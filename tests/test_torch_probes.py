"""The probe kernels' plain versions (``flowhigh_tpu_torch/ops/probes.py``)
against the JAX functions they port, on the CPU: ``snake_only`` and
``mxu_fir`` of ``scripts/bench_act_mxu.py`` (lifted from the script's
source with ``ast``, so its module-level benchmark never runs; their Pallas
kernels run in TPU interpret mode inside ``jax.jit``), and
``act_firs_only`` against ``packed_snake_activation1d`` at p = 1 with the
snake monkeypatched to the identity, as the script does. Also the
wrappers' refusals. The kernels themselves are held against these plain
versions on the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import flowhigh_tpu.ops.packed as PK
from flowhigh_tpu_torch import ops

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(512, 16, 4), (1024, 8, 8)]  # (S, C, p): L = p * C = 64
B = 2


def _lift(*names):
    """The named top-level functions of scripts/bench_act_mxu.py, compiled
    into a namespace holding jax, jnp and PK; nothing else of the script
    runs."""
    tree = ast.parse((ROOT / "scripts" / "bench_act_mxu.py").read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = {"jax": jax, "jnp": jnp, "PK": PK}
    exec(compile(ast.Module(body=body, type_ignores=[]),
                 "scripts/bench_act_mxu.py", "exec"), ns)
    return [ns[n] for n in names]


SNAKE_ONLY, MXU_FIR = _lift("snake_only", "mxu_fir")


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(fn)(*args))


def _inputs(s, c, p, seed=0):
    """The script's inputs at a small size: x * 0.3, log-alpha/beta * 0.1,
    exp'd and tiled to p * C lanes, unit-normal FIR matrices."""
    rng = np.random.default_rng(seed)
    pc = p * c
    x = (rng.standard_normal((B, s, pc)) * 0.3).astype(np.float32)
    al = (rng.standard_normal(c) * 0.1).astype(np.float32)
    be = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ab = np.stack([np.tile(np.exp(al), p), np.tile(np.exp(be), p)])
    ab2 = np.concatenate([ab, ab], axis=1)
    up = rng.standard_normal((3, pc, 2 * pc)).astype(np.float32)
    dn = rng.standard_normal((3, 2 * pc, pc)).astype(np.float32)
    return x, ab.astype(np.float32), ab2.astype(np.float32), up, dn


@pytest.mark.parametrize("s,c,p", SHAPES)
def test_snake_only_matches_jax(s, c, p):
    x, ab, *_ = _inputs(s, c, p)
    want = _interpret(SNAKE_ONLY, jnp.asarray(x), jnp.asarray(ab))
    n0 = ops.snake_only.launches
    got = ops.snake_only(torch.from_numpy(x), torch.from_numpy(ab)).numpy()
    assert ops.snake_only.launches == n0  # the CPU takes the plain version
    # the JAX side's polynomial fast_cos against torch.cos
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("s,c,p", SHAPES)
@pytest.mark.parametrize("dtype,do_snake", [("float32", True),
                                            ("float32", False),
                                            ("bfloat16", True),
                                            ("bfloat16", False)])
def test_mxu_fir_matches_jax(s, c, p, dtype, do_snake):
    x, _, ab2, up, dn = _inputs(s, c, p)
    bf16 = dtype == "bfloat16"
    ju, jd = (_bf16(up), _bf16(dn)) if bf16 else (jnp.asarray(up),
                                                  jnp.asarray(dn))
    want = _interpret(
        lambda a, u, d, e: MXU_FIR(a, u, d, e, do_snake=do_snake),
        jnp.asarray(x), ju, jd, jnp.asarray(ab2))
    tu, td = torch.from_numpy(up), torch.from_numpy(dn)
    if bf16:
        tu, td = tu.to(torch.bfloat16), td.to(torch.bfloat16)
    n0 = ops.mxu_fir.launches
    got = ops.mxu_fir(torch.from_numpy(x), tu, td, torch.from_numpy(ab2),
                      do_snake=do_snake).numpy()
    assert ops.mxu_fir.launches == n0
    assert got.shape == want.shape == x.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if bf16:
        # a flip of one bf16 rounding of s2 moves an output row by a bf16
        # step of s2 times dn: held in relative L2
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
    elif do_snake:
        assert err <= 1e-5 * scale, (err, scale)  # fast_cos vs torch.cos
    else:
        assert err <= 1e-6 * scale, (err, scale)  # f32 sums only


@pytest.mark.parametrize("s,c", [(512, 16), (1000, 8)])
def test_act_firs_only_matches_jax(monkeypatch, s, c):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, s, c)) * 0.3).astype(np.float32)
    al = jnp.asarray((rng.standard_normal(c) * 0.1).astype(np.float32))
    monkeypatch.setattr(PK, "_snake_packed", lambda u, a, b: u)
    want = np.asarray(jax.jit(lambda v: PK.packed_snake_activation1d(
        v, al, al, True, 1))(jnp.asarray(x)))
    n0 = ops.act_firs_only.launches
    got = ops.act_firs_only(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    assert ops.act_firs_only.launches == n0
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               atol=2e-5, rtol=0)


def test_mxu_fir_plain_does_not_depend_on_a_tile():
    # the definition has no tile: rows far from the edges see only their
    # own neighbourhood, so a sequence cut in two agrees away from the cut
    x, _, ab2, up, dn = (torch.from_numpy(a) for a in _inputs(64, 4, 4))
    whole = ops.mxu_fir_plain(x, up, dn, ab2)
    head = ops.mxu_fir_plain(x[:, :32].contiguous(), up, dn, ab2)
    torch.testing.assert_close(head[:, :30], whole[:, :30], atol=1e-4,
                               rtol=1e-5)


def test_wrappers_refuse():
    x, ab, ab2, up, dn = (torch.from_numpy(a) for a in _inputs(64, 4, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.mxu_fir(x[:, :60], up, dn, ab2)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.mxu_fir(x[:, :4], up, dn, ab2)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.mxu_fir(x, up, dn.to(torch.bfloat16), ab2)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.mxu_fir(x, up.double(), dn.double(), ab2)
    with pytest.raises(ValueError, match="float32"):
        ops.mxu_fir(x.double(), up, dn, ab2)
    with pytest.raises(ValueError, match=r"\[3, L, 2L\]"):
        ops.mxu_fir(x, up[:, :, :16], dn, ab2)
    with pytest.raises(ValueError, match=r"\[3, L, 2L\]"):
        ops.mxu_fir(x, up, dn, ab2[:, :16])
    with pytest.raises(ValueError, match=r"\[B, S, L\]"):
        ops.mxu_fir(x[0], up, dn, ab2)
    with pytest.raises(ValueError, match=r"\[2, L\]"):
        ops.snake_only(x, ab2)
    with pytest.raises(ValueError, match="float32"):
        ops.snake_only(x.double(), ab)
    with pytest.raises(ValueError, match=r"\[B, C, T\]"):
        ops.act_firs_only(x[0])
    meta = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.snake_only(meta, torch.empty(2, 16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.act_firs_only(meta)


def _chip_smoke():
    import sys
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _probe_script():
    return _chip_smoke()._load_probe_script()


def test_probe_script_draws_the_jax_scripts_inputs():
    # scripts/bench_act_mxu.py draws, per case and from one generator: x,
    # log-alpha, log-beta, the conv's w and b, then up and dn when p > 1
    bench = _probe_script()
    cases = [(40, 8, 4), (16, 8, 1), (24, 4, 2)]
    ref = np.random.default_rng(0)
    got = np.random.default_rng(0)
    for s, c, p in cases:
        inp = bench.case_inputs(got, s, c, p, "cpu")
        pc = p * c
        x = ref.standard_normal((1, s, pc)).astype(np.float32) * 0.3
        al = ref.standard_normal(c).astype(np.float32) * 0.1
        be = ref.standard_normal(c).astype(np.float32) * 0.1
        w = ref.standard_normal((7, c, c)).astype(np.float32) * 0.05
        ref.standard_normal(c)  # b
        np.testing.assert_array_equal(inp["x"].numpy(), x)
        np.testing.assert_array_equal(inp["ab"][1].numpy(),
                                      np.tile(np.exp(be), p))
        np.testing.assert_array_equal(inp["w"].numpy(), w.transpose(2, 1, 0))
        # the unpacked view: time s * p + phase, channel c
        np.testing.assert_array_equal(inp["x_act"][0, 3, 2 * p + 1].numpy(),
                                      x[0, 2, c + 3] if p > 1 else
                                      x[0, 2 * p + 1, 3])
        assert np.allclose(inp["al"].numpy(), al)
        if p > 1:
            up = ref.standard_normal((3, pc, 2 * pc)).astype(np.float32)
            ref.standard_normal((3, 2 * pc, pc))
            np.testing.assert_array_equal(inp["up"].numpy(), up)
            assert inp["up_bf16"].dtype == torch.bfloat16


def test_probe_script_rows_cover_every_probe_instance():
    # chip_smoke.py phase M reads each probe instance's time from its row
    chip_smoke = _chip_smoke()
    bench = chip_smoke._load_probe_script()
    inp = bench.case_inputs(np.random.default_rng(0), 16, 8, 2, "cpu")
    rows = bench.case_rows(inp, 16, 8, 2, chip_smoke.PEAKS["sxm"])
    assert set(chip_smoke.PROBE_ROWS.values()) <= set(rows)
    assert {"act_full", "conv k7d3"} <= set(rows)
    for row, (run, plain, bound_ms, bound_by) in rows.items():
        torch.testing.assert_close(run(), plain(), atol=0, rtol=0)
        assert bound_ms > 0 and bound_by in ("bytes", "operations")
