"""The port's multi-card training and serving (``flowhigh_tpu_torch.parallel``,
``Trainer`` / ``VocoderTrainer(mesh=)``, ``cli train`` under a launch,
``FlowHighSR.make_sharded_generate``, ``StreamingSR.generate_sharded``)
against the JAX package's ``parallel`` on the CPU.

Ranks are processes joined over gloo on loopback: ``tests/
torch_parallel_ranks.py`` (torch and the port only), started with
torchrun's environment set by hand, one intra-op thread each, every spawn
under a timeout that kills all its ranks. Two spawns run while this
process compiles the JAX side: world 2 (a 2 x 1 mesh) and world 4 (2 x 2,
the field's wide kernels sharded over ``model``). The JAX side runs its
meshes on this process's forced CPU devices (tests/conftest.py).

- the single-process ``initialize`` and ``local_batch_slice`` against
  JAX's, case for case (tests/test_distributed.py); refusals;
- the tensor-parallel rule against ``_kernel_spec`` on the JAX param tree,
  non-dividing widths included, names mapped through ``compat``;
- one ``Trainer`` step at dp2 (global batch 4, frequency masking on, rows
  whose condition minima differ) against the JAX trainer's at dp2 from
  the same params and draws, and against the port's single process; the
  local-rows path; save at dp2, resume at world size 1;
- dp2 x tp2 against dp2, its weights sharded by the rule, its checkpoint
  loaded at world size 1;
- a ``VocoderTrainer`` step at dp2 against the single process;
- ``make_sharded_generate`` at world 2 against JAX's at dp2 and against
  the single-process rows; dp2 x tp2 against dp2;
- ``generate_sharded`` at world 2: JAX's stitching checks
  (tests/test_metrics_streaming.py);
- ``cli train`` in two processes.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowhigh_tpu import FlowHighSR as JaxFlowHighSR
from flowhigh_tpu import config as jcfg
from flowhigh_tpu.models import VectorFieldNet as JaxVectorFieldNet
from flowhigh_tpu.parallel import initialize as jax_initialize
from flowhigh_tpu.parallel import local_batch_slice as jax_local_batch_slice
from flowhigh_tpu.parallel import make_mesh as jax_make_mesh
from flowhigh_tpu.parallel.mesh import _kernel_spec as jax_kernel_spec
from flowhigh_tpu.sr import _fast_init
from flowhigh_tpu.train import Trainer as JaxTrainer
from flowhigh_tpu.train.trainer import TrainState as JaxTrainState
from flowhigh_tpu_torch import FlowHighSR, parallel
from flowhigh_tpu_torch import config as pcfg
from flowhigh_tpu_torch.compat import vector_field_state_from_jax
from flowhigh_tpu_torch.models.melvoco import encode
from flowhigh_tpu_torch.parallel.mesh import Mesh
from flowhigh_tpu_torch.train import Trainer, VocoderTrainer
from test_torch_train_loss import jax_draws
from test_torch_vector_options import _field_params

# one share of the machine's cores per pytest-xdist worker for torch's
# intra-op threads: workers that each spin a pool of every core
# oversubscribe the machine
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

REPO = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "torch_parallel_ranks.py"
SPAWN_TIMEOUT = 300  # seconds for every rank of a spawn

# the trainer's run: tests/test_torch_train_trainer.py's recipe on a
# GateLoop field (its to_qkva is column-parallel too), batch 4 of 1 s
FIELD = dict(dim_in=256, dim=32, depth=2, heads=2, dim_head=8,
             use_gateloop_layers=True)
TRAIN = dict(batch_size=4, lr=1e-3, num_train_steps=100, num_warmup_steps=2,
             save_model_every=0, weighted_loss=True, cond_freq_masking=True,
             amp_dtype="float32")
CFM = dict(cfm_method="independent_cfm_mix", cond_drop_prob=0.4)
N = 48_000
FRAMES = (N + 2 * 784 - 2048) // 480 + 1  # the encode's frames
# the vocoder's: tests/test_torch_vocoder_train.py's tiny configuration
VOC = dict(num_mels=256, upsample_initial_channel=16,
           upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
VOC_KW = dict(segment_frames=8, periods=(2,), resolutions=((512, 50, 240),))
# serving: tests/test_torch_serving.py's tiny pair
SR_MODEL = dict(dim_in=256, dim=64, depth=2, heads=2, dim_head=16)
SR_VOC = dict(num_mels=256, upsample_initial_channel=32,
              upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
CHUNK, HOP, N_CHUNKS = 16_000, 12_000, 5  # 1 s chunks, 0.25 s overlap, 4 s


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this process's torch work, as the other
    training files (several pytest workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv, world: int, **popen):
    """``world`` processes of ``argv`` with torchrun's environment set by
    hand on a free loopback port, one intra-op thread each."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE=str(world))
    return [subprocess.Popen(argv, env={**env, "RANK": str(r),
                                        "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, **popen)
            for r in range(world)]


def _wait(procs) -> list:
    """Each rank's output; on a timeout every rank is killed."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _batch():
    """Four 1 s waves: row 0 silent in its second half, so that its
    condition mel reaches the log clamp and the other shard's rows do
    not (their minima differ from the batch's)."""
    gen = np.random.default_rng(0)
    wave = (0.3 * gen.standard_normal((4, N))).astype(np.float32)
    wave[0, N // 2:] = 0.0
    wave[2:] *= np.float32(2.0)
    return {"wave": wave, "cond": (0.5 * wave).astype(np.float32),
            "lengths": np.full(4, N)}


def _tiny_pair():
    """The JAX FlowHighSR of tests/test_torch_serving.py (sigma 0: a
    deterministic prior) with fast-init weights, and the port's."""
    cj = jcfg.FlowHighConfig().replace(model=jcfg.ModelConfig(**SR_MODEL),
                                       vocoder=jcfg.VocoderConfig(**SR_VOC))
    jsr = JaxFlowHighSR(cj, cfm_method="independent_cfm_adaptive",
                        ode_method="euler")
    r1, r2 = jax.random.split(jax.random.PRNGKey(3))
    mel = jnp.zeros((1, 16, 256))
    jsr.params = jax.device_get(_fast_init(
        lambda r: jsr.net.init(r, mel, times=jnp.zeros(()), cond=mel), r1))
    voc = jax.device_get(_fast_init(
        lambda r: jsr.melvoco.vocoder.init(r, mel), r2))
    leaves, tree = jax.tree_util.tree_flatten(voc)
    gen = np.random.default_rng(4)
    jsr.melvoco.vocoder_params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(v) + (0.1 * gen.standard_normal(v.shape).astype(
            np.float32) if v.ndim == 1 else 0) for v in leaves])
    cp = pcfg.FlowHighConfig().replace(model=pcfg.ModelConfig(**SR_MODEL),
                                       vocoder=pcfg.VocoderConfig(**SR_VOC))
    psr = FlowHighSR(cp, jsr.params, jsr.melvoco.vocoder_params,
                     cfm_method="independent_cfm_adaptive",
                     ode_method="euler", device="cpu")
    return jsr, psr


def _port_configs():
    return pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**FIELD), cfm=pcfg.CFMConfig(**CFM),
        train=pcfg.TrainConfig(**TRAIN))


CLI_CONFIG = {"data": {"data_path": ""},
              "model": {"dim": 64, "n_layers": 2, "n_heads": 2,
                        "dim_head": 16, "cfm_path": "basic_cfm"},
              "train": {"batchsize": 2, "log_every": 1,
                        "save_model_every": 2}}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``python -m flowhigh_tpu_torch.cli train`` launched twice with
    torchrun's environment (tests/test_torch_train_cli.py's tiny reference
    JSON, 2 updates), running beside the other spawns."""
    folder = tmp_path_factory.mktemp("cli")
    config = folder / "config.json"
    config.write_text(json.dumps(CLI_CONFIG))
    out = folder / "results"
    procs = _spawn([sys.executable, "-m", "flowhigh_tpu_torch.cli", "train",
                    "--config", str(config), "--steps", "2", "--save_dir",
                    str(out), "--device", "cpu"], 2, cwd=str(REPO))
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def run(tmp_path_factory, cli_run):
    """Write the ranks' inputs, start the world-2 and world-4 spawns (the
    CLI's is running), run the JAX side and the port's single process
    meanwhile, then collect."""
    folder = tmp_path_factory.mktemp("ranks")
    jparams = _field_params(JaxVectorFieldNet(jcfg.ModelConfig(**FIELD)))
    params = vector_field_state_from_jax(jparams, pcfg.ModelConfig(**FIELD))
    rng0 = jax.random.PRNGKey(0)
    draws = jax_draws(jax.random.split(rng0)[1], (4, FRAMES, 256))
    batch = _batch()
    jsr, psr = _tiny_pair()
    gen = np.random.default_rng(1)
    sbatch = (gen.standard_normal((2, 8000)) * 0.3).astype(np.float32)
    long = (gen.standard_normal(CHUNK * 4) * 0.3).astype(np.float32)
    chunks = [np.pad(long[c * HOP:c * HOP + CHUNK],
                     (0, max(0, CHUNK - len(long[c * HOP:]))))[:CHUNK]
              for c in range(N_CHUNKS)]
    chunks += [np.zeros(CHUNK, np.float32)]  # padded to a dp2 multiple
    vbatch = {"wave": (np.random.default_rng(2).standard_normal(
        (4, VOC_KW["segment_frames"] * 480)) * 0.3).astype(np.float32)}
    torch.save({
        "trainer": {"field": FIELD, "cfm": CFM, "train": TRAIN,
                    "params": params, "batch": batch, "draws": draws},
        "vocoder": {"config": VOC, "kw": VOC_KW, "batch": vbatch},
        "serving": {"field": SR_MODEL, "vocoder": SR_VOC,
                    "net": psr.net.state_dict(),
                    "voc": psr.vocoder.state_dict(), "batch": sbatch,
                    "lens": np.full(2, 8000), "long": long,
                    "chunks": np.stack(chunks).astype(np.float32),
                    "chunk_lens": np.full(len(chunks), CHUNK)}},
        folder / "inputs.pt")
    spawns = {job: _spawn([sys.executable, str(RANKS), job, str(folder)],
                          world) for job, world in (("dp", 2), ("tp", 4))}
    try:
        out = {"params": params, "batch": batch, "draws": draws,
               "sbatch": sbatch, "long": long, "folder": folder,
               "vbatch": vbatch, "psr": psr}
        # the JAX trainer at dp2 on this process's CPU devices
        jc = jcfg.FlowHighConfig().replace(
            model=jcfg.ModelConfig(**FIELD), cfm=jcfg.CFMConfig(**CFM),
            train=jcfg.TrainConfig(**TRAIN))
        jtr = JaxTrainer(jc, mesh=jax_make_mesh(n_data=2))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                               opt_state=jtr.tx.init(jparams), rng=rng0)
        jstate, m = jtr.train_step(jstate, batch)
        out["jax"] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "params": vector_field_state_from_jax(
                          jax.device_get(jstate.params),
                          pcfg.ModelConfig(**FIELD))}
        fn = jsr.make_sharded_generate(jax_make_mesh(n_data=2), in_sr=16000)
        out["jax_generate"] = np.asarray(fn(sbatch, np.full(2, 8000),
                                            seed=3)[0])
        # the port's single process
        tr = Trainer(_port_configs(), results_folder=str(folder / "single"),
                     device="cpu")
        state = tr.init_state(0, params=params)
        state, m = tr.train_step(state, batch, draws=draws)
        out["single"] = {"trainer": tr, "state": state,
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])}
        out["outs"] = {job: _wait(procs) for job, procs in spawns.items()}
    finally:
        for procs in spawns.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    out["dp"] = torch.load(folder / "dp_rank0.pt", weights_only=False)
    out["dp1"] = torch.load(folder / "dp_rank1.pt", weights_only=False)
    out["tp"] = [torch.load(folder / f"tp_rank{r}.pt", weights_only=False)
                 for r in range(4)]
    return out


# --- the single-process entry point against JAX's ---------------------------------

@pytest.mark.parametrize("args", [(32, 0, 4), (32, 3, 4), (10, 0, 4),
                                  (12, None, None)])
def test_local_batch_slice_matches_jax(args):
    """tests/test_distributed.py's cases, and the defaults (one process)."""
    try:
        want = jax_local_batch_slice(*args)
    except AssertionError as e:
        with pytest.raises(AssertionError, match="must divide"):
            parallel.local_batch_slice(*args)
        assert "must divide" in str(e)
        return
    assert parallel.local_batch_slice(*args) == want


def test_single_process_initialize_matches_jax():
    assert parallel.initialize() == jax_initialize() == (0, 1)
    assert parallel.initialize() == (0, 1)  # idempotent, joins nothing
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.index("data") == 0
    assert parallel.make_global_mesh().shape == mesh.shape
    assert parallel.batch_sharding(mesh).spec == ("data",)
    assert parallel.replicated_sharding(mesh).spec == ()
    with pytest.raises(AssertionError, match="needs more than 1 devices"):
        parallel.make_mesh(n_data=2)
    with pytest.raises(AssertionError, match="needs more than 1 devices"):
        parallel.make_mesh(n_model=2)


def test_initialize_refuses_without_a_card(monkeypatch):
    """No fallback: a launch without a card that does not ask for the CPU
    raises before joining anything."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.initialize("localhost:1", 2, 0)
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1"),
                 ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.initialize()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        parallel.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_shard_batch_keeps_the_data_index_rows():
    mesh = Mesh(np.arange(4).reshape(2, 2))  # rank 0 at data index 0
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    got = parallel.shard_batch(mesh, {"x": x})
    np.testing.assert_array_equal(got["x"].numpy(), x[:4])
    assert parallel.shard_batch(mesh, got) is got  # already local rows
    with pytest.raises(AssertionError, match="must divide"):
        parallel.shard_batch(mesh, x[:3])


# --- the tensor-parallel rule --------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 3])
def test_kernel_spec_matches_jax(n_model):
    """The port shards the same kernels on the same dimension as
    ``flowhigh_tpu.parallel.mesh._kernel_spec`` on the JAX param tree (a
    kernel [in, out] is a torch weight [out, in]). dim 11 and 2 x 8 heads:
    the feed-forward's 29 inputs of proj_out divide by neither 2 nor 3,
    and at 3 neither do to_out's 16, proj_in's 58 or to_qkva's 44."""
    field = dict(FIELD, dim=11, use_unet_skip_connection=True)
    jparams = _field_params(JaxVectorFieldNet(jcfg.ModelConfig(**field)))
    port = vector_field_state_from_jax(jparams, pcfg.ModelConfig(**field))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        spec = tuple(jax_kernel_spec(path, leaf, n_model))
        if leaf.ndim != 2:
            continue
        # the port's name of this kernel: the entry holding its transpose
        name, = [k for k, v in port.items() if v.ndim == 2
                 and v.shape == leaf.shape[::-1]
                 and np.array_equal(v.numpy().T, leaf)]
        want[name] = spec[::-1] if spec else ()
    got = parallel.param_shardings(Mesh(np.arange(n_model)[None]), port)
    assert {k: got[k].spec for k in want} == want
    assert all(got[k].spec == () for k in set(got) - set(want))
    kinds = {k.split(".", 3)[-1] for k, s in want.items() if s}
    assert kinds == ({"1.to_qkva.weight", "3.to_qkv.weight",
                      "3.to_out.weight", "5.0.weight"} if n_model == 2
                     else {"3.to_qkv.weight"})


# --- the trainer at dp2 ---------------------------------------------------------------

def test_shards_have_other_minima(run):
    """Not vacuous: the frequency mask's fill is the global minimum, which
    the second shard's rows alone do not reach."""
    b = run["batch"]
    cond = torch.from_numpy(b["cond"])
    cond = cond / cond.abs().amax(-1, keepdim=True)
    mel = encode(cond, pcfg.MelConfig())
    assert float(mel[2:].min()) > float(mel.min()) + 0.5


def test_dp2_trainer_step_matches_jax_dp2(run):
    """Loss and grad norm within rel 1e-5, every leaf within rel L2 1e-5
    of the JAX trainer's dp2 step (tests/test_torch_train_trainer.py's
    bounds for the single-device step); the same on both ranks."""
    got, want = run["dp"]["trainer"], run["jax"]
    assert run["dp"]["mesh"] == {"data": 2, "model": 1}
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    assert run["dp1"]["trainer"]["loss"] == got["loss"]
    for name, v in got["params"].items():
        assert _rel_l2(v, want["params"][name]) <= 1e-5, name


def test_dp2_trainer_step_matches_the_single_process(run):
    got, want = run["dp"]["trainer"], run["single"]
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    for name, v in want["state"].net.state_dict().items():
        assert _rel_l2(got["params"][name], v) <= 1e-5, name


def test_local_rows_equal_the_global_batch(run):
    """``shard_global_batch``'s local rows take the same step as the
    global batch sliced by the trainer."""
    got, want = run["dp"]["trainer_local_rows"], run["dp"]["trainer"]
    assert got["loss"] == want["loss"]
    for name, v in want["params"].items():
        assert torch.equal(got["params"][name], v), name


def test_dp2_checkpoint_resumes_at_world_size_1(run, tmp_path):
    """Rank 0 alone wrote both files; the state resumes in one process
    and its next step equals the single process's second step."""
    assert run["dp"]["saved"] == ["FLowHigh.1.pt", "trainstate_1.pt"]
    ckpt = run["folder"] / "dp_ckpt" / "trainstate_1.pt"
    tr = Trainer(_port_configs(), results_folder=str(tmp_path),
                 device="cpu")
    state = tr.restore_state(ckpt, tr.init_state(0))
    assert state.step == 1
    for name, v in run["dp"]["trainer"]["params"].items():
        assert torch.equal(state.net.state_dict()[name], v), name
    single = run["single"]
    draws = jax_draws(jax.random.PRNGKey(1), (4, FRAMES, 256))
    state, m = tr.train_step(state, run["batch"], draws=draws)
    s_state = single["trainer"].restore_state(
        single["trainer"].save(single["state"], tmp_path / "single"),
        single["trainer"].init_state(0))
    s_state, s_m = single["trainer"].train_step(s_state, run["batch"],
                                                draws=draws)
    assert abs(float(m["loss"]) - float(s_m["loss"])) <= 1e-5 * abs(
        float(s_m["loss"]))
    for name, v in s_state.net.state_dict().items():
        assert _rel_l2(state.net.state_dict()[name], v) <= 1e-5, name


# --- dp2 x tp2 -------------------------------------------------------------------------

def test_dp2_tp2_trainer_step_matches_dp2(run):
    dp, tp = run["dp"]["trainer"], run["tp"][0]["trainer"]
    assert run["tp"][0]["mesh"] == {"data": 2, "model": 2}
    for key in ("loss", "grad_norm"):
        assert abs(tp[key] - dp[key]) <= 1e-5 * abs(dp[key]), key
    assert {r["trainer"]["loss"] for r in run["tp"]} == {tp["loss"]}
    for name, v in dp["params"].items():
        assert _rel_l2(tp["params"][name], v) <= 1e-5, name


def test_dp2_tp2_bf16_step_matches_the_single_process(run):
    """Below float32 the row-parallel kernels sum their float32 partial
    products over ``model`` and round once, as the unsharded product
    rounds its sum once (``parallel.tensor``): one bf16-compute step at
    dp2 x tp2 against the single process's, loss within rel 1e-5 and every
    leaf within rel L2 1e-4 (measured: 6e-8 and 9.1e-6; a product that
    rounds to the other bf16 neighbour moves its term by 2^-8)."""
    cfg = _port_configs()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                amp_dtype="bfloat16"))
    tr = Trainer(cfg, device="cpu")
    state, m = tr.train_step(tr.init_state(0, params=run["params"]),
                             run["batch"], draws=run["draws"])
    got = run["tp"][0]["trainer_bf16"]
    assert abs(got["loss"] - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    for name, v in state.net.state_dict().items():
        assert _rel_l2(got["params"][name], v) <= 1e-4, name


def test_dp2_tp2_weights_stay_sharded_by_the_rule(run):
    """After the step each rank holds half of every kernel the rule shards
    (on the rule's dimension) and the whole of everything else."""
    rule = parallel.param_shardings(Mesh(np.arange(2)[None]),
                                    run["dp"]["trainer"]["params"])
    sharded = {k for k, s in rule.items() if s.spec}
    # to_qkv, to_qkva and proj_in (slot 5.0) by columns, to_out by rows;
    # proj_out's 85 inputs do not divide
    assert {k.split(".", 3)[-1] for k in sharded} == {
        "3.to_qkv.weight", "1.to_qkva.weight", "5.0.weight",
        "3.to_out.weight"}
    for r in run["tp"]:
        for name, full in r["trainer"]["params"].items():
            want = list(full.shape)
            if name in sharded:
                want[rule[name].spec.index("model")] //= 2
            assert list(r["trainer"]["local_shapes"][name]) == want, name


def test_dp2_tp2_checkpoint_loads_at_world_size_1(run, tmp_path):
    tr = Trainer(_port_configs(), results_folder=str(tmp_path),
                 device="cpu")
    state = tr.restore_state(run["folder"] / "tp_ckpt" / "trainstate_1.pt",
                             tr.init_state(0))
    for name, v in run["tp"][0]["trainer"]["params"].items():
        assert torch.equal(state.net.state_dict()[name], v), name
    # the whole Adam moments too, those of the sharded kernels gathered
    dp = tr.restore_state(run["folder"] / "dp_ckpt" / "trainstate_1.pt",
                          tr.init_state(0))
    for p, q in zip(state.net.parameters(), dp.net.parameters()):
        got, want = state.optimizer.inner.state[p], dp.optimizer.inner.state[q]
        assert got["exp_avg"].shape == p.shape
        assert _rel_l2(got["exp_avg"], want["exp_avg"]) <= 1e-5
        assert _rel_l2(got["exp_avg_sq"], want["exp_avg_sq"]) <= 1e-5


# --- the vocoder trainer at dp2 ------------------------------------------------------

def test_dp2_vocoder_step_matches_the_single_process(run):
    """tests/test_torch_vocoder_steps.py's first-step bounds: the three
    losses within rel 1e-5, each element's update within 1e-3 lr where its
    gradient is clear of 0 (1e-3 x its leaf's RMS), at most 1e-4 of the
    elements the other way (Adam's first update is lr x sign(g))."""
    tr = VocoderTrainer(pcfg.VocoderConfig(**VOC), device="cpu", **VOC_KW)
    state = tr.init_state(0)
    start = {f"{m}.{k}": v.detach().clone() for m in ("generator", "mpd",
                                                      "mrd")
             for k, v in getattr(state, m).named_parameters()}
    state, m = tr.train_step(state, run["vbatch"])
    got = run["dp"]["vocoder"]
    for key in ("disc_loss", "gen_loss", "mel_l1"):
        assert abs(got["metrics"][key] - float(m[key])) <= 1e-5 * abs(
            float(m[key])), key
    lr, flipped, total = 2e-4, 0, 0
    for mod in ("generator", "mpd", "mrd"):
        for k, p in getattr(state, mod).named_parameters():
            name = f"{mod}.{k}"
            upd = (p.detach() - start[name]).numpy()
            upd_dp = (got["params"][name] - start[name]).numpy()
            g = p.grad.numpy()
            clear = np.abs(g) > 1e-3 * np.sqrt(np.mean(g * g))
            assert np.all(np.abs(upd - upd_dp)[clear] <= 1e-3 * lr), name
            flipped += int(np.sum(np.abs(upd - upd_dp) > 1e-3 * lr))
            total += g.size
    assert flipped <= 1e-4 * total


# --- sharded serving -------------------------------------------------------------------

def test_sharded_generate_matches_jax_dp2(run):
    """World 2 against the JAX package's dp2 program, at the port's
    generate bound (tests/test_torch_sr.py); both ranks return the whole
    batch."""
    got = run["dp"]["serving"]
    assert got["out"].shape == (2, 24000)
    np.testing.assert_allclose(got["out"].numpy(), run["jax_generate"],
                               atol=1e-3)
    assert got["n48"].tolist() == [24000, 24000]
    assert torch.equal(run["dp1"]["serving"]["out"], got["out"])


def test_sharded_rows_equal_single_process_generate(run):
    """Each shard's row is the one-card pipeline on that row (what
    ``fn`` runs per rank), within tests/test_distributed.py's 1e-5."""
    psr = run["psr"]
    for d in range(2):
        want, _, _ = psr.dispatch_generate(run["sbatch"][d:d + 1],
                                           np.array([8000]), 16000)
        np.testing.assert_allclose(run["dp"]["serving"]["out"][d:d + 1],
                                   want, rtol=1e-5, atol=1e-5)


def test_sharded_generate_dp2_tp2_matches_dp2(run):
    for r in run["tp"]:
        np.testing.assert_allclose(r["serving"]["out"],
                                   run["dp"]["serving"]["out"],
                                   rtol=1e-5, atol=1e-5)


def test_sharded_generate_refusals():
    jsr_free = FlowHighSR(pcfg.FlowHighConfig().replace(
        model=pcfg.ModelConfig(**SR_MODEL),
        vocoder=pcfg.VocoderConfig(**SR_VOC)),
        ode_method="adaptive", device="cpu")
    with pytest.raises(NotImplementedError, match="fixed-grid"):
        jsr_free.make_sharded_generate(parallel.make_mesh(), 16000)
    jsr_free.ode_method = "euler"
    fn = jsr_free.make_sharded_generate(Mesh(np.arange(2)[:, None]), 16000)
    with pytest.raises(AssertionError, match="must divide over data axis"):
        fn(np.zeros((3, 800), np.float32), np.full(3, 800))


def test_generate_sharded_stitches(run):
    """tests/test_metrics_streaming.py::test_sharded_longform_stitches on
    a world of 2: shape, finite, energy in every 4,800-sample segment,
    deterministic, one sharded function for both calls."""
    got = run["dp"]["serving"]
    out = got["long"]
    assert out.shape == (1, 48000 * 4)
    assert np.isfinite(out).all()
    seg = out[0].reshape(-1, 4800)
    assert (np.abs(seg).max(axis=1) > 1e-4).all()
    np.testing.assert_array_equal(out, got["long_again"])
    assert got["cache_entries"] == 1
    np.testing.assert_array_equal(run["dp1"]["serving"]["long"], out)


def test_generate_sharded_interior_passthrough(run):
    """...::test_sharded_longform_interior_passthrough: samples that one
    chunk alone covers are that chunk's sharded output, bit for bit."""
    out, ys = run["dp"]["serving"]["long"], run["dp"]["serving"]["chunks"]
    ys = ys.numpy()
    for c in range(N_CHUNKS):
        y = ys[c][:3 * CHUNK]
        o0 = 3 * c * HOP
        lo = 3 * (CHUNK - HOP) if c > 0 else 0
        hi = len(y) - (3 * (CHUNK - HOP) if c < N_CHUNKS - 1 else 0)
        hi = min(hi, out.shape[1] - o0)
        np.testing.assert_array_equal(out[0, o0 + lo:o0 + hi], y[lo:hi])


# --- cli train in two processes -------------------------------------------------------

def test_cli_train_in_two_processes(run, cli_run):
    """Both ranks log the same (global) losses; rank 0 alone prints the
    summary and writes the metrics and the checkpoints."""
    procs, out = cli_run
    outs = _wait(procs)

    def losses(text):
        return [ln.split("'loss': ")[1].split(",")[0]
                for ln in text.splitlines() if ln.startswith("[train] {")]

    assert len(losses(outs[0])) == 2
    assert losses(outs[0]) == losses(outs[1])
    assert ["rank 0/2" in outs[0], "rank 1/2" in outs[1]] == [True, True]
    assert ["FLowHigh vector field" in o for o in outs] == [True, False]
    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines if "loss" in ln] == [1, 2]
    assert sorted(p.name for p in out.glob("*.pt")) == [
        "FLowHigh.2.pt", "trainstate_2.pt"]
