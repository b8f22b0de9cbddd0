"""No run may load JAX or the JAX package; the port's name begins with the
JAX package's and must pass. The plain reference imports nothing of the
program."""

import ast

import pytest

from benchmark.harness import result, spec


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client",
                                  "flax", "flax.linen", "flowhigh_tpu",
                                  "flowhigh_tpu.sr"])
def test_forbidden_modules_are_found(name):
    assert result.forbidden_modules({name: None, "torch": None}) == [name]


@pytest.mark.parametrize("name", ["flowhigh_tpu_torch", "flowhigh_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "numpy"])
def test_other_modules_pass(name):
    assert result.forbidden_modules({name: None}) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "flowhigh_tpu",
                       "flowhigh_tpu_torch"}


def test_no_benchmark_file_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "flowhigh_tpu"}, path
