"""The inputs: the same seed gives the same inputs and weights; another
seed gives other ones, with the same sizes and arrivals in another order."""

import numpy as np
import pytest
import torch

from benchmark.harness import signals, spec, weights

SPEECH = spec.load_cell("serve-batch16k").traffic["signal"]
SEEDS = (7, 2**31 + 99)


def test_sub_seeds_are_stable_and_distinct():
    assert weights.sub_seed(2**31 + 5, 3) == weights.sub_seed(2**31 + 5, 3)
    assert weights.sub_seed(2**31 + 5, 3) != weights.sub_seed(2**31 + 6, 3)
    assert 0 <= weights.sub_seed(2**33, 1) < 2**63


@pytest.mark.parametrize("seed", SEEDS)
def test_speech_is_deterministic_per_seed(seed):
    a = signals.speech_pool([8000, 12345], 16000, SPEECH, seed, "cpu")
    b = signals.speech_pool([8000, 12345], 16000, SPEECH, seed, "cpu")
    c = signals.speech_pool([8000, 12345], 16000, SPEECH, seed + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert [len(x) for x in a] == [8000, 12345]
    assert all(0.3 - 1e-6 <= np.abs(x).max() <= 0.9 + 1e-6 for x in a)


def test_sizes_and_arrivals_are_a_fixed_set_in_the_seeds_order():
    a = signals.lengths(48, 4.0, 16.0, 16000, np.random.default_rng(1))
    b = signals.lengths(48, 4.0, 16.0, 16000, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and a != b
    assert min(a) == round(4.125 * 16000) and max(a) == round(15.875 * 16000)
    ga = signals.gaps(200, 6.5, np.random.default_rng(1))
    gb = signals.gaps(200, 6.5, np.random.default_rng(2))
    assert np.allclose(np.sort(ga), np.sort(gb)) and not np.allclose(ga, gb)
    assert abs(ga.mean() * 6.5 - 1) < 0.05


@pytest.mark.parametrize("seed", SEEDS)
def test_training_batches_are_deterministic_per_seed(seed):
    a = signals.tones(3, (0.5, 0.75), (2000.0, 12000.0), seed, "cpu")
    b = signals.tones(3, (0.5, 0.75), (2000.0, 12000.0), seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["wave"].shape == (3, 36000)
    assert ((a["lengths"] >= 24000) & (a["lengths"] <= 36000)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_are_deterministic_per_seed(seed):
    cfg = {"model": dict(spec.load_cell("serve-batch16k").config["model"],
                         dim=32, heads=2, dim_head=16)}
    a = weights.field_weights(cfg, seed, "cpu")
    b = weights.field_weights(cfg, seed, "cpu")
    c = weights.field_weights(cfg, seed + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["to_embed.weight"], c["to_embed.weight"])
