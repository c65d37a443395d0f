"""Each traffic mix is the same for the same seed, differs for another seed, and
keeps the same set of sizes whatever the seed."""

import numpy as np
import pytest

from portbench import generate

from . import tiny

SEED = 2**33 + 17  # seeds run past 32 bits


def _flat(x):
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    return [v for y in x for v in _flat(y)]


def _make(name, seed):
    m = tiny.mix(name)
    if m["entry"] == "index":
        return generate.products(m, seed, "cpu")
    return generate.training_batches(m, seed, "cpu")


@pytest.mark.parametrize("name", ["index_mf", "phase1_b8"])
def test_same_seed_same_inputs_other_seed_other_inputs(name):
    a, b, c = _make(name, SEED), _make(name, SEED), _make(name, SEED + 1)
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    assert len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))
    assert len(fa) != len(fc) or any(
        x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(fa, fc))


@pytest.mark.parametrize("name", ["index_mf", "phase1_b8"])
def test_every_seed_gets_the_same_sizes(name):
    def sizes(seed):
        out = _make(name, seed)
        if tiny.mix(name)["entry"] == "index":
            return sorted(tuple(sorted(img.shape for img in call)) for call in out)
        return sorted(tuple(sorted(img.shape for img in imgs)) for imgs, _ in out)

    assert sizes(SEED) == sizes(SEED + 1) == sizes(3)


def test_sampler_draws_are_per_image():
    a = generate.sampler_draws(SEED, 4, [(10, 3), (10, 3)], "cpu")
    b = generate.sampler_draws(SEED, 4, [(10, 3)], "cpu")
    assert np.array_equal(a[0]["rpn"].numpy(), b[0]["rpn"].numpy())
    assert not np.array_equal(a[0]["rpn"].numpy(), a[1]["rpn"].numpy())
