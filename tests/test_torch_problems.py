"""The port's CSP generators and padding contract against the reference.

Same numpy seeds through `repro` and `repro_torch` must give byte-identical
networks, and the padding helpers must produce the same padded tensors, so
every later comparison starts from identical inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.problems import generate as ref_generate, generate_batch as ref_generate_batch

from repro_torch.core import csp_from_numpy, engine
from repro_torch.problems import available_problems, generate, generate_batch

CPU = torch.device("cpu")

FAMILIES = [
    ("model_rb", dict(n=12, hardness=0.9)),
    ("model_rb", dict(n=20, alpha=0.7, r=0.6, hardness=1.1)),
    ("random_binary", dict(n=10, d=6, density=0.5)),
    ("random_binary", dict(n=16, d=10, density=1.0, tightness=0.4)),
]


def _assert_same(ref_csp, csp):
    for field in ("cons", "mask", "dom"):
        want = np.asarray(getattr(ref_csp, field))
        got = getattr(csp, field).numpy()
        assert got.dtype == np.bool_ and got.shape == want.shape, field
        assert got.tobytes() == want.tobytes(), field


@pytest.mark.parametrize("name,knobs", FAMILIES)
def test_generate_is_byte_identical(name, knobs):
    _assert_same(ref_generate(name, seed=7, **knobs), generate(name, seed=7, device=CPU, **knobs))


@pytest.mark.parametrize("name,knobs", FAMILIES)
def test_generate_batch_is_byte_identical(name, knobs):
    ref = ref_generate_batch(name, 3, seed=2, **knobs)
    got = generate_batch(name, 3, seed=2, device=CPU, **knobs)
    assert len(got) == 3
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_registry_knobs_exclude_seed_and_device():
    assert available_problems() == ["model_rb", "random_binary"]
    with pytest.raises(TypeError):
        generate("model_rb", device=CPU, no_such_knob=1)


def test_csp_from_numpy_carries_a_reference_csp_across():
    ref = ref_generate("model_rb", seed=1, n=10)
    csp = csp_from_numpy(np.asarray(ref.cons), np.asarray(ref.mask), np.asarray(ref.dom), CPU)
    _assert_same(ref, csp)
    assert csp.n_vars == 10 and csp.device == CPU


SHAPE_SWEEP = [
    # (n_vars, dom_size, n_block) — the shapes of tests/test_kernels.py
    (4, 3, 4),
    (8, 5, 8),
    (10, 6, 8),
    (16, 8, 8),
    (24, 33, 8),
    (12, 64, 4),
]


@pytest.mark.parametrize("n,d,n_block", SHAPE_SWEEP)
def test_padding_helpers_match_reference(n, d, n_block):
    ref = ref_generate("random_binary", seed=n + d, n=n, d=d, density=0.6)
    csp = generate("random_binary", seed=n + d, n=n, d=d, density=0.6, device=CPU)
    assert engine.padded_shape(n, d, n_block, 8) == ref_engine.padded_shape(n, d, n_block, 8)
    rc, rm, rn, rd = ref_engine.pad_network(ref, n_block, 8)
    c, m, n_p, d_p = engine.pad_network(csp, n_block, 8)
    assert (n_p, d_p) == (rn, rd)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    rng = np.random.default_rng(n * d)
    doms = rng.random((3, n, d)) < 0.7
    np.testing.assert_array_equal(
        engine.pad_dom(torch.as_tensor(doms), n_p, d_p).numpy(),
        np.asarray(ref_engine.pad_dom(jnp.asarray(doms), n_p, d_p)),
    )
    ch = rng.random((3, n)) < 0.5
    np.testing.assert_array_equal(
        engine.pad_changed(ch, n, n_p, batch=(3,)).numpy(),
        np.asarray(ref_engine.pad_changed(ch, n, n_p, batch=(3,))),
    )
    np.testing.assert_array_equal(
        engine.pad_changed(None, n, n_p, batch=(2,)).numpy(),
        np.asarray(ref_engine.pad_changed(None, n, n_p, batch=(2,))),
    )


def test_round_helpers_match_reference():
    for x in (1, 2, 3, 5, 64, 65, 1000):
        assert engine.next_pow2(x) == ref_engine.next_pow2(x)
        assert engine.round_up(x, 8) == ref_engine.round_up(x, 8)
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    for got, want in zip(engine.pad_round_rows([a, a[:, 0]], 8),
                         ref_engine.pad_round_rows([a, a[:, 0]], 8)):
        np.testing.assert_array_equal(got, want)
    for args in ((1, 10, 10), (32, 100, 40), (400, 100, 40)):
        assert engine.frontier_capacity(*args) == ref_engine.frontier_capacity(*args)
    idx = np.array([2, 0, 1], np.int32)
    np.testing.assert_array_equal(engine.resolve_instance_idx(idx, 3, 3),
                                  ref_engine.resolve_instance_idx(idx, 3, 3))
    with pytest.raises(ValueError):
        engine.resolve_instance_idx(np.array([3]), 3, 1)
