"""The port's RTAC fixpoints (`repro_torch.core.rtac`) against the reference.

Same CSPs (numpy seeds through both packages), exact comparison of closures,
verdicts and recurrence counts for the incremental, paper-faithful, batched
and stacked-rows forms, and the engines' ``enforce_many``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import rtac as ref_rtac
from repro.engines import get_engine as ref_get_engine
from repro.problems import generate as ref_generate

from repro_torch.core import rtac
from repro_torch.engines import get_engine
from repro_torch.problems import generate

CPU = torch.device("cpu")

CASES = [
    # (n, d, density, tightness, seed)
    (6, 4, 0.8, 0.5, 0),
    (9, 5, 0.5, 0.6, 1),
    (12, 7, 0.7, 0.45, 2),
    (5, 9, 1.0, 0.7, 3),
    (10, 3, 0.3, 0.5, 4),
]


def _pair(n, d, density, tightness, seed):
    knobs = dict(n=n, d=d, density=density, tightness=tightness)
    return (ref_generate("random_binary", seed=seed, **knobs),
            generate("random_binary", seed=seed, device=CPU, **knobs))


def _assert_result(got, want):
    np.testing.assert_array_equal(np.asarray(got.consistent), np.asarray(want.consistent))
    np.testing.assert_array_equal(np.asarray(got.n_recurrences), np.asarray(want.n_recurrences))
    np.testing.assert_array_equal(np.asarray(got.dom), np.asarray(want.dom))


def _domains(n, d, b, seed):
    doms = np.random.default_rng(seed).random((b, n, d)) < 0.8
    doms[:, :, 0] = True
    return doms


@pytest.mark.parametrize("case", CASES)
def test_enforce_and_enforce_full_match_reference(case):
    ref_csp, csp = _pair(*case)
    _assert_result(rtac.enforce(csp.cons, csp.mask, csp.dom),
                   ref_rtac.enforce(ref_csp.cons, ref_csp.mask, ref_csp.dom))
    _assert_result(rtac.enforce_full(csp.cons, csp.mask, csp.dom),
                   ref_rtac.enforce_full(ref_csp.cons, ref_csp.mask, ref_csp.dom))
    n = case[0]
    seed = np.zeros(n, bool)
    seed[n // 2] = True
    dom = _domains(n, case[1], 1, case[4])[0]
    _assert_result(
        rtac.enforce(csp.cons, csp.mask, torch.as_tensor(dom), torch.as_tensor(seed)),
        ref_rtac.enforce(ref_csp.cons, ref_csp.mask, jnp.asarray(dom), jnp.asarray(seed)),
    )


@pytest.mark.parametrize("case", CASES[:3])
def test_batched_forms_match_reference(case):
    ref_csp, csp = _pair(*case)
    n, d = case[0], case[1]
    doms = _domains(n, d, 4, case[4] + 10)
    seeds = np.random.default_rng(case[4]).random((4, n)) < 0.5
    _assert_result(
        rtac.enforce_batch(csp.cons, csp.mask, torch.as_tensor(doms), torch.as_tensor(seeds)),
        ref_rtac.enforce_batch(ref_csp.cons, ref_csp.mask, jnp.asarray(doms), jnp.asarray(seeds)),
    )
    _assert_result(
        rtac.enforce_full_batch(csp.cons, csp.mask, torch.as_tensor(doms)),
        ref_rtac.enforce_full_batch(ref_csp.cons, ref_csp.mask, jnp.asarray(doms)),
    )


def _stacked(n=8, d=5):
    pairs = [_pair(n, d, 0.7, 0.5, 40 + i) for i in range(3)]
    ref_nets = (jnp.stack([p[0].cons for p in pairs]), jnp.stack([p[0].mask for p in pairs]))
    nets = (torch.stack([p[1].cons for p in pairs]), torch.stack([p[1].mask for p in pairs]))
    idx = np.array([0, 1, 2, 1, 0, 2], np.int32)
    doms = _domains(n, d, len(idx), 5)
    doms[3, 0, 1:] = False  # starts near wipeout
    var = np.array([-1, 2, 0, 5, -1, 7], np.int32)
    val = np.array([0, 1, 0, 2, 0, 3], np.int32)
    return pairs, ref_nets, nets, idx, doms, var, val


def test_stacked_rows_and_assign_match_reference():
    pairs, ref_nets, nets, idx, doms, var, val = _stacked()
    # enforce_rows_generic with the einsum revise (rows read tables[idx])
    seeds = np.random.default_rng(3).random((len(idx), doms.shape[1])) < 0.5

    def ref_rows(net_g, d_, ch):
        return jnp.stack([ref_rtac._EINSUM_REVISE((c, m), di, ci)
                          for c, m, di, ci in zip(net_g[0], net_g[1], d_, ch)])

    def rows(tables, ix, d_, ch):
        return rtac._EINSUM_REVISE((tables[0][ix], tables[1][ix]), d_, ch)

    _assert_result(
        rtac.enforce_rows_generic(nets, torch.as_tensor(doms), torch.as_tensor(seeds),
                                  torch.as_tensor(idx), revise_rows_fn=rows),
        ref_rtac.enforce_rows_generic(ref_nets, jnp.asarray(doms), jnp.asarray(seeds),
                                      jnp.asarray(idx), revise_rows_fn=ref_rows),
    )
    # the fused frontier forms: assign + seed + fixpoint
    got_doms, got_ch = rtac.assign_and_seed(torch.as_tensor(doms), torch.as_tensor(var),
                                            torch.as_tensor(val))
    want_doms, want_ch = ref_rtac.assign_and_seed(jnp.asarray(doms), jnp.asarray(var),
                                                  jnp.asarray(val))
    np.testing.assert_array_equal(got_doms.numpy(), np.asarray(want_doms))
    np.testing.assert_array_equal(got_ch.numpy(), np.asarray(want_ch))
    args = (torch.as_tensor(doms), torch.as_tensor(var), torch.as_tensor(val), torch.as_tensor(idx))
    ref_args = (jnp.asarray(doms), jnp.asarray(var), jnp.asarray(val), jnp.asarray(idx))
    _assert_result(rtac.assign_enforce_many(nets, *args),
                   ref_rtac.assign_enforce_many(ref_nets, *ref_args))
    _assert_result(rtac.assign_enforce_full_many(*nets, *args),
                   ref_rtac.assign_enforce_full_many(*ref_nets, *ref_args))
    np.testing.assert_array_equal(
        rtac.assign(torch.as_tensor(doms[0]), 3, 2).numpy(),
        np.asarray(ref_rtac.assign(jnp.asarray(doms[0]), 3, 2)),
    )


@pytest.mark.parametrize("name,opts,ref_name,ref_opts", [
    ("einsum", {}, "einsum", {}),
    ("full", {}, "full", {}),
    ("hopper_packed", {"fixpoint": "fused"}, "pallas_packed", {"fixpoint": "stepped"}),
    ("hopper_packed", {"fixpoint": "stepped"}, "pallas_packed", {"fixpoint": "stepped"}),
    ("hopper_dense", {"fixpoint": "fused"}, "pallas_dense", {"fixpoint": "stepped"}),
    ("hopper_dense", {"fixpoint": "stepped"}, "pallas_dense", {"fixpoint": "stepped"}),
])
def test_engine_enforce_many_matches_reference(name, opts, ref_name, ref_opts):
    pairs, _, _, idx, doms, _, _ = _stacked()
    seeds = np.random.default_rng(9).random((len(idx), doms.shape[1])) < 0.5
    want = ref_get_engine(ref_name, **ref_opts).prepare_many([p[0] for p in pairs]).enforce_many(
        doms, seeds, idx)
    got = get_engine(name, device=CPU, **opts).prepare_many([p[1] for p in pairs]).enforce_many(
        doms, seeds, idx)
    _assert_result(got, want)


def test_einsum_engine_single_network_matches_reference():
    ref_csp, csp = _pair(*CASES[2])
    ref_prep = ref_get_engine("einsum").prepare(ref_csp)
    prep = get_engine("einsum", device=CPU).prepare(csp)
    _assert_result(prep.enforce(), ref_prep.enforce())
    doms = _domains(12, 7, 3, 1)
    _assert_result(prep.enforce_batch(doms), ref_prep.enforce_batch(doms))


HOPPER_VS_PALLAS = [("hopper_packed", "pallas_packed"), ("hopper_dense", "pallas_dense")]


def test_hopper_single_network_waits_for_its_kernel():
    """The single-network path, which waited for kernels 3 and 6, now runs
    them: ``enforce()`` and ``enforce_batch`` of the root domain equal the
    reference Pallas engines' on both Hopper engines."""
    ref_csp, csp = _pair(*CASES[0])
    for name, ref_name in HOPPER_VS_PALLAS:
        prep = get_engine(name, device=CPU).prepare(csp)
        ref_prep = ref_get_engine(ref_name).prepare(ref_csp)
        _assert_result(prep.enforce(), ref_prep.enforce())
        _assert_result(prep.enforce_batch(csp.dom[None]),
                       ref_prep.enforce_batch(ref_csp.dom[None]))


@pytest.mark.parametrize("name,ref_name", HOPPER_VS_PALLAS)
@pytest.mark.parametrize("case", CASES)
def test_hopper_single_network_matches_reference(case, name, ref_name):
    """`enforce` with a one-hot seed and `enforce_batch` of seeded domains
    (the calls `mac_solve` makes) equal the reference Pallas engines."""
    ref_csp, csp = _pair(*case)
    n, d = case[0], case[1]
    prep = get_engine(name, device=CPU).prepare(csp)
    ref_prep = ref_get_engine(ref_name).prepare(ref_csp)
    dom = _domains(n, d, 1, case[4])[0]
    one_hot = np.arange(n) == n // 2
    _assert_result(prep.enforce(dom, one_hot), ref_prep.enforce(dom, one_hot))
    doms = _domains(n, d, 4, case[4] + 20)
    seeds = np.random.default_rng(case[4]).random((4, n)) < 0.5
    _assert_result(prep.enforce_batch(doms, seeds), ref_prep.enforce_batch(doms, seeds))
    _assert_result(prep.enforce_batch(doms), ref_prep.enforce_batch(doms))
