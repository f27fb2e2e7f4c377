"""The port's sharded path against the reference's.

- The reference's `shard_map` enforcer on a (data=2, model=4) mesh of 8 host
  devices (a subprocess with ``XLA_FLAGS``) and the port's 8 gloo processes
  (`tests/torch_sharded_worker.py`, a `FileStore` under ``tmp_path``, one
  spawn for every case) on the same numpy inputs: `dom`, `consistent` and
  per-domain `k` identical for ``einsum`` on bf16 and u8 and for
  ``bitpacked``; every model rank of a data shard holds the same result;
  the port's engine on 3 domains (padded to the data extent) equals the
  reference's first 3. The same on the (1,4), (2,2) and (4,1) meshes of 4
  host devices and 4 gloo ranks (one spawn of each) for u8 and bitpacked.
- The port's recorded collectives per recurrence equal `collective_stats`
  of the reference's compiled HLO on that mesh and shape, and on the
  4-rank meshes `dryrun_rtac.plan` on that mesh.
- `distributed_ac --network hashed` in a 4-rank gloo world equals its
  1-rank run, through ``--out`` and ``--against``.
- `mac_solve` and `solve_many` on the port's ``sharded`` engine (a one-rank
  gloo world) equal the reference's ``sharded`` engine.
- The block kernels' plain versions against slices of the reference's
  single-network kernels (interpret mode) and `kernels/ref.py`.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import random_csp as ref_random_csp
from repro.core import mac_solve as ref_mac_solve, solve_many as ref_solve_many
from repro.kernels import bitpack_support as ref_bs, ref as ref_ref, rtac_support as ref_rs
from repro.problems import generate as ref_generate

from repro_torch.core import mac_solve, solve_many
from repro_torch.core.csp import csp_from_numpy
from repro_torch.kernels import bitpack_support as bs, ref, rtac_support as rs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: each multi-process run's own limit (seconds)
SPAWN_TIMEOUT = 120
WORLD = 8
SEEDS = (3, 7, 11)
IMPLS = [("einsum", "bfloat16"), ("einsum", "uint8"), ("bitpacked", "bfloat16")]
CASES = [f"{seed}-{impl}-{dtype}" for seed in SEEDS for impl, dtype in IMPLS]
N, D, B = 16, 8, 4


def _inputs(seed):
    """``random_csp(16, 8, 0.7, 0.4, seed)`` and B=4 domains: the root with
    every variable seeded, then three with one variable assigned (seeded
    one-hot, plus a few more seeds), one of them also with a value of
    another variable removed."""
    csp = ref_random_csp(N, D, 0.7, 0.4, seed=seed)
    cons, mask, dom = (np.asarray(a) for a in (csp.cons, csp.mask, csp.dom))
    rng = np.random.default_rng(seed)
    doms = np.repeat(dom[None], B, axis=0)
    changed = np.zeros((B, N), dtype=bool)
    changed[0] = True
    for i in range(1, B):
        var, val = rng.integers(N), rng.integers(D)
        doms[i, var] = False
        doms[i, var, val] = True
        changed[i, var] = True
        changed[i] |= rng.random(N) < 0.15
    doms[2, (3 + seed) % N, :2] = False
    return cons, mask, doms, changed


REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
    sys.path.insert(0, {src!r})
    import jax.numpy as jnp, numpy as np
    from repro.core.sharded import make_sharded_enforcer, shard_csp_arrays
    from repro.kernels.ref import pack_bits_ref
    from repro.launch.mesh import make_mesh
    from repro.parallel.hlo_stats import collective_stats

    data = np.load({inputs!r})
    out, stats = {{}}, {{}}
    for shape in {meshes!r}:
        mesh = make_mesh(tuple(int(s) for s in shape.split("x")), ("data", "model"))
        for case in {cases!r}:
            key = shape + "/" + case
            _seed, impl, dtype = case.split("-")
            cons, mask, doms, changed = (data[case + "_" + f] for f in
                                         ("cons", "mask", "doms", "changed"))
            cons = pack_bits_ref(jnp.asarray(cons)) if impl == "bitpacked" else jnp.asarray(cons)
            enf = make_sharded_enforcer(mesh, dtype=getattr(jnp, dtype), impl=impl)
            cs, ms, ds = shard_csp_arrays(mesh, cons, jnp.asarray(mask), jnp.asarray(doms))
            ch = jnp.asarray(changed)
            res = enf(cs, ms, ds, ch)
            for name, a in zip(("dom", "consistent", "k"), res):
                out[key + "_" + name] = np.asarray(a)
            stats[key] = collective_stats(enf.lower(cs, ms, ds, ch).compile().as_text())
    np.savez({out!r}, **out)
    open({stats!r}, "w").write(json.dumps(stats))
    """
)


def _spawn(tmp, world, meshes, cases):
    """Both packages on every case and mesh: the reference's run on
    ``world`` host devices and the port's ``world`` ranks, started
    together. Returns (inputs, reference results, reference HLO stats, each
    rank's results, each rank's collective records), keyed
    ``{mesh}/{case}``."""
    inputs = tmp / "inputs.npz"
    arrays = {}
    for case in cases:
        for field, a in zip(("cons", "mask", "doms", "changed"), _inputs(int(case.split("-")[0]))):
            arrays[f"{case}_{field}"] = a
    np.savez(inputs, **arrays)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_sharded_worker.py"),
         str(tmp / "store"), str(r), str(world), ",".join(meshes), str(inputs), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        code = REFERENCE.format(devices=world, src=SRC, inputs=str(inputs), meshes=list(meshes),
                                cases=list(cases), out=str(tmp / "reference.npz"),
                                stats=str(tmp / "hlo.json"))
        ref_run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                 timeout=SPAWN_TIMEOUT)
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    assert ref_run.returncode == 0, ref_run.stderr[-3000:]
    for r, (p, log) in enumerate(zip(ranks, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    port = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    records = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    hlo = json.loads((tmp / "hlo.json").read_text())
    return arrays, dict(np.load(tmp / "reference.npz")), hlo, port, records


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Every case on the (2,4) mesh: the reference's 8 devices, the port's
    8 ranks."""
    return _spawn(tmp_path_factory.mktemp("spmd"), WORLD, ["2x4"], CASES)


#: the 4-rank meshes (data x model) and their cases: u8 and bitpacked
MESHES4 = ["1x4", "2x2", "4x1"]
CASES4 = [c for c in CASES if not c.endswith("einsum-bfloat16")]


@pytest.fixture(scope="module")
def spmd4(tmp_path_factory):
    """Every 4-rank mesh and case: the reference's 4 devices, the port's 4
    ranks, one spawn of each."""
    return _spawn(tmp_path_factory.mktemp("spmd4"), 4, MESHES4, CASES4)


def _hold_ranks_against_the_reference(run, mesh, case):
    """Rank r holds data shard r // model; the model ranks of a shard agree,
    the shards in order are the reference's result, and every rank's engine
    run (3 domains, padded to the data extent) is its first 3."""
    _arrays, want, _hlo, port, _records = run
    n_data, n_model = (int(s) for s in mesh.split("x"))
    key = f"{mesh}/{case}"
    for name in ("dom", "consistent", "k"):
        shards = []
        for data_index in range(n_data):
            got = [port[r][f"{key}_{name}"]
                   for r in range(n_model * data_index, n_model * (data_index + 1))]
            for g in got[1:]:
                np.testing.assert_array_equal(g, got[0])
            shards.append(got[0])
        np.testing.assert_array_equal(np.concatenate(shards), want[f"{key}_{name}"])
        for r in range(n_data * n_model):
            np.testing.assert_array_equal(port[r][f"{key}_engine_{name}"],
                                          want[f"{key}_{name}"][:3])
    assert want[f"{key}_k"].max() >= 2


@pytest.mark.parametrize("case", CASES)
def test_eight_gloo_ranks_equal_the_reference_shard_map(spmd, case):
    _hold_ranks_against_the_reference(spmd, "2x4", case)


@pytest.mark.parametrize("case", CASES4)
@pytest.mark.parametrize("mesh", MESHES4)
def test_four_gloo_ranks_equal_the_reference_shard_map(spmd4, mesh, case):
    _hold_ranks_against_the_reference(spmd4, mesh, case)


@pytest.mark.parametrize("impl", [f"{i}-{d}" for i, d in IMPLS])
def test_collectives_per_recurrence_equal_the_reference_hlo(spmd, impl):
    """One all-gather a recurrence, 256 result bytes (2 local domains ·
    16 · 8 bool) and 192 wire bytes, as the reference's HLO counts it."""
    from repro_torch.parallel.comm_stats import Collective, collective_stats

    _arrays, want, hlo, port, records = spmd
    for seed in SEEDS:
        case = f"2x4/{seed}-{impl}"
        assert hlo[case] == {"all-gather": {"count": 1, "result_bytes": 256.0,
                                            "wire_bytes": 192.0}}
        for r in range(WORLD):
            log = [Collective(*c) for c in records[r][case]]
            assert len(set(log)) == 1
            assert len(log) == port[r][f"{case}_k"].max()  # one all-gather a recurrence
            assert collective_stats(log[:1]) == hlo[case]


#: a recurrence's all-gather on each 4-rank mesh: the local batch's domains
#: (B_local · 16 · 8 bool) over the model ranks, (g-1)/g of it on the wire
RECURRENCE4 = {"1x4": (512.0, 384.0), "2x2": (256.0, 128.0), "4x1": (128.0, 0.0)}


@pytest.mark.parametrize("impl", ["einsum-uint8", "bitpacked-bfloat16"])
@pytest.mark.parametrize("mesh", MESHES4)
def test_four_rank_collectives_equal_the_reference_hlo_and_the_plan(spmd4, mesh, impl):
    """On each 4-rank mesh one all-gather a recurrence of the rank's data
    shard, equal to the reference's HLO count and to `dryrun_rtac.plan` on
    that mesh at the test's shape."""
    from repro_torch.launch import dryrun_rtac
    from repro_torch.parallel.comm_stats import Collective, collective_stats

    _arrays, _want, hlo, port, records = spmd4
    n_data, n_model = (int(s) for s in mesh.split("x"))
    variant = {"einsum-uint8": "einsum-u8", "bitpacked-bfloat16": "bitpacked"}[impl]
    plan = dryrun_rtac.plan(variant, {"data": n_data, "model": n_model}, ("data",), n=N, d=D,
                            batch=B)["collectives"]
    result, wire = RECURRENCE4[mesh]
    assert plan == {"all-gather": {"count": 1, "result_bytes": result, "wire_bytes": wire}}
    for seed in SEEDS:
        case = f"{mesh}/{seed}-{impl}"
        assert hlo[case] == plan
        for r in range(4):
            log = [Collective(*c) for c in records[r][case]]
            assert len(set(log)) == 1 and not log[0].staged
            assert len(log) == port[r][f"{case}_k"].max()  # one a recurrence of its shard
            assert collective_stats(log[:1]) == plan


#: `distributed_ac` at a small size of its production command
DAC = ["--device", "cpu", "--network", "hashed", "--n-vars", "64", "--dom-size", "16",
       "--density", "0.2", "--tightness", "0.5", "--batch", "8"]


def _distributed_ac(tmp, world, extra):
    """`distributed_ac` in a gloo world of ``world`` processes (a FileStore
    under ``tmp``): each rank's (exit code, output)."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed_ac", *DAC, *extra,
         "--store", str(tmp / "store"), "--rank", str(r), "--world", str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    """`distributed_ac` on one rank, bitpacked and u8, each saved with
    ``--out``."""
    outs = {}
    for impl in (["--impl", "bitpacked"], ["--impl", "einsum", "--dtype", "uint8"]):
        tmp = tmp_path_factory.mktemp("dac1")
        outs[impl[1]] = tmp / "one.npz"
        [(code, log)] = _distributed_ac(tmp, 1, [*impl, "--mesh", "1,1", "--check", "einsum",
                                                 "--check", "hopper_packed", "--out",
                                                 str(outs[impl[1]])])
        assert code == 0, log[-3000:]
        assert "single-device results (hopper_packed) ✓" in log
    return outs


@pytest.mark.parametrize("mesh,impl", [("1,4", ["--impl", "bitpacked"]),
                                       ("2,2", ["--impl", "einsum", "--dtype", "uint8"])])
def test_distributed_ac_on_four_gloo_ranks_equals_one_rank(one_rank_runs, tmp_path, mesh, impl):
    """`distributed_ac --network hashed` on 4 gloo ranks equals its 1-rank
    run on every rank (``--against``), every rank's first block call equals
    its plain version, the collectives are the plan's, nothing is staged;
    a changed saved result fails every rank."""
    want = one_rank_runs[impl[1]]
    runs = _distributed_ac(tmp_path, 4, [*impl, "--mesh", mesh, "--check", "plain",
                                         "--against", str(want), "--out",
                                         str(tmp_path / "four.npz")])
    for r, (code, log) in enumerate(runs):
        assert code == 0, f"rank {r}:\n{log[-3000:]}"
    log = runs[0][1]
    assert log.count("first block call bit-identical to plain") == 4
    assert "staged through host memory: {'data': False, 'model': False}" in log
    got, one = np.load(tmp_path / "four.npz"), np.load(want)
    for name in ("dom", "consistent", "k"):
        np.testing.assert_array_equal(got[name], one[name])
    assert int(got["k"].max()) >= 2 and not got["staged"]
    bad = dict(one)
    bad["k"] = bad["k"] + 1
    np.savez(tmp_path / "bad.npz", **bad)
    (tmp_path / "again").mkdir()
    runs = _distributed_ac(tmp_path / "again", 4, [*impl, "--mesh", mesh, "--check", "none",
                                                   "--against", str(tmp_path / "bad.npz")])
    assert all(code == 1 for code, _log in runs)
    assert "the results differ from" in runs[0][1]


def test_device_busy_counts_overlapping_device_work_once():
    """`distributed_ac.device_busy_ms` is the union of the device events'
    intervals: a kernel and an NCCL kernel that overlap it count once; a
    CPU event and a user annotation not at all."""
    from types import SimpleNamespace as Event

    from repro_torch.launch.distributed_ac import device_busy_ms

    def ev(start, end, device=torch.autograd.DeviceType.CUDA, annotation=False):
        return Event(time_range=Event(start=start, end=end), device_type=device,
                     is_user_annotation=annotation)

    events = [ev(0, 1000), ev(500, 2000), ev(3000, 3500), ev(3100, 3200),
              ev(0, 9000, torch.autograd.DeviceType.CPU), ev(0, 9000, annotation=True)]
    assert device_busy_ms(Event(events=lambda: events)) == 2.5  # us -> ms
    assert device_busy_ms(Event(events=lambda: [])) == 0.0


#: `mac_solve` / `solve_many` instances: model_rb at n = 12-20
SEARCH = [dict(n=n, hardness=0.9) for n in (12, 14, 17, 20)]
BUDGET = 200


def _stats_key(st):
    """Every SearchStats field except enforce_seconds."""
    return (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions, st.exhausted,
            st.rounds, st.rows, st.members, st.cancelled_members, st.quarantined, st.launches)


@pytest.mark.parametrize("i", range(len(SEARCH)))
def test_mac_solve_on_sharded_equals_the_reference(i):
    csp = ref_generate("model_rb", seed=i, **SEARCH[i])
    ref_sol, ref_st = ref_mac_solve(csp, engine="sharded", max_assignments=BUDGET)
    port_csp = csp_from_numpy(*(np.asarray(a) for a in csp), device="cpu")
    sol, st = mac_solve(port_csp, engine="sharded", device="cpu", max_assignments=BUDGET)
    assert sol == ref_sol
    assert _stats_key(st) == _stats_key(ref_st)


@pytest.mark.parametrize("impl", ["einsum", "bitpacked"])
def test_solve_many_on_sharded_equals_the_reference(impl):
    from repro.engines import get_engine as ref_get_engine
    from repro_torch.engines import get_engine

    n = SEARCH[0]["n"]
    csps = [ref_generate("model_rb", seed=s, n=n, hardness=0.9) for s in range(4)]
    ref_sols, ref_stats = ref_solve_many(csps, engine=ref_get_engine("sharded", impl=impl),
                                         max_assignments=BUDGET)
    port = [csp_from_numpy(*(np.asarray(a) for a in c), device="cpu") for c in csps]
    sols, stats = solve_many(port, engine=get_engine("sharded", device="cpu", impl=impl),
                             max_assignments=BUDGET)
    assert sols == ref_sols
    assert [_stats_key(s) for s in stats] == [_stats_key(s) for s in ref_stats]


def _single_network(n, d, b, seed=0):
    """A random network at (n, d), b domains and seeds (root, one-hot,
    several seeds, seedless), numpy."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.4
    mask = np.triu(mask, 1)
    mask |= mask.T
    cons = (rng.random((n, n, d, d)) < 0.25) & mask[:, :, None, None]
    dom = rng.random((b, n, d)) < 0.5
    changed = np.zeros((b, n), dtype=bool)
    changed[0] = True
    changed[1, 3] = True
    changed[2] = rng.random(n) < 0.3
    return cons, mask, dom, changed


@pytest.mark.parametrize("n,d", [(24, 8), (16, 40)])
@pytest.mark.parametrize("nx", [8, "half", "all"])
@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_block_plain_equals_slices_of_the_reference_kernels(kind, nx, n, d):
    """`packed_revise_block_plain` / `dense_revise_block_plain` on the rows
    of nx variables equal those rows of the reference's single-network
    kernels (interpret mode) and of `kernels/ref.py`'s revise."""
    cons, mask, dom, changed = _single_network(n, d, 4)
    nx = {"half": n // 2, "all": n}.get(nx, nx)
    x0 = n - nx
    w = -(-d // 32)
    ch_u8 = changed.astype(np.uint8)
    m_u8 = mask.astype(np.uint8)
    if kind == "packed":
        blk = np.asarray(ref_ref.pack_bits_ref(cons))  # (n, n, d, W), the reference's cons_blk_pk
        net = blk.transpose(0, 2, 1, 3).reshape(n * d, n * w)
        rows = np.asarray(ref_ref.pack_bits_ref(dom)).reshape(4, n * w)
        want = np.concatenate([np.asarray(ref_bs.packed_revise(
            net, rows[i:i + 1], ch_u8[i:i + 1], m_u8, d=d, w=w)) for i in range(4)])
        got = bs.packed_revise_block_plain(
            torch.from_numpy(blk[x0:].view(np.int32).copy()),
            torch.from_numpy(m_u8[x0:].copy()), torch.from_numpy(rows.view(np.int32).copy()),
            torch.from_numpy(ch_u8), d=d, w=w)
    else:
        net = cons.transpose(0, 2, 1, 3).reshape(n * d, n * d).astype(np.uint8)
        rows = dom.reshape(4, n * d).astype(np.uint8)
        want = np.concatenate([np.asarray(ref_rs.dense_revise(
            net, rows[i:i + 1], ch_u8[i:i + 1], m_u8, d=d)) for i in range(4)])
        got = rs.dense_revise_block_plain(
            torch.from_numpy(cons[x0:].astype(np.uint8)), torch.from_numpy(m_u8[x0:].copy()),
            torch.from_numpy(rows), torch.from_numpy(ch_u8), d=d)
    np.testing.assert_array_equal(got.numpy(), want[:, x0 * d:])
    oracle = np.stack([ref.revise_ref(*(torch.from_numpy(a) for a in (cons, mask, dom[i],
                                                                        changed[i])))
                       .reshape(-1).numpy() for i in range(4)])
    np.testing.assert_array_equal(got.numpy(), oracle[:, x0 * d:].astype(np.uint8))
    assert want[0].any() and not want[3].any()


@pytest.mark.parametrize("n,d", [(24, 8), (16, 40)])
@pytest.mark.parametrize("impl,dtype", [("bitpacked", torch.bfloat16), ("einsum", torch.uint8),
                                        ("einsum", torch.bfloat16)])
def test_block_layout_is_the_references_pair_major_block(impl, dtype, n, d):
    """`block_layout` of a rank's rows: bitpacked is the reference's
    ``cons_blk_pk = pack_bits_ref(cons)`` (nx, n, d, W) word for word; u8 is
    the bool block padded to (nx, n, d_p, d_p), d_p = d rounded up to 8;
    float is the block in ``dtype``."""
    from repro_torch.core.sharded import block_layout

    cons = _single_network(n, d, 4)[0][n // 2:]
    got = block_layout(torch.from_numpy(cons), impl, dtype)
    if impl == "bitpacked":
        want = np.asarray(ref_ref.pack_bits_ref(cons))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    elif dtype == torch.uint8:
        d_p = -(-d // 8) * 8
        want = np.zeros((n - n // 2, n, d_p, d_p), dtype=np.uint8)
        want[:, :, :d, :d] = cons
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), cons.astype(np.float32))


@pytest.mark.parametrize("rows,n,ok", [(1, 65535, True), (65535 * 32, 64, True),
                                       (1, 65536, False), (65535 * 32 + 1, 64, False)])
def test_block_revise_limits_raise_before_a_launch(rows, n, ok):
    """The block wrappers' shape check (`launch.check_block`): n up to 65535
    (a listed neighbour is a u16) and up to 65535 groups of 32 rows pass,
    with a CTA's shared memory under the limit at every such n; beyond
    either the wrapper raises instead of launching."""
    from repro_torch.kernels import launch

    if ok:
        launch.check_block("packed_revise_block", rows, n)
        assert launch.block_smem(n) <= launch.SMEM_OPT_IN_LIMIT
    else:
        with pytest.raises(ValueError, match="packed_revise_block"):
            launch.check_block("packed_revise_block", rows, n)
