"""The port's sharding helpers against the reference's: logical-axis specs
(`spec_for`, the reference's cases and a seeded sweep), collective-byte
accounting (`comm_stats` against `hlo_stats` on the same collectives), the
dry run's per-recurrence bytes, and the meshes and DTensor placements on a
one-rank gloo world."""

import numpy as np
import pytest
import torch

from repro.parallel import hlo_stats as ref_hlo
from repro.parallel import sharding as ref_sharding

from repro_torch.launch import dryrun_rtac, mesh as port_mesh
from repro_torch.parallel import comm_stats, sharding

MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 2, "model": 4}, {"data": 1, "model": 8}, {"model": 3}]


def _same(port_spec, ref_spec):
    return tuple(port_spec) == tuple(ref_spec)


def test_spec_demotion_and_one_use():
    """The reference's own cases (`tests/test_parallel_extras.py`)."""
    mesh_shape = {"data": 16, "model": 16}
    for axes, shape, rules in [
        (("embed", "heads", None), (1280, 20, 64), "param"),
        (("a", "b"), (32, 32), {"a": ("model",), "b": ("model",)}),
        ((None, "batch", "cache_seq", "kv_heads", None), (64, 128, 32768, 8, 128), "act"),
        ((None, "batch", "cache_seq", "kv_heads", None), (64, 1, 524288, 8, 128), "act"),
    ]:
        port_rules, ref_rules = {
            "param": (sharding.DEFAULT_PARAM_RULES, ref_sharding.DEFAULT_PARAM_RULES),
            "act": (sharding.DEFAULT_ACT_RULES, ref_sharding.DEFAULT_ACT_RULES),
        }[rules] if isinstance(rules, str) else (rules, rules)
        log, ref_log = [], []
        got = sharding.spec_for(axes, shape, port_rules, mesh_shape, log)
        want = ref_sharding.spec_for(axes, shape, ref_rules, mesh_shape, ref_log)
        assert _same(got, want) and log == ref_log
    assert sharding.spec_for(("embed", "heads", None), (1280, 20, 64),
                             sharding.DEFAULT_PARAM_RULES, mesh_shape) == sharding.P("data",
                                                                                      None, None)


def test_rule_tables_are_the_reference_tables():
    assert sharding.DEFAULT_PARAM_RULES == ref_sharding.DEFAULT_PARAM_RULES
    assert sharding.DEFAULT_ACT_RULES == ref_sharding.DEFAULT_ACT_RULES


@pytest.mark.parametrize("seed", range(6))
def test_spec_for_equals_the_reference_on_a_seeded_sweep(seed):
    """Random logical axes, sizes (divisible and not) and rule tables on
    every mesh shape: the same spec and the same demotion log lines."""
    rng = np.random.default_rng(seed)
    names = ["batch", "embed", "heads", "mlp", "vocab", "kv_heads", "cache_seq", "seq_q", "x"]
    axes_pool = ["data", "model", "pod"]
    for _ in range(40):
        mesh_shape = MESH_SHAPES[rng.integers(len(MESH_SHAPES))]
        rules = {nm: tuple(rng.permutation(axes_pool)[:rng.integers(0, 3)]) for nm in names}
        for table in (rules, sharding.DEFAULT_ACT_RULES, sharding.DEFAULT_PARAM_RULES):
            rank = int(rng.integers(1, 5))
            axes = [None if rng.random() < 0.2 else names[rng.integers(len(names))]
                    for _ in range(rank)]
            shape = [int(rng.choice([1, 3, 8, 16, 20, 32, 48, 256, 1280])) for _ in range(rank)]
            log, ref_log = [], []
            got = sharding.spec_for(axes, shape, table, mesh_shape, log)
            want = ref_sharding.spec_for(axes, shape, table, mesh_shape, ref_log)
            assert _same(got, want), (axes, shape, table, mesh_shape)
            assert log == ref_log


def _hlo_line(kind, result, groups):
    """One HLO instruction as the reference's parser reads it."""
    rg = "{" + ",".join("{" + ",".join(map(str, g)) + "}" for g in groups) + "}"
    return f"  %c = {result} {kind}(u8[4]{{0}} %x), replica_groups={rg}, dimensions={{0}}"


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_collective_stats_use_the_reference_ring_factors(group):
    """The same collectives as records and as HLO text: the port's dict
    equals `hlo_stats.collective_stats`, `total_wire_bytes` too."""
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all"]
    lines, records = [], []
    for i, kind in enumerate(kinds):
        elems = 16 * (i + 1)
        groups = [list(range(s, s + group)) for s in range(0, 8, group)]
        lines.append(_hlo_line(kind, f"pred[{elems}]{{0}}", groups))
        lines.append(_hlo_line(kind, f"f32[{elems},2]{{1,0}}", groups))
        records += [comm_stats.Collective(kind, elems, group),
                    comm_stats.Collective(kind, elems * 2 * 4, group)]
    want = ref_hlo.collective_stats("\n".join(lines))
    got = comm_stats.collective_stats(records)
    assert got == want
    assert comm_stats.total_wire_bytes(got) == ref_hlo.total_wire_bytes(want)


def test_recorded_all_gather_on_a_one_rank_world():
    """A world of one still issues (and records) the gather; it sends
    nothing."""
    port_mesh.init_world("cpu")
    mesh = port_mesh.host_device_mesh(1, 1, device="cpu")
    group = mesh.get_group("model")
    x = torch.arange(24, dtype=torch.int32).view(2, 3, 4) % 3 == 0
    with comm_stats.recording() as log:
        y = comm_stats.all_gather(x, group, dim=1)
    assert torch.equal(y, x)
    assert log == [comm_stats.Collective("all-gather", 24, 1)]
    assert comm_stats.collective_stats(log)["all-gather"]["wire_bytes"] == 0.0
    assert not comm_stats.staged(group, x)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_dryrun_per_recurrence_bytes_follow_comm_stats(mesh_kind):
    """Each variant's per-recurrence collectives on the production meshes:
    one all-gather of the rank's B/extent domains (n·d bool each) over 16
    model ranks, with `comm_stats`' ring factor; and the layouts' bytes."""
    n, d, batch = dryrun_rtac.N_VARS, dryrun_rtac.DOM, dryrun_rtac.BATCH
    extent = {"single": 16, "multi": 32}[mesh_kind]
    result = batch // extent * n * d
    want = {"all-gather": {"count": 1, "result_bytes": float(result),
                           "wire_bytes": result * comm_stats.wire_factor("all-gather", 16)}}
    cons = {"einsum-bf16": 256 * n * d * d * 2, "einsum-u8": 256 * n * d * d,
            "bitpacked": 256 * d * n * 4}
    for variant in dryrun_rtac.VARIANTS:
        rec = dryrun_rtac.run_variant(variant, mesh_kind)
        assert rec["collectives"] == want
        assert rec["collective_wire_bytes"] == result * 15 / 16
        assert rec["n_devices"] == {"single": 256, "multi": 512}[mesh_kind]
        assert rec["arguments"]["cons"] == cons[variant]
        assert ("cost_analysis" in rec) == variant.startswith("einsum")


@pytest.mark.parametrize("variant", list(dryrun_rtac.VARIANTS))
def test_dryrun_argument_bytes_are_the_layouts_bytes(variant):
    """The dry run's network and mask bytes are those of the blocks the
    sharded path really builds: `block_layout` and `mask_layout` of a rank's
    rows of a seeded network (d=10, so the u8 layout pads to 16)."""
    from repro_torch.core.sharded import block_layout, mask_layout

    n, d, model = 16, 10, 4
    impl, dtype = dryrun_rtac.VARIANTS[variant]
    rng = np.random.default_rng(0)
    cons = torch.as_tensor(rng.random((n // model, n, d, d)) < 0.5)
    mask = torch.as_tensor(rng.random((n // model, n)) < 0.5)
    rec = dryrun_rtac.plan(variant, {"data": 2, "model": model}, ("data",), n=n, d=d, batch=4)
    for name, t in (("cons", block_layout(cons, impl, dtype)),
                    ("mask", mask_layout(mask, impl, dtype))):
        assert rec["arguments"][name] == t.numel() * t.element_size(), name


def test_dryrun_formula_equals_the_reference_hlo_at_the_test_mesh():
    """At the (2, 4) test mesh, n=16, d=8, B=4 the formula gives the
    reference's compiled HLO counts: one all-gather, 256 B, 192 wire B."""
    rec = dryrun_rtac.plan("bitpacked", {"data": 2, "model": 4}, ("data",), n=16, d=8, batch=4)
    assert rec["collectives"] == {"all-gather": {"count": 1, "result_bytes": 256.0,
                                                 "wire_bytes": 192.0}}


def test_meshes_and_groups_on_a_one_rank_world():
    port_mesh.init_world("cpu")
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert port_mesh.make_mesh((1, 1), ("data", "model"), device="cpu") is mesh
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {"data": 1, "model": 1}
    group, size, index = port_mesh.axis_group(mesh, ("data",))
    assert (size, index) == (1, 0) and group is not None
    assert port_mesh.axis_group(mesh, ()) == (None, 1, 0)
    _g, size, index = port_mesh.axis_group(mesh, ("data", "model"))
    assert (size, index) == (1, 0)
    with pytest.raises(ValueError, match="order"):
        port_mesh.axis_group(mesh, ("model", "data"))
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            port_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        port_mesh.init_world("cpu", backend="nccl")


def test_placements_and_shard_act_on_a_one_rank_mesh():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    port_mesh.init_world("cpu")
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert sharding.placements_for(sharding.P("data", None), mesh) == [Shard(0), Replicate()]
    assert sharding.placements_for(sharding.P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert sharding.placements_for(sharding.P(("data", "model")), mesh) == [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        sharding.placements_for(sharding.P(("model", "data")), mesh)
    x = torch.arange(16.0).view(4, 4)
    assert sharding.shard_act(x, ("batch", "mlp")) is x  # outside a ctx
    ctx = sharding.make_ctx(mesh)
    with sharding.sharding_ctx(ctx):
        assert sharding.current_ctx() is ctx
        assert sharding.shard_act(x, ("batch", "mlp")) is x  # not a DTensor
        dt = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        out = sharding.shard_act(dt, ("batch", "mlp"))
        assert isinstance(out, DTensor)
        assert list(out.placements) == [Shard(0), Shard(1)]
        assert torch.equal(out.full_tensor(), x)
    assert sharding.current_ctx() is None
