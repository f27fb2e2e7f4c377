"""`repro_torch.kernels.autotune`: bucket keys as the reference's, its own
cache and env gate, the default schedule equal to the unscheduled launch,
stale cache fields dropped, and the search itself (timing stubbed here; on
the card the ``gpu`` cases hold every candidate bit for bit against the
plain version)."""

import json

import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch import obs
from repro_torch.kernels import autotune, bitpack_support as bs, rtac_support as rs

#: `revise::single_span` (csrc/revise_common.cuh) at n = 104 on an H100's
#: 132 SMs, for B = 1 .. 64 rows: 13 CTAs a row (one variable a warp) up to
#: B = 43, 7 CTAs a row from B = 44
SPAN_AT_104 = {b: 8 for b in range(1, 44)} | {b: 16 for b in range(44, 65)}


@pytest.fixture(autouse=True)
def clean_tables(monkeypatch, tmp_path):
    """Every test starts with empty tables, no gate and a cache of its own."""
    monkeypatch.delenv(autotune.TUNE_ENV, raising=False)
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    autotune.reset()
    yield
    autotune.reset()


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n_p,d_p,r", [(104, 40, 1024), (16, 8, 1), (128, 64, 100), (40, 16, 3)])
def test_bucket_key_equals_the_reference(kind, n_p, d_p, r):
    w = autotune.entry_words(kind, d_p)
    assert w == (-(-d_p // 32) if kind == "packed" else 0)
    assert autotune.bucket_key(kind, n_p, d_p, w, r) == ref_autotune.bucket_key(kind, n_p, d_p,
                                                                                 w, r)


def test_cache_round_trips_under_its_own_schema(tmp_path):
    path = tmp_path / "c.json"
    autotune._CONFIGS["packed/n104/d40/w2/r1024"] = autotune.TuneConfig(width="runtime")
    autotune._CONFIGS["dense_single/n104/d40/w0/r2"] = autotune.TuneConfig(span=16)
    autotune.save_cache(path)
    payload = json.loads(path.read_text())
    assert payload["schema"] == "repro-torch-autotune/v1" != ref_autotune.SCHEMA
    assert payload["configs"] == {"dense_single/n104/d40/w0/r2": {"span": 16},
                                  "packed/n104/d40/w2/r1024": {"width": "runtime"}}
    autotune.reset()
    assert autotune.load_cache(path) == 2
    assert autotune.get_config("packed", 104, 40, 2, 600) == autotune.TuneConfig(width="runtime")
    assert autotune.get_config("dense_single", 104, 40, 0, 2) == autotune.TuneConfig(span=16)
    ref_autotune.reset()  # neither package reads the other's cache
    try:
        assert ref_autotune.load_cache(path) == 0
        ref_autotune._CONFIGS["packed/n16/d8/w1/r8"] = ref_autotune.TuneConfig(8, 8, 8, "xy")
        ref_autotune.save_cache(tmp_path / "ref.json")
    finally:
        ref_autotune.reset()
    autotune.reset()
    assert autotune.load_cache(tmp_path / "ref.json") == 0


def test_launchers_have_scheduled_variants_and_obs_names_are_the_references():
    import inspect

    from repro_torch.kernels import launch

    assert set(launch.SIGNATURES) == set(launch.SCHEDULED) | set(launch.UNSCHEDULED)
    assert set(launch.SCHEDULED) >= set(launch.BLOCK) | set(launch.SPLIT)
    assert not set(launch.SCHEDULED) & set(launch.UNSCHEDULED)
    for library, launchers in launch.UNSCHEDULED.items():  # no schedule, no variant
        assert launch.SIGNATURES[library] == launchers
    for library in launch.SCHEDULED:
        launchers = launch.SIGNATURES[library]
        plain = launch.SCHEDULED[library]
        block = {**launch.BLOCK.get(library, {}), **launch.SPLIT.get(library, {})}
        assert plain and len(launchers) == 2 * len(plain) + len(block), library
        for name, (ptrs, ints) in plain.items():
            assert launchers[name] == (ptrs, ints)
            assert launchers[f"{name}_sched"] == (ptrs, ints + 1)
        # the caller always gives a block launch's span, a split launch's CTAs
        for name, sig in block.items():
            assert launchers[name] == sig and f"{name}_sched" not in launchers
    ref_source, source = inspect.getsource(ref_autotune), inspect.getsource(autotune)
    for name in ('"autotune.search"', '"autotune.tuned_buckets"', '"autotune.search_seconds"'):
        assert name in ref_source and name in source


@pytest.mark.parametrize("content", [
    json.dumps({"schema": "repro-autotune/v1",  # the reference's cache
                "configs": {"packed/n16/d8/w1/r8": {"block_r": 8, "block_rx": 8,
                                                    "block_ry": 8, "sweep": "xy"}}}),
    "{not json",
    json.dumps({"schema": "repro-torch-autotune/v1",
                "configs": {"packed/n16/d8/w1/r8": {"width": "compiled"},
                            "packed_single/n16/d8/w1/r8": {"span": "wide"}}}),
    json.dumps({"schema": "repro-torch-autotune/v1", "configs": ["packed"]}),
], ids=["reference_schema", "corrupt", "bad_entry", "bad_table"])
def test_a_wrong_schema_or_corrupt_cache_loads_nothing(tmp_path, content):
    path = tmp_path / "c.json"
    path.write_text(content)
    assert autotune.load_cache(path) == 0
    assert autotune.get_config("packed", 16, 8, 1, 8) == autotune.default_config("packed", 16,
                                                                                  8, 8)


def test_cache_path_env_override_and_default(monkeypatch, tmp_path):
    assert autotune.cache_path() == tmp_path / "autotune.json"
    monkeypatch.delenv(autotune.CACHE_ENV)
    default = autotune.cache_path()
    assert default.parts[-3:] == (".cache", "repro_torch", "autotune.json")
    monkeypatch.delenv(ref_autotune.CACHE_ENV, raising=False)
    assert default != ref_autotune.cache_path()
    assert (autotune.TUNE_ENV, autotune.CACHE_ENV) == ("REPRO_TORCH_AUTOTUNE",
                                                       "REPRO_TORCH_AUTOTUNE_CACHE")


def test_single_span_mirrors_the_kernels_rule():
    assert {b: autotune.single_span(b, 104, sms=132) for b in range(1, 65)} == SPAN_AT_104
    assert autotune.single_span(1, 104) == 8  # no card here: an H100's SM count
    assert autotune.single_span(1024, 104, sms=132) == 104  # one CTA a row
    assert autotune.single_span(128, 128, sms=132) == 32


@pytest.mark.parametrize("kind,d_p,width", [
    ("packed", 40, "compiled"), ("packed", 16, "compiled"), ("packed", 72, "runtime"),
    ("dense", 16, "compiled"), ("dense", 40, "runtime"), ("dense", 64, "runtime"),
    ("packed_revise", 40, "compiled"), ("packed_revise", 16, "compiled"),
    ("dense_revise", 16, "compiled"), ("dense_revise", 40, "runtime"),
])
def test_an_untuned_bucket_gets_todays_width(kind, d_p, width):
    assert autotune.default_config(kind, 104, d_p, 64) == autotune.TuneConfig(width=width)
    assert autotune.get_config(kind, 104, d_p, autotune.entry_words(kind, d_p), 64) == \
        autotune.TuneConfig(width=width)
    assert autotune.schedule(kind, 104, d_p, autotune.entry_words(kind, d_p), 64) is None


@pytest.mark.parametrize("kind", autotune.SPAN_KINDS)
def test_an_untuned_single_network_bucket_gets_todays_span(kind):
    w = autotune.entry_words(kind, 40)
    for b in (1, 2, 4, 8, 16, 32, 64):
        assert autotune.get_config(kind, 104, 40, w, b) == autotune.TuneConfig(span=SPAN_AT_104[b])
        assert autotune.schedule(kind, 104, 40, w, b) is None
    spans = [c.span for c in autotune.candidate_configs(kind, 104, 40, 2)]
    assert spans == [104, 56, 40, 32, 24, 16, 8] and set(SPAN_AT_104.values()) <= set(spans)


@pytest.mark.parametrize("kind,cfg,kept", [
    ("packed_single", autotune.TuneConfig(span=16), True),
    ("packed_single", autotune.TuneConfig(span=104), True),
    ("packed_single", autotune.TuneConfig(span=12), False),
    ("packed_single", autotune.TuneConfig(span=112), False),
    ("dense_single", autotune.TuneConfig(span=0), False),
    ("dense_single", autotune.TuneConfig(width="runtime"), False),
    ("dense", autotune.TuneConfig(width="compiled"), False),  # d/8 = 5: none compiled
    ("dense", autotune.TuneConfig(width="runtime"), True),
    ("packed", autotune.TuneConfig(width="compiled"), True),
    ("packed_revise", autotune.TuneConfig(width="fast"), False),
])
def test_sanitize_drops_stale_fields(kind, cfg, kept):
    autotune._CONFIGS[autotune.bucket_key(kind, 104, 40, autotune.entry_words(kind, 40), 2)] = cfg
    got = autotune.ensure_tuned(kind, 104, 40, autotune.entry_words(kind, 40), 2)
    default = autotune.default_config(kind, 104, 40, 2)
    assert got == (cfg if kept else default)
    assert got == autotune.get_config(kind, 104, 40, autotune.entry_words(kind, 40), 2)


def test_the_gate_and_the_cpu_never_tune(monkeypatch):
    assert autotune.maybe_tune("packed", 104, 40, 2, 64) is None
    monkeypatch.setenv(autotune.TUNE_ENV, "1")
    assert autotune.maybe_tune("packed", 104, 40, 2, 64, device="cpu") is None
    assert autotune.schedule("packed", 104, 40, 2, 64) is None and not autotune._CONFIGS
    with pytest.raises(RuntimeError, match="nothing to tune"):
        autotune.tune("packed", 16, 8, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        autotune.tune("sweep", 16, 8, device="cpu")


def test_tune_picks_the_minimum_saves_it_and_is_traced(monkeypatch, tmp_path):
    """`tune` with the timing stubbed to a fixed table (the CPU has no card
    to time): the fastest candidate wins, the cache holds it, the search is
    one `autotune.search` span that ticks `autotune.tuned_buckets`; the gate
    then makes it the wrappers' schedule."""
    table = {104: 9.0, 56: 5.0, 40: 3.0, 32: 2.5, 24: 4.0, 16: 6.0, 8: 7.0}
    monkeypatch.setattr(autotune, "_card", lambda device: torch.device("cpu"))
    monkeypatch.setattr(autotune, "_tune_workload", lambda *a: None)
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda kind, wl, cfg, repeats: table[cfg.span] * 1e-6)
    tracer = obs.enable()
    try:
        with obs.REGISTRY.scope() as scope:
            best = autotune.tune("packed_single", 104, 40, 3)
    finally:
        obs.disable()
    assert best == autotune.TuneConfig(span=32)
    key = "packed_single/n104/d40/w2/r4"
    assert [(c.span, t) for c, t in autotune.SEARCHES[key]] == \
        [(s, table[s] * 1e-6) for s in table]
    assert scope.delta()["counters"]["autotune.tuned_buckets"] == 1
    assert scope.delta()["histograms"]["autotune.search_seconds"]["count"] == 1
    spans = [s for s in tracer.snapshot_spans() if s["name"] == "autotune.search"]
    assert len(spans) == 1 and spans[0]["args"]["candidates"] == len(table)
    saved = json.loads((tmp_path / "autotune.json").read_text())
    assert saved["configs"] == {key: {"span": 32}}

    autotune.reset()
    monkeypatch.setenv(autotune.TUNE_ENV, "1")
    assert autotune.maybe_tune("packed_single", 104, 40, 2, 3, device="cuda") == best
    assert autotune.schedule("packed_single", 104, 40, 2, 4) == 32
    assert autotune.schedule("packed_single", 104, 40, 2, 8) is None


@pytest.mark.parametrize("kind", sorted(autotune.KINDS))
def test_tuning_workload_is_the_kinds_operands(kind):
    """The seeded workload feeds the kind's wrapper as it is (on the CPU,
    its plain version): the main path's 7:1 mix of rows for the stacked
    kinds, multi-seed children of one network for the single-network
    ones."""
    wl = autotune._tune_workload(kind, 16, 8, 16, "cpu")
    again = autotune._tune_workload(kind, 16, 8, 16, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(wl.args, again.args))
    seed = wl.args[-1].bool()
    if kind in autotune.SPAN_KINDS:
        assert seed.shape == (16, 16) and bool(seed.any(dim=1).all())
    else:
        assert int(seed.all(dim=1).sum()) == 2 and int((seed.sum(dim=1) == 1).sum()) == 14
        assert wl.args[2].tolist() == [i % 3 for i in range(16)]
    plain = autotune.run_candidate(kind, wl, None)
    for cfg in autotune.candidate_configs(kind, 16, 8, 16):
        got = autotune.run_candidate(kind, wl, cfg)
        pairs = zip(got, plain) if isinstance(plain, tuple) else [(got, plain)]
        assert all(torch.equal(g, p) for g, p in pairs)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(autotune.KINDS))
@pytest.mark.parametrize("n_p,d_p", [(104, 40), (128, 16)])
def test_every_candidate_is_bit_identical_to_plain(cuda, kind, n_p, d_p):
    for r in (4, 64):
        wl = autotune._tune_workload(kind, n_p, d_p, r, cuda)
        want = autotune.run_candidate(kind, wl, None)
        for cfg in autotune.candidate_configs(kind, n_p, d_p, r):
            got = autotune.run_candidate(kind, wl, cfg)
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            for g, p in pairs:
                assert torch.equal(g, p), (kind, n_p, d_p, r, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(autotune.KINDS))
def test_an_explicit_default_schedule_equals_the_unscheduled_launch(cuda, kind):
    module, name = autotune.KINDS[kind]
    fn = getattr(bs if module == "bitpack_support" else rs, name)
    for r in (1, 3, 64):
        wl = autotune._tune_workload(kind, 104, 40, r, cuda)
        default = autotune.default_config(kind, 104, 40, r)
        if kind in autotune.SPAN_KINDS:
            default = autotune.TuneConfig(span=autotune.single_span(r, 104))
        plain = fn(*wl.args, **wl.kw)
        explicit = fn(*wl.args, **wl.kw, sched=default.sched())
        zero = fn(*wl.args, **wl.kw, sched=0)  # the C default rule
        pairs = zip(plain, explicit, zero) if isinstance(plain, tuple) else [(plain, explicit,
                                                                             zero)]
        for a, b, c in pairs:
            assert torch.equal(a, b) and torch.equal(a, c)
