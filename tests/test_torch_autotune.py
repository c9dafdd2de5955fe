"""The port's trace-driven autotuner (``repro_torch.runtime.autotune``)
against the reference's (``repro.runtime.autotune``).

First the reference's own cases (``tests/test_autotune.py``) on the port:
``AutotuneConfig``, overlays, ``TraceLog``, replay, calibration, the
search, a real engine's trace, and ``Supervisor.adopt_overlay``.  Then
parity: the port's ``replay`` and ``autotune`` give exactly the
reference's results on the same synthetic traces with the same stub cost
model (no tolerance); the port's engine records the same sequence of
events as the JAX engine on the same traffic and bridged weights (only
the clock fields differ); and an adopted overlay boots warm from a
program store.
"""
import importlib
import json
import types

import numpy as np
import pytest

import repro.launch.serve as jserve
from repro import engine_config as jec
import repro_torch.launch.serve as tserve
from repro_torch import engine_config as tec
from repro_torch.engine_config import (AutotuneConfig, ClusterConfig,
                                       EngineConfig, HorizonConfig,
                                       PagingConfig, SpecConfig)
from repro_torch.runtime.autotune import (CostModel, TraceLog, apply_overlay,
                                          autotune, config_overlay, replay)
from conftest import ForcedProposer
from test_torch_bench_serve import port_params

# the modules, not the packages' ``autotune`` functions of the same name
jat = importlib.import_module("repro.runtime.autotune")
tat = importlib.import_module("repro_torch.runtime.autotune")

ARCH = "qwen3-0.6b"


# ---------------------------------------------------------------------------
# helpers: synthetic traces + a count-free cost model, for either package
# ---------------------------------------------------------------------------
def _fake_req(rid, prompt_len=8, max_new=32, arrival=0.0):
    return types.SimpleNamespace(
        rid=rid, prompt_len=prompt_len, max_new=max_new,
        arrival_time=arrival, slot=0, ttft_s=1e-3,
        generated=list(range(max_new)))


def _synthetic_trace(config, n_requests=4, max_new=32, gap=0.05,
                     walls=None, path=None, at=tat):
    """A trace as the engine hooks would emit it: boot, submits, one
    prefill_slot per admission, decode dispatches until budgets drain."""
    walls = walls or {"prefill_slot": 2.0e-3, "decode": 1.5e-3}
    log = at.TraceLog(path)
    log.on_boot(ARCH, config)
    reqs = [_fake_req(i, max_new=max_new, arrival=i * gap)
            for i in range(n_requests)]
    for r in reqs:
        log.on_submit(r)
    for r in reqs:
        log.on_dispatch("prefill_slot", walls["prefill_slot"], active=1,
                        tokens=0, rid=r.rid)
        log.on_admit(r)
    for _ in range(max_new - 1):
        log.on_dispatch("decode", walls["decode"],
                        active=min(n_requests, config.batch),
                        tokens=min(n_requests, config.batch))
    for r in reqs:
        log.on_done(r)
    return log


UNIT = 1.0e-5


def _stub_modeled(self, config, program):
    """Analytic modeled seconds: per-token compute proportional to the
    program's in-graph iteration count; no count, no card."""
    self.compiles += 1
    if program == "prefill_slot":
        return UNIT * config.resolved_prefill_len / 4
    if program == "decode":
        return UNIT
    if program == "decode_horizon":
        return UNIT * config.horizon_length
    if program == "verify":
        return UNIT * (config.spec_k + 1)
    raise KeyError(program)


class _StubCostModel(CostModel):
    modeled_seconds = _stub_modeled


class _JStubCostModel(jat.CostModel):
    modeled_seconds = _stub_modeled


# ---------------------------------------------------------------------------
# AutotuneConfig
# ---------------------------------------------------------------------------
def test_autotune_config_validates_and_coerces():
    at = AutotuneConfig(horizons=[1, 8], batches=[2])   # JSON gives lists
    assert at.horizons == (1, 8) and at.batches == (2,)
    with pytest.raises(AssertionError):
        AutotuneConfig(horizons=())
    with pytest.raises(AssertionError):
        AutotuneConfig(spec_ks=(-1,))
    with pytest.raises(AssertionError):
        AutotuneConfig(min_gain=0.5)
    with pytest.raises(AssertionError):
        AutotuneConfig(arena_fracs=(1.5,))
    assert "AutotuneConfig" in tec.__all__
    assert AutotuneConfig().to_dict() == jec.AutotuneConfig().to_dict()


def test_autotune_config_dict_round_trip():
    at = AutotuneConfig(horizons=(1, 16), passes=3, min_gain=1.1)
    d = json.loads(json.dumps(at.to_dict()))
    assert AutotuneConfig.from_dict(d) == at
    with pytest.raises(TypeError):
        AutotuneConfig.from_dict({"no_such_knob": 1})


# ---------------------------------------------------------------------------
# overlays
# ---------------------------------------------------------------------------
def test_overlay_diff_and_apply_round_trip():
    base = EngineConfig(batch=4, max_len=128, prefill_len=16)
    tuned = base.replace(horizon=HorizonConfig(length=16), batch=8)
    ov = config_overlay(base, tuned)
    assert set(ov) == {"horizon", "batch"}
    assert apply_overlay(base, json.loads(json.dumps(ov))) == tuned
    assert config_overlay(base, base) == {}
    assert apply_overlay(base, {}) == base


def test_overlay_rejects_unknown_fields():
    base = EngineConfig(batch=4, max_len=128, prefill_len=16)
    with pytest.raises(TypeError):
        apply_overlay(base, {"warp_drive": True})


def test_overlay_can_disable_subsystems():
    base = EngineConfig(batch=4, max_len=128, prefill_len=16,
                        spec=SpecConfig(k=3))
    tuned = apply_overlay(base, {"spec": None})
    assert tuned.spec is None


# ---------------------------------------------------------------------------
# TraceLog
# ---------------------------------------------------------------------------
def test_tracelog_file_round_trip(tmp_path):
    cfg = EngineConfig(batch=2, max_len=64, prefill_len=16)
    path = tmp_path / "trace.jsonl"
    log = _synthetic_trace(cfg, path=str(path))
    log.close()
    loaded = TraceLog.load(str(path))
    assert loaded.events == log.events
    # identical replay result: the acceptance property of durability
    cm1, cm2 = _StubCostModel(ARCH), _StubCostModel(ARCH)
    cm1.calibrate(log)
    cm2.calibrate(loaded)
    assert replay(log, cost_model=cm1) == replay(loaded, cost_model=cm2)
    # save() re-serializes byte-identically
    log.save(str(tmp_path / "copy.jsonl"))
    assert (tmp_path / "copy.jsonl").read_text() == path.read_text()


def test_tracelog_queries():
    cfg = EngineConfig(batch=2, max_len=64, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=3, max_new=8)
    assert log.boot_config() == cfg
    reqs = log.requests()
    assert [r["rid"] for r in reqs] == [0, 1, 2]
    assert all(r["max_new"] == 8 for r in reqs)
    walls = log.dispatch_walls()
    assert set(walls) == {"prefill_slot", "decode"}
    assert len(walls["prefill_slot"]) == 3
    assert log.accept_rate() is None        # never speculated


def test_tracelog_second_boot_segment_excluded():
    cfg = EngineConfig(batch=2, max_len=64, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=2, max_new=4)
    n = len(log.dispatch_walls()["decode"])
    log.on_boot(ARCH, cfg.replace(batch=4))
    log.on_dispatch("decode", 99.0, active=4, tokens=4)
    assert len(log.dispatch_walls()["decode"]) == n      # new knobs, new key
    assert log.boot_config() == cfg


# ---------------------------------------------------------------------------
# replay simulator
# ---------------------------------------------------------------------------
def test_replay_traced_config_uses_traced_medians():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=32, gap=0.0)
    res = replay(log)                       # no cost model needed: all
    assert res.requests == 4                # programs traced
    assert res.tokens == 4 * 32
    # 4 slots decode in lockstep: 31 decode dispatches at the traced
    # 1.5 ms median
    assert res.decode_dispatches == 31
    assert res.decode_path_s == pytest.approx(31 * 1.5e-3)


def test_replay_horizon_amortizes_dispatches():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=32, gap=0.0)
    cm = _StubCostModel(ARCH)
    cm.calibrate(log)
    base = replay(log, cost_model=cm)
    fused = replay(log, cfg.replace(horizon=HorizonConfig(length=16)),
                   cost_model=cm)
    assert fused.decode_dispatches < base.decode_dispatches
    assert fused.decode_tok_per_s > 1.2 * base.decode_tok_per_s
    assert fused.tokens == base.tokens      # knobs never change streams


def test_replay_batch_bounds_concurrency():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=32, gap=0.0)
    cm = _StubCostModel(ARCH)
    cm.calibrate(log)
    wide = replay(log, cost_model=cm)
    narrow = replay(log, cfg.replace(batch=1), cost_model=cm)
    assert narrow.tokens == wide.tokens
    assert narrow.decode_dispatches > wide.decode_dispatches
    assert narrow.decode_tok_per_s < wide.decode_tok_per_s


def test_replay_arena_capacity_defers_admission():
    paged = EngineConfig(batch=4, max_len=64, prefill_len=16,
                         paging=PagingConfig(kv_block=8))
    log = _synthetic_trace(paged, n_requests=4, max_new=16, gap=0.0)
    cm = _StubCostModel(ARCH)
    cm.calibrate(log)
    full = replay(log, cost_model=cm)
    # arena for ~1 request: admissions serialize, wall stretches
    tight = replay(log, paged.replace(paging=PagingConfig(
        kv_block=8, arena_blocks=4)), cost_model=cm)
    assert tight.tokens == full.tokens
    assert tight.wall_s > full.wall_s
    assert tight.ttft_mean_s > full.ttft_mean_s


def test_replay_spec_needs_traced_evidence():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=32, gap=0.0)
    cm = _StubCostModel(ARCH)
    cm.calibrate(log)
    plain = replay(log, cost_model=cm)
    spec = replay(log, cfg.replace(spec=SpecConfig(k=3)), cost_model=cm)
    # the 0.1 prior rounds to zero accepted drafts: speculation must not
    # look like a win without traced acceptance evidence
    assert spec.decode_tok_per_s <= plain.decode_tok_per_s * 1.05


def _spec_trace(at, ec):
    cfg = ec.EngineConfig(batch=2, max_len=128, prefill_len=16,
                          spec=ec.SpecConfig(k=3))
    log = at.TraceLog()
    log.on_boot(ARCH, cfg)
    for r in [_fake_req(0, max_new=32), _fake_req(1, max_new=32)]:
        log.on_submit(r)
        log.on_dispatch("prefill_slot", 2e-3, active=1, tokens=0)
        log.on_admit(r)
    for _ in range(10):
        log.on_dispatch("verify", 2e-3, active=2, tokens=8,
                        drafted=6, accepted=6)   # accept rate 1.0
    return log


def test_replay_uses_traced_accept_rate():
    log = _spec_trace(tat, tec)
    assert log.accept_rate() == 1.0
    res = replay(log)
    # k=3 at full acceptance: 4 tokens per slot per dispatch
    assert res.decode_dispatches * 2 * 4 >= res.tokens


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
OVERHEAD, SCALE = 1.2e-3, 30.0


def _two_shape_trace(at, ec, cm_truth):
    """Two decode-family shapes (decode + verify) on the line
    ``OVERHEAD + SCALE * modeled``."""
    cfg = ec.EngineConfig(batch=4, max_len=128, prefill_len=16,
                          spec=ec.SpecConfig(k=3))
    log = at.TraceLog()
    log.on_boot(ARCH, cfg)
    for program in ("prefill_slot", "decode", "verify"):
        w = OVERHEAD + SCALE * cm_truth.modeled_seconds(cfg, program)
        log.on_dispatch(program, w, active=4, tokens=4)
    return cfg, log


def test_calibration_recovers_overhead_and_scale():
    cfg, log = _two_shape_trace(tat, tec, _StubCostModel(ARCH))
    cm = _StubCostModel(ARCH)
    fit = cm.calibrate(log)
    assert fit["points"] == 3 and fit["decode_points"] == 2
    assert cm.overhead == pytest.approx(OVERHEAD, rel=1e-6)
    assert cm.scale == pytest.approx(SCALE, rel=1e-6)
    # prediction for an untraced decode-family shape: H=8 horizon
    fused = cfg.replace(horizon=HorizonConfig(length=8))
    want = OVERHEAD + SCALE * _StubCostModel(ARCH).modeled_seconds(
        fused, "decode_horizon")
    assert cm.predict(fused, "decode_horizon") == pytest.approx(want)


def test_calibration_single_shape_uses_dispatch_floor_prior():
    # the common trace (plain decode only on the decode path) cannot
    # split overhead from compute: overhead_frac decides the split, and
    # prefill calibrates its own through-origin scale
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, walls={"prefill_slot": 2e-3,
                                       "decode": 1.5e-3})
    cm = _StubCostModel(ARCH)
    cm.calibrate(log)
    assert cm.overhead == pytest.approx(0.7 * 1.5e-3)
    assert cm.scale >= 0.0
    assert cm.predict(cfg, "decode") == pytest.approx(1.5e-3)
    assert cm.predict(cfg, "prefill_slot") == pytest.approx(2e-3)
    # fused dispatches amortize the floor: H x tokens cost far less
    # than H x the single-step wall
    fused = cfg.replace(horizon=HorizonConfig(length=16))
    assert cm.predict(fused, "decode_horizon") < 16 * 1.5e-3


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------
def test_autotune_picks_deep_horizon_on_chat_workload():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=64, gap=0.0)
    res = autotune(log, AutotuneConfig(horizons=(1, 4, 16), spec_ks=(0,),
                                       batches=(4,), passes=2),
                   cost_model=_StubCostModel(ARCH))
    assert res.overlay == {"horizon": {"length": 16}}
    assert res.predicted_speedup > 1.2
    assert res.best_config.horizon_length == 16
    # base + every distinct candidate was scored and reported
    overlays = [json.dumps(t["overlay"], sort_keys=True)
                for t in res.trials]
    assert json.dumps({}) in overlays and len(set(overlays)) >= 3
    assert res.calibration["points"] == 2


def test_autotune_min_gain_hysteresis_keeps_base():
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=4, max_new=64, gap=0.0)
    res = autotune(log, AutotuneConfig(horizons=(1, 4, 16), spec_ks=(0,),
                                       batches=(4,), passes=2,
                                       min_gain=1e9),
                   cost_model=_StubCostModel(ARCH))
    assert res.overlay == {}
    assert res.best_config == res.base_config


def test_autotune_skips_inexpressible_moves():
    # unpaged base: kv_block / arena / timeslice axes must be no-ops
    cfg = EngineConfig(batch=4, max_len=128, prefill_len=16)
    log = _synthetic_trace(cfg, n_requests=2, max_new=16, gap=0.0)
    res = autotune(log, AutotuneConfig(horizons=(1,), spec_ks=(0,),
                                       batches=(4,), kv_blocks=(8, 16),
                                       arena_fracs=(0.5, 1.0),
                                       timeslices=(None, 8), passes=1),
                   cost_model=_StubCostModel(ARCH))
    assert res.overlay == {}
    assert len(res.trials) == 1             # only the base was scorable


# ---------------------------------------------------------------------------
# integration: a real engine records, the trace replays
# ---------------------------------------------------------------------------
def test_engine_records_replayable_trace(tmp_path):
    path = tmp_path / "trace.jsonl"
    trace = TraceLog(str(path))
    cfg = EngineConfig(batch=2, max_len=64, prefill_len=8, clock="step",
                       device="cpu")
    eng = tserve.ServingEngine(ARCH, cfg, trace=trace)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, size=6),
                   max_new=10, arrival_time=float(i))
    stats = eng.run()
    trace.close()

    evs = [e["ev"] for e in trace.events]
    assert evs.count("boot") == 1
    assert evs.count("submit") == 3 and evs.count("done") == 3
    assert evs.count("admit") == 3
    disp = [e for e in trace.events if e["ev"] == "dispatch"]
    assert sum(e["program"] == "prefill_slot" for e in disp) == 3
    decode = [e for e in disp if e["program"] == "decode"]
    assert len(decode) == stats["decode_steps"]
    assert sum(e["tokens"] for e in decode) == stats["decode_tokens"]
    assert all(e["wall_s"] > 0 for e in disp)
    # the trace's decode walls are the host-call metrics' (one dt)
    assert [1e3 * e["wall_s"] for e in decode] == \
        eng.syscore.hostcalls.metrics[tserve.METRIC_DECODE_MS]
    # stamps are monotonic across the whole event stream
    ts = [e["t"] for e in trace.events]
    assert ts == sorted(ts)
    assert trace.boot_config() == cfg

    # per-dispatch monotonic stamps in the coalesced step telemetry,
    # surfaced through report()["hostcalls"]
    hc = eng.syscore.hostcalls
    assert len(hc.step_stamps) == len(hc.step_times)
    assert all(t is not None for t in hc.step_stamps)
    assert hc.step_stamps == sorted(hc.step_stamps)
    summary = eng.syscore.report()["hostcalls"]
    assert summary["step_stamps"] == len(hc.step_stamps)
    assert summary["step_span_s"] >= 0.0
    eng.drain_completed()
    assert hc.step_stamps == [] and hc.step_times == []

    # the durable file round-trips into an identical replay
    loaded = TraceLog.load(str(path))
    assert loaded.events == trace.events
    assert replay(loaded) == replay(trace)


def test_supervisor_adopts_overlay_for_future_boots():
    from repro_torch.cluster import Supervisor

    ecfg = EngineConfig(batch=2, max_len=64, prefill_len=8, clock="step",
                        device="cpu")
    sup = Supervisor(ARCH, ClusterConfig(engine=ecfg, replicas=1))
    try:
        assert sup.replicas[0].engine.horizon is None
        sup.adopt_overlay({"horizon": {"length": 4}})
        assert sup.config.engine.horizon_length == 4
        # running replicas keep their knobs; only future boots adopt
        assert sup.replicas[0].engine.horizon is None
        eng = sup._boot_engine(1)
        assert eng.horizon == 4
    finally:
        sup.close()


def test_adopted_overlay_boots_warm_from_the_store(tmp_path):
    """The tuned config's first boot exports its programs into the
    fleet's store; every later boot of it is warm: each program from the
    store, no program function called, one hit a program, no put,
    nothing exported."""
    from repro_torch.bench.boot import EntryPointCounter
    from repro_torch.bench.cluster import boot_checks
    from repro_torch.cluster import Supervisor

    ecfg = EngineConfig(batch=2, max_len=64, prefill_len=8, clock="step",
                        device="cpu")
    sup = Supervisor(ARCH, ClusterConfig(
        engine=ecfg, replicas=1, store_dir=str(tmp_path / "store")))
    try:
        sup.adopt_overlay({"horizon": {"length": 4}})
        cold = sup._boot_engine(1)
        assert set(cold.programs) == {"prefill_slot", "decode",
                                      "decode_horizon"}
        # the horizon leaves prefill_slot's and decode's fingerprints as
        # they were: only decode_horizon is new to the store
        assert sup.store.puts == 2 + 1
        store0 = (sup.store.hits, sup.store.misses, sup.store.puts)
        with EntryPointCounter() as counter:
            warm = sup._boot_engine(1)
        checks = boot_checks({"engine": warm, "python_calls": counter.calls,
                              "replica": 1})
        assert checks["warm"], checks
        assert (sup.store.hits - store0[0], sup.store.misses - store0[1],
                sup.store.puts - store0[2]) == (3, 0, 0)
        rng = np.random.default_rng(0)
        prompt = rng.integers(1, warm.cfg.vocab_size, size=6)
        want = cold.submit(prompt, max_new=12)
        cold.run()
        got = warm.submit(prompt, max_new=12)
        warm.run()
        assert got.generated == want.generated
        assert warm.horizon_steps >= 1
        # a background grow preloads a live replica's programs only when
        # that replica runs the current config
        assert sup._stored_programs() == []
    finally:
        sup.close()


# ---------------------------------------------------------------------------
# parity with the reference's autotuner
# ---------------------------------------------------------------------------
def _both(fn):
    """Run ``fn(autotune module, engine_config module, stub class)`` for
    the reference and the port."""
    return (fn(jat, jec, _JStubCostModel), fn(tat, tec, _StubCostModel))


def _sim(res):
    return res.to_dict()


def _search(res):
    return {"overlay": res.overlay, "trials": res.trials,
            "calibration": res.calibration,
            "predicted": res.predicted.to_dict(),
            "base_predicted": res.base_predicted.to_dict(),
            "predicted_speedup": res.predicted_speedup}


SCENARIOS = ["chat", "staggered_default_grid", "paged", "spec",
             "two_shapes", "min_gain"]


def _scenario(name, at, ec, stub):
    """(trace, grid, candidate configs) of one scenario, built with one
    package's classes."""
    if name == "spec":
        log = _spec_trace(at, ec)
        return log, ec.AutotuneConfig(), []
    if name == "two_shapes":
        cfg, log = _two_shape_trace(at, ec, stub(ARCH))
        return log, ec.AutotuneConfig(horizons=(1, 4, 8), batches=(2, 4)), \
            [cfg.replace(horizon=ec.HorizonConfig(length=8))]
    if name == "paged":
        cfg = ec.EngineConfig(batch=4, max_len=64, prefill_len=16,
                              paging=ec.PagingConfig(kv_block=8))
        log = _synthetic_trace(cfg, n_requests=6, max_new=16, gap=0.02,
                               at=at)
        grid = ec.AutotuneConfig(horizons=(1, 4), spec_ks=(0,),
                                 batches=(2, 4, 8), kv_blocks=(8, 16),
                                 arena_fracs=(0.25, 0.5, 1.0, None),
                                 timeslices=(None, 4))
        return log, grid, [cfg.replace(paging=ec.PagingConfig(
            kv_block=8, arena_blocks=4, timeslice=4))]
    cfg = ec.EngineConfig(batch=4, max_len=128, prefill_len=16)
    if name == "chat":
        log = _synthetic_trace(cfg, n_requests=4, max_new=64, gap=0.0,
                               at=at)
        return log, ec.AutotuneConfig(horizons=(1, 4, 16), spec_ks=(0,),
                                      batches=(4,)), \
            [cfg.replace(horizon=ec.HorizonConfig(length=16))]
    if name == "min_gain":
        log = _synthetic_trace(cfg, n_requests=4, max_new=64, gap=0.0,
                               at=at)
        return log, ec.AutotuneConfig(min_gain=1e9), []
    log = _synthetic_trace(cfg, n_requests=7, max_new=40, gap=0.003,
                           walls={"prefill_slot": 3.1e-3,
                                  "decode": 1.7e-3}, at=at)
    return log, ec.AutotuneConfig(), [cfg.replace(batch=2),
                                      cfg.replace(spec=ec.SpecConfig(k=3))]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_replay_and_search_equal_the_reference(scenario):
    def go(at, ec, stub):
        log, grid, cands = _scenario(scenario, at, ec, stub)
        cm = stub(ARCH)
        cm.calibrate(log)
        sims = [_sim(at.replay(log))] + \
            [_sim(at.replay(log, c, cost_model=cm)) for c in cands]
        return sims, _search(at.autotune(log, grid, cost_model=stub(ARCH)))

    (jsims, jsearch), (tsims, tsearch) = _both(go)
    assert tsims == jsims
    assert tsearch == jsearch


def test_engine_trace_equals_the_reference_engine(monkeypatch):
    """The JAX engine and the port's serve the same traffic on the same
    weights with speculation (k 2) and horizons (H 4), drafts offered on
    every third proposal: the same events in the same order, with the
    same programs, request ids, occupancy, tokens and draft counts."""

    class EveryThird(ForcedProposer):
        def __init__(self, ngram):
            super().__init__(ngram)
            self.calls = 0

        def propose(self, k):
            self.calls += 1
            return super().propose(k) if self.calls % 3 == 0 else []

    monkeypatch.setattr(jserve, "NGramProposer", EveryThird)
    monkeypatch.setattr(tserve, "NGramProposer", EveryThird)
    kw = dict(reduced=True, batch=2, max_len=64, prefill_len=8,
              clock="step")
    jtrace, ttrace = jat.TraceLog(), TraceLog()
    jeng = jserve.ServingEngine(ARCH, jec.EngineConfig(
        **kw, spec=jec.SpecConfig(k=2),
        horizon=jec.HorizonConfig(length=4)), trace=jtrace)
    teng = tserve.ServingEngine(ARCH, EngineConfig(
        **kw, spec=SpecConfig(k=2), horizon=HorizonConfig(length=4),
        device="cpu"), params=port_params(ARCH), trace=ttrace)
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 500, size=6), int(m), float(i))
            for i, m in enumerate((12, 9, 11))]
    streams = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new=m, arrival_time=a)
                for p, m, a in work]
        eng.run()
        streams.append([list(r.generated) for r in reqs])
    assert streams[0] == streams[1]

    def strip(ev):
        return {k: v for k, v in ev.items()
                if k not in ("t", "wall_s", "ttft_s", "config")}

    assert [strip(e) for e in ttrace.events] == \
        [strip(e) for e in jtrace.events]
    programs = {e["program"] for e in ttrace.events
                if e["ev"] == "dispatch"}
    assert programs == {"prefill_slot", "verify", "decode_horizon",
                        "decode"}
    # the round trip replays the same on both sides' schema
    assert replay(ttrace).to_dict()["tokens"] == \
        jat.replay(jtrace).to_dict()["tokens"]
