"""The port's elastic fleet (``repro_torch.cluster`` with ``ScaleConfig``):
grow on sustained load, shrink on idle, straggler-triggered replacement,
on the CPU in fp32 at reduced size.  The cases of
``tests/test_elastic_cluster.py``, held to the same properties: every
spawned replica boots warm from the shared store, a shrink or a
replacement loses no request, and under every schedule the merged streams
equal one engine's on the same requests.

The straggler cases drive the monitors from an injected clock (the
supervisor's ``clock=``): a degraded replica's tick advances it, nothing
sleeps.  An ``async_spawn`` case grows the fleet with the store loads on a
background thread, and another holds where each part of that boot runs:
the loads on the background thread, everything that touches process-wide
state (allocation, hot load, and on the card the warm-up and capture) on
the supervisor's thread."""
import threading

import numpy as np
import pytest

from repro_torch.cluster import Supervisor
from repro_torch.core import syscore as syscore_mod
from repro_torch.core.program_store import ProgramStore
from repro_torch.engine_config import ClusterConfig, EngineConfig, ScaleConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import transformer
from repro_torch.runtime import ElasticPlan, reshard_tree

ARCH = "qwen3-0.6b"


def _workload(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 500, size=int(rng.integers(3, 8))),
             int(4 + i % 3)) for i in range(n)]


def _engine_cfg(**kw):
    base = dict(batch=2, max_len=32, clock="step", device="cpu")
    base.update(kw)
    return EngineConfig(**base)


def _reference_streams(work, params, ecfg):
    """One uninterrupted engine on the same requests (no store): the
    byte-exactness oracle for any fleet schedule."""
    single = ServingEngine(ARCH, ecfg, params=params)
    refs = [single.submit(p, max_new=m) for p, m in work]
    single.run()
    return [list(r.generated) for r in refs]


class FakeClock:
    """The supervisor's clock: 1 ms a read, plus what a hook adds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t

    def advance(self, seconds: float):
        self.t += seconds


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """A store holding the test config's programs (exported once by a
    cold boot) and that boot's weights."""
    store_dir = tmp_path_factory.mktemp("elastic_store")
    eng = ServingEngine(ARCH, _engine_cfg(), store=ProgramStore(store_dir))
    return store_dir, eng.params


# ---------------------------------------------------------------------------
# ScaleConfig, ElasticPlan and what waits for other items
# ---------------------------------------------------------------------------
def test_scale_config_validation_and_round_trip():
    sc = ScaleConfig(min_replicas=1, max_replicas=4, high_watermark=0.8,
                     low_watermark=0.2, sustain_window=2, cooldown=3)
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=2, scale=sc)
    back = ClusterConfig.from_dict(ccfg.to_dict())
    assert back == ccfg and back.scale == sc
    with pytest.raises(AssertionError):
        ScaleConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(AssertionError):
        ScaleConfig(low_watermark=0.9, high_watermark=0.8)
    with pytest.raises(AssertionError):
        ScaleConfig(sustain_window=0)
    with pytest.raises(AssertionError):
        ScaleConfig(cooldown=-1)
    with pytest.raises(AssertionError):
        ClusterConfig(replicas=5, scale=ScaleConfig(max_replicas=4))
    with pytest.raises(AssertionError):
        ClusterConfig(replicas=1,
                      scale=ScaleConfig(min_replicas=2, max_replicas=4))


def test_elastic_plan_batch_advice_rounds_not_floors():
    plan = ElasticPlan({"pod": 3, "model": 2}, {"pod": 2, "model": 2})
    assert plan.batch_advice(4) == 3
    for old in range(1, 7):
        for new in range(1, 7):
            p = ElasticPlan({"pod": old, "model": 1},
                            {"pod": new, "model": 1})
            for b in range(1, 33):
                exact = b * new / old
                adv = p.batch_advice(b)
                assert adv == max(1, round(exact)), (old, new, b)
                if round(exact) >= 1:
                    assert abs(adv - exact) <= 0.5, (old, new, b)
    with pytest.raises(ValueError):
        ElasticPlan({"replica": 1, "model": 1},
                    {"replica": 2, "model": 2}).validate()


def test_unported_parts_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="item 13"):
        reshard_tree(None, None, None, None)
    sup = Supervisor(ARCH, ClusterConfig(engine=_engine_cfg(), replicas=1))
    with pytest.raises(NotImplementedError, match="item 12"):
        sup.adopt_overlay({"batch": 4})
    sup.close()


# ---------------------------------------------------------------------------
# Engine drain mode and queued-request withdrawal (the quiesce primitives)
# ---------------------------------------------------------------------------
def test_engine_drain_refuses_admission_and_finishes_inflight():
    eng = ServingEngine(ARCH, _engine_cfg())
    r1 = eng.submit(np.arange(1, 5), max_new=3)
    r2 = eng.submit(np.arange(2, 6), max_new=3)
    eng.tick()                              # both placed into slots
    eng.begin_drain()
    assert eng.snapshot()["draining"]
    assert eng.submit(np.arange(1, 4), max_new=2) is None
    assert eng.rejected == 1
    eng.run()                               # in-flight work still finishes
    assert r1.done and r2.done and not eng.has_work


def test_engine_withdraw_returns_only_queued_requests():
    eng = ServingEngine(ARCH, _engine_cfg())    # batch=2
    reqs = [eng.submit(np.arange(1, 5) + i, max_new=4, rid=10 + i)
            for i in range(3)]
    assert all(r is not None for r in reqs)
    eng.tick()                              # 2 admitted, rid 12 still queued
    assert eng.snapshot()["active"] == 2
    assert eng.withdraw(10) is None         # in a slot: not withdrawable
    assert eng.withdraw(99) is None         # unknown rid
    got = eng.withdraw(12)
    assert got is not None and got.rid == 12 and not eng.queue
    eng.run()
    assert reqs[0].done and reqs[1].done and not reqs[2].done


# ---------------------------------------------------------------------------
# Grow on sustained load
# ---------------------------------------------------------------------------
def test_grow_on_ramp_boots_warm_and_rebalances(stored, tmp_path):
    store_dir, params = stored
    ecfg = _engine_cfg()
    ccfg = ClusterConfig(
        engine=ecfg, replicas=1, journal_dir=str(tmp_path / "journals"),
        scale=ScaleConfig(min_replicas=1, max_replicas=3,
                          high_watermark=0.75, low_watermark=0.01,
                          sustain_window=2, cooldown=1))
    store = ProgramStore(store_dir)
    sup = Supervisor(ARCH, ccfg, params=params, store=store)
    work = _workload(8, seed=4)
    rids = [sup.submit(p, max_new=m) for p, m in work]
    assert all(r is not None for r in rids)
    stats = sup.run()
    assert len(sup.replicas) == 3 and stats["running_replicas"] == 3
    grows = [e for e in stats["scale_events"] if e["action"] == "grow"]
    assert len(grows) == 2
    for e in grows:
        assert e["plan"]["new_axes"]["replica"] == \
            e["plan"]["old_axes"]["replica"] + 1
        assert e["plan"]["new_axes"]["model"] == 1   # TP degree preserved
        # warm: every program from the store, nothing compiled
        assert e["warm"] and e["compile_s"] == 0 and e["load_s"] > 0, e
    assert stats["rebalanced"] >= 1
    moved_rids = [rid for rid, owner in sup.owner.items() if owner > 0]
    assert moved_rids, sup.owner
    assert stats["completed_all"] and stats["requests"] == len(work)
    assert sorted(sup.streams) == rids
    # one store hit per program of each of the 3 boots, nothing written
    assert (store.hits, store.misses, store.puts) == (6, 0, 0)
    for ref, rid in zip(_reference_streams(work, sup.params, ecfg), rids):
        assert sup.streams[rid] == ref, rid
    sup.close()


def test_async_grow_loads_in_background_and_stays_exact(stored):
    """``async_spawn``: the grow's store loads run on a background thread
    while the fleet keeps serving; the replica attaches warm on a later
    pass, and every stream stays exact."""
    store_dir, params = stored
    ecfg = _engine_cfg()
    ccfg = ClusterConfig(
        engine=ecfg, replicas=1,
        scale=ScaleConfig(min_replicas=1, max_replicas=2,
                          high_watermark=0.75, low_watermark=0.01,
                          sustain_window=2, cooldown=1, async_spawn=True,
                          straggler_detection=False))
    store = ProgramStore(store_dir)
    sup = Supervisor(ARCH, ccfg, params=params, store=store)
    work = _workload(10, seed=8)
    rids = [sup.submit(p, max_new=m) for p, m in work]
    passes_while_loading = 0
    while True:
        stats = sup.run(max_ticks=1)
        if sup.spawning:
            passes_while_loading += 1
        if not any(r.engine is not None and r.engine.has_work
                   for r in sup.replicas) and not sup.spawning:
            break
    stats = sup.run()
    grows = [e for e in sup.scale_events if e["action"] == "grow"]
    assert len(grows) == 1 and len(sup.replicas) == 2
    e = grows[0]
    assert e["warm"] and e["compile_s"] == 0, e
    assert e["load_s"] > 0 and e["boot_s"] >= e["load_wall_s"] > 0, e
    assert passes_while_loading >= 1
    assert (store.hits, store.puts) == (4, 0)
    assert stats["completed_all"] and sorted(sup.streams) == rids
    for ref, rid in zip(_reference_streams(work, sup.params, ecfg), rids):
        assert sup.streams[rid] == ref, rid
    sup.close()


def test_async_boot_touches_shared_state_only_on_supervisor_thread(
        stored, monkeypatch):
    """An async boot's background thread only reads and loads payloads;
    allocation, the hot loads and the capture (stubbed here so that the
    CPU reaches it: on the card it holds the sync debug mode, K2's
    scratch-table stack, the host-call site stack, the launch counters
    and the allocator cache, all process-wide) run on the supervisor's
    thread.  Booting the whole engine on the background thread, as the
    reference does, fails this."""
    store_dir, params = stored
    main = threading.current_thread()
    seen = {"capture": [], "hot_load": [], "init_cache": [], "load": []}

    def capture(spec, prog, device):
        seen["capture"].append(threading.current_thread())

    def recorded(name, fn):
        def wrapper(*a, **k):
            seen[name].append(threading.current_thread())
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(syscore_mod, "_card", lambda spec: spec.device)
    monkeypatch.setattr(syscore_mod.Syscore, "_capture",
                        staticmethod(capture))
    monkeypatch.setattr(syscore_mod.Syscore, "hot_load",
                        recorded("hot_load", syscore_mod.Syscore.hot_load))
    monkeypatch.setattr(transformer, "init_cache",
                        recorded("init_cache", transformer.init_cache))
    monkeypatch.setattr(syscore_mod, "install_program",
                        recorded("load", syscore_mod.install_program))
    ccfg = ClusterConfig(
        engine=_engine_cfg(), replicas=1,
        scale=ScaleConfig(min_replicas=1, max_replicas=2,
                          high_watermark=0.75, low_watermark=0.0,
                          sustain_window=1, cooldown=1000, async_spawn=True,
                          straggler_detection=False))
    sup = Supervisor(ARCH, ccfg, params=params, store=ProgramStore(store_dir))
    rids = [sup.submit(p, max_new=m) for p, m in _workload(6, seed=9)]
    stats = sup.run()
    assert [e["action"] for e in sup.scale_events] == ["grow"]
    assert stats["completed_all"] and sorted(sup.streams) == rids
    # two boots of two programs each: replica 0 inline, replica 1 loaded
    # in the background and attached on this thread
    assert len(seen["capture"]) == len(seen["hot_load"]) == 4
    assert all(t is main for t in seen["capture"] + seen["hot_load"] +
               seen["init_cache"]), seen
    assert len(seen["load"]) == 4
    background = [t for t in seen["load"] if t is not main]
    assert len(background) == 2
    assert all(t.name == "replica1-load" for t in background)
    sup.close()


# ---------------------------------------------------------------------------
# Shrink on idle
# ---------------------------------------------------------------------------
def test_shrink_on_idle_quiesces_and_loses_nothing():
    ecfg = _engine_cfg()
    ccfg = ClusterConfig(
        engine=ecfg, replicas=2,
        scale=ScaleConfig(min_replicas=1, max_replicas=2,
                          high_watermark=5.0, low_watermark=0.55,
                          sustain_window=2, cooldown=0))
    sup = Supervisor(ARCH, ccfg)
    long_prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    work = [(long_prompt, 12)] + [(np.arange(2, 6) + i, 2)
                                  for i in range(4)]
    rids = [sup.submit(p, max_new=m) for p, m in work]
    stats = sup.run()
    assert sup.replicas[1].state == "retired"
    assert sup.replicas[1].retire_reason == "idle"
    assert sup.replicas[1].engine is None
    assert sup.replicas[0].state == "running"
    assert stats["retired"] == 1 and stats["running_replicas"] == 1
    shrinks = [e for e in stats["scale_events"] if e["action"] == "shrink"]
    assert len(shrinks) == 1 and shrinks[0]["victim"] == 1
    assert shrinks[0]["plan"]["new_axes"]["replica"] == 1
    assert stats["completed_all"] and sorted(sup.streams) == rids
    per = stats["per_replica"]
    assert sum(p["served"] for p in per) == len(work)
    assert next(p for p in per if p["replica"] == 1)["state"] == "retired"
    assert sum(p["decode_tokens"] for p in per) == stats["decode_tokens"]
    extra_rid = sup.submit(np.asarray([9, 8, 7], np.int32), max_new=3)
    assert extra_rid is not None
    stats2 = sup.run()
    assert stats2["completed_all"] and extra_rid in sup.streams
    all_work = work + [(np.asarray([9, 8, 7], np.int32), 3)]
    for ref, rid in zip(_reference_streams(all_work, sup.params, ecfg),
                        rids + [extra_rid]):
        assert sup.streams[rid] == ref, rid
    sup.close()


# ---------------------------------------------------------------------------
# Straggler-triggered replacement (injected clock)
# ---------------------------------------------------------------------------
def _straggler_fleet(clock, params=None, store=None, detection=True,
                     journal_dir=None):
    ccfg = ClusterConfig(
        engine=_engine_cfg(), replicas=2, health_interval=1,
        journal_dir=journal_dir,
        scale=ScaleConfig(min_replicas=1, max_replicas=2,
                          high_watermark=5.0, low_watermark=0.0,
                          sustain_window=3, cooldown=0,
                          straggler_detection=detection))

    def degrade(step):
        # replica 0 turns straggler mid-run: every tick past step 6 takes
        # 20 ms more on the supervisor's clock, >> 1.5x the 1 ms median
        # the monitor built from steps 1..5
        if step >= 6:
            clock.advance(0.02)

    return Supervisor(ARCH, ccfg, params=params, store=store,
                      fault_hooks={0: degrade}, clock=clock)


STRAGGLER_WORK = [(np.asarray([3, 1, 4, 1, 5], np.int32), 20),  # replica 0
                  (np.arange(2, 6), 3), (np.arange(4, 9), 3)]


def test_straggler_escalation_triggers_warm_replacement(stored, tmp_path):
    store_dir, params = stored
    sup = _straggler_fleet(FakeClock(), params=params,
                           store=ProgramStore(store_dir),
                           journal_dir=str(tmp_path / "journals"))
    rids = [sup.submit(p, max_new=m) for p, m in STRAGGLER_WORK]
    stats = sup.run()
    victim = sup.replicas[0]
    assert victim.state == "retired"
    assert victim.retire_reason == "straggler-replaced"
    assert victim.monitor.escalations >= 1
    events = [e for e in stats["scale_events"] if e["action"] == "replace"]
    assert len(events) == 1 and events[0]["victim"] == 0
    assert events[0]["plan"]["old_axes"] == events[0]["plan"]["new_axes"]
    assert len(sup.replicas) == 3 and stats["running_replicas"] == 2
    assert stats["rerouted"] >= 1
    assert victim.journal.unfinished() == []
    assert stats["completed_all"] and sorted(sup.streams) == rids
    assert events[0]["warm"] and events[0]["compile_s"] == 0, events
    for ref, rid in zip(_reference_streams(STRAGGLER_WORK, sup.params,
                                           _engine_cfg()), rids):
        assert sup.streams[rid] == ref, rid
    sup.close()


def test_straggler_detection_off_reports_but_never_replaces():
    sup = _straggler_fleet(FakeClock(), detection=False)
    rids = [sup.submit(p, max_new=m) for p, m in STRAGGLER_WORK]
    stats = sup.run()
    assert sup.replicas[0].monitor.escalations >= 1
    assert sup.replicas[0].state == "running"
    assert [e for e in stats["scale_events"]
            if e["action"] == "replace"] == []
    assert len(sup.replicas) == 2 and stats["running_replicas"] == 2
    assert stats["completed_all"] and sorted(sup.streams) == rids
    sup.close()
