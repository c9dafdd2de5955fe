"""The port's serving cluster (``repro_torch.cluster``): router, journal,
config, the engine's step-level hooks, and kill / back-pressure / restart
budget / all-failed / prefix-trie failover, on the CPU in fp32 at reduced
size.  The cases of ``tests/test_cluster.py``, held to the same
properties: an N-replica fleet under an injected kill gives merged
streams equal to one engine's on the same requests, loses no request, and
reboots warm (every program installed from the shared store, no program
function run; ``compile_s == 0`` on the CPU, where nothing is captured).
One fleet with a kill is also held to the JAX ``ServingEngine`` on bridged
weights, token for token.

One module-scoped fleet exports the programs once (replica 0 cold,
replica 1 warm: that fleet is also the compile-once case); the cases that
reboot from the store install from its directory.  Cases about routing and
restart policy, not the store, boot without one (a CPU boot without a
store only binds the Python functions), and every single-engine oracle
too."""
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.cluster import (ClusterError, RequestJournal,  # noqa: E402
                                 Router, Supervisor)
from repro_torch.core.program_store import ProgramStore  # noqa: E402
from repro_torch.engine_config import (ROUTER_POLICIES,  # noqa: E402
                                       ClusterConfig, EngineConfig,
                                       PagingConfig, PrefixConfig)
from repro_torch.launch.serve import ServingEngine  # noqa: E402
from repro_torch.runtime.fault import (FaultInjector,  # noqa: E402
                                       SimulatedFailure)
from test_torch_bench_serve import port_params  # noqa: E402

ARCH = "qwen3-0.6b"


def _workload(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 500, size=int(rng.integers(3, 8))),
             int(4 + i % 3)) for i in range(n)]


def _engine_cfg(**kw):
    base = dict(batch=2, max_len=32, clock="step", device="cpu")
    base.update(kw)
    return EngineConfig(**base)


def _single_streams(work, params, ecfg, one_at_a_time=False):
    """One uninterrupted engine on the same requests (no store): the
    exactness oracle of every fleet schedule."""
    single = ServingEngine(ARCH, ecfg, params=params)
    if one_at_a_time:
        out = []
        for p, m in work:
            req = single.submit(p, max_new=m)
            single.run()
            out.append(req.generated)
        return out
    refs = [single.submit(p, max_new=m) for p, m in work]
    single.run()
    return [r.generated for r in refs]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A 2-replica fleet over a fresh store: replica 0 runs the program
    functions and exports them, replica 1 installs them.  Its store
    directory serves every warm boot of this module."""
    store_dir = tmp_path_factory.mktemp("cluster_store")
    sup = Supervisor(ARCH, ClusterConfig(engine=_engine_cfg(), replicas=2),
                     store=ProgramStore(store_dir))
    yield sup, store_dir
    sup.close()


# ---------------------------------------------------------------------------
# Router (unit level: fake snapshots, no engines)
# ---------------------------------------------------------------------------
def _snap(active=0, queue=0, batch=2, arena=0.0):
    return {"active": active, "queue_depth": queue, "batch": batch,
            "arena_occupancy": arena}


def test_router_least_loaded_prefers_idle_replica():
    r = Router("least_loaded")
    snaps = {0: _snap(active=2, queue=3), 1: _snap(active=1), 2: _snap()}
    assert r.rank(np.arange(4), snaps) == [2, 1, 0]
    # arena pressure outweighs an equal queue picture
    snaps = {0: _snap(arena=0.9), 1: _snap(arena=0.1)}
    assert r.rank(np.arange(4), snaps)[0] == 1


def test_router_round_robin_cycles_live_replicas():
    r = Router("round_robin")
    snaps = {0: _snap(), 1: _snap(), 2: _snap()}
    first = [r.rank(np.arange(2), snaps)[0] for _ in range(6)]
    assert first == [0, 1, 2, 0, 1, 2]
    # a dead replica (absent snapshot) is skipped, cycle stays total
    snaps = {0: _snap(), 2: _snap()}
    assert all(r.rank(np.arange(2), snaps)[0] in (0, 2) for _ in range(4))


def test_router_round_robin_cursor_stable_under_membership_change():
    r = Router("round_robin")
    snaps3 = {0: _snap(), 1: _snap(), 2: _snap()}
    assert [r.rank([], snaps3)[0] for _ in range(2)] == [0, 1]
    # replica 1 retires mid-rotation: the next pick is the first live
    # replica strictly after the last-served one
    snaps2 = {0: _snap(), 2: _snap()}
    assert r.rank([], snaps2)[0] == 2
    # the fleet grows mid-rotation: continue after 2, no re-alias
    snaps4 = {i: _snap() for i in range(4)}
    assert r.rank([], snaps4)[0] == 3
    assert r.rank([], snaps4)[0] == 0


def test_router_evict_drops_sticky_entries_for_retired_replica():
    r = Router("prefix_affinity", affinity_len=4)
    p = np.asarray([3, 1, 4, 1], np.int32)
    q = np.asarray([2, 7, 1, 8], np.int32)
    r.record(p, 1)
    r.record(q, 2)
    assert len(r._sticky) == 2
    r.evict(1)
    assert list(r._sticky.values()) == [2]
    # the evicted prefix degrades to the deterministic hash bucket
    snaps = {0: _snap(), 1: _snap(active=2, queue=5), 2: _snap()}
    assert r.rank(p, snaps)[0] == sorted(snaps)[r._affinity_key(p) % 3]


def test_router_prefix_affinity_is_sticky_and_deterministic():
    r = Router("prefix_affinity", affinity_len=4)
    snaps = {i: _snap() for i in range(4)}
    a = np.asarray([7, 7, 7, 7, 1, 2], np.int32)
    b = np.asarray([7, 7, 7, 7, 9, 8], np.int32)   # same prefix, new tail
    ra, rb = r.rank(a, snaps), r.rank(b, snaps)
    assert ra[0] == rb[0]                          # shared prefix -> sticky
    assert sorted(ra) == list(range(4))            # full fallback order
    # a fresh router maps the same prefix identically (crc32)
    assert Router("prefix_affinity", affinity_len=4).rank(a, snaps)[0] == ra[0]
    firsts = {Router("prefix_affinity", affinity_len=4).rank(
        np.asarray([p] * 4, np.int32), snaps)[0] for p in range(32)}
    assert len(firsts) > 1


def test_router_rank_empty_when_no_live_replicas():
    for policy in ROUTER_POLICIES:
        assert Router(policy).rank(np.arange(3), {}) == [], policy
    with pytest.raises(AssertionError):
        Router("beam_me_up")


def test_router_affinity_short_and_empty_prompts_bucket_totally():
    r = Router("prefix_affinity", affinity_len=8)
    snaps = {i: _snap() for i in range(3)}
    short = np.asarray([7, 9], np.int32)
    assert r.rank(short, snaps)[0] == r.rank(short.copy(), snaps)[0]
    assert sorted(r.rank([], snaps)) == [0, 1, 2]      # empty prompt: total
    assert sorted(r.rank([5], snaps)) == [0, 1, 2]
    long_ = np.asarray([7, 9, 1, 2, 3, 4, 5, 6], np.int32)
    assert r._affinity_key(short) != r._affinity_key(long_)
    assert Router("prefix_affinity", affinity_len=8)._affinity_key(short) \
        == r._affinity_key(short)
    with pytest.raises(AssertionError):
        Router("prefix_affinity", affinity_len=0)


def test_router_record_steers_and_survives_replica_death():
    r = Router("prefix_affinity", affinity_len=4)
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    snaps = {0: _snap(), 1: _snap(active=2, queue=4), 2: _snap()}
    r.record(p, 1)                      # replica 1 holds this prefix
    assert r.rank(p, snaps)[0] == 1     # sticky beats load
    alive = {0: _snap(), 2: _snap()}    # the sticky replica died
    order = r.rank(p, alive)
    assert order[0] in (0, 2) and sorted(order) == [0, 2]


# ---------------------------------------------------------------------------
# RequestJournal durability
# ---------------------------------------------------------------------------
def test_journal_tracks_unfinished_and_survives_reopen(tmp_path):
    path = tmp_path / "replica0.jsonl"
    j = RequestJournal(path)
    j.append_submit(0, np.asarray([1, 2, 3]), 4)
    j.append_submit(1, np.asarray([5, 6]), 8, arrival_time=2.0)
    j.append_submit(2, np.asarray([9]), 2)
    j.mark_done(1, [11, 12])
    j.mark_moved(2)
    assert [r["rid"] for r in j.unfinished()] == [0]
    j.close()
    j2 = RequestJournal(path)
    assert [r["rid"] for r in j2.unfinished()] == [0]
    assert j2.unfinished()[0]["prompt"] == [1, 2, 3]
    assert j2.finished() == {1: [11, 12]}
    assert len(j2) == 3 and 2 in j2
    j2.close()


def test_journal_tolerates_torn_tail_line(tmp_path):
    path = tmp_path / "j.jsonl"
    j = RequestJournal(path)
    j.append_submit(0, [1, 2], 4)
    j.close()
    with path.open("a") as f:
        f.write('{"op": "done", "rid": 0, "gen')      # crashed mid-write
    j2 = RequestJournal(path)
    assert [r["rid"] for r in j2.unfinished()] == [0]  # done never landed
    j2.close()


def test_journal_in_memory_mode_needs_no_disk():
    j = RequestJournal()
    j.append_submit(5, [1], 2)
    assert [r["rid"] for r in j.unfinished()] == [5]
    j.mark_done(5, [3, 4])
    assert j.unfinished() == [] and j.finished() == {5: [3, 4]}


# ---------------------------------------------------------------------------
# ClusterConfig
# ---------------------------------------------------------------------------
def test_cluster_config_validation_and_round_trip():
    cfg = ClusterConfig(engine=_engine_cfg(paging=PagingConfig(kv_block=4),
                                           prefix=PrefixConfig()),
                        replicas=3, router="prefix_affinity",
                        health_interval=4, max_restarts=2, backoff_s=0.5,
                        store_dir="/tmp/s")
    back = ClusterConfig.from_dict(cfg.to_dict())
    assert back == cfg and back.engine.device == "cpu"
    with pytest.raises(AssertionError):
        ClusterConfig(replicas=0)
    with pytest.raises(AssertionError):
        ClusterConfig(router="hash_ring")
    with pytest.raises(AssertionError):        # the cluster owns the store
        ClusterConfig(engine=EngineConfig(store_dir="/tmp/x"))
    with pytest.raises(TypeError):
        ClusterConfig.from_dict({"replicass": 2})
    with pytest.raises(TypeError):
        EngineConfig.from_dict({"shard": {}})


# ---------------------------------------------------------------------------
# Engine step-level API (tick / snapshot / stable rids / fault hook)
# ---------------------------------------------------------------------------
def test_engine_snapshot_and_stable_rids():
    eng = ServingEngine(ARCH, _engine_cfg())
    r = eng.submit(np.arange(1, 5), max_new=3, rid=41)
    assert r.rid == 41
    snap = eng.snapshot()
    assert snap["queue_depth"] == 1 and snap["inflight_rids"] == [41]
    assert snap["active"] == 0 and snap["batch"] == 2
    assert snap["draining"] is False and snap["arena_occupancy"] == 0.0
    r2 = eng.submit(np.arange(1, 4), max_new=2)
    assert r2.rid == 42
    assert eng.has_work
    eng.run()
    assert not eng.has_work and eng.snapshot()["inflight_rids"] == []
    # never-placed requests report None, not garbage
    q = ServingEngine(ARCH, _engine_cfg(),
                      params=eng.params).submit(np.arange(1, 4), 2)
    assert q.ttft_s is None and q.latency_s is None
    assert r.ttft_s is not None and r.ttft_s >= 0
    assert r.latency_s is not None and r.latency_s >= r.ttft_s


def test_engine_fault_hook_raises_through_tick():
    inj = FaultInjector(fail_at_steps=[1])
    eng = ServingEngine(ARCH, _engine_cfg(), fault_hook=inj.check)
    eng.submit(np.arange(1, 5), max_new=4)
    assert eng.tick()                      # step 0: admit + first decode
    with pytest.raises(SimulatedFailure):
        eng.tick()                         # hook fires before step 1
    assert inj.fired == [1]


def test_run_stats_latency_none_when_nothing_placed():
    eng = ServingEngine(ARCH, _engine_cfg())
    stats = eng.run(max_steps=1)           # empty engine: nothing decoded
    assert stats["ttft_ms"] is None and stats["decode_p50_ms"] is None
    eng.submit(np.arange(1, 5), 3)
    stats = eng.run()
    assert stats["ttft_ms"] > 0 and stats["decode_p50_ms"] > 0


# ---------------------------------------------------------------------------
# The cluster acceptance property
# ---------------------------------------------------------------------------
def test_cluster_kill_token_exact_zero_lost_warm_recovery(fleet, tmp_path):
    """N replicas + injected kill == one engine, byte-for-byte."""
    base, store_dir = fleet
    ecfg = _engine_cfg()
    ccfg = ClusterConfig(engine=ecfg, replicas=3,
                         journal_dir=str(tmp_path / "journals"))
    inj = FaultInjector(fail_at_steps=[5])
    store = ProgramStore(store_dir)
    sup = Supervisor(ARCH, ccfg, params=base.params, store=store,
                     fault_hooks={1: inj.check})
    work = _workload(8)
    rids = [sup.submit(p, max_new=m) for p, m in work]
    assert all(r is not None for r in rids)
    stats = sup.run()
    assert inj.fired == [5]
    assert stats["kills"] == 1 and len(stats["recoveries"]) == 1
    rec = stats["recoveries"][0]
    assert rec["replica"] == 1 and rec["replayed"] >= 1
    assert stats["requests"] == len(work)
    assert sorted(sup.streams) == rids
    # warm recovery: the rebooted replica installed every program from
    # the store, which counted a hit per program of each of the 4 boots
    # and wrote nothing
    assert rec["warm"] and rec["compile_s"] == 0 and rec["load_s"] > 0, rec
    progs = sup.replicas[1].engine.syscore.report()["programs"]
    assert all(p["source"] == "store" and p["compile_s"] == 0
               for p in progs.values()), progs
    assert (store.hits, store.misses, store.puts) == (4 * len(progs), 0, 0)
    for ref, rid in zip(_single_streams(work, sup.params, ecfg), rids):
        assert sup.streams[rid] == ref, (rid, sup.streams[rid], ref)
    sup.close()


def test_cluster_kill_streams_equal_jax_engine(fleet):
    """A 2-replica port fleet with a kill, on the JAX engine's seed-0
    weights bridged, gives the JAX ServingEngine's streams on the same
    traffic, token for token."""
    _, store_dir = fleet
    work = _workload(8, seed=7)
    jeng = JServingEngine(ARCH, JEngineConfig(batch=2, max_len=32,
                                              clock="step"))
    jreqs = [jeng.submit(p, max_new=m) for p, m in work]
    jeng.run()
    inj = FaultInjector(fail_at_steps=[4])
    sup = Supervisor(ARCH, ClusterConfig(engine=_engine_cfg(), replicas=2),
                     params=port_params(ARCH), store=ProgramStore(store_dir),
                     fault_hooks={0: inj.check})
    rids = [sup.submit(p, max_new=m) for p, m in work]
    stats = sup.run()
    assert inj.fired == [4] and stats["kills"] == 1
    assert stats["recoveries"][0]["warm"]
    assert stats["completed_all"] and sorted(sup.streams) == rids
    assert [sup.streams[rid] for rid in rids] == \
        [list(r.generated) for r in jreqs]
    sup.close()


def test_cluster_replay_respects_admission_backpressure(fleet):
    """A crash strands live-batch + full-queue requests, more than the
    fresh engine's bounded admission queue holds at once: replay drains
    under back-pressure across supervisor passes."""
    base, store_dir = fleet
    ecfg = _engine_cfg(max_queue=2)
    ccfg = ClusterConfig(engine=ecfg, replicas=1, max_restarts=1)
    inj = FaultInjector(fail_at_steps=[3])
    sup = Supervisor(ARCH, ccfg, params=base.params,
                     store=ProgramStore(store_dir),
                     fault_hooks={0: inj.check})
    prompts = [np.asarray([3 + i, 5, 7, 11], np.int32) for i in range(4)]
    rids = [sup.submit(p, max_new=6) for p in prompts[:2]]
    sup.run(max_ticks=2)          # both admitted into slots; queue empty
    rids += [sup.submit(p, max_new=6) for p in prompts[2:]]
    assert rids == [0, 1, 2, 3]
    stats = sup.run()
    assert inj.fired == [3] and stats["kills"] == 1
    rec = stats["recoveries"][0]
    assert rec["warm"]
    assert rec["replayed"] == 4 > ecfg.max_queue
    assert stats["completed_all"] and stats["unfinished"] == 0
    assert sorted(sup.streams) == rids
    refs = _single_streams([(p, 6) for p in prompts], sup.params, ecfg,
                           one_at_a_time=True)
    for ref, rid in zip(refs, rids):
        assert sup.streams[rid] == ref, rid
    sup.close()


def test_cluster_restart_budget_exhausted_reroutes_to_survivors():
    """max_restarts=0: the killed replica fails permanently and its
    unfinished requests complete on the survivors — still zero lost."""
    ecfg = _engine_cfg()
    ccfg = ClusterConfig(engine=ecfg, replicas=2, max_restarts=0)
    inj = FaultInjector(fail_at_steps=[3])
    sup = Supervisor(ARCH, ccfg, fault_hooks={0: inj.check})
    work = _workload(6, seed=1)
    rids = [sup.submit(p, max_new=m) for p, m in work]
    stats = sup.run()
    assert inj.fired == [3]
    assert sup.replicas[0].state == "failed"
    assert stats["rerouted"] >= 1
    assert stats["requests"] == len(work) and sorted(sup.streams) == rids
    for ref, rid in zip(_single_streams(work, sup.params, ecfg), rids):
        assert sup.streams[rid] == ref


def test_cluster_all_replicas_failed_raises():
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=1, max_restarts=0)
    inj = FaultInjector(fail_at_steps=[1])
    sup = Supervisor(ARCH, ccfg, fault_hooks={0: inj.check})
    sup.submit(np.arange(1, 6), max_new=4)
    with pytest.raises(ClusterError):
        sup.run()
    with pytest.raises(ClusterError):
        sup.submit(np.arange(1, 4), max_new=2)


def test_cluster_submit_during_full_fleet_backoff_backpressures():
    """A fleet whose every replica is dead in restart backoff is a
    transient outage: submit back-pressures (None), and the backoff stall
    is slept out in one step, not charged against the tick budget."""
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=2, max_restarts=2,
                         backoff_s=0.3)
    inj0, inj1 = FaultInjector([2]), FaultInjector([2])
    sup = Supervisor(ARCH, ccfg, fault_hooks={0: inj0.check, 1: inj1.check})
    rids = [sup.submit(p, max_new=m) for p, m in _workload(4, seed=5)]
    sup.run(max_ticks=3)               # both replicas crash at step 2
    assert sup.kills == 2
    assert all(r.state == "dead" for r in sup.replicas)
    assert all(r.backoff_until > 0 for r in sup.replicas)
    assert sup.submit(np.arange(1, 5), max_new=3) is None
    assert sup.rejected == 1
    stats = sup.run()
    assert stats["completed_all"] and sorted(sup.streams) == rids
    assert all(r.state == "running" for r in sup.replicas)
    assert stats["ticks"] < 200, stats["ticks"]
    sup.close()


def test_cluster_crash_flushes_step_telemetry_and_resets_window():
    """The step-latency samples since the last health boundary reach the
    StragglerMonitor at crash time, and a reboot resets the monitor's
    rolling window while the cumulative escalation count survives."""
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=1,
                         health_interval=1000)
    inj = FaultInjector(fail_at_steps=[3])
    sup = Supervisor(ARCH, ccfg, fault_hooks={0: inj.check})
    rid = sup.submit(np.arange(1, 6), max_new=6)
    sup.run(max_ticks=4)               # passes 1-3 tick; pass 4 crashes
    assert sup.kills == 1
    mon = sup.replicas[0].monitor
    assert len(mon.times) == 3, mon.times
    assert sup.replicas[0]._pending_step_ms == []
    mon.times.append(99.0)             # sentinel: the reboot must drop it
    mon.escalations = 7                # sentinel: the reboot must keep it
    stats = sup.run()
    assert stats["completed_all"] and sup.streams[rid]
    assert 99.0 not in mon.times
    assert len(mon.times) > 0
    assert mon.escalations == 7
    sup.close()


def test_cluster_health_and_per_replica_stats(fleet):
    base, store_dir = fleet
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=2,
                         health_interval=1)
    sup = Supervisor(ARCH, ccfg, params=base.params,
                     store=ProgramStore(store_dir))
    for p, m in _workload(6, seed=2):
        sup.submit(p, max_new=m)
    stats = sup.run()
    assert stats["requests"] == 6 and stats["kills"] == 0
    assert stats["ttft_p99_ms"] > 0
    assert stats["agg_decode_tok_per_s"] > 0
    per = stats["per_replica"]
    assert [p["replica"] for p in per] == [0, 1]
    assert sum(p["served"] for p in per) == 6
    assert all(p["served"] >= 1 for p in per), per
    health = sup.health()
    assert all(h["state"] == "running" for h in health)
    assert any(h["straggler"]["median_s"] > 0 for h in health)
    rep = sup.report()
    assert rep["replicas"] == 2 and rep["store"]["entries"] > 0
    sup.close()


def test_cluster_run_reports_truncation_and_windowed_stats():
    ccfg = ClusterConfig(engine=_engine_cfg(), replicas=2)
    sup = Supervisor(ARCH, ccfg)
    for p, m in _workload(4, seed=3):
        sup.submit(p, max_new=m)
    part = sup.run(max_ticks=1)        # one pass cannot finish anything
    assert part["unfinished"] > 0 and not part["completed_all"]
    assert part["requests"] == 0
    full = sup.run()
    assert full["completed_all"] and full["unfinished"] == 0
    assert full["requests"] == 4
    assert sum(p["decode_tokens"] for p in full["per_replica"]) == \
        full["decode_tokens"]
    idle = sup.run()                   # drained cluster: an empty window
    assert idle["requests"] == 0 and idle["completed_all"]
    assert all(p["decode_tokens"] == 0 and p["decode_tok_per_s"] == 0.0
               for p in idle["per_replica"])
    sup.close()


def test_cluster_failover_rebuilds_prefix_trie_and_stays_exact(tmp_path):
    """Prefix sharing composes with failover: the rebooted replica
    re-seeds its trie from the ONE fleet-wide PrefixStore, replayed
    requests hit the host-tier shared blocks again, and the merged streams
    stay token-exact vs a single prefix-sharing engine.  (The program
    store is held by the cases above; this one is about the PrefixStore.)"""
    ecfg = _engine_cfg(paging=PagingConfig(kv_block=4),
                       prefix=PrefixConfig())
    ccfg = ClusterConfig(engine=ecfg, replicas=2, router="prefix_affinity",
                         journal_dir=str(tmp_path / "journals"))
    rng = np.random.default_rng(11)
    base = rng.integers(1, 500, size=12).astype(np.int32)
    alt = rng.integers(1, 500, size=12).astype(np.int32)
    prompts = [base, base.copy(), np.concatenate([base[:8], alt[:4]]),
               base.copy(), np.concatenate([base[:4], alt[:8]]),
               base.copy()]
    victim = Router("prefix_affinity", ccfg.affinity_len).rank(
        base, {0: _snap(), 1: _snap()})[0]
    inj = FaultInjector(fail_at_steps=[6])
    sup = Supervisor(ARCH, ccfg, fault_hooks={victim: inj.check})
    rids = [sup.submit(p, max_new=5) for p in prompts]
    assert all(r is not None for r in rids)
    stats = sup.run()
    assert inj.fired == [6]
    assert stats["kills"] == 1 and len(stats["recoveries"]) == 1
    rec = stats["recoveries"][0]
    assert rec["replica"] == victim and rec["replayed"] >= 1
    assert stats["requests"] == len(prompts)
    assert sorted(sup.streams) == sorted(rids)
    assert sup.prefix_store is not None and len(sup.prefix_store) > 0
    reborn = sup.replicas[victim].engine
    assert reborn.prefix_store is sup.prefix_store
    rep = reborn.pager.report()["prefix"]
    assert rep["trie_blocks"] == len(sup.prefix_store)
    assert reborn.pager.prefix_hits >= 1
    assert reborn.pager.shared_faults >= 1
    assert sup.report()["prefix_store"]["entries"] == len(sup.prefix_store)
    refs = _single_streams([(p, 5) for p in prompts], sup.params, ecfg)
    for ref, rid in zip(refs, rids):
        assert sup.streams[rid] == ref, (rid, sup.streams[rid], ref)
    sup.close()


def test_cluster_warm_boots_second_replica_from_first_compile(fleet):
    """Within ONE cluster boot, replica 0 runs the program functions and
    stores them, replica 1 installs them: the shared store pays the
    export once per fleet, not once per replica."""
    sup, _ = fleet
    assert sup.store.puts == 2 and sup.store.hits == 2
    p0 = sup.replicas[0].engine.syscore.report()["programs"]
    p1 = sup.replicas[1].engine.syscore.report()["programs"]
    assert all(v["source"] == "python" for v in p0.values())
    assert all(v["source"] == "store" and v["compile_s"] == 0
               for v in p1.values()), p1
