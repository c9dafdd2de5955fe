"""Supervisor — multi-replica cluster serving over one shared ProgramStore
(port of ``repro/cluster/supervisor.py``).

One engine serves one batch; a fleet serves traffic.  The supervisor owns
N :class:`~repro_torch.launch.serve.ServingEngine` replicas and runs the whole
cluster cooperatively in one process, the same way the paper's host-side
runtime coordinates many Epiphany cores over fast shared state:

  * a :class:`~repro_torch.cluster.router.Router` assigns every incoming request
    (least-loaded by default) from the replicas' host-side snapshots;
  * each replica is driven one :meth:`~ServingEngine.tick` at a time, so a
    single supervisor loop multiplexes the fleet without threads and the
    whole schedule stays deterministic on the step clock;
  * health checks every ``health_interval`` ticks feed the replica's new
    step-latency telemetry (supervised tick wall time, which observes
    everything a slow replica does — the decode program, paging, a
    misbehaving fault hook) into a per-replica
    :class:`~repro_torch.runtime.fault.StragglerMonitor`; pending samples are
    flushed on crash and at the end of every :meth:`run`, so the slow
    steps preceding a failure are never stranded between boundaries;
  * a crash (``SimulatedFailure`` escaping a tick — the injectable
    ``fault_hook``) discards the engine; the replica reboots under a
    :class:`~repro_torch.runtime.fault.RestartPolicy` (restart-with-backoff,
    bounded attempts) by installing every hot program from the SHARED
    :class:`~repro_torch.core.program_store.ProgramStore` — no program
    function runs; on the card each program is still warmed up and
    captured, since a CUDA graph cannot be stored — and replays its
    unfinished requests from its durable
    :class:`~repro_torch.cluster.journal.RequestJournal`;
  * past the restart budget the replica is failed permanently and its
    unfinished requests re-route through the router to survivors.

Elasticity (``ClusterConfig.scale`` — a :class:`ScaleConfig`): the fleet
is a resizable pool over the shared store.  Every supervisor pass scores
mean fleet load (the router's own load metric); sustained load above the
high watermark spawns a NEW replica — booted warm from the shared
ProgramStore/PrefixStore mid-run — and rebalances queued requests onto it
through the journal ``moved`` path.  With ``ScaleConfig.async_spawn`` the
boot's store reads and ``torch.export.load`` (CPU work, seconds a program
at full width) run on a background thread while the fleet serves
(:func:`repro_torch.core.syscore.preload`); the rest of the boot runs on
the supervisor's thread when the replica attaches.  That rest touches
process-wide state the serving replicas use too (on the card: the sync
debug mode of the warm-up, K2's scratch-table stack, the host-call site
stack, the kernels' launch counters a capture takes its launches back
off, the allocator cache a capture empties), so it never runs beside
them.  Sustained load below the
low watermark quiesces an idle replica: ``begin_drain`` stops admissions,
the in-flight batch finishes, then the replica retires and its
journal/telemetry fold into the fleet accumulators.  A sustained
straggler escalation triggers proactive REPLACEMENT (capacity-neutral,
allowed even at ``max_replicas``): a fresh warm replica boots, the
victim retires, and its unfinished requests re-route via the journal.
Each decision is recorded as a validated
:class:`~repro_torch.runtime.elastic.ElasticPlan` over a ``replica`` axis
(the model axis is fixed at one device per engine: the port has no
tensor parallelism yet, ROADMAP Queue 1 item 13) in
``Supervisor.scale_events``.

Exactness: replicas share one params tree and greedy decoding is
deterministic, so the merged per-request streams of an N-replica cluster
— under any kill/reboot/replay/scale schedule — are byte-identical to a
single engine serving the same requests (gated in
``tests/test_torch_cluster.py`` and ``tests/test_torch_elastic.py``).  A kill, a shrink or a
replacement loses no request: everything un-finished is journaled and
replayed from the prompt.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.journal import RequestJournal
from repro_torch.cluster.router import Router
from repro_torch.core.program_store import ProgramSpec, ProgramStore
from repro_torch.core.syscore import Preloaded, preload
from repro_torch.engine_config import ClusterConfig
from repro_torch.launch.serve import (METRIC_DECODE_MS, METRIC_TTFT_MS,
                                      ServingEngine)
from repro_torch.runtime.elastic import ElasticPlan
from repro_torch.runtime.fault import (RestartPolicy, SimulatedFailure,
                                       StragglerMonitor)

__all__ = ["Supervisor", "Replica", "ClusterError"]


class ClusterError(RuntimeError):
    """The cluster can no longer make progress (all replicas failed)."""


@dataclass
class Replica:
    """Supervisor-side state of one replica slot.

    The engine is disposable (a crash discards it whole); everything that
    must survive a crash — the journal, the straggler monitor, restart
    accounting, accumulated telemetry — lives here on the host side.

    Lifecycle: ``running`` -> ``dead`` (crashed, reboot owed) ->
    ``running`` | ``failed`` (restart budget exhausted); elastically
    ``running`` -> ``draining`` (quiescing: no routing, batch finishing)
    -> ``retired`` (engine discarded, telemetry folded into the fleet).
    """
    idx: int
    engine: Optional[ServingEngine] = None
    journal: RequestJournal = field(default_factory=RequestJournal)
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    state: str = "running"   # "running"|"draining"|"dead"|"failed"|"retired"
    ticks: int = 0                    # supervised ticks, engine lifetime
    served: int = 0                   # completions collected from this slot
    restarts: int = 0                 # crash count == restart attempts used
    backoff_until: float = 0.0        # supervisor-clock deadline, reboot
    recoveries: List[Dict[str, Any]] = field(default_factory=list)
    # journal records a reboot still owes the fresh engine: a crash can
    # leave up to max_queue + batch unfinished requests, more than the
    # bounded admission queue holds at once, so replay drains under
    # back-pressure across supervisor passes instead of in one burst
    replay_pending: List[Dict[str, Any]] = field(default_factory=list)
    # elastic-scale bookkeeping
    idle_passes: int = 0              # consecutive no-work supervisor passes
    retire_reason: Optional[str] = None
    _esc_handled: int = 0             # escalations already acted on
    # telemetry accumulators (survive engine swaps; offsets reset per boot)
    acc_decode_tokens: int = 0
    acc_decode_ms: float = 0.0
    _dec_tok_seen: int = 0
    _dec_off: int = 0
    _ttft_off: int = 0
    _collected: int = 0               # engine.completed entries consumed
    _pending_step_ms: List[float] = field(default_factory=list)

    def reset_offsets(self):
        self._dec_tok_seen = 0
        self._dec_off = 0
        self._ttft_off = 0
        self._collected = 0


class Supervisor:
    """Run ``config.replicas`` ServingEngines behind one router.

    Runtime objects stay keyword arguments, exactly like the engine:

    params: shared parameter tree (on ``config.engine.device``); ``None``
        lets replica 0 initialize one (``config.engine.seed``) which every
        other replica — and every failover reboot — then shares, so all
        streams are greedy-exact.
    store: an open :class:`ProgramStore` overriding ``config.store_dir``.
        Replica 0's cold boot runs the program functions and exports them;
        replicas 1..N-1, all reboots and every elastically spawned
        replica install them from the store (``source == "store"``: no
        program function runs; on the CPU ``compile_s == 0``, on the card
        ``compile_s`` is the capture).
    fault_hooks: replica index -> hook injected as the engine's
        ``fault_hook`` (e.g. a ``FaultInjector.check`` bound method).  The
        SAME hook is re-attached across reboots, so a once-per-step
        injector kills once, not every reboot.  A replacement replica has
        a fresh index and therefore no inherited hook.
    clock: the supervisor's clock in seconds (default
        ``time.perf_counter``): supervised tick wall time, restart backoff,
        downtime and stall waits read it.  Tests drive the straggler
        monitors from a fake one.
    """

    def __init__(self, arch: str, config: Optional[ClusterConfig] = None, *,
                 params=None, store: Optional[ProgramStore] = None,
                 fault_hooks: Optional[Dict[int, Any]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.config = config if config is not None else ClusterConfig()
        self.clock = clock
        self.arch = arch
        self.router = Router(self.config.router, self.config.affinity_len)
        self.policy = RestartPolicy(self.config.max_restarts,
                                    self.config.backoff_s,
                                    self.config.backoff_factor)
        if store is None and self.config.store_dir is not None:
            store = ProgramStore(self.config.store_dir)
        self.store = store
        # ONE PrefixStore for the whole fleet (prefix-sharing engines):
        # published prefix blocks are host-DRAM state keyed by content, so
        # a failover reboot re-seeds its trie from here and replayed
        # requests keep hitting prefixes the dead engine published
        self.prefix_store = None
        if self.config.engine.prefix is not None:
            from repro_torch.core.paging import PrefixStore
            self.prefix_store = PrefixStore()
        self.fault_hooks = dict(fault_hooks or {})
        self.params = params
        self.streams: Dict[int, List[int]] = {}    # rid -> final tokens
        self._completed_order: List[int] = []
        self._ttft_ms: List[float] = []
        self.owner: Dict[int, int] = {}            # rid -> replica idx
        self.kills = 0
        self.rerouted = 0
        self.rejected = 0
        self.retired = 0
        self.rebalanced = 0                        # requests moved onto a
                                                   # freshly spawned replica
        self.scale_events: List[Dict[str, Any]] = []
        self._next_rid = 0
        self._pass = 0                 # supervisor passes (scale clock)
        self._last_scale = -(10 ** 9)  # pass of the last scale action
        self._high_run = 0             # consecutive passes above high mark
        self._low_run = 0              # consecutive passes below low mark
        self._spawn: Optional[Dict[str, Any]] = None  # in-flight boot
        self.replicas: List[Replica] = []
        for i in range(self.config.replicas):
            rep = self._make_replica(i)
            rep.engine = self._boot_engine(i)
            self.replicas.append(rep)
            if self.params is None:
                # replica 0 initialized the shared tree; every later boot
                # (replicas and reboots alike) reuses it
                self.params = rep.engine.params

    # -- replica lifecycle ----------------------------------------------------
    def _make_replica(self, idx: int) -> Replica:
        journal = RequestJournal(
            None if self.config.journal_dir is None else
            f"{self.config.journal_dir}/replica{idx}.jsonl")
        monitor = StragglerMonitor(
            threshold=self.config.straggler_threshold,
            patience=self.config.straggler_patience)
        return Replica(idx=idx, journal=journal, monitor=monitor)

    def _boot_engine(self, idx: int,
                     preloaded: Optional[Dict[str, Preloaded]] = None
                     ) -> ServingEngine:
        return ServingEngine(self.arch, self.config.engine,
                             params=self.params, store=self.store,
                             prefix_store=self.prefix_store,
                             fault_hook=self.fault_hooks.get(idx),
                             preloaded=preloaded)

    def _stored_programs(self) -> List[Tuple[ProgramSpec, str]]:
        """(spec, store digest) of every program a new replica installs,
        read off a live replica's engine of the current engine config (an
        adopted overlay changes the fingerprints); empty without a store
        or such an engine.  Computed on the supervisor's thread: a digest
        asks the device its name."""
        want = self.config.engine
        eng = next((r.engine for r in self.replicas
                    if r.engine is not None and r.engine.config ==
                    want.replace(device=r.engine.config.device)), None)
        if self.store is None or eng is None:
            return []
        return [(p.spec, self.store.digest(p.spec))
                for p in eng.syscore.programs.values()]

    def adopt_overlay(self, overlay: Dict[str, Any]):
        """Adopt an autotuned ``EngineConfig`` overlay
        (:mod:`repro_torch.runtime.autotune`) for every FUTURE engine
        boot: elastic spawns, failover reboots, straggler replacements.
        Running replicas keep their current knobs: the fleet converges to
        the tuned config replica by replica as they cycle, each boot going
        through the ordinary ProgramStore path (new knobs -> new
        fingerprints -> at most one cold export fleet-wide per adopted
        config, warm everywhere after)."""
        from repro_torch.runtime.autotune import apply_overlay
        self.config = self.config.replace(
            engine=apply_overlay(self.config.engine, overlay))

    def _on_crash(self, rep: Replica, err: Exception):
        """A tick raised: the engine is gone, with every in-flight request
        — which is exactly what the journal still holds."""
        # flush step telemetry accumulated since the last health boundary
        # FIRST: the slow steps preceding a crash are exactly the samples
        # straggler replacement needs, and the engine swap would strand them
        self._health_check(rep)
        self.kills += 1
        rep.engine = None
        rep.restarts += 1
        rep.reset_offsets()
        # still-unreplayed records stay journaled (never submitted, never
        # marked done); the next reboot recomputes the full replay set
        rep.replay_pending.clear()
        if self.policy.allows(rep.restarts):
            rep.state = "dead"
            rep.backoff_until = (self.clock() +
                                 self.policy.delay_s(rep.restarts))
            rep.recoveries.append({
                "replica": rep.idx, "restart_n": rep.restarts,
                "error": str(err), "t_kill": self.clock(),
            })
        else:
            rep.state = "failed"      # out of budget: survivors take over

    def _maybe_restart(self, rep: Replica) -> bool:
        """Reboot a dead replica once its backoff elapses: warm program
        install from the shared store, then journal replay."""
        now = self.clock()
        if now < rep.backoff_until:
            return False
        t0 = self.clock()
        rep.engine = self._boot_engine(rep.idx)
        reboot_s = self.clock() - t0
        rec = rep.recoveries[-1]
        rec.update(self._boot_report(rep.engine))
        rec.update({
            "reboot_s": reboot_s,
            "downtime_s": self.clock() - rec.pop("t_kill"),
            "replayed": 0,
        })
        rep.state = "running"
        # fresh engine, fresh baseline: its step times must not be judged
        # against the dead engine's median (escalations stay cumulative)
        rep.monitor.reset_window()
        rep.replay_pending = rep.journal.unfinished()
        self._drain_replay(rep)
        return True

    def _drain_replay(self, rep: Replica) -> int:
        """Submit a rebooted replica's pending journal records into its
        fresh engine, mirroring :meth:`_reroute`'s back-pressure handling:
        a crash can strand more requests (queue + live batch) than the
        bounded admission queue holds, so on a refusal the remainder stays
        journaled in ``replay_pending`` and the main loop retries every
        pass as the engine's queue drains.

        Replay resets ``arrival_time`` to 0.0 — unlike ``_reroute``, which
        preserves it — because the fresh engine's step clock restarts at 0:
        the original arrival times would defer admission far into the new
        clock's future.  0.0 makes every record immediately eligible, and
        the admission key ``(arrival_time, rid)`` then orders the replays
        by rid, i.e. the original submission order."""
        replayed = 0
        while rep.replay_pending:
            rec = rep.replay_pending[0]
            req = rep.engine.submit(
                np.asarray(rec["prompt"], np.int32), rec["max_new"],
                arrival_time=0.0, rid=rec["rid"])
            if req is None:
                break                 # queue full; retry next loop pass
            rep.replay_pending.pop(0)
            self.owner[rec["rid"]] = rep.idx
            replayed += 1
        if replayed and rep.recoveries:
            rep.recoveries[-1]["replayed"] += replayed
        return replayed

    def _reroute(self, rep: Replica) -> int:
        """Hand a failed (or retired-with-leftovers) replica's unfinished
        requests to the running fleet."""
        moved = 0
        for r in rep.journal.unfinished():
            target = self._route_submit(
                np.asarray(r["prompt"], np.int32), r["max_new"],
                r.get("arrival_time", 0.0), r["rid"])
            if target is None:
                break                 # survivors full; retry next loop pass
            rep.journal.mark_moved(r["rid"])
            moved += 1
        self.rerouted += moved
        return moved

    # -- elastic scaling ------------------------------------------------------
    def _scale_plan(self, n_old: int, n_new: int) -> ElasticPlan:
        """The scale decision as a validated re-mesh plan: the fleet is a
        ``replica`` axis over engines whose own ``model`` axis (TP degree)
        is fixed — exactly the invariant ``ElasticPlan.validate`` checks."""
        tp = 1                        # one device per engine (no TP yet)
        plan = ElasticPlan(old_axes={"replica": n_old, "model": tp},
                           new_axes={"replica": n_new, "model": tp})
        plan.validate()
        return plan

    def _fleet_load(self, running: List[Replica]) -> float:
        """Mean router load over the running fleet — the same score
        ``Router.load`` ranks admissions by, so the watermarks and the
        router agree on what 'loaded' means."""
        if not running:
            return 0.0
        return (sum(Router.load(r.engine.snapshot()) for r in running)
                / len(running))

    def _scale_pass(self):
        """One elastic-policy evaluation, run every supervisor pass."""
        cfg = self.config.scale
        self._pass += 1
        if self._spawn is not None:
            self._poll_spawn()
        # retire any draining replica whose batch has fully drained
        for rep in self.replicas:
            if (rep.state == "draining" and not rep.engine.has_work
                    and not rep.replay_pending):
                self._retire(rep, rep.retire_reason or "shrink")
        running = [r for r in self.replicas if r.state == "running"]
        load = self._fleet_load(running)
        self._high_run = self._high_run + 1 if load >= cfg.high_watermark \
            else 0
        self._low_run = self._low_run + 1 if load <= cfg.low_watermark else 0
        for rep in running:
            if rep.engine.has_work or rep.replay_pending:
                rep.idle_passes = 0
            else:
                rep.idle_passes += 1
        if self._spawn is not None:
            return                    # one boot in flight at a time
        # straggler replacement first: capacity-neutral, so neither the
        # max_replicas cap nor the load watermarks gate it.  The named
        # ScaleConfig.straggler_detection switch turns only this action
        # off (escalations are still observed and reported) — cooperative
        # single-process benchmarks use it because a concurrent warm boot
        # inflates every replica's tick wall via the GIL, which is
        # contention, not a straggler.
        if cfg.straggler_detection:
            for rep in running:
                if rep.monitor.escalations > rep._esc_handled:
                    rep._esc_handled = rep.monitor.escalations
                    self._begin_spawn("replace", victim=rep.idx,
                                      reason=f"straggler escalation "
                                             f"#{rep.monitor.escalations}")
                    return
        cooled = self._pass - self._last_scale >= cfg.cooldown
        if (cooled and self._high_run >= cfg.sustain_window
                and len(running) < cfg.max_replicas):
            self._begin_spawn(
                "grow", reason=f"load {load:.2f} >= "
                               f"{cfg.high_watermark} x{self._high_run}")
            return
        if (cooled and self._low_run >= cfg.sustain_window
                and len(running) > cfg.min_replicas):
            idle = [r for r in running
                    if r.idle_passes >= cfg.sustain_window]
            if idle:
                victim = max(idle, key=lambda r: r.idx)
                victim.state = "draining"
                victim.retire_reason = "idle"
                victim.engine.begin_drain()
                self._last_scale = self._pass
                self._low_run = 0
                self.scale_events.append({
                    "action": "shrink", "replica": victim.idx,
                    "victim": victim.idx, "pass": self._pass,
                    "reason": f"load {load:.2f} <= {cfg.low_watermark}, "
                              f"idle x{victim.idle_passes}",
                    "plan": self._plan_dict(len(running), len(running) - 1),
                })

    def _plan_dict(self, n_old: int, n_new: int) -> Dict[str, Any]:
        plan = self._scale_plan(n_old, n_new)
        return {"old_axes": dict(plan.old_axes),
                "new_axes": dict(plan.new_axes),
                "scale_factor": plan.scale_factor}

    def _boot_report(self, engine: ServingEngine) -> Dict[str, Any]:
        """How a boot installed its programs: ``warm`` when every one came
        from the store; the sums of their ``load_s``, ``lower_s`` (the
        card's warm-up) and ``compile_s`` (the card's capture)."""
        progs = engine.syscore.report()["programs"]
        return {
            "warm": (self.store is not None and len(progs) > 0 and
                     all(p["source"] == "store" for p in progs.values())),
            "load_s": sum(p["load_s"] for p in progs.values()),
            "lower_s": sum(p["lower_s"] for p in progs.values()),
            "compile_s": sum(p["compile_s"] for p in progs.values()),
        }

    def _begin_spawn(self, action: str, victim: Optional[int] = None,
                     reason: str = ""):
        """Start booting a new replica (grow or replace).  The boot's store
        reads and loads come first (:func:`preload`); with
        ``async_spawn`` they run on a background thread while the
        supervisor keeps ticking the fleet, and the replica attaches on a
        later pass via :meth:`_poll_spawn`, which runs the rest of the
        boot on this thread.  Synchronous spawn loads and attaches
        inline — deterministic, for tests."""
        idx = len(self.replicas)
        n_run = sum(1 for r in self.replicas if r.state == "running")
        n_new = n_run + 1 if action == "grow" else n_run
        event: Dict[str, Any] = {
            "action": action, "replica": idx, "victim": victim,
            "reason": reason, "pass": self._pass,
            "plan": self._plan_dict(n_run, n_new),
        }
        self._last_scale = self._pass
        self._high_run = 0
        box: Dict[str, Any] = {}
        stored = self._stored_programs()

        def _load():
            # CPU only: store reads and torch.export.load (see preload)
            try:
                t0 = self.clock()
                box["preloaded"] = (preload(self.store, stored)
                                    if stored else {})
                box["load_wall_s"] = self.clock() - t0
            except BaseException as e:        # surfaced by _poll_spawn
                box["error"] = e

        if self.config.scale.async_spawn:
            th = threading.Thread(target=_load, daemon=True,
                                  name=f"replica{idx}-load")
            th.start()
            self._spawn = {"event": event, "box": box, "thread": th,
                           "action": action, "victim": victim, "idx": idx}
        else:
            _load()
            self._spawn = {"event": event, "box": box, "thread": None,
                           "action": action, "victim": victim, "idx": idx}
            self._poll_spawn()

    def _poll_spawn(self) -> bool:
        """Attach a finished load to the fleet: boot its engine on this
        thread from the loaded programs, between ticks.  False while the
        load is still running."""
        sp = self._spawn
        if sp["thread"] is not None and sp["thread"].is_alive():
            return False
        self._spawn = None
        box = sp["box"]
        if "error" in box:
            raise box["error"]
        idx = sp["idx"]
        t0 = self.clock()
        engine = self._boot_engine(idx, preloaded=box["preloaded"])
        attach_s = self.clock() - t0
        rep = self._make_replica(idx)
        rep.engine = engine
        event = sp["event"]
        event.update(self._boot_report(engine))
        event.update({"boot_s": box["load_wall_s"] + attach_s,
                      "load_wall_s": box["load_wall_s"],
                      "attach_s": attach_s})
        self.replicas.append(rep)
        self.scale_events.append(event)
        self._last_scale = self._pass     # cooldown counts from attach
        if sp["action"] == "replace" and sp["victim"] is not None:
            victim = self.replicas[sp["victim"]]
            self._retire(victim, "straggler-replaced")
            if victim.journal.unfinished():
                # re-route into the fleet (the replacement included); any
                # back-pressured leftovers retry every main-loop pass
                self._reroute(victim)
        else:
            self._rebalance_into(rep)
        return True

    def _retire(self, rep: Replica, reason: str):
        """Fold a replica out of the fleet: collect its final completions
        and telemetry, discard the engine, drop its sticky routes.  The
        journal stays — retired-with-unfinished (a replaced straggler)
        re-routes through the main loop exactly like ``failed``."""
        if rep.engine is not None:
            self._pump(rep)
        self._health_check(rep)           # flush stranded step telemetry
        rep.engine = None
        rep.state = "retired"
        rep.retire_reason = reason
        rep.replay_pending.clear()
        self.router.evict(rep.idx)
        self.retired += 1

    def _rebalance_into(self, new_rep: Replica) -> int:
        """Move queued (never-started) requests from the deepest-queued
        running replica onto a freshly attached one, so growth helps the
        backlog that triggered it instead of only future arrivals.

        Only QUEUED, non-preempted requests move — they hold no engine
        state, so resubmitting the journaled prompt elsewhere is exact.
        The move is journaled as ``moved`` on the donor and ``submit`` on
        the receiver (the same ledger path failover uses), and the new
        request keeps the donor-side wall-clock submit time so TTFT stays
        honest."""
        donors = [r for r in self.replicas
                  if r.state == "running" and r is not new_rep]
        if not donors:
            return 0
        donor = max(donors, key=lambda r: len(r.engine.queue))
        take = len(donor.engine.queue) // 2
        moved = 0
        # take from the queue TAIL (latest arrivals): the head is next to
        # admit on the donor and moving it would only add boot latency
        for r in list(reversed(donor.engine.queue))[:take]:
            if r.needs_resume:
                continue              # preempted: its KV lives in the pager
            rec = donor.journal.record(r.rid)
            if rec is None:
                continue
            got = donor.engine.withdraw(r.rid)
            if got is None:
                continue
            req = new_rep.engine.submit(
                np.asarray(rec["prompt"], np.int32), rec["max_new"],
                arrival_time=0.0, rid=rec["rid"])
            if req is None:           # receiver full: put the tail back
                back = donor.engine.submit(
                    np.asarray(rec["prompt"], np.int32), rec["max_new"],
                    arrival_time=got.arrival_time, rid=rec["rid"])
                if back is not None:
                    back.t_submit = got.t_submit
                break
            req.t_submit = got.t_submit
            donor.journal.mark_moved(r.rid)
            new_rep.journal.append_submit(rec["rid"], rec["prompt"],
                                          rec["max_new"], 0.0)
            self.owner[rec["rid"]] = new_rep.idx
            moved += 1
        self.rebalanced += moved
        return moved

    # -- request path ---------------------------------------------------------
    def _route_submit(self, prompt, max_new: int, arrival_time: float,
                      rid: int) -> Optional[int]:
        """Try replicas in router order until one admits; returns the
        admitting replica index (journaled) or None if every live replica
        refused."""
        live = {r.idx: r for r in self.replicas if r.state == "running"}
        for idx in self.router.rank(
                prompt, {i: r.engine.snapshot() for i, r in live.items()}):
            rep = live[idx]
            req = rep.engine.submit(prompt, max_new,
                                    arrival_time=arrival_time, rid=rid)
            if req is not None:
                rep.journal.append_submit(rid, prompt, max_new, arrival_time)
                self.owner[rid] = idx
                if self.router.policy == "prefix_affinity":
                    # placement feedback: this replica's trie now holds (or
                    # will publish) the prompt's prefix blocks — route
                    # later same-prefix prompts here first
                    self.router.record(prompt, idx)
                return idx
        return None

    def submit(self, prompt, max_new: int = 16,
               arrival_time: float = 0.0) -> Optional[int]:
        """Route one request into the cluster; returns its GLOBAL rid, or
        None when every live replica's admission queue refused it.

        A fleet with no running replica is not necessarily lost: replicas
        dead in restart backoff will reboot, a spawn may be mid-boot, a
        draining replica is about to free capacity.  Those are
        BACK-PRESSURE (``None`` — the caller retries), not failure;
        :class:`ClusterError` is reserved for a fleet that can never
        serve again (every replica permanently failed)."""
        prompt = np.asarray(prompt, np.int32)
        if not any(r.state == "running" for r in self.replicas):
            if (self._spawn is not None or
                    any(r.state in ("dead", "draining")
                        for r in self.replicas)):
                self.rejected += 1
                return None
            raise ClusterError("no live replicas to route to")
        idx = self._route_submit(prompt, max_new, arrival_time,
                                 self._next_rid)
        if idx is None:
            self.rejected += 1
            return None
        rid = self._next_rid
        self._next_rid += 1
        return rid

    # -- telemetry ------------------------------------------------------------
    def _pump(self, rep: Replica):
        """Collect completions and new telemetry from a live replica —
        continuously, so a later crash can only lose the in-flight tail,
        never already-collected results or metrics."""
        eng = rep.engine
        completed = eng.completed
        while rep._collected < len(completed):
            r = completed[rep._collected]
            rep._collected += 1
            # a replayed duplicate (request finished elsewhere after a
            # reroute race) keeps the FIRST collected stream; greedy
            # determinism makes both identical anyway
            if r.rid not in self.streams:
                self.streams[r.rid] = list(r.generated)
                self._completed_order.append(r.rid)
            rep.journal.mark_done(r.rid, r.generated)
            rep.served += 1
        m = eng.syscore.hostcalls.metrics
        ch = m.get(METRIC_TTFT_MS, [])
        self._ttft_ms.extend(ch[rep._ttft_off:])
        rep._ttft_off = len(ch)
        ch = m.get(METRIC_DECODE_MS, [])
        new = ch[rep._dec_off:]
        rep._dec_off = len(ch)
        rep.acc_decode_ms += sum(new)
        rep.acc_decode_tokens += eng.decode_tokens - rep._dec_tok_seen
        rep._dec_tok_seen = eng.decode_tokens

    def _health_check(self, rep: Replica):
        """Feed the step latencies accumulated since the last check into
        this replica's StragglerMonitor.  A sustained escalation is acted
        on by the elastic scale pass (proactive replacement) when
        ``ClusterConfig.scale`` is set; otherwise it surfaces in
        :meth:`health`."""
        for ms in rep._pending_step_ms:
            rep.monitor.observe(ms / 1e3)
        rep._pending_step_ms.clear()

    def health(self) -> List[Dict[str, Any]]:
        """Point-in-time fleet health: per replica, its lifecycle state,
        restart count, load snapshot and straggler summary."""
        out = []
        for rep in self.replicas:
            h: Dict[str, Any] = {
                "replica": rep.idx, "state": rep.state,
                "restarts": rep.restarts,
                "straggler": rep.monitor.summary(),
            }
            if rep.state in ("running", "draining") and rep.engine is not None:
                snap = rep.engine.snapshot()
                h.update(queue_depth=snap["queue_depth"],
                         active=snap["active"],
                         arena_occupancy=snap["arena_occupancy"])
            out.append(h)
        return out

    # -- main loop ------------------------------------------------------------
    def _pending(self) -> bool:
        serving = [r for r in self.replicas
                   if r.state in ("running", "draining")]
        if any(r.engine.has_work or r.replay_pending for r in serving):
            return True
        if any(r.state == "dead" for r in self.replicas):
            return True               # a reboot (and maybe a replay) is owed
        if self._spawn is not None:
            return True               # a boot is in flight; attach is owed
        if any(r.state == "draining" for r in self.replicas):
            return True               # drained: retirement is owed
        stranded = [r for r in self.replicas
                    if r.state in ("failed", "retired")
                    and r.journal.unfinished()]
        running = [r for r in self.replicas if r.state == "running"]
        if stranded and not running:
            raise ClusterError(
                "all replicas failed with requests outstanding: "
                f"{[r.idx for r in stranded]}")
        return bool(stranded)

    def run(self, max_ticks: int = 100_000) -> Dict[str, Any]:
        """Serve until every journaled request completes or ``max_ticks``
        supervisor passes elapse — ``stats["completed_all"]`` /
        ``stats["unfinished"]`` distinguish a drained cluster from a
        truncated run.  Stats are a window over THIS call, like
        ``ServingEngine.run``.

        Only passes that DO work charge the tick budget: a pass stalled
        on restart backoff sleeps until the earliest live
        ``backoff_until`` (not a fixed 1 ms), and a pass stalled on an
        asynchronous spawn waits briefly — neither counts as a tick, so a
        realistic ``backoff_s`` can no longer convert the budget into a
        spurious ``completed_all=False`` truncation."""
        t0 = self.clock()
        done0 = len(self._completed_order)
        ttft0 = len(self._ttft_ms)
        dec_tok0 = sum(r.acc_decode_tokens for r in self.replicas)
        dec_ms0 = sum(r.acc_decode_ms for r in self.replicas)
        # keyed by replica index, not zipped positionally: the fleet can
        # GROW mid-run (elastic spawn), and a replica attached after this
        # snapshot simply baselines at zero
        rep0 = {r.idx: (r.ticks, r.served, r.acc_decode_tokens,
                        r.acc_decode_ms) for r in self.replicas}
        ticks = 0
        while ticks < max_ticks and self._pending():
            progressed = False
            for rep in list(self.replicas):
                if rep.state in ("failed", "retired"):
                    if rep.journal.unfinished():
                        progressed |= self._reroute(rep) > 0
                    continue
                if rep.state == "dead":
                    progressed |= self._maybe_restart(rep)
                    continue
                if rep.state == "running" and rep.replay_pending:
                    progressed |= self._drain_replay(rep) > 0
                if not rep.engine.has_work:
                    continue
                t_tick = self.clock()
                try:
                    rep.engine.tick()
                except SimulatedFailure as e:
                    self._on_crash(rep, e)
                    progressed = True
                    continue
                # supervised tick wall time is the straggler signal: it
                # sees everything that slows the replica (decode program,
                # paging, a degraded host), not just the decode hostcall
                rep._pending_step_ms.append(
                    (self.clock() - t_tick) * 1e3)
                rep.ticks += 1
                progressed = True
                self._pump(rep)
                if rep.ticks % self.config.health_interval == 0:
                    self._health_check(rep)
            if self.config.scale is not None:
                self._scale_pass()
            if progressed:
                ticks += 1
                continue
            # stalled pass: nothing was serveable this time around
            waits = [r.backoff_until for r in self.replicas
                     if r.state == "dead"]
            if waits:
                # sleep the stall out in one step and charge no tick
                time.sleep(max(0.0, min(waits) - self.clock()))
                continue
            if self._spawn is not None:
                time.sleep(1e-3)      # async boot in flight; attach soon
                continue
            ticks += 1                # backstop: unexplained no-progress
            time.sleep(1e-3)          # still consumes budget
        # flush telemetry stranded below a health_interval boundary, so
        # short runs and drained replicas still feed their monitors
        for rep in self.replicas:
            if rep._pending_step_ms:
                self._health_check(rep)
        wall = self.clock() - t0
        # outstanding work across the fleet's journals (moved records count
        # once, in their new owner's journal): non-zero means this call hit
        # max_ticks before draining, not that the cluster is done
        unfinished = sum(len(r.journal.unfinished()) for r in self.replicas)
        new_rids = self._completed_order[done0:]
        tokens = sum(len(self.streams[rid]) for rid in new_rids)
        ttft = sorted(self._ttft_ms[ttft0:])
        dec_tok = sum(r.acc_decode_tokens for r in self.replicas) - dec_tok0
        dec_s = (sum(r.acc_decode_ms for r in self.replicas) - dec_ms0) / 1e3
        stats: Dict[str, Any] = {
            "requests": len(new_rids),
            "tokens": tokens,
            "wall_s": wall,
            "tok_per_s": tokens / wall if wall else 0.0,
            "ticks": ticks,
            "replicas": len(self.replicas),
            "running_replicas": sum(1 for r in self.replicas
                                    if r.state == "running"),
            "kills": self.kills,
            "rerouted": self.rerouted,
            "rejected": self.rejected,
            "retired": self.retired,
            "rebalanced": self.rebalanced,
            "unfinished": unfinished,
            "completed_all": unfinished == 0,
            "decode_tokens": dec_tok,
            # fleet-aggregate decode throughput over decode-program wall
            # time only (same basis as BENCH_fused/BENCH_tp)
            "agg_decode_tok_per_s": dec_tok / dec_s if dec_s else 0.0,
            "ttft_p99_ms": (ttft[min(len(ttft) - 1,
                                     int(0.99 * len(ttft)))]
                            if ttft else None),
            "recoveries": [dict(rec) for rep in self.replicas
                           for rec in rep.recoveries],
            "scale_events": [dict(e) for e in self.scale_events],
            "per_replica": [
                {"replica": rep.idx, "state": rep.state,
                 "ticks": rep.ticks - tk0, "served": rep.served - sv0,
                 "restarts": rep.restarts,
                 "decode_tokens": rep.acc_decode_tokens - dtok0,
                 "decode_tok_per_s": ((rep.acc_decode_tokens - dtok0) /
                                      ((rep.acc_decode_ms - dms0) / 1e3)
                                      if rep.acc_decode_ms > dms0 else 0.0),
                 "escalations": rep.monitor.escalations}
                for rep in self.replicas
                for tk0, sv0, dtok0, dms0
                in [rep0.get(rep.idx, (0, 0, 0, 0.0))]],
        }
        return stats

    # -- introspection --------------------------------------------------------
    @property
    def spawning(self) -> bool:
        """True while an asynchronous replica boot is in flight — callers
        pacing a cooperative serving loop can yield extra wall time to the
        boot thread instead of contending with it."""
        return self._spawn is not None

    def report(self) -> Dict[str, Any]:
        rep: Dict[str, Any] = {
            "replicas": len(self.replicas),
            "router": self.config.router,
            "kills": self.kills,
            "rerouted": self.rerouted,
            "retired": self.retired,
            "rebalanced": self.rebalanced,
            "scale_events": [dict(e) for e in self.scale_events],
            "health": self.health(),
        }
        if self.store is not None:
            rep["store"] = self.store.report()
        if self.prefix_store is not None:
            rep["prefix_store"] = self.prefix_store.report()
        return rep

    def close(self):
        """Wait for a background load in flight, close the journals."""
        if self._spawn is not None and self._spawn["thread"] is not None:
            self._spawn["thread"].join()
        for rep in self.replicas:
            rep.journal.close()
