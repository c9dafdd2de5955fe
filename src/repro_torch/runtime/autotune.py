"""Trace-driven autotuner: record serving traces, replay-simulate the
knob space, pick engine configs (port of ``repro/runtime/autotune.py``).

The engine has a real knob space (horizon H, spec_k/ngram, kv_block,
arena_blocks, timeslice, batch) and the best values depend on the
workload: a chat workload (short prompts, long decodes) may want deep
fused horizons, a RAG workload (long prompts, short answers) is
prefill-bound and horizon-indifferent, a bursty mixed workload trades
batch width against TTFT.  This module closes the loop from measurement
to configuration:

  1. **Trace recording** (:class:`TraceLog`): a ``ServingEngine`` built
     with ``trace=TraceLog(path)`` records every submit, admission,
     program dispatch and completion as one JSON line: program name,
     measured wall seconds, batch occupancy, tokens emitted, plus the
     engine's full knob snapshot at boot.  The file is durable and
     round-trips (``TraceLog.load`` -> identical replay).

  2. **Replay simulation** (:func:`replay`): a discrete-event re-run of
     the recorded arrival schedule under a *different* ``EngineConfig``.
     Per-dispatch service times come from the trace itself when the
     candidate knob leaves a program's shape unchanged (fingerprint-
     context equality, the rule the ProgramStore keys warm boots on), and
     from the cost model otherwise.

  3. **Cost model** (:class:`CostModel`): for knob settings that change
     a program's shape (another H, kv_block, spec_k, batch) and never
     ran, ``launch.dryrun.lower_serve_programs`` runs the real
     ``serve_program_specs`` once on ``meta`` tensors and counts their
     FLOPs and bytes (``launch.cost``; a ``decode_horizon`` at H is H
     ``decode_step`` calls, so it counts H x the FLOPs of ``decode``),
     priced against the H100's peaks (``launch.roofline``).  Raw roofline
     seconds are then **calibrated** against the traced programs, per
     program family: a linear fit ``measured ~= overhead + scale *
     modeled`` absorbs both the host dispatch overhead (the term deep
     horizons amortize) and the gap between the roofline and the card.

  4. **Search** (:func:`autotune`): coordinate descent over the discrete
     grid of :class:`repro_torch.engine_config.AutotuneConfig`, scoring
     every candidate with :func:`replay`, returning the winning config as
     an **overlay**: the minimal field diff against the traced config.
     ``apply_overlay`` merges it back into any base ``EngineConfig``;
     adopting it on a reboot goes through the ordinary ProgramStore path
     (new knobs -> new fingerprints -> one cold export per adopted
     config, warm ever after).

The replay, the calibration and the search are the reference's
algorithm with the same floats: given the same trace and the same
modeled seconds they return exactly what the reference's return.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.engine_config import (AutotuneConfig, EngineConfig,
                                       HorizonConfig, SpecConfig)

__all__ = ["TraceLog", "CostModel", "SimResult", "replay", "autotune",
           "SearchResult", "config_overlay", "apply_overlay"]


# ---------------------------------------------------------------------------
# trace recording
# ---------------------------------------------------------------------------

class TraceLog:
    """Append-only serving trace, one JSON object per line.

    Event schema (every event carries ``ev`` and a monotonic host stamp
    ``t`` from ``time.perf_counter()``):

      boot      arch, config (full ``EngineConfig.to_dict()`` knob
                snapshot; every later event is keyed under it)
      submit    rid, prompt_len, max_new, arrival_time (the engine-clock
                schedule replay re-runs)
      admit     rid, slot, ttft_s
      dispatch  program, wall_s, active (occupied slots), tokens
                (emitted by this dispatch), plus program extras
                (verify: drafted/accepted)
      done      rid, generated

    ``path=None`` records in memory only; with a path every event is
    written and flushed immediately, so a crashed engine still leaves a
    replayable prefix on disk (journal-adjacent durability).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else None
        self.events: List[Dict[str, Any]] = []
        self._fh = None

    # -- engine-facing hooks -------------------------------------------------
    def on_boot(self, arch: str, config: EngineConfig):
        self._emit({"ev": "boot", "arch": arch,
                    "config": config.to_dict()})

    def on_submit(self, req):
        self._emit({"ev": "submit", "rid": req.rid,
                    "prompt_len": int(req.prompt_len),
                    "max_new": int(req.max_new),
                    "arrival_time": float(req.arrival_time)})

    def on_admit(self, req):
        self._emit({"ev": "admit", "rid": req.rid, "slot": int(req.slot),
                    "ttft_s": float(req.ttft_s)})

    def on_dispatch(self, program: str, wall_s: float, active: int = 0,
                    tokens: int = 0, **extras):
        rec = {"ev": "dispatch", "program": program,
               "wall_s": float(wall_s), "active": int(active),
               "tokens": int(tokens)}
        rec.update(extras)
        self._emit(rec)

    def on_done(self, req):
        self._emit({"ev": "done", "rid": req.rid,
                    "generated": len(req.generated)})

    def _emit(self, rec: Dict[str, Any]):
        rec["t"] = time.perf_counter()
        self.events.append(rec)
        if self.path is not None:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- persistence ---------------------------------------------------------
    def save(self, path: str):
        with open(path, "w") as fh:
            for rec in self.events:
                fh.write(json.dumps(rec) + "\n")

    @classmethod
    def load(cls, path: str) -> "TraceLog":
        log = cls()
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    log.events.append(json.loads(line))
        return log

    # -- queries (first boot segment) ---------------------------------------
    def boot_config(self) -> EngineConfig:
        for rec in self.events:
            if rec["ev"] == "boot":
                return EngineConfig.from_dict(rec["config"])
        raise ValueError("trace has no boot event")

    def _segment(self) -> List[Dict[str, Any]]:
        """Events of the first boot segment only — one knob snapshot, so
        every dispatch in it was served under ``boot_config()``."""
        out, boots = [], 0
        for rec in self.events:
            if rec["ev"] == "boot":
                boots += 1
                if boots > 1:
                    break
                continue
            if boots:
                out.append(rec)
        return out

    def requests(self) -> List[Dict[str, Any]]:
        """The recorded workload: submit events in schedule order."""
        subs = [r for r in self._segment() if r["ev"] == "submit"]
        return sorted(subs, key=lambda r: (r["arrival_time"], r["rid"]))

    def dispatch_walls(self) -> Dict[str, List[float]]:
        """program -> measured wall seconds, one entry per dispatch."""
        out: Dict[str, List[float]] = {}
        for rec in self._segment():
            if rec["ev"] == "dispatch":
                out.setdefault(rec["program"], []).append(rec["wall_s"])
        return out

    def accept_rate(self) -> Optional[float]:
        """Measured draft acceptance over every traced verify dispatch,
        or None when the traced config never speculated."""
        drafted = accepted = 0
        for rec in self._segment():
            if rec["ev"] == "dispatch" and rec["program"] == "verify":
                drafted += rec.get("drafted", 0)
                accepted += rec.get("accepted", 0)
        return accepted / drafted if drafted else None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# ---------------------------------------------------------------------------
# cost model: counts on meta tensors + roofline, calibrated on the trace
# ---------------------------------------------------------------------------

# programs whose service time the replay needs, and which config axes key
# their compiled shape (context function per program)
def _prog_key(config: EngineConfig, program: str) -> str:
    ctx = config.program_context()
    if program == "decode_horizon":
        ctx += "|" + config.horizon_context()
    if program == "prefill_offset":
        ctx += "|" + config.prefix_context()
    return program + "@" + ctx


# calibration families: a batched many-token prefill and a single-token
# decode dispatch sit in different host-efficiency regimes, so fitting
# one (overhead, scale) line across both poisons the extrapolation the
# search actually depends on (decode -> decode_horizon / verify)
_FAMILY = {"prefill": "prefill", "prefill_slot": "prefill",
           "prefill_offset": "prefill",
           "decode": "decode", "verify": "decode",
           "decode_horizon": "decode"}


class CostModel:
    """Prices one dispatch of any serving program under any knob setting.

    Modeled seconds come from counting the real program on ``meta``
    tensors (``dryrun.lower_serve_programs``) -> roofline terms against
    the H100's peaks (compute + memory, one card).  They are
    hardware-normalized, not host-accurate, so :meth:`calibrate` fits

        measured_wall ~= overhead + scale * modeled

    per program FAMILY over the programs the trace actually executed.
    ``overhead`` is the per-dispatch host cost that fused horizons
    amortize; ``scale`` maps roofline seconds onto the traced engine.
    The decode family fits the line when the trace holds two decode-path
    shapes (e.g. decode + verify); the common one-shape trace cannot
    split the wall, so ``overhead_frac`` supplies the dispatch-floor
    share.  Its default, 0.7, is the reference's prior for a
    dispatch-bound host; on the card, where a captured graph's dispatch
    is a small share of a step, the caller passes the share it measured
    (``repro_torch.bench.autotune``), and a mispredicting prior is caught
    by the predicted-vs-measured ranking gate.  Prefill predictions use
    a through-origin scale of their own family (their accuracy only
    moves TTFT and wall time, never the decode-path score).  Counts are
    memoized by program fingerprint context, so a search pays at most
    one count per distinct program shape it explores.  A count that
    fails raises: nothing is guessed in its place.
    """

    def __init__(self, arch: str, overhead_frac: float = 0.7):
        assert 0.0 <= overhead_frac < 1.0, overhead_frac
        self.arch = arch
        self.overhead_frac = overhead_frac
        self.overhead = 0.0
        self.scale = 1.0
        self.prefill_scale: Optional[float] = None
        self._modeled: Dict[str, float] = {}     # _prog_key -> roofline s
        self.costs: Dict[str, Any] = {}          # _prog_key -> counted Cost
        self.compiles = 0                        # distinct shapes counted

    # -- counts and raw roofline seconds --------------------------------------
    def cost(self, config: EngineConfig, program: str):
        """The counted cost (:class:`repro_torch.launch.cost.Cost`) of one
        call of ``program`` under ``config``, counted once per program
        shape."""
        key = _prog_key(config, program)
        if key not in self.costs:
            from repro_torch.launch.dryrun import lower_serve_programs
            recs = lower_serve_programs(self.arch, config,
                                        programs=[program])
            if program not in recs:
                raise KeyError(
                    f"{program} not built by this config: {config}")
            self.costs[key] = recs[program]["cost"]
            self.compiles += 1
        return self.costs[key]

    def modeled_seconds(self, config: EngineConfig, program: str) -> float:
        key = _prog_key(config, program)
        if key not in self._modeled:
            from repro_torch.launch import roofline as rl
            from repro_torch.models import registry
            cost = self.cost(config, program)
            dtype = registry.get_config(self.arch,
                                        reduced=config.reduced).dtype
            terms = rl.roofline_terms(cost.flops, cost.bytes_ideal, 0.0,
                                      dtype=dtype)
            self._modeled[key] = terms["compute_s"] + terms["memory_s"]
        return self._modeled[key]

    # -- calibration ---------------------------------------------------------
    def calibrate(self, trace: TraceLog) -> Dict[str, float]:
        """Fit the decode-family (overhead, scale) and the prefill-family
        through-origin scale from the traced programs' measured medians
        vs their modeled seconds."""
        config = trace.boot_config()
        fams: Dict[str, List[Tuple[float, float]]] = \
            {"decode": [], "prefill": []}
        for program, walls in trace.dispatch_walls().items():
            fams[_FAMILY.get(program, "decode")].append(
                (self.modeled_seconds(config, program), _median(walls)))
        total = len(fams["decode"]) + len(fams["prefill"])
        if not total:
            raise ValueError("trace has no dispatch events to calibrate on")
        # a prefill-only trace (no decode ever ran) is all we have: fall
        # back to its points for the decode line rather than guessing
        dec = fams["decode"] or fams["prefill"]
        if len(dec) >= 2 and max(m for m, _ in dec) > min(m for m, _
                                                          in dec):
            n = len(dec)
            sx = sum(m for m, _ in dec)
            sy = sum(y for _, y in dec)
            sxx = sum(m * m for m, _ in dec)
            sxy = sum(m * y for m, y in dec)
            slope = (n * sxy - sx * sy) / (n * sxx - sx * sx)
            inter = (sy - slope * sx) / n
            if slope <= 0.0:
                # degenerate fit (all walls ~equal): flat overhead model
                slope, inter = 0.0, sy / n
            if inter < 0.0:
                # the modeled ratio overexplains the measured spread; a
                # negative dispatch floor would make deep fusion look
                # free, so fall back to the dispatch-floor split of the
                # smallest shape (conservative for amortization)
                m0, w0 = min(dec)
                inter = self.overhead_frac * w0
                slope = (w0 - inter) / m0 if m0 else 0.0
            self.overhead, self.scale = inter, slope
        else:
            # one decode-path shape: the wall cannot be split, so split
            # it by the dispatch-floor prior (see class docstring)
            m0, w0 = dec[0]
            self.overhead = self.overhead_frac * w0
            self.scale = (w0 - self.overhead) / m0 if m0 else 0.0
        pre = [(m, w) for m, w in fams["prefill"] if m > 0]
        self.prefill_scale = (sum(w / m for m, w in pre) / len(pre)
                              if pre else None)
        return {"overhead_s": self.overhead, "scale": self.scale,
                "prefill_scale": self.prefill_scale, "points": total,
                "decode_points": len(fams["decode"])}

    def predict(self, config: EngineConfig, program: str) -> float:
        """Calibrated wall seconds for one dispatch."""
        modeled = self.modeled_seconds(config, program)
        if _FAMILY.get(program) == "prefill" and \
                self.prefill_scale is not None:
            return self.prefill_scale * modeled
        return self.overhead + self.scale * modeled


# ---------------------------------------------------------------------------
# replay simulator
# ---------------------------------------------------------------------------

@dataclass
class SimResult:
    """What one replay predicts for one candidate config."""
    tokens: int
    decode_dispatches: int
    decode_path_s: float
    wall_s: float
    ttft_mean_s: float
    requests: int

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens / self.decode_path_s if self.decode_path_s \
            else 0.0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["decode_tok_per_s"] = self.decode_tok_per_s
        return d


@dataclass
class _SimSlot:
    rid: int
    remaining: int
    blocks: int


def _service_times(trace: TraceLog, config: EngineConfig,
                   cost_model: Optional[CostModel]) -> Dict[str, float]:
    """Per-program dispatch seconds for ``config``: the traced median
    when the candidate leaves that program's compiled shape identical to
    the traced engine's (fingerprint-context equality), else the
    calibrated cost model."""
    base = trace.boot_config()
    walls = trace.dispatch_walls()
    traced = {_prog_key(base, p): _median(w) for p, w in walls.items()}

    programs = ["prefill_slot", "decode"]
    if config.spec is not None:
        programs.append("verify")
    if config.horizon is not None:
        programs.append("decode_horizon")
    out: Dict[str, float] = {}
    for program in programs:
        key = _prog_key(config, program)
        if key in traced:
            out[program] = traced[key]
        elif cost_model is not None:
            out[program] = cost_model.predict(config, program)
        else:
            # no cost model: nearest traced fallback (same program under
            # the traced knobs) keeps ranking sane for policy-only knobs
            fallback = [v for p, v in walls.items() if p == program]
            out[program] = _median(fallback[0]) if fallback else \
                _median([w for ws in walls.values() for w in ws])
    return out


def replay(trace: TraceLog, config: Optional[EngineConfig] = None,
           cost_model: Optional[CostModel] = None,
           accept_rate: float = 0.1) -> SimResult:
    """Discrete-event re-run of the traced arrival schedule under
    ``config`` (default: the traced config itself).

    Models the engine's scheduling skeleton — bounded batch slots, FIFO
    admission at recorded ``arrival_time``s, the paged arena as a block-
    capacity admission constraint, one decode-path dispatch per step
    (verify when speculating, a fused horizon when the adaptive policy
    would fuse, else single-step decode) — with per-dispatch service
    times from :func:`_service_times`.  Spec emission uses the traced
    acceptance rate when the trace has one; the default ``accept_rate``
    prior is deliberately pessimistic (0.1 -> zero extra tokens at
    k <= 4), so the search adopts speculation only on traced evidence,
    never on a hopeful prior the workload might not honor.
    Deterministic: same trace + config -> the same floats, which is what
    makes the TraceLog round-trip testable.
    """
    if config is None:
        config = trace.boot_config()
    times = _service_times(trace, config, cost_model)
    measured_accept = trace.accept_rate()
    if measured_accept is not None:
        accept_rate = measured_accept
    spec_k = config.spec_k or 0
    horizon = config.horizon_length or 1
    kv_block = config.paging.kv_block if config.paged else 0
    arena = (config.paging.resolved_arena_blocks(config.batch,
                                                 config.max_len)
             if config.paged else 0)

    # the workload, re-clamped to the candidate geometry exactly as
    # submit() would clamp it
    queue: List[Dict[str, Any]] = []
    for sub in trace.requests():
        plen = min(sub["prompt_len"], config.resolved_prefill_len)
        queue.append({"arrival": sub["arrival_time"],
                      "prompt_len": plen,
                      "max_new": min(sub["max_new"],
                                     config.max_len - plen)})

    t = 0.0
    slots: List[Optional[_SimSlot]] = [None] * config.batch
    used_blocks = 0
    tokens = 0
    decode_dispatches = 0
    decode_path_s = 0.0
    ttfts: List[float] = []
    n_requests = len(queue)

    def blocks_needed(r):
        return -(-(r["prompt_len"] + r["max_new"]) // kv_block) \
            if kv_block else 0

    while queue or any(s is not None for s in slots):
        # -- admission (one prefill_slot dispatch per admitted request)
        while queue and queue[0]["arrival"] <= t and None in slots:
            need = blocks_needed(queue[0])
            if arena and used_blocks + need > arena:
                break                        # deferred under memory pressure
            r = queue.pop(0)
            t += times["prefill_slot"]
            ttfts.append(t - r["arrival"])
            # the prefill's last logit IS the first generated token
            slot = _SimSlot(rid=0, remaining=r["max_new"] - 1,
                            blocks=need)
            tokens += 1
            used_blocks += need
            slots[slots.index(None)] = slot
            if slot.remaining <= 0:
                used_blocks -= slot.blocks
                slots[slots.index(slot)] = None
        active = [s for s in slots if s is not None]
        if not active:
            if queue:
                t = max(t, queue[0]["arrival"])   # idle until next arrival
                continue
            break
        # -- one decode-path dispatch (mirrors ServingEngine._use_horizon:
        # a fused horizon needs some row able to amortize the scan, and
        # with an eligible waiter queued it additionally needs admission
        # to be provably impossible for the whole horizon — every slot
        # full with budget > H, no EOS, no timeslice rotation)
        waiting = bool(queue) and queue[0]["arrival"] <= t
        fuse = horizon > 1 and any(
            s.remaining >= max(2, horizon // 2) for s in active)
        if fuse and waiting:
            fuse = (config.eos_id is None
                    and (config.paging.timeslice is None
                         if config.paged else True)
                    and None not in slots
                    and all(s.remaining > horizon for s in active))
        if spec_k:
            dt = times["verify"]
            emit = max(1, min(1 + round(accept_rate * spec_k),
                              1 + spec_k))
            per_slot = [min(emit, s.remaining) for s in active]
        elif fuse:
            dt = times["decode_horizon"]
            per_slot = [min(horizon, s.remaining) for s in active]
        else:
            dt = times["decode"]
            per_slot = [1 for s in active]
        t += dt
        decode_dispatches += 1
        decode_path_s += dt
        for s, n in zip(active, per_slot):
            s.remaining -= n
            tokens += n
            if s.remaining <= 0:
                used_blocks -= s.blocks
                slots[slots.index(s)] = None

    return SimResult(tokens=tokens, decode_dispatches=decode_dispatches,
                     decode_path_s=decode_path_s, wall_s=t,
                     ttft_mean_s=(sum(ttfts) / len(ttfts) if ttfts
                                  else 0.0),
                     requests=n_requests)


# ---------------------------------------------------------------------------
# config overlays
# ---------------------------------------------------------------------------

def config_overlay(base: EngineConfig, tuned: EngineConfig) \
        -> Dict[str, Any]:
    """Minimal top-level field diff ``tuned`` vs ``base``, as the JSON-
    serializable dict :func:`apply_overlay` consumes.  Sub-configs diff
    as whole values (a changed HorizonConfig appears as its full dict),
    which keeps merge semantics unambiguous."""
    bd, td = base.to_dict(), tuned.to_dict()
    return {k: td[k] for k in td if td[k] != bd[k]}


def apply_overlay(base: EngineConfig, overlay: Dict[str, Any]) \
        -> EngineConfig:
    """Merge a tuned overlay into ``base`` and revalidate.  Top-level
    replacement per field; unknown fields are rejected by
    ``EngineConfig.from_dict`` (an overlay from a newer schema fails
    loudly instead of silently dropping knobs)."""
    d = base.to_dict()
    d.update(overlay)
    return EngineConfig.from_dict(d)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@dataclass
class SearchResult:
    base_config: EngineConfig
    best_config: EngineConfig
    overlay: Dict[str, Any]
    predicted: SimResult
    base_predicted: SimResult
    trials: List[Dict[str, Any]] = field(default_factory=list)
    calibration: Dict[str, float] = field(default_factory=dict)

    @property
    def predicted_speedup(self) -> float:
        base = self.base_predicted.decode_tok_per_s
        return self.predicted.decode_tok_per_s / base if base else 0.0


def _with_knob(config: EngineConfig, axis: str, value) -> \
        Optional[EngineConfig]:
    """One coordinate move; None when the value is inexpressible for
    this base (e.g. kv_block that does not divide max_len)."""
    try:
        if axis == "horizons":
            return config.replace(horizon=(HorizonConfig(length=value)
                                           if value >= 2 else None))
        if axis == "spec_ks":
            if value == 0:
                return config.replace(spec=None)
            ngram = config.spec.ngram if config.spec is not None else 2
            return config.replace(spec=SpecConfig(k=value, ngram=ngram))
        if axis == "ngrams":
            if config.spec is None:
                return None
            return config.replace(spec=SpecConfig(k=config.spec.k,
                                                  ngram=value))
        if axis == "batches":
            return config.replace(batch=value)
        if axis == "kv_blocks":
            if not config.paged:
                return None
            return config.replace(paging=dataclasses.replace(
                config.paging, kv_block=value))
        if axis == "arena_fracs":
            if not config.paged:
                return None
            blocks = (None if value is None else max(1, int(
                value * config.batch * config.max_len
                // config.paging.kv_block)))
            return config.replace(paging=dataclasses.replace(
                config.paging, arena_blocks=blocks))
        if axis == "timeslices":
            if not config.paged:
                return None
            return config.replace(paging=dataclasses.replace(
                config.paging, timeslice=value))
        raise KeyError(axis)
    except (AssertionError, ValueError):
        return None           # config validation rejected the move


def autotune(trace: TraceLog,
             atcfg: AutotuneConfig = AutotuneConfig(),
             cost_model: Optional[CostModel] = None,
             arch: Optional[str] = None) -> SearchResult:
    """Coordinate descent over the knob grid, scored by :func:`replay`.

    Starts from the traced config; each pass sweeps every grid axis,
    replacing the incumbent whenever some candidate value predicts at
    least ``atcfg.min_gain`` x its decode throughput.  The cost model is
    calibrated on the trace once up front (built from the trace's boot
    arch when not supplied).  Every scored candidate lands in
    ``trials``, so callers can compare predicted against measured
    rankings."""
    base = trace.boot_config()
    if cost_model is None:
        if arch is None:
            for rec in trace.events:
                if rec["ev"] == "boot":
                    arch = rec["arch"]
                    break
        assert arch is not None, "trace has no boot event: pass arch="
        cost_model = CostModel(arch)
    calibration = cost_model.calibrate(trace)

    scored: Dict[str, SimResult] = {}

    def score(config: EngineConfig) -> SimResult:
        key = repr(sorted(config_overlay(base, config).items()))
        if key not in scored:
            scored[key] = replay(trace, config, cost_model)
        return scored[key]

    trials: List[Dict[str, Any]] = []
    incumbent = base
    best = score(base)
    base_predicted = best
    trials.append({"overlay": {}, "predicted": best.to_dict()})

    axes = [("horizons", atcfg.horizons), ("spec_ks", atcfg.spec_ks),
            ("ngrams", atcfg.ngrams), ("batches", atcfg.batches),
            ("kv_blocks", atcfg.kv_blocks),
            ("arena_fracs", atcfg.arena_fracs),
            ("timeslices", atcfg.timeslices)]
    for _ in range(atcfg.passes):
        moved = False
        for axis, values in axes:
            for value in values:
                cand = _with_knob(incumbent, axis, value)
                if cand is None or cand == incumbent:
                    continue
                res = score(cand)
                trials.append({"overlay": config_overlay(base, cand),
                               "predicted": res.to_dict()})
                if res.decode_tok_per_s > \
                        best.decode_tok_per_s * atcfg.min_gain:
                    incumbent, best, moved = cand, res, True
        if not moved:
            break

    return SearchResult(base_config=base, best_config=incumbent,
                        overlay=config_overlay(base, incumbent),
                        predicted=best, base_predicted=base_predicted,
                        trials=trials, calibration=calibration)
