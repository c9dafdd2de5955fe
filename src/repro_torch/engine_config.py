"""Typed serving-engine configuration: the reference's ``EngineConfig``
(``repro/engine_config.py``) as far as the port carries it, plus
``device``: the dense fields, burst admission (``group_prefill``: a
whole-batch ``prefill`` program), ``paging`` (:class:`PagingConfig`, the
paged KV arena of :mod:`repro_torch.core.paging`), ``prefix``
(:class:`PrefixConfig`, cross-request prefix sharing over that arena),
``spec`` (:class:`SpecConfig`, speculative decoding) and ``horizon``
(:class:`HorizonConfig`, fused decode horizons); and the fleet's
:class:`ScaleConfig` and :class:`ClusterConfig` (:mod:`repro_torch.cluster`),
and the autotuner's knob grid :class:`AutotuneConfig`
(:mod:`repro_torch.runtime.autotune`).  Every config round-trips through a plain dict (``to_dict`` /
``from_dict``).

Sharding is not ported yet (ROADMAP Queue 1 item 13); the config has no
field for it, so asking for one fails at construction, and a fleet's
replicas each run on one device.
``group_prefill`` with ``paging`` or ``spec`` raises as in the reference,
which cannot combine them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

# router policies a ClusterConfig may name (repro_torch.cluster.router
# implements them; the tuple lives here so config validation needs no
# cluster import)
ROUTER_POLICIES = ("least_loaded", "round_robin", "prefix_affinity")

__all__ = ["ROUTER_POLICIES", "PagingConfig", "PrefixConfig", "SpecConfig",
           "HorizonConfig", "EngineConfig", "ScaleConfig", "ClusterConfig",
           "AutotuneConfig"]


@dataclass(frozen=True)
class PagingConfig:
    """Paged KV-cache arena geometry (repro_torch.core.paging).

    kv_block: tokens per physical KV block (must divide ``max_len``).
    arena_blocks: device-resident physical blocks; ``None`` fits the whole
        batch (``batch * max_len / kv_block`` — no memory pressure).
    timeslice: optional preemptive round-robin — active requests that have
        decoded this many tokens since (re)admission are preempted when a
        queued request cannot fit the arena.  Host-side policy only.
    """
    kv_block: int = 8
    arena_blocks: Optional[int] = None
    timeslice: Optional[int] = None

    def __post_init__(self):
        if self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1: {self.kv_block}")
        if self.arena_blocks is not None and self.arena_blocks < 1:
            raise ValueError(f"arena_blocks must be >= 1: "
                             f"{self.arena_blocks}")
        if self.timeslice is not None and self.timeslice < 1:
            raise ValueError(f"timeslice must be >= 1: {self.timeslice}")

    def resolved_arena_blocks(self, batch: int, max_len: int) -> int:
        assert max_len % self.kv_block == 0, (max_len, self.kv_block)
        return (self.arena_blocks if self.arena_blocks is not None
                else batch * (max_len // self.kv_block))


@dataclass(frozen=True)
class PrefixConfig:
    """Cross-request prefix sharing over the paged KV arena
    (repro_torch.core.paging trie + PrefixStore).  Requires ``paging``.

    max_suffix: static suffix capacity of the ``prefill_offset`` program,
        the most tokens recomputed past a matched prefix on the warm
        admission path; ``None`` -> ``2 * kv_block`` (the worst-case
        remainder of a prompt whose whole head matched).  Longer
        divergences fall back to the full prefill program: its storage is
        still deduplicated (matched blocks map read-only; the block-table
        write guard drops the recomputed duplicates), only the compute
        saving is lost.
    min_blocks: smallest trie match worth taking the warm path for;
        below it the full prefill runs (shared mappings still apply).
    """
    max_suffix: Optional[int] = None
    min_blocks: int = 1

    def __post_init__(self):
        if self.max_suffix is not None and self.max_suffix < 1:
            raise ValueError(f"max_suffix must be >= 1: {self.max_suffix}")
        if self.min_blocks < 1:
            raise ValueError(f"min_blocks must be >= 1: {self.min_blocks}")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding: ``k`` drafts per verify execution, proposed by
    a suffix ``ngram`` prompt-lookup over each request's own history
    (:class:`repro_torch.spec.NGramProposer`)."""
    k: int = 3
    ngram: int = 2

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1: {self.k}")
        if self.ngram < 1:
            raise ValueError(f"spec ngram must be >= 1: {self.ngram}")


@dataclass(frozen=True)
class HorizonConfig:
    """Fused decode horizons: up to ``length`` greedy decode iterations per
    ``decode_horizon`` dispatch.  ``length`` < 2 is plain decode: construct
    no HorizonConfig at all instead."""
    length: int = 4

    def __post_init__(self):
        if self.length < 2:
            raise ValueError(f"horizon length must be >= 2: {self.length}")


@dataclass(frozen=True)
class EngineConfig:
    """Everything a ``ServingEngine`` is, as one frozen value object.

    device: where the engine runs; ``None`` means the card (``"cuda"``).
        Tests ask for ``"cpu"``.
    store_dir: a :class:`~repro_torch.core.program_store.ProgramStore`
        directory the engine boots from and writes back into.
    n_layers: the model cut to its first ``n_layers`` layers, its width
        kept; ``None`` serves the config's own depth.  A depth cut is a
        measurement's choice (a run's time on the card), never the
        model's: the programs' fingerprints and the weights follow it.
    """
    reduced: bool = True
    batch: int = 4
    max_len: int = 128
    prefill_len: Optional[int] = None     # None -> max_len // 2
    eos_id: Optional[int] = None
    seed: int = 0
    max_queue: int = 64
    clock: str = "wall"                   # "wall" | "step"
    group_prefill: bool = False
    store_dir: Optional[str] = None       # shorthand for ProgramStore(dir)
    device: Optional[str] = None
    paging: Optional[PagingConfig] = None
    prefix: Optional[PrefixConfig] = None
    spec: Optional[SpecConfig] = None
    horizon: Optional[HorizonConfig] = None
    n_layers: Optional[int] = None

    def __post_init__(self):
        if self.n_layers is not None and self.n_layers < 1:
            raise ValueError(f"n_layers must be >= 1: {self.n_layers}")
        if self.clock not in ("wall", "step"):
            raise ValueError(f"clock must be 'wall' or 'step': {self.clock!r}")
        if not 0 < self.resolved_prefill_len < self.max_len:
            raise ValueError(f"need 0 < prefill_len < max_len: "
                             f"{self.prefill_len}, {self.max_len}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1: {self.batch}")
        if self.paging is not None:
            if self.max_len % self.paging.kv_block:
                raise ValueError(f"kv_block must divide max_len: "
                                 f"{self.paging.kv_block}, {self.max_len}")
            if self.group_prefill:
                raise ValueError("group_prefill rewrites every slot; "
                                 "incompatible with paging")
        if self.prefix is not None:
            if self.paging is None:
                raise ValueError("prefix sharing indexes paged KV blocks: "
                                 "set paging too")
            if self.resolved_prefix_suffix > self.resolved_prefill_len:
                raise ValueError(
                    f"prefix max_suffix exceeds prefill_len: "
                    f"{self.resolved_prefix_suffix}, "
                    f"{self.resolved_prefill_len}")
        if self.spec is not None and self.group_prefill:
            raise ValueError("group_prefill rewrites every slot; "
                             "incompatible with the speculative non-ring "
                             "cache layout")

    @property
    def resolved_prefill_len(self) -> int:
        return self.prefill_len or self.max_len // 2

    @property
    def paged(self) -> bool:
        return self.paging is not None

    @property
    def spec_k(self) -> Optional[int]:
        return self.spec.k if self.spec is not None else None

    @property
    def horizon_length(self) -> Optional[int]:
        return self.horizon.length if self.horizon is not None else None

    @property
    def resolved_prefix_suffix(self) -> int:
        """Static token capacity of the warm-path ``prefill_offset``
        program (see :class:`PrefixConfig`)."""
        assert self.prefix is not None
        return (self.prefix.max_suffix
                if self.prefix.max_suffix is not None
                else 2 * self.paging.kv_block)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # -- fingerprint contexts ------------------------------------------------
    def program_context(self) -> str:
        """The program-shape half of this config, as a deterministic string
        folded into every serving ProgramSpec's fingerprint context.

        Includes exactly what changes the programs: batch / cache
        geometry, the paged-arena shape, and the speculative width (which
        flips windowed layers to non-ring buffers).  Excludes host-side
        scheduling (clock, max_queue, seed, group_prefill, timeslice,
        proposer n-gram, store location) so engines differing only in
        policy share store entries; the device is in the store's
        environment key."""
        items = [("batch", self.batch), ("max_len", self.max_len),
                 ("prefill_len", self.resolved_prefill_len)]
        if self.paging is not None:
            items += [("paged", True), ("kv_block", self.paging.kv_block),
                      ("arena_blocks", self.paging.resolved_arena_blocks(
                          self.batch, self.max_len))]
        if self.spec is not None:
            items += [("spec", self.spec.k)]
        return repr(tuple(items))

    def horizon_context(self) -> str:
        """Extra context for the ``decode_horizon`` program only: its
        closure-captured statics (H, eos), so two horizon lengths never
        collide."""
        return repr((("horizon", self.horizon_length),
                     ("eos", self.eos_id)))

    def prefix_context(self) -> str:
        """Extra context for the ``prefill_offset`` program only: its
        closure-captured suffix capacity."""
        return repr((("prefix_suffix", self.resolved_prefix_suffix),))

    # -- dict round trip -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain nested dict (JSON-serializable); inverse of from_dict."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        d = dict(d)
        for key, sub in (("paging", PagingConfig), ("prefix", PrefixConfig),
                         ("spec", SpecConfig), ("horizon", HorizonConfig)):
            v = d.get(key)
            if isinstance(v, dict):
                d[key] = sub(**v)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(f"unknown EngineConfig fields: {sorted(unknown)}")
        return cls(**d)


@dataclass(frozen=True)
class ScaleConfig:
    """Elastic fleet scaling for a serving cluster (repro_torch.cluster).

    The supervisor watches normalized fleet load — per running replica,
    ``(active slots + routed queue depth) / batch`` plus paged-arena
    pressure, the same basis ``Router.load`` ranks on — and resizes the
    fleet between ``min_replicas`` and ``max_replicas``:

      * load >= ``high_watermark`` for ``sustain_window`` consecutive
        supervisor passes spawns one replica, booted WARM from the shared
        ProgramStore (and PrefixStore) mid-run, then rebalances queued
        (never active) requests onto it through the journal ``moved``
        path;
      * load <= ``low_watermark`` sustained, with some replica idle that
        whole window, quiesces the idle replica: routing stops, its
        in-flight batch drains, then it retires and its journal/telemetry
        fold into the fleet accumulators;
      * a sustained straggler escalation
        (:class:`repro_torch.runtime.fault.StragglerMonitor`) replaces the
        slow replica outright: a fresh warm replica boots, the victim's
        unfinished requests re-route via the journal, the victim retires.
        Replacement is capacity-neutral and therefore allowed even at
        ``max_replicas``.

    ``cooldown`` supervisor passes must elapse between scale actions so
    one burst cannot thrash the fleet.  ``async_spawn`` reads and loads
    the new engine's stored programs on a background thread, so serving
    does not stall behind that CPU work; the rest of the boot (device
    allocation, and on the card the warm-up and capture) runs on the
    supervisor's thread when the replica attaches.  The default loads on
    the supervisor's thread too, so the whole schedule stays deterministic
    on the step clock (tests).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    high_watermark: float = 0.85
    low_watermark: float = 0.15
    sustain_window: int = 3
    cooldown: int = 8
    async_spawn: bool = False
    # straggler-triggered replacement on/off.  Watermark grow/shrink and
    # crash failover are unaffected; escalations are still observed and
    # reported.  Benchmarks whose replicas share one process turn this off
    # by name: a concurrent boot inflates every replica's tick wall (the
    # interpreter lock), which is not a straggler.
    straggler_detection: bool = True

    def __post_init__(self):
        assert 1 <= self.min_replicas <= self.max_replicas, \
            (self.min_replicas, self.max_replicas)
        assert 0.0 <= self.low_watermark < self.high_watermark, \
            (self.low_watermark, self.high_watermark)
        assert self.sustain_window >= 1, self.sustain_window
        assert self.cooldown >= 0, self.cooldown

    def replace(self, **kw) -> "ScaleConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ClusterConfig:
    """A multi-replica serving cluster, as one frozen value object
    (repro_torch.cluster): N identical :class:`EngineConfig` replicas
    behind one router, supervised with health checks and warm failover.

    engine: the per-replica engine config.  Its ``store_dir`` must be
        unset — the cluster owns ONE shared program store
        (``ClusterConfig.store_dir``) so every replica, and every
        failover reboot, warm-loads from the same global-memory tier.
    replicas: replica count (>= 1).
    router: request-assignment policy (``ROUTER_POLICIES``):
        ``least_loaded`` scores queue depth + slot occupancy + arena
        pressure; ``round_robin`` cycles; ``prefix_affinity`` pins a
        prompt's prefix hash to a preferred replica (falling back to
        least-loaded when that replica cannot admit).
    affinity_len: prompt-prefix tokens hashed by ``prefix_affinity``.
    health_interval: supervisor ticks between health checks per replica
        (each check feeds new step-latency telemetry into that replica's
        StragglerMonitor).
    straggler_threshold / straggler_patience: the per-replica
        StragglerMonitor policy — a supervised tick slower than
        ``threshold x`` the replica's rolling median is a straggler
        observation, ``patience`` consecutive observations escalate (and,
        with ``scale`` set, trigger proactive replacement).
    max_restarts / backoff_s / backoff_factor: the serving-side restart
        policy (repro_torch.runtime.fault.RestartPolicy): a crashed
        replica is rebooted at most ``max_restarts`` times, the n-th
        reboot delayed ``backoff_s * backoff_factor**(n-1)`` seconds; past
        the limit its unfinished requests re-route to surviving replicas.
    store_dir: the SHARED ProgramStore directory (warm failover); ``None``
        = no store, every reboot runs the program functions again.
    journal_dir: directory for the durable per-replica request journals;
        ``None`` keeps them in supervisor memory (kill-safe, not
        process-crash-safe).
    scale: elastic fleet scaling policy (:class:`ScaleConfig`); ``None``
        keeps the fleet fixed at ``replicas``.  When set, ``replicas`` is
        the *initial* fleet size and must sit inside
        ``[min_replicas, max_replicas]``.
    """
    engine: EngineConfig = EngineConfig()
    replicas: int = 2
    router: str = "least_loaded"
    affinity_len: int = 8
    health_interval: int = 8
    straggler_threshold: float = 1.5
    straggler_patience: int = 3
    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    store_dir: Optional[str] = None
    journal_dir: Optional[str] = None
    scale: Optional[ScaleConfig] = None

    def __post_init__(self):
        assert self.replicas >= 1, self.replicas
        if self.scale is not None:
            assert (self.scale.min_replicas <= self.replicas
                    <= self.scale.max_replicas), \
                "initial replica count must sit inside the elastic " \
                f"range: {self.scale.min_replicas} <= {self.replicas} " \
                f"<= {self.scale.max_replicas}"
        assert self.router in ROUTER_POLICIES, \
            (self.router, ROUTER_POLICIES)
        assert self.affinity_len >= 1, self.affinity_len
        assert self.health_interval >= 1, self.health_interval
        assert self.straggler_threshold > 1.0, self.straggler_threshold
        assert self.straggler_patience >= 1, self.straggler_patience
        assert self.max_restarts >= 0, self.max_restarts
        assert self.backoff_s >= 0 and self.backoff_factor >= 1, \
            (self.backoff_s, self.backoff_factor)
        assert self.engine.store_dir is None, \
            "the cluster owns the shared program store: set " \
            "ClusterConfig.store_dir, not EngineConfig.store_dir"

    def replace(self, **kw) -> "ClusterConfig":
        return dataclasses.replace(self, **kw)

    # -- dict round trip -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterConfig":
        d = dict(d)
        if isinstance(d.get("engine"), dict):
            d["engine"] = EngineConfig.from_dict(d["engine"])
        if isinstance(d.get("scale"), dict):
            d["scale"] = ScaleConfig(**d["scale"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(
                f"unknown ClusterConfig fields: {sorted(unknown)}")
        return cls(**d)


@dataclass(frozen=True)
class AutotuneConfig:
    """Knob grid and search policy of the trace-driven autotuner
    (:mod:`repro_torch.runtime.autotune`).

    Each grid axis enumerates the discrete values the search may try for
    one engine knob; sentinel ``0`` / ``None`` entries mean "subsystem
    off" (horizon 0/1 -> no HorizonConfig, spec_k 0 -> no SpecConfig,
    arena_frac None -> full-batch residency, timeslice None -> no
    rotation).  The search is coordinate descent: ``passes`` sweeps over
    the axes, each sweep replay-simulating every candidate value of one
    knob with the others held at the incumbent, adopting a move only when
    it predicts at least ``min_gain`` x the incumbent's throughput: the
    hysteresis that keeps simulator noise from flapping configs whose
    difference is below what the replay model can resolve.
    """
    horizons: tuple = (1, 4, 8, 16)
    spec_ks: tuple = (0, 3)
    ngrams: tuple = (2,)
    batches: tuple = (2, 4, 8)
    kv_blocks: tuple = (8, 16)
    arena_fracs: tuple = (1.0,)
    timeslices: tuple = (None,)
    passes: int = 2
    min_gain: float = 1.02

    def __post_init__(self):
        # from_dict round trips through JSON, where tuples arrive as lists
        for axis in ("horizons", "spec_ks", "ngrams", "batches",
                     "kv_blocks", "arena_fracs", "timeslices"):
            vals = tuple(getattr(self, axis))
            object.__setattr__(self, axis, vals)
            assert vals, f"empty AutotuneConfig.{axis}"
        assert all(h >= 1 for h in self.horizons), self.horizons
        assert all(k >= 0 for k in self.spec_ks), self.spec_ks
        assert all(n >= 1 for n in self.ngrams), self.ngrams
        assert all(b >= 1 for b in self.batches), self.batches
        assert all(kb >= 1 for kb in self.kv_blocks), self.kv_blocks
        assert all(f is None or 0.0 < f <= 1.0
                   for f in self.arena_fracs), self.arena_fracs
        assert all(t is None or t >= 1
                   for t in self.timeslices), self.timeslices
        assert self.passes >= 1, self.passes
        assert self.min_gain >= 1.0, self.min_gain

    def replace(self, **kw) -> "AutotuneConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutotuneConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TypeError(
                f"unknown AutotuneConfig fields: {sorted(unknown)}")
        return cls(**d)
