"""Typed serving-engine configuration: the dense fields of the reference's
``EngineConfig`` (``repro/engine_config.py``) plus ``device``.

Paging, prefix sharing, speculative decoding, decode horizons and sharding
are not ported yet (ROADMAP Queue 1 items 4-7 and 13); the config has no
field for them, so asking for one fails at construction.  Burst admission
(``group_prefill=True``) is not ported yet either and raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class EngineConfig:
    """Everything a dense ``ServingEngine`` is, as one frozen value object.

    device: where the engine runs; ``None`` means the card (``"cuda"``).
        Tests ask for ``"cpu"``.
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
    device: Optional[str] = None

    def __post_init__(self):
        if self.clock not in ("wall", "step"):
            raise ValueError(f"clock must be 'wall' or 'step': {self.clock!r}")
        if not 0 < self.resolved_prefill_len < self.max_len:
            raise ValueError(f"need 0 < prefill_len < max_len: "
                             f"{self.prefill_len}, {self.max_len}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1: {self.batch}")
        if self.group_prefill:
            raise NotImplementedError(
                "group_prefill (burst admission through a whole-batch "
                "prefill program) is not ported yet (ROADMAP Queue 1 item 3c)")

    @property
    def resolved_prefill_len(self) -> int:
        return self.prefill_len or self.max_len // 2

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
