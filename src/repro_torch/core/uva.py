"""uva — unified virtual address space (paper §3.5, contribution C5),
port of ``repro/core/uva.py``.

The Epiphany remapping let the SAME pointer be dereferenced on host and
coprocessor, replacing opaque read/write calls with plain ``memcpy``.  The
analogue here is a *named buffer registry* that binds one logical buffer
to its host view (a CPU tensor: numpy has no bfloat16) and its device view
and keeps them coherent on demand.  Host calls pass buffer names + offsets
instead of opaque handles — "pointer-to-pointer" structures work because
both sides resolve the same names.

When the registry's device is the card, host views are page-locked
(pinned) CPU tensors, so a copy either way is one DMA.  Sharded device
views belong to tensor-parallel serving (ROADMAP Queue 1 item 13) and
raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class Buffer:
    name: str
    host: torch.Tensor                    # host view (authoritative on write)
    device: Optional[torch.Tensor] = None  # device view
    dirty_host: bool = False              # host newer than device
    dirty_device: bool = False            # device newer than host


def _no_sharding(sharding):
    if sharding is not None:
        raise NotImplementedError(
            "sharded UVA buffers belong to tensor-parallel serving, which "
            "is not ported yet (ROADMAP Queue 1 item 13)")


class UVARegistry:
    """name -> coherent (host, device) buffer pair with memcpy semantics.

    ``device``: where device views live; ``None`` means the card
    (``"cuda"``), where host views are pinned."""

    def __init__(self, device=None):
        self.device = torch.device(device or "cuda")
        self._bufs: Dict[str, Buffer] = {}

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a host view: on the CPU, pinned when the device is
        the card (a copy only where it is not pinned already)."""
        t = t.cpu()
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t

    # -- allocation (the dmalloc analogue) -----------------------------------
    def alloc(self, name: str, shape, dtype, sharding=None) -> Buffer:
        _no_sharding(sharding)
        buf = Buffer(name=name, host=self._host(torch.zeros(shape,
                                                            dtype=dtype)))
        self._bufs[name] = buf
        return buf

    def bind_host(self, name: str, tensor: torch.Tensor) -> Buffer:
        buf = Buffer(name=name, host=self._host(tensor), dirty_host=True)
        self._bufs[name] = buf
        return buf

    def bind_device(self, name: str, tensor: torch.Tensor) -> Buffer:
        buf = Buffer(name=name,
                     host=self._host(torch.zeros(tensor.shape,
                                                 dtype=tensor.dtype)),
                     device=tensor, dirty_device=True)
        self._bufs[name] = buf
        return buf

    def free(self, name: str):
        self._bufs.pop(name, None)

    def __contains__(self, name):
        return name in self._bufs

    # -- memcpy-style access ---------------------------------------------------
    def write(self, name: str, data, offset: int = 0):
        """Plain host-side write (the paper's ordinary memcpy)."""
        buf = self._bufs[name]
        flat = buf.host.reshape(-1)
        src = torch.as_tensor(data).to(buf.host.dtype).reshape(-1)
        flat[offset:offset + src.numel()] = src
        buf.dirty_host = True

    def read(self, name: str, count: Optional[int] = None,
             offset: int = 0) -> torch.Tensor:
        buf = self._bufs[name]
        self.sync_to_host(name)
        if count is None:
            return buf.host
        return buf.host.reshape(-1)[offset:offset + count]

    # -- coherence ---------------------------------------------------------------
    def to_device(self, name: str, sharding=None) -> torch.Tensor:
        _no_sharding(sharding)
        buf = self._bufs[name]
        if buf.device is None or buf.dirty_host:
            buf.device = buf.host.to(self.device)
            buf.dirty_host = False
        return buf.device

    def update_device(self, name: str, tensor: torch.Tensor):
        buf = self._bufs[name]
        buf.device = tensor
        buf.dirty_device = True

    def sync_to_host(self, name: str) -> torch.Tensor:
        buf = self._bufs[name]
        if buf.dirty_device and buf.device is not None:
            buf.host = self._host(buf.device)   # blocking: the host reads
            buf.dirty_device = False
        return buf.host

    def report(self) -> Dict[str, Dict[str, Any]]:
        return {n: {"shape": list(b.host.shape),
                    "dtype": str(b.host.dtype).replace("torch.", ""),
                    "bytes": b.host.numel() * b.host.element_size(),
                    "on_device": b.device is not None}
                for n, b in self._bufs.items()}
