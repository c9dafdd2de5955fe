"""Deterministic, restartable synthetic token pipeline (port of
``repro/data/pipeline.py``).

Batches come from a counter-based generator, numpy's ``default_rng``
seeded by ``SeedSequence([seed, step])``, so the stream is deterministic
(one seed and step give one batch on every host), restartable (resuming
after checkpoint step k replays batch k + 1 exactly) and prefetchable (a
one-deep host thread makes the next batch while the device runs the
step).  The draws are the reference's, in its order: a Zipf-ish unigram
stream with a learnable bigram rule, so the loss moves.

numpy has no bfloat16 without the ``ml_dtypes`` package, which the port
does not use: a leaf of a bf16 model (a frontend's ``prefix_embeds``, an
encoder's ``frames``) leaves :meth:`TokenPipeline.host_batch` as float32,
and :meth:`TokenPipeline.device_batch` rounds it to bf16 (to nearest
even, as the reference's ``astype`` does), so the device sees the
reference's bits.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.layers import Leaf, torch_dtype


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


def make_batch_specs(cfg, data: DataConfig) -> Dict[str, Leaf]:
    """The batch of a train step as :class:`Leaf` shapes (dtype ``None``:
    the model's)."""
    b, s = data.global_batch, data.seq_len
    if cfg.is_encdec:
        return {"frames": Leaf((b, s // 2, cfg.d_model)),
                "tokens": Leaf((b, s // 2), torch.int32),
                "labels": Leaf((b, s // 2), torch.int32)}
    p = cfg.frontend_tokens
    out = {"tokens": Leaf((b, s - p), torch.int32),
           "labels": Leaf((b, s), torch.int32)}
    if p:
        out["prefix_embeds"] = Leaf((b, p, cfg.d_model))
    return out


class TokenPipeline:
    """step -> batch, with an optional background prefetch."""

    def __init__(self, cfg, data: DataConfig, device="cpu",
                 prefetch: int = 1):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)
        self._prefetch = prefetch
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic generation -------------------------------------------
    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, d = self.cfg, self.data
        rng = np.random.default_rng(np.random.SeedSequence([d.seed, step]))
        vocab = cfg.vocab_size
        # Zipf-ish unigram + a learnable bigram rule (token t+1 = f(t) often)
        s = d.seq_len // 2 if cfg.is_encdec else d.seq_len
        base = rng.zipf(1.3, size=(d.global_batch, s + 1)) % vocab
        follow = (base[:, :-1] * 31 + 7) % vocab
        coin = rng.random((d.global_batch, s)) < 0.5
        seq = np.where(coin, follow, base[:, 1:]).astype(np.int32)
        full = np.concatenate([base[:, :1].astype(np.int32), seq], axis=1)
        if cfg.is_encdec:
            frames = rng.standard_normal(
                (d.global_batch, s, cfg.d_model)).astype(np.float32) * 0.02
            return {"frames": frames, "tokens": full[:, :-1],
                    "labels": full[:, 1:]}
        p = cfg.frontend_tokens
        batch = {"tokens": full[:, :-1][:, :d.seq_len - p]}
        labels = full[:, 1:].copy()
        if p:
            labels = np.concatenate(
                [np.full((d.global_batch, p), -1, np.int32),
                 labels[:, :d.seq_len - p]], axis=1)
            batch["prefix_embeds"] = (rng.standard_normal(
                (d.global_batch, p, cfg.d_model)) * 0.02).astype(np.float32)
        batch["labels"] = labels[:, :d.seq_len]
        return batch

    def device_batch(self, step: int,
                     device=None) -> Dict[str, torch.Tensor]:
        """:meth:`host_batch` as tensors on ``device`` (default: the
        pipeline's); float leaves in the model's dtype."""
        return self._to_device(self.host_batch(step), device)

    # -- prefetching iterator -------------------------------------------------
    def run(self, start_step: int, num_steps: int) -> Iterator:
        """(step, device batch) for steps start_step .. start_step +
        num_steps - 1; with ``prefetch`` a thread makes the next batches
        (host arrays) while the caller runs a step."""
        if self._prefetch <= 0:
            for s in range(start_step, start_step + num_steps):
                yield s, self.device_batch(s)
            return
        q: Queue = Queue(maxsize=self._prefetch)
        stop = self._stop
        stop.clear()

        def producer():
            for s in range(start_step, start_step + num_steps):
                if stop.is_set():
                    return
                q.put((s, self.host_batch(s)))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        self._thread = t
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                s, hb = item
                yield s, self._to_device(hb)
        finally:
            # a consumer that stops early (a failure) releases the producer
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except Exception:
                    pass
                t.join(timeout=0.01)

    def _to_device(self, hb: Dict[str, np.ndarray],
                   device=None) -> Dict[str, Any]:
        device = self.device if device is None else torch.device(device)
        dtype = torch_dtype(self.cfg.dtype)
        out = {}
        for k, v in hb.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.is_floating_point():
                t = t.to(dtype)
            out[k] = t.to(device)
        return out

    def stop(self):
        self._stop.set()
