"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU (port of
``repro/models/hybrid.py``).

The RG-LRU recurrence (arXiv:2402.19427):
    r_t = sigmoid(w_a * x_t + b_a)           (recurrence gate, diagonal)
    i_t = sigmoid(w_i * x_t + b_i)           (input gate, diagonal)
    a_t = exp(-c * softplus(L) * r_t)        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through K5 (``kernels.ops.rglru_scan``) from
the cached state, and training from zero with no cache; decode is the
one-token update in plain PyTorch, as the reference leaves it to XLA.
The three projections go through K2.  Cache writes are made in place: the
layer's ``conv`` buffer (the last 3 conv inputs, model dtype) and ``h``
(B, lru), fp32 whatever the model dtype.

In training, the recurrence's gradient is K5's backward kernel
(``repro_torch::rglru_scan_bwd``, the autograd of K5's operator); the
gate parameters' gradients (``lam``, ``w_a``, ``b_a``, ``w_i``, ``b_i``),
the conv's and the GELU gate's come from autograd through the plain ops,
as the reference leaves them to XLA, and the projections' from K2's
gradient.

Numerics against the reference: the reference's prefill combines steps
with ``lax.associative_scan``, K5 and its plain version walk them in
order, so the two agree to a tolerance, not bit for bit.  ``F.softplus``
returns x itself above 20 where ``jax.nn.softplus`` does not; the
difference there is below fp32's resolution of x.  The gate's GELU is the
tanh form, ``jax.nn.gelu``'s default.  The conv is a plain causal conv
plus bias, with no activation.

A right-padded prefill row runs whole through the conv and the scan, so
its padding enters ``h`` and the conv buffer, as in the reference; the
engine and its batch-1 reference pad to the same ``prefill_len`` and
agree.  At decode every reduction is elementwise (the conv's 4 taps are
added one after another), so a row's result does not depend on how many
rows share the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (Leaf, apply_rmsnorm, causal_conv,
                                       conv_step, linear)

Params = Dict[str, Any]

LRU_C = 8.0
CONV_WIDTH = 4


def rglru_shapes(cfg) -> Params:
    """One recurrent layer's parameter shapes (the reference's
    ``rglru_abstract``; the layer stack adds the leading axis).  The gate
    parameters are fp32 in any model dtype."""
    d = cfg.d_model
    lru = cfg.lru_width or d
    f32 = torch.float32
    return {
        "ln": Leaf((d,)),
        "w_x": Leaf((d, lru)),
        "w_gate": Leaf((d, lru)),
        "conv_w": Leaf((CONV_WIDTH, lru)),
        "conv_b": Leaf((lru,)),
        "lam": Leaf((lru,), f32),
        "w_a": Leaf((lru,), f32),
        "b_a": Leaf((lru,), f32),
        "w_i": Leaf((lru,), f32),
        "b_i": Leaf((lru,), f32),
        "w_out": Leaf((lru, d)),
    }


def rglru_cache_shapes(cfg, batch: int) -> Params:
    lru = cfg.lru_width or cfg.d_model
    return {"conv": Leaf((batch, CONV_WIDTH - 1, lru)),
            "h": Leaf((batch, lru), torch.float32)}


def _gates(p, x):
    """(a, b) of the recurrence for conv output x, in fp32."""
    xf = x.float()
    r = torch.sigmoid(p["w_a"] * xf + p["b_a"])
    i = torch.sigmoid(p["w_i"] * xf + p["b_i"])
    log_a = -LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, b


def rglru_scan(p, x, h0=None):
    """x: (B,S,lru) -> (y (B,S,lru) in x's dtype, h_final (B,lru) fp32),
    the recurrence from h0 (zeros where None) through K5."""
    a, b = _gates(p, x)
    h, hf = ops.rglru_scan(a.contiguous(), b.contiguous(), h0)
    return h.to(x.dtype), hf


def rglru_decode(p, x, hprev):
    """x: (B,1,lru), hprev: (B,lru) fp32 -> (y (B,1,lru), h (B,lru))."""
    a, b = _gates(p, x[:, 0])
    h = a * hprev + b
    return h.to(x.dtype)[:, None], h


def apply_rglru_layer(cfg, p: Params, x: torch.Tensor, *, mode: str,
                      cache, live=None) -> Tuple[torch.Tensor, Any]:
    """Full recurrent block: norm -> (x, gate) projections -> conv ->
    RG-LRU -> gated out projection.  Writes the layer's ``conv`` and ``h``
    into ``cache`` in place; in decode mode a row with ``live`` (B,) False
    keeps its old ones.  ``mode="train"`` takes ``cache=None``, runs the
    conv and the scan from zero (the reference's ``h0 = None``), writes
    nothing and returns ``(x, None)``."""
    residual = x
    xn = apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    xb = linear(xn, p["w_x"])
    gate = F.gelu(linear(xn, p["w_gate"]), approximate="tanh")
    w = CONV_WIDTH - 1

    if mode == "decode":
        full = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)],
                         dim=1)                                 # (B,4,lru)
        conv = conv_step(full, p["conv_w"], p["conv_b"])[:, None]
        new_conv = full[:, 1:]
        y, hf = rglru_decode(p, conv, cache["h"])
    elif mode == "prefill":
        conv = causal_conv(xb, p["conv_w"], p["conv_b"])
        y, hf = rglru_scan(p, conv, h0=cache["h"])
        new_conv = F.pad(xb, (0, 0, w, 0))[:, -w:]
    elif mode == "train":
        if cache is not None:
            raise ValueError("the RG-LRU layer's training forward takes no "
                             "cache")
        y, _ = rglru_scan(p, causal_conv(xb, p["conv_w"], p["conv_b"]))
        return residual + linear(y * gate, p["w_out"]), None
    else:
        raise ValueError(f"mode {mode!r}: decode, prefill or train")

    out = linear(y * gate, p["w_out"])
    if live is not None and mode == "decode":
        new_conv = torch.where(live[:, None, None],
                               new_conv.to(cache["conv"].dtype),
                               cache["conv"])
        hf = torch.where(live[:, None], hf, cache["h"])
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(hf)
    return residual + out, cache
