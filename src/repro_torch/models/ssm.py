"""Mamba-2 (SSD, state-space duality) block (port of
``repro/models/ssm.py``).

Prefill runs the chunked SSD scan through K4 (``kernels.ops.ssd_scan``)
and adds the D-skip; decode is the one-token recurrent update in plain
PyTorch, as the reference leaves it to XLA.  Both projections go through
K2.  Cache writes are made in place: the layer's ``conv`` buffer (the last
``ssm_conv_width - 1`` conv inputs, model dtype) and ``state`` (B,H,P,N),
fp32 whatever the model dtype.

A right-padded prefill row runs whole through the scan, so its padding
enters the state and the conv buffer, as in the reference; the engine and
its batch-1 reference pad to the same ``prefill_len`` and agree.

Token exactness on the card: the decode update reduces only with
elementwise products summed one after another (the conv over its width)
or over a contiguous last axis with B x H x P >= 16 outputs (the state
against C), where PyTorch's reduction split does not depend on the batch
(``layers.mean_last`` says why 16), so a row's result does not depend on
how many rows share the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (Leaf, apply_rmsnorm, causal_conv,
                                       conv_step, linear)

Params = Dict[str, Any]

SSD_CHUNK = 128


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def ssm_shapes(cfg) -> Params:
    """One SSM layer's parameter shapes (the reference's ``ssm_abstract``;
    the layer stack adds the leading axis).  ``w_in`` projects to
    [z (d_inner), x (d_inner), B (N), C (N), dt (H)]."""
    d_inner, h, n, _ = _dims(cfg)
    d, conv_ch = cfg.d_model, d_inner + 2 * n
    f32 = torch.float32
    return {
        "ln": Leaf((d,)),
        "w_in": Leaf((d, 2 * d_inner + 2 * n + h)),
        "conv_w": Leaf((cfg.ssm_conv_width, conv_ch)),
        "conv_b": Leaf((conv_ch,)),
        "a_log": Leaf((h,), f32),
        "d_skip": Leaf((h,), f32),
        "dt_bias": Leaf((h,), f32),
        "out_ln": Leaf((d_inner,)),
        "w_out": Leaf((d_inner, d)),
    }


def ssm_cache_shapes(cfg, batch: int) -> Params:
    d_inner, h, n, p = _dims(cfg)
    return {"conv": Leaf((batch, cfg.ssm_conv_width - 1, d_inner + 2 * n)),
            "state": Leaf((batch, h, p, n), torch.float32)}


def _split_in(cfg, proj):
    """Views of the in-projection: z, the conv input [x, B, C] (one view:
    the three sit side by side, where the reference splits and
    concatenates them) and dt."""
    d_inner, _, n, _ = _dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def ssd_chunked(x, dt, a, b, c, d_skip, h0=None, chunk: int = SSD_CHUNK):
    """Chunked SSD scan plus the D-skip.

    x: (B,S,H,P) dt: (B,S,H) post-softplus, a: (H,) negative,
    b, c: (B,S,N) shared across heads (ngroups=1), h0: (B,H,P,N) or None.
    Returns (y (B,S,H,P), h_final (B,H,P,N)).  The scan is K4 on CUDA
    tensors and its plain version on CPU tensors."""
    y, hf = ops.ssd_scan(x, dt, a, b, c, h0, chunk=min(chunk, x.shape[1]))
    return y + x * d_skip[None, None, :, None].to(x.dtype), hf


def ssd_decode(x, dt, a, b, c, d_skip, hprev):
    """One-token recurrent update. x: (B,1,H,P) dt: (B,1,H) b,c: (B,1,N),
    hprev (B,H,P,N) fp32."""
    da = torch.exp(dt[:, 0] * a)                                  # (B,H)
    xdt = x[:, 0] * dt[:, 0, :, None].to(x.dtype)                 # (B,H,P)
    upd = xdt[..., None] * b[:, 0, None, None, :]                 # (B,H,P,N)
    hnew = hprev * da[..., None, None] + upd.float()
    y = (c[:, 0, None, None, :].float()
         * hnew.to(c.dtype).float()).sum(-1).to(x.dtype)          # (B,H,P)
    y = y + x[:, 0] * d_skip[None, :, None].to(x.dtype)
    return y[:, None], hnew


def apply_ssm_layer(cfg, p: Params, x: torch.Tensor, *, mode: str,
                    cache, live=None) -> Tuple[torch.Tensor, Any]:
    """Full Mamba-2 block: norm -> in_proj -> conv -> SSD -> gated out.
    Writes the layer's ``conv`` and ``state`` into ``cache`` in place; in
    decode mode a row with ``live`` (B,) False keeps its old ones."""
    d_inner, h, n, phd = _dims(cfg)
    residual = x
    xn = apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    proj = linear(xn, p["w_in"])
    z, conv_in, dt = _split_in(cfg, proj)
    w = cfg.ssm_conv_width - 1

    if mode == "decode":
        full = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)],
                         dim=1)                                   # (B,W,C)
        conv_out = F.silu(conv_step(full, p["conv_w"], p["conv_b"]))[:, None]
        new_conv = full[:, 1:]
    elif mode == "prefill":
        conv_out = F.silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]))
        new_conv = F.pad(conv_in, (0, 0, w, 0))[:, -w:]
    else:
        raise NotImplementedError(
            f"mode {mode!r}: the Mamba-2 layer's training forward (and its "
            f"scan's backward kernel) is not ported yet (ROADMAP Queue 1 "
            f"item 14b)")

    bsz, s = conv_out.shape[0], conv_out.shape[1]
    xh = conv_out[..., :d_inner].reshape(bsz, s, h, phd)
    b = conv_out[..., d_inner:d_inner + n]
    c = conv_out[..., d_inner + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if mode == "decode":
        y, hf = ssd_decode(xh, dt, a, b, c, p["d_skip"], cache["state"])
    else:
        y, hf = ssd_chunked(xh, dt, a, b, c, p["d_skip"], h0=cache["state"])

    y = y.reshape(bsz, s, d_inner)
    y = apply_rmsnorm(p["out_ln"], y * F.silu(z), cfg.norm_eps)
    out = linear(y, p["w_out"])
    if live is not None and mode == "decode":
        new_conv = torch.where(live[:, None, None],
                               new_conv.to(cache["conv"].dtype),
                               cache["conv"])
        hf = torch.where(live[:, None, None, None], hf, cache["state"])
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(hf)
    return residual + out, cache
