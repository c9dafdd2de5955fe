"""Shared model layers: norms, RoPE, embeddings, the LM head, the MLP and
parameter initialisation (port of ``repro/models/layers.py``).

Every matrix product goes through K2 (``kernels.ops.matmul``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


class Leaf(NamedTuple):
    """One leaf of a parameter or cache shape tree: its shape, and its
    dtype where the leaf pins one (the SSM's fp32 decay parameters and
    state, the int32 positions); ``None`` is the model's ``cfg.dtype``."""
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype] = None


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (kept), added in an order that does not
    depend on how many rows the tensor has.

    PyTorch's CUDA reduction chooses its thread split from the number of
    outputs while there are fewer than 16, so a plain mean over one row of
    a batch-1 decode and the same row in a batch-4 decode add in different
    orders.  Where 16 divides the width, as in every served config, each
    row is averaged here as 16 pieces first: at least 16 outputs per
    reduction, whatever the batch, so one fixed split."""
    d = x.shape[-1]
    if d % 16 == 0:
        x = x.reshape(*x.shape[:-1], 16, d // 16).mean(-1)
    return x.mean(-1, keepdim=True)


def apply_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """RMSNorm in fp32, scaled by ``1 + scale``, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(mean_last(x * x) + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation (not interleaved), angles in fp32.
    x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.unsqueeze(-1).float() * freqs
    if x.dim() == angles.dim() + 1:        # has a heads axis
        angles = angles.unsqueeze(-2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings, LM head, MLP
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) through K2."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


def apply_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def apply_lm_head(table: torch.Tensor, x: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> logits (B, S, V).  With ``transpose`` the table is the
    tied (V, d) embedding, read in place by K2 as a (d, V) view."""
    return linear(x, table.t() if transpose else table)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (B,S,C) with w (W,C), plus bias b (C,);
    the taps are added one after another in x's dtype.  The Mamba-2 and
    RG-LRU blocks share it (the SSM adds a SiLU after it)."""
    wd, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, wd - 1, 0))
    out = xp[:, :s] * w[0]
    for i in range(1, wd):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def conv_step(window: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One decode step of :func:`causal_conv`: window (B,W,C) holds the
    last W inputs.  The taps are summed in fp32 one after another
    (elementwise, so a row's result does not depend on the batch), then
    rounded to the window's dtype and biased.  Returns (B,C)."""
    acc = window[:, 0].float() * w[0].float()
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i].float() * w[i].float()
    return acc.to(window.dtype) + b


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x @ w_gate) * (x @ w_up) @ w_down, all three through K2."""
    h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    return linear(h, p["w_down"])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 valid_vocab: int) -> torch.Tensor:
    """Per-position cross-entropy in fp32 (``repro/models/layers.py:
    softmax_xent``): vocab padding masked out of the partition function,
    the max held constant (no gradient through it), the label's logit
    gathered.  The reference selects it by a one-hot product, which gives
    the same value; at 4,096 tokens over a 153,600-row vocab the one-hot
    alone would be 2.5 GB of fp32.  logits (..., V), labels (...) int in
    [0, valid_vocab)."""
    vocab = logits.shape[-1]
    logits = logits.float()
    if valid_vocab < vocab:
        pad = torch.arange(vocab, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    label_logit = torch.gather(shifted, -1, labels.long()[..., None])[..., 0] \
        + m[..., 0]
    return lse - label_logit


# ---------------------------------------------------------------------------
# parameter initialisation
# ---------------------------------------------------------------------------

def init_params(shapes, generator: torch.Generator, dtype: torch.dtype,
                device) -> Any:
    """Nested dict of :class:`Leaf` -> tensors, with the distribution of
    the reference's ``materialize``: leaves of rank <= 1 are zeros; others
    are normal * fan_in ** -0.5 with fan_in = shape[-2] (so layer-stacked
    norm scales of shape (L, d) are drawn too).  Each leaf takes its pinned
    dtype, else ``dtype``.  Drawn in fp32 on ``device`` from ``generator``
    (a generator of that device) in sorted key order, one leading-axis
    slice at a time into the leaf, so a layer-stacked expert leaf never
    exists whole in fp32 nor on the host."""
    if isinstance(shapes, dict):
        return {k: init_params(shapes[k], generator, dtype, device)
                for k in sorted(shapes)}
    shape, leaf_dtype = shapes.shape, shapes.dtype or dtype
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=leaf_dtype, device=device)
    std = 1.0 / (shape[-2] ** 0.5)
    out = torch.empty(shape, dtype=leaf_dtype, device=device)
    for piece in (out if len(shape) >= 3 else (out,)):
        piece.copy_(torch.randn(piece.shape, generator=generator,
                                dtype=torch.float32, device=device) * std)
    return out


def zeros(shapes, dtype: torch.dtype, device) -> Any:
    """Nested dict of :class:`Leaf` -> zero tensors (pinned dtype, else
    ``dtype``)."""
    if isinstance(shapes, dict):
        return {k: zeros(v, dtype, device) for k, v in shapes.items()}
    return torch.zeros(shapes.shape, dtype=shapes.dtype or dtype,
                       device=device)
