"""Mixture-of-experts FFN (port of ``repro/models/moe.py``), single shard.

Each token picks its top-k experts from a softmax router; every expert
takes at most ``capacity`` tokens, in token order, and drops the rest
(GShard-style).  The routed rows are gathered into an (E, C, d) buffer,
run through the grouped expert FFN (K3, ``kernels.ops.moe_ffn``) and
combined back into token rows weighted by their router probability.  The
router product goes through K2 like every other projection.

Token exactness on the card rests on every step here being independent of
the other rows in the batch: K2 and K3 sum in a fixed order, the routing
is row-wise, the dispatch is an integer cumsum and scatters that write
each live buffer slot once (duplicates land only in the trash row C), and
the combine adds each token's expert outputs one after another in
ascending expert id, mirroring the reference's expert-major scatter-add.
No step syncs with the host.

The layer trains: K3's gradient is its backward kernel
(``kernels.ops.moe_ffn_bwd``), the router's goes through K2's, and the
softmax, top-k, renormalisation, combine and the Switch auxiliary loss
(through ``probs.mean(0)``, as in the reference) differentiate through
PyTorch's autograd.  The dispatch's gradient is written as a gather
(:class:`_Dispatch`): each token's kept slots in ascending expert id,
summed in fp32 one after another as the combine is, so that no scatter-add
decides the order of a token's sum.

The reference's expert-parallel ``shard_map`` path (experts sharded over a
``model`` mesh axis) comes with tensor-parallel serving (ROADMAP Queue 1
item 13); until then the port runs all experts in one shard.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Leaf

Params = Dict[str, Any]


def moe_shapes(cfg) -> Params:
    """One MoE layer's parameter shapes (the reference's ``moe_abstract``;
    the layer stack adds the leading axis)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": Leaf((d, e)), "w_gate": Leaf((e, d, f)),
            "w_up": Leaf((e, d, f)), "w_down": Leaf((e, f, d))}


def _capacity(cfg, tokens_local: int) -> int:
    c = int(cfg.capacity_factor * cfg.experts_per_token * tokens_local
            / cfg.n_experts)
    return max(4, c)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest router probabilities of each row and their expert ids,
    largest first, ties to the lower id as ``jax.lax.top_k`` breaks them:
    the first k of a stable descending sort (``torch.topk`` does not
    promise an order among ties).  Row-wise, so a row's choice does not
    depend on the batch."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_i[:, :k]


class _Dispatch(torch.autograd.Function):
    """buf = xf[src] * occ: the routed token rows in the (E, C, d) buffer.
    Its gradient is a gather: token t's dx is the sum of dbuf at its kept
    slots (``experts``, ``rows``, ``kept``: (T, k), its choices in
    ascending expert id), in fp32, one slot after another."""

    @staticmethod
    def forward(ctx, xf, src, occ, experts, rows, kept):
        ctx.save_for_backward(experts, rows, kept)
        return xf[src] * occ[..., None].to(xf.dtype)

    @staticmethod
    def backward(ctx, dbuf):
        experts, rows, kept = ctx.saved_tensors
        part = dbuf[experts, rows].float()                    # (T, k, d)
        part = torch.where(kept[..., None], part, torch.zeros_like(part))
        dx = part[:, 0]
        for j in range(1, part.shape[1]):
            dx = dx + part[:, j]
        return dx.to(dbuf.dtype), None, None, None, None, None


def _moe_local(cfg, x, router, w_gate, w_up, w_down, *,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-shard body.  x: (B, S, d) -> ((B, S, d), aux)."""
    b, s, d = x.shape
    t = b * s
    k, n_exp = cfg.experts_per_token, cfg.n_experts
    xf = x.reshape(t, d)

    logits = ops.matmul(xf, router).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                            # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(0)
    hits = torch.zeros((t, n_exp), dtype=torch.float32, device=x.device)
    hits.scatter_(1, top_i, 1.0)
    aux = n_exp * torch.sum(me * hits.mean(0))

    # dispatch: token t's place in expert e's buffer, in token order.  An
    # admission's padded prompt rows are routed too, but they come after
    # its real rows in token order, so a padded row can take only a slot
    # no real row claimed: which real rows are kept depends on the real
    # rows and C alone (qwen3-moe-30b-a3b: C 20 at prefill_len 256)
    hit = hits > 0                                            # (T, E)
    pos = torch.cumsum(hit.to(torch.int32), dim=0) - 1
    keep = hit & (pos < capacity)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity)).long()
    tok = torch.arange(t, device=x.device)[None, :].expand(n_exp, t)
    src = torch.zeros((n_exp, capacity + 1), dtype=torch.long,
                      device=x.device).scatter_(1, slot.t(), tok)
    occ = torch.zeros((n_exp, capacity + 1), dtype=torch.bool,
                      device=x.device).scatter_(1, slot.t(), keep.t())
    src, occ = src[:, :capacity], occ[:, :capacity]
    # each token's choices in ascending expert id: their slots and whether
    # they were kept (the combine's order, and the dispatch gradient's)
    experts, order = torch.sort(top_i, dim=-1)
    kept = torch.gather(keep, 1, experts)
    rows = torch.gather(slot, 1, experts).clamp(max=capacity - 1)
    buf = _Dispatch.apply(xf, src, occ, experts, rows, kept)  # (E, C, d)
    counts = occ.sum(1, dtype=torch.int32)   # kept rows fill slots 0..n-1
    y = ops.moe_ffn(buf, w_gate, w_up, w_down, counts)        # (E, C, d)

    # combine: each token's kept choices in ascending expert id, y * gate
    # in the activation dtype, summed one after another in fp32
    gate = torch.gather(top_p, 1, order).to(y.dtype)          # (T, k)
    part = (y[experts, rows] * gate[..., None]).float()       # (T, k, d)
    part = torch.where(kept[..., None], part, torch.zeros_like(part))
    out = part[:, 0]
    for j in range(1, k):
        out = out + part[:, j]
    return out.to(x.dtype).reshape(b, s, d), aux


def apply_moe(cfg, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (output (B, S, d), aux loss ()).  Capacity follows
    the reference: ``max(4, int(capacity_factor * k * B * S / E))``."""
    cap = _capacity(cfg, x.shape[0] * x.shape[1])
    return _moe_local(cfg, x, p["router"], p["w_gate"], p["w_up"],
                      p["w_down"], capacity=cap)
