"""Decoder-only language model: "G" (global attention), "L" (sliding-
window attention), "M" (Mamba-2 SSD) and "R" (RG-LRU) layers with an
optional SwiGLU MLP or a mixture of experts, and a tied or untied LM head
(port of ``repro/models/transformer.py``).

Parameter and cache trees keep the reference's nested-dict layout and key
paths: layers of the repeating unit are stacked along a leading axis under
``groups/slot{i}``, remainder layers sit under ``tail``, and the cache tree
carries each batch row's next decode position in ``pos``.  Shape trees
hold :class:`~repro_torch.models.layers.Leaf` values, so the SSM's fp32
leaves stay fp32 in a bf16 model.

A windowed ("L") layer whose cache has exactly ``local_window`` slots is a
ring: position p lives in slot p % window.  With fewer slots than the
window (a short ``max_len``) its cache is flat, addressed by absolute
position like a "G" layer's, and reads keep only the last ``window``
positions.

Unlike the reference, which is functional, cache writes here are made in
place: ``forward(mode="prefill")``, ``prefill_offset`` and ``decode_step``
fill the cache tensors they are given, ``pos`` included, and return the
same tree.  Callers that need the old cache keep a copy.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.paging import cache_leaves, leaf_axis, leaf_kind
from repro_torch.models import attention as attn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Leaf, apply_embedding, apply_lm_head,
                                       apply_mlp, apply_rmsnorm, apply_rope,
                                       linear, torch_dtype)

Params = Dict[str, Any]

ATTN_KINDS = ("G", "L")
LAYER_KINDS = ATTN_KINDS + ("M", "R")


def check_cache_heads(cfg):
    """Raise for a decode cache whose heads are folded (this model's and
    the encoder-decoder's)."""
    if cfg.decode_cache_heads not in (0, cfg.n_kv_heads):
        raise NotImplementedError(
            "decode_cache_heads folding belongs to tensor-parallel serving "
            "(ROADMAP Queue 1 item 13)")


def check_supported(cfg):
    """Raise for what this decoder-only model does not carry, naming where
    it is (another module, or the ROADMAP item that brings it)."""
    if cfg.is_encdec or cfg.frontend not in ("none", "vision"):
        what = ("an encoder-decoder model" if cfg.is_encdec
                else f"the {cfg.frontend!r} frontend")
        raise NotImplementedError(
            f"{cfg.name}: {what} is not a decoder-only path; it runs "
            f"through repro_torch.models.encdec")
    check_cache_heads(cfg)
    unit, _, tail = split_layers(cfg)
    for kind in unit + tail:
        if kind not in LAYER_KINDS:
            raise NotImplementedError(
                f"layer kind {kind!r} is not one the port carries "
                f"({', '.join(LAYER_KINDS)}; the reference has no other)")


def default_unit(cfg) -> Tuple[str, ...]:
    """The repeating layer unit: the config's pattern, else ("M",) for the
    SSM family and ("G",) for the rest."""
    if cfg.layer_pattern:
        return cfg.layer_pattern
    return ("M",) if cfg.family == "ssm" else ("G",)


def split_layers(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(repeating unit, number of stacked groups, remainder tail kinds)."""
    unit = default_unit(cfg)
    n_groups = cfg.n_layers // len(unit)
    tail = tuple(unit[i % len(unit)]
                 for i in range(n_groups * len(unit), cfg.n_layers))
    return unit, n_groups, tail


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return Leaf((n,) + tree.shape, tree.dtype)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------

def _attn_shapes(cfg) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"ln": Leaf((d,)), "wq": Leaf((d, cfg.n_heads * hd)),
         "wk": Leaf((d, cfg.n_kv_heads * hd)),
         "wv": Leaf((d, cfg.n_kv_heads * hd)),
         "wo": Leaf((cfg.n_heads * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = Leaf((hd,))
        p["k_norm"] = Leaf((hd,))
    return p


_MIX_SHAPES = {"M": ssm_mod.ssm_shapes, "R": hybrid_mod.rglru_shapes}


def layer_shapes(cfg, kind: str) -> Params:
    p = {"mix": _MIX_SHAPES.get(kind, _attn_shapes)(cfg)}
    if cfg.d_ff > 0:
        d = cfg.d_model
        p["ffn_ln"] = Leaf((d,))
        if cfg.family == "moe":
            p["moe"] = moe_mod.moe_shapes(cfg)
        else:
            p["mlp"] = {"w_gate": Leaf((d, cfg.d_ff)),
                        "w_up": Leaf((d, cfg.d_ff)),
                        "w_down": Leaf((cfg.d_ff, d))}
    return p


def abstract_params(cfg) -> Params:
    """The parameter tree as :class:`Leaf` shapes (the reference's
    LogicalArray tree)."""
    check_supported(cfg)
    unit, n_groups, tail = split_layers(cfg)
    group = {f"slot{i}": layer_shapes(cfg, k) for i, k in enumerate(unit)}
    params = {
        "embed": Leaf((cfg.padded_vocab, cfg.d_model)),
        "groups": _stack(group, n_groups),
        "tail": {f"tail{i}": layer_shapes(cfg, k)
                 for i, k in enumerate(tail)},
        "final_norm": Leaf((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Leaf((cfg.d_model, cfg.padded_vocab))
    return params


def _layer_cache_shape(cfg, kind: str, batch: int, cache_len: int,
                       ring: bool = True):
    if kind == "M":
        return ssm_mod.ssm_cache_shapes(cfg, batch)
    if kind == "R":
        return hybrid_mod.rglru_cache_shapes(cfg, batch)
    c = cache_len
    if kind == "L" and cfg.local_window and ring:
        c = min(cfg.local_window, cache_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": Leaf(shape), "v": Leaf(shape)}


def abstract_cache(cfg, batch: int, cache_len: int, *,
                   ring: bool = True) -> Params:
    """Decode-state tree as :class:`Leaf` shapes: per-layer KV buffers of
    ``cache_len`` slots (``min(local_window, cache_len)`` for windowed
    layers with ``ring``, the reference's ``ring=True`` layout; without it
    every attention layer is full length), SSM conv and state buffers or
    RG-LRU conv and state buffers, plus the per-slot int32 ``pos`` vector
    (B,)."""
    check_supported(cfg)
    unit, n_groups, tail = split_layers(cfg)
    group = {f"slot{i}": _layer_cache_shape(cfg, k, batch, cache_len, ring)
             for i, k in enumerate(unit)}
    return {
        "pos": Leaf((batch,), torch.int32),
        "groups": _stack(group, n_groups),
        "tail": {f"tail{i}": _layer_cache_shape(cfg, k, batch, cache_len,
                                                ring)
                 for i, k in enumerate(tail)},
    }


def abstract_paged_cache(cfg, batch: int, cache_len: int, *, kv_block: int,
                         arena_blocks: int) -> Params:
    """Paged decode-state tree (repro_torch.core.paging).

    Attention layers trade the per-slot (B, C, ...) buffer for a shared
    physical-block **arena** addressed through a per-slot ``block_table``
    (B, cache_len/kv_block) carried next to ``pos`` (-1 = unmapped).  The
    arena holds ``arena_blocks + 1`` blocks of (kv_block, heads,
    head_dim): the pager owns the first ``arena_blocks``, the last is the
    sink that dropped writes land in (``attention.write_paged_kv``).
    Recurrent layers (SSM / RG-LRU) keep their O(1)-size per-slot state
    dense.  Windowed ("L") layers store the full logical length (no ring):
    window masking happens at attention time, so the arena layout is
    uniform across layer kinds.
    """
    assert cache_len % kv_block == 0, (cache_len, kv_block)
    check_supported(cfg)
    unit, n_groups, tail = split_layers(cfg)

    def layer_c(kind):
        if kind in ATTN_KINDS:
            shape = (arena_blocks + 1, kv_block, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            return {"k": Leaf(shape), "v": Leaf(shape)}
        return _layer_cache_shape(cfg, kind, batch, cache_len)

    return {
        "pos": Leaf((batch,), torch.int32),
        "block_table": Leaf((batch, cache_len // kv_block), torch.int32),
        "groups": _stack({f"slot{i}": layer_c(k)
                          for i, k in enumerate(unit)}, n_groups),
        "tail": {f"tail{i}": layer_c(k) for i, k in enumerate(tail)},
    }


def paged_block_bytes(cfg, kv_block: int) -> int:
    """Bytes one KV block occupies across every attention layer (k + v) —
    the page-size unit of the arena's byte-capacity accounting."""
    n_attn = sum(1 for k in cfg.pattern_for_layers() if k in ATTN_KINDS)
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return 2 * n_attn * kv_block * cfg.n_kv_heads * \
        cfg.resolved_head_dim * itemsize


def init_params(cfg, seed: int = 0, *, device="cpu") -> Params:
    """Random weights with the reference's distribution, in ``cfg.dtype``,
    drawn on ``device`` by its own generator: one seed gives the same
    weights on one kind of device, but the card's draw differs from the
    CPU's.  To hold the two against each other, draw once and move."""
    device = torch.device(device)
    return layers.init_params(abstract_params(cfg),
                              torch.Generator(device).manual_seed(seed),
                              torch_dtype(cfg.dtype), device)


def init_cache(cfg, batch: int, cache_len: int, *, ring: bool = True,
               device="cpu") -> Params:
    return layers.zeros(abstract_cache(cfg, batch, cache_len, ring=ring),
                        torch_dtype(cfg.dtype), device)


def init_paged_cache(cfg, batch: int, cache_len: int, *, kv_block: int,
                     arena_blocks: int, device="cpu") -> Params:
    """Zeros, with every block-table entry -1 (unmapped)."""
    tree = layers.zeros(
        abstract_paged_cache(cfg, batch, cache_len, kv_block=kv_block,
                             arena_blocks=arena_blocks),
        torch_dtype(cfg.dtype), device)
    tree["block_table"].fill_(-1)
    return tree


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------

def _write_prefill_cache(cache_kv: torch.Tensor, full: torch.Tensor,
                         window: int, lengths: torch.Tensor) -> torch.Tensor:
    """Write prefill keys/values (B,S,..) into a cache buffer (B,C,..), in
    place, and return the buffer.

    ``lengths`` (B,) is each row's valid (un-padded) length.  A ring
    (C == window <= S) keeps the reference's invariant: slot j holds the
    latest valid position p with p % window == j, gathered per row, since
    right-padded rows end at different positions (``transformer.py:
    114-141``); a row shorter than j + 1 positions reads position 0 there,
    which decode masks.  Otherwise the first C positions are copied.  Slots
    beyond a row's length hold whatever the padded positions produced;
    decode masks them by its per-slot valid length."""
    b, s = full.shape[0], full.shape[1]
    c = cache_kv.shape[1]
    if window and c == window and s >= window:
        lens = lengths.to(device=full.device, dtype=torch.long).reshape(b, 1)
        j = torch.arange(window, device=full.device)[None, :]
        p = torch.clamp(lens - 1 - torch.remainder(lens - 1 - j, window),
                        0, s - 1)                                  # (B, W)
        rows = torch.arange(b, device=full.device)[:, None]
        cache_kv.copy_(full[rows, p])
        return cache_kv
    n = min(s, c)
    cache_kv[:, :n].copy_(full[:, :n])
    return cache_kv


def _write_decode_cache(cache_kv: torch.Tensor, new: torch.Tensor,
                        pos_b: torch.Tensor, *, ring: bool = False,
                        live=None):
    """Write row b's new key/value (B, Hkv, D) at slot ``pos_b[b] % C``, in
    place.  A ring wraps.  A flat buffer drops a position >= C (an idle
    slot left ticking, or a speculative write past the buffer) instead of
    wrapping onto slot 0, as the reference's non-ring rule does
    (``transformer.py:216-234``).  A row with ``live`` (B,) False drops
    too, ring or flat: a frozen row's write would land inside its
    still-valid window.  A dropped row rewrites its slot (0 where the
    position is out of range) with its own current bytes, so no host sync
    is needed to find the dropped rows."""
    b, c = cache_kv.shape[0], cache_kv.shape[1]
    rows = torch.arange(b, device=cache_kv.device)
    in_range = torch.ones_like(pos_b, dtype=torch.bool) if ring \
        else pos_b < c
    hit = in_range if live is None else in_range & live
    slot = torch.where(in_range, pos_b % c, torch.zeros_like(pos_b)).long()
    old = cache_kv[rows, slot]
    cache_kv[rows, slot] = torch.where(hit[:, None, None],
                                       new.to(cache_kv.dtype), old)


def _apply_attn(cfg, p: Params, x: torch.Tensor, *, mode: str, cache,
                pos: torch.Tensor, kind: str, paged=None, live=None):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.local_window if kind == "L" else 0
    theta = cfg.rope_theta
    if kind == "L" and cfg.rope_theta_local is not None:
        theta = cfg.rope_theta_local
    residual = x
    xn = apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    q = linear(xn, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = linear(xn, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(xn, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if mode == "decode":
        pos_b = pos.to(torch.int32).expand(b) if pos.dim() == 0 else pos
        q = apply_rope(q, pos_b[:, None], theta)
        k = apply_rope(k, pos_b[:, None], theta)
        if paged is not None:
            # paged KV: the cache leaf is a (P + 1, bs, Hkv, hd) block arena
            # shared by every slot; the row's write and the logical gather
            # both resolve through the step's block-table index
            # (repro_torch.core.paging), which sends a frozen row's write
            # to the sink
            attn_mod.write_paged(cache["k"], paged, k[:, 0])
            attn_mod.write_paged(cache["v"], paged, v[:, 0])
            out = attn_mod.decode_attention(
                q, attn_mod.gather_paged(cache["k"], paged.blocks),
                attn_mod.gather_paged(cache["v"], paged.blocks),
                pos_b + 1, window=window, ring=False)
        else:
            ring = bool(window) and cache["k"].shape[1] == window
            _write_decode_cache(cache["k"], k[:, 0], pos_b, ring=ring,
                                live=live)
            _write_decode_cache(cache["v"], v[:, 0], pos_b, ring=ring,
                                live=live)
            out = attn_mod.decode_attention(q, cache["k"], cache["v"],
                                            pos_b + 1, window=window,
                                            ring=ring)
    elif mode == "suffix":
        # a warm admission's suffix: ``pos`` (1, S) holds its absolute
        # positions; K/V go to the slot's blocks (shared, unmapped and
        # past-the-table positions to the sink), and K1 runs over the
        # slot's whole gathered row with the queries from pos[0, 0]
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
        attn_mod.write_paged(cache["k"], paged, k)
        attn_mod.write_paged(cache["v"], paged, v)
        out = attn_mod.prefill_attention(
            q, attn_mod.gather_paged(cache["k"], paged.blocks),
            attn_mod.gather_paged(cache["v"], paged.blocks),
            causal=True, window=window, q_start=pos[:, 0])
    elif mode in ("prefill", "train"):
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        if mode == "prefill":
            # padded positions never reach a valid query under the causal
            # mask; in prefill mode ``pos`` carries the per-row valid
            # lengths.  Training writes no cache.
            _write_prefill_cache(cache["k"], k, window, pos)
            _write_prefill_cache(cache["v"], v, window, pos)
        out = attn_mod.prefill_attention(q, k, v, causal=True, window=window)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = linear(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return residual + out, cache


# ---------------------------------------------------------------------------
# full layer and stack
# ---------------------------------------------------------------------------

def apply_layer(cfg, kind: str, p: Params, x, *, mode: str, cache, pos,
                paged=None, live=None):
    """One layer: (x, new cache, aux), aux the MoE layer's auxiliary loss
    (None for the other layers).  In decode mode ``live`` (B,) bool
    (``None``: every row) freezes the other rows' cache: no KV write, no
    recurrent update."""
    if mode == "suffix" and kind not in ATTN_KINDS:
        raise ValueError(f"a suffix at an offset needs attention-only "
                         f"layers: a {kind!r} layer's state would have to "
                         f"replay the whole prompt")
    if kind == "M":
        x, new_cache = ssm_mod.apply_ssm_layer(cfg, p["mix"], x, mode=mode,
                                               cache=cache, live=live)
    elif kind == "R":
        x, new_cache = hybrid_mod.apply_rglru_layer(cfg, p["mix"], x,
                                                    mode=mode, cache=cache,
                                                    live=live)
    elif kind in ATTN_KINDS:
        x, new_cache = _apply_attn(cfg, p["mix"], x, mode=mode, cache=cache,
                                   pos=pos, kind=kind, paged=paged,
                                   live=live)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not one the port "
                                  f"carries ({', '.join(LAYER_KINDS)})")
    aux = None
    if cfg.d_ff > 0:
        xn = apply_rmsnorm(p["ffn_ln"], x, cfg.norm_eps)
        if cfg.family == "moe":
            out, aux = moe_mod.apply_moe(cfg, p["moe"], xn)
        else:
            out = apply_mlp(p["mlp"], xn)
        x = x + out
    return x, new_cache, aux


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _run_stack(cfg, params, x, *, mode: str, caches, pos, paged=None,
               live=None):
    """The reference scans the layer-stacked groups; here a Python loop
    walks the same stacked tensors layer by layer (views, no copies)."""
    unit, n_groups, tail = split_layers(cfg)
    for layer in range(n_groups):
        gp = _index(params["groups"], layer)
        gc = _index(caches["groups"], layer)
        for i, kind in enumerate(unit):
            slot = f"slot{i}"
            x, _, _ = apply_layer(cfg, kind, gp[slot], x, mode=mode,
                                  cache=gc[slot], pos=pos, paged=paged,
                                  live=live)
    for i, kind in enumerate(tail):
        name = f"tail{i}"
        x, _, _ = apply_layer(cfg, kind, params["tail"][name], x,
                              mode=mode, cache=caches["tail"][name], pos=pos,
                              paged=paged, live=live)
    return x, caches


# K2's product, whose outputs the "dots" policy keeps
_DOTS = ("repro_torch::matmul",)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if getattr(op, "name", lambda: "")().split(".")[0] in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg, fn):
    """A layer group of the training forward under the config's
    ``remat_policy`` (the reference's ``jax.checkpoint`` of the scanned
    group): "full" keeps every activation (no recompute); "nothing" keeps
    the group's input alone and recomputes the group in the backward;
    "dots" keeps K2's outputs and recomputes the rest (the reference's
    ``dots_with_no_batch_dims_saveable``: its attention products have
    batch dimensions and are recomputed, as K1 is here).  Non-reentrant
    and without the RNG state, so that a CUDA graph capture takes it."""
    policy = cfg.remat_policy
    if policy == "full":
        return fn
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {policy!r}: nothing, dots or full")
    from torch.utils import checkpoint as ckpt
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def remat(*args):
        return ckpt.checkpoint(fn, *args, **kw)

    return remat


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _run_stack_train(cfg, params, x):
    """The training forward's layers: each stacked group under
    :func:`_maybe_remat`, then the tail, no cache.  Returns (x, aux), aux
    the sum of the MoE layers' auxiliary losses in layer order, as the
    reference's scan carries it (a 0-dim fp32 zero without MoE layers)."""
    unit, n_groups, tail = split_layers(cfg)

    def group(x, gp):
        aux = None
        for i, kind in enumerate(unit):
            x, _, a = apply_layer(cfg, kind, gp[f"slot{i}"], x, mode="train",
                                  cache=None, pos=None)
            aux = _add_aux(aux, a)
        return x, aux

    body = _maybe_remat(cfg, group)
    aux = None
    for layer in range(n_groups):
        x, a = body(x, _index(params["groups"], layer))
        aux = _add_aux(aux, a)
    for i, kind in enumerate(tail):
        x, _, a = apply_layer(cfg, kind, params["tail"][f"tail{i}"], x,
                              mode="train", cache=None, pos=None)
        aux = _add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``, as a Python float: multiplying
    by it gives the bits of multiplying by the rounded scale as a tensor,
    without copying a scalar to the device on every call (a copy a CUDA
    graph capture refuses)."""
    return torch.tensor(d_model ** 0.5, dtype=dtype).item()


def embed_inputs(cfg, params, tokens, prefix_embeds=None):
    """Token embeddings, after ``prefix_embeds`` (B, P, d) where given (a
    frontend's precomputed patch embeddings, cast to the model dtype),
    times sqrt(d_model) for gemma configs: the prefix is concatenated
    before the scale, so it is scaled too, in the reference's order
    (``repro/models/transformer.py:embed_inputs``).  The scale is rounded
    to the model dtype first, as the reference does (50.5 in bf16 at
    d_model 2560, not 50.596)."""
    x = apply_embedding(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.scale_embeddings:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


def logits_from_hidden(cfg, params, x):
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return apply_lm_head(params["embed"], x, transpose=True)
    return apply_lm_head(params["lm_head"], x)


def forward(cfg, params, tokens, *, prefix_embeds=None,
            mode: str = "prefill", caches=None, lengths=None):
    """tokens: (B, S_tok); prefix_embeds: (B, P, d) frontend embeddings
    placed before the tokens, so the model runs S = P + S_tok positions.
    Prefill mode fills ``caches`` in place and sets its ``pos`` to
    ``lengths`` (B,), each right-padded row's valid length counting the
    prefix (default: S), i.e. each row's next decode position.  The
    programs pass ``lengths`` as a tensor on the tokens' device: anything
    else is copied there, which a CUDA graph capture refuses.

    Returns (logits (B, S, V_padded), caches).

    ``mode="train"`` is the training forward (``caches`` None): every
    position at once through K1 (causal, the layer's window), no cache,
    each layer group under the config's ``remat_policy``.  It returns the
    reference's triple (logits, None, aux), aux the MoE layers' summed
    auxiliary loss, a 0-dim fp32 zero for the other families.  "R" layers
    run their scan from zero through K5, whose gradient is K5's backward
    kernel; under ``remat_policy`` "nothing" a group's K5 and K1 run again
    in the backward.  SSM training raises (ROADMAP item 14b.3)."""
    check_supported(cfg)
    if mode == "train":
        if caches is not None or lengths is not None:
            raise ValueError("the training forward takes no cache and no "
                             "lengths")
        x = embed_inputs(cfg, params, tokens, prefix_embeds)
        x, aux = _run_stack_train(cfg, params, x)
        return logits_from_hidden(cfg, params, x), None, aux
    if mode != "prefill" or caches is None:
        raise ValueError(
            f"forward runs in prefill mode with a cache, or in train mode "
            f"without one; got mode {mode!r}")
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    b, s = x.shape[0], x.shape[1]
    if lengths is None:
        pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    else:
        pos = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device).expand(b).clone()
    x, caches = _run_stack(cfg, params, x, mode=mode, caches=caches, pos=pos)
    logits = logits_from_hidden(cfg, params, x)
    caches["pos"].copy_(pos)
    return logits, caches


def prefill_offset(cfg, params, caches, tokens, slot, offset, length):
    """A warm prefix admission's suffix over one slot of a paged tree.

    tokens: (1, S) int, the prompt's tokens from ``offset`` on, right-
    padded; slot, offset, length: (1,) int32 on the tokens' device.  The slot's first ``offset`` positions are already in
    its blocks (read-only shared ones): only the suffix runs, at positions
    ``offset + j``.  Each attention layer writes the suffix's K/V into the
    slot's blocks through its block-table row and runs K1 over the slot's
    whole gathered row with the queries starting at ``offset``, so each
    valid row attends exactly as in a cold prefill of the whole prompt
    (the kernel's header says why the bits are the same).  Every other
    op is row-wise and its bits do not depend on the number of rows.
    ``pos[slot]`` ends at ``length``; no other row is touched.  Attention-
    only configs alone (a recurrent layer raises).

    Returns (logits (1, S, V_padded), caches)."""
    check_supported(cfg)
    s = tokens.shape[1]
    positions = offset.reshape(1, 1) + torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None]
    row = caches["block_table"].index_select(0, slot.long())   # (1, M)
    arena = next(layer["k"] for top in ("groups", "tail")
                 for layer in caches[top].values() if "k" in layer)
    # arenas are (..., P + 1, bs, Hkv, hd), the last block the sink
    paged = attn_mod.paged_index(row, positions, arena.shape[-3],
                                 arena.shape[-4] - 1)
    x = embed_inputs(cfg, params, tokens)
    x, caches = _run_stack(cfg, params, x, mode="suffix", caches=caches,
                           pos=positions, paged=paged)
    logits = logits_from_hidden(cfg, params, x)
    caches["pos"].index_copy_(0, slot.long(), length)
    return logits, caches


def greedy_token(cfg, logits: torch.Tensor) -> torch.Tensor:
    """THE greedy argmax: vocab padding masked, first maximum on ties.
    (..., V_padded) -> (...) int32."""
    valid = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    masked = torch.where(valid, logits,
                         torch.full_like(logits, float("-inf")))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def decode_step(cfg, params, caches, token, pos=None, *, live=None):
    """token: (B, 1) int; pos: () or (B,) absolute positions, defaulting to
    the per-slot ``pos`` carried in the cache tree.  Writes each row's KV at
    its own slot in place and returns (logits (B, 1, V_padded), caches) with
    ``pos`` advanced by one, written into the tree's own ``pos`` tensor (a
    replayed CUDA graph reads the buffer it captured).

    ``live`` (B,) bool freezes rows: a non-live row's KV write, recurrent
    update and ``pos`` advance are all masked out (``torch.where``, which
    changes no bits of the live rows), so its cache is byte-identical
    before and after the step while the live rows step normally: the fused
    horizon's per-slot termination.  ``None`` means every row is live.

    A paged tree (one with a ``block_table``) writes and reads its
    attention layers through the table, and only mapped rows advance: an
    unmapped (released) row's ``pos`` stays frozen so its block index can
    never creep out of range.  A row whose head block is a read-only
    shared mapping (``-(p + 2)``) is mapped; only -1 means unmapped.  The
    table's index (:class:`~repro_torch.models.attention.PagedIndex`) is
    computed once a step: every attention layer reads and writes the same
    blocks of its own arena."""
    check_supported(cfg)
    block_table = caches.get("block_table")
    b = token.shape[0]
    if pos is None:
        pos = caches["pos"]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    pos = pos.expand(b) if pos.dim() == 0 else pos
    x = embed_inputs(cfg, params, token)
    arena = next((layer["k"] for top in ("groups", "tail")
                  for layer in caches[top].values() if "k" in layer), None)
    paged = None
    if block_table is not None and arena is not None:
        # arenas are (..., P + 1, bs, Hkv, hd), the last block the sink
        paged = attn_mod.paged_index(block_table, pos, arena.shape[-3],
                                     arena.shape[-4] - 1, live=live)
    x, caches = _run_stack(cfg, params, x, mode="decode", caches=caches,
                           pos=pos, paged=paged, live=live)
    logits = logits_from_hidden(cfg, params, x)
    advance = live
    if block_table is not None:
        mapped = block_table[:, 0] != -1
        advance = mapped if live is None else mapped & live
    caches["pos"].copy_(pos + 1 if advance is None
                        else torch.where(advance, pos + 1, pos))
    return logits, caches


def decode_horizon(cfg, params, caches, tokens, budget, *, horizon: int,
                   eos_id=None):
    """Fused multi-step decode: ``horizon`` greedy steps in one program.

    tokens: (B, 1) int32, each slot's last accepted token (the greedy
    feedback starts from it); budget: (B,) int32, the tokens row b may
    emit this horizon (0 holds the row frozen throughout, e.g. an empty
    slot).  A row freezes the step after it emits ``eos_id`` or exhausts
    its budget (:func:`decode_step` with ``live``), so a finish inside the
    horizon perturbs no other row.  Every step is the same
    :func:`decode_step` and :func:`greedy_token` the sequential engine
    runs, so each live row's tokens and cache bytes are those of stepping
    one token at a time.

    Returns ``(caches, events)``, the caches written in place and the
    events in tensors the program owns:

      * ``tokens`` (B, H) int32: the token emitted at each step (a frozen
        row repeats its last one; read the first ``n_emitted``);
      * ``n_emitted`` (B,) int32: the valid tokens of row b;
      * ``occupancy`` (H,) f32: the share of rows live at each step;
      * ``buffer``: the three above as views of this one int32 tensor
        (tokens, n_emitted, then occupancy's bits), which the host reads
        back in one transfer.
    """
    b = tokens.shape[0]
    buffer = torch.empty(b * horizon + b + horizon, dtype=torch.int32,
                         device=tokens.device)
    ys = buffer[:b * horizon].view(b, horizon)
    n_emitted = buffer[b * horizon:b * horizon + b]
    occupancy = buffer[b * horizon + b:].view(torch.float32)
    tok = tokens[:, 0]
    emitted = torch.zeros_like(budget)
    live = budget > 0
    for i in range(horizon):
        logits, caches = decode_step(cfg, params, caches, tok[:, None],
                                     live=live)
        y = torch.where(live, greedy_token(cfg, logits[:, 0]), tok)
        emitted = emitted + live.to(emitted.dtype)
        occupancy[i] = live.float().mean()
        ys[:, i] = y
        next_live = live & (emitted < budget)
        if eos_id is not None:
            next_live &= y != eos_id
        tok, live = y, next_live
    n_emitted.copy_(emitted)
    return caches, {"tokens": ys, "n_emitted": n_emitted,
                    "occupancy": occupancy, "buffer": buffer}


def verify_decode(cfg, params, caches, tokens):
    """Speculative verify: score S = k+1 tokens in one program, accept the
    longest greedy-matching draft prefix, roll the rejected state back.

    tokens: (B, S) int32, per row the last accepted token then k drafts.
    Returns ``(caches, ys (B, S) int32, n_new (B,) int32)``: row b's
    accepted continuation is ``ys[b, :n_new[b]]``, and its cache (written
    in place) holds exactly the state of having decoded those tokens one
    at a time, ``pos`` advanced by ``n_new``.  Every candidate goes through
    the same :func:`decode_step` the sequential engine runs, so its logits
    are the sequential ones bit for bit.

    The caches are written in place, so what rollback restores is copied
    first: the attention KV leaves whole before the first step, and each
    recurrent state leaf after every step (clones, never views of the live
    state).  Rollback by leaf kind (``core.paging.leaf_kind``):
      * dense KV (flat buffers; the speculative engine builds no ring):
        slots >= ``pos0 + n_new`` get their pre-verify bytes back;
      * paged KV: the rejected writes are restored through the block
        table (:func:`~repro_torch.models.attention.rollback_paged_kv`);
      * recurrent state: per row, the snapshot after step ``n_new - 1``.
    """
    b, s = tokens.shape
    pos0 = caches["pos"].clone()
    block_table = caches.get("block_table")
    kv = [(path, leaf) for path, leaf in cache_leaves(caches)
          if leaf_kind(path) == "kv"]
    state = [(path, leaf) for path, leaf in cache_leaves(caches)
             if leaf_kind(path) == "state"]
    orig = [leaf.clone() for _, leaf in kv]
    snaps = [torch.empty((s,) + leaf.shape, dtype=leaf.dtype,
                         device=leaf.device) for _, leaf in state]
    ys = torch.empty((b, s), dtype=torch.int32, device=tokens.device)
    for i in range(s):
        logits, caches = decode_step(cfg, params, caches, tokens[:, i:i + 1])
        ys[:, i] = greedy_token(cfg, logits[:, 0])
        for snap, (_, leaf) in zip(snaps, state):
            snap[i].copy_(leaf)
    # draft i+1 is accepted iff it equals the model's token at input i;
    # +1 for the model's own token, always kept
    match = (tokens[:, 1:] == ys[:, :-1]).to(torch.int32)
    n_new = (1 + torch.cumprod(match, dim=1).sum(dim=1)).to(torch.int32)
    pos_new = pos0 + n_new
    for snap, (path, leaf) in zip(snaps, state):
        # batch sits at leaf_axis + 1 of the (S, ...) stack
        shape = [1] * snap.dim()
        shape[leaf_axis(path) + 1] = b
        idx = (n_new - 1).long().reshape(shape).expand(
            (1,) + snap.shape[1:])
        leaf.copy_(torch.gather(snap, 0, idx)[0])
    if block_table is not None:
        steps_ = torch.arange(s, device=tokens.device)
        pos_cand = pos0[:, None] + steps_[None, :]
        reject = steps_[None, :] >= n_new[:, None]
        for (_, leaf), old in zip(kv, orig):
            attn_mod.rollback_paged_kv(leaf, old, block_table, pos_cand,
                                       reject)
        # only mapped slots advance, as in sequential paged decode
        caches["pos"].copy_(torch.where(block_table[:, 0] != -1, pos_new,
                                        pos0))
    else:
        for (path, leaf), old in zip(kv, orig):
            ba = leaf_axis(path)
            c = leaf.shape[ba + 1]
            keep = torch.arange(c, device=leaf.device)[None, :] \
                < pos_new[:, None]
            shape = [1] * leaf.dim()
            shape[ba], shape[ba + 1] = b, c
            leaf.copy_(torch.where(keep.reshape(shape), leaf, old))
        caches["pos"].copy_(pos_new)
    return caches, ys, n_new
