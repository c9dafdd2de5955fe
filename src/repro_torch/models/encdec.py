"""Encoder-decoder backbone (SeamlessM4T-medium: speech encoder + text
decoder), port of ``repro/models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d).  The encoder is bidirectional;
the decoder is a causal transformer with cross-attention over the encoder's
memory.  At prefill the cross K/V of every decoder layer are computed once
from the memory and cached, so decode steps never touch the encoder.

The trees keep the reference's key paths: parameters ``embed``, ``enc``
and ``dec`` (layers stacked along a leading axis), ``enc_norm``,
``final_norm`` and ``lm_head`` (untied); the cache ``self/{k,v}`` of shape
(L, B, S_dec, Hkv, hd) and ``cross_k``, ``cross_v`` of shape (L, B, S_enc,
Hkv, hd).  The cache has no ``pos``: a decode step takes its position as
an argument (``repro/steps.py:serve_step_encdec``).

As in the rest of the port, caches are written in place: ``forward`` and
``decode_step`` fill the cache tensors they are given and return the same
tree.  Every product goes through K2 and every prefill attention (the
encoder's bidirectional one, the decoder's causal self-attention and its
cross-attention, Sq = S_dec over Sk = S_enc) through K1; decode attention
is plain PyTorch, as in the decoder-only model.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import (Leaf, apply_mlp, apply_rmsnorm,
                                       apply_rope, linear, torch_dtype)
from repro_torch.models.transformer import (_apply_attn, _embed_scale,
                                            _index, _stack, check_cache_heads,
                                            embed_inputs, layer_shapes,
                                            logits_from_hidden)

Params = Dict[str, Any]


def check_supported(cfg):
    """Raise for a config this module does not carry."""
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} is decoder-only: it runs through "
                         f"repro_torch.models.transformer")
    check_cache_heads(cfg)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------

def _xattn_shapes(cfg) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"ln": Leaf((d,)), "wq": Leaf((d, cfg.n_heads * hd)),
            "wk": Leaf((d, cfg.n_kv_heads * hd)),
            "wv": Leaf((d, cfg.n_kv_heads * hd)),
            "wo": Leaf((cfg.n_heads * hd, d))}


def _enc_layer_shapes(cfg) -> Params:
    """A decoder-only "G" layer's leaves, its attention under ``attn``."""
    p = layer_shapes(cfg, "G")
    return {"attn": p.pop("mix"), **p}


def _dec_layer_shapes(cfg) -> Params:
    """The same with the attention under ``self``, plus ``cross``."""
    p = layer_shapes(cfg, "G")
    return {"self": p.pop("mix"), "cross": _xattn_shapes(cfg), **p}


def abstract_params(cfg) -> Params:
    """The parameter tree as :class:`Leaf` shapes (the reference's
    LogicalArray tree)."""
    check_supported(cfg)
    return {
        "embed": Leaf((cfg.padded_vocab, cfg.d_model)),
        "enc": _stack(_enc_layer_shapes(cfg), cfg.n_enc_layers),
        "dec": _stack(_dec_layer_shapes(cfg), cfg.n_layers),
        "enc_norm": Leaf((cfg.d_model,)),
        "final_norm": Leaf((cfg.d_model,)),
        "lm_head": Leaf((cfg.d_model, cfg.padded_vocab)),
    }


def abstract_cache(cfg, batch: int, dec_len: int, enc_len: int) -> Params:
    """Decode-state tree as :class:`Leaf` shapes: each decoder layer's
    self-attention K/V over ``dec_len`` slots and its cross K/V over the
    ``enc_len`` encoder positions, stacked by layer."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    self_kv = Leaf((batch, dec_len, cfg.n_kv_heads, hd))
    cross = Leaf((cfg.n_layers, batch, enc_len, cfg.n_kv_heads, hd))
    return {"self": _stack({"k": self_kv, "v": self_kv}, cfg.n_layers),
            "cross_k": cross, "cross_v": cross}


def init_params(cfg, seed: int = 0, *, device=None) -> Params:
    """Random weights with the reference's distribution, in ``cfg.dtype``,
    drawn on ``device`` (``None``: the card) by its own generator, as
    :func:`repro_torch.models.transformer.init_params` draws them."""
    device = torch.device(device or "cuda")
    return layers.init_params(abstract_params(cfg),
                              torch.Generator(device).manual_seed(seed),
                              torch_dtype(cfg.dtype), device)


def init_cache(cfg, batch: int, dec_len: int, enc_len: int, *,
               device=None) -> Params:
    """Zeros on ``device`` (``None``: the card)."""
    return layers.zeros(abstract_cache(cfg, batch, dec_len, enc_len),
                        torch_dtype(cfg.dtype),
                        torch.device(device or "cuda"))


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def _cross_kv(cfg, p: Params, memory: torch.Tensor):
    """The cross K/V of one decoder layer: memory (B, S_enc, d) -> two
    (B, S_enc, Hkv, hd)."""
    b, se, _ = memory.shape
    hd = cfg.resolved_head_dim
    k = linear(memory, p["wk"]).reshape(b, se, cfg.n_kv_heads, hd)
    v = linear(memory, p["wv"]).reshape(b, se, cfg.n_kv_heads, hd)
    return k, v


def _fill_len(n: int, device) -> torch.Tensor:
    """A 0-dim int32 length, filled on the device: a copy from the host is
    what a CUDA graph capture refuses."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _apply_cross(cfg, p: Params, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, enc_len: Optional[torch.Tensor] = None):
    """Cross-attention of x (B, S, d) over the cross K/V (B, S_enc, Hkv,
    hd), with its residual.  One query per row (a decode step) reads the
    first ``enc_len`` positions (a 0-dim int32 tensor on x's device;
    default: all) by plain attention; more (a prefill) go through K1,
    bidirectional, Sq = S over Sk = S_enc."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xn = apply_rmsnorm(p["ln"], x, cfg.norm_eps)
    q = linear(xn, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    if s == 1:
        if enc_len is None:
            enc_len = _fill_len(k.shape[1], x.device)
        out = attn_mod.decode_attention(q, k, v, enc_len)
    else:
        out = attn_mod.prefill_attention(q, k, v, causal=False)
    out = linear(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return x + out


# ---------------------------------------------------------------------------
# encoder, prefill and decode
# ---------------------------------------------------------------------------

def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, d) stub frontend embeddings -> memory (B, S_enc,
    d): scaled by sqrt(d) in the model dtype, RoPE at positions
    0..S_enc-1, bidirectional self-attention through K1, ``enc_norm``."""
    check_supported(cfg)
    x = frames.to(torch_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for i in range(cfg.n_enc_layers):
        lp = _index(params["enc"], i)
        p = lp["attn"]
        xn = apply_rmsnorm(p["ln"], x, cfg.norm_eps)
        q = linear(xn, p["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = linear(xn, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = linear(xn, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attn_mod.prefill_attention(q, k, v, causal=False)
        x = x + linear(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
        xn = apply_rmsnorm(lp["ffn_ln"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], xn)
    return apply_rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward(cfg, params, frames: torch.Tensor, tokens: torch.Tensor, *,
            mode: str = "prefill", caches=None):
    """Teacher-forced decoding over the encoder's memory.

    frames: (B, S_enc, d); tokens: (B, S_dec).  Prefill mode fills
    ``caches`` in place: each decoder layer's self K/V at positions
    0..S_dec-1 and its cross K/V (the cache's ``enc_len`` must be S_enc).
    Returns (logits (B, S_dec, V_padded), caches)."""
    check_supported(cfg)
    if mode != "prefill" or caches is None:
        raise NotImplementedError(
            "forward runs in prefill mode with a cache; the encoder-decoder "
            "training forward is not ported yet (ROADMAP Queue 1 item 14b)")
    if frames.shape[1] != caches["cross_k"].shape[2]:
        raise ValueError(f"frames hold {frames.shape[1]} positions, the "
                         f"cross cache {caches['cross_k'].shape[2]}")
    memory = encode(cfg, params, frames)
    x = embed_inputs(cfg, params, tokens)
    b, s = tokens.shape
    # every row is s long: the self caches take the first s positions
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = _index(params["dec"], i)
        x, _ = _apply_attn(cfg, lp["self"], x, mode="prefill",
                           cache=_index(caches["self"], i), pos=lengths,
                           kind="G")
        ck, cv = _cross_kv(cfg, lp["cross"], memory)
        caches["cross_k"][i].copy_(ck)
        caches["cross_v"][i].copy_(cv)
        x = _apply_cross(cfg, lp["cross"], x, ck, cv)
        xn = apply_rmsnorm(lp["ffn_ln"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], xn)
    return logits_from_hidden(cfg, params, x), caches


def decode_step(cfg, params, caches, token: torch.Tensor, pos, *,
                enc_len: Optional[int] = None):
    """One decoder token against the cached self and cross K/V.

    token: (B, 1) int; pos: () int, the position every row decodes at (a
    tensor on the token's device, or a number).  Writes each layer's self
    K/V at slot ``pos`` in place (a position past the cache drops) and
    returns (logits (B, 1, V_padded), caches).  The cross-attention reads
    the first ``enc_len`` encoder positions (default: all)."""
    check_supported(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    enc_valid = _fill_len(caches["cross_k"].shape[2] if enc_len is None
                          else enc_len, token.device)
    x = embed_inputs(cfg, params, token)
    for i in range(cfg.n_layers):
        lp = _index(params["dec"], i)
        x, _ = _apply_attn(cfg, lp["self"], x, mode="decode",
                           cache=_index(caches["self"], i), pos=pos,
                           kind="G")
        x = _apply_cross(cfg, lp["cross"], x, caches["cross_k"][i],
                         caches["cross_v"][i], enc_len=enc_valid)
        xn = apply_rmsnorm(lp["ffn_ln"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], xn)
    return logits_from_hidden(cfg, params, x), caches
