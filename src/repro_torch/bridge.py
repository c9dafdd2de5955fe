"""Carry weights and caches between the reference and the port.

Trees travel as nested dicts of numpy arrays with the reference's key
paths: parameters ``embed``, ``final_norm``, ``lm_head`` (untied heads
only) and ``groups/slot0/{mix/{ln,wq,wk,wv,wo,q_norm,k_norm},ffn_ln,
mlp/{w_gate,w_up,w_down}}``, or ``moe/{router,w_gate,w_up,w_down}`` in
place of ``mlp`` for the MoE family, or ``mix/{ln,w_in,conv_w,conv_b,
a_log,d_skip,dt_bias,out_ln,w_out}`` for the SSM family, with the layer on
the leading axis; caches ``pos`` and ``groups/slot0/{k,v}``, or
``groups/slot0/{conv,state}`` for the SSM family; a paged cache adds
``block_table`` and holds block arenas under the ``{k, v}`` paths
(:func:`paged_cache_from_numpy`).  The hybrid family
(recurrentgemma, pattern R, R, L) has a recurrent layer's
``mix/{ln,w_x,w_gate,conv_w,conv_b,lam,w_a,b_a,w_i,b_i,w_out}`` and an
``ffn_ln`` and ``mlp`` under ``groups/slot0``, ``groups/slot1`` and, with
no leading axis, the remainder layers ``tail/tail0`` and ``tail/tail1``,
an attention layer under ``groups/slot2``; its caches are ``{conv, h}``
under the recurrent layers' paths and ``{k, v}`` under ``groups/slot2``.
gemma3's attention layers (pattern five "L", then "G") sit the same way
under ``groups/slot0``-``slot5`` and ``tail/tail{i}``, and internvl2
(family "vlm") has the dense layout with an untied ``lm_head``: no other
leaf kind.  seamless-m4t-medium (family "encdec") has its own tree:
parameters ``embed``, ``enc/{attn/{ln,wq,wk,wv,wo},ffn_ln,mlp/...}``,
``dec/{self/...,cross/{ln,wq,wk,wv,wo},ffn_ln,mlp/...}``, ``enc_norm``,
``final_norm`` and ``lm_head``; caches ``self/{k,v}``, ``cross_k`` and
``cross_v`` and no ``pos``.
The expected keys, shapes and dtypes are ``transformer.abstract_params``
and ``abstract_cache`` (``encdec.*`` for an encoder-decoder config): a
leaf that pins its dtype (the SSM's fp32
``a_log``, ``d_skip``, ``dt_bias`` and ``state``, the RG-LRU's fp32
``lam``, ``w_a``, ``b_a``, ``w_i``, ``b_i`` and ``h``, the int32 ``pos``)
must arrive in it, and every other leaf in the tree's one model dtype,
float32 or bfloat16.  bfloat16 arrives as a numpy array whose
``dtype.name == "bfloat16"`` (numpy has no such type of its own): its
bytes are viewed as 16-bit integers and reinterpreted by torch, so the
round trip is bit-exact.  Going back, bfloat16 leaves come out as
``uint16`` bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import encdec, transformer


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")       # a copy; keeps a 0-dim leaf 0-dim
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def to_numpy(tree) -> Any:
    """Tensors -> numpy arrays; bfloat16 leaves as ``uint16`` bit patterns."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _check_shapes(tree, shapes, path="", model_dtypes=None):
    """Keys, shapes and dtypes of a numpy tree against a :class:`Leaf`
    tree (see the module docstring)."""
    top = model_dtypes is None
    model_dtypes = set() if top else model_dtypes
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"tree at {path or '/'} has keys {got}, "
                             f"expected {sorted(shapes)}")
        for k in shapes:
            _check_shapes(tree[k], shapes[k], f"{path}/{k}", model_dtypes)
    else:
        if tuple(tree.shape) != shapes.shape:
            raise ValueError(f"leaf {path} has shape {tuple(tree.shape)}, "
                             f"expected {shapes.shape}")
        got = np.asarray(tree).dtype.name
        if shapes.dtype is None:
            model_dtypes.add(got)
        elif got != str(shapes.dtype).replace("torch.", ""):
            raise ValueError(f"leaf {path} has dtype {got}, expected "
                             f"{shapes.dtype}")
    if top and (len(model_dtypes) > 1 or
                not model_dtypes <= {"float32", "bfloat16"}):
        raise ValueError(f"the tree's model-dtype leaves must share one "
                         f"dtype, float32 or bfloat16: got "
                         f"{sorted(model_dtypes)}")


def params_from_numpy(tree, cfg, device) -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's."""
    model = encdec if cfg.is_encdec else transformer
    _check_shapes(tree, model.abstract_params(cfg))
    return _tree_from_numpy(tree, device)


def cache_from_numpy(tree, cfg, batch: int, cache_len: int, device, *,
                     ring: bool = True, enc_len: int = 0) -> dict:
    """The reference's dense cache tree (numpy leaves) -> the port's;
    ``ring=False`` for the flat windowed buffers of a speculative
    engine.  An encoder-decoder cache takes ``enc_len``, its cross K/V's
    positions (``cache_len`` is the decoder's)."""
    if cfg.is_encdec:
        if enc_len < 1:
            raise ValueError("an encoder-decoder cache takes enc_len >= 1")
        _check_shapes(tree, encdec.abstract_cache(cfg, batch, cache_len,
                                                  enc_len))
        return _tree_from_numpy(tree, device)
    _check_shapes(tree, transformer.abstract_cache(cfg, batch, cache_len,
                                                   ring=ring))
    out = _tree_from_numpy(tree, device)
    out["pos"] = out["pos"].to(torch.int32)
    return out


def cache_to_numpy(caches) -> dict:
    """The port's dense cache tree, decoder-only or encoder-decoder ->
    the reference's (numpy leaves)."""
    return to_numpy(caches)


def _arena_leaves(tree, fn, path=()):
    """``tree`` with ``fn(leaf, axis)`` applied to its arena leaves (``k``
    and ``v``; their block axis is 1 under ``groups``, else 0)."""
    if isinstance(tree, dict):
        return {k: _arena_leaves(v, fn, path + (k,))
                for k, v in tree.items()}
    if path[-1] in ("k", "v"):
        return fn(tree, 1 if path[0] == "groups" else 0)
    return tree


def paged_cache_from_numpy(tree, cfg, batch: int, cache_len: int, *,
                           kv_block: int, arena_blocks: int,
                           device) -> dict:
    """The reference's paged cache tree (numpy leaves: ``pos``,
    ``block_table``, the (..., arena_blocks, kv_block, heads, head_dim)
    arena leaves and the recurrent state rows) -> the port's, whose arena
    leaves carry one block more, the sink of dropped writes
    (``attention.write_paged_kv``), added here as zeros."""
    shapes = transformer.abstract_paged_cache(
        cfg, batch, cache_len, kv_block=kv_block, arena_blocks=arena_blocks)
    ref_shapes = _arena_leaves(shapes, lambda leaf, axis: leaf._replace(
        shape=leaf.shape[:axis] + (arena_blocks,) + leaf.shape[axis + 1:]))
    _check_shapes(tree, ref_shapes)
    out = _tree_from_numpy(tree, device)

    def add_sink(t, axis):
        sink = torch.zeros_like(t.narrow(axis, 0, 1))
        return torch.cat([t, sink], dim=axis)

    return _arena_leaves(out, add_sink)


def paged_cache_to_numpy(caches) -> dict:
    """The port's paged cache tree -> the reference's layout: numpy
    leaves, the arena leaves without their sink block."""
    return to_numpy(_arena_leaves(
        caches, lambda t, axis: t.narrow(axis, 0, t.shape[axis] - 1)))


def train_state_from_numpy(tree, cfg, device) -> dict:
    """The reference's train state ``{"params", "opt": {"m", "v", "step"}}``
    (numpy leaves) -> the port's: the parameters checked as
    :func:`params_from_numpy` does, the moments fp32 trees of the same
    keys and shapes, ``step`` a 0-dim int32."""
    model = encdec if cfg.is_encdec else transformer
    shapes = model.abstract_params(cfg)
    opt = tree["opt"]
    for name in ("m", "v"):
        _check_shapes(opt[name], shapes, f"/opt/{name}")
        dtypes = {np.asarray(a).dtype.name for a in _np_leaves(opt[name])}
        if dtypes != {"float32"}:
            raise ValueError(f"opt/{name} must be float32, got "
                             f"{sorted(dtypes)}")
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt/step must be a 0-dim int32, got "
                         f"{step.dtype} {step.shape}")
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": {"m": _tree_from_numpy(opt["m"], device),
                    "v": _tree_from_numpy(opt["v"], device),
                    "step": _leaf_from_numpy(step, device)}}


def train_state_to_numpy(state) -> dict:
    """The port's train state -> numpy leaves under the reference's key
    paths (bfloat16 parameters as ``uint16`` bit patterns)."""
    return to_numpy(state)


def _np_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    else:
        yield tree
