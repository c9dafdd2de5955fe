"""Serving step functions: the programs the Syscore hot-loads
(port of the dense-cache serving part of ``repro/steps.py``; dense and
MoE archs share it).

Each program works on the live cache tree in place and returns it, so the
engine's call sites read as the reference's: ``caches, out = prog(...)``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.syscore import ProgramSpec
from repro_torch.models import transformer


def make_prefill_slot_step(cfg, cache_len: int):
    """prefill_slot(params, caches, tokens (1,S), slot, length) ->
    (caches, last).

    Admission of ONE request into a live batch: prefill a fresh batch-1
    cache and copy its rows, and its ``pos``, into slot ``slot`` of the live
    tree.  Nothing outside row ``slot`` is touched, so the other slots keep
    decoding between executions.  ``last`` is the (V,) logits at the final
    valid prompt position."""
    def prefill_slot(params, caches, tokens, slot: int, length: int):
        fresh = transformer.init_cache(cfg, 1, cache_len,
                                       device=tokens.device)
        logits, c1 = transformer.forward(
            cfg, params, tokens, mode="prefill", caches=fresh,
            lengths=torch.tensor([length], dtype=torch.int32))
        caches["pos"][slot] = c1["pos"][0]
        # group-stacked leaves carry a leading (layers,) axis: batch is axis
        # 1; tail leaves index batch at axis 0
        for name, group in caches["groups"].items():
            for leaf, buf in group.items():
                buf[:, slot] = c1["groups"][name][leaf][:, 0]
        for name, layer in caches["tail"].items():
            for leaf, buf in layer.items():
                buf[slot] = c1["tail"][name][leaf][0]
        return caches, logits[0, length - 1]

    return prefill_slot


def make_serve_step(cfg):
    """decode(params, caches, token (B,1)) -> (caches, next (B,1), logits).

    One greedy decode step; each row reads its position from the per-slot
    ``pos`` in the cache tree and the tree comes back with it advanced."""
    def serve_step(params, caches, token):
        logits, caches = transformer.decode_step(cfg, params, caches, token)
        return caches, transformer.greedy_token(cfg, logits), logits

    return serve_step


def serve_program_specs(cfg, config) -> Dict[str, ProgramSpec]:
    """The serving programs for an :class:`EngineConfig`:
    ``prefill_slot`` (one admission into a live batch) and ``decode`` (one
    greedy token for every slot)."""
    return {
        "prefill_slot": ProgramSpec(
            "prefill_slot", make_prefill_slot_step(cfg, config.max_len)),
        "decode": ProgramSpec("decode", make_serve_step(cfg)),
    }
