"""Architecture registry of the port and the per-(arch x shape) cell layer
(port of ``repro/models/registry.py``).

A *cell* is one (architecture, input-shape) pair of the assignment matrix.
:func:`cell_spec` returns what a dry run needs to count one: which step
function to build and every argument as a ``meta`` tensor, so that nothing
is allocated (``repro_torch.launch.cost`` counts a program on them).
:func:`param_counts` and :func:`model_flops` are the reference's analytic
counts, the MODEL_FLOPS column of ``repro_torch.bench.roofline``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

# archs whose config and model path the port carries: all ten of the
# reference's (seamless-m4t-medium through ``models.encdec``, the rest
# through ``models.transformer``)
PORTED_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "qwen3-moe-30b-a3b",
                "mamba2-130m", "recurrentgemma-2b", "llama3.2-3b",
                "gemma3-4b", "gemma3-12b", "internvl2-26b",
                "seamless-m4t-medium")

# the reference's order of the assignment matrix
ARCH_IDS = [
    "internvl2-26b", "mamba2-130m", "gemma3-12b", "llama3.2-3b",
    "qwen3-0.6b", "gemma3-4b", "seamless-m4t-medium", "qwen3-moe-30b-a3b",
    "olmoe-1b-7b", "recurrentgemma-2b",
]

# shape id -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

META = torch.device("meta")


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in PORTED_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (the port carries: "
                       f"{', '.join(PORTED_ARCHS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG


def cell_skip_reason(cfg: ModelConfig, shape_id: str) -> Optional[str]:
    if shape_id == "long_500k" and not cfg.supports_long_context:
        return ("full-attention family: 500k decode state is not "
                "sub-quadratic")
    return None


def all_cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            if include_skipped or cell_skip_reason(cfg, s) is None:
                out.append((a, s))
    return out


@dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    cfg: ModelConfig
    abstract_args: Tuple[Any, ...]  # meta tensors, step-fn order
    donate_argnums: Tuple[int, ...]  # the caches, updated in place
    seq_len: int
    global_batch: int


def cell_spec(arch_id: str, shape_id: str, *, reduced: bool = False,
              remat: Optional[str] = None) -> CellSpec:
    """One cell's step-function arguments as ``meta`` tensors: the
    parameters (from ``abstract_params``: a ``meta`` device has no
    generator to draw from), the caches, and the per-call inputs of
    :func:`build_step_fn`'s program; a ``train`` cell's are the train
    state (parameters, fp32 moments, step) and the batch, for the dense,
    MoE and hybrid families (the SSM and encoder-decoder ones raise:
    ROADMAP Queue 1 items 14b.3 and 14b.4).  The
    reference's ``attn_impl`` and ``cache_heads`` knobs are sharding
    switches (ROADMAP Queue 1 item 13); ``remat`` replaces the config's
    ``remat_policy`` (nothing, dots or full)."""
    from repro_torch.models import encdec, layers, transformer

    cfg = get_config(arch_id, reduced=reduced)
    if remat is not None:
        cfg = cfg.replace(remat_policy=remat)
    seq, batch, kind = SHAPES[shape_id]
    if reduced:
        seq, batch = 64, 4
    dtype = layers.torch_dtype(cfg.dtype)
    mod = encdec if cfg.is_encdec else transformer
    if kind == "train":
        from repro_torch import steps
        why = steps.train_unsupported(cfg)
        if why is not None:
            raise NotImplementedError(f"{arch_id} x {shape_id}: {why}")
        params = layers.zeros(mod.abstract_params(cfg), dtype, META)
        state = steps.init_train_state(cfg, params=params)
        inputs = steps.batch_templates(cfg, batch, seq, META)
        return CellSpec(arch=arch_id, shape=shape_id, kind=kind, cfg=cfg,
                        abstract_args=(state,) + tuple(
                            inputs[k] for k in steps.batch_keys(cfg)),
                        donate_argnums=(0,), seq_len=seq,
                        global_batch=batch)
    params = layers.zeros(mod.abstract_params(cfg), dtype, META)
    if cfg.is_encdec:
        se = sd = seq // 2
        caches = encdec.init_cache(cfg, batch, sd, se, device=META)
    else:
        caches = transformer.init_cache(cfg, batch, seq, device=META)

    def ints(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=META)

    if kind == "prefill":
        if cfg.is_encdec:
            inputs = (torch.zeros((batch, se, cfg.d_model), dtype=dtype,
                                  device=META), ints(batch, sd))
        else:
            p = cfg.frontend_tokens
            inputs = (ints(batch, seq - p),
                      torch.full((batch,), seq, dtype=torch.int32,
                                 device=META))
            if p:
                inputs += (torch.zeros((batch, p, cfg.d_model), dtype=dtype,
                                       device=META),)
    else:  # decode: one token a row
        # enc-dec decode still takes an explicit scalar position;
        # decoder-only keeps per-slot positions inside the cache tree
        inputs = ((ints(batch, 1), ints()) if cfg.is_encdec
                  else (ints(batch, 1),))
    return CellSpec(arch=arch_id, shape=shape_id, kind=kind, cfg=cfg,
                    abstract_args=(params, caches) + inputs,
                    donate_argnums=(1,), seq_len=seq, global_batch=batch)


def build_step_fn(spec: CellSpec, opt_cfg=None, accum: int = 1):
    """The program a cell runs: the whole-batch prefill, the decode step,
    or the train program (``steps.make_train_program``: state then the
    batch's tensors) of ``repro_torch.steps``."""
    from repro_torch import steps
    if spec.kind == "prefill":
        return steps.make_prefill_step(spec.cfg)
    if spec.kind == "decode":
        return steps.make_serve_step(spec.cfg)
    from repro_torch.optim import AdamWConfig
    return steps.make_train_program(spec.cfg, opt_cfg or AdamWConfig(),
                                    accum=accum)


# ----------------------------------------------------------------------------
# analytic parameter / FLOP counts for the roofline MODEL_FLOPS column
# ----------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic total and active parameter counts (embedding included)."""
    d, v = cfg.d_model, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    pattern = cfg.pattern_for_layers()
    total = v * d + (0 if cfg.tie_embeddings else d * v)
    active = total
    for kind in pattern:
        if kind in ("G", "L"):
            n = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            total += n
            active += n
        elif kind == "M":
            d_in = cfg.ssm_expand * d
            h = d_in // cfg.ssm_head_dim
            n = d * (2 * d_in + 2 * cfg.ssm_state + h) + d_in * d
            total += n
            active += n
        elif kind == "R":
            lru = cfg.lru_width or d
            n = d * lru * 2 + lru * d
            total += n
            active += n
        if cfg.d_ff > 0:
            if cfg.family == "moe":
                per = 3 * d * cfg.d_ff
                total += cfg.n_experts * per + d * cfg.n_experts
                active += cfg.experts_per_token * per + d * cfg.n_experts
            else:
                n = 3 * d * cfg.d_ff
                total += n
                active += n
    if cfg.is_encdec:
        # encoder layers (attention + mlp), same widths
        n = cfg.n_enc_layers * (d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
                                + 3 * d * cfg.d_ff)
        # cross attention in every decoder layer
        n += cfg.n_layers * d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        total += n
        active += n
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ModelConfig, shape_id: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params,
    D = processed tokens. Attention score FLOPs excluded by convention."""
    seq, batch, kind = SHAPES[shape_id]
    n_active = param_counts(cfg)["active"]
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * batch  # decode: one token per sequence
