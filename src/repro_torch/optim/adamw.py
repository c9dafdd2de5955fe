"""AdamW with decoupled weight decay, global-norm clipping and a cosine
learning rate (port of ``repro/optim/adamw.py``).

Moments are fp32 whatever the parameters' dtype, and every update follows
the reference's order of operations: the gradient scaled by the clip,
``m = b1 * m + (1 - b1) * g``, ``v = b2 * v + (1 - b2) * g^2``, the
bias-corrected step ``(m / b1t) / (sqrt(v / b2t) + eps)``, then
``p.float() * (1 - lr * decay) - lr * step`` cast back to the parameter's
dtype; decay applies to leaves of rank 2 and more.

Two forms: :func:`adamw_update` returns new trees, as the reference does;
:func:`adamw_update_` writes the parameters and the state in place, the
form of the resident train program.  The schedule, the norm and the clip
are computed from device tensors (the step counter lives on the device),
so neither form waits for the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.program_store import leaves, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine down to ``min_lr_ratio * lr``; ``step``
    a 0-dim tensor (any dtype), the result fp32 on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _leaves(tree) -> List[torch.Tensor]:
    """A tree's leaves in sorted key order (a list of leaves as it is)."""
    return tree if isinstance(tree, list) else list(leaves(tree))


def adamw_init(params) -> Dict[str, Any]:
    """fp32 zero moments shaped as the parameters, and a 0-dim int32 step,
    on the parameters' device."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    device = _leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order; or a list of leaves)
    of each leaf's sum of squares, in fp32."""
    total = None
    for leaf in _leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _factors(cfg: AdamWConfig, step: torch.Tensor, grads):
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1t = 1 - torch.pow(cfg.b1, stepf)
    b2t = 1 - torch.pow(cfg.b2, stepf)
    return lr, gnorm, scale, b1t, b2t


def _update(cfg, g, m, v, p, lr, scale, b1t, b2t
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    g = g.float() * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    step_ = (m2 / b1t) / (torch.sqrt(v2 / b2t) + cfg.eps)
    decay = cfg.weight_decay if p.dim() >= 2 else 0.0
    p2 = p.float() * (1 - lr * decay) - lr * step_
    return p2.to(p.dtype), m2, v2


def adamw_update(cfg: AdamWConfig, grads, state, params):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}); the
    inputs are left as they were."""
    step = state["step"] + 1
    lr, gnorm, scale, b1t, b2t = _factors(cfg, step, grads)
    out = [_update(cfg, g, m, v, p, lr, scale, b1t, b2t)
           for g, m, v, p in zip(_leaves(grads), _leaves(state["m"]),
                                 _leaves(state["v"]), _leaves(params))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads, state, params
                  ) -> Dict[str, torch.Tensor]:
    """:func:`adamw_update` in place: the parameters, the moments and the
    step counter are overwritten (their storage kept).  ``grads`` is a
    tree shaped as ``params``, or a list of its leaves in sorted key
    order.  Returns the metrics."""
    state["step"].add_(1)
    g_leaves = _leaves(grads)
    lr, gnorm, scale, b1t, b2t = _factors(cfg, state["step"], g_leaves)
    for g, m, v, p in zip(g_leaves, _leaves(state["m"]),
                          _leaves(state["v"]), _leaves(params)):
        p2, m2, v2 = _update(cfg, g, m, v, p, lr, scale, b1t, b2t)
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)
    return {"grad_norm": gnorm, "lr": lr}
