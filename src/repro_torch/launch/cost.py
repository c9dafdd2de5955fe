"""FLOP and byte counts of a program, run once on ``meta`` tensors (the
port's counterpart of ``repro/launch/hlo_analysis.py``).

The reference prices a program by parsing the HLO that XLA compiled for
it.  The port has no compiled artifact to parse: a program is the Python
function the Syscore captures.  So :func:`count` runs the function once
on ``meta`` tensors (shapes and dtypes, no storage) under a
``TorchDispatchMode`` that sees every ATen operator and every one of the
five kernels' custom operators (``repro_torch::{matmul,flash_attention,
moe_ffn,ssd_scan,rglru_scan}``, and K1's, K3's and K5's gradients
``flash_attention_bwd``, ``moe_ffn_bwd`` and ``rglru_scan_bwd``), and
adds up what each
costs.  On ``meta`` the kernels' registered fakes run, never their CUDA
implementations: counting launches nothing, moves no launch counter and
allocates no device memory.

FLOPs:

- ``aten.mm``/``addmm``: 2·M·N·K; ``aten.bmm``/``baddbmm``: 2·B·M·N·K
  (einsums reach the dispatcher as these);
- K2 ``matmul`` (M, K) @ (K, N): 2·M·N·K;
- K1 ``flash_attention`` q (BH, Sq, D) over keys (BHk, Sk, D): 4·BH·Sq·Sk·D,
  the scores and the weighted sum over every (query, key) pair, with no
  causal or window discount: the reference model's attention computes
  them all, so the count agrees with the JAX package's;
- K1's gradient ``flash_attention_bwd``: 10·BH·Sq·Sk·D, its five products
  (the recomputed scores, dO·Vᵀ, dV, dQ and dK), with no discount either;
- K2's gradient is two more K2 products (dX and dW), counted as K2, so a
  train program counts its products at 3x the forward's, plus the
  forward's again for each layer group its ``remat_policy`` recomputes;
- K3 ``moe_ffn`` buf (E, C, d), w1/w3 (E, d, f): 6·E·C·d·f over the whole
  capacity buffer.  On ``meta`` no routing is known, so rows the router
  leaves empty are counted as if full: an upper bound of the work;
- K3's gradient ``moe_ffn_bwd``: 16·E·C·d·f over the whole buffer, as
  above: the recompute of the gate and up products (4), dH = dY·W2ᵀ (2),
  dX through w1 and w3 (4) and the three weight gradients (6);
- K4 ``ssd_scan`` x (B, S, H, P), b/c (B, S, N), chunks of Q: per batch row,
  head and chunk 2·Q²·(N + P) (the decay-masked C·Bᵀ and its product with
  x) + 4·Q·N·P (the inter-chunk output and the state update), as the
  reference kernel computes them;
- K5 ``rglru_scan`` a, b (B, S, L): 2·B·S·L (h = a·h + b);
- K5's gradient ``rglru_scan_bwd`` a, h, dh (B, S, L): 3·B·S·L (the
  adjoint lam = c·lam + dh, and da = lam·h_prev).

Bytes (the reference's ideal-traffic model: what must touch HBM under
perfect elementwise fusion):

- products and K1-K5 read each input and write each output once;
- cache writes (``index_copy_``, ``index_put_``, ``scatter``, a ``copy_``
  into a view of a larger tensor) move twice the update;
- gathers (``index``, ``index_select``, ``gather``, ``embedding``) and
  materialized copies (``clone``, ``cat``) move twice their result;
- views and elementwise ops are free.

Loops need nothing special: the port's horizon and verify programs are
eager loops of the same ``decode_step``, so a horizon of H steps is
counted H times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the five kernels' custom operators must be registered before a count
from repro_torch.kernels import ops as _ops  # noqa: F401

__all__ = ["Cost", "count", "tensors"]


@dataclass
class Cost:
    """What one run of a program costs: FLOPs, ideal HBM bytes, and per
    operator its calls, FLOPs and bytes (``by_op``, keyed by schema name,
    e.g. ``"repro_torch::matmul"``)."""
    flops: float = 0.0
    bytes_ideal: float = 0.0
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def add(self, op: str, flops: float, nbytes: float):
        self.flops += flops
        self.bytes_ideal += nbytes
        rec = self.by_op.setdefault(op, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes

    def to_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_ideal": self.bytes_ideal,
                "by_op": self.by_op}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def tensors(tree):
    """The tensors of a nested dict, tuple or list."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)


def _io_bytes(args, out) -> int:
    """Each input read once and each output written once."""
    return sum(map(_nbytes, tensors(args))) + \
        sum(map(_nbytes, tensors(out)))


def _mm(args):
    a, b = args[-2], args[-1]
    return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]


def _bmm(args):
    a, b = args[-2], args[-1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]


def _flash(args):
    q, k = args[0], args[1]
    return 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]


def _flash_bwd(args):
    q, k = args[0], args[1]
    return 10.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]


def _moe(args):
    buf, w1 = args[0], args[1]
    e, c, d = buf.shape
    return 6.0 * e * c * d * w1.shape[2]


def _moe_bwd(args):
    buf, w1 = args[0], args[1]
    e, c, d = buf.shape
    return 16.0 * e * c * d * w1.shape[2]


def _ssd(args):
    x, b, chunk = args[0], args[3], args[6]
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    return float(bsz * h * math.ceil(s / q)
                 * (2 * q * q * (n + p) + 4 * q * n * p))


def _rglru(args):
    return 2.0 * args[0].numel()


def _rglru_bwd(args):
    return 3.0 * args[0].numel()


# schema name -> FLOPs of one call; the bytes of these are their I/O
_PRODUCTS: Dict[str, Callable] = {
    "aten::mm": _mm, "aten::addmm": _mm,
    "aten::bmm": _bmm, "aten::baddbmm": _bmm,
    "repro_torch::matmul": _mm,
    "repro_torch::flash_attention": _flash,
    "repro_torch::flash_attention_bwd": _flash_bwd,
    "repro_torch::moe_ffn": _moe,
    "repro_torch::moe_ffn_bwd": _moe_bwd,
    "repro_torch::ssd_scan": _ssd,
    "repro_torch::rglru_scan": _rglru,
    "repro_torch::rglru_scan_bwd": _rglru_bwd,
}

# cache writes: schema name -> the argument holding the update
_WRITES = {"aten::index_copy_": 3, "aten::index_copy": 3,
           "aten::index_put_": 2, "aten::index_put": 2,
           "aten::_index_put_impl_": 2,
           "aten::scatter_": 3, "aten::scatter": 3,
           "aten::scatter_add_": 3, "aten::scatter_add": 3,
           "aten::index_add_": 3, "aten::index_add": 3,
           "aten::slice_scatter": 1, "aten::select_scatter": 1}

# gathers and materialized copies: twice the result
_GATHERS = {"aten::index", "aten::index_select", "aten::gather",
            "aten::embedding", "aten::clone", "aten::cat"}


def _write_bytes(name: str, args) -> int:
    upd = args[_WRITES[name]] if len(args) > _WRITES[name] else None
    if isinstance(upd, torch.Tensor):
        return 2 * _nbytes(upd)
    # a scalar written at the index's positions
    index = args[2]
    return 2 * index.numel() * args[0].element_size()


def _is_part(t: torch.Tensor) -> bool:
    """True when ``t`` is a view of part of a larger tensor."""
    return _nbytes(t) < t.untyped_storage().nbytes()


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in _PRODUCTS:
            self.cost.add(name, _PRODUCTS[name](args),
                          _io_bytes(args, out))
        elif name in _WRITES:
            self.cost.add(name, 0.0, _write_bytes(name, args))
        elif name in _GATHERS:
            self.cost.add(name, 0.0, 2 * sum(map(_nbytes, tensors(out))))
        elif name == "aten::copy_" and _is_part(args[0]):
            self.cost.add(name, 0.0, 2 * _nbytes(args[0]))
        return out


def count(fn: Callable, *args) -> Tuple[Cost, Any]:
    """Run ``fn(*args)`` once and return (its :class:`Cost`, its output).
    Every tensor among ``args`` (nested dicts, tuples and lists included)
    must be on the ``meta`` device, so that the run reads and writes no
    data and launches no kernel."""
    for t in tensors(args):
        if t.device.type != "meta":
            raise ValueError(
                f"count runs a program on meta tensors only; got a tensor "
                f"of shape {tuple(t.shape)} on {t.device}")
    cost = Cost()
    with _Counter(cost):
        out = fn(*args)
    return cost, out
