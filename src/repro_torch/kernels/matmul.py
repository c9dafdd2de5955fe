"""K2: the matrix product of every projection, the MLP and the tied head.

``matmul(x, w)`` replaces the Pallas kernel ``repro/kernels/matmul.py:matmul``
with the CUDA C++ kernel in ``csrc/matmul.cu`` (its header says what bounds
it and how it is built).  The device of the tensors decides the route: CPU
tensors take :func:`matmul_ref`, CUDA tensors launch the kernel or raise.
``matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32-accumulating (M,K)@(K,N) in x's dtype
    (``repro/kernels/ref.py:matmul``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes differ in K: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"matmul operands on {x.device} and {w.device}")
    if x.stride(1) != 1:
        raise ValueError("matmul needs x contiguous along K")
    if w.stride(1) != 1 and w.stride(0) != 1:
        raise ValueError("matmul needs w contiguous along N or along K")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) in x's dtype with fp32 accumulation.

    ``w`` may be a strided view: row-major (K,N), or K-contiguous such as
    ``embed.t()`` for the tied head, which the kernel reads in place.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul has no route for device {x.device}")
    lib = _build.library()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        x.stride(0), w.stride(0), w.stride(1), out.stride(0),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle())
    _build.check(err, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
