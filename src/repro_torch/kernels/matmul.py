"""K2: the matrix product of every projection, the MLP and the tied head.

``matmul(x, w)`` replaces the Pallas kernel ``repro/kernels/matmul.py:matmul``
with the CUDA C++ kernels in ``csrc/matmul.cu`` (its header says what bounds
them and how they are built): bf16 products run on the tensor cores through
``wgmma`` fed by TMA, fp32 ones on the CUDA cores.  The device of the tensors
decides the route: CPU tensors take :func:`matmul_ref`, CUDA tensors launch
the kernel or raise.  ``matmul.launches`` counts kernel launches.

The bf16 kernel splits K into segments that :func:`plan` chooses from
(K, N, dtype) alone, never from M, and adds the segments' fp32 sums in
segment order: a row of the product has the same bits whatever M is, which
the engine's token exactness against its batch-1 reference rests on.

The operator has a gradient made of two more K2 products: dX = dY W^T
(W^T of a row-major W is K-contiguous, read in place) and dW = X^T dY
(X^T made row-major first).  Each goes through ``repro_torch::matmul``
again, so it launches K2 on the card and takes :func:`matmul_ref` on the
CPU, and counts as one launch.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

# the bf16 kernel's tiles (csrc/matmul.cu, namespace tc)
SLAB = 64            # K per TMA load: 128 bytes of bf16, one swizzle row
TILE_N = 64          # weight columns per block (wgmma's m)
SMALL_M = 64         # M up to this: one 64-row x tile, segments split by block
MIN_SEG_SLABS = 2    # no segment shorter than this many slabs
SMS = 132            # H100 SXM
TARGET_BLOCKS = 2 * SMS
# the fp32 kernel's tiles (namespace cuda_core): one pass over K in steps of 32
F32_TILE_N, F32_STEP = 64, 32


class Plan(NamedTuple):
    """How K2 cuts one (K, N) product; a function of (K, N, dtype) only."""
    tile_n: int                # weight columns per block
    tile_k: int                # K per step (a slab)
    slabs: int                 # steps over K
    segments: int              # S
    bounds: Tuple[int, ...]    # segment s covers slabs [bounds[s], bounds[s+1])


@functools.lru_cache(maxsize=None)
def plan(k: int, n: int, dtype: torch.dtype) -> Plan:
    """The split of K for a (K, N) product in ``dtype``.

    bf16: S segments of whole 64-wide slabs, S chosen so that
    ceil(N/64) x S blocks fill the 132 SMs about twice at decode, with no
    segment shorter than ``MIN_SEG_SLABS`` slabs; segment s covers slabs
    [s * slabs // S, (s + 1) * slabs // S), as the kernel computes them.
    fp32: one segment (the CUDA-core kernel walks all of K in steps of 32).
    There is no M argument: the rows of a product must not depend on how
    many there are.
    """
    if dtype == torch.bfloat16:
        slabs = -(-k // SLAB)
        want = -(-TARGET_BLOCKS // -(-n // TILE_N))
        segments = max(1, min(want, slabs // MIN_SEG_SLABS))
        tile_n, tile_k = TILE_N, SLAB
    else:
        slabs = -(-k // F32_STEP)
        segments = 1
        tile_n, tile_k = F32_TILE_N, F32_STEP
    bounds = tuple(i * slabs // segments for i in range(segments + 1))
    return Plan(tile_n, tile_k, slabs, segments, bounds)


def route(p: Plan, m: int, n: int) -> Tuple[int, bool]:
    """(x rows per tile, segments split over blocks) of a bf16 product of M
    rows.  Every M up to ``SMALL_M`` takes one route: a 64-row x tile and,
    with S > 1, one block per segment.  Above it one block adds all S
    segments itself, over x tiles of 128 rows where those give a block to
    every SM, else of 64; either way the same sums in the same order."""
    if m <= SMALL_M:
        return 64, p.segments > 1
    return (128 if -(-m // 128) * -(-n // p.tile_n) >= SMS else 64), False


def tma_error(shape: Sequence[int], strides: Sequence[int], itemsize: int,
              address: int = 0) -> Optional[str]:
    """Why TMA cannot read a 2-D operand of this layout, or None.

    TMA needs one dimension contiguous, a 16-byte aligned base and a row
    stride (the other dimension's) that is a multiple of 16 bytes."""
    if len(shape) != 2 or len(strides) != 2:
        return f"not 2-D: shape {tuple(shape)}"
    if strides[1] == 1:
        pitch = strides[0]
    elif strides[0] == 1:
        pitch = strides[1]
    else:
        return f"neither dimension is contiguous: strides {tuple(strides)}"
    if address % 16:
        return f"base address {address:#x} is not 16-byte aligned"
    if (pitch * itemsize) % 16:
        return f"row stride of {pitch * itemsize} bytes is not a multiple of 16"
    return None


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


# per (device, stream): the fp32 partials of a split product, (S, M, N)
# at its head, and int32 arrival counters, one per weight tile, that the
# last block of a tile resets to 0.  Launches on one stream run one after
# another, so each reuses the buffers; they only grow.  The table in use is
# the top of ``_TABLES``: a program captured as a CUDA graph brings a table
# of its own (:func:`scratch_table`), so its graph's buffers live exactly
# as long as the program and no other product can regrow (free) them.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_TABLES: List[dict] = [_SCRATCH]


@contextlib.contextmanager
def scratch_table(table: dict):
    """Split products inside the block take their scratch from ``table``
    (empty at first, then kept by the caller)."""
    _TABLES.append(table)
    try:
        yield table
    finally:
        _TABLES.pop()


def _scratch(device: torch.device, stream: int, floats: int,
             tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    table = _TABLES[-1]
    key = (device.index, stream)
    ws, cnt = table.get(key, (None, None))
    if ws is not None and ws.numel() >= floats and cnt.numel() >= tiles:
        return ws, cnt
    if torch.cuda.is_current_stream_capturing():
        # growing would free buffers the capture's earlier products hold
        raise RuntimeError(
            f"matmul: a split product needs {floats} floats and {tiles} "
            f"tiles of scratch that its table does not hold while a CUDA "
            f"graph is captured; warm the program up at its real shapes "
            f"(in the same table) before the capture")
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < tiles:
        cnt = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
    table[key] = ws, cnt
    return ws, cnt


def _tma_operands(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Raise on a weight TMA cannot read; copy an x view it cannot (x is
    small).  Returns x."""
    err = tma_error(w.shape, w.stride(), w.element_size(), w.data_ptr())
    if err is not None:
        raise ValueError(f"matmul: TMA cannot read the bf16 weight of shape "
                         f"{tuple(w.shape)}: {err}")
    if tma_error(x.shape, x.stride(), x.element_size(), x.data_ptr()):
        x = x.clone(memory_format=torch.contiguous_format)
        err = tma_error(x.shape, x.stride(), x.element_size(), x.data_ptr())
        if err is not None:
            raise ValueError(f"matmul: TMA cannot read the bf16 x of shape "
                             f"{tuple(x.shape)}: {err}")
    return x


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) in x's dtype with fp32 accumulation.

    ``w`` may be a strided view: row-major (K,N), or K-contiguous such as
    ``embed.t()`` for the tied head, which the kernel reads in place.
    The call goes through the ``repro_torch::matmul`` operator, so
    ``torch.export`` traces a program through it (its fake version gives
    the shape alone).
    """
    _check(x, w)
    return _matmul_op(x, w)


@torch.library.custom_op("repro_torch::matmul", mutates_args=(),
                         device_types="cuda")
def _matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation: launch K2 on the current stream."""
    lib = _build.library()
    m, k = x.shape
    n = w.shape[1]
    stream = _build.stream_handle(x.device.index)
    ws = counters = None
    segments = nt = 0
    if x.dtype == torch.bfloat16:
        x = _tma_operands(x, w)
        p = plan(k, n, x.dtype)
        segments = p.segments
        nt, split = route(p, m, n)
        if split:
            ws, counters = _scratch(x.device, stream, p.segments * m * n,
                                    -(-n // p.tile_n))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        x.stride(0), w.stride(0), w.stride(1), n,
        _build.DTYPE_CODES[x.dtype],
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        segments, nt, stream)
    if err != 0 and x.dtype == torch.bfloat16:
        why = lib.repro_refusal().decode()
        if why:
            raise ValueError(f"matmul refused (M={m}, K={k}, N={n}): {why}")
    _build.check(err, "matmul")
    matmul.launches += 1
    return out


@_matmul_op.register_kernel("cpu")
def _(x, w):
    return matmul_ref(x, w)


@_matmul_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], w.shape[1]))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    x, w = ctx.saved_tensors
    dy = dy.contiguous()
    dx = matmul(dy, w.t()) if ctx.needs_input_grad[0] else None
    dw = matmul(x.t().contiguous(), dy) if ctx.needs_input_grad[1] else None
    return dx, dw


_matmul_op.register_autograd(_backward, setup_context=_setup_context)

matmul.launches = 0
