"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc/`` (the kernels, and the host-call entry
points of ``csrc/hostcall.cu``) are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``kernels/build/libkernels.so`` at first use, one ``nvcc``
process per source, all started together, then linked.  The library has a
plain C interface and is loaded with ``ctypes``: pointers and the CUDA
stream travel as ``c_void_p``.  A content hash of the sources and flags
decides whether an existing library is current.

Importing this module needs neither ``nvcc`` nor CUDA, so the CPU tests
collect; :func:`library` raises :class:`KernelBuildError` where ``nvcc`` is
missing or a build fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or compiling or loading the kernels failed."""


class _Library:
    """The loaded kernel library, built at most once per process."""

    def __init__(self):
        self.cdll: Optional[ctypes.CDLL] = None
        self.build_s: Optional[float] = None   # None: loaded a current build
        self.logs: Dict[str, str] = {}          # nvcc output by source stem


_LIB = _Library()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled "
            "from kernels/csrc/ at first use and need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile every source under csrc/ into build/libkernels.so.

    Returns the library's path; skips the build when the library on disk
    was made from the same sources and flags.
    """
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            _LIB.logs[obj.stem] = out.decode(errors="replace")
            if proc.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise KernelBuildError(
                f"linking failed:\n$ {' '.join(cmd)}\n"
                f"{res.stdout.decode(errors='replace')}")
        os.replace(tmp_lib, lib)
    stamp.write_text(digest)
    _LIB.build_s = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built from the sources on first call)."""
    if _LIB.cdll is None:
        path = build()
        try:
            cdll = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _bind(cdll)
        _LIB.cdll = cdll
    return _LIB.cdll


def last_build_seconds() -> Optional[float]:
    """Seconds the last build in this process took (None: none ran)."""
    return _LIB.build_s


def ptxas_report(stem: str) -> List[dict]:
    """Registers, spills and static shared memory of each kernel compiled
    from ``csrc/<stem>.cu`` in this process's build, from ``-Xptxas -v``
    (empty where no build ran)."""
    rows, cur = [], None
    for line in _LIB.logs.get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return rows


def _bind(cdll: ctypes.CDLL):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.repro_matmul.argtypes = [p, p, p, i, i, i, ll, ll, ll, ll, i, p, p, i,
                                  i, p]
    cdll.repro_matmul.restype = i
    cdll.repro_refusal.argtypes = []
    cdll.repro_refusal.restype = ctypes.c_char_p
    cdll.repro_matmul_smem_bytes.argtypes = [i]
    cdll.repro_matmul_smem_bytes.restype = i
    cdll.repro_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           p, i, p]
    cdll.repro_flash_attention.restype = i
    cdll.repro_flash_attention_wgmma.argtypes = [p, p, p, p, i, i, i, i, i,
                                                 i, i, p, p]
    cdll.repro_flash_attention_wgmma.restype = i
    cdll.repro_flash_attention_wgmma_smem.argtypes = [i]
    cdll.repro_flash_attention_wgmma_smem.restype = i
    cdll.repro_flash_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               i, i, i, i, i, i, i, i, p]
    cdll.repro_flash_attention_bwd.restype = i
    cdll.repro_flash_attention_bwd_smem.argtypes = [i]
    cdll.repro_flash_attention_bwd_smem.restype = i
    cdll.repro_flash_attention_bwd_wgmma.argtypes = [p, p, p, p, p, p, p, p,
                                                     p, p, i, i, i, i, i, i,
                                                     i, p]
    cdll.repro_flash_attention_bwd_wgmma.restype = i
    cdll.repro_flash_attention_bwd_wgmma_smem.argtypes = [i, i]
    cdll.repro_flash_attention_bwd_wgmma_smem.restype = i
    cdll.repro_moe_ffn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    cdll.repro_moe_ffn.restype = i
    cdll.repro_moe_ffn_wgmma.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         p]
    cdll.repro_moe_ffn_wgmma.restype = i
    cdll.repro_moe_ffn_wgmma_smem.argtypes = [i, i]
    cdll.repro_moe_ffn_wgmma_smem.restype = i
    cdll.repro_moe_ffn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, p]
    cdll.repro_moe_ffn_bwd.restype = i
    cdll.repro_moe_ffn_bwd_wgmma.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                             p, p, i, i, i, i, p]
    cdll.repro_moe_ffn_bwd_wgmma.restype = i
    cdll.repro_moe_ffn_bwd_wgmma_smem.argtypes = [i]
    cdll.repro_moe_ffn_bwd_wgmma_smem.restype = i
    cdll.repro_ssd_scan.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                    ll, ll, ll, ll, ll, ll, ll, ll, ll, i, p]
    cdll.repro_ssd_scan.restype = i
    cdll.repro_ssd_scan_wgmma.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, ll, ll, ll, ll, ll, ll, ll,
                                          ll, ll, p]
    cdll.repro_ssd_scan_wgmma.restype = i
    cdll.repro_ssd_scan_wgmma_smem.argtypes = [i]
    cdll.repro_ssd_scan_wgmma_smem.restype = i
    cdll.repro_rglru_scan.argtypes = [p, p, p, p, p, i, i, i, p]
    cdll.repro_rglru_scan.restype = i
    cdll.repro_rglru_scan_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    cdll.repro_rglru_scan_bwd.restype = i
    # csrc/hostcall.cu: in-graph host calls (core/hostcall.py)
    cdll.repro_hostcall.argtypes = [p, p, p, i, p, p, p, p, p, ll]
    cdll.repro_hostcall.restype = i
    cdll.repro_host_alloc.argtypes = [ll]
    cdll.repro_host_alloc.restype = p
    cdll.repro_host_free.argtypes = [p]
    cdll.repro_host_free.restype = i


def check(err: int, what: str):
    """Raise if a kernel's C entry returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err}")


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device_index: Optional[int] = None) -> int:
    """PyTorch's current CUDA stream as an integer for the C interface (a
    fraction of a microsecond through the raw accessor where PyTorch has
    it, some microseconds through a ``Stream`` object where not)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device() if device_index is None
                           else device_index)
    return torch.cuda.current_stream(device_index).cuda_stream
