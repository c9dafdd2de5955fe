"""The port's kernel entry points on the CPU, against the JAX oracles.

On the CPU each wrapper takes its kernel's plain version; the CUDA kernels
themselves are held against those plain versions on the card by
``chip_smoke.py``.  Here the plain versions are held against
``repro.kernels.ref`` and against the Pallas kernels run in interpret mode,
as ``tests/test_kernels.py`` runs them.  fp32 tolerance 1e-5: both sides sum
in fp32 and the port's plain versions do not tile; bf16 takes the
tolerances of ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# ---------------------------------------------------------------------------
# K2 matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(4, 128, 256), (1, 64, 128),
                                   (37, 64, 96), (256, 128, 384)])
def test_matmul_ref_matches_reference_and_interpret_kernel(m, k, n):
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((m, k)) / np.sqrt(k)
    w = rng.standard_normal((k, n))
    got = ops.matmul_ref(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.matmul(_j(x), _j(w))),
                               **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.matmul(_j(x), _j(w), impl="interpret")),
        **F32_TOL)


def test_matmul_tied_head_view_and_bf16():
    """The tied head reads the (V, d) table as a K-contiguous (d, V) view."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((512, 64))
    x = rng.standard_normal((4, 64)) / 8.0
    tt = _t(table)
    view = tt.t()
    assert view.stride(0) == 1 and not view.is_contiguous()
    got = ops.matmul(_t(x), view).numpy()
    want = np.asarray(jops.matmul(_j(x), _j(table).T, impl="interpret"))
    np.testing.assert_allclose(got, want, **F32_TOL)
    got16 = ops.matmul(_t(x, torch.bfloat16), view.to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    want16 = jref.matmul(_j(x, jnp.bfloat16), _j(table, jnp.bfloat16).T)
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# K1 flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 0, 128, 128), (False, 0, 128, 128), (True, 32, 128, 128),
    (True, 0, 64, 128),                       # right-aligned: Sq < Sk
    (False, 0, 64, 128), (False, 0, 128, 64)])  # cross: Sq < Sk, Sq > Sk
def test_flash_attention_ref_matches_reference_and_interpret_kernel(
        heads, kv_heads, causal, window, sq, sk):
    rng = np.random.default_rng(heads * 10 + kv_heads)
    d = 32
    q = rng.standard_normal((heads, sq, d))
    k = rng.standard_normal((kv_heads, sk, d))
    v = rng.standard_normal((kv_heads, sk, d))
    got = ops.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
    want = jref.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                window=window)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    kern = jops.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                window=window, impl="interpret",
                                block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)


def test_flash_attention_ref_bf16():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((4, 64, 16)) for _ in range(3))
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jref.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                _j(v, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# routing by device, checks, build errors
# ---------------------------------------------------------------------------
def test_wrappers_send_cpu_tensors_to_plain_version():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x, w = _t(rng.standard_normal((3, 16))), _t(rng.standard_normal((16, 8)))
    assert torch.equal(ops.matmul(x, w), ops.matmul_ref(x, w))
    q, k = _t(rng.standard_normal((4, 8, 16))), _t(rng.standard_normal(
        (2, 8, 16)))
    assert torch.equal(ops.flash_attention(q, k, k),
                       ops.flash_attention_ref(q, k, k))
    buf, w = _t(rng.standard_normal((2, 3, 16))), _t(rng.standard_normal(
        (2, 16, 8)))
    assert torch.equal(ops.moe_ffn(buf, w, w, w.transpose(1, 2).contiguous()),
                       ops.moe_ffn_ref(buf, w, w,
                                       w.transpose(1, 2).contiguous()))
    x, dt = _t(rng.standard_normal((1, 5, 2, 4))), _t(
        rng.uniform(0.1, 1.0, (1, 5, 2)))
    a, b = _t(-rng.uniform(0.5, 1.5, 2)), _t(rng.standard_normal((1, 5, 3)))
    for got, want in zip(ops.ssd_scan(x, dt, a, b, b, chunk=2),
                         ops.ssd_scan_ref(x, dt, a, b, b, chunk=2)):
        assert torch.equal(got, want)
    a, b = _t(rng.uniform(0.1, 0.9, (2, 5, 3))), _t(rng.standard_normal(
        (2, 5, 3)))
    for got, want in zip(ops.rglru_scan(a, b), ops.rglru_scan_ref(a, b)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == {"matmul": 0, "flash_attention": 0,
                                   "moe_ffn": 0, "ssd_scan": 0,
                                   "rglru_scan": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="K"):
        ops.matmul(x, torch.zeros((6, 8)))
    with pytest.raises(TypeError):
        ops.matmul(x, torch.zeros((8, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(torch.zeros((8, 4)).t(), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(torch.zeros((3, 4, 8)), torch.zeros((2, 4, 8)),
                            torch.zeros((2, 4, 8)))


def test_build_raises_clearly_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_engine_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine("qwen3-0.6b", EngineConfig(max_len=16),
                      device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine("qwen3-0.6b", EngineConfig(max_len=16))
