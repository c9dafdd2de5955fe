"""K4's route and numerics, and K5's segmented order, decided on the CPU.

K4 (``kernels/ssd_scan.py:route``) picks its kernel before launch from the
dtype, the shapes and what TMA can read: every bf16 call of mamba2-130m's
served layers (P 64, N 128, chunks of 128 or one chunk, x, b and c as
strided views of the conv output) must take the wgmma + TMA kernel; fp32
and the odd shapes ``chip_smoke.py`` phase 6 checks keep the CUDA-core
(SIMT) kernel.  The wgmma kernel's shared memory must fit one H100 block
(232,448 bytes).  A torch emulation of the wgmma kernel's operand
roundings (att rounded to bf16, h and x * w fed as hi + lo pairs of bf16,
fp32 sums) is held against the sequential JAX oracle at mamba2's width,
at the bf16 tolerance of ``chip_smoke.py`` (``SSD_TOL``, 5e-2).

K5's plain version (``kernels/rglru_scan.py:rglru_scan_ref``) takes the
kernel's segmented order: it is held against ``repro.kernels.ref.
rglru_scan`` and the Pallas kernel in interpret mode at the RG-LRU
tolerance of ``tests/test_kernels.py`` (2e-4), and its rows at batch 2
must equal the rows at batch 1 bit for bit.  The kernels themselves run on
the card only (``chip_smoke.py`` phases 2, 6, 7, 10 and 11).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import rglru_scan as k5
from repro_torch.kernels import ssd_scan as k4
from repro_torch.models import registry
from repro_torch.models import ssm

SMEM_LIMIT = 232448              # H100: dynamic shared memory of one block
SSD_TOL_BF16 = dict(rtol=5e-2, atol=5e-2)    # chip_smoke.py SSD_TOL
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_kernels.py:160
BF = torch.bfloat16
# chip_smoke.py phase 6's odd (H, P, N, chunk)
ODD_SSD = ((3, 24, 40, 32), (2, 5, 7, 16), (2, 17, 130, 64))


def _mamba2():
    cfg = registry.get_config("mamba2-130m", reduced=False)
    assert cfg.dtype == "bfloat16", cfg
    d_inner = cfg.ssm_expand * cfg.d_model
    return cfg, d_inner, d_inner // cfg.ssm_head_dim


def _served_views(bsz, s):
    """x, b and c of one mamba2-130m prefill call at full width, strided
    views of the conv output as ``models/ssm.py:apply_ssm_layer`` cuts
    them from the conv input ``_split_in`` gives it."""
    cfg, d_inner, h = _mamba2()
    n = cfg.ssm_state
    proj = torch.empty((bsz, s, 2 * d_inner + 2 * n + h), dtype=BF)
    _, conv_in, _ = ssm._split_in(cfg, proj)
    conv_out = torch.empty(conv_in.shape, dtype=BF)   # silu(conv(...))
    x = conv_out[..., :d_inner].reshape(bsz, s, h, cfg.ssm_head_dim)
    return x, conv_out[..., d_inner:d_inner + n], conv_out[..., d_inner + n:]


def _route_of(x, b, c, chunk):
    return k4.route(x.dtype, x.shape[3], b.shape[-1], chunk, x.shape[1],
                    x.stride(), (b.stride(), c.stride()),
                    (x.data_ptr(), b.data_ptr(), c.data_ptr()))


# ---------------------------------------------------------------------------
# K4: the route
# ---------------------------------------------------------------------------
def test_routes_and_segments_are_chosen_from_dtype_and_shape_alone():
    assert list(inspect.signature(k4.route).parameters) == \
        ["dtype", "p", "n", "chunk", "s", "x_strides", "bc_strides",
         "addresses"]
    assert list(inspect.signature(k5.segment_len).parameters) == ["s"]


@pytest.mark.parametrize("bsz", [1, 2, 4])
@pytest.mark.parametrize("s", [256, 200, 129, 37, 1])
def test_served_mamba2_calls_take_the_wgmma_route(bsz, s):
    """Admissions (B 1, S 256), burst-sized batches, and the ragged S of
    ``chip_smoke.py`` phase 6, with the chunk ``ssm.ssd_chunked`` passes."""
    x, b, c = _served_views(bsz, s)
    row = x.shape[2] * x.shape[3] + 2 * b.shape[-1]     # 1792 elements
    # torch strides a dimension of size 1 as it likes
    for t, want in ((x, (s * row, row, x.shape[3], 1)), (b, (s * row, row, 1)),
                    (c, (s * row, row, 1))):
        assert all(st == w for st, w, n in zip(t.stride(), want, t.shape)
                   if n > 1), (t.stride(), want)
    assert _route_of(x, b, c, min(ssm.SSD_CHUNK, s)) == "wgmma"
    # the batch-1 slice of a batched call (phase 6's bit check) too
    assert _route_of(x[:1], b[:1], c[:1], min(ssm.SSD_CHUNK, s)) == "wgmma"


def test_fp32_and_odd_shapes_take_the_simt_route():
    x, b, c = _served_views(1, 256)
    assert _route_of(x.float(), b.float(), c.float(), 128) == "simt"
    for h, p, n, chunk in ODD_SSD:
        assert k4.route(BF, p, n, chunk, 100) == "simt", (p, n, chunk)
    assert k4.route(BF, 64, 192, 128, 256) == "simt"      # N over the smem
    assert k4.route(BF, 64, 128, 64, 256) == "simt"       # chunk 64
    assert k4.route(BF, 64, 128, 256, 200) == "simt"      # one chunk of 200
    assert k4.route(BF, 64, 128, 128, 200) == "wgmma"
    assert k4.route(BF, 64, 64, 37, 37) == "wgmma"
    # heads not packed, a row stride of 12 bytes, a misaligned base
    assert k4.route(BF, 64, 128, 128, 256, (0, 1792, 128, 1)) == "simt"
    assert k4.route(BF, 64, 128, 128, 256, None, [(1536, 6, 1)]) == "simt"
    assert k4.route(BF, 64, 128, 128, 256, None, [(1536, 8, 2)]) == "simt"
    assert k4.route(BF, 64, 128, 128, 256, addresses=(3072 + 8,)) == "simt"


@pytest.mark.parametrize("n", k4.WGMMA_N)
def test_wgmma_shared_memory_fits_one_block(n):
    """Two stages of C, B (n/64 boxes of 128 x 64 bf16 each) and x, the hi
    and lo tiles of h (n/64 boxes of 64 x 64), four (128,) fp32 vectors,
    four barriers, 1024 bytes of alignment."""
    got = k4.wgmma_smem_bytes(n)
    assert got == 2 * (2 * n // 64 + 1) * 16384 + 2 * n // 64 * 8192 \
        + 2048 + 32 + 1024
    assert got <= SMEM_LIMIT
    assert k4.wgmma_smem_bytes(192) > SMEM_LIMIT


# ---------------------------------------------------------------------------
# K4: the wgmma route's roundings against the sequential oracle
# ---------------------------------------------------------------------------
def _hi_lo(v):
    hi = v.to(BF).float()
    return hi, (v - hi).to(BF).float()


def _wgmma_emulation(x, dt, a, b, c, h0, chunk=128):
    """What the wgmma kernel computes, chunk by chunk, in fp32 sums: C.B^T
    from bf16 operands; att = C.B^T * exp(cs_i - cs_j) * dt_j masked and
    rounded to bf16; y = (C.h_hi + C.h_lo) * exp(cs_i) + att.x, rounded
    once; h = h * exp(cs_last) + ((x*w)_hi + (x*w)_lo)^T . B."""
    bsz, s, h, p = x.shape
    hs, ys = h0.clone(), []
    for s0 in range(0, s, chunk):
        xk = x[:, s0:s0 + chunk].float()
        bk, ck = b[:, s0:s0 + chunk].float(), c[:, s0:s0 + chunk].float()
        dtk = dt[:, s0:s0 + chunk]
        q = xk.shape[1]
        cs = torch.cumsum(dtk * a, dim=1)                    # (B,Q,H)
        causal = torch.ones((q, q), dtype=torch.bool).tril()
        seg = cs[:, :, None, :] - cs[:, None, :, :]
        lmat = torch.exp(torch.where(causal[None, :, :, None], seg,
                                     torch.full_like(seg, -1e30)))
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        att = (cb[..., None] * lmat * dtk[:, None]).to(BF).float()
        h_hi, h_lo = _hi_lo(hs)
        y = (torch.einsum("bin,bhpn->bihp", ck, h_hi)
             + torch.einsum("bin,bhpn->bihp", ck, h_lo)) \
            * torch.exp(cs)[..., None]
        y = y + torch.einsum("bijh,bjhp->bihp", att, xk)
        w = dtk * torch.exp(cs[:, -1:] - cs)
        xw_hi, xw_lo = _hi_lo(xk * w[..., None])
        contrib = torch.einsum("bjhp,bjn->bhpn", xw_hi, bk) \
            + torch.einsum("bjhp,bjn->bhpn", xw_lo, bk)
        hs = hs * torch.exp(cs[:, -1])[..., None, None] + contrib
        ys.append(y.to(BF))
    return torch.cat(ys, dim=1), hs


@pytest.mark.parametrize("s", [256, 200])
def test_wgmma_roundings_stay_within_ssd_tol_of_the_sequential_oracle(s):
    """mamba2-130m's width (H 24, P 64, N 128), from a state h0, with
    ``chip_smoke.py``'s input scales; x, b and c in bf16."""
    cfg, _, h = _mamba2()
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((1, s, h, p)) * 0.5).to(BF)
    b = torch.from_numpy(rng.standard_normal((1, s, n)) * 0.3).to(BF)
    c = torch.from_numpy(rng.standard_normal((1, s, n)) * 0.3).to(BF)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((1, s, h))).float())
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h) * 0.3).float())
    h0 = torch.from_numpy(rng.standard_normal((1, h, p, n)) * 0.5).float()
    y, hf = _wgmma_emulation(x, dt, a, b, c, h0)
    wy, wh = jref.ssd_scan(*(jnp.asarray(t.float().numpy())
                             for t in (x, dt, a, b, c)),
                           h0=jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy),
                               **SSD_TOL_BF16)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), **SSD_TOL_BF16)
    # the state is what the plain version computes but for the hi + lo
    # splits (~2^-16) and the order of fp32 sums
    _, ref_h = k4.ssd_scan_ref(x, dt, a, b, c, h0)
    np.testing.assert_allclose(hf.numpy(), ref_h.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(np.abs(np.asarray(wh)).max()) > 0.5


# ---------------------------------------------------------------------------
# K5: the segmented order
# ---------------------------------------------------------------------------
def test_segments_cover_s_and_depend_on_it_alone():
    assert k5.SEGMENTS == 8
    for s in range(1, 600):
        n = k5.segment_len(s)
        assert n * k5.SEGMENTS >= s > (n - 1) * k5.SEGMENTS, s
    assert k5.segment_len(256) == 32


def _scan_inputs(rng, b, s, l):
    """a = sigmoid(normal), b = 0.3 normal (``tests/test_kernels.py:
    156-157``) and a state h0."""
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, l))))
    bb = rng.standard_normal((b, s, l)) * 0.3
    h0 = rng.standard_normal((b, l))
    return [np.asarray(v, np.float32) for v in (a, bb, h0)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 37, 200, 256])
def test_segmented_ref_matches_sequential_oracle_and_interpret_kernel(
        s, with_h0):
    """A ragged L of 40 (one 32-lane block and a part).  The Pallas kernel
    starts from zero: h0 enters it as a virtual step 0 (a = 0, b = h0)."""
    a, b, h0 = _scan_inputs(np.random.default_rng(s), 2, s, 40)
    start = torch.from_numpy(h0) if with_h0 else None
    h, hf = k5.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b), start)
    wh, whf = jref.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                              h0=jnp.asarray(h0) if with_h0 else None)
    if with_h0:
        ja = np.concatenate([np.zeros_like(a[:, :1]), a], axis=1)
        jb = np.concatenate([h0[:, None], b], axis=1)
    else:
        ja, jb = a, b
    ph, phf = jops.rglru_scan(jnp.asarray(ja), jnp.asarray(jb),
                              impl="interpret", chunk=ja.shape[1],
                              block_l=40)
    ph = np.asarray(ph)[:, ja.shape[1] - s:]
    for want_h, want_hf in ((wh, whf), (ph, phf)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf),
                                   **SCAN_TOL)
    assert torch.equal(hf, h[:, -1])


@pytest.mark.parametrize("s", [1, 37, 256, 300])
def test_segmented_ref_rows_at_batch_2_equal_rows_alone(s):
    a, b, h0 = map(torch.from_numpy,
                   _scan_inputs(np.random.default_rng(7 + s), 2, s, 72))
    for start in (None, h0):
        h2, hf2 = k5.rglru_scan_ref(a, b, start)
        for i in range(2):
            h1, hf1 = k5.rglru_scan_ref(
                a[i:i + 1], b[i:i + 1],
                None if start is None else start[i:i + 1])
            assert torch.equal(h2[i:i + 1], h1)
            assert torch.equal(hf2[i:i + 1], hf1)
