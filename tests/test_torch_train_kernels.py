"""The gradients of K1 and K2 on the CPU, against autograd of their plain
versions and against ``jax.vjp`` of the reference's attention.

On the CPU ``repro_torch::matmul``'s gradient runs two more products
through the same operator (its plain version here, K2 on the card), and
``repro_torch::flash_attention``'s runs ``repro_torch::flash_attention_bwd``
(its closed-form plain version here, the CUDA kernel of
``csrc/flash_attention_bwd.cu`` on the card, which ``chip_smoke.py`` holds
against it).  fp32 at the tolerances of ``tests/test_kernels.py``:
flash attention 3e-4, matmul 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (bwd_route, bwd_smem_bytes,
                                                 bwd_wgmma_smem_bytes,
                                                 flash_attention_ref)

FLASH = dict(rtol=3e-4, atol=3e-4)
MATMUL = dict(rtol=2e-3, atol=2e-3)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tied", [False, True])
def test_matmul_gradient_equals_autograd_of_the_plain_version(tied):
    """dX and dW of K2 equal autograd through ``matmul_ref``; the tied
    head's ``embed.t()`` view carries its gradient back to the table, where
    it adds to the embedding lookup's."""
    rng = np.random.default_rng(1)
    m, k, n = 12, 16, 40
    x = torch.from_numpy(_rand(rng, m, k))
    table = torch.from_numpy(_rand(rng, n, k) if tied else _rand(rng, k, n))
    ids = torch.from_numpy(rng.integers(0, n if tied else k, (5,)))
    dy = torch.from_numpy(_rand(rng, m, n))

    def run(mm):
        xr, tr = x.clone().requires_grad_(), table.clone().requires_grad_()
        w = tr.t() if tied else tr
        y = mm(xr, w)
        # the lookup's gradient lands on the same table
        extra = tr[ids].sum() * 0.5
        gx, gt = torch.autograd.grad((y * dy).sum() + extra, (xr, tr))
        return y, gx, gt

    y, gx, gt = run(ops.matmul)
    y0, gx0, gt0 = run(ops.matmul_ref)
    for a, b in ((y, y0), (gx, gx0), (gt, gt0)):
        _close(a, b.detach().numpy(), MATMUL)
    # and against the closed form
    w = table.t() if tied else table
    _close(gx, (dy @ w.t()).numpy(), MATMUL)
    dw = x.t() @ dy
    want_t = dw.t() if tied else dw
    want_t = want_t.clone()
    want_t.index_add_(0, ids, torch.full((5, k) if tied else (5, n), 0.5))
    _close(gt, want_t.numpy(), MATMUL)


def test_matmul_gradient_needs_only_what_is_asked():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand(rng, 4, 8)).requires_grad_()
    w = torch.from_numpy(_rand(rng, 8, 6))
    gx, = torch.autograd.grad(ops.matmul(x, w).sum(), (x,))
    _close(gx, np.ones((4, 6), np.float32) @ w.numpy().T, MATMUL)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
CASES = [  # (groups, head dim, causal, window, S)
    (1, 64, True, 0, 24), (2, 128, True, 0, 24), (4, 256, True, 0, 16),
    (2, 64, True, 8, 24), (4, 128, True, 5, 20), (1, 256, True, 6, 16),
    (2, 64, False, 0, 12)]


def _jax_vjps(q, k, v, do, causal, window):
    """vjp of the reference's ``reference_attention`` and
    ``chunked_attention`` (one jit), (B, S, H, D) layouts, K/V repeated to
    the query heads inside the function (so their cotangents sum over
    each group)."""
    h = q.shape[2]

    def both(q, k, v, do):
        def ref(q, k, v):
            return jattn.reference_attention(q, jattn.repeat_kv(k, h),
                                             jattn.repeat_kv(v, h),
                                             causal=causal, window=window)

        def chunked(q, k, v):
            return jattn.chunked_attention(
                q, jattn.repeat_kv(k, h), jattn.repeat_kv(v, h),
                causal=causal, window=window, chunk_q=8, chunk_k=8)

        return (jax.vjp(ref, q, k, v)[1](do),
                jax.vjp(chunked, q, k, v)[1](do))

    return jax.jit(both)(*(jnp.asarray(a) for a in (q, k, v, do)))


@pytest.mark.parametrize("groups,d,causal,window,s", CASES)
def test_flash_attention_bwd_ref_equals_autograd_and_jax(groups, d, causal,
                                                         window, s):
    rng = np.random.default_rng(groups * 1000 + d + window)
    b, hk = 2, 2
    h = hk * groups
    q, k, v, do = (_rand(rng, b, s, hh, d) for hh in (h, hk, hk, h))

    def flat(a):        # (B, S, H, D) -> (B*H, S, D)
        return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
            -1, s, d).contiguous()

    def unflat(t, hh):  # (B*H, S, D) -> (B, S, H, D)
        return t.detach().reshape(b, hh, s, d).permute(0, 2, 1, 3).numpy()

    qf, kf, vf, dof = (flat(a) for a in (q, k, v, do))
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    closed = ops.flash_attention_bwd_ref(qf, kf, vf, out, dof,
                                         causal=causal, window=window)
    # the operator's gradient (the plain version on the CPU)
    reqs = [t.clone().requires_grad_() for t in (qf, kf, vf)]
    got = torch.autograd.grad(
        ops.flash_attention(*reqs, causal=causal, window=window), reqs, dof)
    # autograd through the plain forward
    reqs = [t.clone().requires_grad_() for t in (qf, kf, vf)]
    auto = torch.autograd.grad(
        flash_attention_ref(*reqs, causal=causal, window=window), reqs, dof)
    for c, g, a in zip(closed, got, auto):
        _close(c, a.numpy(), FLASH)
        _close(g, a.numpy(), FLASH)
    ref, chunked = _jax_vjps(q, k, v, do, causal, window)
    for c, r, ch, hh in zip(closed, ref, chunked, (h, hk, hk)):
        _close(torch.from_numpy(unflat(c, hh)), r, FLASH)
        _close(torch.from_numpy(unflat(c, hh)), ch, FLASH)


def test_flash_attention_gradient_refuses_a_query_start():
    q = torch.zeros((2, 4, 16), requires_grad=True)
    k = torch.zeros((2, 8, 16))
    start = torch.tensor([4], dtype=torch.int32)
    out = ops.flash_attention(q, k, k, q_start=start)
    with pytest.raises(NotImplementedError, match="q_start"):
        out.sum().backward()


def test_backward_fakes_give_the_shapes_and_the_wrapper_checks():
    meta = torch.device("meta")
    q = torch.empty((8, 32, 128), device=meta)
    k = torch.empty((4, 32, 128), device=meta)
    dq, dk, dv = ops.flash_attention_bwd(q, k, k, q, q, causal=True,
                                         window=0)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.device == meta
    # autograd on meta reaches both gradients' fakes
    qr = q.clone().requires_grad_()
    w = torch.empty((128, 64), device=meta, requires_grad=True)
    out = ops.flash_attention(qr, k, k)
    y = ops.matmul(out.reshape(-1, 128), w)
    gq, gw = torch.autograd.grad(y.sum(), (qr, w))
    assert gq.shape == q.shape and gw.shape == w.shape
    with pytest.raises(ValueError, match="shaped as q"):
        ops.flash_attention_bwd(q, k, k, k, q)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention_bwd(q, k, k, q.bfloat16(), q)


def test_backward_shared_memory_fits_the_card():
    """The dK/dV pass's tiles at every head dim fit a block's opt-in
    shared memory (227 KB), D 256 included (gemma3)."""
    for d in (16, 32, 64, 128, 256):
        got = bwd_smem_bytes(d)
        assert got == 4 * (4 * 32 * (d + 1) + 2 * 32 * 33 + 64)
        assert got <= 232448
    assert bwd_smem_bytes(256) > 48 * 1024       # needs the opt-in


# ---------------------------------------------------------------------------
# K1's backward: the route and the wgmma route's tiles, as the card runs them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_backward_route_takes_the_tensor_cores_at_bf16_128_and_256(dtype, d):
    want = "bwd_wgmma" if dtype == torch.bfloat16 and d in (128, 256) \
        else "bwd_simt"
    assert bwd_route(dtype, d) == want


@pytest.mark.parametrize("d", [128, 256])
def test_backward_wgmma_shared_memory_fits_one_block(d):
    """Each wgmma pass's tiles, its pass-2 rows of L and D, its barriers
    and the swizzle's alignment fit one block (227 KB) at both head dims;
    the C entry ``repro_flash_attention_bwd_wgmma_smem`` returns the same
    figures on the card (chip_smoke.py phase 2)."""
    tile = 64 * d * 2
    want = {"stats": 3 * tile + 40 + 1024,
            "dkdv": 6 * tile + 2 * 2 * 64 * 4 + 40 + 1024,
            "dq": 6 * tile + 40 + 1024}
    for kernel, n in want.items():
        assert bwd_wgmma_smem_bytes(d, kernel) == n
        assert n <= 232448
    assert bwd_wgmma_smem_bytes(d) == want["dkdv"] == max(want.values())
    with pytest.raises(ValueError, match="kernel"):
        bwd_wgmma_smem_bytes(d, "dv")


def _key_tiles(qt: int, sq: int, sk: int, causal: bool, window: int,
               tile: int) -> range:
    """The key tiles query tile ``qt`` sees (``fa_bwd::tc::key_tiles``)."""
    off = sk - sq
    q_lo, q_hi = off + qt * tile, off + min(qt * tile + tile, sq) - 1
    lo, hi = 0, sk
    if causal:
        hi = min(sk, q_hi + 1)
    if window > 0:
        lo = max(0, q_lo - window + 1)
    return range(lo // tile, -(-hi // tile) if lo < hi else lo // tile)


def _query_tiles(kt: int, sq: int, sk: int, causal: bool, window: int,
                 tile: int) -> range:
    """The query tiles that see any key of key tile ``kt``
    (``fa_bwd::tc::query_tiles``)."""
    off = sk - sq
    k0, k_hi = kt * tile, min(kt * tile + tile, sk) - 1
    lo, hi = 0, sq
    if causal:
        lo = max(0, k0 - off)
    if window > 0:
        hi = min(sq, k_hi + window - off)
    return range(lo // tile, -(-hi // tile) if lo < hi else lo // tile)


def bwd_tile_pairs(sq: int, sk: int, causal: bool, window: int,
                   tile: int = 64) -> dict:
    """The (query tile, key tile) pairs each pass of the backward's wgmma
    route visits for one query head, in its order: blocks by tile, then
    each block's walk ("stats" and "dq": a query tile's key tiles,
    ascending; "dkdv": a key tile's query tiles, ascending, which a block
    walks once for each of its G query heads).  A copy of the kernels'
    walk; on the card ``chip_smoke.py``'s phase 30 (a) holds the kernels
    themselves on ragged and windowed calls."""
    nq, nk = -(-sq // tile), -(-sk // tile)
    by_query = [(qt, kt) for qt in range(nq)
                for kt in _key_tiles(qt, sq, sk, causal, window, tile)]
    by_key = [(qt, kt) for kt in range(nk)
              for qt in _query_tiles(kt, sq, sk, causal, window, tile)]
    return {"stats": by_query, "dkdv": by_key, "dq": list(by_query)}


TILE_CASES = [  # (Sq, Sk, causal, window)
    (256, 256, True, 0), (1024, 1024, True, 512), (200, 456, True, 0),
    (200, 456, True, 100), (130, 130, True, 64), (1, 300, True, 0),
    (65, 129, True, 30), (3, 500, True, 7), (77, 77, False, 0),
    (100, 300, False, 0), (100, 200, False, 50)]


@pytest.mark.parametrize("sq,sk,causal,window", TILE_CASES)
def test_backward_tile_schedule_visits_each_visible_pair_once(sq, sk, causal,
                                                              window):
    """Each pass of the wgmma route visits every tile pair that holds a
    visible (query, key) pair exactly once, and no tile pair the masks
    cover whole: so every visible pair is summed once, in one tile pair.
    Queries right-aligned against the keys, ragged edges and Sq < Sk."""
    tile = 64
    q_pos = np.arange(sq)[:, None] + sk - sq
    k_pos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    qi, ki = np.nonzero(mask)
    want = set(zip((qi // tile).tolist(), (ki // tile).tolist()))
    pairs = bwd_tile_pairs(sq, sk, causal, window, tile)
    for name, got in pairs.items():
        assert len(got) == len(set(got)), name
        assert set(got) == want, name
    # blocks by tile, each walking its tiles in ascending order
    assert pairs["stats"] == pairs["dq"] == sorted(want)
    assert pairs["dkdv"] == sorted(want, key=lambda p: (p[1], p[0]))
