"""K2's split of K and its TMA rule, on the CPU.

The bf16 kernel's plan (``kernels/matmul.py:plan``) must be a function of
(K, N, dtype) alone, so that a row of a product has the same bits whatever
M is; its segments must cover K in whole slabs, in order; at the decode
shapes of the served configurations it must give the card enough blocks.
Every weight the served paths hand K2, and every head view, must suit TMA,
checked from the configs' shapes with no tensor allocated.  The kernel
itself runs on the card only (``chip_smoke.py`` phases 2-3).
"""
import inspect

import pytest
import torch

from repro_torch.kernels import matmul as mm
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.layers import Leaf

FULL = registry.PORTED_ARCHS
# the leaves layers.linear and the MoE router hand K2 as (K, N) weights
K2_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
             "w_out", "w_x", "router", "lm_head"}
# 2-D leaves that are not products: the depthwise conv taps
NOT_K2 = {"conv_w"}


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, Leaf):
            yield path + (key,), value
        else:
            yield from _leaves(value, path + (key,))


def _k2_operands(arch):
    """(name, shape, strides, byte offset) of every weight K2 reads on the
    path of ``arch`` at full width: each 2-D leaf of a layer (the second
    layer of a stack, so the slice's offset is checked too) and the head.
    The encoder-decoder's stacks are ``enc`` and ``dec``."""
    cfg = registry.get_config(arch, reduced=False)
    itemsize = torch.tensor([], dtype=transformer.torch_dtype(
        cfg.dtype)).element_size()
    model = encdec if cfg.is_encdec else transformer
    params = model.abstract_params(cfg)
    out = []
    for path, leaf in _leaves(params):
        stacked = path[0] in ("groups", "enc", "dec")
        shape = leaf.shape[1:] if stacked else leaf.shape
        if path[-1] == "embed":
            if cfg.tie_embeddings:      # read in place as (d, V)
                v, d = shape
                out.append(("embed.t()", (d, v), (1, d), 0))
            continue
        if len(shape) != 2 or leaf.dtype is not None:
            continue
        assert path[-1] in K2_LEAVES | NOT_K2, path
        if path[-1] in NOT_K2:
            continue
        k, n = shape
        offset = k * n * itemsize if stacked and leaf.shape[0] > 1 else 0
        out.append(("/".join(path), (k, n), (n, 1), offset))
    return itemsize, out


def test_plan_takes_no_m():
    assert list(inspect.signature(mm.plan).parameters) == ["k", "n", "dtype"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(1024, 1024), (2560, 256), (768, 3352),
                                 (2048, 64), (104, 72), (1000, 200),
                                 (64, 64), (8, 8), (7680, 2560),
                                 (1024, 153600), (2560, 256000)])
def test_segments_cover_k_in_whole_slabs_in_order(k, n, dtype):
    p = mm.plan(k, n, dtype)
    assert p.slabs * p.tile_k >= k > (p.slabs - 1) * p.tile_k
    assert len(p.bounds) == p.segments + 1
    assert p.bounds[0] == 0 and p.bounds[-1] == p.slabs
    lengths = [b - a for a, b in zip(p.bounds, p.bounds[1:])]
    assert all(length >= 1 for length in lengths)
    # the kernel computes segment s as [s * slabs // S, (s + 1) * slabs // S)
    assert p.bounds == tuple(s * p.slabs // p.segments
                             for s in range(p.segments + 1))
    if dtype == torch.bfloat16:
        assert (p.tile_k, p.tile_n) == (mm.SLAB, mm.TILE_N)
        if p.segments > 1:
            assert min(lengths) >= mm.MIN_SEG_SLABS
    else:
        assert p.segments == 1       # the fp32 kernel walks all of K


def _served_products(arch):
    """The (K, N) of every K2 product of ``arch``'s serving path."""
    _, ops = _k2_operands(arch)
    return sorted({shape for _, shape, _, _ in ops})


@pytest.mark.parametrize("arch", FULL)
def test_decode_shapes_fill_the_card_where_k_allows(arch):
    for k, n in _served_products(arch):
        p = mm.plan(k, n, torch.bfloat16)
        most = max(1, p.slabs // mm.MIN_SEG_SLABS)   # what K allows
        blocks = -(-n // p.tile_n) * p.segments      # at M <= SMALL_M
        assert blocks >= mm.SMS or p.segments == most, (k, n, p)
        assert p.segments <= most, (k, n, p)


@pytest.mark.parametrize("arch", FULL)
def test_every_m_up_to_64_takes_one_route(arch):
    for k, n in _served_products(arch):
        p = mm.plan(k, n, torch.bfloat16)
        routes = {mm.route(p, m, n) for m in range(1, mm.SMALL_M + 1)}
        assert routes == {(64, p.segments > 1)}, (k, n, routes)
        for m in (65, 200, 256, 1000):
            assert mm.route(p, m, n)[1] is False


@pytest.mark.parametrize("arch", FULL)
def test_tma_rule_holds_for_every_served_weight_and_head(arch):
    itemsize, ops = _k2_operands(arch)
    names = {name.rsplit("/", 1)[-1] for name, _, _, _ in ops}
    assert names & {"embed.t()", "lm_head"}, names    # a head is there
    for name, shape, strides, offset in ops:
        assert mm.tma_error(shape, strides, itemsize, offset) is None, \
            (arch, name, shape, strides, offset)
        assert shape[0] % 8 == 0 and shape[1] % 8 == 0, (arch, name, shape)


def test_tma_rule_rejects_misaligned_layouts():
    assert mm.tma_error((64, 8), (8, 1), 2) is None          # 16-byte rows
    assert mm.tma_error((8, 64), (1, 8), 2) is None          # K-contiguous
    assert "multiple of 16" in mm.tma_error((64, 12), (12, 1), 2)
    assert "multiple of 16" in mm.tma_error((100, 64), (1, 100), 2)
    assert "aligned" in mm.tma_error((64, 8), (8, 1), 2, address=8)
    assert "contiguous" in mm.tma_error((8, 8), (16, 2), 2)
    assert "2-D" in mm.tma_error((2, 8, 8), (64, 8, 1), 2)


def test_tma_operands_raise_on_a_weight_and_copy_an_x_view():
    w_bad = torch.zeros((64, 12), dtype=torch.bfloat16)
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight"):
        mm._tma_operands(x, w_bad)
    w = torch.zeros((64, 16), dtype=torch.bfloat16)
    # a column slice 4 elements in starts 8 bytes off a 16-byte boundary:
    # copied, not refused
    wide = torch.zeros((4, 72), dtype=torch.bfloat16)
    view = wide[:, 4:68]
    assert mm.tma_error(view.shape, view.stride(), 2, view.data_ptr())
    got = mm._tma_operands(view, w)
    assert got.stride() == (64, 1) and torch.equal(got, view)
    # an x whose own row is not a multiple of 16 bytes cannot be copied
    # into shape
    with pytest.raises(ValueError, match="x"):
        mm._tma_operands(torch.zeros((4, 100), dtype=torch.bfloat16),
                         torch.zeros((100, 16), dtype=torch.bfloat16))
