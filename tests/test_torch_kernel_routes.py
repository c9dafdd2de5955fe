"""Which kernel K1 and K3 launch on the card, decided on the CPU.

K1 (``kernels/flash_attention.py:route``) and K3
(``kernels/moe_dispatch.py:route``) pick their route before launch from
the dtype and the shapes alone: every bf16 call of the served attention
and MoE layers must take the wgmma + TMA kernel, fp32 and the odd shapes
``chip_smoke.py`` checks must keep the CUDA-core (SIMT) kernel.  The
wgmma kernels' shared memory must fit one H100 block (232,448 bytes), and
TMA must be able to read every operand those calls hand them.  Shapes come
from the full configurations; no tensor of that size is allocated.  The
kernels themselves run on the card only (``chip_smoke.py`` phases 2, 4, 5
and 8-11).
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import moe_dispatch as k3
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import tma_error
from repro_torch.models import moe, registry

SMEM_LIMIT = 232448          # H100: dynamic shared memory of one block
ATTENTION = ("qwen3-0.6b", "olmoe-1b-7b", "qwen3-moe-30b-a3b",
             "recurrentgemma-2b")
MOE = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
BATCH, PREFILL_LEN = 4, 256  # the served runs (chip_smoke.py)
# chip_smoke.py phase 4's extra head dim and phase 5's odd (E, d, f)
ODD_HEAD_DIMS = (16,)
ODD_MOE = ((3, 96, 80), (2, 33, 17), (5, 40, 24))


def _cfg(arch):
    cfg = registry.get_config(arch, reduced=False)
    assert cfg.dtype == "bfloat16", cfg
    return cfg


def _moe_rows(cfg):
    """Buffer rows C of the served MoE calls: a decode step at batch 4, one
    admission (a prompt padded to 256) and a whole batch's prefill."""
    return sorted({moe._capacity(cfg, BATCH), moe._capacity(cfg, PREFILL_LEN),
                   moe._capacity(cfg, BATCH * PREFILL_LEN)})


def test_routes_are_chosen_from_dtype_and_shape_alone():
    assert list(inspect.signature(k1.route).parameters) == ["dtype", "d"]
    assert list(inspect.signature(k3.route).parameters)[:3] == \
        ["dtype", "d", "f"]
    assert list(inspect.signature(k3.tile_rows).parameters) == ["c"]


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ATTENTION)
def test_served_attention_takes_the_wgmma_route(arch):
    cfg = _cfg(arch)
    d = cfg.resolved_head_dim
    assert k1.route(torch.bfloat16, d) == "wgmma", (arch, d)
    assert k1.route(torch.float32, d) == "simt", (arch, d)


@pytest.mark.parametrize("arch", ATTENTION)
def test_tma_reads_every_served_attention_operand(arch):
    """q (B*H, S, D) and k/v (B*Hkv, S, D), contiguous as
    ``attention.prefill_attention`` hands them over: each head's (S, D)
    matrix, at the offset of every head of a batch-4 admission."""
    cfg = _cfg(arch)
    d = cfg.resolved_head_dim
    for heads in (cfg.n_heads, cfg.n_kv_heads):
        for s in (PREFILL_LEN, 200, 37, 1):
            for head in range(BATCH * heads):
                assert tma_error((s, d), (d, 1), 2, head * s * d * 2) is None


@pytest.mark.parametrize("d", ODD_HEAD_DIMS + (32, 64))
def test_other_head_dims_keep_the_simt_route(d):
    assert k1.route(torch.bfloat16, d) == "simt"
    assert k1.route(torch.float32, d) == "simt"


@pytest.mark.parametrize("d", k1.WGMMA_HEAD_DIMS)
def test_fp32_attention_keeps_the_simt_route(d):
    assert k1.route(torch.float32, d) == "simt"
    assert k1.route(torch.bfloat16, d) == "wgmma"


@pytest.mark.parametrize("d", k1.WGMMA_HEAD_DIMS)
def test_k1_wgmma_shared_memory_fits_one_block(d):
    # Q plus two stages of K and V, 64 rows each in bf16, the barriers and
    # the 1024-byte alignment of the swizzled tiles
    got = k1.wgmma_smem_bytes(d)
    assert got == 5 * 64 * d * 2 + 8 * 7 + 1024
    assert 48 * 1024 < got <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_served_moe_takes_the_wgmma_route(arch):
    cfg = _cfg(arch)
    d, f = cfg.d_model, cfg.d_ff
    assert k3.route(torch.bfloat16, d, f) == "wgmma", (arch, d, f)
    assert k3.route(torch.float32, d, f) == "simt", (arch, d, f)
    for c in _moe_rows(cfg):
        nt = k3.tile_rows(c)
        assert nt in k3.TILE_ROWS
        assert c <= nt or nt == k3.TILE_ROWS[-1], (c, nt)


@pytest.mark.parametrize("arch", MOE)
def test_decode_batches_of_4_and_1_take_one_instruction(arch):
    """The engine decodes at batch 4, its reference at batch 1: both floor
    the capacity at 4, so both run the same n8 instruction."""
    cfg = _cfg(arch)
    assert moe._capacity(cfg, BATCH) == moe._capacity(cfg, 1) == 4
    assert k3.tile_rows(4) == k3.tile_rows(1) == 8


@pytest.mark.parametrize("arch", MOE)
def test_tma_reads_every_served_moe_operand(arch):
    """Each expert's w1/w3 (d, f), w2 (f, d), buffer rows (C, d) and hidden
    rows (C, f), at every expert's offset in its stack."""
    cfg = _cfg(arch)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for c in _moe_rows(cfg):
        for x in range(e):
            for shape, offset in (((d, f), x * d * f), ((f, d), x * f * d),
                                  ((c, d), x * c * d), ((c, f), x * c * f)):
                assert tma_error(shape, (shape[1], 1), 2, offset * 2) is None
    # the second layer's slices of the (L, E, ...) stacks too
    assert k3.route(torch.bfloat16, d, f, [e * d * f * 2]) == "wgmma"


@pytest.mark.parametrize("e,d,f", ODD_MOE)
def test_odd_moe_shapes_keep_the_simt_route(e, d, f):
    assert k3.route(torch.bfloat16, d, f) == "simt"
    assert k3.route(torch.float32, d, f) == "simt"


def test_misaligned_moe_weights_keep_the_simt_route():
    assert k3.route(torch.bfloat16, 2048, 1024, [8]) == "simt"
    assert k3.route(torch.bfloat16, 2048, 1024, [0, 16, 4096]) == "wgmma"


@pytest.mark.parametrize("c,nt", [(1, 8), (4, 8), (8, 8), (9, 16), (16, 16),
                                  (17, 32), (20, 32), (33, 48), (40, 48),
                                  (48, 48), (49, 64), (160, 64)])
def test_tile_rows_is_the_least_that_holds_c(c, nt):
    assert k3.tile_rows(c) == nt


@pytest.mark.parametrize("nt", k3.TILE_ROWS)
@pytest.mark.parametrize("gate_up", [True, False])
def test_k3_wgmma_shared_memory_fits_one_block(gate_up, nt):
    got = k3.wgmma_smem_bytes(gate_up, nt)
    stages = 4 if gate_up else 6
    slab = (2 if gate_up else 1) * 64 * 64 * 2
    assert got == stages * (slab + nt * 128) + nt * 72 * 2 + 16 * stages \
        + 1024
    assert got <= SMEM_LIMIT
    # two blocks an SM at least (the SM's 228 KB, 1 KB reserved a block)
    assert 2 * (got + 1024) <= 228 * 1024


# ---------------------------------------------------------------------------
# K3's backward: its route and the wgmma route's shared memory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,f", [(2048, 1024), (2048, 768), (256, 192),
                                 (64, 64), (200, 136), (96, 80), (2048, 1000),
                                 (2000, 1024)])
def test_k3_backward_takes_the_tensor_cores_at_bf16_multiples_of_64(dtype, d,
                                                                    f):
    want = "bwd_wgmma" if dtype == torch.bfloat16 and d % 64 == 0 and \
        f % 64 == 0 else "bwd_simt"
    assert k3.bwd_route(dtype, d, f) == want
    assert k3.bwd_route(dtype, d, f, [0, 16, 1 << 20]) == want


@pytest.mark.parametrize("address", [2, 8, 1030])
def test_k3_backward_with_a_misaligned_weight_keeps_the_simt_route(address):
    assert k3.bwd_route(torch.bfloat16, 2048, 1024, [256, address, 512]) \
        == "bwd_simt"


@pytest.mark.parametrize("arch", MOE)
def test_trained_moe_backward_takes_the_wgmma_route(arch):
    """Every training call of the two MoE configurations (bf16, d and f
    multiples of 64) runs the backward on the tensor cores."""
    cfg = _cfg(arch)
    assert k3.bwd_route(torch.bfloat16, cfg.d_model, cfg.d_ff) == "bwd_wgmma"
    assert tma_error((cfg.d_model, cfg.d_ff), (cfg.d_ff, 1), 2, 0) is None


@pytest.mark.parametrize("kernel", k3.BWD_WGMMA_PASSES)
def test_k3_backward_wgmma_shared_memory_fits_one_block(kernel):
    """A ring of 3 stages of 64 x 64 bf16 boxes (8 KB): "hidden" holds the
    W1, W3 and W2 slabs and 128 token rows of X and dY (two boxes each), 7
    boxes; "dx" 128 rows of W1, W3, dG and dU, 8; "dw" 64 rows of X and dY
    (one box each) and of H, dG and dU at 128 hidden columns (two each),
    8.  16 bytes of barriers a stage, 1024 to align the swizzled ring.  The
    C entry ``repro_moe_ffn_bwd_wgmma_smem`` returns the same figures on
    the card (chip_smoke.py phase 2).  Each epilogue reuses the ring:
    hidden's three 64 x 128 fp32 fragments and three 128 x 72 bf16 staged
    tiles, dx's 128 x 136, dw's two 64 x 136 and one 128 x 72."""
    box = 64 * 64 * 2
    boxes = {"hidden": 3 + 2 * 2, "dx": 2 * 2 + 2 * 2,
             "dw": 1 + 1 + 3 * 2}[kernel]
    want = 3 * boxes * box + 3 * 16 + 1024
    assert k3.bwd_wgmma_smem_bytes(kernel) == want
    assert want <= SMEM_LIMIT
    epilogue = {"hidden": 3 * 64 * 128 * 4 + 3 * 128 * 72 * 2,
                "dx": 128 * 136 * 2,
                "dw": 2 * 64 * 136 * 2 + 128 * 72 * 2}[kernel]
    assert epilogue <= 3 * boxes * box


def test_k3_backward_shared_memory_names_its_passes():
    assert k3.BWD_WGMMA_PASSES == ("hidden", "dx", "dw")
    with pytest.raises(ValueError, match="kernel"):
        k3.bwd_wgmma_smem_bytes("down")


@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "bwd_wgmma"),
                                        (torch.float32, "bwd_simt")])
def test_cpu_backward_launches_nothing_on_either_route(dtype, kind):
    """A shape whose CUDA call takes ``kind``: on the CPU the operator takes
    the plain version, and no counter moves."""
    e, c, d, f = 2, 8, 64, 64
    rng = np.random.default_rng(3)
    buf, w1, w3, w2, dy = (torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
        for s in ((e, c, d), (e, d, f), (e, d, f), (e, f, d), (e, c, d)))
    assert k3.bwd_route(dtype, d, f) == kind
    ops.reset_launch_counts()
    got = ops.moe_ffn_bwd(buf, w1, w3, w2, dy,
                          torch.tensor([8, 3], dtype=torch.int32))
    assert [t.shape for t in got] == [t.shape for t in (buf, w1, w3, w2)]
    assert ops.launch_counts()["moe_ffn"] == 0
    assert ops.route_counts()["moe_ffn"] == dict.fromkeys(k3.COUNTED, 0)


def test_route_counts_start_at_zero_and_reset():
    ops.reset_launch_counts()
    assert ops.route_counts() == {
        "flash_attention": {"wgmma": 0, "simt": 0, "bwd_wgmma": 0,
                            "bwd_simt": 0},
        "moe_ffn": {"wgmma": 0, "simt": 0, "bwd_wgmma": 0, "bwd_simt": 0},
        "ssd_scan": {"wgmma": 0, "simt": 0},
        "rglru_scan": {"fwd": 0, "bwd": 0}}
    # CPU tensors take the plain versions and launch nothing
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16)
    ops.flash_attention(q, q[:1], q[:1])
    assert ops.route_counts()["flash_attention"] == {
        "wgmma": 0, "simt": 0, "bwd_wgmma": 0, "bwd_simt": 0}
    assert ops.launch_counts()["flash_attention"] == 0
