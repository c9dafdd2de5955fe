"""The port's cost model: FLOP and byte counts on ``meta`` tensors
(``repro_torch.launch.cost``), the H100 roofline terms
(``launch.roofline``), the serving programs' dry runs (``launch.dryrun``)
and the registry's cell layer (``models.registry``), against the
reference's where it has a counterpart: the cases of
``tests/test_dryrun.py``'s serving half, the JAX count of ``decode``, and
``param_counts`` / ``model_flops`` of all ten archs at full width."""
import math

import pytest
import torch

from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.dryrun import lower_serve_programs as jlower
from repro.models import registry as jregistry
from repro_torch import steps
from repro_torch.engine_config import EngineConfig, HorizonConfig, SpecConfig
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost import count
from repro_torch.launch.dryrun import (input_specs, lower_serve_programs,
                                       out_shapes)
from repro_torch.models import registry, transformer

ARCH = "qwen3-0.6b"
HORIZON = 8
SPEC_K = 3
META = torch.device("meta")

# one config yields four of the five serving programs; the whole-batch
# ``prefill`` is built only under group_prefill, which speculation refuses
SPEC_HORIZON = EngineConfig(batch=4, max_len=64, prefill_len=16,
                            spec=SpecConfig(k=SPEC_K),
                            horizon=HorizonConfig(length=HORIZON))
BURST = EngineConfig(batch=4, max_len=64, prefill_len=16,
                     group_prefill=True)


@pytest.fixture(scope="module")
def serve_counted():
    return {"spec_horizon": lower_serve_programs(ARCH, SPEC_HORIZON),
            "burst": lower_serve_programs(ARCH, BURST)}


def test_serve_counts_build_all_five_programs(serve_counted):
    recs = {**serve_counted["spec_horizon"], **serve_counted["burst"]}
    assert set(serve_counted["spec_horizon"]) == {
        "prefill_slot", "decode", "verify", "decode_horizon"}
    assert set(recs) == {"prefill", "prefill_slot", "decode", "verify",
                         "decode_horizon"}
    for name, rec in recs.items():
        assert rec["count_s"] >= 0, name
        assert rec["memory"]["argument_bytes"] > 0, name
        assert rec["memory"]["output_bytes"] > 0, name
        assert rec["memory"]["temp_bytes"] is None, name
        assert rec["cost"].flops > 0 and rec["cost"].bytes_ideal > 0, name


@pytest.mark.parametrize("which,config", [("spec_horizon", SPEC_HORIZON),
                                          ("burst", BURST)])
def test_serve_counts_shapes_match_the_eager_programs(serve_counted, which,
                                                      config):
    """out_shape is the output tree of the real programs run eagerly on
    the CPU on live trees: the count and the engine agree on every
    program's outputs."""
    cfg = registry.get_config(ARCH, reduced=True)
    params = transformer.init_params(cfg, 0)
    caches = transformer.init_cache(cfg, config.batch, config.max_len,
                                    ring=config.spec is None)
    specs = steps.serve_program_specs(cfg, config, params, caches)
    recs = serve_counted[which]
    assert set(specs) == set(recs)
    for name, spec in specs.items():
        out = spec.fn(*spec.resident, *spec.inputs)
        assert recs[name]["out_shape"] == out_shapes(out), name


def test_serve_counts_subset_filter():
    recs = lower_serve_programs(ARCH, SPEC_HORIZON, programs=["decode"])
    assert set(recs) == {"decode"}


def test_flops_follow_the_loops(serve_counted):
    """A horizon of H steps is H eager ``decode_step`` calls, so it counts
    exactly H x ``decode``'s FLOPs; verify scores k+1 tokens."""
    recs = serve_counted["spec_horizon"]
    decode = recs["decode"]["cost"]
    horizon = recs["decode_horizon"]["cost"]
    verify = recs["verify"]["cost"]
    assert horizon.flops == HORIZON * decode.flops
    assert verify.flops == pytest.approx((SPEC_K + 1) * decode.flops,
                                         rel=0.25)
    assert decode.bytes_ideal > 0
    assert horizon.bytes_ideal == pytest.approx(
        HORIZON * decode.bytes_ideal, rel=0.25)


def test_decode_flops_match_analytic_estimate(serve_counted):
    """A decode step is ~2 FLOPs per weight per batched token; the count
    lands in that band (attention adds, nothing removes)."""
    cfg = registry.get_config(ARCH, reduced=True)

    def n(tree):
        return sum(n(v) for v in tree.values()) if isinstance(tree, dict) \
            else math.prod(tree.shape)
    analytic = 2.0 * n(transformer.abstract_params(cfg)) * SPEC_HORIZON.batch
    assert analytic < serve_counted["spec_horizon"]["decode"]["cost"].flops \
        < 3.0 * analytic


def test_decode_flops_match_the_jax_count():
    """The port's counted ``decode`` against the reference's loop-aware
    HLO count of its compiled ``decode``: within 5%."""
    want = jlower(ARCH, JEngineConfig(batch=4, max_len=64, prefill_len=16),
                  programs=["decode"])["decode"]["cost"].flops
    got = lower_serve_programs(ARCH, EngineConfig(
        batch=4, max_len=64, prefill_len=16),
        programs=["decode"])["decode"]["cost"].flops
    assert got == pytest.approx(want, rel=0.05)


def test_roofline_terms_on_serve_costs(serve_counted):
    recs = serve_counted["spec_horizon"]
    dtype = registry.get_config(ARCH, reduced=True).dtype
    for name in ("decode", "decode_horizon"):
        cost = recs[name]["cost"]
        terms = rl.roofline_terms(cost.flops, cost.bytes_ideal, 0.0,
                                  dtype=dtype)
        assert terms["compute_s"] > 0 and terms["memory_s"] > 0, name
        assert terms["dominant"] in ("compute", "memory")
        assert terms["collective_s"] == 0.0
        assert terms["compute_s"] == cost.flops / 67e12
        assert terms["memory_s"] == cost.bytes_ideal / 3.35e12
    bf16 = rl.roofline_terms(989e12, 3.35e12, 0.0)
    assert (bf16["compute_s"], bf16["memory_s"]) == (1.0, 1.0)
    with pytest.raises(NotImplementedError, match="item 13"):
        rl.roofline_terms(1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# the operators' costs
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device=META)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_kernel_formulas_and_bytes():
    """K1-K5 through their custom operators' fakes: the FLOPs of the
    module docstring, each input read and each output written once."""
    x, w = _meta(5, 64), _meta(64, 96)
    cost, out = count(ops.matmul, x, w)
    assert cost.flops == 2 * 5 * 96 * 64
    assert cost.bytes_ideal == _nbytes(x, w, out)
    assert set(cost.by_op) == {"repro_torch::matmul"}

    q, k, v = _meta(8, 16, 128), _meta(4, 40, 128), _meta(4, 40, 128)
    cost, out = count(lambda *a: ops.flash_attention(*a, causal=True),
                      q, k, v)
    assert cost.flops == 4 * 8 * 16 * 40 * 128
    assert cost.bytes_ideal == _nbytes(q, k, v, out)

    buf, w1, w3, w2 = (_meta(6, 4, 64), _meta(6, 64, 32), _meta(6, 64, 32),
                       _meta(6, 32, 64))
    cost, out = count(ops.moe_ffn, buf, w1, w3, w2)
    assert cost.flops == 6 * 6 * 4 * 64 * 32
    assert cost.bytes_ideal == _nbytes(buf, w1, w3, w2, out)

    bsz, s, h, p, n, chunk = 2, 48, 3, 16, 8, 16
    xs = _meta(bsz, s, h, p, dtype=torch.float32)
    dt = _meta(bsz, s, h, dtype=torch.float32)
    a = _meta(h, dtype=torch.float32)
    b, c = (_meta(bsz, s, n, dtype=torch.float32) for _ in range(2))
    cost, (y, hf) = count(lambda *t: ops.ssd_scan(*t, chunk=chunk),
                          xs, dt, a, b, c)
    assert cost.flops == bsz * h * (s // chunk) * (
        2 * chunk * chunk * (n + p) + 4 * chunk * n * p)
    assert cost.bytes_ideal == _nbytes(xs, dt, a, b, c, y, hf)

    ra, rb = (_meta(2, 7, 40, dtype=torch.float32) for _ in range(2))
    cost, (hh, hfin) = count(ops.rglru_scan, ra, rb)
    assert cost.flops == 2 * 2 * 7 * 40
    assert cost.bytes_ideal == _nbytes(ra, rb, hh, hfin)

    # K1's gradient: five products over every (query, key) pair
    o, do = _meta(8, 40, 128), _meta(8, 40, 128)
    kk, vv = _meta(4, 40, 128), _meta(4, 40, 128)
    cost, grads = count(lambda *a: ops.flash_attention_bwd(*a, causal=True,
                                                           window=8),
                        o, kk, vv, o, do)
    assert cost.flops == 10 * 8 * 40 * 40 * 128
    assert cost.bytes_ideal == _nbytes(o, kk, vv, o, do, *grads)
    assert set(cost.by_op) == {"repro_torch::flash_attention_bwd"}


def test_moe_gradient_counts_sixteen_e_c_d_f():
    """K3's gradient through its operator's fake: 16·E·C·d·f (the
    recompute 4, dH 2, dX 4, the weight gradients 6), each input read and
    each output written once."""
    buf, w1, w3, w2, dy = (_meta(6, 4, 64), _meta(6, 64, 32),
                           _meta(6, 64, 32), _meta(6, 32, 64),
                           _meta(6, 4, 64))
    cost, grads = count(ops.moe_ffn_bwd, buf, w1, w3, w2, dy)
    assert cost.flops == 16 * 6 * 4 * 64 * 32
    assert cost.bytes_ideal == _nbytes(buf, w1, w3, w2, dy, *grads)
    assert set(cost.by_op) == {"repro_torch::moe_ffn_bwd"}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-30b-a3b"])
def test_moe_train_cell_counts_k3_and_its_gradient(arch):
    """An MoE train cell is counted through its train program: under remat
    "nothing" K3 runs twice a layer (forward and recompute) and its
    gradient once, at 16/6 of a forward call's FLOPs."""
    spec = registry.cell_spec(arch, "train_4k", reduced=True)
    assert spec.kind == "train" and spec.cfg.remat_policy == "nothing"
    cost, _ = count(registry.build_step_fn(spec), *spec.abstract_args)
    fwd = cost.by_op["repro_torch::moe_ffn"]
    bwd = cost.by_op["repro_torch::moe_ffn_bwd"]
    n = spec.cfg.n_layers
    assert (fwd["calls"], bwd["calls"]) == (2 * n, n)
    assert bwd["flops"] * 6 == fwd["flops"] / 2 * 16


def test_rglru_gradient_counts_three_b_s_l():
    """K5's gradient through its operator's fake: 3·B·S·L (the adjoint's
    product and sum, and da's product), each input read and each output
    written once."""
    a, h, dh = (_meta(2, 7, 40, dtype=torch.float32) for _ in range(3))
    h0, dhf = (_meta(2, 40, dtype=torch.float32) for _ in range(2))
    cost, grads = count(ops.rglru_scan_bwd, a, h, h0, dh, dhf)
    assert cost.flops == 3 * 2 * 7 * 40
    assert cost.bytes_ideal == _nbytes(a, h, h0, dh, dhf, *grads)
    assert set(cost.by_op) == {"repro_torch::rglru_scan_bwd"}


def test_hybrid_train_cell_counts_k5_and_its_gradient():
    """recurrentgemma-2b's train cell is counted through its train
    program: under remat "nothing" K5 runs twice for each "R" layer of the
    stacked groups (forward and recompute) and once for each of the
    tail's, and its gradient once for every "R" layer, at 3/2 of a forward
    call's FLOPs."""
    spec = registry.cell_spec("recurrentgemma-2b", "train_4k", reduced=True)
    assert spec.kind == "train" and spec.cfg.remat_policy == "nothing"
    cost, _ = count(registry.build_step_fn(spec), *spec.abstract_args)
    unit, groups, tail = transformer.split_layers(spec.cfg)
    in_groups, in_tail = groups * unit.count("R"), tail.count("R")
    fwd = cost.by_op["repro_torch::rglru_scan"]
    bwd = cost.by_op["repro_torch::rglru_scan_bwd"]
    assert (fwd["calls"], bwd["calls"]) == (2 * in_groups + in_tail,
                                           in_groups + in_tail)
    assert bwd["flops"] / bwd["calls"] == \
        1.5 * fwd["flops"] / fwd["calls"]


@pytest.mark.parametrize("remat,recomputed,fa_recomputed", [
    ("full", 0, 0), ("nothing", 1, 1), ("dots", 0, 1)])
def test_train_cell_counts_three_times_the_forward_products(
        remat, recomputed, fa_recomputed):
    """A dense train cell counts K2's FLOPs at 3x the training forward's
    (forward, dX, dW), plus one more forward of every layer group that
    its remat policy recomputes (``nothing``; ``dots`` keeps K2's outputs
    and recomputes K1); K1 counts its forward (and recompute) and one
    backward a layer at 10/4 of a forward's FLOPs."""
    spec = registry.cell_spec(ARCH, "train_4k", reduced=True, remat=remat)
    cfg = spec.cfg
    state, tokens = spec.abstract_args[0], spec.abstract_args[1]
    cost, _ = count(registry.build_step_fn(spec), *spec.abstract_args)

    def forward(params, tokens):
        return transformer.forward(cfg, params, tokens, mode="train")[0]

    with torch.no_grad():
        fwd, _ = count(forward, state["params"], tokens)
    mm, fa = "repro_torch::matmul", "repro_torch::flash_attention"
    d, v = cfg.d_model, cfg.padded_vocab
    head = 2 * tokens.numel() * d * v
    layers_mm = fwd.by_op[mm]["flops"] - head
    assert cost.by_op[mm]["flops"] == 3 * head + (3 + recomputed) * layers_mm
    assert cost.by_op[mm]["calls"] == (3 + recomputed) * (
        fwd.by_op[mm]["calls"] - 1) + 3
    assert cost.by_op[fa]["flops"] == \
        (1 + fa_recomputed) * fwd.by_op[fa]["flops"]
    assert cost.by_op["repro_torch::flash_attention_bwd"]["flops"] == \
        2.5 * fwd.by_op[fa]["flops"]
    assert spec.kind == "train" and spec.donate_argnums == (0,)
    assert (spec.seq_len, spec.global_batch) == (64, 4)


def test_bytes_of_writes_gathers_and_elementwise_ops():
    cache, upd = _meta(4, 32, 16), _meta(4, 2, 16)
    idx = torch.zeros((2,), dtype=torch.long, device=META)

    def write(cache, upd, idx):
        cache.index_copy_(1, idx, upd)       # a cache write: 2x the update
        cache[:, 3:5].copy_(upd)             # a copy into a slice: the same
        return cache

    cost, _ = count(write, cache, upd, idx)
    assert cost.bytes_ideal == 2 * 2 * _nbytes(upd)
    assert cost.flops == 0

    def gather(cache, idx):
        return (cache[:, idx] * 2.0 + 1.0).exp()    # elementwise: free

    cost, out = count(gather, cache, idx)
    assert cost.bytes_ideal == 2 * _nbytes(out)
    assert set(cost.by_op) == {"aten::index"}

    a, bm = _meta(3, 5, 7), _meta(3, 7, 2)
    cost, out = count(torch.bmm, a, bm)
    assert cost.flops == 2 * 3 * 5 * 2 * 7
    assert cost.bytes_ideal == _nbytes(a, bm, out)


@pytest.mark.parametrize("arch,kernel", [
    ("olmoe-1b-7b", "repro_torch::moe_ffn"),
    ("mamba2-130m", "repro_torch::ssd_scan"),
    ("recurrentgemma-2b", "repro_torch::rglru_scan")])
def test_other_families_count_through_their_kernels(arch, kernel):
    cfg = EngineConfig(batch=2, max_len=64, prefill_len=16)
    rec = lower_serve_programs(arch, cfg, programs=["prefill_slot"])
    assert rec["prefill_slot"]["cost"].by_op[kernel]["calls"] >= 1


def test_counting_touches_nothing():
    """A count runs the kernels' fakes: no launch counter moves, and a
    tensor off the ``meta`` device is refused."""
    launches, routes = ops.launch_counts(), ops.route_counts()
    lower_serve_programs(ARCH, SPEC_HORIZON)
    count(ops.matmul, _meta(4, 64), _meta(64, 64))
    assert ops.launch_counts() == launches
    assert ops.route_counts() == routes
    with pytest.raises(ValueError, match="meta"):
        count(ops.matmul, torch.zeros(4, 64), torch.zeros(64, 64))


# ---------------------------------------------------------------------------
# the registry's cell layer
# ---------------------------------------------------------------------------
def test_registry_tables_equal_the_reference():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.SHAPES == jregistry.SHAPES
    assert registry.all_cells() == jregistry.all_cells()
    assert registry.all_cells(include_skipped=True) == \
        jregistry.all_cells(include_skipped=True)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert registry.param_counts(cfg) == jregistry.param_counts(jcfg)
    for shape in registry.SHAPES:
        assert registry.model_flops(cfg, shape) == \
            jregistry.model_flops(jcfg, shape), shape
        assert (registry.cell_skip_reason(cfg, shape) is None) == \
            (jregistry.cell_skip_reason(jcfg, shape) is None), shape


def test_cell_spec_builds_every_cell_on_meta():
    """Every cell of the matrix at full width, nothing allocated; the
    training cells of the dense family hold the train state and the batch,
    the other families' wait for item 14b."""
    for arch, shape in registry.all_cells():
        if registry.SHAPES[shape][2] == "train" and \
                steps.train_unsupported(registry.get_config(arch)):
            with pytest.raises(NotImplementedError, match="item 14b"):
                registry.cell_spec(arch, shape)
            continue
        spec = registry.cell_spec(arch, shape)
        args = spec.abstract_args if spec.kind == "train" else \
            input_specs(arch, shape)
        leaves = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            else:
                leaves.append(t)
        for a in args:
            walk(a)
        assert all(t.device == META for t in leaves), (arch, shape)
        assert spec.seq_len == registry.SHAPES[shape][0]
        assert spec.global_batch == registry.SHAPES[shape][1]
        assert registry.build_step_fn(spec) is not None
