"""The port's MoE family on the CPU, against the JAX package.

K3's plain version against ``repro.kernels.ref.moe_ffn`` and the Pallas
kernel in interpret mode (tolerances of ``tests/test_kernels.py``: 3e-4
in fp32, 5e-2 in bf16); the MoE layer, its ``aux`` loss, prefill logits
and caches, decode steps, 32 greedy tokens and engine streams of reduced
``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b`` in fp32 against the JAX model
and engine holding the same bridged weights.  Model tolerance rtol/atol
1e-4, as in ``tests/test_torch_models.py``: both sides compute in fp32 but
XLA's and ATen's CPU sums add in different orders.  The routing itself
(top-k choices and capacity drops) must agree exactly, or the outputs
would differ by far more than that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine_config import EngineConfig as JEngineConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
CACHE_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, seed=1):
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _ffn_operands(rng, e, c, d, f):
    return [rng.standard_normal(s) * sc for s, sc in (
        ((e, c, d), 0.3), ((e, d, f), 0.2), ((e, d, f), 0.2),
        ((e, f, d), 0.2))]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_reference(arch):
    for reduced in (False, True):
        j = jregistry.get_config(arch, reduced=reduced)
        t = tregistry.get_config(arch, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
        assert tuple(ttf.abstract_params(t)) == tuple(jtf.abstract_params(j))


# ---------------------------------------------------------------------------
# K3 moe_ffn: plain version and wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f,bc", [
    (4, 64, 32, 48, 32), (8, 128, 64, 32, 64), (2, 128, 128, 128, 128),
    (3, 37, 40, 24, 37)])                      # ragged C, d and f
def test_moe_ffn_ref_matches_reference_and_interpret_kernel(e, c, d, f, bc):
    ops_in = _ffn_operands(np.random.default_rng(e * 100 + c), e, c, d, f)
    got = ops.moe_ffn_ref(*(torch.from_numpy(a).float() for a in ops_in))
    jin = [jnp.asarray(a, jnp.float32) for a in ops_in]
    tol = KERNEL_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.moe_ffn(*jin)),
                               rtol=tol, atol=tol)
    kern = jops.moe_ffn(*jin, impl="interpret", block_c=bc)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=tol,
                               atol=tol)


def test_moe_ffn_ref_bf16_rounds_the_hidden_like_the_kernel():
    ops_in = _ffn_operands(np.random.default_rng(11), 2, 64, 32, 32)
    got = ops.moe_ffn(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in ops_in))
    assert got.dtype == torch.bfloat16
    kern = jops.moe_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in ops_in),
                        impl="interpret")
    tol = KERNEL_TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern, np.float32), rtol=tol,
                               atol=tol)


def test_moe_ffn_counts_zero_the_rows_past_each_expert():
    ops_in = [torch.from_numpy(a).float() for a in _ffn_operands(
        np.random.default_rng(12), 3, 5, 16, 8)]
    counts = torch.tensor([0, 5, 2], dtype=torch.int32)
    full = ops.moe_ffn(*ops_in)
    got = ops.moe_ffn(*ops_in, counts)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.equal(got[1], full[1])
    assert torch.equal(got[2, :2], full[2, :2])
    assert torch.count_nonzero(got[2, 2:]) == 0


def test_moe_ffn_sends_cpu_tensors_to_plain_version_and_rejects_bad_input():
    ops.reset_launch_counts()
    buf, w1, w3, w2 = (torch.from_numpy(a).float() for a in _ffn_operands(
        np.random.default_rng(13), 2, 4, 8, 6))
    assert torch.equal(ops.moe_ffn(buf, w1, w3, w2),
                       ops.moe_ffn_ref(buf, w1, w3, w2))
    assert ops.launch_counts()["moe_ffn"] == 0
    with pytest.raises(TypeError, match="one dtype"):
        ops.moe_ffn(buf, w1.to(torch.bfloat16), w3, w2)
    with pytest.raises(ValueError, match="ranks"):
        ops.moe_ffn(buf[0], w1, w3, w2)
    with pytest.raises(ValueError, match="E, d or f"):
        ops.moe_ffn(buf, w1, w3[:, :, :5], w2)
    with pytest.raises(ValueError, match="E, d or f"):
        ops.moe_ffn(buf[:1], w1, w3, w2)
    with pytest.raises(ValueError, match="E, d or f"):
        ops.moe_ffn(buf, w1, w3, w2.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_ffn(buf, w1, w3.transpose(1, 2).contiguous().transpose(1, 2),
                    w2)
    with pytest.raises(ValueError, match="counts"):
        ops.moe_ffn(buf, w1, w3, w2, torch.tensor([1, 2]))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_and_aux_match_reference_with_capacity_drops(arch):
    # capacity factor 0.5: capacity = max(4, int(0.5 * 2 * 64 / 8)) = 8 of
    # the 16 choices an expert gets on average, so tokens are dropped
    jcfg = jregistry.get_config(arch, reduced=True).replace(
        capacity_factor=0.5)
    tcfg = tregistry.get_config(arch, reduced=True).replace(
        capacity_factor=0.5)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    layer = jax.tree.map(lambda a: np.array(a[0]),
                         jparams["groups"]["slot0"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.apply_moe(jcfg, jax.tree.map(jnp.asarray, layer),
                                jnp.asarray(x), RULES)
    tp = {k: torch.from_numpy(v) for k, v in layer.items()}
    tout, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the drops happened: some expert was chosen more often than capacity
    logits = x.reshape(-1, jcfg.d_model) @ layer["router"]
    top = np.argsort(-logits, axis=-1)[:, :jcfg.experts_per_token]
    per_expert = np.bincount(top.ravel(), minlength=jcfg.n_experts)
    assert tmoe._capacity(tcfg, 64) == 8 and per_expert.max() > 8


def test_capacity_truncates_like_the_reference():
    cfg = tregistry.get_config("olmoe-1b-7b")
    jcfg = jregistry.get_config("olmoe-1b-7b")
    for t in (1, 4, 8, 25, 26, 256, 1000):
        assert tmoe._capacity(cfg, t) == jmoe._capacity(jcfg, t)
    assert tmoe._capacity(cfg, 4) == 4 and tmoe._capacity(cfg, 256) == 40


def test_moe_expert_weights_are_drawn_like_the_reference():
    cfg = tregistry.get_config("olmoe-1b-7b", reduced=True)
    moe = ttf.init_params(cfg, 0)["groups"]["slot0"]["moe"]
    assert tuple(moe["w_gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                          cfg.d_model, cfg.d_ff)
    for name, fan_in in (("w_gate", cfg.d_model), ("w_up", cfg.d_model),
                         ("w_down", cfg.d_ff), ("router", cfg.d_model)):
        w = moe[name]
        np.testing.assert_allclose(float(w.std()), fan_in ** -0.5,
                                   rtol=0.1)
        # mean zero within four standard errors
        assert abs(float(w.mean())) < 4 * fan_in ** -0.5 / w.numel() ** 0.5
    # every layer and expert slice is drawn anew
    assert not torch.equal(moe["w_gate"][0, 0], moe["w_gate"][1, 0])
    assert not torch.equal(moe["w_gate"][0, 0], moe["w_gate"][0, 1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_exact_for_moe_archs(arch, dtype):
    """``lm_head`` and ``groups/slot0/moe/*`` travel both ways bit-exact."""
    cfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jdt = jnp.dtype(dtype)
    params = _np(jax.tree.map(lambda x: x.astype(jdt),
                              jtf.init_params(cfg, jax.random.PRNGKey(0))))
    assert "lm_head" in params and "moe" in params["groups"]["slot0"]
    back = bridge.to_numpy(bridge.params_from_numpy(params, tcfg, "cpu"))
    flat_in = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        got = flat_out[path]
        assert got.shape == leaf.shape, path
        assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path


# ---------------------------------------------------------------------------
# the model: prefill, decode, greedy tokens
# ---------------------------------------------------------------------------
def _prefill_both(jcfg, tcfg, jparams, tparams, tokens, lengths):
    b = tokens.shape[0]
    jlog, jcache, _ = jtf.forward(
        jcfg, jparams, jnp.asarray(tokens), rules=RULES, mode="prefill",
        caches=jtf.init_cache(jcfg, b, CACHE_LEN),
        lengths=jnp.asarray(lengths))
    tlog, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(tokens), mode="prefill",
        caches=ttf.init_cache(tcfg, b, CACHE_LEN),
        lengths=torch.from_numpy(lengths))
    return jlog, jcache, tlog, tcache


def _assert_cache_close(jcache, tcache):
    want = _np(jcache)
    got = bridge.cache_to_numpy(tcache)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["groups"]["slot0"][leaf],
                                   want["groups"]["slot0"][leaf], **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    tokens[1, 7:] = 0                                    # right padding
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               tokens, lengths)
    assert tlog.shape == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_cache_close(jcache, tcache)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t,
                                                    rules=RULES))
    for _ in range(6):
        tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_cache_close(jcache, tcache)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_32_greedy_tokens_equal_reference(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=5)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (1, 9)).astype(np.int32)
    lengths = np.asarray([9], np.int32)
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               tokens, lengths)
    jtok = jtf.greedy_token(jcfg, jlog[:, -1:])
    ttok = ttf.greedy_token(tcfg, tlog[:, -1:])
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t,
                                                    rules=RULES))
    jstream, tstream = [], []
    for _ in range(32):
        jstream.append(int(jtok[0, 0]))
        tstream.append(int(ttok[0, 0]))
        jlog, jcache = jstep(jparams, jcache, jtok)
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache, ttok)
        jtok = jtf.greedy_token(jcfg, jlog)
        ttok = ttf.greedy_token(tcfg, tlog)
    assert tstream == jstream


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# (max_new, arrival step, prompt length): mixed lengths, a late arrival
# that refills a slot while the other still decodes
TRAFFIC = [(4, 0.0, 4), (8, 0.0, 11), (12, 2.0, 5), (6, 3.0, 17)]


def _submit(eng, vocab):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, vocab, size=plen), max_new=n,
                       arrival_time=arr) for n, arr, plen in TRAFFIC]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_streams_equal_reference_generate_and_jax_engine(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=3)
    eng = ServingEngine(arch, EngineConfig(batch=2, max_len=64, clock="step",
                                           device="cpu"), params=tparams)
    reqs = _submit(eng, eng.cfg.vocab_size)
    ops.reset_launch_counts()
    stats = eng.run()
    assert stats["requests"] == len(TRAFFIC)
    assert stats["refill_admissions"] >= 1
    assert ops.launch_counts() == {"matmul": 0, "flash_attention": 0,
                                   "moe_ffn": 0, "ssd_scan": 0,
                                   "rglru_scan": 0}  # CPU: plain
    jeng = JServingEngine(arch, JEngineConfig(batch=2, max_len=64,
                                              clock="step"), params=jparams)
    jreqs = _submit(jeng, jeng.cfg.vocab_size)
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
        assert r.generated == jr.generated


def test_cli_serves_olmoe_on_cpu(capsys):
    tserve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--requests",
                 "3", "--max-new", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "'requests': 3" in out and "prefill_slot" in out
