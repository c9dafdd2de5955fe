"""The port's SSM family on the CPU, against the JAX package.

K4's plain version against the sequential oracle ``repro.kernels.ref.
ssd_scan`` and the Pallas kernel in interpret mode, at the SSD tolerance
of ``tests/test_kernels.py`` (3e-3: chunked and sequential forms sum in
different orders); the chunked scan with an initial state and the D-skip
against ``repro.models.ssm.ssd_chunked``; the Mamba-2 layer, prefill
logits and caches, decode steps, 32 greedy tokens and engine streams of
reduced ``mamba2-130m`` in fp32 against the JAX model and engine holding
the same bridged weights, with its MLP (``reduced()`` sets d_ff 64) and
without it (``d_ff=0``, as the full config).  Model tolerance rtol/atol
1e-4, as in ``tests/test_torch_models.py``.
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
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry as tregistry
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCH = "mamba2-130m"
TOL = dict(rtol=1e-4, atol=1e-4)
SSD_TOL = dict(rtol=3e-3, atol=3e-3)
CACHE_LEN = 64
F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _scan_inputs(rng, b, s, h, p, n):
    """x, dt (post-softplus), a (negative), B, C as in
    ``tests/test_kernels.py:test_ssd_scan_shapes``, plus a state h0."""
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a = -np.exp(rng.standard_normal(h) * 0.3)
    bb = rng.standard_normal((b, s, n)) * 0.3
    cc = rng.standard_normal((b, s, n)) * 0.3
    h0 = rng.standard_normal((b, h, p, n)) * 0.5
    return [np.asarray(v, np.float32) for v in (x, dt, a, bb, cc, h0)]


def _setup(cfg_fn=lambda c: c, seed=1):
    jcfg = cfg_fn(jregistry.get_config(ARCH, reduced=True))
    tcfg = cfg_fn(tregistry.get_config(ARCH, reduced=True))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


# with the reduced config's SwiGLU MLP, and without one, as the full config
D_FF = {"mlp": lambda c: c, "no_mlp": lambda c: c.replace(d_ff=0)}


# ---------------------------------------------------------------------------
# K4 ssd_scan: plain version and wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(128, 32), (256, 128)])
@pytest.mark.parametrize("p,n", [(16, 32), (32, 16)])
def test_ssd_scan_ref_matches_reference_and_interpret_kernel(s, chunk, p, n):
    x, dt, a, bb, cc, _ = _scan_inputs(np.random.default_rng(s + p), 2, s,
                                       3, p, n)
    y, hf = ops.ssd_scan_ref(*map(_t, (x, dt, a, bb, cc)), chunk=chunk)
    jin = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    for want_y, want_h in (jref.ssd_scan(*jin),
                           jops.ssd_scan(*jin, impl="interpret",
                                         chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **SSD_TOL)


def test_ssd_chunked_with_h0_and_d_skip_matches_reference():
    rng = np.random.default_rng(5)
    x, dt, a, bb, cc, h0 = _scan_inputs(rng, 2, 256, 3, 8, 16)
    d_skip = rng.standard_normal(3).astype(np.float32)
    y, hf = tssm.ssd_chunked(*map(_t, (x, dt, a, bb, cc, d_skip)),
                             h0=_t(h0))
    wy, wh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc, d_skip)),
                              h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SSD_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), **SSD_TOL)
    assert float(np.abs(np.asarray(wh)).max()) > 0.1


@pytest.mark.parametrize("s", [1, 37, 129, 200])
@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_scan_ragged_s_matches_sequential_oracle(s, chunk):
    """The last chunk is shorter than ``chunk`` (the Pallas kernel asserts
    it never is); the state starts from h0."""
    x, dt, a, bb, cc, h0 = _scan_inputs(np.random.default_rng(s), 1, s, 2,
                                        8, 12)
    y, hf = ops.ssd_scan(*map(_t, (x, dt, a, bb, cc, h0)), chunk=chunk)
    wy, wh = jref.ssd_scan(*map(jnp.asarray, (x, dt, a, bb, cc)),
                           h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SSD_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), **SSD_TOL)


def test_ssd_scan_ref_bf16_keeps_the_state_in_fp32():
    x, dt, a, bb, cc, h0 = _scan_inputs(np.random.default_rng(9), 1, 64, 2,
                                        8, 16)
    bf = torch.bfloat16
    y, hf = ops.ssd_scan(_t(x).to(bf), _t(dt), _t(a), _t(bb).to(bf),
                         _t(cc).to(bf), _t(h0), chunk=32)
    assert y.dtype == bf and hf.dtype == torch.float32
    wy, wh = jref.ssd_scan(*map(jnp.asarray, (x, dt, a, bb, cc)),
                           h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), rtol=5e-2,
                               atol=5e-2)


def test_ssd_scan_sends_cpu_tensors_to_plain_version_and_rejects_bad_input():
    ops.reset_launch_counts()
    x, dt, a, bb, cc, h0 = map(_t, _scan_inputs(np.random.default_rng(2), 2,
                                                20, 3, 4, 6))
    # strided views, as the layer's splits leave them
    xv = torch.cat([x, x], dim=-1)[..., :4]
    assert not xv.is_contiguous()
    for got, want in zip(ops.ssd_scan(xv, dt, a, bb, cc, h0, chunk=8),
                         ops.ssd_scan_ref(x, dt, a, bb, cc, h0, chunk=8)):
        assert torch.equal(got, want)
    assert ops.launch_counts()["ssd_scan"] == 0
    with pytest.raises(ValueError, match="ranks"):
        ops.ssd_scan(x[0], dt, a, bb, cc)
    with pytest.raises(ValueError, match="B, S, H or N"):
        ops.ssd_scan(x, dt[:, :5], a, bb, cc)
    with pytest.raises(ValueError, match="B, S, H or N"):
        ops.ssd_scan(x, dt, a, bb, cc[..., :5])
    with pytest.raises(ValueError, match="h0"):
        ops.ssd_scan(x, dt, a, bb, cc, h0[:, :2])
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x, dt, a, bb.to(torch.bfloat16), cc)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), a, bb, cc)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt, a, bb, cc, h0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a, bb, cc, chunk=0)


def test_ssd_scan_kernel_shared_memory_fits_the_mamba2_chunk():
    """One block holds a (128, 128) chunk in the 227 KB of an H100 SM."""
    from repro_torch.kernels import ssd_scan as k4
    assert k4.smem_bytes(128, 128) <= k4.SMEM_LIMIT
    assert k4.smem_bytes(128, 256) > k4.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the Mamba-2 layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims", list(D_FF))
def test_apply_ssm_layer_prefill_and_decode_match_reference(dims):
    jcfg, tcfg, jparams, _ = _setup(D_FF[dims], seed=2)
    layer = jax.tree.map(lambda v: np.array(v[0]),
                         jparams["groups"]["slot0"]["mix"])
    tp = {k: torch.from_numpy(v) for k, v in layer.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(lambda v: v[0], jtf.init_cache(jcfg, 2, 8)
                          ["groups"]["slot0"])
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for mode, xs in (("prefill", x),
                     *(("decode", rng.standard_normal(
                         (2, 1, jcfg.d_model)).astype(np.float32))
                       for _ in range(3))):
        jout, jcache = jssm.apply_ssm_layer(
            jcfg, jax.tree.map(jnp.asarray, layer), jnp.asarray(xs),
            rules=RULES, mode=mode, cache=jcache)
        tout, tcache = tssm.apply_ssm_layer(tcfg, tp, torch.from_numpy(xs),
                                            mode=mode, cache=tcache)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for leaf in ("conv", "state"):
            np.testing.assert_allclose(tcache[leaf].numpy(),
                                       np.asarray(jcache[leaf]), **TOL)
    assert tcache["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# config, trees, bridge, weight draw
# ---------------------------------------------------------------------------
def test_ssm_configs_match_reference():
    for reduced in (False, True):
        j = jregistry.get_config(ARCH, reduced=reduced)
        t = tregistry.get_config(ARCH, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
        assert tuple(ttf.abstract_params(t)) == tuple(jtf.abstract_params(j))
        assert ttf.split_layers(t) == jtf.split_layers(j)
    full = tregistry.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.padded_vocab,
            full.tie_embeddings) == (24, 768, 0, 51_200, False)
    mix = ttf.abstract_params(full)["groups"]["slot0"]["mix"]
    assert mix["w_in"].shape == (24, 768, 3352)
    assert mix["a_log"].shape == (24, 24) and \
        mix["a_log"].dtype == torch.float32
    cache = ttf.abstract_cache(full, 4, 512)["groups"]["slot0"]
    assert cache["state"] == ((24, 4, 24, 64, 128), torch.float32)
    assert cache["conv"] == ((24, 4, 3, 1792), None)


def test_other_layer_kinds_still_raise():
    """"L" and "R" are ported with recurrentgemma-2b and the vision
    frontend with internvl2-26b; an unknown kind and the paths still to
    port raise, naming their ROADMAP item."""
    cfg = tregistry.get_config(ARCH, reduced=True)
    ttf.check_supported(cfg.replace(frontend="vision", frontend_tokens=4))
    for change, match in (({"layer_pattern": ("X", "M")}, "not one the port"),
                          ({"frontend": "audio"}, "models.encdec"),
                          ({"n_enc_layers": 2}, "models.encdec"),
                          ({"decode_cache_heads": 4}, "item 13")):
        with pytest.raises(NotImplementedError, match=match):
            ttf.check_supported(cfg.replace(**change))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_exact_for_mamba2(dtype):
    """Parameters and both cache leaves travel both ways bit-exact; the
    fp32 leaves stay fp32 inside a bf16 tree, and a tree cast wholesale is
    refused."""
    jcfg = jregistry.get_config(ARCH, reduced=True).replace(dtype=dtype)
    tcfg = tregistry.get_config(ARCH, reduced=True).replace(dtype=dtype)
    params = _np(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda v: np.asarray(jnp.asarray(rng.standard_normal(v.shape),
                                         v.dtype))
        if v.dtype != np.int32 else np.asarray([3, 9], np.int32),
        _np(jtf.init_cache(jcfg, 2, CACHE_LEN)))
    tparams = bridge.params_from_numpy(params, tcfg, "cpu")
    tcache = bridge.cache_from_numpy(cache, tcfg, 2, CACHE_LEN, "cpu")
    mix = tparams["groups"]["slot0"]["mix"]
    for name in F32_LEAVES:
        assert mix[name].dtype == torch.float32, name
    assert mix["w_in"].dtype == ttf.torch_dtype(dtype)
    assert tcache["groups"]["slot0"]["state"].dtype == torch.float32
    assert tcache["groups"]["slot0"]["conv"].dtype == ttf.torch_dtype(dtype)
    for tree, back in ((params, bridge.to_numpy(tparams)),
                       (cache, bridge.cache_to_numpy(tcache))):
        flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_in) == len(flat_out)
        for path, leaf in flat_in:
            got = flat_out[path]
            assert got.shape == leaf.shape, path
            assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path
    if dtype == "bfloat16":
        cast = jax.tree.map(lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16)),
                            params)
        with pytest.raises(ValueError, match="a_log has dtype bfloat16"):
            bridge.params_from_numpy(cast, tcfg, "cpu")


def test_ssm_weights_are_drawn_like_the_reference():
    """The reference's draw rule: rank <= 1 zeros, else normal *
    shape[-2] ** -0.5, so the layer-stacked (L, H) a_log, d_skip and
    dt_bias are drawn with fan_in L, in fp32 inside a bf16 model."""
    cfg = tregistry.get_config(ARCH, reduced=True).replace(
        n_layers=64, dtype="bfloat16")
    mix = ttf.init_params(cfg, 0)["groups"]["slot0"]["mix"]
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    for name in F32_LEAVES:
        w = mix[name]
        assert w.dtype == torch.float32 and tuple(w.shape) == (64, h)
        np.testing.assert_allclose(float(w.std()), 64 ** -0.5, rtol=0.2)
    for name, fan_in in (("w_in", cfg.d_model), ("w_out", 2 * cfg.d_model),
                         ("conv_w", cfg.ssm_conv_width), ("ln", 64),
                         ("conv_b", 64)):
        w = mix[name]
        assert w.dtype == torch.bfloat16, name
        np.testing.assert_allclose(float(w.float().std()), fan_in ** -0.5,
                                   rtol=0.1)
    assert not torch.equal(mix["a_log"][0], mix["a_log"][1])
    caches = ttf.init_cache(cfg, 2, 16)["groups"]["slot0"]
    assert caches["state"].dtype == torch.float32
    assert caches["conv"].dtype == torch.bfloat16


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
    for leaf in ("conv", "state"):
        np.testing.assert_allclose(got["groups"]["slot0"][leaf],
                                   want["groups"]["slot0"][leaf], **TOL)


@pytest.mark.parametrize("dims", list(D_FF))
def test_prefill_and_decode_match_reference(dims):
    jcfg, tcfg, jparams, tparams = _setup(D_FF[dims])
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    tokens[1, 7:] = 0                       # right padding enters the state
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


@pytest.mark.parametrize("dims", list(D_FF))
def test_32_greedy_tokens_equal_reference(dims):
    jcfg, tcfg, jparams, tparams = _setup(D_FF[dims], seed=5)
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
# (max_new, arrival step, prompt length): mixed lengths below prefill_len,
# a late arrival that refills a slot while the other still decodes
TRAFFIC = [(4, 0.0, 4), (8, 0.0, 11), (12, 2.0, 5), (6, 3.0, 17)]


def _submit(eng, vocab):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, vocab, size=plen), max_new=n,
                       arrival_time=arr) for n, arr, plen in TRAFFIC]


@pytest.mark.parametrize("prefill_len,max_len", [(32, 64), (256, 512)])
def test_engine_streams_equal_reference_generate_and_jax_engine(
        prefill_len, max_len):
    """At prefill_len 256 each admission scans two chunks of 128, so the
    state carried between chunks is held against the JAX engine."""
    jcfg, tcfg, jparams, tparams = _setup(seed=3)
    config = dict(batch=2, max_len=max_len, prefill_len=prefill_len,
                  clock="step")
    eng = ServingEngine(ARCH, EngineConfig(device="cpu", **config),
                        params=tparams)
    reqs = _submit(eng, eng.cfg.vocab_size)
    ops.reset_launch_counts()
    stats = eng.run()
    assert stats["requests"] == len(TRAFFIC)
    assert stats["refill_admissions"] >= 1
    assert ops.launch_counts() == {"matmul": 0, "flash_attention": 0,
                                   "moe_ffn": 0, "ssd_scan": 0,
                                   "rglru_scan": 0}  # CPU: plain
    jeng = JServingEngine(ARCH, JEngineConfig(**config), params=jparams)
    jreqs = _submit(jeng, jeng.cfg.vocab_size)
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
        assert r.generated == jr.generated


def test_cli_serves_mamba2_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                 "--max-new", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "'requests': 3" in out and "prefill_slot" in out
