"""The port's hybrid family on the CPU, against the JAX package.

K5's plain version against the sequential oracle ``repro.kernels.ref.
rglru_scan`` and the Pallas kernel in interpret mode, at the RG-LRU
tolerance of ``tests/test_kernels.py`` (2e-4); the scan from a carried
state against ``repro.models.hybrid.rglru_scan`` (an associative scan);
the recurrent layer, the windowed "L" layer in its ring and flat layouts,
prefill logits and caches, decode steps, 32 greedy tokens and engine
streams of reduced ``recurrentgemma-2b`` in fp32 against the JAX model and
engine holding the same bridged weights.  Model tolerance rtol/atol 1e-4,
as in ``tests/test_torch_ssm.py``.

The reference's draw zeroes every rank <= 1 leaf, so the tail layers'
gate parameters would be 0 and their gates constant (r = i = 0.5): the
gate leaves and ``conv_b`` are drawn from a numpy seed here, on the JAX
side, and carried across with the bridge.
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
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import hybrid as thybrid
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_LEN = 64
GATE_LEAVES = ("lam", "w_a", "b_a", "w_i", "b_i")
NO_LAUNCHES = {"matmul": 0, "flash_attention": 0, "moe_ffn": 0,
               "ssd_scan": 0, "rglru_scan": 0}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _scan_inputs(rng, b, s, l):
    """a = sigmoid(normal), b = 0.3 normal (``tests/test_kernels.py:
    156-157``) and a state h0."""
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, l))))
    bb = rng.standard_normal((b, s, l)) * 0.3
    h0 = rng.standard_normal((b, l))
    return [np.asarray(v, np.float32) for v in (a, bb, h0)]


def _draw_gates(params, seed):
    """The reference's params with every recurrent layer's gate leaves and
    conv bias drawn from ``seed`` (its own draw zeroes the tail's)."""
    rng = np.random.default_rng(seed)
    params = _np(params)

    def draw(mix):
        if "lam" not in mix:
            return
        for name in GATE_LEAVES:
            mix[name] = rng.standard_normal(mix[name].shape).astype(
                mix[name].dtype)
        mix["conv_b"] = (rng.standard_normal(mix["conv_b"].shape) * 0.1
                         ).astype(mix["conv_b"].dtype)

    for layer in list(params["groups"].values()) + \
            list(params["tail"].values()):
        draw(layer["mix"])
    return params


# the windowed layer's two cache layouts: a ring of window 8 (the reduced
# config), and a flat buffer when the window (128) exceeds max_len (64),
# the layout of the full-width card run (window 2048 over max_len 512)
LAYOUTS = {"ring": lambda c: c, "flat": lambda c: c.replace(local_window=128)}


def _count(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_count(v) for v in shapes.values())
    return int(np.prod(shapes.shape))


def _setup(cfg_fn=lambda c: c, seed=1):
    jcfg = cfg_fn(jregistry.get_config(ARCH, reduced=True))
    tcfg = cfg_fn(tregistry.get_config(ARCH, reduced=True))
    params = _draw_gates(jtf.init_params(jcfg, jax.random.PRNGKey(seed)),
                         seed)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = bridge.params_from_numpy(params, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# K5 rglru_scan: plain version and wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,l,chunk", [(64, 32, 32), (128, 64, 32),
                                       (256, 32, 64)])
def test_rglru_scan_ref_matches_reference_and_interpret_kernel(s, l, chunk):
    a, b, _ = _scan_inputs(np.random.default_rng(s + l), 2, s, l)
    h, hf = ops.rglru_scan_ref(_t(a), _t(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for want_h, want_hf in (jref.rglru_scan(ja, jb),
                            jops.rglru_scan(ja, jb, impl="interpret",
                                            chunk=chunk, block_l=l)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf),
                                   **SCAN_TOL)


def test_rglru_scan_from_h0_matches_reference_model_scan():
    """The port's kernel starts from h0; the reference folds h0 in as a
    virtual step 0 of an associative scan."""
    jcfg, _, jparams, tparams = _setup(seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 96, jcfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.lru_width)).astype(np.float32)
    jp = jax.tree.map(lambda v: v[0], jparams["groups"]["slot0"]["mix"])
    tp = {k: v[0] for k, v in tparams["groups"]["slot0"]["mix"].items()}
    y, hf = thybrid.rglru_scan(tp, _t(x), _t(h0))
    wy, whf = jhybrid.rglru_scan(jp, jnp.asarray(x), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(whf), **SCAN_TOL)
    assert hf.dtype == torch.float32
    assert float(np.abs(np.asarray(whf)).max()) > 0.1


@pytest.mark.parametrize("s", [1, 37, 200])
def test_rglru_scan_ragged_s_matches_sequential_oracle(s):
    """S that no Pallas chunk divides; a ragged L of 40; from h0."""
    a, b, h0 = _scan_inputs(np.random.default_rng(s), 2, s, 40)
    h, hf = ops.rglru_scan(_t(a), _t(b), _t(h0))
    wh, whf = jref.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                              h0=jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **SCAN_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(whf), **SCAN_TOL)


def test_rglru_scan_sends_cpu_tensors_to_plain_version_and_rejects_bad_input():
    ops.reset_launch_counts()
    a, b, h0 = map(_t, _scan_inputs(np.random.default_rng(2), 2, 9, 5))
    for h0_ in (None, h0):
        for got, want in zip(ops.rglru_scan(a, b, h0_),
                             ops.rglru_scan_ref(a, b, h0_)):
            assert torch.equal(got, want)
    assert ops.launch_counts()["rglru_scan"] == 0
    with pytest.raises(ValueError, match="one shape"):
        ops.rglru_scan(a[0], b[0])
    with pytest.raises(ValueError, match="one shape"):
        ops.rglru_scan(a, b[:, :4])
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan(a, b, h0[:1])
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.to(torch.bfloat16), b)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a, b, h0.double())
    with pytest.raises(ValueError, match="non-empty"):
        ops.rglru_scan(a[:, :0], b[:, :0])


def test_flash_attention_kernel_shared_memory_fits_head_dim_256():
    """K1's three fp32 tiles at D = 256 take 82,048 bytes: over the 48 KB
    of static shared memory, inside the 227 KB of an H100 SM."""
    assert 256 in k1.HEAD_DIMS
    assert k1.smem_bytes(256) == 82_048
    assert 48 * 1024 < k1.smem_bytes(256) <= k1.SMEM_LIMIT
    assert k1.smem_bytes(128) <= 48 * 1024


# ---------------------------------------------------------------------------
# the recurrent layer and the windowed attention layer
# ---------------------------------------------------------------------------
def test_apply_rglru_layer_prefill_and_decode_match_reference():
    jcfg, tcfg, jparams, tparams = _setup(seed=2)
    jp = jax.tree.map(lambda v: v[0], jparams["groups"]["slot1"]["mix"])
    tp = {k: v[0] for k, v in tparams["groups"]["slot1"]["mix"].items()}
    for name in GATE_LEAVES:
        assert tp[name].dtype == torch.float32
        assert float(tp[name].abs().max()) > 0.5, name   # drawn, not zero
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(lambda v: v[0], jtf.init_cache(jcfg, 2, 8)
                          ["groups"]["slot1"])
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for mode, xs in (("prefill", x),
                     *(("decode", rng.standard_normal(
                         (2, 1, jcfg.d_model)).astype(np.float32))
                       for _ in range(4))):
        jout, jcache = jhybrid.apply_rglru_layer(
            jcfg, jp, jnp.asarray(xs), rules=RULES, mode=mode, cache=jcache)
        tout, tcache = thybrid.apply_rglru_layer(
            tcfg, tp, torch.from_numpy(xs), mode=mode, cache=tcache)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for leaf in ("conv", "h"):
            np.testing.assert_allclose(tcache[leaf].numpy(),
                                       np.asarray(jcache[leaf]), **TOL)
    assert tcache["h"].dtype == torch.float32


@pytest.mark.parametrize("s,lengths", [(20, [20, 13]), (12, [5, 12]),
                                       (6, [6, 3])])
def test_ring_prefill_write_matches_reference(s, lengths):
    """Slot j of a ring holds each row's latest valid position p with
    p % window == j, gathered by the row's own length; a prompt shorter
    than the window is copied."""
    w = 8
    full = np.random.default_rng(s).standard_normal((2, s, 1, 4)).astype(
        np.float32)
    lens = np.asarray(lengths, np.int32)
    want = jtf._write_prefill_cache(jnp.zeros((2, w, 1, 4)),
                                    jnp.asarray(full), w, lengths=lens)
    got = ttf._write_prefill_cache(torch.zeros((2, w, 1, 4)),
                                   torch.from_numpy(full), w,
                                   torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_scale_is_bit_equal_to_reference_in_bf16():
    """The scale is rounded to bf16 before the multiply: 50.5, not
    50.596."""
    cfg = tregistry.get_config(ARCH)
    jcfg = jregistry.get_config(ARCH)
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((64, cfg.d_model)) * 0.02,
                        jnp.bfloat16)
    tokens = rng.integers(0, 64, (2, 5)).astype(np.int32)
    want = jtf.embed_inputs(jcfg, {"embed": table}, jnp.asarray(tokens),
                            None, RULES)
    got = ttf.embed_inputs(cfg, {"embed": bridge._leaf_from_numpy(
        np.asarray(table), "cpu")}, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert bridge.to_numpy(got).tobytes() == \
        np.asarray(want).view(np.uint16).tobytes()
    assert float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16)) \
        == 50.5


# ---------------------------------------------------------------------------
# config, trees, bridge
# ---------------------------------------------------------------------------
def test_hybrid_configs_match_reference():
    for reduced in (False, True):
        j = jregistry.get_config(ARCH, reduced=reduced)
        t = tregistry.get_config(ARCH, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
        assert ttf.split_layers(t) == jtf.split_layers(j)
    full = tregistry.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.lru_width, full.d_ff,
            full.padded_vocab, full.tie_embeddings) == \
        (26, 2560, 2560, 7680, 256_000, True)
    assert ttf.split_layers(full) == (("R", "R", "L"), 8, ("R", "R"))
    red = tregistry.get_config(ARCH, reduced=True)
    assert (red.n_layers, red.d_model, red.n_heads, red.n_kv_heads,
            red.resolved_head_dim, red.lru_width, red.local_window,
            red.d_ff, red.dtype) == (5, 32, 2, 1, 16, 32, 8, 64, "float32")
    mix = ttf.abstract_params(full)["groups"]["slot0"]["mix"]
    assert mix["w_x"].shape == (8, 2560, 2560)
    assert mix["lam"] == ((8, 2560), torch.float32)
    cache = ttf.abstract_cache(full, 4, 512)
    # max_len 512 < window 2048: the "L" cache is flat, 512 slots
    assert cache["groups"]["slot2"]["k"] == ((8, 4, 512, 1, 256), None)
    assert cache["groups"]["slot0"]["h"] == ((8, 4, 2560), torch.float32)
    assert cache["tail"]["tail1"]["conv"] == ((4, 3, 2560), None)
    assert 2.6e9 < _count(ttf.abstract_params(full)) < 2.7e9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_exact_for_recurrentgemma(dtype):
    """Parameters and every cache leaf, ``tail`` paths included, travel
    both ways bit-exact; the gate leaves and ``h`` stay fp32 inside a bf16
    tree, and a tree cast wholesale is refused."""
    jcfg = jregistry.get_config(ARCH, reduced=True).replace(dtype=dtype)
    tcfg = tregistry.get_config(ARCH, reduced=True).replace(dtype=dtype)
    params = _draw_gates(jtf.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda v: np.asarray(jnp.asarray(rng.standard_normal(v.shape),
                                         v.dtype))
        if v.dtype != np.int32 else np.asarray([3, 9], np.int32),
        _np(jtf.init_cache(jcfg, 2, CACHE_LEN)))
    tparams = bridge.params_from_numpy(params, tcfg, "cpu")
    tcache = bridge.cache_from_numpy(cache, tcfg, 2, CACHE_LEN, "cpu")
    for layer in (tparams["groups"]["slot0"], tparams["tail"]["tail1"]):
        for name in GATE_LEAVES:
            assert layer["mix"][name].dtype == torch.float32, name
        assert layer["mix"]["w_x"].dtype == ttf.torch_dtype(dtype)
    for layer in (tcache["groups"]["slot1"], tcache["tail"]["tail0"]):
        assert layer["h"].dtype == torch.float32
        assert layer["conv"].dtype == ttf.torch_dtype(dtype)
    assert tcache["groups"]["slot2"]["k"].shape == (1, 2, 8, 1, 16)
    for tree, back in ((params, bridge.to_numpy(tparams)),
                       (cache, bridge.cache_to_numpy(tcache))):
        flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_in) == len(flat_out)
        assert any("tail" in str(path) for path, _ in flat_in)
        for path, leaf in flat_in:
            got = flat_out[path]
            assert got.shape == leaf.shape, path
            assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path
    if dtype == "bfloat16":
        cast = jax.tree.map(lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16)),
                            params)
        with pytest.raises(ValueError, match="has dtype bfloat16"):
            bridge.params_from_numpy(cast, tcfg, "cpu")


def test_hybrid_weights_are_drawn_like_the_reference():
    """Rank <= 1 leaves (the tail's gates and conv bias) are zeros; the
    layer-stacked (L, lru) gate leaves are drawn, in fp32 inside a bf16
    model."""
    cfg = tregistry.get_config(ARCH, reduced=True).replace(
        n_layers=3 * 16 + 2, dtype="bfloat16")
    params = ttf.init_params(cfg, 0)
    mix = params["groups"]["slot0"]["mix"]
    for name in GATE_LEAVES:
        w = mix[name]
        assert w.dtype == torch.float32 and tuple(w.shape) == (16, 32)
        np.testing.assert_allclose(float(w.std()), 16 ** -0.5, rtol=0.25)
        tail = params["tail"]["tail0"]["mix"][name]
        assert tail.dtype == torch.float32 and not bool(tail.any())
    assert mix["w_x"].dtype == torch.bfloat16
    caches = ttf.init_cache(cfg, 2, 16)
    assert caches["groups"]["slot0"]["h"].dtype == torch.float32
    assert caches["tail"]["tail1"]["conv"].dtype == torch.bfloat16
    assert caches["groups"]["slot2"]["k"].shape == (16, 2, 8, 1, 16)


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
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(flat_got[path], leaf, err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_and_decode_match_reference(layout):
    """Prompts of 20 and 13 (longer than the window of 8), right-padded;
    12 decode steps take the ring past its wrap."""
    jcfg, tcfg, jparams, tparams = _setup(LAYOUTS[layout])
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 20)).astype(np.int32)
    lengths = np.asarray([20, 13], np.int32)
    tokens[1, 13:] = 0                      # right padding enters the state
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               tokens, lengths)
    slots = tcache["groups"]["slot2"]["k"].shape[2]
    assert slots == (8 if layout == "ring" else CACHE_LEN)
    assert tlog.shape == (2, 20, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_cache_close(jcache, tcache)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t,
                                                    rules=RULES))
    for _ in range(12):
        tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_cache_close(jcache, tcache)


def test_32_greedy_tokens_equal_reference():
    jcfg, tcfg, jparams, tparams = _setup(seed=5)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (1, 11)).astype(np.int32)
    lengths = np.asarray([11], np.int32)
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
    assert len(set(tstream)) > 3


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# (max_new, arrival step, prompt length): prompts below and above the
# window of 8, a late arrival that refills a slot while the other decodes
TRAFFIC = [(4, 0.0, 4), (10, 0.0, 11), (12, 2.0, 5), (8, 3.0, 17)]


def _submit(eng, vocab):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, vocab, size=plen), max_new=n,
                       arrival_time=arr) for n, arr, plen in TRAFFIC]


@pytest.mark.parametrize("prefill_len,max_len", [(32, 64), (256, 512)])
def test_engine_streams_equal_reference_generate_and_jax_engine(
        prefill_len, max_len):
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
    assert ops.launch_counts() == NO_LAUNCHES           # CPU: plain versions
    jeng = JServingEngine(ARCH, JEngineConfig(**config), params=jparams)
    jreqs = _submit(jeng, jeng.cfg.vocab_size)
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
        assert r.generated == jr.generated


def test_cli_serves_recurrentgemma_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                 "--max-new", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "'requests': 3" in out and "prefill_slot" in out
