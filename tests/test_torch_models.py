"""The port's model path against the JAX reference, on the CPU.

Same weights on both sides (drawn by the reference, bridged as numpy), fp32
reduced qwen3-0.6b.  Tolerance rtol/atol 1e-4: both sides compute in fp32,
but XLA's and ATen's CPU sums add in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCH = "qwen3-0.6b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(seed=1):
    jcfg = jregistry.get_config(ARCH, reduced=True)
    tcfg = tregistry.get_config(ARCH, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_match_reference():
    for reduced in (False, True):
        j = jregistry.get_config(ARCH, reduced=reduced)
        t = tregistry.get_config(ARCH, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
    # the tenth arch, the encoder-decoder, loads as the reference's does
    for reduced in (False, True):
        assert repr(tregistry.get_config("seamless-m4t-medium",
                                         reduced=reduced)) == \
            repr(jregistry.get_config("seamless-m4t-medium", reduced=reduced))


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        tregistry.get_config("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_exact(dtype):
    cfg = jregistry.get_config(ARCH, reduced=True)
    tcfg = tregistry.get_config(ARCH, reduced=True)
    jdt = jnp.dtype(dtype)
    params = _np(jax.tree.map(lambda x: x.astype(jdt),
                              jtf.init_params(cfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    cache = _np(jtf.init_cache(cfg, 2, CACHE_LEN))
    filled = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(rng.standard_normal(x.shape), jdt))
        if x.dtype != np.int32 else np.asarray([3, 9], np.int32), cache)
    for tree, conv in ((params, lambda t: bridge.params_from_numpy(
                            t, tcfg, "cpu")),
                       (cache, lambda t: bridge.cache_from_numpy(
                           t, tcfg, 2, CACHE_LEN, "cpu")),
                       (filled, lambda t: bridge.cache_from_numpy(
                           t, tcfg, 2, CACHE_LEN, "cpu"))):
        back = bridge.to_numpy(conv(tree))
        flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_in) == len(flat_out)
        for path, leaf in flat_in:
            got = flat_out[path]
            assert got.shape == leaf.shape, path
            assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path


def test_port_init_params_distribution():
    """The port's own init draws the reference's distribution: zeros for
    rank <= 1, normal * shape[-2] ** -0.5 otherwise."""
    cfg = tregistry.get_config(ARCH, reduced=True)
    params = ttf.init_params(cfg, 0)
    assert torch.count_nonzero(params["final_norm"]) == 0
    emb = params["embed"]
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(float(emb.std()), emb.shape[0] ** -0.5,
                               rtol=0.05)
    wq = params["groups"]["slot0"]["mix"]["wq"]
    np.testing.assert_allclose(float(wq.std()), wq.shape[-2] ** -0.5,
                               rtol=0.1)
    again = ttf.init_params(cfg, 0)
    assert torch.equal(again["embed"], emb)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jlayers.apply_rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = tlayers.apply_rmsnorm(torch.from_numpy(scale), torch.from_numpy(x),
                                1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                      ("w_down", (64, 32)))}
    want = jlayers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             RULES)
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,ring", [(0, False), (4, False), (0, True),
                                         (8, True)])
def test_valid_cache_slots_and_decode_attention_match_reference(window, ring):
    rng = np.random.default_rng(6)
    c = 8
    lens = np.asarray([1, 3, 8, 12], np.int32)       # 12 > C: a wrapped ring
    for cache_len in (lens, 5):
        want = jattn._valid_cache_slots(jnp.asarray(cache_len), 4, c,
                                        window=window, ring=ring)
        got = tattn._valid_cache_slots(torch.as_tensor(cache_len), 4, c,
                                       window=window, ring=ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((4, c, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens),
                                  window=window, ring=ring)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens),
                                 window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [64, 70])
def test_decode_attention_on_and_off_a_multiple_of_64(c):
    """A cache of a multiple of 64 slots is read in one batched call, any
    other one row at a time, each row the call of a batch of one; both
    forms against the reference."""
    rng = np.random.default_rng(8)
    lens = np.asarray([1, c // 2, c - 3, c], np.int32)
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((4, c, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens))
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    got = tattn.decode_attention(tq, tk, tv, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if c % tattn.BATCHED_CACHE_MULTIPLE:
        for r in range(4):
            assert torch.equal(got[r], tattn.decode_attention(
                tq[r:r + 1], tk[r:r + 1], tv[r:r + 1], tl[r:r + 1])[0])


def test_prefill_attention_matches_reference_attention():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(
        tattn.reference_attention(tq, tk, tv, causal=True).numpy(), want,
        **TOL)
    np.testing.assert_allclose(
        tattn.prefill_attention(tq, tk, tv, causal=True).numpy(), want, **TOL)


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


def test_prefill_logits_and_cache_match_reference():
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    tokens[1, 7:] = 0                                    # right padding
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               tokens, lengths)
    assert tlog.shape == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_cache_close(jcache, tcache)


def test_decode_steps_match_reference_with_diverging_positions():
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 10)).astype(np.int32)
    lengths = np.asarray([10, 4], np.int32)
    _, jcache, _, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                         tokens, lengths)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t,
                                                    rules=RULES))
    for _ in range(8):
        tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_cache_close(jcache, tcache)
    pos = tcache["pos"].numpy()
    assert pos[0] != pos[1]


def test_32_greedy_tokens_equal_reference():
    jcfg, tcfg, jparams, tparams = _setup(seed=5)
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


def test_unported_paths_raise():
    cfg = tregistry.get_config(ARCH, reduced=True)
    params = ttf.init_params(cfg, 0)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    # the dense training forward is ported; the SSM family's waits
    logits, caches, aux = ttf.forward(cfg, params, tok, mode="train")
    assert logits.shape == (1, 1, cfg.padded_vocab) and caches is None
    ssm = tregistry.get_config("mamba2-130m", reduced=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        ttf.forward(ssm, ttf.init_params(ssm, 0), tok, mode="train")
    ttf.check_supported(cfg.replace(frontend="vision", frontend_tokens=4))
    for change in ({"frontend": "audio"}, {"n_enc_layers": 2}):
        with pytest.raises(NotImplementedError, match="models.encdec"):
            ttf.check_supported(cfg.replace(**change))
