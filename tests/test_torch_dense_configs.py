"""The port's dense and vision-backbone configs on the CPU, against the JAX
package: llama3.2-3b (tied head, G 3), gemma3-4b and gemma3-12b (five "L"
layers of window 8 then a "G" layer, qk-norm, two rope thetas, scaled
embeddings, tied head) and internvl2-26b (its text backbone, untied head;
the prefix-embedding frontend is ``tests/test_torch_vlm.py``).

Reduced fp32 configs, the same weights on both sides (drawn by the
reference once per arch, bridged as numpy).  Config ``repr`` and
``padded_vocab`` equal the reference's, full and reduced; prefill logits
and every cache leaf, and 8 decode steps at diverging positions, are
allclose at rtol/atol 1e-4 (both sides compute in fp32, but XLA's and
ATen's CPU sums add in different orders); 32 greedy tokens and the
engine's streams (batch 2, staggered, past the window of 8) are equal;
the parameter and cache trees travel both ways byte for byte in fp32 and
bf16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCHS = ("llama3.2-3b", "gemma3-4b", "gemma3-12b", "internvl2-26b")
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 64
NO_LAUNCHES = {"matmul": 0, "flash_attention": 0, "moe_ffn": 0,
               "ssd_scan": 0, "rglru_scan": 0}
# (layers, d_model, heads, kv heads, head dim, d_ff, padded vocab, tied)
# of the published configs
PUBLISHED = {
    "llama3.2-3b": (28, 3072, 24, 8, 128, 8192, 129_024, True),
    "gemma3-4b": (34, 2560, 8, 4, 256, 10240, 262_144, True),
    "gemma3-12b": (48, 3840, 16, 8, 256, 15360, 262_144, True),
    "internvl2-26b": (48, 6144, 48, 8, 128, 16384, 94_208, False),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Reduced fp32 configs and the reference's weights, bridged (drawn
    once per arch: the reference's draw is most of a case's time)."""
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jax_programs(arch):
    """The reference's prefill and decode step, compiled once per arch:
    every case prefills (2, 12) tokens and decodes (2, 1)."""
    jcfg = _models(arch)[0]

    def prefill(params, tokens, lengths):
        logits, caches, _ = jtf.forward(
            jcfg, params, tokens, rules=RULES, mode="prefill",
            caches=jtf.init_cache(jcfg, tokens.shape[0], CACHE_LEN),
            lengths=lengths)
        return logits, caches

    return jax.jit(prefill), jax.jit(
        lambda p, c, t: jtf.decode_step(jcfg, p, c, t, rules=RULES))


def _prefill_both(arch, tokens, lengths):
    jcfg, tcfg, jparams, tparams = _models(arch)
    b = tokens.shape[0]
    jlog, jcache = _jax_programs(arch)[0](jparams, jnp.asarray(tokens),
                                          jnp.asarray(lengths))
    tlog, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(tokens), mode="prefill",
        caches=ttf.init_cache(tcfg, b, CACHE_LEN),
        lengths=torch.from_numpy(lengths))
    return jlog, jcache, tlog, tcache


def _assert_caches_close(jcache, tcache):
    want = dict(_flat(_np(jcache)))
    got = dict(_flat(bridge.cache_to_numpy(tcache)))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path
        np.testing.assert_allclose(got[path], leaf, err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        j = jregistry.get_config(arch, reduced=reduced)
        t = tregistry.get_config(arch, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
    full = tregistry.get_config(arch)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.padded_vocab,
            full.tie_embeddings) == PUBLISHED[arch]
    assert arch in tregistry.PORTED_ARCHS
    ttf.check_supported(full)
    if not full.tie_embeddings:
        head = ttf.abstract_params(full)["lm_head"]
        assert head.shape == (full.d_model, full.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_cache_leaf_match_reference(arch):
    jcfg = _models(arch)[0]
    rng = np.random.default_rng(3)
    # 12 positions: past the reduced window of 8, so the ring keeps the
    # last 8 of the first row
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    tokens[1, 7:] = 0                                    # right padding
    jlog, jcache, tlog, tcache = _prefill_both(arch, tokens, lengths)
    assert tlog.shape == (2, 12, jcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_close(jcache, tcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_with_diverging_positions(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([10, 4], np.int32)
    tokens[0, 10:] = tokens[1, 4:] = 0
    _, jcache, _, tcache = _prefill_both(arch, tokens, lengths)
    jstep = _jax_programs(arch)[1]
    for _ in range(8):
        tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_close(jcache, tcache)
    pos = tcache["pos"].numpy()
    assert pos[0] != pos[1] and pos.max() > 8     # the ring wrapped


@pytest.mark.parametrize("arch", ARCHS)
def test_32_greedy_tokens_equal_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.asarray([12, 9], np.int32)
    tokens[1, 9:] = 0
    jlog, jcache, tlog, tcache = _prefill_both(arch, tokens, lengths)
    rows = np.arange(2)
    jtok = jtf.greedy_token(jcfg, jlog[rows, lengths - 1])[:, None]
    ttok = ttf.greedy_token(tcfg, tlog[rows, lengths - 1])[:, None]
    jstep = _jax_programs(arch)[1]
    jstream, tstream = [], []
    for _ in range(32):
        jstream.append(np.asarray(jtok)[:, 0].tolist())
        tstream.append(ttok[:, 0].tolist())
        jlog, jcache = jstep(jparams, jcache, jtok)
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache, ttok)
        jtok = jtf.greedy_token(jcfg, jlog)
        ttok = ttf.greedy_token(tcfg, tlog)
    assert tstream == jstream
    assert len({t for step in tstream for t in step}) > 3


# (max_new, arrival step, prompt length): prompts below and above the
# window of 8, a late arrival that refills a slot while the other decodes
TRAFFIC = [(4, 0.0, 4), (10, 0.0, 11), (12, 2.0, 5), (8, 3.0, 17)]


def _submit(eng):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=plen),
                       max_new=n, arrival_time=arr)
            for n, arr, plen in TRAFFIC]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_jax_engine_and_reference_generate(arch):
    _, _, jparams, tparams = _models(arch)
    config = dict(batch=2, max_len=48, prefill_len=24, clock="step")
    eng = ServingEngine(arch, EngineConfig(device="cpu", **config),
                        params=tparams)
    reqs = _submit(eng)
    ops.reset_launch_counts()
    stats = eng.run()
    assert stats["requests"] == len(TRAFFIC)
    assert stats["refill_admissions"] >= 1
    assert ops.launch_counts() == NO_LAUNCHES           # CPU: plain versions
    jeng = JServingEngine(arch, JEngineConfig(**config), params=jparams)
    jreqs = _submit(jeng)
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new
        assert r.generated == jr.generated, (arch, r.rid)
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_byte_exact(arch, dtype):
    """Parameters (the untied head of internvl2 included) and a filled
    cache travel both ways bit-exact; no new leaf kind."""
    jdt = jnp.dtype(dtype)
    jcfg = jregistry.get_config(arch, reduced=True).replace(dtype=dtype)
    tcfg = tregistry.get_config(arch, reduced=True).replace(dtype=dtype)
    params = _np(jax.tree.map(lambda x: x.astype(jdt), _models(arch)[2]))
    rng = np.random.default_rng(0)
    cache = _np(jtf.init_cache(jcfg, 2, CACHE_LEN))
    filled = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(rng.standard_normal(x.shape), jdt))
        if x.dtype != np.int32 else np.asarray([3, 9], np.int32), cache)
    assert ("lm_head" in params) == (not tcfg.tie_embeddings)
    for tree, conv in ((params, lambda t: bridge.params_from_numpy(
                            t, tcfg, "cpu")),
                       (filled, lambda t: bridge.cache_from_numpy(
                           t, tcfg, 2, CACHE_LEN, "cpu"))):
        back = dict(_flat(bridge.to_numpy(conv(tree))))
        flat_in = list(_flat(tree))
        assert len(flat_in) == len(back)
        for path, leaf in flat_in:
            got = back[path]
            assert got.shape == leaf.shape, path
            assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path
