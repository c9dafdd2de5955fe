"""internvl2-26b's prefix-embedding frontend on the CPU, against the JAX
package.

The vision frontend is a stub in both packages: 4 precomputed patch
embeddings (``frontend_tokens`` of the reduced config), here drawn from a
numpy seed, run before the text tokens.  Reduced fp32 config and the same
weights on both sides (drawn by the reference, bridged as numpy).
``forward(prefix_embeds=...)``, the whole-batch ``prefill`` program with
``prefix_embeds`` and ``lengths`` (which count the prefix) against
``repro.steps.make_prefill_step`` with ``batch["prefix_embeds"]``, and 8
decode steps from that cache against the reference's ``decode_step``:
logits and every cache leaf allclose at rtol/atol 1e-4 (both sides in
fp32; XLA's and ATen's CPU sums add in different orders).  Each case runs
again with ``scale_embeddings=True`` on both sides, which pins the order:
the prefix is concatenated before the sqrt(d_model) scale, so it is
scaled too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge, steps
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCH = "internvl2-26b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 32
S_TOK = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@functools.lru_cache(maxsize=None)
def _models(scale):
    """The reduced configs, ``scale_embeddings`` set on both sides, and the
    reference's weights, bridged (drawn once)."""
    jcfg = jregistry.get_config(ARCH, reduced=True).replace(
        scale_embeddings=scale)
    tcfg = tregistry.get_config(ARCH, reduced=True).replace(
        scale_embeddings=scale)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _inputs(cfg, seed=0):
    """(tokens (2, 8) with row 1 right-padded after 5, prefix (2, 4, d),
    lengths counting the prefix)."""
    rng = np.random.default_rng(seed)
    p = cfg.frontend_tokens
    tokens = rng.integers(1, cfg.vocab_size, (2, S_TOK)).astype(np.int32)
    tokens[1, 5:] = 0
    prefix = rng.standard_normal((2, p, cfg.d_model)).astype(np.float32)
    lengths = np.asarray([p + S_TOK, p + 5], np.int32)
    return tokens, prefix, lengths


def _assert_caches_close(jcache, tcache):
    want = dict(_flat(_np(jcache)))
    got = dict(_flat(bridge.cache_to_numpy(tcache)))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path, **TOL)


def test_config_carries_the_frontend_stub():
    full = tregistry.get_config(ARCH)
    assert (full.family, full.frontend, full.frontend_tokens) == \
        ("vlm", "vision", 256)
    assert tregistry.get_config(ARCH, reduced=True).frontend_tokens == 4
    ttf.check_supported(full)
    assert steps.warm_prefix_capable(full)       # attention-only, no experts


@pytest.mark.parametrize("scale", [False, True], ids=["unscaled", "scaled"])
def test_forward_with_prefix_embeds_matches_reference(scale):
    jcfg, tcfg, jparams, tparams = _models(scale)
    tokens, prefix, lengths = _inputs(jcfg)
    p = jcfg.frontend_tokens
    jlog, jcache, _ = jtf.forward(
        jcfg, jparams, jnp.asarray(tokens), rules=RULES,
        prefix_embeds=jnp.asarray(prefix), mode="prefill",
        caches=jtf.init_cache(jcfg, 2, CACHE_LEN),
        lengths=jnp.asarray(lengths))
    tlog, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(tokens),
        prefix_embeds=torch.from_numpy(prefix), mode="prefill",
        caches=ttf.init_cache(tcfg, 2, CACHE_LEN),
        lengths=torch.from_numpy(lengths))
    assert tlog.shape == (2, p + S_TOK, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_close(jcache, tcache)
    # the prefix moved the logits: it is not dropped
    plain, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens),
                           mode="prefill",
                           caches=ttf.init_cache(tcfg, 2, CACHE_LEN))
    assert not torch.allclose(plain[:, -1], tlog[:, -1])
    # embed_inputs: the prefix first, then the tokens, one scale for both
    x = ttf.embed_inputs(tcfg, tparams, torch.from_numpy(tokens),
                         torch.from_numpy(prefix))
    k = float(torch.tensor(tcfg.d_model ** 0.5)) if scale else 1.0
    np.testing.assert_array_equal(x[:, :p].numpy(), prefix * np.float32(k))


@pytest.mark.parametrize("scale", [False, True], ids=["unscaled", "scaled"])
def test_prefill_step_with_prefix_then_8_decode_steps_match_reference(scale):
    jcfg, tcfg, jparams, tparams = _models(scale)
    tokens, prefix, lengths = _inputs(jcfg, seed=1)
    jcache, jlast = jax.jit(jsteps.make_prefill_step(jcfg, RULES))(
        jparams, jtf.init_cache(jcfg, 2, CACHE_LEN),
        {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths),
         "prefix_embeds": jnp.asarray(prefix)})
    tcache, tlast = steps.make_prefill_step(tcfg)(
        tparams, ttf.init_cache(tcfg, 2, CACHE_LEN),
        torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(prefix))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_caches_close(jcache, tcache)
    np.testing.assert_array_equal(tcache["pos"].numpy(), lengths)
    jstep = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t,
                                                    rules=RULES))
    jtok = jtf.greedy_token(jcfg, jlast)[:, None]
    ttok = ttf.greedy_token(tcfg, tlast)[:, None]
    for _ in range(8):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = jstep(jparams, jcache, jtok)
        tlog, tcache = ttf.decode_step(tcfg, tparams, tcache, ttok)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok = jtf.greedy_token(jcfg, jlog)
        ttok = ttf.greedy_token(tcfg, tlog)
    _assert_caches_close(jcache, tcache)
    np.testing.assert_array_equal(tcache["pos"].numpy(), lengths + 8)


def test_prefix_is_cast_to_the_model_dtype():
    """A bf16 prefix into the fp32 model: both sides cast it first, so
    the logits agree as with an fp32 prefix of the same values."""
    jcfg, tcfg, jparams, tparams = _models(False)
    tokens, prefix, lengths = _inputs(jcfg, seed=2)
    jpre = jnp.asarray(prefix, jnp.bfloat16)
    tpre = bridge._leaf_from_numpy(np.asarray(jpre), "cpu")
    assert tpre.dtype == torch.bfloat16
    jlog, _, _ = jtf.forward(
        jcfg, jparams, jnp.asarray(tokens), rules=RULES, prefix_embeds=jpre,
        mode="prefill", caches=jtf.init_cache(jcfg, 2, CACHE_LEN),
        lengths=jnp.asarray(lengths))
    tlog, _ = ttf.forward(
        tcfg, tparams, torch.from_numpy(tokens), prefix_embeds=tpre,
        mode="prefill", caches=ttf.init_cache(tcfg, 2, CACHE_LEN),
        lengths=torch.from_numpy(lengths))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
