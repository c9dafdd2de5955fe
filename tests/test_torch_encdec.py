"""seamless-m4t-medium's encoder-decoder path on the CPU, against the JAX
package.

Reduced fp32 config on both sides, the reference's weights
(``repro.models.encdec.init_params``) bridged over as numpy, frames and
tokens from a numpy seed.  Tolerance rtol/atol 1e-4: both sides compute in
fp32, but XLA's and ATen's CPU sums add in different orders.  The frames
are 12 positions and the decoder prompt 6, so the cross-attention runs
Sq 6 over Sk 12 (K1's plain version on the CPU); the self caches hold 16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import encdec as jed
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge, steps
from repro_torch.core.syscore import Syscore
from repro_torch.engine_config import EngineConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import encdec as ted
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S_ENC, S_DEC, DEC_LEN = 2, 12, 6, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@functools.lru_cache(maxsize=None)
def _models():
    """The reduced configs and the reference's weights, bridged (drawn
    once)."""
    jcfg = jregistry.get_config(ARCH, reduced=True)
    tcfg = tregistry.get_config(ARCH, reduced=True)
    jparams = jed.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(_np(jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _inputs(cfg, seed=0):
    """frames (B, S_ENC, d) at the scale of the reference's tests, tokens
    (B, S_DEC)."""
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.02).astype(
        np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    return frames, tokens


def _assert_caches_close(jcache, tcache):
    want = dict(_flat(_np(jcache)))
    got = dict(_flat(bridge.cache_to_numpy(tcache)))
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self/k",
                                           "self/v"]
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path, **TOL)


def _prefill_both(seed=0):
    jcfg, tcfg, jparams, tparams = _models()
    frames, tokens = _inputs(jcfg, seed)
    jlog, jcache, _ = jed.forward(
        jcfg, jparams, jnp.asarray(frames), jnp.asarray(tokens), rules=RULES,
        mode="prefill", caches=jed.init_cache(jcfg, B, DEC_LEN, S_ENC))
    tlog, tcache = ted.forward(
        tcfg, tparams, torch.from_numpy(frames), torch.from_numpy(tokens),
        mode="prefill",
        caches=ted.init_cache(tcfg, B, DEC_LEN, S_ENC, device="cpu"))
    return (jlog, jcache), (tlog, tcache)


def test_config_matches_reference_full_and_reduced():
    assert ARCH in tregistry.PORTED_ARCHS and len(tregistry.PORTED_ARCHS) == 10
    for reduced in (False, True):
        j = jregistry.get_config(ARCH, reduced=reduced)
        t = tregistry.get_config(ARCH, reduced=reduced)
        assert repr(t) == repr(j)
        assert t.padded_vocab == j.padded_vocab
    full = tregistry.get_config(ARCH)
    assert (full.n_enc_layers, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.resolved_head_dim, full.d_ff,
            full.padded_vocab) == (12, 12, 1024, 16, 16, 64, 4096, 258_048)
    assert full.is_encdec and full.frontend == "audio" and \
        full.scale_embeddings and not full.tie_embeddings


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_byte_exact(dtype):
    jcfg, tcfg, jparams, _ = _models()
    jdt = jnp.dtype(dtype)
    params = _np(jax.tree.map(lambda x: x.astype(jdt), jparams))
    rng = np.random.default_rng(0)
    cache = _np(jed.init_cache(jcfg, B, DEC_LEN, S_ENC))
    filled = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(rng.standard_normal(x.shape), jdt)),
        cache)
    for tree, conv in ((params, lambda t: bridge.params_from_numpy(
                            t, tcfg, "cpu")),
                       (filled, lambda t: bridge.cache_from_numpy(
                           t, tcfg, B, DEC_LEN, "cpu", enc_len=S_ENC))):
        back = bridge.to_numpy(conv(tree))
        flat_in = dict(_flat(tree))
        flat_out = dict(_flat(back))
        assert sorted(flat_in) == sorted(flat_out)
        for path, leaf in flat_in.items():
            got = flat_out[path]
            assert got.shape == leaf.shape, path
            assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), path
    # the shapes are checked against encdec's trees
    with pytest.raises(ValueError, match="enc_len"):
        bridge.cache_from_numpy(filled, tcfg, B, DEC_LEN, "cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.cache_from_numpy(filled, tcfg, B, DEC_LEN, "cpu",
                                enc_len=S_ENC + 1)
    assert not {"pos", "groups"} & set(ted.abstract_cache(tcfg, B, DEC_LEN,
                                                          S_ENC))


def test_encode_matches_reference():
    jcfg, tcfg, jparams, tparams = _models()
    frames, _ = _inputs(jcfg, seed=3)
    want = jed.encode(jcfg, jparams, jnp.asarray(frames), rules=RULES)
    got = ted.encode(tcfg, tparams, torch.from_numpy(frames))
    assert got.shape == (B, S_ENC, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_forward_matches_reference_logits_and_every_cache_leaf():
    (jlog, jcache), (tlog, tcache) = _prefill_both()
    _, tcfg, _, _ = _models()
    assert tlog.shape == (B, S_DEC, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_close(jcache, tcache)
    # the self caches hold the prompt's S_DEC positions and no more
    assert not tcache["self"]["k"][:, :, S_DEC:].any()


@pytest.mark.parametrize("enc_len", [None, S_ENC - 5],
                         ids=["all_frames", "first_7_frames"])
def test_decode_step_matches_reference(enc_len):
    jcfg, tcfg, jparams, tparams = _models()
    (_, jcache), (_, tcache) = _prefill_both(seed=1)
    tok = np.asarray([[5], [300]], np.int32)
    jlog, jcache = jed.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                   jnp.int32(S_DEC), rules=RULES,
                                   enc_len=enc_len)
    tlog, tcache = ted.decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(tok),
                                   torch.tensor(S_DEC, dtype=torch.int32),
                                   enc_len=enc_len)
    assert tlog.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches_close(jcache, tcache)
    assert tcache["self"]["k"][:, :, S_DEC].abs().sum() > 0


def test_greedy_tokens_through_the_two_programs_match_reference():
    """The port's prefill and decode programs hot-loaded into a CPU
    Syscore, against the reference's ``make_prefill_step`` and
    ``make_serve_step`` under ``jax.jit``: 8 greedy tokens a row (the
    prefill's and 7 decode steps'), logits within the tolerance."""
    jcfg, tcfg, jparams, tparams = _models()
    frames, tokens = _inputs(jcfg, seed=2)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, RULES))
    jserve = jax.jit(jsteps.make_serve_step(jcfg, RULES))
    jcache, jlast = jprefill(jparams, jed.init_cache(jcfg, B, DEC_LEN, S_ENC),
                             {"frames": jnp.asarray(frames),
                              "tokens": jnp.asarray(tokens)})
    syscore = Syscore("cpu")
    caches = ted.init_cache(tcfg, B, DEC_LEN, S_ENC, device="cpu")
    progs = {k: syscore.hot_load(spec) for k, spec in
             steps.encdec_program_specs(tcfg, tparams, caches,
                                        S_DEC).items()}
    assert sorted(progs) == ["decode", "prefill"]
    assert all(p["source"] == "python"
               for p in syscore.report()["programs"].values())
    _, tlast = progs["prefill"](tparams, caches, torch.from_numpy(frames),
                                torch.from_numpy(tokens))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    jtok = jtf.greedy_token(jcfg, jlast)[:, None]
    ttok = ttf.greedy_token(tcfg, tlast)[:, None]
    jstream, tstream = [np.asarray(jtok)], [ttok.numpy()]
    for i in range(7):
        pos = S_DEC + i
        jcache, jtok, jlog = jserve(jparams, jcache, jtok, jnp.int32(pos))
        # the position as a number on even steps, a 0-dim tensor on odd
        tpos = pos if i % 2 == 0 else torch.tensor(pos, dtype=torch.int32)
        _, ttok, tlog = progs["decode"](tparams, caches, ttok, tpos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jstream.append(np.asarray(jtok))
        tstream.append(ttok.numpy())
    assert ttok.shape == (B, 1) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(np.concatenate(tstream, 1),
                                  np.concatenate(jstream, 1))
    _assert_caches_close(jcache, caches)


def test_engines_refuse_encdec_and_the_decoder_only_path_names_encdec():
    with pytest.raises(AssertionError, match="decoder-only"):
        JServingEngine(ARCH, JEngineConfig(reduced=True))
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(ARCH, EngineConfig(reduced=True, device="cpu"))
    tcfg = tregistry.get_config(ARCH, reduced=True)
    with pytest.raises(NotImplementedError, match="models.encdec"):
        ttf.check_supported(tcfg)
    with pytest.raises(NotImplementedError, match="models.encdec"):
        steps.serve_program_specs(tcfg, EngineConfig(reduced=True), {}, {})
    dense = tregistry.get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(ValueError, match="decoder-only"):
        ted.abstract_params(dense)


def test_train_mode_and_mismatched_frames_raise():
    _, tcfg, _, tparams = _models()
    frames, tokens = _inputs(tcfg)
    caches = ted.init_cache(tcfg, B, DEC_LEN, S_ENC, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        ted.forward(tcfg, tparams, torch.from_numpy(frames),
                    torch.from_numpy(tokens), mode="train", caches=caches)
    with pytest.raises(ValueError, match="frames hold 11 positions"):
        ted.forward(tcfg, tparams, torch.from_numpy(frames[:, :11]),
                    torch.from_numpy(tokens), caches=caches)


def test_trees_are_made_on_the_card_unless_asked_for_the_cpu():
    tcfg = tregistry.get_config(ARCH, reduced=True)
    params = ted.init_params(tcfg, 0, device="cpu")
    assert params["lm_head"].device.type == "cpu"
    assert params["enc"]["attn"]["wq"].shape == (2, 32, 32)
    if torch.cuda.is_available():
        assert ted.init_cache(tcfg, 1, 4, 4)["cross_k"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ted.init_cache(tcfg, 1, 4, 4)
