"""The port's speculative decoding on the CPU, held against the JAX package.

The port's ``NGramProposer`` is a copy of ``repro.spec``'s: the same
proposals and history on seeded random histories.  ``verify_decode`` on
one numpy-seeded snapshot, bridged fp32 reduced weights, through both
packages: ``ys`` and ``n_new`` exact, caches at rtol/atol 1e-4; and the
port's verify byte-identical to its own sequential decode of the accepted
tokens, with rows accepting t = 0, k/2 and k drafts, over the matrix of
``tests/test_spec.py`` without gemma3-4b (not ported).  Then the engine:
streams against the JAX engine with every step forced through verify and
with the fallback to a fused horizon, and the cases of
``tests/test_spec.py``, rebuilt in the port: overshoot past the cache and
paged over-allocation reclaimed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ForcedProposer
from repro.engine_config import EngineConfig as JEngineConfig
from repro.engine_config import HorizonConfig as JHorizonConfig
from repro.engine_config import SpecConfig as JSpecConfig
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro.spec import NGramProposer as JNGramProposer
from repro_torch import bridge
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig, SpecConfig)
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf
from repro_torch.spec import NGramProposer

RULES = make_rules()
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN, KV_BLOCK, ARENA, K = 64, 8, 12, 4
# tests/test_spec.py:153's cells
CASES = [("qwen3-0.6b", False), ("mamba2-130m", False),
         ("recurrentgemma-2b", False), ("olmoe-1b-7b", False),
         ("qwen3-0.6b", True), ("recurrentgemma-2b", True),
         ("gemma3-4b", False), ("gemma3-4b", True)]


def _ids(case):
    arch, paged = case
    return f"{arch}-{'paged' if paged else 'dense'}"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Reduced fp32 configs and the reference's weights, bridged (drawn
    once per arch: the reference's draw is most of a case's time)."""
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_proposer_equals_reference(ngram):
    rng = np.random.default_rng(ngram)
    for _ in range(40):
        hist = rng.integers(0, 6, size=int(rng.integers(0, 50))).tolist()
        port, ref = NGramProposer(ngram), JNGramProposer(ngram)
        for chunk in np.array_split(hist, 3):     # incremental observes
            port.observe(chunk.tolist())
            ref.observe(chunk.tolist())
            for k in (0, 1, 3, 8):
                assert port.propose(k) == ref.propose(k)
        assert port.history == ref.history
        assert port._index == ref._index


def _snapshot(jcfg, tcfg, paged, rng):
    """A batch-4 speculative cache (flat windowed buffers) with every leaf
    drawn, as the JAX tree (numpy) and the port's.  Paged: rows 0 and 2
    private blocks, row 1 a read-only shared head then private blocks,
    row 3 a reservation that ends inside the verify's candidates."""
    pos = np.asarray([27, 19, 12, 14], np.int32)

    def filled(tree):
        tree = jax.tree.map(
            lambda x: x if x.dtype == np.int32
            else rng.standard_normal(x.shape).astype(x.dtype),
            jax.tree.map(np.asarray, tree))
        tree["pos"] = pos
        return tree

    if not paged:
        live = filled(jtf.init_cache(jcfg, 4, CACHE_LEN, ring=False))
        return live, bridge.cache_from_numpy(live, tcfg, 4, CACHE_LEN,
                                             "cpu", ring=False)
    table = np.full((4, CACHE_LEN // KV_BLOCK), -1, np.int32)
    table[0, :4] = [3, 0, 8, 6]
    table[1, :3] = [-(5 + 2), 10, 11]
    table[2, :2] = [1, 9]
    table[3, :2] = [2, 4]
    live = filled(jtf.init_paged_cache(jcfg, 4, CACHE_LEN, kv_block=KV_BLOCK,
                                       arena_blocks=ARENA))
    live["block_table"] = table
    return live, bridge.paged_cache_from_numpy(
        live, tcfg, 4, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA,
        device="cpu")


def _no_sink(tree):
    if "block_table" not in tree:
        return dict(_leaves(tree))
    return {p: (t.narrow(1 if p.startswith("/groups") else 0, 0,
                         t.shape[1 if p.startswith("/groups") else 0] - 1)
                if p.endswith(("/k", "/v")) else t)
            for p, t in _leaves(tree)}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_verify_matches_reference_and_own_sequential_decode(case):
    """Rows 0-2 accept t = 0, k/2 and k drafts, row 3 random drafts.  The
    port's verify against the JAX one on the same snapshot, then against
    its own sequential decode of each row's accepted tokens (the rows are
    stepped together, each frozen by ``live`` once its tokens are in)."""
    arch, paged = case
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(8)
    jlive, snap = _snapshot(jcfg, tcfg, paged, rng)
    last = rng.integers(1, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    # each row's greedy continuation from the snapshot, K + 1 tokens
    cont, c, tok = [], _clone(snap), torch.from_numpy(last)
    for _ in range(K + 1):
        logits, c = ttf.decode_step(tcfg, tparams, c, tok)
        tok = ttf.greedy_token(tcfg, logits)
        cont.append(tok[:, 0])
    cont = torch.stack(cont, 1).numpy()
    vocab = jcfg.vocab_size
    drafts = rng.integers(1, vocab, size=(4, K)).astype(np.int32)
    for row, t in enumerate((0, K // 2, K)):
        drafts[row] = np.concatenate(
            [cont[row, :t], (cont[row, t:K] + 1) % vocab])
    tokens = np.concatenate([last, drafts], axis=1)

    jcache, jys, jn = jax.jit(lambda p, c, t: jtf.verify_decode(
        jcfg, p, c, t, rules=RULES))(
        jparams, jax.tree.map(jnp.asarray, jlive), jnp.asarray(tokens))
    tcache = _clone(snap)
    out, ys, n_new = ttf.verify_decode(tcfg, tparams, tcache,
                                       torch.from_numpy(tokens))
    assert out is tcache
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(n_new.numpy(), np.asarray(jn))
    assert n_new.tolist()[:3] == [1, K // 2 + 1, K + 1]
    to_np = (bridge.paged_cache_to_numpy if paged else bridge.cache_to_numpy)
    want = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    for path, leaf in _leaves(to_np(tcache)):
        if leaf.dtype == np.int32:
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)
        else:
            np.testing.assert_allclose(leaf, want[path], **TOL, err_msg=path)

    seq = _clone(snap)
    for j in range(K + 1):
        ttf.decode_step(tcfg, tparams, seq,
                        torch.from_numpy(tokens[:, j:j + 1]), live=j < n_new)
    got, ref = _no_sink(tcache), _no_sink(seq)
    bad = [p for p in got if not torch.equal(got[p], ref[p])]
    assert not bad, bad


def _engine_pair(arch, monkeypatch, forced, horizon, **kw):
    """The port's speculative engine and the JAX one on the same weights
    (k = 3, n-gram 2), both with ``ForcedProposer`` when ``forced``."""
    if forced:
        monkeypatch.setattr(tserve, "NGramProposer", ForcedProposer)
        monkeypatch.setattr(jserve, "NGramProposer", ForcedProposer)
    _, _, jparams, tparams = _models(arch)
    port = tserve.ServingEngine(arch, EngineConfig(
        device="cpu", spec=SpecConfig(3, 2),
        horizon=HorizonConfig(horizon) if horizon else None, **kw),
        params=tparams)
    ref = jserve.ServingEngine(arch, JEngineConfig(
        spec=JSpecConfig(3, 2),
        horizon=JHorizonConfig(horizon) if horizon else None, **kw),
        params=jparams)
    return port, ref


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
@pytest.mark.parametrize("mode", ["forced", "horizon_fallback"])
def test_spec_engine_streams_equal_jax_engine(arch, mode, monkeypatch):
    forced = mode == "forced"
    port, ref = _engine_pair(arch, monkeypatch, forced,
                             None if forced else 4, batch=2, max_len=64,
                             clock="step")
    streams, stats = [], []
    for eng in (port, ref):
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=n), m)
                for n, m in ((4, 10), (6, 12), (5, 7))]
        stats.append(eng.run())
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]
    keys = ("spec_steps", "draft_tokens", "accepted_drafts", "decode_steps")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]
    if forced:
        assert stats[0]["spec_steps"] == stats[0]["decode_steps"]
    else:
        assert stats[0]["horizon_steps"] == stats[1]["horizon_steps"] >= 1
    for r, s in zip(port.completed, streams[0]):
        assert s == port.reference_generate(r.prompt, r.max_new)


def test_overshoot_past_capacity_and_paged_overallocation(monkeypatch):
    """Forced drafts past a 16-slot cache drop, not wrap; paged verify
    steps grow their page past the base reservation and give the tail
    back: nothing leaks, streams stay exact."""
    monkeypatch.setattr(tserve, "NGramProposer", ForcedProposer)
    eng = tserve.ServingEngine("qwen3-0.6b", EngineConfig(
        batch=1, max_len=16, clock="step", device="cpu",
        spec=SpecConfig(4, 2)))
    prompt = np.random.default_rng(2).integers(1, eng.cfg.vocab_size, size=6)
    req = eng.submit(prompt, max_new=12)
    eng.run()
    assert req.done and eng.spec_steps >= 1
    assert req.generated == eng.reference_generate(prompt, req.max_new)

    paged = tserve.ServingEngine("qwen3-0.6b", EngineConfig(
        batch=2, max_len=32, clock="step", device="cpu",
        paging=PagingConfig(kv_block=2, arena_blocks=32),
        spec=SpecConfig(6, 2)), params=eng.params)
    rng = np.random.default_rng(3)
    reqs = [paged.submit(rng.integers(1, 500, size=6), max_new=8)
            for _ in range(3)]
    stats = paged.run()
    assert stats["requests"] == 3 and paged.spec_steps >= 1
    rep = paged.pager.report()
    assert rep["grown_blocks"] >= 1, rep
    assert 1 <= rep["reclaimed_blocks"] <= rep["grown_blocks"], rep
    assert rep["free_blocks"] == paged.pager.arena_blocks
    assert paged.pager.table.resident_bytes == 0
    paged.pager.check_invariants()
    for r in reqs:
        assert r.generated == paged.reference_generate(r.prompt, r.max_new)


def test_cli_spec_and_horizon_flags_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "10",
                 "--batch", "2", "--spec-k", "3", "--horizon", "4"])
    out = capsys.readouterr().out
    assert "'spec_steps'" in out and "'horizon_steps'" in out
    assert "'verify'" in out and "'decode_horizon'" in out
