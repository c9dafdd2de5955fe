"""The port's fused decode horizon on the CPU, held against the JAX package.

Same numpy-seeded inputs and bridged fp32 reduced weights through both:
``decode_step(live=...)`` for the four served families and paged qwen3
and recurrentgemma (logits and caches at rtol/atol 1e-4, frozen rows'
leaves byte-identical to before the step), ``decode_horizon`` with
budgets that end inside the horizon and an ``eos_id`` (events exact,
caches at 1e-4), and the horizon engine's streams against the JAX
horizon engine and the port's own step engine.  Then the engine cases of
``tests/test_horizon.py``, rebuilt in the port: a mid-horizon EOS, the
adaptive shrink while a request waits, a saturated engine that still
fuses, budget exhaustion and the aggregated metrics.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine_config import EngineConfig as JEngineConfig
from repro.engine_config import HorizonConfig as JHorizonConfig
from repro.engine_config import PagingConfig as JPagingConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge
from repro_torch.core.paging import encode_shared
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig)
from repro_torch.launch.serve import (METRIC_DECODE_MS, METRIC_HORIZON_TOKENS,
                                      METRIC_OCCUPANCY, ServingEngine)
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m", "recurrentgemma-2b")
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN, KV_BLOCK, ARENA = 64, 8, 12
MODEL_CASES = [(a, False) for a in ARCHS] + [("qwen3-0.6b", True),
                                              ("recurrentgemma-2b", True)]


def _ids(case):
    arch, paged = case
    return f"{arch}-{'paged' if paged else 'dense'}"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


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


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _filled(tree, pos, rng):
    tree = jax.tree.map(
        lambda x: x if x.dtype == np.int32
        else rng.standard_normal(x.shape).astype(x.dtype),
        jax.tree.map(np.asarray, tree))
    tree["pos"] = np.asarray(pos, np.int32)
    return tree


def _caches(jcfg, tcfg, paged, pos, rng, ring=True):
    """A batch-4 cache with every leaf drawn, as the JAX tree (numpy) and
    the port's.  Paged: row 0 private blocks, row 1 a read-only shared
    head, row 2 unmapped, row 3 a reservation that ends early."""
    b = len(pos)
    if not paged:
        live = _filled(jtf.init_cache(jcfg, b, CACHE_LEN, ring=ring), pos,
                       rng)
        return live, bridge.cache_from_numpy(live, tcfg, b, CACHE_LEN, "cpu",
                                             ring=ring)
    table = np.full((b, CACHE_LEN // KV_BLOCK), -1, np.int32)
    table[0, :4] = [3, 0, 8, 6]
    table[1, :3] = [encode_shared(5), encode_shared(1), 10]
    table[3, :2] = [2, 4]
    live = _filled(jtf.init_paged_cache(jcfg, b, CACHE_LEN, kv_block=KV_BLOCK,
                                        arena_blocks=ARENA), pos, rng)
    live["block_table"] = table
    return live, bridge.paged_cache_from_numpy(
        live, tcfg, b, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA,
        device="cpu")


def _assert_caches_close(tcache, jcache):
    to_np = (bridge.paged_cache_to_numpy if "block_table" in tcache
             else bridge.cache_to_numpy)
    got = dict(_leaves(to_np(tcache)))
    want = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    assert set(got) == set(want)
    for path, leaf in got.items():
        if leaf.dtype == np.int32:
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)
        else:
            np.testing.assert_allclose(leaf, want[path], **TOL, err_msg=path)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
def test_live_decode_step_matches_reference_and_freezes_rows(case):
    arch, paged = case
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(3)
    # row 3 writes past the flat buffer (dropped) or wraps in a ring; rows
    # 1 and 2 are frozen: a ring write of theirs would land in the window
    pos = [27, 19, 12, 70] if not paged else [27, 19, 12, 16]
    live = np.asarray([True, False, False, True])
    jlive, tcache = _caches(jcfg, tcfg, paged, pos, rng)
    token = rng.integers(1, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    jlogits, jcache = jtf.decode_step(
        jcfg, jparams, jax.tree.map(jnp.asarray, jlive), jnp.asarray(token),
        rules=RULES, live=jnp.asarray(live))
    before = {p: t.clone() for p, t in _leaves(tcache)}
    tlogits, out = ttf.decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(token),
                                   live=torch.from_numpy(live))
    assert out is tcache
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_caches_close(tcache, jcache)
    frozen = [1, 2]
    assert tcache["pos"][frozen].tolist() == [pos[i] for i in frozen]
    table = tcache.get("block_table")
    for path, leaf in _leaves(tcache):
        axis = 1 if path.startswith("/groups") else 0
        if path in ("/pos", "/block_table"):
            continue
        if path.endswith(("/k", "/v")) and table is not None:
            # a frozen row's mapped blocks (here, row 1's shared ones)
            blocks = sorted({int(b) if b >= 0 else -int(b) - 2
                             for b in table[frozen].flatten() if b != -1})
            idx = torch.tensor(blocks)
        else:
            idx = torch.tensor(frozen)
        assert torch.equal(leaf.index_select(axis, idx),
                           before[path].index_select(axis, idx)), path


@pytest.mark.parametrize("case", MODEL_CASES[:5], ids=_ids)
def test_decode_horizon_matches_reference(case):
    """Budgets 6, 3, 0 and 5 over H = 6, and an EOS that row 3 emits at its
    second step: every row ends on its own, inside the horizon."""
    arch, paged = case
    horizon = 6
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(4)
    jlive, tcache = _caches(jcfg, tcfg, paged, [27, 19, 12, 16], rng)
    token = rng.integers(1, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    budget = np.asarray([6, 3, 0, 5], np.int32)

    # the EOS: row 3's second token, found by the port on a copy
    free = ttf.decode_horizon(tcfg, tparams, _clone(tcache),
                              torch.from_numpy(token),
                              torch.from_numpy(budget), horizon=horizon)[1]
    eos = int(free["tokens"][3, 1])
    jcache, jev = jax.jit(lambda p, c, t, bud: jtf.decode_horizon(
        jcfg, p, c, t, bud, rules=RULES, horizon=horizon, eos_id=eos))(
        jparams, jax.tree.map(jnp.asarray, jlive), jnp.asarray(token),
        jnp.asarray(budget))
    out, tev = ttf.decode_horizon(tcfg, tparams, tcache,
                                  torch.from_numpy(token),
                                  torch.from_numpy(budget), horizon=horizon,
                                  eos_id=eos)
    assert out is tcache
    for key in ("tokens", "n_emitted", "occupancy"):
        np.testing.assert_array_equal(tev[key].numpy(),
                                      np.asarray(jev[key]), err_msg=key)
    assert tev["n_emitted"].tolist()[2] == 0
    assert tev["n_emitted"].tolist()[3] <= 2
    _assert_caches_close(tcache, jcache)
    b, h = 4, horizon
    buf = tev["buffer"]
    assert torch.equal(buf[:b * h].view(b, h), tev["tokens"])
    assert torch.equal(buf[b * h + b:].view(torch.float32),
                       tev["occupancy"])


def _trace(eng):
    """Two immediate requests with staggered budgets: one finishes inside
    a horizon while the other keeps decoding."""
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=n),
                       max_new=m) for n, m in ((4, 5), (7, 11))]


# the reference matrix's cells (tests/test_horizon.py:26) this test holds:
# the first four at H 4; the rest (ROADMAP Queue 1 item 8.9) at H 16, all
# against the JAX horizon engine of the same H, paging and weights
ENGINE_CASES = {("qwen3-0.6b", False): 4, ("mamba2-130m", False): 4,
                ("qwen3-0.6b", True): 4, ("recurrentgemma-2b", True): 4,
                ("gemma3-4b", True): 16, ("mamba2-130m", True): 16,
                ("recurrentgemma-2b", False): 16, ("olmoe-1b-7b", False): 16,
                ("olmoe-1b-7b", True): 16}


@pytest.mark.parametrize("case", list(ENGINE_CASES), ids=_ids)
def test_horizon_engine_streams_equal_step_engine_and_jax(case):
    arch, paged = case
    horizon = ENGINE_CASES[case]
    jcfg, tcfg, jparams, tparams = _models(arch)
    kw = dict(batch=2, max_len=48, clock="step")
    paging = PagingConfig(kv_block=8, arena_blocks=12) if paged else None
    step = ServingEngine(arch, EngineConfig(device="cpu", paging=paging,
                                            **kw), params=tparams)
    fused = ServingEngine(arch, EngineConfig(
        device="cpu", paging=paging, horizon=HorizonConfig(horizon), **kw),
        params=tparams)
    sreqs, freqs = _trace(step), _trace(fused)
    ss, fs = step.run(), fused.run()
    assert [r.generated for r in freqs] == [r.generated for r in sreqs]
    assert fs["horizon_steps"] >= 1, fs
    assert fs["decode_steps"] < ss["decode_steps"]
    assert fs["decode_tokens"] == ss["decode_tokens"]
    if paged:
        fused.pager.check_invariants()
    jpaging = (JPagingConfig(kv_block=8, arena_blocks=12) if paged
               else None)
    jeng = JServingEngine(arch, JEngineConfig(
        horizon=JHorizonConfig(horizon), paging=jpaging, **kw),
        params=jparams)
    jreqs = _trace(jeng)
    js = jeng.run()
    assert [r.generated for r in freqs] == [r.generated for r in jreqs]
    assert (fs["decode_steps"], fs["horizon_steps"]) == \
        (js["decode_steps"], js["horizon_steps"])


def _engine(horizon=None, params=None, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 64)
    return ServingEngine("qwen3-0.6b", EngineConfig(
        clock="step", device="cpu",
        horizon=HorizonConfig(horizon) if horizon else None, **kw),
        params=params)


def test_mid_horizon_eos_freezes_row_without_perturbing_others():
    eng = _engine(max_len=32, seed=11)
    prompt_a, prompt_b = np.arange(1, 6), np.arange(3, 7)
    ra = eng.submit(prompt_a, max_new=8)
    eng.submit(prompt_b, max_new=8)
    eng.run()
    eos = ra.generated[2]
    first_hit = ra.generated.index(eos)
    fused = _engine(8, max_len=32, eos_id=eos, params=eng.params)
    fa = fused.submit(prompt_a, max_new=8)
    fb = fused.submit(prompt_b, max_new=8)
    stats = fused.run()
    assert fa.generated == ra.generated[:first_hit + 1]
    assert stats["horizon_steps"] >= 1
    seq = _engine(max_len=32, eos_id=eos, params=eng.params)
    sa = seq.submit(prompt_a, max_new=8)
    sb = seq.submit(prompt_b, max_new=8)
    seq.run()
    assert (fa.generated, fb.generated) == (sa.generated, sb.generated)


def test_adaptive_shrink_then_saturated_fusing_then_budget_exhaustion():
    """More requests than slots: while one waits, single steps; a
    saturated engine whose slots cannot free inside a horizon still fuses;
    a budget smaller than H freezes its row mid-horizon.  Every stream
    equals ``reference_generate``."""
    eng = _engine(4)
    rng = np.random.default_rng(5)
    reqs = [eng.submit(rng.integers(1, 500, size=int(rng.integers(2, 8))),
                       max_new=m) for m in (4, 9, 8, 7)]
    stats = eng.run()
    assert stats["requests"] == 4 and stats["refill_admissions"] >= 1
    progs = eng.syscore.report()["programs"]
    assert progs["decode"]["executions"] >= 1
    assert progs["decode_horizon"]["executions"] >= 1
    sat = _engine(4, params=eng.params)
    rng = np.random.default_rng(7)
    reqs += [sat.submit(rng.integers(1, 500, size=4), max_new=13)
             for _ in range(3)]
    sat.run(max_steps=2)
    assert len(sat.queue) == 1 and sat.horizon_steps == 2
    sat.run()
    short = _engine(8, params=eng.params)
    rng = np.random.default_rng(2)
    reqs += [short.submit(rng.integers(1, 500, size=4), max_new=3),
             short.submit(rng.integers(1, 500, size=5), max_new=12)]
    short.run()
    assert [len(r.generated) for r in reqs[-2:]] == [3, 12]
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


def test_horizon_metrics_flow_as_one_aggregated_dispatch():
    eng = _engine(4)
    eng.submit(np.random.default_rng(1).integers(1, 500, size=4), 9)
    stats = eng.run()
    metrics = eng.syscore.hostcalls.metrics
    assert len(metrics[METRIC_DECODE_MS]) == stats["decode_steps"]
    assert len(metrics[METRIC_OCCUPANCY]) == stats["decode_tokens"]
    assert all(o == 0.5 for o in metrics[METRIC_OCCUPANCY])
    assert len(metrics[METRIC_HORIZON_TOKENS]) == stats["horizon_steps"]
    assert sum(metrics[METRIC_HORIZON_TOKENS]) == stats["horizon_tokens"]
    assert eng.syscore.report()["hostcalls"]["step_reports"] == \
        stats["decode_steps"]
    eng.drain_completed()
    assert metrics[METRIC_HORIZON_TOKENS] == [] == metrics[METRIC_DECODE_MS]
