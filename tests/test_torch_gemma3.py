"""gemma3-4b's row of the family matrix on the CPU, against the JAX engine.

The reference's serving matrix takes gemma3-4b as its sliding-window
(ring-cache) row (``tests/test_serving.py:84``).  Here its reduced config
(five "L" layers of window 8, then a "G" layer, then two more "L"; fp32),
with the reference's weights bridged, serves the workloads of the
reference's own tests through the port's engines, and every stream must
equal the JAX engine's on the same traffic (and the port's batch-1
``reference_generate``):

- paged: ``benchmarks/bench_paging.py``'s smoke workload (batch 2,
  max_len 32, kv_block 8, half the batch's blocks, timeslice 3; the
  workload of ``tests/test_paging.py``'s pressure cases), beside the
  unpaged engine, with the reference pager's schedule;
- speculative (k 3, every step forced through verify), dense and paged:
  ``tests/test_serving.py``'s spec matrix workload;
- horizon (H 16): ``tests/test_horizon.py``'s two staggered budgets;
- prefix sharing: ``tests/test_prefix.py``'s sharing workload, which
  gemma3 (attention-only) admits warm through ``prefill_offset``.

The dense and horizon engines keep "L" layers as rings of 8 slots, and
their requests decode past position 8, so the ring wraps.
"""
import functools

import jax
import numpy as np
import pytest

from conftest import ForcedProposer
from repro.engine_config import EngineConfig as JEngineConfig
from repro.engine_config import HorizonConfig as JHorizonConfig
from repro.engine_config import PagingConfig as JPagingConfig
from repro.engine_config import PrefixConfig as JPrefixConfig
from repro.engine_config import SpecConfig as JSpecConfig
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig, PrefixConfig,
                                       SpecConfig)
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry

ARCH = "gemma3-4b"


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's reduced weights and the same, bridged (drawn once)."""
    jparams = jtf.init_params(jregistry.get_config(ARCH, reduced=True),
                              jax.random.PRNGKey(9))
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        tregistry.get_config(ARCH, reduced=True), "cpu")
    return jparams, tparams


def _pair(config, jconfig):
    jparams, tparams = _params()
    return (tserve.ServingEngine(ARCH, config, params=tparams),
            jserve.ServingEngine(ARCH, jconfig, params=jparams))


def _serve(eng, work):
    reqs = [eng.submit(p, max_new=m, arrival_time=a) for p, m, a in work]
    assert all(r is not None for r in reqs)
    stats = eng.run()
    assert stats["requests"] == len(work)
    return [r.generated for r in reqs], stats


def _assert_ring_wrapped(eng, work):
    """Every "L" layer of a dense engine is a ring of ``local_window``
    slots, and some request decoded past it."""
    cfg = eng.cfg
    ring = eng.caches["groups"]["slot0"]["k"]
    assert ring.shape[2] == cfg.local_window < eng.max_len
    assert max(len(p) + m for p, m, _ in work) > cfg.local_window


def test_paged_engine_equals_unpaged_and_jax_with_the_same_schedule():
    batch, max_len, kv_block, timeslice = 2, 32, 8, 3
    arena = batch * (max_len // kv_block) // 2
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 500, size=int(rng.integers(4, 17))),
             int(rng.integers(4, 9)), 0.0) for _ in range(4 * batch)]
    kw = dict(batch=batch, max_len=max_len, clock="step")
    eng, jeng = _pair(
        EngineConfig(device="cpu", paging=PagingConfig(
            kv_block=kv_block, arena_blocks=arena, timeslice=timeslice),
            **kw),
        JEngineConfig(paging=JPagingConfig(
            kv_block=kv_block, arena_blocks=arena, timeslice=timeslice),
            **kw))
    streams, stats = _serve(eng, work)
    eng.pager.check_invariants()
    assert stats["preemptions"] >= 1 and eng.pager.report()["evictions"] >= 1
    unpaged = tserve.ServingEngine(ARCH, EngineConfig(device="cpu", **kw),
                                   params=_params()[1])
    _assert_ring_wrapped(unpaged, work)
    jstreams, jstats = _serve(jeng, work)
    assert streams == _serve(unpaged, work)[0] == jstreams
    for key in ("preemptions", "swap_ins", "page_faults", "swap_outs",
                "decode_steps"):
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_forced_spec_engine_equals_jax_and_reference(paged, monkeypatch):
    monkeypatch.setattr(tserve, "NGramProposer", ForcedProposer)
    monkeypatch.setattr(jserve, "NGramProposer", ForcedProposer)
    kw = dict(batch=2, max_len=48, clock="step")
    eng, jeng = _pair(
        EngineConfig(device="cpu", spec=SpecConfig(3, 2),
                     paging=PagingConfig(kv_block=8, arena_blocks=12)
                     if paged else None, **kw),
        JEngineConfig(spec=JSpecConfig(3, 2),
                      paging=JPagingConfig(kv_block=8, arena_blocks=12)
                      if paged else None, **kw))
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, eng.cfg.vocab_size, size=n), m, t)
            for n, m, t in ((4, 6, 0.0), (9, 5, 0.0), (6, 7, 2.0))]
    streams, stats = _serve(eng, work)
    jstreams, jstats = _serve(jeng, work)
    assert streams == jstreams
    assert stats["spec_steps"] == stats["decode_steps"] >= 1
    for key in ("spec_steps", "draft_tokens", "accepted_drafts"):
        assert stats[key] == jstats[key], key
    for (p, m, _), s in zip(work, streams):
        assert s == eng.reference_generate(p, m)
    if paged:
        eng.pager.check_invariants()


def test_horizon_engine_equals_step_engine_and_jax_through_a_wrap():
    kw = dict(batch=2, max_len=48, clock="step")
    eng, jeng = _pair(
        EngineConfig(device="cpu", horizon=HorizonConfig(16), **kw),
        JEngineConfig(horizon=JHorizonConfig(16), **kw))
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, eng.cfg.vocab_size, size=n), m, 0.0)
            for n, m in ((4, 5), (7, 11))]
    _assert_ring_wrapped(eng, work)
    streams, stats = _serve(eng, work)
    jstreams, jstats = _serve(jeng, work)
    step = tserve.ServingEngine(ARCH, EngineConfig(device="cpu", **kw),
                                params=_params()[1])
    assert streams == jstreams == _serve(step, work)[0]
    assert stats["horizon_steps"] >= 1
    assert (stats["decode_steps"], stats["horizon_steps"]) == \
        (jstats["decode_steps"], jstats["horizon_steps"])


def test_prefix_sharing_engine_is_warm_and_equals_jax():
    kw = dict(batch=2, max_len=32, prefill_len=16, clock="step")
    eng, jeng = _pair(
        EngineConfig(device="cpu", paging=PagingConfig(kv_block=4),
                     prefix=PrefixConfig(), **kw),
        JEngineConfig(paging=JPagingConfig(kv_block=4),
                      prefix=JPrefixConfig(), **kw))
    assert eng._prefix_tier1 and "prefill_offset" in eng.programs
    rng = np.random.default_rng(0)
    base = rng.integers(1, 500, size=12)
    fresh = rng.integers(1, 500, size=10)
    alt = rng.integers(1, 500, size=16)
    prompts = [base, base.copy(), np.concatenate([base[:9], alt[:3]]),
               np.concatenate([base[:8], alt[:7]]),
               np.concatenate([base[:4], alt[:10]]), fresh]
    work = [(p, 6, 0.0) for p in prompts]
    streams, stats = _serve(eng, work)
    jstreams, jstats = _serve(jeng, work)
    assert streams == jstreams
    for key in ("prefix_admissions", "warm_admissions",
                "prefix_tokens_reused"):
        assert stats[key] == jstats[key], key
    assert stats["warm_admissions"] >= 3, stats
    assert eng.programs["prefill_offset"].stats.executions == \
        stats["warm_admissions"]
    assert eng.pager.report()["prefix"] == jeng.pager.report()["prefix"]
    eng.pager.check_invariants()
    for (p, m, _), s in zip(work, streams):
        assert s == eng.reference_generate(p, m)
