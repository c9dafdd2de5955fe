"""Burst admission in the port, on the CPU, held against the JAX package:
the whole-batch ``prefill`` program against the reference's
``make_prefill_step`` on bridged weights and caches (rtol/atol 1e-4,
fp32, the four served families), and the ``group_prefill`` engine
(``tests/test_serving.py``'s burst case): one ``prefill`` execution admits
the burst, later arrivals go through ``prefill_slot``, and every stream
equals the port's ``reference_generate``."""
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
from repro_torch.engine_config import EngineConfig, PagingConfig, SpecConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m", "recurrentgemma-2b")
RULES = make_rules()
TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _params(arch):
    return ttf.init_params(tregistry.get_config(arch, reduced=True), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(11))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
    batch, cache_len, s = 3, 64, 32
    rng = np.random.default_rng(12)
    tokens = rng.integers(1, jcfg.vocab_size, size=(batch, s)).astype(np.int32)
    lengths = np.asarray([32, 9, 20], np.int32)
    for b, n in enumerate(lengths):
        tokens[b, n:] = 0
    # the live cache holds an earlier batch's bytes: every row is rewritten
    live = jax.tree.map(np.asarray, jtf.init_cache(jcfg, batch, cache_len))
    live = jax.tree.map(lambda x: x if x.dtype == np.int32 else
                        rng.standard_normal(x.shape).astype(x.dtype), live)
    live["pos"] = np.asarray([40, 3, 17], np.int32)
    jcache, jlast = jax.jit(jsteps.make_prefill_step(jcfg, RULES))(
        jparams, jax.tree.map(jnp.asarray, live),
        {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)})
    tcache = bridge.cache_from_numpy(live, tcfg, batch, cache_len, "cpu")
    out, tlast = steps.make_prefill_step(tcfg)(
        tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert out is tcache
    assert tlast.shape == (batch, tcfg.padded_vocab)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    for path, leaf in _leaves(bridge.cache_to_numpy(tcache)):
        np.testing.assert_allclose(leaf, want[path], **TOL, err_msg=path)
    assert tcache["pos"].tolist() == lengths.tolist()



@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_group_prefill_burst_matches_slot_references(arch):
    """A burst admitted by one whole-batch prefill execution gives the
    streams of per-slot admission (``tests/test_serving.py:182``)."""
    eng = ServingEngine(arch, EngineConfig(batch=2, max_len=64, clock="step",
                                           device="cpu", group_prefill=True),
                        params=_params(arch))
    assert set(eng.programs) == {"prefill", "prefill_slot", "decode"}
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=n), 6)
            for n in (4, 7)]
    eng.run()
    progs = eng.syscore.report()["programs"]
    assert progs["prefill"]["executions"] == 1
    assert progs["prefill_slot"]["executions"] == 0
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


def test_burst_then_refills_through_prefill_slot():
    """The chip's phase-17 traffic at reduced size: a burst of ``batch``
    requests at step 0, then four arrivals admitted one by one into a
    busy batch; an idle engine facing a single due request admits it
    through ``prefill_slot`` (a burst needs two)."""
    arch = "qwen3-0.6b"
    eng = ServingEngine(arch, EngineConfig(batch=4, max_len=64, clock="step",
                                           device="cpu", group_prefill=True),
                        params=_params(arch))
    rng = np.random.default_rng(4)
    # the burst's budgets differ, so its slots free one at a time while
    # the others still decode
    work = zip(rng.integers(3, 30, size=8), [5, 9, 13, 17, 8, 8, 8, 8],
               [0, 0, 0, 0, 1, 2, 3, 4])
    reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=int(n)),
                       int(m), arrival_time=a) for n, m, a in work]
    stats = eng.run()
    progs = eng.syscore.report()["programs"]
    assert progs["prefill"]["executions"] == 1
    assert progs["prefill_slot"]["executions"] == 4
    assert stats["admitted"] == 8 and stats["refill_admissions"] >= 1
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
    lone = eng.submit(np.arange(1, 9), 4)
    eng.run()
    assert eng.programs["prefill"].stats.executions == 1
    assert lone.generated == eng.reference_generate(lone.prompt, 4)


def test_group_prefill_builds_its_program_and_refuses_paging_or_spec():
    assert EngineConfig(group_prefill=True).group_prefill
    with pytest.raises(ValueError, match="incompatible with paging"):
        EngineConfig(group_prefill=True, paging=PagingConfig())
    with pytest.raises(ValueError, match="speculative"):
        EngineConfig(group_prefill=True, spec=SpecConfig())
