"""Cross-request prefix sharing in the port, on the CPU, held against the
JAX package.

Same numpy-seeded inputs through both: the manager cases of
``tests/test_prefix.py`` driven on the reference's ``PagedKVManager`` and
the port's side by side (block tables, refcounts, ``report()["prefix"]``
and the arena's bytes equal after every operation; the port's arena has
one more block, the sink, left out); the ``-(p + 2)`` encoding;
``prefill_offset`` against the reference's on bridged paged caches
(rtol/atol 1e-4, fp32, as ``tests/test_torch_paging.py``); K1's plain
version with a query start against ``attention.reference_attention`` and
the reference's ``ref.flash_attention``; and the engine: the family x
{plain, spec, horizon} stream matrix against the port's
``reference_generate``, qwen3's streams against the JAX engine's, a
speculative request diverging inside a shared block, sharing under arena
pressure, a store carried into a fresh engine, and the stats and report.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.core import paging as jpaging
from repro.engine_config import EngineConfig as JEngineConfig
from repro.engine_config import PagingConfig as JPagingConfig
from repro.engine_config import PrefixConfig as JPrefixConfig
from repro.kernels import ref as jref
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge, steps
from repro_torch.core.paging import (PagedKVManager, PrefixStore,
                                     cache_leaves, decode_block_table,
                                     encode_shared, leaf_axis, leaf_kind)
from repro_torch.core.uva import UVARegistry
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig, PrefixConfig, SpecConfig)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.launch.serve import METRIC_PREFIX_HIT, ServingEngine
from repro_torch.models import attention as tattn
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m", "recurrentgemma-2b")


# ---------------------------------------------------------------------------
# the manager, side by side with the reference's
# ---------------------------------------------------------------------------
def _toy_jax(batch=2, n_phys=6, n_blocks=6, bs=2):
    """``tests/test_prefix.py``'s toy caches: group-stacked and tail arena
    leaves, no recurrent rows (block_bytes 128 at bs 2)."""
    z = functools.partial(np.zeros, dtype=np.float32)
    return {
        "pos": np.zeros((batch,), np.int32),
        "block_table": np.full((batch, n_blocks), -1, np.int32),
        "groups": {"slot0": {"k": z((3, n_phys, bs, 1, 2)),
                             "v": z((3, n_phys, bs, 1, 2))}},
        "tail": {"tail0": {"k": z((n_phys, bs, 1, 2)),
                           "v": z((n_phys, bs, 1, 2))}},
    }


def _to_torch(tree):
    return bridge._tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _with_sink(tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_sink(v, path + (k,)) for k, v in tree.items()}
    t = torch.from_numpy(tree.copy())
    if path[-1] in ("k", "v"):
        axis = 1 if path[0] == "groups" else 0
        t = torch.cat([t, torch.zeros_like(t.narrow(axis, 0, 1))], axis)
    return t


class Pair:
    """The reference's manager and the port's, driven by the same calls on
    caches of the same bytes; every call is followed by :meth:`check`."""

    def __init__(self, arena=6, jstore=None, tstore=None, n_phys=None,
                 uva=None):
        n_phys = arena if n_phys is None else n_phys
        self.jstore = jpaging.PrefixStore() if jstore is None else jstore
        self.tstore = PrefixStore() if tstore is None else tstore
        self.j = jpaging.PagedKVManager(arena, 128, kv_block=2,
                                        prefix_store=self.jstore)
        self.t = PagedKVManager(arena, 128, kv_block=2,
                                prefix_store=self.tstore, uva=uva)
        host = _toy_jax(n_phys=n_phys)
        self.jc = jax.tree.map(jnp.asarray, host)
        self.tc = _with_sink(host)
        self.n_phys = n_phys

    def call(self, op, *args, prompt=None, **kw):
        """``op`` on both; ``prompt`` passes each side's own
        ``match_prefix(prompt)`` as ``shared``."""
        jkw, tkw = dict(kw), dict(kw)
        if prompt is not None:
            jkw["shared"] = self.j.match_prefix(prompt)
            tkw["shared"] = self.t.match_prefix(prompt)
        self.jc = getattr(self.j, op)(*args, caches=self.jc, **jkw)
        out = getattr(self.t, op)(*args, caches=self.tc, **tkw)
        assert out is self.tc
        self.check()

    def match(self, prompt):
        js, ts = self.j.match_prefix(prompt), self.t.match_prefix(prompt)
        assert [sb.key for sb in js] == [sb.key for sb in ts]
        assert [sb.chunk for sb in js] == [sb.chunk for sb in ts]
        return ts

    def fill(self, rid, seed):
        """Random bytes into every arena block of ``rid``'s private set,
        the same on both sides; returns the groups-k values."""
        phys = self.t.pages[rid].phys
        assert phys == self.j.pages[rid].phys
        rng = np.random.default_rng(seed)
        gk = rng.standard_normal((3, len(phys), 2, 1, 2)).astype(np.float32)
        tk = rng.standard_normal((len(phys), 2, 1, 2)).astype(np.float32)
        idx = jnp.asarray(phys)
        self.jc["groups"]["slot0"]["k"] = \
            self.jc["groups"]["slot0"]["k"].at[:, idx].set(gk)
        self.jc["tail"]["tail0"]["k"] = \
            self.jc["tail"]["tail0"]["k"].at[idx].set(tk)
        self.tc["groups"]["slot0"]["k"][:, phys] = torch.from_numpy(gk)
        self.tc["tail"]["tail0"]["k"][phys] = torch.from_numpy(tk)
        self.check()
        return gk

    def check(self):
        np.testing.assert_array_equal(self.tc["block_table"].numpy(),
                                      np.asarray(self.jc["block_table"]))
        jrep, trep = self.j.report(), self.t.report()
        assert trep["prefix"] == jrep["prefix"]
        for key in ("free_blocks", "hits", "loads", "evictions",
                    "page_faults", "swap_outs", "grown_blocks",
                    "reclaimed_blocks", "tiers"):
            assert trep[key] == jrep[key], key
        assert {k: (sb.refs, sb.phys, sb.hits)
                for k, sb in self.t._shared.items()} == \
            {k: (sb.refs, sb.phys, sb.hits)
             for k, sb in self.j._shared.items()}
        assert sorted(self.t.free) == sorted(self.j.free)
        jleaves = cache_leaves(_to_torch(self.jc))
        for (path, leaf), (_, jleaf) in zip(cache_leaves(self.tc), jleaves):
            if leaf_kind(path) == "kv":
                leaf = leaf.narrow(leaf_axis(path), 0, self.n_phys)
            np.testing.assert_array_equal(leaf.numpy(), jleaf.numpy(),
                                          err_msg=str(path))
        self.j.check_invariants()
        self.t.check_invariants()

    def gathered(self, phys):
        """groups-k of physical blocks ``phys`` on the port's side."""
        return self.tc["groups"]["slot0"]["k"][:, phys].numpy()


def test_publish_match_refcount_evict_fault_roundtrip():
    m = Pair(arena=6)
    p0 = [1, 2, 3, 4, 5]
    m.call("admit", rid=0, n_blocks=3, slot=0)
    gk = m.fill(0, seed=0)
    m.call("publish", 0, p0, 0)
    assert m.t.published_blocks == 2 and len(m.tstore) == 2
    page0 = m.t.pages[0]
    assert len(page0.shared) == 2 and page0.n_private == 1
    row0 = m.tc["block_table"][0].tolist()
    assert row0[0] < -1 and row0[1] < -1 and row0[2] >= 0

    assert len(m.match([1, 2, 3, 4])) == 1
    assert m.match([]) == [] and m.match([1]) == []
    assert len(m.match([1, 2, 9, 9, 9])) == 1
    shared = m.match([1, 2, 3, 4, 7, 8, 9])
    assert [sb.chunk for sb in shared] == [(1, 2), (3, 4)]
    assert m.t.can_admit(1, 4, shared=shared)
    m.call("admit", rid=1, n_blocks=4, slot=1, prompt=[1, 2, 3, 4, 7, 8, 9])
    assert m.t.prefix_hits == 2
    assert all(sb.refs == 2 for sb in shared)
    np.testing.assert_array_equal(
        decode_block_table(m.tc["block_table"][1])[:2].numpy(),
        decode_block_table(m.tc["block_table"][0])[:2].numpy())

    m.call("release", 0, 0)
    m.call("release", 1, 1)
    assert all(sb.refs == 0 and sb.phys is not None for sb in shared)
    # an arena-wide admission evicts the cold shared blocks for free
    m.call("admit", rid=2, n_blocks=6, slot=0)
    assert m.t.shared_evictions == 2 and len(m.tstore) == 2
    assert all(sb.phys is None for sb in shared)
    m.call("release", 2, 0)
    # the trie still matches; admission faults the bytes back from host
    m.call("admit", rid=3, n_blocks=3, slot=0, prompt=p0)
    assert m.t.shared_faults == 2
    np.testing.assert_array_equal(m.gathered([sb.phys for sb in shared]),
                                  gk[:, :2])


def test_trie_rebuilds_from_store_across_engine_lifetimes():
    jstore, tstore = jpaging.PrefixStore(), PrefixStore()
    m1 = Pair(arena=6, jstore=jstore, tstore=tstore)
    m1.call("admit", rid=0, n_blocks=3, slot=0)
    gk = m1.fill(0, seed=1)
    m1.call("publish", 0, [1, 2, 3, 4, 5], 0)
    assert list(tstore.entries) == list(jstore.entries)   # the same keys
    m2 = Pair(arena=6, jstore=jstore, tstore=tstore)      # the reboot
    assert len(m2.t._shared) == 2
    shared = m2.match([1, 2, 3, 4, 5])
    assert all(sb.phys is None for sb in shared)
    m2.call("admit", rid=0, n_blocks=3, slot=0, prompt=[1, 2, 3, 4, 5])
    assert m2.t.shared_faults == 2
    np.testing.assert_array_equal(m2.gathered([sb.phys for sb in shared]),
                                  gk[:, :2])


def test_grow_and_trim_never_touch_shared_blocks():
    m = Pair(arena=8)
    m.call("admit", rid=0, n_blocks=3, slot=0)
    m.fill(0, seed=2)
    m.call("publish", 0, [1, 2, 3, 4, 5], 0)
    shared = m.match([1, 2, 3, 4, 6, 7])
    m.call("admit", rid=1, n_blocks=3, slot=1, prompt=[1, 2, 3, 4, 6, 7])
    shared_phys = [sb.phys for sb in shared]
    m.call("grow", 1, 5, 1)
    page = m.t.pages[1]
    assert page.n_blocks == 5 and page.n_private == 3
    assert not set(shared_phys) & set(page.phys)
    assert m.tc["block_table"][1, :2].tolist() == \
        [encode_shared(p) for p in shared_phys]
    m.call("trim_to_base", 1, 1)
    assert page.n_blocks == 3 and page.n_private == 1
    assert [sb.phys for sb in shared] == shared_phys
    assert not set(shared_phys) & set(m.t.free)
    assert all(sb.refs == 2 for sb in shared)
    row = m.tc["block_table"][1].tolist()
    assert row[3] == -1 and row[2] >= 0


def test_preempted_shared_head_unpins_evicts_and_faults_back():
    uva = UVARegistry("cpu")
    m = Pair(arena=6, uva=uva)
    m.call("admit", rid=0, n_blocks=3, slot=0)
    gk = m.fill(0, seed=3)
    m.call("publish", 0, [1, 2, 3, 4, 5], 0)
    assert sum(f"kvshare:{k}/0" in uva for k in m.tstore.entries) == 2
    m.call("release", 0, 0)
    shared = m.match([1, 2, 3, 4, 5])
    m.call("admit", rid=1, n_blocks=3, slot=0, prompt=[1, 2, 3, 4, 5])
    m.call("preempt", 1, 0)
    assert all(sb.refs == 1 for sb in shared)
    assert m.t.can_admit(2, 6)
    m.call("admit", rid=2, n_blocks=6, slot=1)
    assert m.t.swap_outs == 1 and m.t.shared_evictions == 2
    assert all(sb.phys is None and sb.refs == 1 for sb in shared)
    m.call("release", 2, 1)
    m.call("resume", 1, slot=0)
    assert m.t.page_faults == 1 and m.t.shared_faults == 2
    phys = [sb.phys for sb in shared]
    assert m.tc["block_table"][0, :2].tolist() == \
        [encode_shared(p) for p in phys]
    np.testing.assert_array_equal(m.gathered(phys), gk[:, :2])
    m.call("release", 1, 0)
    assert all(sb.refs == 0 for sb in shared)
    # finishing while preempted with a shared head
    m.call("admit", rid=3, n_blocks=3, slot=0, prompt=[1, 2, 3, 4, 5])
    m.call("preempt", 3, 0)
    m.call("release", 3, -1)
    assert all(sb.refs == 0 for sb in shared)


def test_shared_encoding_gathers_reads_and_drops_writes():
    """``-(phys + 2)`` is the whole write protection, in both packages:
    the gather decodes it, the write path drops into the sink."""
    host = np.arange(4 * 2, dtype=np.float32).reshape(4, 2, 1, 1)
    bt = np.asarray([[encode_shared(1), 2], [-1, -1]], np.int32)
    arena = torch.cat([torch.from_numpy(host), torch.zeros(1, 2, 1, 1)])
    out = tattn.gather_paged_kv(arena, torch.from_numpy(bt))
    jout = np.asarray(jattn.gather_paged_kv(jnp.asarray(host),
                                            jnp.asarray(bt)))
    np.testing.assert_array_equal(out[0].numpy(), jout[0])
    np.testing.assert_array_equal(out[0, :2].numpy(), host[1])
    np.testing.assert_array_equal(out[0, 2:].numpy(), host[2])
    val = torch.full((2, 1, 1), 99.0)
    live = torch.tensor([True, False])
    a2 = tattn.write_paged_kv(arena.clone(), torch.from_numpy(bt),
                              torch.tensor([0, 0]), val, live)
    np.testing.assert_array_equal(a2[:4].numpy(), host)
    a3 = tattn.write_paged_kv(arena.clone(), torch.from_numpy(bt),
                              torch.tensor([2, 0]), val, live)
    assert float(a3[2, 0, 0, 0]) == 99.0


# ---------------------------------------------------------------------------
# K1's plain version with a query start
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq", [1, 7, 16])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_ref_q_start(sq, window):
    rng = np.random.default_rng(sq + window)
    h, hk, sk, d, start = 4, 2, 40, 16, 13
    q = rng.standard_normal((h, sq, d)).astype(np.float32)
    k = rng.standard_normal((hk, sk, d)).astype(np.float32)
    v = rng.standard_normal((hk, sk, d)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    st = torch.tensor([start], dtype=torch.int32)
    got = flash_attention_ref(tq, tk, tv, window=window, q_start=st)
    want = tattn.reference_attention(
        tq.permute(1, 0, 2)[None], tk.permute(1, 0, 2)[None],
        tv.permute(1, 0, 2)[None], window=window, q_offset=start)
    np.testing.assert_allclose(got.numpy(), want[0].permute(1, 0, 2).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on the CPU, after its checks
    assert torch.equal(flash_attention(tq, tk, tv, window=window, q_start=st),
                       got)
    with pytest.raises(ValueError, match="one int32"):
        flash_attention(tq, tk, tv, q_start=torch.tensor([start, 3],
                                                         dtype=torch.int32))
    # the right-aligned start is the reference's kernel oracle's
    right = flash_attention_ref(
        tq, tk, tv, window=window,
        q_start=torch.tensor([sk - sq], dtype=torch.int32))
    jwant = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True,
                                            window=window))
    np.testing.assert_allclose(right.numpy(), jwant, rtol=3e-4, atol=3e-4)
    assert torch.equal(right, flash_attention_ref(tq, tk, tv, window=window))


# ---------------------------------------------------------------------------
# prefill_offset against the reference's
# ---------------------------------------------------------------------------
CACHE_LEN, PREFILL_LEN, KV_BLOCK, ARENA, SUFFIX = 64, 32, 8, 12, 16


@functools.lru_cache(maxsize=None)
def _models(arch, key=5):
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(key))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("offset,length", [(16, 17), (24, 31), (8, 24)])
def test_prefill_offset_matches_reference(offset, length):
    """Slot 1 maps a read-only shared head of offset / 8 blocks (drawn
    bytes), private blocks after it; its suffix runs at the offset."""
    jcfg, tcfg, jparams, tparams = _models("qwen3-0.6b")
    rng = np.random.default_rng(offset + length)
    n = CACHE_LEN // KV_BLOCK
    table = np.full((2, n), -1, np.int32)
    table[0, :3] = [7, 2, 9]
    head = [encode_shared(b) for b in (0, 4, 11)][:offset // KV_BLOCK]
    table[1, :len(head) + 3] = head + [1, 5, 3]
    cache = jax.tree.map(np.asarray, jtf.init_paged_cache(
        jcfg, 2, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA))
    cache = jax.tree.map(
        lambda x: x if x.dtype == np.int32
        else rng.standard_normal(x.shape).astype(x.dtype), cache)
    cache["block_table"] = table
    cache["pos"] = np.asarray([19, 0], np.int32)
    tokens = np.zeros((1, SUFFIX), np.int32)
    tokens[0, :length - offset] = rng.integers(1, jcfg.vocab_size,
                                               size=length - offset)

    jstep = jax.jit(jsteps.make_paged_prefill_offset_step(jcfg, RULES,
                                                          SUFFIX))
    jcache, jlast = jstep(jparams, jax.tree.map(jnp.asarray, cache),
                          jnp.asarray(tokens), jnp.int32(1),
                          jnp.int32(offset), jnp.int32(length))
    tcache = bridge.paged_cache_from_numpy(
        cache, tcfg, 2, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA,
        device="cpu")
    out, tlast = steps.make_paged_prefill_offset_step(tcfg, SUFFIX)(
        tparams, tcache, torch.from_numpy(tokens),
        torch.tensor(1, dtype=torch.int32),
        torch.tensor(offset, dtype=torch.int32),
        torch.tensor(length, dtype=torch.int32))
    assert out is tcache
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    assert tcache["pos"].tolist() == [19, length]
    # the valid suffix positions' K/V equal the reference's; the shared
    # head and slot 0's blocks kept their bytes.  The reference's scan
    # writes no padded position; the port writes them where they are
    # mapped (the cold prefill's rule), so those are left out
    got = dict(cache_leaves(_to_torch(bridge.paged_cache_to_numpy(tcache))))
    want = dict(cache_leaves(_to_torch(jcache)))
    before = dict(cache_leaves(_to_torch(cache)))
    for path, leaf in got.items():
        if leaf_kind(path) != "kv":
            continue
        axis = leaf_axis(path)
        for pos in range(offset, length):
            blk = table[1, pos // KV_BLOCK]
            np.testing.assert_allclose(
                leaf.select(axis, int(blk)).select(axis, pos % KV_BLOCK)
                .numpy(),
                want[path].select(axis, int(blk)).select(axis, pos % KV_BLOCK)
                .numpy(), **TOL, err_msg=str(path))
        for b in (0, 4, 11)[:len(head)] + (7, 2, 9):
            assert torch.equal(leaf.select(axis, b), before[path].select(
                axis, b)), (path, b)


def test_prefill_offset_refuses_recurrent_layers():
    _, tcfg, _, tparams = _models("recurrentgemma-2b")
    tcache = ttf.init_paged_cache(tcfg, 1, CACHE_LEN, kv_block=KV_BLOCK,
                                  arena_blocks=ARENA)
    with pytest.raises(ValueError, match="attention-only"):
        steps.make_paged_prefill_offset_step(tcfg, SUFFIX)(
            tparams, tcache, torch.zeros((1, SUFFIX), dtype=torch.int32),
            0, 8, 12)
    assert not steps.warm_prefix_capable(tcfg)
    assert steps.warm_prefix_capable(_models("qwen3-0.6b")[1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _prefix_cfg(mode, kv_block=4, max_len=32, prefill_len=16, **kw):
    return EngineConfig(
        batch=2, max_len=max_len, prefill_len=prefill_len, clock="step",
        device="cpu",
        paging=PagingConfig(kv_block=kv_block,
                            arena_blocks=kw.pop("arena_blocks", None),
                            timeslice=kw.pop("timeslice", None)),
        prefix=PrefixConfig(),
        spec=SpecConfig(k=3) if mode == "spec" else None,
        horizon=HorizonConfig(length=4) if mode == "horizon" else None, **kw)


def _sharing_workload(seed=0):
    """``tests/test_prefix.py``'s prompts against kv_block 4: a cold base,
    a repeat (warm), two divergences inside the warm suffix window, one
    long-suffix divergence (tier 2) and a fresh cold prompt."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 500, size=12).astype(np.int32)
    fresh = rng.integers(1, 500, size=10).astype(np.int32)
    alt = rng.integers(1, 500, size=16).astype(np.int32)
    return [base, base.copy(), np.concatenate([base[:9], alt[:3]]),
            np.concatenate([base[:8], alt[:7]]),
            np.concatenate([base[:4], alt[:10]]), fresh]


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = tregistry.get_config(arch, reduced=True)
    return ttf.init_params(cfg, 0)


@pytest.mark.parametrize("mode", ["plain", "spec", "horizon"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_sharing_streams_exact_all_families(arch, mode):
    eng = ServingEngine(arch, _prefix_cfg(mode), params=_params(arch))
    reqs = [eng.submit(p, max_new=6) for p in _sharing_workload()]
    assert all(r is not None for r in reqs)
    stats = eng.run()
    assert stats["requests"] == len(reqs)
    for r in reqs:
        ref = eng.reference_generate(r.prompt, r.max_new)
        assert r.generated == ref, (arch, mode, r.rid, r.generated, ref)
    eng.pager.check_invariants()
    rep = eng.pager.report()["prefix"]
    hc = eng.syscore.report()["hostcalls"]["metrics"]
    if arch == "qwen3-0.6b":
        assert eng._prefix_tier1 and "prefill_offset" in eng.programs
        assert stats["warm_admissions"] >= 3, stats
        assert stats["prefix_tokens_reused"] >= 3 * 8, stats
        assert rep["published_blocks"] >= 3
        assert hc[METRIC_PREFIX_HIT]["count"] == stats["prefix_admissions"]
        assert eng.programs["prefill_offset"].stats.executions == \
            stats["warm_admissions"]
    elif arch == "mamba2-130m":
        # attention-free: nothing to share
        assert rep["published_blocks"] == 0
        assert stats["prefix_admissions"] == 0, stats
    else:
        # recurrent state or MoE routing: storage shared, compute not
        assert "prefill_offset" not in eng.programs
        assert stats["prefix_admissions"] >= 3, stats
        assert stats["warm_admissions"] == 0, stats


def test_qwen3_prefix_streams_equal_jax_engine():
    jcfg, _, jparams, tparams = _models("qwen3-0.6b", key=7)
    eng = ServingEngine("qwen3-0.6b", _prefix_cfg("plain"), params=tparams)
    jeng = JServingEngine("qwen3-0.6b", JEngineConfig(
        reduced=True, batch=2, max_len=32, prefill_len=16, clock="step",
        paging=JPagingConfig(kv_block=4), prefix=JPrefixConfig()),
        params=jparams)
    assert repr(PrefixConfig()) == repr(JPrefixConfig())
    prompts = _sharing_workload(seed=3)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    stats, jstats = eng.run(), jeng.run()
    for key in ("prefix_admissions", "warm_admissions",
                "prefix_tokens_reused"):
        assert stats[key] == jstats[key], key
    assert stats["warm_admissions"] >= 3
    for r, jr in zip(reqs, jreqs):
        assert r.generated == jr.generated, (r.rid, r.generated,
                                             jr.generated)
    assert eng.pager.report()["prefix"] == jeng.pager.report()["prefix"]
    eng.pager.check_invariants()


def test_spec_divergence_inside_shared_prefix_block_exact():
    eng = ServingEngine("qwen3-0.6b", _prefix_cfg(
        "spec", kv_block=8, prefill_len=24), params=_params("qwen3-0.6b"))
    rng = np.random.default_rng(7)
    base = rng.integers(1, 500, size=17).astype(np.int32)
    mid = np.concatenate([base[:12],
                          rng.integers(1, 500, size=5).astype(np.int32)])
    reqs = [eng.submit(p, max_new=6) for p in (base, mid, base.copy())]
    eng.run()
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
    assert eng.prefix_admissions >= 2 and eng.warm_admissions >= 1
    eng.pager.check_invariants()
    # every resident trie block still equals its write-through store copy
    for sb in eng.pager._shared.values():
        if sb.phys is None:
            continue
        live = [leaf.index_select(leaf_axis(path), torch.tensor([sb.phys]))
                for path, leaf in cache_leaves(eng.caches)
                if leaf_kind(path) == "kv"]
        for got, want in zip(live, eng.prefix_store.get(sb.key)):
            assert torch.equal(got, want)


def test_prefix_sharing_under_arena_pressure_exact():
    eng = ServingEngine("qwen3-0.6b", _prefix_cfg(
        "plain", arena_blocks=8, timeslice=3), params=_params("qwen3-0.6b"))
    reqs = [eng.submit(p, max_new=6) for p in _sharing_workload(seed=5)]
    stats = eng.run()
    assert stats["requests"] == len(reqs)
    assert stats["preemptions"] >= 1
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
    eng.pager.check_invariants()
    assert eng.prefix_admissions >= 1


def test_prefix_stats_and_report_shape():
    eng = ServingEngine("qwen3-0.6b", _prefix_cfg("plain"),
                        params=_params("qwen3-0.6b"))
    p = np.arange(1, 13, dtype=np.int32)
    eng.submit(p, max_new=4)
    eng.submit(p.copy(), max_new=4)
    stats = eng.run()
    for key in ("prefix_admissions", "warm_admissions",
                "prefix_tokens_reused"):
        assert key in stats, key
    assert stats["warm_admissions"] == 1
    assert stats["prefix_tokens_reused"] == 8    # 2 blocks of 4
    rep = eng.pager.report()["prefix"]
    assert rep["trie_blocks"] == len(eng.prefix_store)
    assert rep["store"]["entries"] >= 3
    assert rep["store"]["host_bytes"] > 0


def test_store_outlives_its_engine_and_serves_warm():
    """A fresh engine on another's store rebuilds the trie and serves a
    repeat warm, its blocks faulted back from the host copies."""
    params = _params("qwen3-0.6b")
    first = ServingEngine("qwen3-0.6b", _prefix_cfg("plain"), params=params)
    p = np.arange(3, 15, dtype=np.int32)
    want = first.submit(p, max_new=5)
    first.run()
    second = ServingEngine("qwen3-0.6b", _prefix_cfg("plain"), params=params,
                           prefix_store=first.prefix_store)
    req = second.submit(p.copy(), max_new=5)
    stats = second.run()
    assert stats["warm_admissions"] == 1
    assert second.pager.shared_faults == 2
    assert req.generated == want.generated
    second.pager.check_invariants()


def test_engine_config_prefix_rules():
    cfg = EngineConfig(max_len=32, paging=PagingConfig(kv_block=4),
                       prefix=PrefixConfig())
    assert cfg.resolved_prefix_suffix == 8
    with pytest.raises(ValueError, match="paging"):
        EngineConfig(prefix=PrefixConfig())
    with pytest.raises(ValueError, match="max_suffix"):
        EngineConfig(max_len=32, prefill_len=8,
                     paging=PagingConfig(kv_block=8), prefix=PrefixConfig())
    with pytest.raises(ValueError, match="min_blocks"):
        PrefixConfig(min_blocks=0)
