"""The port's paged KV arena on the CPU, held against the JAX package.

Same numpy-seeded inputs through both: the dynamic-call table under one
seeded sequence of operations; the block-table gather, write and
rollback (unmapped entries, read-only shared encodings, positions past
the table); the paged ``prefill_slot`` and ``decode_step`` for the four
served families, caches equal (the arena over the reference's
``arena_blocks``: the port's last block is the sink of dropped writes)
and logits at the model tolerance of the other port tests (rtol/atol
1e-4, fp32); the manager cases of ``tests/test_paging.py`` re-asserted in
the port; ``benchmarks/bench_paging.py``'s smoke workload through the
port's paged engine, equal to its unpaged engine and to the JAX paged
engine on bridged weights; and the rules a CUDA graph replay rests on
(the trees keep their storage through preemption and page faults, the
block table boots unmapped).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.core import dynamic_calls as jdc
from repro.core import placement as jplacement
from repro.engine_config import EngineConfig as JEngineConfig
from repro.engine_config import PagingConfig as JPagingConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.sharding import make_rules
from repro_torch import bridge, steps
from repro_torch.core import dynamic_calls, placement
from repro_torch.core.paging import (PagedKVManager, PrefixStore,
                                     decode_block_table, encode_shared)
from repro_torch.core.uva import UVARegistry
from repro_torch.engine_config import EngineConfig, PagingConfig
from repro_torch.launch.serve import (METRIC_ARENA_OCCUPANCY,
                                      METRIC_PAGE_FAULT, ServingEngine)
from repro_torch.models import attention as tattn
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m", "recurrentgemma-2b")
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN, PREFILL_LEN, KV_BLOCK, ARENA = 64, 32, 8, 12


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# dynamic-call table, UVA registry, placement
# ---------------------------------------------------------------------------
def _drive_tables(seed):
    """One seeded operation sequence through both tables; returns the
    per-step (residency, report) of each and their eviction orders."""
    rng = np.random.default_rng(seed)
    evicted = {"jax": [], "torch": []}
    tables = {
        "jax": jdc.DynamicCallTable(
            1000, on_evict=lambda e: evicted["jax"].append(e.name)),
        "torch": dynamic_calls.DynamicCallTable(
            1000, on_evict=lambda e: evicted["torch"].append(e.name),
            device="cpu")}
    trace = {"jax": [], "torch": []}
    names = [f"p{i}" for i in range(10)]
    registered = set()
    for _ in range(300):
        op = rng.choice(["register", "call", "call", "call", "pin", "unpin",
                         "resize", "reset", "remove"],
                        p=[.15, .2, .2, .2, .08, .08, .04, .02, .03])
        name = str(rng.choice(names))
        size = int(rng.integers(50, 400))
        pinned = bool(rng.random() < 0.1)
        new_size = int(rng.integers(10, 300))
        for key, t in tables.items():
            try:
                if op == "register":
                    t.register(name, lambda n=name: n, size, pinned=pinned)
                elif name not in registered:
                    continue
                elif op == "call":
                    assert t.call(name) == name
                elif op == "pin":
                    t.pin(name)
                elif op == "unpin":
                    if t.is_pinned(name):
                        t.unpin(name)
                elif op == "resize":
                    e = t._entries[name]
                    if e.value is not None and t.resident_bytes \
                            - e.size_bytes + new_size <= t.capacity:
                        t.resize(name, new_size)
                elif op == "reset":
                    t.reset()
                else:
                    t.remove(name)
                outcome = "ok"
            except (MemoryError, KeyError) as err:
                outcome = type(err).__name__
            trace[key].append((op, name, outcome, sorted(t.resident()),
                               t.evictable_bytes, t.is_resident(name),
                               t.report()))
        if op == "register":
            registered.add(name)
        elif op == "remove":
            registered.discard(name)
    return trace, evicted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_call_table_matches_reference(seed):
    trace, evicted = _drive_tables(seed)
    assert trace["torch"] == trace["jax"]
    assert evicted["torch"] == evicted["jax"]
    assert len(evicted["jax"]) >= 5          # the LRU actually evicted
    assert any(step[2] == "MemoryError" for step in trace["jax"]) or seed


def test_host_pages_and_expert_store_load_bit_exact():
    table = dynamic_calls.DynamicCallTable(1 << 20, device="cpu")
    host = torch.randn(4, 8).to(torch.bfloat16)
    e = table.register_host_array("w", host)
    assert e.size_bytes == 64
    out = table.call("w")
    assert torch.equal(out.view(torch.int16), host.view(torch.int16))
    store = dynamic_calls.PagedExpertStore(table)
    weights = {"up": torch.randn(3, 5), "down": {"w": torch.randn(5, 3)}}
    name = store.add_expert(2, 7, weights)
    assert name == "L2/E7" and table._entries[name].size_bytes == 120
    got = store.lookup(2, 7)
    assert torch.equal(got["down"]["w"], weights["down"]["w"])
    store.lookup(2, 7)
    assert store.hot_set(1) == ["L2/E7"] and table._entries[name].hits == 1


def test_uva_registry_roundtrip_and_no_sharding():
    uva = UVARegistry("cpu")
    src = torch.randn(6).to(torch.bfloat16)
    uva.bind_host("a", src)
    assert torch.equal(uva.to_device("a").view(torch.int16),
                       src.view(torch.int16))
    uva.write("a", torch.tensor([1.5, 2.5]), offset=2)
    assert uva.read("a", count=2, offset=2).tolist() == [1.5, 2.5]
    dev = uva.to_device("a")
    assert dev[2].item() == 1.5                       # dirty host re-copied
    uva.update_device("a", dev * 2)
    assert uva.read("a")[3].item() == 5.0             # synced back
    buf = uva.bind_device("b", torch.arange(4, dtype=torch.int32))
    assert buf.host.tolist() == [0, 0, 0, 0]
    assert uva.read("b").tolist() == [0, 1, 2, 3]
    assert uva.report()["a"] == {"shape": [6], "dtype": "bfloat16",
                                 "bytes": 12, "on_device": True}
    uva.free("a")
    assert "a" not in uva and "b" in uva
    with pytest.raises(NotImplementedError, match="item 13"):
        uva.alloc("c", (2,), torch.float32, sharding="model")


def test_placement_report_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"embed": rng.standard_normal((8, 4)).astype(np.float32),
            "groups": {"moe": {"w_up": rng.standard_normal((4, 6, 2))
                               .astype(np.float32),
                               "router": rng.standard_normal((6, 4))
                               .astype(np.float32)}},
            "final_norm": rng.standard_normal((4,)).astype(np.float32)}
    plan = (jplacement.PlacementPlan()
            .add(r"moe/w_", jplacement.DYNAMIC).add(r"norm",
                                                   jplacement.USRMEM))
    tplan = placement.PlacementPlan(rules=list(plan.rules))
    jplaced = jplacement.apply_plan(tree, plan, arena_bytes=4096)
    tplaced = placement.apply_plan(
        {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {a: {b: torch.from_numpy(c) for b, c in d.items()}
              for a, d in v.items()}) for k, v in tree.items()},
        tplan, arena_bytes=4096, device="cpu")
    assert tplaced.report() == jplaced.report()
    assert tplaced.classes == jplaced.classes
    assert placement.footprint(tplaced.materialize()) == \
        jplacement.footprint(tree)
    got = tplaced.materialize()["groups"]["moe"]["w_up"]
    np.testing.assert_array_equal(got.numpy(), tree["groups"]["moe"]["w_up"])
    for _ in range(2):                   # a load, then a hit, as the port's
        jplaced.materialize()
    assert tplaced.dc_table.report()["pages"] == \
        jplaced.dc_table.report()["pages"]


# ---------------------------------------------------------------------------
# block-table gather / write / rollback
# ---------------------------------------------------------------------------
P, BS, M, H, D = 6, 4, 5, 2, 3
# rows: private blocks, a shared head then private, one fully unmapped,
# and one whose reservation ends early (-1 past block 1)
TABLE = np.array([[0, 3, 5, -1, -1],
                  [encode_shared(1), encode_shared(4), 2, -1, -1],
                  [-1, -1, -1, -1, -1],
                  [4, 1, -1, -1, -1]], np.int32)
WRITE_CASES = {
    "mapped": [1, 9, 0, 5],             # row 2 unmapped drops
    "shared_and_past_table": [3, 2, 7, 4 * M + 3],
    "past_reservation": [6, 20, 1, 9],  # rows 1 and 3 land on -1 entries
    "all_dropped": [13, 4, 2, 4 * M],
}


def _arenas(rng, dtype=np.float32):
    """The reference's (P, BS, H, D) arena and the port's, the same plus a
    sink block of its own random bytes."""
    ref = rng.standard_normal((P, BS, H, D)).astype(dtype)
    sink = rng.standard_normal((1, BS, H, D)).astype(dtype)
    return ref, torch.from_numpy(np.concatenate([ref, sink]))


def test_gather_paged_kv_matches_reference():
    ref, arena = _arenas(np.random.default_rng(0))
    want = np.asarray(jattn.gather_paged_kv(jnp.asarray(ref),
                                            jnp.asarray(TABLE)))
    got = tattn.gather_paged_kv(arena, torch.from_numpy(TABLE))
    assert got.shape == (4, M * BS, H, D)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        decode_block_table(TABLE).numpy(),
        np.where(TABLE >= 0, TABLE, -TABLE - 2))


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_paged_kv_matches_reference(case):
    rng = np.random.default_rng(1)
    ref, arena = _arenas(rng)
    before = arena.clone()
    pos = np.asarray(WRITE_CASES[case], np.int32)
    val = rng.standard_normal((4, H, D)).astype(np.float32)
    want = np.asarray(jattn.write_paged_kv(
        jnp.asarray(ref), jnp.asarray(TABLE), jnp.asarray(pos),
        jnp.asarray(val)))
    out = tattn.write_paged_kv(arena, torch.from_numpy(TABLE),
                               torch.from_numpy(pos), torch.from_numpy(val))
    assert out is arena
    np.testing.assert_array_equal(arena[:P].numpy(), want)
    if case == "all_dropped":
        # every row dropped: the pager's blocks keep their bytes
        assert torch.equal(arena[:P], before[:P])
    # a fused horizon's frozen rows (live False) drop as well
    live = np.asarray([True, False, True, False])
    want = np.asarray(jattn.write_paged_kv(
        jnp.asarray(ref), jnp.asarray(TABLE), jnp.asarray(pos),
        jnp.asarray(val), live=jnp.asarray(live)))
    arena.copy_(before)
    tattn.write_paged_kv(arena, torch.from_numpy(TABLE),
                         torch.from_numpy(pos), torch.from_numpy(val),
                         live=torch.from_numpy(live))
    np.testing.assert_array_equal(arena[:P].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_rollback_paged_kv_matches_reference(seed):
    rng = np.random.default_rng(seed + 10)
    ref, arena = _arenas(rng)
    orig, orig_t = _arenas(rng)
    pos_cand = np.stack([np.arange(s, s + 4) for s in (2, 9, 0, 6)]) \
        .astype(np.int32)
    pos_cand[1, 3] = 4 * M + 1                  # past the table
    reject = rng.random((4, 4)) < 0.6
    reject[1, 3] = True
    want = np.asarray(jattn.rollback_paged_kv(
        jnp.asarray(ref), jnp.asarray(orig), jnp.asarray(TABLE),
        jnp.asarray(pos_cand), jnp.asarray(reject)))
    tattn.rollback_paged_kv(arena, orig_t, torch.from_numpy(TABLE),
                            torch.from_numpy(pos_cand),
                            torch.from_numpy(reject))
    np.testing.assert_array_equal(arena[:P].numpy(), want)


# ---------------------------------------------------------------------------
# paged prefill_slot and decode_step against the reference
# ---------------------------------------------------------------------------
def _models(arch, key=5):
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(key))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _paged_cache(jcfg, batch, table, pos, rng):
    """A JAX paged cache tree (numpy leaves) with every arena and state
    leaf drawn, ``table`` as its block table and ``pos``."""
    cache = jax.tree.map(np.asarray, jtf.init_paged_cache(
        jcfg, batch, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA))
    cache = jax.tree.map(
        lambda x: x if x.dtype == np.int32
        else rng.standard_normal(x.shape).astype(x.dtype), cache)
    cache["block_table"] = np.asarray(table, np.int32)
    cache["pos"] = np.asarray(pos, np.int32)
    return cache


def _assert_caches_equal(tcache, jcache):
    want = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    got = dict(_leaves(bridge.paged_cache_to_numpy(tcache)))
    assert set(got) == set(want)
    for path, leaf in got.items():
        if leaf.dtype == np.int32:
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)
        else:
            np.testing.assert_allclose(leaf, want[path], **TOL,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_slot_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(6)
    n = CACHE_LEN // KV_BLOCK
    table = np.full((2, n), -1, np.int32)
    table[0, :3] = [7, 2, 9]
    # slot 1: a read-only shared head, then private blocks, then unmapped
    table[1, :5] = [encode_shared(0), 4, 11, 1, 5]
    live = _paged_cache(jcfg, 2, table, [17, 3], rng)
    length = 23
    tokens = np.zeros((1, PREFILL_LEN), np.int32)
    tokens[0, :length] = rng.integers(1, jcfg.vocab_size, size=length)

    jstep = jax.jit(jsteps.make_paged_prefill_slot_step(
        jcfg, RULES, CACHE_LEN, KV_BLOCK))
    jcache, jlast = jstep(jparams, jax.tree.map(jnp.asarray, live),
                          jnp.asarray(tokens), jnp.int32(1),
                          jnp.int32(length))
    tcache = bridge.paged_cache_from_numpy(
        live, tcfg, 2, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA,
        device="cpu")
    out, tlast = steps.make_paged_prefill_slot_step(
        tcfg, CACHE_LEN, KV_BLOCK)(
        tparams, tcache, torch.from_numpy(tokens),
        torch.tensor(1, dtype=torch.int32),
        torch.tensor(length, dtype=torch.int32))
    assert out is tcache
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_caches_equal(tcache, jcache)
    assert int(tcache["pos"][1]) == length and int(tcache["pos"][0]) == 17
    # the shared head (physical block 0) and slot 0's blocks kept their
    # bytes: the reference dropped those writes, the port sank them
    for path, leaf in _leaves(bridge.paged_cache_to_numpy(tcache)):
        if path.endswith(("/k", "/v")):
            axis = 1 if path.startswith("/groups") else 0
            for b in (0, 7, 2, 9):
                np.testing.assert_array_equal(
                    np.take(leaf, b, axis=axis),
                    np.take(dict(_leaves(live))[path], b, axis=axis))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch, key=8)
    rng = np.random.default_rng(9)
    n = CACHE_LEN // KV_BLOCK
    table = np.full((4, n), -1, np.int32)
    table[0, :4] = [3, 0, 8, 6]                      # private, pos 27
    table[1, :3] = [encode_shared(5), encode_shared(1), 10]   # shared head
    # row 2 unmapped: frozen; row 3 writes past its reservation: dropped
    table[3, :2] = [2, 4]
    pos = [27, 19, 12, 16]
    live = _paged_cache(jcfg, 4, table, pos, rng)
    token = rng.integers(1, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    jlogits, jcache = jax.jit(
        lambda p, c, t: jtf.decode_step(jcfg, p, c, t, rules=RULES))(
        jparams, jax.tree.map(jnp.asarray, live), jnp.asarray(token))
    tcache = bridge.paged_cache_from_numpy(
        live, tcfg, 4, CACHE_LEN, kv_block=KV_BLOCK, arena_blocks=ARENA,
        device="cpu")
    tlogits, out = ttf.decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(token))
    assert out is tcache
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_caches_equal(tcache, jcache)
    assert tcache["pos"].tolist() == [28, 20, 12, 17]


def test_paged_cache_bridge_roundtrip_and_sink():
    jcfg = jregistry.get_config("recurrentgemma-2b", reduced=True)
    tcfg = tregistry.get_config("recurrentgemma-2b", reduced=True)
    live = _paged_cache(jcfg, 2, np.full((2, 8), -1), [0, 0],
                        np.random.default_rng(3))
    t = bridge.paged_cache_from_numpy(live, tcfg, 2, CACHE_LEN,
                                      kv_block=KV_BLOCK, arena_blocks=ARENA,
                                      device="cpu")
    # "L" layers keep their full logical length: no ring in the arena
    assert tuple(t["groups"]["slot2"]["k"].shape) == (1, ARENA + 1, KV_BLOCK,
                                                      1, 16)
    assert not t["groups"]["slot2"]["k"][:, ARENA].any()
    back = dict(_leaves(bridge.paged_cache_to_numpy(t)))
    for path, leaf in _leaves(live):
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    with pytest.raises(ValueError, match="block_table"):
        bad = dict(live, block_table=np.zeros((2, 4), np.int32))
        bridge.paged_cache_from_numpy(bad, tcfg, 2, CACHE_LEN,
                                      kv_block=KV_BLOCK, arena_blocks=ARENA,
                                      device="cpu")
    assert ttf.paged_block_bytes(tcfg, KV_BLOCK) == \
        jtf.paged_block_bytes(jcfg, KV_BLOCK)


# ---------------------------------------------------------------------------
# the manager (tests/test_paging.py's cases, in the port)
# ---------------------------------------------------------------------------
def _toy_caches(dtype, batch=2, n_phys=4, n_blocks=4, bs=2):
    """The real layout at toy size: group-stacked arena leaves (layers axis
    first), a tail arena leaf, per-slot recurrent state leaves; each arena
    with its sink block."""
    z = dict(dtype=dtype)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32),
        "block_table": torch.full((batch, n_blocks), -1, dtype=torch.int32),
        "groups": {"slot0": {"k": torch.zeros((3, n_phys + 1, bs, 1, 2), **z),
                             "v": torch.zeros((3, n_phys + 1, bs, 1, 2), **z)},
                   "slot1": {"state": torch.zeros((3, batch, 5), **z)}},
        "tail": {"tail0": {"k": torch.zeros((n_phys + 1, bs, 1, 2), **z),
                           "v": torch.zeros((n_phys + 1, bs, 1, 2), **z)},
                 "tail1": {"conv": torch.zeros((batch, 3), **z)}},
    }


def _mapped(caches, slot):
    return [b for b in caches["block_table"][slot].tolist() if b >= 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pager_swap_roundtrip_preserves_blocks_and_state(dtype):
    mgr = PagedKVManager(4, 128)
    caches = _toy_caches(dtype)
    storage = [t.data_ptr() for _, t in _leaves(caches)]
    caches = mgr.admit(rid=0, n_blocks=2, slot=0, caches=caches)
    row0 = caches["block_table"][0].tolist()
    phys0 = _mapped(caches, 0)
    assert len(phys0) == 2 and row0[2] == -1

    g = torch.Generator().manual_seed(0)
    gk = torch.randn((3, 2, 2, 1, 2), generator=g).to(dtype)
    tk = torch.randn((2, 2, 1, 2), generator=g).to(dtype)
    st = torch.randn((3, 5), generator=g).to(dtype)
    caches["groups"]["slot0"]["k"][:, phys0] = gk
    caches["tail"]["tail0"]["k"][phys0] = tk
    caches["groups"]["slot1"]["state"][:, 0] = st

    caches = mgr.preempt(0, 0, caches)
    assert caches["block_table"][0].tolist() == [-1] * 4
    assert mgr.table.is_resident("kv:0")       # lazy: not yet written back
    caches = mgr.admit(rid=1, n_blocks=3, slot=1, caches=caches)
    assert not mgr.table.is_resident("kv:0")
    assert mgr.swap_outs == 1 and len(mgr.free) == 1
    assert not mgr.can_admit(0, 2)             # rid 1 is pinned: no room
    caches = mgr.release(1, 1, caches)
    assert mgr.can_admit(0, 2)
    caches["groups"]["slot0"]["k"].zero_()     # the arena forgets
    caches["groups"]["slot1"]["state"].zero_()

    caches = mgr.resume(0, slot=0, caches=caches)
    assert mgr.page_faults == 1
    phys1 = _mapped(caches, 0)
    # bit for bit through the host tier
    assert torch.equal(caches["groups"]["slot0"]["k"][:, phys1].view(
        torch.uint8), gk.view(torch.uint8))
    assert torch.equal(caches["tail"]["tail0"]["k"][phys1].view(torch.uint8),
                       tk.view(torch.uint8))
    assert torch.equal(caches["groups"]["slot1"]["state"][:, 0]
                       .view(torch.uint8), st.view(torch.uint8))
    assert mgr.table.resident_bytes <= mgr.table.capacity
    assert [t.data_ptr() for _, t in _leaves(caches)] == storage
    rep = mgr.report()
    assert rep["page_faults"] == 1 and rep["swap_outs"] == 1
    assert rep["swap_out_ms"] > 0 and rep["page_fault_ms"] > 0
    mgr.check_invariants()


def test_release_while_preempted_no_double_free_no_host_leak():
    uva = UVARegistry("cpu")
    mgr = PagedKVManager(4, 128, uva=uva)
    caches = _toy_caches(torch.float32)
    caches = mgr.admit(rid=0, n_blocks=1, slot=0, caches=caches)
    caches = mgr.preempt(0, 0, caches)
    caches = mgr.release(0, -1, caches)
    assert sorted(mgr.free) == list(range(4))
    mgr.check_invariants()

    caches = mgr.admit(rid=1, n_blocks=2, slot=0, caches=caches)
    caches = mgr.preempt(1, 0, caches)
    caches = mgr.admit(rid=2, n_blocks=3, slot=1, caches=caches)  # evicts 1
    assert mgr.swap_outs == 1
    assert "kvpage:1/0" in uva
    before = caches["block_table"].clone()
    caches = mgr.release(1, -1, caches)
    assert torch.equal(caches["block_table"], before)
    assert "kvpage:1/0" not in uva
    assert len(mgr.free) == 1
    mgr.check_invariants()
    caches = mgr.release(2, 1, caches)
    assert sorted(mgr.free) == list(range(4))
    mgr.check_invariants()


def test_grow_and_trim_to_base_and_prefix_raises():
    mgr = PagedKVManager(6, 16)
    caches = _toy_caches(torch.float32, n_phys=6, n_blocks=5)
    caches = mgr.admit(rid=0, n_blocks=2, slot=1, caches=caches)
    caches = mgr.grow(0, 4, 1, caches)
    assert len(_mapped(caches, 1)) == 4 and mgr.grown_blocks == 2
    mgr.check_invariants()
    caches = mgr.trim_to_base(0, 1, caches)
    assert len(_mapped(caches, 1)) == 2 and mgr.reclaimed_blocks == 2
    assert len(mgr.free) == 4
    mgr.check_invariants()
    # prefix sharing over a real store: rid 0 publishes its two full
    # blocks, rid 1 maps them read-only and takes one private block
    mgr = PagedKVManager(6, 16, kv_block=2, prefix_store=PrefixStore())
    caches = _toy_caches(torch.float32, n_phys=6, n_blocks=5)
    caches = mgr.admit(rid=0, n_blocks=3, slot=0, caches=caches)
    caches = mgr.publish(0, [1, 2, 3, 4, 5], 0, caches)
    shared = mgr.match_prefix([1, 2, 3, 4, 9])
    assert [sb.chunk for sb in shared] == [(1, 2), (3, 4)]
    caches = mgr.admit(1, 3, 1, caches, shared=shared)
    row = caches["block_table"][1].tolist()
    assert row[:2] == [encode_shared(sb.phys) for sb in shared]
    assert row[2] >= 0 and row[3:] == [-1, -1]
    assert all(sb.refs == 2 for sb in shared)
    assert mgr.report()["prefix"]["prefix_hits"] == 2
    mgr.check_invariants()


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def _paged(arch="qwen3-0.6b", batch=2, max_len=32, arena=8, timeslice=None,
           params=None):
    return ServingEngine(arch, EngineConfig(
        batch=batch, max_len=max_len, clock="step", device="cpu",
        paging=PagingConfig(kv_block=8, arena_blocks=arena,
                            timeslice=timeslice)), params=params)


def test_engine_config_paging_rules():
    cfg = EngineConfig(batch=2, max_len=32, paging=PagingConfig())
    assert cfg.paged and not EngineConfig().paged
    assert cfg.paging.resolved_arena_blocks(2, 32) == 8
    with pytest.raises(ValueError, match="divide"):
        EngineConfig(max_len=36, paging=PagingConfig(kv_block=8))
    with pytest.raises(ValueError, match="incompatible with paging"):
        EngineConfig(paging=PagingConfig(), group_prefill=True)
    with pytest.raises(ValueError, match="timeslice"):
        PagingConfig(timeslice=0)


def test_paged_engine_under_pressure_is_token_exact_and_reports():
    eng = _paged(batch=4, arena=8, timeslice=3)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(1, 500, size=int(rng.integers(4, 12))),
                       max_new=int(rng.integers(4, 9))) for _ in range(8)]
    stats = eng.run()
    assert stats["requests"] == 8
    assert stats["preemptions"] >= 1
    assert stats["swap_outs"] >= 1 and stats["page_faults"] >= 1
    assert 0 < stats["arena_occupancy"] <= 1.0
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
    hc = eng.syscore.report()["hostcalls"]["metrics"]
    assert hc[METRIC_PAGE_FAULT]["count"] == stats["page_faults"]
    assert hc[METRIC_ARENA_OCCUPANCY]["count"] == stats["decode_steps"]
    rep = eng.pager.report()
    assert rep["evictions"] == rep["swap_outs"] >= 1
    assert rep["loads"] >= 8
    eng.pager.check_invariants()


def test_paged_arena_reset_is_lossless():
    eng = _paged()
    r1 = eng.submit(np.arange(1, 7), max_new=8)
    for _ in range(3):
        eng.step()
    eng.preempt(r1)
    eng.caches = eng.pager.reset(eng.caches)        # invalidate the arena
    assert eng.pager.swap_outs == 1                 # written back, not lost
    assert len(eng.pager.free) == eng.pager.arena_blocks
    eng.run()
    assert eng.pager.page_faults == 1
    assert r1.generated == eng.reference_generate(r1.prompt, r1.max_new)


def test_paged_cooperative_preempt_resume():
    eng = _paged()
    r1 = eng.submit(np.arange(1, 7), max_new=8)
    r2 = eng.submit(np.arange(3, 8), max_new=6)
    for _ in range(3):
        eng.step()
    eng.preempt(r1)
    assert r1.slot == -1 and r1.needs_resume
    eng.run()
    assert eng.preemptions == 1 and eng.swap_ins == 1
    assert eng.pager.hits >= 1 and eng.pager.page_faults == 0
    for r in (r1, r2):
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


def test_paged_admission_defers_until_blocks_free():
    eng = _paged(arena=2)
    r1 = eng.submit(np.arange(1, 9), max_new=6)     # 14 tokens -> 2 blocks
    r2 = eng.submit(np.arange(2, 10), max_new=6)
    max_active = 0
    while eng.step():
        max_active = max(max_active, sum(s is not None for s in eng.slots))
    assert max_active == 1                          # never co-resident
    for r in (r1, r2):
        assert r.done
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


def test_paged_victim_requeued_ahead_of_waiter_is_not_lost():
    eng = _paged(arena=2, timeslice=2)
    r1 = eng.submit(np.arange(1, 9), max_new=6, arrival_time=0.0)
    r2 = eng.submit(np.arange(2, 10), max_new=6, arrival_time=3.0)
    stats = eng.run()
    assert stats["requests"] == 2
    assert eng.preemptions >= 1
    for r in (r1, r2):
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)


def test_paged_rejects_requests_larger_than_arena():
    eng = _paged(arena=1)
    assert eng.submit(np.arange(1, 12), max_new=8) is None   # needs 3 blocks
    assert eng.rejected == 1


def _leaf_ptrs(tree):
    return {p: t.data_ptr() for p, t in _leaves(tree)}


def test_paged_trees_keep_storage_and_block_table_boots_unmapped():
    eng = _paged(arch="recurrentgemma-2b", arena=3, timeslice=2)
    assert eng.caches["block_table"].tolist() == [[-1] * 4] * 2
    assert not eng.caches["pos"].any()
    boot = {"params": _leaf_ptrs(eng.params), "caches": _leaf_ptrs(eng.caches)}
    rng = np.random.default_rng(2)
    reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size, size=n),
                       max_new=m) for n, m in ((4, 6), (9, 5), (6, 7))]
    stats = eng.run()
    assert stats["preemptions"] >= 1 and stats["page_faults"] >= 1
    assert _leaf_ptrs(eng.params) == boot["params"]
    assert _leaf_ptrs(eng.caches) == boot["caches"]
    assert "/block_table" in boot["caches"]
    for r in reqs:
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
    eng.pager.check_invariants()
    assert eng.caches["block_table"].tolist() == [[-1] * 4] * 2


def _bench_workload(rng, n_req, prefill_len):
    """``benchmarks/bench_paging.py:_workload``."""
    return [(rng.integers(1, 500, size=int(rng.integers(4, prefill_len + 1))),
             int(rng.integers(4, 9)))
            for _ in range(n_req)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bench_paging_smoke_workload_matches_unpaged_and_jax(arch):
    """bench_paging.py's smoke: batch 2, max_len 32, kv_block 8, half the
    batch's blocks, timeslice 3, 8 requests from seed 0."""
    batch, max_len, kv_block = 2, 32, 8
    arena = batch * (max_len // kv_block) // 2
    jcfg, tcfg, jparams, tparams = _models(arch, key=11)
    eng = _paged(arch, batch=batch, max_len=max_len, arena=arena,
                 timeslice=3, params=tparams)
    work = _bench_workload(np.random.default_rng(0), 4 * batch,
                           eng.prefill_len)
    reqs = [eng.submit(p, max_new=m) for p, m in work]
    blocks = sum(eng._blocks_needed(r.prompt_len, r.max_new) for r in reqs)
    assert blocks / arena >= 2.0, (blocks, arena)
    stats = eng.run()
    assert stats["requests"] == len(work)
    assert eng.pager.report()["evictions"] >= 1
    eng.pager.check_invariants()

    unpaged = ServingEngine(arch, EngineConfig(
        batch=batch, max_len=max_len, clock="step", device="cpu"),
        params=tparams)
    ureqs = [unpaged.submit(p, max_new=m) for p, m in work]
    unpaged.run()
    jeng = JServingEngine(arch, JEngineConfig(
        batch=batch, max_len=max_len, clock="step",
        paging=JPagingConfig(kv_block=kv_block, arena_blocks=arena,
                             timeslice=3)), params=jparams)
    jreqs = [jeng.submit(p, max_new=m) for p, m in work]
    jstats = jeng.run()
    for r, u, j in zip(reqs, ureqs, jreqs):
        assert r.generated == u.generated, (arch, r.rid)
        assert r.generated == j.generated, (arch, r.rid)
    # the same schedule as the reference's pager
    for key in ("preemptions", "swap_ins", "page_faults", "swap_outs",
                "decode_steps"):
        assert stats[key] == jstats[key], key
