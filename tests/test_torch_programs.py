"""The port's programs and executor on the CPU: what a CUDA graph replay
on the card rests on, held here where there is no card.

A replay reads and writes the storage it captured, so the engine's trees
must keep their storage through a served run; ``prefill_slot`` takes its
slot and length as device int32 scalars (as the reference's program does)
and must still match ``repro.steps.make_prefill_slot_step`` on the same
bridged fp32 weights, at the model tolerance of the other port tests
(rtol/atol 1e-4), leaving the other slot untouched bit for bit; a handle
refuses a tree it is not bound to; the CPU report says no capture ran; a
replay copies its inputs into the static buffers and adds the captured
launches once; K2's split-K scratch of a captured program is a table of
its own, which a capture never grows; and the engine config's ``spec``
and ``horizon`` are validated and add the ``verify`` and
``decode_horizon`` programs only when asked, a speculative engine's
windowed caches flat.
"""
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
from repro_torch.core import syscore
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig, SpecConfig)
from repro_torch.kernels import matmul as k2
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

RULES = make_rules()
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m", "recurrentgemma-2b")
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN, PREFILL_LEN = 64, 32


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _engine(arch, batch=2):
    return ServingEngine(arch, EngineConfig(
        batch=batch, max_len=CACHE_LEN, prefill_len=PREFILL_LEN,
        clock="step", device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_served_run_keeps_the_trees_storage(arch):
    eng = _engine(arch)
    boot = {name: dict((p, t.data_ptr()) for p, t in _leaves(tree))
            for name, tree in (("params", eng.params),
                               ("caches", eng.caches))}
    rng = np.random.default_rng(0)
    for plen in (5, 17):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, size=plen), max_new=4)
    stats = eng.run()
    assert stats["requests"] == 2 and stats["decode_steps"] > 0
    for name, tree in (("params", eng.params), ("caches", eng.caches)):
        now = dict((p, t.data_ptr()) for p, t in _leaves(tree))
        assert now == boot[name], name
    assert "/pos" in boot["caches"]


def _filled_cache(jcfg, rng):
    """A batch-2 JAX cache tree with every leaf drawn, and pos (3, 9)."""
    cache = jax.tree.map(np.asarray, jtf.init_cache(jcfg, 2, CACHE_LEN))
    return jax.tree.map(
        lambda x: np.asarray([3, 9], np.int32) if x.dtype == np.int32
        else rng.standard_normal(x.shape).astype(x.dtype), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_slot_with_device_scalars_matches_reference(arch):
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = tregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu")
    rng = np.random.default_rng(2)
    live = _filled_cache(jcfg, rng)
    length = 21
    tokens = np.zeros((1, PREFILL_LEN), np.int32)
    tokens[0, :length] = rng.integers(1, jcfg.vocab_size, size=length)

    jstep = jax.jit(jsteps.make_prefill_slot_step(jcfg, RULES, CACHE_LEN))
    jcache, jlast = jstep(jparams, jax.tree.map(jnp.asarray, live),
                          jnp.asarray(tokens), jnp.int32(1),
                          jnp.int32(length))
    tcache = bridge.cache_from_numpy(live, tcfg, 2, CACHE_LEN, "cpu")
    before = {p: t.clone() for p, t in _leaves(tcache)}
    tstep = steps.make_prefill_slot_step(tcfg, CACHE_LEN)
    out, tlast = tstep(tparams, tcache, torch.from_numpy(tokens),
                       torch.tensor(1, dtype=torch.int32),
                       torch.tensor(length, dtype=torch.int32))
    assert out is tcache
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    got = dict(_leaves(tcache))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path], **TOL,
                                   err_msg=path)
        # slot 0 (batch axis 1 under the stacked groups) is untouched
        axis = 1 if path.startswith("/groups") else 0
        assert torch.equal(leaf.select(axis, 0),
                           before[path].select(axis, 0)), path
    assert int(tcache["pos"][1]) == length


def test_a_handle_refuses_a_tree_it_is_not_bound_to():
    eng = _engine("qwen3-0.6b", batch=1)
    token = torch.zeros((1, 1), dtype=torch.int32)
    other = ttf.init_cache(eng.cfg, 1, CACHE_LEN)
    with pytest.raises(ValueError, match="'decode'"):
        eng.programs["decode"](eng.params, other, token)
    params = {k: v for k, v in eng.params.items()}
    params["embed"] = params["embed"].clone()
    prompt = torch.zeros((1, PREFILL_LEN), dtype=torch.int32)
    with pytest.raises(ValueError, match="'prefill_slot'"):
        eng.programs["prefill_slot"](params, eng.caches, prompt, 0, 4)
    with pytest.raises(TypeError, match="'decode'"):
        eng.programs["decode"](eng.params, eng.caches)
    assert eng.syscore.report()["programs"]["decode"]["executions"] == 0


def test_cpu_report_shows_no_capture():
    eng = _engine("qwen3-0.6b", batch=1)
    eng.submit(np.arange(1, 6), max_new=2)
    eng.run()
    rep = eng.syscore.report()
    for prog in rep["programs"].values():
        assert prog["source"] == "python"
        assert prog["compile_s"] == 0.0 and prog["lower_s"] == 0.0
    metrics = rep["hostcalls"]["metrics"]
    assert metrics[syscore.METRIC_PROGRAM_LOAD_MS]["count"] == 2
    assert syscore.METRIC_PROGRAM_COMPILE_MS not in metrics
    assert syscore.METRIC_KERNEL_BUILD_MS not in metrics


class _Graph:
    """Stands in for a captured CUDA graph: a replay runs ``body``."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body()


def test_replay_fills_the_static_inputs_and_counts_the_captured_launches():
    tree = {"w": torch.zeros(3)}
    static = (torch.zeros((1, 4), dtype=torch.int32),
              torch.tensor(0, dtype=torch.int32))
    out = torch.zeros(4, dtype=torch.int32)
    graph = _Graph(lambda: out.copy_(static[0][0] + static[1]))
    prog = syscore.Program(
        key="p", fn=None, storage=(syscore._storage(tree),), n_inputs=2,
        source="cuda_graph", graph=graph, inputs=static, outputs=out,
        launches={"matmul": 5, "flash_attention": 2},
        routes={"flash_attention": {"wgmma": 2}})
    ops.reset_launch_counts()
    for i in range(3):
        got = prog.run((tree, torch.arange(4, dtype=torch.int32)[None], i))
        assert got is out and out.tolist() == [i, i + 1, i + 2, i + 3]
    assert graph.replays == 3
    counts = ops.launch_counts()
    assert counts["matmul"] == 15 and counts["flash_attention"] == 6
    assert ops.route_counts()["flash_attention"]["wgmma"] == 6
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="'p'"):
        prog.run(({"w": torch.zeros(3)}, static[0], 0))


def test_k2_scratch_of_a_program_is_its_own_and_never_grows_in_capture(
        monkeypatch):
    monkeypatch.setattr(k2, "_SCRATCH", {})
    monkeypatch.setattr(k2, "_TABLES", [k2._SCRATCH])
    capturing = {"now": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["now"])
    cpu = torch.device("cpu")
    shared = k2._scratch(cpu, 7, 10, 4)
    table = {}
    with k2.scratch_table(table):                    # the warm-up
        ws, cnt = k2._scratch(cpu, 7, 10, 4)
        assert ws is not shared[0]
        capturing["now"] = True                      # the capture
        assert k2._scratch(cpu, 7, 10, 4) == (ws, cnt)
        with pytest.raises(RuntimeError, match="warm the program up"):
            k2._scratch(cpu, 7, 1 << 21, 4)
        with pytest.raises(RuntimeError, match="warm the program up"):
            k2._scratch(cpu, 8, 10, 4)
    assert table == {(None, 7): (ws, cnt)}
    assert k2._TABLES == [k2._SCRATCH]
    capturing["now"] = False
    assert k2._scratch(cpu, 7, 1 << 21, 4)[0].numel() == 1 << 21
    assert table[(None, 7)][0] is ws                 # the program's: kept


def test_spec_and_horizon_configs_validate():
    assert (SpecConfig().k, SpecConfig().ngram, HorizonConfig().length) == \
        (3, 2, 4)
    for bad in (lambda: SpecConfig(k=0), lambda: SpecConfig(ngram=0),
                lambda: HorizonConfig(length=1)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="speculative"):
        EngineConfig(spec=SpecConfig(), group_prefill=True)
    cfg = EngineConfig(spec=SpecConfig(k=5), horizon=HorizonConfig(16))
    assert (cfg.spec_k, cfg.horizon_length) == (5, 16)
    assert (EngineConfig().spec_k, EngineConfig().horizon_length) == \
        (None, None)


@pytest.mark.parametrize("spec,horizon,paged", [
    (None, None, False), (SpecConfig(k=2), None, False),
    (None, HorizonConfig(3), True), (SpecConfig(k=2), HorizonConfig(3), True)])
def test_serve_program_specs_add_verify_and_horizon_only_when_asked(
        spec, horizon, paged):
    tcfg = tregistry.get_config("recurrentgemma-2b", reduced=True)
    eng = ServingEngine("recurrentgemma-2b", EngineConfig(
        batch=2, max_len=CACHE_LEN, prefill_len=PREFILL_LEN, clock="step",
        device="cpu", spec=spec, horizon=horizon,
        paging=PagingConfig(kv_block=8) if paged else None))
    specs = steps.serve_program_specs(tcfg, eng.config, eng.params,
                                      eng.caches)
    want = {"prefill_slot", "decode"} | ({"verify"} if spec else set()) \
        | ({"decode_horizon"} if horizon else set())
    assert set(specs) == want == set(eng.programs)
    if spec:
        assert tuple(specs["verify"].inputs[0].shape) == (2, spec.k + 1)
    if horizon:
        assert [tuple(t.shape) for t in specs["decode_horizon"].inputs] == \
            [(2, 1), (2,)]
    if not paged:
        # the "L" layer (window 8): a ring of 8 slots, flat with spec
        attn = eng.caches["groups"]["slot2"]["k"]
        assert attn.shape[2] == (CACHE_LEN if spec else tcfg.local_window)
    eng.submit(np.arange(1, 12), max_new=6)
    stats = eng.run()
    assert stats["requests"] == 1
    assert ("spec_steps" in stats) == bool(spec)
    assert ("horizon_steps" in stats) == bool(horizon)
