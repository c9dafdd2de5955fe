"""The port's program store on the CPU (``repro_torch.core.program_store``),
case by case after ``tests/test_program_store.py``: fingerprints, a warm
boot that installs the stored export instead of calling the function, a
corrupt payload and an environment skew that fall back, an unexportable
program (an in-graph host call) that is skipped and counted, the report,
the atomic layout, one store directory shared by several executors and
racing puts; then the serving engine's warm boot (after
``tests/test_serving.py:199``) for qwen3-0.6b and mamba2-130m at reduced
size in fp32: warm streams equal the cold ones, ``reference_generate``
and the JAX engine's on the same weights, and no program function runs
(the ``verify`` and ``decode_horizon`` programs:
``tests/test_torch_warm_boot.py``).
"""
import io

import jax
import numpy as np
import pytest
import torch

from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.bench import boot as boot_bench
from repro_torch.core import hostcall
from repro_torch.core.program_store import ProgramSpec, ProgramStore
from repro_torch.core.syscore import (METRIC_PROGRAM_LOAD_MS, Syscore,
                                      UnknownProgramError)
from repro_torch.engine_config import EngineConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry as tregistry

CALLS = []      # every run of the toy function appends one


def _toy(params, cache, x):
    """The toy program: a product through the tanh, and an in-place write
    of a resident cache (as the serving programs write theirs)."""
    CALLS.append(1)
    w = params["w"]
    y = torch.tanh(x @ w) @ w.T
    cache["acc"].add_(y.sum(0))
    return cache, y


def _trees(n=32):
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        0.1 * rng.standard_normal((n, n)).astype(np.float32))}
    cache = {"acc": torch.zeros(n)}
    return params, cache


def _x(n=32):
    return torch.ones((4, n))


def _spec(key="toy", n=32, context="ctx", fn=_toy, trees=None):
    params, cache = trees if trees is not None else _trees(n)
    return ProgramSpec(key, fn, resident=(params, cache), inputs=(_x(n),),
                       context=context)


def _run(handle, spec):
    params, cache = spec.resident
    return handle(params, cache, _x(params["w"].shape[0]))[1]


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------
def test_fingerprint_stable_across_instances():
    assert _spec().fingerprint == _spec().fingerprint


def test_fingerprint_sensitive_to_content():
    base = _spec()
    assert _spec(n=16).fingerprint != base.fingerprint          # shapes
    assert _spec(context="other").fingerprint != base.fingerprint
    assert _spec(fn=lambda p, c, x: (c, x)).fingerprint != base.fingerprint
    # the key is routing, not content: one program under two keys shares
    # one fingerprint (and so one store entry)
    assert _spec(key="other").fingerprint == base.fingerprint
    params, cache = _trees()
    renamed = ProgramSpec("toy", _toy, resident=({"v": params["w"]}, cache),
                          inputs=(_x(),), context="ctx")
    assert renamed.fingerprint != base.fingerprint               # leaf path


def test_fingerprint_covers_scalar_closure_cells():
    def make(steps):
        def prog(params, cache, x):
            for _ in range(steps):
                x = x @ params["w"]
            return cache, x
        return prog

    assert _spec(fn=make(2)).fingerprint != _spec(fn=make(3)).fingerprint
    assert _spec(fn=make(2)).fingerprint == _spec(fn=make(2)).fingerprint


# ---------------------------------------------------------------------------
# store-backed warm boot
# ---------------------------------------------------------------------------
def test_warm_boot_installs_the_export_instead_of_calling_fn(tmp_path):
    spec = _spec()
    cold = Syscore("cpu", store=ProgramStore(tmp_path))
    toy = cold.hot_load(spec)
    want = _run(toy, spec)
    rep = cold.report()["programs"]["toy"]
    assert rep["source"] == "python" and cold.store.puts == 1
    assert rep["serialized_bytes"] > 0

    # a rebooted process: fresh store object over the same directory
    spec2 = _spec()
    warm = Syscore("cpu", store=ProgramStore(tmp_path))
    toy2 = warm.hot_load(spec2)
    rep = warm.report()["programs"]["toy"]
    assert rep["source"] == "store"
    assert rep["load_s"] > 0 and rep["compile_s"] == 0
    assert rep["serialized_bytes"] > 0
    assert rep["fingerprint"] == spec.fingerprint[:12]
    CALLS.clear()
    got = _run(toy2, spec2)
    assert CALLS == []                     # the export ran, not _toy
    assert torch.equal(got, want)
    # the in-place write reached the caller's tensor (the same storage)
    assert torch.equal(spec2.resident[1]["acc"], spec.resident[1]["acc"])
    assert warm.store.hits == 1 and warm.store.misses == 0
    assert METRIC_PROGRAM_LOAD_MS in warm.hostcalls.metrics
    assert warm.report()["store"]["entries"] == 1


def test_store_miss_on_corrupt_payload_falls_back_to_the_function(tmp_path):
    store = ProgramStore(tmp_path)
    spec = _spec()
    want = _run(Syscore("cpu", store=store).hot_load(spec), spec)
    for p in tmp_path.glob("*.pt2"):
        p.write_bytes(b"not an archive")
    spec2 = _spec()
    warm = Syscore("cpu", store=ProgramStore(tmp_path))
    toy = warm.hot_load(spec2)
    assert warm.report()["programs"]["toy"]["source"] == "python"
    assert torch.equal(_run(toy, spec2), want)
    assert warm.store.misses == 1 and warm.store.hits == 0
    assert warm.store.puts == 1            # the fallback heals the entry


def test_store_keyed_on_environment_version(tmp_path, monkeypatch):
    """A skew (another torch, CUDA, device, kernel or port source) must
    miss, not revive a stale program."""
    Syscore("cpu", store=ProgramStore(tmp_path)).hot_load(_spec())
    skewed = ProgramStore(tmp_path)
    monkeypatch.setattr(skewed, "_env_key",
                        lambda device: ("torch-999", "cuda-999", "cpu",
                                        "k", "c"))
    assert skewed.get(_spec()) is None and skewed.misses == 1
    warm = Syscore("cpu", store=skewed)
    warm.hot_load(_spec())
    assert warm.report()["programs"]["toy"]["source"] == "python"


def test_unexportable_program_is_skipped_not_fatal(tmp_path):
    """A program with an in-graph host call cannot be exported: the store
    counts the skip, the program still installs and runs, and it is never
    tried again."""
    hct = hostcall.HostCallTable()

    def with_callback(params, cache, x):
        cache, y = _toy(params, cache, x)
        hct.hostcall(hostcall.CALL_METRIC, 0, y.sum())
        return cache, y

    store = ProgramStore(tmp_path)
    sc = Syscore("cpu", store=store)
    spec = _spec(fn=with_callback, context="cb")
    prog = sc.hot_load(spec)
    out = _run(prog, spec)
    assert bool(out.isfinite().all())
    assert store.skipped == 1 and store.puts == 0
    assert prog.program.serializable is False
    assert "HostCallExportError" in prog.program.export_error
    assert hct.metrics[0]                         # the call still fired
    assert sc.persist() == 0 and store.skipped == 1


def test_store_report_and_entries(tmp_path):
    store = ProgramStore(tmp_path)
    Syscore("cpu", store=store).hot_load(_spec())
    rep = store.report()
    assert rep["entries"] == 1 and rep["bytes"] > 0 and rep["puts"] == 1
    (entry,) = store.entries().values()
    assert entry["key"] == "toy"
    assert entry["fingerprint"] == _spec().fingerprint
    assert entry["env"][0] == torch.__version__ and entry["env"][2] == "cpu"
    store.clear()
    assert store.report()["entries"] == 0


def test_persist_serialize_and_install_serialized(tmp_path):
    spec = _spec()
    sc = Syscore("cpu")
    toy = sc.hot_load(spec)
    want = _run(toy, spec)
    store = ProgramStore(tmp_path)
    assert sc.persist(store) == 1 and sc.persist(store) == 0
    payload = toy.serialize()
    assert store.get(spec) == payload
    spec2 = _spec()
    other = Syscore("cpu")
    CALLS.clear()
    h = other.install_serialized("toy_copy", payload, spec2)
    assert other.report()["programs"]["toy_copy"]["source"] == "serialized"
    assert torch.equal(_run(h, spec2), want) and CALLS == []
    h.evict()
    with pytest.raises(UnknownProgramError):
        _run(h, spec2)


@pytest.mark.parametrize("op", ["serialize", "evict"])
def test_unknown_key_error_names_key_and_lists_programs(op):
    sc = Syscore("cpu")
    sc.hot_load(_spec(key="alpha"))
    sc.hot_load(_spec(key="beta", context="b"))
    with pytest.raises(UnknownProgramError) as ei:
        getattr(sc, op)("gamma")
    msg = str(ei.value)
    assert "'gamma'" in msg and "'alpha'" in msg and "'beta'" in msg
    assert isinstance(ei.value, KeyError)


def test_store_layout_is_atomic(tmp_path):
    """No .tmp_* residue after a put; the payload is an export archive."""
    Syscore("cpu", store=ProgramStore(tmp_path)).hot_load(_spec())
    assert not list(tmp_path.glob(".tmp_*"))
    (pt2,) = tmp_path.glob("*.pt2")
    ep = torch.export.load(io.BytesIO(pt2.read_bytes()))
    targets = {str(n.target) for n in ep.graph.nodes}
    # the weights are the program's inputs, neither constants nor example
    # inputs in the payload
    assert not ep.constants and not ep.state_dict
    assert ep.example_inputs is None
    assert any("tanh" in t for t in targets)


# ---------------------------------------------------------------------------
# one store directory, several executors
# ---------------------------------------------------------------------------
def test_two_executors_share_one_store_dir(tmp_path):
    spec_a = _spec()
    a = Syscore("cpu", store=ProgramStore(tmp_path))
    ha = a.hot_load(spec_a)
    want = _run(ha, spec_a)
    spec_b = _spec()
    b = Syscore("cpu", store=ProgramStore(tmp_path))
    hb = b.hot_load(spec_b)
    assert b.report()["programs"]["toy"]["source"] == "store"
    assert torch.equal(_run(hb, spec_b), want)
    spec_a.resident[1]["acc"].zero_()
    spec_b.resident[1]["acc"].zero_()
    assert torch.equal(_run(ha, spec_a), _run(hb, spec_b))


def test_interleaved_warm_boots_export_each_program_once(tmp_path):
    specs = [_spec(key=f"p{i}", context=f"v{i}") for i in range(4)]
    a = Syscore("cpu", store=ProgramStore(tmp_path))
    b = Syscore("cpu", store=ProgramStore(tmp_path))
    owners = [a, b, a, b]              # who exports each program first
    for sc, spec in zip(owners, specs):
        sc.hot_load(spec)
    for sc, spec in zip(reversed(owners), specs):   # second touch swapped
        sc.hot_load(spec)
    for sc in (a, b):
        progs = sc.report()["programs"]
        assert len(progs) == 4
        ran = [k for k, v in progs.items() if v["source"] == "python"]
        loaded = [k for k, v in progs.items() if v["source"] == "store"]
        assert len(ran) == 2 and len(loaded) == 2, progs
    assert a.store.puts + b.store.puts == 4
    assert ProgramStore(tmp_path).report()["entries"] == 4


def test_corrupt_entry_while_shared_degrades_one_reader_and_heals(tmp_path):
    spec_a = _spec()
    a = Syscore("cpu", store=ProgramStore(tmp_path))
    ha = a.hot_load(spec_a)
    want = _run(ha, spec_a)
    for p in tmp_path.glob("*.pt2"):
        p.write_bytes(b"torn write garbage")
    b_store = ProgramStore(tmp_path)
    b = Syscore("cpu", store=b_store)
    spec_b = _spec()
    hb = b.hot_load(spec_b)
    assert b.report()["programs"]["toy"]["source"] == "python"
    assert b_store.misses == 1 and b_store.puts == 1
    assert torch.equal(_run(hb, spec_b), want)
    c = Syscore("cpu", store=ProgramStore(tmp_path))
    c.hot_load(_spec())
    assert c.report()["programs"]["toy"]["source"] == "store"


def test_racing_puts_leave_no_tmp_residue_and_one_winner(tmp_path):
    s1, s2 = ProgramStore(tmp_path), ProgramStore(tmp_path)
    a = Syscore("cpu", store=s1)
    a.hot_load(_spec())
    spec_b = _spec()
    handle = Syscore("cpu", store=s2).hot_load(spec_b)
    s2.put(_spec(), a.serialize("toy"))
    s1.put(_spec(), a.serialize("toy"))
    assert not list(tmp_path.glob(".tmp_*"))
    assert ProgramStore(tmp_path).get(_spec()) is not None
    assert bool(_run(handle, spec_b).isfinite().all())


# ---------------------------------------------------------------------------
# the serving engine's warm boot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_engine_warm_boot_is_load_only_and_token_exact(arch, tmp_path):
    jcfg = jregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tregistry.get_config(arch,
                                                            reduced=True),
                                       "cpu")
    kw = dict(batch=2, max_len=32, clock="step")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n) for n in (5, 9)]

    def serve(eng):
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        return [r.generated for r in reqs]

    cold = ServingEngine(arch, EngineConfig(device="cpu", **kw),
                         params=tparams, store=ProgramStore(tmp_path))
    cold_streams = serve(cold)
    assert all(p.program.source == "python" for p in cold.programs.values())
    assert cold.syscore.store.puts == len(cold.programs) == 2

    # a rebooted engine: the same store directory through store_dir
    with boot_bench.EntryPointCounter() as counter:
        warm = ServingEngine(arch, EngineConfig(device="cpu",
                                                store_dir=str(tmp_path),
                                                **kw), params=tparams)
        warm_streams = serve(warm)
    assert counter.calls == 0
    progs = warm.syscore.report()["programs"]
    for name in ("prefill_slot", "decode"):
        assert progs[name]["source"] == "store", (name, progs[name])
        assert progs[name]["load_s"] > 0 and progs[name]["compile_s"] == 0
    assert warm_streams == cold_streams
    assert warm_streams == [warm.reference_generate(p, 6) for p in prompts]
    jeng = JServingEngine(arch, JEngineConfig(**kw), params=jparams)
    assert warm_streams == serve(jeng)



def test_cli_store_dir_boots_warm_the_second_time(tmp_path, capsys):
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "3",
            "--batch", "2", "--store-dir", str(tmp_path)]
    serve_cli.main(argv)
    first = capsys.readouterr().out
    assert "'puts': 2" in first and "'source': 'python'" in first
    serve_cli.main(argv)
    second = capsys.readouterr().out
    assert "'hits': 2" in second and "'source': 'store'" in second
    assert "'source': 'python'" not in second
