"""The port's serving engine on the CPU: token streams against its own
batch-1 reference and against the JAX engine holding the same weights,
its telemetry and registry, and the rule that the port imports neither JAX
nor the JAX package."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.core.syscore import UnknownProgramError
from repro_torch.engine_config import EngineConfig, PagingConfig, SpecConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import (METRIC_DECODE_MS, METRIC_OCCUPANCY,
                                      METRIC_TTFT_MS, ServingEngine)
from repro_torch.models import registry as tregistry

ARCH = "qwen3-0.6b"
# (max_new, arrival step, prompt length): mixed lengths, a late arrival
# that refills a slot while the other still decodes
TRAFFIC = [(4, 0.0, 4), (8, 0.0, 11), (12, 2.0, 5), (6, 3.0, 17)]


def _submit(eng, vocab):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(1, vocab, size=plen), max_new=n,
                       arrival_time=arr) for n, arr, plen in TRAFFIC]


@pytest.fixture(scope="module")
def served():
    jcfg = jregistry.get_config(ARCH, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        tregistry.get_config(ARCH, reduced=True), "cpu")
    eng = ServingEngine(ARCH, EngineConfig(batch=2, max_len=64, clock="step",
                                           device="cpu"), params=tparams)
    reqs = _submit(eng, eng.cfg.vocab_size)
    stats = eng.run()
    return eng, reqs, stats, jparams


def test_streams_equal_reference_generate_and_jax_engine(served):
    eng, reqs, stats, jparams = served
    assert stats["requests"] == len(TRAFFIC)
    assert stats["refill_admissions"] >= 1
    jeng = JServingEngine(ARCH, JEngineConfig(batch=2, max_len=64,
                                              clock="step"), params=jparams)
    jreqs = _submit(jeng, jeng.cfg.vocab_size)
    jeng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new
        assert r.generated == eng.reference_generate(r.prompt, r.max_new)
        assert r.generated == jr.generated


def test_group_prefill_is_not_accepted_yet():
    """``group_prefill`` builds the whole-batch ``prefill`` program; with
    paging or speculation it still raises, as in the reference."""
    eng = ServingEngine(ARCH, EngineConfig(batch=2, max_len=64, device="cpu",
                                           group_prefill=True))
    assert "prefill" in eng.programs and eng.group_prefill
    with pytest.raises(ValueError, match="group_prefill"):
        EngineConfig(batch=2, max_len=64, device="cpu", group_prefill=True,
                     paging=PagingConfig())
    with pytest.raises(ValueError, match="group_prefill"):
        EngineConfig(batch=2, max_len=64, device="cpu", group_prefill=True,
                     spec=SpecConfig())


def test_hostcall_metrics_and_program_registry(served):
    eng, _, stats, _ = served
    rep = eng.syscore.report()
    for code in (METRIC_TTFT_MS, METRIC_DECODE_MS, METRIC_OCCUPANCY):
        assert rep["hostcalls"]["metrics"][code]["count"] > 0
    assert rep["hostcalls"]["step_reports"] == stats["decode_steps"]
    progs = rep["programs"]
    assert progs["decode"]["executions"] == stats["decode_steps"]
    assert progs["prefill_slot"]["executions"] == len(TRAFFIC)
    assert set(progs["decode"]) == {"lower_s", "compile_s", "load_s",
                                    "executions", "serialized_bytes",
                                    "source", "fingerprint"}
    with pytest.raises(UnknownProgramError, match="verify"):
        eng.syscore.handle("verify")
    snap = eng.snapshot()
    assert snap["active"] == 0 and snap["completed"] == len(TRAFFIC)
    done = eng.drain_completed()
    assert len(done) == len(TRAFFIC) and eng.completed == []


def test_bounded_queue_and_eos():
    eng = ServingEngine(ARCH, EngineConfig(batch=1, max_len=32, max_queue=2,
                                           clock="step", device="cpu"))
    prompt = np.arange(1, 6)
    assert eng.submit(prompt, 4) is not None
    assert eng.submit(prompt, 4) is not None
    assert eng.submit(prompt, 4) is None and eng.rejected == 1
    eng.run()
    stream = eng.completed[0].generated
    eos = ServingEngine(ARCH, EngineConfig(batch=1, max_len=32, clock="step",
                                           device="cpu", eos_id=stream[1]),
                        params=eng.params)
    req = eos.submit(prompt, 4)
    eos.run()
    assert req.generated == stream[:2]


def test_cli_main_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "2", "--max-new", "3",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert "'requests': 2" in out and "prefill_slot" in out


def test_port_imports_neither_jax_nor_the_reference_package():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'repro.')) or n == 'repro')\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.models.encdec' in sys.modules\n"
        "for m in ('core.program_store', 'core.hostcall', 'bench.boot',\n"
        "          'bench.load_exec', 'bench.hostcall', 'cluster.supervisor',\n"
        "          'cluster.router', 'cluster.journal', 'runtime.fault',\n"
        "          'runtime.elastic', 'bench.cluster', 'bench.elastic',\n"
        "          'launch.cost', 'launch.roofline', 'launch.dryrun',\n"
        "          'runtime.autotune', 'bench.autotune', 'bench.roofline',\n"
        "          'optim.adamw', 'data.pipeline', 'checkpoint.checkpoint',\n"
        "          'launch.train', 'examples.quickstart',\n"
        "          'examples.train_fault_tolerant'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
