"""The port's serve bench (``repro_torch.bench.serve``) at the reference's
smoke size on the CPU, in fp32, against ``benchmarks/bench_pipeline.py``'s
``serve_throughput`` (its record written under ``tmp_path``) on the same
weights (the reference engine's seed-0 draw, bridged): the fields that do
not depend on the clock are equal, every generated stream among them.
Then the same trace on qwen3-moe-30b-a3b against the reference engine
driven as the bench drives it: a burst routes all its rows under one
capacity, so its streams are the reference's burst's, not batch-1's."""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_pipeline  # noqa: E402
from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.bench import serve as serve_bench  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

ARCH = "qwen3-0.6b"


class Recorder:
    """Patched over ``repro.launch.serve.ServingEngine``: keeps every
    engine a bench builds and the requests submitted to it."""

    def __init__(self, monkeypatch):
        self.engines = []
        base = jserve.ServingEngine
        rec = self

        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.submitted = []
                rec.engines.append(self)

            def submit(self, *a, **k):
                req = super().submit(*a, **k)
                self.submitted.append(req)
                return req

        monkeypatch.setattr(jserve, "ServingEngine", Recording)


def port_params(arch):
    """The JAX engine's seed-0 weights, on the port's CPU."""
    jcfg = jregistry.get_config(arch, reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    tregistry.get_config(arch, reduced=True),
                                    "cpu")


def test_serve_bench_smoke_matches_reference(monkeypatch, tmp_path):
    out = tmp_path / "BENCH_serve.json"
    monkeypatch.setattr(bench_pipeline, "SERVE_JSON", out)
    rec = Recorder(monkeypatch)
    bench_pipeline.serve_throughput(smoke=True)
    want = json.loads(out.read_text())
    jeng, = rec.engines
    port = serve_bench.run(ARCH, full=False, device="cpu", smoke=True,
                           params=port_params(ARCH))
    for key in ("batch", "requests", "refill_admissions", "programs"):
        assert port[key] == want[key], key
    assert port["occupancy"] == pytest.approx(want["occupancy"], abs=1e-12)
    assert port["streams"] == [r.generated for r in jeng.submitted]
    assert port["programs"] == {"prefill": 1, "prefill_slot": 8,
                                "decode": port["decode_steps"]}
    assert port["admitted"] == port["requests"] == 12
    assert port["dtype"] == "float32" and port["max_len"] == 64
    assert port["device"] == {"platform": "cpu"}


def test_serve_bench_moe_burst_matches_reference_engine():
    arch = "qwen3-moe-30b-a3b"
    jeng = jserve.ServingEngine(arch, JEngineConfig(
        reduced=True, batch=4, max_len=64, group_prefill=True))
    jreqs = [jeng.submit(p, max_new=m)
             for p, m in serve_bench.trace(jeng.cfg.vocab_size, smoke=True)]
    jeng.run()
    port = serve_bench.run(arch, full=False, device="cpu", smoke=True,
                           params=port_params(arch), keep_engine=True)
    eng = port.pop("_engine")
    assert port["streams"] == [r.generated for r in jreqs]
    # the refills equal the batch-1 reference; two of the burst's four
    # rows lose an expert slot to the rows before them (padding included)
    alone = [eng.reference_generate(r.prompt, r.max_new) for r in jreqs]
    same = [a == s for a, s in zip(alone, port["streams"])]
    assert same == [True, True, False, False] + [True] * 8
    programs = jeng.syscore.report()["programs"]
    assert port["programs"] == {k: programs[k]["executions"]
                                for k in port["programs"]}
    assert port["programs"]["prefill"] == 1
    assert port["refill_admissions"] == jeng.refill_admissions


def test_serve_bench_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="decoder-only"):
        serve_bench.run("seamless-m4t-medium", full=False, device="cpu")
