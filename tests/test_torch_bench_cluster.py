"""The port's cluster and elastic benches (``repro_torch.bench.{cluster,
elastic}``) at the reference's smoke size on the CPU, in fp32, against
``benchmarks/bench_cluster.py`` (its record written under ``tmp_path``)
and the elastic cell of ``benchmarks/bench_elastic.py`` (driven as the
bench drives it, without its TTFT gate, a speed limit a CPU run may miss),
on the same weights (the reference engines' seed-0 draw, bridged): the
counts that do not depend on the clock are equal, and so is every
generated stream."""
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_cluster, bench_elastic  # noqa: E402
from repro.cluster import Supervisor as JSupervisor  # noqa: E402
from repro.cluster import supervisor as jsupervisor  # noqa: E402
from repro.core import ProgramStore as JProgramStore  # noqa: E402
from repro.engine_config import ClusterConfig as JClusterConfig  # noqa: E402
from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine_config import ScaleConfig as JScaleConfig  # noqa: E402
from repro_torch.bench import cluster, elastic  # noqa: E402
from test_torch_bench_serve import port_params  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The benches run thousands of small CPU ops; one intra-op thread
    takes as long alone and does not oversubscribe the cores that the
    other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded_engines(monkeypatch):
    """Every engine the reference's supervisors boot, kept in a list."""
    engines = []
    base = jsupervisor.ServingEngine

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(jsupervisor, "ServingEngine", Recording)
    return engines


def test_cluster_bench_smoke_matches_reference(monkeypatch, tmp_path):
    out = tmp_path / "BENCH_cluster.json"
    monkeypatch.setattr(bench_cluster, "CLUSTER_JSON", out)
    engines = _recorded_engines(monkeypatch)
    bench_cluster.run(smoke=True, arch=ARCH)
    want = json.loads(out.read_text())
    jstreams = {}
    for eng in engines:
        for r in eng.completed:
            assert jstreams.setdefault(str(r.rid), r.generated) == \
                r.generated
    port = cluster.run(ARCH, full=False, device="cpu", smoke=True,
                       params=port_params(ARCH))
    assert port["streams"] == jstreams
    for key in ("requests", "kill_step", "token_exact_across_n",
                "zero_lost"):
        assert port[key] == want[key], key
    assert port["engine"] == want["engine"]
    for pc, wc in zip(port["cells"], want["cells"], strict=True):
        for key in ("replicas", "requests", "tokens", "kills"):
            assert pc[key] == wc[key], key
        for key in ("replica", "replayed", "warm"):
            assert pc["recovery"][key] == wc["recovery"][key], key
        # the card's warm rule holds on the CPU too
        assert pc["recovery"]["checks"]["warm"]
        assert pc["recovery"]["compile_s"] == wc["recovery"]["compile_s"] \
            == 0
    assert port["cells"][0]["store"]["puts"] == 2
    assert all(c["store"]["puts"] == 0 for c in port["cells"][1:])


def test_elastic_bench_smoke_matches_reference():
    counts = [("warmup", 2), ("flat", 12), ("x2", 10), ("x3", 12),
              ("x4", 60)]
    assert elastic.phase_counts(smoke=True) == counts
    sched, marks = bench_elastic._schedule(np.random.default_rng(0), counts)
    store_dir = tempfile.mkdtemp(prefix="jax_elastic_store_")
    try:
        # bench_elastic.run(smoke=True)'s elastic cell, without its gate
        sup = JSupervisor(ARCH, JClusterConfig(
            engine=JEngineConfig(batch=4, max_len=320, prefill_len=256,
                                 clock="step", seed=0),
            replicas=1,
            scale=JScaleConfig(min_replicas=1, max_replicas=4,
                               high_watermark=0.3, low_watermark=0.02,
                               sustain_window=3, cooldown=12,
                               async_spawn=True, straggler_detection=False)),
            store=JProgramStore(store_dir))

        def _pool(rng=np.random.default_rng(1)):
            while True:
                yield bench_elastic._req(rng)

        rids, _ = bench_elastic._drive(
            sup, sched, marks=marks, cadence_s=bench_elastic.CADENCE_S,
            extend={"pool": _pool(), "target": 4, "cap": 3000})
        stats = sup.run()
        jgrows = [e for e in sup.scale_events if e["action"] == "grow"]
        jstreams = {str(r): sup.streams[r] for r in rids}
        sup.close()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    assert stats["completed_all"] and len(jgrows) == 3
    port = elastic.run(ARCH, full=False, device="cpu", smoke=True,
                       params=port_params(ARCH))
    assert port["scheduled_requests"] == 96
    assert len(port["grow_events"]) == len(jgrows) == 3
    assert port["zero_lost"] and port["token_exact_vs_static_fleet"]
    # the same arrivals (a slower load may extend the 4x tail by more
    # requests from the same pool): the same streams
    common = set(jstreams) & set(port["streams"])
    assert len(common) == min(len(jstreams), len(port["streams"])) >= 96
    assert {r: port["streams"][r] for r in common} == \
        {r: jstreams[r] for r in common}
    assert port["store_during_grows"] == {"hits": 6, "puts": 0,
                                          "misses": 0}
