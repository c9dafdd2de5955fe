"""The port's paging, fused and prefix benches
(``repro_torch.bench.{paging,fused,prefix}``) at the reference's smoke
size on the CPU, in fp32, against ``benchmarks/bench_{paging,fused,
prefix}.py`` on the same weights (the reference engines' seed-0 draw,
bridged): the fields that do not depend on the clock are equal, every
generated stream among them.  ``bench_paging.run`` is called as it is
(its record written under ``tmp_path``); the other two assert speed
limits that a CPU run may miss, so their engines are driven here as the
benches drive them (``bench_fused._measure`` itself for fused), and no
speed is asserted on either side.  The spec bench is held the same way
in ``tests/test_torch_bench_spec.py``."""
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_fused, bench_paging  # noqa: E402
from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine_config import PagingConfig as JPagingConfig  # noqa: E402
from repro.engine_config import PrefixConfig as JPrefixConfig  # noqa: E402
from repro.launch.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.bench import fused, paging, prefix  # noqa: E402
from test_torch_bench_serve import Recorder, port_params  # noqa: E402

ARCH = "qwen3-0.6b"


def test_paging_bench_smoke_matches_reference(monkeypatch, tmp_path):
    out = tmp_path / "BENCH_paging.json"
    monkeypatch.setattr(bench_paging, "PAGING_JSON", out)
    rec = Recorder(monkeypatch)
    bench_paging.run(smoke=True, arch=ARCH)
    want = json.loads(out.read_text())
    jpaged = rec.engines[0]
    port = paging.run(ARCH, full=False, device="cpu", smoke=True,
                      params=port_params(ARCH))
    for key in ("batch", "max_len", "kv_block", "arena_blocks",
                "arena_capacity_bytes", "workload", "arena",
                "token_exact"):
        assert port[key] == want[key], key
    for key in ("preemptions", "swap_ins", "decode_steps"):
        assert port["engine"][key] == want["engine"][key], key
    assert port["engine"]["requests"] == len(jpaged.submitted) == 8
    assert port["streams"] == [r.generated for r in jpaged.submitted]


def test_fused_bench_smoke_matches_reference():
    results, streams, params = {}, {}, None
    for h in bench_fused.HORIZONS:
        params, results[h] = bench_fused._measure(
            ARCH, h, params, streams, batch=2, max_len=128, prefill_len=16,
            max_new=48, repeats=3)
    port = fused.run(ARCH, full=False, device="cpu", smoke=True,
                     params=port_params(ARCH))
    assert port["streams"] == streams[1]
    for h in bench_fused.HORIZONS:
        for key in ("dispatches", "decode_tokens", "dispatches_per_token",
                    "horizon_steps", "repeats"):
            assert port["horizons"][str(h)][key] == results[h][key], (h, key)
    assert port["dispatches_per_token_h16"] <= 1 / 8


def test_prefix_bench_smoke_matches_reference():
    max_len, prompt_len, prefill_len = prefix.geometry(smoke=True)
    eng = JServingEngine(ARCH, JEngineConfig(
        reduced=True, batch=2, max_len=max_len, prefill_len=prefill_len,
        clock="wall", seed=0, paging=JPagingConfig(kv_block=8),
        prefix=JPrefixConfig(max_suffix=1)))
    # bench_prefix.run(smoke=True)'s requests, without its TTFT gate
    rng = np.random.default_rng(0)
    warmup = rng.integers(1, 500, size=prompt_len).astype(np.int32)
    for p in (warmup, warmup.copy()):
        eng.submit(p, max_new=2)
        eng.run()
    base = rng.integers(1, 500, size=prompt_len).astype(np.int32)
    reqs = []
    for _ in range(1 + prefix.N_WARM):
        reqs.append(eng.submit(base.copy(), max_new=4))
        eng.run()
    want = eng.pager.report()["prefix"]
    port = prefix.run(ARCH, full=False, device="cpu", smoke=True,
                      params=port_params(ARCH))
    assert port["streams"] == [r.generated for r in reqs]
    assert port["engine"] == {
        "warm_admissions": eng.warm_admissions,
        "prefix_admissions": eng.prefix_admissions,
        "prefix_tokens_reused": eng.prefix_tokens_reused}
    assert port["prefix"] == {k: want[k] for k in port["prefix"]}
    for key in ("entries", "puts", "gets"):
        assert port["store"][key] == want["store"][key], key
    assert port["shared_blocks"] == (prompt_len - 1) // 8 == 16
