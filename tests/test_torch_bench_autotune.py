"""The port's autotune bench (``repro_torch.bench.autotune``) at the
reference's smoke size on the CPU, in fp32, on the chat workload, against
``benchmarks/bench_autotune.py`` on the same weights (the reference
engines' seed-0 draw, bridged): the same three workloads, and the default
engine's streams equal the reference engine's.  The bench's own gates
hold: streams equal across the measured configs, the trace's round trip,
the predicted ranking against the measured one, and a warm adoption of
the tuned overlay through a program store.  The reference's speed gate
is reported, not asserted (``speedup_asserted`` False)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_autotune  # noqa: E402
from repro.engine_config import EngineConfig as JEngineConfig  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.bench import autotune  # noqa: E402
from test_torch_bench_serve import port_params  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small CPU ops: one intra-op thread takes as long alone
    and keeps the timings the ranking gate reads off the cores that the
    other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_workloads_equal_the_reference():
    vocab = jregistry.get_config(ARCH, reduced=True).vocab_size
    for smoke in (False, True):
        want = bench_autotune._workloads(vocab, smoke)
        got = autotune.workloads(vocab, smoke)
        assert list(got) == list(want) == list(autotune.WORKLOADS)
        for name in want:
            assert len(got[name]) == len(want[name]), name
            for (p, m), (jp, jm) in zip(got[name], want[name]):
                assert m == jm and np.array_equal(p, jp), name


def test_autotune_bench_smoke_chat_matches_reference():
    rec = autotune.run(ARCH, full=False, device="cpu", smoke=True,
                       params=port_params(ARCH), names=("chat",))
    chat = rec["workloads"]["chat"]
    assert chat["token_exact"] and chat["trace_roundtrip_ok"]
    assert chat["ranking_ok"], chat["ranking_pairs"]
    assert chat["adopt"]["warm"], chat["adopt"]
    assert chat["adopt"]["store_hits_misses_puts"][1:] == (0, 0)
    assert chat["cells"][0]["name"] == "default"
    assert {c["name"] for c in chat["cells"]} <= {"default", "tuned",
                                                  "worst_tried"}
    assert rec["gate"]["speedup_asserted"] is False
    assert 0.0 <= rec["overhead"]["overhead_frac"] < 1.0
    assert rec["cost_model_counts"] >= 2
    assert rec["dtype"] == "float32" and rec["device"] == {
        "platform": "cpu"}
    # the reference's default engine on the same workload and weights
    base = JEngineConfig(batch=4, max_len=128, prefill_len=64,
                         clock="step", seed=0)
    vocab = jregistry.get_config(ARCH, reduced=True).vocab_size
    _, want = bench_autotune._measure(
        ARCH, base, None, None, bench_autotune._workloads(vocab, True)[
            "chat"], 1)
    assert chat["streams"] == want["streams"]
