"""The port's Table 2 bench (``repro_torch.bench.placement``) at the
reference's size on the CPU, against ``benchmarks/bench_placement.py``
(which writes no file): the same rows, the same arena hits, loads and
evictions and the same resident bytes per layout; the three layouts'
outputs bit-equal to each other and allclose to the reference's
``moe_ffn`` (the XLA route) on the same weights at K3's fp32 tolerance
(3e-4, ``tests/test_kernels.py``).  Then ``python -m repro_torch.bench``
(``bench/__main__.py``): it prints each bench's line and the benches
that wait, and exits non-zero when a bench fails."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_placement  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bench import placement  # noqa: E402


@pytest.fixture(scope="module")
def both():
    jrows = {name: (value, derived)
             for name, value, derived in bench_placement.run()}
    port = placement.run(full=False, device="cpu", keep_outputs=True)
    return jrows, port


def test_rows_and_arena_counts_equal_reference(both):
    jrows, port = both
    assert [r["row"] for r in port["rows"]] == list(jrows)
    dc = port["rows"][-1]
    value, derived = jrows["table2_dc_hit_rate"]
    assert dc["value"] == value
    assert derived == (f"hits={dc['hits']} loads={dc['loads']} "
                       f"evictions={dc['evictions']}")
    assert (dc["hits"], dc["loads"], dc["evictions"]) == (108, 36, 20)


def test_resident_bytes_equal_reference(both):
    jrows, port = both
    total = port["total_bytes"]
    assert total == 16 * 3 * 64 * 256 * 4
    for r in port["rows"][:-1]:
        derived = jrows[r["row"]][1]
        assert re.search(r"resident=(\d+)KB of (\d+)KB", derived).groups() \
            == (f"{r['resident_bytes'] / 1e3:.0f}", f"{total / 1e3:.0f}")
        assert r["launches_per_pass"] == 0      # the CPU route counts none
    assert [r["resident_bytes"] for r in port["rows"][:-1]] == \
        [total, 0, total // 3]


def test_layouts_bit_equal_and_match_reference_moe_ffn(both):
    _, port = both
    outs = port["_outputs"]
    assert all(port["outputs_bit_equal"].values())
    # the CPU route is the plain version itself
    assert port["max_abs_err_vs_plain"] == 0.0 and port["tol"] == 3e-4
    tree, x, order = port["_workload"]
    assert len(order) == 24 and len(outs["A_usrcore_resident"]) == 24
    for name, layout in outs.items():
        for i, got in zip(order, layout):
            w = tree[f"expert{i}"]
            want = jops.moe_ffn(jnp.asarray(x)[None],
                                *(jnp.asarray(w[k])[None]
                                  for k in ("w1", "w3", "w2")),
                                impl="xla")[0]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=3e-4, atol=3e-4)


def _bench_main(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.bench", *args],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_bench_main_runs_benches_and_lists_the_waiting():
    res = _bench_main("--only", "placement", "--reduced", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    assert lines[0]["bench"] == "placement"
    assert lines[0]["device"] == {"platform": "cpu"}
    assert lines[0]["seconds"] > 0
    waiting = {r["bench"] for r in lines[1:]}
    assert waiting == {"autotune", "roofline", "pipeline_cross_pod", "tp",
                       "treeload"}
    assert all("ROADMAP Queue 1 item" in r["waits_for"] for r in lines[1:])


def test_bench_main_fails_when_a_bench_fails():
    # no card here: the engine refuses a CUDA device, the bench fails,
    # and the runner says so instead of swallowing it
    res = _bench_main("--only", "serve", "--device", "cuda")
    assert res.returncode == 1
    first = json.loads(res.stdout.splitlines()[0])
    assert first == {"bench": "serve", "ok": False, "returncode": 1}
