"""The port's examples (``repro_torch.examples``) on the CPU at reduced
size: the expert-paging example prints what the reference's
``examples/moe_expert_paging.py`` prints (the same draws, page loads,
hits, evictions and hot set); the batched-serving example's streams
equal the batch-of-1 reference plain, paged and booted warm from a
program store, and, given the reference engine's seed-0 weights
(bridged), it prints what the reference's ``examples/serve_batched.py``
prints with the same arguments, but for the clock."""
import ast
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.examples import moe_expert_paging, serve_batched
from repro_torch.models import registry as tregistry

REPO = Path(__file__).resolve().parent.parent
# the serving stats that the clock sets
CLOCKED = {"wall_s", "tok_per_s", "decode_p50_ms", "ttft_ms"}


def test_moe_expert_paging_prints_what_the_reference_prints(capsys):
    spec = importlib.util.spec_from_file_location(
        "reference_moe_expert_paging", REPO / "examples/moe_expert_paging.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.main()
    want = capsys.readouterr().out
    assert moe_expert_paging.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "40 routed calls -> 6 page loads, 34 arena hits" in got


@pytest.mark.parametrize("mode", [[], ["--paged", "--arena-frac", "0.5"]])
def test_serve_batched_matches_batch_of_one(capsys, mode):
    assert serve_batched.main(["--device", "cpu", "--requests", "6",
                               *mode]) == 0
    out = capsys.readouterr().out
    assert "batch-of-1 reference matches: True" in out
    assert "'requests': 6" in out
    if mode:
        assert "paged arena: 16 blocks" in out


def test_serve_batched_boots_warm_from_its_store(capsys, tmp_path):
    args = ["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--store-dir", str(tmp_path)]
    assert serve_batched.main(args) == 0
    cold = capsys.readouterr().out
    assert "'puts': 2" in cold and "installed from the store" not in cold
    assert serve_batched.main(args) == 0
    warm = capsys.readouterr().out
    assert warm.count("installed from the store") == 2
    assert "'hits': 2" in warm
    assert "batch-of-1 reference matches: True" in warm
    sample = [line for line in cold.splitlines() if "generated" in line]
    assert sample == [line for line in warm.splitlines()
                      if "generated" in line]


def _printed(out):
    """The clock-free content of a serve_batched run's output: its
    serving stats but the clock's, each program's executions, the paged
    arena's line and request 0's stream."""
    stats = ast.literal_eval(out.split("serving stats: ", 1)[1]
                             .splitlines()[0])
    programs = {m[0]: int(m[1]) for m in
                re.findall(r"program (\w+): .*re-executed (\d+)x", out)}
    lines = [line.strip() for line in out.splitlines()
             if "paged arena:" in line or "generated:" in line
             or "batch-of-1" in line]
    return ({k: v for k, v in stats.items() if k not in CLOCKED},
            programs, lines)


@pytest.mark.parametrize("mode", [
    [], ["--paged", "--arena-frac", "0.5"],
    ["--paged", "--arena-frac", "0.25"]])
def test_serve_batched_prints_what_the_reference_prints(capsys, monkeypatch,
                                                        mode):
    args = ["--requests", "6", *mode]
    spec = importlib.util.spec_from_file_location(
        "reference_serve_batched", REPO / "examples/serve_batched.py")
    ref = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["serve_batched.py", *args])
    spec.loader.exec_module(ref)
    ref.main()
    want_stats, want_programs, want_lines = _printed(capsys.readouterr().out)

    arch = "qwen3-0.6b"
    jparams = jtf.init_params(jregistry.get_config(arch, reduced=True),
                              jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        tregistry.get_config(arch, reduced=True), "cpu")
    engine = serve_batched.ServingEngine

    def bridged(*a, **k):
        return engine(*a, params=params, **k)

    monkeypatch.setattr(serve_batched, "ServingEngine", bridged)
    assert serve_batched.main(["--device", "cpu", *args]) == 0
    stats, programs, lines = _printed(capsys.readouterr().out)
    assert stats == want_stats
    # the reference also hot-loads a burst ``prefill`` it never runs here
    assert programs == {k: n for k, n in want_programs.items()
                        if k in programs}
    assert all(n == 0 for k, n in want_programs.items()
               if k not in programs)
    assert lines == want_lines
    assert "batch-of-1 reference matches: True" in lines
    if mode[-1:] == ["0.25"]:
        assert stats["preemptions"] > 0 and stats["page_faults"] > 0
