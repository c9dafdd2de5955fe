"""The port's roofline bench (``repro_torch.bench.roofline``) on the
reduced configs: every (arch x shape) cell of the reference's matrix
counted on ``meta`` tensors, the training cells of the SSM and
encoder-decoder families listed as waiting for item 14b, the 500k-token cells of the full-attention archs skipped as the
reference skips them, and the counted decode of qwen3-0.6b equal to the
reference's HLO count of the same program (the JAX ``decode`` at batch 4
over 64 cache slots)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.engine_config import EngineConfig as JEngineConfig
from repro.launch.dryrun import lower_serve_programs as jlower
from repro.models import registry as jregistry
from repro_torch.bench import roofline

ROOT = Path(__file__).resolve().parent.parent
DENSE = {"qwen3-0.6b", "llama3.2-3b", "gemma3-4b", "gemma3-12b",
         "internvl2-26b"}
TRAINABLE = DENSE | {"olmoe-1b-7b", "qwen3-moe-30b-a3b", "recurrentgemma-2b"}


@pytest.fixture(scope="module")
def record():
    return roofline.run(reduced=True)


def test_every_cell_is_counted_or_waits(record):
    cells = {(c["arch"], c["shape"]) for c in record["cells"]}
    waiting = {(w["arch"], w["shape"]) for w in record["waiting"]}
    matrix = set(jregistry.all_cells())
    assert cells | waiting == matrix and not cells & waiting
    # the dense, MoE and hybrid families' training cells are counted, the
    # others wait
    assert waiting == {(a, s) for a, s in matrix if s == "train_4k"
                       and a not in TRAINABLE}
    assert all("item 14b" in w["waits_for"] for w in record["waiting"])
    assert {(c["arch"], c["kind"]) for c in record["cells"]
            if c["shape"] == "train_4k"} == {(a, "train") for a in TRAINABLE}
    skipped = {(s["arch"], s["shape"]) for s in record["skipped"]}
    assert skipped == set(jregistry.all_cells(include_skipped=True)) - matrix
    for c in record["cells"]:
        assert c["flops"] > 0 and c["bytes_ideal"] > 0, c
        assert c["compute_s"] == c["flops"] / 67e12      # fp32 peak
        assert c["memory_s"] == c["bytes_ideal"] / 3.35e12
        assert c["dominant"] in ("compute", "memory")
        assert c["fits_one_card"] and c["model_flops_over_counted"] > 0
        assert (c["seq_len"], c["batch"]) == (64, 4)
    assert record["cells_fitting_one_card"] == len(record["cells"])


def test_decode_count_equals_the_reference(record):
    want = jlower("qwen3-0.6b", JEngineConfig(batch=4, max_len=64,
                                               prefill_len=16),
                  programs=["decode"])["decode"]["cost"].flops
    cell, = [c for c in record["cells"]
             if (c["arch"], c["shape"]) == ("qwen3-0.6b", "decode_32k")]
    assert cell["flops"] == want


def test_train_cells_count_the_train_program(record):
    """A train cell counts its train program at the reduced cell size (4 x
    64 tokens): more FLOPs than the same arch's prefill cell of the same
    size (forward only), less than four times them (forward, dX, dW and
    the recompute of remat "nothing"; AdamW and K1's backward add a
    little), and its resident bytes are the train state's (parameters and
    two fp32 moments: more than the prefill cell's parameters)."""
    cells = {(c["arch"], c["shape"]): c for c in record["cells"]}
    for arch in DENSE:
        train, prefill = cells[arch, "train_4k"], cells[arch, "prefill_32k"]
        assert 3 * prefill["flops"] < train["flops"] < 4.5 * prefill["flops"]
        assert train["model_flops"] == 3 * prefill["model_flops"]


def test_command_line_smoke(tmp_path):
    out = tmp_path / "roofline.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.roofline", "--reduced",
         "--smoke", "--out", str(out)], capture_output=True, text=True,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec == json.loads(out.read_text())
    assert {c["shape"] for c in rec["cells"]} == {"decode_32k"}
    assert len(rec["cells"]) == len(jregistry.ARCH_IDS)
