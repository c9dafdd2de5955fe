"""The port's trainer end to end on the CPU (``repro_torch.launch.train``),
with the checks ``tests/test_system.py`` makes of the reference's: the
loss falls with a step report a step, two injected failures are survived,
and a restart from a checkpoint puts training back on the same path (on
qwen3-0.6b: mamba2's training waits for ROADMAP item 14b).  Reduced
configs, 4 x 32 tokens a step, as the reference's tests run them."""
import numpy as np
import pytest
import torch

from repro_torch.launch import train as train_mod
from repro_torch.launch.train import train


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A training run is thousands of small CPU ops; one intra-op thread
    takes about as long alone and does not oversubscribe the cores that
    the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_e2e_loss_decreases(tmp_path):
    res = train("qwen3-0.6b", reduced=True, steps=40, global_batch=4,
                seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=10,
                lr=3e-3, log_every=100, device="cpu")
    assert res["restarts"] == 0
    assert np.isfinite(res["final_loss"])
    assert res["final_loss"] < res["first_loss"] - 0.3, res
    assert res["telemetry_points"] >= 39       # a host call per step
    assert res["programs"]["train"]["executions"] >= 39
    assert res["steps_run"] == res["telemetry_points"] == 40
    # the in-graph host call makes the program unexportable: the store
    # counts it as skipped, with the error
    assert res["program_store"]["skipped"] == 1
    assert "HostCallExportError" in res["export_error"]


def test_train_e2e_survives_injected_failures(tmp_path):
    res = train("qwen3-0.6b", reduced=True, steps=30, global_batch=4,
                seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=5,
                fail_at=[12, 23], lr=3e-3, log_every=100, device="cpu")
    assert res["restarts"] == 2
    assert res["final_step"] == 29
    assert np.isfinite(res["final_loss"])
    # each restart resumes after the newest checkpoint (10, then 20):
    # steps 11 and 21-22 run twice
    assert res["steps_run"] == res["telemetry_points"] == 30 + 1 + 2


def test_train_e2e_deterministic_data_after_restart(tmp_path):
    """The same final loss whether or not a failure occurred: the data
    replays deterministically and the restore puts the state back (on
    the CPU, bit for bit)."""
    kw = dict(reduced=True, steps=24, global_batch=4, seq_len=32,
              ckpt_every=6, lr=1e-3, log_every=100, device="cpu")
    r1 = train("qwen3-0.6b", ckpt_dir=str(tmp_path / "a"), **kw)
    r2 = train("qwen3-0.6b", ckpt_dir=str(tmp_path / "b"), fail_at=[13],
               **kw)
    assert r2["restarts"] == 1
    assert abs(r1["final_loss"] - r2["final_loss"]) < 0.05, (r1, r2)
    assert r1["final_loss"] == r2["final_loss"]


def test_train_with_host_telemetry_and_the_command_line(tmp_path, capsys):
    """Host-side step reports: the same telemetry count, and the store
    tries to export the train program (counted as skipped, with
    torch.export's error, where it cannot)."""
    res = train_mod.main(["--device", "cpu", "--steps", "6", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "3", "--host-telemetry",
                          "--log-every", "0"])
    assert res["telemetry_points"] == res["steps_run"] == 6
    store = res["program_store"]
    assert store["puts"] + store["skipped"] == 1
    assert (store["skipped"] == 1) == bool(res["export_error"])
    assert "'final_step': 5" in capsys.readouterr().out


def test_train_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        train("qwen3-0.6b", mesh=object(), device="cpu",
              ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 14b"):
        train("mamba2-130m", steps=2, device="cpu", ckpt_dir=str(tmp_path))
