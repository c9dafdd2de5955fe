"""End-to-end fault-tolerant training on the port (example application
b), the counterpart of ``examples/train_fault_tolerant.py``.

Trains a ~25M-parameter qwen3-family model through the whole stack:
the persistent executor (on the card, one CUDA graph per step),
host-call telemetry, periodic checkpoints, two injected node failures
with automatic restart and restore, deterministic data replay and
straggler statistics.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.examples.train_fault_tolerant [--device cuda]
        [--steps 300] [--arch qwen3-0.6b --full]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig

# a ~25M-param decoder (the qwen3 family): big enough to show a learning
# curve, small enough for a few hundred steps
SMALL = ModelConfig(
    name="qwen3-25m", family="dense", n_layers=8, d_model=256, n_heads=8,
    n_kv_heads=4, d_ff=1024, vocab_size=8192, head_dim=32, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True, dtype="float32",
    attn_chunk_q=64, attn_chunk_k=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-25m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ft_ckpt"))
    args = ap.parse_args(argv)

    small = args.arch == "qwen3-25m"
    fail_at = [args.steps // 3, 2 * args.steps // 3]
    print(f"training {args.arch} for {args.steps} steps; injecting node "
          f"failures at {fail_at}")
    res = train("qwen3-0.6b" if small else args.arch,
                reduced=not args.full, config=SMALL if small else None,
                steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=fail_at, lr=3e-3,
                log_every=25, device=args.device)
    print("\n=== result ===")
    for k in ("final_step", "restarts", "first_loss", "final_loss", "wall_s",
              "straggler", "telemetry_points"):
        print(f"  {k}: {res[k]}")
    assert res["restarts"] == 2 and res["final_loss"] < res["first_loss"]
    print("fault-tolerant run converged despite 2 injected failures.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
