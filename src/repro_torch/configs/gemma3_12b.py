"""Gemma3-12B: 5:1 local:global sliding-window attention, 128k context.

[hf:google/gemma-3-1b-pt family]. Pattern LLLLLG, window 1024, qk-norm,
dual rope theta (10k local / 1M global), tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab_size=262144, head_dim=256, qk_norm=True,
    layer_pattern=("L", "L", "L", "L", "L", "G"), local_window=1024,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    tie_embeddings=True, scale_embeddings=True,
)
REDUCED = CONFIG.reduced()
