"""Gemma3-4B: 34L (5 full LLLLLG groups + 4 trailing local layers)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262144, head_dim=256, qk_norm=True,
    layer_pattern=("L", "L", "L", "L", "L", "G"), local_window=1024,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    tie_embeddings=True, scale_embeddings=True,
)
REDUCED = CONFIG.reduced()
