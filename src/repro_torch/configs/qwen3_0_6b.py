"""Qwen3-0.6B: dense GQA decoder with qk-norm and a tied head.
[hf:Qwen/Qwen3-0.6B config.json]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)
REDUCED = CONFIG.reduced()
