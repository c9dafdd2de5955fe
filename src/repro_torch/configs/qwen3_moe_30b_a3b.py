"""Qwen3-30B-A3B: 128-expert top-8 MoE, d_ff=768 per expert, qk-norm,
GQA 32/4, untied head. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    n_experts=128, experts_per_token=8,
)
REDUCED = CONFIG.reduced()
