"""RecurrentGemma-2B (Griffin): RG-LRU + local MQA, pattern (R,R,A) 1:2.

[arXiv:2402.19427; hf].  26 layers = 8 x (R,R,L) + 2 trailing R;
window 2048, lru_width 2560, MQA (kv=1), head_dim 256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256, layer_pattern=("R", "R", "L"),
    local_window=2048, lru_width=2560, rope_theta=10_000.0,
    tie_embeddings=True, scale_embeddings=True,
)
REDUCED = CONFIG.reduced()
