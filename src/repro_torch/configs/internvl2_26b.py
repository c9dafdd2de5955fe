"""InternVL2-26B backbone: InternViT frontend (STUB) + InternLM2-20B LM.

[arXiv:2404.16821; hf].  The vision frontend supplies 256 precomputed patch
embeddings via input_specs(); only the transformer backbone is modeled.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, head_dim=128, rope_theta=1_000_000.0,
    frontend="vision", frontend_tokens=256,
)
REDUCED = CONFIG.reduced()
