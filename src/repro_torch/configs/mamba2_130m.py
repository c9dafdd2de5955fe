"""Mamba2-130m: attention-free SSD (state-space duality). [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_conv_width=4, layer_pattern=("M",),
)
REDUCED = CONFIG.reduced()
