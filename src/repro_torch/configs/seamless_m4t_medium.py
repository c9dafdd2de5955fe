"""SeamlessM4T-medium backbone: 12 enc + 12 dec layers, MHA (kv=16).

[arXiv:2308.11596; hf].  Audio frontend is a STUB: the encoder takes
precomputed frame embeddings (B, S_enc, d) directly.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64, scale_embeddings=True,
    frontend="audio",
)
REDUCED = CONFIG.reduced()
