"""Model configuration: the port's own copy of ``repro.models.config``.

One frozen dataclass describes every family; family-specific fields default
to "off".  The fields, ``pad_vocab`` and ``reduced()`` are kept identical to
the reference so that a config built here and one built there describe the
same shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 2048


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # transformer core ----------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # None -> d_model // n_heads
    # attention details ---------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None
    scale_embeddings: bool = False
    local_window: int = 0
    layer_pattern: Tuple[str, ...] = ()
    # mixture of experts --------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # state-space (mamba2 / SSD) -----------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    # hybrid (RG-LRU) ------------------------------------------------------
    lru_width: int = 0
    # encoder-decoder ------------------------------------------------------
    n_enc_layers: int = 0
    # modality frontend stub ----------------------------------------------
    frontend: str = "none"
    frontend_tokens: int = 0
    # numerics / misc ------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time switches (not architecture) ----------------------------
    remat_policy: str = "nothing"
    attn_impl: str = "scan"
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    decode_cache_heads: int = 0

    # derived --------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True when the decode state is bounded (sub-quadratic)."""
        return self.family in ("ssm", "hybrid")

    def pattern_for_layers(self, n: Optional[int] = None) -> Tuple[str, ...]:
        """Expand the repeating layer pattern to n layers."""
        n = n if n is not None else self.n_layers
        pat = self.layer_pattern or ("G",)
        return tuple(pat[i % len(pat)] for i in range(n))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small config of the same family for CPU tests (same rule as the
        reference, so both packages shrink a config to the same shapes)."""
        pat = self.layer_pattern
        n_layers = max(len(pat), 2) if pat else 2
        if self.family == "hybrid":
            n_layers = len(pat) + 2 if pat else 3
        if pat and self.family == "dense":
            n_layers = len(pat) + 2
        kv = max(1, min(self.n_kv_heads, 2))
        heads = kv * min(self.q_groups, 2)
        hd = 16
        return self.replace(
            n_layers=n_layers,
            d_model=heads * hd if self.family != "hybrid" else 32,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=64,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=8 if self.ssm_state else 64,
            lru_width=32 if self.lru_width else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            frontend_tokens=4 if self.frontend != "none" else 0,
            attn_chunk_q=8,
            attn_chunk_k=8,
            dtype="float32",
        )
