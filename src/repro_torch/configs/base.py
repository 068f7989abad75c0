"""Architecture & shape configuration schema (the port's copy of
``repro.configs.base``; the fields and `reduced()` are the same, so a
config means the same model on both sides).

One `ArchConfig` per ported architecture lives in `configs/<id>.py`; the
four LM input-shape sets are `SHAPES` below.  `reduced()` derives the smoke-
test config (same family, tiny dims) used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "TRAIN_SHAPES", "DECODE_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_every: int = 0  # hybrid: shared attention after every N ssm layers
    slstm_every: int = 0  # xlstm: sLSTM block every N blocks

    # encoder-decoder (audio)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: Optional[str] = None  # "audio" | "vision" (STUB embeddings)

    # attention implementation: "blockwise" (plain online softmax),
    # "sfc" (the SFC flash forward K11 and decode K14) or "flash_pallas"
    # (the dense flash forward K15)
    attn_impl: str = "blockwise"
    q_chunk: int = 512
    k_chunk: int = 1024

    # capability flags
    subquadratic: bool = False  # can run long_500k
    has_decoder: bool = True

    param_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            kv_heads=min(self.kv_heads, 4) if self.kv_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            q_chunk=16,
            k_chunk=16,
            ssm_chunk=8,
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

TRAIN_SHAPES = ("train_4k",)
DECODE_SHAPES = ("decode_32k", "long_500k")
