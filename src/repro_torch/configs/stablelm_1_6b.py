"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified].
24L d_model=2048 32H kv=32 d_ff=5632 vocab=100352; LayerNorm, partial
rotary (25%), gated-silu MLP."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    d_ff=5632,
    vocab=100352,
    norm="layernorm",
    rotary_pct=0.25,
    rope_theta=10000.0,
)
