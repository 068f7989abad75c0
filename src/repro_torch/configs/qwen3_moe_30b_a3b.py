"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
48L d_model=2048 32H kv=4 d_ff=768 vocab=151936, MoE 128e top-8; qk_norm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    rope_theta=1_000_000.0,
)
