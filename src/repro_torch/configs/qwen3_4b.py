"""qwen3-4b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
36L d_model=2560 32H kv=8 d_ff=9728 vocab=151936; per-head RMS q/k norm,
head_dim=128, rope theta 1e6."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
