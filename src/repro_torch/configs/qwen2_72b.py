"""qwen2-72b — GQA, QKV bias [arXiv:2407.10671; hf].
80L d_model=8192 64H kv=8 d_ff=29568 vocab=152064."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
