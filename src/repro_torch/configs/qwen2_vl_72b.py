"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
80L d_model=8192 64H kv=8 d_ff=29568 vocab=152064.  Vision frontend is a
STUB: input_specs() provides patch embeddings merged over the leading
positions; M-RoPE uses (t, h, w) position triples over head_dim=128
sections (16, 24, 24)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)
