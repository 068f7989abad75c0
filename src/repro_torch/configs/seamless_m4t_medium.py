"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].
12L d_model=1024 16H kv=16 d_ff=4096 vocab=256206.  The audio frontend is a
STUB: the encoder takes precomputed frame embeddings (B, S, d)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=4096,
    vocab=256206,
    is_encoder_decoder=True,
    frontend="audio",
    gated_mlp=False,
    act="gelu",
)
