"""zamba2-1.2b — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].
38L d_model=2048 32H kv=32 d_ff=8192 vocab=32000, ssm_state=64; one shared
attention block applied every 6 mamba layers (weight sharing = Zamba trick);
SSM => subquadratic (runs long_500k)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    subquadratic=True,
    ssm_chunk=256,  # bound scan-carry residuals for bwd (DESIGN SS5)
)
