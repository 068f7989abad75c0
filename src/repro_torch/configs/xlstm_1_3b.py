"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
48L d_model=2048 4H d_ff=0 vocab=50304; recurrent => subquadratic (runs
long_500k). d_ff=0: the xLSTM blocks carry their own projections."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=1024,  # d_inner(=2*d_model)/4 heads
    slstm_every=8,  # 42 mLSTM + 6 sLSTM (the paper's ~7:1 mix)
    rotary_pct=0.0,  # recurrence encodes position
    subquadratic=True,
    ssm_chunk=512,  # bound scan-carry residuals for bwd (DESIGN SS5)
)
