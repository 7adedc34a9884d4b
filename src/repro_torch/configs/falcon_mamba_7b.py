"""falcon-mamba-7b [arXiv:2410.05355; unverified] — pure Mamba-1 SSM, attn-free.
64L d_model=4096, d_inner=8192, ssm_state=16, dt_rank=256, conv_k=4,
vocab=65024.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=65024,
    groups=(ScanGroup(("S",), 64),),
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    conv_k=4,
    mlp="swiglu",
    tie_embeddings=True,
)
