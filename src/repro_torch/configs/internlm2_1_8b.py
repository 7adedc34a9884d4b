"""internlm2-1.8b [arXiv:2403.17297; hf] — dense GQA decoder.
24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92544, RoPE 1e6, SwiGLU, RMSNorm.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92544,
    groups=(ScanGroup(("A",), 24),),
    rope_base=1_000_000.0,
    mlp="swiglu",
)
