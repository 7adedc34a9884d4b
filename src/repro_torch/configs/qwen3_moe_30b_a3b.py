"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — MoE decoder.
48L d_model=2048 32H (kv=4, head_dim=128) vocab=151936,
128 routed experts top-8 (no shared), expert d_ff=768, qk-norm.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    groups=(ScanGroup(("M",), 48),),
    n_experts=128,
    top_k=8,
    expert_d_ff=768,
    qk_norm=True,
    rope_base=1_000_000.0,
    mlp="swiglu",
)
