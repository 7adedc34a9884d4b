"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MoE with MLA attention.
27L d_model=2048 16H, MLA kv_lora=512 (rope 64 / nope 128 / v 128),
layer 0 dense (d_ff=10944), layers 1..26 MoE: 2 shared + 64 routed top-6,
expert d_ff=1408, vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102_400,
    groups=(ScanGroup(("D",), 1), ScanGroup(("M",), 26)),
    dense_d_ff=10944,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    shared_d_ff=2816,
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    rope_base=10_000.0,
    mlp="swiglu",
)
