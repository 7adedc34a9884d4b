"""starcoder2-3b [arXiv:2402.19173; hf] — dense GQA decoder.
30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152, RoPE, LayerNorm+gelu MLP.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    groups=(ScanGroup(("A",), 30),),
    rope_base=999_999.4,        # starcoder2 rope theta
    mlp="gelu_mlp",
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
)
