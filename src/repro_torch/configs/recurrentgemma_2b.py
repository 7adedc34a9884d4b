"""recurrentgemma-2b [arXiv:2402.19427; hf] — Griffin hybrid: RG-LRU + local
attention in a (R,R,L) pattern.  26L d_model=2560 10H (MQA kv=1 head_dim=256)
d_ff=7680 lru_width=2560, local window 2048.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    groups=(ScanGroup(("R", "R", "L"), 8), ScanGroup(("R", "R"), 1)),
    lru_width=2560,
    conv_k_rg=4,
    window=2048,
    rope_base=10_000.0,
    rope_local_base=10_000.0,
    mlp="geglu",
    rms_plus_one=True,
    emb_scale=True,
    tie_embeddings=True,
)
