"""gemma-7b [arXiv:2403.08295; hf] — dense MHA (kv=16), GeGLU, head_dim=256.
28L d_model=3072 16H d_ff=24576 vocab=256000, scaled+tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256_000,
    groups=(ScanGroup(("A",), 28),),
    rope_base=10_000.0,
    mlp="geglu",
    rms_plus_one=True,
    emb_scale=True,
    tie_embeddings=True,
)
