"""gemma3-4b [hf:google/gemma-3-4b-pt; unverified] — dense, 5:1 local:global.
34L d_model=2560 8H (kv=4) d_ff=10240 vocab=262144, head_dim=256,
sliding window 1024 on local layers, dual rope base (10k local / 1M global),
qk-norm, GeGLU, gemma-style (1+w) RMSNorm, tied + scaled embeddings.
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262_144,
    groups=(ScanGroup(("L", "L", "L", "L", "L", "G"), 5),
            ScanGroup(("L", "L", "L", "L"), 1)),
    window=1024,
    rope_base=1_000_000.0,
    rope_local_base=10_000.0,
    qk_norm=True,
    mlp="geglu",
    rms_plus_one=True,
    emb_scale=True,
    tie_embeddings=True,
)
