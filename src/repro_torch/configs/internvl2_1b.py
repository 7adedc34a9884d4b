"""internvl2-1b [arXiv:2404.16821; hf] — VLM: ViT frontend STUB + LM backbone.
24L d_model=896 14H (kv=2) d_ff=4864 vocab=151655.  The JAX package
prepends precomputed patch embeddings (B, n_patches, d_model) to the
tokens; the port serves the backbone on token prompts only, and trains
it with the patch prefix (``models/vlm.py``).
"""
from repro_torch.configs.base import ArchConfig, ScanGroup

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    groups=(ScanGroup(("A",), 24),),
    rope_base=1_000_000.0,
    mlp="swiglu",
    tie_embeddings=True,
    frontend="vision_patches",
    n_patches=256,
)
