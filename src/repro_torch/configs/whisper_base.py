"""whisper-base [arXiv:2212.04356; unverified] — encoder-decoder backbone.
6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.  The conv audio
frontend is a STUB: ``api.input_batch`` gives precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=12,
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    rope_base=0.0,              # sinusoidal positions, no rope
    mlp="gelu_mlp",
    norm="layernorm",
    norm_eps=1e-5,
    frontend="audio_frames",
)
