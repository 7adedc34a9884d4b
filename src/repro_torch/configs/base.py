"""Architecture configuration, copied from ``repro.configs.base`` for the
PyTorch port.

The fields, ``ScanGroup`` patterns and :func:`reduced` are the JAX
package's, so one config describes the same model on both sides.  Only the
dtype properties differ: ``cfg.dtype`` / ``cfg.param_dtype`` strings map to
``torch.dtype`` here instead of ``jax.numpy`` dtypes.

Kind codes (see the JAX module): ``A`` full causal attention, ``L`` local
sliding-window, ``G`` global, ``R`` RG-LRU, ``M`` MoE, ``S`` Mamba-1,
``D`` dense block in a MoE model.  The port runs ``A``, ``L``, ``G``,
``R``, ``S``, ``D`` and ``M`` (with MLA where ``kv_lora_rank`` is set,
and shared experts).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ScanGroup:
    pattern: Tuple[str, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    groups: Tuple[ScanGroup, ...] = ()

    # --- attention ---
    rope_base: float = 10_000.0
    rope_local_base: float = 10_000.0
    window: int = 0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0

    # --- MLP ---
    mlp: str = "swiglu"                 # swiglu | geglu | gelu_mlp
    emb_scale: bool = False
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0
    conv_k: int = 4
    dt_rank: int = 0

    # --- RG-LRU ---
    lru_width: int = 0
    conv_k_rg: int = 4

    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"
    n_patches: int = 0

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    rms_plus_one: bool = False

    # --- runtime knobs (kept so configs compare field for field with the
    # JAX package; the port always routes paged attention through
    # repro_torch.kernels.ops) ---
    remat: str = "none"
    use_kernels: bool = False
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.groups and self.n_layers:
            kind = {"moe": "M", "ssm": "S"}.get(self.family, "A")
            object.__setattr__(self, "groups", (ScanGroup((kind,), self.n_layers),))
        if self.family != "encdec":
            total = sum(g.n_layers for g in self.groups)
            if total != self.n_layers:
                raise ValueError(f"{self.name}: groups hold {total} layers, "
                                 f"n_layers is {self.n_layers}")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (the JAX package pads the
        embedding table so the vocab dim shards evenly)."""
        m = 128
        return -(-self.vocab // m) * m

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU tests (``repro.configs.base.
    reduced``, field for field)."""
    groups = tuple(ScanGroup(g.pattern, min(g.repeats, 1)) for g in cfg.groups)
    n_layers = sum(g.n_layers for g in groups)
    kw = dict(
        n_layers=n_layers,
        groups=groups,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), expert_d_ff=32,
                  shared_d_ff=64 if cfg.n_shared_experts else 0,
                  dense_d_ff=128 if cfg.dense_d_ff else 0)
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=8, d_inner=128, dt_rank=8, conv_k=4)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.family == "encdec":
        enc = max(1, cfg.enc_layers // 6)
        dec = max(1, cfg.dec_layers // 6)
        kw.update(enc_layers=enc, dec_layers=dec, n_layers=enc + dec, groups=())
    if cfg.n_patches:
        kw.update(n_patches=4)
    return cfg.replace(**kw)
