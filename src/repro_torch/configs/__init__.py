"""Architecture registry of the port: ``get_config("internlm2-1.8b")``,
``get_config("falcon-mamba-7b")``, ``get_config("starcoder2-3b")``,
``get_config("qwen3-moe-30b-a3b")`` (MoE), ``get_config("internvl2-1b")``
(its token path), ``get_config("gemma-7b")`` and ``get_config("gemma3-4b")``
(head dim 256; gemma3's local and global layers) and
``get_config("recurrentgemma-2b")`` (RG-LRU layers and MQA local
attention), ``get_config("deepseek-v2-lite-16b")`` (MLA, a dense first
layer, shared experts) and ``get_config("whisper-base")`` (the
encoder-decoder family).

Every arch of the JAX package's registry is registered; any other id
raises ``KeyError``, naming it."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ScanGroup, reduced  # noqa: F401

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-1b": "internvl2_1b",
    "gemma-7b": "gemma_7b",
    "gemma3-4b": "gemma3_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "whisper-base": "whisper_base",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[key]}").CONFIG
