"""Family-dispatching model API of the port (``repro.models.api``).

Every arch of the port exposes the same step functions
(dense / moe / ssm / hybrid / encdec / vlm):

  init(generator, cfg, device[, with_axes]) -> params [, logical_axes]
  loss_fn(params, cfg, batch)             -> (loss, (ce, aux))  [train_step]
  forward_fn(params, cfg, batch)          -> logits
  prefill_fn(params, cfg, batch, caches)  -> (logits, caches)
  decode_fn(params, cfg, batch, caches)   -> (logits, caches)
  init_caches(cfg, batch, max_len, ...)   -> cache tree
  input_batch(cfg, shape_kind, batch, seq, generator, device)
                                          -> concrete inputs

As in JAX, ``input_batch`` gives the modality frontend's stubs: whisper
gets frame embeddings, internvl patch embeddings.  ``init`` returns the
parameter tree, and with ``with_axes=True`` JAX's pair ``(params,
logical_axes)``: the axes that ``core.sharding`` maps onto a mesh
(``weights.param_axes``).  The dry run's shape-only entry points,
``abstract_params`` and ``input_specs``, give the same trees as tensors on
the ``meta`` device: shapes and dtypes, nothing allocated and nothing
drawn (``launch/dryrun_lib.py`` makes fake tensors of them).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models import vlm
from repro_torch.models.weights import empty_params, init_params, \
    param_axes


def init(generator: torch.Generator, cfg, device="cuda",
         with_axes: bool = False):
    """The port's seeded init (:func:`weights.init_params`), JAX's
    distributions drawn from ``generator``, which lives on ``device``;
    with ``with_axes``, ``(params, logical_axes)`` as JAX's ``init``
    returns them."""
    params = init_params(cfg, generator, device)
    return (params, param_axes(cfg)) if with_axes else params


def abstract_params(cfg):
    """Shapes-only params for the dry run: ``(params, logical_axes)`` as
    JAX's ``abstract_params`` returns them, the tree of
    :func:`weights.init_params` (its shapes, dtypes and stacked
    ``(repeats, ...)`` leaves) on the ``meta`` device."""
    return empty_params(cfg, "meta"), param_axes(cfg)


# ----------------------------------------------------------------------
def loss_fn(params, cfg, batch):
    """``(loss + aux, (ce, aux))`` of a batch: ``{"tokens"}``, plus
    ``"frames"`` for the encoder-decoder, ``"patches"`` for the VLM and an
    optional ``"targets"``."""
    if cfg.family == "encdec":
        return encdec.loss(params, cfg, batch["frames"], batch["tokens"])
    if cfg.family == "vlm":
        return vlm.loss(params, cfg, batch["patches"], batch["tokens"])
    return tfm.lm_loss(params, cfg, batch["tokens"],
                       targets=batch.get("targets"))


def forward_fn(params, cfg, batch):
    if cfg.family == "encdec":
        enc = encdec.encode(params, batch["frames"], cfg)
        return encdec.decode_full(params, batch["tokens"], enc, cfg)
    if cfg.family == "vlm":
        return vlm.forward(params, cfg, batch["patches"], batch["tokens"])[0]
    return tfm.forward(params, cfg, tokens=batch["tokens"])[0]


def init_caches(cfg, batch: int, max_len: int, enc_len: int = 0,
                device="cuda"):
    """The caches of ``batch`` rows of ``max_len`` positions; the
    encoder-decoder's cross caches hold ``enc_len or max_len`` rows."""
    if cfg.family == "encdec":
        return encdec.init_caches(cfg, batch, max_len, enc_len or max_len,
                                  resolve_device(device))
    return tfm.init_caches(cfg, batch, max_len, resolve_device(device))


def prefill_fn(params, cfg, batch, caches):
    if cfg.family == "encdec":
        return encdec.prefill(params, batch["tokens"], batch["frames"], cfg,
                              caches)
    if cfg.family == "vlm":
        return vlm.prefill(params, cfg, batch["patches"], batch["tokens"],
                           caches)
    return tfm.prefill(params, cfg, batch["tokens"], caches)


def decode_fn(params, cfg, batch, caches):
    if cfg.family == "encdec":
        return encdec.decode_step(params, batch["tokens"], caches,
                                  batch["pos"], cfg)
    return tfm.decode_step(params, cfg, batch["tokens"], caches,
                           batch["pos"])


# ----------------------------------------------------------------------
def input_batch(cfg, shape_kind: str, batch: int, seq: int,
                generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Concrete random inputs with JAX's shapes and dtypes (``api.py:
    81-99``): int32 tokens (B, seq) below ``vocab``, the encoder-decoder's
    fp32 frames (B, seq, d_model) beside them, the VLM's fp32 patches (B,
    min(n_patches, seq), d_model) before max(seq - n_patches, 1) tokens;
    ``decode`` keeps the first token and adds ``pos`` (B,) int32 = seq -
    1.  Draws come from ``generator``, which lives on ``device``; they are
    not JAX's draws."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    tok_seq = seq
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                    generator=generator, device=dev,
                                    dtype=torch.float32)
    elif cfg.family == "vlm":
        npatch = min(cfg.n_patches, seq)
        out["patches"] = torch.randn((batch, npatch, cfg.d_model),
                                     generator=generator, device=dev,
                                     dtype=torch.float32)
        tok_seq = max(seq - npatch, 1)
    out["tokens"] = torch.randint(0, cfg.vocab, (batch, tok_seq),
                                  generator=generator, device=dev,
                                  dtype=torch.int32)
    if shape_kind == "decode":
        out["tokens"] = out["tokens"][:, :1]
        out["pos"] = torch.full((batch,), seq - 1, dtype=torch.int32,
                                device=dev)
    return out


def input_specs(cfg, shape_kind: str, batch: int, seq: int,
                batch_sharding=None):
    """Shape-only stand-ins for the dry run (``api.py:102-122``), on the
    ``meta`` device: decode takes ``tokens`` (B, 1) and ``pos`` (B,)
    int32 and no frontend inputs; otherwise int32 ``tokens`` (B, seq),
    with whisper's fp32 ``frames`` (B, seq, d_model) or internvl's fp32
    ``patches`` (B, min(n_patches, seq), d_model) before max(seq -
    n_patches, 1) tokens.  With ``batch_sharding`` (a leaf's rank -> its
    sharding) each leaf carries its sharding as ``.sharding``, as JAX's
    ``ShapeDtypeStruct`` does."""
    def sds(shape, dtype):
        t = torch.empty(shape, dtype=dtype, device="meta")
        if batch_sharding is not None:
            t.sharding = batch_sharding(len(shape))
        return t
    out: Dict[str, Any] = {}
    tok_seq = seq
    if shape_kind == "decode":
        out["tokens"] = sds((batch, 1), torch.int32)
        out["pos"] = sds((batch,), torch.int32)
    else:
        if cfg.family == "encdec":
            out["frames"] = sds((batch, seq, cfg.d_model), torch.float32)
        elif cfg.family == "vlm":
            npatch = min(cfg.n_patches, seq)
            out["patches"] = sds((batch, npatch, cfg.d_model),
                                 torch.float32)
            tok_seq = max(seq - npatch, 1)
        out["tokens"] = sds((batch, tok_seq), torch.int32)
    return out
