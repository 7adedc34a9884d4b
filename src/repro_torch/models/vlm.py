"""VLM backbone of the port (``repro.models.vlm``, internvl2-1b): the ViT
frontend is a stub, as in JAX.  ``patch_embeds`` (B, n_patches, d_model)
are precomputed embeddings prepended to the token embeddings; the LM
backbone is the decoder of :mod:`repro_torch.models.transformer`."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed, token_nll


def mixed_embeds(params, cfg, patch_embeds, tokens):
    tok = embed(params["embedding"], tokens, cfg)
    return torch.cat([patch_embeds.to(tok.dtype), tok], dim=1)


def forward(params, cfg, patch_embeds, tokens):
    x = mixed_embeds(params, cfg, patch_embeds, tokens)
    return tfm.forward(params, cfg, embeds=x)


def loss(params, cfg, patch_embeds, tokens):
    """Next-token CE on the text positions only, a plain mean, plus the
    router aux loss (``vlm.py:24-34``)."""
    logits, aux = forward(params, cfg, patch_embeds, tokens)
    P = patch_embeds.shape[1]
    text_logits = logits[:, P:, :]
    targets = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    l = torch.mean(token_nll(text_logits, targets))          # noqa: E741
    aux = torch.as_tensor(aux, dtype=torch.float32, device=l.device)
    return l + aux, (l, aux)


def prefill(params, cfg, patch_embeds, tokens, caches):
    """The patch prefix and the prompt into dense caches: the port's
    prefill over mixed embeddings (``vlm.py:37-38``)."""
    x = mixed_embeds(params, cfg, patch_embeds, tokens)
    return tfm.prefill(params, cfg, None, caches, embeds=x)
