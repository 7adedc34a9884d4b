"""Step builders of the port (``repro.launch.steps``): the train step the
training driver runs, and the prefill and decode steps of the model API.
They take every family's batch as ``api`` does: ``{"tokens"}``, with
``"frames"`` for the encoder-decoder (whisper-base, whose train step runs
here on ``{"frames", "tokens"}``; the training driver feeds tokens only)
and ``"patches"`` for the VLM.

The JAX module also builds the sharding specs of every (arch x shape)
cell (``cache_specs``, ``batch_shardings``, ``opt_shardings``, ...); they
come with the multi-device port and the dry run (ROADMAP.md, Queue 1,
items 8 and 9).
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_like


def value_and_grad(params, cfg, batch):
    """``((loss, (ce, aux)), grads)`` of ``api.loss_fn``, as
    ``jax.value_and_grad(..., has_aux=True)`` gives them: the gradient of
    each leaf in its dtype, zeros for a leaf the loss does not reach.  The
    caller's tensors are left as they are: the gradients are taken with
    respect to detached leaves of this call's own."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = flatten_with_paths(leaves)
    with torch.enable_grad():
        loss, (ce, aux) = api.loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(p)
             for (k, p), g in zip(flat.items(), grads)}
    return (loss.detach(), (ce.detach(), aux.detach())), \
        unflatten_like(params, grads)


def make_train_step(cfg, *, lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, clip: float = 1.0,
                    accum_steps: int = 1):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``
    (``steps.py:96-144``).  ``accum_steps > 1`` splits the batch into
    micro-batches taken in order, their gradients summed in fp32 and
    averaged, as JAX's ``lax.scan`` does.  The gradients are clipped to
    global norm ``clip``; the learning rate is the cosine schedule at the
    optimizer's step count before this step.  Metrics are fp32 scalars:
    ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``."""

    def step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, (ce, aux)), grads = value_and_grad(params, cfg, batch)
        else:
            micro = tree_map(lambda a: a.reshape(
                (accum_steps, a.shape[0] // accum_steps) + a.shape[1:]),
                batch)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = ce = aux = 0.0
            for i in range(accum_steps):
                mb = tree_map(lambda a: a[i], micro)
                (l, (c, a)), g = value_and_grad(params, cfg, mb)
                grads = tree_map(lambda x, y: x + y.float(), grads, g)
                loss, ce, aux = loss + l, ce + c, aux + a
            inv = 1.0 / accum_steps
            grads = tree_map(lambda g: g * inv, grads)
            loss, ce, aux = loss * inv, ce * inv, aux * inv
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip)
            lr_t = cosine_schedule(opt_state.step, peak_lr=lr, warmup=warmup,
                                   total=total)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             lr=lr_t)
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux,
                                   "grad_norm": gnorm, "lr": lr_t}

    return step


def make_prefill_step(cfg, max_len: int):
    def step(params, batch, caches):
        return api.prefill_fn(params, cfg, batch, caches)
    return step


def make_decode_step(cfg):
    def step(params, batch, caches):
        return api.decode_fn(params, cfg, batch, caches)
    return step
