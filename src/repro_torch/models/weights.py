"""Parameters of the port: carried over from the JAX package, read from a
``Checkpointer`` step, or made by the port's own seeded init.

The tree is the JAX package's (``models/api.py`` + ``transformer.
init_params``), with torch tensors at the leaves::

    {"embedding": {"table": (padded_vocab, d)},
     "final_norm": {"w": (d,)},
     "groups": [[{"ln1": {"w"}, "mixer": {"wq", "wk", "wv", "wo"},
                  "ln2": {"w"}, "ffn": {"w_gate", "w_up", "w_down"}}]],
     "lm_head": (d, padded_vocab)}

Layer leaves are stacked ``(repeats, ...)``.  Flat keys are the tree paths
``checkpointer.py:25-31`` writes: ``groups/0/0/mixer/wq`` and so on.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# (per-layer shape, init): "normal" is N(0,1) / sqrt(fan_in), "embedding"
# N(0,1) (scale 1.0), "ones" the norm weights (layers.py:15-26)
_Spec = Tuple[Tuple[int, ...], str]


def param_specs(cfg) -> Dict[str, Tuple[int, _Spec]]:
    """Flat key -> (repeats or 0 for unstacked, (per-layer shape, init))."""
    d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    norm_init = "zeros" if cfg.rms_plus_one else "ones"
    specs = {"embedding/table": (0, ((cfg.padded_vocab, d), "embedding")),
             "final_norm/w": (0, ((d,), norm_init))}
    for gi, g in enumerate(cfg.groups):
        for pi, kind in enumerate(g.pattern):
            if kind != "A" or cfg.qk_norm or cfg.mlp != "swiglu" or \
                    cfg.norm != "rmsnorm":
                raise NotImplementedError(
                    f"{cfg.name}: only plain kind-A layers (rmsnorm, "
                    f"swiglu, no qk-norm) are in the port yet: ROADMAP.md, "
                    f"Queue 1, item 6 (the other LM families)")
            pre, R = f"groups/{gi}/{pi}", g.repeats
            specs.update({
                f"{pre}/ln1/w": (R, ((d,), norm_init)),
                f"{pre}/mixer/wq": (R, ((d, H * hd), "normal")),
                f"{pre}/mixer/wk": (R, ((d, KV * hd), "normal")),
                f"{pre}/mixer/wv": (R, ((d, KV * hd), "normal")),
                f"{pre}/mixer/wo": (R, ((H * hd, d), "normal")),
                f"{pre}/ln2/w": (R, ((d,), norm_init)),
                f"{pre}/ffn/w_gate": (R, ((d, f), "normal")),
                f"{pre}/ffn/w_up": (R, ((d, f), "normal")),
                f"{pre}/ffn/w_down": (R, ((f, d), "normal")),
            })
    if not cfg.tie_embeddings:
        specs["lm_head"] = (0, ((d, cfg.padded_vocab), "normal"))
    return specs


def _full_shape(spec) -> Tuple[int, ...]:
    R, (shape, _) = spec
    return (R,) + shape if R else shape


def _unflatten(flat: Mapping[str, torch.Tensor]):
    """Nested dicts from path keys; levels keyed by integers become
    lists, as in the JAX tree."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A writable copy of ``arr`` (numpy views of JAX arrays are
    read-only)."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        # ml_dtypes bfloat16 (or its raw 2-byte form after np.savez)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Mapping[str, np.ndarray], cfg, device="cuda"):
    """The JAX package's parameters, as numpy arrays keyed by tree path,
    -> the port's parameter tree on ``device`` in ``cfg.param_dtype``."""
    device = resolve_device(device)
    flat = {}
    for key, spec in param_specs(cfg).items():
        if key not in tree:
            raise KeyError(f"parameter {key!r} missing from the tree")
        t = _to_tensor(np.asarray(tree[key]))
        if tuple(t.shape) != _full_shape(spec):
            raise ValueError(f"parameter {key!r} has shape "
                             f"{tuple(t.shape)}, expected {_full_shape(spec)}")
        flat[key] = t.to(device=device, dtype=cfg.p_dtype)
    return _unflatten(flat)


def load_checkpoint(step_dir: str, cfg, device="cuda"):
    """Read a ``Checkpointer`` step directory's ``arrays.npz`` (written by
    the JAX package) into the port's parameter tree."""
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        return params_from_numpy({k: data[k] for k in data.files}, cfg,
                                 device)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """The port's own seeded init, with the JAX package's distributions:
    weights N(0,1) / sqrt(fan_in) (fan_in = the per-layer input width),
    the embedding N(0,1), norms ones.  Draws come from ``generator``,
    which must live on ``device``; JAX's ``PRNGKey`` draws cannot be
    reproduced, so parity tests carry JAX weights over with
    :func:`params_from_numpy` instead."""
    device = resolve_device(device)
    flat = {}
    for key, spec in param_specs(cfg).items():
        shape, init = spec[1]
        full = _full_shape(spec)
        if init in ("ones", "zeros"):
            fill = torch.ones if init == "ones" else torch.zeros
            flat[key] = fill(full, dtype=cfg.p_dtype, device=device)
            continue
        std = 1.0 if init == "embedding" else 1.0 / math.sqrt(shape[0])
        w = torch.randn(full, generator=generator, device=device,
                        dtype=torch.float32)
        flat[key] = (w * std).to(cfg.p_dtype)
    return _unflatten(flat)
