"""Parameters of the port: carried over from the JAX package, read from a
``Checkpointer`` step, or made by the port's own seeded init.

The tree is the JAX package's (``models/api.py`` + ``transformer.
init_params``), with torch tensors at the leaves::

    {"embedding": {"table": (padded_vocab, d)},
     "final_norm": {"w": (d,)},
     "groups": [[{"ln1": {"w"}, "mixer": {"wq", "wk", "wv", "wo"},
                  "ln2": {"w"}, "ffn": {"w_gate", "w_up", "w_down"}}]],
     "lm_head": (d, padded_vocab)}

A LayerNorm config adds a bias ``"b"`` beside each norm's ``"w"``, and
the plain GELU MLP is ``{"w_up", "b_up", "w_down", "b_down"}``
(``layers.py:83-88``, ``transformer.py:36-40``); GeGLU has SwiGLU's
leaves.  Kinds ``L`` and ``G`` (gemma3's local and global layers) have
kind ``A``'s.  qk-norm adds
``"q_norm"`` and ``"k_norm"`` (hd,) to the mixer, and a kind-``M`` (MoE)
layer's ``"ffn"`` is ``{"router" (d, E), "w_gate", "w_up" (E, d, f),
"w_down" (E, f, d)}`` (``moe.py:16-24``), with shared experts a dense
``"shared"`` MLP beside them (``:26-28``).  A kind-``D`` layer (the dense
first layer of a MoE model) is kind ``A``'s at ``dense_d_ff``; an MLA
layer's mixer is ``{"wq", "w_dkv", "w_krope", "kv_norm", "w_uk", "w_uv",
"wo"}`` (``attention.py:566-579``).  A kind-``S`` (Mamba-1) layer
is ``{"ln1": {"w"}, "mixer": {"in_proj", "conv_w", "conv_b", "x_proj",
"dt_proj", "dt_bias", "A_log", "D", "out_proj"}}`` (``ssm.py:21-36``),
and a kind-``R`` (RG-LRU) layer is ``{"ln1": {"w"}, "mixer": {"in_x",
"in_gate", "conv_w", "conv_b", "w_a", "b_a", "w_i", "b_i", "lambda",
"out"}, "ln2": {"w"}, "ffn"}`` (``rglru.py:20-36``).
The encoder-decoder family (whisper-base) has a tree of its own
(``encdec.py:41-68``): ``{"embedding": {"table"}, "enc": {"ln1",
"self": {"wq", "wk", "wv", "wo"}, "ln2", "ffn"}, "dec": {"ln1", "self",
"ln_x", "cross", "ln2", "ffn"}, "enc_norm", "dec_norm", "lm_head"}``,
its layers stacked ``(enc_layers, ...)`` and ``(dec_layers, ...)``.
Layer leaves are stacked ``(repeats, ...)``.  Flat keys are the tree
paths ``checkpointer.py:25-31`` writes: ``groups/0/0/mixer/wq`` and so
on.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# (per-layer shape, init) with the JAX package's inits (layers.py:15-26,
# ssm.py:21-36, moe.py:16-24, rglru.py:20-36): "normal" is N(0,1) /
# sqrt(fan_in) with fan_in = shape[0], "embedding" N(0,1) (scale 1.0),
# "conv" N(0,1) * 0.5 and "router" N(0,1) * 0.02 (dense_init's scale is
# the std), "ones" and "zeros" constants, "a_log" the deterministic
# log(1..N) tiled over d_inner, "lambda" the deterministic
# log(expm1(linspace(0.9, 0.999, w)) ** (1/8)).  Every leaf is in
# cfg.param_dtype except "a_log" and "lambda", which stay fp32
# (spec_dtype), as the JAX init makes them.
_Spec = Tuple[Tuple[int, ...], str]


def param_specs(cfg) -> Dict[str, Tuple[int, _Spec]]:
    """Flat key -> (repeats or 0 for unstacked, (per-layer shape, init))."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    if cfg.family == "encdec":
        return _encdec_specs(cfg)
    norm_init = "zeros" if cfg.rms_plus_one else "ones"
    specs = {"embedding/table": (0, ((cfg.padded_vocab, d), "embedding"))}
    specs.update(_norm_specs(cfg, "final_norm", 0, norm_init))
    for gi, g in enumerate(cfg.groups):
        for pi, kind in enumerate(g.pattern):
            pre, R = f"groups/{gi}/{pi}", g.repeats
            if kind == "S" and cfg.norm == "rmsnorm":
                specs.update(_ssm_specs(cfg, pre, R, norm_init))
                continue
            if kind == "R" and cfg.norm == "rmsnorm" and cfg.mlp == "geglu":
                specs.update(_rglru_specs(cfg, pre, R, norm_init))
                continue
            if kind not in ("A", "L", "G", "D", "M") or \
                    cfg.mlp not in ("swiglu", "geglu", "gelu_mlp") or \
                    cfg.norm not in ("rmsnorm", "layernorm"):
                raise NotImplementedError(
                    f"{cfg.name}: only attention layers of kinds A, L, G, D "
                    f"and M (rmsnorm or layernorm, swiglu, geglu or "
                    f"gelu_mlp) and kind-S and kind-R layers are in the port "
                    f"yet: ROADMAP.md, Queue 1, item 6 (the other LM "
                    f"families)")
            specs.update(_norm_specs(cfg, f"{pre}/ln1", R, norm_init))
            if kind == "M" and cfg.kv_lora_rank:
                specs.update(_mla_specs(cfg, pre, R))
            else:
                specs.update(_attn_specs(cfg, f"{pre}/mixer", R))
                if cfg.qk_norm:
                    specs.update({
                        f"{pre}/mixer/q_norm": (R, ((hd,), "ones")),
                        f"{pre}/mixer/k_norm": (R, ((hd,), "ones"))})
            specs.update(_norm_specs(cfg, f"{pre}/ln2", R, norm_init))
            if kind == "M":
                specs.update(_moe_specs(cfg, pre, R))
            else:
                f_layer = (cfg.dense_d_ff or f) if kind == "D" else f
                specs.update(_mlp_specs(cfg, f"{pre}/ffn", R, f_layer))
    if not cfg.tie_embeddings:
        specs["lm_head"] = (0, ((d, cfg.padded_vocab), "normal"))
    return specs


def _attn_specs(cfg, pre: str, R: int):
    """An attention's projections (``attention.py:24-33``)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {f"{pre}/wq": (R, ((d, H * hd), "normal")),
            f"{pre}/wk": (R, ((d, KV * hd), "normal")),
            f"{pre}/wv": (R, ((d, KV * hd), "normal")),
            f"{pre}/wo": (R, ((H * hd, d), "normal"))}


def _encdec_specs(cfg):
    """The encoder-decoder's tree (``encdec.py:41-68``): pre-norm encoder
    layers of self-attention and MLP, decoder layers with a cross
    attention between them, a norm after each stack and an untied
    ``lm_head``."""
    d = cfg.d_model
    specs = {"embedding/table": (0, ((cfg.padded_vocab, d), "embedding"))}
    for side, R, attns in (("enc", cfg.enc_layers, ("self",)),
                           ("dec", cfg.dec_layers, ("self", "cross"))):
        specs.update(_norm_specs(cfg, f"{side}/ln1", R, "ones"))
        specs.update(_attn_specs(cfg, f"{side}/self", R))
        if "cross" in attns:
            specs.update(_norm_specs(cfg, f"{side}/ln_x", R, "ones"))
            specs.update(_attn_specs(cfg, f"{side}/cross", R))
        specs.update(_norm_specs(cfg, f"{side}/ln2", R, "ones"))
        specs.update(_mlp_specs(cfg, f"{side}/ffn", R, cfg.d_ff))
    for name in ("enc_norm", "dec_norm"):
        specs.update(_norm_specs(cfg, name, 0, "ones"))
    specs["lm_head"] = (0, ((d, cfg.padded_vocab), "normal"))
    return specs


def _norm_specs(cfg, pre: str, R: int, norm_init: str):
    """A norm's weight, and for LayerNorm its bias (ones and zeros, as
    ``transformer.init_norm`` draws them)."""
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {f"{pre}/w": (R, ((d,), "ones")),
                f"{pre}/b": (R, ((d,), "zeros"))}
    return {f"{pre}/w": (R, ((d,), norm_init))}


def _mlp_specs(cfg, pre: str, R: int, f: int):
    """A dense MLP of width ``f`` (``layers.py:72-88``): SwiGLU's and
    GeGLU's three matrices, or the plain MLP's two with their biases."""
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        return {f"{pre}/w_gate": (R, ((d, f), "normal")),
                f"{pre}/w_up": (R, ((d, f), "normal")),
                f"{pre}/w_down": (R, ((f, d), "normal"))}
    return {f"{pre}/w_up": (R, ((d, f), "normal")),
            f"{pre}/b_up": (R, ((f,), "zeros")),
            f"{pre}/w_down": (R, ((f, d), "normal")),
            f"{pre}/b_down": (R, ((d,), "zeros"))}


def _mla_specs(cfg, pre: str, R: int):
    """The MLA mixer of one stacked kind-``M`` layer (``attention.py:
    566-579``): the query projection to ``nope + rope`` per head, the
    latent down-projection ``w_dkv`` and its norm, the shared RoPE key
    ``w_krope``, the up-projections ``w_uk`` and ``w_uv`` and ``wo``."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    rh, nh, vh = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    m = f"{pre}/mixer"
    return {f"{m}/wq": (R, ((d, H * (nh + rh)), "normal")),
            f"{m}/w_dkv": (R, ((d, r), "normal")),
            f"{m}/w_krope": (R, ((d, rh), "normal")),
            f"{m}/kv_norm": (R, ((r,), "ones")),
            f"{m}/w_uk": (R, ((r, H * nh), "normal")),
            f"{m}/w_uv": (R, ((r, H * vh), "normal")),
            f"{m}/wo": (R, ((H * vh, d), "normal"))}


def _moe_specs(cfg, pre: str, R: int):
    """The experts of one stacked kind-``M`` layer (``moe.py:16-29``): the
    router at std 0.02, the routed experts' SwiGLU weights and, where the
    config has shared experts, one dense MLP of ``shared_d_ff`` (or
    ``n_shared * expert_d_ff``) under ``"shared"``.  As in JAX's
    ``dense_init``, an expert leaf's fan-in is its first axis, the expert
    count E, not the width it multiplies (d or expert_d_ff)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    specs = {
        f"{pre}/ffn/router": (R, ((d, E), "router")),
        f"{pre}/ffn/w_gate": (R, ((E, d, f), "normal")),
        f"{pre}/ffn/w_up": (R, ((E, d, f), "normal")),
        f"{pre}/ffn/w_down": (R, ((E, f, d), "normal")),
    }
    if cfg.n_shared_experts:
        shared = cfg.shared_d_ff or cfg.n_shared_experts * f
        specs.update(_mlp_specs(cfg, f"{pre}/ffn/shared", R, shared))
    return specs


def _ssm_specs(cfg, pre: str, R: int, norm_init: str):
    """The specs of one stacked kind-``S`` layer (``ssm.py:21-36``)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, K = cfg.dt_rank, cfg.conv_k
    return {
        f"{pre}/ln1/w": (R, ((d,), norm_init)),
        f"{pre}/mixer/in_proj": (R, ((d, 2 * di), "normal")),
        f"{pre}/mixer/conv_w": (R, ((K, di), "conv")),
        f"{pre}/mixer/conv_b": (R, ((di,), "zeros")),
        f"{pre}/mixer/x_proj": (R, ((di, dtr + 2 * N), "normal")),
        f"{pre}/mixer/dt_proj": (R, ((dtr, di), "normal")),
        f"{pre}/mixer/dt_bias": (R, ((di,), "zeros")),
        f"{pre}/mixer/A_log": (R, ((di, N), "a_log")),
        f"{pre}/mixer/D": (R, ((di,), "ones")),
        f"{pre}/mixer/out_proj": (R, ((di, d), "normal")),
    }


def _rglru_specs(cfg, pre: str, R: int, norm_init: str):
    """The specs of one stacked kind-``R`` layer (``rglru.py:20-36`` and
    ``transformer.py:52-70``): the norms, the RG-LRU mixer and the GeGLU
    FFN."""
    d, w, f, K = cfg.d_model, cfg.lru_width, cfg.d_ff, cfg.conv_k_rg
    return {
        f"{pre}/ln1/w": (R, ((d,), norm_init)),
        f"{pre}/mixer/in_x": (R, ((d, w), "normal")),
        f"{pre}/mixer/in_gate": (R, ((d, w), "normal")),
        f"{pre}/mixer/conv_w": (R, ((K, w), "conv")),
        f"{pre}/mixer/conv_b": (R, ((w,), "zeros")),
        f"{pre}/mixer/w_a": (R, ((w, w), "normal")),
        f"{pre}/mixer/b_a": (R, ((w,), "zeros")),
        f"{pre}/mixer/w_i": (R, ((w, w), "normal")),
        f"{pre}/mixer/b_i": (R, ((w,), "zeros")),
        f"{pre}/mixer/lambda": (R, ((w,), "lambda")),
        f"{pre}/mixer/out": (R, ((w, d), "normal")),
        f"{pre}/ln2/w": (R, ((d,), norm_init)),
        f"{pre}/ffn/w_gate": (R, ((d, f), "normal")),
        f"{pre}/ffn/w_up": (R, ((d, f), "normal")),
        f"{pre}/ffn/w_down": (R, ((f, d), "normal")),
    }


def rglru_lambda(w: int) -> torch.Tensor:
    """The RG-LRU's ``lambda`` (``rglru.py:24``), softplus^-1 of
    ``linspace(0.9, 0.999, w) ** (1/8)`` in log space: computed in fp64 on
    the host and rounded to fp32, the same on every device.  JAX computes
    it in fp32, and its eager and jitted inits differ from each other by
    up to 6e-8."""
    x = torch.linspace(0.9, 0.999, w, dtype=torch.float64)
    return torch.log(torch.expm1(x) ** (1.0 / 8)).float()


def spec_dtype(spec, cfg) -> torch.dtype:
    """The dtype of a leaf: fp32 for ``A_log`` and ``lambda`` (the JAX
    init keeps them fp32), else ``cfg.param_dtype``."""
    return torch.float32 if spec[1][1] in ("a_log", "lambda") else \
        cfg.p_dtype


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


def tensor_from_numpy(arr: np.ndarray, copy: bool = True) -> torch.Tensor:
    """A tensor of ``arr``'s values, on a writable copy (numpy views of JAX
    arrays are read-only); ``copy=False`` shares a writable array's
    memory instead (an array ``np.load`` just read)."""
    arr = np.array(arr, copy=copy)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        # ml_dtypes bfloat16 (or its raw 2-byte form after np.savez)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Mapping[str, np.ndarray], cfg, device="cuda"):
    """The JAX package's parameters, as numpy arrays keyed by tree path,
    -> the port's parameter tree on ``device``, each leaf in its spec's
    dtype (:func:`spec_dtype`).  Every key of ``tree`` must be a leaf of
    the config's tree: a path the port names otherwise would leave a leaf
    behind without a word."""
    device = resolve_device(device)
    specs = param_specs(cfg)
    extra = sorted(set(tree) - set(specs))
    if extra:
        raise KeyError(f"parameters {extra[:8]} of the tree are not leaves "
                       f"of {cfg.name}'s tree ({len(extra)} in all)")
    flat = {}
    for key, spec in specs.items():
        if key not in tree:
            raise KeyError(f"parameter {key!r} missing from the tree")
        t = tensor_from_numpy(np.asarray(tree[key]))
        if tuple(t.shape) != _full_shape(spec):
            raise ValueError(f"parameter {key!r} has shape "
                             f"{tuple(t.shape)}, expected {_full_shape(spec)}")
        flat[key] = t.to(device=device, dtype=spec_dtype(spec, cfg))
    return _unflatten(flat)


def load_checkpoint(step_dir: str, cfg, device="cuda"):
    """Read a ``Checkpointer`` step directory's ``arrays.npz`` into the
    port's parameter tree: a bare parameter tree's step, or a trainer's
    ``{"params": ..., "opt": ...}`` step (JAX's ``launch/train.py:78-79``,
    the port's ``launch/train.py``), whose ``params/`` subtree it takes,
    leaving the optimizer state out."""
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        tree = {k: data[k] for k in data.files}
    if any(k.startswith("params/") for k in tree):
        tree = {k[len("params/"):]: a for k, a in tree.items()
                if k.startswith("params/")}
    return params_from_numpy(tree, cfg, device)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """The port's own seeded init, with the JAX package's distributions
    (the inits above): weights N(0,1) / sqrt(fan_in) (fan_in = the
    per-layer leaf's first axis: the input width, or E for an expert
    leaf), the router N(0,1) * 0.02, the embedding N(0,1), norms ones
    (zeros under ``rms_plus_one``), ``A_log`` and ``lambda`` deterministic
    and fp32.  Draws come from ``generator``, which must live on ``device``, one
    repeat at a time in fp32, so the largest transient is one layer's leaf
    (falcon-mamba-7b's in_proj is 17 GB in fp32 when stacked; a
    qwen3-moe-30b-a3b expert leaf, (128, 2048, 768), 0.8 GB).  JAX's
    ``PRNGKey`` draws cannot be reproduced, so parity tests carry JAX
    weights over with :func:`params_from_numpy` instead."""
    device = resolve_device(device)
    flat = {}
    for key, spec in param_specs(cfg).items():
        shape, init = spec[1]
        dtype = spec_dtype(spec, cfg)
        out = torch.empty(_full_shape(spec), dtype=dtype, device=device)
        if init in ("ones", "zeros"):
            out.fill_(1.0 if init == "ones" else 0.0)
        elif init == "a_log":
            n = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            out.copy_(torch.log(n).expand(out.shape))
        elif init == "lambda":
            out.copy_(rglru_lambda(shape[0]).expand(out.shape))
        else:
            std = {"embedding": 1.0, "conv": 0.5, "router": 0.02}.get(
                init, 1.0 / math.sqrt(shape[0]))
            for view in (out if spec[0] else out[None]):
                w = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
                view.copy_(w.mul_(std))
        flat[key] = out
    return _unflatten(flat)


def empty_params(cfg, device="cuda"):
    """The config's tree of uninitialised tensors, each leaf at its shape
    and dtype: what a rank that receives the weights (``core.broadcast.
    place_params``) allocates before they arrive."""
    device = resolve_device(device)
    return _unflatten({
        key: torch.empty(_full_shape(spec), dtype=spec_dtype(spec, cfg),
                         device=device)
        for key, spec in param_specs(cfg).items()})


# Logical axes of each leaf, one layer's (JAX's ``dense_init`` /
# ``Param`` axes: attention.py:24-33, 566-579; layers.py:72-88, 107-111;
# moe.py:16-28; ssm.py:21-36; rglru.py:20-36); a stacked leaf adds
# "layers" in front (transformer.py:214-235)
_ATTN_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
              "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
              "q_norm": (None,), "k_norm": (None,)}
_MLA_AXES = {"wq": ("embed", "heads"), "w_dkv": ("embed", None),
             "w_krope": ("embed", None), "kv_norm": (None,),
             "w_uk": (None, "heads"), "w_uv": (None, "heads"),
             "wo": ("heads", "embed")}
_MLP_AXES = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
             "w_down": ("ff", "embed"), "b_up": ("ff",), "b_down": ("embed",)}
_MOE_AXES = {"router": ("embed", None),
             "w_gate": ("experts", "embed", "ff"),
             "w_up": ("experts", "embed", "ff"),
             "w_down": ("experts", "ff", "embed")}
_SSM_AXES = {"in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
             "conv_b": ("inner",), "x_proj": ("inner", None),
             "dt_proj": (None, "inner"), "dt_bias": ("inner",),
             "A_log": ("inner", None), "D": ("inner",),
             "out_proj": ("inner", "embed")}
_RGLRU_AXES = {"in_x": ("embed", "lru"), "in_gate": ("embed", "lru"),
               "conv_w": (None, "lru"), "conv_b": ("lru",),
               "w_a": ("lru", None), "b_a": (None,), "w_i": ("lru", None),
               "b_i": (None,), "lambda": (None,), "out": ("lru", "embed")}


def _leaf_axes(cfg, key: str):
    parts = key.split("/")
    leaf, block = parts[-1], parts[-2] if len(parts) > 1 else ""
    if key == "embedding/table":
        return ("vocab", "embed")
    if key == "lm_head":
        return ("embed", "vocab")
    if block.startswith("ln") or block.endswith("_norm"):
        return (None,)
    kind = cfg.groups[int(parts[1])].pattern[int(parts[2])] \
        if parts[0] == "groups" else "A"
    if block in ("mixer", "self", "cross"):
        table = {"S": _SSM_AXES, "R": _RGLRU_AXES}.get(kind, _ATTN_AXES)
        if kind == "M" and cfg.kv_lora_rank:
            table = _MLA_AXES
        return table[leaf]
    if block == "ffn" and kind == "M":
        return _MOE_AXES[leaf]
    return _MLP_AXES[leaf]


def param_axes(cfg):
    """JAX's logical axes of every leaf (``api.init``'s second result),
    as a tree of the parameter tree's structure with a tuple of axis
    names (or None) at each leaf."""
    return _unflatten({
        key: (("layers",) if spec[0] else ()) + _leaf_axes(cfg, key)
        for key, spec in param_specs(cfg).items()})
