"""The paper's own predictors, the port of ``repro.models.svm``: SVM
claim/evidence scorers and the pairwise link scorer (MARGOT, §4-5).

As in the JAX package, MARGOT's tree-kernel SVMs become a polynomial
kernel over hashed n-gram features (score = sum_i alpha_i K(sv_i, x)),
with the same scaling in the number of support vectors, and its pair SVM
a bilinear pair scorer.  A model is a dict of tensors on one device:
``{"sv", "alpha", "bias"}`` (polynomial) or ``{"w", "bias"}`` (linear)
for claims and evidence, ``{"W", "w", "bias"}`` (full rank) or
``{"U", "V", "w", "bias"}`` (low rank) for links.  The full-rank link
score runs the hand-written pair-score kernel through
:func:`repro_torch.kernels.ops.pair_score`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def init_svm(generator: torch.Generator, n_sv: int, feat_dim: int,
             device="cuda", dtype=torch.float32):
    """Random polynomial SVM with the JAX package's distributions:
    support vectors N(0,1)/sqrt(d), alphas N(0,1)/sqrt(n_sv), bias 0.
    Draws come from ``generator``, which must live on ``device``."""
    device = resolve_device(device)
    rnd = lambda *s: torch.randn(*s, generator=generator, device=device,  # noqa
                                 dtype=torch.float32)
    return {
        "sv": (rnd(n_sv, feat_dim) / math.sqrt(feat_dim)).to(dtype),
        "alpha": (rnd(n_sv) / math.sqrt(n_sv)).to(dtype),
        "bias": torch.zeros((), dtype=dtype, device=device),
    }


def svm_score(params, x, *, gamma: float = 0.1, coef0: float = 1.0,
              degree: int = 2):
    """x: (N, d) -> (N,) decision scores.  Polynomial kernel, or linear when
    params carry a primal weight vector "w"."""
    if "w" in params:
        return x @ params["w"] + params["bias"]
    k = (gamma * (x @ params["sv"].T) + coef0) ** degree      # (N, n_sv)
    return k @ params["alpha"] + params["bias"]


def init_linear_svm(w, bias: float, device="cuda", dtype=torch.float32):
    device = resolve_device(device)
    return {"w": torch.as_tensor(np.asarray(w), dtype=dtype, device=device),
            "bias": torch.tensor(bias, dtype=dtype, device=device)}


def init_link(generator: torch.Generator, feat_dim: int, rank: int = 0,
              device="cuda", dtype=torch.float32):
    """Bilinear pair scorer with the JAX package's distributions (every
    weight N(0,1)/sqrt(d), bias 0); optional low-rank factorization of W.
    Draws come from ``generator``, which must live on ``device``."""
    device = resolve_device(device)
    rnd = lambda *s: (torch.randn(*s, generator=generator, device=device,  # noqa
                                  dtype=torch.float32)
                      / math.sqrt(feat_dim)).to(dtype)
    if rank:
        link = {"U": rnd(feat_dim, rank), "V": rnd(feat_dim, rank)}
    else:
        link = {"W": rnd(feat_dim, feat_dim)}
    link["w"] = rnd(2 * feat_dim)
    link["bias"] = torch.zeros((), dtype=dtype, device=device)
    return link


def link_score_matrix(params, claims, evidence):
    """claims: (N,d), evidence: (M,d) -> (N,M) scores, the paper's
    Cartesian product (phase 2).  The full-rank form is the pair-score
    kernel on a CUDA tensor (its plain version on the CPU); the low-rank
    form, which no TPU kernel computes, is plain matrix products."""
    if "U" not in params:
        return kops.pair_score(params, claims, evidence)
    bil = (claims @ params["U"]) @ (evidence @ params["V"]).T
    d = claims.shape[-1]
    lin = (claims @ params["w"][:d])[:, None] + \
        (evidence @ params["w"][d:])[None, :]
    return bil + lin + params["bias"]


_FORMS = {"claim": ({"w", "bias"}, {"sv", "alpha", "bias"}),
          "evidence": ({"w", "bias"}, {"sv", "alpha", "bias"}),
          "link": ({"W", "w", "bias"}, {"U", "V", "w", "bias"})}


def models_from_numpy(tree, device="cuda"):
    """The JAX package's ``{"claim", "evidence", "link"}`` model tree, as
    numpy arrays (``jax.device_get``), as the port's tree of tensors on
    ``device``.  Each model may take either of its forms: linear or
    polynomial SVMs, a full-rank or a ``U``/``V`` link.  Raises
    ``ValueError`` on any other tree."""
    device = resolve_device(device)
    if set(tree) != set(_FORMS):
        raise ValueError(f"models_from_numpy: want keys {sorted(_FORMS)}, "
                         f"got {sorted(tree)}")
    out = {}
    for name, forms in _FORMS.items():
        if set(tree[name]) not in forms:
            raise ValueError(f"models_from_numpy: {name} must hold one of "
                             f"{[sorted(f) for f in forms]}, got "
                             f"{sorted(tree[name])}")
        out[name] = {k: torch.from_numpy(np.array(v, copy=True)).to(device)
                     for k, v in tree[name].items()}
    return out


def param_axes(models):
    """JAX's logical axes of a tree of these models (``svm.py:20-60``):
    a polynomial SVM's ``sv`` ("sv", "feat") and ``alpha`` ("sv",), a
    linear SVM's ``w`` ("feat",), the link's ``W`` / ``U`` / ``V``
    ("feat", None) and its ``w`` (None,), every ``bias`` ()."""
    def one(tree):
        if any(k in tree for k in ("W", "U", "V")):       # the link model
            table = {"W": ("feat", None), "U": ("feat", None),
                     "V": ("feat", None), "w": (None,), "bias": ()}
        else:
            table = {"sv": ("sv", "feat"), "alpha": ("sv",), "w": ("feat",),
                     "bias": ()}
        return {k: table[k] for k in tree}
    return {name: one(tree) for name, tree in models.items()}
