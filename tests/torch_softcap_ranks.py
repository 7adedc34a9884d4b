"""Rank bodies of the soft-cap tests on two ranks, run by
``repro_torch.core.collectives.spawn`` (gloo on the CPU).  This module
imports torch and the port only, so a spawned rank loads no JAX; each
body reads its case's config, weights and tokens from an ``.npz`` a test
wrote and returns numpy logits."""
import numpy as np
import torch

#: case -> (arch, layer pattern, policy): the capped two-rank runs, each
#: on a (1, 2) mesh; gemma3-4b's local layer takes the halo route under
#: seqtp and its global layer the gathered one
CASES = {"tp": ("internlm2-1.8b", ("A", "A"), "tp"),
         "seqtp": ("gemma3-4b", ("L", "G"), "seqtp")}
#: the cap (the reduced widths' scores reach ~4) and each case's tokens
CAP = 1.0
SHAPES = {"tp": (2, 12), "seqtp": (2, 1024)}


def config(case):
    from repro_torch.configs import ScanGroup, get_config, reduced
    arch, pattern, _ = CASES[case]
    return reduced(get_config(arch)).replace(
        n_layers=len(pattern), groups=(ScanGroup(pattern, 1),),
        attn_softcap=CAP)


def inputs(path, case):
    """``case``'s capped config, its weights and tokens from ``path``."""
    from repro_torch.models import weights
    with np.load(path) as f:
        d = {k: f[k] for k in f.files}
    cfg = config(case)
    pre = case + "/p/"
    params = weights.params_from_numpy(
        {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}, cfg,
        "cpu")
    return cfg, params, torch.from_numpy(d[case + "/tokens"])


def capped_rank(rank, path):
    """Each case's capped forward logits on a (1, 2) mesh under its
    policy (tp: the rank's head block, gathered; seqtp: the rank's
    positions), and the seqtp routes its layers took."""
    from repro_torch.core.broadcast import place_params
    from repro_torch.core.sharding import use_sharding
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import api, weights
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    mesh = compat_make_mesh((1, 2), ("data", "model"))
    out = {}
    for case, (_, _, policy) in CASES.items():
        cfg, params, toks = inputs(path, case)
        for key in attn.SEQSHARD_ROUTES:
            attn.SEQSHARD_ROUTES[key] = 0
        with torch.no_grad():
            if policy == "tp":
                placed, _ = place_params(params, weights.param_axes(cfg),
                                         mesh, policy)
                with use_sharding(mesh, policy):
                    logits = tfm.gather_logits(api.forward_fn(
                        placed, cfg, {"tokens": toks}))
            else:
                with use_sharding(mesh, policy):
                    logits, _ = tfm.forward(params, cfg, tokens=toks)
        out[case] = {"logits": logits.numpy(),
                     "routes": dict(attn.SEQSHARD_ROUTES)}
    return out
