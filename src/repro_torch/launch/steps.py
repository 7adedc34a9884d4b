"""Step builders of the port (``repro.launch.steps``): the train step the
training driver runs, and the prefill and decode steps of the model API.
They take every family's batch as ``api`` does: ``{"tokens"}``, with
``"frames"`` for the encoder-decoder (whisper-base, whose train step runs
here on ``{"frames", "tokens"}``; the training driver feeds tokens only)
and ``"patches"`` for the VLM.

The sharding specs of every (arch x shape) cell are JAX's
(``steps.py:21-91``, ``:158-170``): :func:`cache_specs`,
:func:`batch_shardings`, :func:`shardings_like` and
:func:`opt_shardings`, as trees of ``core.sharding.NamedSharding`` whose
specs need the mesh's names and sizes alone (``launch.mesh.
abstract_mesh``).

Data parallelism (``make_train_step(..., mesh=)`` under ``broadcast``):
where JAX's GSPMD splits the batch over every device and all-reduces the
gradients, each rank here takes its own rows of the global batch, and
the loss and the gradients are summed over the batch's mesh axes
(``core.collectives``) before the clip, so the clip's global norm and
AdamW see the same numbers on every rank and the parameters stay
bit-identical across ranks.

Tensor parallelism (``tp``, ``fsdp_tp``, JAX's training default): each
rank holds its blocks of the leaves (``core.broadcast.place_params``) and
the layers compute on them (``models/transformer.py``); the gradients
of a ``model`` region's replicated leaves are summed inside autograd
(``collectives.tp_enter``), so each rank's gradient is its block of the
one-device gradient.  Over the data axes, a leaf replicated there has
its gradient all-reduced as under ``broadcast``; a leaf split there
(``fsdp_tp``'s ``embed``) was gathered at its layer's start, and that
gather's backward already summed its gradient over them.  The clip's
global norm sums each leaf's squares over the axes its spec splits.
The prefill and decode steps run under ``core.sharding.use_sharding(mesh,
policy)``, which their callers enter, as JAX's do.

Sequence parallelism (``seqtp``): the weights replicated, each rank
takes its rows over the data axes (JAX's ``"batch"`` rule) and its
positions over ``model`` (``models/transformer.py``); every rank of
``model`` computes the whole loss of its rows from the gathered hidden
states, and its gradients are its share of the replicated leaves' (the
collectives' backwards route the rest), so every leaf's gradient is
all-reduced over the data axes and ``model`` with each rank weighted by
one over their ranks, and the loss over the data axes alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.sharding import TP_POLICIES, NamedSharding, \
    ShardingCtx, _rules, current_ctx, is_axes, use_sharding
from repro_torch.models import api
from repro_torch.models.weights import param_axes
from repro_torch.optim import AdamWState, adamw_update, clip_by_global_norm, \
    cosine_schedule
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map, \
    unflatten_like


# ----------------------------------------------------------------------
# cache logical axes (mirrors models/api.init_caches structures)
def _kv_axes(ring: bool):
    ax = {"k": ("layers", "batch", "seq", "kv_heads", None),
          "v": ("layers", "batch", "seq", "kv_heads", None)}
    if ring:
        ax["pos"] = ("layers", "batch", "seq")
    return ax


def cache_logical_axes(cfg, max_len: int):
    """The logical axes of ``api.init_caches``'s tree (``steps.py:
    32-52``)."""
    if cfg.family == "encdec":
        a = ("layers", "batch", "seq", "kv_heads", None)
        return {"self_k": a, "self_v": a, "cross_k": a, "cross_v": a}
    groups = []
    for g in cfg.groups:
        pos_axes = []
        for kind in g.pattern:
            if kind == "S":
                pos_axes.append({"conv": ("layers", "batch", None, "inner"),
                                 "h": ("layers", "batch", "inner", None)})
            elif kind == "R":
                pos_axes.append({"conv": ("layers", "batch", None, "lru"),
                                 "h": ("layers", "batch", "lru")})
            elif kind == "M" and cfg.kv_lora_rank:
                pos_axes.append({"ckv": ("layers", "batch", "seq", None),
                                 "krope": ("layers", "batch", "seq", None)})
            else:
                ring = kind == "L" and cfg.window and cfg.window < max_len
                pos_axes.append(_kv_axes(bool(ring)))
        groups.append(pos_axes)
    return groups


def cache_specs(cfg, mesh, max_len: int, batch: int, policy: str,
                shard_seq: bool = False):
    """Shardings of the cache tree (``steps.py:55-82``): the batch over
    the data axes, or, where ``batch`` is smaller than them, the sequence;
    ``shard_seq`` adds ``model`` to the sequence; kv heads never split."""
    rules = dict(_rules(policy, mesh.axis_names))
    data_axes = rules.get("batch") or ()
    n_data = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1
    seq_axes = []
    if batch < n_data:
        rules["batch"] = None
        seq_axes += list(data_axes)
    if shard_seq and "model" in mesh.axis_names:
        seq_axes.append("model")
    rules["seq"] = tuple(seq_axes) or None
    rules["kv_heads"] = None
    ctx = ShardingCtx(mesh, policy, rules)
    return tree_map(ctx.sharding_for, cache_logical_axes(cfg, max_len),
                    is_leaf=is_axes)


def batch_shardings(cfg, mesh, policy: str, specs):
    """The batch's leading dimension over the policy's batch axes
    (``steps.py:85-93``); ``specs`` maps names to anything with a
    ``shape``."""
    data_axes = _rules(policy, mesh.axis_names).get("batch") or None
    return {k: NamedSharding(mesh, (data_axes,) + (None,) * (
        len(v.shape) - 1)) for k, v in specs.items()}


def shardings_like(axes_tree, ctx: ShardingCtx):
    return tree_map(ctx.sharding_for, axes_tree, is_leaf=is_axes)


def opt_shardings(param_shardings):
    """Adam's moments take the parameters' shardings, the step count is
    replicated (``steps.py:166-170``)."""
    mesh = tree_leaves(param_shardings)[0].mesh
    return AdamWState(NamedSharding(mesh, ()), param_shardings,
                      param_shardings)


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


def check_policy(policy: str):
    """Raise for a policy JAX does not have; every one of JAX's trains."""
    _rules(policy, ("data", "model"))


def local_rows(batch, mesh, policy: str = "broadcast", axes=None):
    """This rank's rows of the global ``batch`` (a dict of tensors with the
    batch first), split over ``axes`` (by default the policy's batch axes
    as ``_rules`` says): block ``axis_index`` of ``axis_size`` equal
    blocks."""
    if axes is None:
        axes = _rules(policy, mesh.axis_names).get("batch") or ()
    if not axes:
        return batch
    return tree_map(lambda a: collectives.local_block(a, axes, mesh), batch)


_BUCKET = 1 << 26          # elements of one gradient all-reduce (fp32)


def _reduce_grads(grads, weight: float, axes, mesh):
    """``psum(g * weight)`` of every leaf over ``axes``, in fp32 buckets of
    at most ``_BUCKET`` elements, each leaf back in its dtype."""
    flat = flatten_with_paths(grads)
    keys = list(flat)
    out = {}
    i = 0
    while i < len(keys):
        take, n = [], 0
        while i < len(keys) and (not take or n + flat[keys[i]].numel()
                                 <= _BUCKET):
            take.append(keys[i])
            n += flat[keys[i]].numel()
            i += 1
        buf = torch.cat([flat[k].reshape(-1).float() for k in take]) * weight
        buf = collectives.psum(buf, axes, mesh)
        off = 0
        for k in take:
            g = flat[k]
            out[k] = buf[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
    return unflatten_like(grads, out)


def _row_axes(ctx):
    """The mesh axes of more than one rank that the context's batch rule
    splits the rows over."""
    rows = ctx.rules.get("batch") or ()
    rows = (rows,) if isinstance(rows, str) else tuple(rows)
    return rows if rows and ctx.mesh.axis_size(rows) > 1 else ()


def _grad_axes(ctx):
    """The axes a replicated leaf's gradient is all-reduced over: the
    batch's, and under ``seqtp`` ``model`` too (the module docstring)."""
    rows = _row_axes(ctx)
    if ctx.policy == "seqtp" and ctx.mesh.axis_size("model") > 1:
        rows = rows + ("model",)
    return rows


def _mesh_grads(grads, cfg, ctx):
    """Each leaf's gradient over the data axes: a leaf the context's
    specs split there (gathered at its layer's start, its gradient summed
    by that gather's backward) is scaled by one over their ranks; the
    others are all-reduced over the batch's axes (and under ``seqtp``
    ``model``), each rank's weighted by one over their ranks.  Returns
    ``(grads, shardings)``, the latter the leaves' specs under a
    weight-sharded policy (else None)."""
    mesh = ctx.mesh
    if ctx.policy not in TP_POLICIES:
        axes = _grad_axes(ctx)
        return (_reduce_grads(grads, 1.0 / mesh.axis_size(axes), axes, mesh)
                if axes else grads), None
    rows = _row_axes(ctx)
    w = 1.0 / mesh.axis_size(rows) if rows else 1.0
    sh = shardings_like(param_axes(cfg), ctx)
    flat = flatten_with_paths(grads)
    flat_sh = flatten_with_paths(sh)
    split, whole = {}, {}
    for k, g in flat.items():
        s = flat_sh[k]
        data = tuple(a for d in range(len(s.spec)) for a in s.dim_axes(d)
                     if a != "model")
        if data:
            split[k] = g * (1.0 / mesh.axis_size(data))
        else:
            whole[k] = g
    if rows and whole:
        whole = _reduce_grads(whole, w, rows, mesh)
    return unflatten_like(grads, {**split, **whole}), sh


def make_train_step(cfg, *, lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, clip: float = 1.0,
                    accum_steps: int = 1, mesh=None,
                    policy: str = "broadcast"):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``
    (``steps.py:96-144``).  ``accum_steps > 1`` splits the batch into
    micro-batches taken in order, their gradients summed in fp32 and
    averaged, as JAX's ``lax.scan`` does.  The gradients are clipped to
    global norm ``clip``; the learning rate is the cosine schedule at the
    optimizer's step count before this step.  Metrics are fp32 scalars:
    ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``.

    With a ``mesh`` every rank is given the global batch and takes its
    own rows (:func:`local_rows`) under the policy's batch rule, and the
    step runs under ``use_sharding(mesh, policy)`` (or the context the
    caller entered, whose rules it reads): under ``broadcast`` data
    parallelism, under ``tp`` / ``fsdp_tp`` the tensor-parallel layers on
    the rank's blocks of the leaves (the module docstring).  The loss is
    the token-weighted mean over the batch's ranks: the ranks' blocks are
    equal (:func:`local_rows` refuses others), so each rank's mean,
    weighted by its share ``1 / axis_size`` of the tokens, is
    all-reduced, and so are its gradients, in fp32 before the clip.  A
    MoE layer's capacity, slots and aux loss are the global batch's
    (``models/moe.py``).  Under ``seqtp`` each rank takes its rows and its
    positions, and the gradients are summed over ``model`` too (the
    module docstring)."""
    if mesh is not None:
        check_policy(policy)

    def local(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, cfg, batch)
        micro = tree_map(lambda a: a.reshape(
            (accum_steps, a.shape[0] // accum_steps) + a.shape[1:]), batch)
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
        return (loss * inv, (ce * inv, aux * inv)), grads

    def sharded(params, opt_state, batch):
        ctx = current_ctx()
        rows = _row_axes(ctx)
        batch = local_rows(batch, mesh, policy, rows)
        (loss, (ce, aux)), grads = local(params, batch)
        grads, sh = _mesh_grads(grads, cfg, ctx)
        if rows:
            loss, ce, aux = collectives.psum(
                torch.stack([loss, ce, aux]).float() *
                (1.0 / mesh.axis_size(rows)), rows, mesh).unbind()
        return update(params, opt_state, grads, sh, (loss, ce, aux))

    def update(params, opt_state, grads, sh, metrics):
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip, sh)
            lr_t = cosine_schedule(opt_state.step, peak_lr=lr, warmup=warmup,
                                   total=total)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             lr=lr_t)
        loss, ce, aux = metrics
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux,
                                   "grad_norm": gnorm, "lr": lr_t}

    def step(params, opt_state, batch):
        if mesh is None:
            (loss, (ce, aux)), grads = local(params, batch)
            return update(params, opt_state, grads, None, (loss, ce, aux))
        ctx = current_ctx()
        if ctx is not None and ctx.mesh is mesh:
            return sharded(params, opt_state, batch)
        with use_sharding(mesh, policy):
            return sharded(params, opt_state, batch)

    return step


def make_prefill_step(cfg, max_len: int):
    def step(params, batch, caches):
        return api.prefill_fn(params, cfg, batch, caches)
    return step


def make_decode_step(cfg):
    def step(params, batch, caches):
        return api.decode_fn(params, cfg, batch, caches)
    return step
