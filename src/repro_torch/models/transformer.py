"""Decoder LM of the port (``repro.models.transformer``), kinds ``A``
(attention: dense prefill and decode, paged decode and extend), ``L`` and
``G`` (gemma3's sliding-window local attention, over a ring cache where
the window is shorter than the cache, and its global attention, each at
its own RoPE base), ``D`` (kind ``A``'s attention and an MLP of
``dense_d_ff``: the dense first layer of a MoE model), ``M`` (the same
attention, qk-norm where the config asks for it, or MLA where it sets
``kv_lora_rank``, and the MoE FFN of ``models/moe.py``, with shared
experts where it has them), ``S`` (Mamba-1: prefill and decode over a
recurrent state) and ``R`` (recurrentgemma's RG-LRU block,
``models/rglru.py``, over a recurrent state, then the MLP).  MLA's latent
cache cannot page, so it serves dense (``paged_supported``).

Expert capacity couples the rows of a kind-``M`` batch, so every pass
keeps every row of its batch: an inactive slot of the decode loop feeds
token 0 at its frozen position, as JAX's does (``transformer.py:553-556``),
and its row still enters the experts' capacity.

Layer weights keep the JAX package's stacked layout: ``params["groups"][gi]
[pi]`` is a nested dict whose leaves are ``(repeats, ...)`` tensors, and a
Python loop over the repeats takes the place of ``lax.scan``.  Caches
mirror it: dense ``caches[gi][pi] = {"k", "v"}`` of ``(repeats, B, L, KV,
hd)`` (a ring adds ``"pos"`` of ``(repeats, B, L)``; MLA's latent cache
is ``{"ckv", "krope"}`` of ``(repeats, B, L, r)`` and ``(repeats, B, L,
rh)``), paged ``{"kp",
"vp"}`` of ``(repeats, num_blocks+1, bs, KV, hd)``, SSM state ``{"conv",
"h"}`` of ``(repeats, B, K-1, di)`` and ``(repeats, B, di, N)``, RG-LRU
state ``{"conv", "h"}`` of ``(repeats, B, K-1, w)`` and ``(repeats, B,
w)``, all fp32.

In place, unlike JAX: the prefill, decode and extend passes write K/V and
SSM state into the cache tensors they are given, and :func:`decode_loop`
advances the loop state tensors (``pos``, ``last``, ``active``,
``remaining``) where they lie.  Each returns its inputs, so call sites
read like the JAX ones.

Sequence sharding (``seqtp``, ``transformer.py:164-190``): under
``core.sharding.use_sharding(mesh, "seqtp")``, a ``full`` or ``prefill``
pass over S >= ``attention.FLASH_MIN_SEQ`` tokens that divide over the
mesh's ``model`` axis runs each rank's S / n positions through every
layer, its attention on ``attention.seqshard_attn_forward``, and
all-gathers the last hidden states, so every rank returns what the
one-rank pass returns (a prefill's cache filled from the gathered K/V,
MLA's latent, or the last rank's recurrent state).  Every layer kind
shards: attention at a query offset (``attention.seqshard_attn_forward``,
``seqshard_mla_forward``), Mamba and the RG-LRU with the state carried
from rank to rank (``ssm.py``, ``rglru.py``), MoE with the whole
sequence's capacity and aux loss (``moe.py``); ``SEQSHARD_ROUTES``
counts each route's layer calls.  The callers give every rank its rows
of the batch (the policy's data axes; on a mesh of one data rank, the
whole batch).  Any other pass runs whole on every rank, as JAX's does.
Under grad the collectives are differentiable and every rank computes
the same loss from the gathered states (``collectives.seq_gather_same``),
so a train step sums the ranks' gradients over ``model`` weighted 1 / n
(``launch/steps.py``).

Weight-sharded policies (``tp``, ``fsdp_tp``, JAX's defaults for serving
and training): every layer kind computes on the rank's blocks of its
leaves (``core.sharding``, ``models/layers.py``, ``attention.py``,
``moe.py``, ``ssm.py``, ``rglru.py``), with the collectives autograd
differentiates (``core.collectives.tp_*``); under ``fsdp_tp`` each
layer's leaves are gathered over the data axes at the layer's start,
inside its remat body (so they are freed after it and gathered again in
the backward).  Each rank's activations are its own rows, replicated over
``model``; the logits are the rank's block of the vocab
(:func:`gather_logits` gathers a decode step's), and :func:`lm_loss` is a
vocab-parallel cross entropy.  Attention caches are whole on every rank;
the recurrent states of kinds ``S`` and ``R`` are the rank's channels.

Training (``transformer.py:265-325``, ``:708-718``): :func:`forward` runs
the backbone in mode ``"full"``, which keeps no cache and writes nothing
in place (autograd refuses in-place writes to tensors it saved), with
each repeat's body under the config's ``remat`` (:func:`_remat_wrap`);
:func:`lm_loss` is JAX's next-token cross-entropy plus the summed router
aux loss.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import collectives
from repro_torch.core.sharding import (current_ctx, enter_model,
                                       fsdp_active, fsdp_gather,
                                       fsdp_gather_leaf, stack_axes, tp_mesh)
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models.layers import (apply_mlp, embed, layer_norm,
                                       mask_padded_logits, rms_norm,
                                       token_nll, unembed)
from repro_torch.models.weights import param_axes

_NOT_PORTED = "is not in the port yet: ROADMAP.md, Queue 1, item {}"


def apply_norm(p, x, cfg):
    """RMSNorm, or LayerNorm with its bias (``transformer.py:43-46``)."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm={cfg.norm!r} " +
                                  _NOT_PORTED.format("6 (the other LM "
                                                     "families)"))
    return rms_norm(x, p["w"], cfg.norm_eps, plus_one=cfg.rms_plus_one)


def paged_supported(cfg, max_len: int) -> bool:
    """Can this arch serve from a paged KV block pool?  (``transformer.py:
    86-105``): SSM/RG-LRU state, MLA caches and ring windows cannot."""
    for g in cfg.groups:
        for kind in g.pattern:
            if kind in ("S", "R"):
                return False
            if kind == "M" and cfg.kv_lora_rank:
                return False
            if kind == "L" and cfg.window and cfg.window < max_len:
                return False
    return True


#: attention kind of each attention layer kind (``transformer.py:162-163``)
_ATTN_KIND = {"A": "causal", "M": "causal", "D": "causal", "L": "local",
              "G": "global"}


def _check_kind(kind: str):
    if kind not in ("A", "L", "G", "S", "R", "M", "D"):
        raise NotImplementedError(f"layer kind {kind!r} " +
                                  _NOT_PORTED.format("6 (the other LM "
                                                     "families)"))


def _is_mla(kind: str, cfg) -> bool:
    return kind == "M" and bool(cfg.kv_lora_rank)


def init_layer_cache(cfg, kind: str, batch: int, max_len: int, device):
    """Dense cache of one layer (``transformer.py:75-83``): K/V for the
    attention kinds, a ring for kind ``L`` whose window is shorter than
    ``max_len``, the latent cache for MLA, the recurrent state for kinds
    ``S`` and ``R``."""
    _check_kind(kind)
    if kind == "S":
        return ssm.init_ssm_state(cfg, batch, device)
    if kind == "R":
        return rglru.init_rglru_state(cfg, batch, device)
    if _is_mla(kind, cfg):
        return attn.init_mla_cache(cfg, batch, max_len, device)
    ring = kind == "L" and bool(cfg.window) and cfg.window < max_len
    return attn.init_kv_cache(cfg, batch, max_len, device, ring=ring)


def init_caches(cfg, batch: int, max_len: int, device):
    """Dense caches per (group, pattern position), each leaf stacked to
    ``(repeats, batch, ...)`` (``transformer.py:250-260``)."""
    caches = []
    for g in cfg.groups:
        pos_caches = []
        for kind in g.pattern:
            c = init_layer_cache(cfg, kind, batch, max_len, device)
            pos_caches.append({k: v[None].repeat(g.repeats,
                                                 *([1] * v.dim()))
                               for k, v in c.items()})
        caches.append(pos_caches)
    return caches


def init_paged_caches(cfg, num_blocks: int, block_size: int, device):
    """One shared ``(repeats, num_blocks+1, bs, KV, hd)`` K/V pool per
    (group, pattern position); row 0 of each pool is the null block."""
    if not paged_supported(cfg, max_len=1 << 30):
        raise ValueError(f"{cfg.name}: family holds non-pageable state "
                         f"(SSM/RG-LRU/MLA/ring)")
    caches = []
    for g in cfg.groups:
        pos_caches = []
        for _ in g.pattern:
            c = attn.init_paged_kv_cache(cfg, num_blocks, block_size, device)
            pos_caches.append({k: v[None].repeat(g.repeats, 1, 1, 1, 1)
                               for k, v in c.items()})
        caches.append(pos_caches)
    return caches


def seqshard_mesh(S: int, mode: str):
    """The mesh a pass of ``S`` tokens shards its sequence over, or None:
    JAX's ``use_seqshard`` (``transformer.py:167-169``), for every layer
    kind."""
    ctx = current_ctx()
    if ctx is None or ctx.policy != "seqtp" or mode not in ("full",
                                                            "prefill"):
        return None
    n = ctx.mesh.shape.get("model", 1)
    if n == 1 or S < attn.FLASH_MIN_SEQ or S % n:
        return None
    return ctx.mesh


def apply_layer(p, x, cfg, kind: str, mode: str, cache, pos, bt=None,
                seq=None):
    """One layer (``transformer.py:130-210``).  Kinds ``A``, ``D`` and
    ``M``: ``full`` (a whole sequence, no cache: ``cache`` and ``pos``
    are None), ``prefill`` into a dense cache, ``decode`` over a dense or
    paged cache, ``extend`` over a paged cache; ``bt`` is the (B, nb)
    block table of a paged cache.  Kind ``M`` runs the same causal
    attention, or MLA
    over its latent cache (``:151-160``: prefill and decode, dense only),
    and the MoE FFN (``:204-205``); kind ``D`` the causal attention and an
    MLP of ``dense_d_ff``.  Kind ``S`` (``:136-143``): a Mamba mixer and no
    MLP; ``prefill`` runs the whole prompt from a zero state and
    ``decode`` one step from ``cache``, each returning the new state.
    Kind ``R`` (``:145-150``): the RG-LRU mixer the same way, then, unlike
    kind ``S``, ``ln2`` and the MLP.  Mode ``full`` runs each kind's
    whole-sequence mixer and returns ``cache`` as given.
    Returns ``(x, aux, cache)``: aux is kind ``M``'s router loss (an fp32
    scalar) and the float 0.0 for every other kind, so serving, which
    drops it as JAX's engine does, adds no device work.  ``seq`` is the
    mesh of a sequence-sharded pass (:func:`seqshard_mesh`): x holds this
    rank's positions."""
    _check_kind(kind)
    aux = 0.0
    h = apply_norm(p["ln1"], x, cfg)
    if kind == "S":
        if mode == "decode":
            mix, cache = ssm.ssm_decode(p["mixer"], h, cache, cfg)
        elif mode == "prefill":
            mix, cache = ssm.ssm_forward(p["mixer"], h, cfg, state=None,
                                         seq=seq)
        elif mode == "full":
            mix, _ = ssm.ssm_forward(p["mixer"], h, cfg, state=None,
                                     seq=seq, keep_state=False)
        else:
            raise NotImplementedError(f"mode {mode!r} over an SSM state: "
                                      f"the family serves dense")
        return x + mix, aux, cache
    paged = mode != "full" and attn.is_paged_cache(cache)
    akind = _ATTN_KIND.get(kind)
    if kind == "R":
        if mode == "decode":
            mix, cache = rglru.rglru_decode(p["mixer"], h, cache, cfg)
        elif mode == "prefill":
            mix, cache = rglru.rglru_forward(p["mixer"], h, cfg, state=None,
                                             seq=seq)
        elif mode == "full":
            mix, _ = rglru.rglru_forward(p["mixer"], h, cfg, state=None,
                                         seq=seq, keep_state=False)
        else:
            raise NotImplementedError(f"mode {mode!r} over an RG-LRU "
                                      f"state: the family serves dense")
    elif _is_mla(kind, cfg):
        if mode == "decode":
            mix, cache = attn.mla_decode(p["mixer"], h, cache, pos, cfg)
        elif mode in ("prefill", "full"):
            mix, (ckv, krope) = (
                attn.mla_forward(p["mixer"], h, cfg) if seq is None else
                attn.seqshard_mla_forward(p["mixer"], h, cfg, mesh=seq))
            if mode == "prefill":
                cache = attn.mla_prefill_into_cache(ckv, krope, cache)
        else:
            raise NotImplementedError(f"mode {mode!r} over an MLA latent "
                                      f"cache: the family serves dense")
    elif mode == "decode" and paged:
        mix, cache = attn.paged_attn_decode(p["mixer"], h, cache, pos, bt,
                                            cfg, kind=akind)
    elif mode == "extend" and paged:
        mix, cache = attn.paged_attn_extend(p["mixer"], h, cache, pos, bt,
                                            cfg, kind=akind)
    elif mode == "decode":
        mix, cache = attn.attn_decode(p["mixer"], h, cache, pos, cfg,
                                      kind=akind)
    elif seq is not None:
        mix, kv = attn.seqshard_attn_forward(p["mixer"], h, cfg, kind=akind,
                                             mesh=seq,
                                             keep_kv=mode == "prefill")
        if mode == "prefill":
            cache = attn.prefill_into_cache(None, *kv, cache, cfg,
                                            kind=akind)
    elif mode == "prefill":
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)[None, :]
        q, k, v = attn._project_qkv(p["mixer"], h, h, cfg, positions,
                                    positions, attn._rope_base(cfg, akind),
                                    attn._head_block(cfg))
        cache = attn.prefill_into_cache(None, k, v, cache, cfg, kind=akind)
        mix = attn.attn_forward(p["mixer"], h, cfg, kind=akind,
                                qkv=(q, k, v))
    elif mode == "full":
        mix = attn.attn_forward(p["mixer"], h, cfg, kind=akind)
    else:
        # JAX's dense extend (``attention.py:411-434``) verifies speculative
        # windows on a gathered dense copy of the pool; the port verifies
        # them on the pool itself (:func:`verify_extend`), so no plain
        # attention runs on the card and nothing dense is kept
        raise NotImplementedError(
            f"mode {mode!r} over a {'paged' if paged else 'dense'} cache: "
            f"the port extends only a paged cache, through the paged "
            f"extend kernel; the speculative verify reads the block pool "
            f"(verify_extend)")
    x = x + mix
    h2 = apply_norm(p["ln2"], x, cfg)
    if kind == "M":
        f, aux = moe.apply_moe(p["ffn"], h2, cfg, seq=seq)
        return x + f, aux, cache
    return x + apply_mlp(p["ffn"], h2, cfg), aux, cache


def _unstack(tree, repeats: int):
    """All repeats of a stacked parameter tree as ``repeats`` trees of
    views, one ``torch.unbind`` a leaf: its gradient is one stack of the
    repeats' gradients, where a view per repeat (``leaf[r]``) would
    scatter each repeat's gradient into a zero tensor of the whole stack
    and sum ``repeats`` of them (quadratic in the depth)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, repeats) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(repeats)]
    return list(torch.unbind(tree, 0))


def _save_plain_products(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of
    plain matrix products (``x @ W``), recompute everything else,
    batched products (attention, the experts) included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg):
    """``transformer.py:265-271``: ``none`` runs ``fn`` as it is, ``dots``
    keeps only the plain products' outputs for the backward, any other
    value (``full``) keeps only ``fn``'s inputs; both recompute the rest
    in the backward (``torch.utils.checkpoint``, non-reentrant)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        def context():
            return create_selective_checkpoint_contexts(_save_plain_products)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def run_backbone(params, x, cfg, mode: str, caches=None, pos=None, bt=None,
                 last=None):
    """x: (B,S,d) embedded input -> (x, aux, caches) (``transformer.py:
    274-312``); aux sums the layers' router losses (the float 0.0 without
    a kind-``M`` layer).  Mode ``full`` takes no caches (None) and runs
    each repeat's body under :func:`_remat_wrap`; the other modes update
    the caches in place.  ``bt``: (B, nb) int32 block table of paged
    caches, None for dense.  Attention writes K/V into its repeat's views
    itself; a layer that returns new tensors (the SSM state) has them
    copied into its views.  ``last``: a (B,) int64 position a row, where
    only x at those positions is wanted (B,1,d).  A sequence-sharded pass
    (the module docstring) runs this rank's positions and returns the
    whole sequence's x, or with ``last`` each row's position from the rank
    that holds it (an all-gather of one row a rank)."""
    seq = seqshard_mesh(x.shape[1], mode)
    axes = stack_axes(param_axes(cfg)["groups"]) if fsdp_active() else None
    if seq is not None:
        S_loc = x.shape[1] // seq.shape["model"]
        off = collectives.axis_index("model", seq) * S_loc
        x = x[:, off:off + S_loc]
    aux = 0.0
    for gi, g in enumerate(cfg.groups):
        reps = [_unstack(p, g.repeats) for p in params["groups"][gi]]
        if mode == "full":
            def body(xx, rep_params, _pattern=g.pattern, _gi=gi):
                a_sum = 0.0
                for pi, kind in enumerate(_pattern):
                    lp = fsdp_gather(rep_params[pi],
                                     axes and axes[_gi][pi])
                    xx, a, _ = apply_layer(lp, xx, cfg, kind, "full", None,
                                           None, seq=seq)
                    a_sum = a_sum + a
                return xx, a_sum

            body = _remat_wrap(body, cfg)
            for r in range(g.repeats):
                x, a = body(x, [rep[r] for rep in reps])
                aux = aux + a
            continue
        gc = caches[gi]
        for r in range(g.repeats):
            for pi, kind in enumerate(g.pattern):
                layer_cache = {key: t[r] for key, t in gc[pi].items()}
                lp = fsdp_gather(reps[pi][r], axes and axes[gi][pi])
                x, _, new = apply_layer(lp, x, cfg, kind, mode, layer_cache,
                                        pos, bt, seq=seq)
                for key, view in layer_cache.items():
                    if new[key] is not view:
                        view.copy_(new[key])
    if last is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        if seq is None:
            return x[rows, last][:, None], aux, caches
        x = collectives.all_gather(x[rows, last % S_loc][:, None], "model",
                                   dim=1, mesh=seq)
        return x[rows, last // S_loc][:, None], aux, caches
    if seq is not None:
        x = collectives.seq_gather_same(x, "model", 1, seq)
    return x, aux, caches


def _head(params, x, cfg):
    if cfg.tie_embeddings:
        return unembed(params["embedding"], x, cfg)
    logits = enter_model(x) @ fsdp_gather_leaf(params["lm_head"],
                                               ("embed", "vocab"))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return mask_padded_logits(logits, cfg)


def forward(params, cfg, tokens=None, embeds=None):
    """Full-sequence causal LM forward (``transformer.py:315-325``):
    ``tokens`` (B,S), or ``embeds`` (B,S,d) cast to the activation dtype
    -> ``(logits (B,S,V), aux)``."""
    if embeds is None:
        x = embed(params["embedding"], tokens, cfg)
    else:
        x = embeds.to(cfg.act_dtype)
    x, aux, _ = run_backbone(params, x, cfg, "full")
    x = apply_norm(params["final_norm"], x, cfg)
    return _head(params, x, cfg), aux


def lm_loss(params, cfg, tokens, targets=None, embeds=None):
    """Next-token cross-entropy (mean over tokens) plus the router aux
    loss (``transformer.py:708-718``), as JAX computes it: targets default
    to ``tokens[:, 1:]`` padded with token 0 (so the last position learns
    to predict token 0), the mask is all ones, the log-softmax is fp32.
    Returns ``(loss + aux, (loss, aux))``, fp32 scalars."""
    logits, aux = forward(params, cfg, tokens=tokens, embeds=embeds)
    if targets is None:
        targets = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    nll = token_nll(logits, targets)
    mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux, (loss, aux)


def prefill(params, cfg, tokens, caches, last_index=None, embeds=None):
    """Fill dense caches with a full pass over ``tokens (B,S)``, or over
    ``embeds`` (B,S,d) in the activation dtype where given (the VLM's
    patch prefix); returns ``(logits (B,1,V) at last_index, caches)``
    (``transformer.py:327-351``).  ``last_index`` is None (the final
    position) or (B,) per-row last positions of right-padded prompts."""
    x = (embed(params["embedding"], tokens, cfg) if embeds is None
         else embeds.to(cfg.act_dtype))
    B, S = x.shape[:2]
    last = (torch.full((B,), S - 1, dtype=torch.int64, device=x.device)
            if last_index is None else last_index.long())
    x, _, caches = run_backbone(params, x, cfg, "prefill", caches, None,
                                last=last)
    x = apply_norm(params["final_norm"], x, cfg)
    return _head(params, x, cfg), caches


def decode_step(params, cfg, tokens, caches, pos, bt=None):
    """tokens: (B,1) int32; pos: (B,) int32 absolute write position; bt:
    (B, nb) int32 for paged caches, None for dense.  Returns ``(logits
    (B,1,V), caches)``."""
    x = embed(params["embedding"], tokens, cfg)
    x, _, caches = run_backbone(params, x, cfg, "decode", caches, pos, bt)
    x = apply_norm(params["final_norm"], x, cfg)
    return _head(params, x, cfg), caches


def extend_paged(params, cfg, tokens, caches, pos0, bt, last_index):
    """Paged admit pass: append ``tokens (B,S)`` to sequences whose first
    ``pos0 (B,)`` positions are cached in the pool, writing the suffix K/V
    through ``bt`` and returning ``(logits (B,1,V) at per-row
    last_index, caches)``.  With ``pos0 == 0`` it is a full prefill."""
    x = embed(params["embedding"], tokens, cfg)
    x, _, caches = run_backbone(params, x, cfg, "extend", caches, pos0, bt)
    rows = torch.arange(x.shape[0], device=x.device)
    x = x[rows, last_index.long()][:, None]
    x = apply_norm(params["final_norm"], x, cfg)
    return _head(params, x, cfg), caches


def gather_logits(logits):
    """The whole vocab's logits from every rank's block of them (an
    all-gather over ``model`` under ``tp``), ``logits`` itself otherwise:
    a greedy step takes the argmax of the whole row.  Gather a decode
    step's (B, 1, V), never a training step's (B, S, V)."""
    mesh = tp_mesh()
    if mesh is None:
        return logits
    return collectives.all_gather(logits.contiguous(), "model", dim=-1,
                                  mesh=mesh)


def sample_tokens(logits, temperature: float = 0.0, generator=None):
    """logits: (B, V) -> (B,) int32.  ``temperature`` 0 is greedy argmax,
    which takes the first index on ties as ``jnp.argmax`` does; otherwise
    categorical sampling by the Gumbel-max trick with noise drawn from
    ``generator`` (it matches JAX only in distribution)."""
    if temperature and temperature > 0.0:
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / temperature + gumbel,
                            dim=-1).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_fused(params, cfg, tokens, caches, pos, *, temperature=0.0,
                 generator=None, bt=None):
    """One decode step that returns only the ``(B,)`` sampled token ids."""
    logits, caches = decode_step(params, cfg, tokens, caches, pos, bt)
    return sample_tokens(logits[:, 0], temperature, generator), caches


def decode_loop(params, cfg, caches, pos, last, active, remaining,
                generator=None, *, k: int, max_len: int,
                temperature: float = 0.0, bt=None):
    """K decode steps over dense caches, or over a paged pool read through
    ``bt`` at every step (``transformer.py:511-563``, the per-step pool
    path).

    Loop state lives on the device and is advanced in place: ``pos`` (B,)
    next write position, ``last`` (B,) last sampled token, ``active`` (B,)
    bool liveness, ``remaining`` (B,) decode budget.  Per-slot stop is
    exact by masking: an exhausted slot's pos/last/budget freeze and its
    tokens stop being emitted while the batch keeps stepping, and a slot
    that goes inactive feeds token 0.  Returns ``(out (B,k) int32, emitted
    (B,) int32, caches, pos, last, active, remaining)``; ``out[s,
    :emitted[s]]`` are slot s's tokens."""
    B = pos.shape[0]
    out = torch.zeros((B, k), dtype=torch.int32, device=pos.device)
    emitted = torch.zeros((B,), dtype=torch.int32, device=pos.device)
    for i in range(k):
        nxt, caches = decode_fused(params, cfg, last[:, None], caches, pos,
                                   temperature=temperature,
                                   generator=generator, bt=bt)
        nxt = torch.where(active, nxt, last)
        out[:, i] = nxt
        live = active.to(torch.int32)
        emitted += live
        pos += live
        remaining -= live
        active &= (remaining > 0) & (pos < max_len - 1)
        last.copy_(torch.where(active, nxt, 0))
    return out, emitted, caches, pos, last, active, remaining


# ----------------------------------------------------------------------
# Speculative multi-token decode (paged engines, greedy only)
def ngram_draft(hist, pos, last, d: int):
    """Bigram draft (``transformer.py:568-584``): find the most recent
    earlier occurrence of the (previous token, last token) bigram in the
    token history ``hist (B, L)`` and propose the ``d`` tokens that
    followed it; with no match, repeat the last token.  A read past the
    row (a slot parked at ``pos = L``) is clamped into it where JAX's
    gather fills it; such a slot is inactive and emits nothing."""
    B, L = hist.shape
    dev = hist.device
    prev = torch.gather(hist, 1, (pos.long() - 1).clamp(0, L - 1)[:, None])
    i = torch.arange(1, L, device=dev)
    ok = (hist[:, :-1] == prev) & (hist[:, 1:] == last[:, None]) & \
        (i[None, :] < pos[:, None])
    m = torch.where(ok, i[None, :], -1).amax(dim=1)
    cont = torch.where(m >= 0, m + 1, pos.long())
    idx = torch.minimum(cont[:, None] + torch.arange(d, device=dev)[None, :],
                        pos.long()[:, None])
    return torch.gather(hist, 1, idx.clamp(0, L - 1))


def write_window(rows, start, vals):
    """``rows (B, L)`` with ``vals (B, W)`` written at columns ``start[b]
    + j``, in place; columns past the row are dropped, as JAX's
    ``.at[...].set(mode="drop")`` drops them.  A masked select over the
    whole row, so no write can land on a clamped column."""
    L, W = rows.shape[1], vals.shape[1]
    j = torch.arange(L, device=rows.device)[None, :] - start.long()[:, None]
    hit = (j >= 0) & (j < W)
    picked = torch.gather(vals.to(rows.dtype), 1, j.clamp(0, W - 1))
    return rows.copy_(torch.where(hit, picked, rows))


def verify_extend(params, cfg, tokens, caches, pos0, bt):
    """Speculative verify (``transformer.py:587-602``) over the paged pool:
    one batched extend of the ``(B, d+1)`` window ``[last] ++ draft`` at
    absolute positions ``pos0 + j`` through the block table ``bt``, its
    K/V written into the pool and its attention run by the paged extend
    kernel.  Returns the greedy targets at every window position ``(B,
    d+1)`` and the caches.  Position j's logits see exactly the tokens a
    non-speculative loop would have cached when sampling position ``pos0
    + j + 1``, provided tokens[0..j] are what that loop emitted: the
    accepted prefix the caller keeps.  Window rows past the table's span
    go to the null block, and their queries see the whole table, as
    JAX's dense extend drops such writes and caps its mask at the cache
    length."""
    x = embed(params["embedding"], tokens, cfg)
    x, _, caches = run_backbone(params, x, cfg, "extend", caches, pos0, bt)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = _head(params, x, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32), caches


def spec_decode_loop(params, cfg, caches, hist, pos, last, active, remaining,
                     *, k: int, d: int, max_len: int, bt, draft_fn=None):
    """K speculative verify iterations over a paged cache, one host sync
    (``transformer.py:605-692``).  Each drafts ``d`` tokens
    (``draft_fn(hist, pos, last, d)``, default :func:`ngram_draft`),
    verifies ``[last] ++ draft`` in one batched extend through the pool
    (:func:`verify_extend`) and emits the accepted draft prefix plus the
    first correction: 1 to d+1 tokens a backbone pass.  Token-exact
    against :func:`decode_loop` under greedy decoding, since acceptance
    stops at the first draft/target mismatch.

    Unlike JAX, the pool is the only copy of the K/V: nothing is gathered
    before the loop or scattered back after it.  ``hist (B, max_len)`` is
    the token history (``hist[s, p]`` the token at position p for every
    ``p <= pos[s]``); it and the loop state advance in place.  Returns
    ``(out (B, k*(d+1)), emitted (B,), stats (2,) int32 [extra tokens
    accepted, drafts proposed], caches, hist, pos, last, active,
    remaining)``; ``out[s, :emitted[s]]`` are slot s's tokens."""
    draft_fn = draft_fn or ngram_draft
    B, dev = pos.shape[0], pos.device
    W = k * (d + 1)
    out = torch.zeros((B, W), dtype=torch.int32, device=dev)
    emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    cols = torch.arange(d + 1, device=dev)[None, :]
    for _ in range(k):
        draft = draft_fn(hist, pos, last, d).to(torch.int32)      # (B, d)
        window = torch.cat([last[:, None], draft], dim=1)
        targets, caches = verify_extend(params, cfg, window, caches, pos, bt)
        match = (draft == targets[:, :d]).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(dim=1)
        cap = torch.minimum(remaining, (max_len - 1 - pos).clamp(min=0))
        e = torch.where(active, torch.minimum(a + 1, cap),
                        0).to(torch.int32)
        # the whole window lands at column `emitted`, its start clamped as
        # dynamic_update_slice clamps it; columns past the accepted count
        # are junk that the next window (starting at the new `emitted`)
        # overwrites
        start = emitted.long().clamp(0, W - (d + 1))[:, None]
        out.scatter_(1, start + cols, targets)
        # history rows pos+1 .. pos+d+1 get the targets; rows past the
        # accepted count lie above the new pos, unread by the draft and
        # rewritten before pos reaches them; rows past max_len are dropped
        write_window(hist, pos + 1, targets)
        stats[0] += torch.where(active, e - 1, 0).sum().to(torch.int32)
        stats[1] += active.to(torch.int32).sum() * d
        emitted += e
        pos += e
        remaining -= e
        active &= (remaining > 0) & (pos < max_len - 1)
        last_new = torch.gather(targets, 1,
                                (e.long() - 1).clamp(min=0)[:, None])[:, 0]
        last.copy_(torch.where(active, last_new, 0))
    return out, emitted, stats, caches, hist, pos, last, active, remaining
