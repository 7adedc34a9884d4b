"""Rank bodies of the port's multi-device tests, run by
``repro_torch.core.collectives.spawn`` in processes of their own (gloo on
the CPU).  This module imports torch and the port only, so a spawned
rank loads no JAX; each body reads its inputs from an ``.npz`` a test
wrote and returns host values."""
import numpy as np
import torch

from repro_torch.core.collectives import local_block


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _margot(d):
    from repro_torch.models import svm
    models = {name: {k[len(name) + 1:]: _t(v) for k, v in d.items()
                     if k.startswith(name + "/")}
              for name in ("claim", "evidence", "link")}
    return models, svm.param_axes(models)


def _pcfg(d):
    from repro_torch.core.pipeline import PipelineConfig
    return PipelineConfig(feat_dim=int(d["feat_dim"]),
                          claim_capacity=int(d["claim_capacity"]),
                          evid_capacity=int(d["evid_capacity"]))


def _links(out, mesh):
    from repro_torch.core import pipeline
    return sorted(pipeline.gather_links(out, mesh))


def pipeline_rank(rank, path):
    """The sharded MARGOT step on a (4,) ``data`` mesh: this rank's
    output blocks and the gathered links."""
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import compat_make_mesh
    d = _load(path)
    models, _ = _margot(d)
    mesh = compat_make_mesh((4,), ("data",))
    step = pipeline.make_batch_step(_pcfg(d), mesh)
    out = step(models, local_block(_t(d["X"]), "data", mesh),
               local_block(_t(d["keys"]), "data", mesh))
    return {"out": {k: v.numpy() for k, v in out._asdict().items()},
            "links": _links(out, mesh)}


def sharded_vs_local_rank(rank):
    """A seeded corpus through the sharded step on a (2,) ``data`` mesh
    and through the one-device step: (sharded links, one-device links,
    the sharded step's n_dropped)."""
    from repro_torch.core import pipeline
    from repro_torch.data.text import (corpus_arrays, margot_models,
                                       synthetic_corpus)
    from repro_torch.launch.mesh import compat_make_mesh
    pcfg = pipeline.PipelineConfig(feat_dim=256, claim_capacity=48,
                                   evid_capacity=96)
    models = margot_models(pcfg, device="cpu")
    X, keys, _ = corpus_arrays(synthetic_corpus(4, 32, seed=5), dim=256)
    X, keys = _t(X), _t(keys)
    mesh = compat_make_mesh((2,), ("data",))
    out = pipeline.make_batch_step(pcfg, mesh)(
        models, local_block(X, "data", mesh),
        local_block(keys, "data", mesh))
    one = pipeline.make_batch_step(pcfg.__class__(
        feat_dim=256, claim_capacity=96, evid_capacity=192))(models, X, keys)
    key = lambda links: sorted((c, e) for c, e, _ in links)  # noqa: E731
    return (key(pipeline.gather_links(out, mesh)),
            key(pipeline.extract_links(one)), int(out.n_dropped))


class FakeRouter:
    """The few calls an ``Autoscaler`` makes, over a replica count."""

    def __init__(self, n):
        self.n, self.depth = n, 0.0

    def n_alive(self):
        return self.n

    def queue_depth(self):
        return self.depth

    def add_replica(self, *a, **k):
        self.n += 1

    def alive_replicas(self):
        import types
        return [types.SimpleNamespace(rid=i, outstanding_cost=lambda: 0.0)
                for i in range(self.n)]

    def remove_replica(self, rid, drain=True):
        self.n -= 1


def elastic_rank(rank, path):
    """``ElasticRunner`` 4 -> 2 on the MARGOT models (the step's links on
    each mesh), then the autoscaler's resize protocol: rank 0 scales the
    pool 2 -> 3 -> 2 and every rank rescales with it."""
    from repro_torch.cluster.autoscaler import (Autoscaler, AutoscalerConfig,
                                                follow_rescales)
    from repro_torch.core import pipeline
    from repro_torch.core.fault import ElasticRunner
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.tree import flatten_with_paths
    d = _load(path)
    models, axes = _margot(d)
    pcfg = _pcfg(d)
    X, keys = _t(d["X"]), _t(d["keys"])
    make = lambda n: compat_make_mesh((n,), ("data",))  # noqa: E731
    mesh4 = make(4)
    # rank 0 holds the models; the others only their shapes
    held = models if rank == 0 else {
        k: {n: torch.empty_like(t, device="meta") for n, t in v.items()}
        for k, v in models.items()}
    runner = ElasticRunner(held, axes, mesh4, policy="broadcast")
    res = {"placed_equal": all(
        torch.equal(runner.params[k][n], models[k][n])
        for k in models for n in models[k])}

    def links(mesh):
        out = pipeline.make_batch_step(pcfg, mesh)(
            runner.params, local_block(X, "data", mesh),
            local_block(keys, "data", mesh))
        return _links(out, mesh), int(out.n_dropped)

    res["links4"], res["dropped4"] = links(mesh4)
    mesh2 = make(2)
    runner.rescale(mesh2)
    res["gen"] = runner.generation
    res["member2"] = mesh2.is_member
    res["dropped_weights"] = runner.params is None
    res["shipped"] = runner.shipped_bytes
    if mesh2.is_member:
        res["links2"], res["dropped2"] = links(mesh2)
    # the autoscaler's protocol
    if rank == 0:
        router = FakeRouter(2)
        sc = Autoscaler(router, lambda: object(), AutoscalerConfig(
            min_replicas=1, max_replicas=4, scale_up_depth=1.0,
            scale_down_depth=1.0, cooldown_s=0.0, idle_ticks_to_drain=1),
            elastic=runner, make_mesh=make)
        router.depth = 100.0
        up = sc.tick(1.0)
        router.depth = 0.0
        down = sc.tick(2.0)
        sc.release_followers()
        res["events"] = [(e.action, e.n_replicas) for e in (up, down)]
        try:
            sc.start()
            res["start_refused"] = False
            sc.stop()
        except RuntimeError as e:
            res["start_refused"] = "collective thread" in str(e)
    else:
        res["followed"] = follow_rescales(runner, make)
    res["gen_after"] = runner.generation
    res["holds"] = runner.params is not None
    if runner.params is not None:
        res["sum"] = float(sum(t.double().sum() for t in
                               flatten_with_paths(runner.params).values()))
    return res


def compressed_rank(rank, path):
    """``compressed_psum`` of this rank's row of G over a (4,) mesh."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.optim.compression import compressed_psum, quantize
    G = _t(_load(path)["G"])
    mesh = compat_make_mesh((4,), ("data",))
    c, _ = quantize(G[rank])
    val, raw = compressed_psum(c, "data", mesh)
    return val.numpy(), raw.numpy()


def restore_rank(rank, ckpt_dir, arch):
    """A JAX checkpoint of the reduced ``arch`` restored on a (2, 2) mesh
    under ``tp``: this rank's slice of every leaf, and the whole leaves
    rebuilt from every rank's slices."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.broadcast import placement_shardings, unshard
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import weights
    from repro_torch.tree import flatten_with_paths
    cfg = reduced(get_config(arch))
    like = weights.empty_params(cfg, "cpu")
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    sh = placement_shardings(weights.param_axes(cfg), mesh, "tp")
    ck = Checkpointer(ckpt_dir)
    part = ck.restore(like, shardings=sh)
    whole = unshard(part, sh)
    full = ck.restore(like)
    return ({k: v.float().numpy() for k, v in
             flatten_with_paths(part).items()},
            all(torch.equal(a, b) for a, b in zip(
                flatten_with_paths(whole).values(),
                flatten_with_paths(full).values())),
            {k: tuple(v.shape) for k, v in flatten_with_paths(full).items()})


def seqtp_rank(rank, path):
    """Each case's reduced config under ``seqtp`` on a (1, 2) mesh: the
    forward's logits, the prefill's last logits and caches, the routes
    its layers took."""
    from repro_torch.core.sharding import use_sharding
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import flatten_with_paths
    mesh = compat_make_mesh((1, 2), ("data", "model"))
    out = {}
    for case in SEQTP_CASES:
        cfg, params, toks = seqtp_inputs(path, case)
        for key in attn.SEQSHARD_ROUTES:
            attn.SEQSHARD_ROUTES[key] = 0
        with use_sharding(mesh, "seqtp"):
            logits, _ = tfm.forward(params, cfg, tokens=toks)
            caches = tfm.init_caches(cfg, toks.shape[0], toks.shape[1],
                                     "cpu")
            last, caches = tfm.prefill(params, cfg, toks, caches)
        out[case] = {"logits": logits.numpy(), "last": last.numpy(),
                     "caches": {k: v.numpy() for k, v in
                                flatten_with_paths(caches).items()},
                     "routes": dict(attn.SEQSHARD_ROUTES)}
    return out


def seqtp_inputs(path, case):
    """``case``'s config, the JAX weights and the tokens from ``path``."""
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.models import weights
    d = _load(path)
    arch, pattern, window = SEQTP_CASES[case]
    cfg = reduced(get_config(arch)).replace(
        n_layers=len(pattern), groups=(ScanGroup(pattern, 1),),
        **({"window": window} if window else {}))
    pre = case + "/p/"
    params = weights.params_from_numpy(
        {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}, cfg,
        "cpu")
    return cfg, params, _t(d[case + "/tokens"])


#: name -> (arch, layer pattern, window): the two-layer reduced configs
#: of the seqtp tests; "wide" has a local window of 700 over 512-position
#: shards (W > S_loc: the gathered route, where JAX drops the window)
SEQTP_CASES = {"internlm2": ("internlm2-1.8b", ("A", "A"), 0),
               "gemma3": ("gemma3-4b", ("L", "G"), 0),
               "wide": ("gemma3-4b", ("L", "G"), 700)}


#: name -> (arch, two-layer overrides) of the data-parallel train tests
DP_CASES = {"internlm2": "internlm2-1.8b", "whisper": "whisper-base"}
DP_HYPER = dict(lr=1e-2, warmup=1, total=10)


def dp_config(case):
    from repro_torch.configs import ScanGroup, get_config, reduced
    cfg = reduced(get_config(DP_CASES[case]))
    if case == "internlm2":
        return cfg.replace(n_layers=2, groups=(ScanGroup(("A",), 2),))
    return cfg.replace(enc_layers=2, dec_layers=2, n_layers=4)


def dp_rank(rank, path, case):
    """Three data-parallel AdamW steps of ``case`` on a (1, 2) mesh under
    ``broadcast``: each step's metrics and a hash of the parameters, and
    the last step's parameters and moments."""
    import hashlib

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import weights
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths
    d = _load(path)
    cfg = dp_config(case)
    params = weights.params_from_numpy(
        {k[2:]: v for k, v in d.items() if k.startswith("p/")}, cfg, "cpu")
    opt = adamw_init(params)
    mesh = compat_make_mesh((1, 2), ("data", "model"))
    fn = steps.make_train_step(cfg, mesh=mesh, **DP_HYPER)
    out = []
    for i in range(3):
        batch = {k: _t(d[f"b{i}/{k}"]) for k in ("tokens", "frames")
                 if f"b{i}/{k}" in d}
        params, opt, m = fn(params, opt, batch)
        h = hashlib.sha256()
        for v in flatten_with_paths(params).values():
            h.update(v.numpy().tobytes())
        out.append(({k: float(v) for k, v in m.items()}, h.hexdigest()))
    flat = lambda t: {k: v.numpy() for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    return out, flat(params), flat(opt.m), flat(opt.v)


#: name -> (arch, overrides) of the tensor-parallel tests' two-layer
#: reduced configs: each layer kind and MLP kind once; "cut" has 2 heads
#: of 16, so a (1, 4) mesh's column block holds half a head
TP_CASES = {
    "internlm2": ("internlm2-1.8b", {"groups": (("A",), 2)}),
    "cut": ("internlm2-1.8b", {"groups": (("A",), 2), "n_heads": 2,
                               "n_kv_heads": 1}),
    "starcoder2": ("starcoder2-3b", {"groups": (("A",), 2)}),
    "gemma3": ("gemma3-4b", {"groups": (("L", "G"), 1)}),
    "qwen3moe": ("qwen3-moe-30b-a3b", {"groups": (("M",), 2)}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "mamba": ("falcon-mamba-7b", {"groups": (("S",), 2)}),
    "rgemma": ("recurrentgemma-2b", {"groups": (("R", "L"), 1)}),
    "whisper": ("whisper-base", {"enc_layers": 2, "dec_layers": 2,
                                 "n_layers": 4}),
    "internvl2": ("internvl2-1b", {"groups": (("A",), 2)}),
}
#: prompt rows and length, cache length and greedy decode steps of a case
TP_B, TP_S, TP_MAX, TP_DECODE = 4, 20, 28, 6
TP_HYPER = dict(lr=1e-2, warmup=1, total=10)


def tp_config(case):
    from repro_torch.configs import ScanGroup, get_config, reduced
    arch, over = TP_CASES[case]
    over = dict(over)
    if "groups" in over:
        pattern, reps = over["groups"]
        over["groups"] = (ScanGroup(pattern, reps),)
        over["n_layers"] = len(pattern) * reps
    return reduced(get_config(arch)).replace(**over)


def tp_inputs(d, case):
    """``case``'s config, its whole weights and its three batches."""
    from repro_torch.models import weights
    cfg = tp_config(case)
    pre = case + "/p/"
    params = weights.params_from_numpy(
        {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}, cfg,
        "cpu")
    batches = [{k.split("/")[-1]: _t(v) for k, v in d.items()
                if k.startswith(f"{case}/b{i}/")} for i in range(3)]
    return cfg, params, batches


def tp_run(cfg, params, batches, mesh=None, policy=None):
    """Every entry point of ``cfg`` on ``batches`` under ``policy`` on
    ``mesh`` (one device where None): the forward's logits, the loss and
    every gradient of the first batch, a prefill and TP_DECODE greedy
    decode steps (their tokens and the caches after), and three AdamW
    steps (their metrics, the parameters and moments after).  Every
    tensor comes back whole: the ranks' blocks gathered."""
    import contextlib

    from repro_torch.core import collectives
    from repro_torch.core.broadcast import place_params, unshard
    from repro_torch.core.sharding import current_ctx, use_sharding
    from repro_torch.launch import steps
    from repro_torch.models import api, weights
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths, tree_map

    flat = lambda t: {k: v.detach().float().numpy() for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    batch = batches[0]
    rows_of = lambda b: b  # noqa: E731
    whole_rows = lambda t: t  # noqa: E731
    sh, placed = None, params
    scope = contextlib.nullcontext()
    if mesh is not None:
        placed, sh = place_params(params, weights.param_axes(cfg), mesh,
                                  policy)
        scope = use_sharding(mesh, policy)
    out = {}
    with scope:
        if mesh is not None:
            rows = steps._row_axes(current_ctx())
            rows_of = lambda b: steps.local_rows(  # noqa: E731
                b, mesh, policy, rows)
            whole_rows = lambda t: collectives.all_gather(  # noqa: E731
                t.contiguous(), rows, mesh=mesh) if rows else t
        mine = rows_of(batch)
        with torch.no_grad():
            out["logits"] = whole_rows(tfm.gather_logits(
                api.forward_fn(placed, cfg, mine))).numpy()
        (loss, _), grads = steps.value_and_grad(placed, cfg, mine)
        if mesh is not None:
            grads, _ = steps._mesh_grads(grads, cfg, current_ctx())
            grads = unshard(grads, sh)
            if rows:
                loss = collectives.psum(loss / mesh.axis_size(rows), rows,
                                        mesh)
        out["loss"], out["grads"] = float(loss), flat(grads)
        out.update(_tp_serve(cfg, placed, mine, mesh, policy, rows_of,
                             whole_rows))
        opt = adamw_init(placed)
        fn = steps.make_train_step(cfg, mesh=mesh, policy=policy or
                                   "broadcast", **TP_HYPER)
        out["metrics"] = []
        for b in batches:
            placed, opt, m = fn(placed, opt, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            placed, m1, v1 = (unshard(t, sh) for t in (placed, opt.m, opt.v))
        else:
            m1, v1 = opt.m, opt.v
        out["final"] = (flat(placed), flat(m1), flat(v1))
    return out


def _tp_serve(cfg, params, batch, mesh, policy, rows_of, whole_rows):
    """A prefill and TP_DECODE greedy steps of ``batch`` (this rank's
    rows): the tokens of every row, and the caches after, whole."""
    from repro_torch.core.broadcast import unshard
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import flatten_with_paths, tree_map
    B = TP_B
    enc = batch["frames"].shape[1] if "frames" in batch else 0
    caches = api.init_caches(cfg, B, TP_MAX, enc_len=enc, device="cpu")
    sh = None
    if mesh is not None:
        sh = steps.cache_specs(cfg, mesh, TP_MAX, B, policy)
        caches = tree_map(lambda t, s: s.local_slice(t).contiguous(),
                          caches, sh)
    with torch.no_grad():
        logits, caches = api.prefill_fn(params, cfg, batch, caches)
        tok = torch.argmax(whole_rows(tfm.gather_logits(logits))[:, -1],
                           -1).to(torch.int32)
        pos = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                          if "patches" in batch else 0)
        toks = [tok]
        for i in range(TP_DECODE):
            step = rows_of({"tokens": tok[:, None], "pos": torch.full(
                (B,), pos + i, dtype=torch.int32)})
            logits, caches = api.decode_fn(params, cfg, step, caches)
            tok = torch.argmax(whole_rows(tfm.gather_logits(logits))[:, 0],
                               -1).to(torch.int32)
            toks.append(tok)
        if sh is not None:
            caches = unshard(caches, sh)
    return {"tokens": torch.stack(toks, 1).numpy(),
            "caches": {k: v.float().numpy() for k, v in
                       flatten_with_paths(caches).items()}}


def tp_rank(rank, path, shapes, cases, policies):
    """Each of ``cases`` under each of ``policies`` on each mesh of
    ``shapes`` over ("data", "model"), in turn, over the first ranks of
    the world: :func:`tp_run`'s results by shape, from rank 0 (every rank
    of a mesh computes them: the gathers are collective)."""
    from repro_torch.launch.mesh import compat_make_mesh
    d = _load(path)
    out = {}
    for shape in shapes:
        mesh = compat_make_mesh(shape, ("data", "model"))
        if not mesh.is_member:
            continue
        for case in cases:
            cfg, params, batches = tp_inputs(d, case)
            for policy in policies:
                out[shape, case, policy] = tp_run(cfg, params, batches, mesh,
                                                  policy)
    return out if rank == 0 else None


def tp_count_rank(rank, arch, kinds):
    """The reduced ``arch``'s ``tp`` cells of ``kinds`` (ShapeCase B 2 x S
    16) built by the dry run on a real (1, 2) mesh, their leaves and
    inputs filled with seeded values, each step run once on real tensors
    under ``dryrun_lib.counting``: its FLOPs, kernel calls and
    collectives, from rank 0."""
    from repro_torch.configs import base, get_config, reduced
    from repro_torch.core.sharding import use_sharding
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.tree import tree_leaves
    mesh = compat_make_mesh((1, 2), ("data", "model"))
    cfg = reduced(get_config(arch))
    g = torch.Generator().manual_seed(0)
    out = {}
    for kind in kinds:
        sc = base.ShapeCase(kind, 16, 2, kind)
        fn, args, _, _, _, rules = dryrun_lib.build_cell(cfg, sc, mesh, "tp")
        for t in tree_leaves(args):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
            else:
                t.zero_()
        with use_sharding(mesh, "tp", rules=rules), torch.no_grad(), \
                dryrun_lib.counting() as (fc, c):
            fn(*args)
        out[kind] = {"flops": dryrun_lib.step_flops(fc, c),
                     "launches": c.launches(), "colls": c.colls}
    return out if rank == 0 else None


#: name -> (arch, layer pattern and repeats or None for reduced()'s own
#: groups, window): the coupled kinds' seqtp cases (every layer kind of
#: the registry: S, R with its local layer on the halo, D and MLA with
#: MoE, MoE alone) and the attention kinds' training cases
COUPLED_CASES = {"mamba": ("falcon-mamba-7b", None, 0),
                 "rgemma": ("recurrentgemma-2b", (("R", "L"), 1), 0),
                 "deepseek": ("deepseek-v2-lite-16b", None, 0),
                 "qwen3moe": ("qwen3-moe-30b-a3b", None, 0),
                 "internlm2": ("internlm2-1.8b", (("A", "A"), 1), 0),
                 "gemma3": ("gemma3-4b", (("L", "G"), 1), 0)}


def coupled_config(case):
    from repro_torch.configs import ScanGroup, get_config, reduced
    arch, groups, window = COUPLED_CASES[case]
    cfg = reduced(get_config(arch))
    if groups is not None:
        pattern, reps = groups
        cfg = cfg.replace(n_layers=len(pattern) * reps,
                          groups=(ScanGroup(pattern, reps),))
    return cfg.replace(**({"window": window} if window else {}))


def coupled_inputs(d, case, name=None):
    """``case``'s config, the JAX weights and the tokens of run ``name``
    (by default ``case``) from ``d``."""
    from repro_torch.models import weights
    cfg = coupled_config(case)
    pre = case + "/p/"
    params = weights.params_from_numpy(
        {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}, cfg,
        "cpu")
    return cfg, params, _t(d[(name or case) + "/tokens"])


def carry_inputs(seed=0, B=2, S=64, di=6, N=3):
    """Seeded selective-scan inputs whose state outlives a 16-step shard
    (dt ~ 0.01, so exp(A dt) stays near 1): the carry's fold, not the
    decay, sets each shard's entering state."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
    return (r(B, S, di), 0.01 * torch.rand(B, S, di, generator=g), r(B, S, N),
            r(B, S, N), -torch.rand(di, N, generator=g) - 0.1, r(di),
            r(B, S, di))


def carry_check(mesh):
    """``collectives.shard_scan`` of the selective scan on this rank's
    shard of :func:`carry_inputs` under grad: its y and h_final, and the
    gradients of sum(y * w) + sum(h_final) of every input, summed over
    ``model`` as a train step sums a replicated leaf's."""
    from repro_torch.core import collectives
    from repro_torch.models import ssm
    xc, dt, Bc, Cc, A, D, w = carry_inputs()
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    part = lambda t: local_block(t, "model", mesh, 1)  # noqa: E731
    leaves = [part(t).clone().requires_grad_(True)
              for t in (xc, dt, Bc, Cc)] + \
        [t.clone().requires_grad_(True) for t in (A, D)]
    xc_, dt_, B_, C_, A_, D_ = leaves
    y, h = collectives.shard_scan(
        lambda x_, h0: ssm.selective_scan(x_, dt_, B_, C_, A_, D_, h0=h0),
        xc_, torch.exp(A_[None] * dt_.sum(1)[..., None]), "model", mesh)
    last = collectives.all_gather(h, "model", tiled=False, mesh=mesh)[-1]
    loss = (y * part(w)).sum() + (h.sum() if i == n - 1 else 0.0)
    grads = torch.autograd.grad(loss, leaves)
    whole = [collectives.all_gather(g, "model", dim=1, mesh=mesh)
             for g in grads[:4]] + [collectives.psum(g, "model", mesh)
                                    for g in grads[4:]]
    return {"y": collectives.all_gather(y, "model", dim=1,
                                        mesh=mesh).numpy(),
            "h": last.numpy(), "grads": [g.numpy() for g in whole]}


def seqtp_run(cfg, params, toks, mesh=None, grads=True, serve=True):
    """``cfg`` on ``toks`` under ``seqtp`` on ``mesh`` (one device where
    None): the forward's logits, the prefill's last logits and caches,
    the loss and every gradient of ``lm_loss`` (summed over the mesh as
    the train step sums them), and the routes the layers took; each rank
    its rows over the data axes, whole over ``model``."""
    import contextlib

    from repro_torch.core import collectives
    from repro_torch.core.sharding import current_ctx, use_sharding
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import flatten_with_paths
    flat = lambda t: {k: v.detach().float().numpy() for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    for key in attn.SEQSHARD_ROUTES:
        attn.SEQSHARD_ROUTES[key] = 0
    scope = contextlib.nullcontext() if mesh is None else \
        use_sharding(mesh, "seqtp")
    out = {}
    with scope:
        rows = steps._row_axes(current_ctx()) if mesh is not None else ()
        mine = local_block(toks, rows, mesh) if rows else toks
        if serve:
            with torch.no_grad():
                out["logits"] = tfm.forward(params, cfg, tokens=mine)[0]
                caches = tfm.init_caches(cfg, mine.shape[0], mine.shape[1],
                                         "cpu")
                out["last"], caches = tfm.prefill(params, cfg, mine, caches)
            out = {k: v.numpy() for k, v in out.items()}
            out["caches"] = flat(caches)
        if grads:
            (loss, _), g = steps.value_and_grad(params, cfg,
                                                {"tokens": mine})
            if mesh is not None:
                g, _ = steps._mesh_grads(g, cfg, current_ctx())
                if rows:
                    loss = collectives.psum(loss / mesh.axis_size(rows),
                                            rows, mesh)
            out["loss"], out["grads"] = float(loss), flat(g)
    out["routes"] = dict(attn.SEQSHARD_ROUTES)
    return out


def seqtp_coupled_rank(rank, path, shape, runs, carry=False):
    """Each run ``(case, name)`` of ``runs`` (``case``'s config and
    weights, run ``name``'s tokens) under ``seqtp`` on the mesh ``shape``
    over ("data", "model"): :func:`seqtp_run`'s results, every rank's;
    with ``carry``, :func:`carry_check`'s too."""
    from repro_torch.launch.mesh import compat_make_mesh
    d = _load(path)
    mesh = compat_make_mesh(shape, ("data", "model"))
    out = {}
    for case, name in runs:
        cfg, params, toks = coupled_inputs(d, case, name)
        out[name] = seqtp_run(cfg, params, toks, mesh,
                              serve=case in SERVE_CASES)
    if carry:
        out["carry"] = carry_check(mesh)
    return out


#: the cases whose forward and prefill the coupled tests check (the
#: attention kinds' are tests/test_torch_seqshard.py's)
SERVE_CASES = ("mamba", "rgemma", "deepseek", "qwen3moe")


def seqtp_train_rank(rank, ckpt_dir, argv):
    """``launch/train.py``'s CLI on this rank (its process group started
    by ``collectives.spawn``): each step's metrics, the final parameters
    and Adam's second moments."""
    from repro_torch.launch import train
    from repro_torch.tree import flatten_with_paths
    res = train.main(list(argv) + ["--ckpt-dir", f"{ckpt_dir}/r{rank}"])
    flat = lambda t: {k: v.float().numpy() for k, v in  # noqa: E731
                      flatten_with_paths(t).items()}
    return ([{k: h[k] for k in ("loss", "ce", "aux", "grad_norm", "lr")}
             for h in res["history"]], flat(res["params"]),
            flat(res["opt"].v))
