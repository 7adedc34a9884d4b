"""Serving driver of the port, after ``repro.launch.serve``: one engine on
one device, or, with ``--replicas N`` (N > 1), a Router fanning requests
out over N engine replicas with admission control and unified metrics.
It serves the dense fused engine by default, and the paged engine (block
pool, prefix cache) with ``--paged``, as the JAX driver does; on the paged
engine ``--speculative`` decodes speculatively and ``--kv-swap`` swaps
sessions out under pool pressure.
``--arch falcon-mamba-7b`` serves the Mamba-1 family, which has no K/V to
page: with ``--paged`` it serves dense and prints ``kv=dense``, as the JAX
driver would.

``--transport`` picks replica placement:

  * ``thread``  — replicas share this process, its CUDA context and one
    copy of the weights; their host work shares one interpreter.
  * ``process`` — each replica is a spawned worker process with an RPC
    inbox, rebuilt from a serializable spec (arch + seed); each holds its
    own CUDA context, weights and KV.
  * ``socket``  — the same spec-rebuilt worker behind a framed TCP
    connection; here the workers are spawned locally and dial back over
    loopback, but ``python -m repro_torch.cluster.worker_main`` can run
    on any host that reaches this process.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 8 [--paged] [--arch falcon-mamba-7b]
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --requests 3 --max-new 4 --slots 2 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --replicas 2 --transport process --requests 4 \
        --max-new 4 --slots 2 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --paged --block-size 8 --speculative [--kv-swap \
        --kv-blocks 6 --swap-tier artifact] --requests 8 --slots 8 \
        --max-len 32 --max-new 12

Weights come from the port's seeded init (``--seed``); ``--reduce`` serves
the tiny ``reduced()`` config instead of the full-width one.  It prints
the JAX driver's ``[serve] ... tok/s= ...`` line, and with replicas its
``[cluster] replicas=... transport=...`` line.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

from repro_torch.cluster import (POLICIES, TRANSPORTS, AdmissionConfig,
                                 AdmissionController, BrownoutController,
                                 EngineBackend, MetricsRegistry,
                                 ReplicaConfig, Router, Tracer,
                                 current_tracer, engine_spec,
                                 prometheus_text, set_tracer,
                                 to_chrome_trace)
from repro_torch.cluster.backends import make_engine
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine

#: a replicated request's deadline budget, the JAX driver's default
REQUEST_TIMEOUT_S = 600.0

#: the single-engine builder, shared with the cluster's LM backend; the
#: driver serves the full-width config unless asked to reduce it
build_engine = functools.partial(make_engine, reduce=False)


def _serve_cluster(args, engine_kw, prompts):
    """Serve ``prompts`` through a Router over ``args.replicas`` engine
    replicas; returns (tokens, wall, latencies, metrics snapshot)."""
    metrics = MetricsRegistry()
    router = Router(policy=args.router_policy, metrics=metrics,
                    admission=AdmissionController(
                        AdmissionConfig(max_queue_cost=args.max_queue),
                        metrics),
                    brownout=BrownoutController() if args.brownout
                    else None)
    rcfg = ReplicaConfig(max_batch=args.slots)
    if args.transport in ("process", "socket"):
        spec = engine_spec(**engine_kw)
        for _ in range(args.replicas):
            router.add_replica(spec=spec, cfg=rcfg, transport=args.transport)
    else:
        # one copy of the weights, shared by every thread replica
        first = make_engine(metrics=metrics, **engine_kw)
        engines = [first] + [
            Engine(first.params, first.cfg, first.scfg, metrics=metrics,
                   device=first.device) for _ in range(args.replicas - 1)]
        for eng in engines:
            router.add_replica(EngineBackend(eng), rcfg)
    t0 = time.perf_counter()
    creqs = [router.submit((p, args.max_new), cost=args.max_new,
                           session_key=str(i), timeout_s=REQUEST_TIMEOUT_S)
             for i, p in enumerate(prompts)]
    outs = [router.wait(r, timeout=REQUEST_TIMEOUT_S) for r in creqs]
    wall = time.perf_counter() - t0
    router.stop()
    toks = sum(len(o) for o in outs if isinstance(o, list))
    lats = [r.finished_s - r.submitted_s for r in creqs]
    snap = router.cluster_snapshot()
    print(f"[cluster] replicas={args.replicas} "
          f"transport={args.transport} "
          f"policy={args.router_policy} "
          f"completed={snap['router.completed']:.0f} "
          f"shed={snap.get('admission.shed_queue_full', 0):.0f}")
    return toks, wall, lats, snap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="K: decode steps per host sync")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: per-layer block pool + block "
                         "tables + prefix cache (default: dense)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged)")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="usable pool blocks (paged); 0 = slots * "
                         "max_len/block_size")
    ap.add_argument("--kv-swap", action="store_true",
                    help="KV lifecycle swap (paged): under pool pressure "
                         "preempt whole lowest-priority sessions to the "
                         "swap tier and restore them block-exact at "
                         "re-admit instead of completing them early as "
                         "kv_pool_exhausted victims")
    ap.add_argument("--swap-tier", default="host",
                    choices=("host", "artifact"),
                    help="where swapped KV blocks live: host memory "
                         "(inline bytes) or the content-addressed "
                         "artifact store")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative multi-token decode on the paged path: "
                         "an n-gram draft proposes spec-draft tokens per "
                         "step and one batched paged extend verifies them "
                         "(greedy only; requires --paged)")
    ap.add_argument("--spec-draft", type=int, default=3,
                    help="draft tokens proposed per speculative step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--reduce", action="store_true",
                    help="serve the tiny reduced() config instead of the "
                         "full-width one")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the cluster router")
    ap.add_argument("--router-policy", default="round_robin",
                    choices=list(POLICIES))
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="admission control: global queued-cost bound")
    ap.add_argument("--transport", default="thread", choices=list(TRANSPORTS),
                    help="replica placement: host threads, worker processes "
                         "with RPC inboxes, or socket workers over framed "
                         "TCP (remote-host capable)")
    ap.add_argument("--brownout", action="store_true",
                    help="graded overload controller: under queue pressure "
                         "halve max_new and tighten admission instead of "
                         "only shedding at the front door")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write per-request spans through router, "
                         "transport, replica and engine as Chrome "
                         "trace-event JSON")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot in Prometheus "
                         "text exposition format")
    args = ap.parse_args(argv)

    if args.trace_out:
        set_tracer(Tracer(enabled=True, replica="parent"))
    engine_kw = dict(arch=args.arch, reduce=args.reduce,
                     max_len=args.max_len, slots=args.slots,
                     sync_every=args.sync_every,
                     temperature=args.temperature, paged=args.paged,
                     block_size=args.block_size, kv_blocks=args.kv_blocks,
                     speculative=args.speculative,
                     spec_draft=args.spec_draft, kv_swap=args.kv_swap,
                     swap_tier=args.swap_tier, seed=args.seed,
                     device=args.device)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    paged = args.paged and tfm.paged_supported(cfg, args.max_len)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab,
                           size=rng.randint(4, 16)).astype(np.int32)
               for _ in range(args.requests)]
    if args.replicas <= 1:
        metrics = MetricsRegistry()
        eng = make_engine(metrics=metrics, **engine_kw)
        reqs = [eng.submit(p, max_new=args.max_new) for p in prompts]
        t0 = time.perf_counter()
        eng.run_until_drained()
        wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in reqs)
        lats = [r.done_t - r.submit_t for r in reqs]
        snap = metrics.snapshot()
    else:
        toks, wall, lats, snap = _serve_cluster(args, engine_kw, prompts)
    print(f"[serve] arch={args.arch} device={device} "
          f"kv={'paged' if paged else 'dense'} reqs={len(prompts)} "
          f"tokens={toks} tok/s={toks / wall:.1f} "
          f"p50={np.median(lats):.2f}s p99={np.percentile(lats, 99):.2f}s")
    if args.trace_out:
        spans = current_tracer().spans()
        with open(args.trace_out, "w") as f:
            json.dump(to_chrome_trace(spans), f)
        print(f"[trace] {len(spans)} spans -> {args.trace_out}")
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(prometheus_text(snap))
        print(f"[metrics] prometheus exposition -> {args.prom_out}")


if __name__ == "__main__":
    main()
