"""Serving driver of the port, after ``repro.launch.serve``: one engine on
one device, or, with ``--replicas N`` (N > 1), a Router fanning requests
out over N engine replicas with admission control and unified metrics.
It serves the dense fused engine by default, and the paged engine (block
pool, prefix cache) with ``--paged``, as the JAX driver does; on the paged
engine ``--speculative`` decodes speculatively and ``--kv-swap`` swaps
sessions out under pool pressure.
``--arch falcon-mamba-7b`` serves the Mamba-1 family, which has no K/V to
page: with ``--paged`` it serves dense and prints ``kv=dense``, as the JAX
driver would.  ``--arch qwen3-moe-30b-a3b`` serves the MoE family: its
admits are batch-1 and ``--speculative`` falls back to plain paged
decode, as in JAX; one copy of its full-width weights takes 57 GiB of
the card, so it serves as one engine, not as process replicas.
``--arch recurrentgemma-2b`` serves the Griffin hybrid family (RG-LRU
layers and MQA local attention): like Mamba it holds recurrent state, so
``--paged`` serves dense; give it ``--max-len`` above its 2,048-key
window for its local layers to keep rings.  ``--arch
deepseek-v2-lite-16b`` serves MLA (a latent cache, no paging: ``--paged``
serves dense) with the MoE family's rules; its full-width weights take
29 GiB of the card.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --arch recurrentgemma-2b --requests 8 --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --arch deepseek-v2-lite-16b --requests 8 --max-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --arch recurrentgemma-2b --requests 3 --max-new 4 \
        --slots 2 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --requests 3 --max-new 4 --slots 2 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --replicas 2 --transport process --requests 4 \
        --max-new 4 --slots 2 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --paged --block-size 8 --speculative [--kv-swap \
        --kv-blocks 6 --swap-tier artifact] --requests 8 --slots 8 \
        --max-len 32 --max-new 12

Weights come from the port's seeded init (``--seed``), or from a
``Checkpointer`` directory (``--weights-dir``); ``--reduce`` serves the
tiny ``reduced()`` config instead of the full-width one.  It prints the
JAX driver's ``[serve] ... tok/s= ...`` line, and with replicas its
``[cluster] replicas=... transport=...`` line.

The stats stack of the JAX driver (``--stats-port``, ``--stats-dump``,
``--watch``): a sampler of the metrics snapshot (the Router's cluster
snapshot with replicas) into a time-series store, an SLO burn-rate engine
(with replicas it also feeds the Router's brownout) and an HTTP endpoint
with ``/metrics``, ``/timeseries.json``, ``/slo.json`` and ``/dash``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --arch starcoder2-3b --requests 3 --max-new 4 \
        --slots 2 --max-len 64 --stats-dump /tmp/stats
"""
from __future__ import annotations

import argparse
import functools
import json
import threading
import time
import urllib.request

import numpy as np

from repro_torch.cluster import (POLICIES, TRANSPORTS, AdmissionConfig,
                                 AdmissionController, BrownoutController,
                                 EngineBackend, MetricsRegistry,
                                 ReplicaConfig, Router, SLOEngine,
                                 SLOObjective, StatsServer, TelemetrySampler,
                                 TimeSeriesStore, Tracer, current_recorder,
                                 current_tracer, engine_spec,
                                 prometheus_text, render_watch, set_tracer,
                                 to_chrome_trace)
from repro_torch.cluster.backends import make_engine
from repro_torch.cluster.tracing import start_profiling, stop_profiling
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine

#: the single-engine builder, shared with the cluster's LM backend; the
#: driver serves the full-width config unless asked to reduce it
build_engine = functools.partial(make_engine, reduce=False)


def _start_telemetry(args, snapshot_fn, registry, router=None):
    """Build the stats stack — ring-buffer TimeSeriesStore, SLO burn-rate
    engine, background sampler, HTTP stats endpoint, optional terminal
    watcher — and return a ``finalize()`` that takes one last sample,
    dumps the routes (``--stats-dump``), and tears everything down
    (``repro.launch.serve._start_telemetry``)."""
    store = TimeSeriesStore()
    slo = SLOEngine([SLOObjective(kind="any")], registry,
                    recorder=current_recorder())
    if router is not None:
        router.slo = slo            # brownout reads slo.pressure()
    sampler = TelemetrySampler(snapshot_fn, store, registry=registry,
                               tracer=current_tracer(), slo=slo,
                               period_s=args.stats_period)
    sampler.start()
    server = None
    port = args.stats_port
    if port is None and args.stats_dump:
        port = 0
    if port is not None:
        server = StatsServer(snapshot_fn, store, slo=slo,
                             host=args.stats_host, port=port).start()
        print(f"[stats] /metrics /timeseries.json /slo.json /dash "
              f"on {server.url}")
    stop_watch = threading.Event()
    wt = None
    if args.watch:
        def _watch_loop():
            while not stop_watch.wait(1.0):
                print("\x1b[2J\x1b[H" + render_watch(store, slo.status()))
        wt = threading.Thread(target=_watch_loop, daemon=True,
                              name="stats-watch")
        wt.start()

    def finalize():
        stop_watch.set()
        if wt is not None:
            wt.join(timeout=2.0)
        sampler.stop()
        sampler.tick()              # one last sample so dumps see the end
        if args.watch:
            print(render_watch(store, slo.status()))
        try:
            if args.stats_dump and server is not None:
                routes = (("metrics", "txt", "/metrics"),
                          ("timeseries", "json", "/timeseries.json"),
                          ("slo", "json", "/slo.json"),
                          ("dash", "html", "/dash"))
                for name, ext, route in routes:
                    with urllib.request.urlopen(server.url + route,
                                                timeout=10.0) as resp:
                        body = resp.read()
                    with open(f"{args.stats_dump}.{name}.{ext}", "wb") as f:
                        f.write(body)
                print(f"[stats] dumped {len(routes)} routes -> "
                      f"{args.stats_dump}.*")
        finally:
            if server is not None:
                server.stop()

    return finalize


def _serve_cluster(args, engine_kw, prompts, stats_on):
    """Serve ``prompts`` through a Router over ``args.replicas`` engine
    replicas; returns (tokens, wall, latencies, metrics snapshot)."""
    metrics = MetricsRegistry()
    router = Router(policy=args.router_policy, metrics=metrics,
                    admission=AdmissionController(
                        AdmissionConfig(
                            max_queue_cost=args.max_queue,
                            min_kv_headroom_frac=args.kv_headroom),
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
    finalize_stats = None
    if stats_on:
        finalize_stats = _start_telemetry(args, router.cluster_snapshot,
                                          metrics, router=router)
    t0 = time.perf_counter()
    creqs = [router.submit((p, args.max_new), cost=args.max_new,
                           session_key=str(i), timeout_s=args.request_timeout)
             for i, p in enumerate(prompts)]
    outs = [router.wait(r, timeout=args.request_timeout) for r in creqs]
    wall = time.perf_counter() - t0
    if finalize_stats is not None:
        finalize_stats()
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
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="per-token reference decode loop instead of the "
                         "fused K-step loop")
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
    ap.add_argument("--request-timeout", type=float, default=600.0,
                    help="per-request deadline budget in seconds (with "
                         "replicas); the budget rides the wire to workers, "
                         "which drop expired queue work and finish expired "
                         "sessions mid-decode (finish_reason='deadline')")
    ap.add_argument("--brownout", action="store_true",
                    help="graded overload controller: under queue/KV "
                         "pressure (and a firing SLO alert with the stats "
                         "stack on), degrade service (disable speculation, "
                         "halve max_new, tighten admission) instead of "
                         "only shedding at the front door")
    ap.add_argument("--kv-headroom", type=float, default=0.0,
                    help="admission (with replicas): shed when the "
                         "cluster's free KV-block fraction drops below this "
                         "(0 disables)")
    ap.add_argument("--weights-dir", default=None,
                    help="Checkpointer directory to load every engine's "
                         "weights from (default: the seeded init at --seed "
                         "in each engine or worker)")
    ap.add_argument("--trace", action="store_true",
                    help="record per-request spans through router, "
                         "transport, replica, and engine stages")
    ap.add_argument("--trace-sample-rate", type=float, default=1.0,
                    help="fraction of requests that root a trace "
                         "(workers always follow a sampled parent)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write per-request spans through router, "
                         "transport, replica and engine as Chrome "
                         "trace-event JSON; implies --trace")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot in Prometheus "
                         "text exposition format")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the host and "
                         "the card over the run into DIR (Chrome trace "
                         "JSON, Perfetto loadable)")
    ap.add_argument("--stats-port", type=int, default=None, metavar="PORT",
                    help="serve live stats over HTTP: /metrics (Prometheus), "
                         "/timeseries.json, /slo.json, /dash (HTML "
                         "dashboard); 0 picks an ephemeral port")
    ap.add_argument("--stats-host", default="127.0.0.1",
                    help="stats bind address (loopback unless you mean it)")
    ap.add_argument("--stats-dump", default=None, metavar="PREFIX",
                    help="at end of run, fetch every stats route over HTTP "
                         "and write PREFIX.metrics.txt / .timeseries.json / "
                         ".slo.json / .dash.html; implies --stats-port 0")
    ap.add_argument("--watch", action="store_true",
                    help="render a terminal stats screen every second "
                         "while the run is in flight")
    ap.add_argument("--stats-period", type=float, default=0.25,
                    help="telemetry sampling cadence in seconds")
    args = ap.parse_args(argv)

    if args.trace_out:
        args.trace = True
    if args.trace:
        set_tracer(Tracer(enabled=True,
                          sample_rate=args.trace_sample_rate,
                          replica="parent"))
    if args.profile_dir:
        start_profiling(args.profile_dir)
    engine_kw = dict(arch=args.arch, reduce=args.reduce,
                     weights_path=args.weights_dir, fused=args.fused,
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
    stats_on = (args.stats_port is not None or args.stats_dump is not None
                or args.watch)
    if args.replicas <= 1:
        metrics = MetricsRegistry()
        eng = make_engine(metrics=metrics, **engine_kw)
        finalize_stats = None
        if stats_on:
            finalize_stats = _start_telemetry(args, metrics.snapshot,
                                              metrics)
        reqs = [eng.submit(p, max_new=args.max_new) for p in prompts]
        t0 = time.perf_counter()
        eng.run_until_drained()
        wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in reqs)
        lats = [r.done_t - r.submit_t for r in reqs]
        if finalize_stats is not None:
            finalize_stats()
        snap = metrics.snapshot()
    else:
        toks, wall, lats, snap = _serve_cluster(args, engine_kw, prompts,
                                                stats_on)
    print(f"[serve] arch={args.arch} device={device} "
          f"kv={'paged' if paged else 'dense'} reqs={len(prompts)} "
          f"tokens={toks} tok/s={toks / wall:.1f} "
          f"p50={np.median(lats):.2f}s p99={np.percentile(lats, 99):.2f}s")
    if args.profile_dir:
        path = stop_profiling()
        print(f"[profile] torch.profiler trace -> {path}")
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
