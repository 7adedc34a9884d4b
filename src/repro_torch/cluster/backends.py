"""Serializable backend specifications, the port of
``repro.cluster.backends``.

A thread replica can own any in-process object, but a *worker process* must
be able to rebuild its backend from scratch after ``spawn`` — so the unit
of deployment is a :class:`BackendSpec`: a dotted path to a module-level
builder plus picklable kwargs (config values, a device name and a weights
*path*, never a closure or a live tensor).  ``spec.build()`` runs on
whichever side of the process boundary the transport puts it.

Builders for the repo's three backend families live here; anything
module-level and importable works (tests add their own).  Heavy imports
(torch, models) happen inside the builders so that spawning a worker for a
pure-Python backend never pays the torch import.

The LM and stream builders take ``device`` (default ``"cuda"``, which
raises where there is no card; the tests pass ``"cpu"``).  The JAX
module's ``shared_engine_fns`` is gone: it shared jitted functions between
engines of one process, and the port's engine has no jit to share.
Inside a worker process the LM and stream backends also publish the
port's kernel launch counts over the heartbeats (:func:`count_launches`).
:func:`make_engine` is the one engine builder: :func:`build_engine` wraps
its engine in an ``EngineBackend`` for a replica, and
``launch/serve.py`` serves it directly.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import time
from typing import Any, Dict, Optional

# Backend kinds — the admission controller's per-backend cost-model keys.
KIND_FN = "fn"        # arbitrary step functions (cost unit: requests)
KIND_LM = "lm"        # LM engine (cost unit: tokens)
KIND_SVM = "svm"      # SVM stream runtime (cost unit: rows)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """``target`` is ``"module.path:callable"``; ``kwargs`` must pickle.

    ``kind`` tags the backend family for per-backend admission cost models
    and metrics; it defaults to :data:`KIND_FN`.
    """
    target: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kind: str = KIND_FN

    def build(self):
        mod_name, sep, fn_name = self.target.partition(":")
        if not sep:
            raise ValueError(f"BackendSpec target {self.target!r} must be "
                             f"'module.path:callable'")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn(**dict(self.kwargs))


# ----------------------------------------------------------------------
# Builders (module-level: importable from a spawned worker process).

def build_echo(delay_s: float = 0.0, scale: int = 2, stall_s: float = 0.0,
               poison: Optional[int] = None):
    """Deterministic test/bench backend: ``payload * scale`` after an
    optional per-batch stall (models host-side work).

    ``stall_s`` > 0 turns the replica into a *slow loris*: every batch
    hangs for that long (effectively forever for chaos tests) while the
    worker's liveness signals — process aliveness, the socket heartbeat
    thread — stay green.  Detection is the transports' ack timeout.

    ``poison`` marks one payload value as a replica-killer: any batch
    containing it raises, which spills the batch and ends the replica
    loop on every transport (thread replicas die in place; worker
    processes exit and the parent spills).  This models the
    poison-request pathology — a request that crashes whatever serves it
    — whose blast radius the router's retry budget must bound."""
    from repro_torch.cluster.replica import FnBackend

    def step(payloads):
        if poison is not None and any(p == poison for p in payloads):
            raise RuntimeError(f"poison payload {poison!r} in batch")
        if stall_s:
            time.sleep(stall_s)
        if delay_s:
            time.sleep(delay_s)
        return [p * scale for p in payloads]

    return FnBackend(step)


def count_launches(backend):
    """Inside a remote worker, publish the port's kernel launches
    (``repro_torch.kernels.LAUNCHES``, counted in this process) after each
    batch as ``kernels.launches.<name>`` counters of the registry its
    heartbeats ship, so the parent sees which kernels its workers ran.
    Elsewhere (a thread replica, whose launches the parent counts itself)
    ``backend`` is returned as it is."""
    from repro_torch import kernels
    from repro_torch.cluster.metrics import worker_registry

    registry = worker_registry()
    if registry is None:
        return backend
    process, seen = backend.process, dict(kernels.LAUNCHES)

    def counted(payloads):
        try:
            return process(payloads)
        finally:
            for name, n in dict(kernels.LAUNCHES).items():
                registry.counter(f"kernels.launches.{name}").inc(
                    n - seen.get(name, 0))
                seen[name] = n

    backend.process = counted
    return backend


def build_stream(feat_dim: int = 256, claim_capacity: int = 64,
                 evid_capacity: int = 128, period: float = 1.0,
                 capacity: int = 256, scope: str = "window",
                 window: float = 10.0, ring_capacity: int = 512,
                 ingest_ms: float = 0.0, model_seed: int = 7,
                 device="cuda"):
    """One SVM stream runtime on ``device``, rebuilt from config alone.
    The MARGOT SVM models are derived deterministically from
    ``model_seed`` (the repo has no trained-weights artifact for them), so
    every worker process converges on identical models without shipping
    arrays."""
    from repro_torch.cluster.replica import StreamBackend
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.stream import StreamConfig, StreamRuntime
    from repro_torch.data.text import margot_models

    pcfg = PipelineConfig(feat_dim=feat_dim, claim_capacity=claim_capacity,
                          evid_capacity=evid_capacity)
    scfg = StreamConfig(period=period, capacity=capacity, scope=scope,
                        window=window, ring_capacity=ring_capacity)
    models = margot_models(pcfg, link_seed=model_seed, device=device)
    runtime = StreamRuntime(models, pcfg, scfg)
    fetch = None
    if ingest_ms > 0:
        fetch = lambda p: (time.sleep(ingest_ms * 1e-3), p)[1]  # noqa: E731
    return count_launches(StreamBackend(runtime, fetch=fetch))


def checkpoint_step_dir(directory: str) -> str:
    """The step directory ``Checkpointer(directory).restore(like)``
    reads: ``step_<n>`` for the step named in ``LATEST``."""
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(latest) as f:
        return os.path.join(directory, f"step_{int(f.read().strip())}")


def make_engine(arch: str = "internlm2-1.8b", max_len: int = 64,
                slots: int = 2, reduce: bool = True, seed: int = 0,
                weights_path: Optional[str] = None, fused: bool = True,
                sync_every: int = 8, temperature: float = 0.0,
                prefill_bucketing: bool = True, paged: bool = False,
                block_size: int = 16, kv_blocks: int = 0,
                prefix_cache: bool = True, speculative: bool = False,
                spec_draft: int = 3, kv_swap: bool = False,
                swap_tier: str = "host", device="cuda", metrics=None):
    """One continuous-batching LM engine on ``device``.  Weights come from
    ``weights_path`` (a ``Checkpointer`` directory, its ``LATEST`` step)
    when given, else from the port's seeded init at ``seed``.  The
    ``ServeConfig`` knobs are plain scalars, so a spec of them pickles
    across process and socket workers, the speculative decode and KV swap
    knobs included."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import weights
    from repro_torch.serving import Engine, ServeConfig

    device = resolve_device(device)
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    if weights_path is not None:
        params = weights.load_checkpoint(checkpoint_step_dir(weights_path),
                                         cfg, device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = weights.init_params(cfg, gen, device)
    scfg = ServeConfig(max_len=max_len, slots=slots, fused=fused,
                       sync_every=sync_every, temperature=temperature,
                       seed=seed, prefill_bucketing=prefill_bucketing,
                       paged=paged, block_size=block_size,
                       kv_blocks=kv_blocks, prefix_cache=prefix_cache,
                       speculative=speculative, spec_draft=spec_draft,
                       kv_swap=kv_swap, swap_tier=swap_tier)
    return Engine(params, cfg, scfg, metrics=metrics, device=device)


def build_engine(arch: str = "internlm2-1.8b", max_len: int = 64,
                 slots: int = 2, reduce: bool = True, seed: int = 0,
                 weights_path: Optional[str] = None,
                 ingest_ms: float = 0.0, fused: bool = True,
                 sync_every: int = 8, temperature: float = 0.0,
                 prefill_bucketing: bool = True, paged: bool = False,
                 block_size: int = 16, kv_blocks: int = 0,
                 prefix_cache: bool = True, speculative: bool = False,
                 spec_draft: int = 3, kv_swap: bool = False,
                 swap_tier: str = "host", device="cuda"):
    """A replica's LM backend: :func:`make_engine`'s engine behind an
    ``EngineBackend``.  Either way the worker holds its own copy of the
    weights on its own CUDA context, which is the whole point of the
    process transport."""
    from repro_torch.cluster.metrics import worker_registry
    from repro_torch.cluster.replica import EngineBackend

    # inside a remote worker, report into the registry its heartbeats
    # ship — that is how engine.* counters and the paged engine's
    # kv_blocks_* gauges reach the router's admission headroom gate
    engine = make_engine(
        arch, max_len=max_len, slots=slots, reduce=reduce, seed=seed,
        weights_path=weights_path, fused=fused, sync_every=sync_every,
        temperature=temperature, prefill_bucketing=prefill_bucketing,
        paged=paged, block_size=block_size, kv_blocks=kv_blocks,
        prefix_cache=prefix_cache, speculative=speculative,
        spec_draft=spec_draft, kv_swap=kv_swap, swap_tier=swap_tier,
        device=device, metrics=worker_registry())
    if ingest_ms > 0:
        class _IngestEngineBackend(EngineBackend):
            def process(self, payloads):
                time.sleep(ingest_ms * 1e-3 * len(payloads))
                return super().process(payloads)
        return count_launches(_IngestEngineBackend(engine))
    return count_launches(EngineBackend(engine))


# ----------------------------------------------------------------------
# Spec helpers: the canonical way callers name a backend family.

def echo_spec(**kwargs) -> BackendSpec:
    return BackendSpec("repro_torch.cluster.backends:build_echo", kwargs,
                       KIND_FN)


def stream_spec(**kwargs) -> BackendSpec:
    return BackendSpec("repro_torch.cluster.backends:build_stream", kwargs,
                       KIND_SVM)


def engine_spec(**kwargs) -> BackendSpec:
    return BackendSpec("repro_torch.cluster.backends:build_engine", kwargs,
                       KIND_LM)
