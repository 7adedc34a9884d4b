"""Serving driver of the port: one engine on one device, the
single-replica path of ``repro.launch.serve``.  It serves the dense fused
engine by default, and the paged engine (block pool, prefix cache) with
``--paged``, as the JAX driver does.  ``--arch falcon-mamba-7b`` serves
the Mamba-1 family, which has no K/V to page: with ``--paged`` it serves
dense and prints ``kv=dense``, as the JAX driver would.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 8 [--paged] [--arch falcon-mamba-7b]
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduce --requests 3 --max-new 4 --slots 2 --max-len 64

Weights come from the port's seeded init (``--seed``); ``--reduce`` serves
the tiny ``reduced()`` config instead of the full-width one.  It prints
the JAX driver's ``[serve] ... tok/s= ...`` line.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.cluster.metrics import MetricsRegistry
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.weights import init_params
from repro_torch.serving import Engine, ServeConfig


def build_engine(arch: str = "internlm2-1.8b", *, reduce: bool = False,
                 max_len: int = 256, slots: int = 4, sync_every: int = 8,
                 temperature: float = 0.0, paged: bool = False,
                 block_size: int = 16, kv_blocks: int = 0, seed: int = 0,
                 device="cuda",
                 metrics: Optional[MetricsRegistry] = None) -> Engine:
    """A fused engine over seeded random weights, dense unless ``paged``
    (``cluster/backends.py:127-133``).  ``reduce`` picks the tiny
    ``reduced()`` config; the default is the arch at full width."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device)
    scfg = ServeConfig(max_len=max_len, slots=slots, fused=True,
                       sync_every=sync_every, temperature=temperature,
                       seed=seed, paged=paged, block_size=block_size,
                       kv_blocks=kv_blocks)
    return Engine(params, cfg, scfg, metrics=metrics, device=device)


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--reduce", action="store_true",
                    help="serve the tiny reduced() config instead of the "
                         "full-width one")
    args = ap.parse_args(argv)

    eng = build_engine(args.arch, reduce=args.reduce, max_len=args.max_len,
                       slots=args.slots, sync_every=args.sync_every,
                       temperature=args.temperature, paged=args.paged,
                       block_size=args.block_size, kv_blocks=args.kv_blocks,
                       seed=args.seed, device=args.device)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, eng.cfg.vocab,
                           size=rng.randint(4, 16)).astype(np.int32)
               for _ in range(args.requests)]
    reqs = [eng.submit(p, max_new=args.max_new) for p in prompts]
    t0 = time.perf_counter()
    eng.run_until_drained()
    wall = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    lats = [r.done_t - r.submit_t for r in reqs]
    print(f"[serve] arch={args.arch} device={eng.device} "
          f"kv={'paged' if eng.paged else 'dense'} reqs={len(prompts)} "
          f"tokens={toks} tok/s={toks / wall:.1f} "
          f"p50={np.median(lats):.2f}s p99={np.percentile(lats, 99):.2f}s")


if __name__ == "__main__":
    main()
