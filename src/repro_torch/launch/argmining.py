"""MARGOT argument mining as a service, the port's driver of the paper's
two-phase pipeline (``examples/argmining_batch.py`` and
``examples/argmining_stream.py`` of the JAX package):

corpus -> sentence split -> hashed bag-of-words -> phase-1 claim/evidence
SVMs -> static-shape filter -> per-document Cartesian join -> phase-2
pair scoring (the hand-written pair-score kernel on the card) -> links.

    PYTHONPATH=src python -m repro_torch.launch.argmining batch \
        --device cuda --dataset DS2
    PYTHONPATH=src python -m repro_torch.launch.argmining stream --device cuda
    PYTHONPATH=src python -m repro_torch.launch.argmining batch \
        --device cpu --docs 6

``batch`` cuts the corpus into partitions of 12 whole documents (the
paper's join key, so the link set does not depend on the worker count)
and runs them on ``--workers`` threads with straggler speculation.  The
MARGOT models (``--model-sv linear``) keep the pipeline's calibrated
filter capacities, which 12 documents of 40 sentences fit; the random
polynomial SVMs of Table 2 (``M1``-``M3``) have no calibrated positive
rate, so their capacities are raised to the partition size
(``benchmarks/common.py:110-112`` of the JAX package).  ``stream`` runs
five steady micro-batches of 64 instances, then the rate ramp (three
micro-batches a rate), and prints the largest sustainable rate.
``--device`` defaults to ``cuda`` and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.margot_svm import DATASETS, MODELS_SV, PIPELINE, \
    STREAM
from repro_torch.core.fault import speculative_map
from repro_torch.core.pipeline import (PipelineConfig, extract_links,
                                       init_models, make_batch_step)
from repro_torch.core.stream import (StreamConfig, StreamRuntime,
                                     find_sustainable_rate)
from repro_torch.data.text import corpus_arrays, margot_models, \
    synthetic_corpus
from repro_torch.device import resolve_device

SENTENCES_PER_DOC = 40
DOCS_PER_PARTITION = 12     # 480 sentences: ~160 claims fit capacity 256
STEADY_MICROBATCHES, STEADY_N, MB_PER_RATE = 5, 64, 3


def make_corpus(n_sentences: int, feat_dim: int, seed: int = 0,
                sentences_per_doc: int = SENTENCES_PER_DOC):
    """The first ``n_sentences`` of a synthetic corpus of whole documents:
    (X (n, d) fp32, doc keys (n,) int32, sentences)."""
    docs = synthetic_corpus(max(1, -(-n_sentences // sentences_per_doc)),
                            sentences_per_doc, seed=seed)
    X, keys, sents = corpus_arrays(docs, dim=feat_dim)
    return X[:n_sentences], keys[:n_sentences], sents[:n_sentences]


def partition_bounds(keys: np.ndarray, docs_per_partition: int):
    """(start, end) row ranges of ``docs_per_partition`` whole documents
    each; ``keys`` are document ids in document order."""
    doc_starts = np.flatnonzero(np.diff(keys)) + 1
    cuts = [0, *doc_starts[docs_per_partition - 1::docs_per_partition]
            .tolist(), len(keys)]
    return list(zip(cuts[:-1], cuts[1:]))


def batch_models(model_sv: str, psize: int, device, seed: int = 0):
    """(models, pipeline config) for ``--model-sv``: the MARGOT models at
    the calibrated capacities, or Table 2's M1-M3 polynomial SVMs with
    capacities raised to the largest partition ``psize``."""
    if model_sv == "linear":
        return margot_models(PIPELINE, device=device), PIPELINE
    pcfg = dataclasses.replace(
        PIPELINE, claim_capacity=max(PIPELINE.claim_capacity, psize),
        evid_capacity=max(PIPELINE.evid_capacity, psize))
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_models(pcfg, gen, n_sv=MODELS_SV[model_sv],
                       device=device), pcfg


@dataclasses.dataclass
class BatchResult:
    links: list             # (claim row, evidence row, score), corpus rows
    n_dropped: int
    partitions: int
    launched: int           # partition runs started, speculation included
    speculated: int
    wall_s: float


def run_batch(models, X: np.ndarray, keys: np.ndarray,
              pcfg: PipelineConfig, docs_per_partition: int, workers: int,
              device) -> BatchResult:
    """The two-phase pipeline over document-aligned partitions on a
    worker pool; the wall time covers the host-to-device copies, both
    phases and the host's link extraction."""
    bounds = partition_bounds(keys, docs_per_partition)
    step = make_batch_step(pcfg)

    def work(bound):
        s, e = bound
        out = step(models, torch.from_numpy(X[s:e]).to(device),
                   torch.from_numpy(keys[s:e]).to(device))
        links = [(c + s, v + s, sc) for c, v, sc in extract_links(out)]
        return links, int(out.n_dropped)

    t0 = time.perf_counter()
    results, stats = speculative_map(work, bounds, n_workers=workers)
    wall = time.perf_counter() - t0
    return BatchResult([l for r, _ in results for l in r],
                       sum(n for _, n in results), len(bounds),
                       stats.launched, stats.speculated, wall)


def run_stream(models, pcfg: PipelineConfig, scfg: StreamConfig,
               X: np.ndarray, keys: np.ndarray, rates: List[float],
               seed: int = 0):
    """Steady micro-batches of rows drawn from (X, keys), then the rate
    ramp; returns (the steady runtime, the largest sustainable rate)."""
    rng = np.random.RandomState(seed)

    def gen(n, t0):
        idx = rng.randint(0, len(keys), n)
        ts = t0 + np.linspace(0, scfg.period, n,
                              endpoint=False).astype(np.float32)
        return X[idx], keys[idx], ts

    rt = StreamRuntime(models, pcfg, scfg)
    for mb in range(STEADY_MICROBATCHES):
        rt.process_microbatch(*gen(STEADY_N, mb * scfg.period))
    rate = find_sustainable_rate(lambda: StreamRuntime(models, pcfg, scfg),
                                 gen, rates=rates, mb_per_rate=MB_PER_RATE)
    return rt, rate


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    b = sub.add_parser("batch", help="the batch service (paper §5.1)")
    b.add_argument("--device", default="cuda")
    what = b.add_mutually_exclusive_group()
    what.add_argument("--dataset", choices=sorted(DATASETS),
                      help="Table 1's sentence count")
    what.add_argument("--docs", type=int, default=6)
    b.add_argument("--sentences-per-doc", type=int, default=SENTENCES_PER_DOC)
    b.add_argument("--workers", type=int, default=2)
    b.add_argument("--model-sv", choices=["linear", *MODELS_SV],
                   default="linear")
    b.add_argument("--seed", type=int, default=0)
    s = sub.add_parser("stream", help="the micro-batch stream (paper §5.2)")
    s.add_argument("--device", default="cuda")
    s.add_argument("--scope", choices=["window", "file"], default=STREAM.scope)
    s.add_argument("--rates", default="1600,6400,25600,102400",
                   help="the ramp, instances per second")
    s.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return (_main_batch if args.mode == "batch" else _main_stream)(args, dev)


def _main_batch(args, dev):
    spd = args.sentences_per_doc
    n = DATASETS[args.dataset] if args.dataset else args.docs * spd
    t0 = time.perf_counter()
    X, keys, sents = make_corpus(n, PIPELINE.feat_dim, args.seed, spd)
    corpus_s = time.perf_counter() - t0
    psize = max(e - s for s, e in partition_bounds(keys, DOCS_PER_PARTITION))
    models, pcfg = batch_models(args.model_sv, psize, dev, args.seed)
    res = run_batch(models, X, keys, pcfg, DOCS_PER_PARTITION, args.workers,
                    dev)
    print(f"[argmining batch] {args.dataset or 'docs'}: {n} sentences "
          f"(corpus made and featurized in {corpus_s:.2f}s), "
          f"{res.partitions} partitions of <= {DOCS_PER_PARTITION} "
          f"docs ({psize} sentences), model={args.model_sv}, capacities "
          f"{pcfg.claim_capacity}/{pcfg.evid_capacity}, "
          f"workers={args.workers}: links={len(res.links)} "
          f"n_dropped={res.n_dropped} wall={res.wall_s:.3f}s "
          f"sentences/s={n / res.wall_s:.1f} launched={res.launched} "
          f"speculated={res.speculated} device={_device_name(dev)}")
    for c, e, sc in sorted(res.links, key=lambda x: -x[2])[:3]:
        print(f"  [{sc:+.2f}] claim: {sents[c][:48]!r:50} <- evidence: "
              f"{sents[e][:48]!r}")
    return res


def _main_stream(args, dev):
    pcfg, scfg = PIPELINE, dataclasses.replace(STREAM, scope=args.scope)
    models = margot_models(pcfg, device=dev)
    docs = synthetic_corpus(8, 64, seed=1)
    X, keys, _ = corpus_arrays(docs, dim=pcfg.feat_dim)
    rates = [float(r) for r in args.rates.split(",")]
    rt, rate = run_stream(models, pcfg, scfg, X, keys, rates, args.seed)
    for st in rt.stats:
        print(f"[argmining stream] mb={st.mb_id:02d} n={st.n_in} "
              f"busy={st.busy_s * 1e3:.2f}ms links={st.n_links}")
    print(f"[argmining stream] scope={scfg.scope} window={scfg.window}s "
          f"period={scfg.period}s ring={scfg.ring_capacity} "
          f"capacity={scfg.capacity}: max sustainable rate {rate:.0f} "
          f"inst/s of ramp {args.rates} device={_device_name(dev)}")
    return rt, rate


if __name__ == "__main__":
    main()
