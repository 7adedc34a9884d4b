"""LM serving engine of the port: ``repro.serving.engine`` with continuous
batching, on three paths, for the dense GQA family (``internlm2-1.8b``,
``starcoder2-3b``, and at head dim 256 ``gemma-7b`` and ``gemma3-4b``), the
MoE family (``qwen3-moe-30b-a3b``, and ``deepseek-v2-lite-16b``: MLA, a
dense first layer, shared experts), the token path of the VLM family
(``internvl2-1b``'s decoder; its patch prefix is not in the port), the
Mamba-1 family (``falcon-mamba-7b``) and the Griffin hybrid family
(``recurrentgemma-2b``: RG-LRU layers and MQA local attention).

gemma3-4b's local layers keep a ring of ``window`` rows at ``max_len``
2048, so, as in JAX, it serves dense (``paged=True`` falls back, counted)
with exact-length admits (a pad would take a ring row).

* Dense fused (``paged=False``, the default): K/V live in one dense
  ``max_len`` stripe per slot.  An admit prefills the queue's longest
  same-bucket prefix in one right-padded batch and replaces each admitted
  slot's cache row; decode runs ``sync_every`` (K) steps on the device per
  host sync.  On CUDA the prefill runs the flash attention kernel and the
  decode the split-K decode kernel.
* Paged (``paged=True``): K/V live in a shared per-layer block pool
  addressed through per-slot block tables (``serving/kvpool.py`` holds the
  host bookkeeping).  An admit runs one batched suffix extend per prefill
  bucket, reusing prompt blocks a content-hashed prefix cache already
  holds; decode reads the pool through the block tables at every step.  On
  CUDA both passes run the paged attention kernels.  The paged engine also
  decodes speculatively (``speculative=True``: n-gram drafts verified by
  one batched extend through the pool, so the paged extend kernel runs at
  S = d+1), forks sessions copy-on-write, swaps whole sessions out under
  pool pressure (``kv_swap=True``) and exports / imports its prefix
  cache's blocks as ``KVB1`` frames.
* Reference (``fused=False``, dense): one exact-length batch-1 prefill per
  admit and one host round trip per decoded token, greedy only: the parity
  oracle of the other two.

The Mamba family keeps a recurrent state per slot instead of K/V, so it
serves dense: ``paged=True`` falls back to the dense engine, as in JAX
(``engine.paged`` is False and ``engine.paged_fallback_dense`` counts it),
and its admits take exact-length buckets (pads would enter the state),
where same-length prompts still share one batch.  On CUDA each SSM layer's
prefill runs the selective-scan kernel.  The hybrid family serves the same
way: its RG-LRU layers keep a recurrent state (their prefill runs the scan
kernel at N = 1) and its local layers rings of ``window`` rows where the
window is shorter than ``max_len``.

The MoE family's expert capacity couples the rows of a batch, so, as in
JAX, its admits are batch-1 at exact length, speculation falls back to
plain paged decode (``engine.spec_fallback`` counts it) and an inactive
slot keeps feeding token 0 through every decode step.  deepseek-v2-lite's
MLA keeps a latent cache that cannot page, so it serves dense
(``paged=True`` falls back, counted); on CUDA its prefill runs the flash
kernel at q/k 192 and v 128 and its decode the MLA decode kernel.

Differences from the JAX engine, all confined to the device calls:

* PyTorch runs eagerly, so nothing is jitted or donated: the device state
  (pools, ``pos``, ``last``, ``active``, ``remaining``) is updated in place
  by :class:`EngineFns`.
* Admit batches are not padded to a power of two (that only bounded jit
  compiles).
* Sampling draws from the engine's ``torch.Generator``; temperature > 0
  matches JAX in distribution only.
* The block pool is the only copy of the K/V.  JAX's speculative path
  verifies on a resident dense copy of the pool and writes it back
  lazily (``engine.py:1046``); the port's verify reads and writes the
  pool itself, so there is nothing to flush (:meth:`Engine.flush_kv` is
  a no-op) and a swap or export reads the pool as it stands.
* ``KVB1`` frames carry a bf16 leaf as JAX writes it, the 2-byte payload
  under ``ml_dtypes``' dtype string ``<V2``; the port reads such rows
  back by their bits, without ``ml_dtypes``.

The other model families raise ``NotImplementedError`` naming the
ROADMAP.md item that adds them.
"""
from __future__ import annotations

import dataclasses
import itertools
import struct
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.cluster.metrics import MetricsRegistry
from repro_torch.cluster.tracing import (NULL_SPAN, annotate,
                                         current_recorder, current_tracer)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving.kvpool import (NULL_BLOCK, BlockAllocator,
                                        PoolExhausted, hash_token_blocks_memo,
                                        pack_block_arrays, padded_table,
                                        unpack_block_arrays)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512              # cache length per slot
    slots: int = 4                  # decode batch size (continuous batching)
    fused: bool = True              # on-device K-step loop + in-jit sampling
    sync_every: int = 8             # K: decode steps per host sync (fused)
    temperature: float = 0.0        # 0.0 -> greedy argmax (in-jit either way)
    seed: int = 0                   # sampling rng seed (temperature > 0)
    # Pad prompts up to power-of-two buckets so several queued requests
    # prefill in one call.  Auto-gated: recurrent archs (SSM/RG-LRU) would
    # absorb pads into their state, MoE capacity couples batch rows, and
    # ring (windowed) caches could evict real K/V — those families keep the
    # exact-length path (same-length prompts still batch there).
    prefill_bucketing: bool = True
    min_bucket: int = 8             # smallest prefill bucket (pad-tolerant)
    # Paged KV cache (serving/kvpool.py): K/V live in a shared block pool
    # instead of one dense max_len stripe per slot, so per-replica session
    # capacity is bounded by *tokens in flight*, not slots x max_len.
    paged: bool = False
    block_size: int = 16            # tokens per KV block
    # usable pool blocks; 0 -> slots * (max_len / block_size), i.e. the
    # same token capacity the dense layout reserves.
    kv_blocks: int = 0
    prefix_cache: bool = True       # content-hashed full-block prompt reuse
    # Speculative multi-token decode (paged + greedy only).
    speculative: bool = False
    spec_draft: int = 3             # drafted tokens per verify window
    # KV lifecycle (paged only): preempt and swap whole sessions under
    # block-pool pressure instead of completing them as kv_pool_exhausted.
    kv_swap: bool = False
    swap_tier: str = "host"         # "host" (in-request bytes) | "artifact"

    def __post_init__(self):
        if self.fused and self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got "
                             f"{self.sync_every}: a 0-step fused loop would "
                             f"spin without ever finishing a request")
        if not self.fused and self.temperature:
            raise ValueError("the reference (fused=False) path decodes "
                             "greedy-only; temperature sampling requires "
                             "the fused engine")
        if self.paged:
            if not self.fused:
                raise ValueError("paged=True requires the fused engine; "
                                 "the per-token reference loop is dense-"
                                 "only (it is the parity oracle)")
            if self.block_size < 1 or self.max_len % self.block_size:
                raise ValueError(
                    f"block_size ({self.block_size}) must divide max_len "
                    f"({self.max_len}): equal virtual cache length is what "
                    f"makes the paged path token-exact vs the dense oracle")
        if self.speculative:
            if not self.paged:
                raise ValueError("speculative=True requires paged=True: "
                                 "the draft/verify loop runs as a batched "
                                 "extend over the paged block pool")
            if self.temperature:
                raise ValueError("speculative decode is greedy-only: the "
                                 "accepted-prefix emission is token-exact "
                                 "only under argmax (temperature == 0)")
            if self.spec_draft < 1:
                raise ValueError(f"spec_draft must be >= 1, got "
                                 f"{self.spec_draft}")
        if self.kv_swap and not self.paged:
            raise ValueError("kv_swap=True requires paged=True: swap "
                             "serializes KV *blocks*; the dense layout "
                             "has no block granularity to preempt at")
        if self.swap_tier not in ("host", "artifact"):
            raise ValueError(f"swap_tier must be 'host' or 'artifact', "
                             f"got {self.swap_tier!r}")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int                    # decoded-token budget (prefill token free)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""         # "max_new" | "max_len" once done
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0
    # streaming: called at every host sync with the tokens that sync
    # produced — on_tokens(req, new_tokens, done)
    on_tokens: Optional[Callable[["Request", List[int], bool], None]] = None
    # tracing: the engine-side request span and the context batch spans
    # parent on
    trace_span: Any = None
    trace_ctx: Any = None
    # chained prefix-cache block hashes, computed at submit() time
    block_hashes: Optional[List[bytes]] = None
    # KV-swap preemption order (lower preempts first)
    priority: int = 0
    # set while the request is swapped out (see SessionSnapshot)
    kv_snapshot: Optional["SessionSnapshot"] = None
    # resilience: absolute time.monotonic() deadline, and a cancel poller
    # checked each host sync; either finishes the session early
    deadline_s: Optional[float] = None
    cancel_cb: Optional[Callable[[], bool]] = None

    @property
    def decoded(self) -> int:
        """Tokens produced by decode steps (excludes the prefill sample)."""
        return max(len(self.out_tokens) - 1, 0)


@dataclasses.dataclass
class SessionSnapshot:
    """Everything a preempted session needs to resume block-exact: pool
    rows covering ``[0, pos)`` (inline ``data`` or an artifact ``digest``)
    and the loop scalars."""
    pos: int
    rem: int
    last_tok: int
    n_blocks: int
    data: Optional[bytes] = None
    digest: Optional[str] = None


def pad_tolerant(cfg, max_len: int) -> bool:
    """Can this arch prefill right-padded prompts exactly?  False for
    SSM/RG-LRU (state absorbs pads), MoE (capacity couples rows) and ring
    windows (pads could evict real K/V)."""
    for g in cfg.groups:
        for kind in g.pattern:
            if kind in ("S", "R", "M"):
                return False
            if kind == "L" and cfg.window and cfg.window < max_len:
                return False
    return True


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


#: the dtype string of a bf16 leaf in a ``KVB1`` frame: ``ml_dtypes``'
#: bfloat16, as numpy names it in a JAX export; plain numpy has no dtype
#: that prints so (a 2-byte void is ``|V2``)
_BF16_TAG = b"<V2"


def _pack_rows(rows) -> bytes:
    """:func:`pack_block_arrays` of pool rows (CPU tensors, one per cache
    leaf), byte for byte the frame the JAX engine writes for the same
    rows: a bf16 leaf goes as its 2-byte payload, packed as ``<i2`` and
    retagged ``<V2`` (an entry starts with its dtype string's 2-byte
    length, then the string)."""
    entries = []
    for t in rows:
        if t.dtype == torch.bfloat16:
            e = pack_block_arrays([t.view(torch.int16).numpy()])[8:]
            e = e[:2] + _BF16_TAG + e[2 + len(_BF16_TAG):]
        else:
            e = pack_block_arrays([t.numpy()])[8:]
        entries.append(e)
    return pack_block_arrays([])[:4] + struct.pack("<I", len(entries)) + \
        b"".join(entries)


def _rows_tensor(a: np.ndarray) -> torch.Tensor:
    """A frame's array as a tensor: a 2-byte void array (a bf16 leaf read
    without ``ml_dtypes``) becomes bfloat16 by its bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class _PromptTooLong(ValueError):
    """A prompt no allocation could ever satisfy (needs more blocks than
    the whole pool): rejected per-request, never raised out of step()."""


class EngineFns:
    """The engine's device functions for one ``(cfg, scfg)``: the dense and
    paged batched admits, the K-step decode loop and its speculative form,
    the copy-on-write block copy, the KV rows' export and import, and the
    reference path's prefill and decode.  They update the engine's device
    state in place."""

    def __init__(self, cfg, scfg: ServeConfig):
        self.cfg, self.scfg = cfg, scfg
        self.pad_ok = pad_tolerant(cfg, scfg.max_len)
        # MoE expert capacity couples batch rows: admitting several
        # prompts at once would change each one's routing against the
        # reference path's batch-1 prefill, so MoE admits stay batch-1,
        # and speculation, whose verify windows would change the decode
        # batch, is off (``engine.py:262-267``, ``:336-341``)
        self.row_coupled = any(k == "M" for g in cfg.groups
                               for k in g.pattern)

    def bucket(self, plen: int) -> int:
        """Prefill bucket for a prompt (suffix) of length ``plen``."""
        if not (self.scfg.prefill_bucketing and self.pad_ok):
            return plen                       # exact-length path
        return min(max(_next_pow2(plen), self.scfg.min_bucket),
                   self.scfg.max_len)

    @staticmethod
    def insert_rows(caches, small, slots):
        """Replace the whole cache rows of ``slots`` with the prefilled
        rows of ``small``, in place, as the JAX admit writes a fresh cache
        (``engine.py:431-441``).  A leaf of ``small`` is ``(repeats, n,
        ...)``; where it is shorter than the engine's along axis 2 (K/V of
        a ``bucket`` against ``max_len``) the rest of the row is zeroed,
        and a state leaf (``conv``, ``h``) fills its row.  A ring's
        ``"pos"`` row past the prefill is -1 (no position); a prefill
        shorter than the ring made a plain stripe with no ``"pos"`` leaf,
        whose rows hold positions ``0 .. S-1``, as JAX's ring prefill of
        a fresh ring writes them (``attention.py:441-452``)."""
        for group, small_group in zip(caches, small):
            for c, sc in zip(group, small_group):
                for key, big in c.items():
                    if key == "pos" and key not in sc:
                        S = sc["k"].shape[2]
                        row = torch.arange(big.shape[2], dtype=big.dtype,
                                           device=big.device)
                        big[:, slots] = torch.where(row < S, row, -1)
                        continue
                    S = sc[key].shape[2]
                    big[:, slots, :S] = sc[key]
                    big[:, slots, S:] = -1 if key == "pos" else 0
        return caches

    def admit(self, params, tokens, meta, caches, pos, last, active,
              remaining, generator):
        """Prefill ``n`` right-padded prompts in one batch, sample their
        first tokens, insert their caches into their slots and set the
        slots' loop state (``engine.py:423-457``).

        tokens (n, bucket) · meta (3, n) = [last_idx prompt-local last
        index; slot_idx; budget].  Caches and state update in place;
        returns the first tokens (n,)."""
        scfg = self.scfg
        last_idx, slot_idx, budget = meta.unbind(0)
        n, bucket = tokens.shape
        small = tfm.init_caches(self.cfg, n, bucket, tokens.device)
        logits, small = tfm.prefill(params, self.cfg, tokens, small,
                                    last_index=last_idx)
        toks = tfm.sample_tokens(logits[:, 0], scfg.temperature, generator)
        s = slot_idx.long()
        self.insert_rows(caches, small, s)
        nxt = last_idx + 1                      # next write position
        act = (budget > 0) & (nxt < scfg.max_len - 1)
        pos[s] = nxt
        # an immediately exhausted admit parks its slot on token 0
        last[s] = torch.where(act, toks, 0)
        remaining[s] = budget
        active[s] = act
        return toks

    def prefill(self, params, tokens):
        """Exact-length batch-1 prefill of the reference path
        (``engine.py:527-538``): tokens (1, plen) -> (logits (1,1,V),
        caches of length plen)."""
        caches = tfm.init_caches(self.cfg, 1, tokens.shape[1], tokens.device)
        return tfm.prefill(params, self.cfg, tokens, caches)

    def decode(self, params, tokens, caches, pos):
        """One decode step of the reference path over the dense caches
        (``engine.py:268-269``): tokens (slots, 1), pos (slots,) ->
        (logits (slots,1,V), caches)."""
        return tfm.decode_step(params, self.cfg, tokens, caches, pos)

    def paged_admit(self, params, tokens, meta, bt, caches, pos, last,
                    active, remaining, generator, hist=None):
        """Extend ``n`` sequences by their (padded) suffix tokens through
        their block tables, sample first tokens, and set the admitted
        slots' loop state (``engine.py:473-517``).

        tokens (n, bucket) · meta (4, n) = [pos0 cached-prefix length;
        last_idx suffix-local last index; slot_idx; budget] · bt (n,
        nb_max) · hist: the speculative draft's (slots, max_len) token
        history, or None.  Pools and state update in place; returns the
        first tokens (n,)."""
        scfg = self.scfg
        pos0, last_idx, slot_idx, budget = meta.unbind(0)
        logits, _ = tfm.extend_paged(params, self.cfg, tokens, caches, pos0,
                                     bt, last_idx)
        toks = tfm.sample_tokens(logits[:, 0], scfg.temperature, generator)
        nxt = pos0 + last_idx + 1               # next write position
        act = (budget > 0) & (nxt < scfg.max_len - 1)
        s = slot_idx.long()
        if hist is not None:
            # seed the history with the suffix at its absolute positions,
            # then the first token at nxt; bucket pads land above the
            # row's position and are rewritten before a draft reads them,
            # positions past max_len are dropped, and a prefix hit's rows
            # below pos0 are backfilled by the engine
            rows = tfm.write_window(hist[s], pos0, tokens)
            hist[s] = tfm.write_window(rows, nxt, toks[:, None])
        pos[s] = nxt
        # an immediately exhausted admit parks its slot on token 0
        last[s] = torch.where(act, toks, 0)
        remaining[s] = budget
        active[s] = act
        return toks

    def decode_loop(self, params, bt, caches, pos, last, active, remaining,
                    generator):
        """K decode steps over the dense caches (``bt`` None) or through
        the block pool (``engine.py:280-301``); returns the packed
        ``[tokens | emitted | active | remaining]`` (slots, K+3) tensor so
        the host sync is one device-to-host copy."""
        scfg = self.scfg
        out, em, *_ = tfm.decode_loop(
            params, self.cfg, caches, pos, last, active, remaining,
            generator, k=scfg.sync_every, max_len=scfg.max_len,
            temperature=scfg.temperature, bt=bt)
        return torch.cat([out, em[:, None], active[:, None].to(out.dtype),
                          remaining[:, None]], dim=1)

    def spec_decode_loop(self, params, bt, caches, hist, pos, last, active,
                         remaining):
        """K speculative verify iterations through the block pool
        (``engine.py:343-356``); returns the packed ``[tokens | emitted |
        accepted | proposed]`` (slots, K*(d+1)+3) tensor, the two stats
        broadcast down their columns, so the host sync stays one
        device-to-host copy."""
        scfg = self.scfg
        out, em, stats, *_ = tfm.spec_decode_loop(
            params, self.cfg, caches, hist, pos, last, active, remaining,
            k=scfg.sync_every, d=scfg.spec_draft, max_len=scfg.max_len,
            bt=bt)
        return torch.cat([out, em[:, None],
                          stats[None, :].expand(out.shape[0], 2)], dim=1)

    @staticmethod
    def cow(caches, src, dst):
        """Copy-on-write, in place: ``pool[dst[i]] = pool[src[i]]`` for
        every layer's K/V pool (``engine.py:364-372``)."""
        for pool in EngineFns.pools(caches):
            pool[:, dst] = pool[:, src]
        return caches

    @staticmethod
    def pools(caches):
        """Every K/V pool in ``jax.tree_util.tree_leaves`` order: groups,
        then pattern positions, then ``"kp"`` before ``"vp"``."""
        return [c[key] for group in caches for c in group for key in sorted(c)]

    @staticmethod
    def kv_export(caches, ids):
        """Pool rows ``ids`` of every pool, one ``(repeats, len(ids), bs,
        KV, hd)`` tensor a leaf (``engine.py:374-382``)."""
        return [pool[:, ids] for pool in EngineFns.pools(caches)]

    @staticmethod
    def kv_import(caches, ids, rows):
        """Write ``rows`` (one tensor a leaf) into pool rows ``ids``, in
        place and cast to the pool's dtype (``engine.py:383-391``)."""
        for pool, r in zip(EngineFns.pools(caches), rows):
            pool[:, ids] = r.to(pool.dtype)
        return caches


class Engine:
    def __init__(self, params, cfg, scfg: ServeConfig,
                 metrics: Optional[MetricsRegistry] = None, device="cuda"):
        self.device = resolve_device(device)
        if cfg.family == "encdec":
            raise NotImplementedError("Engine serves decoder-LM families")
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.fns = EngineFns(cfg, scfg)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # only families whose whole cache is position-addressed K/V page;
        # the SSM state serves dense, observably (``engine.py:556-561``)
        self.paged = scfg.paged and tfm.paged_supported(cfg, scfg.max_len)
        if scfg.paged and not self.paged:
            self.metrics.counter("engine.paged_fallback_dense").inc()
        if self.paged:
            bs = scfg.block_size
            self.nb_max = scfg.max_len // bs
            n_blocks = scfg.kv_blocks or scfg.slots * self.nb_max
            self.caches = tfm.init_paged_caches(cfg, n_blocks, bs,
                                                self.device)
            self.alloc = BlockAllocator(n_blocks, bs)
            self.alloc.on_evict = lambda bid: current_recorder().record(
                "kv_evict", block=bid)
            self._seq_of_slot: List[Optional[int]] = [None] * scfg.slots
            self._bt = np.zeros((scfg.slots, self.nb_max), np.int32)
            self._pos_h = np.zeros((scfg.slots,), np.int64)
            self._rem_h = np.zeros((scfg.slots,), np.int64)
            self._act_h = np.zeros((scfg.slots,), bool)
            # device copy of the block table, cut to the bucketed width
            # that covers every position the next sync can write; host
            # mutations set the dirty flag and the next sync re-uploads
            self._bt_dev = None
            self._bt_width = 0
            self._bt_dirty = True
            # swap_tier="artifact": the content-addressed store of swapped
            # block payloads, made at first use (the host tier keeps the
            # bytes in the request)
            self._swap_store = None
            self.metrics.gauge("engine.kv_blocks_total").set(n_blocks)
            self._kv_gauges()
        else:
            self.caches = tfm.init_caches(cfg, scfg.slots, scfg.max_len,
                                          self.device)
        # speculative decode needs the paged pool and a family whose
        # batch rows do not couple; a fallback is silent but counted
        # (``engine.py:598-606``).  Brownout L1 clears the attribute at
        # run time; the history stays and keeps being seeded at admits.
        self.speculative = self.paged and scfg.speculative and \
            not self.fns.row_coupled
        if scfg.speculative and not self.speculative:
            self.metrics.counter("engine.spec_fallback").inc()
        # the n-gram draft's token history: row s holds slot s's sequence
        # at its absolute positions
        self._hist = torch.zeros((scfg.slots, scfg.max_len),
                                 dtype=torch.int32, device=self.device) \
            if self.speculative else None
        self.active: List[Optional[Request]] = [None] * scfg.slots
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        if scfg.fused:
            # device-resident loop state, advanced in place by EngineFns
            z = dict(device=self.device)
            self._pos = torch.zeros((scfg.slots,), dtype=torch.int32, **z)
            self._last = torch.zeros((scfg.slots,), dtype=torch.int32, **z)
            self._active = torch.zeros((scfg.slots,), dtype=torch.bool, **z)
            self._remaining = torch.zeros((scfg.slots,), dtype=torch.int32,
                                          **z)
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(scfg.seed)
        else:
            self.pos = np.zeros((scfg.slots,), np.int32)
        # monotonic request ids, never reused
        self._rids = itertools.count(1000)
        # flipped by the first submit carrying a deadline or cancel_cb;
        # keeps the per-step resilience sweep off the hot path otherwise
        self._watch_early = False

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int,
               on_tokens: Optional[Callable] = None,
               trace_ctx: Any = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               cancel_cb: Optional[Callable[[], bool]] = None) -> Request:
        req = Request(rid=next(self._rids),
                      prompt=np.asarray(prompt, np.int32), max_new=max_new,
                      submit_t=time.perf_counter(), on_tokens=on_tokens,
                      priority=priority, deadline_s=deadline_s,
                      cancel_cb=cancel_cb)
        if deadline_s is not None or cancel_cb is not None:
            self._watch_early = True
        if self.paged and self.scfg.prefix_cache:
            # sha256 prefix-chain hashing runs here, off the admit path,
            # memoized across identical prompts
            req.block_hashes = hash_token_blocks_memo(
                req.prompt, self.scfg.block_size)
        sp = current_tracer().span("engine.request", parent=trace_ctx,
                                   rid=req.rid, prompt_len=len(req.prompt),
                                   max_new=max_new)
        if sp.recording:
            req.trace_span = sp
            req.trace_ctx = sp.ctx
        self.queue.append(req)
        return req

    def _emit(self, req: Request, toks: List[int], done: bool):
        """Per-sync streaming callback; a throwing consumer must not take
        the engine (and every other slot's request) down with it."""
        if req.on_tokens is None:
            return
        try:
            req.on_tokens(req, list(toks), done)
        except Exception:
            self.metrics.counter("engine.stream_errors").inc()

    def _kv_gauges(self):
        self.metrics.gauge("engine.kv_blocks_free").set(
            self.alloc.free_blocks)
        self.metrics.gauge("engine.kv_blocks_cached").set(
            self.alloc.cached_blocks)

    def _close_span(self, req: Request):
        if req.trace_span is not None:
            req.trace_span.tag(finish=req.finish_reason,
                               decoded=req.decoded)
            req.trace_span.end()
            req.trace_span = None

    def _finish(self, slot: int, reason: str):
        req = self.active[slot]
        req.done = True
        req.finish_reason = reason
        req.done_t = time.perf_counter()
        self._close_span(req)
        self.finished.append(req)
        self.active[slot] = None
        if self.paged:
            # release the sequence's blocks (cached prefix blocks survive
            # via the prefix cache's own reference) and null the table row
            # so the still-stepping device loop can write nothing real; the
            # freed blocks may be re-allocated in this very sync, so the
            # device copy of the table must be re-uploaded
            sid = self._seq_of_slot[slot]
            if sid is not None:
                self.alloc.free_seq(sid)
                self._seq_of_slot[slot] = None
                self._bt[slot] = NULL_BLOCK
                self._bt_dirty = True
            self._kv_gauges()
        self.metrics.counter("engine.requests").inc()
        self.metrics.counter("engine.tokens").inc(req.decoded)
        if reason == "max_len":
            self.metrics.counter("engine.truncated").inc()
        self.metrics.histogram("engine.ttft_s").observe(
            req.first_token_t - req.submit_t)
        self.metrics.histogram("engine.latency_s").observe(
            req.done_t - req.submit_t)

    def _seat(self, slot: int, req: Request, tok: int, now: float):
        """Seat an admitted request in its slot with its first token; it
        finishes at once when it has no budget or its prompt fills the
        cache (``engine.py:778-786``)."""
        req.out_tokens.append(tok)
        req.first_token_t = now
        self.active[slot] = req
        if req.max_new <= 0:
            self._finish(slot, "max_new")
        elif len(req.prompt) >= self.scfg.max_len - 1:
            self._finish(slot, "max_len")
        self._emit(req, req.out_tokens[-1:], req.done)

    def _batch_ctx(self):
        """Trace parent for a decode-sync span: the first traced active
        request (one span serves the whole shared batch)."""
        return next((r.trace_ctx for r in self.active
                     if r is not None and r.trace_ctx is not None), None)

    # ------------------------------------------------------------------
    # admits: prefill only the suffix a prefix-cache hit leaves uncovered
    def _prep_paged(self, req: Request):
        """Plan one admit without side effects: prefix hits, suffix shape,
        and the block headroom it would need.  None == cannot admit now."""
        bs = self.scfg.block_size
        plen = len(req.prompt)
        if not self.scfg.prefix_cache:
            hashes: List[bytes] = []
        elif req.block_hashes is not None:      # hashed at submit()
            hashes = req.block_hashes
        else:                                   # hand-built request
            hashes = hash_token_blocks_memo(req.prompt, bs)
        # reuse covers at most plen-1 tokens: the last prompt token must be
        # recomputed so the admit has logits to sample the first output
        reusable = hashes[:max(plen - 1, 0) // bs]
        hits = self.alloc.prefix_lookup(reusable)
        n_cached_tok = len(hits) * bs
        need = -(-plen // bs) - len(hits) + 1      # +1 decode-ahead block
        if need > self.alloc.num_blocks:
            raise _PromptTooLong(
                f"prompt of {plen} tokens needs {need} KV blocks but the "
                f"pool has only {self.alloc.num_blocks}: raise kv_blocks "
                f"or shorten the prompt")
        if need > self.alloc.available_excluding(hits):
            return None
        return (hashes, hits, n_cached_tok, plen - n_cached_tok)

    def _reject_oversized(self, req: Request, detail: str):
        """Fail just the unservable request, never the batch it queued
        with: it completes empty with an explicit finish reason."""
        req.done = True
        req.finish_reason = "rejected_prompt_too_long"
        req.done_t = req.first_token_t = time.perf_counter()
        self._close_span(req)
        self.finished.append(req)
        self.metrics.counter("engine.rejected_too_long").inc()
        self._emit(req, [], True)

    def _admit_paged(self):
        scfg = self.scfg
        free = [s for s in range(scfg.slots) if self.active[s] is None]
        while free and self.queue:
            if self.queue[0].kv_snapshot is not None:
                # a preempted session resumes by block import, never by
                # prefill; deferring it keeps FIFO (nothing behind it may
                # overtake the resume)
                if self._try_restore(free):
                    continue
                self.metrics.counter("engine.admit_deferred_kv").inc()
                break
            try:
                prep = self._prep_paged(self.queue[0])
            except _PromptTooLong as e:
                self._reject_oversized(self.queue.popleft(), str(e))
                continue
            if prep is None:
                # pool pressure: leave the queue intact
                self.metrics.counter("engine.admit_deferred_kv").inc()
                break
            bucket = self.fns.bucket(prep[3])
            max_admit = 1 if self.fns.row_coupled else len(free)
            # pop-and-commit one request at a time so each headroom probe
            # sees the blocks its batch-mates already claimed
            rows = []
            while prep is not None and len(rows) < max_admit and \
                    self.fns.bucket(prep[3]) == bucket:
                req = self.queue.popleft()
                hashes, hits, n_cached_tok, suffix_len = prep
                plen = len(req.prompt)
                slot = free[len(rows)]
                sid = self.alloc.new_seq()
                self.alloc.append_shared(sid, hits)
                self.alloc.extend_to(sid, plen)
                self._seq_of_slot[slot] = sid
                self._bt[slot] = padded_table(self.alloc.table(sid),
                                              self.nb_max)
                self._bt_dirty = True
                self._pos_h[slot] = plen
                self._rem_h[slot] = max(req.max_new, 0)
                self._act_h[slot] = req.max_new > 0 and \
                    plen < scfg.max_len - 1
                self.metrics.counter("engine.prefix_hit_blocks").inc(
                    len(hits))
                self.metrics.counter("engine.prefix_lookup_blocks").inc(
                    max(plen - 1, 0) // scfg.block_size)
                self.metrics.counter("engine.prefill_tokens_saved").inc(
                    n_cached_tok)
                rows.append((req, slot, sid, hashes, n_cached_tok,
                             suffix_len))
                try:
                    # a snapshot-carrying head never joins a prefill
                    # batch: the outer loop restores it
                    prep = self._prep_paged(self.queue[0]) \
                        if self.queue and \
                        self.queue[0].kv_snapshot is None else None
                except _PromptTooLong:
                    # the head of the next admit loop rejects it, after
                    # this batch's extend has run
                    prep = None
            n = len(rows)
            free = free[n:]
            tokens = np.zeros((n, bucket), np.int32)
            meta = np.zeros((4, n), np.int32)   # pos0, last_idx, slot, budget
            bt = np.zeros((n, self.nb_max), np.int32)
            for j, (req, slot, sid, hashes, n_cached_tok, suffix_len) in \
                    enumerate(rows):
                tokens[j, :suffix_len] = req.prompt[n_cached_tok:]
                meta[:, j] = (n_cached_tok, suffix_len - 1, slot,
                              max(req.max_new, 0))
                bt[j] = self._bt[slot]
            hit_toks = sum(r[4] for r in rows)
            asp = current_tracer().span(
                "engine.admit",
                parent=next((r[0].trace_ctx for r in rows
                             if r[0].trace_ctx is not None), None),
                bucket=bucket, n=n, rids=[r[0].rid for r in rows],
                prefix_hit_tokens=hit_toks,
                kv_blocks_free=self.alloc.free_blocks)
            current_recorder().record(
                "admit", rids=[r[0].rid for r in rows], bucket=bucket,
                n=n, prefix_hit_tokens=hit_toks)
            _qh = self.metrics.histogram("engine.queue_wait_s")
            _now = time.perf_counter()
            for r in rows:
                _qh.observe(_now - r[0].submit_t)
            psp = current_tracer().span("engine.prefill", parent=asp,
                                        bucket=bucket, n=n)
            with annotate("prefill"):
                dev = self.device
                toks = self.fns.paged_admit(
                    self.params, torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(meta).to(dev),
                    torch.from_numpy(bt).to(dev), self.caches, self._pos,
                    self._last, self._active, self._remaining, self._gen,
                    self._hist)
                toks_h = toks.cpu().numpy()
            psp.end()
            now = time.perf_counter()
            for j, (req, slot, sid, hashes, n_cached_tok, suffix_len) in \
                    enumerate(rows):
                plen = len(req.prompt)
                if self._hist is not None and n_cached_tok:
                    # a prefix hit skips the extend for the cached tokens,
                    # so the admit's seeding never saw them
                    self._hist[slot, :n_cached_tok] = torch.from_numpy(
                        req.prompt[:n_cached_tok]).to(dev)
                if scfg.prefix_cache:
                    # every *full* prompt block is now written and
                    # immutable (decode writes start at plen) — publish it
                    n_full = plen // scfg.block_size
                    self.alloc.prefix_insert(hashes[:n_full],
                                             self.alloc.table(sid)[:n_full])
                self._seat(slot, req, int(toks_h[j]), now)
            asp.end()
            self.metrics.counter("engine.prefill_batches").inc()
            self._kv_gauges()

    def _exhaust_victim(self, slot: int):
        """PoolExhausted mid-decode: complete this slot's request with
        ``finish_reason="kv_pool_exhausted"`` and free its blocks instead
        of raising out of ``step()``; the freed blocks can satisfy later
        slots in this very sync."""
        req = self.active[slot]
        self.metrics.counter("engine.kv_pool_exhausted").inc()
        current_recorder().record("kv_pool_exhausted", rid=req.rid,
                                  slot=slot, pos=int(self._pos_h[slot]))
        self._active[slot] = False
        self._last[slot] = 0
        self._act_h[slot] = False
        self._finish(slot, "kv_pool_exhausted")
        self._emit(req, [], True)

    # ------------------------------------------------------------------
    # resilience: deadline expiry + cancellation, at step boundaries
    @staticmethod
    def _early_reason(req: Request, now: float) -> Optional[str]:
        if req.cancel_cb is not None:
            try:
                if req.cancel_cb():
                    return "cancelled"
            except Exception:           # noqa: BLE001 - poller's bug
                pass                    # a broken poller must not kill step()
        if req.deadline_s is not None and now > req.deadline_s:
            return "deadline"
        return None

    def _finish_early(self, slot: int, reason: str):
        """End an *active* slot mid-decode with ``reason``; on the paged
        path this frees its blocks inside the current sync."""
        req = self.active[slot]
        if self.scfg.fused:
            self._active[slot] = False
            self._last[slot] = 0
        if self.paged:
            self._act_h[slot] = False
        self._finish(slot, reason)
        self._emit(req, [], True)

    def _sweep_expired(self):
        """Complete queued work that is already pointless (expired in queue
        / cancelled before admit) without it ever taking a slot, then end
        active sessions whose deadline passed or whose submitter
        cancelled."""
        now = time.monotonic()
        if self.queue:
            keep: Deque[Request] = deque()
            for req in self.queue:
                reason = self._early_reason(req, now)
                if reason is None:
                    keep.append(req)
                    continue
                req.done = True
                req.finish_reason = reason
                req.done_t = req.first_token_t = time.perf_counter()
                self._close_span(req)
                self.finished.append(req)
                self.metrics.counter(
                    "engine.cancelled" if reason == "cancelled"
                    else "engine.deadline_expired").inc()
                current_recorder().record(
                    reason if reason == "cancelled" else "deadline_expired",
                    rid=req.rid, where="engine_queue")
                self._emit(req, [], True)
            self.queue = keep
        for s, req in enumerate(self.active):
            if req is None:
                continue
            reason = self._early_reason(req, now)
            if reason is None:
                continue
            self.metrics.counter(
                "engine.cancelled" if reason == "cancelled"
                else "engine.deadline_expired").inc()
            current_recorder().record(
                reason if reason == "cancelled" else "deadline_expired",
                rid=req.rid, where="mid_decode", decoded=req.decoded)
            self._finish_early(s, reason)

    # ------------------------------------------------------------------
    # KV lifecycle (``engine.py:1183-1441``): preemption and swap under
    # pool pressure (ServeConfig.kv_swap) and the drain-time export /
    # import of the prefix cache.  Both pin the blocks, gather their rows
    # from the pool in one call and pack them as one KVB1 frame; the pool
    # is always current, so nothing is flushed first.
    def _swap_payload_store(self):
        if self._swap_store is None:
            # imported here: artifacts -> backends -> engine is a cycle at
            # module scope
            from repro_torch.cluster.artifacts import ArtifactStore
            self._swap_store = ArtifactStore()
        return self._swap_store

    def _gather_block_rows(self, blocks: List[int]) -> bytes:
        """Serialize pool rows ``blocks`` (the caller pinned them)."""
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        return _pack_rows([r.cpu() for r in
                           self.fns.kv_export(self.caches, ids)])

    def _scatter_block_rows(self, blocks: List[int], arrays) -> None:
        """Write serialized rows (one array per cache leaf, block axis 1)
        into pool blocks ``blocks``."""
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        self.fns.kv_import(self.caches, ids,
                           [_rows_tensor(a).to(self.device) for a in arrays])

    def _wave_hi(self, s: int, adv: int, d: int) -> int:
        """Highest position (exclusive) slot ``s`` can write this sync;
        under speculation the last verify window writes up to d+1 rows
        past the final emitted position."""
        max_len = self.scfg.max_len
        hi = int(self._pos_h[s]) + min(adv, int(self._rem_h[s]))
        if d:
            return min(min(hi, max_len - 1) + d + 1, max_len)
        return min(hi, max_len)

    def _swap_demand(self, s: int, adv: int, d: int) -> int:
        """Blocks slot ``s`` will claim this sync: fresh allocations plus
        COW copies of shared blocks in its write range."""
        bs = self.scfg.block_size
        table = self.alloc.table(self._seq_of_slot[s])
        lo = int(self._pos_h[s])
        hi = self._wave_hi(s, adv, d)
        fresh = max(-(-hi // bs) - len(table), 0)
        shared = sum(1 for j in range(lo // bs, min(-(-hi // bs),
                                                    len(table)))
                     if self.alloc.refcount(table[j]) > 1)
        return fresh + shared

    def _swap_out(self, slot: int):
        """Preempt ``slot``: serialize its blocks off the card, free them,
        and requeue the request at the queue's front with a
        :class:`SessionSnapshot`, so it resumes ahead of requests never
        admitted as soon as headroom returns."""
        req = self.active[slot]
        sid = self._seq_of_slot[slot]
        pos = int(self._pos_h[slot])
        blocks = self.alloc.table(sid)[:-(-pos // self.scfg.block_size)] \
            if pos else []
        snap = SessionSnapshot(
            pos=pos, rem=int(self._rem_h[slot]),
            last_tok=req.out_tokens[-1] if req.out_tokens else 0,
            n_blocks=len(blocks))
        if blocks:
            self.alloc.pin(blocks)
            try:
                data = self._gather_block_rows(blocks)
            finally:
                self.alloc.unpin(blocks)
            if self.scfg.swap_tier == "artifact":
                snap.digest = self._swap_payload_store().put_bytes(data)
            else:
                snap.data = data
        req.kv_snapshot = snap
        self.queue.appendleft(req)
        self.active[slot] = None
        self.alloc.free_seq(sid)
        self._seq_of_slot[slot] = None
        self._bt[slot] = NULL_BLOCK
        self._bt_dirty = True
        self._act_h[slot] = False
        self._active[slot] = False
        self._last[slot] = 0
        self.metrics.counter("engine.kv_swap_out").inc()
        self.metrics.counter("engine.kv_swapped_blocks").inc(len(blocks))
        current_recorder().record("kv_swap_out", rid=req.rid, slot=slot,
                                  pos=pos, blocks=len(blocks))
        self._kv_gauges()

    def _preempt_for_headroom(self, adv: int, d: int):
        """While this sync's worst-case block demand exceeds the pool,
        preempt the lowest ``(priority, -rid)`` active session (lowest
        priority first; ties to the newest request).  Runs before any
        table changes, so exports see consistent tables and no COW pair
        names a freed block.  A lone survivor is never preempted: if it
        still cannot fit, :meth:`_exhaust_victim` applies."""
        while True:
            live = [(r.priority, -r.rid, s)
                    for s, r in enumerate(self.active) if r is not None]
            if len(live) <= 1:
                return
            demand = sum(self._swap_demand(s, adv, d) for _, _, s in live)
            if demand <= self.alloc.available_blocks:
                return
            self._swap_out(min(live)[2])

    def _try_restore(self, free: List[int]) -> bool:
        """The queue's head is a swapped-out session: re-admit it by
        importing its blocks.  True: handled (restored into a slot, or
        finished as unrestorable); False: deferred on pool pressure, the
        queue intact."""
        req = self.queue[0]
        snap = req.kv_snapshot
        need = snap.n_blocks + 1            # +1 decode-ahead block
        if need > self.alloc.num_blocks:
            # no state of this pool can restore it: finish it alone
            self.queue.popleft()
            req.kv_snapshot = None
            self.metrics.counter("engine.kv_pool_exhausted").inc()
            current_recorder().record("kv_pool_exhausted", rid=req.rid,
                                      pos=snap.pos, at="restore")
            req.done = True
            req.finish_reason = "kv_pool_exhausted"
            req.done_t = time.perf_counter()
            self._close_span(req)
            self.finished.append(req)
            self._emit(req, [], True)
            return True
        if need > self.alloc.available_blocks:
            return False
        slot = free.pop(0)
        self.queue.popleft()
        data = snap.data if snap.data is not None \
            else self._swap_payload_store().read_bytes(snap.digest)
        sid = self.alloc.new_seq()
        self.alloc.extend_to(sid, snap.pos)
        table = self.alloc.table(sid)
        if snap.n_blocks:
            self._scatter_block_rows(table, unpack_block_arrays(data))
        self._seq_of_slot[slot] = sid
        self._bt[slot] = padded_table(table, self.nb_max)
        self._bt_dirty = True
        pos = snap.pos
        self._pos_h[slot] = pos
        self._rem_h[slot] = snap.rem
        alive = snap.rem > 0 and pos < self.scfg.max_len - 1
        self._act_h[slot] = alive
        self._pos[slot] = pos
        self._last[slot] = snap.last_tok if alive else 0
        self._remaining[slot] = max(snap.rem, 0)
        self._active[slot] = alive
        if self._hist is not None:
            # rebuild the draft history: the prompt, then every token
            # emitted so far (hist[pos] == last_tok)
            toks = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens, np.int32)]
            )[:self.scfg.max_len]
            self._hist[slot, :len(toks)] = torch.from_numpy(toks).to(
                self.device)
        self.active[slot] = req
        req.kv_snapshot = None
        self.metrics.counter("engine.kv_swap_in").inc()
        current_recorder().record("kv_swap_in", rid=req.rid, slot=slot,
                                  pos=pos, blocks=snap.n_blocks)
        if not alive:
            self._finish(slot, "max_new" if snap.rem <= 0 else "max_len")
        self._kv_gauges()
        return True

    # ------------------------------------------------------------------
    # warm migration: the drain-time hand-off of the prefix cache's
    # published blocks to a session's new home (the router ships the
    # frame; the replica loop calls these between batches)
    def export_kv_state(self) -> Optional[dict]:
        """The prefix cache, ``(chained hash, block rows)`` in LRU order,
        as one picklable frame, or None when there is nothing to ship
        (dense engine, empty cache).  Published blocks are immutable
        (decode copies before writing), and pins keep eviction away while
        the rows are read."""
        if not self.paged:
            return None
        items = self.alloc.prefix_items()
        if not items:
            return None
        blocks = [b for _, b in items]
        self.alloc.pin(blocks)
        try:
            data = self._gather_block_rows(blocks)
        finally:
            self.alloc.unpin(blocks)
        self.metrics.counter("engine.kv_export_blocks").inc(len(blocks))
        current_recorder().record("kv_export", blocks=len(blocks))
        return {"kind": "kv_blocks", "block_size": self.scfg.block_size,
                "hashes": [h for h, _ in items], "data": data}

    def import_kv_state(self, state) -> int:
        """Adopt a migrated replica's prefix blocks: every unseen hash
        binds a free block (never evicting, so admission headroom never
        shrinks) and the shipped rows are written into the pool.
        Idempotent: cached hashes are skipped.  Returns the number of
        adopted blocks."""
        if not self.paged or not isinstance(state, dict) \
                or state.get("kind") != "kv_blocks" \
                or state.get("block_size") != self.scfg.block_size:
            return 0
        arrays = unpack_block_arrays(state["data"])
        ids: List[int] = []
        cols: List[int] = []
        for i, h in enumerate(state["hashes"]):
            b = self.alloc.import_cached(h)
            if b is None:
                continue
            ids.append(b)
            cols.append(i)
        if not ids:
            return 0
        sel = np.asarray(cols, np.intp)
        self._scatter_block_rows(ids, [a[:, sel] for a in arrays])
        self.metrics.counter("engine.kv_import_blocks").inc(len(ids))
        current_recorder().record("kv_import", blocks=len(ids))
        self._kv_gauges()
        return len(ids)

    def flush_kv(self):
        """Make the pool current for every live sequence: a no-op here,
        since the port's decode and verify write the pool itself (the
        JAX engine flushes its resident dense view, ``engine.py:1074``).
        Kept so callers that read ``engine.caches`` read as on JAX."""

    # ------------------------------------------------------------------
    def _step_paged(self) -> bool:
        self._admit_paged()
        if not any(r is not None for r in self.active):
            return False
        scfg = self.scfg
        d = scfg.spec_draft if self.speculative else 0
        adv = scfg.sync_every * (d + 1)   # most tokens one sync emits
        dsp = current_tracer().span(
            "engine.decode_sync", parent=self._batch_ctx(),
            k=scfg.sync_every,
            n_active=sum(r is not None for r in self.active))
        if scfg.kv_swap:
            # make room by preempting whole sessions before any table
            # changes below
            self._preempt_for_headroom(adv, d)
        # host pre-work: every active slot needs writable private blocks
        # covering every position this loop can write — allocate ahead,
        # COW any block shared with the prefix cache or a fork
        cow_src: List[int] = []
        cow_dst: List[int] = []
        max_hi = 1
        for s, req in enumerate(self.active):
            if req is None:
                continue
            sid = self._seq_of_slot[s]
            lo = int(self._pos_h[s])
            hi = self._wave_hi(s, adv, d)
            pairs = self.alloc.cow_targets(sid, lo, hi)
            try:
                fresh = self.alloc.extend_to(sid, hi)
            except PoolExhausted:
                # the victim's COW pairs are dropped with its sequence
                self._exhaust_victim(s)
                continue
            cow_src += [p[0] for p in pairs]
            cow_dst += [p[1] for p in pairs]
            if pairs or fresh:
                self._bt[s] = padded_table(self.alloc.table(sid),
                                           self.nb_max)
                self._bt_dirty = True
            max_hi = max(max_hi, hi)
        if not any(r is not None for r in self.active):
            dsp.end()
            return True
        if cow_src:
            src, dst = torch.tensor([cow_src, cow_dst], dtype=torch.long,
                                    device=self.device)
            self.fns.cow(self.caches, src, dst)
            self.metrics.counter("engine.kv_cow_copies").inc(len(cow_src))
            dsp.tag(cow_copies=len(cow_src))
            current_recorder().record("cow", n=len(cow_src))
        # cut the device table to the power-of-two block width that covers
        # every position this sync can write; the kernels walk only the
        # blocks a sequence's length needs, and a verify window never
        # reaches past it except at max_len, where the table is whole
        need = -(-max_hi // scfg.block_size)
        nbw = min(_next_pow2(need) if need > 1 else 1, self.nb_max)
        if self._bt_dirty or nbw != self._bt_width:
            self._bt_dev = torch.from_numpy(
                np.ascontiguousarray(self._bt[:, :nbw])).to(self.device)
            self._bt_width = nbw
            self._bt_dirty = False
        with annotate("decode_loop"):
            if self.speculative:
                ssp = current_tracer().span("engine.spec_decode",
                                            parent=dsp, draft_len=d)
                packed = self.fns.spec_decode_loop(
                    self.params, self._bt_dev, self.caches, self._hist,
                    self._pos, self._last, self._active, self._remaining)
            else:
                packed = self.fns.decode_loop(
                    self.params, self._bt_dev, self.caches, self._pos,
                    self._last, self._active, self._remaining, self._gen)
            hsp = current_tracer().span("engine.host_sync", parent=dsp)
            # ONE device fetch; liveness, positions and budgets advance
            # host-side by exactly the emitted counts
            packed_h = packed.cpu().numpy()
            out_h, em_h = packed_h[:, :-3], packed_h[:, -3]
            self._pos_h += em_h.astype(np.int64)
            self._rem_h -= em_h.astype(np.int64)
            self._act_h &= (self._rem_h > 0) & \
                (self._pos_h < scfg.max_len - 1)
            if self.speculative:
                acc, prop = int(packed_h[0, -2]), int(packed_h[0, -1])
                self.metrics.counter("engine.spec_proposed").inc(prop)
                self.metrics.counter("engine.spec_accepted").inc(acc)
                ssp.tag(proposed=prop, accepted=acc)
                ssp.end()
            hsp.end()
        self._emit_sync(dsp, out_h, em_h, self._act_h, self._rem_h)
        return True

    def _unpack(self, packed_h):
        """(tokens (slots, K), emitted, active, remaining) of a packed
        decode-loop result (:meth:`EngineFns.decode_loop`)."""
        k = self.scfg.sync_every
        return (packed_h[:, :k], packed_h[:, k], packed_h[:, k + 1] != 0,
                packed_h[:, k + 2])

    def _emit_sync(self, dsp, out_h, em_h, act_h, rem_h):
        """Hand each active slot the tokens of the sync that just ended
        and finish the slots that went inactive (``engine.py:816-830``)."""
        esp = current_tracer().span("engine.stream_emit", parent=dsp) \
            if any(r is not None and r.on_tokens is not None
                   for r in self.active) else NULL_SPAN
        for s, req in enumerate(self.active):
            if req is None:
                continue
            new = [int(t) for t in out_h[s, :em_h[s]]]
            req.out_tokens.extend(new)
            if not act_h[s]:
                self._finish(s, "max_new" if rem_h[s] <= 0 else "max_len")
            self._emit(req, new, req.done)
        esp.end()
        dsp.end()
        self.metrics.counter("engine.steps").inc()

    # ------------------------------------------------------------------
    # dense fused path (``engine.py:717-830``)
    def _admit_fused(self):
        scfg = self.scfg
        free = [s for s in range(scfg.slots) if self.active[s] is None]
        while free and self.queue:
            # longest same-bucket prefix of the queue (strict FIFO), up to
            # the number of free slots, prefilled as one padded batch
            bucket = self.fns.bucket(len(self.queue[0].prompt))
            batch = [self.queue.popleft()]
            # MoE rows couple through expert capacity: batch-1 admits,
            # as the reference path's
            max_admit = 1 if self.fns.row_coupled else len(free)
            while self.queue and len(batch) < max_admit and \
                    self.fns.bucket(len(self.queue[0].prompt)) == bucket:
                batch.append(self.queue.popleft())
            n = len(batch)
            slots_idx, free = free[:n], free[n:]
            tokens = np.zeros((n, bucket), np.int32)
            meta = np.zeros((3, n), np.int32)   # last_idx, slot, budget
            for j, req in enumerate(batch):
                plen = len(req.prompt)
                tokens[j, :plen] = req.prompt
                meta[:, j] = (plen - 1, slots_idx[j], max(req.max_new, 0))
            rids = [r.rid for r in batch]
            asp = current_tracer().span(
                "engine.admit",
                parent=next((r.trace_ctx for r in batch
                             if r.trace_ctx is not None), None),
                bucket=bucket, n=n, n_pad=n, rids=rids)
            current_recorder().record("admit", rids=rids, bucket=bucket, n=n)
            _qh = self.metrics.histogram("engine.queue_wait_s")
            _now = time.perf_counter()
            for r in batch:
                _qh.observe(_now - r.submit_t)
            psp = current_tracer().span("engine.prefill", parent=asp,
                                        bucket=bucket, n_pad=n)
            with annotate("prefill"):
                dev = self.device
                toks = self.fns.admit(
                    self.params, torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(meta).to(dev), self.caches, self._pos,
                    self._last, self._active, self._remaining, self._gen)
                toks_h = toks.cpu().numpy()
            psp.end()
            now = time.perf_counter()
            for j, req in enumerate(batch):
                self._seat(slots_idx[j], req, int(toks_h[j]), now)
            asp.end()
            self.metrics.counter("engine.prefill_batches").inc()

    def _step_fused(self) -> bool:
        self._admit_fused()
        if not any(r is not None for r in self.active):
            return False
        dsp = current_tracer().span(
            "engine.decode_sync", parent=self._batch_ctx(),
            k=self.scfg.sync_every,
            n_active=sum(r is not None for r in self.active))
        with annotate("decode_loop"):
            packed = self.fns.decode_loop(
                self.params, None, self.caches, self._pos, self._last,
                self._active, self._remaining, self._gen)
            # one host sync per K decode steps (sampling ran on the device)
            hsp = current_tracer().span("engine.host_sync", parent=dsp)
            out_h, em_h, act_h, rem_h = self._unpack(packed.cpu().numpy())
            hsp.end()
        self._emit_sync(dsp, out_h, em_h, act_h, rem_h)
        return True

    # ------------------------------------------------------------------
    # reference path (``engine.py:1669-1711``): one exact-length batch-1
    # prefill per admit, one host round trip per decoded token, greedy
    def _admit_reference(self):
        for slot in range(self.scfg.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                plen = len(req.prompt)
                logits, small = self.fns.prefill(
                    self.params,
                    torch.from_numpy(req.prompt[None]).to(self.device))
                self.fns.insert_rows(self.caches, small, [slot])
                self.pos[slot] = plen                 # next write position
                self._seat(slot, req, int(torch.argmax(logits[0, -1])),
                           time.perf_counter())

    def _step_reference(self) -> bool:
        self._admit_reference()
        if not any(r is not None for r in self.active):
            return False
        toks = np.zeros((self.scfg.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                toks[s, 0] = req.out_tokens[-1]
        dev = self.device
        logits, self.caches = self.fns.decode(
            self.params, torch.from_numpy(toks).to(dev), self.caches,
            torch.from_numpy(self.pos).to(dev))
        nxt = tfm.sample_tokens(logits[:, 0]).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            req.out_tokens.append(int(nxt[s]))
            if req.decoded >= req.max_new:
                self._finish(s, "max_new")
            elif self.pos[s] >= self.scfg.max_len - 1:
                self._finish(s, "max_len")
            self._emit(req, req.out_tokens[-1:], req.done)
        self.metrics.counter("engine.steps").inc()
        return True

    def fork(self, parent: Request, max_new: int,
             on_tokens: Optional[Callable] = None) -> Request:
        """Branch an active request into a new session that shares all of
        its KV blocks copy-on-write (parallel sampling, n-best;
        ``engine.py:1609-1663``).  The child continues from the parent's
        position; a shared block splits when either side writes it.
        Paged engines only; needs a free slot."""
        if not self.paged:
            raise RuntimeError("fork requires a paged engine "
                               "(ServeConfig.paged=True on a supported "
                               "family)")
        try:
            pslot = next(s for s, r in enumerate(self.active)
                         if r is parent)
        except StopIteration:
            raise ValueError(f"request {parent.rid} is not active "
                             f"(finished or still queued)") from None
        try:
            slot = next(s for s, r in enumerate(self.active) if r is None)
        except StopIteration:
            raise RuntimeError("no free slot to fork into") from None
        child = Request(rid=next(self._rids), prompt=parent.prompt.copy(),
                        max_new=max_new,
                        out_tokens=list(parent.out_tokens),
                        submit_t=time.perf_counter(), on_tokens=on_tokens)
        child.first_token_t = child.submit_t
        sid = self.alloc.fork(self._seq_of_slot[pslot])
        self._seq_of_slot[slot] = sid
        self._bt[slot] = padded_table(self.alloc.table(sid), self.nb_max)
        self._bt_dirty = True
        pos = int(self._pos_h[pslot])
        self._pos_h[slot] = pos
        self._rem_h[slot] = max(max_new, 0)
        last_tok = parent.out_tokens[-1] if parent.out_tokens else 0
        alive = max_new > 0 and pos < self.scfg.max_len - 1
        self._act_h[slot] = alive
        self._pos[slot] = pos
        self._last[slot] = last_tok if alive else 0
        self._remaining[slot] = max(max_new, 0)
        self._active[slot] = alive
        if self._hist is not None:
            self._hist[slot] = self._hist[pslot]
        self.active[slot] = child
        self.metrics.counter("engine.forks").inc()
        if not alive:
            self._finish(slot, "max_new" if max_new <= 0 else "max_len")
        self._kv_gauges()
        return child

    # ------------------------------------------------------------------
    def step(self):
        """One engine iteration: admit, then decode — ``sync_every`` steps
        with one host sync on the fused and paged paths, a single step on
        the reference path."""
        if self._watch_early:
            self._sweep_expired()
        if self.paged:
            return self._step_paged()
        if self.scfg.fused:
            return self._step_fused()
        return self._step_reference()

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
