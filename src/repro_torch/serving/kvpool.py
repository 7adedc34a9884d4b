"""Paged KV-cache subsystem: host-side block bookkeeping for the engine.

The dense engine pins one ``max_len`` KV block per decode slot, so slot
*memory* — not compute — caps how many LM sessions a replica can hold.
This module is the host half of the paged alternative:

  * the device holds one **block pool** per attention layer —
    ``(num_blocks, block_size, kv_heads, head_dim)`` for K and V — shared
    by every sequence on the engine;
  * a sequence owns a **block table**: the list of physical block ids
    backing its virtual positions ``[0, pos)``, allocated on demand as
    decode advances instead of reserved up front;
  * blocks are **refcounted** so two sequences can share physical blocks
    (a prefix-cache hit, or a :meth:`BlockAllocator.fork`), with
    **copy-on-write**: a shared block is copied to a private one before a
    sequence may write into it;
  * a **content-hashed prefix cache** maps chains of full prompt blocks
    to their physical blocks, so a shared system/task prompt is prefilled
    once and reused by every later session (the cache holds its own
    reference; cached blocks evict LRU under pool pressure).

Everything here is plain host Python — the allocator never touches jax.
The engine (``serving/engine.py``) executes the device side of each
decision: scattering prefill K/V into the pool, gathering through block
tables in the decode kernel, and copying pool rows when
:meth:`BlockAllocator.cow_targets` says a write would land on a shared
block.

Physical block 0 is reserved as the **null block**: it is never
allocated, block-table padding points at it, and masked/pad writes are
redirected into it — so a stale table entry can corrupt nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import struct
from collections import OrderedDict
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

NULL_BLOCK = 0

# Serialized-block wire format magic (pack_block_arrays). Bump the digit
# if the layout ever changes; unpack refuses unknown magics outright.
_PACK_MAGIC = b"KVB1"


def pack_block_arrays(arrays: Sequence) -> bytes:
    """Serialize a list of numpy arrays to one deterministic byte string.

    The format is self-describing and bit-exact: magic, count, then per
    array the dtype string (which includes byte order, e.g. ``<f4``), the
    shape, and the raw C-order buffer.  Pure numpy — no pickle, no jax —
    so the same bytes come out on every host and the sha256 of the
    payload is a stable content address for the ArtifactStore swap tier.
    """
    import numpy as np
    out = [_PACK_MAGIC, struct.pack("<I", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        ds = a.dtype.str.encode("ascii")
        raw = a.tobytes()
        out.append(struct.pack("<H", len(ds)))
        out.append(ds)
        out.append(struct.pack("<B", a.ndim))
        out.append(struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def unpack_block_arrays(data: bytes) -> List:
    """Inverse of :func:`pack_block_arrays`; bit-exact roundtrip."""
    import numpy as np
    if data[:4] != _PACK_MAGIC:
        raise ValueError("bad kv block payload magic")
    off = 4
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    arrays: List = []
    for _ in range(count):
        (dlen,) = struct.unpack_from("<H", data, off)
        off += 2
        dtype = np.dtype(data[off:off + dlen].decode("ascii"))
        off += dlen
        (ndim,) = struct.unpack_from("<B", data, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", data, off)
        off += 8
        a = np.frombuffer(data, dtype=dtype, count=nbytes // dtype.itemsize,
                          offset=off).reshape(shape).copy()
        off += nbytes
        arrays.append(a)
    return arrays


def hash_token_blocks(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chained content hashes of the *full* blocks of a token sequence.

    ``h_i = sha256(h_{i-1} || tokens[i*bs:(i+1)*bs])`` — chaining makes a
    block hash identify the whole prefix up to and including that block,
    which is what lets two prompts share exactly their common full-block
    prefix and nothing more.
    """
    out: List[bytes] = []
    prev = b""
    for j in range(len(tokens) // block_size):
        blk = tokens[j * block_size:(j + 1) * block_size]
        h = hashlib.sha256()
        h.update(prev)
        h.update(",".join(str(int(t)) for t in blk).encode())
        prev = h.digest()
        out.append(prev)
    return out


@functools.lru_cache(maxsize=4096)
def _hash_blocks_memo(tok_bytes: bytes, block_size: int) -> Tuple[bytes, ...]:
    import numpy as np
    tokens = np.frombuffer(tok_bytes, dtype=np.int32)
    return tuple(hash_token_blocks([int(t) for t in tokens], block_size))


def hash_token_blocks_memo(prompt, block_size: int) -> List[bytes]:
    """:func:`hash_token_blocks` over an int32 numpy prompt, memoized on
    the token bytes.  Serving workloads re-submit identical prompts (and
    identical shared prefixes hash block-by-block anyway), so the sha256
    chain — which used to run on the admit critical path every time —
    amortizes to a dict lookup.  The engine calls this at ``submit()``
    time, off the step loop entirely."""
    return list(_hash_blocks_memo(prompt.astype("int32").tobytes(),
                                  block_size))


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable: the pool cannot satisfy the
    allocation.  Admission gating on :meth:`BlockAllocator.free_blocks`
    headroom exists to make this unreachable in normal operation."""


@dataclasses.dataclass
class SeqState:
    """Host view of one sequence's paged cache."""
    seq_id: int
    table: List[int] = dataclasses.field(default_factory=list)


class BlockAllocator:
    """Free list + refcounts + per-sequence block tables + COW decisions.

    ``num_blocks`` counts *usable* blocks; the device pool has
    ``num_blocks + 1`` rows because row 0 is the reserved null block.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("need at least one usable block")
        self.block_size = block_size
        self.num_blocks = num_blocks
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._ref: Dict[int, int] = {}
        self._seqs: Dict[int, SeqState] = {}
        self._next_seq = 0
        # prefix cache: chained block hash -> physical block id.  Ordered
        # for LRU eviction (move_to_end on hit).  The cache owns one
        # reference on every block it maps.
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self.evictions = 0
        self.cow_copies = 0
        # observability: called with the evicted block id on every prefix
        # cache eviction (the engine points this at the flight recorder)
        self.on_evict: Optional[Callable[[int], None]] = None

    # -- introspection ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def evictable_blocks(self) -> int:
        """Cached prefix blocks held *only* by the cache (refcount 1)."""
        return sum(1 for b in self._prefix.values() if self._ref[b] == 1)

    @property
    def available_blocks(self) -> int:
        """What an allocation burst could obtain: free + evictable."""
        return self.free_blocks + self.evictable_blocks

    def available_excluding(self, pinned: Iterable[int]) -> int:
        """Allocation headroom if ``pinned`` blocks become un-evictable —
        the admit probe's view: taking shared references on its prefix
        hits removes exactly those blocks from the eviction pool, so they
        must not be double-counted as both reusable *and* evictable."""
        pin = set(pinned)
        evict = sum(1 for b in self._prefix.values()
                    if self._ref[b] == 1 and b not in pin)
        return self.free_blocks + evict

    @property
    def cached_blocks(self) -> int:
        return len(self._prefix)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def table(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].table)

    # -- allocation ------------------------------------------------------
    def _pop_free(self) -> int:
        if not self._free:
            if not self._evict_one():
                raise PoolExhausted(
                    f"kv pool exhausted: {self.num_blocks} blocks all "
                    f"referenced, none cached/evictable")
        return self._free.pop()

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix-cache entry whose block is
        not shared with any live sequence."""
        victim = next((h for h, b in self._prefix.items()
                       if self._ref[b] == 1), None)
        if victim is None:
            return False
        b = self._prefix.pop(victim)
        self._decref(b)
        self.evictions += 1
        if self.on_evict is not None:
            try:
                self.on_evict(b)
            except Exception:       # noqa: BLE001 - telemetry stays inert
                pass
        return True

    def _decref(self, block: int) -> None:
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            self._free.append(block)

    def new_seq(self) -> int:
        sid = self._next_seq
        self._next_seq += 1
        self._seqs[sid] = SeqState(sid)
        return sid

    def extend_to(self, seq_id: int, n_tokens: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions;
        returns the newly-allocated block ids (may be empty)."""
        st = self._seqs[seq_id]
        need = -(-n_tokens // self.block_size)
        fresh: List[int] = []
        while len(st.table) < need:
            b = self._pop_free()
            self._ref[b] = 1
            st.table.append(b)
            fresh.append(b)
        return fresh

    def append_shared(self, seq_id: int, blocks: Iterable[int]) -> None:
        """Append already-referenced blocks (a prefix-cache hit) to the
        sequence's table, taking one reference per block."""
        st = self._seqs[seq_id]
        for b in blocks:
            self._ref[b] = self._ref.get(b, 0) + 1
            st.table.append(b)

    def free_seq(self, seq_id: int) -> None:
        st = self._seqs.pop(seq_id, None)
        if st is None:
            return
        for b in st.table:
            self._decref(b)

    # -- serialization pins ----------------------------------------------
    def pin(self, blocks: Iterable[int]) -> None:
        """Take one extra reference on each block for the duration of a
        serialization (swap-out / migration export).  A pinned block
        cannot reach refcount 0 — so neither :meth:`free_seq` nor a
        prefix-cache eviction can recycle it while its rows are being
        gathered off the device.  Pair with :meth:`unpin` in a finally
        block."""
        for b in blocks:
            self._ref[b] = self._ref.get(b, 0) + 1

    def unpin(self, blocks: Iterable[int]) -> None:
        """Release serialization pins taken by :meth:`pin`."""
        for b in blocks:
            self._decref(b)

    # -- sharing / COW ---------------------------------------------------
    def fork(self, seq_id: int) -> int:
        """New sequence sharing *all* of ``seq_id``'s blocks (refcounts
        bumped).  Writes by either side into a shared block must go
        through :meth:`cow_targets` first."""
        child = self.new_seq()
        self.append_shared(child, self._seqs[seq_id].table)
        return child

    def cow_targets(self, seq_id: int, lo_pos: int,
                    hi_pos: int) -> List[Tuple[int, int]]:
        """Make positions ``[lo_pos, hi_pos)`` of ``seq_id`` writable.

        Any table entry in that range with refcount > 1 is replaced by a
        fresh private block; returns ``(src, dst)`` pairs the caller must
        mirror on device (``pool[dst] = pool[src]``) before writing.
        """
        if hi_pos <= lo_pos:
            return []
        st = self._seqs[seq_id]
        copies: List[Tuple[int, int]] = []
        lo_b = lo_pos // self.block_size
        hi_b = -(-hi_pos // self.block_size)
        for j in range(lo_b, min(hi_b, len(st.table))):
            src = st.table[j]
            if self._ref.get(src, 0) > 1:
                dst = self._pop_free()
                self._ref[dst] = 1
                st.table[j] = dst
                self._decref(src)
                copies.append((src, dst))
                self.cow_copies += 1
        return copies

    # -- prefix cache ----------------------------------------------------
    def prefix_lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest cached chain prefix of ``hashes`` -> block ids (LRU
        refreshed).  Does NOT take references — pair with
        :meth:`append_shared`."""
        out: List[int] = []
        for h in hashes:
            b = self._prefix.get(h)
            if b is None:
                break
            self._prefix.move_to_end(h)
            out.append(b)
        return out

    def prefix_insert(self, hashes: Sequence[bytes],
                      blocks: Sequence[int]) -> int:
        """Map each hash to its (already-written, immutable) block; the
        cache takes one reference per newly-inserted entry.  Returns how
        many entries were new."""
        added = 0
        for h, b in zip(hashes, blocks):
            cur = self._prefix.get(h)
            if cur is not None:
                self._prefix.move_to_end(h)
                continue
            self._prefix[h] = b
            self._ref[b] = self._ref.get(b, 0) + 1
            added += 1
        return added

    def prefix_items(self) -> List[Tuple[bytes, int]]:
        """Prefix-cache contents as ``(hash, block)`` pairs in LRU order
        (oldest first) — the migration export's shipping manifest."""
        return list(self._prefix.items())

    def import_cached(self, h: bytes) -> Optional[int]:
        """Bind one *free* block to prefix-cache entry ``h`` (a migrated
        block about to be filled by a device import).

        Returns the bound block id, or ``None`` when the hash is already
        cached (LRU refreshed — the import is a no-op) or when no free
        block exists.  Deliberately never evicts: adopted blocks enter as
        ordinary cache entries with the cache's single reference, so they
        stay evictable and admission headroom never shrinks below what a
        cold replica would have had.
        """
        if h in self._prefix:
            self._prefix.move_to_end(h)
            return None
        if not self._free:
            return None
        b = self._free.pop()
        self._ref[b] = 1
        self._prefix[h] = b
        return b


def padded_table(table: Sequence[int], nb_max: int) -> List[int]:
    """Fixed-width device form of a block table: pad with the null block."""
    if len(table) > nb_max:
        raise ValueError(f"table of {len(table)} blocks exceeds nb_max="
                         f"{nb_max}")
    return list(table) + [NULL_BLOCK] * (nb_max - len(table))
