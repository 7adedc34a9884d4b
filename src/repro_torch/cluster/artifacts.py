"""Content-addressed artifact store for remote backend builds.

A :class:`~repro_torch.cluster.backends.BackendSpec` must be rebuildable on a
host that shares no filesystem with the router — but specs carry *paths*
(``weights_path=...``).  The store closes that gap:

  * the router puts a weights file into its local store and references it
    from the spec as ``"artifact:<sha256>"`` (:func:`artifact_ref`);
  * a socket worker resolving the spec (:func:`resolve_spec`) looks each
    reference up in *its* store and, on a miss, fetches the bytes by hash —
    over the worker's own connection, via a ``("fetch", sha)`` frame the
    parent answers from its store — then verifies the digest before
    trusting the content.

Content addressing makes the cache safe to share between workers and
across restarts: a hash either matches its bytes or the fetch is refused,
and re-fetching an artifact that is already present is free.

:func:`spec_fingerprint` is the handshake's integrity check: parent and
worker hash the spec the same way, so a reconnecting worker built from a
stale spec (an old deployment, a different weights hash) is refused at
the door instead of silently serving wrong results.

Copied from ``repro.cluster.artifacts``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import tempfile
import time
from typing import Callable, Optional

from repro_torch.cluster.backends import BackendSpec

_PREFIX = "artifact:"


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming digest: verifying a multi-GB checkpoint must not
    materialize it in RAM."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def artifact_ref(digest: str) -> str:
    return _PREFIX + digest


def is_artifact_ref(value) -> bool:
    return isinstance(value, str) and value.startswith(_PREFIX)


def ref_digest(ref: str) -> str:
    return ref[len(_PREFIX):]


class ArtifactStore:
    """Flat directory of files named by the sha256 of their content."""

    def __init__(self, root: Optional[str] = None):
        if root is None:
            # per-user, 0700: a world-shared fixed tempdir would let any
            # local user pre-plant a file under a victim's weights digest
            uid = getattr(os, "getuid", lambda: "u")()
            root = os.path.join(tempfile.gettempdir(),
                                f"repro_torch-artifacts-{uid}")
        self.root = root
        os.makedirs(self.root, mode=0o700, exist_ok=True)

    def _path(self, digest: str) -> str:
        # strict sha256-hex only: a digest is a filename, so anything else
        # ("..", separators, empty) is a traversal attempt or corruption
        if not isinstance(digest, str) or len(digest) != 64 or \
                any(c not in "0123456789abcdef" for c in digest):
            raise ValueError(f"bad artifact digest {digest!r}")
        return os.path.join(self.root, digest)

    def has(self, digest: str) -> bool:
        return os.path.exists(self._path(digest))

    def _install(self, tmp: str, digest: str) -> None:
        """Atomically publish a fully-written private temp file under its
        digest, *re-verifying the bytes that actually hit disk* first.

        The re-verify closes the corruption window concurrent fetches used
        to have: a torn/short write (full disk, a crash mid-write, an I/O
        error the buffered writer swallowed) would otherwise be renamed
        into place and then *trusted* by every later worker that finds the
        file present.  Because the temp file is private (mkstemp) and the
        publish is a single ``os.replace``, N workers fetching the same
        hash race benignly: each verifies its own bytes, each rename is
        atomic, and the store never exposes a half-written artifact."""
        disk = sha256_file(tmp)
        if disk != digest:
            raise IOError(
                f"artifact write verification failed: wrote bytes hashing "
                f"to {disk}, expected {digest} — refusing to publish a "
                f"corrupt artifact")
        os.replace(tmp, self._path(digest))

    def put_bytes(self, data: bytes) -> str:
        digest = sha256_bytes(data)
        path = self._path(digest)
        # an existing file only short-circuits the write if its content
        # actually hashes to its name — anything else (pre-planted,
        # truncated) is overwritten with the verified bytes
        fresh = not os.path.exists(path) or sha256_file(path) != digest
        if fresh:
            # write-to-temp + digest re-verify + atomic rename: concurrent
            # puts of the same content race benignly to an identical file
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                self._install(tmp, digest)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return digest

    def put_file(self, path: str, chunk: int = 1 << 20) -> str:
        """Streaming put: hash while copying into a private temp file,
        then verify + atomic-rename — a multi-GB checkpoint is never
        materialized in RAM and never observable half-copied."""
        h = hashlib.sha256()
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with open(path, "rb") as src, os.fdopen(fd, "wb") as dst:
                while True:
                    block = src.read(chunk)
                    if not block:
                        break
                    h.update(block)
                    dst.write(block)
            digest = h.hexdigest()
            target = self._path(digest)
            if os.path.exists(target) and sha256_file(target) == digest:
                return digest           # already installed and verified
            self._install(tmp, digest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return digest

    def get_path(self, digest: str) -> str:
        path = self._path(digest)
        if not os.path.exists(path):
            raise KeyError(f"artifact {digest} not in store {self.root}")
        return path

    def read_bytes(self, digest: str) -> bytes:
        with open(self.get_path(digest), "rb") as f:
            return f.read()

    def put_ref(self, path: str) -> str:
        """Store a file and return the spec-embeddable reference."""
        return artifact_ref(self.put_file(path))


# ----------------------------------------------------------------------
def fetch_with_retry(fetch: Callable[[str], Optional[bytes]], digest: str,
                     attempts: int = 4, base_s: float = 0.2,
                     max_s: float = 5.0, jitter: float = 0.5,
                     sleep: Optional[Callable[[float], None]] = None,
                     rng: Optional[random.Random] = None,
                     ) -> Optional[bytes]:
    """Bounded retry around a transient-miss-prone ``fetch(digest)``.

    Two failure modes bracket the design: a single transient miss (parent
    briefly mid-restart, a dropped frame) used to degrade straight into a
    hard ``KeyError`` from :func:`resolve_spec`; but unbounded retries
    after a mass reconnect would synchronize every worker into a fetch
    storm against the one parent holding the bytes.  So: cap the attempts
    (total failure stays an explicit, prompt error) and spread them —
    exponential backoff with multiplicative jitter drawn per *worker*
    (``rng`` defaults to OS-seeded, deliberately NOT digest-seeded, which
    would put all workers fetching the same artifact in lockstep).

    Returns the first non-``None`` result, or ``None`` after ``attempts``
    misses.  Exceptions from ``fetch`` propagate immediately — a closed
    channel is not a transient miss.
    """
    rng = rng if rng is not None else random.Random()
    do_sleep = sleep if sleep is not None else time.sleep
    for attempt in range(max(1, attempts)):
        data = fetch(digest)
        if data is not None:
            return data
        if attempt + 1 >= attempts:
            break
        delay = min(base_s * (2 ** attempt), max_s)
        do_sleep(delay * (1.0 + jitter * rng.random()))
    return None


def spec_fingerprint(spec: BackendSpec) -> str:
    """Stable content hash of a spec: target, kind, and kwargs (sorted;
    non-JSON values fall back to ``repr``, which is stable for the
    paths/numbers/strings specs are restricted to)."""
    blob = json.dumps(
        {"target": spec.target, "kind": spec.kind,
         "kwargs": {k: spec.kwargs[k] for k in sorted(spec.kwargs)}},
        sort_keys=True, default=repr).encode()
    return sha256_bytes(blob)


def resolve_spec(spec: BackendSpec, store: ArtifactStore,
                 fetch: Optional[Callable[[str], Optional[bytes]]] = None,
                 ) -> BackendSpec:
    """Rewrite every ``"artifact:<sha>"`` kwarg to a local file path.

    Missing artifacts are pulled via ``fetch(sha) -> bytes`` (the socket
    worker wires this to a ``("fetch", sha)`` round-trip); fetched bytes
    are digest-verified by the store's content addressing before use.
    Misses are retried a bounded number of times with jittered backoff
    (:func:`fetch_with_retry`) before degrading to ``KeyError``.
    """
    kwargs = dict(spec.kwargs)
    for key, value in spec.kwargs.items():
        if not is_artifact_ref(value):
            continue
        digest = ref_digest(value)
        cached_ok = store.has(digest) and \
            sha256_file(store.get_path(digest)) == digest
        # a cache hit is re-verified before trust: a pre-planted or
        # corrupted file under the right name is a miss, not a model
        if not cached_ok:
            data = fetch_with_retry(fetch, digest) \
                if fetch is not None else None
            if data is None:
                raise KeyError(
                    f"artifact {digest} (spec kwarg {key!r}) not in store "
                    f"and not fetchable")
            got = store.put_bytes(data)
            if got != digest:
                raise ValueError(
                    f"artifact {digest} fetch returned content hashing to "
                    f"{got} — refusing corrupt artifact")
        kwargs[key] = store.get_path(digest)
    if kwargs == dict(spec.kwargs):
        return spec
    return BackendSpec(spec.target, kwargs, spec.kind)
