"""Wire framing shared by every remote transport carrier.

msgpack for the control plane (tags, rids, heartbeat snapshots — known
plain types), pickle for anything carrying *user* payloads or results
(``pickle_only=True``): msgpack would silently round-trip tuples as lists,
making a backend behave differently across a process or host boundary.
One tag byte keeps decode unambiguous.  The same frames travel over a
``multiprocessing`` pipe (process transport) or a length-prefixed TCP
stream (socket transport, see ``cluster/wire.py``).

Copied from ``repro.cluster.framing``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import pickle
from typing import Any

try:
    import msgpack
except ImportError:                                   # pragma: no cover - env
    msgpack = None


def encode_frame(obj: Any, pickle_only: bool = False) -> bytes:
    if not pickle_only and msgpack is not None:
        try:
            return b"M" + msgpack.packb(obj, use_bin_type=True)
        except (TypeError, ValueError, OverflowError):
            pass
    return b"P" + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode_frame(buf: bytes) -> Any:
    tag, body = buf[:1], buf[1:]
    if tag == b"M":
        if msgpack is None:
            raise RuntimeError("msgpack frame received without msgpack")
        return msgpack.unpackb(body, raw=False)
    if tag == b"P":
        return pickle.loads(body)
    raise ValueError(f"unknown frame tag {tag!r}")
