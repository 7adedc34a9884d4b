"""Message channels and the worker handshake listener.

The transport layer (``cluster/transport.py``) speaks to a replica worker
through a :class:`Channel`: a bidirectional, message-oriented pipe carrying
the frames produced by ``encode_frame``/``decode_frame``.  Two carriers:

  * :class:`PipeChannel`   — a ``multiprocessing.Connection`` duplex pipe
    (the process transport: parent and worker share a host).
  * :class:`SocketChannel` — a TCP stream with 4-byte big-endian
    length-prefixed frames (the socket transport: the worker may live on
    any host that can reach the listener).

Both raise :class:`ChannelClosed` (an ``OSError``) on a broken carrier, so
callers handle pipe EOF and TCP resets identically.

:class:`WorkerListener` is the parent-side accept loop for socket workers.
A connecting worker opens the conversation with a versioned *hello* frame::

    ("hello", PROTOCOL_VERSION, token, kind | None, spec_hash | None)

The listener rejects protocol-version mismatches and unknown tokens with a
``("reject", reason)`` frame, and otherwise routes the connection — first
contact or reconnect — to the :class:`~repro_torch.cluster.transport.
SocketTransport` registered under that token, which continues the
handshake (spec-hash check, ``("welcome", ...)`` reply).

Copied from ``repro.cluster.wire``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.cluster.framing import decode_frame, encode_frame, msgpack

# Bump when hello/welcome/tag semantics change: a worker built from an
# older checkout must be refused at the door, not fail mid-request.
# v2: drain-time ("kv_state", state) frame — warm KV migration hand-off.
#
# Still v2 (backward/forward compatible additions, same door):
#   * ("req", rid, cost, payload, tctx[, budget]) — element 5 is an
#     optional *relative* deadline budget in seconds (monotonic clocks do
#     not cross hosts; the worker pins an absolute deadline at ingest).
#     Old workers ignore the extra element; old parents omit it.
#   * ("cancel", rid) and ("brownout", level) parent->worker control
#     frames — WorkerIO drops unknown tags, so old workers skip them.
PROTOCOL_VERSION = 2

# Bounds a malicious or corrupted length word before we try to allocate
# it.  Note this is also the practical cap on a single artifact transfer
# (fetch replies are one frame; see ROADMAP for chunked transfer).
MAX_FRAME_BYTES = 1 << 31
# Before a peer has presented a known worker token it gets a hello-sized
# budget and — when msgpack is available — no pickle decoding at all:
# ``pickle.loads`` on unauthenticated bytes is remote code execution.
UNTRUSTED_FRAME_BYTES = 1 << 16

_LEN = struct.Struct(">I")


class ChannelClosed(OSError):
    """The carrier under a channel is gone (EOF, reset, closed twice)."""


def _decode_or_close(frame: bytes, allow_pickle: bool = True):
    """A peer that sends an undecodable frame is indistinguishable from a
    corrupt/hostile connection: treat it as closed, never let the decode
    error escape into a receive loop.  With ``allow_pickle=False`` a
    pickle-tagged frame is refused outright (pre-authentication, pickle ==
    arbitrary code execution)."""
    if not allow_pickle and frame[:1] == b"P":
        raise ChannelClosed("pickle frame before authentication")
    try:
        return decode_frame(frame)
    except Exception as e:              # noqa: BLE001 - any decode failure
        raise ChannelClosed(f"undecodable frame: {e!r}") from e


class Channel:
    """Message-oriented duplex channel of ``encode_frame`` payloads."""

    def send(self, obj: Any, pickle_only: bool = False) -> None:
        raise NotImplementedError

    def send_bytes(self, frame: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: float) -> Optional[Any]:
        """Next message, or ``None`` if nothing arrived within ``timeout``.
        Raises :class:`ChannelClosed` when the carrier is gone."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class PipeChannel(Channel):
    """A ``multiprocessing.Connection`` wrapped to the Channel surface."""

    def __init__(self, conn):
        self.conn = conn
        self._send_lock = threading.Lock()

    def send(self, obj: Any, pickle_only: bool = False) -> None:
        self.send_bytes(encode_frame(obj, pickle_only))

    def send_bytes(self, frame: bytes) -> None:
        try:
            with self._send_lock:
                self.conn.send_bytes(frame)
        except (OSError, ValueError, EOFError) as e:
            raise ChannelClosed(str(e)) from e

    def recv(self, timeout: float) -> Optional[Any]:
        try:
            if not self.conn.poll(timeout):
                return None
            buf = self.conn.recv_bytes()
        except (EOFError, OSError) as e:
            raise ChannelClosed(str(e)) from e
        return _decode_or_close(buf)

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class SocketChannel(Channel):
    """Length-prefixed ``encode_frame`` frames over a TCP stream.

    Wire format: ``>I`` byte length, then the frame (tag byte + body).
    Reads buffer partial frames across calls, so a ``recv`` timeout never
    corrupts framing.
    """

    def __init__(self, sock: socket.socket, trusted: bool = True):
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._buf = bytearray()
        self._closed = False
        self._trusted = trusted

    def trust(self) -> None:
        """Lift the pre-authentication restrictions (pickle ban + small
        frame budget) once the peer presented a known worker token."""
        self._trusted = True

    def send(self, obj: Any, pickle_only: bool = False) -> None:
        self.send_bytes(encode_frame(obj, pickle_only))

    def send_bytes(self, frame: bytes) -> None:
        try:
            with self._send_lock:
                self.sock.sendall(_LEN.pack(len(frame)) + frame)
        except struct.error as e:       # > 4 GiB: length prefix overflow
            raise ChannelClosed(
                f"frame too large for the wire ({len(frame)} bytes)") from e
        except OSError as e:
            raise ChannelClosed(str(e)) from e

    def _parse_frame(self) -> Optional[bytes]:
        if len(self._buf) < _LEN.size:
            return None
        (n,) = _LEN.unpack_from(self._buf)
        limit = MAX_FRAME_BYTES if self._trusted else UNTRUSTED_FRAME_BYTES
        if n > limit:
            raise ChannelClosed(f"oversized frame ({n} bytes)")
        if len(self._buf) < _LEN.size + n:
            return None
        frame = bytes(self._buf[_LEN.size:_LEN.size + n])
        del self._buf[:_LEN.size + n]
        return frame

    def recv(self, timeout: float) -> Optional[Any]:
        # readiness via select, not settimeout: the timeout must never
        # leak onto a concurrent send() sharing this socket
        with self._recv_lock:
            frame = self._parse_frame()
            while frame is None:
                if self._closed:
                    raise ChannelClosed("channel closed")
                try:
                    ready, _, _ = select.select([self.sock], [], [], timeout)
                    if not ready:
                        return None
                    chunk = self.sock.recv(1 << 16)
                except (OSError, ValueError) as e:
                    raise ChannelClosed(str(e)) from e
                if not chunk:
                    raise ChannelClosed("EOF")
                self._buf.extend(chunk)
                frame = self._parse_frame()
                # after the first chunk, consume only what is already
                # buffered so one recv() call never blocks on the wire twice
                if frame is None:
                    timeout = 0.0
        # msgpack missing means even hello frames arrive pickled: a
        # degraded single-trust-domain mode, not the multi-host posture
        return _decode_or_close(frame,
                                allow_pickle=self._trusted or msgpack is None)

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect_channel(address: Tuple[str, int],
                    timeout: float = 5.0) -> SocketChannel:
    """Dial a listener; raises ``OSError`` while it is unreachable."""
    sock = socket.create_connection(address, timeout=timeout)
    sock.settimeout(None)
    return SocketChannel(sock)


# ----------------------------------------------------------------------
class WorkerListener:
    """Accepts socket-worker connections and routes them by token.

    One listener serves every :class:`SocketTransport` in the process;
    transports ``register(token, adopt)`` and the listener completes the
    version half of the handshake before handing the channel (plus the
    decoded hello) to the transport's ``adopt`` callback.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 handshake_timeout_s: float = 5.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self.handshake_timeout_s = handshake_timeout_s
        self._handlers: Dict[str, Callable[[SocketChannel, tuple], None]] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="worker-listener")
        self._thread.start()

    def register(self, token: str,
                 adopt: Callable[[SocketChannel, tuple], None]) -> None:
        with self._lock:
            self._handlers[token] = adopt

    def unregister(self, token: str) -> None:
        with self._lock:
            self._handlers.pop(token, None)

    # -- accept path -----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _addr = self._sock.accept()
            except OSError:
                return                      # listener closed
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True, name="worker-handshake").start()

    def _handshake(self, sock: socket.socket) -> None:
        # untrusted until the token checks out: no pickle decoding, small
        # frame budget — an unauthenticated peer must not reach
        # pickle.loads or allocate gigabytes
        chan = SocketChannel(sock, trusted=False)
        try:
            # loop, don't single-shot: the hello may arrive in several TCP
            # segments, and one recv() call only blocks on the wire once
            t_end = time.monotonic() + self.handshake_timeout_s
            hello = None
            try:
                while hello is None and time.monotonic() < t_end:
                    hello = chan.recv(min(0.2, self.handshake_timeout_s))
            except ChannelClosed as e:
                if "pickle frame" in str(e):
                    # a legitimate worker on a msgpack-less host would
                    # fall back to pickle hellos; tell it why it is being
                    # refused instead of ghosting (sending is still safe —
                    # only *decoding* untrusted pickle is not)
                    chan.send(("reject",
                               "pickle hello refused before authentication"
                               " — install msgpack on the worker host"))
                chan.close()
                return
            if hello is None:
                chan.close()
                return
            if (not isinstance(hello, (tuple, list)) or len(hello) < 5
                    or hello[0] != "hello"):
                chan.send(("reject", "malformed hello"))
                chan.close()
                return
            _tag, version, token, _kind, _spec_hash = hello[:5]
            if version != PROTOCOL_VERSION:
                chan.send(("reject",
                           f"protocol version {version} != "
                           f"{PROTOCOL_VERSION}"))
                chan.close()
                return
            with self._lock:
                adopt = self._handlers.get(token)
            if adopt is None:
                chan.send(("reject", f"unknown worker token {token!r}"))
                chan.close()
                return
        except (ChannelClosed, OSError):
            chan.close()
            return
        chan.trust()
        adopt(chan, tuple(hello))

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
