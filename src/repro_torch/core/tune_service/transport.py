"""Authenticated, capped, replay-protected frame codec for fleet sockets
(a copy of the reference package's module: the same frames, byte for
byte, for the same object, key and sequence number).

frame layout (everything big-endian)::

    magic   3 bytes   b"RFT"            \\
    version 1 byte    VERSION            | header, 16 bytes
    seq     8 bytes   per-direction counter, 0, 1, 2, ...
    length  4 bytes   payload byte count /
    sig     32 bytes  HMAC-SHA256(key, header || payload)
    payload length bytes  pickled message

and the receive path enforces, strictly in this order:

1. **magic + version** checked from the fixed-size header --
   :class:`FrameMagicError` / :class:`FrameVersionError` on mismatch
   (a stray client, an incompatible peer);
2. **length cap** checked *before any payload allocation* --
   :class:`FrameTooLargeError` (one hostile header cannot balloon a
   4 GiB buffer);
3. **bounded body read** -- once the first header byte arrives, the rest
   of the frame must arrive within ``frame_timeout_s`` or the read fails
   with :class:`FrameTimeoutError` (a stalled or malicious peer costs a
   bounded wait, never a wedged serve loop);
4. **signature** verified (constant-time) over header+payload with the
   fleet's shared secret -- :class:`FrameSignatureError` rejects unsigned,
   re-keyed or bit-flipped frames *before* the payload is unpickled;
5. **sequence** must be exactly the next expected per-direction counter --
   :class:`FrameReplayError` rejects replayed (and reordered) frames even
   though their signatures verify.

Only after all five gates does ``pickle.loads`` run, and only on bytes
authenticated by the shared key: the trust model is "anyone holding the
fleet spec's ``auth_key``", not "anyone who can reach the port".  The
coordinator journals rejected frames attributable to a leased unit as
``reject`` events and drops the connection (see
:class:`~repro_torch.core.tune_service.coordinator.FleetExecutor`); the
worker treats any :class:`FrameError` as a lost transport and re-dials.
Frames carry host objects only: a worker's results are numpy arrays and
Python scalars, never CUDA tensors.

:class:`FleetSpec` is the frozen JSON bundle that makes a multi-host
fleet deployable from ONE artifact: the coordinator bind address, the
shared ``auth_key``, worker count / host list, heartbeat + lease
parameters and the frame caps.  ``python -m repro_torch.launch.fleet``
turns a spec into N running workers (local subprocesses, or printed
per-host commands); ``Study.tune(executor="fleet", pool="socket",
fleet_spec=...)`` binds the coordinator to it.
"""

from __future__ import annotations

import dataclasses
import hmac
import hashlib
import json
import os
import pickle
import secrets
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

MAGIC = b"RFT"
VERSION = 1

#: header: magic(3) + version(1) + seq(8) + length(4)
_HEADER = struct.Struct(">3sBQI")
SIG_BYTES = 32

#: hard cap on one frame's payload (work units are small dicts: a pickled
#: module-level function reference, a spec tuple and segment bounds; result
#: frames carry one float64 per epoch) — raise via FleetSpec for exotic
#: payloads, never unbounded
DEFAULT_MAX_FRAME_BYTES = 1 << 20
#: once a frame's first byte arrives, the rest must arrive within this
DEFAULT_FRAME_TIMEOUT_S = 5.0
#: how long a just-accepted connection gets to present its signed greet
DEFAULT_GREET_TIMEOUT_S = 5.0


class FrameError(Exception):
    """A frame failed validation; the connection cannot be trusted and
    must be dropped (the stream offset is unrecoverable anyway)."""

    #: short machine-readable reason (stable: journaled in reject events)
    reason = "frame"


class FrameMagicError(FrameError):
    reason = "bad-magic"


class FrameVersionError(FrameError):
    reason = "bad-version"


class FrameTooLargeError(FrameError):
    reason = "oversize"


class FrameSignatureError(FrameError):
    reason = "bad-signature"


class FrameReplayError(FrameError):
    reason = "replay"


class FrameTimeoutError(FrameError):
    reason = "timeout"


class FrameTruncatedError(FrameError):
    reason = "truncated"


class FrameProtocolError(FrameError):
    reason = "protocol"


def reject_reason(exc: BaseException) -> str:
    """The journal-stable reason string for a rejected frame."""
    if isinstance(exc, FrameError):
        return exc.reason
    return "transport"


def _sign(key: bytes, header: bytes, payload: bytes) -> bytes:
    return hmac.new(key, header + payload, hashlib.sha256).digest()


class FrameChannel:
    """One socket wrapped in the signed frame codec.

    Each endpoint keeps independent per-direction counters: ``send``
    stamps frames 0, 1, 2, ... and ``recv`` requires exactly the next
    expected counter, so a captured frame cannot be replayed into the
    same connection.  Sends are serialized by an internal lock (the
    worker's serve loop and its evaluation thread may both send).
    """

    def __init__(self, sock: socket.socket, key: bytes, *,
                 max_frame: int = DEFAULT_MAX_FRAME_BYTES,
                 frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S):
        if not isinstance(key, (bytes, bytearray)) or len(key) < 16:
            raise ValueError("auth key must be >= 16 bytes of shared "
                             "secret (see FleetSpec.generate)")
        self.sock = sock
        self._key = bytes(key)
        self.max_frame = int(max_frame)
        self.frame_timeout_s = float(frame_timeout_s)
        self._send_seq = 0
        self._recv_seq = 0
        self._lock = threading.Lock()

    # -- send --------------------------------------------------------------
    def encode(self, obj: Any) -> bytes:
        """Serialize + sign one frame, consuming a send sequence number.
        Exposed (rather than inlined in :meth:`send`) so the fault
        harness can mangle an otherwise-valid frame."""
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > self.max_frame:
            raise FrameTooLargeError(
                f"outgoing frame payload is {len(payload)} bytes "
                f"(cap {self.max_frame})")
        with self._lock:
            seq = self._send_seq
            self._send_seq += 1
        header = _HEADER.pack(MAGIC, VERSION, seq, len(payload))
        return header + _sign(self._key, header, payload) + payload

    def send(self, obj: Any) -> None:
        self.send_bytes(self.encode(obj))

    def send_bytes(self, raw: bytes) -> None:
        with self._lock:
            self.sock.sendall(raw)

    # -- recv --------------------------------------------------------------
    def _recv_exact(self, n: int, deadline: Optional[float],
                    started: bool) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise FrameTimeoutError(
                        f"frame body did not arrive within "
                        f"{self.frame_timeout_s}s")
                self.sock.settimeout(left)
            else:
                self.sock.settimeout(None)
            try:
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                raise FrameTimeoutError(
                    f"frame body did not arrive within "
                    f"{self.frame_timeout_s}s") from None
            if not chunk:
                if buf or started:
                    raise FrameTruncatedError(
                        "connection closed mid-frame")
                raise EOFError("fleet connection closed")
            buf += chunk
        return bytes(buf)

    def recv(self, wait_timeout: Optional[float] = None) -> Optional[Any]:
        """Receive one validated frame.

        ``wait_timeout`` bounds the wait for the frame to *start*
        (``None`` blocks; on expiry with no bytes, returns ``None`` — an
        idle poll).  Once the first byte arrives the WHOLE frame must
        land within ``frame_timeout_s`` (:class:`FrameTimeoutError`
        otherwise) — a peer can no longer wedge this endpoint between a
        header and its body.  Raises a :class:`FrameError` subclass on
        any validation failure and ``EOFError`` on clean close."""
        self.sock.settimeout(wait_timeout)
        try:
            first = self.sock.recv(1)
        except (socket.timeout, BlockingIOError):
            # BlockingIOError: wait_timeout == 0 puts the socket in
            # non-blocking mode — an empty instant poll, not an error
            return None
        if not first:
            raise EOFError("fleet connection closed")
        deadline = time.monotonic() + self.frame_timeout_s
        header = first + self._recv_exact(_HEADER.size - 1, deadline, True)
        magic, version, seq, length = _HEADER.unpack(header)
        if magic != MAGIC:
            raise FrameMagicError(f"bad frame magic {magic!r}")
        if version != VERSION:
            raise FrameVersionError(
                f"frame version {version} != {VERSION}")
        # the cap gates BEFORE the payload buffer exists: a corrupt or
        # hostile length header costs nothing
        if length > self.max_frame:
            raise FrameTooLargeError(
                f"frame claims {length} bytes (cap {self.max_frame})")
        sig = self._recv_exact(SIG_BYTES, deadline, True)
        payload = self._recv_exact(length, deadline, True)
        if not hmac.compare_digest(sig,
                                   _sign(self._key, header, payload)):
            raise FrameSignatureError(
                "frame signature does not verify (wrong or missing "
                "auth key, or a corrupted frame)")
        if seq != self._recv_seq:
            raise FrameReplayError(
                f"frame sequence {seq} != expected {self._recv_seq} "
                f"(replayed or reordered frame)")
        self._recv_seq += 1
        # only authenticated bytes reach the unpickler
        return pickle.loads(payload)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- the greet handshake -----------------------------------------------------
def greet(channel: FrameChannel, worker_id: int,
          timeout_s: float = DEFAULT_GREET_TIMEOUT_S) -> None:
    """Worker side: present the signed hello and await the coordinator's
    welcome.  Raises :class:`FrameProtocolError` if the coordinator does
    not accept (wrong key never gets a welcome — the connection is simply
    dropped)."""
    channel.send({"type": "hello", "worker": int(worker_id)})
    try:
        ack = channel.recv(wait_timeout=timeout_s)
    except (EOFError, OSError) as e:
        raise FrameProtocolError(
            "coordinator dropped the connection during greet (auth key "
            "mismatch?)") from e
    if not (isinstance(ack, dict) and ack.get("type") == "welcome"
            and ack.get("worker") == int(worker_id)):
        raise FrameProtocolError(f"expected a welcome frame, got {ack!r}")


def accept_greet(channel: FrameChannel,
                 timeout_s: float = DEFAULT_GREET_TIMEOUT_S) -> int:
    """Coordinator side: require a signed hello as the connection's first
    frame (authenticating ``worker_id`` before any unit can be leased)
    and acknowledge it.  Raises :class:`FrameError` on anything else."""
    hello = channel.recv(wait_timeout=timeout_s)
    if hello is None:
        raise FrameTimeoutError("connection presented no greet in time")
    if not (isinstance(hello, dict) and hello.get("type") == "hello"
            and isinstance(hello.get("worker"), int)
            and not isinstance(hello.get("worker"), bool)):
        raise FrameProtocolError(f"greet is not a hello frame: {hello!r}")
    wid = int(hello["worker"])
    channel.send({"type": "welcome", "worker": wid})
    return wid


# -- the fleet spec ----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Frozen, JSON-round-trippable description of one deployable fleet.

    One spec file is the whole hand-off between the coordinator host and
    the worker hosts: where to connect, the shared ``auth_key`` every
    frame is signed with, how many workers to expect, and the transport
    caps.  ``hosts`` empty means the coordinator self-spawns ``workers``
    local socket workers (the test/benchmark shape); a non-empty host
    list means the workers are launched externally
    (``python -m repro_torch.launch.fleet``) and the coordinator waits up to
    ``boot_grace_s`` for them to greet before degrading.

    The ``auth_key`` is a secret: keep spec files out of version control
    and world-readable paths.  :meth:`generate` mints a fresh key.
    """

    workers: int = 2
    hosts: Tuple[str, ...] = ()
    host: str = "127.0.0.1"
    port: int = 0                     # 0 = ephemeral (self-spawned fleets)
    auth_key: str = ""                # hex-encoded shared secret
    heartbeat_s: float = 0.1
    lease_deadline: int = 30          # missed-heartbeat count, wall-clock-free
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
    frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S
    max_redials: int = 8
    redial_backoff_s: float = 0.2
    boot_grace_s: float = 60.0

    def __post_init__(self):
        object.__setattr__(self, "hosts", tuple(self.hosts))
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.hosts and len(self.hosts) != self.workers:
            raise ValueError(
                f"hosts lists {len(self.hosts)} entries for "
                f"workers={self.workers}; list one host per worker "
                f"(repeat a host to run several workers on it)")
        if self.auth_key:
            try:
                key = bytes.fromhex(self.auth_key)
            except ValueError:
                raise ValueError("auth_key must be hex-encoded") from None
            if len(key) < 16:
                raise ValueError("auth_key must be >= 16 bytes (32 hex "
                                 "chars); use FleetSpec.generate()")
        if self.max_frame_bytes < 4096:
            raise ValueError("max_frame_bytes must be >= 4096")
        if self.frame_timeout_s <= 0 or self.heartbeat_s <= 0:
            raise ValueError("frame_timeout_s and heartbeat_s must be > 0")
        if self.lease_deadline < 1:
            raise ValueError("lease_deadline must be >= 1 heartbeat")

    @classmethod
    def generate(cls, **kw) -> "FleetSpec":
        """A spec with a freshly minted 32-byte auth key."""
        kw.setdefault("auth_key", secrets.token_hex(32))
        return cls(**kw)

    @property
    def key_bytes(self) -> bytes:
        if not self.auth_key:
            raise ValueError(
                "fleet spec has no auth_key; use FleetSpec.generate() or "
                "set auth_key explicitly")
        return bytes.fromhex(self.auth_key)

    @property
    def external(self) -> bool:
        """Workers are launched outside the coordinator process."""
        return bool(self.hosts)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hosts"] = list(self.hosts)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown FleetSpec fields {sorted(unknown)}; expected a "
                f"subset of {sorted(known)}")
        return cls(**d)

    def save(self, path: str) -> None:
        """Write the spec as JSON, readable by its owner only (mode 0600:
        it holds the fleet's shared secret)."""
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.fchmod(fd, 0o600)  # an existing file keeps its mode otherwise
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "FleetSpec":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))
