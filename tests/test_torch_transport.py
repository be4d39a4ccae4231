"""The port's fleet transport against the reference's, on the CPU.

``repro_torch.core.tune_service.transport`` is a copy of the reference's
pure-Python frame codec.  These are ``tests/test_transport.py``'s cases on
the port's ``FrameChannel``/``greet``/``FleetSpec``:

* every malformed frame class -- truncated, oversize, bit-flipped,
  replayed, unsigned / wrong-key, wrong magic, wrong version, stalled
  mid-frame -- raises its specific ``FrameError`` with the reference's
  ``reject_reason``;
* the oversize gate fires before any payload allocation;
* a live coordinator fed stranger garbage rejects, drops and still serves;
  a worker dialing a hostile endpoint fails fast;
* ``FleetSpec`` round-trips through JSON, validates, and is saved 0600;

and the wire: a frame the port writes is the reference's bytes for the
same object, key and sequence number, and each side reads the other's
frames and greets.  Every socket is closed and every fleet stopped in
``finally``; every wait has a deadline.
"""

import os
import pickle
import socket
import threading
import time

import pytest

pytest.importorskip("torch")

from repro.core.tune_service import transport as ref_tr  # noqa: E402
from repro_torch.core.tune_service import transport as tr  # noqa: E402
from repro_torch.core.tune_service.transport import (  # noqa: E402
    _HEADER, DEFAULT_MAX_FRAME_BYTES, MAGIC, SIG_BYTES, VERSION,
    FleetSpec, FrameChannel, FrameError, FrameMagicError,
    FrameProtocolError, FrameReplayError, FrameSignatureError,
    FrameTimeoutError, FrameTooLargeError, FrameTruncatedError,
    FrameVersionError, accept_greet, greet, reject_reason)

KEY = bytes(range(32))
OTHER_KEY = bytes(range(32, 64))


def _pair(**kw):
    a, b = socket.socketpair()
    return FrameChannel(a, KEY, **kw), FrameChannel(b, KEY, **kw)


def _valid_frame(chan, obj={"type": "heartbeat"}):
    return chan.encode(obj)


def _unit(x):
    """A work unit for the socket fleet (module-level: spawned workers
    import it by name)."""
    return {"value": float(x) * 2.0, "slot_s": 0.0}


# ---------------------------------------------------------------------------
# the happy path: signed frames round-trip, sequences advance
# ---------------------------------------------------------------------------
def test_roundtrip_and_sequences():
    tx, rx = _pair()
    try:
        for i in range(5):
            tx.send({"type": "heartbeat", "n": i})
            assert rx.recv(wait_timeout=1.0) == {"type": "heartbeat", "n": i}
    finally:
        tx.close(), rx.close()


def test_idle_poll_returns_none():
    tx, rx = _pair()
    try:
        t0 = time.monotonic()
        assert rx.recv(wait_timeout=0.05) is None
        assert time.monotonic() - t0 < 1.0
        # a zero timeout is an instant poll, not a transport error
        assert rx.recv(wait_timeout=0.0) is None
    finally:
        tx.close(), rx.close()


def test_short_key_refused():
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="16 bytes"):
            FrameChannel(a, b"short")
    finally:
        a.close(), b.close()


# ---------------------------------------------------------------------------
# the fuzz corpus: every malformed-frame class -> its specific rejection
# ---------------------------------------------------------------------------
def test_truncated_frame_rejected():
    tx, rx = _pair()
    try:
        raw = _valid_frame(tx)
        tx.sock.sendall(raw[: len(raw) // 2])
        tx.close()
        with pytest.raises(FrameTruncatedError) as e:
            rx.recv(wait_timeout=1.0)
        assert reject_reason(e.value) == "truncated"
    finally:
        tx.close(), rx.close()


def test_clean_close_is_eof_not_frame_error():
    tx, rx = _pair()
    try:
        tx.close()
        with pytest.raises(EOFError):
            rx.recv(wait_timeout=1.0)
    finally:
        rx.close()


def test_oversize_header_rejected_before_allocation():
    tx, rx = _pair(max_frame=4096)
    try:
        # a header claiming a ~4 GiB payload: the cap must fire on the
        # header alone -- reading the claimed body would wedge this test
        tx.sock.sendall(_HEADER.pack(MAGIC, VERSION, 0, 0xFFFF0000))
        with pytest.raises(FrameTooLargeError) as e:
            rx.recv(wait_timeout=1.0)
        assert reject_reason(e.value) == "oversize"
    finally:
        tx.close(), rx.close()


def test_oversize_outgoing_rejected():
    tx, rx = _pair(max_frame=4096)
    try:
        with pytest.raises(FrameTooLargeError):
            tx.send({"blob": b"x" * 8192})
    finally:
        tx.close(), rx.close()


def test_bitflip_anywhere_in_payload_rejected():
    for flip in (0, 7):  # first and last payload byte
        tx, rx = _pair()
        try:
            raw = bytearray(_valid_frame(tx, {"v": 1.0}))
            raw[-1 if flip else _HEADER.size + SIG_BYTES] ^= 0x01
            tx.sock.sendall(bytes(raw))
            with pytest.raises(FrameSignatureError) as e:
                rx.recv(wait_timeout=1.0)
            assert reject_reason(e.value) == "bad-signature"
        finally:
            tx.close(), rx.close()


def test_unsigned_and_wrong_key_rejected():
    # wrong key: a peer without the fleet spec cannot forge a signature
    a, b = socket.socketpair()
    tx, rx = FrameChannel(a, OTHER_KEY), FrameChannel(b, KEY)
    try:
        tx.send({"type": "hello", "worker": 0})
        with pytest.raises(FrameSignatureError):
            rx.recv(wait_timeout=1.0)
    finally:
        tx.close(), rx.close()
    # zeroed signature: same rejection
    tx, rx = _pair()
    try:
        raw = bytearray(_valid_frame(tx))
        raw[_HEADER.size:_HEADER.size + SIG_BYTES] = b"\x00" * SIG_BYTES
        tx.sock.sendall(bytes(raw))
        with pytest.raises(FrameSignatureError):
            rx.recv(wait_timeout=1.0)
    finally:
        tx.close(), rx.close()


def test_replayed_frame_rejected():
    tx, rx = _pair()
    try:
        raw = _valid_frame(tx)
        tx.send_bytes(raw)
        assert rx.recv(wait_timeout=1.0) == {"type": "heartbeat"}
        tx.send_bytes(raw)  # identical bytes, valid signature, stale seq
        with pytest.raises(FrameReplayError) as e:
            rx.recv(wait_timeout=1.0)
        assert reject_reason(e.value) == "replay"
    finally:
        tx.close(), rx.close()


def test_bad_magic_and_version_rejected():
    tx, rx = _pair()
    try:
        tx.sock.sendall(b"GET / HTTP/1.1\r\n" + b"\x00" * 32)
        with pytest.raises(FrameMagicError):
            rx.recv(wait_timeout=1.0)
    finally:
        tx.close(), rx.close()
    tx, rx = _pair()
    try:
        raw = bytearray(_valid_frame(tx))
        raw[3] = VERSION + 1  # version byte
        tx.sock.sendall(bytes(raw))
        with pytest.raises(FrameVersionError):
            rx.recv(wait_timeout=1.0)
    finally:
        tx.close(), rx.close()


def test_stalled_peer_bounded_by_frame_timeout():
    tx, rx = _pair(frame_timeout_s=0.2)
    try:
        tx.sock.sendall(_valid_frame(tx)[:4])  # header started, then silence
        t0 = time.monotonic()
        with pytest.raises(FrameTimeoutError):
            rx.recv(wait_timeout=1.0)
        assert time.monotonic() - t0 < 2.0  # bounded, not wedged
    finally:
        tx.close(), rx.close()


def test_reject_reasons_are_journal_stable():
    cases = [(FrameSignatureError, "bad-signature"),
             (FrameTooLargeError, "oversize"), (FrameReplayError, "replay"),
             (FrameTruncatedError, "truncated"),
             (FrameTimeoutError, "timeout"), (FrameMagicError, "bad-magic"),
             (FrameVersionError, "bad-version"),
             (FrameProtocolError, "protocol")]
    for cls, reason in cases:
        assert reject_reason(cls()) == reason
        # the reference's class of the same name gives the same reason
        assert ref_tr.reject_reason(getattr(ref_tr, cls.__name__)()) \
            == reason
    assert reject_reason(OSError("boom")) == "transport"
    assert ref_tr.reject_reason(OSError("boom")) == "transport"


# ---------------------------------------------------------------------------
# the greet handshake: identity before leases
# ---------------------------------------------------------------------------
def test_greet_roundtrip():
    tx, rx = _pair()
    try:
        t = threading.Thread(target=greet, args=(tx, 3), daemon=True)
        t.start()
        assert accept_greet(rx, timeout_s=2.0) == 3
        t.join(timeout=2.0)
        assert not t.is_alive()
    finally:
        tx.close(), rx.close()


def test_greet_requires_hello_first():
    for hello in ({"type": "result", "unit": 0},     # signed, not a hello
                  {"type": "hello", "worker": True}):  # a bool id
        tx, rx = _pair()
        try:
            tx.send(hello)
            with pytest.raises(FrameProtocolError):
                accept_greet(rx, timeout_s=1.0)
        finally:
            tx.close(), rx.close()


def test_greet_wrong_key_never_welcomed():
    a, b = socket.socketpair()
    tx, rx = FrameChannel(a, OTHER_KEY), FrameChannel(b, KEY)
    worker_exc = []

    def worker_greet():
        try:
            greet(tx, 0, timeout_s=2.0)
        except Exception as e:  # noqa: BLE001 - captured for assertion
            worker_exc.append(e)

    t = threading.Thread(target=worker_greet, daemon=True)
    try:
        t.start()
        with pytest.raises(FrameSignatureError):
            accept_greet(rx, timeout_s=2.0)
        rx.close()  # coordinator drops: the worker's greet fails fast
        t.join(timeout=5.0)
        assert isinstance(worker_exc[0], FrameProtocolError)
    finally:
        tx.close(), rx.close()


def test_silent_peer_greet_times_out():
    tx, rx = _pair()
    try:
        with pytest.raises(FrameTimeoutError):
            accept_greet(rx, timeout_s=0.1)
    finally:
        tx.close(), rx.close()


# ---------------------------------------------------------------------------
# endpoint fuzz: a live coordinator and a worker under hostile bytes
# ---------------------------------------------------------------------------
def test_stranger_garbage_does_not_wedge_the_fleet():
    from repro_torch.core.tune_service.coordinator import FleetExecutor
    ex = FleetExecutor(workers=1, pool="socket", heartbeat_s=0.05,
                       lease_deadline=40, device="cpu")
    try:
        addr = ex.address
        assert addr is not None
        # a stranger who can reach the port: raw garbage, an unsigned
        # pickle-shaped blob, and a half-greet then hangup
        for blob in (b"\x00" * 64, b"GET / HTTP/1.1\r\n\r\n",
                     _HEADER.pack(MAGIC, VERSION, 0, 16) + b"j" * 48):
            s = socket.create_connection(addr, timeout=2.0)
            try:
                s.sendall(blob)
            finally:
                s.close()
        for i in range(3):
            ex.submit(_unit, i)
        got = [ex.pop_next() for _ in range(3)]
        assert [r["value"] for _, r in got] == [0.0, 2.0, 4.0]
        stats = ex.stats()
        assert stats["n_rejected_frames"] >= 3
        # the stranger never held a lease: nothing expired for it
        assert stats["degraded"] is False
        assert stats["n_expired_leases"] == 0
    finally:
        ex.close()


def test_hostile_coordinator_does_not_wedge_the_worker():
    """A worker dialing a garbage-speaking endpoint fails fast (its greet
    gets no valid welcome) instead of redialing forever."""
    from repro_torch.core.tune_service.worker import socket_main

    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()[:2]

    def hostile():
        conn, _ = srv.accept()
        try:
            conn.recv(4096)          # swallow the hello
            conn.sendall(b"\xde\xad\xbe\xef" * 16)  # garbage "welcome"
        finally:
            conn.close()

    t = threading.Thread(target=hostile, daemon=True)
    try:
        t.start()
        t0 = time.monotonic()
        socket_main(addr, 0, heartbeat_s=0.05, device="cpu", key=KEY,
                    max_redials=2, redial_backoff_s=0.05)
        assert time.monotonic() - t0 < 10.0  # returned, not wedged
        t.join(timeout=5.0)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# FleetSpec: one frozen JSON artifact describes the whole fleet
# ---------------------------------------------------------------------------
def test_fleet_spec_roundtrip(tmp_path):
    spec = FleetSpec.generate(workers=3, port=5555,
                              hosts=("a", "b", "c"), heartbeat_s=0.2)
    path = os.path.join(tmp_path, "fleet.json")
    spec.save(path)
    assert os.stat(path).st_mode & 0o777 == 0o600  # it holds the key
    assert FleetSpec.load(path) == spec
    assert spec.external
    assert len(spec.key_bytes) == 32
    assert FleetSpec.from_dict(spec.to_dict()) == spec
    # one artifact for both packages: the reference loads the port's file
    assert ref_tr.FleetSpec.load(path).to_dict() == spec.to_dict()
    # saving over a world-readable file makes it 0600 too
    os.chmod(path, 0o644)
    spec.save(path)
    assert os.stat(path).st_mode & 0o777 == 0o600


def test_fleet_spec_validation():
    with pytest.raises(ValueError, match="workers"):
        FleetSpec(workers=0)
    with pytest.raises(ValueError, match="one host per worker"):
        FleetSpec(workers=2, hosts=("a",))
    with pytest.raises(ValueError, match="hex"):
        FleetSpec(auth_key="not-hex!")
    with pytest.raises(ValueError, match="16 bytes"):
        FleetSpec(auth_key="aabb")
    with pytest.raises(ValueError, match="max_frame_bytes"):
        FleetSpec(max_frame_bytes=16)
    with pytest.raises(ValueError, match="unknown FleetSpec fields"):
        FleetSpec.from_dict({"workers": 2, "warp_drive": True})
    with pytest.raises(ValueError, match="no auth_key"):
        FleetSpec().key_bytes
    assert FleetSpec.generate(workers=2).max_frame_bytes == \
        DEFAULT_MAX_FRAME_BYTES
    assert FleetSpec().to_dict() == ref_tr.FleetSpec().to_dict()


# ---------------------------------------------------------------------------
# the wire: the port's frames are the reference's bytes
# ---------------------------------------------------------------------------
MESSAGES = [
    {"type": "hello", "worker": 3},
    {"type": "heartbeat", "worker": 1, "unit": 7, "attempt": 0},
    {"type": "heartbeat", "worker": 1, "unit": None, "attempt": None},
    {"type": "result", "worker": 0, "unit": 2, "attempt": 1,
     "result": {"value": 61.25, "slot_s": 0.5}},
    {"type": "shutdown"},
]


def test_frames_are_the_references_bytes():
    a1, b1 = socket.socketpair()
    a2, b2 = socket.socketpair()
    ours, ref = FrameChannel(a1, KEY), ref_tr.FrameChannel(a2, KEY)
    try:
        for msg in MESSAGES:            # seq 0, 1, 2, ... on both sides
            raw = ours.encode(msg)
            assert raw == ref.encode(msg)
            assert raw[:3] == MAGIC == ref_tr.MAGIC
            assert raw[_HEADER.size + SIG_BYTES:] == pickle.dumps(
                msg, protocol=pickle.HIGHEST_PROTOCOL)
        assert (tr._HEADER.format, tr.SIG_BYTES, tr.VERSION,
                tr.DEFAULT_MAX_FRAME_BYTES, tr.DEFAULT_FRAME_TIMEOUT_S,
                tr.DEFAULT_GREET_TIMEOUT_S) == (
            ref_tr._HEADER.format, ref_tr.SIG_BYTES, ref_tr.VERSION,
            ref_tr.DEFAULT_MAX_FRAME_BYTES, ref_tr.DEFAULT_FRAME_TIMEOUT_S,
            ref_tr.DEFAULT_GREET_TIMEOUT_S)
    finally:
        for s in (ours, ref):
            s.close()
        b1.close(), b2.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_side_reads_the_others_frames(writer):
    a, b = socket.socketpair()
    mk = {"port": FrameChannel, "reference": ref_tr.FrameChannel}
    reader_name = "reference" if writer == "port" else "port"
    tx, rx = mk[writer](a, KEY), mk[reader_name](b, KEY)
    try:
        for msg in MESSAGES:
            tx.send(msg)
            assert rx.recv(wait_timeout=1.0) == msg
        # and the reader refuses the writer's replay, as its own
        raw = tx.encode({"type": "heartbeat"})
        tx.send_bytes(raw)
        rx.recv(wait_timeout=1.0)
        tx.send_bytes(raw)
        with pytest.raises((FrameError, ref_tr.FrameError)) as e:
            rx.recv(wait_timeout=1.0)
        assert e.value.reason == "replay"
    finally:
        tx.close(), rx.close()


@pytest.mark.parametrize("worker_side", ["port", "reference"])
def test_greet_across_packages(worker_side):
    a, b = socket.socketpair()
    if worker_side == "port":
        tx, rx = FrameChannel(a, KEY), ref_tr.FrameChannel(b, KEY)
        greet_fn, accept_fn = greet, ref_tr.accept_greet
    else:
        tx, rx = ref_tr.FrameChannel(a, KEY), FrameChannel(b, KEY)
        greet_fn, accept_fn = ref_tr.greet, accept_greet
    t = threading.Thread(target=greet_fn, args=(tx, 5), daemon=True)
    try:
        t.start()
        assert accept_fn(rx, timeout_s=2.0) == 5
        t.join(timeout=2.0)
        assert not t.is_alive()
    finally:
        tx.close(), rx.close()
