"""Fleet worker: one remote evaluation slot speaking the lease protocol
(the reference package's worker, on the port's card).

A worker is the execution half of the coordinator/worker control-plane
split (Ray Tune's trial-executor shape): it owns NO study state, executes
exactly ONE work unit at a time, and talks to the coordinator through
three message types::

    hello      {type, worker}                      on connect
    heartbeat  {type, worker, unit, attempt}       every ``heartbeat_s``;
                                                   ``unit`` is None while
                                                   idle (lets the
                                                   coordinator detect a
                                                   lost result message);
                                                   an idle one adds
                                                   ``last``, the (unit,
                                                   attempt) received last
    result     {type, worker, unit, attempt,       when the unit finishes
                result}                            (or times out locally)

and receives::

    unit       {type, unit, attempt, call, timeout_s}
    shutdown   {type}

``call`` is the pickled ``(fn, args)`` pair, and the evaluation thread
unpickles it: a worker's first unit imports its function's module, which
can take seconds, and unpickled in the serve loop it stopped the
heartbeats for as long (a loaded host outlasted the lease's deadline).

The evaluation runs on a daemon thread so the serve loop keeps
heartbeating mid-segment -- a slow epoch loop is visibly alive, a dead or
wedged worker goes silent and its lease expires coordinator-side.  A unit
whose evaluation exceeds its ``timeout_s`` is converted into an
``{"error": "timeout..."}`` result locally (the hung thread is abandoned;
the process keeps serving) so a hung objective costs one slot-timeout,
never the study.

Transports:

* **process** (:func:`process_main`) -- started by the coordinator on the
  same box, always by ``spawn`` (a process that has started CUDA cannot
  be forked); messages over ``multiprocessing`` queues.  The worker
  self-terminates when its parent dies, so a SIGKILLed coordinator never
  leaks orphan evaluators.
* **socket** (:func:`socket_main`, or ``python -m
  repro_torch.core.tune_service.worker --connect HOST:PORT``) --
  authenticated, length-capped frames over TCP (:mod:`.transport`) for
  workers on other hosts.  Every frame is HMAC-signed with the fleet
  spec's shared ``auth_key`` and the worker greets with a signed hello
  before any unit is leased.  A dropped connection does NOT end the
  worker: it re-dials with exponential backoff and re-greets under the
  same identity, keeping any in-flight evaluation alive across the gap --
  the coordinator re-attaches the live lease, or first-commit-wins
  absorbs the duplicate if it already expired.

Injected faults (:mod:`.faults`) are applied HERE, keyed by
``(unit, attempt)``, because this is where real fleets break: process
death, wedged heartbeats, lost/duplicated/late result messages, hung
evaluations, and (socket transport) corrupted / truncated / replayed
frames, partitions and link latency.

**The card.**  Before a worker greets, :func:`warm_up` starts CUDA on the
study's device and launches each ``select_topk`` kernel once at a small
shape, so its library is built or loaded and its module is on the card.
Units are leased only to greeted workers, so neither the CUDA start nor
the kernel load runs inside a lease (where it could go silent past
``lease_deadline`` and be expired on a clean run).  A worker whose
warm-up failed still greets, and answers every unit with an error result
naming the failure: it never evaluates on another device than the one it
was given.  Nor does a worker evaluate a unit on another device than the
one it warmed up: a unit whose segment payload names another device (a
``--device cpu`` socket worker serving a study on the card, or the
reverse) gets an error result the same way.  Each unit's result also
carries the worker's kernel launches
during the unit (``ops.launch_counts_by_variant()`` after, less before,
under :data:`LAUNCHES_KEY`); the coordinator strips them before the
service sees the result, so journals and digests stay the reference's.
Results cross the transport as host objects: a segment returns its walls
as a numpy array (and, under the fleet, no carry), never a CUDA tensor.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ...kernels import ops
from .executor import _timed_safe
from .faults import NO_FAULTS, FaultPlan
from .transport import (DEFAULT_FRAME_TIMEOUT_S, DEFAULT_MAX_FRAME_BYTES,
                        FleetSpec, FrameChannel, FrameError, greet)

#: heartbeat cadence (seconds) while a unit is evaluating
DEFAULT_HEARTBEAT_S = 0.1
#: environment variables the CLI / launcher use to pass secrets and
#: injected latency without putting them on argv (visible in ``ps``)
KEY_ENV = "REPRO_FLEET_KEY"
NET_DELAY_ENV = "REPRO_FLEET_NET_DELAY_S"
#: result key of a unit's kernel launches on its worker (kernel ->
#: variant -> count); the coordinator strips it before the service
LAUNCHES_KEY = "kernel_launches"
#: the ``select_topk`` kernels :func:`warm_up` launches, each at a row
#: length the kernel takes: ``block`` covers a row in one tile
WARM_UP_ROWS = (("block", 64), ("cluster", 2048))


def warm_up(device: str, worker_id: int) -> Optional[str]:
    """Start CUDA on ``device`` and launch each ``select_topk`` kernel
    once (building or loading its library and putting its module on the
    card); nothing to do on the CPU.  Returns None, or the error every
    unit of this worker then returns."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            return None
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        from ...kernels import select_topk as sk
        if dev.index is not None:
            torch.cuda.set_device(dev)
        for variant, n in WARM_UP_ROWS:
            heat = torch.arange(n, dtype=torch.float32,
                                device=dev).reshape(1, n)
            mask = torch.ones((1, n), dtype=torch.bool, device=dev)
            k = torch.ones(1, dtype=torch.float32, device=dev)
            sk.select_topk(mask, heat, mask, heat, k, k, variant=variant)
        torch.cuda.synchronize(dev)
    except Exception as e:  # noqa: BLE001 - reported by every unit
        return (f"worker {worker_id} could not start {device} or load "
                f"select_topk:\n" + "".join(traceback.format_exception(
                    type(e), e, e.__traceback__)))
    return None


def _same_device(a: str, b: str) -> bool:
    """``a`` and ``b`` name one device (``cuda`` is ``cuda:0`` in a
    worker, which never selects another current device)."""
    try:
        da, db = torch.device(a), torch.device(b)
    except RuntimeError:  # a name torch does not know is no device here
        return False
    if da.type != db.type:
        return False
    return da.type != "cuda" or (da.index or 0) == (db.index or 0)


def device_error(args, device: str, worker_id: int) -> Optional[str]:
    """The error a unit gets when its payload (a segment's mapping, its
    first argument) names another device than ``device``, the one this
    worker warmed up; None when it names this device or none."""
    payload = args[0] if args and isinstance(args[0], dict) else {}
    want = payload.get("device")
    if want is None or _same_device(str(want), device):
        return None
    return (f"worker {worker_id} warmed up {device}, but its unit runs on "
            f"{want}: start the worker with --device {want}")


def _launch_delta(before: Dict[str, Dict[str, int]],
                  after: Dict[str, Dict[str, int]]
                  ) -> Dict[str, Dict[str, int]]:
    return {name: {v: n - before.get(name, {}).get(v, 0)
                   for v, n in by_variant.items()}
            for name, by_variant in after.items()}


class _Running:
    """One in-flight evaluation: the daemon thread plus its result box.
    Completion sets an event so the serve loop wakes instantly instead of
    holding the finished slot for a transport-poll interval."""

    def __init__(self, msg: Dict[str, Any], faults: FaultPlan,
                 card_error: Optional[str], device: str, worker_id: int):
        self.unit = int(msg["unit"])
        self.attempt = int(msg["attempt"])
        self.timeout_s = msg.get("timeout_s")
        self.t0 = time.perf_counter()
        self._box: Dict[str, Any] = {}
        self._event = threading.Event()
        self._faults = faults
        self._card_error = card_error
        self._device = device
        self._worker_id = worker_id
        self._thread = threading.Thread(
            target=self._run, args=(msg["call"],), daemon=True,
            name=f"repro-torch-fleet-eval-u{self.unit}")
        self._thread.start()

    def _run(self, call: bytes) -> None:
        if self._faults.kills(self.unit, self.attempt):
            # die mid-segment: the lease is live, heartbeats have flowed
            time.sleep(0.05)
            os._exit(9)
        if self._faults.hangs(self.unit, self.attempt):
            # a hung evaluation: heartbeats continue, the result never
            # comes -- only timeout_s can unwedge the unit
            while True:
                time.sleep(3600)
        try:
            # the frame was authenticated before it was decoded; this
            # may import the function's module (seconds, once a worker)
            fn, args = pickle.loads(call)
        except Exception as e:  # noqa: BLE001 -- reported as the result
            self._box["result"] = {
                "error": f"worker {self._worker_id} cannot load unit "
                         f"{self.unit}: {type(e).__name__}: {e}",
                "slot_s": 0.0}
            self._event.set()
            return
        error = self._card_error or device_error(args, self._device,
                                                 self._worker_id)
        if error is not None:
            self._box["result"] = {"error": error, "slot_s": 0.0}
        else:
            before = ops.launch_counts_by_variant()
            result = _timed_safe(fn, *args)
            result[LAUNCHES_KEY] = _launch_delta(
                before, ops.launch_counts_by_variant())
            self._box["result"] = result
        self._event.set()

    def wait(self, timeout: float) -> None:
        self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def result(self) -> Dict[str, Any]:
        return self._box["result"]

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def timed_out(self) -> bool:
        return self.timeout_s is not None and self.elapsed > self.timeout_s


class TransportLost(Exception):
    """The socket transport failed mid-serve (raised by the socket
    transport's send/recv closures); the reconnect loop re-dials.  Any
    in-flight evaluation survives in the :class:`_ServeState`."""


class _ServeState:
    """Serve-loop state that must survive a transport loss: the in-flight
    evaluation (its daemon thread keeps computing while the worker
    re-dials), the wedged flag (a fired stall fault outlives any number
    of reconnects), the device the worker warmed up and the warm-up's
    error, if any (:func:`warm_up`)."""

    def __init__(self, device: str, card_error: Optional[str] = None):
        self.device = device
        self.card_error = card_error
        self.current: Optional[_Running] = None
        self.wedged = False  # a fired stall fault: alive, forever silent
        #: a result whose send was cut off by a transport loss: resent
        #: first thing after the next successful re-greet, so a partition
        #: landing on the result frame costs a reconnect, not the unit
        self.pending: Optional[Dict[str, Any]] = None
        #: (unit, attempt) of the last unit message received (a refused one
        #: too); every idle heartbeat carries it, so the coordinator can
        #: tell one sent before the worker received its unit (or that
        #: never will) from one sent after
        self.last: Optional[Tuple[int, int]] = None


def _serve(recv: Callable[[float], Optional[Dict[str, Any]]],
           send: Callable[[Dict[str, Any]], None],
           worker_id: int, heartbeat_s: float, faults: FaultPlan,
           parent_alive: Callable[[], bool],
           state: _ServeState, hello: bool = True) -> str:
    """The worker loop shared by every transport.

    Idle: block on the transport (new units wake it immediately) and send
    an *idle* heartbeat (``unit: None``) every ``heartbeat_s`` -- this is
    how the coordinator learns a result message was lost (a worker
    claiming idle while its lease is live) and that a written-off worker
    recovered.  Busy: wait on the evaluation's completion event (finished
    slots are reported instantly, not at the next poll tick), heartbeat
    the lease every ``heartbeat_s``, and poll the transport
    non-blockingly for shutdown.

    Returns ``"shutdown"`` (coordinator said so), ``"parent"`` (the
    spawning coordinator process died) or ``"transport"`` (the transport
    broke -- the socket path re-dials with the same ``state``).  The
    socket closures may also raise :class:`TransportLost` out of this
    loop; ``state`` keeps that safe."""
    if hello:
        send({"type": "hello", "worker": worker_id})
    if state.pending is not None:
        # the previous connection died between computing a result and
        # delivering it: deliver before anything else (the coordinator
        # just re-attached the lease; this resolves it)
        out, state.pending = state.pending, None
        send(out)
    last_hb = time.monotonic()
    while True:
        if not parent_alive():
            return "parent"
        try:
            if state.current is not None:
                delay = max(0.0, heartbeat_s
                            - (time.monotonic() - last_hb))
                if state.current.timeout_s is not None:
                    delay = min(delay, max(
                        0.0, state.current.timeout_s
                        - state.current.elapsed) + 0.01)
                state.current.wait(delay)
                msg = recv(0.0)
            else:
                msg = recv(min(0.25, heartbeat_s))
        except (EOFError, OSError):
            return "transport"  # the coordinator died or hung up
        if msg is not None:
            if msg.get("type") == "shutdown":
                return "shutdown"
            if msg.get("type") == "unit":
                state.last = (int(msg["unit"]), int(msg["attempt"]))
                if state.current is not None and not state.current.done:
                    # the coordinator never double-books a worker; a unit
                    # arriving mid-unit means state was lost -- refuse it
                    send({"type": "result", "worker": worker_id,
                          "unit": int(msg["unit"]),
                          "attempt": int(msg["attempt"]),
                          "result": {"error": "worker busy (protocol "
                                              "violation)", "slot_s": 0.0}})
                    continue
                state.current = _Running(msg, faults, state.card_error,
                                         state.device, worker_id)
                continue
        now = time.monotonic()
        if state.current is None:
            if not state.wedged and now - last_hb >= heartbeat_s:
                last_hb = now
                send({"type": "heartbeat", "worker": worker_id,
                      "unit": None, "attempt": None, "last": state.last})
            continue
        current = state.current
        u, a = current.unit, current.attempt
        if current.done:
            result = current.result
            state.current = None
            last_hb = now
            if faults.stalls(u, a):
                # stall: the worker wedges -- this result and every later
                # message (including idle heartbeats) are suppressed, so
                # the lease expires by heartbeat SILENCE and the worker is
                # written off as suspect until it speaks again (never)
                state.wedged = True
                continue
            if faults.drops(u, a):
                # drop: pure message loss -- the worker stays healthy, and
                # its idle heartbeats let the coordinator detect the lost
                # result quickly (the "lost" expiry fast path)
                continue
            delay = faults.delays(u, a)
            if delay:
                time.sleep(delay)  # straggler: the late twin still arrives
            out = {"type": "result", "worker": worker_id, "unit": u,
                   "attempt": a, "result": result}
            state.pending = out  # survives a transport loss mid-delivery
            send(out)
            if faults.dups(u, a):
                send(out)
            state.pending = None
        elif current.timed_out:
            t = current.timeout_s
            state.current = None  # abandon the daemon thread; keep serving
            last_hb = now
            send({"type": "result", "worker": worker_id, "unit": u,
                  "attempt": a,
                  "result": {"error": f"timeout: unit {u} exceeded "
                                      f"{t}s on worker {worker_id}",
                             "timeout": True, "slot_s": float(t)}})
        elif faults.stalls(u, a):
            continue  # wedged host: no heartbeats, no result
        elif now - last_hb >= heartbeat_s:
            last_hb = now
            send({"type": "heartbeat", "worker": worker_id, "unit": u,
                  "attempt": a})


# -- process transport (multiprocessing queues) ------------------------------
def process_main(worker_id: int, inbox, outbox, heartbeat_s: float,
                 faults: FaultPlan, device: str) -> None:
    """Entry point for coordinator-spawned process workers: warm up the
    card (:func:`warm_up`), then greet and serve."""
    state = _ServeState(device, warm_up(device, worker_id))
    import multiprocessing as mp
    parent = mp.parent_process()

    def recv(timeout: float):
        try:
            return inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def parent_alive() -> bool:
        return parent is None or parent.is_alive()

    try:
        _serve(recv, outbox.put, worker_id, heartbeat_s, faults,
               parent_alive, state=state)
    finally:
        outbox.cancel_join_thread()


# -- socket transport (authenticated frames, reconnect-with-backoff) ---------
def _dial(addr, key: bytes, worker_id: int, max_frame: int,
          frame_timeout_s: float) -> FrameChannel:
    """One connect + greet attempt; raises OSError/FrameError on failure."""
    sock = socket.create_connection(tuple(addr), timeout=5.0)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    chan = FrameChannel(sock, key, max_frame=max_frame,
                        frame_timeout_s=frame_timeout_s)
    try:
        greet(chan, worker_id)
    except BaseException:
        chan.close()
        raise
    return chan


def socket_main(addr, worker_id: int,
                heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                faults: FaultPlan = NO_FAULTS,
                device: str = "cuda",
                key: Optional[bytes] = None,
                max_frame: int = DEFAULT_MAX_FRAME_BYTES,
                frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S,
                max_redials: int = 8,
                redial_backoff_s: float = 0.2,
                net_delay_s: float = 0.0,
                announce: Optional[Callable[[str], None]] = None) -> None:
    """Entry point for socket workers (same-box tests and self-spawned
    fleets call this in a process; remote hosts use the module CLI).

    The card is warmed up first (:func:`warm_up`).  The outer loop is
    reconnect-with-backoff: dial, greet with the signed hello, serve until
    the transport breaks, then re-dial (exponential backoff, at most
    ``max_redials`` consecutive failures) and re-greet under the same
    ``worker_id``.  The :class:`_ServeState` -- including an in-flight
    evaluation's daemon thread -- survives the gap, so after re-greeting
    the worker resumes heartbeating its lease and the coordinator
    re-attaches it.  A greet the coordinator never answers (wrong auth
    key) fails fast instead of redialing forever.
    """
    if key is None:
        hexkey = os.environ.get(KEY_ENV, "")
        if not hexkey:
            raise ValueError(
                f"socket workers need the fleet auth key: pass key= or "
                f"set {KEY_ENV} (see FleetSpec and python -m "
                f"repro_torch.launch.fleet)")
        key = bytes.fromhex(hexkey)
    if not net_delay_s:
        net_delay_s = float(os.environ.get(NET_DELAY_ENV, "0") or 0)
    state = _ServeState(device, warm_up(device, worker_id))
    # frame faults fire once per (unit, attempt) per worker process --
    # a re-issued attempt has fresh coordinates, so it runs clean
    fired: set = set()
    partition_hold = [0.0]

    def run_once(chan: FrameChannel) -> str:
        def recv(timeout: float):
            try:
                return chan.recv(wait_timeout=timeout)
            except FrameError as e:
                # a garbled or hostile coordinator stream: drop + re-dial
                raise TransportLost(str(e)) from e

        def send(msg: Dict[str, Any]) -> None:
            if net_delay_s:
                time.sleep(net_delay_s)
            kind = msg.get("type")
            u, a = msg.get("unit"), msg.get("attempt")
            try:
                if kind == "result":
                    hold = faults.partitions(u, a)
                    if hold and ("partition", u, a) not in fired:
                        # the link drops mid-lease, just before the result
                        # frame, and stays down: close, hold, then re-dial
                        # and re-greet.  Keyed to the result (every unit
                        # sends exactly one) so the fault fires
                        # deterministically; the result itself survives in
                        # ``state.pending`` and is delivered after the
                        # reconnect -- the coordinator re-attaches the
                        # lease, nothing is re-executed
                        fired.add(("partition", u, a))
                        partition_hold[0] = hold
                        chan.close()
                        raise TransportLost("injected partition")
                    raw = chan.encode(msg)
                    if faults.corrupts(u, a) and \
                            ("corrupt", u, a) not in fired:
                        fired.add(("corrupt", u, a))
                        # flip the last payload byte: the signature no
                        # longer verifies coordinator-side
                        raw = raw[:-1] + bytes([raw[-1] ^ 0x01])
                        chan.send_bytes(raw)
                        return
                    if faults.truncates(u, a) and \
                            ("truncate", u, a) not in fired:
                        fired.add(("truncate", u, a))
                        # half a frame then EOF: closing is what makes the
                        # fault deterministic (the coordinator always sees
                        # truncated, never a signature race with later
                        # heartbeat bytes filling the body read)
                        chan.send_bytes(raw[:len(raw) // 2])
                        chan.close()
                        raise TransportLost("injected truncated frame")
                    chan.send_bytes(raw)
                    if faults.replays(u, a) and \
                            ("replay", u, a) not in fired:
                        fired.add(("replay", u, a))
                        # the same bytes again: a stale sequence number --
                        # rejected even though the signature verifies
                        chan.send_bytes(raw)
                    return
                chan.send(msg)
            except TransportLost:
                raise
            except (OSError, FrameError) as e:
                raise TransportLost(str(e)) from e

        try:
            # greet() already presented the signed hello; the coordinator
            # reader forwards it, so the serve loop must not repeat it
            return _serve(recv, send, worker_id, heartbeat_s, faults,
                          lambda: True, state=state, hello=False)
        except TransportLost:
            return "transport"

    dials = 0
    while True:
        try:
            chan = _dial(addr, key, worker_id, max_frame, frame_timeout_s)
        except FrameError:
            return  # greeted but refused / garbled welcome: wrong key
        except OSError:
            dials += 1
            if dials > max_redials:
                return
            time.sleep(min(redial_backoff_s * (2 ** (dials - 1)), 2.0))
            continue
        dials = 0
        if announce is not None:
            announce(f"worker {worker_id} greeted")
        outcome = run_once(chan)
        chan.close()
        if outcome in ("shutdown", "parent"):
            return
        if partition_hold[0]:
            time.sleep(partition_hold[0])
            partition_hold[0] = 0.0
        dials += 1
        if dials > max_redials:
            return
        time.sleep(min(redial_backoff_s * (2 ** (dials - 1)), 2.0))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="repro_torch tune-service fleet worker (authenticated "
                    "socket transport)")
    p.add_argument("--connect", metavar="HOST:PORT", default=None,
                   help="coordinator address (defaults to the fleet "
                        "spec's host:port)")
    p.add_argument("--id", type=int, default=0, help="worker id")
    p.add_argument("--fleet-spec", metavar="SPEC.json", default=None,
                   help="fleet spec file: address, auth key, heartbeat "
                        "and transport caps in one artifact")
    p.add_argument("--key-file", metavar="PATH", default=None,
                   help="file holding the hex auth key (overrides the "
                        f"spec; default: ${KEY_ENV})")
    p.add_argument("--heartbeat", type=float, default=None,
                   help="heartbeat cadence in seconds")
    p.add_argument("--max-redials", type=int, default=None,
                   help="consecutive failed re-dials before giving up")
    p.add_argument("--device", default="cuda",
                   help="device the units run on (default cuda; cpu for "
                        "the plain kernels)")
    args = p.parse_args(argv)
    spec = FleetSpec.load(args.fleet_spec) if args.fleet_spec else None
    key = None
    if args.key_file:
        with open(args.key_file, "r", encoding="utf-8") as fh:
            key = bytes.fromhex(fh.read().strip())
    elif os.environ.get(KEY_ENV):
        key = bytes.fromhex(os.environ[KEY_ENV])
    elif spec is not None and spec.auth_key:
        key = spec.key_bytes
    if args.connect:
        host, port = args.connect.rsplit(":", 1)
        addr = (host, int(port))
    elif spec is not None:
        addr = (spec.host, spec.port)
    else:
        p.error("--connect or --fleet-spec is required")
    kw: Dict[str, Any] = {}
    if spec is not None:
        kw.update(max_frame=spec.max_frame_bytes,
                  frame_timeout_s=spec.frame_timeout_s,
                  max_redials=spec.max_redials,
                  redial_backoff_s=spec.redial_backoff_s)
        if args.heartbeat is None:
            args.heartbeat = spec.heartbeat_s
    if args.max_redials is not None:
        kw["max_redials"] = args.max_redials
    socket_main(addr, args.id,
                heartbeat_s=args.heartbeat if args.heartbeat is not None
                else DEFAULT_HEARTBEAT_S,
                device=args.device, key=key,
                announce=lambda line: print(line, flush=True), **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
