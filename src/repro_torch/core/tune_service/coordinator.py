"""FleetExecutor: a lease-and-commit trial queue over remote workers (the
reference package's coordinator, with workers that hold the card).

The multi-host rung of the tuning service.  One
coordinator owns the study — the journal, the optimizer, the canonical
commit order — and serves work units from ONE shared queue to N
:mod:`.worker` processes (``pool="process"`` on this box, ``pool="socket"``
across hosts, speaking the authenticated capped-frame codec of
:mod:`.transport` and deployable from a frozen
:class:`~repro_torch.core.tune_service.transport.FleetSpec`).  The class is
a drop-in for :class:`~repro_torch.core.tune_service.executor.TrialExecutor`
(same ``submit``/``submit_ready``/``pop_next``/``outstanding`` surface), so
the :class:`~repro_torch.core.tune_service.service.TuneService` control
loop — and
every determinism property it pins — is reused unchanged.

**Lease-and-commit.**  Each dispatched unit carries a lease: the worker
must heartbeat it every ``heartbeat_s`` while the segment runs, and a
lease that goes silent for ``lease_deadline`` heartbeat intervals of the
coordinator's listening (or whose worker provably died — process
sentinel, socket EOF, or an idle heartbeat proving the result was lost in
flight) **expires**.  An expired
unit is **re-issued** to another worker, at most :data:`MAX_ATTEMPTS` times
with a short backoff, before it is surrendered as an error result (which
the service turns into a bounded trial ``retry``, then FAILED).
Re-issue is safe *because* the study is deterministic: a unit is a pure
function of its canonical coordinates (seed + batch offset + segment
bounds), so duplicate execution returns the same bits — the first result
to land commits, and any late twin is **asserted bitwise equal** against
the committed digest (a cheap, always-on placement-invariance check).

**Determinism of the journal.**  Lease lifecycle events
(``lease``/``expire``/``reissue``) are collected per unit and journaled
by the service at the unit's *commit* point, in canonical order — never
at wall-clock detection time.  Worker ids stay out of the journal
(placement is irrelevant to the study), deadlines are recorded as
heartbeat *counts* (wall-clock-free), and each worker runs exactly one
unit at a time, so an injected fault keyed by ``(unit, attempt)``
(:mod:`.faults`) perturbs exactly one lease no matter which worker drew
the unit.  Two runs under the same fault plan therefore write
byte-identical journals, and a coordinator SIGKILLed mid-re-issue
resumes byte-identically (the re-issue in flight simply replays).

**Rejects and reconnects.**  On the socket transport, a frame that fails
validation (bad signature, oversize, replayed, truncated) drops its
connection and — when the sender held a live lease — journals a
``reject`` into the unit's history before expiring the lease; a worker
whose link merely dropped re-dials, re-greets under its identity and has
its live lease re-attached (journaled as ``reconnect``).  Both events
ride the same commit-time history mechanism as ``lease``/``expire``/
``reissue``, so the journal stays deterministic.

**Graceful degradation.**  Dead process workers are respawned up to
``max_respawns`` times — each respawn first promotes a booted hot-spare
worker when one is up, so the slot refills instantly and the fresh
interpreter boot (seconds: a spawned worker imports torch, starts CUDA
and loads the kernels) happens on the replacement spare, off the critical
path.  When the live fleet shrinks to zero, queued units run on the
coordinator's local slot instead — the study finishes slower, never
wedges.

**The card.**  Workers always start by ``spawn``: a process that has
started CUDA (or torch's threads) cannot be forked.  Each worker warms
the study's device up before it greets
(:func:`~repro_torch.core.tune_service.worker.warm_up`), and reports its
kernel launches with each result; :meth:`FleetExecutor.stats` sums them
under ``kernel_launches`` (the coordinator's own launches, the
model-phase asks' and the local slot's, stay in this process's
``ops`` counters).  The coordinator strips the launches from each result
before the service or the twin digest sees it.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .executor import _timed_safe
from .faults import NO_FAULTS, FaultPlan
from .transport import (FleetSpec, FrameChannel, FrameError,
                        FrameReplayError, accept_greet, reject_reason)
from .worker import (DEFAULT_HEARTBEAT_S, LAUNCHES_KEY, process_main,
                     socket_main)

FLEET_POOLS = ("process", "socket")

#: default lease deadline, in missed-heartbeat counts (wall-clock-free)
DEFAULT_LEASE_DEADLINE = 30
#: give up re-issuing a unit after this many lease attempts
MAX_ATTEMPTS = 4
#: back-off (seconds) per earlier re-issue before a unit's next attempt
REISSUE_BACKOFF_S = 0.05
#: hot-spare workers a process fleet keeps booted
HOT_SPARES = 1


def _result_digest(result: Dict[str, Any]) -> Optional[bytes]:
    """A canonical digest of a unit result for the duplicate-execution
    equality assertion (None for error results — tracebacks may differ)."""
    if "error" in result:
        return None
    if "wall_ms" in result:
        return np.ascontiguousarray(
            np.asarray(result["wall_ms"], dtype=np.float64)).tobytes()
    if "value" in result:
        return repr(float(result["value"])).encode()
    return None


class _ProcessFleet:
    """Process-transport fleet: spawned workers on this box, queue
    messaging.

    Keeps :data:`HOT_SPARES` workers booted but never leased: a worker
    death promotes a spare instantly instead of paying a fresh boot
    (interpreter, torch, CUDA, kernels: seconds) on the critical path —
    the replacement spare boots in the background while both promoted
    slots keep working.

    Each worker writes to a queue of its own, which a thread of the
    coordinator forwards into one inbox.  A shared queue's write lock is
    held by whichever process is writing: a worker killed mid-write (a
    heartbeat in flight) dies holding it, and every other worker's
    messages stop for good -- their live leases expire for silence and
    the fleet degrades.  A worker's own queue can only lose its own
    messages."""

    def __init__(self, n: int, heartbeat_s: float, faults: FaultPlan,
                 device: str):
        import multiprocessing as mp
        # never fork: a process that started CUDA or torch's threads
        # cannot be forked
        self._ctx = mp.get_context("spawn")
        self._inbox: "queue_mod.Queue" = queue_mod.Queue()
        self._closing = False
        self._heartbeat_s = heartbeat_s
        self._faults = faults
        self._device = device
        self._procs: Dict[int, Any] = {}
        self._queues: Dict[int, Any] = {}
        self._outboxes: Dict[int, Any] = {}
        self._forwarders: List[threading.Thread] = []
        self._reaped: set = set()
        self._spares: List[int] = []
        self.n_promotions = 0
        self._next_wid = 0
        for _ in range(n):
            self._spawn()
        for _ in range(HOT_SPARES):
            self._spares.append(self._spawn())

    def _spawn(self) -> int:
        wid = self._next_wid
        self._next_wid += 1
        q, out = self._ctx.Queue(), self._ctx.Queue()
        p = self._ctx.Process(
            target=process_main,
            args=(wid, q, out, self._heartbeat_s, self._faults,
                  self._device),
            daemon=True, name=f"repro-torch-fleet-w{wid}")
        p.start()
        self._procs[wid] = p
        self._queues[wid] = q
        self._outboxes[wid] = out
        t = threading.Thread(target=self._forward, args=(wid, out),
                             daemon=True, name=f"repro-torch-fleet-fwd-w{wid}")
        t.start()
        self._forwarders.append(t)
        return wid

    def _forward(self, wid: int, out) -> None:
        """Move worker ``wid``'s messages into the inbox until the fleet
        closes, or the worker is reaped and its queue is empty."""
        while not self._closing:
            try:
                msg = out.get(timeout=0.25)
            except queue_mod.Empty:
                if wid in self._reaped:
                    return
                continue
            except (EOFError, OSError):
                return
            self._inbox.put(msg)

    def spawn_worker(self) -> int:
        # promote a live hot spare if one is up: it is already booted
        # (and typically greeted), so the slot refills instantly; the
        # fresh boot happens on the NEW spare, off the critical path
        while self._spares:
            wid = self._spares.pop(0)
            if self._procs[wid].is_alive():
                self.n_promotions += 1
                self._spares.append(self._spawn())
                return wid
            self._reaped.add(wid)  # spare died while idle: skip it
        return self._spawn()

    def poll(self, timeout: float) -> Optional[Dict[str, Any]]:
        try:
            if timeout <= 0:
                return self._inbox.get_nowait()
            return self._inbox.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def send(self, wid: int, msg: Dict[str, Any]) -> None:
        self._queues[wid].put(msg)

    def dispatchable(self) -> List[int]:
        """Workers a unit can be sent to right now (spares are held in
        reserve: they only take work once promoted by a death)."""
        return [w for w, p in self._procs.items()
                if w not in self._reaped and w not in self._spares
                and p.is_alive()]

    def n_eligible(self, suspect) -> int:
        """Workers that could ever take work (degradation trigger).
        Suspects don't count: a wedged worker is alive but written off
        until it speaks again — waiting on it could wedge the study.
        Spares don't count either: with respawns exhausted they are
        never promoted, and waiting on one would wedge the study."""
        return len([w for w in self.dispatchable() if w not in suspect])

    def reap_dead(self) -> List[int]:
        # a dead hot spare held no lease and no slot: replace it
        # silently rather than reporting a worker death
        for wid in list(self._spares):
            if not self._procs[wid].is_alive():
                self._spares.remove(wid)
                self._reaped.add(wid)
                self._spares.append(self._spawn())
        dead = [w for w, p in self._procs.items()
                if w not in self._reaped and w not in self._spares
                and not p.is_alive()]
        self._reaped.update(dead)
        return dead

    def close(self) -> None:
        self._closing = True
        for wid, p in self._procs.items():
            if p.is_alive():
                try:
                    self._queues[wid].put({"type": "shutdown"})
                except Exception:
                    pass
        deadline = time.monotonic() + 2.0
        for p in self._procs.values():
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=0.5)
                if p.is_alive():
                    p.kill()
        for t in self._forwarders:
            t.join(timeout=0.5)
        for q in list(self._queues.values()) + \
                list(self._outboxes.values()):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass


class _SocketFleet:
    """Socket-transport fleet behind the authenticated frame codec
    (:mod:`.transport`): every connection must greet with a signed hello
    before its worker id exists coordinator-side, every frame is
    HMAC-verified, length-capped *before* allocation and bounded in read
    time, and a frame that fails any gate produces a ``frame_reject``
    inbox message plus a dropped connection — never a wedged reader.

    A dropped connection is a *disconnect*, not a death: workers re-dial
    (:func:`~repro_torch.core.tune_service.worker.socket_main`) and a
    re-greet under a known id atomically swaps the connection back in.
    Only a self-spawned worker's process sentinel proves death; external
    workers (``spec.hosts`` non-empty, launched by ``python -m
    repro_torch.launch.fleet``) are
    never declared dead — a silent one expires its lease and is written
    off as suspect until it speaks again."""

    def __init__(self, n: int, heartbeat_s: float, faults: FaultPlan,
                 device: str, spec: Optional[FleetSpec] = None):
        if spec is None:
            # self-contained fleet: mint an ephemeral key for this run
            spec = FleetSpec.generate(workers=n, heartbeat_s=heartbeat_s)
        self.spec = spec
        self._key = spec.key_bytes
        self._srv = socket.create_server((spec.host, spec.port))
        self.address: Tuple[str, int] = self._srv.getsockname()[:2]
        self._inbox: "queue_mod.Queue" = queue_mod.Queue()
        self._heartbeat_s = heartbeat_s
        self._lock = threading.Lock()
        self._chans: Dict[int, FrameChannel] = {}
        self._dc: set = set()      # disconnected (may re-dial); not dead
        self._reaped: set = set()  # provably dead (process sentinel)
        self._closing = False
        self._boot_deadline = time.monotonic() + spec.boot_grace_s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="repro-torch-fleet-accept")
        self._accept_thread.start()
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")  # never fork: see _ProcessFleet
        self._faults = faults
        self._device = device
        self._procs: Dict[int, Any] = {}
        self._next_wid = 0
        if not spec.external:
            for _ in range(n):
                self.spawn_worker()

    def spawn_worker(self) -> int:
        if self.spec.external:
            return -1  # externally-launched workers cannot be respawned
        wid = self._next_wid
        self._next_wid += 1
        p = self._ctx.Process(
            target=socket_main,
            args=(self.address, wid, self._heartbeat_s, self._faults,
                  self._device),
            kwargs={"key": self._key,
                    "max_frame": self.spec.max_frame_bytes,
                    "frame_timeout_s": self.spec.frame_timeout_s,
                    "max_redials": self.spec.max_redials,
                    "redial_backoff_s": self.spec.redial_backoff_s,
                    "net_delay_s": self._faults.net_delay_s},
            daemon=True, name=f"repro-torch-fleet-w{wid}")
        p.start()
        self._procs[wid] = p
        return wid

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket) -> None:
        chan = FrameChannel(conn, self._key,
                            max_frame=self.spec.max_frame_bytes,
                            frame_timeout_s=self.spec.frame_timeout_s)
        try:
            wid = accept_greet(chan)
        except (FrameError, EOFError, OSError) as e:
            # an unauthenticated stranger (or a garbled greet): no worker
            # id was ever established, so nothing is leased and nothing
            # reaches the journal — count it and drop the connection
            self._inbox.put({"type": "frame_reject", "worker": None,
                             "reason": reject_reason(e)})
            chan.close()
            return
        with self._lock:
            old = self._chans.get(wid)
            self._chans[wid] = chan
            self._dc.discard(wid)
        if old is not None:
            old.close()  # a re-greet supersedes the stale connection
        self._inbox.put({"type": "hello", "worker": wid})
        try:
            while True:
                try:
                    msg = chan.recv()
                except FrameReplayError as e:
                    # an authentic frame out of sequence (a replayed
                    # copy): it was read whole and the channel's counter
                    # did not move, so the stream stays in step -- count
                    # it and read on.  Dropping the connection here would
                    # make the worker re-greet while a lease issued after
                    # the original (in the window before this read) is
                    # live: a journaled reconnect, or a reject charged to
                    # the wrong unit, that depends on timing
                    self._inbox.put({"type": "frame_reject", "worker": wid,
                                     "reason": reject_reason(e),
                                     "stale": True})
                    continue
                if msg is not None:
                    self._inbox.put(msg)
        except (EOFError, OSError):
            pass  # a disconnect: the worker may re-dial and re-greet
        except FrameError as e:
            # an authenticated connection produced an invalid frame: the
            # stream cannot be trusted past this point — reject + drop
            self._inbox.put({"type": "frame_reject", "worker": wid,
                             "reason": reject_reason(e)})
        finally:
            with self._lock:
                if self._chans.get(wid) is chan:
                    self._dc.add(wid)
            chan.close()

    def poll(self, timeout: float) -> Optional[Dict[str, Any]]:
        try:
            if timeout <= 0:
                return self._inbox.get_nowait()
            return self._inbox.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def send(self, wid: int, msg: Dict[str, Any]) -> None:
        with self._lock:
            chan = self._chans.get(wid)
        if chan is None:
            raise OSError(f"worker {wid} has no live connection")
        chan.send(msg)

    def dispatchable(self) -> List[int]:
        with self._lock:
            return [w for w in self._chans
                    if w not in self._dc and w not in self._reaped]

    def n_eligible(self, suspect) -> int:
        # self-spawned workers count while their PROCESS is alive even if
        # the connection is down (they are redialing — that is the point
        # of reconnect); externals count while connected, plus the ones
        # still expected to greet within the boot grace window
        with self._lock:
            if self._procs:
                live = sum(1 for w, p in self._procs.items()
                           if w not in self._reaped and w not in suspect
                           and p.is_alive())
                ext = sum(1 for w in self._chans
                          if w not in self._dc and w not in self._reaped
                          and w not in suspect and w not in self._procs)
                return live + ext
            live = sum(1 for w in self._chans
                       if w not in self._dc and w not in self._reaped
                       and w not in suspect)
            if time.monotonic() < self._boot_deadline:
                live += max(0, self.spec.workers - len(self._chans))
            return live

    def reap_dead(self) -> List[int]:
        # only a process sentinel proves death now that connections
        # reconnect; a silent external worker is handled by lease expiry
        with self._lock:
            dead = {w for w, p in self._procs.items()
                    if w not in self._reaped and not p.is_alive()}
            self._reaped.update(dead)
        return sorted(dead)

    def close(self) -> None:
        self._closing = True
        for wid in self.dispatchable():
            try:
                self.send(wid, {"type": "shutdown"})
            except (OSError, FrameError):
                pass
        try:
            self._srv.close()
        except OSError:
            pass
        deadline = time.monotonic() + 2.0
        for p in self._procs.values():
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=0.5)
                if p.is_alive():
                    p.kill()
        with self._lock:
            for chan in self._chans.values():
                chan.close()


class FleetExecutor:
    """``workers`` remote evaluation slots behind the lease-and-commit
    protocol, committed in canonical unit-creation order.  Drop-in for
    :class:`~repro_torch.core.tune_service.executor.TrialExecutor`.

    ``device`` is where the workers evaluate (the study's
    ``SimOptions.device``); each warms it up before it greets.
    ``busy_s`` is slot *occupancy* — wall time leases were held (issue to
    result, or to fault detection for expired leases) — not worker-side
    compute time: a coordinator doesn't control its workers' clocks, and
    occupancy is what the utilization receipt must measure (an aborted
    attempt occupied its slot; only detection/respawn/backoff gaps and
    starvation count as idle)."""

    def __init__(self, workers: int, pool: str = "process",
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 lease_deadline: int = DEFAULT_LEASE_DEADLINE,
                 timeout_s: Optional[float] = None,
                 faults: FaultPlan = NO_FAULTS,
                 max_respawns: Optional[int] = None,
                 fleet_spec: Optional[FleetSpec] = None,
                 device: str = "cuda"):
        if fleet_spec is not None:
            if pool != "socket":
                raise ValueError(
                    f"fleet_spec describes a socket fleet; got "
                    f"pool={pool!r}")
            # the spec is the deployment artifact: the externally-launched
            # workers run with ITS heartbeat/transport parameters, so the
            # coordinator must agree with it, not with ad-hoc overrides
            workers = fleet_spec.workers
            heartbeat_s = fleet_spec.heartbeat_s
            lease_deadline = fleet_spec.lease_deadline
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if pool not in FLEET_POOLS:
            raise ValueError(f"unknown fleet pool {pool!r}; expected one "
                             f"of {FLEET_POOLS}")
        if lease_deadline < 1:
            raise ValueError("lease_deadline must be >= 1 heartbeat")
        self.slots = int(workers)
        self.pool_kind = pool
        self.heartbeat_s = float(heartbeat_s)
        self.lease_deadline = int(lease_deadline)
        self.timeout_s = timeout_s
        self.faults = faults if faults is not None else NO_FAULTS
        self.max_respawns = int(max_respawns) if max_respawns is not None \
            else int(workers)
        self.device = str(device)
        if pool == "process":
            self._fleet = _ProcessFleet(self.slots, self.heartbeat_s,
                                        self.faults, self.device)
        else:
            self._fleet = _SocketFleet(self.slots, self.heartbeat_s,
                                       self.faults, self.device,
                                       spec=fleet_spec)
        # unit state, keyed by canonical sequence number
        self._specs: Dict[int, Tuple[Callable, tuple, Optional[float]]] = {}
        self._queue: "collections.deque[Tuple[int, float]]" = \
            collections.deque()
        self._ready: Dict[int, Dict[str, Any]] = {}
        self._leases: Dict[int, Dict[str, Any]] = {}
        self._history: Dict[int, List[Dict[str, Any]]] = {}
        self._attempts: Dict[int, int] = {}
        self._digest: Dict[int, Optional[bytes]] = {}
        self._busy: Dict[int, int] = {}       # worker id -> unit seq
        self._suspect: set = set()            # wedged until they speak
        # workers that have spoken (hello or any later message).  A unit
        # is only ever leased to a greeted worker: a spawned process that
        # is still booting (a spawned worker imports torch, starts CUDA
        # and loads the kernels: seconds) is not an issue target, and
        # leasing against it would start the silence clock on a worker
        # that cannot heartbeat yet — the lease would expire through no
        # fault of the protocol.  Booting workers still count as
        # *eligible* (they are on their way), so the coordinator does not
        # degrade to its local slot during a respawn.
        self._greeted: set = set()
        # the silence clock: seconds the coordinator spent listening.  A
        # lease is judged on the silence it kept while the coordinator
        # was reading its inbox, never on time the coordinator itself
        # was away (a long ask, a descheduled or frozen host): after such
        # a gap the workers' heartbeats may not have been sent or read
        # yet, and wall time would convict every live lease at once
        self._listened = 0.0
        self._ticked = time.monotonic()
        self._next_seq = 0
        self._next_commit = 0
        self.busy_s = 0.0
        # local degradation slot (lazy)
        self._local = None
        self._local_futs: Dict[int, Tuple[Any, float]] = {}
        # receipts
        self.n_reissues = 0
        self.n_expired = 0
        self.n_worker_deaths = 0
        self.n_respawns = 0
        self.n_duplicates = 0
        self.n_reconnects = 0
        self.n_rejected_frames = 0
        self.reissue_overhead_s = 0.0
        self.recover_s: List[float] = []
        self.degraded = False
        #: the workers' kernel launches, summed over every result that
        #: carried them (kernel -> variant -> count)
        self.kernel_launches: Dict[str, Dict[str, int]] = {}

    # -- submission --------------------------------------------------------
    def submit(self, fn: Callable[..., Dict[str, Any]], *args,
               timeout_s: Optional[float] = None) -> int:
        seq = self._next_seq
        self._next_seq += 1
        t = timeout_s if timeout_s is not None else self.timeout_s
        self._specs[seq] = (fn, args, t)
        self._history[seq] = []
        self._attempts[seq] = 0
        self._queue.append((seq, 0.0))
        self._pump(block=False)
        return seq

    def submit_ready(self, result: Dict[str, Any]) -> int:
        """A pre-resolved unit (journal-replay cache hit): holds its
        canonical commit slot, never touches the fleet."""
        seq = self._next_seq
        self._next_seq += 1
        self._ready[seq] = dict(result)
        return seq

    @property
    def outstanding(self) -> int:
        return self._next_seq - self._next_commit

    # -- canonical-order commits ------------------------------------------
    def pop_next(self) -> Tuple[int, Dict[str, Any]]:
        seq = self._next_commit
        while seq not in self._ready:
            self._pump(block=True)
        result = self._ready.pop(seq)
        self._digest[seq] = _result_digest(result)
        self._specs.pop(seq, None)
        self._attempts.pop(seq, None)
        self._next_commit += 1
        return seq, result

    def take_history(self, seq: int) -> List[Dict[str, Any]]:
        """The unit's lease lifecycle events, for commit-time journaling."""
        return self._history.pop(seq, [])

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """The socket fleet's bound (host, port); None for process pools."""
        return getattr(self._fleet, "address", None)

    # -- the pump: messages, liveness, leases, dispatch --------------------
    def _pump(self, block: bool) -> None:
        msg = self._fleet.poll(min(self.heartbeat_s, 0.05) if block else 0.0)
        self._tick()
        while msg is not None:
            self._handle(msg)
            msg = self._fleet.poll(0.0)
        self._check_workers()
        self._check_leases()
        self._check_local()
        self._dispatch()

    def _handle(self, msg: Dict[str, Any]) -> None:
        kind = msg.get("type")
        wid = msg.get("worker")
        if kind == "frame_reject":
            # the transport rejected a frame (bad signature, oversize,
            # truncated, ...) and dropped the connection.  If the sender
            # held a live lease, the lease cannot be trusted to complete —
            # journal the reject into the unit's history (at commit time,
            # like every lease event) and expire it.  A reject with no
            # live lease (an unauthenticated stranger) and a replayed
            # frame (``stale``: the connection stays up, nothing is lost)
            # touch stats only: journaling them would be
            # wall-clock-dependent.
            self.n_rejected_frames += 1
            if wid is None or msg.get("stale"):
                return
            # the reader drops this connection after it queued the
            # reject: no unit goes to the worker until it greets again,
            # or a re-issue could be sent down the closing connection and
            # the re-greet journal a timing-dependent reconnect
            self._greeted.discard(wid)
            seq = self._busy.get(wid)
            lease = self._leases.get(seq) if seq is not None else None
            if lease is not None and lease["worker"] == wid:
                self._busy.pop(wid, None)
                self._history[seq].append(
                    {"event": "reject", "unit": seq,
                     "attempt": lease["attempt"],
                     "reason": msg.get("reason", "frame")})
                self._expire(seq, "reject")
            return
        if wid is not None:
            self._suspect.discard(wid)
            self._greeted.add(wid)
        if kind == "hello":
            # a re-greet from a worker we believe is busy: its connection
            # dropped and it re-dialed.  If the lease is still live,
            # re-attach it (refresh the silence clock, journal the
            # reconnect at commit); if it already expired, leave the
            # worker marked busy — it is still evaluating its old unit
            # and will tell us (result, or idle heartbeat) when it frees
            seq = self._busy.get(wid)
            if seq is not None:
                lease = self._leases.get(seq)
                if lease is not None and lease["worker"] == wid:
                    self._heard(lease)
                    self.n_reconnects += 1
                    self._history[seq].append(
                        {"event": "reconnect", "unit": seq,
                         "attempt": lease["attempt"]})
            return
        if kind == "heartbeat":
            unit = msg.get("unit")
            if unit is None:
                # an idle heartbeat from a worker we believe is busy means
                # its result was lost in flight — expire the lease now
                seq = self._busy.get(wid)
                if seq is not None:
                    lease = self._leases.get(seq)
                    if lease is None:
                        # the lease already resolved without this worker
                        # (rejected frame, expiry + late twin): the worker
                        # is demonstrably idle again — free its slot
                        self._busy.pop(wid, None)
                    elif lease["worker"] == wid and \
                            time.monotonic() - lease["issued"] > \
                            3 * self.heartbeat_s:
                        self._busy.pop(wid, None)
                        self._expire(seq, "lost")
                return
            lease = self._leases.get(unit)
            if lease is not None and lease["worker"] == wid and \
                    lease["attempt"] == msg.get("attempt"):
                self._heard(lease)
            return
        if kind == "result":
            seq = int(msg["unit"])
            held = self._leases.get(seq)
            if self._busy.get(wid) == seq and not (
                    held is not None and held["worker"] == wid
                    and held["attempt"] != msg.get("attempt")):
                # a worker is free once it reports the attempt it holds.
                # A stale attempt's result -- the one a truncated frame or
                # a partition cut off, re-sent after the re-greet while
                # the worker already runs the unit's re-issue -- leaves it
                # busy: freeing it would book a second unit onto a busy
                # worker, which refuses it ("worker busy"), a journaled
                # retry that depends on timing
                self._busy.pop(wid)
            result = dict(msg["result"])
            self._count_launches(result.pop(LAUNCHES_KEY, {}))
            if seq < self._next_commit or seq in self._ready:
                # a duplicate or late twin: first commit won; assert the
                # twin returned the SAME bits (placement invariance).  The
                # twin's runtime is wasted occupancy: the slot was busy,
                # the work was redundant
                self._assert_twin(seq, result)
                self.n_duplicates += 1
                self.busy_s += float(result.get("slot_s", 0.0))
                self.reissue_overhead_s += float(result.get("slot_s", 0.0))
                return
            lease = self._leases.pop(seq, None)
            if lease is None and seq not in self._attempts:
                return  # unit unknown (e.g. surrendered and committed)
            # accept whichever attempt lands first; cancel any queued
            # re-issue of the same unit
            self._unqueue(seq)
            if lease is not None:
                # slot occupancy: wall time the lease was held, issue to
                # result — NOT worker-reported compute time, which a
                # coordinator doesn't control (and which shrinks under
                # less CPU contention, masking idle slots)
                self.busy_s += time.monotonic() - lease["issued"]
            self._ready[seq] = result
            return

    def _count_launches(self, launches: Dict[str, Dict[str, int]]) -> None:
        for name, by_variant in launches.items():
            total = self.kernel_launches.setdefault(name, {})
            for variant, n in by_variant.items():
                total[variant] = total.get(variant, 0) + int(n)

    def _assert_twin(self, seq: int, result: Dict[str, Any]) -> None:
        want = self._digest.get(seq, _result_digest(self._ready.get(seq, {})))
        got = _result_digest(result)
        if want is not None and got is not None and want != got:
            raise RuntimeError(
                f"duplicate execution of unit {seq} returned different "
                f"bits — the evaluation is not placement-invariant (this "
                f"is a determinism bug, not a fleet fault)")

    def _unqueue(self, seq: int) -> None:
        for entry in list(self._queue):
            if entry[0] == seq:
                self._queue.remove(entry)

    def _check_workers(self) -> None:
        for wid in self._fleet.reap_dead():
            self.n_worker_deaths += 1
            self._suspect.discard(wid)
            seq = self._busy.pop(wid, None)
            if seq is not None and seq in self._leases:
                self._expire(seq, "worker-dead")
            if self.n_respawns < self.max_respawns:
                self.n_respawns += 1
                self._fleet.spawn_worker()

    def _tick(self) -> None:
        """Advance the silence clock by the time since the last tick, up
        to one heartbeat: a longer gap is time the coordinator was not
        listening."""
        now = time.monotonic()
        self._listened += min(now - self._ticked, self.heartbeat_s)
        self._ticked = now

    def _heard(self, lease: Dict[str, Any]) -> None:
        lease["last_seen"] = time.monotonic()
        lease["heard"] = self._listened

    def _check_leases(self) -> None:
        silence = self.heartbeat_s * self.lease_deadline
        for seq, lease in list(self._leases.items()):
            if self._listened - lease["heard"] > silence:
                # wedged, not provably dead: write the worker off until it
                # speaks again, but leave it marked busy (never re-booked)
                self._suspect.add(lease["worker"])
                self._expire(seq, "expired")

    def _expire(self, seq: int, reason: str) -> None:
        lease = self._leases.pop(seq, None)
        if lease is None:
            return
        now = time.monotonic()
        attempt = lease["attempt"]
        self.n_expired += 1
        self.recover_s.append(now - lease["last_seen"])
        # the doomed attempt occupied its slot from issue until the fault
        # was detected: wasted occupancy, not idle time — count it as
        # both busy and re-issue overhead so utilization measures idle
        # slots and reissue_overhead_s measures burned wall clock
        held = max(0.0, now - lease["issued"])
        self.busy_s += held
        self.reissue_overhead_s += held
        self._history[seq].append(
            {"event": "expire", "unit": seq, "attempt": attempt,
             "reason": reason})
        nxt = attempt + 1
        if nxt >= MAX_ATTEMPTS:
            self._ready[seq] = {
                "error": f"lease expired {nxt} times (unit {seq}, last "
                         f"reason: {reason}); the fleet could not complete "
                         f"this unit", "slot_s": 0.0}
            return
        self._attempts[seq] = nxt
        self.n_reissues += 1
        self._history[seq].append(
            {"event": "reissue", "unit": seq, "attempt": nxt})
        # the first re-issue goes out immediately (the expiry already cost
        # detection latency); repeated failures of the SAME unit back off
        self._queue.appendleft((seq, now + REISSUE_BACKOFF_S * (nxt - 1)))

    def _dispatch(self) -> None:
        while self._queue:
            seq, not_before = self._queue[0]
            now = time.monotonic()
            if not_before > now:
                break  # re-issue backoff; re-checked on the next pump
            wid = self._idle_worker()
            if wid is None:
                if self._fleet.n_eligible(self._suspect) == 0:
                    self._queue.popleft()
                    self._run_local(seq)
                    continue
                break
            self._queue.popleft()
            attempt = self._attempts[seq]
            fn, args, t = self._specs[seq]
            try:
                self._fleet.send(wid, {"type": "unit", "unit": seq,
                                       "attempt": attempt, "fn": fn,
                                       "args": args, "timeout_s": t})
            except (OSError, FrameError):
                # the connection dropped under us (socket transport): the
                # unit was never leased — requeue it and try other workers
                self._queue.appendleft((seq, now))
                self._greeted.discard(wid)
                continue
            self._leases[seq] = {"worker": wid, "attempt": attempt,
                                 "issued": now, "last_seen": now,
                                 "heard": self._listened}
            self._busy[wid] = seq
            if attempt == 0:
                self._history[seq].append(
                    {"event": "lease", "unit": seq, "attempt": 0,
                     "deadline": self.lease_deadline})

    def _idle_worker(self) -> Optional[int]:
        for wid in self._fleet.dispatchable():
            if wid not in self._busy and wid not in self._suspect \
                    and wid in self._greeted:
                return wid
        return None

    # -- graceful degradation: the coordinator's local slot ----------------
    def _run_local(self, seq: int) -> None:
        if self._local is None:
            import concurrent.futures
            self._local = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="repro-torch-fleet-local")
        self.degraded = True
        attempt = self._attempts[seq]
        fn, args, _ = self._specs[seq]
        if attempt == 0:
            self._history[seq].append(
                {"event": "lease", "unit": seq, "attempt": 0,
                 "deadline": self.lease_deadline})
        self._local_futs[seq] = (self._local.submit(_timed_safe, fn, *args),
                                 time.monotonic())

    def _check_local(self) -> None:
        for seq, (fut, t0) in list(self._local_futs.items()):
            _, _, t = self._specs.get(seq, (None, None, None))
            if fut.done():
                del self._local_futs[seq]
                self.busy_s += time.monotonic() - t0
                self._ready[seq] = fut.result()
            elif t is not None and time.monotonic() - t0 > t:
                fut.cancel()
                del self._local_futs[seq]
                self.busy_s += time.monotonic() - t0
                self._ready[seq] = {
                    "error": f"timeout: unit {seq} exceeded {t}s on the "
                             f"local degradation slot", "timeout": True,
                    "slot_s": float(t)}

    # -- receipts / shutdown ----------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "workers": self.slots,
            "pool": self.pool_kind,
            "n_reissues": self.n_reissues,
            "n_expired_leases": self.n_expired,
            "n_worker_deaths": self.n_worker_deaths,
            "n_respawns": self.n_respawns,
            "n_spare_promotions": getattr(self._fleet, "n_promotions", 0),
            "n_duplicate_results": self.n_duplicates,
            "n_reconnects": self.n_reconnects,
            "n_rejected_frames": self.n_rejected_frames,
            "reissue_overhead_s": float(self.reissue_overhead_s),
            "time_to_recover_s": [float(x) for x in self.recover_s],
            "degraded": self.degraded,
            "kernel_launches": {name: dict(by_variant) for name, by_variant
                                in sorted(self.kernel_launches.items())},
        }

    def close(self) -> None:
        self._fleet.close()
        if self._local is not None:
            self._local.shutdown(wait=False, cancel_futures=True)
