"""TrialExecutor: N saturated evaluation slots + canonical commit order
(the reference package's executor, with a process pool of its own).

Work units (trial evaluation segments) are enqueued in creation order and
run on whichever of the N slots frees first -- slots never idle while work
is queued, and nothing ever waits on a per-round barrier.  What makes the
asynchrony safe is the COMMIT protocol: results are handed back strictly
in unit-creation order (:meth:`pop_next` blocks on the canonical-next
unit while later finishers buffer), so every decision the service makes --
asks, ASHA promotions, CRN-group tells -- sees a deterministic state no
matter how wall-clock completion interleaved.  Combined with the epoch
loop's counter-based draws (placement-invariant numbers), the entire study
is a pure function of its parameters; the executor only changes how fast
it runs.

Two slot backends:

* ``"thread"`` (default) -- a thread pool in this process: every slot
  shares the process's card and its kernels, and unpicklable custom
  ``objective=`` callables work;
* ``"process"`` -- a process pool owned by the executor, always started
  by ``spawn`` (a process that has started CUDA cannot be forked): each
  worker imports the port afresh, starts CUDA and loads the built kernels
  itself.  Payload functions must be module-level picklables (the
  service's default simulator objective is).

Failures never kill a slot: unit callables are wrapped, exceptions come
back as ``{"error": <traceback>}`` results, and the service records a
FAILED trial and keeps the window full.  Two further slot-level faults are
absorbed here rather than killing the study:

* a hung evaluation -- a per-unit ``timeout_s`` bounds the canonical-next
  wait and converts the unit into an ``{"error": "timeout..."}`` result
  (the wedged slot is abandoned; :meth:`close` terminates a wedged
  process);
* a dead ``pool="process"`` worker -- ``BrokenProcessPool`` poisons every
  pending future of the pool, so the executor discards the broken pool,
  builds a fresh one and resubmits ALL outstanding units.  Results are
  deterministic, so the journal stays byte-identical to a fault-free run;
  only wall-clock suffers.  Rebuilds are bounded
  (:data:`MAX_POOL_REBUILDS`) so a poisoned objective cannot respawn
  forever.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import time
import traceback
from concurrent.futures import BrokenExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

POOLS = ("thread", "process")

#: bound on BrokenProcessPool self-heals per executor
MAX_POOL_REBUILDS = 3
#: seconds :meth:`TrialExecutor.close` gives a process worker to exit
#: before terminating it (a worker left running a timed-out unit)
CLOSE_GRACE_S = 5.0


def _timed_safe(fn: Callable[..., Dict[str, Any]], *args
                ) -> Dict[str, Any]:
    """Run one unit: exceptions -> {"error": traceback}; always stamps the
    slot-occupancy wall clock (``slot_s``) for the utilization receipt.
    Module-level so process pools can pickle it."""
    t0 = time.perf_counter()
    try:
        out = fn(*args)
        if not isinstance(out, dict):
            out = {"value": out}
    except Exception as e:  # noqa: BLE001 - the FAILED-trial contract
        out = {"error": "".join(traceback.format_exception(
            type(e), e, e.__traceback__))}
    out["slot_s"] = time.perf_counter() - t0
    return out


def _process_pool(slots: int) -> cf.ProcessPoolExecutor:
    return cf.ProcessPoolExecutor(
        max_workers=slots, mp_context=multiprocessing.get_context("spawn"))


class TrialExecutor:
    """``slots`` evaluation slots over a thread/process pool, with results
    committed in unit-creation order."""

    def __init__(self, slots: int, pool: str = "thread",
                 timeout_s: Optional[float] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if pool not in POOLS:
            raise ValueError(f"unknown pool {pool!r}; expected one of "
                             f"{POOLS}")
        self.slots = int(slots)
        self.pool_kind = pool
        self.timeout_s = timeout_s  # default per-unit hang bound
        if pool == "process":
            self._pool = _process_pool(self.slots)
        else:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self.slots,
                thread_name_prefix="repro-torch-tune-slot")
        self._futures: Dict[int, Any] = {}
        # (fn, args, timeout_s) per live unit -- resubmission after a pool
        # heal, and the per-unit hang bound
        self._specs: Dict[int, Tuple[Callable, tuple, Optional[float]]] = {}
        self._rebuilds = 0
        self._next_seq = 0
        self._next_commit = 0
        self.busy_s = 0.0  # summed slot occupancy (utilization receipt)

    # -- submission --------------------------------------------------------
    def submit(self, fn: Callable[..., Dict[str, Any]], *args,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue one unit (FIFO; the pool keeps <= slots running).
        Returns the unit's canonical sequence number."""
        seq = self._next_seq
        self._next_seq += 1
        t = timeout_s if timeout_s is not None else self.timeout_s
        self._specs[seq] = (fn, args, t)
        self._futures[seq] = self._safe_submit(fn, args)
        return seq

    def _safe_submit(self, fn: Callable, args: tuple):
        try:
            return self._pool.submit(_timed_safe, fn, *args)
        except BrokenExecutor:
            self._heal()
            return self._pool.submit(_timed_safe, fn, *args)

    def submit_ready(self, result: Dict[str, Any]) -> int:
        """Enqueue a pre-resolved unit (journal-replay cache hit): it holds
        a commit slot in canonical order but occupies no evaluation slot."""
        seq = self._next_seq
        self._next_seq += 1
        self._futures[seq] = dict(result)  # sentinel: plain dict == ready
        return seq

    # -- canonical-order commits ------------------------------------------
    @property
    def outstanding(self) -> int:
        """Units created but not yet committed (the ask-ahead window)."""
        return self._next_seq - self._next_commit

    def pop_next(self) -> Tuple[int, Dict[str, Any]]:
        """Block for the canonical-next unit's result (later finishers
        buffer inside their futures until their turn).  A unit exceeding
        its ``timeout_s`` wait comes back as an ``{"error": "timeout..."}``
        result instead of wedging the study; a dead process-pool worker
        triggers a bounded pool rebuild + resubmission of every
        outstanding unit."""
        seq = self._next_commit
        fut = self._futures.pop(seq)
        if isinstance(fut, dict):
            result = fut
        else:
            _, _, t = self._specs.get(seq, (None, (), None))
            deadline = None if t is None else time.monotonic() + t
            while True:
                try:
                    left = None if deadline is None else \
                        max(0.0, deadline - time.monotonic())
                    result = fut.result(timeout=left)
                    break
                except cf.TimeoutError:
                    fut.cancel()  # queued: freed; running: slot abandoned
                    result = {"error": f"timeout: unit {seq} exceeded "
                                       f"{t}s in the {self.pool_kind} "
                                       f"pool", "timeout": True,
                              "slot_s": float(t)}
                    break
                except BrokenExecutor:
                    # the canonical-next unit was already popped from
                    # _futures, so _heal's resubmission loop misses it --
                    # resubmit it on the fresh pool here
                    self._heal()
                    fn, args, _ = self._specs[seq]
                    fut = self._pool.submit(_timed_safe, fn, *args)
        self._specs.pop(seq, None)
        self._next_commit += 1
        self.busy_s += float(result.get("slot_s", 0.0))
        return seq, result

    def _heal(self) -> None:
        """A broken process pool poisons every pending future: discard it,
        build a fresh pool and resubmit all outstanding units.  Unit
        results are deterministic, so re-execution changes nothing the
        journal sees -- the fault costs wall clock only."""
        if self.pool_kind != "process":
            raise RuntimeError("thread pool broke -- cannot self-heal")
        if self._rebuilds >= MAX_POOL_REBUILDS:
            raise RuntimeError(
                f"process pool broke {self._rebuilds + 1} times "
                f"(> MAX_POOL_REBUILDS={MAX_POOL_REBUILDS}); giving up -- "
                f"the objective is likely killing its workers")
        self._rebuilds += 1
        self._stop_pool()
        self._pool = _process_pool(self.slots)
        for seq, fut in list(self._futures.items()):
            if isinstance(fut, dict):
                continue  # replay cache hit: no evaluation to redo
            fn, args, _ = self._specs[seq]
            self._futures[seq] = self._pool.submit(_timed_safe, fn, *args)

    def take_history(self, seq: int) -> List[Dict[str, Any]]:
        """Lease lifecycle events for commit-time journaling.  Local slots
        have no leases -- the fleet coordinator overrides this."""
        return []

    def _stop_pool(self) -> None:
        """Shut the process pool down and stop its workers: an idle worker
        exits on the shutdown; one still running a unit (timed out, or
        cancelled by :meth:`close`) is terminated after
        :data:`CLOSE_GRACE_S`."""
        procs = list((getattr(self._pool, "_processes", None) or {})
                     .values())
        self._pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + CLOSE_GRACE_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=CLOSE_GRACE_S)

    def close(self) -> None:
        """Shut down, cancelling queued units so an aborted study doesn't
        leave orphan segments burning slots (a running thread unit cannot
        be interrupted, but its result is dropped; a running process unit
        is terminated after :data:`CLOSE_GRACE_S`)."""
        for fut in self._futures.values():
            if not isinstance(fut, dict):
                fut.cancel()
        self._futures.clear()
        self._specs.clear()
        if self.pool_kind == "process":
            self._stop_pool()
        else:
            self._pool.shutdown(wait=True, cancel_futures=True)
