"""Bring up a tune-service worker fleet of the port from ONE frozen
FleetSpec.

The spec file (:class:`repro_torch.core.tune_service.FleetSpec`) is the
whole hand-off between the coordinator host and the worker hosts: bind
address, shared auth key, worker count / host list, heartbeat + lease
parameters and the transport caps.  This launcher turns it into running
workers:

initialize a spec (mints a fresh 32-byte auth key, picks a free port;
the file is written with mode 0600; the workers' hosts default to the
coordinator's host, one entry per worker)::

    python -m repro_torch.launch.fleet fleet.json --init --workers 4 \
        [--hosts h1,h2,h3,h4]

start the coordinator against it (any host that can reach the workers;
``pool="socket"`` is implied by the spec)::

    Study(spec).tune(executor="fleet", scheduler="asha",
                     fleet_spec=FleetSpec.load("fleet.json"),
                     journal="study.jsonl")

bring up the workers:

* **local mode** (every host of the spec a loopback address): starts
  ``workers`` subprocesses of ``python -m
  repro_torch.core.tune_service.worker``, passes the auth key in the
  ``REPRO_FLEET_KEY`` environment variable (argv is visible in ``ps``;
  the key must not be), health-checks every
  greet by watching the workers' output for the ``worker N greeted``
  line, and stops the fleet (SIGTERM, then SIGKILL) on exit, on Ctrl-C
  and on SIGTERM::

      python -m repro_torch.launch.fleet fleet.json [--device cuda|cpu]

* **remote mode** (any other host, or ``--print``): prints one
  ready-to-run command per host, without the key -- run each on its host
  next to a copy of the spec file; the workers re-dial with backoff until
  the coordinator is up, and reconnect if the link drops::

      python -m repro_torch.launch.fleet fleet.json --print

A spec with no hosts describes a fleet the coordinator spawns itself
(``FleetSpec.generate()`` in code); the launcher refuses it, since its
workers would take the same ids as the coordinator's.  Each worker starts
CUDA on ``--device`` (default ``cuda``) and loads the ``select_topk``
kernels before it greets; ``--device cpu`` runs the plain versions.  It
must be the study's ``SimOptions.device``: a worker answers a unit for
another device with an error result.  The
spec file holds the fleet's shared secret: keep it out of version control
and world-readable paths.
"""

from __future__ import annotations

import argparse
import os
import queue
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..core.tune_service.transport import FleetSpec
from ..core.tune_service.worker import KEY_ENV

#: the announce line a worker prints once its greet was welcomed
GREETED = "greeted"
#: the directory holding the ``repro_torch`` package (the workers'
#: ``PYTHONPATH``)
SRC = Path(__file__).resolve().parents[2]
WORKER_MODULE = "repro_torch.core.tune_service.worker"


def _loopback(host: str) -> bool:
    return host in ("localhost", "::1") or host.startswith("127.")


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def worker_command(spec_path: str, worker_id: int, python: str = "python",
                   device: str = "cuda") -> str:
    """The per-host worker invocation (the auth key travels in the spec
    file or ``REPRO_FLEET_KEY``, never on argv)."""
    return (f"{python} -m {WORKER_MODULE} --fleet-spec "
            f"{shlex.quote(spec_path)} --id {worker_id} "
            f"--device {shlex.quote(device)}")


class LocalFleet:
    """``spec.workers`` local socket workers, health-checked by their greet
    announces and stopped on :meth:`terminate`.  Context-manageable."""

    def __init__(self, spec: FleetSpec, spec_path: str,
                 device: str = "cuda"):
        self.spec = spec
        self.spec_path = spec_path
        self._lines: "queue.Queue[str]" = queue.Queue()
        self.greeted: set = set()
        env = dict(os.environ, **{KEY_ENV: spec.auth_key})
        env["PYTHONPATH"] = str(SRC) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.procs: List[subprocess.Popen] = []
        try:
            for i in range(spec.workers):
                p = subprocess.Popen(
                    [sys.executable, "-m", WORKER_MODULE, "--fleet-spec",
                     spec_path, "--id", str(i), "--device", device],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env)
                self.procs.append(p)
                threading.Thread(target=self._pump, args=(p,),
                                 daemon=True).start()
        except BaseException:
            self.terminate()
            raise

    def _pump(self, p: subprocess.Popen) -> None:
        for line in p.stdout:
            self._lines.put(line.rstrip())

    def wait_greeted(self, timeout_s: float = 60.0,
                     echo: bool = False) -> bool:
        """Health-check: every worker presented its signed greet and was
        welcomed (needs the coordinator up -- the workers re-dial with
        backoff until it is)."""
        deadline = time.monotonic() + timeout_s
        while len(self.greeted) < self.spec.workers:
            try:
                line = self._lines.get(
                    timeout=max(0.01, deadline - time.monotonic()))
            except queue.Empty:
                return False
            if echo:
                print(f"  {line}", flush=True)
            if GREETED in line:
                try:
                    self.greeted.add(int(line.split()[1]))
                except (IndexError, ValueError):
                    pass
            if time.monotonic() > deadline:
                return False
        return True

    @property
    def alive(self) -> int:
        return sum(1 for p in self.procs if p.poll() is None)

    def join(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass

    def terminate(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        self.join(2.0)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
            if p.stdout is not None:
                p.stdout.close()

    def __enter__(self) -> "LocalFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


def _interrupt(signum, frame):
    raise KeyboardInterrupt  # SIGTERM stops the fleet as Ctrl-C does


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fleet",
        description=__doc__.splitlines()[0] + " " + __doc__.splitlines()[1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("spec", metavar="SPEC.json", help="fleet spec file")
    ap.add_argument("--init", action="store_true",
                    help="write a fresh spec (new auth key, free port) "
                         "instead of launching")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker count for --init")
    ap.add_argument("--host", default="127.0.0.1",
                    help="coordinator bind host for --init")
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port for --init (default: pick a "
                         "free one)")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated worker hosts for --init, one "
                         "per worker (default: --host for each)")
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="heartbeat cadence for --init")
    ap.add_argument("--device", default="cuda",
                    help="device the workers evaluate on (default cuda)")
    ap.add_argument("--print", dest="print_only", action="store_true",
                    help="print per-host worker commands, launch nothing")
    ap.add_argument("--greet-timeout", type=float, default=60.0,
                    help="seconds to wait for every worker's greet")
    args = ap.parse_args(argv)

    if args.init:
        kw = {"workers": args.workers, "host": args.host,
              "port": args.port if args.port is not None
              else _free_port(args.host)}
        kw["hosts"] = tuple(h.strip() for h in args.hosts.split(",")) \
            if args.hosts else (args.host,) * args.workers
        if args.heartbeat is not None:
            kw["heartbeat_s"] = args.heartbeat
        spec = FleetSpec.generate(**kw)
        spec.save(args.spec)
        print(f"wrote {args.spec}: {spec.workers} workers, coordinator "
              f"{spec.host}:{spec.port} (auth key minted; file mode 0600)")
        return 0

    spec = FleetSpec.load(args.spec)
    if spec.port == 0:
        print("spec has port 0 (ephemeral): launched workers could not "
              "find the coordinator; --init again with a fixed port",
              file=sys.stderr)
        return 2

    if not spec.external:
        print("spec lists no hosts: the coordinator spawns its workers "
              "itself; --init again (hosts default to the coordinator's)",
              file=sys.stderr)
        return 2
    if args.print_only or not all(map(_loopback, spec.hosts)):
        hosts = spec.hosts
        print(f"# coordinator: bind {spec.host}:{spec.port} "
              f"(Study.tune(executor='fleet', fleet_spec=...))")
        print(f"# copy {args.spec} to each worker host (mode 0600), then:")
        for i, h in enumerate(hosts):
            print(f"{h}$ {worker_command(args.spec, i, device=args.device)}")
        return 0

    signal.signal(signal.SIGTERM, _interrupt)
    with LocalFleet(spec, args.spec, device=args.device) as fleet:
        print(f"launched {spec.workers} workers -> "
              f"{spec.host}:{spec.port}; waiting for greets "
              f"(the workers re-dial until the coordinator is up)",
              flush=True)
        try:
            ok = fleet.wait_greeted(args.greet_timeout, echo=True)
            if not ok and fleet.alive < spec.workers:
                print("some workers exited before greeting (wrong key? "
                      "coordinator unreachable?)", file=sys.stderr)
                return 1
            if ok:
                print(f"all {spec.workers} workers greeted; serving until "
                      f"the coordinator shuts the fleet down (Ctrl-C to "
                      f"stop)", flush=True)
            while fleet.alive:
                time.sleep(0.25)
        except KeyboardInterrupt:
            pass
    print("fleet stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
