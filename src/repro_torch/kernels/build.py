"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under the
checkout's ``build/`` directory, and loaded with ``ctypes`` at first use.
Library names carry a hash of the source, of every ``csrc`` header it
includes (``#include "x.cuh"``, followed through headers) and of the nvcc
flags, so an edited kernel, header or flag never loads a stale build.
:func:`build` starts one ``nvcc`` per source that is not built yet, all at
once, and waits for all of them; each build's compiler output is kept
beside its library (:func:`build_log`).  Building and loading hold one
lock, so threads that load one kernel first run one ``nvcc`` between
them.  :func:`count_launch` is the wrappers' launch counter, safe under
threads too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: build outputs: ``<checkout>/build/`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("select_topk", "page_migrate", "paged_attention",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: flags of one kernel on top of NVCC_FLAGS: the kernels with tensor-core
#: or cluster code keep line info and ptxas's register and spill report
#: (``-Xptxas -v``)
PTXAS_REPORT = ("-lineinfo", "-Xptxas", "-v")
KERNEL_FLAGS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": PTXAS_REPORT,
    "paged_attention": PTXAS_REPORT,
    "select_topk": PTXAS_REPORT,
}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LOADED: Dict[str, ctypes.CDLL] = {}
#: held while building or loading (re-entrant: :func:`load` builds)
_BUILD_LOCK = threading.RLock()
#: held while a launch counter is read, bumped or reset
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags kernel ``name`` is built with."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes by a quoted
    ``#include``, followed through included files, in first-seen order."""
    order = [CSRC / f"{name}.cu"]
    i = 0
    while i < len(order):
        for inc in _INCLUDE.findall(order[i].read_text()):
            path = CSRC / inc
            if path.is_file() and path not in order:
                order.append(path)
        i += 1
    return order


def library_path(name: str) -> Path:
    """The shared library built from ``csrc/<name>.cu`` (hash-named)."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler's output of the build of kernel ``name`` ("" if it was
    not built in this checkout)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one
    ``nvcc`` each, all started together; returns each build's seconds
    (0.0 for a library that was already there).  Raises with the
    compiler's output if any build fails."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {name: 0.0 for name in names}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _BUILD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def count_launch(module, variant: Optional[str] = None) -> None:
    """Add one to a kernel wrapper module's ``launches`` and, given
    ``variant``, to its ``launches_by_variant[variant]``: the wrappers
    launch from several threads at once (thread slots of the tune
    service), and ``+=`` on shared state can lose counts."""
    with COUNT_LOCK:
        module.launches += 1
        if variant is not None:
            module.launches_by_variant[variant] += 1
