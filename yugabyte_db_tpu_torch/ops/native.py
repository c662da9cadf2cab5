"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, at first use, and
loaded with ``ctypes``. The library's file name carries a hash of its
source, so an edited source never loads a stale build. ``nvcc``'s output
(``-Xptxas -v``: registers, stack frames, spills) is kept beside the
library as ``lib<name>-<hash>.log``, so ``build_logs`` holds it also when
every library was built by an earlier process. Nothing here runs
when the module is imported: the CPU tests import every module on a host
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output of the build of each kernel (registers, spills), from
# this process's build or from the log kept beside a cached library.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return str(path)


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """Where ``nvcc``'s output for ``library_path(name)`` is kept."""
    return library_path(name).with_suffix(".log")


def build(names) -> None:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together; read the kept log of each one cached."""
    todo = [n for n in names if not library_path(n).exists()]
    for name in names:
        if name not in todo and name not in build_logs and \
                log_path(name).exists():
            build_logs[name] = log_path(name).read_text()
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        log_tmp = log_path(name).with_suffix(f".{os.getpid()}.logtmp")
        log_tmp.write_text(log)
        os.replace(log_tmp, log_path(name))  # before the library: a
        os.replace(tmp, target)              # cached library has its log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
