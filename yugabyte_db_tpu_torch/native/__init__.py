"""The port's native (C++) host components, built at first use.

Reference analog: the JAX package's ``native/`` extensions (its
``native/Makefile``). The port keeps its own copy of the sources here and
builds them itself, so it reads nothing of the JAX package:

- ``yb_codec`` (``codec.cc`` over ``tagcodec.h``): the tagged binary
  codec that frames every RPC payload and WAL record. The pure-Python
  codec in ``utils/codec.py`` stays as its plain version.

``yb_codec()`` compiles the extension with the system C++ compiler
(``-O3 -fPIC -std=gnu++17 -shared`` and the include path of
``sysconfig``, as the JAX Makefile does) into ``build/torch_native/`` at
the root of the checkout, under a file name that carries a hash of the
sources, so an edited source never loads a stale build. It writes to a
temporary name and renames it into place, so that several processes may
build at once. Nothing is built when this package is imported. The build
needs ``c++`` and ``Python.h``; without them ``yb_codec()`` answers None
and ``build_error`` says why (the callers then take the Python codec).
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXXFLAGS = ("-O3", "-Wall", "-fPIC", "-std=gnu++17", "-shared")
SOURCES = ("codec.cc", "tagcodec.h")

_lock = threading.Lock()
_UNBUILT = object()
_module = _UNBUILT
build_error: str | None = None  # why the module did not build or load


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update((SRC / src).read_bytes())
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    return BUILD_DIR / f"yb_codec-{digest.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile ``yb_codec`` if its library is missing: the library's
    path."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++) on this host")
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").exists():
        raise RuntimeError(f"no Python.h under {include}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
    cmd = [cxx, *CXXFLAGS, f"-I{include}", str(SRC / SOURCES[0]),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def yb_codec():
    """The native codec module, built first if needed; None when it
    cannot be built or loaded here (``build_error`` says why)."""
    global _module, build_error
    with _lock:
        if _module is _UNBUILT:
            try:
                spec = importlib.util.spec_from_file_location("yb_codec",
                                                              build())
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as e:  # noqa: BLE001 — the Python codec serves
                build_error = f"{type(e).__name__}: {e}"
                mod = None
            _module = mod
        return _module
