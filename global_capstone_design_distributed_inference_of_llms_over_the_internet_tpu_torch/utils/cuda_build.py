"""Build a ``csrc/`` source into a shared library and load it.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root (listed
in ``.gitignore``), named by a digest of the source and flags so an edited
source rebuilds. Host C++ sources (the wire codec, ``csrc/codec.cpp``) take
the same path through ``g++`` (`load_host_library`). Nothing here runs at
import time: a library builds at its first use, or when ``chip_smoke.py``
builds every kernel up front. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-shared")

# Compiler output of each build in this process (ptxas register / shared
# memory / spill report), keyed by source name, for chip_smoke.py to print.
build_logs: Dict[str, str] = {}
_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(f"no host C++ compiler to build the sources in {CSRC}")
    return found


def _build_and_load(source: str, compiler: str, flags: Sequence[str]) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` once per content digest and load it."""
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_logs[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    with _lock:
        _loaded[source] = lib
    return lib


def load_kernel_library(source: str) -> ctypes.CDLL:
    """A CUDA source of ``csrc/``, built by nvcc for sm_90a."""
    return _build_and_load(source, _nvcc(), NVCC_FLAGS)


def load_host_library(source: str) -> ctypes.CDLL:
    """A host C++ source of ``csrc/``, built by g++ (or ``$CXX``)."""
    return _build_and_load(source, _cxx(), CXX_FLAGS)
