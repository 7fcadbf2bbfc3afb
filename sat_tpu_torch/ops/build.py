"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this package (listed in ``.gitignore``), and loaded with ``ctypes``.  A
library is named by the sha256 of its source, so an edited source is
rebuilt and an unchanged one is reused.  All stale sources compile at
once, one ``nvcc`` process each.  A failed build raises with nvcc's
stderr; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per kernel: build seconds (0.0 when reused) and ptxas' report: each entry
# function's (mangled) name, then its registers
build_log: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME:
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _target(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_all() -> Dict[str, str]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns name → .so."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    targets = {os.path.splitext(os.path.basename(s))[0]: (s, _target(s)) for s in sources}
    stale = {n: st for n, st in targets.items() if not os.path.exists(st[1])}
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs: List = []
        for name, (src, so) in stale.items():
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        failures = []
        for name, so, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{err}{out}")
                continue
            os.replace(tmp, so)
            build_log[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in err.splitlines()
                          if "registers" in ln or "entry function" in ln],
            }
        if failures:
            raise RuntimeError("\n".join(failures))
    for name in targets:
        build_log.setdefault(name, {"seconds": 0.0, "ptxas": []})
    return {n: st[1] for n, st in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
