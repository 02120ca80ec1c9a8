"""Build and load the port's CUDA kernels.

Each source under ``dgvcc_tpu_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface under
``build/torch_ext/`` at the root of the checkout, and loaded with
``ctypes``. A library is rebuilt when its source, or a header under
``csrc/``, is newer. Nothing is
built when this module is imported: the first call that needs a kernel
builds it, and ``build_all`` builds every stale library at once, one
``nvcc`` process per source, all started together.

A failed build raises ``RuntimeError`` carrying nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_ext"
SOURCES = {"mem_attention": CSRC / "mem_attention.cu",
           "mem_attention_train": CSRC / "mem_attention_train.cu",
           "dmap": CSRC / "dmap.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    inputs = [SOURCES[name], *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(f.stat().st_mtime for f in inputs)


def build_all(names=None) -> Dict[str, str]:
    """Compile every stale library in parallel; returns nvcc's log per
    library built (its ``-Xptxas -v`` register and shared-memory report)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or stale."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
