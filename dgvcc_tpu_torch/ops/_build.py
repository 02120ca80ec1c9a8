"""Build and load the port's CUDA kernels.

Each source under ``dgvcc_tpu_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface under
``build/torch_ext/`` at the root of the checkout, and loaded with
``ctypes``; nvcc's log (ptxas's register and spill report) is kept beside
it, so that a library that is up to date still has its report. A library
is rebuilt when its source, or a header under ``csrc/``, is newer. Nothing is
built when this module is imported: the first call that needs a kernel
builds it, and ``build_all`` builds every stale library at once, one
``nvcc`` process per source, all started together.

A failed build raises ``RuntimeError`` carrying nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

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


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def build_log(name: str) -> str:
    """nvcc's log of the build of the library ``name`` now on disk ("" if
    it has none)."""
    path = log_path(name)
    return path.read_text() if path.exists() else ""


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
            log_path(name).write_text(out)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def ptxas_report(log: str, kernel: str) -> List[str]:
    """The lines of nvcc's ``-Xptxas -v`` log about the entry functions whose
    mangled name contains ``kernel``: spills, registers, and ptxas's
    warnings that it serialised their wgmma instructions (C7512, C7514), which
    ptxas prints before the function's own lines."""
    lines, current = [], ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            current = m.group(1)
        elif (kernel in current and ("registers" in ln or "spill" in ln)
              or "Performance Loss" in ln and kernel in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


def ptxas_faults(report: List[str]) -> List[str]:
    """What in a ``ptxas_report`` makes a kernel slow though it stays right:
    serialised wgmma instructions (ptxas's "Potential Performance Loss"
    warnings, C7512 and C7514) and spilled registers. An empty report is a
    fault too: the kernel's lines were not found."""
    if not report:
        return ["no ptxas lines for the kernel"]
    faults = [ln for ln in report if "Performance Loss" in ln]
    for ln in report:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and (int(m.group(1)) or int(m.group(2))):
            faults.append(ln)
    return faults


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or stale."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
