"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled into
`_kernel_build/<name>-<hash>.so` inside the package (a directory git
ignores) at first use; a changed source or flag set changes the hash and
so triggers a rebuild. nvcc comes from PATH, else from `$CUDA_HOME/bin`
(default /usr/local/cuda). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernel_build"
SOURCES = ("nms", "matching")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels are built on the machine with the card"
        )
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, str]:
    """Compile every stale source, one nvcc process each, all at once.
    Returns {name: compiler log}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """Load the library of `csrc/<name>.cu`, building it first if stale."""
    with _lock:
        if not _target(name).exists():
            build_all()
    return ctypes.CDLL(str(_target(name)))
