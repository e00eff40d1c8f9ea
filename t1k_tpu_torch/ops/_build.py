"""Build and load the port's CUDA kernels.

Each kernel source under ``t1k_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``.  The build runs at first use, from the sources in the
checkout only, into ``build/t1k_tpu_torch/`` at the repository root; a
library newer than its source is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "t1k_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No fused multiply-add: the f64 kernels round every operation the way
# the native oracle (built with -ffp-contract=off) does.
FP_FLAGS = ["-fmad=false"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _library(name: str) -> Tuple[str, str]:
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless an up-to-date library
    exists; returns None or (process, command, private output, t0)."""
    src, out = _library(name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, *FP_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, time.perf_counter()


def _finish(name: str, started) -> str:
    src, out = _library(name)
    if started is None:
        return out
    proc, cmd, tmp, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(f"{' '.join(cmd)}\n{time.perf_counter() - t0:.2f}s\n")
        f.write(log)
    os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``BUILD_DIR/lib<name>.so`` unless an
    up-to-date library exists; returns the library path.  The compiler's
    register/spill report lands in ``BUILD_DIR/<name>.log``."""
    return _finish(name, _start(name))


def build_all(names: Sequence[str]) -> List[str]:
    """Build several kernels with one nvcc process each, all at once."""
    started = [_start(n) for n in names]
    out, errors = [], []
    for n, s in zip(names, started):  # wait for every process, then raise
        try:
            out.append(_finish(n, s))
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(build(name))
