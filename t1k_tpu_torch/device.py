"""Device routing for the port: the counterparts of ``tpu_present`` and
``resolve_backend`` in ``t1k_tpu/core/pipeline.py``, with the same
environment contract.

* ``T1K_BACKEND`` = ``native`` | ``gpu`` decides outright.
* The presence verdict is cached in ``T1K_GPU_PRESENT`` and the resolved
  backend in ``T1K_BACKEND_RESOLVED`` (never in ``T1K_BACKEND``), so child
  processes inherit them and skip the check.
* Presence is ``torch.cuda.is_available()``, checked in-process.
"""

from __future__ import annotations

import os

import torch

BACKENDS = ("native", "gpu")


def gpu_present() -> bool:
    """Is a CUDA card usable by this process?"""
    env = os.environ.get("T1K_BACKEND", "")
    if env in BACKENDS:
        return env == "gpu"
    cached = os.environ.get("T1K_GPU_PRESENT", "")
    if cached in ("0", "1"):
        return cached == "1"
    present = torch.cuda.is_available()
    os.environ["T1K_GPU_PRESENT"] = "1" if present else "0"
    return present


def resolve_backend(backend: str) -> str:
    """Resolve "auto" for the alignment stage: "gpu" when a card is
    present, else "native" (byte-identical outputs either way).  Any
    other value is returned as given."""
    if backend != "auto":
        return backend
    env = os.environ.get("T1K_BACKEND", "")
    if env in BACKENDS:
        return env
    cached = os.environ.get("T1K_BACKEND_RESOLVED", "")
    if cached in BACKENDS:
        return cached
    resolved = "gpu" if gpu_present() else "native"
    os.environ["T1K_BACKEND_RESOLVED"] = resolved
    return resolved


def resolve_device(device) -> torch.device:
    """The torch device the gpu routes run on.  A CUDA device on a machine
    without CUDA raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available on this machine")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
