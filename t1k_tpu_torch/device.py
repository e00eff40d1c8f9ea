"""Device routing for the port.

Every entry point runs on the card unless the caller asks for the CPU.

* Backends are "native" (the host engine), "gpu" (the kernels on the
  torch device given as ``device``: a CUDA card, or the CPU through the
  kernels' plain versions) and "auto".
* "auto" is "gpu" on ``device``.  When that is a CUDA device and no card
  is present it raises ``NoCardError``, which names the two explicit
  routes; it never falls back to the host engine.  The measured size
  gates (the extraction screen's streamed reads, the EM's dense cells)
  then route between the device and the host engine.
* ``T1K_BACKEND`` = ``native`` | ``gpu`` decides outright, and the
  presence verdict is cached in ``T1K_GPU_PRESENT`` so child processes
  inherit it.  Presence is ``torch.cuda.is_available()``.
"""

from __future__ import annotations

import os

import torch

BACKENDS = ("native", "gpu")


class NoCardError(RuntimeError):
    """An "auto" route asked for a CUDA device on a machine without one."""


NO_CARD = ("'auto' runs on the CUDA card and this machine has none: pass "
           "--backend native for the host engine, or --device cpu for the "
           "kernels' plain versions on the CPU")


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


def resolve_backend(backend: str, device="cuda") -> str:
    """Resolve "auto": "gpu" on `device`, or T1K_BACKEND's choice.  A
    CUDA `device` without a card raises NoCardError.  Any other value is
    returned as given."""
    if backend != "auto":
        return backend
    env = os.environ.get("T1K_BACKEND", "")
    if env in BACKENDS:
        return env
    if torch.device(device).type == "cuda" and not gpu_present():
        raise NoCardError(NO_CARD)
    return "gpu"


def resolve_device(device, error=RuntimeError) -> torch.device:
    """The torch device the gpu routes run on.  A CUDA device on a machine
    without CUDA raises `error` naming --device cpu instead of running
    elsewhere (NoCardError where a CLI is to exit 2 on it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise error(f"device {str(dev)!r} requested but CUDA is not "
                    "available on this machine: pass --device cpu for the "
                    "kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
