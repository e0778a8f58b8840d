"""repro_torch — the PyTorch + CUDA port of :mod:`repro` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``repro_torch/core/formats.py``
↔ ``repro/core/formats.py`` and so on) and keeps its public names and
argument order.  It imports ``torch`` and numpy only — never ``jax`` and
never ``repro``.

Every kernel the JAX package wrote in Pallas for the TPU is a hand-written
CUDA C++ kernel for ``sm_90a`` here (``repro_torch/csrc``), built with
``nvcc`` at first use (:mod:`repro_torch.kernels.build`).  Beside each
kernel, in the same module, sits a plain PyTorch version of the same
function: a wrapper takes it only when its tensors lie on the CPU; a CUDA
tensor launches the kernel or raises.

Entry points run on the card: :func:`default_device` returns ``cuda`` and
raises when there is none, unless the caller asks for the CPU explicitly
with ``device="cpu"`` (as the tests do).

Importing the package turns TF32 off for float32 matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): the port's f32 paths are held to
full-f32 references.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["on_hopper", "default_device", "resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def on_hopper() -> bool:
    """True when a CUDA device of compute capability (9, 0) is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def default_device() -> torch.device:
    """The device entry points run on: the first CUDA card.  Raises when
    there is none — the port never moves to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: device='cuda' asked for, but no "
                           "CUDA device is present")
    return dev
