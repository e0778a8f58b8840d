"""Single Element Width encodings of the MTE CSR (paper §III-B).

The port carries only ``SEW`` — what :mod:`repro_torch.core.formats` and
:mod:`repro_torch.core.geometry` need.  The full CSR model (``TileState``)
is queued with the rest of ``core`` (ROADMAP A2).
"""
from __future__ import annotations

import enum

import torch

__all__ = ["SEW"]

_DTYPE_BITS = {
    "float64": 64, "float32": 32, "bfloat16": 16, "float16": 16,
    "int64": 64, "int32": 32, "int16": 16, "int8": 8, "uint8": 8,
}


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype or a dtype name ("bfloat16", …)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


class SEW(enum.IntEnum):
    """Single Element Width encodings (2 bits within a ttype field)."""

    E8 = 0
    E16 = 1
    E32 = 2
    E64 = 3

    @property
    def bits(self) -> int:
        return 8 << int(self)

    @property
    def bytes(self) -> int:
        return self.bits // 8

    @classmethod
    def from_bits(cls, bits: int) -> "SEW":
        mapping = {8: cls.E8, 16: cls.E16, 32: cls.E32, 64: cls.E64}
        if bits not in mapping:
            raise ValueError(f"unsupported SEW bit-width: {bits}")
        return mapping[bits]

    @classmethod
    def from_dtype(cls, dtype) -> "SEW":
        name = dtype_name(dtype)
        if name not in _DTYPE_BITS:
            raise ValueError(f"unsupported dtype for SEW: {name}")
        return cls.from_bits(_DTYPE_BITS[name])
