"""Bit-accurate model of the MTE 64-bit Control Status Register (paper §III-B).

The port of ``repro.core.tile_state``: the paper stores the entire MTE
architectural state in one 64-bit CSR (Table II):

    | field      | description                      | bits |
    |------------|----------------------------------|------|
    | t[m,n,k]   | tile dimension shapes            | 36   |
    | ttype[i,o] | input/output matrix tile types   | 8    |
    | rlenb      | RLEN in bytes                    | 12   |
    | reserved   | additional data                  | 8    |

Each of tm/tn/tk is a 12-bit field holding the dimension offset-by-one
(stored = dim - 1), so the maximum dimension is 2^12 = 4096 elements.  A
zero dimension is never architecturally visible: Algorithm 1's loops
terminate before a zero grant could be written to the CSR.  Each ttype
field is 4 bits: 2 bits encode SEW (8/16/32/64) and 2 bits encode the
inactive-element policy (undisturbed / agnostic).

:meth:`TileState.encode` and :meth:`TileState.decode` give the JAX
package's words bit for bit, and ``tss[m,n,k]`` its request→grant
semantics (paper §III-C1): the granted dimension is the minimum of the
software request and the microarchitecture maximum for the current SEW
settings (Formulas 2/3, :func:`repro_torch.core.geometry.max_tile_dims`).
:func:`repro_torch.core.geometry.tile_state_for` gives the word a Hopper
plan grants.  Pure Python apart from :meth:`SEW.from_dtype`, which takes
torch dtypes and dtype names.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

__all__ = ["SEW", "TailPolicy", "TileState", "MAX_DIM"]

MAX_DIM = 4096  # 12-bit dimension fields.

_DIM_BITS = 12
_DIM_MASK = (1 << _DIM_BITS) - 1

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


class TailPolicy(enum.IntEnum):
    """Inactive row/column element policy (2 bits within a ttype field).

    UNDISTURBED leaves inactive elements untouched; AGNOSTIC lets the
    hardware dirty them (software must not read them).  Mirrors the RISC-V
    V vta/vma nomenclature referenced by the paper.
    """

    UNDISTURBED = 0
    AGNOSTIC = 1


def _encode_ttype(sew: SEW, policy: TailPolicy) -> int:
    return (int(policy) << 2) | int(sew)


def _decode_ttype(v: int) -> Tuple[SEW, TailPolicy]:
    return SEW(v & 0x3), TailPolicy((v >> 2) & 0x3 & 0x1)


@dataclasses.dataclass(frozen=True)
class TileState:
    """Decoded MTE CSR contents.

    ``tm``/``tn``/``tk`` are the *currently granted* tile dimensions;
    ``sew_i``/``sew_o`` the input/output element widths; ``rlenb`` the row
    length in bytes (a design-time constant surfaced to software so kernels
    can be written geometry-agnostically, paper §III-C4).
    """

    tm: int = 1
    tn: int = 1
    tk: int = 1
    sew_i: SEW = SEW.E32
    sew_o: SEW = SEW.E32
    policy_i: TailPolicy = TailPolicy.AGNOSTIC
    policy_o: TailPolicy = TailPolicy.AGNOSTIC
    rlenb: int = 64  # 512-bit rows, the paper's evaluated design point.

    def __post_init__(self):
        for name in ("tm", "tn", "tk"):
            v = getattr(self, name)
            if not (1 <= v <= MAX_DIM):
                raise ValueError(f"{name}={v} outside offset-encoded "
                                 f"12-bit field range [1, {MAX_DIM}]")
        if not (0 <= self.rlenb < (1 << 12)):
            raise ValueError(f"rlenb={self.rlenb} outside 12-bit field range")

    # -- CSR bit layout -----------------------------------------------------
    # [0:12) tm | [12:24) tn | [24:36) tk | [36:40) ttype_i | [40:44) ttype_o
    # | [44:56) rlenb | [56:64) reserved
    def encode(self) -> int:
        word = 0
        word |= ((self.tm - 1) & _DIM_MASK) << 0
        word |= ((self.tn - 1) & _DIM_MASK) << 12
        word |= ((self.tk - 1) & _DIM_MASK) << 24
        word |= _encode_ttype(self.sew_i, self.policy_i) << 36
        word |= _encode_ttype(self.sew_o, self.policy_o) << 40
        word |= (self.rlenb & 0xFFF) << 44
        return word

    @classmethod
    def decode(cls, word: int) -> "TileState":
        if not (0 <= word < (1 << 64)):
            raise ValueError("CSR word must fit in 64 bits")
        tm = ((word >> 0) & _DIM_MASK) + 1
        tn = ((word >> 12) & _DIM_MASK) + 1
        tk = ((word >> 24) & _DIM_MASK) + 1
        sew_i, pol_i = _decode_ttype((word >> 36) & 0xF)
        sew_o, pol_o = _decode_ttype((word >> 40) & 0xF)
        rlenb = (word >> 44) & 0xFFF
        return cls(tm=tm, tn=tn, tk=tk, sew_i=sew_i, sew_o=sew_o,
                   policy_i=pol_i, policy_o=pol_o, rlenb=rlenb)

    # -- tss[m,n,k] request/grant semantics (paper §III-C1) ------------------
    # A grant of zero is returned to software (loop exit) but never written
    # to the CSR — the dimension fields always hold the last nonzero grant.
    def tssm(self, request: int, hw_max_m: int) -> Tuple[int, "TileState"]:
        granted = max(0, min(request, hw_max_m, MAX_DIM))
        return granted, (dataclasses.replace(self, tm=granted)
                         if granted else self)

    def tssn(self, request: int, hw_max_n: int) -> Tuple[int, "TileState"]:
        granted = max(0, min(request, hw_max_n, MAX_DIM))
        return granted, (dataclasses.replace(self, tn=granted)
                         if granted else self)

    def tssk(self, request: int, hw_max_k: int) -> Tuple[int, "TileState"]:
        granted = max(0, min(request, hw_max_k, MAX_DIM))
        return granted, (dataclasses.replace(self, tk=granted)
                         if granted else self)

    @property
    def rlen_bits(self) -> int:
        return self.rlenb * 8
