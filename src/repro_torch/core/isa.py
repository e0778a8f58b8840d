"""Dynamic instruction accounting for MTE and baseline ISAs (paper Table IX).

The port of ``repro.core.isa``, host arithmetic carried over verbatim: it
counts what the paper's CPU designs (``geometry.PROFILES``) retire, not
what an H100 runs.  The paper measures the *retired vector/matrix instruction count* of each
ISA's GEMM micro-kernel.  This module reproduces that accounting
analytically from the kernel structure the paper describes:

- **MTE** (Algorithm 1 + §III-D unrolling): per macro-tile, the K loop
  executes ``um`` A-tile loads, ``un`` B-tile loads and ``um·un`` tfmul
  MMAs; the epilogue is masked vector arithmetic on the accumulator tiles.
- **Vector 1KB/2KB** (§V-C): vectorize the N loop, unroll M across the
  register file; per K step one B vector load plus ``um`` vfmacc
  (scalar-broadcast A), epilogue through vector ops.
- **SiFiveInt** (§II-C2/§V-C): per-instruction geometry 4×(VLEN/128)×4;
  A loads move only a 4×4 tile per MMA.

Counts cover vector + matrix instructions (tile loads/stores, MMAs, vector
arithmetic, vsetvl/tvmask/tss configuration), mirroring "retired
vector/matrix instructions"; scalar address arithmetic is excluded, as in
the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.geometry import (
    HardwareProfile, PROFILES, cdiv, max_tile_dims, sifive_tile_dims,
    solve_unroll,
)
from repro_torch.core.tile_state import SEW

__all__ = ["InstructionCounts", "count_instructions", "count_all",
           "count_sew_sweep"]


@dataclasses.dataclass(frozen=True)
class InstructionCounts:
    """Retired instruction breakdown for one GEMM on one architecture."""

    arch: str
    tile_loads: int = 0        # tl/ttl (or vector loads for vector ISAs)
    tile_stores: int = 0       # tsc (or vector stores)
    mma: int = 0               # tfmul / MMA / vfmacc compute instructions
    vector_ops: int = 0        # epilogue + mask + broadcast vector arithmetic
    config: int = 0            # tss*/vsetvl/tvmask CSR configuration

    @property
    def total(self) -> int:
        return (self.tile_loads + self.tile_stores + self.mma
                + self.vector_ops + self.config)

    def scaled(self, factor: int) -> "InstructionCounts":
        return InstructionCounts(
            arch=self.arch,
            tile_loads=self.tile_loads * factor,
            tile_stores=self.tile_stores * factor,
            mma=self.mma * factor,
            vector_ops=self.vector_ops * factor,
            config=self.config * factor,
        )


def _mte_counts(profile: HardwareProfile, m: int, n: int, k: int,
                sew_i: SEW, sew_o: SEW, with_beta: bool) -> InstructionCounts:
    tile = max_tile_dims(profile, sew_i, sew_o)
    plan = solve_unroll(profile, tile, m, n, k, policy="mte")
    um, un = plan.um, plan.un
    mt = cdiv(m, tile.m * um)
    nt = cdiv(n, tile.n * un)
    kt = cdiv(k, tile.k)
    mn = mt * nt
    # Algorithm 1 with M/N unrolled; K loop unrolled so tssk only runs when
    # the remainder changes (at most twice per (m, n) macro-iteration).
    config = (
        mt                      # tssm per M iteration
        + mn                    # tssn per N iteration
        + mn * 2                # vsetvl + tvmaskc per N iteration
        + mn * min(kt, 2)       # tssk (steady state + tail)
    )
    vector_ops = (
        mn * um * un            # accumulator zeroing broadcast (line 10)
        + mn * um * un          # alpha scale   (line 17)
        + (mn * um * un if with_beta else 0)  # beta fmacc (line 18)
    )
    tile_loads = (
        mn * kt * (um + un)     # tla + tlb per K step (lines 13-14)
        + (mn * um * un if with_beta else 0)  # tlc (line 16)
    )
    mma = mn * kt * um * un     # tfmul (line 15)
    tile_stores = mn * um * un  # tsc (line 19)
    return InstructionCounts(arch=profile.name, tile_loads=tile_loads,
                             tile_stores=tile_stores, mma=mma,
                             vector_ops=vector_ops, config=config)


def _vector_counts(profile: HardwareProfile, m: int, n: int, k: int,
                   sew: SEW, with_beta: bool) -> InstructionCounts:
    vl = profile.max_vl_elems(sew)
    # Unroll M across the register file: um C rows + 1 B vector live.
    um = max(1, min(profile.arch_regs - 2, m))
    nt = cdiv(n, vl)
    mt = cdiv(m, um)
    config = mt * nt  # vsetvl per column-panel
    # Per K step: one B-row vector load + um broadcast vfmacc.
    tile_loads = mt * nt * k
    mma = mt * nt * k * um
    # Epilogue: load C rows, alpha/beta vector ops, store.
    vector_ops = mt * nt * um * (1 + (1 if with_beta else 0) + 1)  # zero+scale
    tile_loads += mt * nt * um if with_beta else 0
    tile_stores = mt * nt * um
    return InstructionCounts(arch=profile.name, tile_loads=tile_loads,
                             tile_stores=tile_stores, mma=mma,
                             vector_ops=vector_ops, config=config)


def _sifive_counts(profile: HardwareProfile, m: int, n: int, k: int,
                   sew: SEW, with_beta: bool) -> InstructionCounts:
    tile = sifive_tile_dims(profile, sew)
    plan = solve_unroll(profile, tile, m, n, k, policy="sifive")
    um, un = plan.um, plan.un
    mt = cdiv(m, tile.m * um)
    nt = cdiv(n, tile.n * un)
    kt = cdiv(k, tile.k)
    mn = mt * nt
    config = mn * 2
    tile_loads = mn * kt * (um + un)
    mma = mn * kt * um * un
    # The MMA reads only the first 4×4 tile of vs1 (§II-C2), so advancing
    # through the 16 packed A tiles costs one vector slide per A register
    # per K step — a structural overhead of the SiFiveInt geometry.
    slides = mn * kt * um
    vector_ops = slides + mn * um * un * (2 + (1 if with_beta else 0))
    tile_loads += mn * um * un if with_beta else 0
    tile_stores = mn * um * un
    return InstructionCounts(arch=profile.name, tile_loads=tile_loads,
                             tile_stores=tile_stores, mma=mma,
                             vector_ops=vector_ops, config=config)


def count_instructions(arch: str, m: int, n: int, k: int,
                       sew_i: SEW = SEW.E32, sew_o: SEW = SEW.E32,
                       with_beta: bool = True) -> InstructionCounts:
    """Retired vector/matrix instruction count for one GEMM on one ISA."""
    profile = PROFILES[arch]
    if arch in ("vector1k", "vector2k"):
        return _vector_counts(profile, m, n, k, sew_i, with_beta)
    if arch == "sifiveint":
        return _sifive_counts(profile, m, n, k, sew_i, with_beta)
    return _mte_counts(profile, m, n, k, sew_i, sew_o, with_beta)


def count_all(m: int, n: int, k: int, sew_i: SEW = SEW.E32,
              sew_o: SEW = SEW.E32) -> Dict[str, InstructionCounts]:
    return {a: count_instructions(a, m, n, k, sew_i, sew_o)
            for a in PROFILES}


def count_sew_sweep(m: int, n: int, k: int,
                    sews: Tuple[SEW, ...] = (SEW.E8, SEW.E16, SEW.E32),
                    sew_o: SEW = SEW.E32,
                    ) -> Dict[str, Dict[str, InstructionCounts]]:
    """Instruction counts across input element widths (Table IX, extended).

    The sweep now reaches down to E8 so the quantized int8 GEMMs the
    format policy enables are covered: a narrower ``SEW_i`` widens the
    Formula 3 K tile (``RLEN/SEW_i``), so MTE retires *fewer* MMAs and
    tile loads for the same logical GEMM — the ISA-level mechanism behind
    the int8 speedup.  ``sew_o`` is clamped up to ``sew_i`` for the
    uniform-precision case (E32 inputs accumulate in E32).
    """
    out: Dict[str, Dict[str, InstructionCounts]] = {}
    for sew in sews:
        so = sew_o if sew_o.bits >= sew.bits else sew
        out[sew.name] = count_all(m, n, k, sew, so)
    return out
