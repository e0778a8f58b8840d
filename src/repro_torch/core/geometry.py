"""Block-geometry solver for Hopper (the port of ``repro.core.geometry``).

The paper's principle carries over unchanged: a GEMM's tile shape is
*granted* from hardware constants and the requested shape, never fixed.
What changes is the hardware.  The TPU solver (``geometry.py:398`` in the
JAX package) budgets VMEM and snaps to the (8·32/SEW, 128) native tile;
this one budgets a block's shared memory and grants one of the tile
shapes the hand-written kernels in ``csrc/gemm_tile.cuh`` implement:

- ``(bm, bn) = (16, 128)`` for skinny M ≤ 16 (decode GEMVs: one 16-row
  MMA fragment, wide in N);
- ``(bm, bn) = (64, 64)`` otherwise.

``bk`` is the K slice a plan works in: the split-K slice granularity and,
under ``bf16acc``, the block after which the running sum is rounded to
bf16.  It is a multiple of the kernels' 32-deep inner tile.  Split-K is
offered when the (M, N) tile grid, ``cdiv(M,bm)·cdiv(N,bn)``, is below
the card's SM count — the rule that replaces the TPU's 8-core horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

from repro_torch.core.tile_state import SEW

__all__ = ["HopperProfile", "BlockGeometry", "H100_SPEC", "hopper_profile",
           "solve_block_geometry", "round_up", "cdiv", "KERNEL_TILES",
           "INNER_BK"]

Policy = Literal["mte", "amx", "sifive", "vector"]

# (bm, bn) tiles the CUDA GEMM kernels are compiled for, and their fixed
# inner K depth (one shared-memory stage).
KERNEL_TILES: Tuple[Tuple[int, int], ...] = ((16, 128), (64, 64))
INNER_BK = 32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class HopperProfile:
    """Hopper constants the solver and the analytic time model read.

    ``source`` says where ``sm_count``/``smem_per_block`` came from:
    ``"device"`` (``torch.cuda.get_device_properties``) or
    ``"spec-sheet"`` (NVIDIA's H100 SXM data sheet defaults)."""

    name: str = "h100_sxm"
    sm_count: int = 132
    smem_per_block: int = 227 * 1024
    peak_bf16_flops: float = 989e12
    peak_int8_ops: float = 1979e12
    peak_fp32_flops: float = 67e12
    hbm_bw_bytes_per_s: float = 3.35e12
    launch_s: float = 4e-6
    # Resident blocks an SM needs before the GEMM kernels (no load
    # pipelining inside a block) cover memory latency: the planner counts
    # a grid smaller than sm_count * this as leaving the card idle.
    blocks_per_sm: int = 4
    source: str = "spec-sheet"

    def peak_flops(self, sew_i: SEW) -> float:
        if sew_i.bits <= 8:
            return self.peak_int8_ops
        return (self.peak_bf16_flops if sew_i.bits <= 16
                else self.peak_fp32_flops)


H100_SPEC = HopperProfile()


def hopper_profile() -> HopperProfile:
    """The present card's profile; spec-sheet defaults without a card."""
    import torch
    if not torch.cuda.is_available():
        return H100_SPEC
    props = torch.cuda.get_device_properties(0)
    smem = getattr(props, "shared_memory_per_block_optin",
                   H100_SPEC.smem_per_block)
    return dataclasses.replace(
        H100_SPEC, name=props.name, sm_count=props.multi_processor_count,
        smem_per_block=int(smem), source="device")


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """A solved block schedule for one GEMM (same fields as the JAX
    package's).  ``split_k`` > 1 splits K into that many slices, each
    writing a partial accumulator."""

    bm: int
    bn: int
    bk: int
    split_k: int
    n_acc: int
    transposed_b: bool
    sew_i: SEW
    sew_o: SEW
    policy: Policy

    def grid_for(self, m: int, n: int, k: int) -> Tuple[int, int, int]:
        return (cdiv(m, self.bm), cdiv(n, self.bn), cdiv(k, self.bk))

    def smem_bytes(self) -> int:
        """Shared memory one block of the CUDA kernel takes: one A and one
        B stage of ``INNER_BK`` depth plus the staged accumulator tile."""
        a = self.bm * INNER_BK * self.sew_i.bytes
        b = INNER_BK * self.bn * self.sew_i.bytes
        return a + b + self.bm * self.bn * 4


def _tile_for(m: int) -> Tuple[int, int]:
    return KERNEL_TILES[0] if m <= KERNEL_TILES[0][0] else KERNEL_TILES[1]


def solve_block_geometry(m: int, n: int, k: int, sew_i: SEW, sew_o: SEW,
                         profile: HopperProfile = H100_SPEC,
                         policy: Policy = "mte",
                         split_k: Optional[int] = None) -> BlockGeometry:
    """Shared-memory-budgeted geometry for one GEMM on Hopper.

    ``policy="mte"`` (the only one ported; the rigid ``"amx"`` baseline
    is B8 in ROADMAP queue B) picks the kernel tile by M, the widest
    ``bk`` up to 256 that K needs, and ``split_k`` (None ⇒ 1; the plan
    cache enumerates the split candidates)."""
    if policy != "mte":
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet (ROADMAP B8: the rigid "
            f"AMX-style baseline)")
    bm, bn = _tile_for(m)
    bk = min(round_up(max(k, 1), INNER_BK), 256)
    geom = BlockGeometry(bm=bm, bn=bn, bk=bk, split_k=split_k or 1,
                         n_acc=1, transposed_b=False, sew_i=sew_i,
                         sew_o=sew_o, policy=policy)
    if geom.smem_bytes() > profile.smem_per_block:
        raise ValueError(f"tile {bm}x{bn} needs {geom.smem_bytes()} B of "
                         f"shared memory, the card offers "
                         f"{profile.smem_per_block}")
    return geom
