"""Block-geometry solver for Hopper (the port of ``repro.core.geometry``).

The paper's principle carries over unchanged: a GEMM's tile shape is
*granted* from hardware constants and the requested shape, never fixed.
What changes is the hardware.  The TPU solver (``geometry.py:398`` in the
JAX package) budgets VMEM and snaps to the (8·32/SEW, 128) native tile;
this one budgets a block's shared memory and grants the tile shapes the
hand-written kernels implement.  Two mainloops exist (``csrc/``):

- the **tile loop** (``gemm_tile.cuh``; B1's fp32/int8 path, B2, B3, and
  B8's fp32/int8 path): ``(bm, bn) = (16, 128)`` for skinny M ≤ 16
  (decode GEMVs: one 16-row MMA fragment, wide in N), ``(64, 64)``
  otherwise (:data:`TILE_LOOP_TILES`), 32 deep in K, loads not pipelined;
- the **wgmma engine** (``wgmma_mainloop.cuh``; B1 and B8 stage 1 on bf16
  operands): TMA loads 64 deep in K into a ring of shared-memory stages,
  wgmma with the accumulator in registers, at ``bm`` ∈ {64, 128} × ``bn``
  ∈ {64, 128, 256} (:data:`WGMMA_TILES`; bf16acc ``bn`` ≤ 128).

:func:`gemm_engine` says which one runs a launch: a pure function of the
operand type, the accumulator, the tile and the alignment of K and N.
The solver's base tile is the tile loop's tile for M; the plan cache
(``core/autotune.py``) adds the wgmma tiles the shape and format allow and
prices every candidate.

The rigid ``"amx"`` policy (the AMX-style baseline, ``csrc/rigid_gemm.cu``)
adapts nothing: it is always granted the one rigid tile, 128 x 128 with a
128-deep K block and no split, as the JAX solver grants it
(``geometry.py:422-426`` there), on whichever mainloop :func:`gemm_engine`
names.

``bk`` is the K slice a plan works in: the split-K slice granularity and,
under ``bf16acc``, the block after which the running sum is rounded to
bf16.  It is a multiple of the tile loop's 32-deep inner tile.  Split-K
(tile loop only) is offered when the (M, N) tile grid,
``cdiv(M,bm)·cdiv(N,bn)``, is below the card's SM count — the rule that
replaces the TPU's 8-core horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

from repro_torch.core.tile_state import SEW, dtype_name

__all__ = ["HopperProfile", "BlockGeometry", "H100_SPEC", "hopper_profile",
           "solve_block_geometry", "round_up", "cdiv", "TILE_LOOP_TILES",
           "WGMMA_TILES", "INNER_BK", "WGMMA_BK", "RIGID_TILE",
           "check_kernel_tile", "gemm_engine", "wgmma_stages"]

Policy = Literal["mte", "amx", "sifive", "vector"]

# (bm, bn) tiles the tile loop (gemm_tile.cuh) is compiled for in B1, B2
# and B3, and its fixed inner K depth (one shared-memory stage).
TILE_LOOP_TILES: Tuple[Tuple[int, int], ...] = ((16, 128), (64, 64))
INNER_BK = 32
# (bm, bn) tiles of the wgmma engine (wgmma_mainloop.cuh) in B1, its K
# depth per TMA stage, the alignment TMA needs of K and N (16-byte rows
# of bf16), and the widest tile under bf16acc (two register sets).
WGMMA_TILES: Tuple[Tuple[int, int], ...] = tuple(
    (bm, bn) for bm in (64, 128) for bn in (64, 128, 256))
WGMMA_BK = 64
WGMMA_ALIGN = 8
WGMMA_BF16ACC_MAX_BN = 128
# B8's one tile, (bm, bn, bk): the tile loop or the wgmma engine.
RIGID_TILE = (128, 128, 128)
_SMEM_LIMIT = 227 * 1024


def wgmma_stages(bm: int, bn: int) -> int:
    """Stages of the wgmma engine's shared-memory ring for a tile (the
    ``Cfg::STAGES`` of ``wgmma_mainloop.cuh``): as many 64-deep A and B
    stages as fit in 227 KB, at most 5."""
    return min(5, (_SMEM_LIMIT - 2048) // ((bm + bn) * WGMMA_BK * 2))


def gemm_engine(dtype_in, bm: int, bn: int, n: int, k: int, *,
                bf16acc: bool = False, rigid: bool = False) -> str:
    """The mainloop that runs one B1 launch (``rigid``: one B8 stage-1
    launch): ``"wgmma"`` or ``"tile"``.

    A pure function of the operand type, the accumulator, the tile and
    the alignment; the wrappers launch what it names and nothing else:

    - ``"wgmma"`` when the operands are bf16, the tile is a wgmma tile
      (bf16acc: ``bn`` ≤ 128; rigid: the 128 x 128 tile) and K and N are
      multiples of 8 (TMA's 16-byte row alignment);
    - ``"tile"`` otherwise, when the tile loop is compiled for the tile
      (fp32, int8, M ≤ 16's 16 x 128 tile, strides TMA cannot take);
    - ValueError when neither engine is compiled for the launch (a pinned
      tile is launched as it is or refused, never replanned)."""
    tile = (bm, bn)
    if rigid:
        wgmma_ok = loop_ok = tile == RIGID_TILE[:2]
    else:
        wgmma_ok = tile in WGMMA_TILES and not (
            bf16acc and bn > WGMMA_BF16ACC_MAX_BN)
        loop_ok = tile in TILE_LOOP_TILES
    aligned = k % WGMMA_ALIGN == 0 and n % WGMMA_ALIGN == 0
    if wgmma_ok and aligned and dtype_name(dtype_in) == "bfloat16":
        return "wgmma"
    if loop_ok:
        return "tile"
    raise ValueError(
        f"no {'rigid' if rigid else 'mte'} GEMM engine takes the tile "
        f"{bm}x{bn} for {dtype_name(dtype_in)} operands"
        f"{' with a bf16 accumulator' if bf16acc else ''} at K={k}, "
        f"N={n}: the wgmma engine takes bf16 operands, K and N multiples "
        f"of {WGMMA_ALIGN} and the tiles {WGMMA_TILES} (bf16acc: bn <= "
        f"{WGMMA_BF16ACC_MAX_BN}); the tile loop {TILE_LOOP_TILES}")


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
    # L2 to SM operand traffic for all SMs together: an assumed figure,
    # not a data-sheet or measured one (uncalibrated, as launch_s is).
    l2_bw_bytes_per_s: float = 8e12
    launch_s: float = 4e-6
    # Resident blocks an SM needs before the tile loop (no load pipelining
    # inside a block) covers memory latency: the planner counts a grid of
    # tile-loop blocks smaller than sm_count * this as leaving the card
    # idle.  The wgmma engine's stage ring does not need it.
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

    def smem_bytes(self, engine: Optional[str] = None) -> int:
        """Shared memory one block takes.  The tile loop: one A and one B
        stage of ``INNER_BK`` depth plus the staged accumulator tile.  The
        wgmma engine: its ring of 64-deep bf16 A and B stages, 1 KB to
        align it to the swizzle atom and two barriers per stage.
        ``engine`` None takes the wgmma engine for a bf16 wgmma tile (the
        larger need when the alignment is not known), else the loop."""
        if engine is None:
            engine = ("wgmma" if (self.bm, self.bn) in WGMMA_TILES
                      and self.sew_i.bits == 16 else "tile")
        if engine == "wgmma":
            stages = wgmma_stages(self.bm, self.bn)
            return (1024 + stages * (self.bm + self.bn) * WGMMA_BK * 2
                    + 16 * stages)
        a = self.bm * INNER_BK * self.sew_i.bytes
        b = INNER_BK * self.bn * self.sew_i.bytes
        return a + b + self.bm * self.bn * 4


def _tile_for(m: int) -> Tuple[int, int]:
    small, large = TILE_LOOP_TILES
    return small if m <= small[0] else large


def check_kernel_tile(geom: "BlockGeometry", group: int = 1) -> None:
    """Raise unless a kernel of ``geom``'s policy is compiled for its
    tile: a pinned geometry is launched as it is or refused, never
    replanned.  The rigid policy has its one tile; the MTE kernels take
    the tile loop's tiles with any split and group, and the wgmma tiles
    on B1 only (no split, no group).  Whether the operands suit the
    wgmma engine is :func:`gemm_engine`'s call, at launch."""
    tile = (geom.bm, geom.bn)
    if geom.policy == "amx":
        ok = (geom.bm, geom.bn, geom.bk) == RIGID_TILE and geom.split_k == 1
    else:
        ok = geom.bk % INNER_BK == 0 and geom.split_k >= 1 and (
            tile in TILE_LOOP_TILES
            or (tile in WGMMA_TILES and geom.split_k == 1 and group == 1))
    if not ok:
        raise ValueError(
            f"no {geom.policy!r} kernel is compiled for the tile "
            f"{geom.bm}x{geom.bn}x{geom.bk} split_k={geom.split_k} "
            f"group={group}; compiled: MTE tile loop {TILE_LOOP_TILES} "
            f"(bk a multiple of {INNER_BK}, any split or group), MTE "
            f"wgmma {WGMMA_TILES} (split_k 1, group 1), rigid "
            f"{RIGID_TILE}")


def solve_block_geometry(m: int, n: int, k: int, sew_i: SEW, sew_o: SEW,
                         profile: HopperProfile = H100_SPEC,
                         policy: Policy = "mte",
                         split_k: Optional[int] = None) -> BlockGeometry:
    """Shared-memory-budgeted geometry for one GEMM on Hopper.

    ``policy="mte"`` picks the kernel tile by M, the widest ``bk`` up to
    256 that K needs, and ``split_k`` (None ⇒ 1; the plan cache
    enumerates the split candidates).  ``policy="amx"`` always returns
    the rigid (128, 128, 128) block with ``split_k=1``.  The other
    policies of the JAX solver (``"vector"``, ``"sifive"``) have no
    kernel here."""
    if policy == "amx":
        bm, bn, bk = RIGID_TILE
        geom = BlockGeometry(bm=bm, bn=bn, bk=bk, split_k=1, n_acc=8,
                             transposed_b=False, sew_i=sew_i, sew_o=sew_o,
                             policy=policy)
    elif policy == "mte":
        bm, bn = _tile_for(m)
        bk = min(round_up(max(k, 1), INNER_BK), 256)
        geom = BlockGeometry(bm=bm, bn=bn, bk=bk, split_k=split_k or 1,
                             n_acc=1, transposed_b=False, sew_i=sew_i,
                             sew_o=sew_o, policy=policy)
    else:
        raise NotImplementedError(
            f"policy {policy!r} has no Hopper kernel (ported: 'mte', "
            f"'amx')")
    if geom.smem_bytes() > profile.smem_per_block:
        raise ValueError(f"tile {bm}x{bn} needs {geom.smem_bytes()} B of "
                         f"shared memory, the card offers "
                         f"{profile.smem_per_block}")
    return geom
