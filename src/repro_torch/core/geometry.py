"""Block-geometry solver for Hopper (the port of ``repro.core.geometry``).

The paper's principle carries over unchanged: a GEMM's tile shape is
*granted* from hardware constants and the requested shape, never fixed.
What changes is the hardware.  The TPU solver (``geometry.py:398`` in the
JAX package) budgets VMEM and snaps to the (8·32/SEW, 128) native tile;
this one budgets a block's shared memory and grants the tile shapes the
hand-written kernels implement.  Three mainloops exist (``csrc/``):

- the **tile loop** (``gemm_tile.cuh``; B1, B2, B3 and B8 on what their
  other engines leave: B1's int8 at M ≤ 16, B2's and B3's int8 off the
  cluster rule, int8 off the s8 rule, unaligned shapes, B1's M ≤ 16):
  ``(bm, bn) = (16, 128)`` for skinny M ≤ 16 (decode GEMVs: one 16-row
  MMA fragment, wide in N), ``(64, 64)`` otherwise
  (:data:`TILE_LOOP_TILES`), 32 deep in K, loads not pipelined;
- the **wgmma engine** (``wgmma_mainloop.cuh``; B1, B8 stage 1 and B3
  past 16 rows on bf16 operands, B1 and B3 past 16 rows and B8 stage 1
  at every M on int8 operands): TMA loads 64 deep in K (bf16; 128 deep
  for int8, the same 128-byte rows) into a ring of shared-memory stages,
  wgmma with the accumulator in registers, at ``bm`` ∈ {64, 128} × ``bn``
  ∈ {64, 128, 256} (:data:`WGMMA_TILES`; bf16acc ``bn`` ≤ 128);
- the **SIMT f32 engine** (``simt_f32_mainloop.cuh``; B1, B2 and B3 on
  f32 operands past 16 rows, the training backward, and B8 stage 1 on
  f32 operands at every M): 8 × 8 accumulators a thread over a 16-deep
  cp.async ring, at 128 × 128 or 128 × 64 (:data:`SIMT_TILES`), K and N
  multiples of 4.

:func:`gemm_engine` says which one runs a launch: a pure function of the
operand type, the accumulator, the tile, the rows and the alignment of K
and N.
B2–B7 have a second engine each, chosen the same way:
:func:`splitk_engine` and :func:`grouped_engine` (the cluster split-K
mainloop of ``splitk_cluster.cuh`` for bf16 GEMMs of at most 16 rows,
with an f32 or a bf16 accumulator, and for int8 ones with their int32
accumulator where N is a multiple of 16; past 16 rows, at the plan's
tile, B3 on the wgmma mainloop for bf16 and int8 and both on the SIMT
f32 one for f32; else the tile loop),
:func:`decode_engine` and :func:`flat_decode_engine`
(mma.sync over 16-position tiles of the pages or of the flat or ring
cache for bf16, else the SIMT kernel), :func:`attention_engine` (TMA +
wgmma for bf16 at head dims 64/128/256, else the SIMT kernel) and
:func:`scan_engine` (B7: spans staged in shared memory by TMA for f32
with W a multiple of 4, else one thread per channel).
The solver's base tile is the tile loop's tile for M; the plan cache
(``core/autotune.py``) adds the wgmma and SIMT tiles the shape and format
allow and prices every candidate.

Below the Hopper solver sit the paper's own CPU architectures
(:data:`PROFILES`, Table VII), Formulas 2 and 3 (:func:`max_tile_dims`,
:func:`sifive_tile_dims`) and the register-level unroll solver
(:func:`solve_unroll`), which :mod:`repro_torch.core.isa` and
:mod:`repro_torch.core.perfmodel` read, and :func:`tile_state_for`, the
CSR word (:class:`~repro_torch.core.tile_state.TileState`) a Hopper plan
grants.

The rigid ``"amx"`` policy (the AMX-style baseline, ``csrc/rigid_gemm.cu``)
adapts nothing: it is always granted the one rigid tile, 128 x 128 with a
128-deep K block and no split, as the JAX solver grants it
(``geometry.py:422-426`` there), on whichever mainloop :func:`gemm_engine`
names (the rigid tile is a wgmma tile and a SIMT tile, so bf16, int8
and f32 operands run it on the engines built for Hopper, at every M: the
128-row padding of a small M is the baseline's handicap by design).

``bk`` is the K slice a plan works in: the split-K slice granularity and,
under ``bf16acc``, the block after which the running sum is rounded to
bf16 (on the cluster split-K engines: blocks of ``bk`` rows counted from
each K slice's first row, whose bf16 partials are summed in f32 and
rounded once, as the reference's split-K kernel sums its bf16 partials).
It is a multiple of the tile loop's 32-deep inner tile.  Split-K
is offered when the (M, N) tile grid, ``cdiv(M,bm)·cdiv(N,bn)``, is below
the card's SM count — the rule that replaces the TPU's 8-core horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

from repro_torch.core.tile_state import SEW, TileState, dtype_name

__all__ = ["HopperProfile", "BlockGeometry", "H100_SPEC", "hopper_profile",
           "solve_block_geometry", "round_up", "cdiv", "TILE_LOOP_TILES",
           "WGMMA_TILES", "INNER_BK", "WGMMA_BK", "WGMMA_S8_BK",
           "WGMMA_S8_ALIGN_K", "S8_MAX_K", "RIGID_TILE",
           "check_kernel_tile", "gemm_engine", "wgmma_stages",
           "SIMT_TILES", "SIMT_BK", "SIMT_STAGES", "SIMT_ALIGN",
           "GROUPED_BN", "GROUPED_MAX_M", "GROUPED_BK", "GROUPED_BK_S8",
           "GROUPED_S8_ALIGN_N", "MAX_CLUSTER", "GROUPED_X_BYTES",
           "GROUPED_FILL_SPLIT", "cluster_stage", "grouped_max_depth",
           "grouped_engine", "grouped_live_tiles", "grouped_split",
           "SPLITK_DEEP_DEPTH", "splitk_engine", "splitk_cluster_split",
           "window_rows",
           "DECODE_MMA_MAX_G", "DECODE_MMA_DIMS", "decode_engine",
           "flat_decode_engine", "decode_kv_split", "attention_engine",
           "attention_kv_split", "scan_engine", "tile_state_for",
           "HardwareProfile", "PROFILES", "RegisterTile", "UnrollPlan",
           "max_tile_dims", "sifive_tile_dims", "solve_unroll"]

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
# The int8 (s8) wgmma engine: a stage's 128-byte rows hold 128 int8 of K,
# TMA's 16-byte row stride needs K a multiple of 16 (N stays a multiple of
# 8), and the launcher refuses K past S8_MAX_K, where 127^2 * K would pass
# the int32 accumulator's range.
WGMMA_S8_BK = 128
WGMMA_S8_ALIGN_K = 16
S8_MAX_K = 131072
# B8's one tile, (bm, bn, bk): the tile loop or the wgmma engine.
RIGID_TILE = (128, 128, 128)
# (bm, bn) tiles of the SIMT f32 engine (simt_f32_mainloop.cuh) in B1 and
# B2 (128 x 64 is offered only where 128 x 128 tiles underfill the SMs),
# its K rows per stage, its ring's depth, the floats past each K-outer
# row, and the alignment its 16-byte vectors need of K and N (f32).
SIMT_TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (128, 64))
SIMT_BK = 16
SIMT_STAGES = 4
SIMT_PAD = 4
SIMT_ALIGN = 4
_SMEM_LIMIT = 227 * 1024


def wgmma_stages(bm: int, bn: int) -> int:
    """Stages of the wgmma engine's shared-memory ring for a tile (the
    ``Cfg::STAGES`` of ``wgmma_mainloop.cuh``): as many 64-deep A and B
    stages as fit in 227 KB, at most 5."""
    return min(5, (_SMEM_LIMIT - 2048) // ((bm + bn) * WGMMA_BK * 2))


def _simt(dtype_in, tile: Tuple[int, int], m: int, n: int, k: int, *,
          rigid: bool = False) -> bool:
    """The SIMT f32 engine's rule: f32 operands, more than 16 rows (decode
    and the verify rows of speculation stay on the tile loop; the rigid
    route takes it at every M), one of its tiles, K and N multiples of 4
    (16-byte rows; the wrappers hand it contiguous operands at 16-byte
    aligned addresses)."""
    return (dtype_name(dtype_in) == "float32" and tile in SIMT_TILES
            and (rigid or m > GROUPED_MAX_M)
            and k % SIMT_ALIGN == 0 and n % SIMT_ALIGN == 0)


def _s8(dtype_in, tile: Tuple[int, int], m: int, n: int, k: int, *,
        rigid: bool = False) -> bool:
    """The int8 wgmma engine's rule: int8 operands with their int32
    accumulator, K a multiple of 16 and N of 8 (TMA's 16-byte rows of the
    K-major operands); on B1 and B3 more than 16 rows (decode rows run the
    cluster split-K engines; the plan offers wgmma tiles only from 64
    rows) at a wgmma tile; on B8 (``rigid``) its one tile at every M (the
    rows past M are TMA's zeros, the padding the rigid tile pays by
    design) and K up to S8_MAX_K (the launcher refuses more)."""
    if dtype_name(dtype_in) != "int8" or k % WGMMA_S8_ALIGN_K \
            or n % WGMMA_ALIGN:
        return False
    if rigid:
        return tile == RIGID_TILE[:2] and k <= S8_MAX_K
    return tile in WGMMA_TILES and m > GROUPED_MAX_M


def gemm_engine(dtype_in, bm: int, bn: int, n: int, k: int, *, m: int,
                bf16acc: bool = False, rigid: bool = False) -> str:
    """The mainloop that runs one B1 launch (``rigid``: one B8 stage-1
    launch): ``"wgmma"``, ``"simt"`` or ``"tile"``.

    A pure function of the operand type, the accumulator, the tile, the
    rows ``m`` and the alignment; the wrappers launch what it names and
    nothing else:

    - ``"wgmma"`` when the operands are bf16, the tile is a wgmma tile
      (bf16acc: ``bn`` ≤ 128; rigid: the 128 x 128 tile) and K and N are
      multiples of 8 (TMA's 16-byte row alignment); and when the operands
      are int8 (int32 accumulator) with K a multiple of 16 and N of 8,
      past 16 rows at a wgmma tile, or, rigid, at every M with K up to
      ``S8_MAX_K`` (:func:`_s8`);
    - ``"simt"`` when the operands are f32, the tile is one of
      :data:`SIMT_TILES` and K and N are multiples of 4, past 16 rows
      (B1: its M ≤ 16 decode tile stays on the tile loop) or at every M
      (rigid: the 128 x 128 tile whatever M, each output the tile loop's
      FMA chain, so bit-equal to it);
    - ``"tile"`` otherwise, when the tile loop is compiled for the tile
      (fp32 off the SIMT engine's tiles or alignment, int8 off the s8
      rule, M ≤ 16's 16 x 128 tile, strides TMA cannot take);
    - ValueError when no engine is compiled for the launch (a pinned
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
    if _s8(dtype_in, tile, m, n, k, rigid=rigid):
        return "wgmma"
    if _simt(dtype_in, tile, m, n, k, rigid=rigid):
        return "simt"
    if loop_ok:
        return "tile"
    raise ValueError(
        f"no {'rigid' if rigid else 'mte'} GEMM engine takes the tile "
        f"{bm}x{bn} for {dtype_name(dtype_in)} operands"
        f"{' with a bf16 accumulator' if bf16acc else ''} at M={m}, "
        f"K={k}, N={n}: the wgmma engine "
        f"takes bf16 operands, K and N multiples of {WGMMA_ALIGN} and the "
        f"tiles {WGMMA_TILES} (bf16acc: bn <= {WGMMA_BF16ACC_MAX_BN}), and "
        f"int8 past {GROUPED_MAX_M} rows (rigid: at every M) with K a "
        f"multiple of {WGMMA_S8_ALIGN_K}; the "
        f"SIMT engine f32 operands past {GROUPED_MAX_M} rows (rigid: at "
        f"every M), K and N multiples of {SIMT_ALIGN} and the tiles "
        f"{SIMT_TILES}; the tile loop {TILE_LOOP_TILES}")


# B3's split-K engine (grouped_gemm_splitk.cu): output tiles GROUPED_BN
# columns wide, at most GROUPED_MAX_M rows (one m16n8k16 fragment, bf16;
# m16n8k32, int8), K sliced in multiples of one TMA stage of 128-byte rows
# -- GROUPED_BK rows of bf16, GROUPED_BK_S8 of int8 -- across a
# thread-block cluster of at most MAX_CLUSTER CTAs (the portable cluster
# size); a CTA holds its slice of x, each row padded by 16 bytes, in at
# most GROUPED_X_BYTES of shared memory.  An int8 weight's rows are 16-byte
# aligned for TMA where N is a multiple of GROUPED_S8_ALIGN_N.
GROUPED_BN = 128
GROUPED_MAX_M = 16
GROUPED_BK = 64
GROUPED_BK_S8 = 128
GROUPED_S8_ALIGN_N = 16
MAX_CLUSTER = 8
GROUPED_X_BYTES = 128 * 1024
# The most slices the split takes to fill the card: on an H100 (the
# by-split timings of chip_smoke.py), 8 slices ran slower than 4 at
# gemma_2b's decode group -- 160 CTAs put two on some SMs, doubling those
# SMs' bytes -- and no faster at recurrentgemma_9b's; more than 4 only
# where x would not fit otherwise.
GROUPED_FILL_SPLIT = 4


def _int8(dtype_in) -> bool:
    return dtype_name(dtype_in) == "int8"


def cluster_stage(dtype_in="bfloat16") -> int:
    """K rows of one stage of the cluster split-K engines for an operand
    type: 128 bytes of K, GROUPED_BK bf16 rows or GROUPED_BK_S8 int8
    ones."""
    return GROUPED_BK_S8 if _int8(dtype_in) else GROUPED_BK


def grouped_max_depth(m: int, dtype_in="bfloat16") -> int:
    """The deepest K slice whose m rows of x (rows padded by 16 bytes)
    fit the split-K engines' x budget, worked out in bytes: a whole
    number of stages, 128 bytes of K each (GROUPED_BK bf16 rows,
    GROUPED_BK_S8 int8 ones)."""
    itemsize = 1 if _int8(dtype_in) else 2
    return (GROUPED_X_BYTES // max(m, 1) - 16) // 128 * 128 // itemsize


def _cluster_takes(dtype_in, m: int, n: int, k: int) -> bool:
    """The cluster split-K engines' rule (B2's and B3's alike): at most 16
    rows, and bf16 operands with N a multiple of 8, or int8 operands with
    N a multiple of 16 (TMA's 16-byte rows of the weight) and K within the
    int32 accumulator's range (S8_MAX_K); K such that 8 slices of x fit
    the x budget."""
    if m > GROUPED_MAX_M:
        return False
    dt = dtype_name(dtype_in)
    if dt == "bfloat16":
        aligned = n % WGMMA_ALIGN == 0
    elif dt == "int8":
        aligned = n % GROUPED_S8_ALIGN_N == 0 and k <= S8_MAX_K
    else:
        return False
    return aligned and k <= MAX_CLUSTER * grouped_max_depth(m, dt)


def grouped_engine(dtype_in, m: int, n: int, k: int, *,
                   bf16acc: bool = False,
                   tile: Optional[Tuple[int, int]] = None) -> str:
    """The engine that runs one B3 launch: ``"splitk"``, ``"wgmma"``,
    ``"simt"`` or ``"tile"``.

    A pure function of the operand type, the shape, the accumulator and
    the plan's ``tile`` (None: no tile of the pipelined engines); the
    wrapper launches what it names and nothing else:

    - ``"splitk"`` (the cluster split-K kernel) for bf16 operands with an
      f32 or a bf16 (``bf16acc``) accumulator, at most 16 rows (the decode
      group), N a multiple of 8 (TMA's 16-byte row alignment of the
      weight) and a K that 8 slices of x cover in shared memory (m = 16:
      K ≤ 32256).  Under bf16acc each slice rounds its running sum once
      per K block of the slice and the slices' bf16 partials are summed
      in f32 and rounded once: B2's split-K contract, where the
      reference's grouped kernel rounds in K order over all of K (the
      two agree to bf16 tolerance).  Also for int8 operands (int32
      accumulator) at most 16 rows with N a multiple of 16 (an int8
      weight's 16-byte rows) and a K that 8 slices of x cover (m = 16:
      K ≤ 64512) within S8_MAX_K: its s8 path, the int32 sums exact
      (:func:`_cluster_takes`);
    - ``"wgmma"`` (B1's TMA + wgmma mainloop with the group on the grid,
      ``grouped_gemm_wgmma.cu``) for bf16 operands with an f32 or a
      bf16acc accumulator past 16 rows, K and N multiples of 8 and a
      ``tile`` of :data:`WGMMA_TILES` (bf16acc: ``bn`` ≤ 128); bf16acc
      rounds the running sum in K order, as B1's wgmma engine;
    - ``"simt"`` (the SIMT f32 mainloop with the group on the grid) for
      f32 operands past 16 rows, K and N multiples of 4 and a ``tile``
      of :data:`SIMT_TILES`: each output the tile loop's FMA chain, so
      bit-equal to it;
    - ``"wgmma"`` also for int8 operands (int32 accumulator) past 16 rows
      at a wgmma tile, K a multiple of 16 and N of 8 (:func:`_s8`; the s8
      mainloop reads w K-major);
    - ``"tile"`` (the tile loop) otherwise: int8 at C ≤ 16 off the
      cluster rule (N not a multiple of 16) or past 16 rows off the s8
      rule, fp32 at C ≤ 16, unaligned shapes and tiles of the tile loop
      only."""
    dt = dtype_name(dtype_in)
    if _cluster_takes(dt, m, n, k):
        return "splitk"
    if tile is None or m <= GROUPED_MAX_M:
        return "tile"
    if (dt == "bfloat16" and tile in WGMMA_TILES
            and not (bf16acc and tile[1] > WGMMA_BF16ACC_MAX_BN)
            and k % WGMMA_ALIGN == 0 and n % WGMMA_ALIGN == 0):
        return "wgmma"
    if _s8(dtype_in, tile, m, n, k):
        return "wgmma"
    if _simt(dtype_in, tile, m, n, k):
        return "simt"
    return "tile"


def grouped_live_tiles(n: int, widths: Optional[Sequence[int]],
                       g: int) -> Tuple[int, ...]:
    """Output tiles of each member that hold a live column: a member of
    width w has ``cdiv(min(w, n), GROUPED_BN)``; without widths every
    member is n wide."""
    ws = list(widths) if widths is not None else [n] * g
    return tuple(cdiv(min(int(w), n), GROUPED_BN) for w in ws)


def _cluster_split(tiles: int, k: int, m: int, sm_count: int,
                   fill: int, dtype_in) -> Tuple[int, int]:
    stage = cluster_stage(dtype_in)
    stages = cdiv(max(k, 1), stage)
    deepest = grouped_max_depth(m, dtype_in)
    s = 1
    while s * 2 <= MAX_CLUSTER and s * 2 <= stages and (
            (tiles * s < sm_count and s < fill) or s * deepest < k):
        s *= 2
    depth = round_up(cdiv(max(k, 1), s), stage)
    return cdiv(max(k, 1), depth), depth


def grouped_split(live_tiles: int, k: int, m: int = 1,
                  sm_count: int = 132,
                  dtype_in="bfloat16") -> Tuple[int, int]:
    """(slices, slice depth) of the split-K engine: the fewest slices,
    doubling, that give live tiles x slices >= the SM count (up to
    GROUPED_FILL_SPLIT) and slices no deeper than
    :func:`grouped_max_depth` (up to MAX_CLUSTER), each at least one
    stage deep; the depth is a whole number of stages
    (:func:`cluster_stage`: 64 bf16 rows, 128 int8 ones) and every slice
    holds at least one K row.  The same rule in rows for both operand
    types, so an int8 slice moves half a bf16 slice's bytes."""
    return _cluster_split(live_tiles, k, m, sm_count, GROUPED_FILL_SPLIT,
                          dtype_in)


# B2's cluster engine (splitk_gemm_cluster.cu) runs B3's mainloop at G = 1:
# the same tile, stage, row and x budget, and the same split rule with the
# same cap on the filling split, plus one step past it for deep K.  On an
# H100 (chip_smoke.py's by-split timings at the decode GEMMs of gemma_2b and
# recurrentgemma_9b) the cap of 4 was the fastest split, or within noise of
# it, everywhere but at gemma_2b's down (16 tiles, K = 16384), where 8
# slices of 2048 rows beat 4.
SPLITK_DEEP_DEPTH = 2048


def splitk_engine(dtype_in, m: int, n: int, k: int, *,
                  bf16acc: bool = False,
                  tile: Optional[Tuple[int, int]] = None) -> str:
    """The engine that runs one B2 launch: ``"cluster"``, ``"simt"`` or
    ``"tile"``.

    A pure function of the operand type, the shape and the plan's
    ``tile`` (both accumulators, f32 and ``bf16acc``'s bf16, take the
    same engine); the wrapper launches what it names and nothing else:

    - ``"cluster"`` (B3's cluster split-K mainloop at G = 1, the reduction
      and the whole epilogue in the launch) for bf16 operands with an f32
      or a bf16 (``bf16acc``) accumulator, at most 16 rows (decode, and
      the verify GEMMs of speculation), N a multiple of 8 (TMA's 16-byte
      row alignment of the weight) and a K that 8 slices of x cover in
      shared memory.  Under bf16acc the engine keeps the reference's
      split-K contract (``splitk_gemm.py:76-105`` there): a bf16 running
      sum per slice, rounded once per K block of the slice, the slices'
      bf16 partials summed and rounded once, every epilogue step rounded
      to bf16.  Also for int8 operands (int32 accumulator, the identity
      epilogue) at most 16 rows with N a multiple of 16 and K within 8
      slices of x and S8_MAX_K (:func:`_cluster_takes`): the mainloop's s8
      path, int32 partials summed exactly;
    - ``"simt"`` (the SIMT f32 engine over each K slice, partials summed
      in PyTorch) for f32 operands, M > 16, a ``tile`` of
      :data:`SIMT_TILES` and K and N multiples of 4 (the training
      backward's dB of a narrow weight);
    - ``"tile"`` (the tile loop, partials summed in PyTorch) otherwise:
      fp32 off the SIMT engine's rule, int8 off the cluster rule (past 16
      rows, N not a multiple of 16) and bf16 past 16 rows."""
    if _cluster_takes(dtype_in, m, n, k):
        return "cluster"
    if tile is not None and _simt(dtype_in, tile, m, n, k):
        return "simt"
    return "tile"


def splitk_cluster_split(tiles: int, k: int, m: int = 1,
                         sm_count: int = 132,
                         dtype_in="bfloat16") -> Tuple[int, int]:
    """(slices, slice depth) of B2's cluster engine for ``tiles``
    128-column output tiles: :func:`grouped_split`'s rule -- the fewest
    slices (up to GROUPED_FILL_SPLIT) that fill the SMs, each a whole
    number of stages (:func:`cluster_stage`), none deeper than x's
    shared-memory budget allows --, then doubling on, up to 8 (the
    portable cluster), while the grid stays within one CTA per SM and
    every slice stays at least SPLITK_DEEP_DEPTH rows deep (rows, for
    bf16 and int8 alike).  The plan's ``split_k`` (the tile loop's) plays
    no part."""
    stage = cluster_stage(dtype_in)
    s, depth = _cluster_split(tiles, k, m, sm_count, GROUPED_FILL_SPLIT,
                              dtype_in)
    while (s * 2 <= MAX_CLUSTER and tiles * s * 2 <= sm_count
           and round_up(cdiv(k, s * 2), stage) >= SPLITK_DEEP_DEPTH):
        s *= 2
        depth = round_up(cdiv(k, s), stage)
    return cdiv(k, depth), depth


def window_rows(engine: str, plan_rows: int, depth: int = 0,
                dtype_in="bfloat16") -> int:
    """The most rows one launch takes of a GEMM planned at ``plan_rows``
    rows and called on more (a speculative verify window: slots·k rows on
    the decode step's plan, ``ops.mte_gemm(plan_rows=)``), such that each
    row comes out as a ``plan_rows``-row launch computes it; the caller
    runs the rows in chunks of this many.

    - Past GROUPED_MAX_M planned rows, ``plan_rows``: the decode step runs
      the tile loop at M = slots, and a chunk of that many rows is its
      launch.
    - On the split-K engines (``engine`` ``"cluster"`` for B2,
      ``"splitk"`` for B3, ``depth`` the K slice of the split planned for
      ``plan_rows``): the most rows up to GROUPED_MAX_M whose x slice of
      ``depth`` ``dtype_in`` elements fits the engine's shared memory
      (:func:`grouped_max_depth`); a row computes alike whatever rows ride
      with it on the same split -- under bf16acc too: each row's running
      sum is rounded at the same K rows whatever rides with it --, and
      past that count the launch would leave the engine or refuse the
      split.  At gemma2_27b's decode gate and up (K 4608, one slice) that
      is 14 rows, at its down (K 36864, 4 slices of 9216) 7.
    - Otherwise (the tile loops, whose rows are each computed alike on a
      given tile) GROUPED_MAX_M."""
    if plan_rows > GROUPED_MAX_M:
        return plan_rows
    rows = GROUPED_MAX_M
    if engine in ("cluster", "splitk"):
        while rows > plan_rows and grouped_max_depth(rows,
                                                     dtype_in) < depth:
            rows -= 1
    return rows


# B4's mma engine (flash_decode_paged_mma.cu): the G query heads of a kv
# head are the rows of one m16n8k16 A fragment, the head dim a whole number
# of k16 steps held in registers as the output accumulator.
DECODE_MMA_MAX_G = 16
DECODE_MMA_DIMS = (64, 128, 256)


def decode_engine(kv_dtype, q_dtype, g: int, d: int) -> str:
    """The engine that runs one B4 launch: ``"mma"`` (one launch: a
    cluster per (sequence, kv head) walks whole pages by bulk copy and
    runs QK^T and PV on mma.sync) for bf16 pages and a bf16 query with
    G = H/Hkv <= 16 and D in {64, 128, 256}; ``"simt"``
    (``flash_decode_paged.cu`` + its merge pass) otherwise: f32 and int8
    pages, and other head counts and dims."""
    if (dtype_name(kv_dtype) == "bfloat16"
            and dtype_name(q_dtype) == "bfloat16"
            and 1 <= g <= DECODE_MMA_MAX_G and d in DECODE_MMA_DIMS):
        return "mma"
    return "simt"


def flat_decode_engine(kv_dtype, q_dtype, g: int, d: int,
                       aligned: bool) -> str:
    """The engine that runs one B6 launch: ``"mma"`` (B4's mma engine over
    16-slot tiles of the flat or ring cache, ``flash_decode_mma.cu``: one
    launch, a cluster per (sequence, kv head)) for a bf16 cache and a bf16
    query with G = H/Hkv <= 16, D in {64, 128, 256} and an ``aligned``
    cache (D contiguous, every other stride of k and v a multiple of 16
    bytes, 16-byte aligned bases: what TMA can read); ``"simt"``
    (``flash_decode.cu`` + its merge pass) otherwise: f32 caches, other
    head counts and dims, and views TMA cannot take."""
    if aligned and decode_engine(kv_dtype, q_dtype, g, d) == "mma":
        return "mma"
    return "simt"


def scan_engine(dtype, b: int, s: int, w: int, aligned: bool = True) -> str:
    """The engine that runs one B7 launch: ``"staged"`` (a block per batch
    row and slab of 32 channels, the spans of a and b brought
    into shared memory by TMA, ``rglru_scan_staged.cu``) for f32 with W a
    multiple of 4 (TMA's 16-byte row stride), 16-byte aligned bases of a
    and b (``aligned``), 1 <= B <= 65535 and S >= 1; ``"direct"`` (one
    thread per channel reading device memory, ``rglru_scan.cu``)
    otherwise."""
    if (dtype_name(dtype) == "float32" and w % 4 == 0 and aligned
            and 1 <= b <= 65535 and s >= 1):
        return "staged"
    return "direct"


def decode_kv_split(rows: int, pages: int, sm_count: int = 132) -> int:
    """KV slices (one cluster) per (sequence, kv head) row of B4's and
    B6's mma engines: the fewest, doubling up to MAX_CLUSTER, that give
    rows x slices >= the SM count, with at least one page (B4) or 16-slot
    tile (B6) per slice (gemma_2b's decode, 4 rows of 68 pages: 8;
    recurrentgemma_9b's ring decode, 4 rows of 128 tiles: 8)."""
    s = 1
    while s * 2 <= MAX_CLUSTER and s * 2 <= pages and rows * s < sm_count:
        s *= 2
    return s


def attention_engine(dtype, d: int) -> str:
    """The engine that runs one B5 launch: ``"wgmma"`` (TMA + wgmma,
    ``flash_attention_wgmma.cu``) for bf16 at a head dim of 64, 128 or
    256 (every ported config's), ``"simt"`` (``flash_attention.cu``)
    otherwise: fp32, and the reduced configs' head dims."""
    if dtype_name(dtype) == "bfloat16" and d in (64, 128, 256):
        return "wgmma"
    return "simt"


def attention_kv_split(ctas: int, kv_tiles: int, sm_count: int = 132) -> int:
    """How many CTAs (a cluster) share one query tile's kv range on B5's
    wgmma engine: 2 when the grid of (batch·head, 64-query tile) CTAs
    fills at most half the card and the kv range holds at least two
    64-row tiles (gemma_2b's prefill chunk: 64 CTAs), else 1."""
    return 2 if 2 * ctas <= sm_count and kv_tiles >= 2 else 1


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
    # The tile loop's f32 rate: its unpipelined FMA blocks ran
    # 4096 x 16384 x 2048 in 39.3 ms on an H100 80GB HBM3 (~7.0 TFLOP/s,
    # PERF.md section 6, B1's f32 rows), the SIMT f32 engine in 6.6 ms.
    tile_fp32_flops: float = 7e12
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
        align it to the swizzle atom and two barriers per stage.  The SIMT
        f32 engine: its ring of ``SIMT_STAGES`` 16-deep f32 A and B
        stages, each row ``SIMT_PAD`` floats longer than the tile.
        ``engine`` None takes the wgmma engine for a bf16 or int8 wgmma
        tile (an int8 stage is 128 deep: the same bytes) and the SIMT
        engine for an f32 SIMT tile (the larger needs when the alignment
        is not known), else the loop."""
        tile = (self.bm, self.bn)
        if engine is None:
            engine = ("wgmma" if tile in WGMMA_TILES
                      and self.sew_i.bits <= 16 else
                      "simt" if tile in SIMT_TILES and self.sew_i.bits == 32
                      else "tile")
        if engine == "wgmma":
            stages = wgmma_stages(self.bm, self.bn)
            return (1024 + stages * (self.bm + self.bn) * WGMMA_BK * 2
                    + 16 * stages)
        if engine == "simt":
            return (SIMT_STAGES * SIMT_BK
                    * (self.bm + self.bn + 2 * SIMT_PAD) * 4)
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
    the tile loop's tiles with any split and group, the wgmma tiles on B1
    and B3 (no split) and the SIMT f32 tiles on B1 and B2 (any split)
    and B3 (no split).  Whether the operands suit the wgmma or the SIMT
    engine is :func:`gemm_engine`'s, :func:`splitk_engine`'s and
    :func:`grouped_engine`'s call, at launch."""
    tile = (geom.bm, geom.bn)
    if geom.policy == "amx":
        ok = (geom.bm, geom.bn, geom.bk) == RIGID_TILE and geom.split_k == 1
    else:
        ok = geom.bk % INNER_BK == 0 and geom.split_k >= 1 and (
            tile in TILE_LOOP_TILES
            or (tile in WGMMA_TILES and geom.split_k == 1)
            or (tile in SIMT_TILES and (group == 1 or geom.split_k == 1)))
    if not ok:
        raise ValueError(
            f"no {geom.policy!r} kernel is compiled for the tile "
            f"{geom.bm}x{geom.bn}x{geom.bk} split_k={geom.split_k} "
            f"group={group}; compiled: MTE tile loop {TILE_LOOP_TILES} "
            f"(bk a multiple of {INNER_BK}, any split or group), MTE "
            f"wgmma {WGMMA_TILES} (split_k 1, any group), MTE SIMT f32 "
            f"{SIMT_TILES} (any split at group 1, split_k 1 in a group), "
            f"rigid {RIGID_TILE}")


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


def tile_state_for(geom: BlockGeometry, m: int, n: int, k: int,
                   rlenb: int = 64) -> TileState:
    """The MTE CSR contents describing one block step of ``geom`` (the
    JAX package's ``tile_state_for``): the granted (tm, tn, tk) are the
    active extents within the block, clamped by the CSR's 12-bit
    fields."""
    return TileState(
        tm=min(geom.bm, m, 4096), tn=min(geom.bn, n, 4096),
        tk=min(geom.bk, k, 4096), sew_i=geom.sew_i, sew_o=geom.sew_o,
        rlenb=rlenb)


# ---------------------------------------------------------------------------
# The paper's CPU architectures (Tables IV, V, VI, VII), Formulas 2 and 3
# and the register-level unroll solver (§III-D): host arithmetic, the port
# of ``repro/core/geometry.py:73-310``, which core/isa.py and
# core/perfmodel.py read.  Nothing here describes the H100.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One evaluated architecture row of Table VII (+ system params, Table IV)."""

    name: str
    vlen_bits: int                 # vector register length
    rlen_bits: int                 # tile row length (0 => pure vector ISA)
    arch_regs: int                 # architecturally visible registers
    phys_regs: int                 # physical registers
    static_latency: int            # front-end latency, overlappable (cycles)
    dynamic_latency: int           # blocks the compute resource (cycles)
    n_units: int                   # VPUs (or 1 systolic array)
    systolic: bool
    freq_hz: float = 2.0e9
    flops_per_cycle: int = 512     # peak fp32 FLOP/cycle (all rows equal)
    # memory system (Table IV)
    l1_bytes: int = 48 * 1024
    l2_bytes: int = 2 * 1024 * 1024
    dram_bw_bytes_per_s: float = 191.25e9
    l1_bw_bytes_per_cycle: float = 128.0
    # Sustained tile-load bandwidth from L2: bounded by the L1's 10 MSHRs of
    # 128-byte lines over the 26-cycle L2 latency (Table IV) ≈ 48 B/cycle.
    l2_bw_bytes_per_cycle: float = 48.0
    issue_width: int = 6

    @property
    def dram_bw_bytes_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_s / self.freq_hz

    @property
    def peak_flops(self) -> float:
        return self.flops_per_cycle * self.freq_hz

    def max_vl_elems(self, sew: SEW) -> int:
        return self.vlen_bits // sew.bits


# Table VII rows.
PROFILES = {
    "vector1k": HardwareProfile(
        name="vector1k", vlen_bits=8192, rlen_bits=0, arch_regs=32,
        phys_regs=40, static_latency=20, dynamic_latency=4, n_units=4,
        systolic=False),
    "vector2k": HardwareProfile(
        name="vector2k", vlen_bits=16384, rlen_bits=0, arch_regs=32,
        phys_regs=40, static_latency=20, dynamic_latency=8, n_units=4,
        systolic=False),
    "sifiveint": HardwareProfile(
        name="sifiveint", vlen_bits=8192, rlen_bits=2048, arch_regs=32,
        phys_regs=40, static_latency=28, dynamic_latency=16, n_units=4,
        systolic=False),
    "mte8s": HardwareProfile(
        name="mte8s", vlen_bits=8192, rlen_bits=512, arch_regs=8,
        phys_regs=24, static_latency=36, dynamic_latency=16, n_units=1,
        systolic=True),
    "mte32s": HardwareProfile(
        name="mte32s", vlen_bits=8192, rlen_bits=512, arch_regs=32,
        phys_regs=40, static_latency=36, dynamic_latency=16, n_units=1,
        systolic=True),
    "mte32v": HardwareProfile(
        name="mte32v", vlen_bits=8192, rlen_bits=512, arch_regs=32,
        phys_regs=40, static_latency=36, dynamic_latency=64, n_units=4,
        systolic=False),
}


@dataclasses.dataclass(frozen=True)
class RegisterTile:
    """Maximum hardware tile geometry granted by the microarchitecture."""

    m: int
    n: int
    k: int
    transposed_b: bool  # mixed precision stores B col-major (paper §III-A2)

    @property
    def mnk(self) -> Tuple[int, int, int]:
        return (self.m, self.n, self.k)

    @property
    def macs(self) -> int:
        return self.m * self.n * self.k

    @property
    def flops(self) -> int:
        return 2 * self.macs


def max_tile_dims(profile: HardwareProfile, sew_i: SEW,
                  sew_o: Optional[SEW] = None) -> RegisterTile:
    """Formulas 2 (uniform) and 3 (mixed precision) from the paper.

    Uniform precision (SEW_i == SEW_o), row-major B::

        M = VLEN/RLEN,  N = RLEN/SEW,  K = min(M, N)

    Mixed precision (SEW_i < SEW_o), col-major ("transposed") B::

        M = VLEN/RLEN,  N = min(M, RLEN/SEW_o),  K = RLEN/SEW_i
    """
    sew_o = sew_o or sew_i
    if profile.rlen_bits == 0:
        # Pure vector ISA: degenerate 1 × VL × 1 geometry (Table VII).
        vl = profile.max_vl_elems(sew_i)
        return RegisterTile(m=1, n=vl, k=1, transposed_b=False)
    rows = profile.vlen_bits // profile.rlen_bits
    if sew_i == sew_o:
        m = rows
        n = profile.rlen_bits // sew_i.bits
        k = min(m, n)
        return RegisterTile(m=m, n=n, k=k, transposed_b=False)
    if sew_i.bits > sew_o.bits:
        raise ValueError("mixed precision requires SEW_i < SEW_o")
    m = rows
    n = min(m, profile.rlen_bits // sew_o.bits)
    k = profile.rlen_bits // sew_i.bits
    return RegisterTile(m=m, n=n, k=k, transposed_b=True)


def sifive_tile_dims(profile: HardwareProfile, sew_i: SEW) -> RegisterTile:
    """SiFiveInt per-instruction geometry: 4×4 A tile times all B tiles.

    With VLEN bits of B organized as independent 4×4 tiles the instruction
    geometry is M=4, K=4, N = 4 · (VLEN / (16·SEW)) — §V-C gives 4×64×4 for
    VLEN 8192, fp32.
    """
    tiles_in_reg = profile.vlen_bits // (16 * sew_i.bits)
    return RegisterTile(m=4, n=4 * tiles_in_reg, k=4, transposed_b=False)


@dataclasses.dataclass(frozen=True)
class UnrollPlan:
    """Software loop-unroll plan for Algorithm 1.

    ``um``/``un`` count how many M-/N-direction tiles are processed per
    micro-kernel invocation; ``um*un`` C accumulator tiles, ``um`` A tiles
    and one (streamed) B tile are live simultaneously.  Register budget:
    ``um*un + um + 1 <= arch_regs`` (the paper's register-pressure model —
    AMX's 8 registers cap this at 2×2, MTE₃₂'s 32 allow 4×5/5×4).
    """

    tile: RegisterTile
    um: int
    un: int
    policy: Policy

    @property
    def live_regs(self) -> int:
        return self.um * self.un + self.um + 1

    @property
    def indep_chains(self) -> int:
        return self.um * self.un

    @property
    def macro_m(self) -> int:
        return self.tile.m * self.um

    @property
    def macro_n(self) -> int:
        return self.tile.n * self.un


def solve_unroll(profile: HardwareProfile, tile: RegisterTile,
                 m: int, n: int, k: int, policy: Policy = "mte") -> UnrollPlan:
    """Choose (um, un) for Algorithm 1's M/N loop unrolling.

    Mirrors the paper's JIT code generator (§III-D, §V-B1): unrolling serves
    two purposes — (i) expose enough *independent* tfmul chains to hide the
    static+dynamic instruction latency, and (ii) reuse the A/B tiles held in
    registers to cut tile-load traffic.  Objective: among plans whose
    independent-chain count covers the latency-hiding threshold, minimize
    load bytes per MMA ``(um·|A-tile| + un·|B-tile|) / (um·un)``; fall back
    to maximum chains when the budget cannot reach the threshold (the
    8-register / AMX case).  Useful tiles only: unrolling beyond
    ceil(dim/tile) adds no work.
    """
    budget = profile.arch_regs
    max_um = max(1, cdiv(m, max(tile.m, 1)))
    max_un = max(1, cdiv(n, max(tile.n, 1)))
    # Latency-hiding threshold: chains needed so a dependent accumulation
    # chain never starves the compute resource.
    threshold = cdiv((profile.static_latency + profile.dynamic_latency)
                     * profile.n_units, max(profile.dynamic_latency, 1))
    a_bytes = max(tile.m * tile.k, 1)
    b_bytes = max(tile.k * tile.n, 1)

    candidates = []
    for um in range(1, min(max_um, budget) + 1):
        for un in range(1, min(max_un, budget) + 1):
            # Register pressure: um·un accumulators + A tiles + streamed B.
            # Budgets ≥ 16 double-buffer the A tiles and the B slot to hide
            # tile-load latency (the paper's JIT prefetch); the 8-register
            # AMX case has no headroom and single-buffers.
            if budget >= 16:
                live = um * un + 2 * um + 2
            else:
                live = um * un + um + 1
            if live > budget:
                continue
            candidates.append(UnrollPlan(tile=tile, um=um, un=un,
                                         policy=policy))
    if not candidates:
        raise ValueError("register budget cannot hold a single tile set")

    def pad_factor(p: UnrollPlan) -> float:
        pm = cdiv(m, p.macro_m) * p.macro_m
        pn = cdiv(n, p.macro_n) * p.macro_n
        return (pm * pn) / (m * n)

    def cost(p: UnrollPlan) -> float:
        loads = (p.um * a_bytes + p.un * b_bytes) / (p.um * p.un)
        return loads * pad_factor(p)

    covered = [p for p in candidates if p.indep_chains >= threshold]
    if covered:
        return min(covered, key=lambda p: (cost(p), -p.indep_chains))
    return max(candidates, key=lambda p: (p.indep_chains / pad_factor(p),
                                          -cost(p)))
