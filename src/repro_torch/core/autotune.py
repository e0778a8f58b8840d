"""GEMM plan cache on Hopper (the port of ``repro.core.autotune``, the
subset the serving path runs).

For every distinct GEMM signature

    (M, N, K, dtype_in, dtype_out, epilogue, policy, backend, group, fmt)

the cache enumerates candidate geometries from the Hopper solver
(:func:`repro_torch.core.geometry.solve_block_geometry`) and, for bf16
and int8 shapes the wgmma engine takes, its tiles, and for f32 shapes the SIMT f32
engine takes, its tiles with and without split-K (grouped signatures
too, unsplit, past 16 rows); scores them with an analytic
Hopper time (:func:`score_geometry`), and memoizes the winner in an LRU.
Routes: ``"mte"`` (the B1 kernel, ``csrc/mte_gemm.cu``), ``"splitk"``
(B2: ``csrc/splitk_gemm_cluster.cu`` or ``csrc/splitk_gemm.cu``), offered
when the (M, N) tile grid leaves SMs idle, ``"grouped"`` (B3) and
``"rigid"`` (B8).

Queued (ROADMAP A4): the JSON warm start, measured refinement
(``measure=True``), ``runner_up`` and ``recalibrate``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.geometry import (
    INNER_BK, SIMT_BK, SIMT_TILES, WGMMA_BK, WGMMA_S8_BK, WGMMA_TILES,
    BlockGeometry, H100_SPEC, HopperProfile, Policy, cdiv, gemm_engine,
    grouped_engine, hopper_profile, round_up, solve_block_geometry,
    splitk_engine,
)
from repro_torch.core.tile_state import SEW, dtype_name

__all__ = [
    "GemmSignature", "ExecutionPlan", "PlanCache", "CacheStats",
    "enumerate_candidates", "score_geometry", "execute_plan", "get_plan",
    "plan_engine",
    "plan_cache", "reset_cache", "cache_stats", "cache_generation",
]

_SPLIT_CANDIDATES = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class GemmSignature:
    """The cache key: everything that changes which plan wins."""

    m: int
    n: int
    k: int
    dtype_in: str
    dtype_out: str
    epilogue: Epilogue
    policy: Policy = "mte"
    backend: str = "kernels"
    group: int = 1
    fmt: str = "fp32"

    @classmethod
    def make(cls, m: int, n: int, k: int, dtype_in, dtype_out,
             epilogue: Optional[Epilogue] = None, policy: Policy = "mte",
             backend: str = "kernels", group: int = 1,
             fmt: Optional[str] = None) -> "GemmSignature":
        if fmt is None:
            from repro_torch.core.formats import infer_format
            fmt = infer_format(dtype_in).name
        return cls(m=int(m), n=int(n), k=int(k),
                   dtype_in=dtype_name(dtype_in),
                   dtype_out=dtype_name(dtype_out),
                   epilogue=epilogue or Epilogue(), policy=policy,
                   backend=backend, group=int(group), fmt=str(fmt))

    @classmethod
    def for_format(cls, m: int, n: int, k: int, fmt, out_dtype,
                   epilogue: Optional[Epilogue] = None,
                   policy: Policy = "mte",
                   group: int = 1) -> "GemmSignature":
        """The signature a kernels-backed GEMM (``group`` 1) or grouped
        GEMM plans under the format policy ``fmt``: an int8 format its
        int8 product into int32 with the identity epilogue (the
        dequantize and the epilogue run after it), the others the operand
        type into ``out_dtype`` with ``epilogue``."""
        if fmt.quantized:
            return cls.make(m, n, k, "int8", "int32", None, policy,
                            group=group, fmt=fmt.name)
        return cls.make(m, n, k, fmt.operand_dtype, out_dtype, epilogue,
                        policy, group=group, fmt=fmt.name)

    @property
    def format_policy(self):
        from repro_torch.core.formats import FORMATS, infer_format
        return FORMATS.get(self.fmt) or infer_format(self.dtype_in)

    @property
    def sew_i(self) -> SEW:
        return SEW.from_dtype(self.dtype_in)

    @property
    def sew_o(self) -> SEW:
        return SEW.from_dtype(self.dtype_out)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A granted plan: kernel route + block geometry + predicted cost."""

    signature: GemmSignature
    geometry: BlockGeometry
    route: str                       # "mte" | "splitk" | "grouped" | "rigid"
    predicted_s: float
    measured_s: Optional[float] = None
    source: str = "analytic"   # "analytic" | "program" (pinned by
    #                            repro_torch.graph.schedule)

    @property
    def n_split(self) -> int:
        return self.geometry.split_k

    def describe(self) -> str:
        g = self.geometry
        tail = f" split_k={g.split_k}" if g.split_k > 1 else ""
        tail += " bT" if g.transposed_b else ""
        return (f"{self.route}[{g.bm}x{g.bn}x{g.bk}{tail}] "
                f"~{self.predicted_s * 1e6:.2f}us ({self.source})")


def _route_for(sig: GemmSignature, geom: BlockGeometry) -> str:
    """The kernel route of a geometry, in the JAX package's order
    (``autotune.py:190-197`` there)."""
    if sig.policy == "amx":
        return "rigid"
    if sig.group > 1:
        return "grouped"
    if geom.split_k > 1:
        return "splitk"
    return "mte"


def plan_engine(sig: GemmSignature, geom: BlockGeometry) -> str:
    """The mainloop a plan launches: ``"wgmma"``, ``"simt"``,
    ``"splitk"``, ``"cluster"`` or ``"tile"``.  B3 (grouped plans) follows
    :func:`repro_torch.core.geometry.grouped_engine` at the plan's tile
    (``"splitk"``, its cluster split-K kernel for the bf16 and int8 decode
    groups; ``"wgmma"`` and ``"simt"`` past 16 rows at their tiles) and B2
    (split plans)
    :func:`repro_torch.core.geometry.splitk_engine` (``"cluster"``, the
    same mainloop at G = 1 for the bf16 and int8 decode GEMMs, which keeps
    the tile loop's price, so no route or grouping decision moves; ``"simt"``, the
    SIMT f32 engine over K slices at its tiles).  B1 and B8 stage 1 follow
    :func:`repro_torch.core.geometry.gemm_engine` (ValueError when no
    engine takes the geometry)."""
    bf16acc = sig.format_policy.accum_dtype == "bfloat16"
    if sig.group > 1:
        return grouped_engine(sig.dtype_in, sig.m, sig.n, sig.k,
                              bf16acc=bf16acc, tile=(geom.bm, geom.bn))
    if geom.split_k > 1:
        return splitk_engine(sig.dtype_in, sig.m, sig.n, sig.k,
                             bf16acc=bf16acc, tile=(geom.bm, geom.bn))
    return gemm_engine(sig.dtype_in, geom.bm, geom.bn, sig.n, sig.k,
                       m=sig.m, bf16acc=bf16acc, rigid=sig.policy == "amx")


def _on_engine(sig: GemmSignature, geom: BlockGeometry,
               engine: str) -> bool:
    try:
        return plan_engine(sig, geom) == engine
    except ValueError:
        return False


def _split_bk(base_bk: int, k: int, s: int) -> int:
    """Largest inner-tile-aligned K slice ≤ base that gives ≥ s slices."""
    return min(base_bk, max(INNER_BK, round_up(cdiv(k, s), INNER_BK)))


def enumerate_candidates(sig: GemmSignature,
                         profile: HopperProfile = H100_SPEC
                         ) -> List[BlockGeometry]:
    """Candidate geometries for one signature, the solver's base first
    (its tile is the tile loop's tile for this M), then, for M ≥ 64, the
    wgmma tiles the engine takes for this signature (bf16 or bf16acc —
    whose two register sets stop at ``bn`` 128 —, K and N multiples of
    8; int8 past 16 rows with K a multiple of 16; same ``bk``), then split-K slices of the base when its (M, N) tile
    grid is below the SM count, or whatever the grid when B2's cluster
    engine would run them (bf16 and int8 decode GEMMs of at most 16 rows,
    :func:`splitk_engine`): that engine takes its own slices, one where
    the grid fills the card, while B1's only engine at such M is the tile
    loop (B2 never gets a wgmma tile).  The rigid
    policy gets exactly its fixed block (a rigid ISA cannot adapt), and
    grouped signatures no split (B3's split-K engine takes its own slices;
    the group axis already multiplies the grid) but the wgmma tiles at
    C ≥ 64 as B1 gets them.  f32 signatures past 16 rows get the
    SIMT f32 engine's tiles where it takes them (128 x 64 only where the
    128 x 128 grid, all members' tiles together, is below the SM count,
    or pads N less than it: N = 16, 48, 192, 320, ...), each unsplit
    and, ungrouped, where its own grid is below the SM count, split as
    the base is."""
    base = solve_block_geometry(sig.m, sig.n, sig.k, sig.sew_i, sig.sew_o,
                                profile=profile, policy=sig.policy)
    cands: List[BlockGeometry] = [base]
    if sig.policy != "mte":
        return cands
    if sig.m >= 64:     # at least one 64-row wgmma
        for bm, bn in WGMMA_TILES:
            g = dataclasses.replace(base, bm=bm, bn=bn)
            if g not in cands and _on_engine(sig, g, "wgmma"):
                cands.append(g)
    grid_mn = cdiv(sig.m, base.bm) * cdiv(sig.n, base.bn)
    cluster = splitk_engine(
        sig.dtype_in, sig.m, sig.n, sig.k,
        bf16acc=sig.format_policy.accum_dtype == "bfloat16") == "cluster"
    if sig.group == 1 and (grid_mn < profile.sm_count or cluster):
        _add_splits(sig, base, cands)
    group = max(sig.group, 1)
    bm0, bn0 = SIMT_TILES[0]
    wide = group * cdiv(sig.m, bm0) * cdiv(sig.n, bn0) >= profile.sm_count
    for bm, bn in SIMT_TILES:
        if wide and bn != bn0 and round_up(sig.n, bn) >= round_up(sig.n, bn0):
            continue
        g = dataclasses.replace(base, bm=bm, bn=bn)
        if g in cands or not _on_engine(sig, g, "simt"):
            continue
        cands.append(g)
        if group == 1 and cdiv(sig.m, bm) * cdiv(sig.n, bn) < \
                profile.sm_count:
            _add_splits(sig, g, cands)
    return cands


def _add_splits(sig: GemmSignature, geom: BlockGeometry,
                cands: List[BlockGeometry]) -> None:
    """Append ``geom`` split into each of :data:`_SPLIT_CANDIDATES` K
    slices of whole ``INNER_BK`` blocks, where K holds that many."""
    if sig.k <= INNER_BK:
        return
    for s in _SPLIT_CANDIDATES:
        bk = _split_bk(geom.bk, sig.k, s)
        if cdiv(sig.k, bk) < s:
            continue
        g = dataclasses.replace(geom, bk=bk, split_k=s)
        if g not in cands:
            cands.append(g)


def _wave_seconds(sig: GemmSignature, geom: BlockGeometry,
                  profile: HopperProfile, depth: int,
                  extra_bytes: float) -> float:
    """The time of a pipelined engine (wgmma, SIMT f32): whole waves of
    blocks (tiles x K slices) over the SMs, each block taking the longer
    of its ``depth`` K rows of multiply-adds at one SM's share of the
    format's peak and its operand loads at one SM's share of the L2 rate
    (the stage ring overlaps the two), and never less than every operand,
    the output and ``extra_bytes`` moved once through device memory."""
    m, n, k = sig.m, sig.n, sig.k
    bm, bn = geom.bm, geom.bn
    sms = profile.sm_count
    tile_mma = 2.0 * bm * bn * depth / (profile.peak_flops(sig.sew_i) / sms)
    tile_load = ((bm + bn) * depth * sig.sew_i.bytes
                 / (profile.l2_bw_bytes_per_s / sms))
    waves = cdiv(cdiv(m, bm) * cdiv(n, bn) * geom.split_k, sms)
    hbm = ((m * k + k * n) * sig.sew_i.bytes + m * n * sig.sew_o.bytes
           + extra_bytes) / profile.hbm_bw_bytes_per_s
    return max(waves * max(tile_mma, tile_load), hbm)


def score_geometry(sig: GemmSignature, geom: BlockGeometry,
                   profile: HopperProfile = H100_SPEC) -> float:
    """Predicted seconds, plus launch overhead.  On the wgmma engine
    (:func:`plan_engine`): tile waves on the SMs against operand traffic
    (:func:`_wave_seconds`, the K depth padded to a 64-deep stage; int8,
    priced at the int8 peak, to its 128-deep stage).  On
    the SIMT f32 engine the same at 67 TFLOP/s over each block's K slice
    (padded to a 16-deep stage), with no load stretch; a split pays its
    partials' write and read back and the reduction's launch.  On the
    tile loop, and for every grouped plan whatever engine runs it: the
    larger of padded MMA
    work over the format's peak and operand/partial traffic over HBM
    bandwidth, stretched by the share of the card the block grid leaves
    idle (a grid below ``sm_count * blocks_per_sm`` resident blocks cannot
    cover memory latency: its loads are not pipelined); f32 work that the
    tile loop itself runs (unsplit or over K slices) takes no less than
    its padded operations at the rate measured on a full card,
    ``profile.tile_fp32_flops``, which binds from a grid of about a
    tenth of the card up: the smaller grids, the reduced models' f32
    chunks and groups, keep their stretched price and their plans.
    Split-K pays a second launch for the reduction; the rigid route
    pays, on every engine, the accumulator's write and read back and,
    with a non-identity epilogue, the epilogue pass's launch.  A grouped
    signature is priced as G GEMMs' worth of tiles on one grid: G times
    the work and the traffic, G times the blocks.  Grouped plans keep the
    tile loop's price on the split-K, wgmma and SIMT engines too: the
    scheduler weighs a grouped program against its members with these
    prices (``graph/schedule.py``), and on an H100 the engines' own price
    moved qwen15_4b's 512-row and musicgen_medium's 4096-row q/k/v into
    grouped launches that made those chunks slower (the grouped program
    restacks the weights on every call and adds the biases outside the
    kernel, which this model does not count); the plan's tile still
    follows the shape."""
    m, n, k = sig.m, sig.n, sig.k
    launches = 1
    rigid_bytes = 0.0
    if sig.policy == "amx":
        rigid_bytes = 2.0 * m * n * 4
        launches = 1 if sig.epilogue.is_identity else 2
    runs = plan_engine(sig, geom)
    engine = "tile" if sig.group > 1 else runs
    if engine == "wgmma":
        stage = WGMMA_S8_BK if sig.sew_i.bits == 8 else WGMMA_BK
        return (_wave_seconds(sig, geom, profile, round_up(k, stage),
                              rigid_bytes)
                + profile.launch_s * launches)
    if engine == "simt":
        s = geom.split_k
        depth = round_up(cdiv(k, s), SIMT_BK)
        partials = 2.0 * s * m * n * 4 if s > 1 else 0.0
        return (_wave_seconds(sig, geom, profile, depth,
                              partials + rigid_bytes)
                + profile.launch_s * (launches + (1 if s > 1 else 0)))
    g = max(sig.group, 1)
    gm, gn = cdiv(m, geom.bm), cdiv(n, geom.bn)
    s = geom.split_k
    blocks = g * gm * gn * s
    flops = 2.0 * g * round_up(m, geom.bm) * round_up(n, geom.bn) * k
    acc_b = sig.format_policy.sew_o.bytes
    bytes_ = g * ((m * k * gn + k * n * gm) * sig.sew_i.bytes
                  + m * n * sig.sew_o.bytes) + rigid_bytes
    if s > 1:
        bytes_ += 2 * s * m * n * acc_b
        launches = 2
    t = max(flops / profile.peak_flops(sig.sew_i),
            bytes_ / profile.hbm_bw_bytes_per_s)
    slots = profile.sm_count * profile.blocks_per_sm
    occupancy = min(blocks, slots) / slots
    t /= occupancy
    if sig.sew_i.bits == 32 and runs in ("tile", "splitk"):
        t = max(t, flops / profile.tile_fp32_flops)
    return t + profile.launch_s * launches


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    solver_calls: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class PlanCache:
    """In-process LRU of GemmSignature → ExecutionPlan."""

    def __init__(self, maxsize: int = 4096,
                 profile: Optional[HopperProfile] = None):
        self.maxsize = maxsize
        self.profile = profile or hopper_profile()
        self._plans: "OrderedDict[GemmSignature, ExecutionPlan]" = \
            OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, sig: GemmSignature) -> bool:
        return sig in self._plans

    def clear(self) -> None:
        self._plans.clear()
        self.stats = CacheStats()

    def plan(self, sig: GemmSignature, *, measure: bool = False
             ) -> ExecutionPlan:
        if measure:
            raise NotImplementedError(
                "measured plan refinement is ROADMAP A4")
        hit = self._plans.get(sig)
        if hit is not None:
            self.stats.hits += 1
            self._plans.move_to_end(sig)
            return hit
        self.stats.misses += 1
        plan = self._build(sig)
        self._plans[sig] = plan
        while len(self._plans) > self.maxsize:
            self._plans.popitem(last=False)
        return plan

    def _build(self, sig: GemmSignature) -> ExecutionPlan:
        self.stats.solver_calls += 1
        cands = enumerate_candidates(sig, self.profile)
        scored = sorted(((score_geometry(sig, g, self.profile), i, g)
                         for i, g in enumerate(cands)),
                        key=lambda t: (t[0], t[1]))
        best_s, _, best_g = scored[0]
        return ExecutionPlan(signature=sig, geometry=best_g,
                             route=_route_for(sig, best_g),
                             predicted_s=best_s)


def execute_plan(plan: ExecutionPlan, a, b, c=None, bias=None, *,
                 widths=None):
    """Launch the plan's route on concrete operands (already cast or
    quantized to the format by the caller).  The grouped route takes
    x (G, C, K) and w (G, K, N) as ``a`` and ``b`` and, in ``widths``,
    each member's true output width.  The rigid route ignores the
    narrow accumulator: a rigid ISA cannot adapt its width.  The split-K
    engines take their slices for the signature's rows, which may be
    fewer than the operands' (``ops.mte_gemm(plan_rows=)``)."""
    from repro_torch.core.formats import to_torch_dtype
    from repro_torch.kernels.grouped_gemm import grouped_gemm_kernel
    from repro_torch.kernels.mte_gemm import mte_gemm_kernel
    from repro_torch.kernels.rigid_gemm import rigid_gemm_kernel
    from repro_torch.kernels.splitk_gemm import mte_gemm_splitk_kernel

    sig = plan.signature
    out_dtype = to_torch_dtype(sig.dtype_out)
    acc_dtype = sig.format_policy.accum_torch
    if plan.route == "rigid":
        return rigid_gemm_kernel(a, b, c, bias, epilogue=sig.epilogue,
                                 out_dtype=out_dtype)
    if plan.route == "grouped":
        if c is not None or bias is not None:
            raise ValueError("the grouped route takes no C or bias")
        return grouped_gemm_kernel(a, b, geom=plan.geometry,
                                   epilogue=sig.epilogue,
                                   out_dtype=out_dtype, acc_dtype=acc_dtype,
                                   widths=widths, split_rows=sig.m)
    if plan.route == "splitk":
        return mte_gemm_splitk_kernel(
            a, b, c, bias, geom=plan.geometry, n_split=plan.n_split,
            epilogue=sig.epilogue, out_dtype=out_dtype, acc_dtype=acc_dtype,
            split_rows=sig.m)
    return mte_gemm_kernel(a, b, c, bias, geom=plan.geometry,
                           epilogue=sig.epilogue, out_dtype=out_dtype,
                           acc_dtype=acc_dtype)


_GLOBAL: Optional[PlanCache] = None
_GENERATION = 0


def cache_generation() -> int:
    """Bumped on every :func:`reset_cache`: memoized compiled programs
    pin plans granted by the cache of their generation."""
    return _GENERATION


def plan_cache() -> PlanCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = PlanCache()
    return _GLOBAL


def reset_cache(maxsize: int = 4096,
                profile: Optional[HopperProfile] = None) -> PlanCache:
    global _GLOBAL, _GENERATION
    _GLOBAL = PlanCache(maxsize=maxsize, profile=profile)
    _GENERATION += 1
    return _GLOBAL


def cache_stats() -> CacheStats:
    return plan_cache().stats


def get_plan(m: int, n: int, k: int, dtype_in, dtype_out=None, *,
             epilogue: Optional[Epilogue] = None, policy: Policy = "mte",
             backend: str = "kernels", group: int = 1,
             fmt: Optional[str] = None,
             measure: bool = False) -> ExecutionPlan:
    """The one-call planning entry point used by ``kernels/ops.py``."""
    dtype_out = dtype_out if dtype_out is not None else dtype_in
    sig = GemmSignature.make(m, n, k, dtype_in, dtype_out, epilogue,
                             policy, backend, group, fmt)
    return plan_cache().plan(sig, measure=measure)
