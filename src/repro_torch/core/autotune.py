"""GEMM plan cache on Hopper (the port of ``repro.core.autotune``, the
subset the serving path runs).

For every distinct GEMM signature

    (M, N, K, dtype_in, dtype_out, epilogue, policy, backend, group, fmt)

the cache enumerates candidate geometries from the Hopper solver
(:func:`repro_torch.core.geometry.solve_block_geometry`), scores them
with an analytic Hopper time (:func:`score_geometry`), and memoizes the
winner in an LRU.  Routes: ``"mte"`` (the B1 kernel, ``csrc/mte_gemm.cu``)
and ``"splitk"`` (the B2 kernel, ``csrc/splitk_gemm.cu``), offered when
the (M, N) tile grid leaves SMs idle.

Queued (ROADMAP A4): the JSON warm start, measured refinement
(``measure=True``), ``runner_up`` and ``recalibrate``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.geometry import (
    INNER_BK, BlockGeometry, H100_SPEC, HopperProfile, Policy,
    cdiv, hopper_profile, round_up, solve_block_geometry,
)
from repro_torch.core.tile_state import SEW, dtype_name

__all__ = [
    "GemmSignature", "ExecutionPlan", "PlanCache", "CacheStats",
    "enumerate_candidates", "score_geometry", "execute_plan", "get_plan",
    "plan_cache", "reset_cache", "cache_stats",
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
    route: str                       # "mte" | "splitk"
    predicted_s: float
    measured_s: Optional[float] = None
    source: str = "analytic"

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
    if sig.policy == "amx":
        raise NotImplementedError("the rigid route is ROADMAP B8")
    if sig.group > 1:
        raise NotImplementedError("the grouped route is ROADMAP B3")
    if geom.split_k > 1:
        return "splitk"
    return "mte"


def _split_bk(base_bk: int, k: int, s: int) -> int:
    """Largest inner-tile-aligned K slice ≤ base that gives ≥ s slices."""
    return min(base_bk, max(INNER_BK, round_up(cdiv(k, s), INNER_BK)))


def enumerate_candidates(sig: GemmSignature,
                         profile: HopperProfile = H100_SPEC
                         ) -> List[BlockGeometry]:
    """Candidate geometries for one signature, the solver's base first
    (its tile is the kernel tile for this M), then split-K slices when
    the (M, N) tile grid is below the SM count."""
    base = solve_block_geometry(sig.m, sig.n, sig.k, sig.sew_i, sig.sew_o,
                                profile=profile, policy=sig.policy)
    cands: List[BlockGeometry] = [base]
    grid_mn = cdiv(sig.m, base.bm) * cdiv(sig.n, base.bn)
    if sig.group == 1 and grid_mn < profile.sm_count and sig.k > INNER_BK:
        for s in _SPLIT_CANDIDATES:
            bk = _split_bk(base.bk, sig.k, s)
            if cdiv(sig.k, bk) < s:
                continue
            g = dataclasses.replace(base, bk=bk, split_k=s)
            if g not in cands:
                cands.append(g)
    return cands


def score_geometry(sig: GemmSignature, geom: BlockGeometry,
                   profile: HopperProfile = H100_SPEC) -> float:
    """Predicted seconds: the larger of padded MMA work over the format's
    peak and operand/partial traffic over HBM bandwidth, stretched by the
    share of the card the block grid leaves idle (a grid below
    ``sm_count * blocks_per_sm`` resident blocks cannot cover memory
    latency), plus launch overhead (split-K pays a second launch for the
    reduction)."""
    m, n, k = sig.m, sig.n, sig.k
    gm, gn = cdiv(m, geom.bm), cdiv(n, geom.bn)
    s = geom.split_k
    blocks = gm * gn * s
    flops = 2.0 * round_up(m, geom.bm) * round_up(n, geom.bn) * k
    acc_b = sig.format_policy.sew_o.bytes
    bytes_ = ((m * k * gn + k * n * gm) * sig.sew_i.bytes
              + m * n * sig.sew_o.bytes)
    if s > 1:
        bytes_ += 2 * s * m * n * acc_b
    t = max(flops / profile.peak_flops(sig.sew_i),
            bytes_ / profile.hbm_bw_bytes_per_s)
    slots = profile.sm_count * profile.blocks_per_sm
    occupancy = min(blocks, slots) / slots
    return t / occupancy + profile.launch_s * (2 if s > 1 else 1)


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


def execute_plan(plan: ExecutionPlan, a, b, c=None, bias=None):
    """Launch the plan's route on concrete operands (already cast or
    quantized to the format by the caller)."""
    from repro_torch.core.formats import to_torch_dtype
    from repro_torch.kernels.mte_gemm import mte_gemm_kernel
    from repro_torch.kernels.splitk_gemm import mte_gemm_splitk_kernel

    sig = plan.signature
    out_dtype = to_torch_dtype(sig.dtype_out)
    acc_dtype = sig.format_policy.accum_torch
    if plan.route == "splitk":
        return mte_gemm_splitk_kernel(
            a, b, c, bias, geom=plan.geometry, n_split=plan.n_split,
            epilogue=sig.epilogue, out_dtype=out_dtype, acc_dtype=acc_dtype)
    return mte_gemm_kernel(a, b, c, bias, geom=plan.geometry,
                           epilogue=sig.epilogue, out_dtype=out_dtype,
                           acc_dtype=acc_dtype)


_GLOBAL: Optional[PlanCache] = None


def plan_cache() -> PlanCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = PlanCache()
    return _GLOBAL


def reset_cache(maxsize: int = 4096,
                profile: Optional[HopperProfile] = None) -> PlanCache:
    global _GLOBAL
    _GLOBAL = PlanCache(maxsize=maxsize, profile=profile)
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
