"""Analytical machine model for the paper's evaluated architectures (§V-E).

The port of ``repro.core.perfmodel``.  The paper's performance numbers
come from a trace-driven simulator that models physical register
allocation, cache-level data movement, and the two instruction cost
components of Table VII:

- a **static** front-end latency, overlappable with other instructions, and
- a **dynamic** latency tied to vector length/compute throughput that
  blocks the compute resource.

:func:`model_gemm` is the reproduction's equivalent, carried over
verbatim: a closed-form model of the same effects, driven by the kernel
structure (tile geometry + unroll plan from
:mod:`repro_torch.core.geometry`) instead of an instruction trace.  Per
GEMM:

``cycles = max(compute, memory, issue)`` where

- ``compute``: MMA count × per-MMA occupancy.  A dependent accumulation
  chain can only issue one MMA per (static + dynamic) cycles, so with
  ``n_indep`` live accumulator tiles the effective inverse throughput is
  ``max(dynamic / n_units, (static + dynamic) / n_indep)`` — the
  register-count mechanism the paper identifies: AMX's 8 registers bound
  ``n_indep`` at 4 (2×2 unroll) while MTE₃₂'s 32 registers sustain 16-20
  chains.
- ``memory``: tile-load traffic through the L2 + DRAM re-stream traffic for
  operand panels that exceed cache capacity (Table IV memory system).
- ``issue``: retired instructions / issue width (Table IV, 6-wide).

Efficiency = useful FLOPs / (cycles × 512 FLOP/cycle), the paper's
"percentage of peak performance" metric (all architectures share the same
1024 GFLOP/s fp32 peak, §V-A).  These are the paper's CPU design points,
not the H100.

The card's side is the port planner's own model: :func:`analytic_seconds`
returns what :func:`repro_torch.core.autotune.score_geometry` gives the
analytic base candidate on :func:`repro_torch.core.geometry.
hopper_profile` (the JAX package's TPU model, ``tpu_gemm_time``, prices a
TPU and has no counterpart here).  The calibration table holds measured /
modelled ratios for consumers that want them; nothing in the planner
reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.geometry import (
    HardwareProfile, HopperProfile, PROFILES, cdiv, max_tile_dims,
    sifive_tile_dims, solve_unroll,
)
from repro_torch.core.isa import count_instructions
from repro_torch.core.tile_state import SEW

__all__ = ["GemmTiming", "model_gemm", "model_all", "analytic_seconds",
           "set_calibration", "clear_calibration", "calibration",
           "calibrated_seconds"]


@dataclasses.dataclass(frozen=True)
class GemmTiming:
    arch: str
    m: int
    n: int
    k: int
    cycles: float
    compute_cycles: float
    memory_cycles: float
    issue_cycles: float
    useful_flops: int
    padded_flops: int

    @property
    def efficiency(self) -> float:
        profile = PROFILES[self.arch]
        return self.useful_flops / (self.cycles * profile.flops_per_cycle)

    @property
    def gflops(self) -> float:
        profile = PROFILES[self.arch]
        secs = self.cycles / profile.freq_hz
        return self.useful_flops / secs / 1e9

    @property
    def seconds(self) -> float:
        return self.cycles / PROFILES[self.arch].freq_hz

    @property
    def bottleneck(self) -> str:
        parts = {"compute": self.compute_cycles, "memory": self.memory_cycles,
                 "issue": self.issue_cycles}
        return max(parts, key=parts.get)


def _tile_and_plan(profile: HardwareProfile, m, n, k, sew_i, sew_o):
    if profile.name == "sifiveint":
        tile = sifive_tile_dims(profile, sew_i)
    else:
        tile = max_tile_dims(profile, sew_i, sew_o)
    plan = solve_unroll(profile, tile, m, n, k)
    return tile, plan


def model_gemm(arch: str, m: int, n: int, k: int,
               sew_i: SEW = SEW.E32, sew_o: SEW = SEW.E32,
               with_beta: bool = True) -> GemmTiming:
    """Model one GEMM's execution on one of the Table VII architectures."""
    profile = PROFILES[arch]
    sew = sew_i
    useful_flops = 2 * m * n * k

    if profile.rlen_bits == 0:
        # --- vector ISA: vectorize N, unroll M ---------------------------
        vl = profile.max_vl_elems(sew)
        um = max(1, min(profile.arch_regs - 2, m))
        nt, mt = cdiv(n, vl), cdiv(m, um)
        kt = k
        n_mma = mt * nt * k * um          # vfmacc instructions
        flops_per_mma = 2 * vl            # padded: full VL occupied
        n_indep = um
        # per K step: one B-row vector load (A comes via scalar broadcast)
        loads = [(mt * nt * k, min(n, vl) * sew.bytes)]
        c_moves = mt * nt * um * (2 if with_beta else 1)
        loads_c_bytes = min(n, vl) * sew_o.bytes
        macro_m, macro_n = um, vl
    else:
        tile, plan = _tile_and_plan(profile, m, n, k, sew_i, sew_o)
        um, un = plan.um, plan.un
        mt = cdiv(m, tile.m * um)
        nt = cdiv(n, tile.n * un)
        kt = cdiv(k, tile.k)
        n_mma = mt * nt * kt * um * un
        flops_per_mma = tile.flops
        n_indep = plan.indep_chains
        a_tile_bytes = tile.m * tile.k * sew_i.bytes
        b_tile_bytes = tile.k * tile.n * sew_i.bytes
        loads = [(mt * nt * kt * um, a_tile_bytes),
                 (mt * nt * kt * un, b_tile_bytes)]
        c_moves = mt * nt * um * un * (2 if with_beta else 1)
        loads_c_bytes = tile.m * tile.n * sew_o.bytes
        macro_m, macro_n = tile.m * um, tile.n * un

    padded_flops = n_mma * flops_per_mma

    # -- compute: dependency-limited vs resource-limited ---------------------
    # MTE32v's cvfma decomposition moves A operands across the lane
    # interconnect between steps (§IV-A2) — an occupancy overhead the
    # Table VII dynamic latency does not include.
    eff_dynamic = profile.dynamic_latency
    if profile.rlen_bits and not profile.systolic and profile.name == "mte32v":
        eff_dynamic = profile.dynamic_latency * 1.15
    per_mma = max(eff_dynamic / profile.n_units,
                  (profile.static_latency + profile.dynamic_latency)
                  / max(n_indep, 1))
    compute_cycles = n_mma * per_mma
    if not profile.systolic:
        # Vector-unit implementations (§IV-A2) execute tile moves, slides and
        # the vector-mode epilogue on the *same* VPUs as the cvfma compute —
        # the systolic variants run them on their dedicated side VPUs.  Each
        # vector op occupies a VPU for VLEN/lane-width cycles.
        move_cycles = profile.vlen_bits / 2048.0
        n_loads = sum(cnt for cnt, _ in loads)
        n_aux = n_loads + c_moves
        if profile.name == "sifiveint":
            n_aux += n_mma  # A-tile slides, one per MMA (see isa.py)
        compute_cycles += n_aux * move_cycles / profile.n_units

    # -- memory ---------------------------------------------------------------
    # L2→register tile-load port: sustained bandwidth is MSHR-limited
    # (profile.l2_bw) and each discrete load pays a minimum port occupancy —
    # tiny tile loads (SiFiveInt's 64 B A tiles) waste the port.
    min_occ = 4.0  # cycles
    l2_cycles = 0.0
    for count, nbytes in loads + [(c_moves, loads_c_bytes)]:
        l2_cycles += count * max(nbytes / profile.l2_bw_bytes_per_cycle, min_occ)

    # DRAM: cache-blocked panel streaming.  With the m→n→k loop nest of
    # Algorithm 1, the A row-panel (macro_m × K) is reused across the N sweep
    # if it fits in half the L2; the B column-panel (K × macro_n) is streamed
    # once per N iteration and reused across M if it fits.
    a_bytes = m * k * sew_i.bytes
    b_bytes = k * n * sew_i.bytes
    c_bytes = m * n * sew_o.bytes
    a_panel = macro_m * k * sew_i.bytes
    b_panel = k * macro_n * sew_i.bytes
    a_streams = 1 if a_panel <= profile.l2_bytes // 2 else max(1, cdiv(n, macro_n))
    b_streams = 1 if b_panel <= profile.l2_bytes // 2 else max(1, cdiv(m, macro_m))
    dram_bytes = (a_bytes * a_streams + b_bytes * b_streams
                  + c_bytes * (2 if with_beta else 1))
    dram_cycles = dram_bytes / profile.dram_bw_bytes_per_cycle
    memory_cycles = max(l2_cycles, dram_cycles)
    counts = count_instructions(arch, m, n, k, sew_i, sew_o, with_beta)

    # -- issue ---------------------------------------------------------------
    # Vector/matrix instructions plus ~30% scalar loop/address overhead.
    issue_cycles = counts.total * 1.3 / profile.issue_width

    cycles = max(compute_cycles, memory_cycles, issue_cycles)
    return GemmTiming(arch=arch, m=m, n=n, k=k, cycles=cycles,
                      compute_cycles=compute_cycles,
                      memory_cycles=memory_cycles,
                      issue_cycles=issue_cycles,
                      useful_flops=useful_flops, padded_flops=padded_flops)


def model_all(m: int, n: int, k: int, sew_i: SEW = SEW.E32,
              sew_o: SEW = SEW.E32) -> Dict[str, GemmTiming]:
    return {a: model_gemm(a, m, n, k, sew_i, sew_o) for a in PROFILES}


# ---------------------------------------------------------------------------
# The card's side: the port planner's own model
# ---------------------------------------------------------------------------


def analytic_seconds(m: int, n: int, k: int, *, fmt: str = "fp32",
                     policy: str = "mte", group: int = 1,
                     profile: Optional[HopperProfile] = None) -> float:
    """Predicted seconds for a dispatch that never consulted the planner.

    Solves the analytic block geometry for the shape and format
    (:func:`repro_torch.core.geometry.solve_block_geometry`, the plan
    cache's base candidate) and returns its price,
    :func:`repro_torch.core.autotune.score_geometry`, on ``profile``
    (default :func:`~repro_torch.core.geometry.hopper_profile`).  A
    ``group`` > 1 is priced as the grouped launch the plan cache prices
    (G GEMMs' worth of tiles on one grid).  A policy without a Hopper
    kernel (``"sifive"``, ``"vector"``) is priced as ``"mte"``, as the
    JAX package's ``analytic_seconds`` does."""
    from repro_torch.core.autotune import GemmSignature, score_geometry
    from repro_torch.core.formats import FORMATS
    from repro_torch.core.geometry import hopper_profile, solve_block_geometry
    profile = profile or hopper_profile()
    fp = FORMATS.get(fmt, FORMATS["fp32"])
    solver_policy = policy if policy in ("mte", "amx") else "mte"
    sig = GemmSignature.for_format(m, n, k, fp, fp.accum_dtype,
                                   policy=solver_policy, group=group)
    geom = solve_block_geometry(m, n, k, sig.sew_i, sig.sew_o,
                                profile=profile, policy=solver_policy)
    return score_geometry(sig, geom, profile)


# ---------------------------------------------------------------------------
# Measured calibration scales
# ---------------------------------------------------------------------------
#
# Where a measurement and the model disagree, a per-(shape_class, fmt)
# measured/modeled ratio can be installed here so any consumer that wants
# measured-honest predictions multiplies through ``calibrated_seconds``.
# Nothing in the planner consumes these: plan ranking stays analytic and
# deterministic.

_CALIBRATION: Dict[tuple, float] = {}


def set_calibration(shape_class: str, fmt: str, ratio: float) -> None:
    """Record a measured/modeled error ratio for one (shape class, fmt)."""
    ratio = float(ratio)
    if not (ratio > 0.0) or ratio != ratio or ratio == float("inf"):
        raise ValueError(f"calibration ratio must be finite and positive, "
                         f"got {ratio!r} for ({shape_class}, {fmt})")
    _CALIBRATION[(str(shape_class), str(fmt))] = ratio


def clear_calibration() -> None:
    _CALIBRATION.clear()


def calibration() -> Dict[str, float]:
    """The installed ratios as ``{"shape_class/fmt": ratio}`` (a copy)."""
    return {f"{sc}/{fmt}": r for (sc, fmt), r in sorted(_CALIBRATION.items())}


def calibrated_seconds(seconds: float, shape_class: str, fmt: str) -> float:
    """Scale an analytic prediction by the installed measured ratio
    (identity when no ratio has been installed for the class/format)."""
    return float(seconds) * _CALIBRATION.get((str(shape_class), str(fmt)),
                                             1.0)
