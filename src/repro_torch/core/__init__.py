"""MTE core on Hopper: the paper's contribution as a composable PyTorch
library (the port of ``repro.core``).

Layout:
- ``tile_state``  — the 64-bit MTE CSR, bit-accurate (paper §III-B).
- ``geometry``    — the Hopper block-geometry solver and engine rules,
                    beside the paper's CPU profiles, Formulas 2/3 and the
                    unroll solver (§III-A, §III-D).
- ``epilogue``    — vector-processing-mode epilogues (§III-C4).
- ``formats``     — data-format policies (the SEW contract): fp32 / bf16 /
                    bf16acc / int8-with-scales, shared by every GEMM path.
- ``dispatch``    — ``mte_gemm`` public entry point and ``plan_gemm``.
- ``autotune``    — plan cache: per-signature candidate search on the
                    Hopper engines + LRU memoization.
- ``isa``         — retired-instruction accounting (Table IX).
- ``perfmodel``   — analytical machine model (§V-E simulator analogue).
- ``conv``        — direct convolution → one grouped GEMM (§V-B1).
"""
from repro_torch.core.autotune import (
    ExecutionPlan, GemmSignature, PlanCache, get_plan, plan_cache,
)
from repro_torch.core.dispatch import GemmPlan, mte_gemm, plan_gemm
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import (
    FORMATS, FormatPolicy, infer_format, resolve_format,
)
from repro_torch.core.geometry import (
    H100_SPEC, PROFILES, BlockGeometry, HardwareProfile, HopperProfile,
    hopper_profile, max_tile_dims, solve_block_geometry, solve_unroll,
)
from repro_torch.core.tile_state import SEW, TailPolicy, TileState

__all__ = [
    "GemmPlan", "mte_gemm", "plan_gemm", "Epilogue",
    "FORMATS", "FormatPolicy", "infer_format", "resolve_format",
    "ExecutionPlan", "GemmSignature", "PlanCache", "get_plan", "plan_cache",
    "PROFILES", "H100_SPEC", "BlockGeometry", "HardwareProfile",
    "HopperProfile", "hopper_profile",
    "max_tile_dims", "solve_block_geometry", "solve_unroll",
    "SEW", "TailPolicy", "TileState",
]
