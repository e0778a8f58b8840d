#!/usr/bin/env python3
"""Decode kernels of one checkout of the repo, timed on the card: B2 at the
decode GEMMs of gemma_2b and recurrentgemma_9b (through the plan the plan
cache grants, with the weight warm and cold in L2), B3 at the two decode
q/k/v groups (with a SHA-256 of each output) and B4 at gemma_2b's decode
attention.  Inputs are made on the card from fixed seeds, so two checkouts
see the same operands.

Run it on two checkouts in turns (A, B, B, A), each in its own process, to
compare them on one card:

    python3 tools/ab_decode.py ROOT --out a1.json

ROOT is the checkout whose ``src/repro_torch`` and ``chip_smoke.py`` (for
its timers) are used; the kernels build into ``ROOT/build``.  ``--same``
FILE fails the run unless every B3 output hash equals the one in FILE.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--same", help="a JSON file of an earlier run whose B3 "
                    "output hashes this run must reproduce")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("ab_decode: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.autotune import PlanCache, GemmSignature
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.graph import stack_group_weights
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
    from repro_torch.kernels.grouped_gemm import grouped_gemm_kernel
    from repro_torch.kernels.splitk_gemm import mte_gemm_splitk_kernel

    build.build_all()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": root, "nvidia_smi": smi, "b2": {}, "b3": {}, "b4": {}}
    cache = PlanCache()
    bf16 = torch.bfloat16
    for label, m, n, k, act in [
            ("gemma o", 4, 2048, 2048, "none"),
            ("gemma gate", 4, 16384, 2048, "gelu"),
            ("gemma up", 4, 16384, 2048, "none"),
            ("gemma down", 4, 2048, 16384, "none"),
            ("rg q/o/rglru", 4, 4096, 4096, "none"),
            ("rg gate", 4, 12288, 4096, "gelu"),
            ("rg down", 4, 4096, 12288, "none")]:
        gen = torch.Generator(device=dev).manual_seed(m * n + k)
        a = (torch.randn(m, k, generator=gen, device=dev)
             / math.sqrt(k)).to(bf16)
        b = torch.randn(k, n, generator=gen, device=dev).to(bf16)
        epi = Epilogue(activation=act)
        plan = cache.plan(GemmSignature.make(m, n, k, bf16, bf16, epi,
                                             fmt="bf16"))
        run = lambda: mte_gemm_splitk_kernel(  # noqa: E731
            a, b, geom=plan.geometry, n_split=plan.n_split, epilogue=epi,
            out_dtype=bf16)
        res["b2"][f"{label} {m}x{n}x{k}"] = {
            "ms": chip_smoke.time_ms(run),
            "cold_ms": chip_smoke.time_ms_cold(run)}
    for label, c, k, widths in [("qkv 3x4x2048x2048", 4, 2048,
                                 (2048, 256, 256)),
                                ("qkv 3x4x4096x4096", 4, 4096,
                                 (4096, 256, 256))]:
        gen = torch.Generator(device=dev).manual_seed(k)
        x = (torch.randn(c, k, generator=gen, device=dev)
             / math.sqrt(k)).to(bf16)
        ws = stack_group_weights([torch.randn(k, w, generator=gen,
                                              device=dev).to(bf16)
                                  for w in widths])
        xg = x[None].expand(len(widths), c, k)
        n = max(widths)
        plan = cache.plan(GemmSignature.make(c, n, k, bf16, bf16, Epilogue(),
                                             group=len(widths), fmt="bf16"))
        run = lambda: grouped_gemm_kernel(  # noqa: E731
            xg, ws, geom=plan.geometry, out_dtype=bf16, widths=list(widths))
        out = run()
        torch.cuda.synchronize()
        res["b3"][label] = {
            "sha256": hashlib.sha256(
                out.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "ms": chip_smoke.time_ms(run),
            "cold_ms": chip_smoke.time_ms_cold(run)}
    gen = torch.Generator(device=dev).manual_seed(2)
    q, kp, vp, table, lens = chip_smoke.paged_inputs(
        dev, b=4, h=8, hkv=1, d=256, page=16, lens=[1030, 1041, 1024, 1047],
        dtype=bf16, gen=gen)
    run = lambda: flash_decode_paged_kernel(  # noqa: E731
        q, kp, vp, table, lens)
    res["b4"]["4 slots x 8 heads x 256, ~1035 tokens"] = {
        "ms": chip_smoke.time_ms(run),
        "cold_ms": chip_smoke.time_ms_cold(run)}
    res["launches"] = {k: v for k, v in build.launch_counts().items() if v}
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    if args.same:
        with open(args.same) as fh:
            ref = json.load(fh)["b3"]
        for label, row in res["b3"].items():
            if row["sha256"] != ref[label]["sha256"]:
                print(f"ab_decode: B3 output at {label} differs from "
                      f"{args.same}", file=sys.stderr)
                return 1
        print("ab_decode: every B3 output equals the reference's bit for "
              "bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
