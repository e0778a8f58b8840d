#!/usr/bin/env python3
"""Decode kernels and B7 of one checkout of the repo, timed on the card: B2
at the decode GEMMs of gemma_2b, recurrentgemma_9b and gemma2_27b (through
the plan the plan cache grants, with the weight warm and cold in L2), B3
at their three decode q/k/v groups, B4 at gemma_2b's decode attention, B6 at
recurrentgemma_9b's ring decode attention (warm and cold), B8's stage 1
at gemma_2b's gate under amx (bf16, prefill chunk and decode, and int8 on
whatever engine the checkout's rule names) and its epilogue
pass at the amx path's shapes and at a ragged one, and B7 at the serving
prefill's (1, 512, 4096) on every engine the checkout has,
from zero and, where the checkout takes one, from h0, each with a SHA-256
of its output.  Inputs are made on the card from fixed seeds, so two
checkouts see the same operands.

Run it on two checkouts in turns (A, B, B, A), each in its own process, to
compare them on one card:

    python3 tools/ab_decode.py ROOT --out a1.json

ROOT is the checkout whose ``src/repro_torch`` and ``chip_smoke.py`` (for
its timers) are used; the kernels build into ``ROOT/build``.  ``--same``
FILE fails the run unless every B2, B3, B4 and epilogue-pass output hash
FILE has equals this run's, as does every B8 stage-1 row (bf16 on the same
engine; int8 exact on any), and every B7 row FILE has too (the direct
engine from zero, in a checkout before the staged engine) equals FILE's
(B6's engine may differ between checkouts; its hash shows that repeated
calls agree).  Every run fails unless its B7 rows from zero share one
hash, and its rows from h0 another: the engines agree bit for bit.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--same", help="a JSON file of an earlier run whose B2, "
                    "B3, B4 and pass output hashes this run must reproduce")
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
    from repro_torch.kernels.flash_decode import (flash_decode_kernel,
                                                  flash_decode_paged_kernel)
    from repro_torch.kernels import rglru_scan as scan_mod
    from repro_torch.kernels.grouped_gemm import grouped_gemm_kernel
    from repro_torch.kernels.rigid_gemm import (epilogue_pass_kernel,
                                                rigid_accumulate_kernel)
    from repro_torch.kernels.splitk_gemm import mte_gemm_splitk_kernel

    def sha(x):
        torch.cuda.synchronize()
        return hashlib.sha256(x.detach().contiguous().cpu().view(
            torch.uint8).numpy().tobytes()).hexdigest()

    def timed(run, cold=True):
        """Hash of the first call's output (the same as a second call's,
        or the run fails), and the warm (and cold) times."""
        out = run()
        row = {"sha256": sha(out)}
        if sha(run()) != row["sha256"]:
            raise AssertionError("ab_decode: two calls differ")
        row["ms"] = chip_smoke.time_ms(run)
        if cold:
            row["cold_ms"] = chip_smoke.time_ms_cold(run)
        return row

    build.build_all()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": root, "nvidia_smi": smi, "b2": {}, "b3": {}, "b4": {},
           "b6": {}, "b8": {}, "pass": {}, "b7": {}}
    cache = PlanCache()
    bf16 = torch.bfloat16
    for label, m, n, k, act in [
            ("gemma o", 4, 2048, 2048, "none"),
            ("gemma gate", 4, 16384, 2048, "gelu"),
            ("gemma up", 4, 16384, 2048, "none"),
            ("gemma down", 4, 2048, 16384, "none"),
            ("rg q/o/rglru", 4, 4096, 4096, "none"),
            ("rg gate", 4, 12288, 4096, "gelu"),
            ("rg down", 4, 4096, 12288, "none"),
            ("g2 o", 4, 4608, 4096, "none"),
            ("g2 gate", 4, 36864, 4608, "gelu"),
            ("g2 up", 4, 36864, 4608, "none"),
            ("g2 down", 4, 4608, 36864, "none")]:
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
        res["b2"][f"{label} {m}x{n}x{k}"] = timed(run)
    for label, c, k, widths in [("qkv 3x4x2048x2048", 4, 2048,
                                 (2048, 256, 256)),
                                ("qkv 3x4x4096x4096", 4, 4096,
                                 (4096, 256, 256)),
                                ("qkv 3x4x4608x4096", 4, 4608,
                                 (4096, 2048, 2048))]:
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
        res["b3"][label] = timed(run)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, kp, vp, table, lens = chip_smoke.paged_inputs(
        dev, b=4, h=8, hkv=1, d=256, page=16, lens=[1030, 1041, 1024, 1047],
        dtype=bf16, gen=gen)
    run = lambda: flash_decode_paged_kernel(  # noqa: E731
        q, kp, vp, table, lens)
    res["b4"]["4 slots x 8 heads x 256, ~1035 tokens"] = timed(run)
    # recurrentgemma_9b's local-layer decode: 4 slots x 16 heads on one kv
    # head x D 256 over its wrapped 2048-slot ring, read through the
    # (B, L, Hkv, D) storage, window 2048.
    gen = torch.Generator(device=dev).manual_seed(7)
    b, h, d, length = 4, 16, 256, 2048
    ring_k, ring_v = (torch.randn(b, length, 1, d, generator=gen,
                                  device=dev).to(bf16) for _ in range(2))
    qp = torch.tensor([2570, 2581, 2564, 2587], dtype=torch.int32,
                      device=dev)
    idx = torch.arange(length, device=dev)
    kvp = (qp[:, None] - (qp[:, None] - idx) % length).to(torch.int32)
    q = torch.randn(b, h, d, generator=gen, device=dev).to(bf16)
    run = lambda: flash_decode_kernel(  # noqa: E731
        q, ring_k.transpose(1, 2), ring_v.transpose(1, 2), kvp, qp,
        window=2048)
    res["b6"]["ring 4x16x256 L=2048"] = timed(run)
    # B8's stage 1 at the amx path's gate, prefill chunk and decode: bf16
    # (the wgmma engine) and int8 (the engine the checkout's rule names).
    for label, m, dt in [("bf16 gate 512x16384x2048", 512, bf16),
                         ("bf16 gate 4x16384x2048", 4, bf16),
                         ("int8 gate 512x16384x2048", 512, torch.int8),
                         ("int8 gate 4x16384x2048", 4, torch.int8)]:
        gen = torch.Generator(device=dev).manual_seed(m + 11)
        if dt == bf16:
            a = (torch.randn(m, 2048, generator=gen, device=dev)
                 / math.sqrt(2048)).to(bf16)
            b = torch.randn(2048, 16384, generator=gen, device=dev).to(bf16)
        else:
            a, b = (torch.randint(-127, 128, shape, generator=gen,
                                  device=dev, dtype=dt)
                    for shape in ((m, 2048), (2048, 16384)))
        run = lambda: rigid_accumulate_kernel(a, b)  # noqa: E731
        res["b8"][label] = timed(run)
    # B8's pass: the amx path's gate (prefill chunk and decode) with gelu,
    # the prefill shape with beta*C + bias + softcap, and a ragged N
    # (not a multiple of 8) with every option.
    gen = torch.Generator(device=dev).manual_seed(9)
    full = Epilogue(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
                    activation="gelu")
    for label, m, n, epi, out_dtype in [
            ("gelu 512x16384 bf16", 512, 16384, Epilogue(activation="gelu"),
             bf16),
            ("gelu 4x16384 bf16", 4, 16384, Epilogue(activation="gelu"),
             bf16),
            ("beta*C+bias+softcap gelu 512x16384 bf16", 512, 16384, full,
             bf16),
            ("beta*C+bias+softcap gelu 130x257 f32", 130, 257, full,
             torch.float32)]:
        acc = torch.randn(m, n, generator=gen, device=dev) * 3
        c = torch.randn(m, n, generator=gen, device=dev)
        bias = torch.randn(n, generator=gen, device=dev)
        run = lambda: epilogue_pass_kernel(  # noqa: E731
            acc, c, bias, epilogue=epi, out_dtype=out_dtype)
        res["pass"][label] = timed(run, cold=False)
    # B7 at the serving prefill's (1, 512, 4096) f32, on every engine the
    # checkout's wrapper can pin, from zero and, where it takes one, from
    # h0 (a resumed chunk).
    gen = torch.Generator(device=dev).manual_seed(8)
    a = torch.rand(1, 512, 4096, generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn(1, 512, 4096, generator=gen, device=dev)
    h0 = torch.randn(1, 4096, generator=gen, device=dev)
    takes = inspect.signature(scan_mod.rglru_scan_kernel).parameters
    for engine in ["direct"] + (["staged"] if "engine" in takes else []):
        kw = {"engine": engine} if "engine" in takes else {}
        for operands in ([(a, x)] + ([(a, x, h0)] if "h0" in takes
                                     else [])):
            start = "random" if len(operands) == 3 else "none"
            label = f"{engine} 1x512x4096 h0={start}"
            run = lambda: scan_mod.rglru_scan_kernel(  # noqa: E731
                *operands, **kw)
            res["b7"][label] = timed(run)
    res["launches"] = {k: v for k, v in build.launch_counts().items() if v}
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    for start in ("none", "random"):
        hashes = {row["sha256"] for label, row in res["b7"].items()
                  if label.endswith(f"h0={start}")}
        if len(hashes) > 1:
            print(f"ab_decode: B7's engines differ from h0={start}",
                  file=sys.stderr)
            return 1
    if args.same:
        with open(args.same) as fh:
            ref = json.load(fh)
        for part in ("b2", "b3", "b4", "b8", "pass", "b7"):
            for label, row in res[part].items():
                if part in ("b7", "b8") and label not in ref.get(part, {}):
                    continue
                if row["sha256"] != ref[part][label]["sha256"]:
                    print(f"ab_decode: {part} output at {label} differs "
                          f"from {args.same}", file=sys.stderr)
                    return 1
        print("ab_decode: every B2, B3, B4, B8, pass and B7 output equals "
              "the reference's bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
