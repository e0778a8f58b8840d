#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):

1. Environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the build of every kernel under
   ``src/repro_torch/csrc`` with nvcc (into ``build/``; the compiler log
   goes to ``build_log.txt`` in the output directory).
2. Kernels against their plain PyTorch versions on the card: B1
   ``mte_gemm``, B2 ``splitk_gemm``, B4 ``flash_decode_paged``, B5
   ``flash_attention`` — at the exact shapes the serving phase launches
   (bf16) and at small ragged shapes in every mode each kernel takes.  Each
   prints its max error beside the tolerance; the main-path shapes also
   print the kernel time (CUDA events, median of 10), its bound
   (max(FLOP / peak, bytes / 3.35 TB/s)), the plain version's time and the
   time of one library call for the same function (``torch.matmul`` or
   ``F.scaled_dot_product_attention``), timed only as a yardstick.
3. The whole path held against the CPU: gemma_2b.reduced() in fp32 with
   one seed, served by the port's engine on the card (kernels) and on the
   CPU (plain versions): first-token logits within 1e-3, identical greedy
   token streams.
4. Full-width serving: gemma_2b (18 layers, d_model 2048, vocab 256000) in
   bf16 with seeded random weights, 4 slots, 16-token pages, 1024-token
   prompts in 512-token chunks, 6 requests × 24 greedy tokens, two
   sharing their first 512 tokens.  Launch counters are zeroed just
   before and read just after; every kernel must have launched.

Then it prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the rest of the checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device milliseconds of one call, from CUDA events between
    back-to-back calls.  A sleep kernel holds the device while the host
    enqueues every call, so the host's own time per call (Python, the
    wrapper's allocations) is not counted as the kernel's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(200_000_000)        # ~0.1 s at the H100's clocks
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound_ms(flops: float, nbytes: float, peak: float) -> float:
    return 1e3 * max(flops / peak, nbytes / HBM_BYTES_PER_S)


def bound_by(flops: float, nbytes: float, peak: float) -> str:
    return "operations" if flops / peak >= nbytes / HBM_BYTES_PER_S \
        else "bytes"


def require(cond, what) -> None:
    """Fail the run (an explicit raise, kept under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(name, got, want, tol, rel=True):
    """Assert |got - want| <= tol * (1 + |want|) elementwise (tol = 0:
    exact); print the max error beside the tolerance."""
    import torch
    err = max_err(got, want)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    lim = tol * (1.0 + want.float().abs()) if rel else tol
    ok = bool((diff <= lim).all())
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g}"
        f"{' x (1+|ref|)' if rel and tol else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} over tolerance "
                             f"{tol:g}")
    return err


# -- phase 2: kernels against their plain versions -----------------------------

def gemm_phase(dev, rows):
    import torch
    from repro_torch.core.autotune import PlanCache, GemmSignature
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.geometry import BlockGeometry, SEW
    from repro_torch.kernels.mte_gemm import mte_gemm_kernel, mte_gemm_torch
    from repro_torch.kernels.splitk_gemm import (mte_gemm_splitk_kernel,
                                                 mte_gemm_splitk_torch)

    gen = torch.Generator(device=dev).manual_seed(1)
    cache = PlanCache()

    def operands(m, n, k, dt):
        if dt == torch.int8:
            return (torch.randint(-127, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8),
                    torch.randint(-127, 128, (k, n), generator=gen,
                                  device=dev, dtype=torch.int8))
        a = torch.randn(m, k, generator=gen, device=dev) / math.sqrt(k)
        b = torch.randn(k, n, generator=gen, device=dev)
        return a.to(dt), b.to(dt)

    # Small ragged shapes in every mode the GEMM kernels take.
    modes = [("fp32", torch.float32, None, torch.float32, 1e-4),
             ("bf16", torch.bfloat16, None, torch.bfloat16, 2e-2),
             ("bf16acc", torch.bfloat16, torch.bfloat16, torch.float32,
              3e-2),
             ("int8", torch.int8, None, torch.int32, 0.0)]
    epi_full = Epilogue(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
                        activation="gelu")
    for label, dt, acc, out_dt, tol in modes:
        for m, n, k in [(100, 70, 130), (7, 300, 1000), (33, 257, 65)]:
            a, b = operands(m, n, k, dt)
            bm, bn = (16, 128) if m <= 16 else (64, 64)
            geom = BlockGeometry(bm, bn, 64, 1, 1, False, SEW.E32, SEW.E32,
                                 "mte")
            epi = Epilogue() if dt == torch.int8 else epi_full
            c = torch.randn(m, n, device=dev)
            bias = torch.randn(n, device=dev)
            c_, bias_ = (None, None) if dt == torch.int8 else (c, bias)
            want = mte_gemm_torch(a, b, c_, bias_, geom=geom, epilogue=epi,
                                  out_dtype=out_dt, acc_dtype=acc)
            got = mte_gemm_kernel(a, b, c_, bias_, geom=geom, epilogue=epi,
                                  out_dtype=out_dt, acc_dtype=acc)
            check(f"mte_gemm {label} {m}x{n}x{k}", got, want, tol)
            bt = b.t().contiguous()
            tgeom = dataclasses.replace(geom, transposed_b=True)
            got = mte_gemm_kernel(a, bt, c_, bias_, geom=tgeom, epilogue=epi,
                                  out_dtype=out_dt, acc_dtype=acc)
            check(f"mte_gemm {label} transposed-B {m}x{n}x{k}", got, want,
                  tol)
            for s in (3, 4):
                want = mte_gemm_splitk_torch(a, b, c_, bias_, geom=geom,
                                             n_split=s, epilogue=epi,
                                             out_dtype=out_dt,
                                             acc_dtype=acc)
                got = mte_gemm_splitk_kernel(a, b, c_, bias_, geom=geom,
                                             n_split=s, epilogue=epi,
                                             out_dtype=out_dt,
                                             acc_dtype=acc)
                check(f"splitk_gemm {label} n_split={s} {m}x{n}x{k}", got,
                      want, tol)

    # The bf16 GEMMs of the full-width serving run, through the plans the
    # serving run gets (prefill chunk M = 512, decode M = 4 slots).
    d, f, hd = 2048, 16384, 256
    shapes = [("q/o", d, d, "none"), ("k/v", hd, d, "none"),
              ("gate", f, d, "gelu"), ("up", f, d, "none"),
              ("down", d, f, "none")]
    for m in (512, 4):
        for label, n, k, act in shapes:
            epi = Epilogue(activation=act)
            sig = GemmSignature.make(m, n, k, "bfloat16", "bfloat16", epi,
                                     fmt="bf16")
            plan = cache.plan(sig)
            a, b = operands(m, n, k, torch.bfloat16)
            if plan.route == "splitk":
                kern = "splitk_gemm"
                run = lambda: mte_gemm_splitk_kernel(  # noqa: E731
                    a, b, geom=plan.geometry, n_split=plan.n_split,
                    epilogue=epi, out_dtype=torch.bfloat16)
                plain = lambda: mte_gemm_splitk_torch(  # noqa: E731
                    a, b, geom=plan.geometry, n_split=plan.n_split,
                    epilogue=epi, out_dtype=torch.bfloat16)
            else:
                kern = "mte_gemm"
                run = lambda: mte_gemm_kernel(  # noqa: E731
                    a, b, geom=plan.geometry, epilogue=epi,
                    out_dtype=torch.bfloat16)
                plain = lambda: mte_gemm_torch(  # noqa: E731
                    a, b, geom=plan.geometry, epilogue=epi,
                    out_dtype=torch.bfloat16)
            err = check(f"{kern} main-path {label} {m}x{n}x{k} "
                        f"[{plan.describe()}]", run(), plain(), 2e-2)
            flops = 2.0 * m * n * k
            nbytes = 2.0 * (m * k + k * n + m * n)
            row = {"kernel": kern, "shape": f"{label} {m}x{n}x{k}",
                   "plan": plan.describe(), "max_abs_err": err,
                   "tol": 2e-2, "ms": time_ms(run), "plain_ms": time_ms(plain),
                   "bound_ms": bound_ms(flops, nbytes, PEAK["bf16"]),
                   "bound_by": bound_by(flops, nbytes, PEAK["bf16"]),
                   "library_ms": time_ms(lambda: torch.matmul(a, b))}
            rows.append(row)
            log(f"    time {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
                f"torch.matmul {row['library_ms']:.4f} ms")


def paged_inputs(dev, *, b, h, hkv, d, page, lens, dtype, gen, stale=False):
    import torch
    maxp = max(-(-int(s) // page) for s in lens) + 1
    total = 1 + sum(-(-int(s) // page) for s in lens) + 2
    kp = torch.randn(total, page, hkv, d, generator=gen, device=dev)
    vp = torch.randn(total, page, hkv, d, generator=gen, device=dev)
    table = torch.full((b, maxp), -1, dtype=torch.int32)
    nxt = 1
    for bi, s in enumerate(lens):
        for i in range(-(-int(s) // page)):
            table[bi, i] = nxt
            nxt += 1
    if stale:
        table[0, 1] = total - 1   # a mapped page holding other data
        if b > 2:
            table[2, 1] = -1      # an unmapped page inside a live row
    q = torch.randn(b, h, d, generator=gen, device=dev)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def decode_phase(dev, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_paged_kernel,
                                                  flash_decode_paged_torch)
    from repro_torch.models.attention import _quantize_kv
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, dtype, tol in [("fp32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 1e-2)]:
        for kw in [{}, {"window": 6, "softcap": 5.0}]:
            q, kp, vp, table, lens = paged_inputs(
                dev, b=4, h=8, hkv=2, d=64, page=8, lens=[5, 17, 25, 0],
                dtype=dtype, gen=gen, stale=True)
            table[3] = -1         # an empty row: zeros out
            got = flash_decode_paged_kernel(q, kp, vp, table, lens, **kw)
            want = flash_decode_paged_torch(q, kp, vp, table, lens, **kw)
            check(f"flash_decode_paged {label} {kw or 'plain'}", got, want,
                  tol)
            require(float(got[3].float().abs().max()) == 0.0,
                    "flash_decode_paged: an empty row must give zeros")
    q, kp, vp, table, lens = paged_inputs(
        dev, b=3, h=4, hkv=1, d=32, page=4, lens=[5, 17, 26],
        dtype=torch.float32, gen=gen)
    kq, ks = _quantize_kv(kp)
    vq, vs = _quantize_kv(vp)
    got = flash_decode_paged_kernel(q, kq, vq, table, lens, ks, vs)
    want = flash_decode_paged_torch(q, kq, vq, table, lens, ks, vs)
    check("flash_decode_paged int8 pages", got, want, 1e-5)

    # The serving run's decode: 4 slots, 8 query heads on 1 kv head,
    # D = 256, 16-token pages, ~1024-1048 cached tokens per slot.
    b, h, hkv, d, page = 4, 8, 1, 256, 16
    lens = [1030, 1041, 1024, 1047]
    q, kp, vp, table, lens_t = paged_inputs(dev, b=b, h=h, hkv=hkv, d=d,
                                            page=page, lens=lens,
                                            dtype=torch.bfloat16, gen=gen)
    run = lambda: flash_decode_paged_kernel(  # noqa: E731
        q, kp, vp, table, lens_t)
    plain = lambda: flash_decode_paged_torch(  # noqa: E731
        q, kp, vp, table, lens_t)
    err = check("flash_decode_paged main-path bf16 4x8x256 ~1035 tokens",
                run(), plain(), 1e-2)
    idx = table.clamp(min=0).long()
    kg = kp[idx].reshape(b, -1, hkv, d).permute(0, 2, 1, 3)
    vg = vp[idx].reshape(b, -1, hkv, d).permute(0, 2, 1, 3)
    pos = torch.arange(kg.shape[2], device=dev)[None]
    mask = ((pos < lens_t[:, None].long())
            & (table >= 0).repeat_interleave(page, 1))[:, None, None, :]
    qs = q[:, :, None, :]
    kx, vx = kg.expand(b, h, -1, d), vg.expand(b, h, -1, d)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, kx, vx, attn_mask=mask)
    live = sum(lens)
    flops = 4.0 * live * h * d
    nbytes = 2.0 * (2 * live * hkv * d + 2 * b * h * d) + 4 * table.numel()
    row = {"kernel": "flash_decode_paged", "shape": "4 slots x 8 heads x "
           "256, ~1035 tokens", "max_abs_err": err, "tol": 1e-2,
           "ms": time_ms(run), "plain_ms": time_ms(plain),
           "bound_ms": bound_ms(flops, nbytes, PEAK["bf16"]),
           "bound_by": bound_by(flops, nbytes, PEAK["bf16"]),
           "library_ms": time_ms(lib)}
    rows.append(row)
    log(f"    time {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
        f"sdpa {row['library_ms']:.4f} ms")


def attention_phase(dev, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_torch)
    gen = torch.Generator(device=dev).manual_seed(3)

    def qkv(b, h, hkv, sq, skv, d, dtype):
        return (torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype),
                torch.randn(b, hkv, skv, d, generator=gen,
                            device=dev).to(dtype),
                torch.randn(b, hkv, skv, d, generator=gen,
                            device=dev).to(dtype))

    cases = [
        ("causal", (1, 4, 4, 70, 70, 32), {}),
        ("GQA", (2, 8, 2, 48, 48, 64), {}),
        ("window", (1, 4, 1, 40, 40, 32), {"window": 16}),
        ("softcap", (1, 2, 2, 33, 33, 16), {"softcap": 20.0}),
        ("Sq<Skv", (1, 4, 2, 20, 83, 32), {}),
        ("non-causal", (1, 2, 1, 24, 56, 32), {"causal": False}),
    ]
    for label, dtype, tol in [("fp32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 1e-2)]:
        for name, shape, kw in cases:
            q, k, v = qkv(*shape, dtype)
            check(f"flash_attention {label} {name}",
                  flash_attention_kernel(q, k, v, **kw),
                  flash_attention_torch(q, k, v, **kw), tol)

    # The serving run's prefill chunks: 512 queries x 8 heads against the
    # 512-token chunk itself and against 512 prefix + 512 chunk tokens.
    for skv in (512, 1024):
        b, h, hkv, sq, d = 1, 8, 1, 512, 256
        q, k, v = qkv(b, h, hkv, sq, skv, d, torch.bfloat16)
        run = lambda: flash_attention_kernel(q, k, v)  # noqa: E731
        plain = lambda: flash_attention_torch(q, k, v)  # noqa: E731
        err = check(f"flash_attention main-path bf16 {sq}x{skv} H=8 D=256",
                    run(), plain(), 1e-2)
        qp = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        mask = torch.arange(skv, device=dev)[None] <= qp
        kx, vx = k.expand(b, h, skv, d), v.expand(b, h, skv, d)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kx, vx, attn_mask=mask)
        visible = sq * (skv - sq) + sq * (sq + 1) // 2
        flops = 4.0 * b * h * d * visible
        nbytes = 2.0 * (2 * b * h * sq * d + 2 * b * hkv * skv * d)
        row = {"kernel": "flash_attention", "shape": f"{sq}x{skv} H=8 D=256",
               "max_abs_err": err, "tol": 1e-2, "ms": time_ms(run),
               "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, PEAK["bf16"]),
               "bound_by": bound_by(flops, nbytes, PEAK["bf16"]),
               "library_ms": time_ms(lib)}
        rows.append(row)
        log(f"    time {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms")


# -- phase 3: the whole path on the card against the CPU -----------------------

def reduced_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("gemma_2b").reduced()       # fp32
    params_cpu = model_lib.init_params(cfg, seed=0, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    params_gpu = to(params_cpu, dev)
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab, 24, dtype=np.int32)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, 8,
                                                  dtype=np.int32)])
               for _ in range(3)] + [rng.integers(0, cfg.vocab, 20,
                                                  dtype=np.int32)]
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=16)

    # First-token logits of one prompt through both chunks.
    logits = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 1, 64, num_pages=9,
                                           page_size=8, device=device)
        table = torch.arange(1, 9, dtype=torch.int32,
                             device=device)[None]
        toks = torch.as_tensor(prompts[0].astype(np.int64), device=device)
        for p0 in (0, 16):
            out, cache = model_lib.prefill_chunk(
                params, {"tokens": toks[None, p0:p0 + 16],
                         "page_table": table}, cache, cfg, pos0=p0)
        logits[str(device)] = out.cpu()
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced fp32 first-token logits cuda vs cpu: max_abs_err="
        f"{err:.3e} tol=1e-3")
    require(err <= 1e-3, f"first-token logits differ by {err}")

    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        outs[str(device)] = eng.run()
        log(f"  reduced engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }")
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"greedy stream of request {rid} differs")
    log("  reduced engine: greedy streams identical on cuda and cpu")


# -- phase 4: full-width serving ---------------------------------------------

def serving_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import autotune
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("gemma_2b")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  gemma_2b params: {model_lib.param_count(params) / 1e9:.3f} B "
        f"(f32), init {time.perf_counter() - t0:.1f} s")

    timing = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
              "decode_steps": 0, "decode_tokens": 0}

    class TimedEngine(ServingEngine):
        """Synchronises around each prefill chunk and decode launch so the
        host clock measures device work."""

        def _advance_prefill(self, slot):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super()._advance_prefill(slot)
            torch.cuda.synchronize()
            timing["prefill_s"] += time.perf_counter() - t
            timing["prefill_tokens"] += self.prefill_chunk

        def _launch_decode(self, decoding):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super()._launch_decode(decoding)
            torch.cuda.synchronize()
            timing["decode_s"] += time.perf_counter() - t
            timing["decode_steps"] += 1
            timing["decode_tokens"] += len(decoding)

    eng = TimedEngine(params, cfg, slots=4, page_size=16, prefill_len=1024,
                      cache_len=1088, prefill_chunk=512, device=dev)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 1024, dtype=np.int32)
               for _ in range(6)]
    # Request 4 is admitted when 0 finishes and aliases its first chunk.
    prompts[4][:512] = prompts[0][:512]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_tokens=24))
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics()
    log(f"  served {len(out)} requests in {wall:.2f} s: statuses "
        f"{ {r: v.status for r, v in out.items()} }")
    log(f"  launch counts: {counts}")
    log(f"  prefill: {timing['prefill_tokens']} tokens in "
        f"{timing['prefill_s']:.3f} s = "
        f"{timing['prefill_tokens'] / timing['prefill_s']:.1f} tokens/s")
    log(f"  decode: {timing['decode_tokens']} tokens in "
        f"{timing['decode_steps']} steps, {timing['decode_s']:.3f} s = "
        f"{timing['decode_tokens'] / timing['decode_s']:.1f} tokens/s, "
        f"{1e3 * timing['decode_s'] / timing['decode_steps']:.3f} ms/step")
    log(f"  peak memory: {peak / 2**30:.2f} GiB; prefix_hit_pages="
        f"{m['prefix_hit_pages']}, prefill_tokens={m['prefill_tokens']}, "
        f"cached_prefill_tokens={m['cached_prefill_tokens']}")
    for rid, resp in out.items():
        require(resp.status == "ok", resp)
        require(len(resp) == 24, (rid, len(resp)))
        require(all(0 <= tok < cfg.vocab for tok in resp), rid)
    require(m["prefix_hit_pages"] > 0, m)
    for name, n in counts.items():
        require(n > 0, f"{name} was never launched on the main path")
    # Finite logits at full width (the engine quarantines non-finite rows;
    # check one prefill's logits directly too).
    cache = model_lib.init_paged_cache(cfg, 1, 1024, num_pages=65,
                                       page_size=16, device=dev)
    table = torch.arange(1, 65, dtype=torch.int32, device=dev)[None]
    toks = torch.as_tensor(prompts[1][:512].astype(np.int64), device=dev)
    logits, _ = model_lib.prefill_chunk(
        eng.params, {"tokens": toks[None], "page_table": table}, cache,
        eng.cfg, pos0=0)
    require(logits.shape == (1, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            "full-width prefill logits not finite")
    plans = sorted({(p.signature.m, p.signature.n, p.signature.k,
                     p.describe()) for p in autotune.plan_cache()._plans.values()})
    for plan in plans:
        log(f"  plan {plan[0]}x{plan[1]}x{plan[2]}: {plan[3]}")
    profile = profile_steps(eng, dev)
    return counts, {
        "prefill_tokens_per_s": timing["prefill_tokens"]
        / timing["prefill_s"],
        "decode_tokens_per_s": timing["decode_tokens"] / timing["decode_s"],
        "ms_per_decode_step": 1e3 * timing["decode_s"]
        / timing["decode_steps"],
        "decode_steps": timing["decode_steps"],
        "peak_memory_gib": peak / 2**30, "wall_s": wall,
        "prefix_hit_pages": m["prefix_hit_pages"], "profile": profile}


def step_bounds(eng, positions, chunk: int, pos0: int):
    """Least device time of one decode step (a token at each of
    ``positions``) and of one ``chunk``-token prefill chunk at ``pos0``:
    max(operations / bf16 peak, bytes / HBM rate), each weight and KV
    byte read once, at the widths the engine holds them in."""
    cfg, params = eng.cfg, eng.params
    weights = [d["w"] for lp in params["layers"]
               for grp in ("mixer", "ffn") for d in lp[grp].values()]
    w_params = sum(w.numel() for w in weights)
    w_bytes = sum(w.numel() * w.element_size() for w in weights)
    head = params["embedding"]["unembed"]
    head_bytes = head.numel() * head.element_size()
    kv = eng.cache["layers"][0]["k_pages"]
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * kv.element_size() * cfg.n_layers
    attn = 4 * cfg.n_heads * cfg.hd * cfg.n_layers   # FLOP per (q, kv) pair
    seen = sum(p + 1 for p in positions)
    dec_flops = (2 * len(positions) * (w_params + head.numel())
                 + attn * seen)
    dec_bytes = w_bytes + head_bytes + kv_row * seen
    pairs = chunk * pos0 + chunk * (chunk + 1) // 2
    pre_flops = 2 * chunk * w_params + attn * pairs + 2 * head.numel()
    pre_bytes = w_bytes + head_bytes + kv_row * (pos0 + chunk)
    return {"decode_step": {"bound_ms": bound_ms(dec_flops, dec_bytes,
                                                 PEAK["bf16"]),
                            "weight_gb": w_bytes / 1e9,
                            "lm_head_gb": head_bytes / 1e9,
                            "kv_gb": kv_row * seen / 1e9},
            "prefill_chunk": {"bound_ms": bound_ms(pre_flops, pre_bytes,
                                                   PEAK["bf16"]),
                              "tflop": pre_flops / 1e12}}


def profile_steps(eng, dev, steps: int = 3):
    """``torch.profiler`` over a few full-width decode steps (4 slots at
    ~1040 cached tokens, over pages left in the pool by the serving run)
    and one 512-token prefill chunk: wall time per call, device busy time
    (sum of kernel times), the device's idle share, the kernels that take
    the most device time, and the call's bound (:func:`step_bounds`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_lib

    maxp = eng.sched.max_pages_per_seq
    positions = [1030, 1041, 1024, 1047]
    bounds = step_bounds(eng, positions, chunk=512, pos0=512)
    table = (1 + torch.arange(4 * maxp, dtype=torch.int32,
                              device=dev)).reshape(4, maxp)
    batch = {"tokens": torch.zeros(4, 1, dtype=torch.int32, device=dev),
             "pos": torch.tensor(positions, device=dev),
             "page_table": table}
    temps = torch.zeros(4, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)

    def decode():
        return model_lib.decode_and_sample(
            eng.params, batch, eng.cache, eng.cfg, generator=None,
            temperatures=temps, active_rows=active)

    def prefill():
        return model_lib.prefill_chunk(
            eng.params, {"tokens": batch["tokens"].new_zeros(1, 512).long(),
                         "page_table": table[:1]}, eng.cache, eng.cfg,
            pos0=512)

    out = {}
    for name, fn, n in (("decode_step", decode, steps),
                        ("prefill_chunk", prefill, 1)):
        fn()
        torch.cuda.synchronize()
        # Wall time without the profiler, whose own overhead would inflate
        # the idle share; then the device time under it.
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            dev_us = (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0) or 0)
            # An aten op reports the kernels it launched as its own device
            # time; count the kernels only.
            if dev_us > 0 and not e.key.startswith("aten::"):
                rows.append((dev_us / n / 1e3, e.key, e.count // n))
        busy_ms = sum(r[0] for r in rows)
        rows.sort(reverse=True)
        top = [{"kernel": k[:60], "ms": ms, "calls": c}
               for ms, k, c in rows[:8]]
        out[name] = {"wall_ms": wall_ms,
                     "device_busy_ms": busy_ms if rows else None,
                     "idle_share": (1 - busy_ms / wall_ms) if rows
                     else None, "top": top, **bounds[name]}
        busy = (f"device busy {busy_ms:.3f} ms" if rows else
                "device time not measured (no device events)")
        log(f"  profile {name}: wall {wall_ms:.3f} ms, {busy}, bound "
            f"{bounds[name]['bound_ms']:.3f} ms")
        for r in top:
            log(f"    {r['ms']:.4f} ms x{r['calls']} {r['kernel']}")
    return out


KERNELS = [
    ("mte_gemm", "src/repro_torch/csrc/mte_gemm.cu",
     "src/repro/kernels/mte_gemm.py:114", "gate 512x16384x2048"),
    ("splitk_gemm", "src/repro_torch/csrc/splitk_gemm.cu",
     "src/repro/kernels/splitk_gemm.py:60", "gate 4x16384x2048"),
    ("flash_decode_paged", "src/repro_torch/csrc/flash_decode_paged.cu",
     "src/repro/kernels/flash_decode.py:208", None),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:108", "512x1024 H=8 D=256"),
]


def parse_args():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"),
                    help="directory for chip_smoke.json and build_log.txt")
    return ap.parse_args()


def main() -> int:
    out_dir = parse_args().out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"== 1. environment: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    times = build.build_all(ptxas_verbose=True)
    with open(os.path.join(out_dir, "build_log.txt"), "w") as fh:
        fh.write("\n".join(build.BUILD_LOG))
    log(f"  built {sorted(times)} in {time.perf_counter() - t:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in times.items()} })")

    rows = []
    log("== 2. kernels against their plain versions on the card")
    gemm_phase(dev, rows)
    decode_phase(dev, rows)
    attention_phase(dev, rows)
    log("== 3. reduced gemma_2b (fp32): card against CPU")
    reduced_phase(dev)
    log("== 4. full-width gemma_2b serving (bf16)")
    counts, serving = serving_phase(dev)
    log(f"  serving summary: {json.dumps(serving)}")

    kernels = []
    for name, source, replaces, shape in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        rep = next((r for r in mine if shape is None or shape == r["shape"]),
                   mine[0])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "shape": rep["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "rows": rows, "serving": serving,
                   "kernels": kernels,
                   "seconds": time.perf_counter() - t_start}, fh, indent=1)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
