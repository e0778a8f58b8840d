"""Time the plain attention of a local layer's prefill chunk over its ring
(``models.attention.ring_chunk_attention``), with and without the kv-chunk
scan, on the card.

Past 2048 kv positions ``_xla_attention`` scans chunks of
``cfg.attn_chunk`` with an online softmax, as the JAX package does; a
512-token chunk over a full 4096-slot ring attends to 4608 positions.
This runs gemma2_27b's and starcoder2_7b's shapes (bf16, their heads,
window and softcap) both ways in one process, in turns (unchunked,
chunked, chunked, unchunked), and prints each median of CUDA-event times,
the largest difference between the two outputs, and the card's name and
power limit.

    PYTHONPATH=src python tools/ab_chunked_attention.py [--iters 20]
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

# (name, query heads, kv heads, head dim, window, softcap)
SHAPES = [("gemma2_27b", 32, 16, 128, 4096, 50.0),
          ("starcoder2_7b", 36, 4, 128, 4096, None)]
CHUNK, RING = 512, 4096


def time_ms(fn, iters: int) -> float:
    """Median of ``iters`` calls, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_chunked_attention: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models import attention as attn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pos0 = RING
    for name, h, hkv, d, window, softcap in SHAPES:
        q = torch.randn(1, h, CHUNK, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(1, hkv, RING + CHUNK, d, generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        q_pos = torch.arange(pos0, pos0 + CHUNK, device=dev)[None]
        kv_pos = torch.cat([torch.arange(RING, device=dev), q_pos[0]])[None]

        def run():
            return attn._xla_attention(
                q, k, v, causal=True, window=window, softcap=softcap,
                scale=d ** -0.5, kv_positions=kv_pos, q_positions=q_pos)

        threshold = attn._CHUNK_THRESHOLD
        times = {"unchunked": [], "chunked": []}
        outs = {}
        for way in ("unchunked", "chunked", "chunked", "unchunked"):
            attn._CHUNK_THRESHOLD = (1 << 30) if way == "unchunked" \
                else threshold
            with torch.no_grad():
                outs[way] = run()
                times[way].append(time_ms(run, args.iters))
        attn._CHUNK_THRESHOLD = threshold
        diff = float((outs["chunked"].float()
                      - outs["unchunked"].float()).abs().max())
        print(f"{name}: 1 x {CHUNK} queries, {h}/{hkv} heads x {d}, "
              f"{RING + CHUNK} kv positions, window {window}, softcap "
              f"{softcap}: unchunked {times['unchunked']} ms, chunked "
              f"{times['chunked']} ms (chunk {attn._KV_CHUNK}); max |diff| "
              f"{diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
