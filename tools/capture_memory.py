#!/usr/bin/env python3
"""Device memory that a CUDA stream keeps after one library product ran
on it: ``torch.cuda.memory_allocated`` after the same f32 ``torch.matmul``
(the LM head's shape at 4 rows) on ``--streams`` fresh side streams, then
as many times on one stream.  PyTorch keeps a cuBLAS workspace per
stream for the life of the process, so a capture on a fresh stream each
time holds one more (the reason ``serving.engine._capture`` reuses one
capture stream per device).  Needs a CUDA device.

    python3 tools/capture_memory.py [--streams 8]
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("capture_memory: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    x = torch.randn(4, 2048, device="cuda")
    w = torch.randn(2048, 32000, device="cuda")
    torch.matmul(x, w)
    torch.cuda.synchronize()

    def on(stream):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            torch.matmul(x, w)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()

    base = torch.cuda.memory_allocated()
    for _ in range(args.streams):
        on(torch.cuda.Stream())
    fresh = torch.cuda.memory_allocated() - base
    base = torch.cuda.memory_allocated()
    one = torch.cuda.Stream()
    for _ in range(args.streams):
        on(one)
    reused = torch.cuda.memory_allocated() - base
    print(f"{smi}: {args.streams} fresh streams hold {fresh / 2**20:.1f} "
          f"MiB more ({fresh / args.streams / 2**20:.1f} MiB each); one "
          f"stream used {args.streams} times holds {reused / 2**20:.1f} MiB "
          f"more")
    return 0


if __name__ == "__main__":
    sys.exit(main())
