#!/usr/bin/env python3
"""Does a row's result depend on how many rows ride with it?  On the card,
for the two operations a speculative verify window runs over slots·k rows
outside the port's kernels: the LM head's f32 ``torch.matmul`` (at
gemma_2b's and recurrentgemma_9b's widths, vocab 256000) and ``rmsnorm``.
For 4 slots and k = 2, 3, 4 it prints whether each window position's 4
rows, computed with the window, equal the same 4 rows computed alone
(bf16-rounded operands from a fixed seed).

    python3 tools/row_bits.py          # from the repo root, on the card

A False for the LM head is why ``models.model.verify_chunk`` unembeds one
window position at a time.
"""
from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch.models.layers import rmsnorm

    if not torch.cuda.is_available():
        print("row_bits: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    slots = 4
    for d in (2048, 4096):
        head = (torch.randn(256000, d, generator=gen, device=dev) * 0.02
                ).to(torch.bfloat16).float()
        scale = {"scale": torch.ones(d, device=dev)}
        for k in (2, 3, 4):
            x = torch.randn(slots, k, d, generator=gen, device=dev
                            ).to(torch.bfloat16)
            whole = torch.matmul(x.float().reshape(slots * k, d), head.t()
                                 ).reshape(slots, k, -1)
            head_eq = [torch.equal(whole[:, i], torch.matmul(
                x[:, i].float(), head.t())) for i in range(k)]
            normed = rmsnorm(x, scale)
            norm_eq = [torch.equal(normed[:, i:i + 1],
                                   rmsnorm(x[:, i:i + 1].contiguous(), scale))
                       for i in range(k)]
            print(f"d_model {d}, k {k}: LM head rows equal {head_eq}; "
                  f"rmsnorm rows equal {norm_eq}")
        del head
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
