#!/usr/bin/env python3
"""How far the model-level path's prefill and decode logits lie from the
forward's at the same positions in bf16, by depth, at musicgen_medium's
width, through the port's plain versions on the CPU.

Builds musicgen_medium with ``n_layers`` cut to each given depth, bf16
weights (``param_dtype``), biases and LayerNorm parameters drawn as
``chip_smoke.random_biases`` draws them, and one sequence of 96 + 6 frame
embeddings; runs ``forward`` over all of them, ``prefill`` over the first
96 and 6 ``decode`` steps, and prints per depth the largest
|diff| / (1 + |ref|) and the RMS ratio ||diff|| / ||ref|| of the prefill
and decode logits against the forward's.  Both sides round to bf16 after
each GEMM, the same contracts in other orders, so the spread measures
how the roundings grow with depth: the scale ``chip_smoke.py``'s
``MODEL_LEVEL_TOL`` and ``MODEL_LEVEL_RMS`` were set from.

    python3 tools/model_level_noise.py --depths 2 6 12 24

Runs on the CPU (the plain versions); depth 24 holds ~1.4 GB of weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 6, 12])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import random_biases
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    s, steps = args.frames, args.steps
    for depth in args.depths:
        cfg = dataclasses.replace(get_config("musicgen_medium"),
                                  n_layers=depth, param_dtype="bfloat16")
        params = random_biases(
            model_lib.init_params(cfg, seed=0, device="cpu"), cfg)
        emb = torch.randn(1, s + steps, cfg.d_model,
                          generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            full, _ = model_lib.forward(params, {"embeddings": emb}, cfg)
            got, cache = model_lib.prefill(
                params, {"embeddings": emb[:, :s]}, cfg,
                cache_len=s + steps + 4)
            got = [got]
            for i in range(steps):
                logits, cache = model_lib.decode(
                    params, {"embeddings": emb[:, s + i:s + i + 1],
                             "pos": s + i}, cache, cfg)
                got.append(logits)
        got = torch.stack(got, dim=1)
        want = full[:, s - 1:]
        diff = got - want
        rel = float((diff.abs() / (1 + want.abs())).max())
        rms = float(diff.norm() / want.norm())
        print(f"depth {depth}: max |diff|/(1+|ref|) {rel:.4f}, RMS ratio "
              f"{rms:.4f}, max |diff| {float(diff.abs().max()):.4f}, ref "
              f"std {float(want.std()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
