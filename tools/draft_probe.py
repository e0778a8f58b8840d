#!/usr/bin/env python3
"""How often a draft of its own weights is accepted at full width, by the
scale of its projection weights.

Serves ``chip_smoke.py``'s phase-4 workload (4 slots, 6 requests x 24
greedy tokens, seed-0 target weights) once without speculation and then
with ``spec_k=4`` and a one-period draft (``draft_config`` +
``draft_params``: seed 1, every projection weight times each scale), and
prints per run the acceptance rate, how many windows accepted 0..3
drafts, whether every greedy stream equals the vanilla one, and the
launches of the tile loops and SIMT kernels (0 expected).  With random
weights every model here repeats its last prompt token, and a draft at
scale 1 does too; a large enough scale makes the draft's layers, not its
embedding, decide its proposals.  ``chip_smoke.py``'s
``REJECTING_DRAFT_SCALE`` and its draft builder (``rejecting_draft``) are
the ones probed here.

    python3 tools/draft_probe.py --scales 1 2 4 [--configs default]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0, 2.0])
    ap.add_argument("--configs", nargs="+",
                    default=["default", "recurrentgemma"])
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    if not torch.cuda.is_available():
        print("draft_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    build.build_all()

    def serve(eng, prompts):
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=cs.MAX_TOKENS))
        return {r: list(v) for r, v in eng.run().items()}

    for name in args.configs:
        arch, overrides = cs.CONFIGS[name]
        cfg = dataclasses.replace(get_config(arch), **overrides)
        prompts, kw = cs.serving_workload(cfg, cs.WORKLOADS[arch], dev)
        cs.reset_planning()
        params = model_lib.init_params(cfg, seed=0, device=dev)
        vanilla = serve(ServingEngine(params, cfg, **kw), prompts)
        repeats = all(set(s) == {int(prompts[r][-1])}
                      for r, s in vanilla.items())
        print(f"[{name}] vanilla streams repeat the last prompt token: "
              f"{repeats}", flush=True)
        dcfg = cfg.draft(1)
        for scale in args.scales:
            accepted = []

            class Probe(ServingEngine):
                def _accept(self, *a):
                    emit, j = super()._accept(*a)
                    accepted.append(j)
                    return emit, j

            draft = cs.rejecting_draft(dcfg, dev, scale)
            cs.reset_planning()
            eng = Probe(params, cfg, spec_k=cs.SPEC_K, draft_config=dcfg,
                        draft_params=draft, **kw)
            build.reset_launch_counts()
            out = serve(eng, prompts)
            counts = build.launch_counts()
            m = eng.metrics()
            off = {k: counts[k] for k in cs.NOT_ON_PATH[name] if counts[k]}
            print(f"[{name}] scale {scale}: acceptance "
                  f"{m['acceptance_rate']}, windows by accepted drafts "
                  f"{np.bincount(accepted, minlength=cs.SPEC_K).tolist()}, "
                  f"streams equal to vanilla {out == vanilla}, off-path "
                  f"launches {off}", flush=True)
            del eng, draft
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
