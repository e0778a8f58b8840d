#!/usr/bin/env python3
"""Compare ``chip_smoke.py`` runs of two checkouts made in turns on one
card (A, B, B, A, each with its own ``--out`` directory): for every
phase-4 configuration, each run's decode-step device time (eager and
replayed), the replay's wall time, run (b)'s steady ms per step and
decode tokens/s; whether the plan strings of every compiled program
equal across the runs; and each run's phase-5 speculative summaries,
where it has them.

    python3 tools/ab_smoke.py A1/chip_smoke.json B1/chip_smoke.json \\
        B2/chip_smoke.json A2/chip_smoke.json

Exits non-zero when a configuration's plan strings differ between runs.
"""
from __future__ import annotations

import json
import sys


def main(paths) -> int:
    runs = [json.load(open(p)) for p in paths]
    print(f"card: {runs[0]['nvidia_smi']}")
    same = True
    for name in runs[0]["serving"]:
        rows = []
        for run in runs:
            s = run["serving"][name]
            prof = s["profile"]
            rows.append((prof["decode_step"]["device_busy_ms"],
                         prof["decode_replay"]["device_busy_ms"],
                         prof["decode_replay"]["wall_ms"],
                         s["async"]["steady_ms_per_step_mean"],
                         s["async"]["decode_tokens_per_s"]))
        plans = [[p["plans"] for p in run["serving"][name]["programs"]]
                 for run in runs]
        equal = all(p == plans[0] for p in plans)
        same &= equal
        print(f"[{name}] plan strings equal across runs: {equal}")
        for label, i in (("decode eager device ms", 0),
                         ("decode replayed device ms", 1),
                         ("decode replayed wall ms", 2),
                         ("(b) steady ms/step", 3),
                         ("(b) decode tokens/s", 4)):
            print(f"  {label}: " + ", ".join(f"{r[i]:.3f}" for r in rows))
    for path, run in zip(paths, runs):
        for key, s in run.get("speculative", {}).items():
            prof = s["profile"]
            if "speedup_vs_vanilla" in s:
                print(f"{path} [{key}] speedup_vs_vanilla "
                      f"{s['speedup_vs_vanilla']:.4f}, tokens/s "
                      f"{s['tokens_per_s']}, accepted_per_step "
                      f"{s['accepted_per_step']:.3f}")
                continue
            # Runs before the speculative graphs profiled the eager draft
            # step only.
            window = prof.get("verify_replay", prof["verify_window"])
            draft = prof.get("draft_replay", prof.get("draft_decode_step"))
            print(f"{path} [{key}] acceptance {s['acceptance_rate']:.4f}, "
                  f"spec_k_mean {s['spec_k_mean']:.3f}, "
                  f"{s['decode_tokens_per_s']:.1f} decode tokens/s, peak "
                  f"{s['peak_memory_gib']:.2f} GiB; verify window "
                  f"{window['wall_ms']:.3f} ms wall / "
                  f"{window['device_busy_ms']:.3f} ms device;"
                  f" draft decode step "
                  f"{draft['wall_ms']:.3f} / "
                  f"{draft['device_busy_ms']:.3f} ms")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
