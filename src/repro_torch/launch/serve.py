"""Serving launcher (the port of ``repro/launch/serve.py``): random
weights from a seeded ``torch.Generator`` and the continuous-batching
engine — paged KV pool, FIFO scheduler, grouped decode q/k/v — over a
synthetic request stream, with the telemetry stack on the flags that ask
for it.  The flags and their defaults are the JAX launcher's, plus
``--device`` (the card unless ``--device cpu``).

Examples::

    # CPU-scale, a reduced config:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \\
        --reduced --requests 8 --max-tokens 16 --device cpu

    # gemma_2b at full width on the card, the whole observability stack:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \\
        --requests 6 --max-tokens 24 --prefill-len 512 --cache-len 576 \\
        --watch 4 --status-json health.json --prom prom.txt \\
        --trace run.trace.json --gemm-table

    # Resilience: poison request 0's logits mid-decode; the engine
    # quarantines that slot while every healthy request finishes:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \\
        --reduced --device cpu --requests 6 \\
        --fault-plan poison_logits:rid=0,step=4 \\
        --deadline-ms 60000 --shed-queue-depth 32 --watchdog-s 60
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.resilience import FaultInjector, Shed
from repro_torch.telemetry import gemm_account, tracing
from repro_torch.telemetry.registry import registry as metrics_registry

__all__ = ["parse_args", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu' (the "
                         "kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-pool page size (tokens per page)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool pages (default: slots can grow to cache-len;"
                         " smaller values overcommit and exercise eviction)")
    ap.add_argument("--kv-format", default=None,
                    help="paged-KV FormatPolicy (int8pt/int8/bf16/fp32; "
                         "default: compute dtype)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="admission cap on committed in-flight tokens")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="content-hash KV page sharing across requests "
                         "(--no-prefix-cache recomputes every prefix; "
                         "aliasing needs --prefill-chunk < --prefill-len)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt-chunk tokens for incremental prefill "
                         "(must divide --prefill-len; default: the whole "
                         "window, i.e. one chunk)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every synthetic request this many shared "
                         "leading tokens (a system prompt) — the "
                         "prefix-cache demo workload")
    ap.add_argument("--plan-cache", default=None,
                    help="GEMM plan-cache JSON to warm-start from / save to")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; a request still running "
                         "when it expires is cancelled with partial "
                         "output and status 'deadline'")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="admission control: reject submits once this "
                         "many requests are waiting (status 'shed')")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="arm a StepWatchdog around every engine step; a "
                         "straggling step raises StragglerError")
    ap.add_argument("--fault-plan", default=None,
                    help="inject a deterministic fault plan, e.g. "
                         "'poison_logits:rid=0,step=4;straggle:step=2,"
                         "delay_s=0.5' (kinds: alloc_fail, "
                         "chunk_exception, poison_logits, straggle, "
                         "crash)")
    ap.add_argument("--debug-audit", action="store_true",
                    help="run the KV-pool invariant checker after every "
                         "engine step (slow; chaos debugging)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding window: a weight-shared "
                         "draft proposes k-1 tokens per step, the target "
                         "verifies the window in ONE call (0/1: vanilla "
                         "decode)")
    ap.add_argument("--no-spec", action="store_true",
                    help="force vanilla decode (overrides --spec-k)")
    ap.add_argument("--draft-config", default=None,
                    help="config name of the draft: a truncation of the "
                         "target, whose layers it shares (default: the "
                         "target's first --draft-groups layer periods)")
    ap.add_argument("--draft-groups", type=int, default=1,
                    help="layer periods kept in the weight-shared draft "
                         "(ignored with --draft-config)")
    ap.add_argument("--draft-format", default=None,
                    help="FormatPolicy for the draft's GEMMs (default: "
                         "the target's)")
    ap.add_argument("--prefix-index", default=None,
                    help="JSON path for the pool's published page hashes "
                         "— saved after run(), reloaded at start so a "
                         "restarted engine aliases surviving KV")
    ap.add_argument("--no-async", action="store_true",
                    help="synchronous engine stepping (pipeline depth 1)")
    ap.add_argument("--no-graph", action="store_true",
                    help="eager per-GEMM dispatch instead of compiled "
                         "repro_torch.graph programs (use_graph=False)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run (engine phase spans + request lifecycle; "
                         "open in ui.perfetto.dev)")
    ap.add_argument("--gemm-table", action="store_true",
                    help="print the per-GEMM dispatch table (shape class "
                         "x format, plan provenance, modeled time) after "
                         "the run")
    ap.add_argument("--status-json", default=None, metavar="PATH",
                    help="write the structured health() snapshot (registry"
                         " + KV pool + scheduler + plan-cache/program "
                         "stats + SLO verdicts + calibration summary) as "
                         "schema-validated JSON after the run")
    ap.add_argument("--prom", default=None, metavar="PATH",
                    help="write the whole metrics registry in Prometheus "
                         "text exposition format after the run")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="print a status line every N engine steps "
                         "(0 = off): step, slots, queue, pool, tokens, "
                         "SLO verdict")
    ap.add_argument("--slo", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="evaluate the default serving SLOs (ttft p99, "
                         "error rate, KV headroom) every engine step "
                         "(default: on when --status-json/--prom/--watch)")
    ap.add_argument("--profile", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="after the run, time the hot dispatch signatures "
                         "(CUDA events on the card) and print the "
                         "modeled-vs-measured calibration table + "
                         "plan-regret audit (default: on when "
                         "--status-json)")
    args = ap.parse_args(argv)
    if args.slo is None:
        args.slo = bool(args.status_json or args.prom or args.watch)
    if args.profile is None:
        args.profile = bool(args.status_json)
    return args


def main(argv=None):
    """Serve one synthetic stream as the flags say; → ``rid -> Response``.
    ``argv`` None reads the command line."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.no_graph:
        cfg = dataclasses.replace(cfg, use_graph=False)
    draft_cfg = None
    if args.draft_config:
        draft_cfg = get_config(args.draft_config)
        if args.reduced:
            draft_cfg = draft_cfg.reduced()

    # Telemetry goes up BEFORE the engine: the accountant must see the
    # dispatches of the first calls and of each CUDA-graph capture (a
    # replay records none).
    tracer = None
    if args.trace:
        tracer = tracing.install(tracing.Tracer())
    acct = gemm_account.install(gemm_account.GemmAccountant())
    slo_monitor = None
    if args.slo:
        from repro_torch.telemetry.slo import SloMonitor
        slo_monitor = SloMonitor()

    params = model_lib.init_params(cfg, seed=0, device=dev)
    engine = ServingEngine(params, cfg, slots=args.slots,
                           cache_len=args.cache_len,
                           prefill_len=args.prefill_len,
                           page_size=args.page_size,
                           num_pages=args.num_pages,
                           kv_format=args.kv_format,
                           token_budget=args.token_budget,
                           prefix_cache=args.prefix_cache,
                           prefill_chunk=args.prefill_chunk,
                           plan_cache_path=args.plan_cache,
                           deadline_ms=args.deadline_ms,
                           shed_queue_depth=args.shed_queue_depth,
                           watchdog_s=args.watchdog_s,
                           debug_audit=args.debug_audit,
                           spec_k=0 if args.no_spec else args.spec_k,
                           draft_config=draft_cfg,
                           draft_groups=args.draft_groups,
                           draft_format_policy=args.draft_format,
                           prefix_index_path=args.prefix_index,
                           slo_monitor=slo_monitor,
                           async_steps=not args.no_async,
                           fault=(FaultInjector.from_spec(args.fault_plan)
                                  if args.fault_plan else None),
                           device=dev)
    del params      # the engine holds its own serving copy

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=args.shared_prefix,
                          dtype=np.int32)
    for rid in range(args.requests):
        tail_len = (max(1, args.prefill_len - args.shared_prefix)
                    if args.shared_prefix
                    else int(rng.integers(4, args.prefill_len)))
        prompt = np.concatenate(
            [shared, rng.integers(0, cfg.vocab, size=tail_len,
                                  dtype=np.int32)])
        try:
            engine.submit(Request(rid=rid, prompt=prompt,
                                  max_tokens=args.max_tokens,
                                  temperature=args.temperature))
        except Shed as e:
            print(f"  req {rid} shed at submit: {e}")

    t0 = time.time()
    if args.watch:
        # run() is resumable: drain the engine --watch steps at a time,
        # printing a status line between slices.
        while True:
            outputs = engine.run(max_steps=args.watch)
            active = sum(1 for r in engine.slot_req if r is not None)
            pool = engine.sched.pool
            slo_tag = ""
            if slo_monitor is not None and slo_monitor.last_report:
                rep = slo_monitor.last_report
                slo_tag = (" slo=OK" if rep.ok else " slo=VIOLATING["
                           + ",".join(s.name for s in rep.statuses
                                      if not s.ok) + "]")
            print(f"  [watch] step {engine.step_idx}: active {active}"
                  f"/{engine.slots}, queue {len(engine.sched.waiting)}, "
                  f"pool {pool.free_pages}/{pool.num_pages} free, "
                  f"decode tokens {engine.sched.decode_tokens}{slo_tag}")
            if not active and not engine.sched.waiting:
                break
    else:
        outputs = engine.run()
    dt = time.time() - t0
    total = sum(len(v) for v in outputs.values())
    m = engine.metrics()
    print(f"served {len(outputs)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s) on {dev}")
    print(f"  occupancy {m['batch_occupancy']:.2f}, "
          f"prefill/decode tokens {m['prefill_tokens']}/{m['decode_tokens']}, "
          f"preemptions {m['preemptions']}, kv_format {m['kv_format']}, "
          f"pool {m['num_pages']}x{m['page_size']} "
          f"({m['free_pages']} free at exit)")
    print(f"  prefix cache {'on' if m['prefix_cache'] else 'off'} "
          f"(chunk {m['prefill_chunk']}): hit rate "
          f"{m['prefix_hit_rate']:.2f} "
          f"({m['cached_prefill_tokens']} tokens aliased, "
          f"{m['prefix_hit_pages']} pages / {m['prefix_queries']} queries), "
          f"{m['shared_pages']} shared, {m['cached_pages']} cached, "
          f"{m['cow_copies']} cow copies")
    if m.get("spec_on"):
        print(f"  speculative decode k={m['spec_k']} "
              f"(mean window {m.get('spec_k_mean', 0):.2f}): "
              f"{m['spec_steps']} spec steps, "
              f"accepted/step {m.get('accepted_per_step', 0.0):.2f}, "
              f"acceptance rate {m.get('acceptance_rate', 0.0):.2f}, "
              f"{m['spec_emitted']} tokens emitted speculatively")
    statuses = {}
    for r in outputs.values():
        statuses[r.status] = statuses.get(r.status, 0) + 1
    print(f"  statuses {statuses}, cancelled {m['cancelled_requests']}, "
          f"shed {m['shed_requests']}")
    for rid in sorted(outputs):
        r = outputs[rid]
        tag = "" if r.ok else f" [{r.status}]"
        print(f"  req {rid}{tag}: {list(r)[:12]}...")
    reg = metrics_registry()
    ttft = reg.get("serving.ttft_s")
    itl = reg.get("serving.inter_token_s")
    wait = reg.get("serving.queue_wait_s")
    if ttft is not None and ttft.count:
        print(f"  latency: ttft p50 {ttft.percentile(50) * 1e3:.1f}ms / "
              f"p99 {ttft.percentile(99) * 1e3:.1f}ms"
              + (f", inter-token p50 {itl.percentile(50) * 1e3:.2f}ms / "
                 f"p99 {itl.percentile(99) * 1e3:.2f}ms"
                 if itl is not None and itl.count else "")
              + (f", queue wait p50 {wait.percentile(50) * 1e3:.2f}ms"
                 if wait is not None and wait.count else ""))
    if args.gemm_table:
        print(acct.format_table())
    prof = None
    if args.profile:
        # After the run: time the hot dispatch signatures, join them
        # against the planner's price, audit the grants against their
        # analytic runners-up.
        from repro_torch.telemetry.profiler import DispatchProfiler
        prof = DispatchProfiler(acct, device=dev)
        prof.sample()
        print(prof.format_calibration_table())
        for e in prof.regret_audit():
            verdict = "REGRET" if e["flagged"] else "ok"
            print(f"  regret audit {e['signature']}: granted "
                  f"{e['granted_route']} {e['granted_s'] * 1e6:.1f}us vs "
                  f"runner-up {e['runner_route']} "
                  f"{e['runner_s'] * 1e6:.1f}us -> {verdict}")
    if slo_monitor is not None and slo_monitor.last_report is not None:
        print(slo_monitor.last_report.format_report())
    if args.prom:
        from repro_torch.telemetry.export import write_prometheus
        write_prometheus(args.prom)
        print(f"wrote prometheus exposition -> {args.prom}")
    if args.status_json:
        from repro_torch.telemetry.export import write_health
        write_health(args.status_json, engine=engine, profiler=prof,
                     slo_report=(slo_monitor.last_report
                                 if slo_monitor else None))
        print(f"wrote health snapshot -> {args.status_json}")
    if tracer is not None:
        tracing.uninstall()
        tracer.export(args.trace)
        print(f"wrote trace -> {args.trace} "
              f"({len(tracer.events)} events)")
    gemm_account.uninstall()
    if args.plan_cache:
        engine.save_plan_cache()
        print(f"saved plan cache -> {args.plan_cache}")
    return outputs


if __name__ == "__main__":
    main()
