#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):

1. Environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the build of every kernel under
   ``src/repro_torch/csrc`` with nvcc (into ``build/``; the compiler log
   goes to ``build_log.txt`` in the output directory).
2. Kernels against their plain PyTorch versions on the card: B1
   ``mte_gemm`` on its three engines (the TMA + wgmma mainloop, counter
   ``mte_gemm_wgmma``, the SIMT f32 mainloop, ``mte_gemm_simt``, and the
   tile loop, counter ``mte_gemm``), B2 on its three engines (the cluster
   split-K kernel, ``splitk_gemm_cluster``, the SIMT f32 mainloop,
   ``splitk_gemm_simt``, and the tile loop, ``splitk_gemm``), B3 on
   its four engines (the cluster split-K kernel, ``grouped_gemm_splitk``,
   the wgmma mainloop, ``grouped_gemm_wgmma``, the SIMT f32 mainloop,
   ``grouped_gemm_simt``, and the tile loop, ``grouped_gemm``), both
   halves of B8 (stage 1 on its three engines, ``rigid_gemm_wgmma``,
   ``rigid_gemm_simt`` and ``rigid_gemm``, and ``epilogue_pass``), B4 on
   both of its engines (the mma kernel,
   ``flash_decode_paged_mma``, and SIMT, ``flash_decode_paged``), B5 on
   both of its engines (TMA + wgmma, ``flash_attention_wgmma``, and SIMT,
   ``flash_attention``), B6 on both of its engines (the mma kernel over
   the ring, ``flash_decode_mma``, and SIMT, ``flash_decode``), B7 on
   both of its engines (the staged scan, ``rglru_scan_staged``, and the
   direct one, ``rglru_scan``; bit for bit, from zero and from h0) --
   at the exact shapes the serving phase launches (bf16; f32 for B7;
   gemma_2b's and recurrentgemma_9b's prefill and decode projections for
   B1, B2 and B8 stage 1 and decode q/k/v groups for B3, each printed with
   its plan's engine and tile; gemma2_27b's prefill gate on B1, decode o,
   gate, up and down on B2, decode q/k/v group on B3, and its attention
   with softcap 50 and the query scale 144^-0.5 on B4, B5 and B6 at
   G = 2, D = 128; qwen15_4b's prefill gate on B1 and decode o, gate and
   down on B2 and q/k/v group on B3 under its bf16acc format (bf16
   accumulator, every epilogue step rounded) beside the f32 accumulator
   at the same shapes, and its MHA attention (G = 1, D = 128) on B4 and
   B5; starcoder2_7b's prefill up (bias + gelu in one epilogue) and down
   (bias) on B1, decode o, up (bias + gelu) and down (bias) on B2 (the
   library row ``torch.addmm`` where a bias joins), decode q/k/v group
   (widths 4608/512/512) on B3, and its ring decode at G = 9 (36 query
   heads on 4 kv heads, D = 128, ragged ring tails at S = 37 too) on B6;
   musicgen_medium's model-level prefill (M = 4096) q (bias), up (bias +
   gelu) and down (bias) on B1 and its decode step's (M = 4) on B2, its
   causal prefill attention (4 x 24 heads on 24 kv heads, G = 1, D = 64,
   1024 frames) on B5, and its decode over a flat 2048-slot cache on B6
   at G = 1, D = 64 with the slots past each row's position masked, at
   positions 1024 and 1087 and at a ragged tail (each row also printing
   the K/V bytes of the visible slots, of the 16-slot tiles the kernel
   loads and of all the slots); chameleon_34b's model-level prefill gate
   (M = 4096, 22016 x 8192, silu) on B1, warm and cold, its decode
   step's down (M = 4, 8192 x 22016) on B2 at the plan's split, its
   causal prefill attention (4 x 1024, 64 heads on 8 kv heads, D = 128)
   on B5 and its decode over a flat 1088-slot cache at position 1087 (G
   = 8, D = 128) on B6; the training step's GEMMs at gemma_2b's
   full width over 4096 tokens (``train_gemm_phase``): the forward's bf16
   gate on B1's wgmma mainloop, and every backward f32 GEMM shape of a
   layer on the SIMT f32 engine (``mte_gemm_simt``, and
   ``splitk_gemm_simt`` for the k/v dB's split) -- the accumulator's
   recompute, dA (B read transposed in place) and dB (A^T copied first,
   the copy timed apart) -- bit-equal to the tile loop at the same
   operands, warm and cold against an f32 ``torch.matmul`` and the tile
   loop's time; the SIMT engine at both its tiles, bit-equal to the tile
   loop, in the small ragged fp32 shapes; B3 past 16 rows: the prefill
   gate+up group and qwen15_4b's prefill q/k/v group (bf16acc) on the
   wgmma engine (the gate+up also on the tile loop, pinned),
   granite_moe_1b's experts in bf16 (a per-group x) and GroupedGemm's f32
   dw on the SIMT engine; int8 past 16 rows on the s8 entries of the
   wgmma mainloop (``int8_phase``: ``mte_gemm_wgmma_s8`` and
   ``grouped_gemm_wgmma_s8`` bit-equal to the tile loop and the plain
   version at ragged shapes, B as (K, N) and (N, K), x broadcast and per
   member, widths, and ±127 operands at K = 4096; timed at gemma_2b's
   and granite_moe_1b's prefill shapes and granite's experts beside
   ``torch._int_mm``, the K-major copy of B and the tile loop, and the
   tile loops of B1, B3 and B8 at gemma_2b's gate in int8); int8 at most
   16 rows on the s8 entries of the cluster split-K mainloop
   (``int8_decode_phase``: ``splitk_gemm_cluster_s8`` and
   ``grouped_gemm_splitk_s8`` bit-equal to the tile loops, the plain
   versions and ``int_matmul`` at M 1, 5 and 16, ragged K and N, every
   slice count, x broadcast and per member, widths, and ±127 operands at
   K = 16384; timed at gemma_2b's int8 decode GEMMs and q/k/v group and
   granite_moe_1b's decode o and experts' gate and down (C = 8), warm,
   L2-cold and by split, beside ``torch._int_mm`` on the rows padded to
   32 and the tile loops, which get rows of their own); B8's int8 stage 1
   on the s8 entry of the wgmma mainloop at its one 128 x 128 tile at
   every M (``rigid_int8_phase``: ``rigid_gemm_wgmma_s8`` bit-equal to
   the rigid tile loop pinned and ``int_matmul`` at M 1, 4, 16, 130 and
   520 by N 72, 2056 and 16384 by K 144, 1040, 2048 and 16384, ±127
   operands at K = 16384, the shapes off its rule on ``rigid_gemm``;
   timed at gemma_2b's prefill and decode projections, warm and L2-cold,
   beside ``torch._int_mm`` (decode: the rows padded to 32), the K-major
   copy of B, the wrapper with that copy and the rigid tile loop); B8
   stage 1 on the SIMT engine at the reduced
   model's gate (bit-equal to the tile loop, also timed pinned) and the
   amx training backward's GEMMs (``rigid_train_rows``);
   the old engines' own rows at the fp32
   shapes phase 3 gives them, or pinned at the main-path shape) and at
   small ragged shapes in every mode each kernel takes.  Each prints its
   max error beside the tolerance; the main-path shapes also print the
   kernel time (CUDA events, median of 10), its bound (max(operations /
   peak, bytes / 3.35 TB/s)), the plain version's time and the time of one
   library call for the same function (``torch.matmul``, ``torch.bmm`` on
   the stacked operands, ``F.gelu`` or ``F.scaled_dot_product_attention``;
   none for B7, and none for a softcapped attention row, whose SDPA time
   without the softcap is kept apart), timed only as a yardstick; the
   decode rows of B2, B3, B4
   and B6 also with the L2 cache cold and at every cluster size, B7's
   staged engine cold too, and B8's
   pass at three shapes (the prefill gate's gelu, the same with beta*C +
   bias + softcap, the decode gate's gelu).
3. The whole path held against the CPU: gemma_2b.reduced() in fp32 with
   one seed, served by the port's engine on the card (kernels) and on the
   CPU (plain versions), in the default configuration (graph programs +
   the grouped decode q/k/v) and under ``gemm_policy="amx"`` (B8 stage 1
   on the SIMT f32 engine), one 4096-token chunk through it on the eager path
   (B1's SIMT f32 engine: fp32 GEMMs past 16 rows; no tile-loop launch),
   gemma_2b.reduced() under ``format_policy="int8"`` with 64-row
   prefill chunks (B1's and B3's s8 entries; the 2-row decode steps on B2's
   and B3's cluster s8 entries; ``reduced_int8_phase``),
   and
   recurrentgemma_9b.reduced() in the default configuration (prompts
   longer than its 16-slot ring, chunks of 8; and with an RG-LRU width of
   126, which B7 runs on its direct engine), and gemma2_27b.reduced()
   (local and global layers, softcaps, post-norms; prompts longer than
   its 16-slot window), and qwen15_4b.reduced() under its bf16acc format
   with a bf16 compute dtype (QKV biases, an untied head; first-token
   logits within 5e-2; its decode GEMMs on B2's and B3's cluster
   engines), and starcoder2_7b.reduced() (LayerNorm with a bias, the plain
   GELU MLP with biases, every layer local, biases and norm parameters
   drawn away from zero and one; prompts longer than its 16-slot window),
   and the MoE layer (``reduced_moe_phase``): granite_moe_1b.reduced()
   under int8 and qwen3_moe_235b.reduced() in bf16 with QK-norm, both at
   the published capacity factor 1.25 with 128-token chunks (the experts'
   GEMMs on B3's wgmma entries at C = 80, and on its split-K entries in
   the decode steps at C = 8), the CPU run's dropped assignments printed
   (granite's above 0), page-table rows per request and prefix
   registrations equal too:
   first-token logits within
   1e-3 (2e-2 under int8 and bf16), identical greedy token streams from
   the card's engine in its
   defaults (async, depth 2, the decode step replayed as a CUDA graph)
   and the CPU's synchronous eager engine, and the same with
   ``spec_k=4`` (speculative decoding; equal to the vanilla streams too),
   plus reduced gemma_2b at 5 slots x ``spec_k=4``: verify windows of 20
   rows, run in row chunks on the decode step's plans.  Then the
   model-level path (``forward``, ``prefill``, ``decode`` over flat
   caches, over frame embeddings): musicgen_medium.reduced() in fp32 (2
   sequences of 24 frames, 3 decode steps) within 1e-4 and musicgen_medium
   at full width and depth 2 in bf16 (2 x 256 frames, 4 decode steps)
   within 2e-2 (x (1 + |ref|)), and chameleon_34b.reduced() in fp32
   (QK-norm, SwiGLU, an untied head) within 1e-4, card against CPU.
   Then the SSD mixer: mamba2_130m.reduced() in fp32, a 32-token prompt
   in four 8-token chunks into one slot (first-token logits within
   1e-3), the engine with 3 requests on 2 slots in 8-token chunks (a
   30-token prompt spans 4; the third request prefills while two
   decode), greedy streams equal on the card (async + graph) and the CPU
   (sync, eager), with and without ``spec_k=4``, and no kernel counter
   moved: the SSD block is plain PyTorch, as the JAX package computes it
   in plain jnp.
4. Full-width serving (``CONFIGS``, ``WORKLOADS``) in bf16 with seeded
   random weights, 4 slots, 16-token pages, 512-token prefill chunks, 6
   requests × 24 greedy tokens: gemma_2b (18 layers, d_model 2048, vocab
   256000; 1024-token prompts, two sharing their first 512 tokens) in
   three configurations — the defaults, the rigid ``amx`` policy and
   slice 1's eager path — and under the engine's ``format_policy="int8"``
   (``int8``: f32 weights quantized at every call, every prefill
   projection on B1's s8 entry and no int8 tile-loop launch in a prefill
   chunk, ``CHUNK_LAUNCHES``; the decode step's 4-row GEMMs on B2's and
   B3's cluster s8 entries, 72 and 18 launches a step, no tile loop) and
   under it with the rigid baseline (``amx-int8``: every projection of a
   prefill chunk and of a decode step, 126 each, on B8's s8 entry at the
   128 x 128 tile; no other GEMM kernel, no epilogue pass; the ratio of
   its step and chunk device times to ``int8``'s is printed), and
   granite_moe_1b (``granite``: 24 layers, d_model 1024, GQA 16/8 x 64,
   32 experts top-8 of d_ff 512 at capacity factor 1.25, under its
   published int8 with f32 weights from seed 0; gemma_2b's workload; a
   chunk runs 96 ``mte_gemm_wgmma_s8``, 72 ``grouped_gemm_wgmma_s8`` at
   C = 160 and 24 B5 launches, a step 96 ``grouped_gemm_splitk_s8`` (the
   q/k/v group and the experts at C = 8), 24 ``splitk_gemm_cluster_s8``
   and 24 B4; no tile loop; the step's bound counts the router and every
   expert, and the experts the profiled step routed to are printed
   beside it), then
   recurrentgemma_9b (38 layers, d_model 4096;
   2560-token prompts, so its 2048-slot rings wrap in prefill and decode)
   and gemma2_27b (46 layers alternating local and global, d_model 4608,
   GQA 32/16, softcaps 50 and 30, post-norms; weights built in bf16;
   4608-token prompts, so its 4096-slot rings wrap in prefill and decode)
   and qwen15_4b (40 layers, d_model 2560, MHA 20 x 128, QKV biases drawn
   non-zero, an untied LM head, bf16acc; 2048-token prompts, two sharing
   their first chunk) and starcoder2_7b (32 local layers, d_model 4608,
   GQA 36/4, LayerNorm, the plain GELU MLP; biases and norm parameters
   drawn by ``random_biases``; 4608-token prompts, so its 4096-slot rings
   wrap in prefill and decode) in the defaults, and mamba2_130m
   (``mamba2``: 24 SSD layers, d_model 768, no FFN, tied embeddings; f32
   weights from seed 0; 4096-token prompts, so each slot's SSD state and
   conv ring resume over 8 chunks; no prefix cache; every kernel counter
   0, the decode step replayed as a CUDA graph of plain PyTorch, the
   SSD state's bytes and the scan's operations in ``step_bounds``), each
   engine freed before the next is built.  Each configuration is served
   twice: (a) with ``async_steps=False`` and the eager decode step,
   synchronised around
   each prefill chunk and decode launch (the earlier slices' numbers),
   and (b) in the engine's defaults (async, depth 2, the decode step
   replayed as one CUDA graph) with nothing synchronised inside; the
   greedy tokens of (a) and (b) must be equal request for request, (b)
   must reach ``steps_in_flight_max`` 2, and one steady step of (b) runs
   under ``torch.cuda.set_sync_debug_mode("error")`` (no sync but the
   retire's event wait).  For each run, launch counters are zeroed just
   before it and read just after (every kernel of that path must have
   launched, every bf16 B1 and B8 stage-1 launch on the wgmma engine,
   every decode GEMM on B2's cluster engine, every decode q/k/v group on
   B3's split-K engine, every paged decode attention on B4's mma engine,
   every ring decode attention on B6's mma engine, every prefill
   attention on B5's wgmma engine and every prefill scan on B7's staged
   engine: the tile loops', the SIMT kernels' and B7's direct engine's
   counters must stay 0, the profiled decode step must count the launches
   ``DECODE_STEP_LAUNCHES`` names, eager and replayed (captured delta x
   replays), the profiled resumed prefill chunk one staged B7 launch per
   RG-LRU layer and no cumulative sum, and no prefill projection may be
   planned off B1 or B8), and it prints (a)'s decode ms per step and
   prefill tokens/s, (b)'s run wall time, decode tokens/s over the run
   and unsynchronised wall ms of the steps that ran no prefill chunk,
   peak memory beside the reckoning of what the engine holds (weights,
   stacked decode q/k/v, f32 LM head, paged KV, rings, RG-LRU rows), each
   compiled program's grouping decision and plans, and
   a profile of a decode step (eager and replayed) and a prefill chunk
   (idle share, launches per call).

5. Full-width speculative serving (``SPEC_RUNS``): phase 4's workload in
   the engine's defaults with ``spec_k=4``, the speculative step's shapes
   (verify, catch-up and replay windows, the draft decode step) replayed
   as CUDA graphs (``SpecStep``) — gemma_2b (default configuration) with
   a one-layer draft and with an 18-layer one (the whole target),
   recurrentgemma_9b with a one-period draft (rglru, rglru, local), all
   sharing the target's weights, gemma2_27b with a one-period draft
   (a local and a global layer), qwen15_4b with a one-layer one (its
   head shared too) and starcoder2_7b with a one-layer one; then
   gemma_2b and recurrentgemma_9b each
   with a one-period draft of weights of its own (``draft_config`` +
   ``draft_params``), which is rejected part of the time.  Each run's
   greedy tokens must equal phase 4's (b) run request for request, the
   full-depth draft's acceptance rate must be exactly 1.0 (every verify
   row equals the draft's decode row bit for bit), the own drafts' must
   lie strictly between 0 and 1 (with replay windows for recurrentgemma's
   ring and RG-LRU rows), the tile loops' and SIMT kernels' counters stay
   0, every step's verify window is a replay and each shape is captured
   once, and every target window, replays included, launches B4 once per
   position and global layer and B6 once per position and local layer,
   and B2 and B3 once per GEMM and row chunk (``window_launches``: as
   often as a decode step where a window's rows fit one launch, as at
   gemma_2b and recurrentgemma_9b; gemma2_27b's 16-row windows run its
   gate and up in chunks of 14 rows and its down in chunks of 7).
   It prints each speculative step (host wall ms, the CUDA-event spans
   of its draft and target windows, its launches), the captures and
   replays per shape family, the acceptance rate, the mean window, decode
   tokens/s over the run and its ratio to phase 4's (b), and the peak
   memory, and profiles the verify window (eager and replayed; the
   replayed gemma window's idle share must be at most 0.15) and the
   replayed draft decode step.  Last, ``exact-draft``: the reference's
   exact-draft workload (``benchmarks/run.py:345-430``) at gemma_2b's
   full width — layers 1-17 with zero ``o`` and ``down`` weights, so the
   one-layer draft is bit-exact; 2 slots, ``spec_k=6``, 8 requests x 32
   greedy tokens after a warm-up request — served without and with
   speculation in alternating turns, three each, held to the reference's
   gate: equal greedy streams, ``speedup_vs_vanilla`` (medians) >= 1.00,
   ``accepted_per_step`` > 1 and ``acceptance_rate`` >= 0.95.

6. The model-level path at full width (``MODEL_LEVEL``): musicgen_medium
   (48 layers, d_model 1536, 24 heads of 64, MHA, LayerNorm, the plain
   GELU MLP with biases, QKV biases, an untied head; biases and norm
   parameters drawn by ``random_biases``; flat caches of 2048 slots) and
   chameleon_34b (48 layers, d_model 8192, GQA 64/8 x 128, d_ff 22016,
   SwiGLU, RMSNorm, QK-norm, an untied head; 34.29 B parameters, 68.6 GB;
   flat caches of 1088 slots), bf16 weights, each over 4 sequences of
   seeded frame embeddings: ``forward`` over 1088 frames, ``prefill``
   over the first 1024, then 64 ``decode`` steps.  What the card will
   hold is printed first (``model_level_reckoning``: weights, caches,
   forward's logits, the head widened to f32) and must stay under
   ``FITS_GIB``.  Prefill's and every decode step's logits must agree
   with forward's at the same position (``MODEL_LEVEL_TOL``,
   ``MODEL_LEVEL_RMS``); each decode step must launch B2 on its cluster
   engine once per projection and layer (musicgen 288, chameleon 336)
   and B6 on its mma engine once per layer (48), forward and prefill B1
   (as many) and B5 (48) on their wgmma engines only.  It prints the
   device ms and idle share of a decode step, the prefill and the forward
   against their bounds (``model_level_bounds``) and the peak memory
   beside what is held.

7. Training (``TRAIN``).  (a) Card against CPU: reduced gemma_2b in
   fp32, under ``gemm_policy="amx"`` (every GEMM on B8, stage 1 on the
   SIMT f32 engine) and in the default, 3 steps of ``loss_and_grads`` +
   AdamW on both (losses, every
   gradient leaf and the parameters after the steps), ``microbatches=2``
   against 1, and ``train_loop`` through a checkpoint and a restart
   against the same steps straight; gemma_2b at full width and depth 2 in
   bf16 over 2 x 64 tokens (loss, every gradient leaf, the AdamW update).
   (b) gemma_2b at its published widths with f32 parameters from seed 0,
   ``SyntheticDataset`` batches of 1 x 4096 tokens, remat "full", the bf16
   format, lr 3e-4: one warm step, 3 timed steps and one profiled step.
   Every loss and grad norm must be finite and the parameters must move;
   per step, the forward runs B1's wgmma mainloop (twice under remat)
   and B5's wgmma engine, and every backward GEMM a launch of the SIMT f32
   engine of B1 (or B2 where a plan splits K): ``backward_gemms`` of
   them, none on the tile loops or a library call.  It prints each step's wall ms, the profiled step's
   device ms and idle share beside its bound (``train_bounds``: bf16
   operations at 989 TFLOP/s, f32 at 67, bytes at 3.35 TB/s), the
   launches per step per counter, each compiled program's grouping
   decision, and the peak memory beside the reckoning.  (c) The same
   workload under the rigid ``amx`` baseline: per step ``backward_gemms``
   launches of B8 stage 1 on the SIMT f32 engine (``rigid_gemm_simt``),
   none of B1, B2 or a tile loop, the forward on ``rigid_gemm_wgmma`` and
   ``epilogue_pass``, the first loss within 2e-2 x (1 + |ref|) of (b)'s;
   it prints the same figures and the profiled step's device time by
   kernel (the unsplit k/v dB, the B^T copies, the accumulators' round
   trips and the epilogue passes stand apart).

8. The paper's convolutions (``CONV_SUITE``, §V-B2): the 75 unique
   layers of ResNet-50, VGG-16, SqueezeNet 1.1, Inception-v3 and
   Darknet-19 at minibatch 16 (the script's own list, the shapes of
   ``benchmarks/workloads.py``), each through
   ``core.conv.conv2d_direct(backend="kernels")`` with a bias and relu,
   inputs from a seeded ``torch.Generator`` on the card: in fp32 and bf16
   all 75, in int8 ResNet-50's 18.  Each call is one B3 launch, counters
   zeroed just before and read just after: every aligned layer on B3's
   SIMT (fp32), wgmma (bf16) or s8 (int8) engine, only the six
   unaligned layers (``CONV_UNALIGNED``: IC = 3, and yl.head's OC = 425)
   on the tile loop; each held against ``backend="reference"`` on the
   card (``CONV_TOL``: max error over the output's RMS, int8 exactly
   equal) and, as an oracle only, ``F.conv2d`` on the format's rounded
   inputs in f32 (``CONV_ORACLE_TOL``).  Per layer it prints the engine,
   the plan's tile and CSR word (``TileState``), the B3 launch's ms
   (median of 10, and L2-cold), the whole ``conv2d_direct``'s, the bound
   (the format's peak; bytes: stacked windows, weights and the f32
   partials), the kernel's plain version, ``torch.bmm`` at the grouped
   shape, ``F.conv2d`` and the peak memory.
9. The paper's 18 transformer GEMMs (``TRANSFORMER_GEMMS``, §V-B3)
   through ``core.dispatch.mte_gemm(backend="kernels")`` under
   ``policy="mte"`` (B1, B2) and ``"amx"`` (B8), in fp32 and bf16, each
   one launch held against ``backend="reference"`` (``DISPATCH_TOL``):
   route, engine, tile and CSR word, the launch's ms under both policies
   and their ratio, beside the paper's CPU model (``perfmodel.model_all``:
   the Table VII design points, not the H100) and its retired
   instructions (``isa.count_all``).

Each phase's seconds are printed on a line of their own ("-- N s:").
Then it prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the rest of the checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import gc
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


_T0 = time.perf_counter()
# (header, start) of each phase logged so far.
_PHASES = []


def log(*args):
    """Print at once; a phase's header ("== ...") also gets the seconds
    since the script started, and the phase before it a line of its own
    with its seconds, so each phase's share of the limit shows."""
    if args and str(args[0]).startswith("== "):
        now = time.perf_counter()
        if _PHASES:
            print(f"-- {now - _PHASES[-1][1]:.1f} s: {_PHASES[-1][0]}",
                  flush=True)
        _PHASES.append((str(args[0])[3:60], now))
        args = (*args, f"[{now - _T0:.1f} s]")
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2,
            sleep_cycles: int = 200_000_000) -> float:
    """Median device milliseconds of one call, from CUDA events between
    back-to-back calls.  A sleep kernel (``sleep_cycles``, by default
    ~0.1 s at the H100's clocks) holds the device while the host enqueues
    every call, so the host's own time per call (Python, the wrapper's
    allocations) is not counted as the kernel's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(sleep_cycles)
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def time_ms_cold(fn, iters: int = 10) -> float:
    """Median device milliseconds of one call that finds the L2 cache cold,
    as a decode step finds each layer's weights: 128 MB (over twice the
    H100's 50 MB of L2) are written before each call, then a sleep kernel
    holds the device while the host enqueues the call between its own
    two CUDA events."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.int8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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


# gemma2_27b's attention: softcap 50 on the logits, query scale
# (d_model / n_heads)^-0.5 = 144^-0.5 (not head_dim^-0.5).
GEMMA2_ATTN = dict(softcap=50.0, scale=(4608 / 32) ** -0.5)


def library_times(lib, kw, cold=True):
    """The library yardstick of an attention row: ``library_ms`` (and the
    L2-cold time) of ``F.scaled_dot_product_attention``, which computes
    the same function unless the row has a softcap, which it cannot
    apply: then ``library_ms`` is None and its time without the softcap
    is kept apart (``sdpa_without_softcap_ms``)."""
    times = {"library_ms": time_ms(lib)}
    if cold:
        times["library_cold_ms"] = time_ms_cold(lib)
    if kw.get("softcap") is not None:
        times = {**{k: None for k in times},
                 **{k.replace("library", "sdpa_without_softcap"): v
                    for k, v in times.items()}}
    return times


def log_attention_row(row):
    def ms(key):
        return (f"{row[key]:.4f} ms" if row.get(key) is not None
                else "none")
    lib = ("sdpa" if "sdpa_without_softcap_ms" not in row
           else "sdpa (no softcap)")
    key = "library" if lib == "sdpa" else "sdpa_without_softcap"
    log(f"    time {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, {lib} "
        f"{ms(key + '_ms')}"
        + (f"; L2 cold {row['cold_ms']:.4f} ms, {lib} "
           f"{ms(key + '_cold_ms')}" if "cold_ms" in row else "")
        + (f"; by kv split {row.get('ms_by_split') or row['ms_by_kv_split']}"
           f" (planned {row['kv_split']})" if "kv_split" in row else ""))


# -- phase 2: kernels against their plain versions -----------------------------

def gemm_phase(dev, rows):
    """B1 and B2 on both of their engines against their plain versions:
    small ragged shapes in every mode (the TMA-aligned ones, M, N and K
    multiples of 8, run bf16 and bf16acc on B1's wgmma engine at several
    tiles, the others the tile loops; bf16 at M <= 16 on B2's cluster
    engine with every epilogue term), then the bf16 GEMMs of the
    full-width serving runs through the plans those runs get: gemma_2b's
    prefill (M = 512) and decode (M = 4) projections and
    recurrentgemma_9b's, each printed with its engine and tile; the decode
    rows also with the weight cold in L2 and at every split.  The tile
    loops' own rows are the reduced fp32 model's gate, at the shapes phase
    3 gives them (a 4096-token chunk for B1, a 2-slot decode for B2)."""
    import torch
    from repro_torch.core.autotune import PlanCache, GemmSignature, \
        plan_engine
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.geometry import (SIMT_TILES, BlockGeometry, SEW,
                                           gemm_engine, splitk_engine)
    from repro_torch.kernels.mte_gemm import (bf16acc_block,
                                              mte_gemm_kernel,
                                              mte_gemm_torch)
    from repro_torch.kernels.splitk_gemm import (cluster_layout,
                                                 mte_gemm_splitk_kernel,
                                                 mte_gemm_splitk_torch,
                                                 splitk_cluster_torch)

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
    def engine_of(dt, tile, m, n, k, acc):
        try:
            return gemm_engine(dt, *tile, n, k, m=m, bf16acc=acc is not None)
        except ValueError:
            return None

    for label, dt, acc, out_dt, tol in modes:
        for m, n, k in [(100, 70, 130), (7, 300, 1000), (33, 257, 65),
                        (520, 2056, 1032), (64, 64, 64)]:
            a, b = operands(m, n, k, dt)
            bm, bn = (16, 128) if m <= 16 else (64, 64)
            geom = BlockGeometry(bm, bn, 64, 1, 1, False, SEW.E32, SEW.E32,
                                 "mte")
            tiles = [(bm, bn)]
            if engine_of(dt, (bm, bn), m, n, k, acc) == "wgmma":
                tiles += [(128, 128), (64, 128)] if acc is not None \
                    else [(128, 128), (128, 256)]
            # f32 past 16 rows with K and N multiples of 4: the SIMT
            # engine at both its tiles, bit-equal to the tile loop.
            tiles += [t for t in SIMT_TILES
                      if engine_of(dt, t, m, n, k, acc) == "simt"]
            epi = Epilogue() if dt == torch.int8 else epi_full
            c = torch.randn(m, n, device=dev)
            bias = torch.randn(n, device=dev)
            c_, bias_ = (None, None) if dt == torch.int8 else (c, bias)
            want = mte_gemm_torch(a, b, c_, bias_, geom=geom, epilogue=epi,
                                  out_dtype=out_dt, acc_dtype=acc)
            bt = b.t().contiguous()
            loop_out = {}
            for tile in tiles:
                g = dataclasses.replace(geom, bm=tile[0], bn=tile[1])
                eng = engine_of(dt, tile, m, n, k, acc)
                for tb, bb in ((False, b), (True, bt)):
                    got = mte_gemm_kernel(
                        a, bb, c_, bias_,
                        geom=dataclasses.replace(g, transposed_b=tb),
                        epilogue=epi, out_dtype=out_dt, acc_dtype=acc)
                    check(f"mte_gemm[{eng} {tile[0]}x{tile[1]}] {label} "
                          f"{'transposed-B ' if tb else ''}{m}x{n}x{k}",
                          got, want, tol)
                    if eng == "tile":
                        loop_out[tb] = got
                    elif eng == "simt":
                        require(torch.equal(got, loop_out[tb]),
                                f"mte_gemm[simt] {m}x{n}x{k}: not "
                                f"bit-equal to the tile loop")
                        log("    bit-equal to the tile loop")
            if (m, n, k) in ((520, 2056, 1032), (64, 64, 64)):
                continue         # split-K: the first three shapes
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

    # B2's cluster engine at small shapes: M 1-16, a ragged K, N a multiple
    # of 8 but not of 128, every epilogue term (C in f32 and bf16, a row
    # and a column bias), both output types; two calls bit-equal.
    sew16 = SEW.E16
    for m, n, k, c_dt, axis, out_dt in [
            (1, 2048, 2048, torch.float32, "row", torch.bfloat16),
            (7, 392, 1000, torch.bfloat16, "row", torch.float32),
            (16, 136, 40, torch.bfloat16, "col", torch.bfloat16)]:
        a, b = operands(m, n, k, torch.bfloat16)
        c = torch.randn(m, n, generator=gen, device=dev).to(c_dt)
        bias = torch.randn(n if axis == "row" else m, generator=gen,
                           device=dev)
        epi = Epilogue(alpha=0.7, beta=0.5, has_bias=True, bias_axis=axis,
                       softcap=20.0, activation="gelu")
        geom = BlockGeometry(16, 128, 64, 4, 1, False, sew16, sew16, "mte")
        slices, depth = cluster_layout(m, n, k, dev)
        # f32 and bf16 (bf16acc: 64-row blocks of each slice) accumulators.
        for acc, tol in ((None, 2e-2), (torch.bfloat16, 3e-2)):
            require(splitk_engine(a.dtype, m, n, k, bf16acc=acc is not None)
                    == "cluster", f"{m}x{n}x{k} is not on the cluster "
                    f"engine")
            kw = dict(epilogue=epi, out_dtype=out_dt, acc_dtype=acc)
            got = mte_gemm_splitk_kernel(a, b, c, bias, geom=geom, **kw)
            check(f"splitk_gemm_cluster {m}x{n}x{k} ({slices} slices, C "
                  f"{str(c_dt)[6:]}, {axis} bias"
                  f"{', bf16acc' if acc else ''})", got,
                  splitk_cluster_torch(a, b, c, bias, n_split=slices,
                                       depth=depth,
                                       rbk=bf16acc_block(geom.bk, k), **kw),
                  tol)
            require(torch.equal(got, mte_gemm_splitk_kernel(
                a, b, c, bias, geom=geom, **kw)),
                "splitk_gemm_cluster: two calls differ")

    def main_path(label, m, n, k, act, dt=torch.bfloat16, tol=2e-2,
                  fmt="bf16", cold=False, bias=False):
        epi = Epilogue(has_bias=bias, activation=act)
        sig = GemmSignature.make(m, n, k, dt, dt, epi, fmt=fmt)
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        a, b = operands(m, n, k, dt)
        # A bias joins the epilogue before the activation, in f32, as the
        # model's dense layers pass it.
        args = (a, b, None, 0.5 * torch.randn(n, generator=gen, device=dev)
                if bias else None)
        geom, extra = plan.geometry, {}
        acc = torch.bfloat16 if fmt == "bf16acc" else None
        kw = dict(epilogue=epi, out_dtype=dt, acc_dtype=acc)
        if engine == "cluster":
            kern = "splitk_gemm_cluster"
            slices, depth = cluster_layout(m, n, k, dev)
            extra["slices"] = slices
            run = lambda: mte_gemm_splitk_kernel(  # noqa: E731
                *args, geom=geom, n_split=plan.n_split, **kw)
            # The plain version in the engine's slices and, under bf16acc,
            # its K blocks.
            rbk = bf16acc_block(geom.bk, k)
            plain = lambda: splitk_cluster_torch(  # noqa: E731
                *args, n_split=slices, depth=depth, rbk=rbk, **kw)
        elif plan.route == "splitk":
            kern = "splitk_gemm_simt" if engine == "simt" else "splitk_gemm"
            run = lambda: mte_gemm_splitk_kernel(  # noqa: E731
                *args, geom=geom, n_split=plan.n_split, **kw)
            plain = lambda: mte_gemm_splitk_torch(  # noqa: E731
                *args, geom=geom, n_split=plan.n_split, **kw)
        else:
            kern = {"wgmma": "mte_gemm_wgmma",
                    "simt": "mte_gemm_simt"}.get(engine, "mte_gemm")
            run = lambda: mte_gemm_kernel(  # noqa: E731
                *args, geom=geom, **kw)
            plain = lambda: mte_gemm_torch(  # noqa: E731
                *args, geom=geom, **kw)
        shape = (f"{label} {m}x{n}x{k}{' bf16acc' if acc else ''}"
                 f"{' +bias' if bias else ''}")
        want = plain()
        got = run()
        err = check(f"{kern} main-path {shape} [{plan.describe()}, engine "
                    f"{engine}]", got, want, tol)
        if engine == "cluster":
            require(torch.equal(got, run()), f"{kern}: two calls differ")
        flops = 2.0 * m * n * k
        nbytes = (a.element_size() * (m * k + k * n + m * n)
                  + (4 * n if bias else 0))
        peak = PEAK["bf16" if dt == torch.bfloat16 else "fp32"]
        if bias:       # the library's product with the bias in one call
            lib_bias = args[3].to(dt)
            lib = lambda: torch.addmm(lib_bias, a, b)  # noqa: E731
        else:
            lib = lambda: torch.matmul(a, b)  # noqa: E731
        row = {"kernel": kern, "shape": shape, "engine": engine,
               "plan": plan.describe(), "max_abs_err": err,
               "tol": tol, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library_ms": time_ms(lib),
               "library": "torch.addmm" if bias else "torch.matmul", **extra}
        if (m <= 16 and kern != "mte_gemm") or cold:
            # A decode GEMM (or a row asked cold): with the weight cold in
            # L2, as a decode step finds it, and (cluster engine) at every
            # power-of-two split, each held to the plain version at its
            # own split.
            row["cold_ms"] = time_ms_cold(run)
            row["library_cold_ms"] = time_ms_cold(lib)
        if engine == "cluster":
            row["ms_by_split"] = {}
            for s in (1, 2, 4, 8):
                try:
                    cluster_layout(m, n, k, dev, s)
                except ValueError:
                    continue     # x's slice would not fit, or empty slices
                pinned = lambda: mte_gemm_splitk_kernel(  # noqa: E731
                    *args, geom=geom, cluster_split=s, **kw)
                want_s = splitk_cluster_torch(
                    *args, n_split=s, depth=cluster_layout(m, n, k, dev,
                                                           s)[1],
                    rbk=rbk, **kw)
                err = max(err, check(f"{kern} main-path {shape} {s} "
                                     f"slices", pinned(), want_s, tol))
                row["ms_by_split"][s] = time_ms(pinned)
            row["max_abs_err"] = err
        rows.append(row)
        log(f"    time {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"{row['library']} {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.2f}x)"
            + (f"; L2 cold {row['cold_ms']:.4f} ms, {row['library']} "
               f"{row['library_cold_ms']:.4f} ms" if "cold_ms" in row
               else "")
            + (f"; by split {row['ms_by_split']} (planned {slices})"
               if engine == "cluster" else ""))

    # The bf16 GEMMs of the full-width serving runs, through the plans the
    # serving runs get (prefill chunk M = 512, decode M = 4 slots):
    # gemma_2b (d 2048, d_ff 16384, one 256-wide kv head) and
    # recurrentgemma_9b's prefill (d and RG-LRU width 4096, d_ff 12288).
    gemma = [("q/o", 2048, 2048, "none"), ("k/v", 256, 2048, "none"),
             ("gate", 16384, 2048, "gelu"), ("up", 16384, 2048, "none"),
             ("down", 2048, 16384, "none")]
    rg = [("rg q/o/rglru", 4096, 4096, "none"),
          ("rg k/v", 256, 4096, "none"),
          ("rg gate", 12288, 4096, "gelu"),
          ("rg down", 4096, 12288, "none")]
    for m in (512, 4):
        for label, n, k, act in gemma:
            main_path(label, m, n, k, act)
    for label, n, k, act in rg:
        main_path(label, 512, n, k, act)
    # recurrentgemma_9b's decode GEMMs on B2 (its k/v run in B3's group).
    for label, n, k, act in rg[:1] + rg[2:]:
        main_path(label, 4, n, k, act)
    # gemma2_27b (d 4608, 32 heads x 128 = 4096, d_ff 36864): the prefill
    # chunk's gate on B1 and the decode step's o, gate, up and down on B2
    # (its q/k/v run in B3's group).
    main_path("g2 gate", 512, 36864, 4608, "gelu", cold=True)
    for label, n, k, act in [("g2 o", 4608, 4096, "none"),
                             ("g2 gate", 36864, 4608, "gelu"),
                             ("g2 up", 36864, 4608, "none"),
                             ("g2 down", 4608, 36864, "none")]:
        main_path(label, 4, n, k, act)
    # qwen15_4b (d 2560, 20 heads x 128 = 2560, d_ff 6912, SwiGLU) under
    # its bf16acc format: the prefill chunk's gate on B1's wgmma mainloop
    # (bf16 accumulator, 128-wide tiles at most), and the decode step's o,
    # gate and down on B2's cluster engine with the bf16 accumulator
    # (up is gate's shape without the activation), each beside the f32
    # accumulator's run at the same shape.
    for fmt, tol in (("bf16acc", 3e-2), ("bf16", 2e-2)):
        main_path("q gate", 512, 6912, 2560, "silu", fmt=fmt, cold=True,
                  tol=tol)
        for label, n, k, act in [("q o", 2560, 2560, "none"),
                                 ("q gate", 6912, 2560, "silu"),
                                 ("q down", 2560, 6912, "none")]:
            main_path(label, 4, n, k, act, fmt=fmt, tol=tol)
    # starcoder2_7b (d 4608, 36 heads x 128 = 4608, d_ff 18432, the plain
    # GELU MLP with biases): the prefill chunk's up (bias + gelu in one
    # epilogue) and down (bias) on B1's wgmma mainloop, and the decode
    # step's o (no bias, as in the reference), up and down on B2's
    # cluster engine, warm and cold.
    main_path("s2 up", 512, 18432, 4608, "gelu", cold=True, bias=True)
    main_path("s2 down", 512, 4608, 18432, "none", bias=True)
    for label, n, k, act, bias in [("s2 o", 4608, 4608, "none", False),
                                   ("s2 up", 18432, 4608, "gelu", True),
                                   ("s2 down", 4608, 18432, "none", True)]:
        main_path(label, 4, n, k, act, bias=bias)
    # musicgen_medium (d 1536, 24 heads x 64 = 1536, d_ff 6144, the plain
    # GELU MLP with biases, QKV biases): the model-level prefill's (M =
    # 4 x 1024 frames) q (bias), up (bias + gelu) and down (bias) on B1's
    # wgmma mainloop at K = 1536 and 6144, and the decode step's (M = 4)
    # on B2's cluster engine, warm and cold.
    for m in (4096, 4):
        for label, n, k, act in [("mg q", 1536, 1536, "none"),
                                 ("mg up", 6144, 1536, "gelu"),
                                 ("mg down", 1536, 6144, "none")]:
            main_path(label, m, n, k, act, bias=True)
    # chameleon_34b (d 8192, 64 heads x 128 = 8192, GQA 64/8, d_ff 22016,
    # SwiGLU): the model-level prefill's (M = 4 x 1024) gate with its silu
    # on B1's wgmma mainloop, warm and cold, and the decode step's (M = 4)
    # down on B2's cluster engine at the plan's split, warm and cold.
    main_path("ch gate", 4096, 22016, 8192, "silu", cold=True)
    main_path("ch down", 4, 8192, 22016, "none")
    # The training forward's gate over 4096 tokens (phase 7, bf16 format).
    main_path("train gate", 4096, 16384, 2048, "gelu")
    # The rows of the f32 engines at the shapes phase 3 gives them: the
    # reduced fp32 gemma_2b's (d_model 128, d_ff 256) gate in its
    # 4096-token chunk (B1's SIMT engine) and in its 2-slot decode (B2's
    # tile loop), and B1's tile loop at reduced qwen15_4b's o projection
    # (d_model 128) over a 16-token chunk under bf16acc.
    main_path("gate fp32", 4096, 256, 128, "gelu", dt=torch.float32,
              tol=1e-4, fmt="fp32")
    main_path("qr o", 16, 128, 128, "none", fmt="bf16acc", tol=3e-2)
    main_path("gate fp32", 2, 256, 128, "gelu", dt=torch.float32,
              tol=1e-4, fmt="fp32")


def train_gemm_phase(dev, rows):
    """The training backward's f32 GEMMs at gemma_2b's full width (d 2048,
    8 heads x 256, one 256-wide kv head, d_ff 16384) over 4096 tokens,
    each through the plan and route the backward gives it
    (``autodiff.raw_gemm``): the gate's accumulator recompute (4096 x
    16384 x 2048), and for every projection shape of a layer ``dA = dacc
    @ B^T`` (B read in place through B1's transposed-B geometry) and ``dB
    = A^T @ dacc`` (A^T copied row-major first; the gate's copy timed
    apart): q/o, k/v (its dB 2048 x 256 x 4096 splits K onto B2), gate/up
    and down.  Every one must plan onto the SIMT f32 engine.  Each against
    its plain version (elementwise within 1e-4 x (1 + |ref|) and in
    relative Frobenius error within 1e-5: the f32 summation order is all
    that may differ) and against the tile loop at the same operands and
    split, pinned at 64 x 64 (bit for bit: each output is the same FMA
    chain), warm and with the L2 cold, beside its bound (f32 operations
    at 67 TFLOP/s), the tile loop's time and one f32 ``torch.matmul`` of
    the same product as the yardstick; and the training forward's bf16
    gate (4096 x 16384 x 2048 + gelu) on the wgmma mainloop."""
    import torch
    from repro_torch.core.autotune import get_plan, plan_engine
    from repro_torch.kernels.autodiff import _transposed, raw_gemm
    from repro_torch.kernels.mte_gemm import mte_gemm_kernel, mte_gemm_torch
    from repro_torch.kernels.splitk_gemm import (mte_gemm_splitk_kernel,
                                                 mte_gemm_splitk_torch)

    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = 4096

    def row(label, x, y, transposed, lib, copy_ms=None):
        m, k = x.shape
        n = y.shape[0] if transposed else y.shape[1]
        plan = get_plan(m, n, k, torch.float32, torch.float32)
        geom = plan.geometry
        loop = dataclasses.replace(geom, bm=64, bn=64)
        if plan.route == "mte":
            geom = dataclasses.replace(geom, transposed_b=transposed)
            loop = dataclasses.replace(loop, transposed_b=transposed)
            plain = lambda: mte_gemm_torch(x, y, geom=geom)  # noqa: E731
            tile_loop = lambda: mte_gemm_kernel(  # noqa: E731
                x, y, geom=loop)
        else:
            yp = y.t().contiguous() if transposed else y
            plain = lambda: mte_gemm_splitk_torch(  # noqa: E731
                x, yp, geom=geom, n_split=plan.n_split)
            tile_loop = lambda: mte_gemm_splitk_kernel(  # noqa: E731
                x, yp, geom=loop, n_split=plan.n_split)
        engine = plan_engine(plan.signature, geom)
        run = lambda: raw_gemm(x, y, transposed_b=transposed)  # noqa: E731
        shape = f"train {label} fp32 {m}x{n}x{k}"
        kern = {"mte": "mte_gemm", "splitk": "splitk_gemm"}[plan.route]
        kern += "_simt" if engine == "simt" else ""
        got, want = run(), plain()
        err = check(f"{kern} main-path {shape} [{plan.describe()}, engine "
                    f"{engine}]", got, want, 1e-4)
        require(engine == "simt", f"{shape} plans onto {engine}, not the "
                f"SIMT f32 engine")
        rel = _frobenius(got, want)
        log(f"    relative Frobenius error {rel:.3e} (tol 1e-5)")
        require(rel <= 1e-5, f"{kern} {shape}: relative error {rel}")
        require(torch.equal(got, tile_loop()),
                f"{kern} {shape}: not bit-equal to the tile loop")
        log(f"    bit-equal to the tile loop (64x64"
            f"{f', {plan.n_split} slices' if plan.n_split > 1 else ''})")
        del got, want
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        r = {"kernel": kern, "shape": shape, "engine": engine,
             "plan": plan.describe(), "max_abs_err": err, "tol": 1e-4,
             "rel_err": rel, "rel_tol": 1e-5,
             "ms": time_ms(run, iters=5), "cold_ms": time_ms_cold(run, 5),
             "plain_ms": time_ms(plain, iters=5),
             "bound_ms": bound_ms(flops, nbytes, PEAK["fp32"]),
             "bound_by": bound_by(flops, nbytes, PEAK["fp32"]),
             "library_ms": time_ms(lib, iters=5),
             "library_cold_ms": time_ms_cold(lib, 5),
             "library": "torch.matmul (f32)",
             "tile_loop_ms": time_ms(tile_loop, iters=3, warmup=1),
             "bit_equal_to_tile_loop": True}
        r["tflops"] = flops / r["ms"] / 1e9
        if copy_ms is not None:
            r["transpose_copy_ms"] = copy_ms
        rows.append(r)
        log(f"    time {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), "
            f"L2 cold {r['cold_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"torch.matmul f32 {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x), cold "
            f"{r['library_cold_ms']:.4f} ms; the tile loop "
            f"{r['tile_loop_ms']:.4f} ms"
            + (f"; the A^T copy {copy_ms:.4f} ms" if copy_ms is not None
               else "; B^T read in place (no copy)" if transposed
               and plan.route == "mte" else ""))

    for name, d_in, d_out in (("gate", 2048, 16384), ("q/o", 2048, 2048),
                              ("k/v", 2048, 256), ("down", 16384, 2048)):
        a = (torch.randn(tokens, d_in, generator=gen, device=dev)
             / math.sqrt(d_in))
        w = (torch.randn(d_in, d_out, generator=gen, device=dev)
             / math.sqrt(d_in))
        dacc = (torch.randn(tokens, d_out, generator=gen, device=dev)
                / math.sqrt(d_out))
        at = _transposed(a, torch.float32)
        copy_ms = (time_ms(lambda: _transposed(a, torch.float32))
                   if name == "gate" else None)
        if name == "gate":
            row(f"{name} recompute", a, w, False,
                lambda: torch.matmul(a, w))
        row(f"{name} dA", dacc, w, True, lambda: torch.matmul(dacc, w.t()))
        row(f"{name} dB", at, dacc, False, lambda: torch.matmul(a.t(), dacc),
            copy_ms)
        del a, w, dacc, at


GROUPED_KERNEL = {"splitk": "grouped_gemm_splitk", "wgmma":
                  "grouped_gemm_wgmma", "simt": "grouped_gemm_simt",
                  "tile": "grouped_gemm"}


def grouped_phase(dev, rows):
    """B3 on its four engines against its plain version: ragged shapes in
    every mode on the tile loop (shared x with member widths, and a
    per-group x), for bf16 into f32 with C <= 16 on the cluster split-K
    engine (widths that straddle a tile, one of 0, a K the slice depth
    does not divide; two calls bit-equal), for bf16 past 16 rows on the
    wgmma engine at three tiles (C not a multiple of 64, an N tail, a K
    not a multiple of 64, widths that straddle a tile and one of 0,
    broadcast and per-group x, bf16acc; widths' columns exactly 0) and
    for f32 past 16 rows on the SIMT engine at both its tiles (bit-equal
    to the tile loop pinned at 64 x 64), then the main-path shapes: the
    decode q/k/v groups of gemma_2b and recurrentgemma_9b (split-K), the
    prefill gate+up group and qwen15_4b's prefill q/k/v group under
    bf16acc (wgmma; the gate+up group also on the tile loop, pinned, in
    the same run), granite_moe_1b's expert GEMMs in bf16 with a per-group
    x (wgmma), and GroupedGemm's f32 dw (SIMT)."""
    import torch
    from repro_torch.core.autotune import (GemmSignature, PlanCache,
                                           plan_engine)
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.geometry import (BlockGeometry, SEW,
                                           grouped_engine)
    from repro_torch.graph import stack_group_weights
    from repro_torch.kernels.grouped_gemm import (MAX_WIDTHS,
                                                  grouped_gemm_kernel,
                                                  grouped_gemm_torch,
                                                  grouped_splitk_torch,
                                                  split_layout)
    from repro_torch.kernels.mte_gemm import bf16acc_block

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plain_of(x, w, kw, n_split=None):
        """The plain version of the engine that runs ``kw``: under bf16acc
        on the split-K engine, its slices (pinned, or the card's) and K
        blocks; else the whole-K version (an f32 accumulator's slices
        differ from it in f32 summation order only)."""
        acc = kw.get("acc_dtype")
        g, c, k = x.shape
        if acc is None or grouped_engine(x.dtype, c, w.shape[2], k,
                                         bf16acc=True) != "splitk":
            return lambda: grouped_gemm_torch(x, w, **kw)  # noqa: E731
        slices, depth = split_layout(x, w, widths=kw.get("widths"),
                                     n_split=n_split, sm_count=sms)
        pkw = {key: v for key, v in kw.items() if key != "geom"}
        return lambda: grouped_splitk_torch(  # noqa: E731
            x, w, n_split=slices, depth=depth,
            rbk=bf16acc_block(kw["geom"].bk, k), **pkw)

    def zero_past_widths(name, got, widths):
        for i, wd in enumerate(widths or ()):
            require(bool((got[i, :, wd:] == 0).all()),
                    f"{name}: member {i}'s columns past {wd} not 0")

    gen = torch.Generator(device=dev).manual_seed(4)

    def operands(g, c, k, n, dt):
        if dt == torch.int8:
            return (torch.randint(-127, 128, (g, c, k), generator=gen,
                                  device=dev, dtype=dt),
                    torch.randint(-127, 128, (g, k, n), generator=gen,
                                  device=dev, dtype=dt))
        return ((torch.randn(g, c, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(dt),
                torch.randn(g, k, n, generator=gen, device=dev).to(dt))

    modes = [("fp32", torch.float32, None, torch.float32, 1e-4),
             ("bf16", torch.bfloat16, None, torch.bfloat16, 2e-2),
             ("bf16acc", torch.bfloat16, torch.bfloat16, torch.float32,
              3e-2),
             ("int8", torch.int8, None, torch.int32, 0.0)]
    ragged = [(3, 4, 130, 300, True, None), (2, 70, 1000, 90, False, None),
              (3, 33, 65, 257, True, None)]
    splitk = [(3, 4, 1000, 392, True, (392, 129, 0)),
              (8, 16, 1000, 392, False, (392, 40, 129, 0, 8, 300, 256,
                                         500)),
              (2, 1, 130, 136, True, None)]
    # Past 16 rows on the pipelined engines: C not a multiple of 64, N a
    # tail past the last 128- and 256-column tile, K not a multiple of 64
    # (f32: nor of 16), widths that straddle a tile and one of 0.
    piped = [(3, 100, 1000, 392, True, (392, 129, 0)),
             (2, 200, 520, 264, False, None),
             (4, 64, 1032, 392, False, (392, 40, 300, 0))]
    for label, dt, acc, out_dt, tol in modes:
        cases = [(c, (16, 128) if c[1] <= 16 else (64, 64)) for c in ragged]
        if label in ("bf16", "bf16acc"):
            cases += [(c, (16, 128)) for c in splitk]
            tiles = ((64, 64), (128, 128)) + (
                ((128, 256),) if label == "bf16" else ())
            cases += [(c, t) for c in piped for t in tiles]
        if label == "fp32":
            cases += [(c, t) for c in piped for t in ((128, 128),
                                                       (128, 64))]
        for (g, c, k, n, shared, widths), (bm, bn) in cases:
            x, w = operands(g, c, k, n, dt)
            epi = (Epilogue() if dt == torch.int8 else
                   Epilogue(alpha=0.7, softcap=20.0, activation="gelu"))
            if shared:
                x = x[:1].expand(g, c, k)
                widths = widths or [n, n // 3, n // 2 + 1][:g]
            geom = BlockGeometry(bm, bn, 64, 1, 1, False, SEW.E32, SEW.E32,
                                 "mte")
            kw = dict(geom=geom, epilogue=epi, out_dtype=out_dt,
                      acc_dtype=acc, widths=widths)
            engine = grouped_engine(dt, c, n, k, bf16acc=acc is not None,
                                    tile=(bm, bn))
            kernel = GROUPED_KERNEL[engine]
            got = grouped_gemm_kernel(x, w, **kw)
            shape = (f"{label} G={g} {c}x{n}x{k} {bm}x{bn}"
                     f"{' shared-x' if shared else ''}"
                     f"{' widths' if widths else ''}")
            err = check(f"{kernel} {shape}", got, plain_of(x, w, kw)(),
                        1e-2 if engine == "wgmma" and acc is None else tol)
            rows.append({"kernel": kernel, "shape": shape,
                         "max_abs_err": err, "tol": tol})
            zero_past_widths(f"{kernel} {shape}", got, widths)
            if engine in ("splitk", "wgmma"):
                require(torch.equal(got, grouped_gemm_kernel(x, w, **kw)),
                        f"{kernel}: two calls differ")
            if engine == "simt":
                loop = dict(kw, geom=dataclasses.replace(geom, bm=64,
                                                         bn=64))
                require(torch.equal(got, grouped_gemm_kernel(x, w, **loop)),
                        f"{kernel} {shape}: not bit-equal to the tile loop")
                log("    bit-equal to the tile loop (64x64)")

    cache = PlanCache()

    def main_path(label, g, c, k, widths, out_dt, fmt="bf16", shared=True,
                  tile_loop=False):
        """One main-path group through its plan: checked (f32 accumulator
        1e-2 x (1 + |ref|) in bf16; bf16acc 3e-2) and timed beside its
        bound, its plain version and ``torch.bmm``; ``tile_loop``: the
        tile loop too, pinned at 64 x 64, as a row of its own."""
        n = max(widths)
        ws = [torch.randn(k, wd, generator=gen, device=dev)
              .to(torch.bfloat16) for wd in widths]
        wstack = stack_group_weights(ws)
        if shared:
            x = (torch.randn(c, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            xg = x[None].expand(g, c, k)
        else:
            xg = (torch.randn(g, c, k, generator=gen, device=dev)
                  / math.sqrt(k)).to(torch.bfloat16)
        sig = GemmSignature.make(c, n, k, "bfloat16", out_dt, Epilogue(),
                                 group=g, fmt=fmt)
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        name = GROUPED_KERNEL[engine]
        live_w = list(widths) if g <= MAX_WIDTHS else None
        kw = dict(geom=plan.geometry, out_dtype=out_dt, widths=live_w,
                  acc_dtype=torch.bfloat16 if fmt == "bf16acc" else None)
        tol = 3e-2 if fmt == "bf16acc" else (
            1e-2 if engine == "wgmma" else 2e-2)
        label += " bf16acc" if fmt == "bf16acc" else ""
        run = lambda: grouped_gemm_kernel(xg, wstack, **kw)  # noqa: E731
        plain = plain_of(xg, wstack, kw)
        got = run()
        err = check(f"{name} main-path {label} [{plan.describe()}, "
                    f"engine {engine}]", got, plain(), tol)
        zero_past_widths(f"{name} {label}", got, live_w)
        if engine in ("splitk", "wgmma"):
            require(torch.equal(got, run()), f"{name}: two calls differ")
        live = sum(widths)
        flops = 2.0 * c * k * live
        out_b = torch.empty((), dtype=out_dt).element_size()
        nbytes = (2.0 * (c * k * (1 if shared else g) + k * live)
                  + out_b * g * c * n)
        lib = lambda: torch.bmm(xg, wstack)  # noqa: E731
        row = {"kernel": name, "shape": label,
               "plan": plan.describe(), "engine": engine,
               "max_abs_err": err, "tol": tol,
               "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, PEAK["bf16"]),
               "bound_by": bound_by(flops, nbytes, PEAK["bf16"]),
               "library_ms": time_ms(lib)}
        if engine == "splitk":
            # With the weights cold in L2, as in a decode step, and at
            # every split the engine takes (the planner's in "ms").
            row["cold_ms"] = time_ms_cold(run)
            row["library_cold_ms"] = time_ms_cold(lib)
            row["ms_by_split"] = {}
            for s in (1, 2, 4, 8):
                pinned = lambda: grouped_gemm_kernel(  # noqa: E731
                    xg, wstack, n_split=s, **kw)
                err = max(err, check(f"{name} main-path {label} {s} "
                                     f"slices", pinned(),
                                     plain_of(xg, wstack, kw, s)(), tol))
                row["ms_by_split"][s] = time_ms(pinned)
            row["max_abs_err"] = err
        else:
            row["cold_ms"] = time_ms_cold(run)
        rows.append(row)
        lib_ms = row["library_ms"]
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; live "
            f"columns only), plain {row['plain_ms']:.4f} ms, torch.bmm "
            f"{lib_ms:.4f} ms ({row['ms'] / lib_ms:.2f}x"
            + (", another function under bf16acc)" if fmt == "bf16acc"
               else ")")
            + (f"; L2 cold torch.bmm {row['library_cold_ms']:.4f} ms; by "
               f"split {row['ms_by_split']}" if engine == "splitk" else ""))
        if tile_loop:
            lkw = dict(kw, geom=dataclasses.replace(plan.geometry, bm=64,
                                                    bn=64))
            loop = lambda: grouped_gemm_kernel(  # noqa: E731
                xg, wstack, engine="tile", **lkw)
            lrow = dict(row, kernel="grouped_gemm", engine="tile",
                        shape=f"{label} (tile loop)", plan="pinned 64x64",
                        max_abs_err=check(f"grouped_gemm main-path {label} "
                                          f"(tile loop, 64x64)", loop(),
                                          plain(), 2e-2),
                        ms=time_ms(loop), cold_ms=time_ms_cold(loop))
            lrow.pop("ms_by_split", None)
            rows.append(lrow)
            log(f"    the tile loop at 64x64: {lrow['ms']:.4f} ms (L2 cold "
                f"{lrow['cold_ms']:.4f}); the {engine} engine "
                f"{lrow['ms'] / row['ms']:.2f}x faster")

    # The decode steps' q/k/v groups over the prestacked weights (k and v
    # padded from 256 to q's width; their padding tiles are skipped), and
    # the prefill chunk's gate+up group (the member path: f32 out).
    main_path("qkv decode 3x4x2048x2048", 3, 4, 2048, (2048, 256, 256),
              torch.bfloat16)
    main_path("qkv decode 3x4x4096x4096", 3, 4, 4096, (4096, 256, 256),
              torch.bfloat16)
    main_path("qkv decode 3x4x4608x4096", 3, 4, 4608, (4096, 2048, 2048),
              torch.bfloat16)
    # qwen15_4b's MHA group (no padding) under its bf16acc format, and with
    # the f32 accumulator at the same shape.
    for fmt in ("bf16acc", "bf16"):
        main_path("qkv decode 3x4x2560x2560", 3, 4, 2560, (2560,) * 3,
                  torch.bfloat16, fmt=fmt)
    # starcoder2_7b's GQA 36/4 group: k and v 512 wide, padded to q's 4608
    # (their padding tiles skipped; the biases are added after the group).
    main_path("s2 qkv decode 3x4x4608x4608", 3, 4, 4608, (4608, 512, 512),
              torch.bfloat16)
    main_path("gate+up prefill 2x512x2048x16384", 2, 512, 2048,
              (16384, 16384), torch.float32, tile_loop=True)
    # qwen15_4b's prefill q/k/v (one 512-token chunk) as one group under
    # its bf16acc format: the programs keep it ungrouped (grouped plans
    # keep the tile loop's price), the row shows what a group would take.
    main_path("qkv prefill 3x512x2560x2560", 3, 512, 2560, (2560,) * 3,
              torch.bfloat16, fmt="bf16acc")
    # granite_moe_1b's experts in bf16 (its config is int8; this is the
    # bf16 path the int8 wgmma engine will extend): 32 experts of capacity
    # 1024 (4096 tokens x top-8 / 32), each its own x.
    main_path("moe gate 32x1024x1024x512", 32, 1024, 1024, (512,) * 32,
              torch.bfloat16, shared=False)
    main_path("moe down 32x1024x512x1024", 32, 1024, 512, (1024,) * 32,
              torch.bfloat16, shared=False)

    # GroupedGemm's backward in f32 at gemma_2b's gate+up group over 4096
    # tokens: dw = x^T (2, 2048, 4096) @ dacc (2, 4096, 16384), on the
    # SIMT engine through the plan the backward gets (raw_grouped).
    from repro_torch.kernels.autodiff import raw_grouped
    from repro_torch.core.autotune import get_plan
    g, c, k, n = 2, 2048, 4096, 16384
    xt = torch.randn(g, c, k, generator=gen, device=dev) / math.sqrt(k)
    dacc = torch.randn(g, k, n, generator=gen, device=dev) / math.sqrt(n)
    plan = get_plan(c, n, k, torch.float32, torch.float32, group=g)
    engine = plan_engine(plan.signature, plan.geometry)
    name = GROUPED_KERNEL[engine]
    label = f"dw fp32 {g}x{c}x{k}x{n}"
    run = lambda: raw_grouped(xt, dacc)  # noqa: E731
    plain = lambda: grouped_gemm_torch(  # noqa: E731
        xt, dacc, geom=plan.geometry)
    got, want = run(), plain()
    err = check(f"{name} main-path {label} [{plan.describe()}, engine "
                f"{engine}]", got, want, 1e-4)
    require(engine == "simt", f"{label} plans onto {engine}, not the SIMT "
            f"f32 engine")
    rel = _frobenius(got, want)
    log(f"    relative Frobenius error {rel:.3e} (tol 1e-5)")
    require(rel <= 1e-5, f"{name} {label}: relative error {rel}")
    del got, want
    flops = 2.0 * g * c * k * n
    nbytes = 4.0 * g * (c * k + k * n + c * n)
    lib = lambda: torch.bmm(xt, dacc)  # noqa: E731
    row = {"kernel": name, "shape": label, "engine": engine,
           "plan": plan.describe(), "max_abs_err": err, "tol": 1e-4,
           "rel_err": rel, "rel_tol": 1e-5,
           "ms": time_ms(run, iters=5), "cold_ms": time_ms_cold(run, 5),
           "plain_ms": time_ms(plain, iters=5),
           "bound_ms": bound_ms(flops, nbytes, PEAK["fp32"]),
           "bound_by": bound_by(flops, nbytes, PEAK["fp32"]),
           "library_ms": time_ms(lib, iters=5), "library": "torch.bmm (f32)"}
    row["tflops"] = flops / row["ms"] / 1e9
    rows.append(row)
    log(f"    time {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), L2 cold "
        f"{row['cold_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, torch.bmm "
        f"f32 {row['library_ms']:.4f} ms "
        f"({row['ms'] / row['library_ms']:.2f}x)")
    del xt, dacc


# -- phase 2: int8 on the s8 wgmma engine ---------------------------------------

# Ragged int8 shapes of B1's s8 engine: M 65 and 520, N 72 and 2056, K 144
# and 1040 (a K tail past the 128-deep stages).
S8_SHAPES = [(65, 72, 144), (520, 2056, 1040), (65, 2056, 144),
             (520, 72, 1040)]
# The int8 GEMMs timed at their main-path shapes: gemma_2b's prefill
# projections (one 512-token chunk) and granite_moe_1b's attention
# projections (d_model 1024, 16 heads x 64, 8 kv heads) over a 512-token
# chunk, on B1.
S8_GEMMS = [("gate", 512, 16384, 2048), ("up", 512, 16384, 2048),
            ("down", 512, 2048, 16384), ("q/o", 512, 2048, 2048),
            ("k/v", 512, 256, 2048), ("granite q/o", 512, 1024, 1024),
            ("granite k/v", 512, 512, 1024)]
# granite_moe_1b's 32 experts (d_model 1024, d_ff 512), each its own x,
# at the capacity of its served 512-token chunk (C = 160 at capacity
# factor 1.25), gate and down.
S8_EXPERTS = [("moe gate", 32, 160, 1024, 512),
              ("moe down", 32, 160, 512, 1024)]


def int_mm_call(a, b, bt):
    """One ``torch._int_mm`` call computing a @ b (int8 -> int32), B
    given column-major (``bt`` (N, K) seen transposed, cuBLAS's fast
    layout) or, where that is refused, row-major; None where neither
    runs here (the error is printed)."""
    import torch
    for call in (lambda: torch._int_mm(a, bt.t()),
                 lambda: torch._int_mm(a, b)):
        try:
            call()
            return call
        except RuntimeError as e:
            log(f"    torch._int_mm refused a layout: {e}")
    return None


def int8_phase(dev, rows):
    """B1 and B3 on the int8 (s8) entries of the wgmma mainloop against
    the tile loop and their plain versions, bit for bit: ragged shapes at
    every B1 tile with B as (K, N) and as (N, K), B3 with x broadcast and
    per member and with widths, and ±127 operands at K = 4096 (sums past
    2^24); then the main-path rows with their plans: B1 at gemma_2b's
    prefill gate, up, down, q/o and k/v and at granite_moe_1b's q/o and
    k/v, B3 at granite's experts (own x) and at gemma_2b's gate+up group,
    each timed warm and L2-cold beside its bound (int8 operations at 1979
    TOPS, bytes at 3.35 TB/s: the operands once and the int32 output),
    the plain version, ``torch._int_mm`` (B1; B3 has no one call: the
    summed time of its members' calls is kept apart), the K-major copy of
    B the wrapper makes and the tile loop in the same run; and the int8
    times of the tile loops themselves (B1, B3 and B8 stage 1 pinned) at
    gemma_2b's gate."""
    import torch
    from repro_torch.core.autotune import (GemmSignature, PlanCache,
                                           plan_engine)
    from repro_torch.core.geometry import (WGMMA_TILES, BlockGeometry, SEW,
                                           gemm_engine, grouped_engine)
    from repro_torch.kernels.grouped_gemm import (grouped_gemm_kernel,
                                                  grouped_gemm_torch)
    from repro_torch.kernels.mte_gemm import (k_major, mte_gemm_kernel,
                                              mte_gemm_torch)
    from repro_torch.kernels.rigid_gemm import (rigid_accumulate_kernel,
                                                rigid_accumulate_torch)

    gen = torch.Generator(device=dev).manual_seed(29)
    i32 = torch.int32

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def geom(tile, transposed=False):
        return BlockGeometry(*tile, 256, 1, 1, transposed, SEW.E8, SEW.E32,
                             "mte")

    def exact(name, got, want, loop=None):
        ok = got.dtype == i32 and torch.equal(got, want) and (
            loop is None or torch.equal(got, loop))
        log(f"  {name}: int32 bit-equal to the plain version"
            f"{' and the tile loop' if loop is not None else ''} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name}: not bit-equal")

    # B1: every compiled tile, both B layouts, ragged M, N and K.
    for tile in WGMMA_TILES:
        for m, n, k in S8_SHAPES[:2] if tile != (128, 256) else S8_SHAPES:
            require(gemm_engine(torch.int8, *tile, n, k, m=m) == "wgmma",
                    f"{m}x{n}x{k} at {tile} is not on the s8 engine")
            a, b = ints(m, k), ints(k, n)
            want = mte_gemm_torch(a, b, geom=geom(tile), out_dtype=i32)
            for tb, bb in ((False, b), (True, b.t().contiguous())):
                got = mte_gemm_kernel(a, bb, geom=geom(tile, tb),
                                      out_dtype=i32)
                loop = mte_gemm_kernel(a, bb, geom=geom((64, 64), tb),
                                       out_dtype=i32, engine="tile")
                exact(f"mte_gemm_wgmma_s8 [{tile[0]}x{tile[1]}] "
                      f"{'(N, K) ' if tb else ''}{m}x{n}x{k}", got, want,
                      loop)
                rows.append({"kernel": "mte_gemm_wgmma_s8",
                             "shape": f"int8 {m}x{n}x{k} {tile[0]}x"
                                      f"{tile[1]}{' nk' if tb else ''}",
                             "max_abs_err": 0.0, "tol": 0.0})
    # B3: x broadcast and per member, with and without widths.
    for tile in ((64, 128), (128, 256)):
        for g, c, n, k in [(3, 65, 2056, 144), (3, 520, 72, 1040)]:
            for shared in (True, False):
                x, w = ints(1 if shared else g, c, k), ints(g, k, n)
                if shared:
                    x = x.expand(g, c, k)
                require(grouped_engine(torch.int8, c, n, k, tile=tile)
                        == "wgmma", f"G={g} {c}x{n}x{k} is not on the s8 "
                        f"engine")
                for widths in (None, [n, 0, 40]):
                    kw = dict(geom=geom(tile), out_dtype=i32, widths=widths)
                    got = grouped_gemm_kernel(x, w, **kw)
                    shape = (f"int8 G={g} {c}x{n}x{k} {tile[0]}x{tile[1]}"
                             f"{' shared-x' if shared else ''}"
                             f"{' widths' if widths else ''}")
                    exact(f"grouped_gemm_wgmma_s8 {shape}", got,
                          grouped_gemm_torch(x, w, **kw),
                          grouped_gemm_kernel(x, w, engine="tile", **dict(
                              kw, geom=geom((64, 64)))))
                    for i, wd in enumerate(widths or ()):
                        require(bool((got[i, :, wd:] == 0).all()),
                                f"{shape}: columns past {wd} not 0")
                    rows.append({"kernel": "grouped_gemm_wgmma_s8",
                                 "shape": shape, "max_abs_err": 0.0,
                                 "tol": 0.0})
    # ±127 operands at K = 4096: sums past 2^24 that f32 cannot hold.
    m, n, k = 192, 320, 4096
    a = torch.full((m, k), 127, dtype=torch.int8, device=dev)
    b = torch.full((k, n), -127, dtype=torch.int8, device=dev)
    b[::2, 1::2] = 127
    b[:3, ::3] = 1
    b[3, ::3] = 2
    want = mte_gemm_torch(a, b, geom=geom((64, 64)), out_dtype=i32)
    require(int(want.abs().max()) > 2 ** 24
            and not torch.equal(want.float().long(), want.long()),
            "the ±127 case does not pass 2^24")
    for tile in ((64, 64), (128, 256)):
        exact(f"mte_gemm_wgmma_s8 ±127 K=4096 [{tile[0]}x{tile[1]}] "
              f"(max |sum| {int(want.abs().max())})",
              mte_gemm_kernel(a, b, geom=geom(tile), out_dtype=i32), want)
        exact(f"grouped_gemm_wgmma_s8 ±127 K=4096 [{tile[0]}x{tile[1]}]",
              grouped_gemm_kernel(a[None].expand(2, m, k),
                                  torch.stack([b, -b]), geom=geom(tile),
                                  out_dtype=i32),
              torch.stack([want, -want]))

    cache = PlanCache()
    peak = PEAK["int8"]

    def s8_gemm_row(label, m, n, k):
        sig = GemmSignature.make(m, n, k, "int8", "int32", fmt="int8")
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        log(f"  int8 {label} {m}x{n}x{k}: plan {plan.describe()}, engine "
            f"{engine}")
        require(plan.route == "mte" and engine == "wgmma",
                f"int8 {label}: planned {plan.describe()} on {engine}")
        a, b = ints(m, k), ints(k, n)
        bt = b.t().contiguous()
        g = plan.geometry
        run = lambda: mte_gemm_kernel(  # noqa: E731
            a, bt, geom=dataclasses.replace(g, transposed_b=True),
            out_dtype=i32)
        wrapped = lambda: mte_gemm_kernel(  # noqa: E731
            a, b, geom=g, out_dtype=i32)
        loop = lambda: mte_gemm_kernel(  # noqa: E731
            a, b, geom=dataclasses.replace(g, bm=64, bn=64), out_dtype=i32,
            engine="tile")
        plain = lambda: mte_gemm_torch(  # noqa: E731
            a, b, geom=g, out_dtype=i32)
        want = plain()
        exact(f"mte_gemm_wgmma_s8 main-path int8 {label} {m}x{n}x{k}",
              run(), want, loop())
        require(torch.equal(wrapped(), want), f"int8 {label}: the (K, N) "
                f"route differs")
        lib = int_mm_call(a, b, bt)
        if lib is not None:
            require(torch.equal(lib(), want), f"torch._int_mm differs at "
                    f"{label}")
        flops = 2.0 * m * n * k
        nbytes = m * k + k * n + 4.0 * m * n
        row = {"kernel": "mte_gemm_wgmma_s8",
               "shape": f"int8 {label} {m}x{n}x{k}", "engine": engine,
               "plan": plan.describe(), "max_abs_err": 0.0, "tol": 0.0,
               "ms": time_ms(run), "cold_ms": time_ms_cold(run),
               "wrapper_ms": time_ms(wrapped),
               "k_major_copy_ms": time_ms(lambda: k_major(b, False)),
               "plain_ms": time_ms(plain, iters=5),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": "torch._int_mm",
               "library_ms": time_ms(lib) if lib else None,
               "library_cold_ms": time_ms_cold(lib) if lib else None,
               "tile_loop_ms": time_ms(loop, iters=5)}
        rows.append(row)
        lib_txt = (f"torch._int_mm {row['library_ms']:.4f} ms (L2 cold "
                   f"{row['library_cold_ms']:.4f}; "
                   f"{row['ms'] / row['library_ms']:.2f}x)" if lib
                   else "torch._int_mm not run")
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {lib_txt}"
            f", K-major copy of B {row['k_major_copy_ms']:.4f} ms (copy + "
            f"kernel {row['wrapper_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, the tile loop (64x64) "
            f"{row['tile_loop_ms']:.4f} ms "
            f"({row['tile_loop_ms'] / row['ms']:.1f}x the s8 engine)")
        return row

    for label, m, n, k in S8_GEMMS:
        s8_gemm_row(label, m, n, k)

    def s8_group_row(label, g, c, k, n, shared=False, tile_loop_row=False):
        sig = GemmSignature.make(c, n, k, "int8", "int32", fmt="int8",
                                 group=g)
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        log(f"  int8 {label} G={g} {c}x{k}->{n}: plan {plan.describe()}, "
            f"engine {engine}")
        require(engine == "wgmma", f"int8 {label}: on {engine}")
        x = ints(1 if shared else g, c, k)
        x = x.expand(g, c, k) if shared else x
        w = ints(g, k, n)
        wt = w.transpose(1, 2).contiguous()
        kw = dict(geom=plan.geometry, out_dtype=i32)
        run = lambda: grouped_gemm_kernel(x, w, **kw)  # noqa: E731
        lkw = dict(kw, geom=dataclasses.replace(plan.geometry, bm=64, bn=64))
        loop = lambda: grouped_gemm_kernel(  # noqa: E731
            x, w, engine="tile", **lkw)
        plain = lambda: grouped_gemm_torch(x, w, **kw)  # noqa: E731
        want = plain()
        shape = (f"int8 {label} {g}x{c}x{k}x{n}"
                 f"{' shared-x' if shared else ''}")
        exact(f"grouped_gemm_wgmma_s8 main-path {shape}", run(), want,
              loop())
        # No one library call: each member's torch._int_mm, summed.
        calls = [int_mm_call(x[i], w[i], wt[i]) for i in range(g)]
        members = None
        if all(calls):
            members = lambda: [f() for f in calls]  # noqa: E731
        flops = 2.0 * g * c * k * n
        nbytes = (1 if shared else g) * c * k + g * k * n + 4.0 * g * c * n
        # The wrapper's K-major copy of w is inside ``ms``; timed apart.
        row = {"kernel": "grouped_gemm_wgmma_s8", "shape": shape,
               "engine": engine, "plan": plan.describe(),
               "max_abs_err": 0.0, "tol": 0.0,
               "ms": time_ms(run), "cold_ms": time_ms_cold(run),
               "k_major_copy_ms": time_ms(
                   lambda: w.transpose(1, 2).contiguous()),
               "plain_ms": time_ms(plain, iters=3),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": None, "library_ms": None,
               "int_mm_members_ms": time_ms(members) if members else None,
               "tile_loop_ms": time_ms(loop, iters=5)}
        rows.append(row)
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}; "
            f"with the K-major copy of w, {row['k_major_copy_ms']:.4f} ms "
            f"of it), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"library none ({g} torch._int_mm calls, one a member: "
            + (f"{row['int_mm_members_ms']:.4f} ms" if members else "not run")
            + f"), plain {row['plain_ms']:.4f} ms, the tile loop (64x64) "
            f"{row['tile_loop_ms']:.4f} ms "
            f"({row['tile_loop_ms'] / row['ms']:.1f}x)")
        if tile_loop_row:
            rows.append(dict(row, kernel="grouped_gemm", engine="tile",
                             shape=f"{shape} (tile loop)",
                             plan="pinned 64x64", ms=row["tile_loop_ms"],
                             cold_ms=time_ms_cold(loop, iters=3)))

    for label, g, c, k, n in S8_EXPERTS:
        s8_group_row(label, g, c, k, n)
    # gemma_2b's gate+up as one int8 group (the programs keep it
    # ungrouped): the s8 engine beside B3's tile loop.
    s8_group_row("gate+up", 2, 512, 2048, 16384, shared=True,
                 tile_loop_row=True)

    # The tile loops' own int8 rows at gemma_2b's gate: B1's pinned at
    # 64 x 64 and B8's stage 1 pinned (its rule names the s8 engine,
    # ``rigid_int8_phase``).
    m, n, k = 512, 16384, 2048
    a, b = ints(m, k), ints(k, n)
    bt = b.t().contiguous()
    lib = int_mm_call(a, b, bt)
    flops, nbytes = 2.0 * m * n * k, m * k + k * n + 4.0 * m * n
    for kern, run, plain in (
            ("mte_gemm", lambda: mte_gemm_kernel(
                a, b, geom=geom((64, 64)), out_dtype=i32, engine="tile"),
             lambda: mte_gemm_torch(a, b, geom=geom((64, 64)),
                                    out_dtype=i32)),
            ("rigid_gemm", lambda: rigid_accumulate_kernel(
                a, b, engine="tile"),
             lambda: rigid_accumulate_torch(a, b))):
        want = plain()
        exact(f"{kern} int8 gate {m}x{n}x{k} (tile loop)", run(), want)
        row = {"kernel": kern, "engine": "tile",
               "shape": f"int8 gate {m}x{n}x{k} (tile loop)",
               "plan": "pinned 64x64" if kern == "mte_gemm"
               else "rigid 128x128x128",
               "max_abs_err": 0.0, "tol": 0.0, "ms": time_ms(run, iters=5),
               "cold_ms": time_ms_cold(run, iters=3),
               "plain_ms": time_ms(plain, iters=3),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": "torch._int_mm",
               "library_ms": time_ms(lib) if lib else None}
        rows.append(row)
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, torch._int_mm "
            + (f"{row['library_ms']:.4f} ms "
               f"({row['ms'] / row['library_ms']:.1f}x)" if lib
               else "not run"))


# -- phase 2: int8 decode GEMMs on the cluster split-K engines ----------------

# Ragged int8 decode shapes (K, N) of B2's and B3's s8 entries: K 144 (one
# short 128-row stage), 2048 and 16384; N past the last 128-column tile.
S8_DECODE_SHAPES = [(144, 2064), (2048, 2064), (16384, 400)]
# gemma_2b's int8 decode GEMMs at 4 slots on B2 (gate and up share one
# shape) and its decode q/k/v group on B3 (widths 2048/256/256).
S8_DECODE_GEMMS = [("o", 4, 2048, 2048), ("gate", 4, 16384, 2048),
                   ("down", 4, 2048, 16384), ("granite o", 4, 1024, 1024)]
# B3's s8 split-K groups of a decode step: (label, G, C, K, N, widths):
# gemma_2b's q/k/v (widths 2048/256/256), and granite_moe_1b's experts'
# gate and down at 4 slots (C = 8 rows, each expert its own x).
S8_DECODE_GROUPS = [("qkv decode", 3, 4, 2048, 2048, (2048, 256, 256)),
                    ("granite moe gate decode", 32, 8, 1024, 512, None),
                    ("granite moe down decode", 32, 8, 512, 1024, None)]


def int8_decode_phase(dev, rows):
    """B2 and B3 on the s8 entries of the cluster split-K mainloop against
    the tile loops and their plain versions, bit for bit: B2 at M 1, 5
    and 16 and ragged K and N (``splitk_cluster_torch`` at the engine's
    split, ``int_matmul`` and the tile loop's summed partials, pinned
    with ``launch_partials``), every slice count pinned, B3 with a
    broadcast and a per-member x, with and without widths
    (``grouped_splitk_torch``, ``grouped_gemm_torch``, the tile loop
    pinned with ``engine="tile"``), and ±127 operands at K = 16384 (sums
    past 2^24); then gemma_2b's int8 decode GEMMs (o, gate/up, down) and
    its decode q/k/v group through their plans, each timed warm, L2-cold
    and at every split beside its bound (bytes at 3.35 TB/s: the int8
    operands once and the int32 output; int8 operations at 1979 TOPS),
    the plain version, ``torch._int_mm`` on the 4 rows zero-padded to 32
    (it takes only M > 16; B3 has no one call: its three members' calls
    summed, kept apart) and the tile loop in the same run, which also
    gets rows of its own (``splitk_gemm`` / ``grouped_gemm``)."""
    import torch
    from repro_torch.core.autotune import (GemmSignature, PlanCache,
                                           plan_engine)
    from repro_torch.core.formats import int_matmul
    from repro_torch.core.geometry import (SEW, BlockGeometry, cdiv,
                                           grouped_engine, splitk_engine)
    from repro_torch.kernels.grouped_gemm import (grouped_gemm_kernel,
                                                  grouped_gemm_torch,
                                                  grouped_splitk_torch,
                                                  split_layout)
    from repro_torch.kernels.splitk_gemm import (cluster_layout,
                                                 launch_partials,
                                                 mte_gemm_splitk_kernel,
                                                 mte_gemm_splitk_torch,
                                                 splitk_cluster_torch)

    gen = torch.Generator(device=dev).manual_seed(30)
    i32, i8 = torch.int32, torch.int8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = BlockGeometry(16, 128, 256, 4, 1, False, SEW.E8, SEW.E32, "mte")

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=i8)

    def exact(name, got, *wants):
        ok = got.dtype == i32 and all(torch.equal(got, w) for w in wants)
        log(f"  {name}: int32 bit-equal to the plain version, int_matmul "
            f"and the tile loop {'ok' if ok else 'FAIL'}")
        require(ok, f"{name}: not bit-equal")

    def b2(a, b, label, **pin):
        m, k = a.shape
        n = b.shape[1]
        require(splitk_engine(i8, m, n, k) == "cluster",
                f"int8 {m}x{n}x{k} is not on the cluster engine")
        slices, depth = cluster_layout(m, n, k, dev,
                                       pin.get("cluster_split"),
                                       dtype_in=i8)
        got = mte_gemm_splitk_kernel(a, b, geom=geo, out_dtype=i32, **pin)
        loop = launch_partials(a, b, geom=geo, n_split=4, acc_dtype=i32,
                               engine="tile").sum(0, dtype=i32)
        exact(f"splitk_gemm_cluster_s8 {label} {slices} slices of {depth}",
              got, splitk_cluster_torch(a, b, n_split=slices, depth=depth,
                                        out_dtype=i32),
              int_matmul(a, b), loop)

    def b3(x, w, widths, label):
        g, c, k = x.shape
        n = w.shape[2]
        require(grouped_engine(i8, c, n, k) == "splitk",
                f"int8 G={g} {c}x{n}x{k} is not on the split-K engine")
        kw = dict(geom=geo, out_dtype=i32, widths=widths)
        slices, depth = split_layout(x, w, widths=widths, sm_count=sms)
        exact_ = torch.stack([int_matmul(x[i], w[i]) for i in range(g)])
        for i, wd in enumerate(widths or ()):
            exact_[i, :, wd:] = 0
        got = grouped_gemm_kernel(x, w, **kw)
        exact(f"grouped_gemm_splitk_s8 {label} {slices} slices of {depth}",
              got, grouped_splitk_torch(x, w, n_split=slices, depth=depth,
                                        out_dtype=i32, widths=widths),
              grouped_gemm_torch(x, w, **kw), exact_,
              grouped_gemm_kernel(x, w, engine="tile", **kw))

    # Ragged rows and shapes; B3 with a broadcast x and widths, and with a
    # per-member x and none.
    for m in (1, 5, 16):
        for k, n in S8_DECODE_SHAPES:
            b2(ints(m, k), ints(k, n), f"{m}x{n}x{k}")
            rows.append({"kernel": "splitk_gemm_cluster_s8",
                         "shape": f"int8 {m}x{n}x{k}", "max_abs_err": 0.0,
                         "tol": 0.0})
        for k, n in S8_DECODE_SHAPES:
            for shared, widths in ((True, [n, 16, 0]), (False, None)):
                x = ints(1 if shared else 3, m, k)
                x = x.expand(3, m, k) if shared else x
                label = (f"G=3 {m}x{n}x{k}{' shared-x' if shared else ''}"
                         f"{' widths' if widths else ''}")
                b3(x, ints(3, k, n), widths, label)
                rows.append({"kernel": "grouped_gemm_splitk_s8",
                             "shape": f"int8 {label}", "max_abs_err": 0.0,
                             "tol": 0.0})
    # Every slice count the s8 entry takes at gemma_2b's o (128-row
    # stages: 5 and 7 slices of K = 2048 leave one empty).
    a, b = ints(4, 2048), ints(2048, 2048)
    for s in (1, 2, 3, 4, 6, 8):
        b2(a, b, "o 4x2048x2048 pinned", cluster_split=s)
    # ±127 operands at K = 16384: sums past 2^24 that f32 cannot hold.
    m, n, k = 5, 272, 16384
    a = torch.full((m, k), 127, dtype=i8, device=dev)
    b = torch.full((k, n), -127, dtype=i8, device=dev)
    b[::2, 1::2] = 127
    b[:3, ::3] = 1
    b[3, ::3] = 2
    want = int_matmul(a, b)
    require(int(want.abs().max()) > 2 ** 24
            and not torch.equal(want.float().long(), want.long()),
            "the ±127 case does not pass 2^24")
    b2(a, b, f"±127 {m}x{n}x{k} (max |sum| {int(want.abs().max())})")
    b3(a[None].expand(2, m, k), torch.stack([b, -b]), [n, 16],
       f"±127 G=2 {m}x{n}x{k}")

    cache = PlanCache()
    peak = PEAK["int8"]

    def padded_int_mm(a, b):
        """``torch._int_mm`` of a's rows zero-padded to 32 (it takes only
        M > 16), held to the exact product on a's rows."""
        ap = torch.zeros(32, a.shape[1], dtype=i8, device=dev)
        ap[:a.shape[0]] = a
        call = int_mm_call(ap, b, b.t().contiguous())
        if call is not None:
            require(torch.equal(call()[:a.shape[0]], int_matmul(a, b)),
                    "torch._int_mm differs")
        return call

    def timed(row, run, plain, loop, lib, slices, pinned):
        row.update({"ms": time_ms(run), "cold_ms": time_ms_cold(run),
                    "plain_ms": time_ms(plain, iters=3),
                    "library_ms": time_ms(lib) if lib else None,
                    "library_cold_ms": time_ms_cold(lib) if lib else None,
                    "tile_loop_ms": time_ms(loop, iters=5),
                    "tile_loop_cold_ms": time_ms_cold(loop, iters=5),
                    "slices": slices,
                    "ms_by_split": {s: time_ms(f) for s, f in pinned}})
        rows.append(row)
        rows.append(dict(row, kernel=row["tile_loop"], engine="tile",
                         shape=f"{row['shape']} (tile loop)",
                         ms=row["tile_loop_ms"],
                         cold_ms=row["tile_loop_cold_ms"],
                         plain_ms=row["tile_loop_plain_ms"],
                         ms_by_split=None))
        members = row.get("int_mm_members_ms")
        lib_txt = (f"{row['library']} {row['library_ms']:.4f} ms (L2 cold "
                   f"{row['library_cold_ms']:.4f})" if lib else
                   f"library none ({row['library']}: "
                   + (f"{members:.4f} ms)" if members else "not run)"))
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, {lib_txt}, the tile loop "
            f"{row['tile_loop_ms']:.4f} ms (L2 cold "
            f"{row['tile_loop_cold_ms']:.4f}; "
            f"{row['tile_loop_ms'] / row['ms']:.1f}x); by split "
            f"{row['ms_by_split']} (planned {slices})")

    def s8_decode_group(label, g, c, k, n, widths):
        sig = GemmSignature.make(c, n, k, "int8", "int32", fmt="int8",
                                 group=g)
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        log(f"  int8 {label} G={g} {c}x{k}->{n} widths {widths}: plan "
            f"{plan.describe()}, engine {engine}")
        require(engine == "splitk", f"int8 {label}: on {engine}")
        # What the decode step hands it: x quantized per member
        # (contiguous); the prestacked q/k/v weight zero past its widths.
        x, w = ints(g, c, k), ints(g, k, n)
        widths = list(widths) if widths else None
        for i, wd in enumerate(widths or ()):
            w[i, :, wd:] = 0
        kw = dict(geom=plan.geometry, out_dtype=i32, widths=widths)
        slices, depth = split_layout(x, w, widths=widths, sm_count=sms)
        run = lambda: grouped_gemm_kernel(x, w, **kw)  # noqa: E731
        plain = lambda: grouped_splitk_torch(  # noqa: E731
            x, w, n_split=slices, depth=depth, out_dtype=i32,
            widths=widths)
        loop = lambda: grouped_gemm_kernel(  # noqa: E731
            x, w, engine="tile", **kw)
        exact(f"grouped_gemm_splitk_s8 main-path int8 {label}", run(),
              plain(), grouped_gemm_torch(x, w, **kw), loop())
        pinned = []
        for s in (1, 2, 4, 8):
            f = lambda s=s: grouped_gemm_kernel(x, w, n_split=s,  # noqa
                                                **kw)
            try:
                got = f()
            except ValueError:
                continue     # more slices than 128-row stages
            require(torch.equal(got, run()), f"{label}: {s} slices differ")
            pinned.append((s, f))
        # No one library call: each member's torch._int_mm over its live
        # columns, the rows padded to 32, summed.
        live = widths or [n] * g
        calls = [padded_int_mm(x[i], w[i, :, :wd].contiguous())
                 for i, wd in enumerate(live)]
        flops = 2.0 * c * k * sum(live)
        nbytes = g * c * k + k * sum(live) + 4.0 * g * c * n
        timed({"kernel": "grouped_gemm_splitk_s8",
               "shape": f"int8 {label} {g}x{c}x{k}x{n}", "engine": engine,
               "plan": plan.describe(), "max_abs_err": 0.0, "tol": 0.0,
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": f"{g} torch._int_mm calls summed ({c} rows "
                          f"padded to 32)",
               "int_mm_members_ms": time_ms(lambda: [f() for f in calls])
               if all(calls) else None,
               "tile_loop": "grouped_gemm",
               "tile_loop_plain_ms": time_ms(
                   lambda: grouped_gemm_torch(x, w, **kw), iters=3)},
              run, plain, loop, None, slices, pinned)

    for label, m, n, k in S8_DECODE_GEMMS:
        sig = GemmSignature.make(m, n, k, "int8", "int32", fmt="int8")
        plan = cache.plan(sig)
        engine = plan_engine(sig, plan.geometry)
        log(f"  int8 decode {label} {m}x{n}x{k}: plan {plan.describe()}, "
            f"engine {engine}")
        require(plan.route == "splitk" and engine == "cluster",
                f"int8 decode {label}: planned {plan.describe()} on {engine}")
        a, b = ints(m, k), ints(k, n)
        g = plan.geometry
        slices, depth = cluster_layout(m, n, k, dev, dtype_in=i8)
        run = lambda: mte_gemm_splitk_kernel(  # noqa: E731
            a, b, geom=g, n_split=plan.n_split, out_dtype=i32)
        plain = lambda: splitk_cluster_torch(  # noqa: E731
            a, b, n_split=slices, depth=depth, out_dtype=i32)
        loop = lambda: launch_partials(  # noqa: E731
            a, b, geom=g, n_split=plan.n_split, acc_dtype=i32,
            engine="tile")
        exact(f"splitk_gemm_cluster_s8 main-path int8 decode {label} "
              f"{m}x{n}x{k}", run(), plain(), int_matmul(a, b),
              loop().sum(0, dtype=i32))
        pinned = []
        for s in (1, 2, 4, 8):
            try:
                cluster_layout(m, n, k, dev, s, dtype_in=i8)
            except ValueError:
                continue     # x's slice would not fit, or empty slices
            f = (lambda s=s: mte_gemm_splitk_kernel(
                a, b, geom=g, out_dtype=i32, cluster_split=s))
            require(torch.equal(f(), run()), f"{label}: {s} slices differ")
            pinned.append((s, f))
        flops, nbytes = 2.0 * m * n * k, m * k + k * n + 4.0 * m * n
        timed({"kernel": "splitk_gemm_cluster_s8",
               "shape": f"int8 {label} {m}x{n}x{k}", "engine": engine,
               "plan": plan.describe(), "max_abs_err": 0.0, "tol": 0.0,
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": "torch._int_mm (4 rows padded to 32)",
               "tile_loop": "splitk_gemm",
               "tile_loop_plain_ms": time_ms(
                   lambda: mte_gemm_splitk_torch(
                       a, b, geom=g, n_split=plan.n_split, out_dtype=i32),
                   iters=3)},
              run, plain, loop, padded_int_mm(a, b), slices, pinned)

    for label, g, c, k, n, widths in S8_DECODE_GROUPS:
        s8_decode_group(label, g, c, k, n, widths)


# -- phase 2: B8's int8 stage 1 on the s8 path of the wgmma mainloop ----------

# gemma_2b's projections at a 512-token prefill chunk and a 4-slot decode
# step under amx x int8: (label, M, N, K).
RIGID_S8_GEMMS = [("gate", 512, 16384, 2048), ("down", 512, 2048, 16384),
                  ("q/o", 512, 2048, 2048), ("k/v", 512, 256, 2048),
                  ("decode gate", 4, 16384, 2048),
                  ("decode down", 4, 2048, 16384),
                  ("decode q/o", 4, 2048, 2048),
                  ("decode k/v", 4, 256, 2048)]
# The bit-equality grid of the rigid s8 entry: every M by every N by
# every K.
RIGID_S8_GRID = dict(m=(1, 4, 16, 130, 520), n=(72, 2056, 16384),
                     k=(144, 1040, 2048, 16384))


def rigid_int8_phase(dev, rows):
    """B8's int8 stage 1 on the s8 entry of the wgmma mainloop
    (``rigid_gemm_wgmma_s8``) against the rigid tile loop pinned
    (``engine="tile"``) and the plain version (``int_matmul``), bit for
    bit: every M by N by K of ``RIGID_S8_GRID`` -- rows below the
    128-row tile (TMA's zeros), N past the last tile, K tails past a
    128-deep stage --, ±127
    operands at K = 16384 (sums past 2^24), and the shapes off the rule (K
    % 16, N % 8), which must launch the tile loop; then gemma_2b's
    projections under amx x int8 (``RIGID_S8_GEMMS``), each timed warm and
    L2-cold on the kernel alone (B given K-major, ``s8_accumulate``)
    beside its bound (int8 operations at 1979 TOPS, bytes at 3.35 TB/s:
    the operands once and the int32 output), the wrapper with its K-major
    copy of B, that copy alone, the plain version, ``torch._int_mm``
    (decode: on the rows zero-padded to 32, which it needs) and the tile
    loop in the same run."""
    import torch
    from repro_torch.core.formats import int_matmul
    from repro_torch.core.geometry import RIGID_TILE, gemm_engine
    from repro_torch.kernels import build
    from repro_torch.kernels.mte_gemm import k_major
    from repro_torch.kernels.rigid_gemm import (rigid_accumulate_kernel,
                                                rigid_accumulate_torch,
                                                rigid_gemm_kernel,
                                                s8_accumulate)

    gen = torch.Generator(device=dev).manual_seed(31)
    i8 = torch.int8

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=i8)

    def engine(m, n, k):
        return gemm_engine(i8, *RIGID_TILE[:2], n, k, m=m, rigid=True)

    def exact(name, a, b):
        """Stage 1 on its rule's engine, bit-equal to the tile loop
        pinned and to ``int_matmul``; returns the accumulator."""
        got = rigid_accumulate_kernel(a, b)
        ok = (got.dtype == torch.int32
              and torch.equal(got, rigid_accumulate_kernel(a, b,
                                                           engine="tile"))
              and torch.equal(got, int_matmul(a, b)))
        log(f"  {name}: int32 bit-equal to the rigid tile loop and "
            f"int_matmul {'ok' if ok else 'FAIL'}")
        require(ok, f"{name}: not bit-equal")
        return got

    before = build.launch_counts()
    cases = 0
    for k in RIGID_S8_GRID["k"]:
        for n in RIGID_S8_GRID["n"]:
            b = ints(k, n)
            for m in RIGID_S8_GRID["m"]:
                require(engine(m, n, k) == "wgmma",
                        f"rigid int8 {m}x{n}x{k} is not on the s8 engine")
                exact(f"rigid_gemm_wgmma_s8 {m}x{n}x{k}", ints(m, k), b)
                cases += 1
            del b
    after = build.launch_counts()
    require(after["rigid_gemm_wgmma_s8"] - before["rigid_gemm_wgmma_s8"]
            == cases, "the s8 entry did not run every case")
    rows.append({"kernel": "rigid_gemm_wgmma_s8",
                 "shape": f"int8 M 1-520 x N 72-16384 x K 144-16384 "
                          f"({cases} shapes)", "max_abs_err": 0.0,
                 "tol": 0.0})
    # ±127 operands at K = 16384: sums past 2^24 that f32 cannot hold.
    n, k = 272, 16384
    b = torch.full((k, n), -127, dtype=i8, device=dev)
    b[::2, 1::2] = 127
    b[:3, ::3] = 1
    b[3, ::3] = 2
    for m in (4, 130):
        a = torch.full((m, k), 127, dtype=i8, device=dev)
        want = int_matmul(a, b)
        require(int(want.abs().max()) > 2 ** 24
                and not torch.equal(want.float().long(), want.long()),
                "the ±127 case does not pass 2^24")
        exact(f"rigid_gemm_wgmma_s8 ±127 {m}x{n}x{k} (max |sum| "
              f"{int(want.abs().max())})", a, b)
    # Off the rule: the tile loop, and nothing on the s8 entry.
    for m, n, k in ((4, 2048, 2040), (130, 2052, 2048), (520, 257, 65)):
        require(engine(m, n, k) == "tile", f"{m}x{n}x{k} off the rule")
        before = build.launch_counts()
        a, b = ints(m, k), ints(k, n)
        got = rigid_gemm_kernel(a, b, out_dtype=torch.int32)
        require(torch.equal(got, int_matmul(a, b)), f"{m}x{n}x{k} differs")
        after = build.launch_counts()
        ran = {c: after[c] - before[c] for c in after
               if after[c] != before[c]}
        log(f"  rigid_gemm int8 {m}x{n}x{k} off the s8 rule: exact, "
            f"launches {ran}")
        require(ran == {"rigid_gemm": 1}, f"{m}x{n}x{k}: launched {ran}")

    peak = PEAK["int8"]
    for label, m, n, k in RIGID_S8_GEMMS:
        require(engine(m, n, k) == "wgmma", f"{label}: off the s8 engine")
        a, b = ints(m, k), ints(k, n)
        bt = b.t().contiguous()
        run = lambda: s8_accumulate(a, bt)  # noqa: E731
        wrapped = lambda: rigid_accumulate_kernel(a, b)  # noqa: E731
        loop = lambda: rigid_accumulate_kernel(  # noqa: E731
            a, b, engine="tile")
        plain = lambda: rigid_accumulate_torch(a, b)  # noqa: E731
        want = plain()
        got = run()
        ok = (torch.equal(got, want) and torch.equal(wrapped(), want)
              and torch.equal(loop(), want))
        log(f"  rigid_gemm_wgmma_s8 main-path int8 {label} {m}x{n}x{k}: "
            f"bit-equal to the tile loop and the plain version "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"rigid int8 {label}: not bit-equal")
        if m > 16:
            lib, lib_name = int_mm_call(a, b, bt), "torch._int_mm"
        else:
            ap = torch.zeros(32, k, dtype=i8, device=dev)
            ap[:m] = a
            lib = int_mm_call(ap, b, bt)
            lib_name = f"torch._int_mm ({m} rows padded to 32)"
        if lib is not None:
            require(torch.equal(lib()[:m], want), f"torch._int_mm differs "
                    f"at {label}")
        flops = 2.0 * m * n * k
        nbytes = m * k + k * n + 4.0 * m * n
        row = {"kernel": "rigid_gemm_wgmma_s8",
               "shape": f"int8 {label} {m}x{n}x{k}", "engine": "wgmma",
               "plan": "rigid 128x128x128",
               "ctas": math.ceil(m / 128) * math.ceil(n / 128),
               "max_abs_err": 0.0, "tol": 0.0,
               "ms": time_ms(run), "cold_ms": time_ms_cold(run),
               "wrapper_ms": time_ms(wrapped),
               "k_major_copy_ms": time_ms(lambda: k_major(b, False)),
               "plain_ms": time_ms(plain, iters=3),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library": lib_name,
               "library_ms": time_ms(lib) if lib else None,
               "library_cold_ms": time_ms_cold(lib) if lib else None,
               "tile_loop_ms": time_ms(loop, iters=3, warmup=1)}
        rows.append(row)
        lib_txt = (f"{lib_name} {row['library_ms']:.4f} ms (L2 cold "
                   f"{row['library_cold_ms']:.4f}; "
                   f"{row['ms'] / row['library_ms']:.2f}x)" if lib
                   else f"{lib_name} not run")
        log(f"    time {row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}; "
            f"{row['ctas']} CTAs), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {lib_txt}, K-major copy of B "
            f"{row['k_major_copy_ms']:.4f} ms (copy + kernel "
            f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f} ms, the "
            f"rigid tile loop {row['tile_loop_ms']:.4f} ms "
            f"({row['tile_loop_ms'] / row['ms']:.1f}x the s8 engine)")


def rigid_phase(dev, rows):
    """Both halves of B8 against their plain versions: ragged shapes in
    every mode (a rigid route has no narrow accumulator: bf16acc runs as
    bf16; TMA-aligned bf16 shapes run stage 1 on the wgmma engine, f32
    with K and N multiples of 4 on the SIMT f32 engine at every M, bit for
    bit equal to the tile loop pinned, the others on the tile loop), then
    the main path's gate projection with its GeGLU epilogue (the pass also
    with beta*C + bias + softcap, and at the decode gate's 4 rows), stage
    1 also at recurrentgemma_9b's prefill gate and at a 4-slot decode GEMV
    (the 128-row tile's padding), the reduced fp32 model's prefill gate
    (phase 3's amx run) on the SIMT engine and on the tile loop pinned,
    and the training backward's f32 GEMMs under amx at gemma_2b's full
    width over 4096 tokens through ``autodiff.raw_gemm`` (the gate's
    recompute; its dA with the B^T copy the rigid route needs, timed
    apart; the q/o dB; the k/v dB, unsplit on the rigid tile) against
    their plain versions and an f32 ``torch.matmul``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.geometry import RIGID_TILE, gemm_engine
    from repro_torch.kernels.rigid_gemm import (
        epilogue_pass_kernel, epilogue_pass_torch, rigid_accumulate_kernel,
        rigid_accumulate_torch, rigid_gemm_kernel, rigid_gemm_torch)

    gen = torch.Generator(device=dev).manual_seed(5)
    epi_full = Epilogue(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
                        activation="silu")
    for label, dt, tol in [("fp32", torch.float32, 1e-4),
                           ("bf16", torch.bfloat16, 1e-4),
                           ("int8", torch.int8, 0.0)]:
        for m, n, k in [(4, 300, 1000), (130, 257, 65), (100, 70, 130),
                        (520, 2056, 1032), (64, 64, 64), (4, 16384, 2048),
                        (16, 392, 1000), (130, 264, 520)]:
            eng = gemm_engine(dt, *RIGID_TILE[:2], n, k, m=m, rigid=True)
            if dt == torch.int8:
                a = torch.randint(-127, 128, (m, k), generator=gen,
                                  device=dev, dtype=dt)
                b = torch.randint(-127, 128, (k, n), generator=gen,
                                  device=dev, dtype=dt)
                check(f"rigid_gemm[{eng}] int8 {m}x{n}x{k}",
                      rigid_gemm_kernel(a, b, out_dtype=torch.int32),
                      rigid_gemm_torch(a, b, out_dtype=torch.int32), 0.0)
                continue
            a = (torch.randn(m, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(dt)
            b = torch.randn(k, n, generator=gen, device=dev).to(dt)
            c = torch.randn(m, n, generator=gen, device=dev)
            bias = torch.randn(n, generator=gen, device=dev)
            acc1 = rigid_accumulate_kernel(a, b)
            check(f"rigid_gemm[{eng}] {label} {m}x{n}x{k} (stage 1, f32 "
                  f"accumulator)", acc1, rigid_accumulate_torch(a, b), tol)
            if eng == "simt":
                require(torch.equal(acc1, rigid_accumulate_kernel(
                    a, b, engine="tile")), f"rigid_gemm_simt {m}x{n}x{k}: "
                    f"not bit-equal to the tile loop")
                log("    bit-equal to the tile loop")
            check(f"rigid_gemm[{eng}] {label} {m}x{n}x{k} (both stages)",
                  rigid_gemm_kernel(a, b, c, bias, epilogue=epi_full),
                  rigid_gemm_torch(a, b, c, bias, epilogue=epi_full), tol)

    kernel_of = {"wgmma": "rigid_gemm_wgmma", "simt": "rigid_gemm_simt",
                 "tile": "rigid_gemm"}

    def stage1(label, m, n, k, dt=torch.bfloat16, engine=None):
        """Stage 1 at one main-path shape: check (the f32 accumulator
        within 1e-4; on the SIMT engine bit-equal to the tile loop too)
        and time it; ``engine`` pins it.  Returns its operands and
        accumulator."""
        a = (torch.randn(m, k, generator=gen, device=dev)
             / math.sqrt(k)).to(dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        eng = engine or gemm_engine(dt, *RIGID_TILE[:2], n, k, m=m,
                                    rigid=True)
        kern = kernel_of[eng]
        run = lambda: rigid_accumulate_kernel(a, b, engine=eng)  # noqa
        plain = lambda: rigid_accumulate_torch(a, b)  # noqa: E731
        acc = run()
        shape = f"{label} {m}x{n}x{k}" + (" (tile loop)" if engine else "")
        err = check(f"{kern} main-path {shape} (stage 1, f32 accumulator)",
                    acc, plain(), 1e-4)
        if eng == "simt":
            require(torch.equal(acc, rigid_accumulate_kernel(
                a, b, engine="tile")), f"{kern} {shape}: not bit-equal to "
                f"the tile loop")
            log("    bit-equal to the tile loop")
        flops = 2.0 * m * n * k
        nbytes = a.element_size() * (m * k + k * n) + 4.0 * m * n
        peak = PEAK["bf16" if dt == torch.bfloat16 else "fp32"]
        row = {"kernel": kern, "shape": shape, "max_abs_err": err,
               "tol": 1e-4, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "library_ms": time_ms(lambda: torch.matmul(a, b))}
        rows.append(row)
        log(f"    {kern}: time {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, torch.matmul "
            f"{row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.2f}x)")
        return a, b, acc

    def pass_row(label, acc, epi, c=None, bias=None):
        """The epilogue pass at one main-path shape: check (bf16 out
        within 1e-2) and time it beside F.gelu on the same accumulator."""
        m, n = acc.shape
        run = lambda: epilogue_pass_kernel(  # noqa: E731
            acc, c, bias, epilogue=epi, out_dtype=torch.bfloat16)
        plain = lambda: epilogue_pass_torch(  # noqa: E731
            acc, c, bias, epilogue=epi, out_dtype=torch.bfloat16)
        err = check(f"epilogue_pass main-path {label} (stage 2)", run(),
                    plain(), 1e-2)
        # Element-wise operations: the tanh-gelu's 15, and alpha (1),
        # beta*C (2), the bias (1) and the softcap (3) where present.
        ops_per = (15 + 1 + 2 * (c is not None) + (bias is not None)
                   + 3 * (epi.softcap is not None))
        flops = float(ops_per * m * n)
        nbytes = (4.0 * m * n * (1 + (c is not None)) + 2.0 * m * n
                  + 4.0 * n * (bias is not None))
        row = {"kernel": "epilogue_pass", "shape": label,
               "max_abs_err": err, "tol": 1e-2, "ms": time_ms(run),
               "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, PEAK["fp32"]),
               "bound_by": bound_by(flops, nbytes, PEAK["fp32"]),
               "library_ms": time_ms(
                   lambda: F.gelu(acc, approximate="tanh"))}
        rows.append(row)
        log(f"    epilogue_pass: time {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, F.gelu {row['library_ms']:.4f} ms")

    # The gate projection of a 512-token prefill chunk, GeGLU's gelu on it
    # (the amx path's pass); the same with beta*C, a row bias and a
    # softcap; and the decode gate's pass (4 slots).
    m, n = 512, 16384
    a, b, acc = stage1("gate", m, n, 2048)
    epi = Epilogue(activation="gelu")
    pass_row("gelu 512x16384", acc, epi)
    check("rigid_gemm main-path gate 512x16384x2048 (both stages)",
          rigid_gemm_kernel(a, b, epilogue=epi, out_dtype=torch.bfloat16),
          rigid_gemm_torch(a, b, epilogue=epi, out_dtype=torch.bfloat16),
          2e-2)
    pass_row("beta*C+bias+softcap gelu 512x16384", acc,
             Epilogue(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
                      activation="gelu"),
             torch.randn(m, n, generator=gen, device=dev),
             torch.randn(n, generator=gen, device=dev))
    pass_row("gelu 4x16384", acc[:4].clone(), epi)
    stage1("rg gate", 512, 12288, 4096)
    stage1("decode gate", 4, 16384, 2048)
    stage1("gate fp32", 16, 256, 128, dt=torch.float32)  # phase 3's amx
    stage1("gate fp32", 16, 256, 128, dt=torch.float32, engine="tile")
    rigid_train_rows(dev, rows, gen)


def rigid_train_rows(dev, rows, gen):
    """The training backward's f32 GEMMs on the rigid route at gemma_2b's
    full width over 4096 tokens, each through ``autodiff.raw_gemm`` with
    ``policy="amx"`` (phase 7c's route): the gate's accumulator recompute
    (4096 x 16384 x 2048), the gate's dA (its B^T copied row-major first,
    the rigid tile reading a row-major B only; the copy timed apart), the
    q/o dB (2048 x 2048 x 4096) and the k/v dB (2048 x 256 x 4096: 32
    tiles of the unsplit rigid tile for 132 SMs).  Each must run the SIMT
    f32 engine; against its plain version (1e-4 x (1 + |ref|), relative
    Frobenius error 1e-5), warm and with the L2 cold, beside its bound and
    an f32 ``torch.matmul`` (the tile loop is too slow to time here)."""
    import torch
    from repro_torch.core.autotune import get_plan, plan_engine
    from repro_torch.kernels.autodiff import _transposed, raw_gemm
    from repro_torch.kernels.rigid_gemm import rigid_accumulate_torch

    tokens = 4096

    def row(label, x, y, transposed, lib, copy_ms=None):
        m, k = x.shape
        n = y.shape[0] if transposed else y.shape[1]
        plan = get_plan(m, n, k, torch.float32, torch.float32,
                        policy="amx")
        engine = plan_engine(plan.signature, plan.geometry)
        require(engine == "simt", f"amx {label} plans onto {engine}")
        run = lambda: raw_gemm(x, y, "amx",  # noqa: E731
                               transposed_b=transposed)
        yp = y.t().contiguous() if transposed else y
        plain = lambda: rigid_accumulate_torch(x, yp)  # noqa: E731
        shape = f"train amx {label} fp32 {m}x{n}x{k}"
        got, want = run(), plain()
        err = check(f"rigid_gemm_simt main-path {shape} [{plan.describe()}"
                    f", engine {engine}]", got, want, 1e-4)
        rel = _frobenius(got, want)
        log(f"    relative Frobenius error {rel:.3e} (tol 1e-5)")
        require(rel <= 1e-5, f"rigid_gemm_simt {shape}: relative error "
                f"{rel}")
        del got, want
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        r = {"kernel": "rigid_gemm_simt", "shape": shape, "engine": engine,
             "plan": plan.describe(), "max_abs_err": err, "tol": 1e-4,
             "rel_err": rel, "rel_tol": 1e-5,
             "ms": time_ms(run, iters=5), "cold_ms": time_ms_cold(run, 5),
             "plain_ms": time_ms(plain, iters=5),
             "bound_ms": bound_ms(flops, nbytes, PEAK["fp32"]),
             "bound_by": bound_by(flops, nbytes, PEAK["fp32"]),
             "library_ms": time_ms(lib, iters=5),
             "library_cold_ms": time_ms_cold(lib, 5),
             "library": "torch.matmul (f32)"}
        r["tflops"] = flops / r["ms"] / 1e9
        if copy_ms is not None:
            r["transpose_copy_ms"] = copy_ms
        rows.append(r)
        log(f"    time {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s; the "
            f"B^T copy included where there is one), L2 cold "
            f"{r['cold_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.matmul "
            f"f32 {r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x)"
            + (f"; the copy {copy_ms:.4f} ms" if copy_ms is not None
               else ""))

    for name, d_in, d_out in (("gate", 2048, 16384), ("q/o", 2048, 2048),
                              ("k/v", 2048, 256)):
        a = (torch.randn(tokens, d_in, generator=gen, device=dev)
             / math.sqrt(d_in))
        w = (torch.randn(d_in, d_out, generator=gen, device=dev)
             / math.sqrt(d_in))
        dacc = (torch.randn(tokens, d_out, generator=gen, device=dev)
                / math.sqrt(d_out))
        if name == "gate":
            row(f"{name} recompute", a, w, False,
                lambda: torch.matmul(a, w))
            row(f"{name} dA", dacc, w, True,
                lambda: torch.matmul(dacc, w.t()),
                time_ms(lambda: w.t().contiguous()))
        else:
            at = _transposed(a, torch.float32)
            row(f"{name} dB", at, dacc, False,
                lambda: torch.matmul(a.t(), dacc))
            del at
        del a, w, dacc


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
    """B4 on both of its engines against its plain version: small ragged
    cases (stale and unmapped pages, an empty row, window and softcap) in
    fp32 and int8 pages on the SIMT kernel and in bf16 on the mma engine,
    the mma engine at G 1/8/16 x D 64/128/256 over lengths 0, 1, 15, 16,
    17 and 1037; then the serving run's decode on the mma engine (also
    with the pages cold in L2 and at every cluster size) and the SIMT
    kernel's row at the reduced fp32 decode phase 3 gives it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.geometry import decode_engine, decode_kv_split
    from repro_torch.kernels.flash_decode import (flash_decode_paged_kernel,
                                                  flash_decode_paged_torch)
    from repro_torch.models.attention import _quantize_kv
    gen = torch.Generator(device=dev).manual_seed(2)

    def kernel_of(q, kp):
        g = q.shape[1] // kp.shape[2]
        return ("flash_decode_paged_mma"
                if decode_engine(kp.dtype, q.dtype, g, q.shape[2]) == "mma"
                else "flash_decode_paged")

    for label, dtype, tol in [("fp32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 1e-2)]:
        for kw in [{}, {"window": 6, "softcap": 5.0}]:
            q, kp, vp, table, lens = paged_inputs(
                dev, b=4, h=8, hkv=2, d=64, page=8, lens=[5, 17, 25, 0],
                dtype=dtype, gen=gen, stale=True)
            table[3] = -1         # an empty row: zeros out
            got = flash_decode_paged_kernel(q, kp, vp, table, lens, **kw)
            want = flash_decode_paged_torch(q, kp, vp, table, lens, **kw)
            name = kernel_of(q, kp)
            err = check(f"{name} {label} page 8 {kw or 'plain'}", got, want,
                        tol)
            rows.append({"kernel": name, "shape": f"{label} page 8 "
                         f"{kw or 'plain'}", "max_abs_err": err, "tol": tol})
            require(float(got[3].float().abs().max()) == 0.0,
                    f"{name}: an empty row must give zeros")
    q, kp, vp, table, lens = paged_inputs(
        dev, b=3, h=4, hkv=1, d=32, page=4, lens=[5, 17, 26],
        dtype=torch.float32, gen=gen)
    kq, ks = _quantize_kv(kp)
    vq, vs = _quantize_kv(vp)
    got = flash_decode_paged_kernel(q, kq, vq, table, lens, ks, vs)
    want = flash_decode_paged_torch(q, kq, vq, table, lens, ks, vs)
    err = check("flash_decode_paged int8 pages", got, want, 1e-5)
    rows.append({"kernel": "flash_decode_paged", "shape": "int8 pages",
                 "max_abs_err": err, "tol": 1e-5})
    # The mma engine at every G and D it takes, over two kv heads: lengths
    # 0, 1, 15, 16, 17 and 1037 (a stale page mapped in the empty row, an
    # unmapped page inside the long row), plain and windowed + softcapped.
    lens_mma = [0, 1, 15, 16, 17, 1037]
    for g in (1, 8, 16):
        for d in (64, 128, 256):
            q, kp, vp, table, lens = paged_inputs(
                dev, b=len(lens_mma), h=2 * g, hkv=2, d=d, page=16,
                lens=lens_mma, dtype=torch.bfloat16, gen=gen, stale=True)
            table[5, 3] = -1
            for kw in [{}, {"window": 40, "softcap": 30.0}]:
                got = flash_decode_paged_kernel(q, kp, vp, table, lens, **kw)
                want = flash_decode_paged_torch(q, kp, vp, table, lens,
                                                **kw)
                shape = f"G={g} D={d} {kw or 'plain'}"
                err = check(f"flash_decode_paged_mma {shape}", got, want,
                            1e-2)
                require(torch.equal(got, flash_decode_paged_kernel(
                    q, kp, vp, table, lens, **kw)),
                    "flash_decode_paged_mma: two calls differ")
                require(float(got[0].float().abs().max()) == 0.0,
                        "flash_decode_paged_mma: an empty row must give "
                        "zeros")
                rows.append({"kernel": "flash_decode_paged_mma",
                             "shape": shape, "max_abs_err": err,
                             "tol": 1e-2})

    def main_path(label, b, h, hkv, d, page, lens, dtype, tol, **kw):
        q, kp, vp, table, lens_t = paged_inputs(
            dev, b=b, h=h, hkv=hkv, d=d, page=page, lens=lens, dtype=dtype,
            gen=gen)
        name = kernel_of(q, kp)
        run = lambda: flash_decode_paged_kernel(  # noqa: E731
            q, kp, vp, table, lens_t, **kw)
        plain = lambda: flash_decode_paged_torch(  # noqa: E731
            q, kp, vp, table, lens_t, **kw)
        want = plain()
        got = run()
        err = check(f"{name} main-path {label}", got, want, tol)
        idx = table.clamp(min=0).long()
        kg = kp[idx].reshape(b, -1, hkv, d).permute(0, 2, 1, 3)
        vg = vp[idx].reshape(b, -1, hkv, d).permute(0, 2, 1, 3)
        pos = torch.arange(kg.shape[2], device=dev)[None]
        mask = ((pos < lens_t[:, None].long())
                & (table >= 0).repeat_interleave(page, 1))[:, None, None, :]
        qs = q[:, :, None, :]
        kx, vx = ((x.expand(b, h, -1, d) if hkv == 1
                   else x.repeat_interleave(h // hkv, 1)) for x in (kg, vg))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, kx, vx, attn_mask=mask, scale=kw.get("scale"))
        live = sum(lens)
        elt = q.element_size()
        flops = 4.0 * live * h * d
        nbytes = (elt * (2 * live * hkv * d + 2 * b * h * d)
                  + 4 * (table.numel() + b))
        peak = PEAK["bf16" if dtype == torch.bfloat16 else "fp32"]
        row = {"kernel": name, "shape": label, "max_abs_err": err,
               "tol": tol, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "cold_ms": time_ms_cold(run),
               **library_times(lib, kw)}
        if name == "flash_decode_paged_mma":
            require(torch.equal(got, run()), f"{name}: two calls differ")
            row["kv_split"] = decode_kv_split(
                b * hkv, table.shape[1],
                torch.cuda.get_device_properties(dev).multi_processor_count)
            row["ms_by_split"] = {}
            for s in (1, 2, 4, 8):
                pinned = lambda: flash_decode_paged_kernel(  # noqa: E731
                    q, kp, vp, table, lens_t, kv_split=s, **kw)
                err = max(err, check(f"{name} main-path {label} kv_split="
                                     f"{s}", pinned(), want, tol))
                row["ms_by_split"][s] = time_ms(pinned)
            row["max_abs_err"] = err
        rows.append(row)
        log_attention_row(row)

    # The serving run's decode: 4 slots, 8 query heads on 1 kv head,
    # D = 256, 16-token pages, ~1024-1048 cached tokens per slot (the mma
    # engine); gemma2_27b's global layers: 32 query heads on 16 kv heads
    # (G = 2), D = 128, ~4620 tokens, softcap 50 and the query scale
    # 144^-0.5; the reduced fp32 engine's: 2 slots, 4 heads on 1 kv head,
    # D = 32, 8-token pages (the SIMT kernel).
    main_path("4 slots x 8 heads x 256, ~1035 tokens", 4, 8, 1, 256, 16,
              [1030, 1041, 1024, 1047], torch.bfloat16, 1e-2)
    main_path("g2 4 slots x 32/16 heads x 128, ~4620 tokens, softcap 50",
              4, 32, 16, 128, 16, [4615, 4626, 4609, 4632], torch.bfloat16,
              1e-2, **GEMMA2_ATTN)
    # qwen15_4b: MHA (G = 1: one live row of the mma's 16), 20 heads of
    # 128, ~2060 cached tokens per slot.
    main_path("q 4 slots x 20/20 heads x 128, ~2060 tokens", 4, 20, 20,
              128, 16, [2054, 2065, 2048, 2071], torch.bfloat16, 1e-2)
    main_path("fp32 2 slots x 4 heads x 32, 40 tokens", 2, 4, 1, 32, 8,
              [37, 43], torch.float32, 1e-5)


def attention_phase(dev, rows):
    """B5 on both of its engines against its plain version: small ragged
    cases on the SIMT kernel (fp32, and bf16 at D = 16 and 32) and on the
    wgmma engine (bf16 at D = 64, 128 and 256: causal, GQA, window,
    softcap, Sq < Skv, ragged Skv, non-causal), then the serving run's
    prefill chunks on the wgmma engine, and the SIMT kernel at the same
    shape in fp32 for its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.geometry import attention_engine, \
        attention_kv_split
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
        ("GQA 8:1 D=256", (1, 8, 1, 130, 130, 256), {}),
        ("GQA 2:1 Sq<Skv D=128", (2, 4, 2, 100, 333, 128), {}),
        ("window D=64", (1, 2, 1, 128, 200, 64), {"window": 48}),
        ("softcap D=256", (1, 2, 2, 64, 130, 256), {"softcap": 20.0}),
        ("non-causal D=128", (1, 2, 1, 70, 90, 128), {"causal": False}),
    ]
    for label, dtype, tol in [("fp32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 1e-2)]:
        for name, shape, kw in cases:
            q, k, v = qkv(*shape, dtype)
            engine = attention_engine(dtype, shape[-1])
            kernel = "flash_attention_wgmma" if engine == "wgmma" \
                else "flash_attention"
            err = check(f"{kernel} {label} {name}",
                        flash_attention_kernel(q, k, v, **kw),
                        flash_attention_torch(q, k, v, **kw), tol)
            rows.append({"kernel": kernel, "shape": f"{label} {name}",
                         "max_abs_err": err, "tol": tol})

    def main_path(shape, b, h, hkv, sq, skv, d, dtype, cold=False,
                  rel_tol=None, **kw):
        q, k, v = qkv(b, h, hkv, sq, skv, d, dtype)
        simt = attention_engine(dtype, d) == "simt"
        kernel = "flash_attention" if simt else "flash_attention_wgmma"
        tol = 1e-5 if simt else 1e-2
        run = lambda: flash_attention_kernel(q, k, v, **kw)  # noqa: E731
        plain = lambda: flash_attention_torch(q, k, v, **kw)  # noqa: E731
        want = plain()

        def hold(label, got):
            err = check(label, got, want, tol)
            if rel_tol is not None:
                # The whole output in relative Frobenius error: the rows
                # far down a long sequence average many values, so an
                # elementwise bound alone would pass a wrong tile there.
                rel = _frobenius(got, want)
                log(f"    relative Frobenius error {rel:.3e} (tol "
                    f"{rel_tol:g})")
                require(rel <= rel_tol, f"{label}: relative error {rel}")
            return err

        err = hold(f"{kernel} main-path {shape}", run())
        by_split = {}
        if not simt:
            # Both kv splits, the planner's choice first: each held to the
            # plain version, each timed.
            chosen = attention_kv_split(b * h * (sq // 64), skv // 64)
            for split in (chosen, 3 - chosen):
                got = flash_attention_kernel(q, k, v, kv_split=split, **kw)
                err = max(err, hold(f"{kernel} main-path {shape} kv_split="
                                    f"{split}", got))
                by_split[split] = time_ms(
                    lambda: flash_attention_kernel(q, k, v, kv_split=split,
                                                   **kw))
        qp = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        mask = torch.arange(skv, device=dev)[None] <= qp
        kx, vx = ((x.expand(b, h, skv, d) if hkv == 1
                   else x.repeat_interleave(h // hkv, 1)) for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kx, vx, attn_mask=mask, scale=kw.get("scale"))
        visible = sq * (skv - sq) + sq * (sq + 1) // 2
        flops = 4.0 * b * h * d * visible
        elt = q.element_size()
        nbytes = elt * (2 * b * h * sq * d + 2 * b * hkv * skv * d)
        peak = PEAK["fp32" if simt else "bf16"]
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
               "tol": tol, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               **library_times(lib, kw, cold=cold)}
        if cold:
            row["cold_ms"] = time_ms_cold(run)
        if by_split:
            row["kv_split"] = chosen
            row["ms_by_kv_split"] = by_split
        rows.append(row)
        log_attention_row(row)

    # The serving run's prefill chunks: 512 queries x 8 heads against the
    # 512-token chunk itself and against 512 prefix + 512 chunk tokens, on
    # the wgmma engine (bf16); the SIMT kernel at the second shape in fp32;
    # gemma2_27b's global layers at the chunk past its 4096-token window:
    # 512 queries x 32 heads on 16 kv heads, D = 128, against 4608 tokens,
    # softcap 50 and the query scale 144^-0.5.
    for skv, dtype in ((512, torch.bfloat16), (1024, torch.bfloat16),
                       (1024, torch.float32)):
        fp32 = "fp32 " if dtype == torch.float32 else ""
        main_path(f"{fp32}512x{skv} H=8 D=256", 1, 8, 1, 512, skv, 256,
                  dtype)
    main_path("g2 512x4608 H=32/16 D=128 softcap 50", 1, 32, 16, 512, 4608,
              128, torch.bfloat16, cold=True, **GEMMA2_ATTN)
    # qwen15_4b's last prefill chunk of a 2048-token prompt: 512 queries x
    # 20 heads on 20 kv heads (MHA), D = 128, against 2048 tokens.
    main_path("q 512x2048 H=20/20 D=128", 1, 20, 20, 512, 2048, 128,
              torch.bfloat16, cold=True)
    # musicgen_medium's model-level prefill: 4 sequences of 1024 frames,
    # 24 heads on 24 kv heads (G = 1), D = 64, causal over the whole
    # sequence.
    main_path("mg 4x1024 H=24/24 D=64", 4, 24, 24, 1024, 1024, 64,
              torch.bfloat16, cold=True)
    # chameleon_34b's model-level prefill: 4 sequences of 1024 positions,
    # 64 heads on 8 kv heads (G = 8), D = 128, causal.
    main_path("ch 4x1024 H=64/8 D=128", 4, 64, 8, 1024, 1024, 128,
              torch.bfloat16, cold=True)
    # gemma_2b's training forward (phase 7): one sequence of 4096 tokens,
    # 8 heads on one kv head, D = 256, causal over the whole sequence.
    main_path("train 1x4096 H=8/1 D=256", 1, 8, 1, 4096, 4096, 256,
              torch.bfloat16, cold=True, rel_tol=1e-2)


def ring_decode_phase(dev, rows):
    """B6 on both of its engines against its plain version: small ragged
    cases (S = 37, not a multiple of the 16-slot tile; a wrapped ring, -1
    slots, window and softcap, an empty row) in fp32 on the SIMT kernel
    and in bf16 on the mma engine at G 1/4/9/16 x D 64/128/256, over the
    ring's strided view and over a contiguous cache; then the full-width
    decode of recurrentgemma_9b's local layers on the mma engine -- 4
    slots x 16 query heads on 1 kv head x D 256 over a wrapped 2048-slot
    bf16 ring, read through its (B, L, Hkv, D) storage --, gemma2_27b's
    (G = 2) and starcoder2_7b's (36 query heads on 4 kv heads, G = 9,
    D 128, a wrapped 4096-slot ring), each also with the
    cache cold in L2 and at every cluster size, and the SIMT kernel's row
    at the reduced fp32 decode phase 3 gives it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.geometry import decode_kv_split, flat_decode_engine
    from repro_torch.kernels.flash_decode import (flash_decode_kernel,
                                                  flash_decode_torch,
                                                  tma_strided)
    gen = torch.Generator(device=dev).manual_seed(7)

    def ring(b, length, hkv, d, q_pos, dtype, strided=True):
        k = torch.randn(b, length, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, length, hkv, d, generator=gen, device=dev)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
        idx = torch.arange(length, device=dev)
        kvp = qp[:, None] - (qp[:, None] - idx) % length
        kvp = torch.where(kvp >= 0, kvp, -1).to(torch.int32)
        k, v = (x.to(dtype).transpose(1, 2) for x in (k, v))
        if not strided:
            k, v = k.contiguous(), v.contiguous()
        return k, v, kvp, qp

    def kernel_of(q, k, v):
        g = q.shape[1] // k.shape[1]
        return ("flash_decode_mma"
                if flat_decode_engine(k.dtype, q.dtype, g, q.shape[2],
                                      tma_strided(k, v)) == "mma"
                else "flash_decode")

    def small(label, dtype, g, d, tol, strided=True):
        for kw in [{}, {"window": 9, "softcap": 5.0}]:
            k, v, kvp, qp = ring(4, 37, 2, d, [60, 20, 5, 36], dtype,
                                 strided)
            kvp[3] = -1                      # an empty row: zeros out
            q = torch.randn(4, 2 * g, d, generator=gen,
                            device=dev).to(dtype)
            got = flash_decode_kernel(q, k, v, kvp, qp, **kw)
            want = flash_decode_torch(q, k, v, kvp, qp, **kw)
            name = kernel_of(q, k, v)
            shape = f"{label} {kw or 'plain'}"
            err = check(f"{name} {shape}", got, want, tol)
            require(float(got[3].float().abs().max()) == 0.0,
                    f"{name}: an empty row must give zeros")
            if name == "flash_decode_mma":
                require(torch.equal(got, flash_decode_kernel(
                    q, k, v, kvp, qp, **kw)), f"{name}: two calls differ")
            rows.append({"kernel": name, "shape": shape, "max_abs_err": err,
                         "tol": tol})

    small("fp32 ring S=37 G=4 D=64", torch.float32, 4, 64, 1e-5)
    # G = 9 (starcoder2_7b's 36/4): rows 9-15 of the mma's A fragment are
    # padding, and G is no power of two.
    for g in (1, 4, 9, 16):
        for d in (64, 128, 256):
            small(f"ring S=37 G={g} D={d}", torch.bfloat16, g, d, 1e-2)
            small(f"contiguous S=37 G={g} D={d}", torch.bfloat16, g, d,
                  1e-2, strided=False)

    def main_path(label, b, h, hkv, d, length, q_pos, dtype, tol, window,
                  flat=False, **extra):
        k, v, kvp, qp = ring(b, length, hkv, d, q_pos, dtype)
        if flat:
            # A flat cache: slot j holds position j up to q_pos, -1 past it.
            idx = torch.arange(length, device=dev)
            kvp = torch.where(idx[None] <= qp[:, None], idx,
                              -1).to(torch.int32)
        q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
        name = kernel_of(q, k, v)
        kw = dict(window=window, **extra)
        run = lambda: flash_decode_kernel(  # noqa: E731
            q, k, v, kvp, qp, **kw)
        plain = lambda: flash_decode_torch(  # noqa: E731
            q, k, v, kvp, qp, **kw)
        want = plain()
        got = run()
        err = check(f"{name} main-path {label}", got, want, tol)
        kvl = kvp.long()[:, None, None, :]
        qpl = qp.long()[:, None, None, None]
        mask = (kvl >= 0) & (kvl <= qpl)
        if window is not None:
            mask = mask & (kvl > qpl - window)
        qs = q[:, :, None, :]
        kx, vx = ((x.expand(b, h, length, d) if hkv == 1
                   else x.repeat_interleave(h // hkv, 1)) for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, kx, vx, attn_mask=mask, scale=kw.get("scale"))
        visible = int(mask.sum())
        elt = q.element_size()
        flops = 4.0 * visible * h * d
        nbytes = (elt * (2 * visible * hkv * d + 2 * b * h * d)
                  + 4 * (kvp.numel() + b))
        peak = PEAK["bf16" if dtype == torch.bfloat16 else "fp32"]
        # The K/V bytes the mma engine loads: whole 16-slot tiles holding
        # a visible slot (it skips the others), beside the visible rows'.
        tiles = mask.reshape(b, -1)[:, :length // 16 * 16].reshape(
            b, -1, 16).any(-1)
        row = {"kernel": name, "shape": label, "max_abs_err": err,
               "tol": tol, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, peak),
               "bound_by": bound_by(flops, nbytes, peak),
               "kv_bytes_visible": elt * 2 * visible * hkv * d,
               "kv_bytes_loaded": elt * 2 * 16 * int(tiles.sum()) * hkv * d,
               "kv_bytes_all_slots": elt * 2 * b * length * hkv * d,
               "cold_ms": time_ms_cold(run),
               **library_times(lib, kw)}
        if name == "flash_decode_mma":
            require(torch.equal(got, run()), f"{name}: two calls differ")
            row["kv_split"] = decode_kv_split(
                b * hkv, -(-length // 16),
                torch.cuda.get_device_properties(dev).multi_processor_count)
            row["ms_by_split"] = {}
            for s in (1, 2, 4, 8):
                pinned = lambda: flash_decode_kernel(  # noqa: E731
                    q, k, v, kvp, qp, kv_split=s, **kw)
                err = max(err, check(f"{name} main-path {label} kv_split="
                                     f"{s}", pinned(), want, tol))
                row["ms_by_split"][s] = time_ms(pinned)
            row["max_abs_err"] = err
        rows.append(row)
        log_attention_row(row)
        return name

    # The serving run's decode of a local layer, positions past the wrap
    # (the mma engine); the reduced fp32 engine's: 2 slots, 4 heads on 1
    # kv head, D = 32 over a 16-slot ring (the SIMT kernel).
    require(main_path("ring 4x16x256 L=2048", 4, 16, 1, 256, 2048,
                      [2570, 2581, 2564, 2587], torch.bfloat16, 1e-2, 2048)
            == "flash_decode_mma",
            "the serving ring's decode must run on B6's mma engine")
    require(main_path("g2 ring 4x32/16x128 L=4096 softcap 50", 4, 32, 16,
                      128, 4096, [4614, 4625, 4608, 4631], torch.bfloat16,
                      1e-2, 4096, **GEMMA2_ATTN) == "flash_decode_mma",
            "gemma2_27b's ring decode must run on B6's mma engine")
    require(main_path("s2 ring 4x36/4x128 L=4096", 4, 36, 4, 128, 4096,
                      [4614, 4625, 4608, 4631], torch.bfloat16, 1e-2, 4096)
            == "flash_decode_mma",
            "starcoder2_7b's ring decode (G = 9) must run on B6's mma "
            "engine")
    # musicgen_medium's model-level decode over its flat 2048-slot caches:
    # 4 sequences x 24 heads on 24 kv heads (G = 1), D = 64, the slots past
    # each row's position masked (-1), whole KV slices of them at cluster
    # sizes past 2; at positions 1024 and 1087 (the first and the last of
    # phase 6's decode steps) and at a ragged tail.
    for label, q_pos in (("pos 1024", [1024] * 4), ("pos 1087", [1087] * 4),
                         ("ragged", [1024, 1045, 1066, 1087])):
        require(main_path(f"mg flat 4x24/24x64 L=2048 {label}", 4, 24, 24,
                          64, 2048, q_pos, torch.bfloat16, 1e-2, None,
                          flat=True) == "flash_decode_mma",
                "musicgen_medium's flat-cache decode must run on B6's mma "
                "engine")
    # chameleon_34b's model-level decode over its flat 1088-slot caches:
    # 4 sequences x 64 heads on 8 kv heads (G = 8), D = 128, at the last of
    # phase 6's decode steps (position 1087: every slot visible).
    require(main_path("ch flat 4x64/8x128 L=1088 pos 1087", 4, 64, 8, 128,
                      1088, [1087] * 4, torch.bfloat16, 1e-2, None,
                      flat=True) == "flash_decode_mma",
            "chameleon_34b's flat-cache decode must run on B6's mma engine")
    require(main_path("fp32 ring 2x4x32 L=16", 2, 4, 1, 32, 16, [37, 20],
                      torch.float32, 1e-5, 16) == "flash_decode",
            "fp32 ring decode must run on B6's SIMT kernel")


def rglru_phase(dev, rows):
    """B7 on both of its engines against its plain version, bit for bit,
    from zero and from a random h0: ragged S (not a multiple of the staged
    engine's 64-step span) at W = 48, a partial last slab (W = 4100), W
    not a multiple of 4 (4098: the direct engine by choice) and S = 4096
    (a 4096-token chunk); then the serving prefill's (1, 512, 4096) f32
    from h0 (a resumed chunk): the staged engine warm and with the L2
    cold, the direct engine beside it, the staged engine at a 4096-token chunk, and
    the direct engine's own row at the (1, 8, 126) chunk phase 3 gives
    it.  No single PyTorch call computes
    this recurrence, so it has no library time."""
    import torch
    from repro_torch.core.geometry import scan_engine
    from repro_torch.kernels.rglru_scan import (rglru_scan_kernel,
                                                rglru_scan_torch)
    gen = torch.Generator(device=dev).manual_seed(8)

    def inputs(b, s, w):
        a = torch.rand(b, s, w, generator=gen, device=dev) * 0.5 + 0.5
        return (a, torch.randn(b, s, w, generator=gen, device=dev),
                torch.randn(b, w, generator=gen, device=dev))

    def variants(b, s, w):
        """(counter, engine) of every engine that can run the shape."""
        out = [("rglru_scan", "direct")]
        if scan_engine(torch.float32, b, s, w) == "staged":
            out.append(("rglru_scan_staged", "staged"))
        return out

    for b, s, w in [(2, 1, 48), (2, 63, 48), (3, 100, 48), (1, 70, 4100),
                    (1, 70, 4098), (1, 4096, 4096)]:
        a, x, h0 = inputs(b, s, w)
        for h in (None, h0):
            want = rglru_scan_torch(a, x, h)
            start = "none" if h is None else "random"
            for name, engine in variants(b, s, w):
                got = rglru_scan_kernel(a, x, h, engine=engine)
                check(f"{name} {b}x{s}x{w} h0={start}", got, want, 0.0)

    def timed_row(name, shape, a, x, h, cold, **kw):
        run = lambda: rglru_scan_kernel(a, x, h, **kw)  # noqa: E731
        plain = lambda: rglru_scan_torch(a, x, h)  # noqa: E731
        err = check(f"{name} main-path {shape} f32", run(), plain(), 0.0)
        flops = 2.0 * a.numel()
        nbytes = 12.0 * a.numel() + (4.0 * h.numel() if h is not None
                                     else 0.0)
        row = {"kernel": name, "shape": shape, "max_abs_err": err,
               "tol": 0.0, "ms": time_ms(run), "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(flops, nbytes, PEAK["fp32"]),
               "bound_by": bound_by(flops, nbytes, PEAK["fp32"]),
               "library_ms": None}
        if cold:
            row["cold_ms"] = time_ms_cold(run)
        rows.append(row)
        return row

    a, x, h0 = inputs(1, 512, 4096)
    require(scan_engine(a.dtype, 1, 512, 4096) == "staged",
            "the serving chunk's scan must run on B7's staged engine")
    row = timed_row("rglru_scan_staged", "1x512x4096", a, x, h0, True)
    direct = timed_row("rglru_scan", "1x512x4096", a, x, h0, True,
                       engine="direct")
    log(f"    staged: time {row['ms']:.4f} ms, L2 cold "
        f"{row['cold_ms']:.4f} ms; direct {direct['ms']:.4f} ms (cold "
        f"{direct['cold_ms']:.4f}); bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library none "
        f"(no single PyTorch call computes the recurrence)")
    # A 4096-token chunk: long enough that bytes, not the chain of S
    # dependent multiply-adds per channel, set the staged engine's time.
    a, x, h0 = inputs(1, 4096, 4096)
    long = timed_row("rglru_scan_staged", "1x4096x4096", a, x, h0, True)
    log(f"    staged at 1x4096x4096: time {long['ms']:.4f} ms, L2 cold "
        f"{long['cold_ms']:.4f} ms, bound {long['bound_ms']:.4f} ms")
    a, x, h0 = inputs(1, 8, 126)
    require(scan_engine(a.dtype, 1, 8, 126) == "direct",
            "W = 126 must run on B7's direct engine")
    small = timed_row("rglru_scan", "1x8x126", a, x, h0, False)
    log(f"    direct at 1x8x126: time {small['ms']:.4f} ms, bound "
        f"{small['bound_ms']:.4f} ms, plain {small['plain_ms']:.4f} ms")


# -- phase 3: the whole path on the card against the CPU -----------------------

# The configurations phase 3 and phase 4 serve, each (arch, overrides):
# gemma_2b in the port's defaults (the JAX package's kernel
# configuration: graph programs + the grouped decode q/k/v), under the
# rigid AMX-style baseline and on slice 1's eager path; recurrentgemma_9b
# in the defaults (its weights built in bf16: in f32 they would take 37.6
# GB before the engine's cast).
CONFIGS = {
    "default": ("gemma_2b", {}),
    "amx": ("gemma_2b", {"gemm_policy": "amx"}),
    "eager": ("gemma_2b", {"use_graph": False}),
    "recurrentgemma": ("recurrentgemma_9b", {"param_dtype": "bfloat16"}),
    "gemma2": ("gemma2_27b", {"param_dtype": "bfloat16"}),
    "qwen": ("qwen15_4b", {"param_dtype": "bfloat16"}),
    "starcoder2": ("starcoder2_7b", {"param_dtype": "bfloat16"}),
    "int8": ("gemma_2b", {}),
    "amx-int8": ("gemma_2b", {"gemm_policy": "amx"}),
    "granite": ("granite_moe_1b", {}),
    "mamba2": ("mamba2_130m", {}),
}
# Engine arguments of a configuration: ``int8`` serves gemma_2b under the
# engine's ``format_policy="int8"`` (its f32 weights quantized at every
# call, as the JAX engine serves them), ``amx-int8`` the same under the
# rigid baseline.
ENGINE_KW = {"int8": {"format_policy": "int8"},
             "amx-int8": {"format_policy": "int8"}}
# Kernels each configuration's main path must launch.
PATH_KERNELS = {
    "default": ("mte_gemm_wgmma", "splitk_gemm_cluster", "grouped_gemm_splitk",
                "flash_decode_paged_mma", "flash_attention_wgmma"),
    "amx": ("rigid_gemm_wgmma", "epilogue_pass", "flash_decode_paged_mma",
            "flash_attention_wgmma"),
    "eager": ("mte_gemm_wgmma", "splitk_gemm_cluster",
              "flash_decode_paged_mma", "flash_attention_wgmma"),
    "recurrentgemma": ("mte_gemm_wgmma", "splitk_gemm_cluster",
                       "grouped_gemm_splitk", "flash_decode_mma",
                       "rglru_scan_staged"),
    "gemma2": ("mte_gemm_wgmma", "splitk_gemm_cluster", "grouped_gemm_splitk",
               "flash_decode_paged_mma", "flash_decode_mma",
               "flash_attention_wgmma"),
    "qwen": ("mte_gemm_wgmma", "splitk_gemm_cluster", "grouped_gemm_splitk",
             "flash_decode_paged_mma", "flash_attention_wgmma"),
    "starcoder2": ("mte_gemm_wgmma", "splitk_gemm_cluster",
                   "grouped_gemm_splitk", "flash_decode_mma"),
    "int8": ("mte_gemm_wgmma_s8", "splitk_gemm_cluster_s8",
             "grouped_gemm_splitk_s8", "flash_decode_paged_mma",
             "flash_attention_wgmma"),
    "amx-int8": ("rigid_gemm_wgmma_s8", "flash_decode_paged_mma",
                 "flash_attention_wgmma"),
    "granite": ("mte_gemm_wgmma_s8", "splitk_gemm_cluster_s8",
                "grouped_gemm_splitk_s8", "grouped_gemm_wgmma_s8",
                "flash_decode_paged_mma", "flash_attention_wgmma"),
    # mamba2: none.  Its SSD block is plain PyTorch (the JAX package
    # computes it in plain jnp, in no Pallas kernel), so no counter may
    # move: a configuration absent from NOT_ON_PATH holds every counter
    # at 0.
    "mamba2": (),
}
# Counters that must stay 0 at full width: every bf16 B1 launch (all of
# them prefill projections) and every bf16 B8 stage-1 launch runs on the
# wgmma engine, every decode GEMM on B2's cluster engine, every decode
# q/k/v group on B3's split-K engine, every paged decode attention on B4's
# mma engine, every prefill attention on B5's wgmma engine, every ring
# decode attention on B6's mma engine, every prefill scan on B7's staged
# engine -- not on the tile loops, the SIMT kernels or B7's direct engine.
NOT_ON_PATH = {
    "default": ("mte_gemm", "splitk_gemm", "grouped_gemm",
                "grouped_gemm_simt", "flash_decode_paged",
                "flash_attention"),
    "amx": ("rigid_gemm", "rigid_gemm_simt", "flash_decode_paged",
            "flash_attention"),
    "eager": ("mte_gemm", "splitk_gemm", "flash_decode_paged",
              "flash_attention"),
    "recurrentgemma": ("mte_gemm", "splitk_gemm", "grouped_gemm",
                       "grouped_gemm_simt", "flash_decode", "rglru_scan"),
    "gemma2": ("mte_gemm", "splitk_gemm", "grouped_gemm",
               "grouped_gemm_simt", "flash_decode_paged", "flash_decode",
               "flash_attention"),
    "qwen": ("mte_gemm", "splitk_gemm", "grouped_gemm", "grouped_gemm_simt",
             "flash_decode_paged", "flash_attention"),
    "starcoder2": ("mte_gemm", "splitk_gemm", "grouped_gemm",
                   "grouped_gemm_simt", "flash_decode"),
    # int8: no bf16 or f32 engine runs, and no int8 tile loop: the
    # prefill projections run B1's s8 entry (CHUNK_LAUNCHES), the decode
    # step's 4-row GEMMs B2's and B3's cluster s8 entries
    # (DECODE_STEP_LAUNCHES).
    "int8": ("mte_gemm", "mte_gemm_wgmma", "mte_gemm_simt", "splitk_gemm",
             "splitk_gemm_cluster", "splitk_gemm_simt", "grouped_gemm",
             "grouped_gemm_splitk", "grouped_gemm_wgmma",
             "grouped_gemm_simt", "flash_decode_paged", "flash_attention"),
    # amx-int8: every projection, prefill and decode, on B8's s8 entry;
    # no other stage-1 engine, no epilogue pass (int8's epilogue runs
    # after the dequantize), no B1, B2 or B3 launch.
    "amx-int8": ("rigid_gemm", "rigid_gemm_wgmma", "rigid_gemm_simt",
                 "epilogue_pass", "mte_gemm", "mte_gemm_wgmma",
                 "mte_gemm_wgmma_s8", "mte_gemm_simt", "splitk_gemm",
                 "splitk_gemm_cluster", "splitk_gemm_cluster_s8",
                 "splitk_gemm_simt", "grouped_gemm", "grouped_gemm_splitk",
                 "grouped_gemm_splitk_s8", "grouped_gemm_wgmma",
                 "grouped_gemm_wgmma_s8", "grouped_gemm_simt",
                 "flash_decode_paged", "flash_attention"),
    # granite (its published int8): no tile loop, no SIMT kernel and no
    # bf16 or f32 GEMM engine; the experts run B3's s8 entries, the
    # prefill projections B1's, the decode o B2's.
    "granite": ("mte_gemm", "mte_gemm_wgmma", "mte_gemm_simt",
                "splitk_gemm", "splitk_gemm_cluster", "splitk_gemm_simt",
                "grouped_gemm", "grouped_gemm_splitk", "grouped_gemm_wgmma",
                "grouped_gemm_simt", "rigid_gemm", "rigid_gemm_wgmma",
                "rigid_gemm_simt", "rigid_gemm_wgmma_s8", "epilogue_pass",
                "flash_decode_paged", "flash_attention"),
}
# Launches per profiled prefill chunk of the int8 configurations: every
# projection of gemma_2b's 18 layers (q, k, v, o, gate, up, down) on the
# s8 engine (B1's, or B8's under amx), none on an int8 tile loop.
CHUNK_LAUNCHES = {
    "int8": {"mte_gemm_wgmma_s8": 18 * 7, "mte_gemm": 0, "splitk_gemm": 0,
             "grouped_gemm": 0, "grouped_gemm_wgmma_s8": 0},
    "amx-int8": {"rigid_gemm_wgmma_s8": 18 * 7, "rigid_gemm": 0,
                 "mte_gemm_wgmma_s8": 0, "epilogue_pass": 0},
    # granite: q, k, v and o of its 24 layers on B1's s8 entry, the
    # experts' gate, up and down (C = 160 for 512 tokens) on B3's.
    "granite": {"mte_gemm_wgmma_s8": 24 * 4, "grouped_gemm_wgmma_s8": 24 * 3,
                "mte_gemm": 0, "splitk_gemm": 0, "grouped_gemm": 0},
}
# Launches of the new engines per profiled decode step: gemma_2b's 18
# layers run B2 on o, gate, up and down (and on q, k, v on the eager path)
# and B4 once; recurrentgemma_9b's decode GEMMs make 256 B2 launches and
# its 12 local layers 12 B6 launches; gemma2_27b's 46 layers run B2 on o,
# gate, up and down, and its 23 global layers B4 once each and its 23
# local layers B6 once each; qwen15_4b's 40 layers run B2 (bf16acc) on o,
# gate, up and down and B4 once each; starcoder2_7b's 32 local layers run
# B2 on o, up and down (the plain MLP has no gate), B3 on the q/k/v group
# and B6 once each; under int8 gemma_2b's 18 layers run B2's s8 entry on
# o, gate, up and down and B4 once each, and under amx x int8 B8's s8
# entry on all seven projections (amx does not group the q/k/v) and B4
# once each.
DECODE_STEP_LAUNCHES = {
    "default": {"splitk_gemm_cluster": 72, "flash_decode_paged_mma": 18},
    "amx": {"flash_decode_paged_mma": 18},
    "eager": {"splitk_gemm_cluster": 126, "flash_decode_paged_mma": 18},
    "recurrentgemma": {"splitk_gemm_cluster": 256, "flash_decode_mma": 12},
    "gemma2": {"splitk_gemm_cluster": 184, "flash_decode_paged_mma": 23,
               "flash_decode_mma": 23},
    "qwen": {"splitk_gemm_cluster": 160, "flash_decode_paged_mma": 40},
    "starcoder2": {"splitk_gemm_cluster": 96, "grouped_gemm_splitk": 32,
                   "flash_decode_mma": 32},
    "int8": {"splitk_gemm_cluster_s8": 72, "flash_decode_paged_mma": 18},
    "amx-int8": {"rigid_gemm_wgmma_s8": 126, "flash_decode_paged_mma": 18},
    # granite: B3's s8 entry on the q/k/v group and the experts' gate, up
    # and down (C = 8 for 4 slots) of its 24 layers, B2's on o, B4 once.
    "granite": {"grouped_gemm_splitk_s8": 24 * 4,
                "splitk_gemm_cluster_s8": 24, "flash_decode_paged_mma": 24},
    "mamba2": {},
}
# The counter of the decode step's grouped q/k/v where it is not B3's
# bf16 split-K entry: int8 groups of 4 rows run its s8 entry.  A MoE
# layer's three expert GEMMs at C = 8 run on the same entry.
DECODE_QKV_KERNEL = {"int8": "grouped_gemm_splitk_s8",
                     "granite": "grouped_gemm_splitk_s8"}
# Phase 4's workload per arch: 4 slots, 16-token pages, 512-token prefill
# chunks, 6 requests x 24 greedy tokens.  gemma_2b: 1024-token prompts, two
# sharing their first chunk (the prefix cache).  recurrentgemma_9b:
# 2560-token prompts, so the 2048-slot ring wraps in prefill (the chunk
# at 2048) and in decode; no prefix cache (stateful layers).
# gemma2_27b: 4608-token prompts, so its 4096-slot rings wrap in prefill
# (the chunk at 4096) and in decode while its global layers see every
# token; no prefix cache (the rings).  qwen15_4b: 2048-token prompts, two
# sharing their first chunk (the prefix cache).  starcoder2_7b: 4608-token
# prompts, so its 4096-slot rings (every layer local) wrap in prefill (the
# chunk at 4096) and in decode; no prefix cache (the rings).  ``decode``
# and ``pos0`` place the profiled decode step and prefill chunk.
WORKLOADS = {
    "gemma_2b": dict(prefill_len=1024, cache_len=1088, shared=512,
                     decode=[1030, 1041, 1024, 1047], pos0=512),
    "recurrentgemma_9b": dict(prefill_len=2560, cache_len=2592, shared=0,
                              decode=[2570, 2581, 2564, 2587], pos0=2048),
    "gemma2_27b": dict(prefill_len=4608, cache_len=4672, shared=0,
                       decode=[4614, 4625, 4608, 4631], pos0=4096),
    "qwen15_4b": dict(prefill_len=2048, cache_len=2112, shared=512,
                      decode=[2054, 2065, 2048, 2071], pos0=1536),
    "starcoder2_7b": dict(prefill_len=4608, cache_len=4672, shared=0,
                          decode=[4614, 4625, 4608, 4631], pos0=4096),
    "granite_moe_1b": dict(prefill_len=1024, cache_len=1088, shared=512,
                           decode=[1030, 1041, 1024, 1047], pos0=512),
    # mamba2_130m: 4096-token prompts, so each prompt's SSD state and conv
    # ring resume over 8 chunks; no prefix cache (stateful layers).
    "mamba2_130m": dict(prefill_len=4096, cache_len=4160, shared=0,
                        decode=[4102, 4113, 4096, 4119], pos0=3584),
}


def free_card():
    """Give back what a dropped engine held (its weights, caches and
    graph pools) before the next one is built: no two full-width trees
    are ever alive at once."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def memory_reckoning(eng):
    """The bytes the engine keeps on the card, by item (each tensor once):
    its weights at the width it serves them (a MoE layer's router and
    experts apart), the stacked decode q/k/v
    (``engine._stack_decode_qkv``), the LM head's f32 copy
    (``serving_params``), the global layers' paged KV, the local layers'
    rings, the RG-LRU and SSD rows and the draft's cache; in GB (1e9
    bytes)."""
    import torch
    seen = set()

    def size(tree):
        if isinstance(tree, torch.Tensor):
            key = (tree.data_ptr(), tree.numel())
            if key in seen:
                return 0
            seen.add(key)
            return tree.numel() * tree.element_size()
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(size(v) for v in tree)
        return 0

    params = eng.params
    items = {
        "lm_head_f32": size(params["embedding"]["unembed"]),
        "decode_qkv_stack": size([lp["mixer"].get("qkv")
                                  for lp in params["layers"]]),
        # A MoE layer's router and all its experts (held whole: the
        # capacity buffer runs every expert).
        "moe_router_experts": size([lp["ffn"] for lp in params["layers"]
                                    if "router" in lp.get("ffn", {})]),
        "weights": size(params),
    }
    kinds = [mixer for mixer, _ in eng.cfg.layer_kinds]
    layers = eng.cache["layers"]
    for item, kind in (("paged_kv", "attn"), ("rings", "local"),
                       ("rglru_state", "rglru"), ("ssd_state", "ssd")):
        items[item] = size([c for c, m in zip(layers, kinds) if m == kind])
    if getattr(eng, "draft_cache", None) is not None:
        items["draft_cache"] = size(eng.draft_cache)
    gb = {k: v / 1e9 for k, v in items.items() if v}
    gb["total"] = sum(gb.values())
    gb["total_gib"] = sum(items.values()) / 2**30
    return gb


def reset_planning():
    """A fresh plan cache and program memo, so each configuration's plans
    and programs are its own."""
    from repro_torch.core import autotune
    from repro_torch.graph import schedule
    autotune.reset_cache()
    schedule.reset_programs()


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def reduced_phase(dev):
    """gemma_2b.reduced() in fp32, card against CPU, in the default and
    ``amx`` configurations; returns the card's launch counts of each
    engine run (keys ``reduced-default``, ``reduced-amx``): fp32 runs B2
    and B3 on their tile loops at C <= 16 and B8 stage 1 on the SIMT f32
    engine, whose launches count here."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    base = get_config("gemma_2b").reduced()       # fp32
    params_cpu = model_lib.init_params(base, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, dev)
    rng = np.random.default_rng(0)
    head = rng.integers(0, base.vocab, 24, dtype=np.int32)
    prompts = [np.concatenate([head, rng.integers(0, base.vocab, 8,
                                                  dtype=np.int32)])
               for _ in range(3)] + [rng.integers(0, base.vocab, 20,
                                                  dtype=np.int32)]
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=16)

    path_counts = {}
    for name in ("default", "amx"):
        cfg = dataclasses.replace(base, **CONFIGS[name][1])
        reset_planning()
        # First-token logits of one prompt through both chunks.
        logits = {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            cache = model_lib.init_paged_cache(cfg, 1, 64, num_pages=9,
                                               page_size=8, device=device)
            table = torch.arange(1, 9, dtype=torch.int32,
                                 device=device)[None]
            toks = torch.as_tensor(prompts[0].astype(np.int64),
                                   device=device)
            for p0 in (0, 16):
                out, cache = model_lib.prefill_chunk(
                    params, {"tokens": toks[None, p0:p0 + 16],
                             "page_table": table}, cache, cfg, pos0=p0)
            logits[str(device)] = out.cpu()
        err = max_err(logits[str(dev)], logits["cpu"])
        log(f"  reduced fp32 [{name}] first-token logits cuda vs cpu: "
            f"max_abs_err={err:.3e} tol=1e-3")
        require(err <= 1e-3, f"[{name}] first-token logits differ by {err}")

        outs = {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            # The card in the engine's defaults (async, the decode step as
            # a CUDA graph), the CPU synchronous and eager.
            eng = ServingEngine(params, cfg, device=device,
                                async_steps=device == dev, **kw)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
            build.reset_launch_counts()
            outs[str(device)] = eng.run()
            counts = build.launch_counts()
            log(f"  reduced engine [{name}] on {device}: "
                f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
                f"launches {counts}; steps_in_flight_max "
                f"{eng.steps_in_flight_max}, graphs "
                f"{sorted(eng.decode_step.graphs)}")
            if device == dev:
                require(eng.decode_step.graph and eng.decode_step.graphs,
                        f"[{name}] the card's decode step was not replayed "
                        f"as a CUDA graph")
                path_counts[f"reduced-{name}"] = counts
                marks = (("splitk_gemm", "grouped_gemm",
                          "flash_decode_paged", "flash_attention")
                         if name == "default" else ("rigid_gemm_simt",))
                for mark in marks:
                    require(counts[mark] > 0,
                            f"[{name}] {mark} not launched on the card")
        for rid in outs["cpu"]:
            require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
            require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                    f"[{name}] greedy stream of request {rid} differs")
        log(f"  reduced engine [{name}]: greedy streams identical on cuda "
            f"(async + graph) and cpu (synchronous, eager)")
        if name == "default":
            path_counts["reduced-spec"] = reduced_spec_check(
                dev, f"[{name}]", cfg, params_cpu, params_gpu, prompts, kw,
                outs["cpu"])
            # 5 slots x spec_k=4: verify windows of 20 rows, past the 16
            # one launch of B2's and B3's split-K engines takes, run in
            # row chunks on the decode step's plans.
            kw5 = dict(kw, slots=5)
            eng = ServingEngine(params_cpu, cfg, device="cpu", **kw5)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
            path_counts["reduced-spec-5slots"] = reduced_spec_check(
                dev, f"[{name}] 5 slots", cfg, params_cpu, params_gpu,
                prompts, kw5, eng.run(), want_k=SPEC_K)

    # B1's SIMT f32 engine runs the fp32 GEMMs past 16 rows: one
    # 4096-token chunk through the reduced model on the eager path (every
    # projection, 4096 x {32, 128, 256} x {128, 256}, is planned onto it
    # unsplit, at 128 x 64).
    cfg = dataclasses.replace(base, **CONFIGS["eager"][1])
    reset_planning()
    toks_np = rng.integers(0, base.vocab, 4096).astype(np.int64)
    logits = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 1, 4096, num_pages=257,
                                           page_size=16, device=device)
        table = torch.arange(1, 257, dtype=torch.int32, device=device)[None]
        toks = torch.as_tensor(toks_np, device=device)
        build.reset_launch_counts()
        out, _ = model_lib.prefill_chunk(
            params, {"tokens": toks[None], "page_table": table}, cache, cfg,
            pos0=0)
        logits[str(device)] = out.cpu()
        if device == dev:
            path_counts["reduced-long-prefill"] = counts = \
                build.launch_counts()
            log(f"  reduced fp32 [eager] one 4096-token chunk on {device}: "
                f"launches {counts}")
            require(counts["mte_gemm_simt"] > 0, "the 4096-token chunk did "
                    "not launch B1's SIMT f32 engine")
            require(counts["mte_gemm"] == 0, "the 4096-token chunk ran "
                    "B1's tile loop")
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced fp32 [eager] 4096-token chunk logits cuda vs cpu: "
        f"max_abs_err={err:.3e} tol=1e-3")
    require(err <= 1e-3, f"4096-token chunk logits differ by {err}")
    return path_counts


# Phase 3's reduced int8 engines: (name, gemm_policy, counters the card's
# run must launch, counters it must not).  Under amx every GEMM is B8's
# stage 1 on the s8 engine (every reduced width is a multiple of 16): no
# tile loop, no B1, B2 or B3 launch.
REDUCED_INT8 = [
    ("int8", "mte", ("mte_gemm_wgmma_s8", "grouped_gemm_wgmma_s8",
                     "splitk_gemm_cluster_s8", "grouped_gemm_splitk_s8"),
     ()),
    ("amx-int8", "amx", ("rigid_gemm_wgmma_s8",),
     ("rigid_gemm", "rigid_gemm_wgmma", "epilogue_pass", "mte_gemm",
      "mte_gemm_wgmma_s8", "splitk_gemm", "splitk_gemm_cluster_s8",
      "grouped_gemm", "grouped_gemm_wgmma_s8", "grouped_gemm_splitk_s8")),
]


def reduced_int8_phase(dev):
    """gemma_2b.reduced() under ``format_policy="int8"`` (fp32 compute),
    card against CPU, with 64-row prefill chunks, so that the s8 engine's
    tiles are offered, in two configurations.  ``int8`` (MTE): the
    prefill q/k/v run as one group on B3's s8 entry and the MLP on B1's;
    in the 2-row decode steps the q/k/v and gate+up groups run B3's
    split-K s8 entry, the down B2's cluster s8 entry and the o (unsplit)
    B1's int8 tile loop.  ``amx-int8`` (``gemm_policy="amx"``): every
    projection, prefill and decode, is one launch of B8's stage 1 on the
    s8 engine at the rigid tile.  Quantize, the int32 sums and the
    dequantize are exact on both devices: first-token logits within 2e-2
    (the f32 arithmetic around the GEMMs differs in summation order,
    which can move a quantized value by one step) and identical greedy
    streams from the card's engine in its defaults and the CPU's
    synchronous eager one.  Returns the card's launch counts
    (``reduced-int8``, ``reduced-amx-int8``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    fp32 = get_config("gemma_2b").reduced()       # fp32 compute
    params_cpu = model_lib.init_params(fp32, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, fp32.vocab, 128, dtype=np.int32)
               for _ in range(3)] + [rng.integers(0, fp32.vocab, 96,
                                                  dtype=np.int32)]
    kw = dict(slots=2, cache_len=192, prefill_len=128, page_size=16,
              prefill_chunk=64, format_policy="int8")
    path_counts = {}
    for name, policy, marks, off in REDUCED_INT8:
        base = dataclasses.replace(fp32, gemm_policy=policy)
        cfg = dataclasses.replace(base, format_policy="int8")
        reset_planning()
        logits = {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            cache = model_lib.init_paged_cache(cfg, 1, 128, num_pages=9,
                                               page_size=16, device=device)
            table = torch.arange(1, 9, dtype=torch.int32,
                                 device=device)[None]
            toks = torch.as_tensor(prompts[0].astype(np.int64),
                                   device=device)
            for p0 in (0, 64):
                out, cache = model_lib.prefill_chunk(
                    params, {"tokens": toks[None, p0:p0 + 64],
                             "page_table": table}, cache, cfg, pos0=p0)
            logits[str(device)] = out.cpu()
        check(f"reduced [{name}] first-token logits cuda vs cpu",
              logits[str(dev)], logits["cpu"], 2e-2)
        outs, counts = {}, {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            reset_planning()
            eng = ServingEngine(params, base, device=device,
                                async_steps=device == dev, **kw)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
            build.reset_launch_counts()
            outs[str(device)] = eng.run()
            if device == dev:
                counts = build.launch_counts()
                require(eng.decode_step.graph and eng.decode_step.graphs,
                        f"[{name}] the card's decode step was not replayed "
                        f"as a CUDA graph")
            log(f"  reduced engine [{name}] on {device}: "
                f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
                f"launches {build.launch_counts()}")
        for mark in marks:
            require(counts[mark] > 0,
                    f"[{name}] {mark} not launched on the card")
        for mark in off:
            require(counts[mark] == 0, f"[{name}] {counts[mark]} launches "
                    f"of {mark} on the card")
        for rid in outs["cpu"]:
            require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
            require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                    f"[{name}] greedy stream of request {rid} differs")
        log(f"  reduced engine [{name}]: greedy streams identical on cuda "
            f"(async + graph) and cpu (synchronous, eager)")
        path_counts[f"reduced-{name}"] = counts
    return path_counts


# Phase 3's reduced MoE engines: (name, arch, config overrides, counters
# the card's run must launch).  granite_moe_1b runs its published int8
# format at its published capacity factor 1.25 (the reduced config's 4.0
# never drops); qwen3_moe_235b bf16 with its QK-norm.  128-token chunks
# give the experts C = 80 rows (B3's wgmma entries), the 2-slot decode
# steps C = 8 (B3's split-K entries).
REDUCED_MOE = [
    ("granite-int8", "granite_moe_1b", dict(format_policy="int8"),
     ("grouped_gemm_wgmma_s8", "grouped_gemm_splitk_s8",
      "mte_gemm_wgmma_s8")),
    ("qwen3-moe-bf16", "qwen3_moe_235b",
     dict(format_policy="bf16", compute_dtype="bfloat16"),
     ("grouped_gemm_wgmma", "grouped_gemm_splitk", "mte_gemm_wgmma")),
]


def count_drops(moe_lib):
    """Wrap ``moe_lib.apply_moe`` so that each call adds its routed and
    dropped assignments to the returned [assignments, dropped] (it reads
    the device: for the CPU's eager runs only); → (counts, undo)."""
    seen, apply = [0, 0], moe_lib.apply_moe

    def counting(x, p, cfg):
        _, keep, _ = moe_lib.route_stats(x, p, cfg)
        seen[0] += keep.numel()
        seen[1] += int((~keep).sum())
        return apply(x, p, cfg)

    moe_lib.apply_moe = counting
    return seen, lambda: setattr(moe_lib, "apply_moe", apply)


def recorded_tables(eng):
    """Wrap ``eng.step`` to keep each request's page-table row as it last
    stood while the request held its slot (the per-step logs of a
    synchronous and an async engine differ in step count, not in the
    pages each request was given)."""
    rows, step = {}, eng.step

    def logged():
        step()
        for slot in eng.sched.active:
            req = eng.slot_req[slot]
            if req is not None:
                rows[req.rid] = eng.sched.table_row(slot).tolist()

    eng.step = logged
    return rows


def reduced_moe_phase(dev):
    """granite_moe_1b.reduced() under int8 at capacity factor 1.25 and
    qwen3_moe_235b.reduced() in bf16 with QK-norm (``REDUCED_MOE``), card
    against CPU: four prompts (3 x 256 tokens, two sharing their first
    chunk, and 200) in 128-token chunks on 2 slots, 8 greedy tokens each;
    first-token logits within 2e-2, then the card's engine in its
    defaults (async, the decode step a CUDA graph) against the CPU's
    synchronous eager one: equal greedy streams, equal page-table rows
    per request and prefix registrations, the assignments the CPU run's
    MoE layers dropped printed (granite's must be above 0).  Returns the
    card's launch counts (``reduced-granite-int8``,
    ``reduced-qwen3-moe-bf16``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(0)
    path_counts = {}
    for name, arch, overrides, marks in REDUCED_MOE:
        base = get_config(arch).reduced()
        cfg = dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, capacity_factor=1.25),
            **overrides)
        prompts = [rng.integers(0, cfg.vocab, 256, dtype=np.int32)
                   for _ in range(3)] + [rng.integers(0, cfg.vocab, 200,
                                                      dtype=np.int32)]
        prompts[2][:128] = prompts[0][:128]
        kw = dict(slots=2, cache_len=288, prefill_len=256, page_size=16,
                  prefill_chunk=128)
        params_cpu = model_lib.init_params(cfg, seed=0, device="cpu")
        params_gpu = to_device(params_cpu, dev)
        reset_planning()
        logits = {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            cache = model_lib.init_paged_cache(cfg, 1, 256, num_pages=17,
                                               page_size=16, device=device)
            table = torch.arange(1, 17, dtype=torch.int32,
                                 device=device)[None]
            toks = torch.as_tensor(prompts[0].astype(np.int64),
                                   device=device)
            for p0 in (0, 128):
                out, cache = model_lib.prefill_chunk(
                    params, {"tokens": toks[None, p0:p0 + 128],
                             "page_table": table}, cache, cfg, pos0=p0)
            logits[str(device)] = out.cpu()
        check(f"reduced [{name}] first-token logits cuda vs cpu",
              logits[str(dev)], logits["cpu"], 2e-2)
        outs, tables, regs = {}, {}, {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            reset_planning()
            eng = ServingEngine(params, cfg, device=device,
                                async_steps=device == dev, **kw)
            tables[str(device)] = recorded_tables(eng)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
            if device == dev:
                build.reset_launch_counts()
                outs[str(device)] = eng.run()
                counts = build.launch_counts()
                require(eng.decode_step.graph and eng.decode_step.graphs,
                        f"[{name}] the card's decode step was not replayed "
                        f"as a CUDA graph")
            else:
                drops, undo = count_drops(moe_lib)
                try:
                    outs[str(device)] = eng.run()
                finally:
                    undo()
            regs[str(device)] = eng.sched.pool.registrations()
            log(f"  reduced engine [{name}] on {device}: "
                f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
                f"prefix_hit_pages {eng.metrics()['prefix_hit_pages']}")
        log(f"  reduced engine [{name}]: the CPU run's MoE layers dropped "
            f"{drops[1]} of {drops[0]} assignments at capacity factor "
            f"1.25; the card's launches {counts}")
        if arch == "granite_moe_1b":
            require(drops[1] > 0, f"[{name}] no assignment was dropped")
        for mark in marks:
            require(counts[mark] > 0,
                    f"[{name}] {mark} not launched on the card")
        for rid in outs["cpu"]:
            require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
            require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                    f"[{name}] greedy stream of request {rid} differs")
        require(tables[str(dev)] == tables["cpu"],
                f"[{name}] page tables differ: {tables}")
        require(regs[str(dev)] == regs["cpu"],
                f"[{name}] prefix registrations differ")
        log(f"  reduced engine [{name}]: greedy streams, page-table rows "
            f"and prefix registrations identical on cuda (async + graph) "
            f"and cpu (synchronous, eager)")
        path_counts[f"reduced-{name}"] = counts
    return path_counts


def reduced_recurrent_phase(dev):
    """recurrentgemma_9b.reduced() in fp32, default configuration, card
    against CPU: 32-token prompts (twice the 16-slot ring) in chunks of 8,
    first-token logits within 1e-3, identical greedy streams from the
    engine (3 requests on 2 slots, so one prefills while others decode);
    then the same prompt's logits with an RG-LRU width of 126 (not a
    multiple of 4, so B7 runs on its direct engine).  Returns the card's
    launch counts of the engine run (key ``reduced-recurrent``: fp32 runs
    B3's tile loop and B6's SIMT kernel, whose launches count here) and of
    the width-126 chunks (``reduced-recurrent-w126``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("recurrentgemma_9b").reduced()      # fp32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (32, 9, 30, 17)]

    def first_token_logits(cfg, label):
        """The first prompt through four 8-token chunks on both devices;
        returns the parameters and the card's launch counts."""
        reset_planning()
        params_cpu = model_lib.init_params(cfg, seed=0, device="cpu")
        params_gpu = to_device(params_cpu, dev)
        logits = {}
        for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
            cache = model_lib.init_paged_cache(cfg, 2, 64, num_pages=17,
                                               page_size=8, device=device)
            table = torch.arange(1, 9, dtype=torch.int32,
                                 device=device)[None]
            toks = torch.as_tensor(prompts[0].astype(np.int64),
                                   device=device)
            build.reset_launch_counts()
            for p0 in range(0, 32, 8):
                out, cache = model_lib.prefill_chunk(
                    params, {"tokens": toks[None, p0:p0 + 8],
                             "page_table": table, "slot": 1}, cache, cfg,
                    pos0=p0)
            logits[str(device)] = out.cpu()
            if device == dev:
                counts = build.launch_counts()
        err = max_err(logits[str(dev)], logits["cpu"])
        log(f"  reduced recurrentgemma fp32 {label}first-token logits cuda "
            f"vs cpu: max_abs_err={err:.3e} tol=1e-3")
        require(err <= 1e-3,
                f"recurrentgemma {label}first-token logits differ by {err}")
        return params_cpu, params_gpu, counts

    wide = dataclasses.replace(cfg, rglru=dataclasses.replace(cfg.rglru,
                                                              width=126))
    _, _, w126 = first_token_logits(wide, "(RG-LRU width 126) ")
    log(f"  reduced recurrentgemma width 126 launches {w126}")
    require(w126["rglru_scan"] > 0 and w126["rglru_scan_staged"] == 0,
            "RG-LRU width 126 must run B7's direct engine only")
    params_cpu, params_gpu, _ = first_token_logits(cfg, "")
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device, slots=2,
                            cache_len=64, prefill_len=32, page_size=8,
                            prefill_chunk=8, async_steps=device == dev)
        for rid, p in enumerate(prompts[1:]):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        build.reset_launch_counts()
        outs[str(device)] = eng.run()
        counts = build.launch_counts()
        log(f"  reduced recurrentgemma engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"launches {counts}; steps_in_flight_max "
            f"{eng.steps_in_flight_max}, graphs "
            f"{sorted(eng.decode_step.graphs)}")
        if device == dev:
            require(eng.decode_step.graph and eng.decode_step.graphs,
                    "reduced recurrentgemma: the card's decode step was not "
                    "replayed as a CUDA graph")
            path_counts = counts
            for kernel in ("grouped_gemm", "flash_decode",
                           "rglru_scan_staged"):
                require(counts[kernel] > 0,
                        f"reduced recurrentgemma: {kernel} not launched")
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"recurrentgemma greedy stream of request {rid} differs")
    log("  reduced recurrentgemma engine: greedy streams identical on cuda "
        "(async + graph) and cpu (synchronous, eager)")
    spec = reduced_spec_check(
        dev, "recurrentgemma", cfg, params_cpu, params_gpu, prompts[1:],
        dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
             prefill_chunk=8), outs["cpu"])
    return {"reduced-recurrent": path_counts,
            "reduced-recurrent-w126": w126,
            "reduced-recurrent-spec": spec}


def reduced_spec_check(dev, label, cfg, params_cpu, params_gpu, prompts, kw,
                       vanilla, want_k=None):
    """A reduced engine with ``spec_k=4`` on the card (async, the decode
    step as a CUDA graph, the speculative step's shapes replayed as CUDA
    graphs) and on the CPU (synchronous, eager): greedy streams equal on
    both and equal to the vanilla ones, and with ``want_k`` windows of
    that many tokens on both; → the card's launch counts."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServingEngine
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device, spec_k=SPEC_K,
                            async_steps=device == dev, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        build.reset_launch_counts()
        outs[str(device)] = eng.run()
        counts = build.launch_counts()
        m = eng.metrics()
        log(f"  reduced {label} spec_k={SPEC_K} on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"acceptance rate {m['acceptance_rate']:.3f}, spec steps "
            f"{m['spec_steps']}; launches {counts}")
        require(m["spec_steps"] > 0, f"reduced {label}: no speculative step")
        require(want_k is None or max(eng.spec_k_hist) == want_k,
                f"reduced {label}: windows {eng.spec_k_hist}, want "
                f"{want_k} tokens")
        if device == dev:
            require(eng.spec_step.graph and eng.spec_step.replays["verify"],
                    f"reduced {label}: the card's verify windows were not "
                    f"replayed as CUDA graphs")
            card_counts = counts
    for rid in vanilla:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid])
                == list(vanilla[rid]),
                f"reduced {label} spec_k={SPEC_K}: greedy stream of request "
                f"{rid} differs between the card, the CPU and vanilla")
    log(f"  reduced {label} spec_k={SPEC_K}: greedy streams identical on "
        f"cuda and cpu, and equal to vanilla")
    return card_counts


def reduced_gemma2_phase(dev):
    """gemma2_27b.reduced() in fp32, default configuration, card against
    CPU: local (16-slot ring) and global layers in one model, GQA 2:1,
    softcaps 50 and 30, the query scale, post-norms.  32-token prompts in
    chunks of 16 (the second chunk wraps the rings): first-token logits
    within 1e-3, identical greedy streams from the engine (3 requests on
    2 slots) on the card in its defaults and on the CPU synchronous and
    eager, and the same with ``spec_k=4`` (a one-period draft: a local and
    a global layer).  Returns the card's launch counts (keys
    ``reduced-gemma2``, ``reduced-gemma2-spec``): fp32 runs B2's and B3's
    tile loops and the SIMT kernels of B4, B5 and B6."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("gemma2_27b").reduced()             # fp32
    reset_planning()
    params_cpu = model_lib.init_params(cfg, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (32, 21, 30, 17)]
    logits = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 2, 64, num_pages=17,
                                           page_size=8, device=device)
        table = torch.arange(1, 9, dtype=torch.int32, device=device)[None]
        toks = torch.as_tensor(prompts[0].astype(np.int64), device=device)
        for p0 in (0, 16):
            out, cache = model_lib.prefill_chunk(
                params, {"tokens": toks[None, p0:p0 + 16],
                         "page_table": table, "slot": 1}, cache, cfg,
                pos0=p0)
        logits[str(device)] = out.cpu()
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced gemma2 fp32 first-token logits cuda vs cpu: "
        f"max_abs_err={err:.3e} tol=1e-3")
    require(err <= 1e-3, f"gemma2 first-token logits differ by {err}")
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=16)
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device,
                            async_steps=device == dev, **kw)
        for rid, p in enumerate(prompts[1:]):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        build.reset_launch_counts()
        outs[str(device)] = eng.run()
        counts = build.launch_counts()
        log(f"  reduced gemma2 engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"launches {counts}; steps_in_flight_max "
            f"{eng.steps_in_flight_max}, graphs "
            f"{sorted(eng.decode_step.graphs)}")
        if device == dev:
            require(eng.decode_step.graph and eng.decode_step.graphs,
                    "reduced gemma2: the card's decode step was not "
                    "replayed as a CUDA graph")
            path_counts = counts
            for kernel in ("splitk_gemm", "grouped_gemm",
                           "flash_decode_paged", "flash_decode",
                           "flash_attention"):
                require(counts[kernel] > 0,
                        f"reduced gemma2: {kernel} not launched")
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"gemma2 greedy stream of request {rid} differs")
    log("  reduced gemma2 engine: greedy streams identical on cuda "
        "(async + graph) and cpu (synchronous, eager)")
    spec = reduced_spec_check(dev, "gemma2", cfg, params_cpu, params_gpu,
                              prompts[1:], kw, outs["cpu"])
    return {"reduced-gemma2": path_counts, "reduced-gemma2-spec": spec}


def random_biases(params, cfg, seed: int = 1):
    """Draw every q/k/v bias from 0.5 x N(0, 1), and (from seed + 1) every
    MLP bias from 0.1 x N(0, 1) and each LayerNorm's scale from
    1 + 0.2 x N(0, 1) and bias from 0.2 x N(0, 1) (``init_params`` makes
    biases zero and scales one, as JAX does), so a served run adds biases
    and norm parameters that move its activations."""
    import torch
    dev = params["embedding"]["table"].device
    with torch.no_grad():
        if cfg.qkv_bias:
            gen = torch.Generator(device=dev).manual_seed(seed)
            for lp in params["layers"]:
                for name in ("q", "k", "v"):
                    b = lp["mixer"][name]["b"]
                    b.copy_(0.5 * torch.randn(b.shape, generator=gen,
                                              device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)

        def draw(t, mean, std):
            t.copy_(mean + std * torch.randn(t.shape, generator=gen,
                                             device=dev))

        for lp in params["layers"]:
            for leaf in lp["ffn"].values() if cfg.mlp_bias else ():
                draw(leaf["b"], 0.0, 0.1)
        if cfg.norm_type == "layernorm":
            norms = [params["final_norm"]] + [
                lp[name] for lp in params["layers"] for name in lp
                if "norm" in name]
            for p in norms:
                draw(p["scale"], 1.0, 0.2)
                draw(p["bias"], 0.0, 0.2)
    return params


def reduced_qwen_phase(dev):
    """qwen15_4b.reduced() under its published bf16acc format with a bf16
    compute dtype, default configuration, card against CPU: MHA, QKV
    biases (drawn non-zero), an untied LM head.  A 32-token prompt in
    chunks of 16: first-token logits within 5e-2 (bf16 activations; the
    two sides round the same contracts, the kernels' f32 block partials
    summed in another order); identical greedy streams from the engine
    (3 requests on 2 slots) on the card in its defaults and on the CPU
    synchronous and eager, and the same with ``spec_k=4`` (the
    weight-shared one-layer draft).  The card's decode GEMMs and q/k/v
    groups must run on B2's and B3's cluster engines with the bf16
    accumulator.  Returns the card's launch counts (keys
    ``reduced-qwen``, ``reduced-qwen-spec``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen15_4b").reduced(),
                              format_policy="bf16acc",
                              compute_dtype="bfloat16")
    reset_planning()
    params_cpu = random_biases(
        model_lib.init_params(cfg, seed=0, device="cpu"), cfg)
    params_gpu = to_device(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (32, 21, 30, 17)]
    logits = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 2, 64, num_pages=17,
                                           page_size=8, device=device)
        table = torch.arange(1, 9, dtype=torch.int32, device=device)[None]
        toks = torch.as_tensor(prompts[0].astype(np.int64), device=device)
        for p0 in (0, 16):
            out, cache = model_lib.prefill_chunk(
                params, {"tokens": toks[None, p0:p0 + 16],
                         "page_table": table}, cache, cfg, pos0=p0)
        logits[str(device)] = out.cpu()
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced qwen bf16acc first-token logits cuda vs cpu: "
        f"max_abs_err={err:.3e} tol=5e-2")
    require(err <= 5e-2, f"qwen first-token logits differ by {err}")
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=16)
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device,
                            async_steps=device == dev, **kw)
        for rid, p in enumerate(prompts[1:]):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        build.reset_launch_counts()
        outs[str(device)] = eng.run()
        counts = build.launch_counts()
        log(f"  reduced qwen engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"launches {counts}; steps_in_flight_max "
            f"{eng.steps_in_flight_max}, graphs "
            f"{sorted(eng.decode_step.graphs)}")
        if device == dev:
            require(eng.decode_step.graph and eng.decode_step.graphs,
                    "reduced qwen: the card's decode step was not "
                    "replayed as a CUDA graph")
            path_counts = counts
            # B1's tile loop: the o projection at M <= 16 (2 slots, chunks
            # of 16 tokens) under bf16acc.
            for kernel in ("splitk_gemm_cluster", "grouped_gemm_splitk",
                           "mte_gemm"):
                require(counts[kernel] > 0,
                        f"reduced qwen: {kernel} not launched")
            for kernel in ("splitk_gemm", "grouped_gemm"):
                require(counts[kernel] == 0,
                        f"reduced qwen: {counts[kernel]} bf16acc launches "
                        f"of {kernel}: the cluster engines take them")
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"qwen greedy stream of request {rid} differs")
    log("  reduced qwen engine: greedy streams identical on cuda "
        "(async + graph) and cpu (synchronous, eager)")
    spec = reduced_spec_check(dev, "qwen", cfg, params_cpu, params_gpu,
                              prompts[1:], kw, outs["cpu"])
    return {"reduced-qwen": path_counts, "reduced-qwen-spec": spec}


def reduced_starcoder2_phase(dev):
    """starcoder2_7b.reduced() in fp32, default configuration, card against
    CPU: LayerNorm with a bias, the plain GELU MLP with biases, every layer
    local (16-slot rings), GQA 4:1, QKV biases and an untied head, the
    biases and norm parameters drawn away from their initial values
    (``random_biases``).  32-token prompts in chunks of 16 (the second
    chunk wraps the rings): first-token logits within 1e-3, identical
    greedy streams from the engine (3 requests on 2 slots) on the card in
    its defaults and on the CPU synchronous and eager, and the same with
    ``spec_k=4`` (the weight-shared one-layer draft).  Returns the card's
    launch counts (keys ``reduced-starcoder2``,
    ``reduced-starcoder2-spec``): fp32 runs B2's and B3's tile loops and
    B6's SIMT kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("starcoder2_7b").reduced()          # fp32
    reset_planning()
    params_cpu = random_biases(
        model_lib.init_params(cfg, seed=0, device="cpu"), cfg)
    params_gpu = to_device(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (32, 21, 30, 17)]
    logits = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 2, 64, num_pages=17,
                                           page_size=8, device=device)
        table = torch.arange(1, 9, dtype=torch.int32, device=device)[None]
        toks = torch.as_tensor(prompts[0].astype(np.int64), device=device)
        for p0 in (0, 16):
            out, cache = model_lib.prefill_chunk(
                params, {"tokens": toks[None, p0:p0 + 16],
                         "page_table": table, "slot": 1}, cache, cfg,
                pos0=p0)
        logits[str(device)] = out.cpu()
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced starcoder2 fp32 first-token logits cuda vs cpu: "
        f"max_abs_err={err:.3e} tol=1e-3")
    require(err <= 1e-3, f"starcoder2 first-token logits differ by {err}")
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=16)
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device,
                            async_steps=device == dev, **kw)
        for rid, p in enumerate(prompts[1:]):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        build.reset_launch_counts()
        outs[str(device)] = eng.run()
        counts = build.launch_counts()
        log(f"  reduced starcoder2 engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"launches {counts}; steps_in_flight_max "
            f"{eng.steps_in_flight_max}, graphs "
            f"{sorted(eng.decode_step.graphs)}")
        if device == dev:
            require(eng.decode_step.graph and eng.decode_step.graphs,
                    "reduced starcoder2: the card's decode step was not "
                    "replayed as a CUDA graph")
            path_counts = counts
            for kernel in ("splitk_gemm", "grouped_gemm", "flash_decode"):
                require(counts[kernel] > 0,
                        f"reduced starcoder2: {kernel} not launched")
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"starcoder2 greedy stream of request {rid} differs")
    log("  reduced starcoder2 engine: greedy streams identical on cuda "
        "(async + graph) and cpu (synchronous, eager)")
    spec = reduced_spec_check(dev, "starcoder2", cfg, params_cpu,
                              params_gpu, prompts[1:], kw, outs["cpu"])
    return {"reduced-starcoder2": path_counts,
            "reduced-starcoder2-spec": spec}


# The port's logits against the same model's on another device, per
# format (``MODEL_TOL`` of ``tests/torch_parity.py``), each x (1 + |ref|).
MODEL_TOL = {"fp32": 1e-4, "bf16": 2e-2}


def model_level_logits(params, cfg, emb, prefix, steps):
    """The model-level path over frame embeddings ``emb`` (B, prefix +
    steps, d_model): ``forward`` over all of them, ``prefill`` over the
    first ``prefix`` into caches of prefix + 4 slots, then ``steps``
    decode steps at a scalar position: → {call: f32 logits}."""
    from repro_torch.models import model as model_lib
    full, _ = model_lib.forward(params, {"embeddings": emb}, cfg)
    out = {"forward": full}
    out["prefill"], cache = model_lib.prefill(
        params, {"embeddings": emb[:, :prefix]}, cfg, cache_len=prefix + 4)
    for i in range(steps):
        pos = prefix + i
        out[f"decode {i}"], cache = model_lib.decode(
            params, {"embeddings": emb[:, pos:pos + 1], "pos": pos}, cache,
            cfg)
    return out


def model_level_card_phase(dev, label, cfg, batch, prefix, steps, tol,
                           on_path, off_path):
    """``model_level_logits`` of a frontend-stub config under ``cfg`` with
    seeded random weights (biases and LayerNorm parameters drawn by
    ``random_biases``) and frame embeddings, on the card (the kernels) and
    on the CPU (their plain versions): every call's logits within ``tol``
    x (1 + |ref|).  The counters, zeroed just before the card's run and
    read just after, must show every kernel of ``on_path`` launched and
    none of ``off_path``.  Returns those counts."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib

    reset_planning()
    params_cpu = random_biases(
        model_lib.init_params(cfg, seed=0, device="cpu"), cfg)
    params_gpu = to_device(params_cpu, dev)
    emb = torch.randn(batch, prefix + steps, cfg.d_model,
                      generator=torch.Generator().manual_seed(5))
    build.reset_launch_counts()
    with torch.no_grad():
        card = model_level_logits(params_gpu, cfg, emb.to(dev), prefix,
                                  steps)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        cpu = model_level_logits(params_cpu, cfg, emb, prefix, steps)
    for name, want in cpu.items():
        got = card[name].cpu()
        check(f"{label} {name} logits cuda vs cpu", got, want, tol)
        log(f"    max |diff|/(1+|ref|) "
            f"{float(((got - want).abs() / (1 + want.abs())).max()):.4e}")
    log(f"  {label}: launches {counts}")
    for kernel in on_path:
        require(counts[kernel] > 0, f"{label}: {kernel} not launched")
    for kernel in off_path:
        require(counts[kernel] == 0,
                f"{label}: {counts[kernel]} launches of {kernel}")
    return counts


def reduced_musicgen_phase(dev):
    """musicgen_medium.reduced() in fp32 (2 layers, d_model 128, 4 heads
    of 32) through the model-level path, card against CPU: 2 sequences
    of 24 frames, then 3 decode steps, within ``MODEL_TOL["fp32"]``; fp32
    runs B1's SIMT f32 engine at 48 rows, B2's and B3's tile loops (the
    48-row q/k/v program is grouped) and B5's and B6's SIMT kernels.  Then
    musicgen_medium at full width and depth 2 in bf16 (weights built in
    bf16): 2 sequences of 256 frames, then 4 decode steps, within
    ``MODEL_TOL["bf16"]`` -- the bf16 engines at D = 64 and G = 1 (B1's
    wgmma mainloop, B2's cluster engine, B5's wgmma engine, B6's mma
    engine over the flat cache) held to the CPU.  Returns the card's
    launch counts (keys ``reduced-musicgen``, ``musicgen-depth2``)."""
    from repro_torch.configs import get_config
    cfg = get_config("musicgen_medium")
    old = ("mte_gemm", "splitk_gemm", "grouped_gemm", "flash_attention",
           "flash_decode")
    new = ("mte_gemm_wgmma", "splitk_gemm_cluster", "flash_attention_wgmma",
           "flash_decode_mma")
    reduced = model_level_card_phase(
        dev, "reduced musicgen fp32", cfg.reduced(), 2, 24, 3,
        MODEL_TOL["fp32"], ("mte_gemm_simt", "splitk_gemm", "grouped_gemm",
                            "flash_attention", "flash_decode"), new)
    log("== 3. musicgen_medium at full width, depth 2 (bf16): card "
        "against CPU")
    depth2 = model_level_card_phase(
        dev, "musicgen depth 2 bf16",
        dataclasses.replace(cfg, n_layers=2, param_dtype="bfloat16"), 2,
        256, 4, MODEL_TOL["bf16"], new, old)
    return {"reduced-musicgen": reduced, "musicgen-depth2": depth2}


def reduced_chameleon_phase(dev):
    """chameleon_34b.reduced() in fp32 (2 layers, d_model 128, 4 heads of
    32 on 1 kv head, QK-norm, SwiGLU, an untied head) through the
    model-level path, card against CPU: 2 sequences of 24 embeddings,
    then 3 decode steps, within ``MODEL_TOL["fp32"]``; fp32 runs B1's
    SIMT f32 engine at 48 rows and B5's and B6's SIMT kernels, and none of
    the bf16 engines.  Returns the card's launch counts (key
    ``reduced-chameleon``)."""
    from repro_torch.configs import get_config
    counts = model_level_card_phase(
        dev, "reduced chameleon fp32", get_config("chameleon_34b").reduced(),
        2, 24, 3, MODEL_TOL["fp32"],
        ("mte_gemm_simt", "flash_attention", "flash_decode"),
        ("mte_gemm_wgmma", "splitk_gemm_cluster", "flash_attention_wgmma",
         "flash_decode_mma"))
    return {"reduced-chameleon": counts}


def reduced_mamba2_phase(dev):
    """mamba2_130m.reduced() in fp32 (2 SSD layers, d_model 128, 16 SSD
    heads of 16, d_state 16, SSD chunk 8), card against CPU: the first
    prompt (32 tokens) through four 8-token prefill chunks into slot 1
    (each chunk after the first resumes the slot's state and conv ring),
    first-token logits within 1e-3; then the engine, 3 requests on 2
    slots in 8-token chunks (prompts of 9, 30 and 17 tokens: the 30-token
    one spans 4 chunks, and the third request prefills while two decode),
    on the card in its defaults (async, the decode step replayed as a CUDA
    graph) and on the CPU synchronous and eager: identical greedy
    streams; then the same with ``spec_k=4`` (``reduced_spec_check``).
    The SSD is plain PyTorch, as the JAX package computes it in plain jnp:
    no kernel counter may move.  Returns the card's launch counts (keys
    ``reduced-mamba2``, ``reduced-mamba2-spec``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("mamba2_130m").reduced()            # fp32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (32, 9, 30, 17)]
    reset_planning()
    params_cpu = model_lib.init_params(cfg, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, dev)
    logits = {}
    build.reset_launch_counts()
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        cache = model_lib.init_paged_cache(cfg, 2, 64, num_pages=17,
                                           page_size=8, device=device)
        table = torch.arange(1, 9, dtype=torch.int32, device=device)[None]
        toks = torch.as_tensor(prompts[0].astype(np.int64), device=device)
        for p0 in range(0, 32, 8):
            out, cache = model_lib.prefill_chunk(
                params, {"tokens": toks[None, p0:p0 + 8],
                         "page_table": table, "slot": 1}, cache, cfg,
                pos0=p0)
        logits[str(device)] = out.cpu()
    err = max_err(logits[str(dev)], logits["cpu"])
    log(f"  reduced mamba2 fp32 first-token logits after 4 chunks cuda vs "
        f"cpu: max_abs_err={err:.3e} tol=1e-3")
    require(err <= 1e-3, f"mamba2 first-token logits differ by {err}")
    outs = {}
    for device, params in ((dev, params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(params, cfg, device=device, slots=2,
                            cache_len=64, prefill_len=32, page_size=8,
                            prefill_chunk=8, async_steps=device == dev)
        for rid, p in enumerate(prompts[1:]):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=8))
        outs[str(device)] = eng.run()
        log(f"  reduced mamba2 engine on {device}: "
            f"{ {r: list(v) for r, v in outs[str(device)].items()} }; "
            f"steps_in_flight_max {eng.steps_in_flight_max}, graphs "
            f"{sorted(eng.decode_step.graphs)}")
        if device == dev:
            require(eng.decode_step.graph and eng.decode_step.graphs,
                    "reduced mamba2: the card's decode step was not "
                    "replayed as a CUDA graph")
    counts = build.launch_counts()
    for rid in outs["cpu"]:
        require(outs[str(dev)][rid].status == "ok", outs[str(dev)][rid])
        require(list(outs[str(dev)][rid]) == list(outs["cpu"][rid]),
                f"mamba2 greedy stream of request {rid} differs")
    log("  reduced mamba2 engine: greedy streams identical on cuda (async + "
        "graph) and cpu (synchronous, eager)")
    spec = reduced_spec_check(
        dev, "mamba2", cfg, params_cpu, params_gpu, prompts[1:],
        dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
             prefill_chunk=8), outs["cpu"])
    for label, got in (("chunks and engine", counts), ("spec_k=4", spec)):
        moved = {k: v for k, v in got.items() if v}
        log(f"  reduced mamba2 {label}: kernel launches {moved}")
        require(not moved, f"reduced mamba2 {label}: kernels launched "
                f"{moved}; the SSD path runs none")
    return {"reduced-mamba2": counts, "reduced-mamba2-spec": spec}


# -- phase 4: full-width serving ---------------------------------------------

MAX_TOKENS = 24


def serving_workload(cfg, work, dev):
    """Phase 4's six prompts of ``work`` (seed 0) and the engine's
    arguments: 4 slots, 16-token pages, 512-token prefill chunks."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, work["prefill_len"],
                            dtype=np.int32) for _ in range(6)]
    if work["shared"]:
        # Request 4 is admitted when 0 finishes and aliases its first
        # chunk.
        prompts[4][:work["shared"]] = prompts[0][:work["shared"]]
    return prompts, dict(slots=4, page_size=16,
                         prefill_len=work["prefill_len"],
                         cache_len=work["cache_len"], prefill_chunk=512,
                         device=dev)


def serving_phase(dev, name):
    """Serve configuration ``name`` at full width (bf16, seed 0) on its
    arch's workload (``WORKLOADS``), twice: (a) synchronous with the eager
    decode step (``async_steps=False, cuda_graph=False``), synchronised
    around each prefill chunk and decode launch so the host clock
    measures device work, as in the earlier slices; (b) in the engine's
    defaults (async, depth 2, the decode step replayed as a CUDA graph)
    with nothing synchronised inside.  Launch counters are zeroed just
    before each run and read just after; the greedy tokens of (a) and (b)
    must be equal request for request."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import autotune
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    arch, overrides = CONFIGS[name]
    work = WORKLOADS[arch]
    cfg = dataclasses.replace(get_config(arch), **overrides)
    prompts, engine_kw = serving_workload(cfg, work, dev)

    def build_engine(engine_cls, **kw):
        """A fresh plan cache, the seed-0 weights, the engine; the raw
        weights are dropped once the engine holds its own (each run
        builds them anew, so neither run's peak holds the other's)."""
        reset_planning()
        t0 = time.perf_counter()
        params = random_biases(
            model_lib.init_params(cfg, seed=0, device=dev), cfg)
        torch.cuda.synchronize()
        log(f"  {arch} params: {model_lib.param_count(params) / 1e9:.3f} B "
            f"({cfg.param_dtype}), init {time.perf_counter() - t0:.1f} s")
        return engine_cls(params, cfg, **kw, **engine_kw,
                          **ENGINE_KW.get(name, {}))

    timing = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
              "decode_steps": 0, "decode_tokens": 0}

    class TimedEngine(ServingEngine):
        """(a): synchronises around each prefill chunk and decode launch
        so the host clock measures device work."""

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

    # (b): (wall ms, ran a prefill chunk, captured a graph, tokens the
    # step's decode launch will deliver)
    steps = []

    class StepTimedEngine(ServingEngine):
        """(b): the host clock around each engine step, unsynchronised,
        noting whether the step ran a prefill chunk or a capture; one
        steady step (a decode in flight, nothing prefilling or waiting,
        the graph captured) runs under
        ``torch.cuda.set_sync_debug_mode("error")``: any synchronising
        call but the retire's event wait raises."""
        sync_checked_at = None

        def _advance_prefill(self, slot):
            self._ran_prefill = True
            super()._advance_prefill(slot)

        def step(self):
            self._ran_prefill = False
            graphs = len(self.decode_step.graphs)
            check = (self.sync_checked_at is None and graphs
                     and self.steps_in_flight >= 1 and not self._prefilling
                     and not self.sched.waiting)
            t = time.perf_counter()
            if check:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    super().step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                self.sync_checked_at = self.step_idx
            else:
                super().step()
            steps.append((1e3 * (time.perf_counter() - t),
                          self._ran_prefill,
                          len(self.decode_step.graphs) != graphs,
                          sum(len(e["slots"]) for e in self._inflight
                              if e["kind"] == "decode"
                              and e["step"] == self.step_idx)))

    def serve(eng):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t = time.perf_counter()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_tokens=MAX_TOKENS))
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = build.launch_counts()
        log(f"  [{name}{eng.label}] served {len(out)} requests in "
            f"{wall:.3f} s: statuses "
            f"{ {r: v.status for r, v in out.items()} }")
        log(f"  [{name}{eng.label}] launch counts: {counts}")
        for rid, resp in out.items():
            require(resp.status == "ok", resp)
            require(len(resp) == MAX_TOKENS, (rid, len(resp)))
            require(all(0 <= tok < cfg.vocab for tok in resp), rid)
        for kernel in PATH_KERNELS[name]:
            require(counts[kernel] > 0, f"[{name}{eng.label}] {kernel} was "
                    f"never launched on the main path")
        for kernel in NOT_ON_PATH.get(name, counts):
            require(counts[kernel] == 0,
                    f"[{name}{eng.label}] {counts[kernel]} launches of "
                    f"{kernel} at full width: every bf16 launch must run on "
                    f"its new engine")
        return out, counts, wall, torch.cuda.max_memory_allocated()

    eng = build_engine(TimedEngine, async_steps=False, cuda_graph=False)
    eng.label = " (a) sync eager"
    out_a, counts_a, wall_a, peak_a = serve(eng)
    m = eng.metrics()
    log(f"  [{name} (a)] prefill: {timing['prefill_tokens']} tokens in "
        f"{timing['prefill_s']:.3f} s = "
        f"{timing['prefill_tokens'] / timing['prefill_s']:.1f} tokens/s")
    log(f"  [{name} (a)] decode: {timing['decode_tokens']} tokens in "
        f"{timing['decode_steps']} steps, {timing['decode_s']:.3f} s = "
        f"{timing['decode_tokens'] / timing['decode_s']:.1f} tokens/s, "
        f"{1e3 * timing['decode_s'] / timing['decode_steps']:.3f} ms/step")
    log(f"  [{name} (a)] peak memory: {peak_a / 2**30:.2f} GiB; "
        f"prefix_hit_pages={m['prefix_hit_pages']}, prefill_tokens="
        f"{m['prefill_tokens']}, cached_prefill_tokens="
        f"{m['cached_prefill_tokens']}")
    if work["shared"]:
        require(m["prefix_hit_pages"] > 0, m)
    del eng
    free_card()

    eng = build_engine(StepTimedEngine)
    eng.label = " (b) async graph"
    require(eng.async_steps and eng.pipeline_depth == 2
            and eng.decode_step.graph, "(b) must run the engine's defaults")
    out_b, counts, wall_b, peak_b = serve(eng)
    reckoning = memory_reckoning(eng)
    log(f"  [{name} (b)] memory reckoning (GB): "
        f"{ {k: round(v, 3) for k, v in reckoning.items()} }; peak "
        f"allocated {peak_b / 1e9:.3f} GB = {peak_b / 2**30:.2f} GiB")
    m = eng.metrics()
    for rid in out_a:
        require(list(out_b[rid]) == list(out_a[rid]),
                f"[{name}] request {rid}: the async + graph run's greedy "
                f"tokens differ from the synchronous eager run's")
    require(eng.steps_in_flight_max >= 2,
            f"[{name}] steps_in_flight_max {eng.steps_in_flight_max} < 2")
    require(eng.sync_checked_at is not None,
            f"[{name}] no steady step ran under the sync check")
    if work["shared"]:
        require(m["prefix_hit_pages"] > 0, m)
    steady = [(ms, tokens) for ms, prefill, captured, tokens in steps
              if not prefill and not captured]
    steady_tps = 1e3 * sum(t for _, t in steady) / sum(ms for ms, _ in steady)
    steady = [ms for ms, _ in steady]
    async_run = {
        "wall_s": wall_b, "steps": len(steps),
        "decode_tokens": m["decode_tokens"],
        "decode_tokens_per_s": m["decode_tokens"] / wall_b,
        "steady_steps": len(steady),
        "steady_ms_per_step_mean": statistics.mean(steady),
        "steady_ms_per_step_median": statistics.median(steady),
        "steady_tokens_per_s": steady_tps,
        "prefill_step_ms_mean": statistics.mean(
            [ms for ms, prefill, _, _ in steps if prefill]),
        "steps_in_flight_max": eng.steps_in_flight_max,
        "delivery_lag_mean": m["delivery_lag_mean"],
        "sync_checked_at_step": eng.sync_checked_at,
        "captured_deltas": {str(k): v[2]
                            for k, v in eng.decode_step.graphs.items()},
        "peak_memory_gib": peak_b / 2**30, "memory_reckoning": reckoning}
    log(f"  [{name} (b)] greedy tokens equal to (a) for all {len(out_a)} "
        f"requests; steps_in_flight_max {eng.steps_in_flight_max}, "
        f"delivery_lag_mean {m['delivery_lag_mean']:.3f}; step "
        f"{eng.sync_checked_at} ran under set_sync_debug_mode('error') "
        f"with no sync but the retire's event wait")
    log(f"  [{name} (b)] run wall {wall_b:.3f} s (a: {wall_a:.3f} s), "
        f"{async_run['decode_tokens_per_s']:.1f} decode tokens/s over the "
        f"run; {len(steady)} steady steps (no prefill chunk): "
        f"{async_run['steady_ms_per_step_mean']:.3f} ms/step mean, "
        f"{async_run['steady_ms_per_step_median']:.3f} median, "
        f"{steady_tps:.1f} tokens/s launched; peak memory "
        f"{peak_b / 2**30:.2f} GiB; captured deltas "
        f"{async_run['captured_deltas']}")
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
    del cache, logits
    programs = log_programs(name)
    plans = sorted({(p.signature.m, p.signature.n, p.signature.k,
                     p.signature.group, p.describe(), p.route)
                    for p in autotune.plan_cache()._plans.values()})
    for plan in plans:
        log(f"  [{name}] plan {plan[0]}x{plan[1]}x{plan[2]} G={plan[3]}: "
            f"{plan[4]}")
    # The prefill chunk's projections (M = 512) stay on B1 (or B8 under
    # amx): the pricing must not move one into a grouped launch (B3).
    chunk_routes = {p[5] for p in plans if p[0] == 512}
    require(chunk_routes <= {"mte", "rigid"},
            f"[{name}] prefill projections planned on {chunk_routes}")
    profile = profile_steps(eng, dev, work)
    # Every decode q/k/v group (one per attention layer where the decode
    # step groups them) and every paged prefill attention (one per global
    # attention layer) ran on the new engines; the replayed step counts
    # (captured delta x replays) what the eager step launches.
    kinds = [mixer for mixer, _ in eng.cfg.layer_kinds]
    ffns = [ffn for _, ffn in eng.cfg.layer_kinds]
    per_chunk = profile["prefill_chunk"]["wrapper_launches"]
    for call in ("decode_step", "decode_replay"):
        per_step = profile[call]["wrapper_launches"]
        want = (kinds.count("attn") + kinds.count("local")
                + 3 * ffns.count("moe"))
        if attn_lib.grouped_decode(eng.cfg) and want:
            qkv = DECODE_QKV_KERNEL.get(name, "grouped_gemm_splitk")
            require(per_step.get(qkv) == want,
                    f"[{name}] {call}: {per_step.get(qkv)} {qkv} launches "
                    f"per decode step, want {want}")
        for kernel, want in DECODE_STEP_LAUNCHES[name].items():
            require(per_step.get(kernel) == want,
                    f"[{name}] {call}: {per_step.get(kernel)} launches of "
                    f"{kernel} per decode step, want {want}")
        if not PATH_KERNELS[name]:
            require(not per_step, f"[{name}] {call}: kernel launches "
                    f"{per_step}; the path runs none")
    require(profile["decode_replay"]["wrapper_launches"]
            == profile["decode_step"]["wrapper_launches"],
            f"[{name}] a replay counts other launches than the eager step")
    if kinds.count("attn"):
        require(per_chunk.get("flash_attention_wgmma") == kinds.count("attn"),
                f"[{name}] {per_chunk.get('flash_attention_wgmma')} wgmma "
                f"B5 launches per prefill chunk, want {kinds.count('attn')}")
    if kinds.count("rglru"):
        # Every RG-LRU layer of the resumed chunk scans once, on the staged
        # engine, from the carried state: no cumulative sum is left.
        require(per_chunk.get("rglru_scan_staged") == kinds.count("rglru"),
                f"[{name}] {per_chunk.get('rglru_scan_staged')} staged B7 "
                f"launches per prefill chunk, want {kinds.count('rglru')}")
        chunk = profile["prefill_chunk"]
        scans = [r["kernel"] for r in chunk["kernels"]
                 if "cumsum" in r["kernel"].lower()
                 or "tensor_kernel_scan" in r["kernel"]
                 or "DeviceScan" in r["kernel"]]
        require(chunk["cumsum_calls"] == 0 and not scans,
                f"[{name}] the resumed prefill chunk ran "
                f"{chunk['cumsum_calls']} torch.cumsum calls, kernels "
                f"{scans}")
    if not PATH_KERNELS[name]:
        require(not per_chunk, f"[{name}] prefill chunk: kernel launches "
                f"{per_chunk}; the path runs none")
        log(f"  [{name}] no kernel counter moved in (a), (b) or the "
            f"profiled calls: the SSD path is plain PyTorch, as JAX's is "
            f"plain jnp")
    if name in CHUNK_LAUNCHES:
        for kernel, want in CHUNK_LAUNCHES[name].items():
            require(per_chunk.get(kernel, 0) == want,
                    f"[{name}] {per_chunk.get(kernel, 0)} launches of "
                    f"{kernel} per prefill chunk, want {want}")
        log(f"  [{name}] the prefill chunk ran every projection on the s8 "
            f"engine ({per_chunk}) and no int8 tile loop; the decode "
            f"step's launches by counter: "
            f"{profile['decode_step']['wrapper_launches']}")
    summary = {
        "config": name, "arch": arch, "requests": len(out_b),
        "max_tokens": MAX_TOKENS,
        "streams": {rid: list(resp) for rid, resp in out_b.items()},
        "prefill_tokens_per_s": timing["prefill_tokens"]
        / timing["prefill_s"],
        "decode_tokens_per_s": timing["decode_tokens"] / timing["decode_s"],
        "ms_per_decode_step": 1e3 * timing["decode_s"]
        / timing["decode_steps"],
        "decode_steps": timing["decode_steps"],
        "prefill_chunks": timing["prefill_tokens"] // 512,
        "peak_memory_gib": peak_a / 2**30, "wall_s": wall_a,
        "prefix_hit_pages": m["prefix_hit_pages"],
        "launch_counts_sync": counts_a, "launch_counts": counts,
        "async": async_run, "programs": programs, "profile": profile}
    del eng
    free_card()
    return counts, summary


def int8_isa_ratio(serving):
    """The rigid ISA against MTE under int8 at gemma_2b's full width:
    ``amx-int8``'s device ms over ``int8``'s for the eager and the
    replayed decode step and the prefill chunk (phase 4's profiles), each
    printed with the kernels that take the most device time on either
    side."""
    ratio = {}
    for call in ("decode_step", "decode_replay", "prefill_chunk"):
        amx, mte = (serving[name]["profile"][call]
                    for name in ("amx-int8", "int8"))
        if amx["device_busy_ms"] is None or mte["device_busy_ms"] is None:
            ratio[call] = None
            log(f"  [amx-int8 / int8] {call}: device time not measured")
            continue
        ratio[call] = amx["device_busy_ms"] / mte["device_busy_ms"]
        log(f"  [amx-int8 / int8] {call}: device {amx['device_busy_ms']:.3f}"
            f" / {mte['device_busy_ms']:.3f} ms = {ratio[call]:.3f}")
        for name, prof in (("amx-int8", amx), ("int8", mte)):
            log(f"    {name}: " + "; ".join(
                f"{r['ms']:.3f} ms x{r['calls']} {r['kernel']}"
                for r in prof["top"][:4]))
    return ratio


def step_bounds(eng, positions, chunk: int, pos0: int, *,
                draft: bool = False):
    """Least device time of one decode step (a token at each of
    ``positions``) and of one ``chunk``-token prefill chunk at ``pos0``
    of the engine's target model, or of its draft (``draft``):
    max(operations / bf16 peak, bytes / HBM rate).  Bytes: every weight
    read once at the width the engine holds it in (not the stacked decode
    q/k/v), the f32 LM-head copy, the KV the step attends to (a global
    layer's whole prefix, a local layer's ring slots inside the window),
    and each RG-LRU and SSD state row (an SSD layer's f32 state and its
    conv ring) read and written.  Operations: the GEMMs, the (query, key)
    pairs the masks let through and the SSD's scan (``ssd_bounds``).
    Under an int8 format the peak is int8's (1979 TOPS), and
    ``int8_weights_bound_ms`` counts each weight at one byte (what int8 weights held on the card
    would move) beside the bound at the width the engine holds them.  A
    MoE layer's router and every expert count as weights: the capacity
    buffer runs every expert's GEMMs over its C rows, filled or not
    (operations: the router's product over the call's tokens and each
    expert's three GEMMs over C rows); the router stays f32 under int8."""
    from repro_torch.core.formats import to_torch_dtype
    from repro_torch.models.layers import model_format
    from repro_torch.models.moe import moe_capacity
    cfg, params = ((eng.draft_cfg, eng.draft_params) if draft
                   else (eng.cfg, eng.params))
    quantized = model_format(cfg).quantized
    peak = PEAK["int8"] if quantized else PEAK["bf16"]
    weights = [leaf["w"] for lp in params["layers"]
               for grp in ("mixer", "ffn") for leaf in lp.get(grp, {}).values()
               if isinstance(leaf, dict) and "w" in leaf]
    moe = [lp["ffn"] for lp in params["layers"]
           if "router" in lp.get("ffn", {})]
    experts = [ffn[k] for ffn in moe for k in ("gate", "up", "down")]
    routers = [ffn["router"] for ffn in moe]
    # Dense and expert weights: the bytes int8 would hold as one each.
    weights += experts
    w_params = sum(w.numel() for w in weights)
    w_bytes = sum(w.numel() * w.element_size() for w in weights)
    router_bytes = sum(w.numel() * w.element_size() for w in routers)

    def moe_flops(tokens):
        if not moe:
            return 0
        m = cfg.moe
        expert = 3 * cfg.d_model * m.d_ff_expert
        return 2 * len(moe) * m.n_experts * (
            tokens * cfg.d_model + moe_capacity(tokens, cfg) * expert)

    head = params["embedding"]["unembed"]
    head_bytes = head.numel() * head.element_size()
    elt = to_torch_dtype(cfg.compute_dtype).itemsize
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * elt    # one position, one layer
    pair = 4 * cfg.n_heads * cfg.hd               # FLOP per (q, kv) pair
    kinds = [mixer for mixer, _ in cfg.layer_kinds]
    n_attn, n_local = kinds.count("attn"), kinds.count("local")
    n_rglru = kinds.count("rglru")
    window = cfg.window or 0

    def seen(p, kind):                            # keys visible to query p
        return p + 1 if kind == "attn" else min(p + 1, window)

    dec_pairs = sum(n_attn * seen(p, "attn") + n_local * seen(p, "local")
                    for p in positions)
    rg = cfg.rglru                  # h in f32, the conv tail, both ways
    rg_state = (2 * n_rglru * rg.width * (4 + rg.conv_width * elt)
                if n_rglru else 0)
    n_ssd = kinds.count("ssd")
    ssd_state, ssd_step, ssd_chunk = ssd_bounds(cfg, elt, chunk)
    rg_state += 2 * n_ssd * ssd_state
    e_params = sum(w.numel() for w in experts)
    dec_flops = 2 * len(positions) * (w_params - e_params + head.numel()) \
        + pair * dec_pairs + moe_flops(len(positions)) \
        + n_ssd * ssd_step * len(positions)
    dec_kv = kv_row * dec_pairs
    dec_bytes = w_bytes + router_bytes + head_bytes + dec_kv \
        + rg_state * len(positions)
    pre_pairs = sum(n_attn * seen(p, "attn") + n_local * seen(p, "local")
                    for p in range(pos0, pos0 + chunk))
    pre_kv = kv_row * (n_attn * (pos0 + chunk)
                       + n_local * (min(pos0, window) + chunk))
    pre_flops = 2 * chunk * (w_params - e_params) + pair * pre_pairs \
        + 2 * head.numel() + moe_flops(chunk) + n_ssd * ssd_chunk
    pre_bytes = w_bytes + router_bytes + head_bytes + pre_kv + rg_state
    out = {"decode_step": {"bound_ms": bound_ms(dec_flops, dec_bytes, peak),
                           "weight_gb": (w_bytes + router_bytes) / 1e9,
                           "lm_head_gb": head_bytes / 1e9,
                           "kv_gb": dec_kv / 1e9},
           "prefill_chunk": {"bound_ms": bound_ms(pre_flops, pre_bytes, peak),
                             "tflop": pre_flops / 1e12}}
    if quantized:
        for key, flops, nbytes in (("decode_step", dec_flops, dec_bytes),
                                   ("prefill_chunk", pre_flops, pre_bytes)):
            out[key]["int8_weights_bound_ms"] = bound_ms(
                flops, nbytes - w_bytes + w_params, peak)
    if n_ssd:
        out["decode_step"]["ssd_state_gb"] = 2 * n_ssd * ssd_state / 1e9
    if moe:
        out["decode_step"]["expert_gb"] = sum(
            w.numel() * w.element_size() for w in experts) / 1e9
        out["decode_step"]["router_gb"] = router_bytes / 1e9
    return out


def ssd_bounds(cfg, elt: int, chunk: int):
    """An SSD layer's share of a call's bound (``models/ssm.py``): the
    bytes of its per-slot state (the f32 (H, P, N) state and the
    (conv_width, conv_dim) ring in ``elt``-byte elements), and the
    operations beside its projections -- of one decode step (the conv,
    the state's decay and update and its read-out, 2 W C + 6 H P N) and
    of one ``chunk``-token prefill chunk in SSD chunks of q = min(chunk,
    cfg.ssm.chunk) (per SSD chunk the conv 2 W C q, C·B^T 2 q^2 N, the
    masked decay product 2 H q^2, the diagonal term 2 H q^2 P, the chunk
    state and the off-diagonal term 2 q H P N each).  → (state bytes,
    step FLOP, chunk FLOP); zeros without an SSD config."""
    s = cfg.ssm
    if s is None:
        return 0, 0, 0
    d_inner = s.expand * cfg.d_model
    h, p, n, w = d_inner // s.head_dim, s.head_dim, s.d_state, s.conv_width
    conv_dim = d_inner + 2 * n
    q = min(chunk, s.chunk)
    per_chunk = (2 * w * conv_dim * q + 2 * q * q * n + 2 * h * q * q
                 + 2 * h * q * q * p + 4 * q * h * p * n)
    return (4 * h * p * n + w * conv_dim * elt,
            2 * w * conv_dim + 6 * h * p * n,
            -(-chunk // q) * per_chunk)


def routed_expert_gb(eng, call):
    """GB of the expert weights (at the width the engine holds them) that
    one ``call`` of the engine's model routes to: per MoE layer the
    experts at least one of its tokens chose, kept or dropped.  Reads
    the device (eager calls only)."""
    from repro_torch.models import moe as moe_lib
    m, seen = eng.cfg.moe, []
    apply = moe_lib.apply_moe

    def recording(x, p, cfg):
        idx, _, _ = moe_lib.route_stats(x, p, cfg)
        seen.append((int(idx.unique().numel()), p["gate"].element_size()))
        return apply(x, p, cfg)

    moe_lib.apply_moe = recording
    try:
        call()
    finally:
        moe_lib.apply_moe = apply
    per_expert = 3 * eng.cfg.d_model * m.d_ff_expert
    return {"routed_expert_gb": sum(n * per_expert * elt
                                    for n, elt in seen) / 1e9,
            "experts_routed_per_layer": [n for n, _ in seen]}


def log_programs(name):
    """Each compiled program's grouping decision, nodes and plans, logged
    and returned."""
    from repro_torch.graph import schedule
    programs = []
    for prog in schedule.compiled_programs():
        kinds = [type(n).__name__ for n in prog.graph.nodes]
        head = prog.describe().splitlines()[0]
        plans = [prog.plans[i].describe() for i in sorted(prog.plans)]
        log(f"  [{name}] {head}: grouped={prog.grouped} nodes={kinds}")
        for line in plans:
            log(f"      plan {line}")
        programs.append({"program": head, "grouped": prog.grouped,
                         "nodes": kinds, "plans": plans})
    return programs


def profile_steps(eng, dev, work, steps: int = 10):
    """``torch.profiler`` over a few full-width decode steps (4 slots at
    the workload's ``decode`` positions, over the cache the serving run
    left), run eagerly and as replays of the engine's captured greedy
    step (the same staged inputs: :class:`DecodeStep`), and one
    512-token prefill chunk at ``pos0`` into slot 0: wall time per call,
    device busy time (sum of kernel times), the device's idle share, the
    kernels that take the most device time, and the call's bound
    (:func:`step_bounds`).  The replay's idle share is also given against
    the eager step's kernel sum (the same kernels), and its launches per
    call come from the counters (captured delta x replays)."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib

    maxp = eng.sched.max_pages_per_seq
    positions = work["decode"]
    bounds = step_bounds(eng, positions, chunk=512, pos0=work["pos0"])
    bounds["decode_replay"] = bounds["decode_step"]
    table = (1 + np.arange(4 * maxp, dtype=np.int32)).reshape(4, maxp)
    step = eng.decode_step
    step.stage(np.asarray(positions, np.int64), table,
               np.zeros(4, np.float32), np.ones(4, bool))
    prefill_table = torch.as_tensor(table[:1], device=dev)
    prefill_tokens = torch.zeros(1, 512, dtype=torch.int64, device=dev)
    if eng.cfg.moe is not None:
        routed = routed_expert_gb(eng, lambda: step.eager(False))
        bounds["decode_step"].update(routed)
        log(f"  decode step: {routed['routed_expert_gb']:.4f} GB of the "
            f"experts' {bounds['decode_step']['expert_gb']:.4f} routed to "
            f"(experts per layer {routed['experts_routed_per_layer']})")

    def prefill():
        return model_lib.prefill_chunk(
            eng.params, {"tokens": prefill_tokens,
                         "page_table": prefill_table, "slot": 0},
            eng.cache, eng.cfg, pos0=work["pos0"])

    out = {}
    for name, fn, n in (("decode_step", lambda: step.eager(False), steps),
                        ("decode_replay", lambda: step(False), steps),
                        ("prefill_chunk", prefill, 1)):
        out[name] = {**profile_call(fn, n), **bounds[name]}
        if name == "decode_replay":
            eager_busy = out["decode_step"]["device_busy_ms"]
            wall_ms = out[name]["wall_ms"]
            out[name]["idle_share_vs_eager_kernels"] = (
                1 - eager_busy / wall_ms if eager_busy else None)
        log_profile(name, out[name],
                    (f" (against the eager step's kernel sum: "
                     f"{out[name]['idle_share_vs_eager_kernels']})"
                     if name == "decode_replay" else ""))
    return out


# Calls run under ``torch.profiler`` (at most): its processing of the
# events, not the calls, takes the seconds -- an eager full-width decode
# step launches thousands of kernels.
PROFILED_CALLS = 3


def profile_call(fn, n):
    """One call of ``fn`` to warm up, then ``n`` calls timed by the host
    clock around a synchronise (no profiler: its overhead would inflate
    the idle share), then min(n, ``PROFILED_CALLS``) under
    ``torch.profiler`` (``profile_s``: the seconds that took): wall ms, the
    wrappers' launches, device kernels and busy ms per call, the idle
    share, the kernels by device time and the ``torch.cumsum`` calls.
    CUDA events between the timed calls give each call's span on the
    device's clock (``call_ms``), which shows whether a high idle share
    is one call held back or every call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    fn()
    torch.cuda.synchronize()
    build.reset_launch_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t = time.perf_counter()
    for i in range(n):
        marks[i].record()
        fn()
    marks[n].record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / n
    call_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    per_call = {k: v / n for k, v in build.launch_counts().items() if v}
    t = time.perf_counter()
    n_prof = min(n, PROFILED_CALLS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    rows = []
    for e in averages:
        dev_us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) or 0)
        # An aten op or an autograd Function (``MteGemmBackward``) reports
        # the kernels it launched as its own device time, and a runtime
        # call (cudaLaunchKernel, cudaGraphLaunch) can carry the time of
        # what it launched; count the device's own activities (kernels,
        # copies) only.  "Command Buffer Full" marks the host waiting on a
        # full launch queue, not device work.
        if (dev_us > 0 and e.device_type == DeviceType.CUDA
                and not e.key.startswith(("aten::", "cuda"))
                and e.key != "Command Buffer Full"):
            rows.append((dev_us / n_prof / 1e3, e.key, e.count // n_prof))
    cumsum_calls = sum(e.count for e in averages
                       if e.key == "aten::cumsum") // n_prof
    busy_ms = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"wall_ms": wall_ms, "call_ms": call_ms,
            "profiled_calls": n_prof,
            "profile_s": time.perf_counter() - t,
            "wrapper_launches": per_call,
            "cumsum_calls": cumsum_calls,
            "device_kernels": sum(r[2] for r in rows) if rows else None,
            "device_busy_ms": busy_ms if rows else None,
            "idle_share": (1 - busy_ms / wall_ms) if rows else None,
            "top": [{"kernel": k[:60], "ms": ms, "calls": c}
                    for ms, k, c in rows[:8]],
            "kernels": [{"kernel": k[:120], "ms": ms, "calls": c}
                        for ms, k, c in rows]}


def log_profile(name, prof, note=""):
    busy = (f"device busy {prof['device_busy_ms']:.3f} ms"
            if prof["device_busy_ms"] is not None else
            "device time not measured (no device events)")
    if "int8_weights_bound_ms" in prof:
        note += (f" (bound with int8 weights held: "
                 f"{prof['int8_weights_bound_ms']:.3f} ms)")
    log(f"  profile {name}: wall {prof['wall_ms']:.3f} ms, {busy}, bound "
        f"{prof['bound_ms']:.3f} ms, idle share {prof['idle_share']}{note}; "
        f"device kernels per call {prof['device_kernels']}, wrapper "
        f"launches per call {prof['wrapper_launches']}; device span per "
        f"call {min(prof['call_ms']):.3f}-{max(prof['call_ms']):.3f} ms; "
        f"{prof['profiled_calls']} calls profiled in "
        f"{prof['profile_s']:.1f} s")
    for r in prof["top"]:
        log(f"    {r['ms']:.4f} ms x{r['calls']} {r['kernel']}")


# -- phase 5: speculative serving at full width -------------------------------

# Phase 5's runs: (phase 4 configuration, draft depth in layer periods).
# (configuration, draft depth in layer periods, draft weights).  With
# random weights every model here greedily repeats its last prompt token
# (the tied embedding's product with itself decides the LM head), and so
# does any draft with weights of the same scale: the weight-shared drafts
# are accepted every time.  gemma_2b's 18-period draft is the target
# itself, so its acceptance must be exactly 1.0.  The "-own" runs pass a
# draft of their own (``draft_config`` + ``draft_params``: seed 1, its
# projection weights scaled by REJECTING_DRAFT_SCALE so they, not the
# embedding, decide part of its proposals; ``tools/draft_probe.py``
# sweeps the scale: at 2 every draft is still accepted, at 3 almost none):
# drafts are rejected at some positions and not at others, which runs the
# rollback at full width (gemma's paged rewind; recurrentgemma's ring and
# RG-LRU restore and the replay of the accepted prefix).
SPEC_RUNS = {
    "default-draft1": ("default", 1, "shared"),
    "default-draft18": ("default", 18, "shared"),
    "recurrentgemma-draft1": ("recurrentgemma", 1, "shared"),
    "default-own1": ("default", 1, "own"),
    "recurrentgemma-own1": ("recurrentgemma", 1, "own"),
    "gemma2-draft1": ("gemma2", 1, "shared"),
    "qwen-draft1": ("qwen", 1, "shared"),
    "starcoder2-draft1": ("starcoder2", 1, "shared"),
}
REJECTING_DRAFT_SCALE = 2.5
SPEC_K = 4


def speculative_phase(dev, run, vanilla, vanilla_async, smi):
    """Serve ``run`` (``SPEC_RUNS``) at full width with ``spec_k=4`` in the
    engine's defaults on phase 4's workload: the speculative step's
    shapes replayed as CUDA graphs (``SpecStep``).  Launch counters are
    zeroed just before the run and read just after.  Requires: every
    request's greedy tokens equal to phase 4's (b) run of the same
    configuration (``vanilla``); the tile loops' and SIMT kernels'
    counters at 0; every speculative step's verify window replayed, each
    shape captured once; every target window (the step's, and a
    replay's) launching B4 (or B6) once per position and attention layer,
    and B2 and B3 as often as a decode step (its projections run once
    over the window's rows); an acceptance rate of exactly 1.0 for the
    full-depth draft.  Prints each speculative step (host wall ms, the
    device spans of its draft and target windows between CUDA events,
    its wrappers' launches), the captures and replays per shape family,
    the run's acceptance rate, mean window, decode tokens/s over the run
    and over its steady steps (no capture, no prefill chunk), each
    with its ratio to phase 4's (b) (``vanilla_async``: over the run,
    and over (b)'s steady steps), and peak memory, and profiles the
    verify window (eager and replayed) and the replayed draft decode step
    at the workload's positions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine, SpecStep

    name, groups, weights = SPEC_RUNS[run]
    arch, overrides = CONFIGS[name]
    work = WORKLOADS[arch]
    cfg = dataclasses.replace(get_config(arch), **overrides)
    prompts, engine_kw = serving_workload(cfg, work, dev)
    kinds = [mixer for mixer, _ in cfg.layer_kinds]
    # Per window position: B4 once per global layer, B6 once per local one.
    attn_layers = {kernel: kinds.count(kind) for kernel, kind in
                   (("flash_decode_paged_mma", "attn"),
                    ("flash_decode_mma", "local")) if kinds.count(kind)}
    grouped = attn_lib.grouped_decode(dataclasses.replace(
        cfg, decode_qkv_grouped=True))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    require(len(decode_gemms(cfg, grouped)[0])
            == DECODE_STEP_LAUNCHES[name]["splitk_gemm_cluster"],
            f"[{run}] decode_gemms disagrees with DECODE_STEP_LAUNCHES")
    steps = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    class TimedSpecStep(SpecStep):
        """Records each target window of a speculative step: its tokens,
        the CUDA-event span and the counters' deltas of its replay (a
        shape's first call captures it first, outside the record: the
        capture's warm-up counts too)."""

        def __call__(self, family, n):
            rec = self.engine._rec
            if rec is None or family not in ("verify", "replay"):
                return super().__call__(family, n)
            if (family, n) not in self.graphs:
                self.capture(family, n)
            before = build.launch_counts()
            start = event()
            out = super().__call__(family, n)
            after = build.launch_counts()
            rec["windows"].append({
                "family": family, "tokens": n, "events": (start, event()),
                **{kernel: after[kernel] - before[kernel]
                   for kernel in (*attn_layers, "splitk_gemm_cluster",
                                  "grouped_gemm_splitk")}})
            return out

    class SpecTimedEngine(ServingEngine):
        """Records each speculative step: host wall time, the CUDA-event
        span of its draft, its target windows (``TimedSpecStep``), the
        counters' deltas, and whether its engine step ran a prefill
        chunk first."""
        _rec = None
        _ran_prefill = False
        spec_step_cls = TimedSpecStep

        def step(self):
            self._ran_prefill = False
            super().step()

        def _advance_prefill(self, slot):
            self._ran_prefill = True
            super()._advance_prefill(slot)

        def _spec_step(self, decoding, k):
            self._rec = rec = {"k": k, "slots": len(decoding),
                               "windows": [], "prefill": self._ran_prefill}
            before = build.launch_counts()
            accepted = self.sched.spec_accepted
            emitted = self.sched.spec_emitted
            captures = sum(self.spec_step.captures.values())
            t = time.perf_counter()
            super()._spec_step(decoding, k)
            rec["wall_ms"] = 1e3 * (time.perf_counter() - t)
            rec["accepted"] = self.sched.spec_accepted - accepted
            rec["emitted"] = self.sched.spec_emitted - emitted
            rec["captured"] = sum(self.spec_step.captures.values()) \
                != captures
            rec["launches"] = {n: c - before[n] for n, c
                               in build.launch_counts().items()
                               if c != before[n]}
            steps.append(rec)
            self._rec = None

        def _draft_propose(self, decoding, k, sampled):
            start = event()
            out = super()._draft_propose(decoding, k, sampled)
            self._rec["draft_events"] = (start, event())
            return out

    reset_planning()
    params = random_biases(
        model_lib.init_params(cfg, seed=0, device=dev), cfg)
    if weights == "shared":
        draft_kw = dict(draft_groups=groups)
        about = "weights shared with the target"
    else:
        dcfg = cfg.draft(groups)
        draft = rejecting_draft(dcfg, dev)
        draft_kw = dict(draft_config=dcfg, draft_params=draft)
        about = (f"weights of its own (seed 1, projections x "
                 f"{REJECTING_DRAFT_SCALE})")
    eng = SpecTimedEngine(params, cfg, spec_k=SPEC_K, **draft_kw,
                          **engine_kw)
    del params
    draft_kw = draft = None
    require(eng.spec_step.graph, f"[{run}] the speculative step must "
            f"replay CUDA graphs on the card")
    log(f"  [{run}] draft {eng.draft_cfg.name}: {eng.draft_cfg.n_layers} "
        f"layers, {about}; spec_k={SPEC_K}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_tokens=MAX_TOKENS))
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics()
    for rec in steps:
        rec["draft_span_ms"] = rec["draft_events"][0].elapsed_time(
            rec["draft_events"][1])
        for v in rec["windows"]:
            v["span_ms"] = v["events"][0].elapsed_time(v["events"][1])
            del v["events"]
        del rec["draft_events"]
    for i, rec in enumerate(steps):
        log(f"  [{run}] spec step {i}: k={rec['k']} slots={rec['slots']} "
            f"accepted={rec['accepted']} wall {rec['wall_ms']:.3f} ms, "
            f"draft span {rec['draft_span_ms']:.3f} ms, target window "
            f"spans {[round(v['span_ms'], 3) for v in rec['windows']]} ms "
            f"(windows {[v['tokens'] for v in rec['windows']]}); launches "
            f"{rec['launches']}")
    log(f"  [{run}] launch counts: {counts}")
    spec = eng.spec_step
    graphs = {}
    for family, n in spec.graphs:
        graphs.setdefault(family, []).append(n)
    log(f"  [{run}] graphs: captures {dict(spec.captures)}, replays "
        f"{dict(spec.replays)}, shapes "
        f"{ {f: sorted(v) for f, v in graphs.items()} }")
    for rid, resp in out.items():
        require(resp.status == "ok", resp)
        require(list(resp) == vanilla[rid],
                f"[{run}] request {rid}: speculative greedy tokens differ "
                f"from phase 4's vanilla run")
    for kernel in PATH_KERNELS[name]:
        require(counts[kernel] > 0, f"[{run}] {kernel} never launched")
    for kernel in NOT_ON_PATH[name]:
        require(counts[kernel] == 0,
                f"[{run}] {counts[kernel]} launches of {kernel}")
    require(sum(spec.captures.values()) == len(spec.graphs),
            f"[{run}] {dict(spec.captures)} captures for "
            f"{len(spec.graphs)} shapes: a shape was captured twice")
    require(m["spec_steps"] == len(steps) == spec.replays["verify"] > 0,
            f"[{run}] {m['spec_steps']} speculative steps, "
            f"{spec.replays['verify']} verify replays")
    windows = [v for rec in steps for v in rec["windows"]]
    require(spec.replays["verify"] + spec.replays["replay"] == len(windows),
            f"[{run}] {len(windows)} target windows, "
            f"{dict(spec.replays)} replays")
    slots = engine_kw["slots"]
    for v in windows:
        for kernel, layers in attn_layers.items():
            require(v[kernel] == layers * v["tokens"],
                    f"[{run}] a {v['tokens']}-token window launched "
                    f"{v[kernel]} {kernel}, want {layers * v['tokens']}")
        for kernel, want in window_launches(cfg, grouped, slots,
                                            v["tokens"], sms).items():
            require(v[kernel] == want,
                    f"[{run}] a {v['family']} window of {v['tokens']} "
                    f"tokens launched {v[kernel]} {kernel}, want {want}")
    if groups == cfg.n_layers // cfg.period:
        require(m["acceptance_rate"] == 1.0,
                f"[{run}] acceptance rate {m['acceptance_rate']} with the "
                f"full-depth draft: a verify row differs from the draft's "
                f"decode row")
    if weights == "own":
        require(0.0 < m["acceptance_rate"] < 1.0,
                f"[{run}] acceptance rate {m['acceptance_rate']}: the "
                f"draft of its own must be rejected at some positions and "
                f"accepted at others")
        replays = [v for v in windows if v["family"] == "replay"]
        require(not eng._stateful_rows or replays,
                f"[{run}] no replay window: the ring and RG-LRU rows were "
                f"never restored")
        log(f"  [{run}] {len(replays)} replay windows of "
            f"{sorted(set(v['tokens'] for v in replays))} tokens")
    tps = m["decode_tokens"] / wall
    vanilla_tps = vanilla_async["decode_tokens_per_s"]
    # Steady steps, as phase 4's: no capture, no prefill chunk in the
    # engine step, and none in the draft's catch-up (B1 runs only in
    # prefill chunks at full width).
    steady = [rec for rec in steps if not rec["captured"]
              and not rec["prefill"]
              and "mte_gemm_wgmma" not in rec["launches"]]
    steady_tps = (1e3 * sum(r["emitted"] for r in steady)
                  / sum(r["wall_ms"] for r in steady))
    vanilla_steady = vanilla_async["steady_tokens_per_s"]
    # A decode step gives each decoding slot one token: the steady spec
    # step's wall per token a slot compares with (b)'s steady ms/step
    # whatever the slots' occupancy of either run.
    slot_ms = (sum(r["wall_ms"] for r in steady)
               / sum(r["emitted"] / r["slots"] for r in steady))
    vanilla_ms = vanilla_async["steady_ms_per_step_mean"]
    log(f"  [{run}] greedy tokens equal to phase 4's for all {len(out)} "
        f"requests; every target window launched {attn_layers} once per "
        f"position and layer, and B2 and B3 once per GEMM and row chunk "
        f"(at {SPEC_K} tokens: "
        f"{window_launches(cfg, grouped, slots, SPEC_K, sms)}; a decode "
        f"step: {window_launches(cfg, grouped, slots, 1, sms)})")
    reckoning = memory_reckoning(eng)
    log(f"  [{run}] memory reckoning (GB): "
        f"{ {k: round(v, 3) for k, v in reckoning.items()} }; peak "
        f"allocated {peak / 1e9:.3f} GB = {peak / 2**30:.2f} GiB")
    log(f"  [{run}] on {smi}: acceptance rate {m['acceptance_rate']:.4f}, "
        f"spec_k_mean {m['spec_k_mean']:.3f}, {m['spec_steps']} speculative "
        f"of {m['decode_steps']} decode steps, run wall {wall:.3f} s, "
        f"{tps:.1f} decode tokens/s over the run = {tps / vanilla_tps:.3f}x "
        f"phase 4's (b) {vanilla_tps:.1f}; {len(steady)} steady steps "
        f"(no capture, no prefill chunk): "
        f"{statistics.mean(r['wall_ms'] for r in steady):.3f} ms mean, "
        f"{steady_tps:.1f} tokens/s = {steady_tps / vanilla_steady:.3f}x "
        f"(b)'s steady {vanilla_steady:.1f}, {slot_ms:.3f} ms per token a "
        f"slot = {vanilla_ms / slot_ms:.3f}x (b)'s steady {vanilla_ms:.3f} "
        f"ms/step; peak memory {peak / 2**30:.2f} GiB")
    profile = profile_spec(eng, work["decode"], SPEC_K, work["pos0"])
    if kinds.count("attn"):
        idle = profile["verify_replay"]["idle_share"]
        require(idle is not None and idle <= 0.15,
                f"[{run}] the replayed verify window's idle share {idle} "
                f"> 0.15 (device span per call: "
                f"{profile['verify_replay']['call_ms']} ms)")
    summary = {
        "run": run, "config": name, "arch": arch,
        "draft": eng.draft_cfg.name, "draft_layers": eng.draft_cfg.n_layers,
        "spec_k": SPEC_K, "acceptance_rate": m["acceptance_rate"],
        "spec_k_mean": m["spec_k_mean"], "spec_steps": m["spec_steps"],
        "decode_steps": m["decode_steps"],
        "decode_tokens": m["decode_tokens"], "wall_s": wall,
        "decode_tokens_per_s": tps, "vs_vanilla": tps / vanilla_tps,
        "steady_steps": len(steady), "steady_tokens_per_s": steady_tps,
        "steady_vs_vanilla": steady_tps / vanilla_steady,
        "steady_ms_per_slot_token": slot_ms,
        "steady_slot_speedup": vanilla_ms / slot_ms,
        "peak_memory_gib": peak / 2**30, "memory_reckoning": reckoning,
        "launch_counts": counts,
        "captures": dict(spec.captures), "replays": dict(spec.replays),
        "steps": steps, "profile": profile}
    del eng
    free_card()
    return summary


def decode_gemms(cfg, grouped: bool):
    """The (N, K) of every B2 launch of a decode step (o, and q/k/v when
    they are not grouped, per attention layer; the RG-LRU block's five
    projections; gate, up and down, or the plain MLP's up and down), and
    the member widths and K of every B3 launch (the grouped q/k/v)."""
    d, ff = cfg.d_model, cfg.d_ff
    q_w, kv_w = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    b2, b3 = [], []
    for mixer, _ in cfg.layer_kinds:
        if mixer == "rglru":
            w = cfg.rglru.width
            b2 += [(w, d), (w, d), (w, w), (w, w), (d, w)]
        else:
            if grouped:
                b3.append(((q_w, kv_w, kv_w), d))
            else:
                b2 += [(q_w, d), (kv_w, d), (kv_w, d)]
            b2.append((d, q_w))
        gated = cfg.mlp_type in ("swiglu", "geglu")
        b2 += [(ff, d)] * (2 if gated else 1) + [(d, ff)]
    return b2, b3


def window_launches(cfg, grouped: bool, slots: int, tokens: int, sms: int):
    """B2 and B3 launches of a target window of ``tokens`` per slot: each
    GEMM of a decode step once per row chunk of
    ``geometry.window_rows`` (the split planned at the decode step's
    ``slots`` rows on the card's ``sms``); at one token, the decode
    step's."""
    from repro_torch.core.geometry import (cdiv, grouped_live_tiles,
                                           grouped_split,
                                           splitk_cluster_split,
                                           window_rows)
    rows = slots * tokens
    b2, b3 = decode_gemms(cfg, grouped)
    out = {"splitk_gemm_cluster": sum(
        cdiv(rows, window_rows("cluster", slots, splitk_cluster_split(
            cdiv(n, 128), k, slots, sms)[1])) for n, k in b2)}
    if b3:
        out["grouped_gemm_splitk"] = sum(
            cdiv(rows, window_rows("splitk", slots, grouped_split(
                sum(grouped_live_tiles(max(ws), ws, len(ws))), k, slots,
                sms)[1])) for ws, k in b3)
    return out


def rejecting_draft(dcfg, dev, scale: float = REJECTING_DRAFT_SCALE):
    """A draft's parameters of its own: seed 1, every projection weight
    times ``scale`` (norms, embedding and the RG-LRU's bare tensors as
    drawn)."""
    import torch
    from repro_torch.models import model as model_lib
    draft = model_lib.init_params(dcfg, seed=1, device=dev)
    with torch.no_grad():
        for lp in draft["layers"]:
            for group in ("mixer", "ffn"):
                for leaf in lp[group].values():
                    if isinstance(leaf, dict) and "w" in leaf:
                        leaf["w"].mul_(scale)
    return draft


# Calls per profiled replay, as many as ``profile_steps`` times of a
# decode step.  Over 3 calls the host clock's fixed costs (the first
# launch, the last synchronise) weigh three times as much, and the
# replayed qwen window's idle share read 0.024 in one run and 0.159 in
# another.  The eager window, whose idle share no check reads, keeps 3
# calls: the profiler's cost grows with its thousands of host ops.
SPEC_PROFILE_CALLS = {"verify_window": 3, "verify_replay": 10,
                      "draft_replay": 10}


def profile_spec(eng, positions, k, pos0):
    """The profiler over the verify window of ``k`` tokens per slot at
    ``positions`` (one per slot, over the cache the run left), called
    eagerly and replayed, and over the replayed draft decode step at the
    same positions: wall and device ms, idle share (the replay's also
    against the eager window's kernel sum), and each call's bound
    (:func:`step_bounds` over its tokens)."""
    import numpy as np
    spec = eng.spec_step
    slots = len(positions)
    maxp = eng.sched.max_pages_per_seq
    table = (1 + np.arange(slots * maxp, dtype=np.int32)).reshape(slots,
                                                                  maxp)
    active = np.ones(slots, bool)
    spec.stage("target", positions, table, active)
    spec.stage_tokens("verify", np.zeros((slots, k), np.int64))
    spec.stage("draft", positions, eng._draft_table, active)
    spec.stage_tokens("draft", np.zeros((slots, 1), np.int64))
    window = [p + i for p in positions for i in range(k)]
    verify_bound = step_bounds(eng, window, chunk=512, pos0=pos0)
    draft_bound = step_bounds(eng, positions, chunk=512, pos0=pos0,
                              draft=True)
    out = {}
    for name, fn, bound in (
            ("verify_window", lambda: spec.eager("verify", k), verify_bound),
            ("verify_replay", lambda: spec("verify", k), verify_bound),
            ("draft_replay", lambda: spec("draft", 1), draft_bound)):
        t = time.perf_counter()
        out[name] = {**profile_call(fn, SPEC_PROFILE_CALLS[name]),
                     **bound["decode_step"]}
        note = (f" [{SPEC_PROFILE_CALLS[name]} calls, profiled in "
                f"{time.perf_counter() - t:.1f} s]")
        if name == "verify_replay":
            eager_busy = out["verify_window"]["device_busy_ms"]
            out[name]["idle_share_vs_eager_kernels"] = (
                1 - eager_busy / out[name]["wall_ms"] if eager_busy
                else None)
            note += (f" (against the eager window's kernel sum: "
                     f"{out[name]['idle_share_vs_eager_kernels']})")
        log_profile(name, out[name], note)
    return out


# The reference's exact-draft workload (``benchmarks/run.py:345-430``, the
# non-smoke size) at gemma_2b's full width: layers 1-17 get zero ``o`` and
# ``down`` weights, so they add exactly 0.0 to the residual stream and the
# one-layer weight-shared draft computes the target's logits bit for bit,
# while each verify window still pays all 18 layers.  Its gate
# (``:858-860``): speculative tokens/s at least vanilla's, more than one
# accepted draft per step, acceptance at least 0.95.
EXACT_DRAFT = dict(slots=2, spec_k=6, cache_len=128, prefill_len=32,
                   page_size=16)
EXACT_REQUESTS, EXACT_TOKENS, EXACT_TURNS = 8, 32, 3


def exact_draft_phase(dev, smi):
    """Serve the exact-draft workload (``EXACT_DRAFT``) with a vanilla
    engine and a speculative one, both in the engine's defaults (async,
    depth 2, the decode step and the speculative step replayed as CUDA
    graphs), each warmed up by one untimed request (which captures its
    graphs), then timed in alternating turns (vanilla, speculative,
    three times each: 8 greedy requests of 32 tokens, prompts of 24
    shared tokens plus 8 of their own from ``default_rng(0)``).  Decode
    tokens/s is the requests' tokens over the turn's host wall, prefill
    included, as the reference counts.  Requires, unloosened: equal
    greedy streams in every turn, ``speedup_vs_vanilla`` (the ratio of
    the medians) ≥ 1.00, ``accepted_per_step`` > 1 and
    ``acceptance_rate`` ≥ 0.95."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("gemma_2b")
    reset_planning()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        for lp in params["layers"][1:]:
            lp["mixer"]["o"]["w"].zero_()
            lp["ffn"]["down"]["w"].zero_()
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 24, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 8,
                                                    dtype=np.int32)])
               for _ in range(2 * EXACT_REQUESTS)]
    kw = dict(EXACT_DRAFT, device=dev)
    engines = {"vanilla": ServingEngine(params, cfg, **dict(kw, spec_k=0)),
               "spec": ServingEngine(params, cfg, draft_groups=1, **kw)}
    del params
    for label, eng in engines.items():
        eng.submit(Request(rid=0, prompt=prompts[0],
                           max_tokens=EXACT_TOKENS))
        eng.run()
        log(f"  [exact-draft] {label} warm-up: "
            f"{eng.metrics()['decode_steps']} decode steps")
    spec = engines["spec"].spec_step
    captured = dict(spec.captures)
    tps = {"vanilla": [], "spec": []}
    streams = {}
    counts = None
    for turn in range(EXACT_TURNS):
        rids = [100 * (turn + 1) + i for i in range(1, EXACT_REQUESTS + 1)]
        for label in ("vanilla", "spec"):
            eng = engines[label]
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t = time.perf_counter()
            for rid, prompt in zip(rids, prompts[1:]):
                eng.submit(Request(rid=rid, prompt=prompt,
                                   max_tokens=EXACT_TOKENS))
            out = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if label == "spec":
                counts = build.launch_counts()
            for rid in rids:
                require(out[rid].status == "ok", out[rid])
            tokens = sum(len(out[rid]) for rid in rids)
            tps[label].append(tokens / wall)
            streams[label] = [list(out[rid]) for rid in rids]
            log(f"  [exact-draft] turn {turn} {label}: {tokens} tokens in "
                f"{wall:.4f} s = {tokens / wall:.1f} tokens/s")
        require(streams["spec"] == streams["vanilla"],
                f"[exact-draft] turn {turn}: speculative greedy streams "
                f"differ from vanilla's")
    m = engines["spec"].metrics()
    speedup = statistics.median(tps["spec"]) / statistics.median(
        tps["vanilla"])
    log(f"  [exact-draft] on {smi}: speculative {tps['spec']} against "
        f"vanilla {tps['vanilla']} tokens/s; speedup_vs_vanilla "
        f"{speedup:.4f} (medians), accepted_per_step "
        f"{m['accepted_per_step']:.4f}, acceptance_rate "
        f"{m['acceptance_rate']:.4f}, windows {engines['spec'].spec_k_hist}"
        f"; graphs: captures {captured} in the warm-up, "
        f"{dict(spec.captures)} in all, replays "
        f"{dict(spec.replays)}; launches of the last speculative turn "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(speedup >= 1.00,
            f"[exact-draft] speedup_vs_vanilla {speedup:.4f} < 1.00")
    require(m["accepted_per_step"] > 1.0,
            f"[exact-draft] accepted_per_step {m['accepted_per_step']} <= 1")
    require(m["acceptance_rate"] >= 0.95,
            f"[exact-draft] acceptance_rate {m['acceptance_rate']} < 0.95")
    eng = engines["spec"]
    positions = [40, 45]
    profile = profile_spec(eng, positions, EXACT_DRAFT["spec_k"], 0)
    summary = {"tokens_per_s": tps, "speedup_vs_vanilla": speedup,
               "accepted_per_step": m["accepted_per_step"],
               "acceptance_rate": m["acceptance_rate"],
               "spec_k_hist": dict(eng.spec_k_hist),
               "captures": dict(spec.captures),
               "replays": dict(spec.replays), "launch_counts": counts,
               "profile": profile}
    del engines, eng, spec
    free_card()
    return summary


# -- phase 6: the model-level path at full width -----------------------------

# Phase 6's model-level runs, by arch: 4 sequences of frame embeddings,
# ``forward`` over 1088 frames, ``prefill`` over the first 1024 into flat
# caches of ``cache_len`` slots, then 64 decode steps over frames
# 1024-1087.  ``short``: the run's label and its key among the launch
# counts.  chameleon_34b's caches hold the 1088 positions and no more; its
# reckoning (``model_level_reckoning``) must stay under ``fits_gib``.
MODEL_LEVEL = {
    "musicgen_medium": dict(short="musicgen", batch=4, frames=1088,
                            prefix=1024, cache_len=2048),
    "chameleon_34b": dict(short="chameleon", batch=4, frames=1088,
                          prefix=1024, cache_len=1088),
}
# How far prefill's and each decode step's logits may lie from forward's
# at the same position: both sides are bf16 through 48 layers, on other
# engines (B2 and B6 against B1 and B5) and so other roundings.  Fixed
# before the first card run from the plain versions on the CPU at
# d_model 1536 (``tools/model_level_noise.py``, depths 2-24: max |diff|
# / (1 + |ref|) 0.007-0.035, RMS ratio 0.0015-0.0093, growing about as
# the square root of the depth):
# each logit within MODEL_LEVEL_TOL x (1 + |ref|), and the RMS of the
# differences at most MODEL_LEVEL_RMS of the reference's.
MODEL_LEVEL_TOL = 0.2
MODEL_LEVEL_RMS = 0.05


FITS_GIB = 76


def model_level_bounds(cfg, batch, frames, prefix, decode_pos, cache_len):
    """The least time of each call on the card, at the bf16 peak and 3.35
    TB/s, from what it must compute and move (``bound_ms``): ``forward``
    and ``prefill`` -- every layer's GEMMs over B x S rows, causal
    attention over the visible pairs, the LM head over the rows it
    unembeds; bytes: the weights read once (the bf16 layers and head,
    biases and norm scales, QK-norm's; the embedding table is not read
    under the stub), the embeddings read, the logits written and, for
    prefill, the flat caches written; one decode step at ``decode_pos``
    -- the weights and the live KV (the positions up to decode_pos of
    every layer) read, 2 x weights x B FLOP.  Also the caches' bytes all
    ``cache_len`` slots would take."""
    d, f, h, hd, v = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd, cfg.vocab
    hkv, nl = cfg.n_kv_heads, cfg.n_layers
    mlp_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    layer_w = d * (h + 2 * hkv) * hd + h * hd * d + mlp_mats * d * f
    layer_b = (((h + 2 * hkv) * hd if cfg.qkv_bias else 0)
               + ((mlp_mats - 1) * f + d if cfg.mlp_bias else 0)
               + (2 * hd if cfg.qk_norm else 0)
               + (4 if cfg.norm_type == "layernorm" else 2) * d)
    weights = 2 * (nl * (layer_w + layer_b) + d * v + 2 * d)
    kv_token = 2 * hkv * hd * 2                # K and V of a token, bf16

    def attn_flops(s):
        return 4.0 * batch * h * hd * s * (s + 1) / 2

    def call(rows, s, logits_rows, cache_bytes):
        flops = nl * (2.0 * rows * layer_w + attn_flops(s)) \
            + 2.0 * logits_rows * d * v
        nbytes = (weights + 2 * rows * d + 4 * logits_rows * v
                  + cache_bytes)
        return {"bound_ms": bound_ms(flops, nbytes, PEAK["bf16"]),
                "bound_by": bound_by(flops, nbytes, PEAK["bf16"]),
                "flops": flops, "bytes": nbytes}

    caches = nl * batch * cache_len * kv_token
    live = nl * batch * (decode_pos + 1) * kv_token
    dec_flops = 2.0 * batch * (nl * layer_w + d * v) \
        + nl * 4.0 * batch * h * hd * (decode_pos + 1)
    dec_bytes = weights + live + 2 * batch * d + 4 * batch * v
    return {
        "forward": call(batch * frames, frames, batch * frames, 0),
        "prefill": call(batch * prefix, prefix, batch, caches),
        "decode_step": {
            "bound_ms": bound_ms(dec_flops, dec_bytes, PEAK["bf16"]),
            "bound_by": bound_by(dec_flops, dec_bytes, PEAK["bf16"]),
            "flops": dec_flops, "bytes": dec_bytes,
            "bound_ms_all_slots": 1e3 * (weights + caches + 2 * batch * d
                                         + 4 * batch * v)
            / HBM_BYTES_PER_S},
        "weights_gb": weights / 1e9, "caches_gb": caches / 1e9}


def model_level_reckoning(cfg, bounds, batch, frames):
    """What phase 6 holds on the card at once, in GB: the bf16 weights
    (the embedding table too, which the stub never reads), the flat
    caches, forward's f32 logits (B, frames, vocab) and the LM head
    widened to f32 by ``unembed`` on each call."""
    return {"weights_gb": bounds["weights_gb"]
            + 2 * cfg.d_model * cfg.vocab / 1e9,
            "caches_gb": bounds["caches_gb"],
            "forward_logits_gb": 4 * batch * frames * cfg.vocab / 1e9,
            "head_f32_gb": 4 * cfg.d_model * cfg.vocab / 1e9}


def model_level_phase(dev, arch):
    """``arch`` (musicgen_medium or chameleon_34b) at full width (bf16
    weights via ``param_dtype``; biases and LayerNorm parameters drawn by
    ``random_biases`` where the config has them) through the model-level
    path on the kernels (``MODEL_LEVEL[arch]``): frame embeddings E drawn
    from a seed, ``forward`` over E, ``prefill`` over its first 1024
    frames into flat caches, then 64 ``decode`` steps over frames
    1024-1087.  Before the run it prints what the card will hold
    (``model_level_reckoning``) and fails past ``FITS_GIB``.  Checks:
    prefill's logits against forward's at 1023 and each decode step's
    against forward's at 1024 + i (``MODEL_LEVEL_TOL``,
    ``MODEL_LEVEL_RMS``); per decode step one B2 launch on the cluster
    engine per projection (q, k, v, o and the MLP's two or three) of
    every layer and one B6 launch on the mma engine per layer, per
    forward and prefill as many B1 launches on the wgmma engine and one
    B5 launch on its wgmma engine per layer, and 0 tile-loop, SIMT and
    grouped launches.  Prints the device ms and idle share of a decode
    step, the prefill and the forward (``profile_call``) against their
    bounds (``model_level_bounds``) and the peak memory beside what is
    held.  Returns (launch counts of the run, summary)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib

    run = MODEL_LEVEL[arch]
    short, b, frames, prefix, cache_len = (
        run[k] for k in ("short", "batch", "frames", "prefix", "cache_len"))
    steps = frames - prefix
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    nl = cfg.n_layers
    n_proj = 4 + (3 if cfg.mlp_type in ("swiglu", "geglu") else 2)
    bounds = model_level_bounds(cfg, b, frames, prefix, frames - 1,
                                cache_len)
    held = model_level_reckoning(cfg, bounds, b, frames)
    log(f"  [{short}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_params() / 1e9:.3f} B parameters; the card will hold "
        f"{ {k: round(v, 3) for k, v in held.items()} } = "
        f"{sum(held.values()):.3f} GB ({sum(held.values()) * 1e9 / 2**30:.2f}"
        f" GiB, limit {FITS_GIB} GiB), activations apart")
    require(sum(held.values()) * 1e9 / 2**30 <= FITS_GIB,
            f"{short}: the reckoning passes {FITS_GIB} GiB")
    reset_planning()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_biases(model_lib.init_params(cfg, seed=0, device=dev),
                           cfg)
    torch.cuda.synchronize()
    log(f"  [{short}] params: {model_lib.param_count(params) / 1e9:.3f} B "
        f"(bf16), init {time.perf_counter() - t0:.1f} s")
    emb = torch.randn(b, frames, cfg.d_model, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(11)
                      ).to(torch.bfloat16)
    build.reset_launch_counts()
    with torch.no_grad():
        full, _ = model_lib.forward(params, {"embeddings": emb}, cfg)
        first, cache = model_lib.prefill(
            params, {"embeddings": emb[:, :prefix]}, cfg,
            cache_len=cache_len)
        before = build.launch_counts()
        decoded = []
        for i in range(steps):
            logits, cache = model_lib.decode(
                params, {"embeddings": emb[:, prefix + i:prefix + i + 1],
                         "pos": prefix + i}, cache, cfg)
            decoded.append(logits)
        torch.cuda.synchronize()
        counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_counts = {k: (counts[k] - before.get(k, 0)) / steps
                   for k in counts if counts[k] != before.get(k, 0)}
    before = {k: v for k, v in before.items() if v}
    log(f"  [{short}] launches: forward + prefill {before}; per decode "
        f"step {step_counts}")
    require(step_counts == {"splitk_gemm_cluster": n_proj * nl,
                            "flash_decode_mma": nl},
            f"{short} decode step: launches {step_counts}, want "
            f"{n_proj * nl} splitk_gemm_cluster and {nl} flash_decode_mma")
    require(before == {"mte_gemm_wgmma": 2 * n_proj * nl,
                       "flash_attention_wgmma": 2 * nl},
            f"{short} forward + prefill: launches {before}, want "
            f"{2 * n_proj * nl} mte_gemm_wgmma and {2 * nl} "
            f"flash_attention_wgmma")
    # The q/k/v programs at M = 4352 (forward), 4096 (prefill) and 4
    # (decode), which the scheduler may group (B3); the checks above say
    # it did not.
    programs = log_programs(short)

    got = torch.stack([first] + decoded, dim=1)           # (B, 65, V)
    want = full[:, prefix - 1:]
    diff = (got - want).abs()
    rel = float((diff / (1 + want.abs())).max())
    rms = float((got - want).norm() / want.norm())
    argmax = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  [{short}] prefill and {steps} decode steps against forward: "
        f"max |diff| {float(diff.max()):.4e}, max |diff|/(1+|ref|) "
        f"{rel:.4e} (tol {MODEL_LEVEL_TOL}), RMS ratio {rms:.4e} (tol "
        f"{MODEL_LEVEL_RMS}), argmax agreement {argmax:.4f}")
    require(bool(torch.isfinite(full).all()) and full.shape == (
        b, frames, cfg.vocab), f"{short} forward: logits not finite or "
        f"of the wrong shape")
    require(rel <= MODEL_LEVEL_TOL and rms <= MODEL_LEVEL_RMS,
            f"{short}: prefill/decode logits differ from forward's "
            f"({rel}, {rms})")
    del full, first, decoded, got, want, diff

    pos = torch.tensor(frames - 1, device=dev)
    step_batch = {"embeddings": emb[:, -1:], "pos": pos}

    def decode_step():
        return model_lib.decode(params, step_batch, cache, cfg)

    def prefill():
        return model_lib.prefill(params, {"embeddings": emb[:, :prefix]},
                                 cfg, cache_len=cache_len)

    def forward():
        return model_lib.forward(params, {"embeddings": emb}, cfg)

    profiles = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for name, fn, n in (("decode_step", decode_step, 10),
                            ("prefill", prefill, 1),
                            ("forward", forward, 1)):
            profiles[name] = {**profile_call(fn, n), **bounds[name]}
            log_profile(name, profiles[name])
    peak_profiles = torch.cuda.max_memory_allocated()
    log(f"  [{short}] peak memory of the checked run {peak / 2**30:.2f} "
        f"GiB ({peak / 1e9:.3f} GB) beside {held} "
        f"({sum(held.values()):.3f} GB held at once, activations apart); "
        f"of the profiles (a second prefill's caches alive) "
        f"{peak_profiles / 1e9:.3f} GB; "
        f"decode step bound {bounds['decode_step']['bound_ms']:.3f} ms "
        f"({bounds['decode_step']['bound_ms_all_slots']:.3f} ms were all "
        f"{cache_len} slots read)")
    del params, cache, emb
    free_card()
    return counts, {"arch": arch, "launches_per_decode_step": step_counts,
                    "launches_forward_prefill": before,
                    "programs": programs,
                    "max_rel_err": rel, "rms_ratio": rms,
                    "argmax_agreement": argmax,
                    "peak_bytes": peak, "peak_bytes_profiles": peak_profiles,
                    "held_gb": held,
                    "profile": profiles, "bounds": bounds}


# -- phase 7: training -------------------------------------------------------

# Phase 7's full-width run: gemma_2b at its published widths, f32
# parameters from seed 0, ``SyntheticDataset`` batches of 1 x 4096 tokens
# (``train_4k``'s sequence; its global batch of 256 cut to 1 for one
# card), remat "full", the bf16 format, lr 3e-4: one warm step, then
# ``timed`` steps, then one profiled step.
TRAIN = dict(arch="gemma_2b", batch=1, seq=4096, lr=3e-4, timed=3)
# Card against CPU (phase 7a): reduced gemma_2b in fp32 over 4 x 32
# tokens; gemma_2b at full width and depth 2 in bf16 over 2 x 64 tokens.
# Gradient leaves within TRAIN_GRAD_TOL relative Frobenius error: fp32
# the CPU tests' bound against JAX, bf16 the port's bf16 tolerance
# (ROADMAP §C): the forward's bf16 roundings move on other engines.
TRAIN_GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# The depth-2 bf16 check runs once for each seed (parameters and data):
# the worst leaf's spread across seeds beside its gate.
TRAIN_DEPTH2_SEEDS = (0, 1)


def _frobenius(got, want) -> float:
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / (torch.linalg.vector_norm(want) + 1e-30))


def compare_grads(label, got, want, tol):
    """Every gradient leaf of ``got`` (the card's) within ``tol`` relative
    Frobenius error of ``want`` (the CPU's); returns the worst."""
    from repro_torch.tree import paths
    gp, wp = paths(got), paths(want)
    require(gp.keys() == wp.keys(), f"{label}: gradient trees differ")
    errs = {k: _frobenius(gp[k], wp[k]) for k in gp}
    worst = max(errs, key=errs.get)
    log(f"  {label} grads cuda vs cpu: worst leaf {worst} "
        f"{errs[worst]:.3e} (tol {tol:g}, {len(errs)} leaves)")
    require(errs[worst] <= tol, f"{label}: grad {worst} differs by "
            f"{errs[worst]}")
    return errs[worst]


def training_card_phase(dev):
    """Phase 7a, card against CPU.  reduced gemma_2b in fp32, under the
    rigid ``amx`` policy and in the port's default: 3 steps of
    ``loss_and_grads`` + ``adamw_update`` from one seed on both (each
    step's loss within 1e-5 relative, every gradient leaf within
    ``TRAIN_GRAD_TOL["fp32"]``, the parameters after the steps within
    1e-5), then ``microbatches=2`` against 1 on the card (loss 1e-4,
    parameters 2e-3, the reference's test), then ``train_loop`` with a
    checkpoint: 2 steps, a restart, 2 more, against 4 straight (rtol 1e-5,
    atol 1e-6, the reference's test; the card's embedding gradient sums
    repeated tokens with atomics, so not bit for bit).  Then gemma_2b at
    full width and depth 2 in bf16 over 2 x 64 tokens, once for each of
    ``TRAIN_DEPTH2_SEEDS`` (parameters and data): the loss within
    2e-2 x (1 + |ref|), every gradient leaf within
    ``TRAIN_GRAD_TOL["bf16"]``, and the card's AdamW update of the card's
    gradients equal to the CPU's update of the same gradients within
    1e-6.  Returns the card's launch counts (``train-reduced``,
    ``train-reduced-amx``, ``train-depth2``)."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import build
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizer as opt_lib
    from repro_torch.training import trainer
    from repro_torch.tree import leaves

    counts = {}
    base = get_config("gemma_2b").reduced()
    data = SyntheticDataset(DataConfig(vocab=base.vocab, seq_len=32,
                                       global_batch=4, seed=0))
    opt_cfg = opt_lib.AdamWConfig(lr=1e-3)
    # The port's default policy, then the rigid amx baseline (every GEMM,
    # forward and backward, on B8: stage 1 on the SIMT f32 engine).
    for policy, key in (("amx", "train-reduced-amx"),
                        ("mte", "train-reduced")):
        cfg = dataclasses.replace(base, gemm_policy=policy)
        reset_planning()
        sides = {}
        for device in (dev, "cpu"):
            params = model_lib.init_params(cfg, seed=0, device="cpu")
            params = to_device(params, device)
            sides[str(device)] = (params, opt_lib.init_opt_state(params))
        build.reset_launch_counts()
        for step in range(3):
            batch = data.batch(step)
            out = {}
            for device, (params, state) in sides.items():
                metrics, grads = trainer.loss_and_grads(
                    params, to_device(batch, device), cfg)
                out[device] = (float(metrics["loss"]), grads)
                opt_lib.adamw_update(params, grads, state, opt_cfg)
            (lg, gg), (lc, gc_) = out[str(dev)], out["cpu"]
            log(f"  reduced fp32 [{policy}] step {step}: loss cuda {lg:.6f} "
                f"cpu {lc:.6f}")
            require(abs(lg - lc) <= 1e-5 * abs(lc), f"[{policy}] step "
                    f"{step}: loss {lg} against {lc}")
            compare_grads(f"reduced fp32 [{policy}] step {step}", gg, gc_,
                          TRAIN_GRAD_TOL["fp32"])
        torch.cuda.synchronize()
        counts[key] = build.launch_counts()
        perr = max(max_err(a.cpu(), b) for a, b in zip(
            leaves(sides[str(dev)][0]), leaves(sides["cpu"][0])))
        log(f"  reduced fp32 [{policy}] params after 3 steps cuda vs cpu: "
            f"max_abs_err={perr:.3e} tol=1e-5")
        require(perr <= 1e-5, f"[{policy}] reduced params differ by {perr}")

    params = sides[str(dev)][0]
    batch = to_device(data.batch(3), dev)
    runs = []
    for mb in (1, 2):
        p = opt_lib.clone_tree(params)
        p, _, m = trainer.make_train_step(cfg, opt_cfg, mb)(
            p, opt_lib.init_opt_state(p), batch)
        runs.append((float(m["loss"]), p))
    perr = max(max_err(a, b) for a, b in zip(leaves(runs[0][1]),
                                              leaves(runs[1][1])))
    log(f"  microbatches 2 vs 1 on the card: loss {runs[1][0]:.6f} vs "
        f"{runs[0][0]:.6f}, params max_abs_err={perr:.3e} tol=2e-3")
    require(abs(runs[0][0] - runs[1][0]) <= 1e-4 * abs(runs[0][0])
            and perr <= 2e-3, "microbatching differs from one batch")
    del sides, runs

    kw = dict(batch=4, seq=32, lr=1e-3, log=lambda *a: None, seed=3,
              device=dev)
    straight, _ = train_loop(cfg, steps=4, **kw)
    with tempfile.TemporaryDirectory() as ckpt:
        train_loop(cfg, steps=2, ckpt_dir=ckpt, ckpt_every=100, **kw)
        resumed, _ = train_loop(cfg, steps=4, ckpt_dir=ckpt,
                                ckpt_every=100, **kw)
    pairs = list(zip(leaves(resumed), leaves(straight)))
    log(f"  train_loop 2 steps + restart + 2 against 4 straight: "
        f"max_abs_err={max(max_err(a, b) for a, b in pairs):.3e} (rtol "
        f"1e-5, atol 1e-6)")
    require(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                for a, b in pairs), "checkpoint resume differs")
    del straight, resumed, pairs

    log("== 7. gemma_2b at full width, depth 2 (bf16): training card "
        "against CPU")
    cfg = dataclasses.replace(get_config("gemma_2b"), n_layers=2)
    reset_planning()
    # The last seed's parameters and gradients go on to the AdamW check.
    for seed in TRAIN_DEPTH2_SEEDS:
        params_gpu = gg = None
        params_cpu = model_lib.init_params(cfg, seed=seed, device="cpu")
        params_gpu = to_device(params_cpu, dev)
        batch = SyntheticDataset(DataConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=2, seed=seed)).batch(0)
        build.reset_launch_counts()
        mg, gg = trainer.loss_and_grads(params_gpu, to_device(batch, dev),
                                        cfg)
        torch.cuda.synchronize()
        counts["train-depth2"] = build.launch_counts()
        mc, gc_ = trainer.loss_and_grads(params_cpu, batch, cfg)
        lg, lc = float(mg["loss"]), float(mc["loss"])
        log(f"  depth 2 bf16 seed {seed} loss cuda {lg:.6f} cpu {lc:.6f}")
        require(abs(lg - lc) <= 2e-2 * (1 + abs(lc)),
                f"depth 2 seed {seed}: loss differs")
        compare_grads(f"depth 2 bf16 seed {seed}", gg, gc_,
                      TRAIN_GRAD_TOL["bf16"])
        del gc_
    gg_cpu = to_device(gg, "cpu")
    opt_cfg = opt_lib.AdamWConfig(lr=TRAIN["lr"])
    opt_lib.adamw_update(params_gpu, gg, opt_lib.init_opt_state(params_gpu),
                         opt_cfg)
    opt_lib.adamw_update(params_cpu, gg_cpu,
                         opt_lib.init_opt_state(params_cpu), opt_cfg)
    perr = max(max_err(a.cpu(), b) for a, b in zip(leaves(params_gpu),
                                                    leaves(params_cpu)))
    log(f"  depth 2 AdamW of the card's grads, cuda vs cpu: max_abs_err="
        f"{perr:.3e} tol=1e-6")
    require(perr <= 1e-6, f"depth 2: AdamW differs by {perr}")
    # Every GEMM of 32 rows or more with widths multiples of 4 runs f32 on
    # the SIMT engine (the reduced model's forward and backward, the depth-2
    # model's backward), none on the tile loops; under amx every GEMM runs
    # B8 stage 1 on it, at every M, and none runs B1 or B2.
    for label, on, off in (
            ("train-reduced", ("mte_gemm_simt",), ("mte_gemm",
                                                   "splitk_gemm")),
            ("train-reduced-amx", ("rigid_gemm_simt",),
             ("rigid_gemm", "mte_gemm", "mte_gemm_simt", "splitk_gemm",
              "splitk_gemm_simt")),
            ("train-depth2", ("mte_gemm_wgmma", "mte_gemm_simt",
                              "flash_attention_wgmma"),
             ("mte_gemm", "splitk_gemm"))):
        got = {k: v for k, v in counts[label].items() if v}
        log(f"  [{label}] launches {got}")
        for kernel in on:
            require(got.get(kernel, 0) > 0, f"{label}: {kernel} not "
                    f"launched")
        for kernel in off:
            require(kernel not in got, f"{label}: {got.get(kernel)} "
                    f"launches of {kernel}")
    del params_gpu, gg
    free_card()
    return counts


def train_bounds(cfg, batch, seq):
    """The least time of one full-width train step on the card: bf16
    operations (the projections' forward once, the attention's forward
    over the causal pairs, the LM head's forward on bf16-rounded operands)
    at 989 TFLOP/s plus f32 operations (the projections' dA and dB, the
    attention's backward, the LM head's dx and dW) at 67 TFLOP/s, against
    the bytes the update must move (parameters, m and v read and written,
    f32: 24 bytes a parameter) at 3.35 TB/s."""
    d, f, h, hkv, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    nl, vocab, tokens = cfg.n_layers, cfg.vocab, batch * seq
    proj = nl * (d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * f)
    n_params = proj + vocab * d + nl * 2 * d + d
    attn = nl * 4.0 * batch * h * hd * seq * (seq + 1) / 2
    head = 2.0 * tokens * d * vocab
    bf16 = 2.0 * tokens * proj + attn + head
    f32 = 4.0 * tokens * proj + 2 * attn + 2 * head
    nbytes = 24.0 * n_params
    ops_ms = 1e3 * (bf16 / PEAK["bf16"] + f32 / PEAK["fp32"])
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bf16_tflop": bf16 / 1e12, "f32_tflop": f32 / 1e12,
            "bytes_gb": nbytes / 1e9, "params": n_params,
            "reckoning_gb": {
                "params_f32": 4 * n_params / 1e9,
                "grads_f32": 4 * n_params / 1e9,
                "adam_m_v": 8 * n_params / 1e9,
                "logits_f32": 4 * tokens * vocab / 1e9,
                "logits_grad_f32": 4 * tokens * vocab / 1e9,
                "lm_head_f32_table": 4 * vocab * d / 1e9}}


def backward_gemms(cfg) -> int:
    """The backward GEMMs of one step of an attention + MLP stack: two per
    projection (dA, dB; q, k, v, o and the MLP's) and the accumulator's
    recompute of the one projection whose epilogue's derivative reads it
    (the MLP's activation)."""
    gated = cfg.mlp_type in ("swiglu", "geglu")
    return cfg.n_layers * (2 * (4 + (3 if gated else 2)) + 1)


def training_phase(dev, policy="mte", ref_loss=None):
    """Phase 7b (``policy="mte"``) and 7c (``"amx"``, the rigid baseline):
    gemma_2b trained at full width on the card (``TRAIN``): one warm
    step, ``timed`` steps timed by the host clock around a synchronise,
    then one step profiled (``profile_call``: device busy ms, idle share
    and the device time by kernel).  Each step's loss and grad norm must
    be finite, the parameters must change, and every backward GEMM must
    run on the SIMT f32 engine: per step, under mte B1's or B2's launches
    (``mte_gemm_simt``, ``splitk_gemm_simt``) equal ``backward_gemms`` and
    the tile loops' (``mte_gemm``, ``splitk_gemm``) are 0; under amx B8
    stage 1's (``rigid_gemm_simt``) equal ``backward_gemms``, none runs
    B1, B2 or a tile loop, the forward runs ``rigid_gemm_wgmma`` and
    ``epilogue_pass``, and the first step's loss is within 2e-2 x (1 +
    |ref|) of ``ref_loss`` (7b's first loss, the same seed).  Prints each
    step's wall ms, the step's bound (``train_bounds``), the launches per
    step per counter, each compiled program's grouping decision, and the
    peak memory beside the reckoning.  Returns (launch counts of the
    timed steps, summary)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizer as opt_lib
    from repro_torch.training import trainer

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), gemm_policy=policy)
    batch, seq, timed = TRAIN["batch"], TRAIN["seq"], TRAIN["timed"]
    reset_planning()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, seed=0, device=dev)
    opt_state = opt_lib.init_opt_state(params)
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=batch, seed=0),
                            device=dev)
    step_fn = trainer.make_train_step(cfg, opt_lib.AdamWConfig(
        lr=TRAIN["lr"]))
    def watched():
        return {"gate": params["layers"][0]["ffn"]["gate"]["w"][:4],
                "final_norm": params["final_norm"]["scale"]}

    before = {k: v.clone() for k, v in watched().items()}
    metrics_log = []

    def step():
        nonlocal params, opt_state
        params, opt_state, m = step_fn(params, opt_state, data.batch())
        return m

    def record(m, wall_ms=None):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        metrics_log.append({"loss": loss, "grad_norm": gnorm,
                            "wall_ms": wall_ms})
        log(f"  [train {policy}] step {len(metrics_log) - 1}: loss "
            f"{loss:.4f}, grad "
            f"norm {gnorm:.4f}"
            + (f", wall {wall_ms:.1f} ms" if wall_ms is not None else ""))
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"step {len(metrics_log) - 1}: loss {loss}, grad norm "
                f"{gnorm}")

    t = time.perf_counter()
    record(step(), 1e3 * (time.perf_counter() - t))       # warm
    programs = log_programs(f"train {policy}")
    if ref_loss is not None:
        first = metrics_log[0]["loss"]
        log(f"  [train {policy}] first loss {first:.6f} against the mte "
            f"run's {ref_loss:.6f} (tol 2e-2 x (1 + |ref|))")
        require(abs(first - ref_loss) <= 2e-2 * (1 + abs(ref_loss)),
                f"[train {policy}] first loss {first} against {ref_loss}")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step()
        torch.cuda.synchronize()
        record(m, 1e3 * (time.perf_counter() - t))
    counts = build.launch_counts()
    per_step = {k: v / timed for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    bounds = train_bounds(cfg, batch, seq)
    prof = {**profile_call(lambda: record(step()), 1), **bounds}
    log_profile(f"train_step {policy}", prof)
    for r in prof["kernels"]:
        if r["ms"] >= 0.5:
            log(f"    [train {policy}] {r['ms']:.3f} ms x{r['calls']} "
                f"{r['kernel']}")
    changed = {k: max_err(v, before[k]) for k, v in watched().items()}
    held = bounds["reckoning_gb"]
    log(f"  [train {policy}] launches per step {per_step}; backward GEMMs "
        f"per step "
        f"{backward_gemms(cfg)}")
    log(f"  [train {policy}] peak memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.3f} "
        f"GB) beside the reckoning {held} ({sum(held.values()):.3f} GB, "
        f"activations and layer transients apart); bound "
        f"{bounds['bound_ms']:.1f} ms ({bounds['bound_by']}: "
        f"{bounds['bf16_tflop']:.2f} bf16 TFLOP, {bounds['f32_tflop']:.2f} "
        f"f32 TFLOP, {bounds['bytes_gb']:.1f} GB); parameters moved by "
        f"{changed}")
    require(all(v > 0 for v in changed.values()),
            f"the parameters did not change: {changed}")
    if policy == "amx":
        simt = per_step.get("rigid_gemm_simt", 0)
        off = ("rigid_gemm", "mte_gemm", "splitk_gemm", "mte_gemm_simt",
               "splitk_gemm_simt", "mte_gemm_wgmma")
        on = ("rigid_gemm_wgmma", "epilogue_pass", "flash_attention_wgmma")
    else:
        simt = (per_step.get("mte_gemm_simt", 0)
                + per_step.get("splitk_gemm_simt", 0))
        off = ("mte_gemm", "splitk_gemm")
        on = ("mte_gemm_wgmma", "flash_attention_wgmma")
    require(simt == backward_gemms(cfg),
            f"[{policy}] backward GEMMs per step on the SIMT f32 engine: "
            f"{simt}, want {backward_gemms(cfg)}")
    for kernel in off:
        require(per_step.get(kernel, 0) == 0, f"[{policy}] "
                f"{per_step.get(kernel)} launches of {kernel} per step")
    for kernel in on:
        require(per_step.get(kernel, 0) > 0, f"train {policy}: {kernel} "
                f"not launched")
    walls = [r["wall_ms"] for r in metrics_log[1:1 + timed]]
    summary = {"steps": metrics_log, "step_wall_ms": walls,
               "launches_per_step": per_step,
               "backward_gemms_per_step": backward_gemms(cfg),
               "programs": programs, "peak_bytes": peak,
               "profile": prof, "bounds": bounds,
               "param_change": changed}
    del params, opt_state, before
    free_card()
    return counts, summary


# (counter, source, the TPU kernel it replaces, the row of phase 2 that
# stands for it, the configuration whose main path counts its launches)
# -- phase 8: the paper's convolutions on B3 ----------------------------------

CONV_MB = 16
# The 75 unique convolutions of the paper's suite (§V-B2) at minibatch 16,
# from the published network definitions: ResNet-50, VGG-16, SqueezeNet
# 1.1, Inception-v3 and Darknet-19 (YOLO).  (name, H, IC, OC, K, stride,
# pad, W): a K x K kernel, pad K // 2 and W = H where None.
CONV_SUITE = [
    # ResNet-50
    ("rn.conv1", 224, 3, 64, 7, 2, 3, None),
    ("rn.c2.a", 56, 64, 64, 1, 1, None, None),
    ("rn.c2.b", 56, 64, 64, 3, 1, None, None),
    ("rn.c2.c", 56, 64, 256, 1, 1, None, None),
    ("rn.c2.d", 56, 256, 64, 1, 1, None, None),
    ("rn.c3.a", 56, 256, 128, 1, 2, None, None),
    ("rn.c3.b", 28, 128, 128, 3, 1, None, None),
    ("rn.c3.c", 28, 128, 512, 1, 1, None, None),
    ("rn.c3.d", 28, 512, 128, 1, 1, None, None),
    ("rn.c4.a", 28, 512, 256, 1, 2, None, None),
    ("rn.c4.b", 14, 256, 256, 3, 1, None, None),
    ("rn.c4.c", 14, 256, 1024, 1, 1, None, None),
    ("rn.c4.d", 14, 1024, 256, 1, 1, None, None),
    ("rn.c5.down", 14, 1024, 2048, 1, 2, None, None),
    ("rn.c5.a", 14, 1024, 512, 1, 2, None, None),
    ("rn.c5.b", 7, 512, 512, 3, 1, None, None),
    ("rn.c5.c", 7, 512, 2048, 1, 1, None, None),
    ("rn.c5.d", 7, 2048, 512, 1, 1, None, None),
    # VGG-16
    ("vgg.1_1", 224, 3, 64, 3, 1, None, None),
    ("vgg.1_2", 224, 64, 64, 3, 1, None, None),
    ("vgg.2_1", 112, 64, 128, 3, 1, None, None),
    ("vgg.2_2", 112, 128, 128, 3, 1, None, None),
    ("vgg.3_1", 56, 128, 256, 3, 1, None, None),
    ("vgg.3_2", 56, 256, 256, 3, 1, None, None),
    ("vgg.4_1", 28, 256, 512, 3, 1, None, None),
    ("vgg.4_2", 28, 512, 512, 3, 1, None, None),
    # SqueezeNet 1.1
    ("sq.conv1", 224, 3, 64, 3, 2, 0, None),
    ("sq.f2.s", 56, 64, 16, 1, 1, None, None),
    ("sq.f2.e1", 56, 16, 64, 1, 1, None, None),
    ("sq.f2.e3", 56, 16, 64, 3, 1, None, None),
    ("sq.f4.s", 28, 128, 32, 1, 1, None, None),
    ("sq.f4.e1", 28, 32, 128, 1, 1, None, None),
    ("sq.f4.e3", 28, 32, 128, 3, 1, None, None),
    ("sq.f6.s", 14, 256, 48, 1, 1, None, None),
    ("sq.f6.e1", 14, 48, 192, 1, 1, None, None),
    ("sq.f6.e3", 14, 48, 192, 3, 1, None, None),
    ("sq.f8.s", 14, 384, 64, 1, 1, None, None),
    ("sq.f8.e1", 14, 64, 256, 1, 1, None, None),
    ("sq.f8.e3", 14, 64, 256, 3, 1, None, None),
    ("sq.f9.s", 14, 512, 64, 1, 1, None, None),
    # Inception-v3 (the factorized 1x7 as a 1 x 1 over 17 x 17)
    ("in.c1", 299, 3, 32, 3, 2, 0, None),
    ("in.c2", 149, 32, 32, 3, 1, 0, None),
    ("in.c3", 147, 32, 64, 3, 1, None, None),
    ("in.c4", 73, 64, 80, 1, 1, 0, None),
    ("in.c5", 73, 80, 192, 3, 1, 0, None),
    ("in.m5.1x1", 35, 192, 64, 1, 1, None, None),
    ("in.m5.5x5r", 35, 192, 48, 1, 1, None, None),
    ("in.m5.5x5", 35, 48, 64, 5, 1, None, None),
    ("in.m5.3x3r", 35, 192, 96, 1, 1, None, None),
    ("in.m5.3x3", 35, 96, 96, 3, 1, None, None),
    ("in.m5.pool", 35, 192, 32, 1, 1, None, None),
    ("in.m6.3x3", 35, 288, 384, 3, 2, 0, None),
    ("in.m6.7x7r", 17, 768, 128, 1, 1, None, None),
    ("in.m6.1x7", 17, 128, 128, 1, 1, 0, 17),
    ("in.m6.7x1", 17, 128, 192, 7, 1, 3, None),
    ("in.m6e.r", 17, 768, 192, 1, 1, None, None),
    ("in.m6e.7x1", 17, 192, 192, 7, 1, 3, None),
    ("in.m7.3x3r", 17, 768, 320, 1, 1, None, None),
    ("in.m7.3x3", 17, 320, 320, 3, 2, 0, None),
    ("in.m8.1x1", 8, 1280, 320, 1, 1, None, None),
    ("in.m8.3x3r", 8, 1280, 448, 1, 1, None, None),
    ("in.m8.3x3", 8, 448, 384, 3, 1, None, None),
    ("in.m8.b", 8, 1280, 384, 1, 1, None, None),
    ("in.m8c.1x1", 8, 2048, 320, 1, 1, None, None),
    ("in.m8c.b", 8, 2048, 448, 1, 1, None, None),
    # Darknet-19 (YOLO)
    ("yl.c1", 416, 3, 32, 3, 1, None, None),
    ("yl.c2", 208, 32, 64, 3, 1, None, None),
    ("yl.c3", 104, 64, 128, 3, 1, None, None),
    ("yl.c5", 52, 128, 256, 3, 1, None, None),
    ("yl.c6", 52, 256, 128, 1, 1, None, None),
    ("yl.c7", 26, 256, 512, 3, 1, None, None),
    ("yl.c8", 26, 512, 256, 1, 1, None, None),
    ("yl.c9", 13, 512, 1024, 3, 1, None, None),
    ("yl.c10", 13, 1024, 512, 1, 1, None, None),
    ("yl.head", 13, 1024, 425, 1, 1, None, None),
]
# The layers whose channels no B3 engine takes (IC = 3: K is not a
# multiple of 4, 8 or 16; yl.head's OC = 425: N is not a multiple of 4 or
# 8): the only ones that may run the tile loop.
CONV_UNALIGNED = {"rn.conv1", "vgg.1_1", "sq.conv1", "in.c1", "yl.c1",
                  "yl.head"}
# B3's counters past 16 rows: the engine a convolution's one launch ran.
CONV_ENGINES = ("grouped_gemm_simt", "grouped_gemm_wgmma",
                "grouped_gemm_wgmma_s8", "grouped_gemm")
# Each counter's name in ``geometry.grouped_engine``.
CONV_ENGINE_OF = {"grouped_gemm_simt": "simt", "grouped_gemm_wgmma": "wgmma",
                  "grouped_gemm_wgmma_s8": "wgmma", "grouped_gemm": "tile"}
# The formats the phase runs and on which layers (int8: ResNet-50's 18).
CONV_FORMATS = {"fp32": "", "bf16": "", "int8": "rn."}
# Tolerances, of max |got - want| over the RMS of want: against the plain
# version (``backend="reference"`` on the card; int8 exactly equal) and
# against ``F.conv2d`` on the format's rounded inputs in f32 (TF32 off),
# an oracle only.  int8 quantizes each window row and weight column to
# 127 levels, which F.conv2d does not: its error is held in max and in
# RMS (``CONV_INT8_ORACLE_RMS``).
CONV_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 0.0}
CONV_ORACLE_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 0.15}
CONV_INT8_ORACLE_RMS = 2e-2
# The sleep before each timed batch of a conv or dispatch row (~10 ms):
# these calls enqueue in well under a millisecond each.
SHORT_SLEEP = 20_000_000


def conv_specs():
    """:data:`CONV_SUITE` as the port's ``ConvSpec`` rows."""
    from repro_torch.core.conv import ConvSpec
    return [ConvSpec(name, CONV_MB, h, w or h, ic, oc, k, k, stride,
                     k // 2 if pad is None else pad)
            for name, h, ic, oc, k, stride, pad, w in CONV_SUITE]


def rms_err(got, want):
    """(max |got - want|, the same over the RMS of want, the RMS of
    got - want over the RMS of want)."""
    d = (got.float() - want.float())
    scale = float(want.float().pow(2).mean().sqrt())
    worst = float(d.abs().max())
    return worst, worst / scale, float(d.pow(2).mean().sqrt()) / scale


def conv_oracle(x, wt, bias, spec, fmt):
    """``F.conv2d`` (channels-last) of the format's rounded operands in
    f32, then the phase's epilogue (bias, relu)."""
    import torch
    import torch.nn.functional as F
    if fmt == "bf16":
        x, wt = x.bfloat16().float(), wt.bfloat16().float()
    out = F.conv2d(x.permute(0, 3, 1, 2),
                   wt.permute(3, 2, 0, 1).contiguous(
                       memory_format=torch.channels_last),
                   bias, stride=spec.stride, padding=spec.pad)
    return torch.relu(out.permute(0, 2, 3, 1))


def conv_row(dev, spec, fmt, gen, path):
    """One convolution through ``conv2d_direct(backend="kernels")`` (the
    path: launch counters zeroed just before and read just after, summed
    into ``path``), held against the plain version and ``F.conv2d``,
    then timed: the B3 launch alone (warm and L2-cold), the whole
    ``conv2d_direct``, the kernel's plain version, ``torch.bmm`` at the
    grouped shape and ``F.conv2d``.  Returns the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import dispatch, formats
    from repro_torch.core.conv import conv2d_direct, conv_gemm_dims, \
        stack_windows
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.kernels import build
    from repro_torch.core.geometry import grouped_engine
    from repro_torch.kernels.grouped_gemm import grouped_gemm_kernel, \
        grouped_gemm_torch
    g = spec.kh * spec.kw
    m, n, k = conv_gemm_dims(spec)
    x = torch.randn((spec.n, spec.h, spec.w, spec.ic), generator=gen,
                    device=dev)
    wt = torch.randn((spec.kh, spec.kw, spec.ic, spec.oc), generator=gen,
                     device=dev) / math.sqrt(g * spec.ic)
    bias = torch.randn((spec.oc,), generator=gen, device=dev)
    kw = dict(stride=spec.stride, pad=spec.pad, format_policy=fmt,
              epilogue=Epilogue(has_bias=True, activation="relu"))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    got = conv2d_direct(x, wt, bias, backend="kernels", **kw)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - before
    for name, v in counts.items():
        path[name] = path.get(name, 0) + v
    ran = {name: v for name, v in counts.items() if v}
    require(len(ran) == 1 and sum(ran.values()) == 1
            and next(iter(ran)) in CONV_ENGINES,
            f"conv {fmt} {spec.name}: {ran} is not one B3 launch")
    engine = next(iter(ran))
    require((engine == "grouped_gemm") == (spec.name in CONV_UNALIGNED),
            f"conv {fmt} {spec.name}: ran {engine}; only the unaligned "
            f"layers {sorted(CONV_UNALIGNED)} may run the tile loop")
    require(tuple(got.shape) == (spec.n, spec.oh, spec.ow, spec.oc)
            and bool(torch.isfinite(got).all()),
            f"conv {fmt} {spec.name}: shape {tuple(got.shape)} or "
            f"non-finite values")
    want = conv2d_direct(x, wt, bias, backend="reference", **kw)
    if fmt == "int8":
        require(torch.equal(got, want),
                f"conv int8 {spec.name}: differs from the plain version")
        abs_err = err = 0.0
    else:
        abs_err, err, _ = rms_err(got, want)
        require(err <= CONV_TOL[fmt], f"conv {fmt} {spec.name}: "
                f"{err:.3e} x RMS from the plain version, over "
                f"{CONV_TOL[fmt]:g}")
    del want
    _, oracle, oracle_rms = rms_err(got, conv_oracle(x, wt, bias, spec,
                                                     fmt))
    require(oracle <= CONV_ORACLE_TOL[fmt]
            and (fmt != "int8" or oracle_rms <= CONV_INT8_ORACLE_RMS),
            f"conv {fmt} {spec.name}: {oracle:.3e} (RMS {oracle_rms:.3e}) "
            f"x RMS from F.conv2d, over {CONV_ORACLE_TOL[fmt]:g}")
    del got

    grant = dispatch.plan_gemm(m, n, k, format_policy=fmt, group=g)
    geom = grant.geometry
    sig = grant.plan.signature
    # B3's engine at the plan's tile (a one-member group plans as its
    # member's plain GEMM, route "mte" or "splitk", but B3 runs it).
    b3 = grouped_engine(sig.dtype_in, m, n, k,
                        bf16acc=sig.format_policy.accum_dtype == "bfloat16",
                        tile=(geom.bm, geom.bn))
    require(CONV_ENGINE_OF[engine] == b3, f"conv {fmt} {spec.name}: ran "
            f"{engine}, the plan's tile names B3's {b3} engine")
    f = formats.resolve_format(fmt)
    xs = x if f.quantized else x.to(f.operand_torch)
    xg = stack_windows(xs, spec.kh, spec.kw, spec.stride, spec.pad)
    wg = (wt if f.quantized else wt.to(f.operand_torch)).reshape(g, k, n)
    if f.quantized:
        xg, wg, _, _ = formats.quantize_operands(xg, wg, f)
    out_dt = torch.int32 if f.quantized else torch.float32

    def kernel():
        return grouped_gemm_kernel(xg, wg, geom=geom, out_dtype=out_dt,
                                   acc_dtype=f.accum_torch, split_rows=m)

    def conv():
        return conv2d_direct(x, wt, bias, backend="kernels", **kw)

    row = {"kernel": engine, "shape": f"conv {fmt} {spec.name}",
           "fmt": fmt, "layer": spec.name, "g": g, "m": m, "n": n, "k": k,
           "route": "grouped", "engine": b3,
           "tile": [geom.bm, geom.bn, geom.bk, geom.split_k],
           "tile_state": hex(grant.tile_state.encode()),
           "max_abs_err": abs_err, "err_over_rms": err,
           "oracle_err": oracle,
           "oracle_rms_err": oracle_rms, "peak_gb": peak / 1e9,
           "ms": time_ms(kernel, sleep_cycles=SHORT_SLEEP),
           "cold_ms": time_ms_cold(kernel),
           "conv_ms": time_ms(conv, sleep_cycles=SHORT_SLEEP),
           "plain_ms": time_ms(lambda: grouped_gemm_torch(
               xg, wg, geom=geom, out_dtype=out_dt), iters=3, warmup=1)}
    if f.quantized:
        # One torch._int_mm computes a one-member group (a 1 x 1 layer);
        # a G > 1 launch has no one library call.
        lib = (int_mm_call(xg[0], wg[0], wg[0].t().contiguous())
               if g == 1 else None)
        if lib is not None:
            require(torch.equal(lib(), kernel()[0]), f"conv int8 "
                    f"{spec.name}: torch._int_mm differs from the kernel")
        row["library"] = "torch._int_mm" if lib is not None else None
        row["library_ms"] = (time_ms(lib, sleep_cycles=SHORT_SLEEP)
                             if lib is not None else None)
        row["conv2d_ms"] = None
    else:
        xn = xs.permute(0, 3, 1, 2)
        wn = wt.to(xs.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row["library"] = "torch.bmm"
        row["library_ms"] = time_ms(lambda: torch.bmm(xg, wg),
                                    sleep_cycles=SHORT_SLEEP)
        row["conv2d_ms"] = time_ms(lambda: F.conv2d(
            xn, wn, stride=spec.stride, padding=spec.pad),
            sleep_cycles=SHORT_SLEEP)
    nbytes = (xg.numel() * xg.element_size() + wg.numel()
              * wg.element_size() + g * m * n * 4)
    row["bound_ms"] = bound_ms(spec.flops, nbytes, PEAK[fmt])
    row["bound_by"] = bound_by(spec.flops, nbytes, PEAK[fmt])
    log(f"  conv {fmt} {spec.name} G={g} M={m} N={n} K={k}: {engine} "
        f"{geom.bm}x{geom.bn}x{geom.bk}"
        f"{f' (plan split {geom.split_k})' if geom.split_k > 1 else ''} "
        f"csr {row['tile_state']}; kernel {row['ms']:.4f} ms (cold "
        f"{row['cold_ms']:.4f}), conv2d_direct {row['conv_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), plain "
        f"{row['plain_ms']:.4f}, {row['library']} "
        + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None
           else "none (G > 1: no one call)")
        + (f", F.conv2d {row['conv2d_ms']:.4f}"
           if row["conv2d_ms"] is not None else ", F.conv2d none")
        + f"; peak {row['peak_gb']:.3f} GB; err {err:.2e} x RMS "
        f"(tol {CONV_TOL[fmt]:g}), F.conv2d {oracle:.2e} (tol "
        f"{CONV_ORACLE_TOL[fmt]:g}, RMS {oracle_rms:.2e})")
    return row


def conv_phase(dev, rows):
    """The paper's 75 convolutions (:data:`CONV_SUITE`) in fp32 and bf16
    and ResNet-50's 18 in int8, each one B3 launch through
    ``conv2d_direct``: every aligned layer on B3's SIMT, wgmma or s8
    engine, only :data:`CONV_UNALIGNED` on the tile loop.  Returns the
    path's launch counts (the conv calls only)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reset_planning()
    path = {}
    for fmt, prefix in CONV_FORMATS.items():
        t = time.perf_counter()
        fmt_rows = [conv_row(dev, spec, fmt, gen, path)
                    for spec in conv_specs() if spec.name.startswith(prefix)]
        rows.extend(fmt_rows)
        by = {}
        for r in fmt_rows:
            by.setdefault(r["kernel"], []).append(r["ms"])
        log(f"  conv {fmt}: {len(fmt_rows)} layers in "
            f"{time.perf_counter() - t:.1f} s; kernel ms by engine "
            f"{ {e: round(sum(v), 4) for e, v in by.items()} }; all "
            f"{sum(r['ms'] for r in fmt_rows):.4f} ms, conv2d_direct "
            f"{sum(r['conv_ms'] for r in fmt_rows):.4f} ms"
            + (f", F.conv2d {sum(r['conv2d_ms'] for r in fmt_rows):.4f} ms"
               if fmt != "int8" else
               f"; the {sum(r['g'] == 1 for r in fmt_rows)} 1 x 1 layers "
               f"{sum(r['ms'] for r in fmt_rows if r['g'] == 1):.4f} ms, "
               f"torch._int_mm "
               f"{sum(r['library_ms'] for r in fmt_rows if r['g'] == 1):.4f}"
               f" ms"))
        free_card()
    log(f"  conv launches: {path}")
    for name in CONV_ENGINES:
        require(path.get(name, 0) > 0, f"conv: {name} never launched")
    return path


# -- phase 9: the paper's transformer GEMMs through dispatch.mte_gemm ---------

# The paper's 18 transformer GEMMs (§V-B3): BERT/GPT-2 projections at
# queries 16 and 32, d_model 512 and 768 (q/k/v, attention out, the two
# feed-forward GEMMs with 2048 hidden units), and the two BERT4Rec GEMMs
# at sequence 200.  (name, M, N, K).
TRANSFORMER_GEMMS = [
    (f"t.q{q}.d{d}.{what}", q, n, k)
    for q in (16, 32) for d in (512, 768)
    for what, n, k in (("qkv", 3 * d, d), ("attn_out", d, d),
                       ("ff1", 2048, d), ("ff2", d, 2048))
] + [("rec.seq200.proj", 200, 768, 768), ("rec.seq200.ff1", 200, 2048, 768)]
DISPATCH_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# The paper's CPU design points the model compares: MTE with 32
# registers against the 8-register AMX-like design.
MODEL_PAIR = ("mte32s", "mte8s")


def dispatch_row(dev, name, m, n, k, fmt, policy, gen, path):
    """One GEMM through ``dispatch.mte_gemm(backend="kernels")`` (the
    path: counters zeroed before, read after, summed into ``path``), held
    against ``backend="reference"`` on the card, and its launch timed
    alone (the plan's route on pre-cast operands), beside the plain
    version and ``torch.matmul``."""
    import torch
    from repro_torch.core import autotune, dispatch, formats
    from repro_torch.kernels import build
    a = torch.randn((m, k), generator=gen, device=dev) / math.sqrt(k)
    b = torch.randn((k, n), generator=gen, device=dev)
    kw = dict(policy=policy, format_policy=fmt)
    build.reset_launch_counts()
    got = dispatch.mte_gemm(a, b, backend="kernels", **kw)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    for c, v in counts.items():
        path[c] = path.get(c, 0) + v
    ran = {c: v for c, v in counts.items() if v}
    require(len(ran) == 1 and sum(ran.values()) == 1,
            f"dispatch {fmt} {policy} {name}: {ran} is not one launch")
    kernel = next(iter(ran))
    want = dispatch.mte_gemm(a, b, backend="reference", **kw)
    err = check(f"{name} {fmt} {policy}", got, want, DISPATCH_TOL[fmt])
    grant = dispatch.plan_gemm(m, n, k, format_policy=fmt, policy=policy)
    geom = grant.geometry
    f = formats.resolve_format(fmt)
    ac, bc = a.to(f.operand_torch), b.to(f.operand_torch)
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n) * ac.element_size() + m * n * 4
    return {
        "kernel": kernel, "shape": f"dispatch {fmt} {policy} {name}",
        "fmt": fmt, "policy": policy, "gemm": name, "m": m, "n": n, "k": k,
        "route": grant.route, "engine": grant.engine,
        "tile": [geom.bm, geom.bn, geom.bk, geom.split_k],
        "tile_state": hex(grant.tile_state.encode()), "max_abs_err": err,
        "ms": time_ms(lambda: autotune.execute_plan(grant.plan, ac, bc),
                      sleep_cycles=SHORT_SLEEP),
        "plain_ms": time_ms(lambda: dispatch.mte_gemm(
            a, b, backend="reference", **kw), sleep_cycles=SHORT_SLEEP),
        "library_ms": time_ms(lambda: torch.matmul(ac, bc),
                              sleep_cycles=SHORT_SLEEP),
        "bound_ms": bound_ms(flops, nbytes, PEAK[fmt]),
        "bound_by": bound_by(flops, nbytes, PEAK[fmt])}


def dispatch_phase(dev, rows):
    """The paper's 18 transformer GEMMs through ``dispatch.mte_gemm`` on
    the kernels under ``policy="mte"`` (B1, B2) and ``"amx"`` (B8), in
    fp32 and bf16, each held against ``backend="reference"``; prints the
    route, engine, tile and CSR word of each, kernel ms under both
    policies and their ratio, beside the paper's CPU model
    (``perfmodel.model_all``) and instruction counts (``isa.count_all``)
    for the same shapes.  Returns the path's launch counts."""
    import torch
    from repro_torch.core import isa, perfmodel
    from repro_torch.core.tile_state import SEW
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    reset_planning()
    path = {}
    for fmt in DISPATCH_TOL:
        sew_i = SEW.E32 if fmt == "fp32" else SEW.E16
        for name, m, n, k in TRANSFORMER_GEMMS:
            pair = {p: dispatch_row(dev, name, m, n, k, fmt, p, gen, path)
                    for p in ("mte", "amx")}
            ratio = pair["mte"]["ms"] / pair["amx"]["ms"]
            model = perfmodel.model_all(m, n, k, sew_i, SEW.E32)
            counts = isa.count_all(m, n, k, sew_i, SEW.E32)
            lo, hi = MODEL_PAIR
            for r in pair.values():
                r["mte_over_amx"] = ratio
                r["model_s"] = {a: t.seconds for a, t in model.items()}
                r["model_efficiency"] = {a: t.efficiency
                                         for a, t in model.items()}
                r["isa_total"] = {a: c.total for a, c in counts.items()}
            rows.extend(pair.values())
            mte, amx = pair["mte"], pair["amx"]
            log(f"  {fmt} {name} {m}x{n}x{k}: mte {mte['kernel']} "
                f"{mte['route']}/{mte['engine']} "
                f"{'x'.join(map(str, mte['tile'][:3]))} split "
                f"{mte['tile'][3]} csr {mte['tile_state']} {mte['ms']:.4f} "
                f"ms; amx {amx['kernel']} {amx['engine']} csr "
                f"{amx['tile_state']} {amx['ms']:.4f} ms; mte/amx "
                f"{ratio:.3f} (bound {mte['bound_ms']:.4f} ms, "
                f"{mte['bound_by']}; torch.matmul {mte['library_ms']:.4f}); "
                f"the paper's CPU model, not the H100: {lo} "
                f"{model[lo].seconds * 1e6:.2f} us (eff "
                f"{model[lo].efficiency:.3f}), {hi} "
                f"{model[hi].seconds * 1e6:.2f} us, speedup "
                f"{model[hi].seconds / model[lo].seconds:.3f}; retired "
                f"{ {a: c.total for a, c in counts.items()} }")
    log(f"  dispatch launches: {path}")
    return path


KERNELS = [
    ("mte_gemm_wgmma", "src/repro_torch/csrc/mte_gemm.cu",
     "src/repro/kernels/mte_gemm.py:114", "gate 512x16384x2048", "default"),
    ("mte_gemm_wgmma_s8", "src/repro_torch/csrc/mte_gemm.cu",
     "src/repro/kernels/mte_gemm.py:114", "int8 gate 512x16384x2048",
     "int8"),
    ("mte_gemm_simt", "src/repro_torch/csrc/mte_gemm.cu",
     "src/repro/kernels/mte_gemm.py:114",
     "train gate recompute fp32 4096x16384x2048", "train"),
    ("mte_gemm", "src/repro_torch/csrc/mte_gemm.cu",
     "src/repro/kernels/mte_gemm.py:114", "qr o 16x128x128 bf16acc",
     "reduced-qwen"),
    ("splitk_gemm_cluster", "src/repro_torch/csrc/splitk_gemm_cluster.cu",
     "src/repro/kernels/splitk_gemm.py:60", "gate 4x16384x2048", "default"),
    ("splitk_gemm_cluster_s8", "src/repro_torch/csrc/splitk_gemm_cluster.cu",
     "src/repro/kernels/splitk_gemm.py:60", "int8 gate 4x16384x2048",
     "int8"),
    ("splitk_gemm_simt", "src/repro_torch/csrc/splitk_gemm.cu",
     "src/repro/kernels/splitk_gemm.py:60",
     "train k/v dB fp32 2048x256x4096", "train"),
    ("splitk_gemm", "src/repro_torch/csrc/splitk_gemm.cu",
     "src/repro/kernels/splitk_gemm.py:60", "gate fp32 2x256x128",
     "reduced-default"),
    ("grouped_gemm_splitk", "src/repro_torch/csrc/grouped_gemm_splitk.cu",
     "src/repro/kernels/grouped_gemm.py:60", "qkv decode 3x4x2048x2048",
     "default"),
    ("grouped_gemm_splitk_s8", "src/repro_torch/csrc/grouped_gemm_splitk.cu",
     "src/repro/kernels/grouped_gemm.py:60", "int8 qkv decode 3x4x2048x2048",
     "int8"),
    ("grouped_gemm_wgmma", "src/repro_torch/csrc/grouped_gemm_wgmma.cu",
     "src/repro/kernels/grouped_gemm.py:60", "conv bf16 vgg.1_2", "conv"),
    ("grouped_gemm_wgmma_s8", "src/repro_torch/csrc/grouped_gemm_wgmma.cu",
     "src/repro/kernels/grouped_gemm.py:60",
     "int8 moe gate 32x160x1024x512", "granite"),
    ("grouped_gemm_simt", "src/repro_torch/csrc/grouped_gemm.cu",
     "src/repro/kernels/grouped_gemm.py:60", "conv fp32 vgg.1_2", "conv"),
    ("grouped_gemm", "src/repro_torch/csrc/grouped_gemm.cu",
     "src/repro/kernels/grouped_gemm.py:60",
     "gate+up prefill 2x512x2048x16384 (tile loop)", "reduced-default"),
    ("flash_decode_paged_mma",
     "src/repro_torch/csrc/flash_decode_paged_mma.cu",
     "src/repro/kernels/flash_decode.py:208",
     "4 slots x 8 heads x 256, ~1035 tokens", "default"),
    ("flash_decode_paged", "src/repro_torch/csrc/flash_decode_paged.cu",
     "src/repro/kernels/flash_decode.py:208",
     "fp32 2 slots x 4 heads x 32, 40 tokens", "reduced-default"),
    ("flash_attention_wgmma", "src/repro_torch/csrc/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention.py:108", "512x1024 H=8 D=256",
     "default"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:108", "fp32 512x1024 H=8 D=256",
     "reduced-default"),
    ("rigid_gemm_wgmma", "src/repro_torch/csrc/rigid_gemm.cu",
     "src/repro/kernels/rigid_gemm.py:80", "gate 512x16384x2048", "amx"),
    ("rigid_gemm_wgmma_s8", "src/repro_torch/csrc/rigid_gemm.cu",
     "src/repro/kernels/rigid_gemm.py:80", "int8 gate 512x16384x2048",
     "amx-int8"),
    ("rigid_gemm_simt", "src/repro_torch/csrc/rigid_gemm.cu",
     "src/repro/kernels/rigid_gemm.py:80", "gate fp32 16x256x128",
     "train-amx"),
    ("rigid_gemm", "src/repro_torch/csrc/rigid_gemm.cu",
     "src/repro/kernels/rigid_gemm.py:80",
     "gate fp32 16x256x128 (tile loop)", "reduced-amx"),
    ("epilogue_pass", "src/repro_torch/csrc/rigid_gemm.cu",
     "src/repro/kernels/rigid_gemm.py:43", "gelu 512x16384", "amx"),
    ("flash_decode_mma", "src/repro_torch/csrc/flash_decode_mma.cu",
     "src/repro/kernels/flash_decode.py:87", "ring 4x16x256 L=2048",
     "recurrentgemma"),
    ("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:87", "fp32 ring 2x4x32 L=16",
     "reduced-recurrent"),
    ("rglru_scan_staged", "src/repro_torch/csrc/rglru_scan_staged.cu",
     "src/repro/kernels/rglru_scan.py:45", "1x512x4096", "recurrentgemma"),
    ("rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:45", "1x8x126",
     "reduced-recurrent-w126"),
]


# The phase-2 row of each s8 kernel at granite_moe_1b's shapes (launches
# from phase 4's granite run): the prefill q/o on B1, the experts' down
# at C = 160 on B3's wgmma entry, the decode o on B2, the decode experts'
# gate at C = 8 on B3's split-K entry.
GRANITE_ROWS = {
    "mte_gemm_wgmma_s8": "int8 granite q/o 512x1024x1024",
    "grouped_gemm_wgmma_s8": "int8 moe down 32x160x512x1024",
    "splitk_gemm_cluster_s8": "int8 granite o 4x1024x1024",
    "grouped_gemm_splitk_s8": "int8 granite moe gate decode 32x8x1024x512",
}
# The phase-2 row of each kernel at gemma2_27b's shapes (its launches
# come from phase 4's gemma2 run): the prefill gate on B1, the decode gate
# on B2, the decode q/k/v group on B3, a global layer's decode on B4 and
# prefill chunk past the window on B5, a local layer's decode on B6.
GEMMA2_ROWS = {
    "mte_gemm_wgmma": "g2 gate 512x36864x4608",
    "splitk_gemm_cluster": "g2 gate 4x36864x4608",
    "grouped_gemm_splitk": "qkv decode 3x4x4608x4096",
    "flash_decode_paged_mma":
        "g2 4 slots x 32/16 heads x 128, ~4620 tokens, softcap 50",
    "flash_attention_wgmma": "g2 512x4608 H=32/16 D=128 softcap 50",
    "flash_decode_mma": "g2 ring 4x32/16x128 L=4096 softcap 50",
}
# The same at qwen15_4b's shapes under its bf16acc format (launches from
# phase 4's qwen run): the prefill gate on B1 and the decode gate on B2 with
# the bf16 accumulator, the MHA decode q/k/v group on B3 likewise, and
# attention at G = 1 on B4 (decode) and B5 (the last prefill chunk).
QWEN_ROWS = {
    "mte_gemm_wgmma": "q gate 512x6912x2560 bf16acc",
    "splitk_gemm_cluster": "q gate 4x6912x2560 bf16acc",
    "grouped_gemm_splitk": "qkv decode 3x4x2560x2560 bf16acc",
    "flash_decode_paged_mma": "q 4 slots x 20/20 heads x 128, ~2060 tokens",
    "flash_attention_wgmma": "q 512x2048 H=20/20 D=128",
}
# The same at starcoder2_7b's shapes (launches from phase 4's starcoder2
# run): the prefill up with bias + gelu on B1, the decode up with bias +
# gelu on B2, the GQA 36/4 decode q/k/v group on B3 and the ring decode at
# G = 9 on B6.
STARCODER2_ROWS = {
    "mte_gemm_wgmma": "s2 up 512x18432x4608 +bias",
    "splitk_gemm_cluster": "s2 up 4x18432x4608 +bias",
    "grouped_gemm_splitk": "s2 qkv decode 3x4x4608x4608",
    "flash_decode_mma": "s2 ring 4x36/4x128 L=4096",
}


# The int8 rows of the tile loops (launches from phase 4's int8 run, where
# none runs any more): B1's and B8's at gemma_2b's prefill gate, beside the
# s8 wgmma engine's, B2's and B3's at its decode gate and q/k/v group,
# beside the cluster engines' s8 entries.
INT8_ROWS = {
    "mte_gemm": "int8 gate 512x16384x2048 (tile loop)",
    "rigid_gemm": "int8 gate 512x16384x2048 (tile loop)",
    "splitk_gemm": "int8 gate 4x16384x2048 (tile loop)",
    "grouped_gemm": "int8 qkv decode 3x4x2048x2048 (tile loop)",
}


# The rigid s8 entry's decode row (launches from phase 4's amx-int8 run,
# whose decode step runs it 126 times): gemma_2b's 4-slot gate.
AMX_INT8_DECODE_ROWS = {
    "rigid_gemm_wgmma_s8": "int8 decode gate 4x16384x2048",
}


# The rows of the kernels phase 7's training step launches (its launches
# over the timed steps; B8's from phase 7c's amx step, the rest from 7b):
# the backward's f32 GEMMs at every shape of a layer on B1's SIMT f32
# engine, and the k/v dB on B2's (a split plan), under amx the gate's
# recompute and dA, the q/o dB and the unsplit k/v dB on B8's, the
# forward's bf16 gate on B1's wgmma mainloop and its causal attention on
# B5's.
TRAIN_PATH = {"rigid_gemm_simt": "train-amx"}
TRAIN_ROWS = {
    "rigid_gemm_simt": ("train amx gate recompute fp32 4096x16384x2048",
                        "train amx gate dA fp32 4096x2048x16384",
                        "train amx q/o dB fp32 2048x2048x4096",
                        "train amx k/v dB fp32 2048x256x4096"),
    "mte_gemm_simt": ("train gate recompute fp32 4096x16384x2048",
                 "train gate dA fp32 4096x2048x16384",
                 "train gate dB fp32 2048x16384x4096",
                 "train q/o dA fp32 4096x2048x2048",
                 "train q/o dB fp32 2048x2048x4096",
                 "train k/v dA fp32 4096x2048x256",
                 "train down dA fp32 4096x16384x2048",
                 "train down dB fp32 16384x2048x4096"),
    "mte_gemm_wgmma": ("train gate 4096x16384x2048",),
    "flash_attention_wgmma": ("train 1x4096 H=8/1 D=256",),
    "splitk_gemm_simt": ("train k/v dB fp32 2048x256x4096",),
}


# The same at musicgen_medium's shapes (launches from phase 6's
# model-level run: forward, prefill and 64 decode steps): the prefill's up
# with bias + gelu on B1, the decode step's on B2, the prefill's causal
# attention at D = 64, G = 1 on B5 and the flat-cache decode at its last
# position on B6.
MUSICGEN_ROWS = {
    "mte_gemm_wgmma": "mg up 4096x6144x1536 +bias",
    "splitk_gemm_cluster": "mg up 4x6144x1536 +bias",
    "flash_attention_wgmma": "mg 4x1024 H=24/24 D=64",
    "flash_decode_mma": "mg flat 4x24/24x64 L=2048 pos 1087",
}
# The same at chameleon_34b's shapes (launches from phase 6's chameleon
# run): the prefill's gate with its silu on B1, the decode step's down on
# B2, the prefill's causal attention at G = 8, D = 128 on B5 and the
# flat-cache decode at its last position on B6.
CHAMELEON_ROWS = {
    "mte_gemm_wgmma": "ch gate 4096x22016x8192",
    "splitk_gemm_cluster": "ch down 4x8192x22016",
    "flash_attention_wgmma": "ch 4x1024 H=64/8 D=128",
    "flash_decode_mma": "ch flat 4x64/8x128 L=1088 pos 1087",
}


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
        from repro_torch.configs import get_config
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
    grouped_phase(dev, rows)
    rigid_phase(dev, rows)
    int8_phase(dev, rows)
    int8_decode_phase(dev, rows)
    rigid_int8_phase(dev, rows)
    decode_phase(dev, rows)
    attention_phase(dev, rows)
    ring_decode_phase(dev, rows)
    rglru_phase(dev, rows)
    train_gemm_phase(dev, rows)
    log("== 3. reduced gemma_2b (fp32): card against CPU, default and amx")
    counts, serving = reduced_phase(dev), {}
    log("== 3. reduced gemma_2b (int8, 64-row chunks): card against CPU, "
        "default and amx")
    counts.update(reduced_int8_phase(dev))
    log("== 3. reduced recurrentgemma_9b (fp32): card against CPU, default")
    counts.update(reduced_recurrent_phase(dev))
    log("== 3. reduced gemma2_27b (fp32): card against CPU, default")
    counts.update(reduced_gemma2_phase(dev))
    log("== 3. reduced qwen15_4b (bf16acc): card against CPU, default")
    counts.update(reduced_qwen_phase(dev))
    log("== 3. reduced starcoder2_7b (fp32): card against CPU, default")
    counts.update(reduced_starcoder2_phase(dev))
    log("== 3. reduced granite_moe_1b (int8) and qwen3_moe_235b (bf16, "
        "QK-norm) at capacity factor 1.25: card against CPU")
    counts.update(reduced_moe_phase(dev))
    log("== 3. reduced musicgen_medium (fp32): the model-level path, card "
        "against CPU")
    counts.update(reduced_musicgen_phase(dev))
    log("== 3. reduced chameleon_34b (fp32, QK-norm): the model-level path, "
        "card against CPU")
    counts.update(reduced_chameleon_phase(dev))
    log("== 3. reduced mamba2_130m (fp32): the SSD mixer, card against CPU")
    counts.update(reduced_mamba2_phase(dev))
    for name, (arch, overrides) in CONFIGS.items():
        fmt = ENGINE_KW.get(name, {}).get(
            "format_policy", get_config(arch).format_policy or "bf16")
        log(f"== 4. full-width {arch} serving ({fmt}), configuration "
            f"[{name}] {overrides or ENGINE_KW.get(name) or '(defaults)'}")
        counts[name], serving[name] = serving_phase(dev, name)
        log(f"  [{name}] serving summary: {json.dumps(serving[name])}")
    isa_ratio = int8_isa_ratio(serving)
    speculative = {}
    for run, (name, groups, weights) in SPEC_RUNS.items():
        log(f"== 5. full-width speculative serving [{run}]: configuration "
            f"[{name}], spec_k={SPEC_K}, draft of {groups} layer period(s), "
            f"{weights} weights")
        speculative[run] = speculative_phase(
            dev, run, serving[name]["streams"], serving[name]["async"], smi)
        counts[run] = speculative[run]["launch_counts"]
    log("== 5. the reference's exact-draft gate at gemma_2b's full width "
        "[exact-draft]")
    speculative["exact-draft"] = exact_draft_phase(dev, smi)
    model_level = {}
    for arch, run in MODEL_LEVEL.items():
        log(f"== 6. the model-level path at full width: {arch} (bf16) "
            f"forward, prefill and decode over flat caches")
        counts[run["short"]], model_level[run["short"]] = \
            model_level_phase(dev, arch)
    log("== 7. training: reduced gemma_2b (fp32) card against CPU")
    counts.update(training_card_phase(dev))
    log(f"== 7. training gemma_2b at full width on the card: "
        f"{TRAIN['batch']} x {TRAIN['seq']} tokens, remat full, bf16")
    counts["train"], training = training_phase(dev)
    log(f"== 7c. training gemma_2b at full width on the card under the "
        f"rigid amx baseline: {TRAIN['batch']} x {TRAIN['seq']} tokens")
    counts["train-amx"], training_amx = training_phase(
        dev, "amx", training["steps"][0]["loss"])
    free_card()
    log(f"== 8. the paper's {len(CONV_SUITE)} convolutions at minibatch "
        f"{CONV_MB} through core.conv.conv2d_direct: one B3 launch each "
        f"(fp32, bf16; ResNet-50's in int8)")
    counts["conv"] = conv_phase(dev, rows)
    log(f"== 9. the paper's {len(TRANSFORMER_GEMMS)} transformer GEMMs "
        f"through core.dispatch.mte_gemm: mte (B1/B2) against amx (B8)")
    counts["dispatch"] = dispatch_phase(dev, rows)

    kernels = []
    for name, source, replaces, shape, path in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[path][name],
            "path": path,
            "shape": rep["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]})
        for key, config, at in (("at_gemma2", "gemma2", GEMMA2_ROWS),
                                ("at_qwen", "qwen", QWEN_ROWS),
                                ("at_starcoder2", "starcoder2",
                                 STARCODER2_ROWS),
                                ("at_musicgen", "musicgen",
                                 MUSICGEN_ROWS),
                                ("at_chameleon", "chameleon",
                                 CHAMELEON_ROWS),
                                ("at_int8", "int8", INT8_ROWS),
                                ("at_granite", "granite", GRANITE_ROWS),
                                ("at_decode", "amx-int8",
                                 AMX_INT8_DECODE_ROWS)):
            if name in at:
                row = next(r for r in mine if r["shape"] == at[name])
                kernels[-1][key] = {
                    "launches": counts[config][name],
                    **{k: row.get(k) for k in (
                        "shape", "max_abs_err", "ms", "cold_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "sdpa_without_softcap_ms")}}
        for key, config, prefix in (("at_conv", "conv", "conv "),
                                    ("at_dispatch", "dispatch",
                                     "dispatch ")):
            on = sorted((r for r in mine if r["shape"].startswith(prefix)),
                        key=lambda r: r["bound_ms"])
            if on:
                kernels[-1][key] = {
                    "launches": counts[config].get(name, 0),
                    "rows": len(on),
                    **{which: {k: row.get(k) for k in (
                        "shape", "tile", "tile_state", "max_abs_err", "ms",
                        "cold_ms", "conv_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "conv2d_ms",
                        "mte_over_amx")}
                       for which, row in (("largest", on[-1]),
                                          ("median", on[len(on) // 2]))}}
        if name in TRAIN_ROWS:
            train = counts[TRAIN_PATH.get(name, "train")]
            kernels[-1]["at_train"] = {
                "path": TRAIN_PATH.get(name, "train"),
                "launches": train[name],
                "launches_per_step": train[name] / TRAIN["timed"],
                "rows": [{k: r.get(k) for k in (
                    "shape", "max_abs_err", "ms", "cold_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms",
                    "library_cold_ms", "transpose_copy_ms",
                    "tile_loop_ms")}
                    for r in mine if r["shape"] in TRAIN_ROWS[name]]}
            require(len(kernels[-1]["at_train"]["rows"])
                    == len(TRAIN_ROWS[name]), f"{name}: the training rows "
                    f"{TRAIN_ROWS[name]} are not all among its rows")
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "rows": rows, "serving": serving,
                   "int8_isa_ratio": isa_ratio,
                   "speculative": speculative, "model_level": model_level,
                   "training": training, "training_amx": training_amx,
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
