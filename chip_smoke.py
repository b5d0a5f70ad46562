#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --only kernels  # build + kernel phases only
    python3 chip_smoke.py --only k12      # kernels 1-2 timed at the main
                                          # path's shapes, one JSON line
    python3 chip_smoke.py --only serve-families   # kernels 1-2 built, the
                                          # recurrent and enc-dec families,
                                          # mistral-large and their smokes
    python3 chip_smoke.py --only train    # kernels 1, 4 and 3 built, the
                                          # training stack (phase 8,
                                          # (a)-(g)), one
                                          # JSON line
    python3 chip_smoke.py --only parallel # kernel 1 built: the parallel
                                          # layer and the dry run, its
                                          # trace held on the card (phase
                                          # 11), one JSON line
    python3 chip_smoke.py --only sharded  # kernel 1 built: the dense
                                          # serve forwards sharded (phase
                                          # 12), one JSON line
    python3 chip_smoke.py --only sharded-train  # kernel 1 built: the QAT
                                          # train step sharded (phase
                                          # 13), one JSON line
    python3 chip_smoke.py --only sharded-moe    # kernels 1 and 7 built: the
                                          # MoE and MLA decoders served
                                          # sharded (phase 14), one JSON
                                          # line
    python3 chip_smoke.py --only sharded-families  # kernel 1 built: the
                                          # recurrent, enc-dec and VLM
                                          # families served sharded (phase
                                          # 16), one JSON line
    python3 chip_smoke.py --only sharded-train-families  # kernel 1 built:
                                          # their QAT train step sharded
                                          # (phase 17), one JSON line

``--only k12`` builds kernels 1-2 alone and times kernel 1's decode layer
(``phase_gemm``) and kernel 2's main-path shape (``flash_main_timing``):
to compare two checkouts on one card, copy this script into each and run
them in turns in one call (parent, change, change, parent).

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the six CUDA sources of ``src/repro_torch/csrc`` (one ``nvcc``
   each, started together) and print the build time;
3. kernels 1-2 (fused lookup GEMM, flash-decode) against their plain
   PyTorch versions at the serve path's shapes (kernel 1 at M 1, 4, 16,
   17, 20 and 64, on tables narrowed once as the serve params hold them;
   M 20 is the verify window of 4 slots x 5 tokens),
   and kernel 1 at the edges of its dp4a and mma.sync paths (G 3/4,
   ragged kg, odd dp, uint8/int16 indices, int16 rows) and over the whole
   domain the reference takes (G 1-6, dp up to 256): the lookup GEMM
   must be bit-equal in int32, flash-decode within the stated f32
   tolerance over fp/int8/int4 pools, windows, idle slots, 1 to 16
   splits, two rep chunks and head dims off its 8-element pieces (18, 36,
   100, 126: the ragged instances, hd 126 timed beside hd 128); times of
   the kernel, the plain version,
   the bound and a library yardstick: one ``torch._int_mm`` of the
   one-hot coefficients against the gathered table rows (held equal),
   beside a dense int8 ``_int_mm`` of the same shape as context, and
   SDPA over the gathered K/V; then both at the dense families' shapes
   (kernel 1 at command-r-35b's four linear shapes, kernel 2 at rep 8,
   hd 64 and a 2048-token window over slots past it);
4. kernels 3-6 (bit-plane pack, lookup GEMM on packed codes, the
   cluster-scheduled GEMM for one tile and for every tile) against their
   plain versions and the dense integer GEMM on small compiled plans, at
   the reference's own test shapes, and kernels 5-6 at G 1, with more
   than 128 clusters and with a G 6 slice of N_arr 4096 (larger than
   shared memory);
5. full-width ResNet-18 (``configs/resnet18.CONFIG``) drawn on the card
   and its 16 basic-block convs compiled on the host
   (``compile_resnet``): compile seconds and the Fig. 8 cost report per
   conv, ``verify_plan`` on each;
6. kernels 1 and 3-6 at those 16 convs' shapes (batch 32, 56x56 input):
   int32-equal to their plain versions, kernels 5/6 to kernel 3's row
   GEMMs and to ``torch._int_mm`` of the plan's weights; kernel, plain,
   bound (bytes over HBM or the one-hot product over the int8
   tensor-core peak, both printed) and ``torch._int_mm`` times per
   stage (kernels 3-6 and their ``_int_mm`` by CUDA-graph replay, the
   eager time beside; kernels 1 and 3 on the narrow tables that
   ``conv_row_plan`` holds), and the whole conv against ``conv2d`` of
   the codes;
7. the serve main path: full-width codeqwen1.5-7b with seeded random
   TLMAC weights drawn on the card, ``PagedServeLoop(batch_slots=4,
   s_max=1024, page_size=16)`` under the reference's defaults (prefix
   cache, on-demand pages, priority preemption) over six requests, its
   chunk and decode forwards captured as CUDA graphs (graph replay
   checked bit-equal to eager first; one graph per forward after the
   run), with the launch counters of kernels 1-2 and the graphs' replay
   counts reset before and read after the run (launches = eager
   launches + launches recorded at capture x replays);
   then the same requests under ``'auto'`` (``phase_autotune``): the
   loop's ``tune`` (kernel 1 against kernels 4 + 3 at each linear shape,
   kernel 2 at 1, 2, 4 and 8 splits against the gathered reader), each
   key's winner with its and the baseline's µs, every GEMM winner
   int32-equal to ``'ref'``, both GEMM candidates by graph replay, then
   the six requests served in turns under the fixed impls and under the
   tuned ``'auto'`` (fixed, auto, auto, fixed): decode step on the host
   clock and as the device span, prefill, tokens (this script's
   autotune cache is emptied at its start and after every tuning, so
   every other phase dispatches the miss defaults);
   then the serve features at the same width: 8 requests sharing a
   512-token system prompt, served with the cache off, under the
   defaults (prefix hits, skipped chunks, tokens equal to the cache-off
   run where the top-2 margin is clear), and in a pool small enough to
   preempt (every request finishes, no page leaks);
   then speculation at the same width (``phase_serve_spec``): a verify
   replay checked bit-equal to eager and verify rows bit-equal to
   sequential decode steps on one cache state, then six requests (three
   repeat a span) served with speculation off and the gathered decode
   reader (the baseline T), with spec_k 4 and a replay drafter over T at
   corruption 0, 0.4 and 1.0, and with the n-gram drafter: every token
   equal to T, accept rate, tokens per slot-step, decode and verify step
   medians, three graphs, and each run's own launches (kernel 1 = 7 x
   layers x forwards, no flash-decode); then the main path's requests
   with telemetry off and on in turns (``phase_telemetry``): tokens and
   graphs equal to the off run, the lifecycle trace valid, phase
   histograms, TTFT and queue waits, each run's median whole step and
   wall time, and the Chrome trace written to a temporary directory;
   then the swap tier (``phase_swap_roundtrip``): the full-width fp, int8
   and int4 pools, 8 pages out through the staging ring and back into
   other pages, bytes and CRC-32 equal, GB/s each way and CRC ms per
   page; then the main path's prompts with 96 new tokens in a 62-page
   pool that preempts twice (``phase_serve_swap``), served with swap
   policy never, always, auto (fp) and always (int8): every request
   finishes, no leak, launches counted per run, the always runs restore
   pages and replay fewer tokens, with the swap timings (put and match
   CRC, gather and copies, restore); then seeded faults
   (``phase_faults``): cancels and admission stalls against a fault-free
   run (tokens equal where the margin is clear), the reference's chaos
   rates with tenant quotas (every request done or ended with a typed
   error, no page or host byte leaked), and the typed door errors;
   then the other dense families the reference pages
   (``phase_families``), each drawn on the card with its init peak
   printed (the params plus at most one layer) and freed before the
   next: command-r-35b at full width, 20 of 40 layers, served as the
   main path is (six requests, both graphs, launches asserted), then the
   dense
   oracle at its width (``phase_dense_oracle``: four requests solo
   through the dense ``ServeLoop`` and through the paged loop with the
   gathered reader, fp then int8 pools, tokens equal where the margin is
   clear, the share of bit-equal logits rows printed);
   internvl2-76b's backbone and minicpm-2b at full width and depth (four
   requests x 16 tokens); the 2048-token sliding window at
   codeqwen1.5-7b's width (8 layers, prompts past the window, kernel 2
   held against the gathered reader at the first step past it); and the
   int8 and mixed serve layouts on a 4-layer codeqwen-shaped stack (the
   int8 linears equal to their plain product, the mixed tree served with
   kernel 1 on the attention linears only); each served family but the
   layouts also tuned on its own shapes (``phase_tune_family``: every
   key's winner and the baseline's µs; command-r-35b's six requests
   then served in turns under the fixed impls and the tuned ``'auto'``);
   then the MoE family
   (``phase_moe``): deepseek-v3-671b's widths with GQA blocks (the
   reference's moe-gqa), cut to 11 of 61 layers (3 dense + 8 MoE), its
   ``plan_shapes`` reckoning printed, drawn on the card (init peak
   asserted), kernel 1's single linears at its widths (a dense layer's
   q/k/v/o and FFN, the shared expert) int32-equal at M 4 and 64,
   kernel 2 at its decode shape (128 KV heads of dim 56) on fp, int8
   and int4 pools, kernel 1's expert axis int32-equal to its plain
   version at one MoE layer's 256-expert wi/wg/wo at M 4 and 2 and
   timed against its bound, four requests x 16 tokens served from CUDA graphs as the
   main path is (kernel 1 once per lookup linear a forward, three expert
   stacks a MoE layer, asserted), and one eager decode step profiled by
   MoE phase (route, dispatch einsums, experts, combine einsums, shared
   experts), with the step's device time split into kernel 1's expert
   stacks (by that range), its single linears, kernel 2 and the rest;
   then moe-gqa in the int8 layout, cut to 3 dense + 2 MoE layers
   (``phase_int8_experts``): one MoE layer's int8 expert stacks
   int32-equal to their plain twin and to a per-expert ``_int_mm`` loop
   at M 4 and 2, one stack timed against its byte bound, the twin and
   the loop, four requests x 16 tokens served from CUDA graphs with the
   int8 expert kernel's launches asserted (three a MoE layer a forward);
   then deepseek-v3-671b (11 of 61 layers) and kimi-k2-1t-a32b (5 of
   61) with their MLA attention (``phase_mla``), each with its
   ``plan_shapes`` reckoning and init peak, kernel 1 int32-equal to its
   plain version at the block's wq_a, wq_b, wkv_a and wo (M 4 and the
   prefill's 1264 rows) and at one MoE layer's expert stacks (M 4),
   four requests x 16 tokens
   through the dense ``ServeLoop`` (MLA does not page), kernel 1's
   launches asserted and no flash-decode;
   then the families that serve through the dense forwards, at full
   width and depth (``phase_serve_families``), each with its
   ``plan_shapes`` reckoning and init peak, kernel 1 int32-equal to its
   plain version at every lookup linear shape of the model (M 4 and the
   prefill's rows), and decode continuing prefill (prefill(S) + one
   decode step against prefill(S + 1), within 2e-2): recurrentgemma-2b
   (four prompts of 53/144/227/2100 tokens left-padded to 2100, so every
   attn_local ring wraps, s_max 2304) and xlstm-350m (53/144/227/256,
   left-padded to a multiple of the scan's 64) through the dense
   ``ServeLoop``, 16 tokens each; seamless-m4t-medium through
   ``lm.prefill(tokens, frames=...)`` (seeded frames [4, 512, 1024], four
   16-token prompts) and 32 greedy decode steps; each run's decode step,
   prefill rate, run peak, one decode step profiled, kernel 1's launches
   asserted and no flash-decode; then mistral-large-123b at full width
   and depth (59 GiB of params) on the main path's loop, four prompts x
   16 tokens;
8. the training stack (``phase_train``): (a) one ``make_train_step`` on
   codeqwen1.5-7b's smoke (quantisers calibrated) on the card against
   the same step on the CPU (loss, gradient norm, lr within stated
   tolerances), and the loss falling on a fixed batch on the card; (b)
   minicpm-2b at full width, 10 of 40 layers, through the train CLI
   (``launch.train.main``: 6 steps, batch 4 x 1024, WSD), its memory
   reckoning beside the params, init and run peaks, every step's loss,
   lr and gradient norm (finite), the median step and tokens a second,
   and the last step profiled (device busy share, largest kernels); (c)
   the trained layer 0 ``ffn.wi`` compiled (G 4, d_p 128,
   ``verify_plan``) and run on kernel 1 at M 4 and 64, int32-equal to
   its plain version and to the integer product of its codes; (d)
   preempt and resume on minicpm-2b's smoke, the resumed losses within
   1e-5 of the uninterrupted run's; (e) full-width ResNet-18, 10 QAT SGD
   steps at batch 32, then the trained ``block0.conv1`` and
   ``block7.conv2`` compiled and run as lookup convs (kernels 4 then 3),
   int32-equal to the integer conv of their codes; (f) one
   ``make_train_step`` on the card against the same step on the CPU for
   each other family's smoke (recurrentgemma-2b at window 8, xlstm-350m,
   seamless-m4t-medium with frames, deepseek-v3-671b with MLA + MoE and
   int8 moments, moe-gqa, kimi-k2-1t-a32b, internvl2-76b with ``front``);
   (g) recurrentgemma-2b cut to 6 of 26 layers (batch 2 x 1024, the
   last of 4 steps profiled), xlstm-350m cut to 8 of 24 layers (4 x 128:
   two of the scan's 64-step chunks) and seamless-m4t-medium (4 x 1024
   tokens, 512 frames) at full width through the train CLI (deepseek-v3's
   3 dense MLA layers train in phase 15), each with its memory
   reckoning, init and run peaks, first and median step, tokens a
   second and finite losses, each freed before the next;
9. the port on the card against the port on the CPU (plain versions) on
   six smoke configs (the five dense families', minicpm's at head dim
   18, and the MoE smoke), every one read with kernel 2,
   teacher-forced, logits within tolerance; the two MLA smoke configs
   through the dense ``ServeLoop``; xlstm's and recurrentgemma's smokes
   through the dense ``ServeLoop`` and seamless's through prefill with
   frames and decode steps;
10. the paper path: ResNet-18's forward on 32 seeded 56x56 images, then
    every conv as a lookup conv (kernels 4 + 3) and as one
    cluster-scheduled launch (kernels 4 + 6, and 5 on the single-tile
    convs), each equal to the integer conv, with the launch counters of
    kernels 3-6 reset before and asserted after; and ``TLMACLinear`` at
    the quickstart's shape equal to the dense integer GEMM;
11. the parallel layer (``phase_parallel``; the rings and the pipeline
    use no kernel: their products are ``torch.matmul`` in f32, as the
    reference's are ``jnp.dot``): one
    NCCL rank spawned per visible card (world size printed: 1 on one
    card, where a ring hop is the identity and no overlap can show),
    ``ring_ag_matmul`` and ``ring_rs_matmul`` at codeqwen1.5-7b's
    ``ffn.wi`` widths (x [4096, 4096], w [4096, 13440], f32) held
    against one ``torch.matmul``, ``pipeline_apply`` with a ``tanh(x @
    w)`` stage at d 4096 over 8 microbatches of 512 held against the
    stages applied in turn, each within its printed tolerance, the
    collectives each issued, and their times beside ``all_gather`` +
    matmul (matmul + ``reduce_scatter``; the sequential stages); then
    the port's dry run (``python -m repro_torch.launch.dryrun --all
    --mesh both --skip-hlo``, no JAX on the machine) over every cell and
    both meshes, each cell's per-device argument bytes printed against
    the card's 80 GB; every ``decode_32k`` cell on the pod mesh traced
    (rank 0's step on ``meta``: temp and total bytes against 80 GB,
    flops against the analytic count) -- both dry runs use no card and
    run in the background from the script's start, beside the kernels'
    build (``start_dry_runs``); and the trace held on the card at
    world 1 (``phase_dry_run_card``): phase 12's codeqwen1.5-7b decode
    step (8 of 32 layers, B 4) and phase 13's train step (4 of 32
    layers, B 4 x 1024) traced on ``meta`` under a fake one-rank group,
    then run on the card under the same trace: collectives, flops and
    kernel 1's calls (against its launch counter) equal, the predicted
    peak bytes within ``DRY_PEAK_TOL`` of the rise of
    ``torch.cuda.max_memory_allocated()`` over the step.
12. the dense serve forwards sharded (``phase_sharded``): one NCCL rank
    spawned per visible card, a (data 1, model world) mesh (world 1 on
    one card: every collective is still issued, over one-rank groups);
    codeqwen1.5-7b at full width cut to 8 of 32 layers (32 KV heads:
    head-sharded caches) and command-r-35b cut to 4 of 40 layers (8 KV
    heads:
    sequence-sharded caches, the decode softmax combined over 'model'),
    seeded TLMAC weights, B 4 x 256-token prompts and 16 greedy decode
    steps, each through ``lm.prefill``/``lm.decode_step`` unsharded and
    then under the mesh on this rank's blocks (``local_tree``), held
    bit-equal (tokens, prefill and last logits, caches), kernel 1's
    launches counted on the sharded run (7 x layers x 17), the
    collectives a decode step (kind, count, bytes) and both decode steps'
    median ms; then kernel 1 at the blocks one rank of a 16-way 'model'
    axis runs at M 4 (codeqwen1.5-7b's and mistral-large-123b's q/o, k/v,
    wi/wg and FFN wo: n_tiles / 16 output tiles, the FSDP reduction
    groups gathered whole), int32-equal to its plain twin and timed
    beside it, its bound and the one-hot ``_int_mm``.
13. the QAT train step sharded (``phase_sharded_train``): one NCCL rank
    per visible card, a (data 1, model world) mesh (world 1 on one card);
    minicpm-2b at full width cut to 10 of 40 layers (``pure_fsdp``: every
    linear ZeRO-3-sharded over ('data', 'model') and gathered at use) and
    codeqwen1.5-7b at full width cut to 4 of 32 layers (tensor, sequence
    and vocab parallel over 'model', FSDP over ('pod', 'data')), each
    from phase 8's seeded params and batches (4 x 1024, WSD): two
    unsharded ``make_train_step``s, freed, then two sharded ones from the
    same state on this rank's blocks (``local_tree``) and rows, the loss,
    gradient norm, every gradient leaf's norm and bit checksum and every
    param after each step compared bit for bit (a step that is not is
    named, its loss held within 1e-6 and each gradient leaf within the
    CPU tests' tolerances), the collectives of a step by kind, count and
    bytes with the backward's and the parameter ones apart, both steps'
    ms and peak memory; then minicpm-2b's trained layer 0 ``ffn.wi``
    gathered over its axes, compiled and run on kernel 1 at M 4 and 64,
    int32-equal to its plain twin (``phase_trained_linear``).
14. the MoE and MLA decoders served sharded (``phase_sharded_moe``): one
    NCCL rank per visible card, a (data 1, model world) mesh (world 1 on
    one card); deepseek-v3-671b at full width cut to 5 of 61 layers (3
    dense MLA + 2 MoE), kimi-k2-1t at full width cut to 2 (1 dense + 1
    MoE) and int8 moe-gqa cut as deepseek (calibrated steps), each B 4 x
    256 + 16 greedy steps through ``lm.prefill``/``lm.decode_step``
    unsharded and then under the mesh on this rank's blocks (expert
    parallelism over 'model', the MLA latent caches sequence-sharded),
    held bit-equal (tokens, prefill and last logits, caches), kernel 1's
    and kernel 7's launches counted on the sharded run (one a lookup
    linear or expert stack a forward), the collectives a decode step,
    both decode steps' median ms and both runs' peaks; then kernel 1 at
    one rank's block of a 16-way 'model' axis's expert stacks
    (deepseek-v3's 16 of 256 and kimi-k2's 24 of 384 experts of wi, wg
    and wo) and kernel 7 at 16 of int8 moe-gqa's 256 experts, at the rows
    a decode step and the prefill give each expert, int32-equal to their
    plain twins and timed beside them and the bound.
15. the MoE and MLA decoders' QAT train step sharded
    (``phase_sharded_train_moe``): one NCCL rank per visible card, a
    (data 1, model world) mesh (world 1 on one card); deepseek-v3-671b at
    full width cut to its 3 dense MLA layers and the deepseek smoke
    widened (d_model 256, 8 experts of 64, MLA + MoE), each with
    ``fsdp``, int8 moments, int8 gradient compression and two
    microbatches, 4 x 1024, WSD: two unsharded steps, then two sharded
    ones, the loss, norm, gradients, params and moments compared bit for
    bit, the collectives of a step with the backward's, the parameter
    ones and the compression's apart, both steps' ms and peaks; the MoE
    smoke's step on the card against the CPU; then the trained layer 0
    ``attn.wq_a`` and expert 0's ``moe.wi`` compiled and run on kernel 1
    at M 4 and 64, int32-equal to their plain twins and
    ``dense_int_matmul``, timed beside them, the one-hot ``_int_mm`` and
    the bound.
16. the recurrent, enc-dec and VLM families served sharded
    (``phase_sharded_families``): one NCCL rank per visible card, a (data
    1, model world) mesh (world 1 on one card); recurrentgemma-2b at full
    width cut to 6 of 26 layers (two whole (rglru, rglru, attn_local)
    patterns), the same with a B 1 x 2304 prompt past its 2048-slot
    window (the ring wraps), xlstm-350m cut to 8 of 24 (one 7 + 1
    pattern), seamless-m4t-medium whole with 512 frames and internvl2-76b
    cut to 2 of 80 with its 256-row front, each B 4 x 256 + 16 greedy
    steps through ``lm.prefill``/``lm.decode_step`` unsharded and then
    under the mesh on this rank's blocks (the recurrent states, the ring's
    slots, the encoder and the cross caches), held bit-equal (tokens,
    prefill and last logits, caches), kernel 1's launches counted on the
    sharded run (``_sharded_launches``), the collectives a decode step,
    both decode steps' median ms, both prefills' tok/s and both runs'
    peaks; then kernel 1 at one rank's block of a 16-way 'model' axis of
    every distinct lookup linear shape of the four families, M 4,
    int32-equal to its plain twin and timed beside it, the bound and the
    one-hot ``_int_mm``.
17. the enc-dec, VLM and recurrent families' QAT train step sharded
    (``phase_sharded_train_families``): one NCCL rank per visible card, a
    (data 1, model world) mesh (world 1 on one card); seamless-m4t-medium
    whole, 2 x (512 frames + 512 tokens), internvl2-76b cut to 1 of 80
    layers, 1 x (256 front rows + 768 tokens), recurrentgemma-2b cut to 6
    of 26, 2 x 1024, xlstm-350m cut to 8 of 24, 2 x 128, at full width,
    WSD: two unsharded steps, then two sharded ones, the loss, norm,
    gradients, params and moments compared bit for bit, the collectives
    of a step, both steps' ms and peaks beside the reckoning; then the
    trained layer 0 ``attn.wq`` of internvl2 and decoder layer 0
    ``xattn.wq`` of seamless, each cut to one rank's block of a 16-way
    'model' axis, compiled and run on kernel 1 at M 4 and 64, int32-equal
    to their plain twins and ``dense_int_matmul``, timed beside them, the
    one-hot ``_int_mm`` and the bound.

The line before the last is the kernel JSON (all six ported kernels and
the int8 expert kernel, launches counted on the main paths: the serve
main path for kernels 1-2, the paper path for kernels 3-6, the int8
moe-gqa path for the int8 expert kernel; kernel 1's and kernel 2's
rows also carry ``launches_by_path``, each counted on one of the
families' runs with the counters set to 0 just before it, kernel 1's
and kernels 3-4's also the trained weights' launches in phase 8 and
kernel 1's the sharded runs of phases 12, 14 and 16 and the sharded
trained linears of phases 13, 15 and 17 (their times under
``trained_shards``), with its 16-way shard-shape times under
``shard_shapes`` and ``family_shard_shapes`` and its 16-way expert-block
times under ``expert_block_shapes``, the int8 expert kernel's phase 14's); the
last line is the device JSON.  Needs one CUDA card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory, the
# non-tensor-core f32 rate, against which int32 lookup-adds and f32
# attention flops are counted (one operation each), and the int8
# tensor-core rate, against which kernel 1's one-hot product is counted.
HBM_BYTES_S = 3.35e12
NONTENSOR_OPS_S = 67e12
INT8_TC_OPS_S = 1979e12
FLASH_TOL = 1e-4     # f32: only the order of the softmax sums differs
LOGIT_TOL = 3e-2     # bf16 logits of the whole model, card vs CPU

PROMPT_LENS = (37, 128, 211, 300, 64, 500)
MAX_NEW = 32
CHUNK = 64           # prefill chunk of the main path
SEED = 0
DEV = "cuda"         # every phase runs on the card
SOURCES = ("tlmac_fused", "flash_decode", "bitplanes", "tlmac_gemm",
           "tlmac_clustered", "int8_experts")
TRAIN_SOURCES = ("tlmac_fused", "bitplanes", "tlmac_gemm")   # --only train
# the autotune cache of this run alone, made empty at the start: every
# phase but phase_autotune resolves 'auto' to its miss defaults
AUTOTUNE_CACHE = os.path.join(ROOT, "build", "autotune-smoke.json")


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str):
    log(f"phase: {name} (at {time.perf_counter() - T_START:.1f} s)")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SIDE_STREAM = []   # one warm-up stream for every graph_ms call


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's cost between calls is not timed.  A decode
    kernel runs for tens of microseconds, less than its Python wrapper
    takes to launch it, and back-to-back eager calls (``cuda_ms``) then
    time the host."""
    import torch

    fn()
    # the warm-up runs on one side stream for the whole script: cuBLAS
    # keeps a workspace for every stream it has run on, so a new stream
    # per call would leave memory allocated into the serve run's peak
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def rotation(nbytes: int) -> int:
    """Input copies to cycle through so repeated launches find them out of
    the 50 MB L2, as the main path does (each layer has its own)."""
    return max(1, min(8, math.ceil(128e6 / max(nbytes, 1))))


# ---------------------------------------------------------------------------
# kernel 1: fused lookup GEMM
# ---------------------------------------------------------------------------

GEMM_SHAPES = {  # name: (K, N, dp) of codeqwen1.5-7b's serve linears
    "q/k/v/o 4096->4096": (4096, 4096, 128),
    "wi/wg 4096->13440": (4096, 13440, 120),
    "wo 13440->4096": (13440, 4096, 128),
}
DECODE_LAYER_MIX = {"q/k/v/o 4096->4096": 4, "wi/wg 4096->13440": 2,
                    "wo 13440->4096": 1}
GEMM_MS = (1, 4, 16, 17, 20, 64)  # both inner products, their boundary,
                                  # and the verify window (4 slots x 5)
INT_MM_MIN_M = 32              # torch._int_mm refuses M <= 16: pad to 32


def _gemm_bound(M, kg, N, G, nbytes):
    """The least time (ms) of one lookup GEMM: its bytes over HBM, or the
    one-hot product's 2*M*2^G*kg*N operations over the int8 tensor-core
    peak, whichever is larger; with the two times it is the larger of."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_o = 2 * M * 2**G * kg * N / INT8_TC_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)


def _bound_by(d):
    return "bytes" if d["bytes_ms"] >= d["ops_ms"] else "operations"


def _onehot_int_mm(tf, aq, idx, cl, tab, B_a, G):
    """The library yardstick of a lookup GEMM: one ``torch._int_mm`` of the
    one-hot coefficients ``A' [M, 2^G*kg]`` (zero rows pad M to 32) against
    the narrow table rows gathered beforehand, ``W' [2^G*kg, N]``: the same
    function for any table.  Returns the padded A', W' and the call."""
    import torch

    M = aq.shape[0]
    coef = tf.onehot_coefficients(aq, B_a, G).reshape(M, -1).to(torch.int8)
    a_pad = torch.zeros((max(M, INT_MM_MIN_M), coef.shape[1]),
                        dtype=torch.int8, device=aq.device)
    a_pad[:M] = coef
    w = tf.gathered_rows(idx, cl, tab).contiguous()
    return lambda: torch._int_mm(a_pad, w)[:M]


def phase_gemm(chunk: int, batch: int, verify: int, B_a=3, G=4, n_arr=4096,
               n_clus=4):
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, (K, N, dp) in GEMM_SHAPES.items():
        nt, kg = N // dp, K // G
        reps = rotation(nt * kg * dp * 2)
        # the serve path's params: int32 tables narrowed once at init
        plans = [(torch.randint(0, n_arr, (nt, kg, dp), dtype=torch.int16,
                                generator=gen, device="cuda"),
                  torch.randint(0, n_clus, (nt, kg), dtype=torch.int8,
                                generator=gen, device="cuda"),
                  tf.narrow_table(torch.randint(
                      -8, 8, (n_clus, n_arr, 2**G), dtype=torch.int32,
                      generator=gen, device="cuda")))
                 for _ in range(reps)]
        idx, cl, tab = plans[0]
        assert tab.dtype == torch.int8, tab.dtype
        for M in GEMM_MS:
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device="cuda")
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM {name} M={M}", got, want)
            if M not in (batch, chunk, verify):
                log(f"  lookup GEMM {name:20s} M={M:3d}: equal int32")
                continue
            it = iter(range(1 << 30))

            def run_kernel():
                i, c, t = plans[next(it) % reps]
                tf.tlmac_gemm_fused(aq, i, c, t, B_a=B_a, G=G)

            ms = graph_ms(run_kernel)
            eager_ms = cuda_ms(run_kernel, iters=20)
            plain_ms = cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                aq, idx, cl, tab, B_a=B_a, G=G), iters=3, warmup=1)
            nbytes = M * K + idx.numel() * 2 + cl.numel() + tab.numel() \
                + M * N * 4
            b = _gemm_bound(M, kg, N, G, nbytes)
            bound, by = b["bound_ms"], _bound_by(b)
            lib = _onehot_int_mm(tf, aq, idx, cl, tab, B_a, G)
            _equal(f"lookup GEMM {name} M={M} one-hot _int_mm", lib(), got)
            lib_ms = graph_ms(lib)
            del lib
            a8 = torch.randint(-128, 128, (max(M, INT_MM_MIN_M), K),
                               dtype=torch.int8, generator=gen, device="cuda")
            w8 = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                               generator=gen, device="cuda")
            dense_ms = graph_ms(lambda: torch._int_mm(a8, w8))
            del a8, w8
            rows[(name, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=lib_ms,
                                   eager_ms=eager_ms)
            log(f"  lookup GEMM {name:20s} M={M:3d}: equal int32; kernel "
                f"{ms:.4f} ms (eager calls {eager_ms:.4f} ms), plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({by}), {bound / ms:.1%} of bound; one-hot _int_mm "
                f"(M padded to {max(M, INT_MM_MIN_M)}) {lib_ms:.4f} ms, "
                f"equal int32; context: dense int8 _int_mm "
                f"[{max(M, INT_MM_MIN_M)},{K}]x[{K},{N}] {dense_ms:.4f} ms")
        del plans
    fields = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")
    for M in sorted({batch, chunk, verify}):
        tot = {f: sum(rows[(n, M)][f] * c for n, c in DECODE_LAYER_MIX.items())
               for f in fields}
        log(f"  one layer's 7 lookup GEMMs at M={M}: kernel {tot['ms']:.4f} "
            f"ms (eager calls {tot['eager_ms']:.4f} ms), plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"one-hot _int_mm {tot['library_ms']:.4f} ms")
    # the JSON entry: one decode step's seven lookup GEMMs of one layer
    tot = {f: sum(rows[(n, batch)][f] * c for n, c in DECODE_LAYER_MIX.items())
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by = rows[("wi/wg 4096->13440", batch)]["bound_by"]
    return dict(name="tlmac_gemm_fused", route="cuda",
                source="src/repro_torch/csrc/tlmac_fused.cu",
                replaces="src/repro/kernels/tlmac_fused.py:199",
                shape=f"one decode layer: 4x4096->4096, 2x4096->13440, "
                      f"1x13440->4096 at M={batch}",
                max_abs_err=0, bound_by=by, **tot)


def phase_gemm_edges(B_a=3):
    """Kernel 1 at the edges of both inner products, int32-equal to its
    plain version: M across the dp4a/mma boundary, ragged kg, dp 120 and
    odd, uint8 and int16 indices, G 3 and 4, and an int16-row table."""
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (G, n_tiles, kg, dp, n_arr, idx dtype, table range)
        (4, 3, 37, 120, 600, torch.int16, (-8, 8)),
        (4, 2, 21, 128, 200, torch.uint8, (-128, 128)),
        (3, 3, 45, 64, 300, torch.int16, (-12, 10)),
        (3, 2, 19, 5, 100, torch.uint8, (-8, 8)),
        (4, 2, 37, 120, 600, torch.int16, (-300, 300)),   # int16 rows
        (3, 3, 22, 64, 200, torch.uint8, (-200, 200)),    # int16 rows
    ]
    n = 0
    for G, nt, kg, dp, n_arr, idt, (lo, hi) in cases:
        idx = torch.randint(0, n_arr, (nt, kg, dp), generator=gen,
                            device="cuda").to(idt)
        cl = torch.randint(0, 3, (nt, kg), dtype=torch.int8, generator=gen,
                           device="cuda")
        t32 = torch.randint(lo, hi, (3, n_arr, 2**G), dtype=torch.int32,
                            generator=gen, device="cuda")
        tab = tf.narrow_table(t32)
        want_dt = torch.int8 if -128 <= lo and hi <= 128 else torch.int16
        assert tab.dtype == want_dt, (tab.dtype, lo, hi)
        for M in GEMM_MS:
            aq = torch.randint(0, 2**B_a, (M, kg * G), dtype=torch.int8,
                               generator=gen, device="cuda")
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM edge G={G} kg={kg} dp={dp} {idt} {tab.dtype} "
                   f"M={M}", got, tf.tlmac_gemm_fused_plain(
                       aq, idx, cl, t32, B_a=B_a, G=G))
            n += 1
    try:
        tf.tlmac_gemm_fused(aq, idx, cl, t32, B_a=B_a, G=G)
    except ValueError:
        pass
    else:
        raise AssertionError("the kernel took an int32 table")
    log(f"  lookup GEMM edges: {n} cases (M {list(GEMM_MS)}, G 3/4, ragged "
        "kg, dp 120/128/64/5, uint8/int16 indices, int8/int16 rows) equal "
        "int32 to the plain version; an int32 table is refused")


# (name, G, K, N, dp): kernel 1 beyond the serve path's G 4 and dp <= 128
GEMM_DOMAIN_TIMED = [("G=5 4080->4096 dp 128", 5, 4080, 4096, 128),
                     ("G=6 4080->4096 dp 128", 6, 4080, 4096, 128),
                     ("G=4 4096->4096 dp 256", 4, 4096, 4096, 256)]


def phase_gemm_domain(B_a=3, n_arr=4096, n_clus=4):
    """Kernel 1 over the whole domain the reference takes: G 1-6 with dp
    5, 130, 192 and 256 (above 128 a tile runs as column tiles), uint8 and
    int16 indices, int8 and int16 rows, int32-equal to the plain version
    at M 1, 4, 17 and 64; then timed (graph replay), with its bound, at
    three layer-sized shapes of G 5, G 6 and dp 256."""
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 0
    for G in range(1, 7):
        for dp, narr, (lo, hi) in ((5, 100, (-128, 128)),
                                   (130, 600, (-8, 8)),
                                   (192, 300, (-300, 300)),
                                   (256, 200, (-20, 20))):
            kg = 29 + G
            idt = torch.uint8 if narr <= 256 else torch.int16
            idx = torch.randint(0, narr, (2, kg, dp), generator=gen,
                                device="cuda").to(idt)
            cl = torch.randint(0, 3, (2, kg), dtype=torch.int8,
                               generator=gen, device="cuda")
            tab = tf.narrow_table(torch.randint(
                lo, hi, (3, narr, 2**G), dtype=torch.int32, generator=gen,
                device="cuda"))
            for M in (1, 4, 17, 64):
                aq = torch.randint(0, 2**B_a, (M, kg * G), dtype=torch.int8,
                                   generator=gen, device="cuda")
                _equal(f"lookup GEMM G={G} dp={dp} {tab.dtype} M={M}",
                       tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G),
                       tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a,
                                                 G=G))
                n += 1
    log(f"  lookup GEMM domain: {n} cases (G 1-6, dp 5/130/192/256, uint8/"
        "int16 indices, int8/int16 rows, M 1/4/17/64) equal int32 to the "
        "plain version")
    for name, G, K, N, dp in GEMM_DOMAIN_TIMED:
        nt, kg = N // dp, K // G
        idx = torch.randint(0, n_arr, (nt, kg, dp), dtype=torch.int16,
                            generator=gen, device="cuda")
        cl = torch.randint(0, n_clus, (nt, kg), dtype=torch.int8,
                           generator=gen, device="cuda")
        tab = tf.narrow_table(torch.randint(
            -8, 8, (n_clus, n_arr, 2**G), dtype=torch.int32, generator=gen,
            device="cuda"))
        for M in (4, 64):
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device="cuda")
            run = lambda: tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM {name} M={M}", run(),
                   tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G))
            ms = graph_ms(run)
            nbytes = M * K + idx.numel() * 2 + cl.numel() + tab.numel() \
                + M * N * 4
            b = _gemm_bound(M, kg, N, G, nbytes)
            log(f"  lookup GEMM {name:22s} M={M:3d}: equal int32; kernel "
                f"{ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({_bound_by(b)}),"
                f" {b['bound_ms'] / ms:.1%} of bound")


# ---------------------------------------------------------------------------
# kernel 2: paged flash-decode
# ---------------------------------------------------------------------------

MAIN_LENS = (53, 144, 227, 316)   # four prompts of the main path + 16 tokens


def _pool(gen, kv, n_pages, P, KV, hd):
    import torch

    if kv == "fp":
        k = torch.randn((n_pages, P, KV, hd), generator=gen, device="cuda")
        v = torch.randn((n_pages, P, KV, hd), generator=gen, device="cuda")
        return k.bfloat16(), v.bfloat16(), None, None
    w = hd // 2 if kv == "int4" else hd
    lo, hi = (-128, 128) if kv == "int4" else (-127, 128)
    k, v = (torch.randint(lo, hi, (n_pages, P, KV, w), dtype=torch.int8,
                          generator=gen, device="cuda") for _ in range(2))
    ks, vs = ((torch.rand((n_pages, P, KV), generator=gen, device="cuda")
               * 0.05 + 0.001).bfloat16() for _ in range(2))
    return k, v, ks, vs


def _flash_case(gen, kv, B, KV, rep, hd, P, MB, lens, window, n_splits,
                idle=()):
    import torch

    n_pages = B * MB + 1
    k, v, ks, vs = _pool(gen, kv, n_pages, P, KV, hd)
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[:B * MB]
          + 1).reshape(B, MB).to(torch.int32)
    for b in idle:
        bt[b] = 0
    q = torch.randn((B, KV, rep, hd), generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return dict(q=q, k_pages=k, v_pages=v, block_table=bt, lengths=lengths,
                window=window, n_splits=n_splits, k_scales=ks, v_scales=vs,
                kv_dtype=kv)


def _flash_plain(a):
    from repro_torch.kernels import flash_decode as fd

    kw = dict(a)
    return fd.combine_splits(*fd.flash_decode_partials_plain(
        kw.pop("q"), kw.pop("k_pages"), kw.pop("v_pages"),
        kw.pop("block_table"), kw.pop("lengths"), **kw))


def _flash_kernel(a):
    from repro_torch.kernels import flash_decode as fd

    kw = dict(a)
    return fd.flash_decode(kw.pop("q"), kw.pop("k_pages"), kw.pop("v_pages"),
                           kw.pop("block_table"), kw.pop("lengths"), **kw)


def phase_flash():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    cases = [
        ("rep1 hd128 KV32", dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64,
                                 lens=MAIN_LENS, window=None, n_splits=4)),
        ("rep1 hd128 window 64, 1 split",
         dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64, lens=MAIN_LENS,
              window=64, n_splits=1)),
        ("rep4 hd128 KV8", dict(B=4, KV=8, rep=4, hd=128, P=16, MB=64,
                                lens=MAIN_LENS, window=None, n_splits=4)),
        ("rep4 hd16 KV2 window 8, idle slot",
         dict(B=3, KV=2, rep=4, hd=16, P=8, MB=6, lens=(1, 20, 48),
              window=8, n_splits=4, idle=(0,))),
        ("rep1 hd128 KV32, 16 splits",
         dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64, lens=MAIN_LENS,
              window=None, n_splits=16)),
        ("rep12 hd128 KV8 (2 rep chunks), idle slot",
         dict(B=3, KV=8, rep=12, hd=128, P=16, MB=32, lens=(1, 300, 77),
              window=None, n_splits=3, idle=(0,))),
        # head dims off the 8-element lane pieces (the RAGGED instances)
        ("rep4 hd18 KV2 (ragged), idle slot",
         dict(B=3, KV=2, rep=4, hd=18, P=8, MB=6, lens=(1, 20, 48),
              window=None, n_splits=4, idle=(0,))),
        ("rep1 hd36 KV4 (ragged), window 64",
         dict(B=4, KV=4, rep=1, hd=36, P=16, MB=16, lens=(53, 144, 227, 3),
              window=64, n_splits=2)),
        ("rep8 hd100 KV2 (ragged)",
         dict(B=2, KV=2, rep=8, hd=100, P=16, MB=32, lens=(300, 511),
              window=None, n_splits=4)),
        ("rep1 hd126 KV32 (ragged)",
         dict(B=4, KV=32, rep=1, hd=126, P=16, MB=64, lens=MAIN_LENS,
              window=None, n_splits=4)),
    ]
    for kv in ("fp", "int8", "int4"):
        for label, c in cases:
            a = _flash_case(gen, kv, **c)
            got = _flash_kernel(a)
            want = _flash_plain(a)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash-decode {kv} {label}: max abs err "
                                     f"{err} > {FLASH_TOL}")
            log(f"  flash-decode {kv:4s} {label:34s}: max abs err {err:.3e}")

    row = flash_main_timing(gen)
    # the RAGGED path at the same shape but hd 126 (bytes read one by one)
    reps, ms = row.pop("reps"), row["ms"]
    r = _flash_case(gen, "fp", 4, 32, 1, 126, 16, 64, MAIN_LENS, None, 4)
    rcopies = [r] + [dict(r, k_pages=r["k_pages"].clone(),
                          v_pages=r["v_pages"].clone())
                     for _ in range(reps - 1)]
    it = iter(range(1 << 30))
    ragged_ms = graph_ms(lambda: _flash_kernel(rcopies[next(it) % reps]),
                         iters=50)
    r_bytes = row.pop("nbytes") * 126 / 128
    log(f"  flash-decode fp at hd 126 (ragged instance), same shape: kernel "
        f"{ragged_ms:.4f} ms, byte bound {r_bytes / HBM_BYTES_S * 1e3:.4f} ms"
        f" ({ragged_ms / ms:.2f}x the hd-128 kernel)")
    return dict(row, max_abs_err=worst, ragged_hd126_ms=ragged_ms)


def flash_main_timing(gen):
    """Kernel 2 timed at the main path's decode shape: B=4 slots of
    full-width codeqwen (KV=32, rep=1, hd=128), 16-token pages,
    s_max=1024, pool copies rotated past the L2; the plain version, the
    bound and SDPA over gathered K/V beside it."""
    import torch

    B, KV, rep, hd, P, MB = 4, 32, 1, 128, 16, 64
    a = _flash_case(gen, "fp", B, KV, rep, hd, P, MB, MAIN_LENS, None, 4)
    reps = rotation(a["k_pages"].numel() * 4)
    copies = [a] + [dict(a, k_pages=a["k_pages"].clone(),
                         v_pages=a["v_pages"].clone()) for _ in range(reps - 1)]
    it = iter(range(1 << 30))
    run_kernel = lambda: _flash_kernel(copies[next(it) % reps])
    ms = graph_ms(run_kernel, iters=50)
    eager_ms = cuda_ms(run_kernel, iters=50)
    plain_ms = cuda_ms(lambda: _flash_plain(a), iters=5, warmup=1)
    # library yardstick: SDPA (bf16) over K/V gathered beforehand
    from repro_torch.kernels.paged import gather_kv

    kc, vc = gather_kv(a["k_pages"], a["v_pages"], a["block_table"])
    qh = a["q"].reshape(B, KV * rep, 1, hd)
    kh, vh = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    S = kc.shape[1]
    mask = (torch.arange(S, device="cuda")[None, :]
            < a["lengths"][:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=50)
    library_eager_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                               iters=50)
    # bytes the function needs: the live tokens' K and V (bf16), the
    # block-table entries of their pages, q, lengths and the f32 output
    pages = sum(-(-L // P) for L in MAIN_LENS)
    nbytes = (sum(MAIN_LENS) * KV * hd * 2 * 2 + pages * 4
              + a["q"].numel() * 2 + B * 4 + B * KV * rep * hd * 4)
    ops = 4 * KV * rep * hd * sum(MAIN_LENS)
    t_b, t_o = nbytes / HBM_BYTES_S, ops / NONTENSOR_OPS_S
    bound = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    log(f"  flash-decode fp main-path shape: kernel {ms:.4f} ms (eager calls "
        f"{eager_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
        f"({by}), SDPA over gathered K/V {library_ms:.4f} ms (eager calls "
        f"{library_eager_ms:.4f} ms); tolerance {FLASH_TOL} (f32)")
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:206",
                shape=f"B=4 KV=32 rep=1 hd=128 P=16 MB=64 fp, lengths "
                      f"{list(MAIN_LENS)}, 4 splits",
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, reps=reps, nbytes=nbytes)


# ---------------------------------------------------------------------------
# kernels 3-6: lookup GEMM on packed codes, bit-plane packing, and the
# cluster-scheduled lookup GEMM (one tile, every tile)
# ---------------------------------------------------------------------------

# the reference's own kernel test shapes (tests/test_kernels.py and
# tests/test_fused_autotune.py): (K, N, M, B_w, B_a, G[, d_p])
SWEEP = [(16, 64, 4, 2, 2, 2), (24, 64, 8, 3, 3, 3), (32, 128, 16, 3, 4, 4),
         (48, 64, 5, 4, 4, 6), (64, 192, 33, 2, 3, 4), (40, 128, 37, 3, 3, 4)]
CLUSTERED = [(64, 64, 21, 3, 3, 4), (24, 32, 7, 2, 2, 3), (48, 128, 9, 4, 4, 4)]
CLUSTERED_MULTI = [(64, 128, 21, 3, 3, 4, 64), (24, 96, 7, 2, 2, 3, 32),
                   (48, 128, 9, 4, 4, 4, 128)]
RESNET_BATCH = 32
RESNET_HW = 56      # the map sizes ImageNet ResNet-18's basic blocks see


def _equal(name, got, want):
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, want "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{name}: {bad} outputs differ")


def _bound(nbytes, ops):
    """The least time (ms) for ``nbytes`` of traffic and ``ops`` bit
    operations (the pack's) at the non-tensor rate, as fields of one
    launch: the bound and the two times it is the larger of."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / NONTENSOR_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)


def _live_steps(idx_sorted, n_arr1):
    """Steps of a cluster schedule up to each (tile, cluster) run's last
    step that selects a real row (not the zero row ``n_arr1 - 1``), summed
    over the runs: the steps whose codes a launch needs."""
    import torch

    ms, dp = idx_sorted.shape[-2:]
    real = (idx_sorted.reshape(-1, ms, dp) != n_arr1 - 1).any(-1)
    steps = torch.arange(1, ms + 1, device=real.device)
    return int(torch.where(real, steps, 0).amax(-1).sum())


def phase_lookup_small():
    """Kernels 3-6 against their plain versions (and the dense integer
    GEMM) on small compiled plans, at the reference's test shapes."""
    import numpy as np
    import torch

    from repro_torch.core.tlmac.compile import compile_layer
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.kernels import tlmac_gemm as tg

    rng = np.random.default_rng(5)

    def setup(K, N, M, B_w, B_a, G, d_p):
        w = rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=(K, N))
        plan = compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                             anneal_iters=100, seed=0)
        a = torch.from_numpy(rng.integers(0, 2**B_a, (M, K)).astype(np.int8))
        dense = ops.dense_int_matmul(a, torch.from_numpy(w))
        return plan, a.to(DEV), dense.to(DEV)

    for K, N, M, B_w, B_a, G in SWEEP:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, 64)
        codes = bp.pack_bitplanes(a, B_a=B_a, G=G)
        _equal(f"pack_bitplanes K={K} G={G}", codes,
               bp.pack_bitplanes_plain(a, B_a=B_a, G=G))
        # the kernel reads the plan's table as narrow rows, made once
        table = tf.narrow_table(torch.from_numpy(plan.table)).to(DEV)
        rb = kref.rowbase_from_plan(
            table, torch.from_numpy(plan.exec_idx).to(DEV),
            torch.from_numpy(plan.step_cluster).to(DEV), N // 64, K // G)
        t2d = table.reshape(-1, 2**G)
        got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=G, N=N)
        _equal(f"tlmac_gemm K={K} N={N} M={M} G={G}", got,
               tg.tlmac_gemm_plain(codes, rb, t2d, B_a=B_a, G=G, N=N))
        _equal(f"tlmac_gemm K={K} G={G} vs dense", got, dense)
    log(f"  kernels 3-4 on the reference's sweep ({len(SWEEP)} compiled "
        "plans, G 2/3/4/6): equal int32 to plain and to the dense GEMM")
    for K, N, M, B_w, B_a, G in CLUSTERED:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, N)
        for bk in (8, 2):
            s = tc.device_schedule(plan, 1, bk, DEV, tiled=False)
            codes = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s["cols"])
            got = tc.tlmac_gemm_clustered(codes, s["idx_sorted"],
                                          s["table_pad"], B_a=B_a, G=G)
            _equal(f"clustered K={K} N={N} bk={bk}", got,
                   tc.tlmac_gemm_clustered_plain(
                       codes, s["idx_sorted"], s["table_pad"], B_a=B_a, G=G))
            _equal(f"clustered K={K} N={N} vs dense", got, dense)
    for K, N, M, B_w, B_a, G, d_p in CLUSTERED_MULTI:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, d_p)
        s = tc.device_schedule(plan, N // d_p, 8, DEV, tiled=True)
        codes = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s["cols"])
        got = tc.tlmac_gemm_clustered_multi(codes, s["idx_sorted"],
                                            s["table_pad"], B_a=B_a, G=G)
        _equal(f"clustered multi K={K} N={N}", got,
               tc.tlmac_gemm_clustered_multi_plain(
                   codes, s["idx_sorted"], s["table_pad"], B_a=B_a, G=G))
        _equal(f"clustered multi K={K} N={N} vs dense", got, dense)
    log(f"  kernels 5-6 on the reference's clustered shapes "
        f"({len(CLUSTERED)} + {len(CLUSTERED_MULTI)} plans): equal int32 "
        "to plain and to the dense GEMM")


def phase_clustered_domain(B_a=3):
    """Kernels 5-6 on the plans the reference takes beyond the ResNet
    ones: G = 1 (a compiled plan, also equal to the dense GEMM), more
    than 128 clusters, and G = 6 at N_arr 4096 (a 262 KB int8 / 524 KB
    int16 slice, more than a block's shared memory holds), each against
    its plain version; the large-slice case timed by graph replay."""
    import numpy as np
    import torch

    from repro_torch.core.tlmac.compile import compile_layer
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import tlmac_clustered as tc

    rng = np.random.default_rng(6)
    K, N, M = 48, 192, 70
    w = rng.integers(-2, 2, size=(K, N))
    plan = compile_layer(w, B_w=2, B_a=B_a, G=1, d_p=64, anneal_iters=100,
                         seed=0)
    a = torch.from_numpy(rng.integers(0, 2**B_a, (M, K)).astype(np.int8))
    dense = ops.dense_int_matmul(a, torch.from_numpy(w)).to(DEV)
    a = a.to(DEV)
    s = tc.device_schedule(plan, N // 64, 8, DEV, tiled=True)
    codes = bp.pack_bitplanes(a, B_a=B_a, G=1).index_select(2, s["cols"])
    got = tc.tlmac_gemm_clustered_multi(codes, s["idx_sorted"],
                                        s["table_pad"], B_a=B_a, G=1)
    _equal("clustered multi G=1 plan", got, tc.tlmac_gemm_clustered_multi_plain(
        codes, s["idx_sorted"], s["table_pad"], B_a=B_a, G=1))
    _equal("clustered multi G=1 plan vs dense", got, dense)
    gen = torch.Generator(device=DEV).manual_seed(6)
    for n_clus, n_arr1, G, dtype, ms, dp in (
            (130, 33, 3, torch.int8, 16, 64), (200, 17, 4, torch.int16, 8, 120),
            (4, 4097, 6, torch.int8, 24, 192), (4, 4097, 6, torch.int16, 24, 192)):
        lo, hi = (-128, 128) if dtype == torch.int8 else (-3000, 3000)
        table = torch.randint(lo, hi, (n_clus, n_arr1, 2**G), generator=gen,
                              device=DEV).to(dtype)
        table[:, -1] = 0
        idx = torch.randint(0, n_arr1 - 1, (2, n_clus, ms, dp), generator=gen,
                            device=DEV).to(torch.int32)
        idx[:, :, ms - 3:] = n_arr1 - 1
        cs = torch.randint(0, 2**G, (B_a, 256, 2 * n_clus * ms),
                           generator=gen, device=DEV).to(torch.int8)
        run = lambda: tc.tlmac_gemm_clustered_multi(cs, idx, table, B_a=B_a,
                                                    G=G)
        what = (f"G={G} {n_clus} clusters N_arr+1={n_arr1} {dtype} "
                f"(slice {n_arr1 * 2**G * table.element_size()} bytes)")
        _equal(f"clustered multi {what}", run(),
               tc.tlmac_gemm_clustered_multi_plain(cs, idx, table, B_a=B_a,
                                                   G=G))
        _equal(f"clustered {what}", tc.tlmac_gemm_clustered(
            cs[:, :, :n_clus * ms].contiguous(), idx[0], table, B_a=B_a, G=G),
            tc.tlmac_gemm_clustered_plain(cs[:, :, :n_clus * ms], idx[0],
                                          table, B_a=B_a, G=G))
        log(f"  kernels 5-6, {what}, M 256, 2 tiles x dp {dp}: equal int32; "
            f"kernel 6 {graph_ms(run):.4f} ms")
    log("  kernels 5-6 at G 1 (compiled plan, == dense GEMM), 130 and 200 "
        "clusters, and G 6 at N_arr 4096: equal int32 to plain")


def resnet_convs(cfg, plans):
    """(name, plan, input shape [B, H, W, C_in], stride, stage) of every
    basic-block conv at input resolution ``RESNET_HW``."""
    from repro_torch.models.resnet import block_strides

    out, it = [], iter(plans)
    hw, cin = RESNET_HW, cfg.width
    strides = block_strides(cfg)
    bi = 0
    for si, (ch, n, _) in enumerate(cfg.stages):
        for _ in range(n):
            s = strides[bi]
            for ci, (c_in, st) in enumerate(((cin, s), (ch, 1))):
                name, plan = next(it)
                out.append((name, plan, (RESNET_BATCH, hw, hw, c_in), st,
                            si + 1))
                if ci == 0:
                    hw = -(-hw // s)
            cin = ch
            bi += 1
    return out


def compile_full_resnet(cfg):
    """ResNet ``cfg`` (full-width ResNet-18 in the run) drawn on the card
    and its basic-block convs compiled on the host; prints the Fig. 8
    report."""
    import torch

    from repro_torch.core.tlmac.compile import verify_plan
    from repro_torch.models import resnet as R

    params = R.init_resnet(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), device=DEV)
    # time each conv's compile_layer inside the compile_resnet call
    secs, compile_layer = [], R.tlc.compile_layer

    def timed(*a, **kw):
        t = time.perf_counter()
        plan = compile_layer(*a, **kw)
        secs.append(time.perf_counter() - t)
        return plan

    R.tlc.compile_layer = timed
    t0 = time.perf_counter()
    try:
        plans = R.compile_resnet(params, cfg)
    finally:
        R.tlc.compile_layer = compile_layer
    total = time.perf_counter() - t0
    log(f"  compile_resnet: {len(plans)} convs in {total:.1f} s on the host (default "
        "anneal_iters=2000); verify_plan holds on each")
    log("  Fig. 8 report (FPGA cost model, not a card measurement):")
    log(f"    {'conv':14s} {'shape':>16s} {'N_uwg':>6s} {'N_clus':>6s} "
        f"{'N_arr':>6s} {'D_s':>5s} {'D_p':>4s} {'LUTs':>8s} "
        f"{'routes before->after':>22s} {'compile s':>9s}")
    for (name, plan), sec in zip(plans, secs):
        if not verify_plan(plan):
            raise AssertionError(f"verify_plan fails on {name}")
        log(f"    {name:14s} {str(tuple(plan.orig_shape)):>16s} "
            f"{plan.N_uwg:6d} {plan.N_clus:6d} {plan.N_arr:6d} {plan.D_s:5d} "
            f"{plan.D_p:4d} {plan.resources.luts:8d} "
            f"{plan.routes_before:10d} -> {plan.routes_after:8d} {sec:9.2f}")
    return params, plans


def _conv_inputs(shape, seed, B_a):
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(0, 2**B_a, shape, dtype=torch.int8, generator=gen,
                         device=DEV)


def _dense_weights(w_codes, n_rows):
    """The conv's integer weights as ``[C*3, O*len(rows)]`` int8 for
    ``torch._int_mm`` against the windows: row ``c*3 + j``, column ``o*R +
    ri`` holds ``w[o, c, rows[ri], j]`` (the column order of a conv plan's
    outputs, ``oc*3 + r``, when all three rows are taken)."""
    import torch

    O, C = w_codes.shape[:2]
    w = torch.as_tensor(w_codes, dtype=torch.int8, device=DEV)
    rows = w[:, :, list(n_rows), :]                   # [O, C, R, 3]
    return rows.permute(1, 3, 0, 2).reshape(C * 3, O * len(n_rows)).contiguous()


def phase_resnet_kernels(cfg, params, plans):
    """Kernels 1 and 3-6 at the 16 full-width conv shapes: each against
    its plain version (int32-equal), kernels 5/6 against kernel 3's row
    GEMMs; kernel, plain, bound and library times summed per stage."""
    import torch

    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R

    B_a = cfg.a_bits
    keys = ("pack_bitplanes", "tlmac_gemm", "tlmac_gemm_clustered",
            "tlmac_gemm_clustered_multi", "tlmac_gemm_fused", "conv")
    acc = {k: {} for k in keys}

    def add(kind, stage, **vals):
        for f, v in vals.items():
            if v is None:
                continue
            d = acc[kind].setdefault(stage, {})
            d[f] = d.get(f, 0.0) + v

    for ci, (name, plan, shape, stride, stage) in enumerate(
            resnet_convs(cfg, plans)):
        a = _conv_inputs(shape, 100 + ci, B_a)
        win = R.conv_windows(a)
        M, K = win.shape
        C = shape[3]
        n_ot = plan.D_s // C
        dpc = plan.D_p // 3           # output channels per tile
        N = n_ot * dpc
        w_codes = R.quantize_conv_weights(params["blocks"][ci // 2][
            "conv1" if ci % 2 == 0 else "conv2"], cfg)
        # kernel 4
        codes = bp.pack_bitplanes(win, B_a=B_a, G=3)
        _equal(f"{name} pack", codes,
               bp.pack_bitplanes_plain(win, B_a=B_a, G=3))
        pack = lambda: bp.pack_bitplanes(win, B_a=B_a, G=3)
        add("pack_bitplanes", stage, ms=graph_ms(pack, iters=5, replays=3),
            eager_ms=cuda_ms(pack, 10),
            plain_ms=cuda_ms(lambda: bp.pack_bitplanes_plain(
                win, B_a=B_a, G=3), 2, 1), n=1,
            **_bound(M * K + codes.numel(), M * K * B_a))
        # kernel 3 (three row GEMMs) and kernel 1 on the same row plans;
        # both read the plan's table (one for all rows) as the narrow rows
        # conv_row_plan made once
        rows = []
        tn = R.conv_row_plan(plan, 0, DEV)[0]
        for r in range(3):
            table, ex, cl = R.conv_row_plan(plan, r, DEV)
            rb = kref.rowbase_from_plan(table, ex, cl, n_ot, C)
            t2d = table.reshape(-1, 8)
            got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=3, N=N)
            _equal(f"{name} row {r} tlmac_gemm", got, tg.tlmac_gemm_plain(
                codes, rb, t2d, B_a=B_a, G=3, N=N))
            rows.append(got)
            wr = _dense_weights(w_codes, (r,))
            lib = torch._int_mm(win, wr)
            _equal(f"{name} row {r} _int_mm", lib, got)
            lib_ms = cuda_ms(lambda: torch._int_mm(win, wr), 10)
            gemm = lambda: tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=3, N=N)
            add("tlmac_gemm", stage, ms=graph_ms(gemm, iters=5, replays=3),
                eager_ms=cuda_ms(gemm, 10),
                plain_ms=cuda_ms(lambda: tg.tlmac_gemm_plain(
                    codes, rb, t2d, B_a=B_a, G=3, N=N), 2, 1),
                library_ms=graph_ms(lambda: torch._int_mm(win, wr), iters=5,
                                    replays=3),
                library_eager_ms=lib_ms, n=1,
                **_gemm_bound(M, C, N, 3, codes.numel() + rb.numel() * 4
                              + t2d.numel() * t2d.element_size()
                              + M * N * 4))
            idx_t = (torch.uint8 if plan.N_arr <= 256 else torch.int16)
            ex3 = ex.reshape(n_ot, C, dpc).to(idx_t)
            cl2 = cl.reshape(n_ot, C).to(torch.int8)
            fz = tf.tlmac_gemm_fused(win, ex3, cl2, tn, B_a=B_a, G=3)
            _equal(f"{name} row {r} tlmac_gemm_fused", fz, got)
            bound = _gemm_bound(M, C, N, 3, M * K
                                + ex3.numel() * ex3.element_size()
                                + cl2.numel() + tn.numel()
                                * tn.element_size() + M * N * 4)["bound_ms"]
            add("tlmac_gemm_fused", stage,
                ms=cuda_ms(lambda: tf.tlmac_gemm_fused(win, ex3, cl2, tn,
                                                       B_a=B_a, G=3), 10),
                plain_ms=cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                    win, ex3, cl2, tn, B_a=B_a, G=3), 2, 1),
                library_ms=lib_ms, n=1, bound_ms=bound)
        # kernels 6 and (single-tile convs) 5 on the same windows
        w3 = _dense_weights(w_codes, (0, 1, 2))
        for kind, tiled in (("tlmac_gemm_clustered_multi", True),
                            ("tlmac_gemm_clustered", False)):
            if not tiled and n_ot != 1:
                continue
            s = tc.device_schedule(plan, n_ot, 8, DEV, tiled=tiled)
            cs = codes.index_select(2, s["cols"])
            idx = s["idx_sorted"]
            fn, plain = ((tc.tlmac_gemm_clustered_multi,
                          tc.tlmac_gemm_clustered_multi_plain) if tiled else
                         (tc.tlmac_gemm_clustered,
                          tc.tlmac_gemm_clustered_plain))
            got = fn(cs, idx, s["table_pad"], B_a=B_a, G=3)
            _equal(f"{name} {kind}", got, plain(cs, idx, s["table_pad"],
                                                B_a=B_a, G=3))
            per_row = got.reshape(M, n_ot, dpc, 3)
            for r in range(3):
                _equal(f"{name} {kind} row {r} vs tlmac_gemm",
                       per_row[..., r].reshape(M, N), rows[r])
            lib = torch._int_mm(win, w3)
            _equal(f"{name} _int_mm of the plan's weights", lib, got)
            tab = s["table_pad"]
            run = lambda: fn(cs, idx, tab, B_a=B_a, G=3)
            # the codes of the live steps only (the padding after a run's
            # last real step is never read); the one-hot product the same
            live = _live_steps(idx, tab.shape[1])
            add(kind, stage, ms=graph_ms(run, iters=5, replays=3),
                eager_ms=cuda_ms(run, 10),
                plain_ms=cuda_ms(lambda: plain(cs, idx, tab, B_a=B_a, G=3),
                                 2, 1),
                library_ms=graph_ms(lambda: torch._int_mm(win, w3), iters=5,
                                    replays=3),
                library_eager_ms=cuda_ms(lambda: torch._int_mm(win, w3), 10),
                n=1,
                **_gemm_bound(M, live, plan.D_p, 3, B_a * M * live
                              + idx.numel() * 4
                              + tab.numel() * tab.element_size()
                              + M * N * 3 * 4))
        # the whole conv: integer codes through conv2d in f32 (TF32 off)
        (ht, hb), (wl, wr_) = (R.same_pads(shape[1], 3, stride),
                               R.same_pads(shape[2], 3, stride))
        xf = torch.nn.functional.pad(a.permute(0, 3, 1, 2).float(),
                                     (wl, wr_, ht, hb))
        wf = torch.as_tensor(w_codes, dtype=torch.float32, device=DEV)
        add("conv", stage, library_ms=cuda_ms(
            lambda: torch.nn.functional.conv2d(xf, wf, stride=stride), 10), n=1)
        del rows, codes, win
    torch.cuda.empty_cache()

    def total(kind):
        t = {}
        for d in acc[kind].values():
            for f, v in d.items():
                t[f] = t.get(f, 0.0) + v
        return t

    def line(kind, what, d):
        lib = d.get("library_ms")
        eager = (f" (eager calls {d['eager_ms']:.4f} ms)" if "eager_ms" in d
                 else "")
        lib_eager = (f" (eager {d['library_eager_ms']:.4f} ms)"
                     if "library_eager_ms" in d else "")
        bound = (f", bound {d['bound_ms']:.4f} ms (bytes {d['bytes_ms']:.4f}"
                 f", ops {d['ops_ms']:.4f})" if "bytes_ms" in d else
                 f", bound {d['bound_ms']:.4f} ms")
        log(f"  {kind:27s} {what} ({int(d['n'])} launches): kernel "
            f"{d['ms']:.4f} ms{eager}, plain {d['plain_ms']:.3f} ms{bound}, "
            "library " + (f"{lib:.4f} ms{lib_eager}" if lib is not None
                          else "none"))

    for kind in keys[:-1]:
        for stage, d in sorted(acc[kind].items()):
            line(kind, f"stage {stage}", d)
        line(kind, "all stages", total(kind))
    for stage, d in sorted(acc["conv"].items()):
        look = sum(acc[k][stage]["ms"] for k in ("pack_bitplanes", "tlmac_gemm"))
        log(f"  stage {stage} lookup convs (pack + 3 row GEMMs) {look:.4f} ms "
            f"vs integer conv2d (f32, TF32 off) {d['library_ms']:.4f} ms")
    meta = {
        "pack_bitplanes": ("csrc/bitplanes.cu", "src/repro/kernels/bitplanes.py:41",
                           "16 packs of the 1x3 windows, M = 32*56^2..32*7^2 "
                           "(device time by CUDA-graph replay)"),
        "tlmac_gemm": ("csrc/tlmac_gemm.cu", "src/repro/kernels/tlmac_gemm.py:136",
                       "48 kernel-row lookup GEMMs of the 16 convs, narrow "
                       "tables (device time by CUDA-graph replay)"),
        "tlmac_gemm_clustered": (
            "csrc/tlmac_clustered.cu", "src/repro/kernels/tlmac_clustered.py:128",
            "the 4 single-tile stage-1 convs, all three kernel rows "
            "(device time by CUDA-graph replay)"),
        "tlmac_gemm_clustered_multi": (
            "csrc/tlmac_clustered.cu", "src/repro/kernels/tlmac_clustered.py:290",
            "all 16 convs, all three kernel rows, one launch each (device "
            "time by CUDA-graph replay)"),
    }
    entries = {}
    for kind, (src, rep, shape) in meta.items():
        t = total(kind)
        entries[kind] = dict(
            name=kind, route="cuda", source="src/repro_torch/" + src,
            replaces=rep, shape=f"ResNet-18 batch {RESNET_BATCH} at "
            f"{RESNET_HW}x{RESNET_HW}: {shape}", max_abs_err=0, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=_bound_by(t),
            library_ms=t.get("library_ms"))
    fz = total("tlmac_gemm_fused")
    log(f"  tlmac_gemm_fused on the 48 compiled row plans: kernel "
        f"{fz['ms']:.4f} ms, plain {fz['plain_ms']:.3f} ms, bound "
        f"{fz['bound_ms']:.4f} ms, torch._int_mm {fz['library_ms']:.4f} ms")
    return entries


def phase_paper_path(cfg, params, plans):
    """The paper's compile-and-execute flow at full width: forward on 32
    images, then every conv as a lookup conv (kernels 4 + 3) and as one
    cluster-scheduled launch (kernels 4 + 6; kernel 5 too on the
    single-tile convs), with every launch counter read around the run."""
    import numpy as np
    import torch

    from repro_torch.core.quant import quantizers as Q
    from repro_torch.core.tlmac.api import TLMACLinear
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R

    B_a = cfg.a_bits
    convs = resnet_convs(cfg, plans)
    inputs = [_conv_inputs(shape, 100 + ci, B_a)
              for ci, (_, _, shape, _, _) in enumerate(convs)]
    x = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                    generator=torch.Generator(device=DEV).manual_seed(7),
                    device=DEV)
    torch.cuda.synchronize()
    bp.launches = tg.launches = tc.launches = tc.launches_multi = 0
    t0 = time.perf_counter()
    logits = R.forward(params, x, cfg)
    outs = []
    for (name, plan, shape, stride, _), a in zip(convs, inputs):
        n_ot = plan.D_s // shape[3]
        out = R.tlmac_conv_forward(plan, a, cfg.quant, stride)
        win = R.conv_windows(a)
        multi = tc.run_clustered_multi(plan, win, B_a, N=n_ot * plan.D_p)
        single = tc.run_clustered(plan, win, B_a) if n_ot == 1 else None
        outs.append((out, multi, single))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"pack_bitplanes": bp.launches, "tlmac_gemm": tg.launches,
              "tlmac_gemm_clustered": tc.launches,
              "tlmac_gemm_clustered_multi": tc.launches_multi}
    n_single = sum(1 for _, p, s, _, _ in convs if p.D_s // s[3] == 1)
    want = {"pack_bitplanes": 2 * len(convs) + n_single,
            "tlmac_gemm": 3 * len(convs), "tlmac_gemm_clustered": n_single,
            "tlmac_gemm_clustered_multi": len(convs)}
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    if logits.shape != (RESNET_BATCH, cfg.num_classes) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    n = len(convs)
    log(f"  forward: logits {tuple(logits.shape)} finite; the path (forward "
        f"+ {n} lookup convs + {n} clustered + {n_single} single-tile) ran in "
        f"{wall:.2f} s (host clock, first calls)")
    log(f"  launches: pack_bitplanes {counts['pack_bitplanes']} (= {n} lookup "
        f"convs + {n} clustered + {n_single} single-tile), tlmac_gemm "
        f"{counts['tlmac_gemm']} (= 3 rows x {n}), tlmac_gemm_clustered "
        f"{counts['tlmac_gemm_clustered']}, tlmac_gemm_clustered_multi "
        f"{counts['tlmac_gemm_clustered_multi']}")
    for ci, ((name, plan, shape, stride, _), a, (out, multi, single)) in \
            enumerate(zip(convs, inputs, outs)):
        blk = params["blocks"][ci // 2]["conv1" if ci % 2 == 0 else "conv2"]
        w = torch.as_tensor(R.quantize_conv_weights(blk, cfg), device=DEV)
        ref = int_conv(a, w, stride)
        _equal(f"{name} lookup conv vs integer conv", out, ref)
        n_ot = plan.D_s // shape[3]
        B, H, W, _ = shape
        dpc = plan.D_p // 3
        rows = multi.reshape(B, H, W, n_ot, dpc, 3)
        _equal(f"{name} clustered conv vs integer conv", R.combine_row_sums(
            [rows[..., r].reshape(B, H, W, n_ot * dpc) for r in range(3)],
            stride), ref)
        if single is not None:
            _equal(f"{name} single-tile clustered", single, multi)
        log(f"  {name:14s} {str(shape):20s} stride {stride}: lookup conv "
            f"{tuple(out.shape)} == integer conv; clustered == integer conv")
    # the quickstart's layer through TLMACLinear, outside the counted run
    rng = np.random.default_rng(0)
    K, N, M = 128, 256, 32
    wq = rng.normal(size=(K, N)) * 0.05
    lin = TLMACLinear.from_weights(wq, w_bits=3, a_bits=3, G=4, d_p=64,
                                   anneal_iters=5000, device=DEV)
    xs = torch.as_tensor(np.abs(rng.normal(size=(M, K))), dtype=torch.float32,
                         device=DEV)
    lin.calibrate(xs)
    aq = torch.clamp(torch.round(xs / lin.a_step), 0, 7).to(torch.int8)
    w_codes = Q.quantize_weights_int(
        torch.as_tensor(wq, dtype=torch.float32, device=DEV),
        Q.QuantConfig(w_bits=3, a_bits=3, per_channel=False),
        step=lin.w_step)[0]
    yi = ops.tlmac_matmul(aq, *lin._plan_arrays(DEV), B_a=3, G=4, N=N,
                          impl="pallas")
    _equal("TLMACLinear lookup GEMM vs dense", yi,
           ops.dense_int_matmul(aq, w_codes))
    y = lin(xs)
    if y.shape != (M, N) or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError("TLMACLinear output not finite")
    log(f"  TLMACLinear K={K} N={N} M={M}: lookup GEMM == dense_int_matmul; "
        f"plan N_uwg {lin.plan.N_uwg}, N_arr {lin.plan.N_arr}")
    return counts


def int_conv(a, w, stride):
    """The integer 3x3 conv of codes ``a [B, H, W, C]`` with weights ``w
    [O, C, 3, 3]`` (SAME padding as XLA): im2col + the port's exact
    dense integer GEMM."""
    from repro_torch.kernels.ops import dense_int_matmul
    from repro_torch.models.resnet import same_pads

    import torch.nn.functional as F

    B, H, W, C = a.shape
    (ht, hb), (wl, wr) = same_pads(H, 3, stride), same_pads(W, 3, stride)
    x = F.pad(a.permute(0, 3, 1, 2).double(), (wl, wr, ht, hb))
    cols = F.unfold(x, 3, stride=stride)                 # [B, C*9, L]
    Ho, Wo = (H + ht + hb - 3) // stride + 1, (W + wl + wr - 3) // stride + 1
    y = dense_int_matmul(cols.transpose(1, 2).reshape(-1, C * 9),
                         w.reshape(w.shape[0], -1).T)
    return y.reshape(B, Ho, Wo, w.shape[0])


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def _requests(vocab, lens, max_new, seed):
    import numpy as np

    from repro_torch.serve.loop import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]


PROFILED_STEP = 10   # decode step traced with torch.profiler


def _profiled(fn, a, kw, host: int = 0):
    """Run one forward (a graph replay) under torch.profiler and print
    where its device time goes: the two hand kernels, every other kernel,
    and the busy share of the step's wall time.  Where the profiler
    records no kernel, the device time between CUDA events around the
    replay stands in for the busy time (said so in the line).  ``host``:
    also the ``host`` host ops of most self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ev[0].record()
        logits = fn(*a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    span = ev[0].elapsed_time(ev[1])
    by_name = {}
    for e in prof.key_averages():
        # kernel events only: CPU ops carry their kernels' time as well,
        # and an eager forward's record_function ranges (repro_torch.*)
        # appear on the device as spans over its kernels
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or e.key.startswith("repro_torch."):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if not busy:
        log(f"  profiled decode step {PROFILED_STEP}: the profiler recorded "
            f"no kernel; CUDA events around the replay: {span:.2f} ms of "
            f"{wall:.2f} ms wall ({span / wall:.1%}), idle "
            f"{1 - span / wall:.1%}")
        return logits
    gemm = sum(v for k, v in by_name.items() if "tlmac_fused_" in k)
    expert = sum(v for k, v in by_name.items() if "tlmac_fused_expert_" in k)
    flash = sum(v for k, v in by_name.items() if "flash_decode_kernel" in k)
    others = sorted(((v, k) for k, v in by_name.items()
                     if "tlmac_fused_" not in k
                     and "flash_decode_kernel" not in k), reverse=True)
    split = (f" (expert-stacked {expert:.2f} ms, single linears "
             f"{gemm - expert:.2f} ms)" if expert else "")
    log(f"  profiled decode step {PROFILED_STEP}: wall {wall:.2f} ms (under "
        f"the profiler), device busy {busy:.2f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}; lookup GEMM {gemm:.2f} ms{split}, "
        f"flash-decode {flash:.2f} ms, {len(others)} other kernels "
        f"{busy - gemm - flash:.2f} ms; CUDA events around the replay "
        f"{span:.2f} ms")
    for v, k in others[:5]:
        log(f"    {v:8.3f} ms  {k[:90]}")
    if host:
        ops = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None)
                      == torch.autograd.DeviceType.CPU), reverse=True)
        log(f"    host, self CPU ms (calls) of the {host} costliest ops:")
        for ms, n, k in ops[:host]:
            log(f"    {ms:8.3f} ms ({n})  {k[:80]}")
    return logits


def init_main_model():
    """Full-width codeqwen1.5-7b with seeded random TLMAC plans, drawn on
    the card; returns (cfg, params)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("codeqwen1.5-7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_lm(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def main_loop(params, cfg, **kw):
    """The serve loop of the main path: 4 slots, s_max 1024, page 16,
    chunk 64, the reference's defaults (prefix cache, on-demand pages,
    priority preemption) unless ``kw`` overrides them."""
    from repro_torch.serve.paged import PagedServeLoop

    kw = dict(dict(batch_slots=4, s_max=1024, page_size=16, chunk=CHUNK,
                   device=DEV, check_invariants=True), **kw)
    return PagedServeLoop(params, cfg, **kw)


def graph_parity(loop, cfg):
    """Two prefill chunks (start 0 and 2 * chunk) and one decode step,
    each replayed from the loop's CUDA graph (the first call captures it)
    and run eagerly on the same inputs: the logits must be bit-equal.
    The block tables name distinct pages (writing the same K/V twice is
    idempotent, and no page is written twice within a forward)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    MB = loop.spec.max_blocks
    row = np.arange(1, MB + 1, dtype=np.int32)
    bt = (np.arange(loop.B * MB, dtype=np.int32).reshape(loop.B, MB) + 1) \
        % (loop.spec.n_pages - 1) + 1
    cases = [("chunk", (rng.integers(0, cfg.vocab, (1, CHUNK)), start, row,
                        CHUNK - 1), loop._prefill_chunk, loop._chunk_fn)
             for start in (0, 2 * CHUNK)]
    cases.append(("decode", (rng.integers(0, cfg.vocab, (loop.B, 1)),
                             np.array([200, 37, 511, 0][:loop.B]), bt),
                  loop._decode, loop._decode_fn))
    for kind, args, graph_fn, eager_fn in cases:
        got = graph_fn(*args).clone()
        want = eager_fn(*[torch.as_tensor(np.asarray(x, np.int32),
                                          device=DEV) for x in args])
        if DEV == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{kind} graph replay differs from eager by "
                f"{(got.float() - want.float()).abs().max().item()}")
    log(f"  graph replay == eager, bit for bit: chunk at start 0 and "
        f"{2 * CHUNK}, decode step; captured {loop.compiled_shapes()}, "
        "launches recorded per graph: " + ", ".join(
            f"{k} {f.graph_launches}" for k, f in loop.forwards.items()))


def _lookup_launches(params):
    """Kernel-1 launches of one forward: every serve linear whose params
    carry a TLMAC table, one launch each, an expert stack included, over
    every layer of every segment; and how many of them are expert stacks
    (``exec_idx [E, n_tiles, kg, dp]``).  Returns (total, expert)."""
    def walk(tree):
        if "table" in tree:
            return 1, int(tree["exec_idx"].dim() == 4)
        sums = [walk(v) for v in tree.values() if isinstance(v, dict)]
        return sum(a for a, _ in sums), sum(b for _, b in sums)

    total = expert = 0
    for si in range(len(params.segments)):
        layers = params.layers(si)
        n, e = walk(layers[0])
        total, expert = total + n * len(layers), expert + e * len(layers)
    return total, expert


def phase_main(cfg, params, lens=PROMPT_LENS, max_new=MAX_NEW, setup=None,
               **kw):
    """The main path: full-width codeqwen1.5-7b served on the card under
    the reference's defaults, its two forwards replayed from CUDA graphs.
    Later families run the same path over ``lens`` prompts of ``max_new``
    tokens (``kw`` goes to the loop, ``setup(loop)`` may wrap its forwards
    before the run); the launch assertions count every serve linear's
    lookup GEMM, ``7 x layers`` a forward when all seven are TLMAC."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    sync = torch.cuda.synchronize
    loop = main_loop(params, cfg, **kw)
    by_kind = {}
    for name, t in params.named_buffers():
        kind = name.rsplit(".", 1)[-1]
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    for name, t in params.named_parameters():
        kind = "embed/head" if name.split(".")[0] in ("embed", "head") \
            else "float weights"
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    pool = loop.kv_pool_bytes()
    log("  reckoned memory: " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in sorted(by_kind.items()))
        + f", KV pool {pool / 2**30:.3f} GiB; total "
        f"{(sum(by_kind.values()) + pool) / 2**30:.3f} GiB")
    graph_parity(loop, cfg)

    steps = _step_times(loop, ("_prefill_chunk", "_decode"),
                        profiled="_decode")
    if setup is not None:
        setup(loop)
    reqs = _requests(cfg.vocab, lens, max_new, SEED)
    for r in reqs:
        loop.submit(r)
    torch.cuda.reset_peak_memory_stats()
    # every launch counter set to 0 just before the run: the wrappers'
    # (eager launches) and the graphs' replay counts
    _reset_launches(loop)
    t_run = time.perf_counter()
    done = loop.run()
    sync()
    wall = time.perf_counter() - t_run
    calls = {"prefill": steps["_prefill_chunk"]["calls"],
             "decode": steps["_decode"]["calls"]}
    eager = {"tlmac_gemm_fused": tf.launches, "flash_decode": fd.launches}
    counts, _ = _read_launches(loop)
    assert len(done) == len(reqs), (len(done), len(reqs))
    for r in done:
        assert len(r.output) == max_new, (r.rid, len(r.output))
        assert 0 <= int(r.output.min()) and int(r.output.max()) < cfg.vocab
    if len(lens) > loop.B:
        assert loop.refills >= 2, f"only {loop.refills} mid-decode admissions"
    loop.check_compiled()
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}, \
        loop.compiled_shapes()
    per_fwd, per_fwd_expert = _lookup_launches(params)
    forwards = calls["prefill"] + calls["decode"]
    if DEV == "cuda":         # plain versions (the CPU) count nothing
        assert {k: f.replays for k, f in loop.forwards.items()} == {
            "chunk": calls["prefill"], "decode": calls["decode"]}
        want_flash = cfg.n_layers * calls["decode"]
        assert counts["tlmac_gemm_fused"] == per_fwd * forwards, (
            counts, per_fwd * forwards)
        assert counts["tlmac_gemm_fused_expert"] == (
            per_fwd_expert * forwards), (counts, per_fwd_expert * forwards)
        assert counts["flash_decode"] == want_flash, (counts, want_flash)
    loop.pages.check()
    loop.prefix.check()
    dec = sorted(steps["_decode"]["ms"])
    prefill_s = sum(steps["_prefill_chunk"]["ms"]) / 1e3
    prompt_tokens = sum(lens)
    log(f"  served {len(done)} requests x {max_new} tokens in {wall:.2f} s: "
        f"{calls['prefill']} prefill chunks (chunk {CHUNK}), "
        f"{calls['decode']} decode steps, {loop.refills} mid-decode "
        "admissions; all logits finite; compiled "
        f"{loop.compiled_shapes()} (check_compiled holds)")
    span = _median(steps["_decode"]["span"])
    log(f"  decode step: median {_median(dec):.2f} ms, min {dec[0]:.2f} ms, "
        f"max {dec[-1]:.2f} ms (batch_slots 4, host clock around a "
        f"synchronised step); device span (CUDA events around the copies "
        f"and the replay) median {span:.2f} ms, {span / _median(dec):.1%} "
        f"of the median step")
    log(f"  prefill: {prompt_tokens} prompt tokens in {prefill_s:.2f} s = "
        f"{prompt_tokens / prefill_s:.1f} tok/s "
        f"({calls['prefill'] * CHUNK} padded chunk tokens)")
    log(f"  max_memory_allocated during the run: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    st = loop.sched_stats()
    log(f"  defaults: prefix cache {loop.prefix.stats()['nodes']} pages "
        f"kept, {loop.prefill_tokens_saved} prefill tokens saved; "
        f"on-demand pages grown {st['grown_pages']}, preemptions "
        f"{st['preemptions']}, peak live slots {st['peak_live_slots']}, pool "
        f"peak {st['pool_pages_peak']} of {loop.spec.n_pages - 1} pages")
    expert_note = (f", of which expert-stacked "
                   f"{counts['tlmac_gemm_fused_expert']} (= "
                   f"{per_fwd_expert} x {forwards})" if per_fwd_expert
                   else "")
    log(f"  launches: lookup GEMM {counts['tlmac_gemm_fused']} (= "
        f"{per_fwd} a forward x {forwards} forwards{expert_note}), "
        f"flash-decode {counts['flash_decode']} (= {cfg.n_layers}"
        f" x {calls['decode']} decode steps): graph launches recorded at "
        f"capture x replays ({', '.join(f'{k} {f.replays}' for k, f in loop.forwards.items())}"
        f") + eager launches {eager}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(outputs={r.rid: r.output.tolist() for r in done},
                        decode_ms=_median(dec), span_ms=span,
                        prefill_tok_s=prompt_tokens
                        / prefill_s, wall=wall, forwards=forwards)


# ---------------------------------------------------------------------------
# serve features at full width: shared prefix, pool pressure
# ---------------------------------------------------------------------------

SYSTEM_LEN = 512                                  # shared system prompt
SUFFIXES = (16, 64, 128, 96, 32, 112, 48, 80)     # distinct suffixes
PRESSURE_PAGES = 60   # 59 usable: on-demand growth of the set then preempts


def _shared_requests(vocab, seed):
    import numpy as np

    from repro_torch.serve.loop import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_LEN).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
                [system, rng.integers(0, vocab, n).astype(np.int32)]),
                max_new_tokens=MAX_NEW) for i, n in enumerate(SUFFIXES)]


def _serve_margins(loop):
    """Hook ``loop`` so that, per request, the top-2 margin test of every
    emitted token is recorded: True where the margin clears LOGIT_TOL x
    the step's max |logit| (the first token from the admission's last
    prefill chunk, the rest from decode rows).  For runs without
    preemption."""
    import torch

    first, dec, cur = {}, {}, {}

    def clear(lg):
        top2 = lg.float().topk(2, dim=-1).values
        return ((top2[..., 0] - top2[..., 1])
                > LOGIT_TOL * lg.float().abs().amax(-1)).cpu().tolist()

    pop, chunk, decode = loop.sched.pop, loop._prefill_chunk, loop._decode

    def pop_w(ent):
        cur["rid"] = ent.req.rid
        return pop(ent)

    def chunk_w(*a):
        lg = chunk(*a)
        first[cur["rid"]] = clear(lg[None])[0]     # the last chunk's wins
        return lg

    def decode_w(*a):
        lg = decode(*a)
        ok = clear(lg)
        for i, s in enumerate(loop.slots):
            if s is not None:
                dec.setdefault(s["req"].rid, []).append(ok[i])
        return lg

    loop.sched.pop, loop._prefill_chunk, loop._decode = pop_w, chunk_w, \
        decode_w
    return lambda rid: [first[rid]] + dec.get(rid, [])


def phase_serve_features(cfg, params):
    """The shared-prefix set (8 requests: one 512-token system prompt, a
    distinct 16-128-token suffix each, 32 new tokens) served three ways:
    cache off; under the defaults (prefix hits, skipped chunks; tokens
    equal to the cache-off run wherever its top-2 margin clears the
    card-vs-CPU tolerance); and in a pool small enough that on-demand
    growth preempts (every request finishes, no page leaks; the share of
    tokens equal to the unpressured run is printed: a recompute prefill
    reads K/V through the chunk's attention where decode used
    flash-decode, so it is not bit-exact)."""
    import torch

    runs = {}
    for name, kw in (("cache off", dict(prefix_cache=False)),
                     ("defaults", {}),
                     ("pressure", dict(n_pages=PRESSURE_PAGES))):
        loop = main_loop(params, cfg, **kw)
        margins = _serve_margins(loop) if name == "cache off" else None
        for r in _shared_requests(cfg.vocab, SEED + 2):
            loop.submit(r)
        t = time.perf_counter()
        done = {r.rid: r.output.tolist() for r in loop.run()}
        wall = time.perf_counter() - t
        assert sorted(done) == list(range(len(SUFFIXES))), sorted(done)
        assert all(len(o) == MAX_NEW for o in done.values())
        loop.check_compiled()
        loop.pages.check()
        kept = loop.prefix.n_nodes if loop.prefix is not None else 0
        assert loop.pages.in_use == kept, (loop.pages.in_use, kept)
        if loop.prefix is not None:
            loop.prefix.check()
            loop.prefix.evict(10**6)
        assert loop.pages.in_use == 0, "pages leaked"
        st = loop.sched_stats()
        runs[name] = dict(done=done, saved=loop.prefill_tokens_saved,
                          run=loop.prefill_tokens_run,
                          hits=loop.prefix.hit_blocks if loop.prefix else 0,
                          cow=loop.cow_copies, st=st, wall=wall,
                          margins={rid: margins(rid) for rid in done}
                          if margins else None)
        log(f"  {name}: {len(done)} requests in {wall:.2f} s; prefill "
            f"tokens run {loop.prefill_tokens_run}, saved "
            f"{loop.prefill_tokens_saved}; prefix hit blocks "
            f"{runs[name]['hits']}, CoW copies {loop.cow_copies}; "
            f"preemptions {st['preemptions']}, resumes {st['resumes']} "
            f"({st['resume_prefill_tokens']} tokens replayed), grown pages "
            f"{st['grown_pages']}, peak live slots {st['peak_live_slots']}, "
            f"pool peak {st['pool_pages_peak']} of {loop.spec.n_pages - 1}")
        del loop
        gc.collect()          # the loop and its graphs form a cycle
        if DEV == "cuda":
            torch.cuda.empty_cache()
    off, on, pr = runs["cache off"], runs["defaults"], runs["pressure"]
    assert on["hits"] > 0 and on["saved"] > 0, on
    assert pr["st"]["preemptions"] >= 1, pr["st"]
    compared = 0
    for rid, toks in off["done"].items():
        for t_off, t_on, ok in zip(toks, on["done"][rid],
                                   off["margins"][rid]):
            if not ok:
                break                        # a near tie: later tokens follow it
            if t_off != t_on:
                raise AssertionError(f"request {rid}: cache-on token differs "
                                     "where the cache-off margin is clear")
            compared += 1
    n_tok = len(SUFFIXES) * MAX_NEW
    same = sum(a == b for rid in on["done"]
               for a, b in zip(on["done"][rid], off["done"][rid]))
    pressed = sum(a == b for rid in on["done"]
                  for a, b in zip(on["done"][rid], pr["done"][rid]))
    log(f"  shared prefix: {on['saved']} of {on['saved'] + on['run']} "
        f"prefill tokens saved by the cache; {compared} tokens with a clear "
        f"top-2 margin equal to the cache-off run ({same} of {n_tok} equal "
        f"in all)")
    log(f"  pool pressure ({PRESSURE_PAGES - 1} usable pages): "
        f"{pr['st']['preemptions']} preemptions, {pr['st']['resumes']} "
        f"resumes; {pressed} of {n_tok} tokens ({pressed / n_tok:.1%}) equal "
        "to the unpressured run")
    return runs


# ---------------------------------------------------------------------------
# speculation at full width: n-gram and replay drafters, the verify graph
# ---------------------------------------------------------------------------

SPEC_K = 4                  # drafts per slot: a [4, 5] verify window
SPAN = 48                   # repeated span of the speculative prompts
CORRUPTIONS = (0.0, 0.4, 1.0)


def _spec_requests(vocab, seed):
    """Six requests of the main path's prompt lengths and 32 new tokens;
    requests 1, 3 and 5 end with a 48-token span copied from their own
    first tokens, so the n-gram drafter finds matches in the prompt."""
    import numpy as np

    from repro_torch.serve.loop import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(PROMPT_LENS):
        p = rng.integers(0, vocab, n).astype(np.int32)
        if i % 2:
            p[n - SPAN:] = p[:SPAN]
        reqs.append(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    return reqs


def _replay_drafter(streams, corrupt_p, vocab, seed=0):
    """``tests/test_spec_decode.py::ReplayDrafter``: replays each request's
    known continuation, corrupting every proposed token with probability
    ``corrupt_p`` (0: every draft right, 1: every window rejected at its
    first row)."""
    import numpy as np

    from repro_torch.serve.spec import Drafter

    class ReplayDrafter(Drafter):
        def __init__(self):
            self.streams = [np.asarray(s, np.int64) for s in streams]
            self.rng = np.random.default_rng(seed)

        def propose(self, context, k):
            ctx = np.asarray(context, np.int64)
            for s in self.streams:
                if len(s) >= len(ctx) and np.array_equal(s[: len(ctx)], ctx):
                    d = s[len(ctx): len(ctx) + k].astype(np.int32)
                    flip = self.rng.random(len(d)) < corrupt_p
                    return np.where(flip, (d + 1) % vocab, d)
            return np.zeros(0, np.int32)

    return ReplayDrafter()


def _capture_forwards(loop):
    """Capture every forward of ``loop`` before a counted run: one call
    each on all-zero inputs (block tables of page 0, n_writes 0), whose
    writes all land in the scratch page.  Then every launch of the run is
    a replay's (the counters are reset after this)."""
    import numpy as np

    B, MB = loop.B, loop.spec.max_blocks
    z = lambda *shape: np.zeros(shape, np.int32)        # noqa: E731
    loop._prefill_chunk(z(1, loop.chunk), 0, z(MB), 0)
    loop._decode(z(B, 1), z(B), z(B, MB))
    if "verify" in loop.forwards:
        loop._verify(z(B, loop.spec_k + 1), z(B), z(B), z(B, MB))
    if DEV == "cuda":
        import torch

        torch.cuda.synchronize()


def _reset_launches(loop):
    from repro_torch.serve.paged import _COUNTED

    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
    for f in loop.forwards.values():
        f.eager = f.replays = 0


def _read_launches(loop):
    """Launches since ``_reset_launches``: eager ones plus the launches
    recorded at capture x replays, of every kernel a loop's graph counts
    (``serve.paged._COUNTED``); and the forwards that ran."""
    from repro_torch.serve.paged import _COUNTED

    counts = {k: getattr(mod, attr) for k, (mod, attr) in _COUNTED.items()}
    for f in loop.forwards.values():
        for k, n in f.graph_launches.items():
            counts[k] += n * f.replays
    return counts, sum(f.eager + f.replays for f in loop.forwards.values())


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def _step_times(loop, names, profiled=None):
    """Wrap the loop's forwards ``names``: per call, host ms around a
    synchronised call and the device span (ms between CUDA events around
    it); every call's logits must be finite.  Call ``PROFILED_STEP`` of
    the forward ``profiled`` runs under torch.profiler instead and is kept
    out of the timings.  Returns ``{name: {"ms", "span", "calls"}}``."""
    import torch

    steps = {n: {"ms": [], "span": [], "calls": 0} for n in names}

    def timed(name, fn):
        rec = steps[name]

        def wrapper(*a):
            if name == profiled and rec["calls"] == PROFILED_STEP:
                out = _profiled(fn, a, {})
            elif DEV != "cuda":       # a rehearsal: host time only
                t = time.perf_counter()
                out = fn(*a)
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["span"].append(rec["ms"][-1])
            else:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                t = time.perf_counter()
                ev[0].record()
                out = fn(*a)
                ev[1].record()
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["span"].append(ev[0].elapsed_time(ev[1]))
            rec["calls"] += 1
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"non-finite logits in a {name} forward")
            return out
        return wrapper

    for n in names:
        setattr(loop, n, timed(n, getattr(loop, n)))
    return steps


def verify_parity(loop, cfg):
    """On a speculative loop (decode pinned to the gathered reader): one
    verify replay equals the eager verify forward bit for bit; then the
    same window run as sequential decode replays against one verify
    replay, on the same cache state: verify row j must equal decode step
    j bit for bit, the reference's contract.  Then the attention alone of
    one layer at these shapes (graph replay): the verify window's gather
    + masked softmax and the gathered decode reader's.  Returns the two
    attention times (ms a step over every layer)."""
    import numpy as np
    import torch

    from repro_torch.kernels import paged as pk
    from repro_torch.models import attention as at

    rng = np.random.default_rng(SEED + 3)
    B, MB, K1 = loop.B, loop.spec.max_blocks, loop.spec_k + 1
    bt = (np.arange(B * MB, dtype=np.int32).reshape(B, MB) + 1) \
        % (loop.spec.n_pages - 1) + 1
    pos = np.array([200, 37, 511, 0][:B], np.int32)
    toks = rng.integers(0, cfg.vocab, (B, K1)).astype(np.int32)
    n_writes = np.array([K1, 3, K1, 0][:B], np.int32)
    got = loop._verify(toks, pos, n_writes, bt).clone()
    want = loop._verify_fn(*[torch.as_tensor(x, device=DEV)
                             for x in (toks, pos, n_writes, bt)])
    if not torch.equal(got, want):
        raise AssertionError(
            "verify graph replay differs from eager by "
            f"{(got.float() - want.float()).abs().max().item()}")
    seq = []
    for j in range(K1):
        seq.append(loop._decode(toks[:, j: j + 1], pos + j, bt).clone())
    win = loop._verify(toks, pos, np.full(B, K1, np.int32), bt).clone()
    diff = max((win[:, j].float() - seq[j].float()).abs().max().item()
               for j in range(K1))
    if diff != 0:
        raise AssertionError("verify rows differ from sequential decode steps"
                             f" by max |dlogit| {diff}")
    log(f"  verify graph replay == eager, bit for bit ([{B}, {K1}] window, "
        f"n_writes {n_writes.tolist()}); verify row j == decode step j bit "
        "for bit (lax reader, graph replays, same cache state)")
    if DEV != "cuda":
        return float("nan"), float("nan")
    qs = pk.qspec_for(cfg)
    pool = {n: leaf[0] for n, leaf in loop.caches[0]["b0"].items()}
    q = torch.randn((B, K1, cfg.n_heads, cfg.kv_head_dim), device=DEV,
                    dtype=torch.bfloat16)
    bt_d, pos_d = torch.as_tensor(bt, device=DEV), torch.as_tensor(
        pos, device=DEV)

    def verify_attention():         # gqa_verify_paged after its K/V write
        kc, vc = pk.gather_kv_deq(pool, bt_d, qs)
        iq = pos_d[:, None, None] + torch.arange(K1, device=DEV)[None, :,
                                                                 None]
        mask = torch.arange(kc.shape[1], device=DEV)[None, None, :] <= iq
        return at._sdpa(q, kc, vc, mask[:, None, None], cfg)

    t_v = graph_ms(verify_attention, iters=8)
    t_d = graph_ms(lambda: pk._attend_lax(q[:, :1], pool, bt_d, pos_d, None,
                                          qs), iters=8)
    log(f"  attention alone, one layer (graph replay): verify window "
        f"{t_v:.4f} ms, gathered decode reader {t_d:.4f} ms; x "
        f"{cfg.n_layers} layers: {t_v * cfg.n_layers:.2f} / "
        f"{t_d * cfg.n_layers:.2f} ms a step")
    return t_v * cfg.n_layers, t_d * cfg.n_layers


def phase_serve_spec(cfg, params):
    """Speculation on the main path's model and loop: the six-request set
    (three prompts repeat a span) served with speculation off and the
    gathered decode reader (the baseline, tokens T), then with spec_k 4
    and a replay drafter over T at corruption 0, 0.4 and 1.0, then with
    the n-gram drafter.  Per run: every token equal to T (verify rows are
    bit-equal to decode steps, ``verify_parity``), accept rate and tokens
    per slot-step, decode and verify step medians, the forward set, and
    the run's own launches: kernel 1 7 x layers x forwards, flash-decode
    none."""
    import numpy as np
    import torch

    reqs = lambda: _spec_requests(cfg.vocab, SEED + 4)     # noqa: E731
    loop = main_loop(params, cfg, spec_k=SPEC_K,
                     drafter=_replay_drafter([], 0.0, cfg.vocab))
    attn_v, attn_d = verify_parity(loop, cfg)
    del loop
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    want = None
    runs = [("spec off, lax", dict(attn_impl="lax"))]
    runs += [(f"replay p={p}", dict(spec_k=SPEC_K, corrupt=p))
             for p in CORRUPTIONS]
    runs.append(("n-gram", dict(spec_k=SPEC_K, drafter="ngram")))
    for name, kw in runs:
        if "corrupt" in kw:
            streams = [np.concatenate([r.prompt, want[r.rid]])
                       for r in reqs()]
            kw = dict(spec_k=SPEC_K, drafter=_replay_drafter(
                streams, kw.pop("corrupt"), cfg.vocab, seed=SEED))
        loop = main_loop(params, cfg, **kw)
        _capture_forwards(loop)
        steps = _step_times(loop, ("_decode", "_verify"))
        for r in reqs():
            loop.submit(r)
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_launches(loop)
        t = time.perf_counter()
        done = {r.rid: r.output.tolist() for r in loop.run()}
        wall = time.perf_counter() - t
        counts, n_fwd = _read_launches(loop)
        assert sorted(done) == list(range(len(PROMPT_LENS))), sorted(done)
        assert all(len(o) == MAX_NEW for o in done.values())
        loop.check_compiled()
        shapes = loop.compiled_shapes()
        assert shapes == ({"chunk": 1, "decode": 1, "verify": 1}
                          if loop.drafter is not None
                          else {"chunk": 1, "decode": 1}), shapes
        if DEV == "cuda":
            # captured before the reset: every forward of the run a replay
            assert n_fwd == sum(f.replays for f in loop.forwards.values())
            want_k1 = 7 * cfg.n_layers * n_fwd
            assert counts["tlmac_gemm_fused"] == want_k1, (counts, want_k1)
            assert counts["flash_decode"] == 0, counts
        loop.pages.check()
        st = loop.spec_stats()
        if want is None:
            want = done
            cmp = "baseline T"
        elif done != want:
            raise AssertionError(f"{name}: tokens differ from T")
        else:
            cmp = f"all {len(PROMPT_LENS) * MAX_NEW} tokens equal to T"
        dec = [_median(steps["_decode"][k]) for k in ("ms", "span")]
        ver = [_median(steps["_verify"][k]) for k in ("ms", "span")]
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if DEV == "cuda" else float("nan"))
        log(f"  {name}: {wall:.2f} s; {cmp}; accept rate "
            f"{st['accept_rate']:.3f} ({st['accepted']} of {st['proposed']}),"
            f" tokens per slot-step {st['tokens_per_step']:.3f}; "
            f"{st['decode_steps']} decode steps median {dec[0]:.2f} ms "
            f"(device span {dec[1]:.2f}), {st['spec_steps']} verify steps "
            f"median {ver[0]:.2f} ms (device span {ver[1]:.2f}); compiled "
            f"{shapes}; this run's launches: lookup GEMM "
            f"{counts['tlmac_gemm_fused']} (= 7 x {cfg.n_layers} x {n_fwd} "
            f"forwards), flash-decode {counts['flash_decode']}; "
            f"max_memory_allocated {peak:.3f} GiB")
        if name == "replay p=1.0":          # every slot-step a full window
            log(f"  attention share of the step (attention alone x layers "
                f"over the device span): verify {attn_v / ver[1]:.1%} of "
                f"{ver[1]:.2f} ms, decode {attn_d / dec[1]:.1%} of "
                f"{dec[1]:.2f} ms")
        del loop
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()


def _timed_steps(loop):
    """Wrap ``loop.step``: host ms of every whole step (admission, the
    forward and its synchronising argmax read, acceptance, and with
    telemetry on every event, histogram, gauge and profiler range)."""
    ms = []
    step = loop.step

    def wrapper():
        t = time.perf_counter()
        more = step()
        ms.append((time.perf_counter() - t) * 1e3)
        return more
    loop.step = wrapper
    return ms


def phase_telemetry(cfg, params, main_run):
    """The main path's six requests with telemetry off and on, in turns
    (off, on, on, off): every run's tokens equal the main path's and its
    forward set is the two graphs; the traced runs' lifecycle validates;
    the phase histograms, TTFT and queue waits of the first traced run
    are printed, with each run's median whole step and wall time, which
    is what telemetry costs; its Chrome trace is exported to a temporary
    directory and counted."""
    import tempfile

    from repro_torch.serve.telemetry import validate_lifecycle

    cost = {True: [], False: []}
    traced = None
    for tel in (False, True, True, False):
        loop = main_loop(params, cfg, telemetry=tel)
        _capture_forwards(loop)
        ms = _timed_steps(loop)
        for r in _requests(cfg.vocab, PROMPT_LENS, MAX_NEW, SEED):
            loop.submit(r)
        t = time.perf_counter()
        done = {r.rid: r.output.tolist() for r in loop.run()}
        cost[tel].append((_median(ms), time.perf_counter() - t, len(ms)))
        if done != main_run["outputs"]:
            raise AssertionError(f"telemetry={tel} changed the tokens")
        loop.check_compiled()
        assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
        if tel:
            seqs = validate_lifecycle(loop.tel.tracer.events)
            assert len(seqs) == len(PROMPT_LENS), seqs
            if traced is None:
                traced = dict(hist=loop.metrics()["telemetry"]["histograms"],
                              st=loop.sched_stats())
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "trace.json")
                    traced["events"] = loop.export_trace(path)["events"]
                    traced["bytes"] = os.path.getsize(path)
        del loop
        gc.collect()

    def q(name):
        h = traced["hist"][name]
        return (f"{name} p50 {h['p50'] * 1e3:.2f} ms p99 "
                f"{h['p99'] * 1e3:.2f} ms (n {h['count']})")
    log(f"  telemetry on: tokens equal to the main path's, compiled "
        "{'chunk': 1, 'decode': 1}, lifecycle valid for "
        f"{len(PROMPT_LENS)} requests; {q('phase.prefill_chunk_s')}; "
        f"{q('phase.decode_s')}; {q('phase.reserve_s')}")
    for key in ("ttft_s", "queue_wait_s"):
        s = traced["st"][key]
        log(f"  {key}: n {s['count']}, p50 {s['p50'] * 1e3:.1f} ms, p99 "
            f"{s['p99'] * 1e3:.1f} ms, max {s['max'] * 1e3:.1f} ms")
    fmt = lambda runs: ", ".join(                            # noqa: E731
        f"{m:.3f} ms ({n} steps, run {w:.3f} s)" for m, w, n in runs)
    log(f"  decode step median as whole step() calls (admission, forward, "
        f"argmax read, acceptance, telemetry), host clock, runs in turns "
        f"off/on/on/off: "
        f"off {fmt(cost[False])}; on {fmt(cost[True])} (main path decode "
        f"step {main_run['decode_ms']:.2f} ms); Chrome trace "
        f"{traced['events']} events, {traced['bytes']} bytes (temporary "
        "directory)")


# ---------------------------------------------------------------------------
# swap tier, faults, cancellation, deadlines and tenants at full width
# ---------------------------------------------------------------------------

ROUNDTRIP_REPS = 5          # timed round trips per pool dtype
# the main path's six prompts with 96 new tokens each, in a pool that
# on-demand growth exhausts twice (at 32 new tokens growth is 1-2 pages a
# request, and no pool size preempts more than once): admitting the first
# four takes 4 + 8 + 16 + 20 = 48 pages, their growth to 96 tokens 11 more
SWAP_MAX_NEW = 96
SWAP_POOL_PAGES = 62        # 61 usable
CHAOS_RATES = {"alloc": 0.15, "swap_put": 0.25, "swap_corrupt": 0.5,
               "admit_stall": 0.1, "cancel": 0.04}   # tests/test_faults.py
FAULT_SEED = 7              # (i): two cancels, four stalls
CHAOS_SEED = 8              # (ii): preempts, restores and drops torn pages
DEADLINE_S = 600.0          # generous: the fault runs take seconds


def _page_host(caches, p):
    """Page ``p`` of every pool leaf, read to the host leaf by leaf (not
    through the ring), as a host page."""
    from repro_torch.serve.faults import tree_map
    from repro_torch.serve.swap import host_array

    return tree_map(lambda leaf: host_array(leaf[:, p].cpu()), caches)


def _same_bytes(a, b) -> bool:
    import torch

    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def phase_swap_roundtrip(cfg):
    """The full-width pool in fp, int8 and int4 with seeded contents:
    one ring transaction of pages (``serve_swap_ring_pages``, 8) out
    through the staging ring (gather, pinned copy,
    event) and split per page as the loop does, then scattered in place
    into other page ids (``stage_to_device``: stacked into pinned buffers
    on the host, copied; ``cache_swap_in``).  Every page's bytes and
    CRC-32 must equal its source's, taken leaf by leaf before the move.
    Prints GB/s each way (host clock around synchronised work, median of
    ``ROUNDTRIP_REPS`` after one untimed round), the host-to-device time
    split into the host stack and the copy with the scatter, and the CRC
    ms per page."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.paged import spec_for
    from repro_torch.models import lm
    from repro_torch.serve.faults import tree_leaves, tree_map
    from repro_torch.serve.swap import (StagingRing, page_checksum,
                                        stage_to_device)

    dev = torch.device(DEV)
    sync = (lambda: torch.cuda.synchronize()) if DEV == "cuda" \
        else (lambda: None)
    width = cfg.serve_swap_ring_pages
    src = list(range(1, width + 1))
    dst = list(range(width + 1, 2 * width + 1))
    for kv in ("fp", "int8", "int4"):
        kcfg = dataclasses.replace(cfg, serve_kv_dtype=kv)
        spec = spec_for(1024, 4, page_size=16, n_pages=2 * width + 1)
        caches = lm.init_caches(kcfg, spec, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
        for leaf in tree_leaves(caches):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-128, 128, leaf.shape, device=DEV,
                                         generator=gen, dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, device=DEV,
                                       generator=gen).to(leaf.dtype))
        ptrs = [leaf.data_ptr() for leaf in tree_leaves(caches)]
        before = [page_checksum(_page_host(caches, p)) for p in src]
        page_bytes = sum(a.nbytes for a in tree_leaves(_page_host(caches, 1)))
        nbytes = page_bytes * width
        d2h, h2d, stack, crc = [], [], [], []
        src_t = torch.tensor(src, device=dev)
        dst_t = torch.tensor(dst, device=dev)
        for rep in range(ROUNDTRIP_REPS + 1):     # round 0: pinned warm-up
            ring = StagingRing(width=width)
            sync()
            t = time.perf_counter()
            ring.stage(0, lm.cache_swap_out(caches, src_t))
            ((_, host),) = ring.drain()
            t_out = time.perf_counter() - t
            pages = [tree_map(lambda a: a[:, j].copy(), host)
                     for j in range(width)]
            del host
            t = time.perf_counter()
            sums = [page_checksum(pg) for pg in pages]
            t_crc = (time.perf_counter() - t) / width
            if sums != before:
                raise AssertionError(f"{kv}: a page's CRC changed on the "
                                     "way out")
            # the host half of stage_to_device alone, as it stacks
            t = time.perf_counter()
            for xs in zip(*[tree_leaves(pg) for pg in pages]):
                np.stack(xs, axis=1)
            t_stack = time.perf_counter() - t
            sync()
            t = time.perf_counter()
            staged = tree_map(lambda *xs: stage_to_device(xs, dev), *pages)
            lm.cache_swap_in(caches, staged, dst_t)
            sync()
            t_in = time.perf_counter() - t
            del staged, pages
            if rep:
                d2h.append(t_out)
                crc.append(t_crc)
                stack.append(t_stack)
                h2d.append(t_in)
        assert ptrs == [leaf.data_ptr() for leaf in tree_leaves(caches)], \
            "cache_swap_in moved a pool leaf"
        for leaf in tree_leaves(caches):
            if not _same_bytes(leaf[:, dst], leaf[:, src]):
                raise AssertionError(f"{kv}: restored pages differ")
        after = [page_checksum(_page_host(caches, p)) for p in dst]
        if after != before:
            raise AssertionError(f"{kv}: restored pages' CRC differs")
        med = lambda xs: float(np.median(xs))          # noqa: E731
        log(f"  {kv} pool: page {page_bytes / 2**20:.3f} MiB ({cfg.n_layers}"
            f" layers, {len(tree_leaves(caches))} leaves); {width} pages "
            f"({nbytes / 2**20:.1f} MiB) out and back, bytes and CRC-32 of "
            f"every page equal to its source's; device-to-host (gather, "
            f"pinned copy, event) {nbytes / med(d2h) / 1e9:.2f} GB/s "
            f"({med(d2h) * 1e3:.2f} ms), host-to-device (stack into pinned, "
            f"copy, scatter) {nbytes / med(h2d) / 1e9:.2f} GB/s "
            f"({med(h2d) * 1e3:.2f} ms; a numpy stack of the same pages "
            f"alone {med(stack) * 1e3:.2f} ms), CRC-32 "
            f"{med(crc) * 1e3:.2f} ms a page ({page_bytes / med(crc) / 1e9:.2f}"
            f" GB/s); medians of {ROUNDTRIP_REPS}")
        del caches
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()


def _swap_timers(loop):
    """Wrap the loop's swap work: seconds in ``_swap_out`` (of which the
    ring's ``stage`` and ``drain``: gathers, pinned copies and the waits
    for them; and ``SwapStore.put``, of which the CRC; the rest is the
    per-page host copies), in ``SwapStore.match`` (of which the CRC) and
    in ``_swap_restore``.  Returns the accumulators and an undo for the
    module-level checksum hook."""
    from repro_torch.serve import swap as swap_mod

    acc = dict(out_s=0.0, ring_s=0.0, put_s=0.0, put_crc_s=0.0, put_crc_n=0,
               match_s=0.0, match_crc_s=0.0, match_crc_n=0, restore_s=0.0,
               matches=0)
    where = []
    crc = swap_mod.page_checksum

    def timed_crc(data):
        t = time.perf_counter()
        c = crc(data)
        if where:
            acc[where[-1] + "_crc_s"] += time.perf_counter() - t
            acc[where[-1] + "_crc_n"] += 1
        return c

    def timed(key, fn, ctx=None):
        def wrapper(*a, **kw):
            if ctx:
                where.append(ctx)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t
                if ctx:
                    where.pop()
        return wrapper

    swap_mod.page_checksum = timed_crc
    loop._swap_out = timed("out_s", loop._swap_out)
    loop._swap_restore = timed("restore_s", loop._swap_restore)
    ring = loop.swap_ring
    ring.stage = timed("ring_s", ring.stage)
    ring.drain = timed("ring_s", ring.drain)
    loop.swap.put = timed("put_s", loop.swap.put, "put")
    match = timed("match_s", loop.swap.match, "match")

    def counted_match(*a, **kw):
        acc["matches"] += 1
        return match(*a, **kw)
    loop.swap.match = counted_match

    def undo():
        swap_mod.page_checksum = crc
    return acc, undo


def _drained(loop):
    """After a run: every structure checks, and once the prefix cache is
    evicted no pool page is held; the host store's ledgers are exact."""
    loop.check_compiled()
    loop.pages.check()
    loop.sched.check()
    if loop.prefix is not None:
        loop.prefix.check()
        loop.prefix.evict(10**6)
    assert loop.pages.in_use == 0, f"{loop.pages.in_use} pool pages leaked"
    if loop.swap is not None:
        loop.swap.check()


def phase_serve_swap(cfg, params, main_run):
    """The main path's six prompts, ``SWAP_MAX_NEW`` new tokens each, in a
    ``SWAP_POOL_PAGES`` pool, where on-demand growth preempts at least
    twice: with ``swap_policy='never'`` (recompute,
    the baseline), ``'always'`` and ``'auto'`` on the fp pool and
    ``'always'`` on int8.  Every run: every request finishes, the forward
    set is the two graphs, no page leaks, the store's ledgers hold, and
    kernels 1-2 launch 7 x layers x forwards and layers x decode steps
    (counters set to 0 just before the run).  The 'always' runs restore
    pages and replay fewer tokens than 'never'.  Prints preemptions, the
    policy's choices and rates, pages and bytes each way, restored against
    replayed tokens, the swap timings (swap-out: gather, pinned copy and
    put with its CRC; the CRC at every match; restore: pinned copy,
    scatter, synchronise), wall time and the share of tokens equal to the
    unpressured main path (not bit-exact: the partial tail page is
    recomputed through the chunk's attention; the first ``MAX_NEW`` tokens
    of each request are compared)."""
    import dataclasses

    import torch

    usable = SWAP_POOL_PAGES - 1
    blocks = [-(-(-(-n // CHUNK) * CHUNK) // 16) for n in PROMPT_LENS]
    grown = [-(-(n + SWAP_MAX_NEW - 1) // 16) for n in PROMPT_LENS]
    log(f"  pool {SWAP_POOL_PAGES} pages ({usable} usable): prefill pages "
        f"{blocks} (first four {sum(blocks[:4])}), final pages {grown} "
        f"(first four {sum(grown[:4])}) at {SWAP_MAX_NEW} new tokens: growth"
        " must preempt")
    n_tok = len(PROMPT_LENS) * MAX_NEW
    runs = {}
    for name, kv, policy in (("never", "fp", "never"),
                             ("always", "fp", "always"),
                             ("auto", "fp", "auto"),
                             ("always int8", "int8", "always")):
        loop = main_loop(params, dataclasses.replace(cfg, serve_kv_dtype=kv),
                         n_pages=SWAP_POOL_PAGES, swap=True,
                         swap_policy=policy)
        _capture_forwards(loop)
        acc, undo = _swap_timers(loop)
        for r in _requests(cfg.vocab, PROMPT_LENS, SWAP_MAX_NEW, SEED):
            loop.submit(r)
        _reset_launches(loop)
        t = time.perf_counter()
        try:
            done = {r.rid: r.output.tolist() for r in loop.run()}
        finally:
            undo()
        wall = time.perf_counter() - t
        counts, n_fwd = _read_launches(loop)
        assert sorted(done) == list(range(len(PROMPT_LENS))), sorted(done)
        assert all(len(o) == SWAP_MAX_NEW for o in done.values())
        assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}, \
            loop.compiled_shapes()
        if DEV == "cuda":
            n_dec = loop.forwards["decode"].replays
            assert n_fwd == sum(f.replays for f in loop.forwards.values())
            assert counts["tlmac_gemm_fused"] == 7 * cfg.n_layers * n_fwd, \
                counts
            assert counts["flash_decode"] == cfg.n_layers * n_dec, counts
        st, sw = loop.sched_stats(), loop.swap_stats()
        _drained(loop)
        # 'auto' may recompute a victim, which changes the later paging
        assert st["preemptions"] >= (1 if policy == "auto" else 2), \
            st["preemptions"]
        same = sum(a == b for rid, o in done.items()
                   for a, b in zip(o, main_run["outputs"][rid]))
        runs[name] = dict(st=st, sw=sw, wall=wall)
        pol = sw["policy"]
        log(f"  {name} ({kv}): {wall:.2f} s; preemptions {st['preemptions']}"
            f", policy chose swap {pol['chose_swap']} / recompute "
            f"{pol['chose_recompute']} (prefill "
            f"{pol['prefill_tok_per_s']:.0f} tok/s, copy "
            f"{pol['copy_bytes_per_s'] / 1e9:.3f} GB/s measured); pages out "
            f"{sw['swapped_out_pages']} ({sw['swap_out_bytes'] / 2**20:.1f} "
            f"MiB), in {sw['swapped_in_pages']} "
            f"({sw['swap_in_bytes'] / 2**20:.1f} MiB), page "
            f"{sw['page_bytes'] / 2**20:.3f} MiB; tokens restored "
            f"{sw['restored_tokens']}, replayed {st['resume_prefill_tokens']}"
            f" in {st['resumes']} resumes; store {sw['store']['pages']} pages"
            f" {sw['store']['bytes'] / 2**20:.1f} MiB at the end, "
            f"{sw['store']['hit_blocks']} hit blocks in {acc['matches']} "
            f"matches; {same} of {n_tok} tokens ({same / n_tok:.1%}) equal to"
            f" the unpressured main path; launches: lookup GEMM "
            f"{counts['tlmac_gemm_fused']} (7 x {cfg.n_layers} x {n_fwd}), "
            f"flash-decode {counts['flash_decode']}")
        ms = lambda s, n=1: f"{s * 1e3 / max(n, 1):.2f} ms"   # noqa: E731
        log(f"    swap timings (host clock): swap-out {ms(acc['out_s'])} in "
            f"all, of which the ring (gathers, pinned copies, waits) "
            f"{ms(acc['ring_s'])}, put {ms(acc['put_s'])} (CRC "
            f"{ms(acc['put_crc_s'])} over {acc['put_crc_n']} pages, "
            f"{ms(acc['put_crc_s'], acc['put_crc_n'])} a page) and the "
            f"per-page host copies "
            f"{ms(acc['out_s'] - acc['ring_s'] - acc['put_s'])}; "
            f"matches {ms(acc['match_s'])} (CRC {ms(acc['match_crc_s'])} "
            f"over {acc['match_crc_n']} pages); restore "
            f"{ms(acc['restore_s'])} ({sw['swap_in_bytes'] / max(acc['restore_s'], 1e-9) / 1e9:.2f} GB/s)")
        del loop
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    never, always = runs["never"]["st"], runs["always"]["st"]
    for name in ("always", "always int8"):
        sw, st = runs[name]["sw"], runs[name]["st"]
        assert sw["swapped_in_pages"] > 0 and sw["restored_tokens"] > 0, sw
        assert st["resume_prefill_tokens"] < never["resume_prefill_tokens"], \
            (name, st["resume_prefill_tokens"],
             never["resume_prefill_tokens"])
    log(f"  replayed tokens: never {never['resume_prefill_tokens']}, always "
        f"{always['resume_prefill_tokens']} (restored "
        f"{runs['always']['sw']['restored_tokens']})")
    return runs


def _tenant_requests(vocab, max_new=MAX_NEW):
    reqs = _requests(vocab, PROMPT_LENS, max_new, SEED)
    for r in reqs:
        r.tenant = "a" if r.rid % 2 == 0 else "b"
        r.deadline_s = DEADLINE_S
    return reqs


def phase_faults(cfg, params):
    """Seeded faults on the main path's six requests, tenants a and b and
    a generous deadline: (i) cancels and admission stalls, swap off,
    against a fault-free run: every finished request's tokens and every
    cancelled request's partial output equal the fault-free run's
    exactly (stronger than the top-2 margin rule of
    ``phase_serve_features``, which at full width clears almost no
    token: a stall moves a request to other batch-mates and other steps,
    and no kernel of the decode step mixes slots); (ii) the reference's chaos rates
    with every site armed, swap 'always', the swap phase's traffic and
    ``SWAP_POOL_PAGES`` pool, and tenant page and swap-byte quotas in full-width pages (every
    request done or failed with a typed error, no page or host byte
    leaked, the lifecycle valid, the forward set the two graphs).  Then
    the door: a spent deadline and a tenant's queue limit raise their
    typed errors."""
    import torch

    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.loop import Request
    from repro_torch.serve.scheduler import (CancelledError,
                                             DeadlineExceededError,
                                             QuotaExceededError)
    from repro_torch.serve.telemetry import validate_lifecycle

    def free():
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()

    base = main_loop(params, cfg)
    margins = _serve_margins(base)
    for r in _tenant_requests(cfg.vocab):
        base.submit(r)
    want = {r.rid: r.output.tolist() for r in base.run()}
    clear = {rid: margins(rid) for rid in want}
    _drained(base)
    del base
    free()

    def agree(rid, got):
        """``got`` must be a prefix of the fault-free run's tokens;
        returns how many of them clear the top-2 margin."""
        if got != want[rid][:len(got)]:
            raise AssertionError(f"request {rid}: tokens differ from the "
                                 "fault-free run")
        return sum(clear[rid][:len(got)])

    plan = FaultPlan(seed=FAULT_SEED, rates={"cancel": 0.05,
                                             "admit_stall": 0.2})
    loop = main_loop(params, cfg, faults=plan, telemetry=True)
    for r in _tenant_requests(cfg.vocab):
        loop.submit(r)
    t = time.perf_counter()
    loop.run()
    wall = time.perf_counter() - t
    fired = loop.faults.stats()["fired"]
    assert fired["cancel"] + fired["admit_stall"] > 0, fired
    compared = 0
    for r in loop.done:
        assert r.error is None and len(r.output) == MAX_NEW
        compared += agree(r.rid, r.output.tolist())
    for r in loop.failed:
        assert r.finish_reason == "cancelled" and \
            isinstance(r.error, CancelledError), (r.rid, r.error)
        assert len(r.output) <= MAX_NEW
        compared += agree(r.rid, r.output.tolist())
    assert len(loop.done) + len(loop.failed) == len(PROMPT_LENS)
    validate_lifecycle(loop.tel.tracer.events)
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    _drained(loop)
    log(f"  (i) cancel + admit_stall, seed {FAULT_SEED}, swap off: {wall:.2f}"
        f" s; fired {fired}; done {sorted(r.rid for r in loop.done)}, "
        f"cancelled {sorted((r.rid, len(r.output)) for r in loop.failed)} "
        f"(rid, tokens kept); every token equal to the fault-free run's "
        f"({compared} of them with a clear top-2 margin); tenants "
        f"{loop.tenant_stats()['tenants']}")
    del loop
    free()

    # one fp page: K and V, bf16, every layer
    page = 2 * 2 * cfg.n_layers * 16 * cfg.n_kv * cfg.kv_head_dim
    quota, swap_budget = 30, 24 * page
    loop = main_loop(params, cfg, n_pages=SWAP_POOL_PAGES, swap=True,
                     swap_policy="always", telemetry=True,
                     faults=FaultPlan(seed=CHAOS_SEED, rates=CHAOS_RATES),
                     tenant_page_quota=quota, tenant_swap_bytes=swap_budget)
    for r in _tenant_requests(cfg.vocab, SWAP_MAX_NEW):
        loop.submit(r)
    t = time.perf_counter()
    loop.run()
    wall = time.perf_counter() - t
    for r in loop.done:
        assert r.error is None and r.finish_reason in ("stop", "length")
    for r in loop.failed:
        assert (r.finish_reason, type(r.error)) in (
            ("cancelled", CancelledError),
            ("deadline", DeadlineExceededError)), (r.rid, r.error)
    assert len(loop.done) + len(loop.failed) == len(PROMPT_LENS)
    assert not {r.rid for r in loop.done} & {r.rid for r in loop.failed}
    validate_lifecycle(loop.tel.tracer.events)
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    fs, sw = loop.faults.stats(), loop.swap_stats()
    assert sum(fs["fired"].values()) > 0, fs
    assert sw["store"]["corrupt_dropped"] <= fs["fired"]["swap_corrupt"]
    ts = loop.tenant_stats()
    _drained(loop)
    log(f"  (ii) chaos {CHAOS_RATES}, seed {CHAOS_SEED}, swap always, "
        f"{SWAP_POOL_PAGES}-page pool, tenant page quota {quota}, tenant "
        f"swap budget {swap_budget / 2**20:.0f} MiB (24 pages): {wall:.2f} "
        f"s; fired {fs['fired']} of armed {fs['armed']}; done "
        f"{sorted(r.rid for r in loop.done)}, failed "
        f"{sorted((r.rid, r.finish_reason) for r in loop.failed)}; "
        f"preemptions {loop.preemptions}, pages out "
        f"{sw['swapped_out_pages']}, in {sw['swapped_in_pages']}, "
        f"corrupt_dropped {sw['store']['corrupt_dropped']}, refused puts "
        f"{sw['store']['refused_puts']}, purged {sw['store']['purged_pages']}"
        f", tenant evictions {sw['store']['evicted_pages']}; no page or host "
        f"byte leaked; tenant_stats {ts}")
    del loop
    free()

    door = main_loop(params, cfg, n_pages=40, tenant_queue_limit=1)
    p = _requests(cfg.vocab, (64,), 4, SEED)[0].prompt
    door.submit(Request(rid=0, prompt=p, tenant="a"))
    for req, err in ((Request(rid=1, prompt=p, deadline_s=0.0),
                      DeadlineExceededError),
                     (Request(rid=2, prompt=p, tenant="a"),
                      QuotaExceededError)):
        try:
            door.submit(req)
        except err as e:
            log(f"  door: request {req.rid} -> {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"request {req.rid} was not refused")
    assert len(door.sched) == 1
    del door
    free()


# ---------------------------------------------------------------------------
# the dense families at full width, the dense oracle, the window, layouts
# ---------------------------------------------------------------------------

FAMILY_MAX_NEW = 16      # new tokens of the internvl2/minicpm/window/mixed runs
ORACLE_N = 4             # main-path requests run through the dense oracle
WINDOW = 2048            # attn_local window: the reference's default
WINDOW_LENS = (2300, 3000, 37, 300)   # two past the window, two inside it
WINDOW_LAYERS = 8        # depth cut of the window family (codeqwen width)
WINDOW_S_MAX = 4096
LAYOUT_LAYERS = 4        # depth of the int8 / mixed codeqwen-shaped stack
INIT_SLACK = 64 << 20    # allocator rounding allowed over params + a layer
LINEARS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo")]


def _free():
    import torch

    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def _tree_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in [*module.parameters(), *module.buffers()])


def init_family(cfg, cut: str = "full depth"):
    """Draw ``cfg``'s serve params on the card (``lm.init_lm``, one stacked
    leaf filled layer by layer) and print the init time and peak: the
    params' bytes plus at most one layer's (``INIT_SLACK`` for the
    allocator's rounding).  Returns the params."""
    import torch

    from repro_torch.models import lm

    _free()
    base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_lm(cfg, gen, device=DEV)
    if DEV == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total = _tree_bytes(params)
    layer = max(_tree_bytes(seg) // s.n for seg, s in
                zip(params.segments, lm.segments_for(cfg)))
    msg = (f"  init {cfg.name} ({cfg.n_layers} layers, {cut}; d_model "
           f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv}, hd "
           f"{cfg.kv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
           f"{', tied head' if cfg.tie_embeddings else ''}, serve_impl "
           f"{cfg.serve_impl}) on the card: {secs:.1f} s; params "
           f"{total / 2**30:.3f} GiB")
    if DEV == "cuda":
        peak = torch.cuda.max_memory_allocated() - base
        msg += (f", init peak {peak / 2**30:.3f} GiB = params + "
                f"{(peak - total) / 2**30:.3f} GiB (one layer "
                f"{layer / 2**30:.3f} GiB)")
        if peak > total + layer + INIT_SLACK:
            raise AssertionError(f"init peak {peak} > params {total} + one "
                                 f"layer {layer}")
    log(msg)
    return params


def _calibrate_int8(params):
    """Calibrated steps for the int8 linears of ``params`` (the reference's
    init holds steps of 1): ``a_step`` 1/32 and ``w_step`` 3 / (127
    sqrt(K)), the absmax calibration of unit activations and N(0, 1/K)
    weights, as ``tests/_torch_families.py`` does."""
    import torch

    def walk(tree):
        for v in tree.values():
            if not isinstance(v, dict):
                continue
            if "w8" in v:
                K = v["w8"].shape[-2]
                with torch.no_grad():
                    v["a_step"].fill_(1.0 / 32)
                    v["w_step"].fill_(3.0 / (127.0 * math.sqrt(K)))
            else:
                walk(v)

    for seg in params.tree()["segments"]:
        walk(seg)


def phase_family_kernels(B_a=3, G=4, n_arr=4096, n_clus=4):
    """Kernels 1-2 at the shapes the new families give them, against
    their plain versions: kernel 1 at command-r-35b's linears (k/v 8192 ->
    1024, q/o 8192 -> 8192, wi/wg 8192 -> 22528, wo 22528 -> 8192) at the
    serve path's M, timed at M = 4; kernel 2 at rep 8 (64 heads over 8),
    at hd 64 (minicpm-2b) and with the 2048-token window over slots past
    it, on fp and int8 pools."""
    import torch

    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.models.nn import _pick_dp

    gen = torch.Generator(device="cuda").manual_seed(5)
    n0 = tf.launches
    for name, (K, N) in {"k/v 8192->1024": (8192, 1024),
                         "q/o 8192->8192": (8192, 8192),
                         "wi/wg 8192->22528": (8192, 22528),
                         "wo 22528->8192": (22528, 8192)}.items():
        dp = _pick_dp(N, 128)
        nt, kg = N // dp, K // G
        idx = torch.randint(0, n_arr, (nt, kg, dp), dtype=torch.int16,
                            generator=gen, device="cuda")
        cl = torch.randint(0, n_clus, (nt, kg), dtype=torch.int8,
                           generator=gen, device="cuda")
        tab = tf.narrow_table(torch.randint(-8, 8, (n_clus, n_arr, 2**G),
                                            dtype=torch.int32, generator=gen,
                                            device="cuda"))
        for M in (1, 4, 20, 64):
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device="cuda")
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM {name} M={M}", got,
                   tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G))
            if M == 4:
                ms = graph_ms(lambda: tf.tlmac_gemm_fused(
                    aq, idx, cl, tab, B_a=B_a, G=G))
                nbytes = (M * K + idx.numel() * 2 + cl.numel() + tab.numel()
                          + M * N * 4)
                b = _gemm_bound(M, kg, N, G, nbytes)
                log(f"  lookup GEMM {name:18s} (dp {dp}): equal int32 at M "
                    f"1, 4, 20, 64; M=4 kernel {ms:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms ({_bound_by(b)}), "
                    f"{b['bound_ms'] / ms:.1%} of bound")
        del idx, cl, tab
    worst = 0.0
    cases = [
        ("rep8 hd128 KV8 (command-r, internvl2)",
         dict(B=4, KV=8, rep=8, hd=128, P=16, MB=64, lens=MAIN_LENS,
              window=None, n_splits=4)),
        ("rep1 hd64 KV36 (minicpm)",
         dict(B=4, KV=36, rep=1, hd=64, P=16, MB=64, lens=MAIN_LENS,
              window=None, n_splits=4)),
        ("rep1 hd128 KV32 window 2048, past it",
         dict(B=4, KV=32, rep=1, hd=128, P=16, MB=256,
              lens=(2301, 3001, 38, 301), window=WINDOW, n_splits=4)),
    ]
    for kv in ("fp", "int8"):
        for label, c in cases:
            a = _flash_case(gen, kv, **c)
            got = _flash_kernel(a)
            err = (got - _flash_plain(a)).abs().max().item()
            worst = max(worst, err)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash-decode {kv} {label}: max abs err "
                                     f"{err} > {FLASH_TOL}")
            if c["window"]:
                full = _flash_kernel(dict(a, window=None))
                assert (full - got).abs().max().item() > 100 * FLASH_TOL, \
                    "the window changed nothing"
            log(f"  flash-decode {kv:4s} {label:38s}: max abs err {err:.3e}")
            del a
    tf.launches = n0          # comparison launches are not the path's
    return worst


def _logit_rows(loop):
    """Hook a paged loop: per request, the host f32 logits row behind each
    emitted token (the admission's last chunk, then decode rows)."""
    first, rows, cur = {}, {}, {}
    pop, chunk, decode = loop.sched.pop, loop._prefill_chunk, loop._decode

    def pop_w(ent):
        cur["rid"] = ent.req.rid
        return pop(ent)

    def chunk_w(*a):
        lg = chunk(*a)
        first[cur["rid"]] = lg.float().cpu()        # the last chunk's wins
        return lg

    def decode_w(*a):
        lg = decode(*a)
        host = lg.float().cpu()
        for i, s in enumerate(loop.slots):
            if s is not None:
                rows.setdefault(s["req"].rid, []).append(host[i])
        return lg

    loop.sched.pop, loop._prefill_chunk, loop._decode = pop_w, chunk_w, \
        decode_w
    return lambda rid: [first[rid]] + rows.get(rid, [])


def _oracle_rows(loop):
    """Hook a dense ``ServeLoop`` run one request at a time: per request,
    the host f32 logits row of each argmax (prefill, then decode steps)."""
    rows = {}
    argmax = loop._argmax

    def argmax_w(logits):
        rid = len(loop.done)            # solo: the request being served
        rows.setdefault(rid, []).append(logits[0].float().cpu())
        return argmax(logits)

    loop._argmax = argmax_w
    return rows


def _clear(row) -> bool:
    top2 = row.topk(2).values
    return bool(top2[0] - top2[1] > LOGIT_TOL * row.abs().max())


def phase_dense_oracle(cfg, params):
    """The reference's paged-vs-dense contract on the card at full width:
    the main path's first four requests run solo through the port's dense
    ``ServeLoop`` (eager, dense caches) and together through
    ``PagedServeLoop`` with the gathered reader (``attn_impl='lax'``), at
    one ``s_max`` equal to ``max_blocks x page_size``, so both readers
    reduce over the same length; on an fp pool, then on an int8 pool
    against the dense loop's round-tripped f32 cache.  Tokens must be
    equal wherever the dense run's top-2 margin clears LOGIT_TOL x its
    max |logit| (up to the first near tie: later tokens follow it); the
    share of bit-equal logits rows is printed."""
    import torch

    from repro_torch.serve.loop import ServeLoop

    lens = PROMPT_LENS[:ORACLE_N]
    for kv in ("fp", "int8"):
        kcfg = dataclasses.replace(cfg, serve_kv_dtype=kv)
        oracle = ServeLoop(params, kcfg, batch_slots=1, s_max=1024,
                           device=DEV)
        orows = _oracle_rows(oracle)
        t = time.perf_counter()
        for r in _requests(cfg.vocab, lens, MAX_NEW, SEED):
            oracle.submit(r)
            oracle.run()
        t_dense = time.perf_counter() - t
        dense = {r.rid: r.output.tolist() for r in oracle.done}
        del oracle
        _free()
        loop = main_loop(params, kcfg, attn_impl="lax")
        assert loop.spec.s_alloc == 1024
        prow = _logit_rows(loop)
        for r in _requests(cfg.vocab, lens, MAX_NEW, SEED):
            loop.submit(r)
        t = time.perf_counter()
        paged = {r.rid: r.output.tolist() for r in loop.run()}
        t_paged = time.perf_counter() - t
        compared = exact = 0
        for rid, toks in dense.items():
            assert len(toks) == len(paged[rid]) == MAX_NEW
            for td, tp, rd, rp in zip(toks, paged[rid], orows[rid],
                                      prow(rid)):
                if not _clear(rd):
                    break
                if td != tp:
                    raise AssertionError(
                        f"{kv}: request {rid}, paged token {tp} != dense "
                        f"{td} where the dense margin is clear")
                compared += 1
                exact += bool(torch.equal(rd, rp))
        same = sum(a == b for rid in dense
                   for a, b in zip(dense[rid], paged[rid]))
        n_tok = ORACLE_N * MAX_NEW
        log(f"  dense oracle, {kv} KV: {ORACLE_N} requests x {MAX_NEW} "
            f"tokens, dense loop solo {t_dense:.2f} s (eager), paged 'lax' "
            f"{t_paged:.2f} s; {compared} tokens with a clear margin all "
            f"equal ({same} of {n_tok} equal in all); bit-equal logits rows "
            f"{exact} of {compared} ({exact / max(compared, 1):.1%})")
        del loop
        _free()


def _window_check(loop, cfg, done):
    """Wrap the loop's decode: at the first step with a slot past the
    window, hold flash-decode (kernel 2, window ``local_window``) against
    the gathered ``'lax'`` reader on layer 0's pool, the step's block
    table and positions, within FLASH_TOL (f32 sums in another order) of
    the output's scale where it exceeds 1 (a served pool holds the
    model's V, not unit noise); and show the window changes the result.
    The comparison's launches are taken back out."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged as pk

    decode = loop._decode
    W = cfg.local_window

    def wrapper(tokens, positions, block_table):
        lg = decode(tokens, positions, block_table)
        if not done and int(np.max(positions)) > W:
            n0 = fd.launches
            qs = pk.qspec_for(cfg)
            pool = {n: leaf[0] for n, leaf in loop.caches[0]["b0"].items()}
            B, H, KV, hd = loop.B, cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
            gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
            # queries at the keys' inverse scale: scores of order one,
            # where a served pool's raw keys would saturate the softmax
            k_rms = pool["k"].float().pow(2).mean().sqrt().item() \
                if not qs.quantised else 1.0
            q = (torch.randn((B, 1, H, hd), generator=gen, device=DEV)
                 / max(k_rms, 1.0)).bfloat16()
            pos = torch.as_tensor(np.asarray(positions, np.int32), device=DEV)
            bt = torch.as_tensor(np.asarray(block_table, np.int32),
                                 device=DEV)
            ksc, vsc = pk.pool_scales(pool)
            got = fd.flash_decode(q.reshape(B, KV, H // KV, hd), pool["k"],
                                  pool["v"], bt, pos + 1, window=W,
                                  n_splits=4, k_scales=ksc, v_scales=vsc,
                                  kv_dtype=qs.dtype).reshape(B, H * hd)
            want = pk._attend_lax(q.float(), pool, bt, pos, W, qs)[:, 0]
            full = pk._attend_lax(q.float(), pool, bt, pos, None, qs)[:, 0]
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            fd.launches = n0
            past = [int(p) for p in np.asarray(positions) if p > W]
            if not err <= FLASH_TOL * scale:
                raise AssertionError(f"window flash-decode vs lax: {err} > "
                                     f"{FLASH_TOL} x {scale}")
            moved = (full - want).abs().max().item()
            assert moved > 100 * FLASH_TOL, "the window changed nothing"
            done.append(err)
            log(f"  window {W}: flash-decode vs the gathered reader on "
                f"layer 0's pool at positions {np.asarray(positions).tolist()}"
                f" ({len(past)} slots past the window): max abs err "
                f"{err:.3e} (tolerance {FLASH_TOL} x max(1, max |out|) = "
                f"{FLASH_TOL * scale:.3e}); full attention differs by "
                f"{moved:.3f}")
        return lg
    loop._decode = wrapper


# command-r-35b's depth in the families phase and the dense oracle: cut
# from 40 to keep the whole script inside its time limit
COMMAND_R_LAYERS = 20


def phase_families():
    """The dense families the reference pages, at full width: command-r-35b
    (``COMMAND_R_LAYERS`` of 40, the main path's six requests, then the
    dense oracle),
    internvl2-76b's backbone and minicpm-2b (full depth, four requests x 16
    tokens), the sliding window at codeqwen1.5-7b's width (8 layers,
    prompts of 2300/3000/37/300 tokens, s_max 4096), and the int8 and
    mixed serve layouts on a 4-layer codeqwen-shaped stack.  Each model is
    freed before the next is drawn.  Returns the runs' figures."""
    from repro_torch.configs import get_config

    out = {}
    phase(f"command-r-35b at full width, {COMMAND_R_LAYERS} of 40 layers "
          "(serve)")
    cfg = _cut_config("command-r-35b", COMMAND_R_LAYERS)
    params = init_family(cfg, cut=f"{COMMAND_R_LAYERS} of 40 layers")
    out["command-r-35b"] = phase_main(cfg, params)
    phase_tune_family(cfg, params, main_run=out["command-r-35b"][1])
    phase("dense oracle at command-r-35b's width: paged 'lax' vs ServeLoop")
    phase_dense_oracle(cfg, params)
    del params
    for name in ("internvl2-76b", "minicpm-2b"):
        phase(f"{name} at full width and depth (serve)")
        cfg = get_config(name)
        params = init_family(cfg)
        out[name] = phase_main(cfg, params, lens=MAIN_LENS,
                               max_new=FAMILY_MAX_NEW)
        phase_tune_family(cfg, params)
        del params
    phase("sliding window 2048 at codeqwen1.5-7b's width (serve)")
    out["window"] = phase_window()
    phase("int8 and mixed serve layouts at codeqwen1.5-7b's width")
    out["layouts"] = phase_layouts()
    _free()
    return out


def phase_window():
    """The sliding window at codeqwen1.5-7b's width: ``attn_local``
    blocks (window 2048), 8 layers, s_max 4096, prompts of 2300 and 3000
    tokens past the window and two inside it, 16 new tokens each; kernel
    2 held against the gathered reader at the first step past the
    window."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(
        get_config("codeqwen1.5-7b"), family="hybrid",
        block_pattern=("attn_local",), local_window=WINDOW,
        n_layers=WINDOW_LAYERS, name="codeqwen1.5-7b attn_local")
    params = init_family(cfg, cut="cut from 32")
    checked = []
    run = phase_main(cfg, params, lens=WINDOW_LENS, max_new=FAMILY_MAX_NEW,
                     s_max=WINDOW_S_MAX,
                     setup=lambda loop: _window_check(loop, cfg, checked))
    assert checked, "no decode step ran past the window"
    phase_tune_family(cfg, params, s_max=WINDOW_S_MAX)
    return run


def phase_layouts():
    """A 4-layer codeqwen1.5-7b-shaped stack: the int8 layout's seven
    linears on the card (``torch._int_mm``) held equal to their plain
    product (an exact f64 product of the codes, on the card) at M 1, 4,
    17 and 64, one layer's seven timed at M = 4 against their byte bound;
    then a mixed tree (TLMAC attention, int8 FFN) serving four requests
    through ``PagedServeLoop``: kernel 1 launches 4 x layers a forward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn

    base = dataclasses.replace(get_config("codeqwen1.5-7b"),
                               n_layers=LAYOUT_LAYERS)
    cut = "cut from 32"
    c8 = dataclasses.replace(base, serve_impl="int8",
                             name="codeqwen1.5-7b int8")
    p8 = init_family(c8, cut)
    _calibrate_int8(p8)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    layer = p8.layers(0)[0]["b0"]
    t_layer = b_layer = 0.0
    for blk, name in LINEARS:
        lin = layer[blk][name]
        K, N = lin["w8"].shape
        bias = blk == "attn" and name != "wo" and c8.qkv_bias
        for M in (1, 4, 17, 64):
            x = (torch.randn((M, K), generator=gen, device=DEV) * 2).bfloat16()
            got = nn.serve_linear_apply(lin, x, c8, use_bias=bias)
            aq = torch.clamp(torch.round(x.float() / lin["a_step"]), -127, 127)
            yi = torch.matmul(aq.double(), lin["w8"].double()).to(torch.int32)
            want = (yi.float() * (lin["a_step"] * lin["w_step"])).bfloat16()
            if bias:
                want = want + lin["b"]
            _equal(f"int8 linear {blk}.{name} M={M}", got, want)
            if M == 4 and DEV == "cuda":
                t_layer += graph_ms(lambda: nn.serve_linear_apply(
                    lin, x, c8, use_bias=bias))
                b_layer += (K * N + M * K + M * N * 2) / HBM_BYTES_S * 1e3
    log(f"  int8 layout: 7 linears of layer 0 equal to the plain product at "
        f"M 1, 4, 17, 64; one layer's seven at M=4: {t_layer:.4f} ms "
        f"(graph replay), byte bound {b_layer:.4f} ms "
        f"({b_layer / max(t_layer, 1e-9):.1%} of bound)")
    # a ragged int8 linear: w8 zero-padded to multiples of 8 where made
    K, N = 100, 36
    lin = nn.init_serve_linear(gen, K, N, c8, device=DEV)
    assert tuple(lin["w8"].shape) == (104, 40)
    for M in (1, 4, 17, 64):
        x = (torch.randn((M, K), generator=gen, device=DEV) * 2).bfloat16()
        aq = torch.clamp(torch.round(x.float() / lin["a_step"]), -127, 127)
        yi = torch.matmul(aq.double(), lin["w8"][:K, :N].double()).to(
            torch.int32)
        _equal(f"ragged int8 linear {K}->{N} M={M}",
               nn.serve_linear_apply(lin, x, c8),
               (yi.float() * (lin["a_step"] * lin["w_step"])).bfloat16())
    log(f"  ragged int8 linear {K}->{N} (w8 padded to 104 x 40): equal to "
        f"the plain int32 product at M 1, 4, 17, 64")
    ffn = p8.tree()["segments"][0]["b0"]["ffn"]
    pt = init_family(dataclasses.replace(base, name="codeqwen1.5-7b mixed"),
                     cut)
    tree = pt.tree()
    tree["segments"][0]["b0"]["ffn"] = ffn
    mixed = nn.ParamTree(tree)
    del p8, pt, tree, ffn
    _free()
    assert _lookup_launches(mixed) == (4 * LAYOUT_LAYERS, 0)
    cfg = dataclasses.replace(base, name="codeqwen1.5-7b mixed")
    run = phase_main(cfg, mixed, lens=MAIN_LENS, max_new=FAMILY_MAX_NEW)
    del mixed
    return dict(int8_layer_ms=t_layer, int8_layer_bound_ms=b_layer,
                mixed=run)


# ---------------------------------------------------------------------------
# the MoE family: deepseek-v3's widths with GQA attention (moe-gqa)
# ---------------------------------------------------------------------------

MOE_LAYERS = 11          # depth cut of moe-gqa: the 3 dense + 8 MoE of 61
MOE_MS = (4, 2)          # rows an expert sees: a decode step of 4 slots
                         # (cap 1 x 4 groups), a 64-token chunk (cap 2)
MOE_LINEAR_MS = (4, CHUNK)   # rows a single linear sees: decode, a chunk
MOE_SINGLE = [("dense layer", "attn", n) for n in ("wq", "wk", "wv", "wo")] + [
    ("dense layer", "ffn", n) for n in ("wi", "wg", "wo")] + [
    ("MoE layer", "moe", n) for n in ("shared_wi", "shared_wg", "shared_wo")]


def moe_config(n_layers: int = MOE_LAYERS):
    """deepseek-v3-671b with GQA blocks (the reference's moe-gqa: MLA does
    not page), widths unchanged, ``n_layers`` of 61."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"),
                               attn_kind="gqa", n_layers=n_layers,
                               name="deepseek-v3-671b moe-gqa")


def _idx_bytes(cfg, K, N):
    """The exec_idx bytes of one serve linear K -> N by ``plan_shapes``."""
    from repro_torch.core.tlmac.compile import plan_shapes
    from repro_torch.models.nn import _pick_dp

    dp = _pick_dp(N, cfg.tlmac_dp)
    ps = plan_shapes(K, N, cfg.tlmac_G, cfg.quant.w_bits,
                     n_arr_cap=cfg.tlmac_narr_cap, d_p=dp)
    return (N // dp) * (K // cfg.tlmac_G) * dp * (1 if ps["N_arr"] <= 256
                                                  else 2), ps["N_arr"]


def _attn_bytes(cfg):
    """One attention block's serve bytes by ``plan_shapes``: GQA's q/k/v/o
    indices, or MLA's wq_a, wq_b, wkv_a and wo indices plus the dense
    bf16 ``wkv_b``."""
    d = cfg.d_model
    if cfg.attn_kind == "mla":
        H, ql, kvl = cfg.n_heads, cfg.mla_q_lora, cfg.mla_kv_lora
        nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
        return (_idx_bytes(cfg, d, ql)[0]
                + _idx_bytes(cfg, ql, H * (nod + rod))[0]
                + _idx_bytes(cfg, d, kvl + rod)[0]
                + _idx_bytes(cfg, H * vd, d)[0] + kvl * H * (nod + vd) * 2)
    qkvo = cfg.n_heads * cfg.kv_head_dim
    kv = cfg.n_kv * cfg.kv_head_dim
    return (_idx_bytes(cfg, d, qkvo)[0] + 2 * _idx_bytes(cfg, d, kv)[0]
            + _idx_bytes(cfg, qkvo, d)[0])


def moe_reckoning(cfg):
    """Print the index bytes of the model by ``plan_shapes``: one expert
    linear, a MoE layer (experts, attention, shared expert), a dense layer,
    the embedding and head, at 61 layers and at ``cfg.n_layers``."""
    d, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert
    wi, n_arr = _idx_bytes(cfg, d, F)
    wo, _ = _idx_bytes(cfg, F, d)
    experts = E * (2 * wi + wo)
    attn = _attn_bytes(cfg)
    Fs = F * cfg.n_shared
    shared = 2 * _idx_bytes(cfg, d, Fs)[0] + _idx_bytes(cfg, Fs, d)[0]
    dense = attn + 2 * _idx_bytes(cfg, d, cfg.d_ff)[0] + _idx_bytes(
        cfg, cfg.d_ff, d)[0]
    emb = 2 * (cfg.vocab + (-cfg.vocab) % 16) * d * 2
    moe_layer = experts + attn + shared

    def total(L):
        return (emb + cfg.moe_layer_start * dense
                + (L - cfg.moe_layer_start) * moe_layer)
    G = 1e9
    log(f"  plan_shapes reckoning (N_arr {n_arr}, "
        f"{'uint8' if n_arr <= 256 else 'int16'} indices, "
        f"{cfg.attn_kind} attention): one expert "
        f"linear {d}->{F} {wi / 1e6:.2f} MB; a MoE layer {moe_layer / G:.3f}"
        f" GB = {E} experts x 3 {experts / G:.3f} GB + attention "
        f"{attn / 1e6:.1f} MB + shared expert {shared / 1e6:.1f} MB; a dense "
        f"layer {dense / G:.3f} GB; embedding + head {emb / G:.3f} GB; "
        f"61 layers {total(61) / G:.1f} GB, {cfg.n_layers} layers "
        f"{total(cfg.n_layers) / G:.2f} GB (indices and bf16 embeddings)")


def _single_linears_equal(lins, Ms, gen, B_a, G):
    """Kernel 1 int32-equal to its plain version (``ref.tlmac_matmul_ref``
    on the same codes) on each lookup linear of ``lins`` ({label: the
    drawn params}, narrow tables as the serve path reads them) at each M
    of ``Ms``.  The caller restores the launch counters."""
    import torch

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_fused as tf

    for label, lin in lins.items():
        idx, cl, tab = lin["exec_idx"], lin["step_cluster"], lin["table_narrow"]
        nt, kg, dp = idx.shape
        t0 = time.perf_counter()
        for M in Ms:
            aq = torch.randint(0, 2**B_a, (M, kg * G), dtype=torch.int8,
                               generator=gen, device=DEV)
            _equal(f"lookup GEMM {label} M={M}",
                   tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G),
                   kref.tlmac_matmul_ref(aq, tab, idx, cl, B_a, G, nt * dp))
        log(f"  lookup GEMM {label} {kg * G}->{nt * dp} (dp {dp}, N_arr "
            f"{tab.shape[-2]}, {idx.dtype}): equal int32 at M "
            f"{', '.join(map(str, Ms))} ({time.perf_counter() - t0:.1f} s)")


def phase_moe_kernels(cfg, params, B_a=3):
    """Kernels 1-2 at the moe-gqa path's shapes, against their plain
    versions: kernel 1's single linears from the drawn params (one dense
    layer's q/k/v/o and FFN, a MoE layer's shared expert; N_arr 512) at M
    4 and 64, int32-equal; kernel 2 at the decode shape (4 slots, 128 KV
    heads of dim 56, 16-token pages) on fp, int8 and int4 pools, within
    ``FLASH_TOL``; kernel 1's expert axis on one MoE layer's
    expert-stacked wi, wg and wo (256 experts), at M 4 (decode) and 2 (a
    64-token chunk), each int32-equal to its plain version (a loop over
    the experts) and timed (graph replay) against its bound; at M 4, wi
    also as 256 single launches.  Returns kernel 1's expert-stack row and
    kernel 2's worst error."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    G = cfg.tlmac_G
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    n0, e0, f0 = tf.launches, tf.expert_launches, fd.launches
    blocks = {"dense layer": params.layers(0)[0]["b0"],
              "MoE layer": params.layers(1)[0]["b0"]}
    _single_linears_equal(
        {f"{where} {blk}.{name}": blocks[where][blk][name]
         for where, blk, name in MOE_SINGLE}, MOE_LINEAR_MS, gen, B_a, G)
    worst = 0.0
    if DEV == "cuda":
        for kv in ("fp", "int8", "int4"):
            a = _flash_case(gen, kv, B=4, KV=cfg.n_kv,
                            rep=cfg.n_heads // cfg.n_kv, hd=cfg.kv_head_dim,
                            P=16, MB=64, lens=MAIN_LENS, window=None,
                            n_splits=4)
            err = (_flash_kernel(a) - _flash_plain(a)).abs().max().item()
            worst = max(worst, err)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash-decode {kv} moe-gqa decode "
                                     f"shape: max abs err {err} > "
                                     f"{FLASH_TOL}")
            log(f"  flash-decode {kv:4s} moe-gqa decode shape (B 4, KV "
                f"{cfg.n_kv}, rep {cfg.n_heads // cfg.n_kv}, hd "
                f"{cfg.kv_head_dim}, P 16, MB 64): max abs err {err:.3e}")
            del a
    layer = blocks["MoE layer"]["moe"]
    row = {"flash_max_abs_err": worst}
    for name in ("wi", "wg", "wo"):
        lin = layer[name]
        idx, cl, tab = lin["exec_idx"], lin["step_cluster"], lin["table_narrow"]
        E, nt, kg, dp = idx.shape
        K, N = kg * G, nt * dp
        for M in MOE_MS:
            aq = torch.randint(0, 2**B_a, (E, M, K), dtype=torch.int8,
                               generator=gen, device=DEV)
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"expert-stacked lookup GEMM {name} [{E}] {K}->{N} M={M}",
                   got, want)
            del want
            if DEV != "cuda":
                continue
            ms = graph_ms(lambda: tf.tlmac_gemm_fused(
                aq, idx, cl, tab, B_a=B_a, G=G), iters=10, replays=3)
            nbytes = (aq.numel() + idx.numel() * idx.element_size()
                      + cl.numel() + tab.numel() * tab.element_size()
                      + E * M * N * 4)
            b = _gemm_bound(E * M, kg, N, G, nbytes)
            acc = row.setdefault(M, dict(ms=0.0, bound_ms=0.0, bytes=0))
            acc["ms"] += ms
            acc["bound_ms"] += b["bound_ms"]
            acc["bytes"] += nbytes
            msg = (f"  expert-stacked lookup GEMM {name} [{E}] {K}->{N} (dp "
                   f"{dp}) M={M}: equal int32; kernel {ms:.4f} ms (one "
                   f"launch), bound {b['bound_ms']:.4f} ms ({_bound_by(b)}), "
                   f"{b['bound_ms'] / ms:.1%} of bound")
            if name == "wi" and M == 4:
                single = graph_ms(lambda: [tf.tlmac_gemm_fused(
                    aq[e], idx[e], cl[e], tab[e], B_a=B_a, G=G)
                    for e in range(E)], iters=2, replays=2)
                msg += f"; {E} single launches {single:.4f} ms"
                row["single_launches_ms"] = single
            log(msg)
    # comparisons are not the path's
    tf.launches, tf.expert_launches, fd.launches = n0, e0, f0
    for M in MOE_MS:
        if M in row:
            r = row[M]
            log(f"  one MoE layer's three expert stacks at M={M}: "
                f"{r['ms']:.4f} ms against a {r['bound_ms']:.4f} ms bound "
                f"({r['bytes'] / 1e9:.3f} GB; {r['bound_ms'] / r['ms']:.1%})")
    return row


def _moe_glue(cfg, params):
    """One eager decode step (4 slots at the main path's lengths) under
    torch.profiler: device ms of each MoE phase's range (route, dispatch
    einsums, expert linears, combine einsums, shared experts) summed over
    the MoE layers, and the step's device time split into kernel 1's
    expert stacks, its single linears, kernel 2 and the rest (the range
    spans the profiler records on the device are not kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged as pk
    from repro_torch.models import lm

    B = 4
    spec = pk.spec_for(1024, B, page_size=16)
    caches = lm.init_caches(cfg, spec, device=DEV)
    MB = spec.max_blocks
    bt = (torch.arange(B * MB, dtype=torch.int32, device=DEV).reshape(B, MB)
          % (spec.n_pages - 1) + 1)
    pos = torch.tensor(MAIN_LENS, dtype=torch.int32, device=DEV)
    cur = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    step = lambda: lm.decode_step_paged(params, caches, cur, pos, bt, cfg)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ranges, by_kernel = {}, {}
    for e in prof.key_averages():
        if e.key.startswith("repro_torch."):
            if e.key.startswith("repro_torch.moe."):
                ranges[e.key.rsplit(".", 1)[-1]] = (
                    getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0)) / 1e3
        elif getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = (getattr(e, "self_device_time_total", None)
                                or getattr(e, "self_cuda_time_total", 0)) / 1e3
    k1 = sum(v for k, v in by_kernel.items() if "tlmac_fused_" in k)
    stacks = sum(v for k, v in by_kernel.items() if "tlmac_fused_expert_" in k)
    k2 = sum(v for k, v in by_kernel.items() if "flash_decode_kernel" in k)
    busy = sum(by_kernel.values())
    others = sorted(((v, k) for k, v in by_kernel.items()
                     if "tlmac_fused_" not in k
                     and "flash_decode_kernel" not in k), reverse=True)
    del caches
    names = ("route", "dispatch", "experts", "combine", "shared")
    if not any(ranges.get(n) for n in names):
        log("  MoE phases of an eager decode step: the profiler gave the "
            "ranges no device time (not measured)")
        return ranges
    log(f"  MoE phases of an eager decode step ({cfg.n_layers - cfg.moe_layer_start}"
        f" MoE layers, device ms by profiler range): " + ", ".join(
            f"{n} {ranges.get(n, 0.0):.3f}" for n in names))
    log(f"  the eager decode step's device time {busy:.3f} ms: kernel 1 "
        f"expert stacks {stacks:.3f} ms, kernel 1 single linears "
        f"{k1 - stacks:.3f} ms, kernel 2 {k2:.3f} ms, {len(others)} other "
        f"kernels {busy - k1 - k2:.3f} ms (the dispatch and combine "
        f"einsums among them, as the ranges above)")
    for v, k in others[:3]:
        log(f"    {v:8.3f} ms  {k[:90]}")
    return dict(ranges, stacks=stacks, k1=k1, k2=k2, busy=busy)


def phase_moe():
    """The reference's MoE path at deepseek-v3-671b's widths (GQA blocks,
    128 heads over 128 of dim 56, 256 experts top 8 with one shared,
    d_expert 2048, vocab 129280), cut to 11 of 61 layers (3 dense + 8 MoE):
    drawn on the card (init peak asserted), kernel 1's expert axis held
    against its plain version at the real shapes, then four prompts x 16
    tokens served through ``PagedServeLoop`` under CUDA graphs as the main
    path is (launches asserted: every lookup linear once a forward, three
    expert stacks a MoE layer), and the MoE phases of a decode step
    profiled.  Returns the run's figures."""
    cfg = moe_config()
    moe_reckoning(cfg)
    params = init_family(cfg, cut=f"cut from 61: {cfg.moe_layer_start} "
                                  f"dense + {MOE_LAYERS - cfg.moe_layer_start}"
                                  f" MoE")
    rows = phase_moe_kernels(cfg, params)
    counts, run = phase_main(cfg, params, lens=MAIN_LENS,
                             max_new=FAMILY_MAX_NEW)
    phase_tune_family(cfg, params)
    if DEV == "cuda":
        run["glue"] = _moe_glue(cfg, params)
    del params
    _free()
    return dict(run, counts=counts, expert_rows=rows)


# ---------------------------------------------------------------------------
# autotune: the main path under 'auto' after tuning
# ---------------------------------------------------------------------------


def _fresh_autotune_cache():
    """Point the autotuner at this run's own cache file, emptied: until
    ``phase_autotune`` records winners (and after it empties the file
    again) every 'auto' resolves to its miss defaults, kernel 1 and
    flash-decode at 4 splits."""
    from repro_torch.kernels import autotune as at

    os.environ[at.CACHE_ENV] = AUTOTUNE_CACHE
    for path in (AUTOTUNE_CACHE, AUTOTUNE_CACHE + ".lock"):
        if os.path.exists(path):
            os.remove(path)
    at.reset_cache()


def _served_turn(params, cfg, main_run):
    """The main path's six requests served from CUDA graphs by a fresh
    loop under ``cfg``'s impls (forwards captured before the timed run):
    decode step median on the host clock and as the device span, prefill
    tok/s, requests whose tokens equal ``main_run``'s, and launches."""
    import torch

    loop = main_loop(params, cfg)
    _capture_forwards(loop)              # capture outside the timed run
    steps = _step_times(loop, ("_prefill_chunk", "_decode"))
    reqs = _requests(cfg.vocab, PROMPT_LENS, MAX_NEW, SEED)
    for r in reqs:
        loop.submit(r)
    _reset_launches(loop)
    done = loop.run()
    if DEV == "cuda":
        torch.cuda.synchronize()
    counts, _ = _read_launches(loop)
    assert len(done) == len(reqs)
    for r in done:
        assert len(r.output) == MAX_NEW
        assert 0 <= int(r.output.min()) and int(r.output.max()) < cfg.vocab
    loop.check_compiled()
    out = dict(decode_ms=_median(steps["_decode"]["ms"]),
               span_ms=_median(steps["_decode"]["span"]),
               prefill_tok_s=sum(PROMPT_LENS)
               / (sum(steps["_prefill_chunk"]["ms"]) / 1e3),
               same=sum(r.output.tolist() == main_run["outputs"][r.rid]
                        for r in done), counts=counts,
               autotune=loop.metrics()["autotune"])
    del loop
    _free()
    return out


def phase_autotune(cfg, params, main_run, B_a=3):
    """The main path under ``'auto'`` (the reference's default for the
    serve linears and the paged decode reader), tuned first: the loop's
    ``tune`` times kernel 1 against kernels 4 + 3 on every linear shape at
    the chunk's and the decode step's rows, and kernel 2 at 1, 2, 4 and 8
    splits against the gathered reader at the decode shape (every
    candidate held to the oracle before it is timed); each key printed
    with its winner, the winner's and the baseline's µs; every tuned GEMM
    winner held int32-equal to ``'ref'`` again on fresh codes, and both
    GEMM candidates timed by graph replay, as the captured forwards run
    them.  Then the main path's six requests served in turns under the
    fixed impls (kernel 1, flash-decode at 4 splits) and under the tuned
    ``'auto'`` (fixed, auto, auto, fixed, a fresh loop each): decode step
    on the host clock and as the device span, prefill tok/s, tokens equal
    to ``phase_main``'s run (``main_run``).  The cache is emptied
    after."""
    import numpy as np
    import torch

    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.serve.paged import _tlmac_linears

    G = cfg.tlmac_G
    loop = main_loop(params, cfg)
    t0 = time.perf_counter()
    tuned = loop.tune()
    secs = time.perf_counter() - t0
    rows = (loop.chunk, loop.B)
    del loop
    _log_tuned(tuned, secs, cfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    checked = set()
    for lin in _tlmac_linears(params.tree()):
        n_tiles, kg, dp = lin["exec_idx"].shape
        tab = lin["table_narrow"]
        K, N = kg * G, n_tiles * dp
        for M in rows:
            key = at.shape_key(M, K, N, B_a=B_a, G=G, D_p=dp,
                               R=int(np.prod(tab.shape[:-1])), device=DEV)
            if key in checked:
                continue
            checked.add(key)
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device=DEV)
            run = {impl: (lambda impl=impl: ops.dispatch_config(
                {"impl": impl}, aq, tab, lin["exec_idx"], lin["step_cluster"],
                B_a=B_a, G=G, N=N))
                for impl in {"fused", "pallas", tuned[key]["impl"]}}
            _equal(f"'auto' winner {tuned[key]} at {key}",
                   run[tuned[key]["impl"]](),
                   kref.tlmac_matmul_ref(aq, tab, lin["exec_idx"],
                                         lin["step_cluster"], B_a, G, N))
            if DEV == "cuda":      # as a captured forward runs them
                ms = {k: graph_ms(run[k], iters=10, replays=3)
                      for k in ("fused", "pallas")}
                log(f"    M={M} {K}->{N} by graph replay: kernel 1 "
                    f"{ms['fused'] * 1e3:.1f} us, kernels 4 + 3 (rowbase "
                    f"rebuilt a call) {ms['pallas'] * 1e3:.1f} us")
    log(f"  every tuned GEMM winner int32-equal to 'ref' on fresh codes "
        f"({len(checked)} shapes)")
    turns = _turns(cfg, params, main_run)
    _fresh_autotune_cache()
    return dict(tuned=tuned, turns=turns)


def _turns(cfg, params, main_run):
    """The main path's six requests under the fixed impls (kernel 1,
    flash-decode at 4 splits) and under ``'auto'`` after tuning, in turns
    (fixed, auto, auto, fixed, a fresh loop each), printed with the
    means of each side."""
    fixed = dataclasses.replace(cfg, serve_tlmac_impl="fused",
                                serve_paged_attn_impl="flash")
    turns = []
    for kind in ("fixed", "auto", "auto", "fixed"):
        r = _served_turn(params, fixed if kind == "fixed" else cfg, main_run)
        turns.append((kind, r))
        log(f"  {kind:5s}: decode step median {r['decode_ms']:.3f} ms, "
            f"device span median {r['span_ms']:.3f} ms, prefill "
            f"{r['prefill_tok_s']:.1f}"
            f" tok/s; {r['same']} of {len(PROMPT_LENS)} requests' tokens "
            f"equal to phase_main's; launches " + ", ".join(
                f"{k} {v}" for k, v in r["counts"].items() if v))
    by = {k: [r for kk, r in turns if kk == k] for k in ("fixed", "auto")}
    assert by["fixed"][0]["counts"] == by["auto"][0]["counts"]
    mean = lambda k, f: sum(r[f] for r in by[k]) / 2     # noqa: E731
    log(f"  {cfg.name} in turns: decode step fixed "
        f"{mean('fixed', 'decode_ms'):.3f} ms "
        f"vs 'auto' {mean('auto', 'decode_ms'):.3f} ms (host clock), device "
        f"span {mean('fixed', 'span_ms'):.3f} vs "
        f"{mean('auto', 'span_ms'):.3f} ms; phase_main's "
        f"{main_run['decode_ms']:.3f} ms (span {main_run['span_ms']:.3f})")
    snap = by["auto"][-1]["autotune"]
    log(f"  metrics()['autotune']: lookup hits {snap['lookup_hits']}, "
        f"misses {snap['lookup_misses']}, {len(snap['tuned_keys'])} tuned "
        f"keys")
    return turns


def _log_tuned(tuned, secs, cfg):
    from repro_torch.kernels import autotune as at

    entries = at._load()
    log(f"  tuned {len(tuned)} keys in {secs:.1f} s (serve_tlmac_impl "
        f"{cfg.serve_tlmac_impl!r}, serve_paged_attn_impl "
        f"{cfg.serve_paged_attn_impl!r}; winner us, baseline us):")
    for key, conf in tuned.items():
        e = entries[key]
        base = ", ".join(f"{k} {v:.1f}" for k, v in e["baseline_us"].items())
        log(f"    {key}: {conf} {e['us']:.1f} us; baseline {base}")


def phase_tune_family(cfg, params, main_run=None, **kw):
    """The loop's ``tune`` on a family's own shapes (``kw`` to the loop):
    each key's winner with its and the baseline's µs; with ``main_run``
    (the family's run of the main path's requests) also ``_turns``; the
    cache is emptied after, so later phases keep the miss defaults."""
    loop = main_loop(params, cfg, **kw)
    t0 = time.perf_counter()
    tuned = loop.tune()
    secs = time.perf_counter() - t0
    del loop
    _log_tuned(tuned, secs, cfg)
    if main_run is not None:
        _turns(cfg, params, main_run)
    _fresh_autotune_cache()
    _free()
    return tuned


# ---------------------------------------------------------------------------
# the int8 layout's expert stacks: one launch of the int8 expert kernel
# ---------------------------------------------------------------------------

INT8_MOE_LAYERS = 5      # depth cut of int8 moe-gqa: the 3 dense + 2 MoE


def phase_int8_experts(B_a=3):
    """moe-gqa in the int8 serve layout (deepseek-v3's widths, GQA
    blocks), cut to 3 dense + 2 MoE layers (an int8 MoE layer's experts
    are 11.3 GB): one MoE layer's expert stacks wi, wg and wo (256
    experts) held int32-equal, at M 4 (a decode step) and 2 (a chunk), to
    the plain twin (each expert's f64 product) and to a per-expert
    ``torch._int_mm`` loop; wi at M 4 timed (graph replay) against its
    byte bound, its plain twin and the loop (the yardstick: no one
    PyTorch call takes a batched int8 product); then four requests x 16
    tokens served through ``PagedServeLoop`` from CUDA graphs, the kernel
    launched once per expert stack (three a MoE layer) a forward,
    asserted.  Returns the kernel's JSON row."""
    import torch

    from repro_torch.kernels import int8_experts as I8

    cfg = dataclasses.replace(moe_config(INT8_MOE_LAYERS), serve_impl="int8",
                              name="deepseek-v3-671b moe-gqa int8")
    E, d, F = cfg.n_experts, cfg.d_model, cfg.d_expert
    log(f"  reckoning: an int8 MoE layer's expert stacks {E} x 3 x {d} x "
        f"{F} B = {3 * E * d * F / 1e9:.2f} GB")
    params = init_family(cfg, cut=f"cut from 61: {cfg.moe_layer_start} "
                                  f"dense + {INT8_MOE_LAYERS - cfg.moe_layer_start} MoE")
    _calibrate_int8(params)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    layer = params.layers(1)[0]["b0"]["moe"]
    n0 = I8.launches
    row = None
    for name in ("wi", "wg", "wo"):
        w8 = layer[name]["w8"]
        _, K, N = w8.shape
        for M in MOE_MS:
            aq = torch.randint(-127, 128, (E, M, K), dtype=torch.int8,
                               generator=gen, device=DEV)
            got = I8.int8_experts_matmul(aq, w8)
            want = I8.int8_experts_matmul_plain(aq, w8)
            _equal(f"int8 expert stack {name} [{E}] {K}->{N} M={M}", got,
                   want)
            if DEV == "cuda":
                _equal(f"int8 expert stack {name} M={M} vs _int_mm loop",
                       I8.int8_experts_loop(aq, w8), want)
            del want
            if DEV != "cuda" or name != "wi" or M != 4:
                continue
            ms = graph_ms(lambda: I8.int8_experts_matmul(aq, w8), iters=10,
                          replays=3)
            loop_ms = graph_ms(lambda: I8.int8_experts_loop(aq, w8), iters=2,
                               replays=2)
            plain_ms = cuda_ms(lambda: I8.int8_experts_matmul_plain(aq, w8),
                               iters=2, warmup=1)
            nbytes = E * (M * K + K * N + 4 * M * N)
            t_b = nbytes / HBM_BYTES_S * 1e3      # int8 products: tensor peak
            t_o = 2 * E * M * K * N / INT8_TC_OPS_S * 1e3
            b = dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)
            row = dict(name="int8_experts", route="cuda",
                       source="src/repro_torch/csrc/int8_experts.cu",
                       replaces="none: the reference's int8 expert stacks "
                                "are a jax.vmap of dot_general "
                                "(src/repro/models/nn.py:406)",
                       shape=f"one MoE layer's wi [{E}] {K}->{N} at M={M}",
                       max_abs_err=0, ms=ms, plain_ms=plain_ms,
                       bound_ms=b["bound_ms"], bound_by=_bound_by(b),
                       library_ms=None, int_mm_loop_ms=loop_ms)
            log(f"  int8 expert stack wi [{E}] {K}->{N} M={M}: kernel "
                f"{ms:.4f} ms (one launch), bound {b['bound_ms']:.4f} ms "
                f"({_bound_by(b)}, {b['bound_ms'] / ms:.1%} of bound), "
                f"plain (per-expert f64) {plain_ms:.3f} ms, {E} _int_mm "
                f"launches {loop_ms:.4f} ms")
        log(f"  int8 expert stack {name} [{E}] {K}->{N}: equal int32 to the "
            f"plain twin and the _int_mm loop at M "
            f"{', '.join(map(str, MOE_MS))}")
    I8.launches = n0                      # comparisons are not the path's
    counts, run = phase_main(cfg, params, lens=MAIN_LENS,
                             max_new=FAMILY_MAX_NEW)
    forwards = run["forwards"]
    stacks = 3 * (INT8_MOE_LAYERS - cfg.moe_layer_start)
    if DEV == "cuda":
        assert counts["int8_experts"] == stacks * forwards, (counts, stacks)
    log(f"  int8 expert kernel launches {counts['int8_experts']} (= {stacks} "
        f"stacks a forward x {forwards} forwards)")
    del params, layer
    _free()
    if row is not None:
        row["launches"] = counts["int8_experts"]
    return row


# ---------------------------------------------------------------------------
# MLA: deepseek-v3 and kimi-k2 with their own attention, dense ServeLoop
# ---------------------------------------------------------------------------

MLA_CUTS = {"deepseek-v3-671b": 11,   # the 3 dense + 8 MoE of 61, as moe-gqa
            "kimi-k2-1t-a32b": 5}     # the 1 dense + 4 MoE of 61
MLA_S_MAX = 1024
MLA_LINEARS = ("wq_a", "wq_b", "wkv_a", "wo")   # kernel 1's in an MLA block
# rows kernel 1 sees in the MLA run: a decode step of 4 slots, the prefill
# of the four prompts left-padded to the longest
MLA_LINEAR_MS = (4, len(MAIN_LENS) * max(MAIN_LENS))


def _serve_dense(params, cfg, reqs, s_max=MLA_S_MAX, profiled=False):
    """``reqs`` through the dense ``ServeLoop`` (four slots, caches of
    ``s_max``), every prefill and decode step timed on the host around a
    synchronised call.  With ``profiled``, decode step ``PROFILED_STEP``
    runs under torch.profiler instead (``_profiled`` prints its device
    time by kernel) and is kept out of the timings.  Returns (done,
    prefill ms, decode ms)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve.loop import ServeLoop

    times = {"prefill": [], "decode_step": []}
    real = {n: getattr(lm, n) for n in times}
    calls = {n: 0 for n in times}

    def timed(name):
        def wrapper(*a, **kw):
            calls[name] += 1
            if (profiled and DEV == "cuda" and name == "decode_step"
                    and calls[name] == PROFILED_STEP + 1):
                out = _profiled(real[name], a, kw)
            else:
                if DEV == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = real[name](*a, **kw)
                if DEV == "cuda":
                    torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
            if not bool(torch.isfinite(out[0]).all()):
                raise AssertionError(f"non-finite logits in {name}")
            return out
        return wrapper

    loop = ServeLoop(params, cfg, batch_slots=4, s_max=s_max, device=DEV)
    for r in reqs:
        loop.submit(r)
    try:
        for n in times:
            setattr(lm, n, timed(n))
        done = loop.run()
    finally:
        for n, f in real.items():
            setattr(lm, n, f)
    return done, times["prefill"], times["decode_step"], calls


def phase_mla(name: str):
    """``name`` (deepseek-v3-671b or kimi-k2-1t-a32b) with its MLA blocks
    at full width, cut in layers (``MLA_CUTS``; the ``plan_shapes``
    reckoning printed at 61 and at the cut), drawn on the card (init peak
    asserted), then the main path's four prompts x 16 tokens served
    through the dense ``ServeLoop`` (MLA does not page, as in the
    reference): prefill through ``mla_train``, decode through the absorbed
    ``mla_decode`` on latent caches; kernel 1 launched once per lookup
    linear (three expert stacks a MoE layer) a forward, asserted, and no
    flash-decode.  Before the run, kernel 1 is held int32-equal to its
    plain version at the block's own lookup linears (``MLA_LINEARS``, from
    the drawn params) at the run's rows (``MLA_LINEAR_MS``), and at one
    MoE layer's expert stacks at M 4.  Prints the decode step, prefill
    tok/s, params, init and run peak and kernel 1's launches; returns
    them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    L = MLA_CUTS[name]
    cfg = dataclasses.replace(get_config(name), n_layers=L)
    moe_reckoning(cfg)
    params = init_family(cfg, cut=f"cut from 61: {cfg.moe_layer_start} "
                                  f"dense + {L - cfg.moe_layer_start} MoE")
    total = _tree_bytes(params)
    B_a, G = cfg.quant.a_bits, cfg.tlmac_G
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    n0, e0 = tf.launches, tf.expert_launches
    blk = params.layers(0)[0]["b0"]["attn"]
    _single_linears_equal({f"MLA attn.{n}": blk[n] for n in MLA_LINEARS},
                          MLA_LINEAR_MS, gen, B_a, G)
    moe = params.layers(1)[0]["b0"]["moe"]
    for n in ("wi", "wg", "wo"):
        idx, cl, tab = (moe[n][k] for k in ("exec_idx", "step_cluster",
                                            "table_narrow"))
        E, nt, kg, dp = idx.shape
        aq = torch.randint(0, 2**B_a, (E, 4, kg * G), dtype=torch.int8,
                           generator=gen, device=DEV)
        _equal(f"expert-stacked lookup GEMM {n} [{E}]",
               tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G),
               tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G))
        log(f"  expert-stacked lookup GEMM moe.{n} [{E}] {kg * G}->"
            f"{nt * dp} (dp {dp}): equal int32 at M 4")
    del aq
    tf.launches, tf.expert_launches = n0, e0   # comparisons are not the path's
    reqs = _requests(cfg.vocab, MAIN_LENS, FAMILY_MAX_NEW, SEED)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tf.launches = tf.expert_launches = fd.launches = 0
    t0 = time.perf_counter()
    done, pre, dec, _ = _serve_dense(params, cfg, reqs)
    wall = time.perf_counter() - t0
    per_fwd, per_fwd_expert = _lookup_launches(params)
    forwards = len(pre) + len(dec)
    assert len(done) == len(reqs)
    for r in done:
        assert len(r.output) == FAMILY_MAX_NEW, (r.rid, len(r.output))
        assert 0 <= int(r.output.min()) and int(r.output.max()) < cfg.vocab
    if DEV == "cuda":
        assert tf.launches == per_fwd * forwards, (tf.launches, per_fwd)
        assert tf.expert_launches == per_fwd_expert * forwards
        assert fd.launches == 0
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    prompt = len(reqs) * max(MAIN_LENS)      # left-padded to the longest
    log(f"  {cfg.name} MLA served {len(done)} requests x {FAMILY_MAX_NEW} "
        f"tokens through the dense ServeLoop in {wall:.2f} s: {len(pre)} "
        f"prefill (4 x {max(MAIN_LENS)} left-padded), {len(dec)} decode "
        f"steps; decode step median {_median(dec):.2f} ms (min "
        f"{min(dec):.2f}, max {max(dec):.2f}; eager, host clock around a "
        f"synchronised step); prefill {sum(MAIN_LENS) / (sum(pre) / 1e3):.1f}"
        f" prompt tok/s ({prompt / (sum(pre) / 1e3):.1f} padded); params "
        f"{total / 2**30:.3f} GiB, run peak {peak / 2**30:.3f} GiB; kernel "
        f"1 launches {tf.launches} (= {per_fwd} a forward x {forwards}, "
        f"{tf.expert_launches} expert stacks)")
    out = dict(decode_ms=_median(dec), prefill_tok_s=sum(MAIN_LENS)
               / (sum(pre) / 1e3), params_gib=total / 2**30,
               run_peak_gib=peak / 2**30, launches=tf.launches)
    tf.launches = tf.expert_launches = fd.launches = 0
    del params, done
    _free()
    return out


def _dense_loop_card_vs_cpu(params, cfg, seed):
    """``params`` (on the CPU) served through the dense ``ServeLoop`` on
    the CPU (five requests in two slots, s_max 48: refills), then the
    same requests on the card teacher-forced with the CPU run's logits.
    Returns (max |dlogit| of card against CPU, the CPU logits)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve.loop import ServeLoop

    reqs = lambda: _requests(cfg.vocab, (6, 11, 3, 9, 5), 6, seed)
    rec = []
    real = {n: getattr(lm, n) for n in ("prefill", "decode_step")}
    worst = 0.0
    try:
        for n in real:
            setattr(lm, n, (lambda f: lambda *a, **kw: rec.append(
                f(*a, **kw)) or rec[-1])(real[n]))
        loop = ServeLoop(params, cfg, batch_slots=2, s_max=48, device="cpu")
        for r in reqs():
            loop.submit(r)
        loop.run()
        want = [lg.float() for lg, _ in rec]
        it = iter(want)

        def forced(f):
            def wrapper(*a, **kw):
                nonlocal worst
                lg, c = f(*a, **kw)
                w = next(it)
                worst = max(worst, (lg.float().cpu() - w).abs().max().item())
                return w.to(lg.dtype).to(DEV), c
            return wrapper

        for n in real:
            setattr(lm, n, forced(real[n]))
        loop = ServeLoop(params.to(DEV), cfg, batch_slots=2, s_max=48,
                         device=DEV)
        for r in reqs():
            loop.submit(r)
        loop.run()
    finally:
        for n, f in real.items():
            setattr(lm, n, f)
    return worst, want


def phase_mla_reference(seed: int = SEED):
    """The MLA smoke configs (deepseek-v3's and kimi-k2's) on the card
    against the port on the CPU, through the dense ``ServeLoop``,
    teacher-forced: logits within ``LOGIT_TOL`` of the scale."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    for name in MLA_CUTS:
        cfg = smoke_config(name)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        worst, want = _dense_loop_card_vs_cpu(params, cfg, seed)
        scale = max(w.abs().max().item() for w in want)
        if not worst <= LOGIT_TOL * scale:
            raise AssertionError(f"{name} MLA smoke: card vs CPU logits "
                                 f"differ by {worst} > {LOGIT_TOL} x {scale}")
        log(f"  {name} MLA smoke: {len(want)} teacher-forced dense forwards, "
            f"card vs CPU max |dlogit| {worst:.3e} (scale {scale:.3f}, "
            f"tolerance {LOGIT_TOL} x scale)")


# ---------------------------------------------------------------------------
# the recurrent and enc-dec families, mistral-large at full width
# ---------------------------------------------------------------------------

# family: (prompt lengths, s_max) of its dense ServeLoop run, 16 new tokens
RECURRENT_RUNS = {
    # left-padded to 2100: every slot's position passes the 2048 window,
    # so the attn_local ring buffers wrap
    "recurrentgemma-2b": ((53, 144, 227, 2100), 2304),
    # left-padded to 256, a multiple of the xLSTM scan's chunk of 64, in
    # four slots: no refill reaches a length the reference's scan refuses
    "xlstm-350m": ((53, 144, 227, 256), 512),
}
ENC_FRAMES = 512         # seamless: seeded frames [4, 512, 1024]
ENC_PROMPT = 16          # four target prompts of 16 tokens
ENC_STEPS = 32           # greedy decode steps after the prefill
CONT_S = {"recurrentgemma-2b": 63, "xlstm-350m": 63,
          "seamless-m4t-medium": 16}
CONT_TOL = 2e-2          # tests/test_models_smoke.py's rtol = atol


def _block_linear_shapes(kind, cfg):
    """The lookup linears ``(K, N)`` of one block of ``kind`` and the
    element count of its f32 leaves (gates, convs, recurrences, norms)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    attn = [(d, H * hd), (d, KV * hd), (d, KV * hd), (H * hd, d)]
    ffn = ([(d, cfg.d_ff)] * (2 if cfg.act == "swiglu" else 1)
           + [(cfg.d_ff, d)])
    if kind == "mlstm":
        i = 2 * d
        return [(d, 2 * i), (i, i), (i, i), (i, i), (i, d)], (
            cfg.conv_width * i + 2 * i * H + H + d)
    if kind == "slstm":
        return [(d, 4 * d), (d, d), (d, d)], 4 * H * (d // H) ** 2 + 5 * d
    if kind == "rglru":
        lru = cfg.lru_dim or d
        return [(d, lru), (d, lru), (lru, d)] + ffn, (
            cfg.conv_width * lru + 2 * lru * lru + lru + 2 * d)
    extra = attn if kind == "dec_cross" else []
    return attn + extra + ffn, (3 if kind == "dec_cross" else 2) * d


def serve_reckoning(cfg):
    """Print the serve params' bytes by ``plan_shapes`` before the model is
    drawn: each lookup linear's index bytes, the f32 leaves and the bf16
    embedding (and head); returns the total."""
    from repro_torch.models import lm

    segs = list(lm.segments_for(cfg))
    if cfg.n_enc_layers:
        segs.append(lm.Segment(("enc_attn",), cfg.n_enc_layers))
    idx = f32 = n_lin = 0
    n_arr = set()
    for seg in segs:
        for kind in seg.pattern:
            shapes, n32 = _block_linear_shapes(kind, cfg)
            for K, N in shapes:
                b, na = _idx_bytes(cfg, K, N)
                idx += seg.n * b
                n_arr.add(na)
            n_lin += seg.n * len(shapes)
            f32 += seg.n * n32 * 4
    emb = (1 + (not cfg.tie_embeddings)) * (
        cfg.vocab + (-cfg.vocab) % 16) * cfg.d_model * 2
    total = idx + f32 + emb
    log(f"  plan_shapes reckoning of {cfg.name}: {n_lin} lookup linears, "
        f"indices {idx / 2**30:.3f} GiB (N_arr {sorted(n_arr)}), f32 leaves "
        f"{f32 / 2**30:.3f} GiB, embedding{'' if cfg.tie_embeddings else ' + head'}"
        f" {emb / 2**30:.3f} GiB: {total / 2**30:.3f} GiB before tables and "
        "steps")
    return total


def _linears_by_shape(params, cfg):
    """One lookup linear of the drawn params per distinct ``(K, N)`` (the
    first layer of every segment, and of the encoder): ``{label: params}``
    as ``_single_linears_equal`` takes them."""
    found = {}

    def walk(tree, path):
        if "table" in tree:
            nt, kg, dp = tree["exec_idx"].shape
            found.setdefault((kg * cfg.tlmac_G, nt * dp),
                             (".".join(path), tree))
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])

    stacks = [("segments", si) for si in range(len(params.segments))]
    if cfg.n_enc_layers:
        stacks.append(("encoder", 0))
    for stack, si in stacks:
        walk(params.layers(si, stack)[0], [f"{stack}[{si}]"])
    return {label: lin for label, lin in found.values()}


def _tables(tree) -> int:
    """Lookup linears (TLMAC tables) in a param tree."""
    if "table" in tree:
        return 1
    return sum(_tables(v) for v in tree.values() if isinstance(v, dict))


def _continuation(params, cfg, frames=None):
    """The reference's decode-continues-prefill check
    (``tests/test_models_smoke.py``) on the card at full width: prefill(S)
    then one decode step against prefill(S + 1), within ``CONT_TOL``
    relative and absolute."""
    import torch

    from repro_torch.models import lm

    S = CONT_S[cfg.name]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 61)
    toks = torch.randint(0, cfg.vocab, (1, S + 1), generator=gen, device=DEV)
    kw = {} if frames is None else {"frames": frames[:1]}
    _, caches = lm.prefill(params, toks[:, :S], cfg, S_max=S + 8, **kw)
    lb, _ = lm.decode_step(params, caches, toks[:, S:], S, cfg)
    lf, _ = lm.prefill(params, toks, cfg, S_max=S + 8, **kw)
    lb, lf = lb.float(), lf.float()
    d = (lb - lf).abs()
    if not bool((d <= CONT_TOL + CONT_TOL * lf.abs()).all()):
        raise AssertionError(f"{cfg.name}: decode after prefill({S}) differs "
                             f"from prefill({S + 1}) by {d.max().item()}")
    log(f"  decode continues prefill: prefill({S}) + one decode step vs "
        f"prefill({S + 1}): max |dlogit| {d.max().item():.3e} (logits max "
        f"{lf.abs().max().item():.3f}; rtol = atol = {CONT_TOL}), equal "
        f"argmax {bool(lb.argmax() == lf.argmax())}")


def _family_kernel_checks(params, cfg, Ms, frames=None):
    """Kernel 1 int32-equal to its plain version at every lookup linear
    shape of the drawn model at the rows ``Ms``, then the continuation
    check; the comparisons' launches are taken back out."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    n0, e0, f0 = tf.launches, tf.expert_launches, fd.launches
    gen = torch.Generator(device=DEV).manual_seed(SEED + 43)
    _single_linears_equal(_linears_by_shape(params, cfg), Ms, gen,
                          cfg.quant.a_bits, cfg.tlmac_G)
    _continuation(params, cfg, frames)
    tf.launches, tf.expert_launches, fd.launches = n0, e0, f0


def phase_recurrent(name: str):
    """``name`` (recurrentgemma-2b or xlstm-350m) at full width and depth:
    its ``plan_shapes`` reckoning, drawn on the card (init peak asserted),
    kernel 1 int32-equal to its plain version at every lookup linear
    shape (M 4 and the prefill's rows), decode continuing prefill, then
    four requests x 16 tokens through the dense ``ServeLoop``
    (``RECURRENT_RUNS``; recurrent states, the attn_local ring buffer),
    one decode step profiled; kernel 1 launched once per lookup linear a
    forward (asserted), no flash-decode.  Returns the run's figures."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    cfg = get_config(name)
    lens, s_max = RECURRENT_RUNS[name]
    serve_reckoning(cfg)
    params = init_family(cfg)
    total = _tree_bytes(params)
    _family_kernel_checks(params, cfg, (4, len(lens) * max(lens)))
    reqs = _requests(cfg.vocab, lens, FAMILY_MAX_NEW, SEED)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tf.launches = tf.expert_launches = fd.launches = 0
    t0 = time.perf_counter()
    done, pre, dec, calls = _serve_dense(params, cfg, reqs, s_max=s_max,
                                         profiled=True)
    wall = time.perf_counter() - t0
    per_fwd, _ = _lookup_launches(params)
    forwards = calls["prefill"] + calls["decode_step"]
    assert len(done) == len(reqs)
    for r in done:
        assert len(r.output) == FAMILY_MAX_NEW, (r.rid, len(r.output))
        assert 0 <= int(r.output.min()) and int(r.output.max()) < cfg.vocab
    launches = tf.launches
    if DEV == "cuda":
        assert launches == per_fwd * forwards, (launches, per_fwd, forwards)
        assert fd.launches == 0
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    padded = len(reqs) * max(lens)
    tok_s = sum(lens) / (sum(pre) / 1e3)
    log(f"  {cfg.name} served {len(done)} requests x {FAMILY_MAX_NEW} "
        f"tokens through the dense ServeLoop (s_max {s_max}) in {wall:.2f} "
        f"s: {calls['prefill']} prefill (4 x {max(lens)} left-padded), "
        f"{calls['decode_step']} decode steps; decode step median "
        f"{_median(dec):.2f} ms (min {min(dec):.2f}, max {max(dec):.2f}; "
        f"eager, host clock around a synchronised step); prefill "
        f"{tok_s:.1f} prompt tok/s ({padded / (sum(pre) / 1e3):.1f} padded; "
        f"{sum(pre):.0f} ms); params {total / 2**30:.3f} GiB, run peak "
        f"{peak / 2**30:.3f} GiB; kernel 1 {launches} launches (= {per_fwd} "
        f"a forward x {forwards})")
    out = dict(decode_ms=_median(dec), prefill_tok_s=tok_s,
               params_gib=total / 2**30, run_peak_gib=peak / 2**30,
               launches=launches, per_forward=per_fwd)
    tf.launches = tf.expert_launches = fd.launches = 0
    del params, done
    _free()
    return out


def phase_encdec():
    """seamless-m4t-medium at full width and depth (12 encoder + 12
    decoder layers): reckoning, drawn on the card (init peak asserted),
    kernel 1 int32-equal at every lookup linear shape (M 4, the decoder
    prefill's 64 rows and the encoder's 2048), decode continuing prefill,
    then seeded frames ``[4, 512, 1024]`` and four 16-token prompts
    through ``lm.prefill(tokens, frames=...)`` (the encoder, then the
    decoder with its cross K/V cached) and 32 greedy ``decode_step``s,
    one profiled.  Kernel 1's launches are asserted: the encoder's
    linears, the decoder's plus each ``xattn``'s ``wk``/``wv`` over the
    encoder output at the prefill, the decoder's a step (``xattn``'s
    ``wk``/``wv`` included: the reference computes and drops them).
    Returns the run's figures."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.models import lm

    cfg = get_config("seamless-m4t-medium")
    serve_reckoning(cfg)
    params = init_family(cfg)
    total = _tree_bytes(params)
    B = 4
    gen = torch.Generator(device=DEV).manual_seed(SEED + 71)
    frames = torch.randn((B, ENC_FRAMES, 1024), generator=gen, device=DEV)
    toks = torch.randint(0, cfg.vocab, (B, ENC_PROMPT), generator=gen,
                         device=DEV)
    _family_kernel_checks(params, cfg, (4, B * ENC_PROMPT, B * ENC_FRAMES),
                          frames)
    enc_fwd = _tables(params.layers(0, "encoder")[0]) * cfg.n_enc_layers
    dec_fwd, _ = _lookup_launches(params)
    want_prefill = enc_fwd + dec_fwd + 2 * cfg.n_layers

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tf.launches = tf.expert_launches = fd.launches = 0
    sync()
    t = time.perf_counter()
    logits, caches = lm.prefill(params, toks, cfg,
                                S_max=ENC_PROMPT + ENC_STEPS, frames=frames)
    sync()
    pre_ms = (time.perf_counter() - t) * 1e3
    pre_launches = tf.launches
    out_toks = [logits.argmax(-1)]
    dec = []
    for step in range(ENC_STEPS):
        cur = out_toks[-1][:, None]
        if step == PROFILED_STEP and DEV == "cuda":
            logits, caches = _profiled(lm.decode_step, (
                params, caches, cur, ENC_PROMPT + step, cfg), {})
        else:
            sync()
            t = time.perf_counter()
            logits, caches = lm.decode_step(params, caches, cur,
                                            ENC_PROMPT + step, cfg)
            sync()
            dec.append((time.perf_counter() - t) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits in a seamless decode step")
        out_toks.append(logits.argmax(-1))
    gen_toks = torch.stack(out_toks[:ENC_STEPS], dim=1).cpu().numpy()
    assert gen_toks.shape == (B, ENC_STEPS)
    assert 0 <= int(gen_toks.min()) and int(gen_toks.max()) < cfg.vocab
    dec_launches = tf.launches - pre_launches
    if DEV == "cuda":
        assert pre_launches == want_prefill, (pre_launches, want_prefill)
        assert dec_launches == dec_fwd * ENC_STEPS, (dec_launches, dec_fwd)
        assert fd.launches == 0
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    n_in = B * (ENC_FRAMES + ENC_PROMPT)
    log(f"  {cfg.name}: prefill of {B} x {ENC_FRAMES} frames + {B} x "
        f"{ENC_PROMPT} tokens (encoder, then the decoder with the cross K/V "
        f"cached) {pre_ms:.1f} ms = {n_in / (pre_ms / 1e3):.1f} tok/s "
        f"(frames + tokens), then {ENC_STEPS} greedy decode steps: median "
        f"{_median(dec):.2f} ms (min {min(dec):.2f}, max {max(dec):.2f}; "
        f"eager, host clock around a synchronised step); distinct tokens "
        f"{len(np.unique(gen_toks))}; params {total / 2**30:.3f} GiB, run "
        f"peak {peak / 2**30:.3f} GiB; kernel 1 {pre_launches} launches at "
        f"the prefill (= encoder {enc_fwd} + decoder {dec_fwd} + cross K/V "
        f"{2 * cfg.n_layers}), {dec_launches} at decode (= {dec_fwd} a step "
        f"x {ENC_STEPS})")
    out = dict(decode_ms=_median(dec), prefill_tok_s=n_in / (pre_ms / 1e3),
               params_gib=total / 2**30, run_peak_gib=peak / 2**30,
               launches=pre_launches + dec_launches, per_forward=dec_fwd)
    tf.launches = tf.expert_launches = fd.launches = 0
    del params, caches
    _free()
    return out


def phase_mistral():
    """mistral-large-123b at full width and depth (88 layers, 12288, 96
    heads over 8, d_ff 28672): its ``plan_shapes`` reckoning, drawn on
    the card (init peak = the params + at most one layer, asserted),
    kernel 1 int32-equal to its plain version at its four linear shapes
    (M 4 and a chunk's 64 rows) and kernel 2 within ``FLASH_TOL`` at its
    decode shape (12 query heads over each of 8 KV heads, hd 128; fp and
    int8 pools), then the main path (``PagedServeLoop``, both forwards as
    CUDA graphs, launches asserted) over the families' four prompts x 16
    tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf

    cfg = get_config("mistral-large-123b")
    serve_reckoning(cfg)
    params = init_family(cfg)
    n0, e0, f0 = tf.launches, tf.expert_launches, fd.launches
    gen = torch.Generator(device=DEV).manual_seed(SEED + 81)
    _single_linears_equal(_linears_by_shape(params, cfg), (4, CHUNK), gen,
                          cfg.quant.a_bits, cfg.tlmac_G)
    if DEV == "cuda":
        for kv in ("fp", "int8"):
            a = _flash_case(gen, kv, B=4, KV=cfg.n_kv,
                            rep=cfg.n_heads // cfg.n_kv, hd=cfg.kv_head_dim,
                            P=16, MB=64, lens=MAIN_LENS, window=None,
                            n_splits=4)
            err = (_flash_kernel(a) - _flash_plain(a)).abs().max().item()
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash-decode {kv} at mistral's shape: "
                                     f"max abs err {err} > {FLASH_TOL}")
            log(f"  flash-decode {kv:4s} rep{cfg.n_heads // cfg.n_kv} hd"
                f"{cfg.kv_head_dim} KV{cfg.n_kv} (mistral-large): max abs "
                f"err {err:.3e}")
            del a
    tf.launches, tf.expert_launches, fd.launches = n0, e0, f0
    counts, run = phase_main(cfg, params, lens=MAIN_LENS,
                             max_new=FAMILY_MAX_NEW)
    del params
    _free()
    return counts, run


def phase_dense_reference(seed: int = SEED):
    """The recurrent and enc-dec smoke configs on the card against the
    port on the CPU, teacher-forced, logits within ``LOGIT_TOL`` of the
    scale: xlstm-350m and recurrentgemma-2b through the dense
    ``ServeLoop`` (five requests in two slots: refills), seamless through
    ``lm.prefill(tokens, frames=...)`` and eight decode steps."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    for name in ("xlstm-350m", "recurrentgemma-2b", "seamless-m4t-medium"):
        cfg = smoke_config(name)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        if cfg.n_enc_layers:
            g = torch.Generator().manual_seed(seed + 1)
            frames = torch.randn((2, 12, 1024), generator=g)
            toks = torch.randint(0, cfg.vocab, (2, 9), generator=g)
            want, steps = [], []
            lg, c = lm.prefill(params, toks, cfg, S_max=24, frames=frames)
            want.append(lg.float())
            for pos in range(9, 17):
                steps.append(want[-1].argmax(-1)[:, None])
                lg, c = lm.decode_step(params, c, steps[-1], pos, cfg)
                want.append(lg.float())
            gp = params.to(DEV)
            lg, c = lm.prefill(gp, toks.to(DEV), cfg, S_max=24,
                               frames=frames.to(DEV))
            got = [lg.float().cpu()]
            for pos, cur in zip(range(9, 17), steps):
                lg, c = lm.decode_step(gp, c, cur.to(DEV), pos, cfg)
                got.append(lg.float().cpu())
            worst = max((g - w).abs().max().item() for g, w in zip(got, want))
            n = len(want)
        else:
            worst, want = _dense_loop_card_vs_cpu(params, cfg, seed)
            n = len(want)
        scale = max(w.abs().max().item() for w in want)
        if not worst <= LOGIT_TOL * scale:
            raise AssertionError(f"{name} smoke: card vs CPU logits differ by "
                                 f"{worst} > {LOGIT_TOL} x {scale}")
        log(f"  {name} smoke: {n} teacher-forced dense forwards, card vs CPU "
            f"max |dlogit| {worst:.3e} (scale {scale:.3f}, tolerance "
            f"{LOGIT_TOL} x scale)")


# ---------------------------------------------------------------------------
# card vs CPU on the smoke configs
# ---------------------------------------------------------------------------


def phase_reference(seed: int = SEED):
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.paged import PagedServeLoop

    # every family reads with kernel 2, minicpm's smoke at head dim 18 too;
    # the MoE family is deepseek-v3's smoke with GQA (the reference's
    # moe-gqa), its expert linears through kernel 1's expert axis
    moe_gqa = dataclasses.replace(smoke_config("deepseek-v3-671b"),
                                  attn_kind="gqa", name="ds-moe-gqa")
    for name in ("codeqwen1.5-7b", "mistral-large-123b", "minicpm-2b",
                 "command-r-35b", "internvl2-76b", "moe-gqa"):
        cfg = moe_gqa if name == "moe-gqa" else smoke_config(name)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        reqs = lambda: _requests(cfg.vocab, (6, 11, 3, 9, 5), 6, seed)
        kw = dict(batch_slots=2, s_max=48, page_size=8, chunk=8)
        ref = PagedServeLoop(params, cfg, device="cpu", **kw)
        rec = []
        for kind in ("_prefill_chunk", "_decode"):
            fn = getattr(ref, kind)
            setattr(ref, kind, (lambda f: lambda *a: rec.append(f(*a))
                                or rec[-1])(fn))
        for r in reqs():
            ref.submit(r)
        ref.run()
        gpu = PagedServeLoop(params.to("cuda"), cfg, device="cuda", **kw)
        it = iter(rec)
        worst = 0.0

        def forced(f):
            def wrapper(*a):
                nonlocal worst
                got = f(*a).float().cpu()
                want = next(it)
                worst = max(worst, (got - want.float()).abs().max().item())
                return want.to("cuda")          # teacher forcing
            return wrapper

        gpu._prefill_chunk = forced(gpu._prefill_chunk)
        gpu._decode = forced(gpu._decode)
        for r in reqs():
            gpu.submit(r)
        gpu.run()
        scale = max(w.float().abs().max().item() for w in rec)
        if not worst <= LOGIT_TOL * scale:
            raise AssertionError(f"{name} smoke: card vs CPU logits differ by "
                                 f"{worst} > {LOGIT_TOL} x {scale}")
        log(f"  {name} smoke (hd {cfg.kv_head_dim}): {len(rec)} "
            f"teacher-forced forwards, card vs CPU max |dlogit| {worst:.3e} "
            f"(scale {scale:.3f}, tolerance {LOGIT_TOL} x scale)")


def phase_cli():
    """The port's serving CLI as a user runs it (``python -m
    repro_torch.launch.serve --arch xlstm-350m``: full-width xlstm-350m,
    eight requests of 4-16 prompt tokens x 16 new tokens in four slots of
    the dense ``ServeLoop``), every request finished with its tokens."""
    from repro_torch.launch import serve as cli

    t = time.perf_counter()
    done = cli.main(["--arch", "xlstm-350m", "--device", DEV])
    assert sorted(r.rid for r in done) == list(range(8)), len(done)
    for r in done:
        assert len(r.output) == 16, (r.rid, len(r.output))
    log(f"  the CLI served {len(done)} requests x 16 tokens in "
        f"{time.perf_counter() - t:.2f} s (init included)")


# ---------------------------------------------------------------------------
# the training stack: QAT of a dense decoder and of ResNet-18, the trained
# weights compiled back onto the lookup kernels
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm-2b"
TRAIN_LAYERS = 10       # of 40: cut for the script's time limit
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 6, 1024, 4
TRAIN_PROFILED_STEP = TRAIN_STEPS - 1   # profiled; left out of the median
TRAIN_LOSS_RTOL = 1e-2        # card vs CPU: bf16 GEMMs summed in other
TRAIN_GNORM_RTOL = 5e-2       # orders; a flipped 3-bit code moves a sum
CAL_DELTAS, CAL_OUT_STEP = -2.0, 0.1   # tests/test_torch_train.py's
TRAINED_LINEAR_MS = (4, 64)
PREEMPT_STEPS, PREEMPT_AT, PREEMPT_EVERY = 8, 5, 3
PREEMPT_TOL = 1e-5            # tests/test_substrates.py:178
RESNET_QAT_STEPS, RESNET_QAT_LR, RESNET_QAT_BATCH = 10, 0.05, 32
TRAINED_CONVS = ("block0.conv1", "block7.conv2")
# (f): each other family's smoke, card vs CPU (recurrentgemma at window 8,
# so the window bites at S 32; deepseek with the full config's int8
# moments, its dense FFN 256 wide so that some moments are int8 blocks)
TRAIN_SMOKES = (
    ("recurrentgemma-2b", dict(local_window=8)),
    ("xlstm-350m", {}),
    ("seamless-m4t-medium", {}),
    ("deepseek-v3-671b", dict(opt_state_dtype="int8", d_ff=256)),
    ("deepseek-v3-671b", dict(attn_kind="gqa", name="moe-gqa")),
    ("kimi-k2-1t-a32b", {}),
    ("internvl2-76b", {}),
)
# (g): (arch, batch, seq_len, steps, profiled step, layers kept); widths
# are never cut.  deepseek-v3-671b's 3 dense MLA layers at 4 x 1024 train
# in phase 15 (its unsharded run, with the full config's int8 moments)
TRAIN_FULL = (
    # recurrentgemma and xlstm cut in depth to keep the whole script well
    # inside its time limit: both are host bound (~1.7 and ~30 s a step at
    # full depth), and their time grows with the layers; xlstm's sequence
    # halved to 128 (its scans are a loop over time) when phase 17 added
    # its sharded step
    ("recurrentgemma-2b", 2, 1024, 4, 3, 6),
    ("xlstm-350m", 4, 128, 2, None, 8),
    ("seamless-m4t-medium", 4, 1024, 3, None, None),
)


def _calibrated(params):
    """Every N2UQ activation quantiser of ``params`` at ``CAL_DELTAS`` and
    ``CAL_OUT_STEP`` (thresholds over 0.06-0.83: at the init's 0.39-5.0
    nearly every activation sits below the first one and only the
    embeddings learn)."""
    import torch

    with torch.no_grad():
        for mod in params.modules():
            if hasattr(mod, "deltas"):
                mod.deltas.fill_(CAL_DELTAS)
                mod.out_step.fill_(CAL_OUT_STEP)
    return params


def train_reckoning(cfg, B: int, S: int, enc_len: int = 0,
                    front_len: int = 0) -> dict:
    """Bytes of the train step, from the port's own train init drawn on
    the meta device (no memory): f32 params and gradients; the AdamW
    moments (f32, or under ``opt_state_dtype='int8'`` int8 blocks with an
    f32 scale a 256 where the last dim allows, ``optim.lowbit``); the
    per-layer gradients of the largest stacked segment, held until its
    ``unbind`` backward stacks them; and the logits of ``B x S`` rows over
    the padded vocab, in bf16 and three f32 copies (the loss's cast, its
    exp, their gradient); one layer's attention score tiles under
    recompute (the blocked softmax's ``512 x 1024`` f32 tiles of every
    head: scores, probabilities and their two gradients); and an mLSTM's
    matrix memory ``[B, H, hd, hd]`` f32 about four times a step over one
    64-step chunk of the scan under recompute.  ``enc_len`` and
    ``front_len`` are printed only: the encoder's and the frontend's
    activations are small."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import lm, xlstm
    from repro_torch.models.nn import padded_vocab
    from repro_torch.optim.lowbit import q8_compatible

    with torch.device("meta"):
        params = lm.init_lm(cfg, None, purpose="train", device="meta")
    leaves = list(params.parameters())
    n = sum(p.numel() for p in leaves)
    int8 = cfg.opt_state_dtype == "int8"
    mom = sum(2 * (p.numel() + 4 * p.numel() // 256)
              if int8 and q8_compatible(p) else 8 * p.numel()
              for p in leaves)
    seg = max(sum(p.numel() for p in sp.parameters())
              for sp in params.segments) * 4
    Vp = padded_vocab(cfg.vocab)
    logits = B * S * Vp * (2 + 3 * 4)
    scan = tiles = 0
    if cfg.family == "ssm":
        hd = 2 * cfg.d_model // cfg.n_heads
        scan = min(S, xlstm.CHUNK) * B * cfg.n_heads * hd * hd * 4 * 4
    else:
        qb = min(S, A.FLASH_QB)
        tiles = -(-S // qb) * B * cfg.n_heads * qb * min(S, A.FLASH_KB) * 16
    state = 8 * n + mom
    r = dict(params=n, state_gb=state / 1e9, segment_grads_gb=seg / 1e9,
             logits_gb=logits / 1e9, tiles_gb=tiles / 1e9,
             scan_gb=scan / 1e9,
             peak_gb=(state + seg + logits + tiles + scan) / 1e9)
    extra = (f", {enc_len} frames" if enc_len else "") + (
        f", {front_len} front rows" if front_len else "")
    log(f"  reckoning {cfg.name} train ({cfg.n_layers} layers), batch {B} x "
        f"{S}{extra}: {n / 1e9:.3f} B params; f32 params and grads + "
        f"{'int8' if int8 else 'f32'} moments {r['state_gb']:.1f} GB; the "
        f"largest segment's per-layer grads {r['segment_grads_gb']:.1f} GB; "
        f"logits {r['logits_gb']:.1f} GB"
        + (f"; one layer's attention tiles {r['tiles_gb']:.1f} GB"
           if tiles else "")
        + (f"; one scan chunk {r['scan_gb']:.1f} GB" if scan else "")
        + "; reckoned peak at most "
        f"{r['peak_gb']:.1f} GB of {_card_gb():.1f} GB")
    return r


def _card_gb() -> float:
    import torch

    return (torch.cuda.get_device_properties(0).total_memory / 1e9
            if DEV == "cuda" else 0.0)


def _profiled_train_step(fn, args):
    """One train step under torch.profiler: wall, device busy (kernels'
    self time), the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn(*args)
        float(out[2]["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            n_kernels += e.count
    busy = sum(by_name.values())
    top = sorted(((v, k) for k, v in by_name.items()), reverse=True)[:6]
    return out, dict(wall_ms=wall, busy_ms=busy, kernels=n_kernels,
                     top=[(round(v, 3), k[:80]) for v, k in top])


def train_step_card_vs_cpu(cfg, seed: int = SEED) -> dict:
    """One ``make_train_step`` on a smoke ``cfg`` from the same seeded
    params (quantisers calibrated) and batch (4 x 32; frames of 16 for an
    enc-dec config, a VLM's ``front``), on the card and on the CPU, with
    ``cfg``'s AdamW state dtype: loss, gradient norm and lr within the
    stated tolerances.  Returns ``{'card': metrics, 'cpu': metrics}``."""
    import copy

    import torch

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import trainer as T

    tc = T.TrainConfig(lr=1e-3, total_steps=10, warmup_steps=2,
                       adamw=AdamWConfig(state_dtype=cfg.opt_state_dtype))
    cpu = _calibrated(lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                                 purpose="train", device="cpu"))
    card = copy.deepcopy(cpu).to(DEV)
    batch = SyntheticLMData(
        cfg.vocab, 32, 4, seed=seed,
        enc_len=16 if cfg.family == "audio" else 0, frontend=cfg.frontend,
        frontend_len=cfg.frontend_len).batch(0)
    got = {}
    for where, params in (("cpu", cpu), (DEV, card)):
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        _, _, m = T.make_train_step(cfg, tc)(
            params, adamw_init(params, tc.adamw), b, 1)
        got[where] = {k: float(v) for k, v in m.items()}
    c, g = got["cpu"], got[DEV]
    for k, tol in (("loss", TRAIN_LOSS_RTOL), ("gnorm", TRAIN_GNORM_RTOL),
                   ("lr", 1e-6)):
        if not abs(g[k] - c[k]) <= tol * abs(c[k]):
            raise AssertionError(f"{cfg.name} train step card vs CPU: {k} "
                                 f"{g[k]} vs {c[k]} (rtol {tol})")
    log(f"  make_train_step, {cfg.name} smoke ({', '.join(sorted(batch))}; "
        f"{cfg.opt_state_dtype} moments), batch 4 x 32: card loss "
        f"{g['loss']:.6f} |g| {g['gnorm']:.6f} lr {g['lr']:.3e}; CPU loss "
        f"{c['loss']:.6f} |g| {c['gnorm']:.6f} (rel "
        f"{abs(g['loss'] - c['loss']) / abs(c['loss']):.1e} / "
        f"{abs(g['gnorm'] - c['gnorm']) / abs(c['gnorm']):.1e}; rtol "
        f"{TRAIN_LOSS_RTOL} / {TRAIN_GNORM_RTOL})")
    del cpu, card
    _free()
    return dict(card=g, cpu=c)


def phase_train_card_vs_cpu(seed: int = SEED):
    """(a) ``train_step_card_vs_cpu`` on codeqwen1.5-7b's smoke.  Then the
    reference's "loss falls on a fixed batch" on the card: eight steps at
    lr 1e-2 lower the loss by 0.1."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import trainer as T

    cfg = smoke_config("codeqwen1.5-7b")
    out = train_step_card_vs_cpu(cfg, seed)
    params = lm.init_lm(cfg, torch.Generator(device=DEV).manual_seed(seed),
                        purpose="train", device=DEV)
    tc = T.TrainConfig(lr=1e-2, total_steps=10, warmup_steps=1)
    step, opt = T.make_train_step(cfg, tc), adamw_init(params, tc.adamw)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    b = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                                 device=DEV, dtype=torch.int32)}
    losses = [float(step(params, opt, b, i)[2]["loss"]) for i in range(8)]
    if not losses[-1] < losses[0] - 0.1:
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    log(f"  loss on a fixed batch, 8 steps at lr 1e-2 on the card: "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return dict(out, fixed_batch=[losses[0], losses[-1]])


def train_cli_run(arch: str, B: int, S: int, steps: int, gpu: str,
                  profiled=None, cfg=None):
    """One model at full width through the train CLI
    (``launch.train.main``, ``steps`` steps of batch ``B x S`` on the
    card): its memory reckoning, then params, init and run peaks beside
    it, every step's loss, lr and gradient norm (finite), the first step
    and the median of the later ones (the profiled step left out) and
    tokens a second; step ``profiled`` (if any) under the profiler
    (device busy share, largest kernels).  ``cfg`` replaces the arch's
    config (a cut in layers).  Returns (its figures, the trained params);
    the caller frees them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    from repro_torch.train import trainer as T

    cfg = cfg or get_config(arch)
    enc_len = S // 2 if cfg.family == "audio" else 0
    front_len = cfg.frontend_len if cfg.frontend == "patch" else 0
    reck = train_reckoning(cfg, B, S, enc_len, front_len)
    marks = {}

    class Loop(T.TrainLoop):
        """The CLI's loop, with the init's peak read and one step
        profiled."""

        def init(self, seed=0):
            _free()
            cuda = DEV == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = super().init(seed)
            if cuda:
                torch.cuda.synchronize()
            marks["init_s"] = time.perf_counter() - t
            marks["init_peak"] = torch.cuda.max_memory_allocated() if cuda \
                else 0
            marks["params"] = sum(p.numel() for p in out[0].parameters())
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            step_fn = self.step_fn

            def stepped(*a):
                if a[3] != profiled:
                    return step_fn(*a)
                out, marks["profile"] = _profiled_train_step(step_fn, a)
                return out

            self.step_fn = stepped
            return out

    cli.TrainLoop = Loop
    get = cli.get_config
    cli.get_config = lambda name: cfg
    t0 = time.perf_counter()
    try:
        loop, params = cli.main([
            "--arch", arch, "--steps", str(steps), "--seq-len", str(S),
            "--batch", str(B), "--device", DEV])
    finally:
        cli.TrainLoop, cli.get_config = T.TrainLoop, get
    if DEV == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    log_ = loop.metrics_log
    for m in log_:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["gnorm"])):
            raise AssertionError(f"{arch} step {m['step']}: loss {m['loss']} "
                                 f"|g| {m['gnorm']}")
    if len(log_) != steps:
        raise AssertionError(f"{len(log_)} steps logged, want {steps}")
    steady = [m["wall_s"] for m in log_[1:] if m["step"] != profiled]
    med = sorted(steady)[len(steady) // 2]
    prof = marks.get("profile", {})
    tokens = B * (S + enc_len + front_len)
    fig = dict(layers=cfg.n_layers, batch=[B, S], enc_len=enc_len,
               params=marks["params"], params_gib=marks["params"] * 4 / 2**30,
               init_s=marks["init_s"], init_peak_gib=marks["init_peak"] / 2**30,
               run_peak_gib=run_peak / 2**30, reckoning=reck,
               steps=[dict(step=m["step"], loss=m["loss"], lr=m["lr"],
                           gnorm=m["gnorm"], ms=m["wall_s"] * 1e3)
                      for m in log_],
               first_step_ms=log_[0]["wall_s"] * 1e3, median_step_ms=med * 1e3,
               tok_s=B * S / med, all_tok_s=tokens / med, wall_s=wall,
               busy_share=(prof["busy_ms"] / prof["wall_ms"]) if prof else None,
               profile=prof)
    if DEV == "cuda" and run_peak > torch.cuda.get_device_properties(
            0).total_memory:
        raise AssertionError(f"{arch}: run peak {run_peak} over the card")
    log(f"  {gpu}: {cfg.name} train, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, batch {B} x {S}"
        + (f" + {enc_len} frames" if enc_len else "")
        + f": {marks['params'] / 1e9:.3f} B params, {fig['params_gib']:.3f} "
        f"GiB f32; init {marks['init_s']:.1f} s, init peak "
        f"{fig['init_peak_gib']:.3f} GiB; run peak {fig['run_peak_gib']:.3f} "
        f"GiB ({run_peak / 1e9:.2f} GB; reckoned at most "
        f"{reck['peak_gb']:.1f} GB)")
    for m in fig["steps"]:
        log(f"    step {m['step']}: loss {m['loss']:.4f} lr {m['lr']:.3e} "
            f"|g| {m['gnorm']:.4f} {m['ms']:.1f} ms")
    log(f"  {gpu}: first step {fig['first_step_ms']:.1f} ms; median of the "
        f"later steps {fig['median_step_ms']:.1f} ms, {fig['tok_s']:.1f} "
        f"tokens/s" + (f" ({fig['all_tok_s']:.1f} with the frames)"
                       if enc_len else ""))
    if prof:
        log(f"  {gpu}: profiled step {profiled}: wall {prof['wall_ms']:.1f} "
            f"ms (under the profiler), device busy {prof['busy_ms']:.1f} ms "
            f"({fig['busy_share']:.1%}), {prof['kernels']} kernel launches")
        for v, k in prof["top"]:
            log(f"    {v:9.3f} ms  {k}")
    return fig, params


def phase_train_minicpm(gpu: str):
    """(b) minicpm-2b at full width, ``TRAIN_LAYERS`` of its 40 layers,
    through the train CLI (six steps, batch 4 x 1024, WSD), the last step
    profiled.  Returns (its figures, layer 0's trained ``ffn.wi`` {'w',
    'w_step'} on the CPU)."""
    fig, params = train_cli_run(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                TRAIN_STEPS, gpu,
                                profiled=TRAIN_PROFILED_STEP,
                                cfg=_cut_config(TRAIN_ARCH, TRAIN_LAYERS))
    wi = params.segments[0].b0.ffn.wi
    trained = {"w": wi.w[0].detach().float().cpu().numpy(),
               "w_step": wi.w_step[0].detach().float().cpu().numpy()}
    del params
    _free()
    return fig, trained


def phase_train_families_card_vs_cpu(seed: int = SEED):
    """(f) ``train_step_card_vs_cpu`` on each of ``TRAIN_SMOKES``."""
    from repro_torch.configs import smoke_config

    out = {}
    for arch, over in TRAIN_SMOKES:
        cfg = dataclasses.replace(smoke_config(arch), **over)
        out[cfg.name] = train_step_card_vs_cpu(cfg, seed)
    return out


def phase_train_families(gpu: str):
    """(g) ``TRAIN_FULL`` at full width through the train CLI, each freed
    before the next (deepseek-v3-671b's dense MLA layers train in phase
    15: one of its MoE layers alone holds at least 113 GB of train
    state)."""
    from repro_torch.configs import get_config

    out = {}
    for arch, B, S, steps, profiled, layers in TRAIN_FULL:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        phase(f"train (g): {arch} at full width "
              f"({cfg.n_layers} of {get_config(arch).n_layers} layers), "
              f"batch {B} x {S}")
        out[arch], params = train_cli_run(arch, B, S, steps, gpu,
                                          profiled=profiled, cfg=cfg)
        del params
        _free()
    return out


def phase_trained_linear(trained, gpu: str):
    """(c) The trained ``ffn.wi`` of layer 0 deployed: its codes
    ``clip(round(w / w_step), -4, 3)`` (``examples/train_lm_tlmac.py``)
    compiled (G 4, d_p 128, ``verify_plan``), then kernel 1 at M 4 and 64
    on seeded 3-bit activation codes, int32-equal to its plain version
    and to ``dense_int_matmul`` of the trained codes.  Returns (figures,
    kernel 1's launches)."""
    import numpy as np
    import torch

    from repro_torch.core.tlmac.api import TLMACLinear
    from repro_torch.core.tlmac.compile import compile_layer, verify_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels import tlmac_fused as tf

    codes = np.clip(np.round(trained["w"] / trained["w_step"]), -4, 3
                    ).astype(np.int32)
    K, N = codes.shape
    t = time.perf_counter()
    plan = compile_layer(codes, B_w=3, B_a=3, G=4, d_p=128, anneal_iters=3000)
    secs = time.perf_counter() - t
    if not verify_plan(plan):
        raise AssertionError("verify_plan fails on the trained ffn.wi")
    lin = TLMACLinear(plan=plan, w_step=torch.as_tensor(trained["w_step"]),
                      a_step=torch.ones((), device=DEV), a_bits=3, N=N)
    sp = lin.as_serve_params()
    sp_cpu = {k: v.cpu() for k, v in sp.items()}
    w = torch.as_tensor(codes, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 23)
    n0 = tf.launches
    for M in TRAINED_LINEAR_MS:
        aq = torch.randint(0, 8, (M, K), generator=gen, dtype=torch.int8,
                           device=DEV)
        got = ops.tlmac_matmul(aq, sp["table_narrow"], sp["exec_idx"],
                               sp["step_cluster"], B_a=3, G=4, N=N,
                               impl="fused")
        plain = ops.tlmac_matmul(aq.cpu(), sp_cpu["table"],
                                 sp_cpu["exec_idx"], sp_cpu["step_cluster"],
                                 B_a=3, G=4, N=N, impl="fused")
        _equal(f"trained ffn.wi M={M}: kernel 1 vs plain", got.cpu(), plain)
        _equal(f"trained ffn.wi M={M}: kernel 1 vs dense_int_matmul", got,
               ops.dense_int_matmul(aq, w))
    launches = tf.launches - n0
    if DEV == "cuda" and launches != len(TRAINED_LINEAR_MS):
        raise AssertionError(f"kernel 1 launched {launches} times")
    log(f"  {gpu}: trained {TRAIN_ARCH} layer 0 ffn.wi {K}->{N}: codes "
        f"{np.bincount(codes.ravel() + 4, minlength=8).tolist()} (-4..3), "
        f"compiled in {secs:.1f} s (host): N_uwg {plan.N_uwg}, N_arr "
        f"{plan.N_arr}, verify_plan holds; kernel 1 at M "
        f"{'/'.join(map(str, TRAINED_LINEAR_MS))} == plain == "
        f"dense_int_matmul of the trained codes ({launches} launches)")
    return dict(compile_s=secs, N_uwg=plan.N_uwg, N_arr=plan.N_arr,
                launches=launches), launches


def phase_train_preempt(seed: int = SEED):
    """(d) ``FaultTolerantRunner`` on minicpm-2b's smoke on the card,
    checkpoints under a temporary directory, preempted once: the resumed
    run's losses within ``PREEMPT_TOL`` of the uninterrupted run's (the
    embedding's backward accumulates with atomics on the card)."""
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train import trainer as T
    from repro_torch.train.ft import FaultTolerantRunner, PreemptionSchedule

    cfg = smoke_config(TRAIN_ARCH)
    tc = T.TrainConfig(lr=1e-3, total_steps=PREEMPT_STEPS, warmup_steps=2)
    data = SyntheticLMData(cfg.vocab, 64, 4, seed=seed)
    a = T.TrainLoop(cfg, tc, data, device=DEV)
    pa, oa = a.init(seed)
    a.run(pa, oa, num_steps=PREEMPT_STEPS)
    ref = [m["loss"] for m in a.metrics_log]
    with tempfile.TemporaryDirectory() as d:
        b = T.TrainLoop(cfg, tc, data, ckpt_interval=PREEMPT_EVERY,
                        device=DEV)
        runner = FaultTolerantRunner(b, d)
        runner.run(PREEMPT_STEPS, seed=seed,
                   step_hook=PreemptionSchedule([PREEMPT_AT]))
    got = {m["step"]: m["loss"] for m in b.metrics_log}
    worst = max(abs(got[s] - ref[s]) for s in range(PREEMPT_STEPS))
    if runner.restarts != 1 or not worst <= PREEMPT_TOL:
        raise AssertionError(f"preempt/resume: {runner.restarts} restarts, "
                             f"max |dloss| {worst}")
    resumed = PREEMPT_AT // PREEMPT_EVERY * PREEMPT_EVERY
    log(f"  {cfg.name} smoke, {PREEMPT_STEPS} steps, preempted at step "
        f"{PREEMPT_AT}, resumed from step {resumed}: max |dloss| vs the "
        f"uninterrupted run {worst:.3e} (tolerance {PREEMPT_TOL})")
    return dict(restarts=runner.restarts, max_dloss=worst)


def phase_resnet_qat(gpu: str):
    """(e) Full-width ResNet-18 (``configs/resnet18.CONFIG``), batch 32 of
    ``in_hw`` images, 10 QAT SGD steps at lr 0.05 on ``qat_loss``
    (``examples/compile_resnet.py``), finite losses; then the trained
    ``block0.conv1`` and ``block7.conv2`` compiled and run as lookup
    convs (kernel 4, then kernel 3's three row GEMMs), int32-equal to
    the integer conv of the trained codes at the maps these convs see.
    Returns (figures, launch counts)."""
    import torch

    from repro_torch.configs.resnet18 import CONFIG as cfg
    from repro_torch.core.tlmac.compile import compile_layer, verify_plan
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R
    from repro_torch.optim.adamw import tree_leaves

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    params = R.init_resnet(cfg, gen, device=DEV)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    x = torch.randn((RESNET_QAT_BATCH, cfg.in_hw, cfg.in_hw, 3),
                    generator=gen, device=DEV)
    labels = torch.randint(0, cfg.num_classes, (RESNET_QAT_BATCH,),
                           generator=gen, device=DEV)
    losses, ms = [], []
    for _ in range(RESNET_QAT_STEPS):
        t = time.perf_counter()
        loss = R.qat_loss(params, x, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(RESNET_QAT_LR * g)
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ResNet QAT losses {losses}")
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"  {gpu}: ResNet-18 QAT ({cfg.w_bits}-bit, width {cfg.width}, "
        f"{cfg.num_classes} classes), batch {RESNET_QAT_BATCH} x "
        f"{cfg.in_hw}x{cfg.in_hw}, {RESNET_QAT_STEPS} SGD steps at lr "
        f"{RESNET_QAT_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{ms[0]:.1f} ms first, {med:.2f} ms median after")
    strides = R.block_strides(cfg)
    hw, convs = cfg.in_hw, {}
    for bi, s in enumerate(strides):          # the map each conv reads
        convs[f"block{bi}.conv1"] = (hw, s)
        hw = -(-hw // s)
        convs[f"block{bi}.conv2"] = (hw, 1)
    n0 = {"pack_bitplanes": bp.launches, "tlmac_gemm": tg.launches}
    fig = dict(losses=losses, first_step_ms=ms[0], median_step_ms=med)
    for name in TRAINED_CONVS:
        bi, cname = int(name.split(".")[0][5:]), name.split(".")[1]
        codes = R.quantize_conv_weights(params["blocks"][bi][cname], cfg)
        t = time.perf_counter()
        plan = compile_layer(codes, B_w=cfg.w_bits, B_a=cfg.a_bits,
                             d_p=min(64, codes.shape[0]), anneal_iters=2000,
                             seed=bi)
        secs = time.perf_counter() - t
        if not verify_plan(plan):
            raise AssertionError(f"verify_plan fails on trained {name}")
        hw_in, stride = convs[name]
        a = _conv_inputs((RESNET_QAT_BATCH, hw_in, hw_in, codes.shape[1]),
                         200 + bi, cfg.a_bits)
        out = R.tlmac_conv_forward(plan, a, cfg.quant, stride)
        _equal(f"trained {name} lookup conv vs integer conv", out,
               int_conv(a, torch.as_tensor(codes, device=DEV), stride))
        fig[name] = dict(compile_s=secs, N_uwg=plan.N_uwg, N_arr=plan.N_arr,
                         shape=[RESNET_QAT_BATCH, hw_in, hw_in,
                                int(codes.shape[1])], stride=stride)
        log(f"  trained {name} {tuple(codes.shape)}: compiled in {secs:.2f} "
            f"s (host), N_uwg {plan.N_uwg}, N_arr {plan.N_arr}; lookup conv "
            f"on [{RESNET_QAT_BATCH}, {hw_in}, {hw_in}, {codes.shape[1]}] "
            f"stride {stride} == integer conv of the trained codes")
    counts = {"pack_bitplanes": bp.launches - n0["pack_bitplanes"],
              "tlmac_gemm": tg.launches - n0["tlmac_gemm"]}
    want = {"pack_bitplanes": len(TRAINED_CONVS),
            "tlmac_gemm": 3 * len(TRAINED_CONVS)}
    if DEV == "cuda" and counts != want:
        raise AssertionError(f"trained convs: launches {counts}, want {want}")
    del params, leaves
    _free()
    return fig, counts


def phase_train():
    """The training stack, (a)-(g); returns its figures and the launches
    of the deployed trained weights ({kernel name: {path: n}})."""
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    t0 = time.perf_counter()
    phase("train (a): one train step, card vs CPU; loss on a fixed batch")
    out = {"card_vs_cpu": phase_train_card_vs_cpu()}
    phase(f"train (b): {TRAIN_ARCH} at full width ({TRAIN_LAYERS} of 40 "
          "layers) through the "
          "train CLI")
    out[TRAIN_ARCH], trained = phase_train_minicpm(gpu)
    phase("train (c): the trained ffn.wi compiled and run on kernel 1")
    out["trained_linear"], k1 = phase_trained_linear(trained, gpu)
    phase("train (d): preempt and resume on the card")
    out["preempt"] = phase_train_preempt()
    phase("train (e): ResNet-18 QAT, trained convs on kernels 4 + 3")
    out["resnet18"], conv_counts = phase_resnet_qat(gpu)
    phase("train (f): every other family's smoke step, card vs CPU")
    out["families_card_vs_cpu"] = phase_train_families_card_vs_cpu()
    out["families"] = phase_train_families(gpu)
    out["seconds"] = time.perf_counter() - t0
    log(f"  the train phase took {out['seconds']:.1f} s")
    launches = {"tlmac_gemm_fused": {f"{TRAIN_ARCH} trained ffn.wi": k1},
                "pack_bitplanes": {"resnet18 trained convs":
                                   conv_counts["pack_bitplanes"]},
                "tlmac_gemm": {"resnet18 trained convs":
                               conv_counts["tlmac_gemm"]}}
    return out, launches


def phase_serve_families():
    """The recurrent families and the enc-dec family through the dense
    forwards, then mistral-large-123b on the main path, each at full
    width and depth and freed before the next.  Returns ({family: its
    figures}, mistral's launch counts)."""
    runs = {}
    for name in RECURRENT_RUNS:
        phase(f"{name} at full width and depth (dense ServeLoop)")
        runs[name] = phase_recurrent(name)
    phase("the serving CLI: repro_torch.launch.serve --arch xlstm-350m")
    phase_cli()
    phase("seamless-m4t-medium at full width and depth (enc-dec: prefill "
          "with frames, then decode)")
    runs["seamless-m4t-medium"] = phase_encdec()
    phase("mistral-large-123b at full width and depth (serve)")
    counts, run = phase_mistral()
    runs["mistral-large-123b"] = dict(
        decode_ms=run["decode_ms"], prefill_tok_s=run["prefill_tok_s"],
        launches=counts["tlmac_gemm_fused"])
    return runs, counts


PAR_SHAPES = dict(
    M=4096, K=4096, N=13440,       # codeqwen1.5-7b's ffn.wi: x [M, K], w [K, N]
    D=4096, MB=512, N_MB=8)        # pipeline: stage width, rows, microbatches
PAR_TOL = 1e-4      # f32 products over K=4096 of |y| ~ 1: other sum orders
CARD_GB = 80e9      # one H100's device memory (data sheet)


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _parallel_rank(rank: int, world: int, tmp: str, dev_type: str,
                   shapes: dict) -> None:
    """One rank of the parallel phase: the rings and the pipeline held
    against their plain versions, then timed beside them; rank 0 writes
    the figures to ``tmp/rank0.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.parallel.overlap import ring_ag_matmul, ring_rs_matmul
    from repro_torch.parallel.pipeline import pipeline_apply

    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        M, K, N = shapes["M"], shapes["K"], shapes["N"]
        m, k = M // world, K // world
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((M, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
        ref = torch.matmul(x, w)
        xb, wb = x[rank * m:(rank + 1) * m], w[rank * k:(rank + 1) * k]
        out = {"world": world}
        with record_collectives() as st:
            y = ring_ag_matmul(xb, w)
        out["ring_ag"] = dict(max_abs_err=(y - ref).abs().max().item(),
                              collectives=dataclasses.asdict(st))
        with record_collectives() as st:
            y = ring_rs_matmul(x, wb)
        out["ring_rs"] = dict(
            max_abs_err=(y - ref[rank * m:(rank + 1) * m]).abs().max().item(),
            collectives=dataclasses.asdict(st))
        D = shapes["D"]
        gp = torch.Generator(device=dev).manual_seed(SEED + 1)
        ws = [torch.randn((D, D), generator=gp, device=dev) / math.sqrt(D)
              for _ in range(world)]
        xs = torch.randn((shapes["N_MB"], shapes["MB"], D), generator=gp,
                         device=dev)
        stage = lambda p, v: torch.tanh(torch.matmul(v, p))

        def sequential():
            h = xs
            for p in ws:
                h = stage(p, h)
            return h

        with record_collectives() as st:
            y = pipeline_apply(stage, ws[rank], xs)
        out["pipeline"] = dict(
            max_abs_err=(y - sequential()).abs().max().item(),
            slots=world + shapes["N_MB"] - 1,
            collectives=dataclasses.asdict(st))
        del y, ref
        # the plain versions the rings replace, timed beside them
        gathered = torch.empty_like(x)
        rs_out = torch.empty((m, N), device=dev)
        xk = x[:, rank * k:(rank + 1) * k].contiguous()

        def ag_plain():
            dist.all_gather_into_tensor(gathered, xb.contiguous())
            return torch.matmul(gathered, w)

        def rs_plain():
            dist.reduce_scatter_tensor(rs_out, torch.matmul(xk, wb))
            return rs_out

        # CUDA events on the card; the host clock in a CPU rehearsal
        timed = cuda_ms if dev_type == "cuda" else _host_ms
        out["ring_ag"]["ms"] = timed(lambda: ring_ag_matmul(xb, w), 10)
        out["ring_ag"]["all_gather_matmul_ms"] = timed(ag_plain, 10)
        out["ring_rs"]["ms"] = timed(lambda: ring_rs_matmul(x, wb), 10)
        out["ring_rs"]["matmul_reduce_scatter_ms"] = timed(rs_plain, 10)
        out["pipeline"]["ms"] = timed(
            lambda: pipeline_apply(stage, ws[rank], xs), 5)
        out["pipeline"]["sequential_ms"] = timed(sequential, 5)
        # one f32 product x @ w at the non-tensor-core rate
        out["ring_ag"]["f32_bound_ms"] = 2 * M * K * N / NONTENSOR_OPS_S * 1e3
        if rank == 0:
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


# phase 11's dry runs: their output folder under build/ and arguments
DRY_RUNS = {"dry_run": ("--all", "--mesh", "both", "--skip-hlo"),
            "dry_run_traced": ("--shape", "decode_32k", "--mesh", "pod")}
_BACKGROUND = []        # the subprocesses started, stopped at exit


class _DryRun:
    """One dry run (``python -m repro_torch.launch.dryrun``, a subprocess
    as a user runs it) started now into ``build/<name>``; a thread waits
    for it and keeps its output and seconds."""

    def __init__(self, name: str, args):
        import shutil
        import threading

        self.args = args
        self.out_dir = os.path.join(ROOT, "build", name)
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", self.out_dir],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _BACKGROUND.append(self.proc)
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        self.stdout, self.stderr = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0

    def join(self, timeout: float = 900):
        """Wait for the run to end (killed past ``timeout`` seconds from
        its start); raises if it failed."""
        self.waiter.join(max(0.0, timeout - (time.perf_counter() - self.t0)))
        if self.waiter.is_alive():
            self.proc.kill()
            raise RuntimeError(f"the dry run {self.args} took over "
                               f"{timeout} s")
        if self.proc.returncode:
            log(self.stderr[-4000:])
            raise RuntimeError(f"the dry run exited {self.proc.returncode}")


def start_dry_runs(runs: dict = DRY_RUNS) -> dict:
    """Phase 11's dry runs started in the background (they use no card):
    started before the kernels' build, they run beside it."""
    return {name: _DryRun(name, args) for name, args in runs.items()}


def stop_background():
    """Kill whatever subprocess the script started and is still running."""
    for proc in _BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_parallel(dry_runs: dict = None, world: int = 0,
                   shapes: dict = PAR_SHAPES) -> dict:
    """Phase 11: the rings and the pipeline on one spawned rank per card
    (NCCL), then the port's dry runs (``dry_runs``, from
    ``start_dry_runs``; started now if not given) read: every cell, and
    the traced ``decode_32k`` cells (the trace's hold on the card follows:
    ``phase_dry_run_card``).  Returns the figures."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = world or torch.cuda.device_count()
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        "rank per visible card" + (" (a ring hop is the identity, so no "
                                   "overlap can show)" if world == 1 else ""))
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_parallel_rank, args=(world, tmp, DEV, shapes),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            out = json.load(f)
    sh = shapes
    for name, ref, plain, what in (
            ("ring_ag", "one torch.matmul", "all_gather_matmul_ms",
             "all_gather + matmul"),
            ("ring_rs", "one torch.matmul", "matmul_reduce_scatter_ms",
             "matmul + reduce_scatter"),
            ("pipeline", "the stages in turn", "sequential_ms",
             "the stages in turn")):
        r = out[name]
        hops = {k: v for k, v in r["collectives"]["count_by_kind"].items()
                if v}
        log(f"  {name}: max |err| {r['max_abs_err']:.3e} vs {ref} (tol "
            f"{PAR_TOL:g}); {r['ms']:.4f} ms vs {what} {r[plain]:.4f} ms "
            f"[{gpu}]; collectives {hops}")
        assert r["max_abs_err"] <= PAR_TOL, (name, r["max_abs_err"])
        assert r["collectives"]["count_by_kind"]["all-gather"] == 0
    log(f"  shapes: x [{sh['M']}, {sh['K']}], w [{sh['K']}, {sh['N']}] f32 "
        f"(f32 bound of x @ w {out['ring_ag']['f32_bound_ms']:.3f} ms at "
        f"{NONTENSOR_OPS_S / 1e12:g} TFLOP/s); pipeline d {sh['D']}, "
        f"{sh['N_MB']} microbatches of {sh['MB']}, {out['pipeline']['slots']} "
        "slots")
    t0 = time.perf_counter()
    for name, run in (dry_runs or start_dry_runs()).items():
        out[name] = phase_dry_run(run)
    log(f"  the dry runs (started with the build) kept phase 11 waiting "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_dry_run(run: _DryRun) -> dict:
    """The port's dry run ``run`` waited for; prints each cell's
    per-device argument bytes against the card's memory (a traced cell:
    its temp and total bytes too, and its traced flops against the
    analytic count) and holds every cell ``ok``."""
    run.join()
    out_dir = run.out_dir
    cells, skipped = {}, 0
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            res = json.load(f)
        assert res["ok"], (name, res.get("error"))
        if "skipped" in res:
            skipped += 1
            continue
        mem = res["memory_analysis"]
        arg, port = mem["argument_size_in_bytes"], mem[
            "port_argument_size_in_bytes"]
        cells[f"{res['arch']} {res['shape']} {res['mesh']}"] = arg
        log(f"  dry run {res['arch']} {res['shape']} {res['mesh']}: "
            f"{arg / 1e9:.3f} GB a device ({100 * arg / CARD_GB:.1f}% of "
            f"{CARD_GB / 1e9:g} GB; the port's own leaves {port / 1e9:.3f} "
            f"GB), roofline bound by {res['analytic']['bottleneck']}")
        if res["trace_s"] is not None:
            total, n = mem["total_nonalias_bytes"], res["analytic"]["n_chips"]
            ratio = res["cost_analysis"]["flops"] * n / res["analytic"][
                "flops"]
            coll = res["hlo_collectives"]
            log(f"    traced in {res['trace_s']:.1f} s: temp "
                f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, total "
                f"{total / 1e9:.3f} GB ({100 * total / CARD_GB:.1f}% of "
                f"{CARD_GB / 1e9:g} GB); flops x {n} chips / analytic "
                f"{ratio:.3f}; collectives {coll['count_by_kind']} "
                f"({coll['total_bytes'] / 1e9:.3f} GB); kernel calls "
                f"{res['kernel_calls']}")
    log(f"  dry run {' '.join(run.args)}: {len(cells)} cells ok, "
        f"{skipped} skipped by design, in {run.seconds:.1f} s (no JAX "
        "imported)")
    return dict(cells=len(cells), skipped=skipped, seconds=run.seconds,
                max_gb=max(cells.values()) / 1e9)


def _dry_card_cells() -> dict:
    """The cells held on the card, ``name: (arch, layers, kind, S, B)``:
    phase 12's codeqwen1.5-7b decode step (its cut, B 4, a cache of the
    prompt and its steps) and phase 13's train step (its cut and batch)."""
    arch = "codeqwen1.5-7b"
    return {"decode": (arch, SHARD_CUTS[arch], "decode",
                       SHARD_PROMPT + SHARD_STEPS, SHARD_B),
            "train": (arch, STRAIN_CUTS[arch], "train", TRAIN_SEQ,
                      TRAIN_BATCH)}


# the predicted peak bytes (the trace's storages, exact) against the rise
# of torch.cuda.max_memory_allocated() over the step: the caching
# allocator rounds each block up to 512 bytes, and a library's buffers
# made in the step come on top (cuBLAS's 32 MiB workspace for autograd's
# device thread, made at the first backward product)
DRY_PEAK_TOL = dict(rel=0.01, abs=64 * 2**20)


def _dry_card_rank(rank: int, world: int, tmp: str, dev_type: str):
    """The dry run's trace held on the card at world 1: each cell of
    ``_dry_card_cells()`` traced on ``meta`` under a fake one-rank group (no
    real group exists yet), then run on this rank's card under the same
    trace (NCCL, world 1); rank 0 writes both and the card's measures."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.launch import dryrun
    from repro_torch.launch.comm_analysis import trace_step
    from repro_torch.launch.mesh import (fake_world, make_mesh_compat,
                                         mesh_context)
    from repro_torch.models import nn

    def fields(trace):
        f = dryrun.traced_fields(trace)
        return dict(f, peak_bytes=trace.peak_bytes, seconds=trace.seconds)

    cells = {name: (_cut_config(arch, layers), ShapeConfig(name, S, B, kind))
             for name, (arch, layers, kind, S, B) in _dry_card_cells().items()}
    out = {}
    with fake_world(world):
        mesh = make_mesh_compat((1, world), ("data", "model"), "cpu")
        with mesh_context(mesh):
            for name, (cfg, shape) in cells.items():
                args = dryrun.step_args(cfg, shape, mesh)
                out[name] = {"meta": fields(dryrun.trace_cell(
                    cfg, shape, mesh, args))}
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh_compat((1, world), ("data", "model"), dev_type)
        # the libraries' lazy buffers made before any measure: a bf16
        # product (cuBLAS's workspace) and one collective (NCCL's
        # communicator)
        x = torch.ones((64, 64), dtype=torch.bfloat16, device=dev)
        (x @ x).float().sum().item()
        dist.all_reduce(torch.ones(1, device=dev))
        # the card's ops on every device (a CPU rehearsal runs them too)
        with mesh_context(mesh), nn.card_ops():
            for name, (cfg, shape) in cells.items():
                gen = torch.Generator(device=dev).manual_seed(SEED)
                fn, a, donated = dryrun.cell_step(
                    cfg, shape, mesh, dryrun.step_args(cfg, shape, mesh, gen))
                if dev_type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                launches = tf.launches
                trace = trace_step(fn, *a, donated=donated)
                card = fields(trace)
                card["launches"] = tf.launches - launches
                if dev_type == "cuda":
                    torch.cuda.synchronize()
                    card["rise_bytes"] = (torch.cuda.max_memory_allocated()
                                          - base)
                out[name]["card"] = card
                del fn, a, trace
                gc.collect()
                if dev_type == "cuda":
                    torch.cuda.empty_cache()
        if rank == 0:
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_dry_run_card() -> dict:
    """The dry run's prediction held on the card at world 1 (one spawned
    rank, ``_dry_card_rank``): per cell, the meta trace's collectives,
    flops, kernel 1's calls and peak bytes beside the card's, printed with
    the card's name and power limit; counts must be equal and the peak
    within ``DRY_PEAK_TOL``."""
    import tempfile

    import torch.multiprocessing as mp

    gpu = gpu_line() if DEV == "cuda" else "cpu"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dry_card_rank, args=(1, tmp, DEV),
                           nprocs=1, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            out = json.load(f)
    cells = _dry_card_cells()
    for name, r in out.items():
        meta, card = r["meta"], r["card"]
        arch, layers, kind, S, B = cells[name]
        mc, cc = meta["hlo_collectives"], card["hlo_collectives"]
        k_meta = meta["kernel_calls"].get("tlmac_gemm_fused", 0)
        k_card = card["kernel_calls"].get("tlmac_gemm_fused", 0)
        log(f"  {name}: {arch} {layers} layers, B {B} x {S}: predicted on "
            f"meta (traced in {meta['seconds']:.1f} s) vs measured on the "
            f"card [{gpu}]")
        log(f"    collectives {mc['count_by_kind']} / {mc['total_bytes']} B "
            f"vs {cc['count_by_kind']} / {cc['total_bytes']} B")
        log(f"    flops {meta['cost_analysis']['flops']:.6e} vs "
            f"{card['cost_analysis']['flops']:.6e}; bytes accessed "
            f"{meta['cost_analysis']['bytes accessed']:.6e} vs "
            f"{card['cost_analysis']['bytes accessed']:.6e}; "
            f"transcendentals {meta['cost_analysis']['transcendentals']:.0f}"
            f" vs {card['cost_analysis']['transcendentals']:.0f}")
        log(f"    kernel 1 calls {k_meta} vs {k_card} (launch counter "
            f"{card['launches']})")
        assert mc == cc, (name, mc, cc)
        assert meta["cost_analysis"]["flops"] == card["cost_analysis"][
            "flops"], name
        assert k_meta == k_card, (name, k_meta, k_card)
        if DEV == "cuda":       # the CPU's plain twin counts no launch
            assert card["launches"] == k_card, (name, card["launches"])
            pred, rise = meta["peak_bytes"], card["rise_bytes"]
            tol = DRY_PEAK_TOL["rel"] * pred + DRY_PEAK_TOL["abs"]
            log(f"    peak bytes predicted {pred} (temp "
                f"{meta['memory_analysis']['temp_size_in_bytes']}) vs rise "
                f"of max_memory_allocated {rise} ({rise - pred:+d} B, "
                f"{(rise - pred) / pred:+.3%}; tolerance {tol:.0f} B: "
                f"{DRY_PEAK_TOL['rel']:.0%} + {DRY_PEAK_TOL['abs'] >> 20} "
                f"MiB for allocator rounding and library buffers) [{gpu}]")
            assert abs(rise - pred) <= tol, (name, pred, rise)
    out["seconds"] = time.perf_counter() - t0
    log(f"  the hold on the card took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the dense serve forwards sharded under a (data, model) mesh
# ---------------------------------------------------------------------------

SHARD_B, SHARD_PROMPT, SHARD_STEPS = 4, 256, 16
# the models served sharded: arch -> layers kept (None: full depth)
SHARD_CUTS = {"codeqwen1.5-7b": 8, "command-r-35b": 4}
SHARD_WAY = 16        # the production meshes' 'model' axis
SHARD_M = 4           # rows a decode step of 4 slots gives each linear
SHARD_ARCHS = ("codeqwen1.5-7b", "mistral-large-123b")   # kernel 1's shapes


def _timed(fn):
    """``fn()`` and its ms: CUDA events on the card, the host clock on the
    CPU."""
    import torch

    if DEV == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    out = fn()
    if DEV == "cuda":
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)
    return out, (time.perf_counter() - t0) * 1e3


def _greedy_run(params, tokens, cfg, S_max: int, steps: int, profile=None,
                extra=None, pos0=None):
    """``lm.prefill`` then ``steps`` greedy ``lm.decode_step``s (under the
    active mesh, if any).  Returns the prefill and last logits, the tokens
    ``[steps + 1, B]``, the caches, the prefill's and each decode step's
    ms (CUDA events on the card, the host clock on the CPU) and the last
    step's collectives.  ``extra``: ``lm.prefill``'s ``frames``/``front``;
    ``pos0``: the first decode position (the prompt's length by default;
    a VLM's front adds its rows).  ``profile`` (a label): on the card,
    step ``PROFILED_STEP`` runs under ``torch.profiler`` (``_profiled``)
    and is left out of the times."""
    import torch

    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.models import lm

    pos0 = tokens.shape[1] if pos0 is None else pos0
    (first, caches), pre_ms = _timed(lambda: lm.prefill(
        params, tokens, cfg, S_max=S_max, **(extra or {})))
    t = lm.greedy(first)
    toks, ms = [t], []
    for i in range(steps):
        if profile and DEV == "cuda" and i == PROFILED_STEP:
            log(f"  {profile}:")
            logits, caches = _profiled(lm.decode_step, (
                params, caches, t[:, None].to(torch.int32), pos0 + i, cfg),
                {}, host=8)
            t = lm.greedy(logits)
            toks.append(t)
            continue
        def step():
            lg, c = lm.decode_step(params, caches, t[:, None].to(
                torch.int32), pos0 + i, cfg)
            return lg, c, lm.greedy(lg)

        with record_collectives() as st:
            (logits, caches, t), step_ms = _timed(step)
            ms.append(step_ms)
        toks.append(t)
    return dict(first=first, last=logits, tokens=torch.stack(toks),
                caches=caches, step_ms=ms, prefill_ms=pre_ms, stats=st)


def _vocab_block(whole, local, rows):
    """The whole logits' block a rank holds: its rows, its vocab block of
    the padded vocab (padding columns at -1e30, as the rank masks them)."""
    import torch

    from repro_torch.parallel import collectives as coll

    vl = local.shape[-1]
    lo = coll.index("model") * vl
    pad = torch.full((whole.shape[0], lo + vl), -1e30, dtype=whole.dtype,
                     device=whole.device)
    pad[:, :min(whole.shape[1], lo + vl)] = whole[:, :lo + vl]
    return pad[rows[0]:rows[0] + rows[1], lo:lo + vl]


def _cut_config(arch: str, layers, over=None):
    """``arch``'s config cut to ``layers`` of its depth (None: full depth),
    widths unchanged, with the fields ``over`` sets."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, **over) if over else cfg


def _int8_expert_launches(params) -> int:
    """int8 expert kernel launches of one forward: one a stack (``w8 [E,
    K, N]`` in a layer's view) over every layer of every segment."""
    def walk(tree):
        if "w8" in tree:
            return int(tree["w8"].dim() == 3)
        return sum(walk(v) for v in tree.values() if isinstance(v, dict))

    return sum(walk(params.layers(si)[0]) * len(params.layers(si))
               for si in range(len(params.segments)))


def _gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda" else 0.0


def _sharded_launches(local, cfg, steps: int) -> dict:
    """Kernel 1 and kernel 7 launches the sharded run of ``steps`` decode
    steps makes: one a lookup linear or expert stack a forward; an enc-dec
    model's encoder once (the prefill), and each ``dec_cross`` block's
    ``xattn`` without its ``wk``/``wv`` of the decoder stream (the
    reference's compiled graph drops them: the prefill runs them on the
    encoder's output instead, a decode step not at all)."""
    per_fwd, per_fwd_expert = _lookup_launches(local)
    forwards = 1 + steps
    n = per_fwd * forwards
    if cfg.n_enc_layers:
        n += (_tables(local.layers(0, "encoder")[0]) * cfg.n_enc_layers
              - 2 * cfg.n_layers * steps)
    return dict(tlmac_gemm_fused=n, expert_stacks=per_fwd_expert * forwards,
                int8_experts=_int8_expert_launches(local) * forwards)


def _sharded_model(arch: str, cfg, mesh, dev, profile: bool = False,
                   run=None) -> dict:
    """One model served unsharded, then sharded under ``mesh`` on this
    rank's blocks (``local_tree`` of the same params; the whole params
    freed first), the launch counters of kernels 1 and 7 set to 0 just
    before the sharded run and read just after and asserted
    (``_sharded_launches``); the two held bit-equal: tokens, prefill and
    last logits (this rank's rows and vocab block), caches (this rank's
    blocks).  An int8 model gets calibrated steps.  ``run``: the batch
    ``B`` and ``prompt`` length (``SHARD_B`` x ``SHARD_PROMPT`` by
    default), an enc-dec model's ``frames`` (their count, drawn ``[B,
    frames, 1024]``), a VLM's ``front`` (its ``frontend_len`` rows of
    1152, drawn).  ``profile``: step ``PROFILED_STEP`` of each run under
    the profiler."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import int8_experts as I8
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import attention, lm, nn
    from repro_torch.parallel.sharding import (batch_entry, block_range,
                                               fix_batch_axes, local_tree)

    run = run or {}
    B, prompt = run.get("B", SHARD_B), run.get("prompt", SHARD_PROMPT)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init_lm(cfg, gen, device=dev)
    if cfg.serve_impl == "int8":
        _calibrate_int8(params)
    tokens = torch.randint(0, cfg.vocab, (B, prompt), generator=gen,
                           device=dev, dtype=torch.int32)
    extra, F = {}, 0
    if run.get("frames"):
        extra["frames"] = torch.randn((B, run["frames"], 1024),
                                      generator=gen, device=dev)
    if run.get("front"):
        F = cfg.frontend_len
        extra["front"] = torch.randn((B, F, 1152), generator=gen,
                                     device=dev)
    S_max = F + prompt + SHARD_STEPS

    def warm_prefill(p, rows=slice(None)):
        """The prefill again, its ms: the first one pays the process's
        first launches and collectives of its shapes."""
        return _timed(lambda: lm.prefill(
            p, tokens[rows], cfg, S_max=S_max,
            **{k: v[rows] for k, v in extra.items()}))[1]

    _reset_peak()
    plain = _greedy_run(params, tokens, cfg, S_max, SHARD_STEPS,
                        profile=f"{cfg.name} unsharded" if profile
                        else None, extra=extra, pos0=F + prompt)
    plain_peak = _gib()
    plain_warm_ms = warm_prefill(params)
    local = nn.ParamTree(local_tree(params.tree(), lm.param_axes(cfg), mesh))
    del params
    _free()
    rows = block_range(B, batch_entry(B, mesh), mesh)
    mine = slice(rows[0], rows[0] + rows[1])
    with mesh_context(mesh):
        _reset_peak()
        tf.launches = tf.expert_launches = I8.launches = 0
        sh = _greedy_run(local, tokens[mine], cfg, S_max, SHARD_STEPS,
                         profile=f"{cfg.name} sharded" if profile else None,
                         extra={k: v[mine] for k, v in extra.items()},
                         pos0=F + prompt)
        launches = dict(tlmac_gemm_fused=tf.launches,
                        expert_stacks=tf.expert_launches,
                        int8_experts=I8.launches)
        peak = _gib()
        warm_ms = warm_prefill(local, mine)
        first = _vocab_block(plain["first"], sh["first"], rows)
        last = _vocab_block(plain["last"], sh["last"], rows)
    want = _sharded_launches(local, cfg, SHARD_STEPS)
    assert launches == want or DEV != "cuda", (cfg.name, launches, want)
    caches = local_tree(plain["caches"], fix_batch_axes(
        lm.cache_axes_tree(cfg), B, mesh), mesh)
    same = dict(
        tokens=torch.equal(sh["tokens"], plain["tokens"][:, mine]),
        prefill_logits=torch.equal(sh["first"], first),
        last_logits=torch.equal(sh["last"], last),
        caches=all(torch.equal(a[b][k], c[b][k]) for a, c in zip(
            sh["caches"], caches) for b in a for k in a[b]))
    st = sh["stats"]
    kinds = {k for seg in lm.segments_for(cfg) for k in seg.pattern}
    if cfg.attn_kind == "mla":
        cache = "latents, sequence on 'model'"
    elif cfg.attn_kind == "none":
        cache = "recurrent states"
    else:
        cache = ("KV heads on 'model'" if attention.kv_heads_sharded(cfg)
                 else "sequence on 'model'")
        if kinds & {"rglru", "mlstm", "slstm"}:
            cache = f"recurrent states, ring {cache}"
    n_in = B * (prompt + F + run.get("frames", 0))
    del local
    return dict(
        arch=arch, layers=cfg.n_layers, of_layers=get_config(arch).n_layers,
        serve_impl=cfg.serve_impl, cache=cache, equal=same, B=B,
        prompt=prompt, inputs={k: list(v.shape) for k, v in extra.items()},
        launches=launches["tlmac_gemm_fused"], kernel_launches=launches,
        step_ms=_median(sh["step_ms"]), plain_step_ms=_median(
            plain["step_ms"]), steps_ms=sh["step_ms"],
        plain_steps_ms=plain["step_ms"], prefill_ms=sh["prefill_ms"],
        plain_prefill_ms=plain["prefill_ms"],
        prefill_tok_s=n_in / (sh["prefill_ms"] / 1e3),
        plain_prefill_tok_s=n_in / (plain["prefill_ms"] / 1e3),
        prefill_warm_ms=warm_ms, plain_prefill_warm_ms=plain_warm_ms,
        peak_gib=peak, plain_peak_gib=plain_peak,
        collectives={k: [st.count_by_kind[k], st.bytes_by_kind[k]]
                     for k in st.count_by_kind if st.count_by_kind[k]},
        param_collectives=[st.param_count, st.param_bytes])


def _shard_gemms(dev, archs, seed: int, B_a=3) -> dict:
    """Kernel 1 at one rank's block of the 16-way 'model' axis of every
    distinct lookup linear of ``archs`` at full width (``_block_linear_
    shapes`` of each block kind they build), M 4 (a decode step of 4
    slots).  The block is the one the linear's own plan spec gives
    (``nn.init_serve_linear``, as the reference's: output tiles n_tiles /
    16 wherever they divide, for the row-parallel linears too; FSDP
    reduction groups gathered at use, so kg whole); every shape of these
    archs cuts its tiles.  Each is int32-equal to its plain twin, timed
    by graph replay over rotated plan blocks beside the twin, the bound
    and the one-hot ``_int_mm``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.models import lm, nn
    from repro_torch.parallel.sharding import spec_of

    out, seen = {}, set()
    gen = torch.Generator(device=dev).manual_seed(seed)
    for arch in archs:
        cfg = get_config(arch)
        kinds = {k for seg in lm.segments_for(cfg) for k in seg.pattern}
        if cfg.n_enc_layers:
            kinds.add("enc_attn")
        G = cfg.tlmac_G
        for K, N in sorted({ks for k in kinds
                            for ks in _block_linear_shapes(k, cfg)[0]}):
            if (K, N, G, cfg.tlmac_dp) in seen:
                continue
            seen.add((K, N, G, cfg.tlmac_dp))
            p = nn.init_serve_linear(gen, K, N, cfg, device=dev)
            nt, kg, dp = p["exec_idx"].shape
            spec = spec_of(p["exec_idx"])
            assert spec[0] == "model", (arch, K, N, spec)
            ntl = nt // SHARD_WAY
            reps = min(SHARD_WAY, rotation(ntl * kg * dp
                                           * p["exec_idx"].element_size()))
            plans = [(p["exec_idx"][i * ntl:(i + 1) * ntl].contiguous(),
                      p["step_cluster"][i * ntl:(i + 1) * ntl].contiguous())
                     for i in range(reps)]
            tab = p["table_narrow"]
            aq = torch.randint(0, 2**B_a, (SHARD_M, K), dtype=torch.int8,
                               generator=gen, device=dev)
            idx, cl = plans[0]
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM {arch} {K}->{N} shard", got, want)
            it = iter(range(1 << 30))

            def run_kernel():
                i, c = plans[next(it) % reps]
                tf.tlmac_gemm_fused(aq, i, c, tab, B_a=B_a, G=G)

            ms = graph_ms(run_kernel)
            plain_ms = cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                aq, idx, cl, tab, B_a=B_a, G=G), iters=3, warmup=1)
            nbytes = (aq.numel() + idx.numel() * idx.element_size()
                      + cl.numel() + tab.numel() + SHARD_M * ntl * dp * 4)
            b = _gemm_bound(SHARD_M, kg, ntl * dp, G, nbytes)
            lib = _onehot_int_mm(tf, aq, idx, cl, tab, B_a, G)
            _equal(f"lookup GEMM {arch} {K}->{N} shard one-hot _int_mm",
                   lib(), got)
            lib_ms = graph_ms(lib)
            key = f"{arch} {K}->{N}"
            out[key] = dict(spec=str(spec), tiles=f"{ntl} of {nt} (dp {dp})",
                            kg=kg, ms=ms, plain_ms=plain_ms,
                            bound_ms=b["bound_ms"], bound_by=_bound_by(b),
                            library_ms=lib_ms)
            log(f"  kernel 1 {key}, one rank of 16 (exec_idx {spec}): {ntl}"
                f" of {nt} tiles (dp {dp}), kg {kg}, M {SHARD_M}: equal "
                f"int32; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({_bound_by(b)}, "
                f"{b['bound_ms'] / ms:.1%} of bound), one-hot _int_mm "
                f"{lib_ms:.4f} ms")
            del p, plans, lib
    return out


def _gather_rate(mesh, dev) -> dict:
    """One FSDP plan gather as the sharded path issues it: codeqwen1.5-7b's
    ``ffn.wi`` plan (``exec_idx [112, 1024, 120]`` int16, 27.5 MB) over
    ('pod', 'data') along kg, the NCCL call alone on the same bytes, and a
    device copy of them (``clone``); ms and GB/s (the bytes over the time:
    at world 1 each is one copy of the plan)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group, mesh_context
    from repro_torch.parallel import collectives as coll

    t = torch.randint(0, 4096, (112, 1024, 120), dtype=torch.int16,
                      generator=torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    nbytes = t.numel() * t.element_size()
    src = t.view(torch.uint8)
    buf = torch.empty((dist.get_world_size(axis_group(
        mesh, ("pod", "data"))) * src.shape[0], *src.shape[1:]),
        dtype=torch.uint8, device=dev)
    with mesh_context(mesh):
        out = dict(
            gather_ms=cuda_ms(lambda: coll.all_gather(
                t, ("pod", "data"), dim=1, param=True), iters=10),
            nccl_ms=cuda_ms(lambda: dist.all_gather_into_tensor(
                buf, src, group=axis_group(mesh, ("pod", "data"))),
                iters=10),
            clone_ms=cuda_ms(lambda: t.clone(), iters=10))
    out.update({k.replace("_ms", "_GBs"): nbytes / v / 1e6
                for k, v in list(out.items())}, bytes=nbytes)
    return out


def _sharded_rank(rank: int, world: int, tmp: str, dev_type: str,
                  models: dict, kind: str = "dense") -> None:
    """One rank of a sharded serve phase: every model of ``models``
    (label: ``(arch, layers, config overrides[, run])``, ``run`` as
    ``_sharded_model`` takes it) unsharded and sharded under a (1, world)
    mesh, then (rank 0) the kernel figures of ``kind``: ``'dense'`` the
    FSDP gather and kernel 1 at the 16-way shard shapes (phase 12),
    ``'moe'`` kernels 1 and 7 at a 16-way 'model' block's expert stacks
    (phase 14), ``'families'`` kernel 1 at the recurrent, enc-dec and VLM
    families' 16-way shard shapes (phase 16); rank 0 writes the figures
    to ``tmp/rank0.json``."""
    global DEV
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    DEV = dev_type
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh_compat((1, world), ("data", "model"), dev_type)
        out = {"world": world, "mesh": [1, world], "models": {}}
        for label, (arch, layers, over, *run) in models.items():
            out["models"][label] = _sharded_model(
                arch, _cut_config(arch, layers, over), mesh, dev,
                profile=kind == "dense" and layers is None,
                run=run[0] if run else None)
            gc.collect()
            if dev_type == "cuda":
                torch.cuda.empty_cache()
        if dev_type == "cuda" and kind == "dense":
            out["fsdp_gather"] = _gather_rate(mesh, dev)
        if rank == 0 and dev_type == "cuda":
            if kind == "dense":
                out["shard_gemms"] = _shard_gemms(dev, SHARD_ARCHS, SEED + 3)
            elif kind == "families":
                out["shard_gemms"] = _shard_gemms(dev, SFAM_ARCHS, SEED + 7)
            else:
                out["expert_blocks"] = _expert_block_gemms(dev)
        if rank == 0:
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn_sharded(world: int, models: dict, kind: str) -> dict:
    """``_sharded_rank`` on ``world`` spawned ranks; rank 0's figures."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_sharded_rank, args=(world, tmp, DEV, models,
                                                kind),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)


def _log_sharded(out: dict, gpu: str) -> None:
    """Print each model's sharded run beside its unsharded one; raise
    unless they are bit-equal."""
    for label, r in out["models"].items():
        depth = ("full depth" if r["layers"] == r["of_layers"] else
                 f"{r['layers']} of {r['of_layers']} layers")
        log(f"  {label} ({depth}, full width, {r['serve_impl']}; caches: "
            f"{r['cache']}), B {r['B']} x {r['prompt']} + {SHARD_STEPS} "
            f"greedy steps: sharded vs unsharded {r['equal']}; launches "
            f"{r['kernel_launches']} (one a lookup linear or expert stack "
            f"a forward x {1 + SHARD_STEPS} forwards)")
        log(f"    a decode step (median, min-max): sharded "
            f"{r['step_ms']:.3f} ms ({min(r['steps_ms']):.3f}-"
            f"{max(r['steps_ms']):.3f}), unsharded {r['plain_step_ms']:.3f} "
            f"ms ({min(r['plain_steps_ms']):.3f}-"
            f"{max(r['plain_steps_ms']):.3f}); peak sharded "
            f"{r['peak_gib']:.3f} GiB, unsharded {r['plain_peak_gib']:.3f} "
            f"GiB [{gpu}]; collectives a step (kind: count, bytes) "
            f"{r['collectives']}, of them parameter gathers "
            f"{r['param_collectives']}")
        if "prefill_ms" in r:
            log(f"    prefill of {r['B']} x {r['prompt']} tokens"
                f"{' + ' + str(r['inputs']) if r['inputs'] else ''}: "
                f"sharded {r['prefill_ms']:.1f} ms ({r['prefill_tok_s']:.1f}"
                f" tok/s; warm {r['prefill_warm_ms']:.1f} ms), unsharded "
                f"{r['plain_prefill_ms']:.1f} ms ("
                f"{r['plain_prefill_tok_s']:.1f} tok/s; warm "
                f"{r['plain_prefill_warm_ms']:.1f} ms) [{gpu}]")
        assert all(r["equal"].values()), (label, r["equal"])


def phase_sharded(world: int = 0, cuts: dict = SHARD_CUTS) -> dict:
    """Phase 12: the dense serve forwards sharded under a (1, world) mesh,
    one NCCL rank per visible card (world 1 on one card: every collective
    is issued over its one-rank group).  Returns rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    models = {a: (a, layers, {}) for a, layers in cuts.items()}
    out = _spawn_sharded(world, models, "dense")
    _log_sharded(out, gpu)
    g = out.get("fsdp_gather")
    if g:
        log(f"  one FSDP plan gather (codeqwen1.5-7b ffn.wi exec_idx, "
            f"{g['bytes'] / 1e6:.1f} MB, over ('pod', 'data') of size "
            f"1): {g['gather_ms']:.3f} ms "
            f"({g['gather_GBs']:.1f} GB/s); the NCCL call alone "
            f"{g['nccl_ms']:.3f} ms ({g['nccl_GBs']:.1f} GB/s); a device "
            f"copy {g['clone_ms']:.3f} ms ({g['clone_GBs']:.1f} GB/s) [{gpu}]")
    return out


# ---------------------------------------------------------------------------
# phase 14: sharded serving of the MoE and MLA decoders
# ---------------------------------------------------------------------------

# label: (arch, layers kept of 61, config overrides); widths are never cut.
# deepseek-v3's 3 dense MLA layers and 2 MoE, kimi-k2's 1 dense and 1 MoE,
# and moe-gqa in the int8 layout (kernel 7's expert stacks) cut as deepseek
SMOE_MODELS = {
    "deepseek-v3-671b": ("deepseek-v3-671b", 5, {}),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", 2, {}),
    "deepseek-v3-671b moe-gqa int8": ("deepseek-v3-671b", 5, dict(
        attn_kind="gqa", serve_impl="int8",
        name="deepseek-v3-671b moe-gqa int8")),
}
SMOE_WAY = 16        # the production meshes' 'model' axis: experts / 16 a rank
SMOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")


def _expert_rows(cfg) -> dict:
    """Rows each expert of a stack sees (groups x capacity): a decode step
    of ``SHARD_B`` slots (a group of one token each: capacity 1) and the
    ``SHARD_B`` x ``SHARD_PROMPT`` prefill (a group a sequence)."""
    cap = max(int(cfg.capacity_factor * SHARD_PROMPT * cfg.top_k
                  / cfg.n_experts), 1)
    return {"decode": SHARD_B, "prefill": SHARD_B * cap}


def _expert_block_gemms(dev, B_a=3) -> dict:
    """Kernel 1 at one rank's block of a 16-way 'model' axis's expert
    stacks (``SMOE_ARCHS``: deepseek-v3's 16 of 256 and kimi-k2's 24 of 384
    experts of wi, wg, wo at full width, drawn as the serve init draws
    them) and kernel 7 at 16 of int8 moe-gqa's 256 experts, at the rows a
    decode step and the 4 x 256 prefill give each expert
    (``_expert_rows``): one launch a stack, int32-equal to its plain twin,
    timed by graph replay beside the twin and the bound (no one PyTorch
    call computes an expert stack; kernel 7 also beside its per-expert
    ``_int_mm`` loop)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import int8_experts as I8
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.models import nn

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for arch in SMOE_ARCHS:
        cfg = get_config(arch)
        El, G = cfg.n_experts // SMOE_WAY, cfg.tlmac_G
        d, F = cfg.d_model, cfg.d_expert
        for name, (K, N) in (("wi", (d, F)), ("wg", (d, F)), ("wo", (F, d))):
            p = nn.init_serve_linear(gen, K, N, cfg, device=dev, expert=El)
            idx, cl, tab = p["exec_idx"], p["step_cluster"], p["table_narrow"]
            _, nt, kg, dp = idx.shape
            for what, M in _expert_rows(cfg).items():
                aq = torch.randint(0, 2**B_a, (El, M, K), dtype=torch.int8,
                                   generator=gen, device=dev)
                got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
                want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a,
                                                 G=G)
                _equal(f"expert block {arch} {name} [{El}] {K}->{N} M={M}",
                       got, want)
                del want
                plain_ms = cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                    aq, idx, cl, tab, B_a=B_a, G=G), iters=1, warmup=0)
                ms = graph_ms(lambda: tf.tlmac_gemm_fused(
                    aq, idx, cl, tab, B_a=B_a, G=G), iters=10, replays=3)
                nbytes = (aq.numel() + idx.numel() * idx.element_size()
                          + cl.numel() + tab.numel() * tab.element_size()
                          + El * M * N * 4)
                b = _gemm_bound(El * M, kg, N, G, nbytes)
                key = f"{arch} {name} [{El} of {cfg.n_experts}] {K}->{N} M={M}"
                out[key] = dict(kernel="tlmac_gemm_fused", rows=what,
                                ms=ms, plain_ms=plain_ms,
                                bound_ms=b["bound_ms"], bound_by=_bound_by(b),
                                library_ms=None, bytes=nbytes)
                log(f"  kernel 1 {key} ({what}; dp {dp}, kg {kg}): equal "
                    f"int32; kernel {ms:.4f} ms (one launch), bound "
                    f"{b['bound_ms']:.4f} ms ({_bound_by(b)}, "
                    f"{b['bound_ms'] / ms:.1%} of bound), plain "
                    f"{plain_ms:.1f} ms")
            del p, idx, cl, tab, aq
    cfg = _cut_config(*SMOE_MODELS["deepseek-v3-671b moe-gqa int8"])
    El = cfg.n_experts // SMOE_WAY
    K, N = cfg.d_model, cfg.d_expert
    w8 = nn.init_serve_linear(gen, K, N, cfg, device=dev, expert=El)["w8"]
    for what, M in _expert_rows(cfg).items():
        aq = torch.randint(-127, 128, (El, M, K), dtype=torch.int8,
                           generator=gen, device=dev)
        got = I8.int8_experts_matmul(aq, w8)
        want = I8.int8_experts_matmul_plain(aq, w8)
        _equal(f"int8 expert block wi [{El}] {K}->{N} M={M}", got, want)
        ms = graph_ms(lambda: I8.int8_experts_matmul(aq, w8), iters=10,
                      replays=3)
        plain_ms = cuda_ms(lambda: I8.int8_experts_matmul_plain(aq, w8),
                           iters=2, warmup=1)
        loop_ms = graph_ms(lambda: I8.int8_experts_loop(aq, w8), iters=4,
                           replays=2)
        nbytes = El * (M * K + K * N + 4 * M * N)
        t_b = nbytes / HBM_BYTES_S * 1e3
        t_o = 2 * El * M * K * N / INT8_TC_OPS_S * 1e3
        b = dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)
        key = f"moe-gqa int8 wi [{El} of {cfg.n_experts}] {K}->{N} M={M}"
        out[key] = dict(kernel="int8_experts", rows=what, ms=ms,
                        plain_ms=plain_ms, bound_ms=b["bound_ms"],
                        bound_by=_bound_by(b), library_ms=None,
                        int_mm_loop_ms=loop_ms, bytes=nbytes)
        log(f"  kernel 7 {key} ({what}): equal int32; kernel {ms:.4f} ms "
            f"(one launch), bound {b['bound_ms']:.4f} ms ({_bound_by(b)}, "
            f"{b['bound_ms'] / ms:.1%} of bound), plain (per-expert f64) "
            f"{plain_ms:.3f} ms, {El} _int_mm launches {loop_ms:.4f} ms")
        del want
    return out


def phase_sharded_moe(world: int = 0, models: dict = SMOE_MODELS) -> dict:
    """Phase 14: the MoE and MLA decoders served sharded under a (1,
    world) mesh (expert parallelism over 'model', the MLA latent caches
    sequence-sharded), one NCCL rank per visible card (world 1 on one
    card: every collective is issued over its one-rank group); then
    kernels 1 and 7 at a 16-way 'model' block's expert stacks.  Returns
    rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    out = _spawn_sharded(world, models, "moe")
    _log_sharded(out, gpu)
    for key, r in out.get("expert_blocks", {}).items():
        log(f"  expert block {key}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms [{gpu}]")
    return out


# ---------------------------------------------------------------------------
# phase 16: sharded serving of the recurrent, enc-dec and VLM families
# ---------------------------------------------------------------------------

SFAM_WRAP = 2304     # a prompt past recurrentgemma-2b's 2048-slot ring
# label: (arch, layers kept, config overrides, run); widths are never cut:
# recurrentgemma-2b two whole (rglru, rglru, attn_local) patterns, and a
# B 1 prompt longer than its window so that the ring wraps on the card;
# xlstm-350m one 7 + 1 pattern; seamless-m4t-medium whole with 512 frames;
# internvl2-76b 2 of 80 layers with its 256-row front (4 before phase 17
# was added: cut for the script's time limit)
SFAM_MODELS = {
    "recurrentgemma-2b": ("recurrentgemma-2b", 6, {}),
    "recurrentgemma-2b ring wrap": ("recurrentgemma-2b", 6, {}, dict(
        B=1, prompt=SFAM_WRAP)),
    "xlstm-350m": ("xlstm-350m", 8, {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", None, {}, dict(
        frames=512)),
    "internvl2-76b": ("internvl2-76b", 2, {}, dict(front=True)),
}
SFAM_PHASE = ("sharded recurrent, enc-dec and VLM serve: recurrent states, "
              "rings, encoders and a front under a (data, model) mesh")
SFAM_ARCHS = ("recurrentgemma-2b", "xlstm-350m", "seamless-m4t-medium",
              "internvl2-76b")


def phase_sharded_families(world: int = 0,
                           models: dict = SFAM_MODELS) -> dict:
    """Phase 16: the recurrent, enc-dec and VLM families served sharded
    under a (1, world) mesh (the RG-LRU, mLSTM and sLSTM on each rank's
    blocks of their states, the ``attn_local`` ring cut on its slots, the
    encoder and the cross-attention on each rank's heads or positions, a
    VLM's front projected by its FSDP-gathered weight), one NCCL rank per
    visible card (world 1 on one card: every collective is issued over
    its one-rank group); then kernel 1 at the families' 16-way shard
    shapes.  Returns rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    out = _spawn_sharded(world, models, "families")
    _log_sharded(out, gpu)
    return out


# ---------------------------------------------------------------------------
# phase 13: the sharded QAT train step of the dense GQA decoders
# ---------------------------------------------------------------------------

# layers kept (None: full depth); widths are never cut.  codeqwen1.5-7b's
# f32 params, gradients and moments take 16 bytes a parameter: 3.7 GB a
# layer and 12.1 GB for its untied tables, so 8 of its 32 layers (41.8 GB)
# would fit beside the step's activations; 4 (27.0 GB) are kept, cut with
# minicpm-2b (train (b)'s depth) to keep the whole script inside its time
# limit
STRAIN_CUTS = {TRAIN_ARCH: TRAIN_LAYERS, "codeqwen1.5-7b": 4}
STRAIN_STEPS = 2
# tests/_torch_train.py's tolerances, for an op the card cannot keep
# bit-equal: gradients by cosine and max error over the leaf's largest
# (the N2UQ ``aq`` leaves over the largest of their kind), the loss
GRAD_COS, GRAD_REL, AQ_REL, LOSS_RTOL = 0.9999, 2e-2, 5e-2, 1e-6


@contextlib.contextmanager
def _train_rank(rank: int, world: int, tmp: str, dev_type: str,
                deterministic: bool = False):
    """A spawned rank of a sharded train phase: this module's ``DEV``, the
    rank's card (TF32 off), one process group over ``world`` ranks (NCCL
    on cards, gloo on the CPU) on a file store under ``tmp``; yields
    ``(device, mesh)``, the mesh (data 1, model world), and destroys the
    group after.  ``deterministic``: no atomics-ordered sums (runs that
    compare bit for bit)."""
    global DEV
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat

    DEV = dev_type
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(dev_type, rank if dev_type == "cuda" else None)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        yield dev, make_mesh_compat((1, world), ("data", "model"), dev_type)
    finally:
        dist.destroy_process_group()


def _spawn_train(fn, world: int, *args, grow: bool = False) -> dict:
    """``fn(rank, world, tmp, DEV, *args)`` on ``world`` spawned ranks;
    returns what rank 0 wrote to ``tmp/rank0.json``.  ``grow``: the ranks'
    allocator grows its segments in place (a run that peaks near the
    card's size, where fixed segments left 13 GiB unusable)."""
    import tempfile

    import torch.multiprocessing as mp

    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if grow:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(fn, args=(world, tmp, DEV, *args),
                               nprocs=world, start_method="spawn")
            with open(os.path.join(tmp, "rank0.json")) as f:
                return json.load(f)
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf


def _leaf_marks(tree) -> list:
    """Per leaf of ``tree`` (``tree_leaves`` order): its f64 norm and a
    checksum of its bits (its 32-bit words summed in int64)."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    return [(float(t.detach().double().norm()),
             int(t.detach().float().contiguous().view(torch.int32).long()
                 .sum())) for t in tree_leaves(tree)]


def _sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def _reset_peak():
    import torch

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _hold_leaves(names, want, got, mesh) -> dict:
    """Gradient leaves ``got`` (this rank's blocks on the card, tagged with
    their specs) against ``want`` (host copies of the unsharded step's,
    cut to the same blocks) by ``GRAD_COS``/``GRAD_REL`` (``aq`` leaves
    by ``AQ_REL`` of the largest of their kind); returns the worst cosine
    and error, or raises."""
    from repro_torch.parallel.sharding import local_shard, spec_of

    want = [local_shard(w, spec_of(g), mesh).double()
            for w, g in zip(want, got)]
    kinds = {}
    for n, w in zip(names, want):
        if ".aq." in n:
            k = n.rsplit(".", 1)[1]
            kinds[k] = max(kinds.get(k, 0.0), float(w.abs().max()))
    worst = dict(cos=1.0, err=0.0)
    for n, w, g in zip(names, want, got):
        g = g.detach().double().cpu()
        scale = float(w.abs().max())
        if scale == 0:
            if float(g.abs().max()):
                raise AssertionError(f"{n}: nonzero where unsharded is 0")
            continue
        if ".aq." in n:
            err = float((w - g).abs().max()) / kinds[n.rsplit(".", 1)[1]]
            if err >= AQ_REL:
                raise AssertionError(f"{n}: aq error {err}")
        else:
            cos = float((w * g).sum() / (w.norm() * g.norm()))
            err = float((w - g).abs().max()) / scale
            if not (cos > GRAD_COS and err < GRAD_REL):
                raise AssertionError(f"{n}: cos {cos}, error {err}")
            worst["cos"] = min(worst["cos"], cos)
        worst["err"] = max(worst["err"], err)
    return worst


def _named_leaves(tree, pre=""):
    """``(dotted name, leaf)`` of a nested dict/list of tensors, in
    ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{pre}{i}.")
    else:
        yield pre[:-1], tree


def _sharded_train_model(cfg, mesh, dev, pick=None, tc=None,
                         strict: bool = False, of_layers=None,
                         B: int = TRAIN_BATCH, S: int = TRAIN_SEQ,
                         frames: int = 0):
    """One model's QAT train step unsharded, then sharded under ``mesh`` on
    this rank's blocks, from the same seeded params (phase 8's: the train
    CLI's ``init``, seed 0) and batches (its
    ``SyntheticLMData``, batch ``B x S`` tokens, default ``TRAIN_BATCH x
    TRAIN_SEQ``; an enc-dec model's ``frames`` frames, a VLM's
    ``frontend_len`` front rows), WSD,
    ``STRAIN_STEPS`` steps each (``tc``: the step's config, by default
    ``cfg``'s moments, no accumulation, no compression; the compression's
    uniforms from one generator seed a step in both runs): the loss, the
    gradient norm, every gradient leaf (norm and bit checksum), every
    param and every moment leaf after each step compared bit for bit.
    Where step 0's gradients differ (every step at world > 1: the blocks
    are not the whole), the loss is held within ``LOSS_RTOL`` and each
    gradient leaf within the CPU tests' tolerances of the unsharded one's
    block (host copies of the unsharded gradient, kept only when not
    ``strict``); under ``strict`` a difference in the loss, the norm, a
    param or a moment raises, after the leaves that differ are named.  Returns the figures
    and ``pick(local params)`` (a trained linear on the host).
    ``of_layers``: the depth ``cfg`` was cut from (default: its full
    config's)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import lm, nn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.parallel.sharding import block_range, local_tree
    from repro_torch.train import trainer as T

    front = cfg.frontend_len if cfg.frontend == "patch" else 0
    reck = train_reckoning(cfg, B, S, frames, front)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=S, global_batch=B,
                           seed=SEED, frontend=cfg.frontend,
                           frontend_len=front, enc_len=frames)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(STRAIN_STEPS)]
    tc = tc or T.TrainConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                             schedule="wsd", adamw=AdamWConfig(
                                 state_dtype=cfg.opt_state_dtype))

    def init_params():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return lm.init_lm(cfg, gen, purpose="train", device=dev)

    def run(params, rows, plain=None) -> tuple:
        step = T.make_train_step(cfg, tc)
        grads_of, seen = step.grads, {}
        real_compress, comp = T.compress_grads, []

        def watched(p, b):     # the step's gradient, before clipping
            loss, g = grads_of(p, b)
            first = "loss" not in seen
            seen.update(loss=float(loss), grads=_leaf_marks(g))
            if first and plain is None:
                if not strict:      # a strict run must not differ: no copy
                    seen["host"] = [t.detach().to("cpu", copy=True)
                                    for t in tree_leaves(g)]
            elif (first and plain["host"] is not None
                  and seen["grads"] != plain["steps"][0]["grads"]):
                want = plain["steps"][0]["loss"]
                if abs(seen["loss"] - want) > LOSS_RTOL * abs(want):
                    raise AssertionError(f"{cfg.name}: loss {seen['loss']} "
                                         f"vs {want}")
                names = [n for n, _ in _named_leaves(p.tree())]
                seen["held"] = _hold_leaves(names, plain["host"],
                                            tree_leaves(g), mesh)
            return loss, g

        def counted(grads, gen=None, error_state=None):
            with record_collectives() as cst:
                out = real_compress(grads, gen, error_state)
            comp.append(cst)
            return out

        step.grads = watched
        opt = adamw_init(params, tc.adamw)
        out = dict(steps=[])
        T.compress_grads = counted
        try:
            for i, b in enumerate(batches):
                b = {k: v[rows[0]:rows[0] + rows[1]] for k, v in b.items()}
                gen = torch.Generator(device=dev).manual_seed(
                    T.COMPRESS_SEED + i)
                with record_collectives() as st:
                    _sync()
                    t = time.perf_counter()
                    params, opt, m = step(params, opt, b, i, gen)
                    float(m["loss"])
                    _sync()
                    ms = (time.perf_counter() - t) * 1e3
                out["steps"].append(dict(
                    ms=ms, loss=seen["loss"], gnorm=float(m["gnorm"]),
                    grads=seen["grads"], params=_leaf_marks(params),
                    moments=_leaf_marks({"m": opt["m"], "v": opt["v"]}),
                    stats=st, compress=comp[i] if comp else None))
        finally:
            T.compress_grads = real_compress
        out["host"] = seen.pop("host", None)
        out["held"] = seen.get("held")
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if DEV == "cuda" else 0.0)
        return out, params

    _free()
    _reset_peak()
    plain, params = run(init_params(), (0, B))
    del params
    _free()
    _reset_peak()
    whole = init_params()
    local = nn.ParamTree(local_tree(whole.tree(), lm.param_axes(
        cfg, "train"), mesh), trainable=True)
    del whole
    rows = block_range(B, nn.train_batch_axes(cfg), mesh)
    picked = None
    with mesh_context(mesh):
        sh, local = run(local, rows, plain)
        if pick is not None:
            picked = pick(local.tree(), cfg)
    del local, plain["host"]
    _free()
    equal = [dict(loss=a["loss"] == b["loss"], gnorm=a["gnorm"] == b[
        "gnorm"], grads=a["grads"] == b["grads"], params=a["params"] == b[
        "params"], moments=a["moments"] == b["moments"])
        for a, b in zip(plain["steps"], sh["steps"])]
    if not equal[0]["grads"] and mesh.size() == 1:
        diff = [n for (n, _), x, y in zip(
            _named_leaves(lm.param_axes(cfg, "train")), plain["steps"][0][
                "grads"], sh["steps"][0]["grads"]) if x != y]
        log(f"  {cfg.name}: step 0 not bit-equal at world 1 ({equal[0]}); "
            f"gradient leaves that differ: {diff[:6]}"
            f"{' ...' if len(diff) > 6 else ''}"
            + (f"; held within the CPU tests' tolerances {sh['held']}"
               if sh["held"] is not None else ""))
    if strict and not all(e[k] for e in equal
                          for k in ("loss", "gnorm", "params", "moments")):
        raise AssertionError(f"{cfg.name}: sharded vs unsharded {equal}")

    def kinds(st):
        return {k: dict(count=st.count_by_kind[k], bytes=st.bytes_by_kind[k],
                        backward_count=st.backward_count_by_kind[k],
                        backward_bytes=st.backward_bytes_by_kind[k])
                for k in st.count_by_kind if st.count_by_kind[k]}

    st, cst = sh["steps"][0]["stats"], sh["steps"][0]["compress"]
    return dict(
        layers=cfg.n_layers, of_layers=of_layers or get_config(
            cfg.name).n_layers,
        layout="pure_fsdp" if cfg.pure_fsdp else "TP + SP + FSDP",
        moments=tc.adamw.state_dtype, accum=tc.accum_steps,
        compress=tc.compress, reckoning=reck, equal=equal, held=sh["held"],
        loss=[s["loss"] for s in sh["steps"]],
        gnorm=[s["gnorm"] for s in sh["steps"]],
        plain_loss=[s["loss"] for s in plain["steps"]],
        plain_gnorm=[s["gnorm"] for s in plain["steps"]],
        step_ms=[s["ms"] for s in sh["steps"]],
        plain_step_ms=[s["ms"] for s in plain["steps"]],
        peak_gib=sh["peak_gib"], plain_peak_gib=plain["peak_gib"],
        collectives=kinds(st), param_collectives=[st.param_count,
                                                  st.param_bytes],
        compress_collectives=kinds(cst) if cst else None), picked


def _layer0_linear(path, cut: int = 1):
    """A ``pick`` of ``_sharded_train_model``: layer 0 of the stacked train
    linear at ``path`` (keys from the param tree's root), ``w`` and
    ``w_step`` gathered over their FSDP axes, on the host; ``cut``: only
    their first ``N / cut`` columns (one rank's block of a ``cut``-way
    'model' axis)."""
    def pick(tree, cfg) -> dict:
        from repro_torch.models import lm, nn

        stacked = tree
        for k in path:
            stacked = stacked[k]
        layer0 = lm._unstack({k: stacked[k] for k in ("w", "w_step")},
                             stacked["w"].shape[0])[0]
        n = layer0["w_step"].shape[-1] // cut
        return {k: nn.gather_fsdp(v, cfg)[..., :n].detach().float().cpu()
                .numpy() for k, v in layer0.items()}
    return pick


def _sharded_train_rank(rank: int, world: int, tmp: str, dev_type: str,
                        cuts: dict) -> None:
    """One rank of phase 13: every model of ``cuts`` trained unsharded and
    sharded under a (1, world) mesh; then (rank 0) the first model's
    trained layer 0 ``ffn.wi`` on kernel 1; rank 0 writes the figures to
    ``tmp/rank0.json``."""
    with _train_rank(rank, world, tmp, dev_type) as (dev, mesh):
        out = {"world": world, "mesh": [1, world], "models": {}}
        wi = None
        for arch, layers in cuts.items():
            cfg = _cut_config(arch, layers)
            out["models"][arch], w = _sharded_train_model(
                cfg, mesh, dev, pick=None if wi is not None else
                _layer0_linear(("segments", 0, "b0", "ffn", "wi")))
            wi = wi if wi is not None else w
        if rank == 0:
            gpu = gpu_line() if dev_type == "cuda" else "cpu"
            out["trained_linear"], out["launches"] = phase_trained_linear(
                wi, gpu)
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)


def phase_sharded_train(world: int = 0, cuts: dict = STRAIN_CUTS) -> dict:
    """Phase 13: the QAT train step of the dense GQA decoders sharded under
    a (1, world) mesh, one NCCL rank per visible card (world 1 on one
    card: every collective is still issued, over one-rank groups).
    Returns rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    t0 = time.perf_counter()
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    out = _spawn_train(_sharded_train_rank, world, cuts)
    for arch, r in out["models"].items():
        depth = ("full depth" if r["layers"] == r["of_layers"] else
                 f"{r['layers']} of {r['of_layers']} layers")
        log(f"  {arch} ({depth}, full width, {r['layout']}), batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, WSD, {STRAIN_STEPS} steps: "
            f"sharded vs unsharded {r['equal']}"
            + (f"; held within the CPU tests' tolerances {r['held']}"
               if r["held"] else ""))
        log(f"    loss {r['loss']} |g| {r['gnorm']} (unsharded "
            f"{r['plain_loss']}, {r['plain_gnorm']}); a step: sharded "
            f"{[round(x, 1) for x in r['step_ms']]} ms, unsharded "
            f"{[round(x, 1) for x in r['plain_step_ms']]} ms; peak "
            f"{r['peak_gib']:.2f} GiB sharded, {r['plain_peak_gib']:.2f} "
            f"GiB unsharded [{gpu}]")
        log(f"    collectives step 0 (kind: count/bytes, of them backward) "
            + "; ".join(f"{k} {c['count']}/{c['bytes']} ({c['backward_count']}"
                        f"/{c['backward_bytes']})"
                        for k, c in r["collectives"].items())
            + f"; parameter collectives {r['param_collectives']} (the FSDP "
            "gathers and their reduce-scatters)")
        for i, e in enumerate(r["equal"]):
            # a step 0 held within tolerances leaves the later steps on
            # another state: those must only be finite
            if not all(e.values()) and not r["held"]:
                raise AssertionError(f"{arch} step {i}: {e}")
            if not (math.isfinite(r["loss"][i])
                    and math.isfinite(r["gnorm"][i])):
                raise AssertionError(f"{arch} step {i}: loss {r['loss']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the sharded QAT train step of the MoE and MLA decoders
# ---------------------------------------------------------------------------

# (1) deepseek-v3-671b at full width cut to its 3 dense MLA layers (the
# train phase's former cell) with its full config's fsdp and int8 moments,
# compression on
# and two accumulation microbatches; (2) the MoE path at the deepseek smoke
# widened as tests/test_torch_sharded_train.py::MOE_WIDE (MLA + MoE, 8
# experts top-2, fsdp), int8 moments, compression, two microbatches
STRAIN_MOE_ARCH, STRAIN_MOE_LAYERS, STRAIN_MOE_ACCUM = "deepseek-v3-671b", 3, 2
MOE_TRAIN_WIDE = dict(d_model=256, d_ff=512, d_expert=64, fsdp=True,
                      opt_state_dtype="int8")


def _moe_train_config(cfg):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer as T

    return T.TrainConfig(lr=3e-4, total_steps=TRAIN_STEPS, schedule="wsd",
                         accum_steps=STRAIN_MOE_ACCUM, compress=True,
                         adamw=AdamWConfig(state_dtype=cfg.opt_state_dtype))


def _expert0_wi(tree, cfg) -> dict:
    """The first MoE layer's trained ``moe.wi`` of expert 0 (this rank's
    first expert at world 1) with its step gathered whole, on the host."""
    from repro_torch.models import lm, nn
    from repro_torch.parallel import collectives as coll

    stacked = tree["segments"][1]["b0"]["moe"]["wi"]
    layer0 = lm._unstack({k: stacked[k] for k in ("w", "w_step")},
                         stacked["w"].shape[0])[0]
    w = nn.gather_fsdp(layer0["w"], cfg)[0]
    step = coll.all_gather(layer0["w_step"].detach().clone(), "model", 0)
    return {"w": w.detach().float().cpu().numpy(),
            "w_step": step.detach().float().cpu().numpy()}


def _trained_shard_on_kernel1(label: str, trained, gpu: str, d_p: int):
    """A trained linear compiled back (codes ``clip(round(w / w_step), -4,
    3)``, G 4, ``verify_plan``) and run on kernel 1 at M 4 and 64 on seeded
    3-bit activation codes: int32-equal to its plain version and to
    ``dense_int_matmul``; then timed by graph replay beside the plain
    version, the one-hot ``_int_mm`` and the byte / one-hot-operation
    bound.  Returns (figures, kernel 1's launches on the checks)."""
    import numpy as np
    import torch

    from repro_torch.core.tlmac.api import TLMACLinear
    from repro_torch.core.tlmac.compile import compile_layer, verify_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels import tlmac_fused as tf

    codes = np.clip(np.round(trained["w"] / trained["w_step"]), -4, 3
                    ).astype(np.int32)
    K, N = codes.shape
    t = time.perf_counter()
    plan = compile_layer(codes, B_w=3, B_a=3, G=4, d_p=d_p,
                         anneal_iters=3000)
    secs = time.perf_counter() - t
    if not verify_plan(plan):
        raise AssertionError(f"verify_plan fails on the trained {label}")
    lin = TLMACLinear(plan=plan, w_step=torch.as_tensor(trained["w_step"]),
                      a_step=torch.ones((), device=DEV), a_bits=3, N=N)
    sp = lin.as_serve_params()
    sp_cpu = {k: v.cpu() for k, v in sp.items()}
    w = torch.as_tensor(codes, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 29)
    aqs = {M: torch.randint(0, 8, (M, K), generator=gen, dtype=torch.int8,
                            device=DEV) for M in TRAINED_LINEAR_MS}

    def kernel(aq):
        return ops.tlmac_matmul(aq, sp["table_narrow"], sp["exec_idx"],
                                sp["step_cluster"], B_a=3, G=4, N=N,
                                impl="fused")

    def plain(aq):
        return ops.tlmac_matmul(aq.cpu(), sp_cpu["table"],
                                sp_cpu["exec_idx"], sp_cpu["step_cluster"],
                                B_a=3, G=4, N=N, impl="fused")

    n0 = tf.launches
    for M, aq in aqs.items():
        got = kernel(aq)
        _equal(f"trained {label} M={M}: kernel 1 vs plain", got.cpu(),
               plain(aq))
        _equal(f"trained {label} M={M}: kernel 1 vs dense_int_matmul", got,
               ops.dense_int_matmul(aq, w))
    launches = tf.launches - n0
    if DEV == "cuda" and launches != len(TRAINED_LINEAR_MS):
        raise AssertionError(f"kernel 1 launched {launches} times")
    idx, cl, tab = sp["exec_idx"], sp["step_cluster"], sp["table_narrow"]
    nt, kg, dp = idx.shape
    rows = {}
    for M, aq in aqs.items():
        nbytes = (aq.numel() + idx.numel() * idx.element_size() + cl.numel()
                  * cl.element_size() + tab.numel() * tab.element_size()
                  + M * N * 4)
        b = _gemm_bound(M, kg, N, 4, nbytes)
        rows[M] = dict(bound_ms=b["bound_ms"], bound_by=_bound_by(b))
        if DEV == "cuda":     # graph replay, as the kernel table's rows
            lib = _onehot_int_mm(tf, aq, idx, cl, tab, 3, 4)
            rows[M].update(
                ms=graph_ms(lambda: tf.tlmac_gemm_fused(aq, idx, cl, tab,
                                                        B_a=3, G=4)),
                plain_ms=cuda_ms(lambda: plain(aq), iters=1, warmup=0),
                library_ms=graph_ms(lib))
        r = rows[M]
        log(f"  {gpu}: kernel 1 on the trained {label} {K}->{N} (N_arr "
            f"{plan.N_arr}, dp {dp}), M {M}: == plain == dense_int_matmul; "
            + (f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, one-hot "
               f"_int_mm {r['library_ms']:.4f} ms, " if "ms" in r else "")
            + f"bound {b['bound_ms']:.4f} ms ({_bound_by(b)})")
    log(f"  trained {label}: codes "
        f"{np.bincount(codes.ravel() + 4, minlength=8).tolist()} (-4..3), "
        f"compiled in {secs:.1f} s (host), verify_plan holds; {launches} "
        "kernel 1 launches on the checks")
    return dict(shape=[K, N], compile_s=secs, N_arr=plan.N_arr, rows=rows,
                launches=launches), launches


def _sharded_train_moe_rank(rank: int, world: int, tmp: str,
                            dev_type: str) -> None:
    """One rank of phase 15: deepseek-v3's 3 dense MLA layers at full width
    and the widened MoE smoke trained unsharded and sharded under a (1,
    world) mesh, bit for bit; then (rank 0) the MoE smoke's step card vs
    CPU and the two trained shards on kernel 1; rank 0 writes the figures
    to ``tmp/rank0.json``."""
    from repro_torch.configs import smoke_config

    with _train_rank(rank, world, tmp, dev_type, deterministic=True) as (
            dev, mesh):
        out = {"world": world, "mesh": [1, world], "models": {}}
        mla = _cut_config(STRAIN_MOE_ARCH, STRAIN_MOE_LAYERS)
        out["models"]["deepseek-v3-671b MLA"], wq_a = _sharded_train_model(
            mla, mesh, dev,
            pick=_layer0_linear(("segments", 0, "b0", "attn", "wq_a")),
            tc=_moe_train_config(mla), strict=True)
        moe = dataclasses.replace(smoke_config("deepseek-v3-671b"),
                                  **MOE_TRAIN_WIDE)
        out["models"]["deepseek-v3 MoE smoke"], wi = _sharded_train_model(
            moe, mesh, dev, pick=_expert0_wi, tc=_moe_train_config(moe),
            strict=True, of_layers=moe.n_layers)
        if rank == 0:
            gpu = gpu_line() if dev_type == "cuda" else "cpu"
            out["card_vs_cpu"] = train_step_card_vs_cpu(moe)
            out["trained"], n = {}, 0
            for label, trained, d_p in (
                    ("deepseek-v3 layer 0 attn.wq_a", wq_a, 128),
                    ("MoE smoke expert 0 moe.wi", wi, 64)):
                out["trained"][label], k = _trained_shard_on_kernel1(
                    label, trained, gpu, d_p)
                n += k
            out["launches"] = n
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)


def phase_sharded_train_moe(world: int = 0) -> dict:
    """Phase 15: the QAT train step of the MoE and MLA decoders sharded
    under a (1, world) mesh (experts over 'model', MLA on each rank's
    heads, int8 moments by the reference's ``_opt_axes``, int8 gradient
    compression on each rank's block of the global gradient), one NCCL
    rank per visible card.  Returns rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    t0 = time.perf_counter()
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    # run 1 peaks near the card's size
    out = _spawn_train(_sharded_train_moe_rank, world, grow=True)
    for label, r in out["models"].items():
        depth = ("full depth" if r["layers"] == r["of_layers"] else
                 f"{r['layers']} of {r['of_layers']} layers")
        log(f"  {label} ({depth}, {r['layout']}, {r['moments']} moments, "
            f"accum {r['accum']}, compression {r['compress']}), batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, WSD, {STRAIN_STEPS} steps: "
            f"sharded vs unsharded {r['equal']}")
        log(f"    loss {r['loss']} |g| {r['gnorm']} (unsharded "
            f"{r['plain_loss']}, {r['plain_gnorm']}); a step: sharded "
            f"{[round(x, 1) for x in r['step_ms']]} ms, unsharded "
            f"{[round(x, 1) for x in r['plain_step_ms']]} ms (the second "
            f"{TRAIN_BATCH * TRAIN_SEQ / r['plain_step_ms'][-1] * 1e3:.1f} "
            f"tokens/s unsharded); {r['reckoning']['params'] / 1e9:.3f} B "
            f"params; peak {r['peak_gib']:.2f} GiB sharded, "
            f"{r['plain_peak_gib']:.2f} GiB unsharded [{gpu}]")
        log("    collectives step 0 (kind: count/bytes, of them backward) "
            + "; ".join(f"{k} {c['count']}/{c['bytes']} ({c['backward_count']}"
                        f"/{c['backward_bytes']})"
                        for k, c in r["collectives"].items())
            + f"; parameter collectives {r['param_collectives']}; of them "
            "the compression's "
            + ("; ".join(f"{k} {c['count']}/{c['bytes']}"
                         for k, c in (r["compress_collectives"] or {}).items())
               or "none"))
        for i, e in enumerate(r["equal"]):
            if not all(e[k] for k in ("loss", "gnorm", "params", "moments")):
                raise AssertionError(f"{label} step {i}: {e}")
            if not (math.isfinite(r["loss"][i])
                    and math.isfinite(r["gnorm"][i])):
                raise AssertionError(f"{label} step {i}: loss {r['loss']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the sharded QAT train step of the enc-dec, VLM and recurrent
# families
# ---------------------------------------------------------------------------

# label: (arch, layers kept (None: full depth), batch, tokens, frames);
# widths are never cut.  seamless-m4t-medium whole (12 + 12) with 512
# frames; internvl2-76b 1 of 80 layers with its 256-row front (16 bytes a
# parameter at f32 moments: its two vocab tables 33.6 GB, a layer 13.7 GB;
# 2 layers peaked at 76.59 GiB alone on the card and ran out of memory
# after the earlier phases, AdamW's temporaries of the 4.2 GB tables
# past the reckoning); recurrentgemma-2b two whole
# (rglru, rglru, attn_local) patterns; xlstm-350m one 7 + 1 pattern (fewer
# layers hold no sLSTM) at 128 tokens (its scans are a loop over time)
SFAM_TRAIN_PHASE = ("sharded enc-dec, VLM and recurrent train: the QAT "
                    "step under a (data, model) mesh")
SFAM_TRAIN = {
    "seamless-m4t-medium": ("seamless-m4t-medium", None, 2, 512, 512),
    "internvl2-76b": ("internvl2-76b", 1, 1, 768, 0),
    "recurrentgemma-2b": ("recurrentgemma-2b", 6, 2, 1024, 0),
    "xlstm-350m": ("xlstm-350m", 8, 2, 128, 0),
}
# the trained linears compiled back onto kernel 1, each one rank's block of
# the production meshes' 16-way 'model' axis (its first SHARD_WAY-th of the
# columns): label: (model, path of the stacked leaf, dp of the plan)
SFAM_TRAINED = {
    "internvl2-76b layer 0 attn.wq": (
        "internvl2-76b", ("segments", 0, "b0", "attn", "wq"), 128),
    "seamless-m4t-medium decoder layer 0 xattn.wq": (
        "seamless-m4t-medium", ("segments", 0, "b0", "xattn", "wq"), 64),
}


def _sharded_train_families_rank(rank: int, world: int, tmp: str,
                                 dev_type: str, models: dict) -> None:
    """One rank of phase 17: every model of ``models`` (``SFAM_TRAIN``'s
    form) trained unsharded and sharded under a (1, world) mesh, bit for
    bit; then (rank 0) ``SFAM_TRAINED``'s trained shards on kernel 1; rank
    0 writes the figures to ``tmp/rank0.json``."""
    import torch

    from repro_torch.configs import get_config

    with _train_rank(rank, world, tmp, dev_type, deterministic=True) as (
            dev, mesh):
        out = {"world": world, "mesh": [1, world], "models": {},
               "trained": {}}
        picked = {}
        for label, (arch, layers, B, S, frames) in models.items():
            cfg = _cut_config(arch, layers)
            picks = {k: _layer0_linear(path, SHARD_WAY)
                     for k, (a, path, _) in SFAM_TRAINED.items()
                     if a == arch}
            fig, got = _sharded_train_model(
                cfg, mesh, dev, strict=True, B=B, S=S, frames=frames,
                of_layers=get_config(arch).n_layers,
                pick=(lambda tree, c: {k: f(tree, c)
                                       for k, f in picks.items()})
                if picks else None)
            out["models"][label] = dict(fig, batch=[B, S], frames=frames)
            picked.update(got or {})
            gc.collect()
            if dev_type == "cuda":
                torch.cuda.empty_cache()
        if rank == 0:
            gpu = gpu_line() if dev_type == "cuda" else "cpu"
            n = 0
            for label, trained in picked.items():
                out["trained"][label], k = _trained_shard_on_kernel1(
                    label, trained, gpu, SFAM_TRAINED[label][2])
                n += k
            out["launches"] = n
            with open(os.path.join(tmp, "rank0.json"), "w") as f:
                json.dump(out, f)


def phase_sharded_train_families(world: int = 0,
                                 models: dict = SFAM_TRAIN) -> dict:
    """Phase 17: the QAT train step of the enc-dec, VLM and recurrent
    families sharded under a (1, world) mesh (the encoder sequence-sharded
    and gathered once for every decoder block's cross K/V, a VLM's front
    rows before the tokens in the sequence cut, the RG-LRU on each rank's
    channels and the xLSTM cells in the serve layout, over the whole
    sequence), one NCCL rank per visible card (world 1 on one card: every
    collective is issued over its one-rank group), each bit for bit with
    its unsharded step; then two trained 16-way shards on kernel 1.
    Returns rank 0's figures."""
    import torch

    world = world or torch.cuda.device_count()
    gpu = gpu_line() if DEV == "cuda" else "cpu"
    t0 = time.perf_counter()
    log(f"  world size {world}: one {'NCCL' if DEV == 'cuda' else 'gloo'} "
        f"rank per visible card, mesh (data 1, model {world})")
    # internvl2's run peaks near the card's size
    out = _spawn_train(_sharded_train_families_rank, world, models,
                       grow=True)
    for label, r in out["models"].items():
        depth = ("full depth" if r["layers"] == r["of_layers"] else
                 f"{r['layers']} of {r['of_layers']} layers")
        B, S = r["batch"]
        extra = f" + {r['frames']} frames" if r["frames"] else ""
        log(f"  {label} ({depth}, full width, {r['layout']}), batch {B} x "
            f"{S}{extra}, WSD, {STRAIN_STEPS} steps: sharded vs unsharded "
            f"{r['equal']}")
        log(f"    loss {r['loss']} |g| {r['gnorm']} (unsharded "
            f"{r['plain_loss']}, {r['plain_gnorm']}); a step: sharded "
            f"{[round(x, 1) for x in r['step_ms']]} ms, unsharded "
            f"{[round(x, 1) for x in r['plain_step_ms']]} ms; "
            f"{r['reckoning']['params'] / 1e9:.3f} B params; peak "
            f"{r['peak_gib']:.2f} GiB sharded, {r['plain_peak_gib']:.2f} GiB "
            f"unsharded, reckoned {r['reckoning']['peak_gb']:.1f} GB [{gpu}]")
        log("    collectives step 0 (kind: count/bytes, of them backward) "
            + "; ".join(f"{k} {c['count']}/{c['bytes']} ({c['backward_count']}"
                        f"/{c['backward_bytes']})"
                        for k, c in r["collectives"].items())
            + f"; parameter collectives {r['param_collectives']}")
        for i, e in enumerate(r["equal"]):
            if not all(e.values()):
                raise AssertionError(f"{label} step {i}: {e}")
            if not (math.isfinite(r["loss"][i])
                    and math.isfinite(r["gnorm"][i])):
                raise AssertionError(f"{label} step {i}: loss {r['loss']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("all", "kernels", "k12",
                                       "serve-families", "train",
                                       "parallel", "sharded",
                                       "sharded-train", "sharded-moe",
                                       "sharded-train-moe",
                                       "sharded-families",
                                       "sharded-train-families"),
                    default="all",
                    help="all (default); kernels (build + kernel phases); "
                         "k12 (kernels 1-2 timed, one JSON line); "
                         "serve-families (kernels 1-2 built, the dense-"
                         "forward families); train (kernels 1, 4 and 3 "
                         "built, the training stack (a)-(g), one JSON "
                         "line); parallel (kernel 1 built: the rings, "
                         "the pipeline, the dry run and its trace held on "
                         "the card, one JSON line); "
                         "sharded (kernel 1 built: the dense serve "
                         "forwards under a (1, cards) mesh and kernel 1 at "
                         "the 16-way shard shapes, one JSON line); "
                         "sharded-train (kernel 1 built: the QAT train "
                         "step of minicpm-2b and codeqwen1.5-7b under a "
                         "(1, cards) mesh, the trained ffn.wi on kernel 1, "
                         "one JSON line); sharded-moe (kernels 1 and 7 "
                         "built: deepseek-v3, kimi-k2 and int8 moe-gqa "
                         "served under a (1, cards) mesh, kernels 1 and 7 "
                         "at a 16-way block's expert stacks, one JSON "
                         "line); sharded-train-moe (kernel 1 built: the "
                         "QAT train step of deepseek-v3's dense MLA layers "
                         "and of the widened MoE smoke under a (1, cards) "
                         "mesh with int8 moments and compression, the "
                         "trained wq_a and expert wi on kernel 1, one JSON "
                         "line); sharded-families (kernel 1 built: "
                         "recurrentgemma-2b, xlstm-350m, seamless-m4t-medium "
                         "and internvl2-76b with its front served under a "
                         "(1, cards) mesh, kernel 1 at their 16-way shard "
                         "shapes, one JSON line); sharded-train-families "
                         "(kernel 1 built: the QAT train step of those four "
                         "under a (1, cards) mesh, the trained internvl2 "
                         "wq and seamless xattn.wq shards on kernel 1, one "
                         "JSON line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    _fresh_autotune_cache()
    log(gpu_line())
    t0 = time.perf_counter()
    sources = {"k12": SOURCES[:2], "serve-families": SOURCES[:2],
               "parallel": SOURCES[:1],
               "train": TRAIN_SOURCES, "sharded": SOURCES[:1],
               "sharded-train": SOURCES[:1],
               "sharded-train-moe": SOURCES[:1],
               "sharded-families": SOURCES[:1],
               "sharded-train-families": SOURCES[:1],
               "sharded-moe": (SOURCES[0], SOURCES[-1])}.get(
        args.only, SOURCES)
    dry_runs = (start_dry_runs() if args.only in ("all", "parallel")
                else None)
    logs = _build.build(sources)
    log(f"build: {' + '.join(n + '.cu' for n in sources)} with nvcc -arch "
        f"sm_90a in {time.perf_counter() - t0:.1f} s (parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if args.only == "parallel":
        phase("parallel layer: rings, pipeline, dry run")
        par = phase_parallel(dry_runs)
        par["dry_run_card"] = phase_dry_run_card()
        log(json.dumps({"parallel": par}))
        return 0
    if args.only == "sharded":
        phase("sharded serve: the dense forwards under a (data, model) mesh")
        log(json.dumps({"sharded": phase_sharded()}))
        return 0
    if args.only == "sharded-moe":
        phase("sharded MoE and MLA serve: expert parallelism under a (data, "
              "model) mesh")
        log(json.dumps({"sharded_moe": phase_sharded_moe()}))
        return 0
    if args.only == "sharded-train":
        phase("sharded train: the QAT train step under a (data, model) mesh")
        log(json.dumps({"sharded_train": phase_sharded_train()}))
        return 0
    if args.only == "sharded-train-moe":
        phase("sharded MoE and MLA train: experts over 'model', int8 "
              "moments and compression under a (data, model) mesh")
        log(json.dumps({"sharded_train_moe": phase_sharded_train_moe()}))
        return 0
    if args.only == "sharded-families":
        phase(SFAM_PHASE)
        log(json.dumps({"sharded_families": phase_sharded_families()}))
        return 0
    if args.only == "sharded-train-families":
        phase(SFAM_TRAIN_PHASE)
        log(json.dumps({"sharded_train_families":
                        phase_sharded_train_families()}))
        return 0
    if args.only == "train":
        train, _ = phase_train()
        log(json.dumps({"train": train}))
        return 0
    if args.only == "serve-families":
        runs, _ = phase_serve_families()
        phase("card vs CPU on the recurrent and enc-dec smoke configs")
        phase_dense_reference()
        log(json.dumps({"serve_families": runs}))
        return 0
    phase("lookup GEMM vs plain (int32, must be equal)")
    gemm = phase_gemm(chunk=CHUNK, batch=4, verify=4 * (SPEC_K + 1))
    if args.only == "k12":
        phase("flash-decode at the main path's shape")
        flash = flash_main_timing(torch.Generator(device="cuda").manual_seed(2))
        log(json.dumps({"k12": {"kernel1_layer_ms": gemm["ms"],
                                "kernel2_ms": flash["ms"]}}))
        return 0
    phase_gemm_edges()
    phase_gemm_domain()
    phase("flash-decode vs plain")
    flash = phase_flash()
    phase("kernels 1-2 at the dense families' shapes vs plain")
    flash["max_abs_err"] = max(flash["max_abs_err"], phase_family_kernels())
    phase("kernels 3-6 vs plain on small compiled plans")
    phase_lookup_small()
    phase_clustered_domain()
    phase("full-width ResNet-18, 16 convs compiled on the host")
    from repro_torch.configs.resnet18 import CONFIG as rcfg

    rparams, plans = compile_full_resnet(rcfg)
    phase("kernels 1 and 3-6 at the ResNet-18 conv shapes")
    lookup = phase_resnet_kernels(rcfg, rparams, plans)
    # launches are counted on the main paths only: null when they did not run
    counts = dict.fromkeys(["tlmac_gemm_fused", "flash_decode", *lookup])
    if args.only == "all":
        phase("main path (serve)")
        cfg, params = init_main_model()
        main_counts, main_run = phase_main(cfg, params)
        counts.update(main_counts)
        phase("autotune: the main path under 'auto' after tuning")
        phase_autotune(cfg, params, main_run)
        phase("serve features: shared prefix, pool pressure")
        phase_serve_features(cfg, params)
        phase("serve speculation: n-gram and replay drafters, verify graph")
        phase_serve_spec(cfg, params)
        phase("serve telemetry: the main path's requests, telemetry on")
        phase_telemetry(cfg, params, main_run)
        phase("swap round trip: full-width pools through the staging ring")
        phase_swap_roundtrip(cfg)
        phase("serve under pool pressure with swap")
        phase_serve_swap(cfg, params, main_run)
        phase("faults, cancellation, deadlines, tenants")
        phase_faults(cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase_families()
        phase("moe-gqa at deepseek-v3-671b's widths (serve, 11 of 61 layers)")
        moe = phase_moe()
        flash["max_abs_err"] = max(flash["max_abs_err"],
                                   moe["expert_rows"]["flash_max_abs_err"])
        gemm["expert_stack"] = dict(
            shape="one MoE layer's wi/wg/wo, 256 experts, M=4",
            ms=moe["expert_rows"].get(4, {}).get("ms"),
            bound_ms=moe["expert_rows"].get(4, {}).get("bound_ms"),
            launches_moe_path=moe["counts"]["tlmac_gemm_fused_expert"],
            launches_moe_path_all=moe["counts"]["tlmac_gemm_fused"])
        phase("int8 moe-gqa: expert stacks on the int8 expert kernel "
              "(3 dense + 2 MoE of 61 layers)")
        int8_row = phase_int8_experts()
        for name, L in MLA_CUTS.items():
            phase(f"{name} with MLA (dense ServeLoop, {L} of 61 layers)")
            phase_mla(name)
        runs, mistral_counts = phase_serve_families()
        gemm["launches_by_path"] = dict(
            {n: r["launches"] for n, r in runs.items()},
            **{"mistral-large-123b": mistral_counts["tlmac_gemm_fused"]})
        flash["launches_by_path"] = {
            "mistral-large-123b": mistral_counts["flash_decode"]}
        train, train_launches = phase_train()
        gemm["launches_by_path"].update(train_launches["tlmac_gemm_fused"])
        for name in ("pack_bitplanes", "tlmac_gemm"):
            lookup[name]["launches_by_path"] = train_launches[name]
        phase("card vs CPU on smoke configs")
        phase_reference()
        phase_mla_reference()
        phase_dense_reference()
        phase("paper path (ResNet-18 compile-and-execute)")
        counts.update(phase_paper_path(rcfg, rparams, plans))
        phase("parallel layer: rings, pipeline, dry run")
        phase_parallel(dry_runs)
        phase_dry_run_card()
        gc.collect()
        torch.cuda.empty_cache()
        phase("sharded serve: the dense forwards under a (data, model) mesh")
        sharded = phase_sharded()
        gemm["launches_by_path"].update(
            {f"sharded {a}": r["launches"]
             for a, r in sharded["models"].items()})
        gemm["shard_shapes"] = sharded["shard_gemms"]
        gc.collect()
        torch.cuda.empty_cache()
        phase("sharded MoE and MLA serve: expert parallelism under a (data, "
              "model) mesh")
        smoe = phase_sharded_moe()
        for label, r in smoe["models"].items():
            n = r["kernel_launches"]
            if n["tlmac_gemm_fused"]:
                gemm["launches_by_path"][f"sharded {label}"] = n[
                    "tlmac_gemm_fused"]
            if n["int8_experts"]:
                int8_row.setdefault("launches_by_path", {})[
                    f"sharded {label}"] = n["int8_experts"]
        blocks = smoe["expert_blocks"]
        gemm["expert_block_shapes"] = {
            k: v for k, v in blocks.items() if v["kernel"] == gemm["name"]}
        int8_row["expert_block_shapes"] = {
            k: v for k, v in blocks.items() if v["kernel"] == "int8_experts"}
        gc.collect()
        torch.cuda.empty_cache()
        phase("sharded train: the QAT train step under a (data, model) mesh")
        strain = phase_sharded_train()
        gemm["launches_by_path"][
            f"sharded-train {TRAIN_ARCH} trained ffn.wi"] = strain["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        phase("sharded MoE and MLA train: experts over 'model', int8 "
              "moments and compression under a (data, model) mesh")
        smt = phase_sharded_train_moe()
        gemm["launches_by_path"][
            "sharded-train-moe trained wq_a and expert wi"] = smt["launches"]
        gemm["trained_shards"] = {
            label: dict(shape=t["shape"], **{f"M{M}": row for M, row in
                                              t["rows"].items()})
            for label, t in smt["trained"].items()}
        gc.collect()
        torch.cuda.empty_cache()
        phase(SFAM_PHASE)
        sfam = phase_sharded_families()
        gemm["launches_by_path"].update(
            {f"sharded {a}": r["launches"]
             for a, r in sfam["models"].items()})
        gemm["family_shard_shapes"] = sfam["shard_gemms"]
        gc.collect()
        torch.cuda.empty_cache()
        phase(SFAM_TRAIN_PHASE)
        sft = phase_sharded_train_families()
        gemm["launches_by_path"][
            "sharded-train-families trained wq and xattn.wq"] = sft[
                "launches"]
        gemm["trained_shards"].update({
            label: dict(shape=t["shape"], **{f"M{M}": row for M, row in
                                              t["rows"].items()})
            for label, t in sft["trained"].items()})
    kernels = [gemm, flash, *lookup.values()]
    for k in kernels:
        k["launches"] = counts[k["name"]]
    if args.only == "all":
        kernels.append(int8_row)
    log(json.dumps({"kernels": kernels}))
    if args.only != "all":
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_background()
