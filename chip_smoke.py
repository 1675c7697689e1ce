"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every CUDA kernel from
               ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
               parallel) and print the build seconds;
  2. kernels - hold each kernel against its plain PyTorch version on the
               card, at the main paths' shapes (windowed attention and
               GAR at gemma3's widths among them) and at ragged ones (ssd
               also over three chunks and at steps whose sums pass
               float32's exponent range), and
               time kernel, plain version and (where one exists) one
               PyTorch library call with CUDA events; log the attention
               kernels' split scratch at gemma3's T 264; a
               tensor-parallel rank's GAR products (the fused call's stage
               1 alone, and the stage-2 entry ``gar_tail`` on a given z)
               at llama4-scout-17b-a16e's attn/q shard of (1, 2) and at
               ragged shapes;
  3. serve   - serve gpt2-small at full width (random weights from a seed,
               the serving launcher's calibrated DataSVD state) through
               ``ElasticEngine``: 8 requests at budgets 0.4 and 1.0, half
               greedy, half temperature 0.8 / top-k 40; the launch counts
               of the three serving kernels must be > 0;
  4. cross   - one greedy request through the same state on the card and on
               the CPU (plain versions): the tokens must be identical;
  5. train   - FlexRank consolidation of gpt2-small at full width through
               ``repro_torch.launch.train.run``: calibration (8 batches of
               8 x 129 tokens), DataSVD and DP, 20 AdamW steps of
               stochastic-budget distillation, per-row CE before and after;
               losses finite and ``lowrank_matmul`` launched;
  6. cross   - one training step (batch 2 x 32 tokens, budget row 0) from
               the trained factors on the card and on the CPU: the loss and
               every gradient leaf must agree;
  19. modes  - run right after phase 6, on phase 5's gpt2-small dense
               weights and trained factors (full width, 8 x 128): (a) 3
               steps (5 until the smoke passed 1050 s) of ``--mode
               dense`` through ``make_train_step`` (under
               ``remat_blocks``), then one loss and gradient with and
               without remat from the same state (TOL_TRAIN_LOSS,
               TOL_TRAIN_GRAD; ms and activation peak of each); (b) 3 steps
               of ``--mode flexrank`` on the uniform table; (c) 3 steps of
               ``flexrank_kd`` with Muon, ``apply_updates`` timed by CUDA
               events and ``newton_schulz`` on the embedding; (b) and (c)
               must launch ``lowrank_matmul``; (d) one step of each at 2
               layers card vs CPU (loss, gradients, updated parameters);
               (e) PowerSGD over (a)'s gradients card vs CPU from one
               ``init`` (TOL_POWERSGD), its compression ratio; (f) the
               launcher at full width, ``--mode dense --steps 6
               --ckpt-every 2``: a real SIGTERM after step 3 through
               ``PreemptionGuard``, the restart from step 4, against an
               uninterrupted run (TOL_TRAIN_LOSS, bit identity logged), at
               2 of the 12 layers, and the uninterrupted run again with
               ``--mesh-shape 4,1`` (a 1 x 1 mesh on one card): bit for
               bit;
               (g) ``nestedness.train(nsl_loss)``, 1000 steps on the 6 x 5
               target, card vs CPU (TOL_NESTED) and Theorem 4.3's gaps;
  7. rwkv6   - the same consolidation of rwkv6-3b at full width cut to 4
               of its 32 layers (8 until the smoke passed 1050 s with phase
               19), 5 steps; ``wkv6`` and ``lowrank_matmul``
               launched, losses and CE finite; then one training step card
               vs CPU at 2 layers;
  8. zamba2  - the same for zamba2-7b at full width cut to one
               ``zamba_unit`` (5 Mamba2 layers, the shared attention block,
               the unit's FFN) and one trailing Mamba2 layer, 5 steps;
               ``ssd`` (two launches a call, counted in whole calls) and
               ``lowrank_matmul`` launched; the card-vs-CPU step at 2
               Mamba2 layers (one in the unit, one trailing);
  9. decode  - the pure-decode path on gpt2-small: 8 prompts of 90-159
               tokens fill a ``PagedKVCache`` through ``paged_mixed_step``,
               then 32 greedy steps of ``paged_decode_step`` over
               ``model_caches()`` at budget rows 0 and 6, each held against
               the same step through ``paged_mixed_step`` with one token a
               slot (logits within TOL_DECODE, greedy tokens identical); the
               decode kernel launched;
  10. gemma3 - gemma3-27b at full width cut to 2 of its 62 layers, every
               2nd global (a windowed layer and a global one: the 5:1
               local:global pattern's two kinds of layer): the serving
               launcher's state, GAR at its shapes (T 8 and 264), 4
               requests (8 until the smoke passed 1050 s with phase 20)
               of 1100-1500 prompt tokens (past the 1024-token
               window) and 32 new through ``ElasticEngine(prefill_chunk=256,
               max_batch=8, max_len=2048)`` at budgets 0.4 and 1.0; the
               decode check of phase 9 (its card vs CPU request on 2
               layers went when phase 21 took gpt2-small's partitioned
               flexrank run and the smoke passed 1050 s); every kernel of
               the path launched; then the spec check of phase 11 on the same
               engine and requests, with the draft rank that makes row 0
               (already deployed) the top row's draft row;
  11. spec   - nested self-speculative decoding of gpt2-small on phase 3's
               engine and requests: served plain, then with
               ``SpecConfig(draft_rank=0.7, spec_len=4)``, then with
               ``stochastic=False``, then the greedy half at budget 1.0 (the
               greedy requests sit on the bottom row, which has no draft
               row) plain and speculative, and the top row drafting for
               itself (greedy drafts all accepted but at near ties: the
               draft path's own check, since random weights leave the
               prefix rows' acceptance near 0). Every speculative round is
               queued under the sync debug mode "error" up to the read of
               its commit; ``gar_matmul``, ``paged_prefill_attention`` and
               ``topk_mask_sample`` (and its probs variant) launched; each
               greedy and verify-only stream equals the plain one or parts
               from it at a near tie (``TOL_SPEC_TIE``);
  12. stream - the one-iteration lookahead pipeline and the streaming
               front door on phase 3's engine and requests: (a) served with
               lookahead, timed in turns with the synchronous loop (sync,
               lookahead, lookahead, sync, sync, lookahead), streams
               identical to phase 3's
               and the three serving kernels launched; (b) with forced
               rollbacks every third iteration, in turns with plain
               lookahead runs, identical, rollbacks > 0;
               (c) a ``StreamSession`` on a worker thread, Poisson arrivals
               at 20 requests/s, every third request cancelled after 2
               tokens: the others equal phase 3's streams (the arrivals
               change the batches, so a parting is allowed at a near tie
               only), cancelled Results prefixes of them, the caches empty
               at the end; TTFT on the client's and the engine's clocks and
               the lag from the engine's emit to the client; (d) every
               pipelined iteration planned, dispatched and advanced under
               the sync debug mode "error". Phase 10 serves its requests
               with prefix caching, lookahead and sync in turns (lookahead,
               sync, sync, lookahead; the lookahead runs under the same
               mode): streams identical to its plain run.
  13. drain  - the drain engine and the carried decode states: (a) right
               after phase 7, rwkv6-3b's trained factors, table and infos
               (its optimizer state freed) served at full width (4 of 32
               layers) through ``ElasticEngine(max_batch=8, max_len=256)
               .generate`` with ``mode="auto"``, which must route to drain:
               4 requests of 96-128 prompt tokens (the batch's longest
               128, a multiple of rwkv6's chunk) and 32 new at budget 0.4
               (row 0 alone: 8 requests at 0.4 and 1.0 until the smoke
               passed 1050 s with phase 20), greedy and temperature 0.8 /
               top-k 40 mixed in the batch, every prefill, decode step and
               draw under the
               sync debug mode "error"; ``gar_matmul`` and
               ``topk_mask_sample`` launched; each shorter prompt's stream
               holds its padding; tokens/s, TTFT, prefill and decode ms
               (host clock and device time), deploy seconds and peak
               memory; GAR at channel/k, row 0, T 1024; one greedy
               request's prefill and decode logits against ``forward`` of
               the whole sequence (TOL_DRAIN_FORWARD); the same request
               card vs CPU on phase 7's 2-layer cut, identical or parting
               at a near tie only, the logits of the steps fed the same
               tokens within TOL_DRAIN_FORWARD. (b) the same for zamba2-7b right after
               phase 8 (one unit and one Mamba2 layer; GAR at in_proj, row
               0, m 14576, T 8 and 1024; card vs CPU on phase 8's cut).
               (c) after phase 12, each of phase 3's requests alone
               through the drain batch (keyed by its phase-3 index)
               against its phase-3 stream, then the 8 through
               ``generate(mode="drain")``: each batch's longest prompt
               against its solo run; equal, or parting at a near tie only
               (``TOL_SPEC_TIE``).
  14. moe    - deepseek-moe-16b at full width cut to 2 of its 28 layers
               (the dense layer 0 and one MoE layer: 64 experts, top-6 of
               1408, 2 shared; 3 layers until the smoke passed 1050 s with
               phase 20): the serving launcher's state (one
               whitening per MoE layer's moment for its 64 experts), GAR
               at layer 0's FFN (m 10944) and the shared experts (m
               2816), T 8 and 72; phase 3's prompts, budgets and sampling
               through ``ElasticEngine(prefill_chunk=64, max_batch=8,
               max_len=256)``, the three serving kernels launched; the
               same with lookahead under the sync debug mode "error",
               streams identical; one ``moe_apply`` call's device time at
               T 8 and 72 split into the expert products and the rest, and
               the decode iteration of 8 slots (host clock, kernel time
               under ``torch.profiler``, the expert products' share);
               phase 9's decode check at ``capacity_factor =
               num_experts * ceil(4 / top_k)`` (no drops, and both steps'
               expert products at the same shapes: ``nodrop_capacity``);
               one greedy request card vs CPU on the same 2 layers: a
               token whose expert set differs
               must be a near tie of its own routing (``TOL_ROUTE``, each
               logged), the logits agree within ``TOL_MOE_CROSS`` until
               such a token, and the tokens are equal or part at a near
               tie of the logits (``TOL_SPEC_TIE``) or after a routing
               near tie;
  20. llama4 - right after phase 14, llama4-scout-17b-a16e at full width
               cut to 1 of its 48 layers (16 experts, top-1 of 8192, one
               shared; GQA 40/8, a head group of 5; vocab 202048): the
               predicted seconds first, dense and factorized parameter
               counts at 1 and 48 layers, then phase 14's checks with
               every request at budget 0.4 and row 0 alone deployed (GAR at
               attn/q and mlp/shared/gate, T 8 and 72). Phase 2 holds both
               attention kernels at its G 5 (T 8, T 72, decode B 8, and
               ragged cases) and the sampler at V 202048;
  15. mla    - minicpm3-4b at full width cut to 8 of its 62 layers: the
               serving launcher's state, then phase 13's drain checks
               (``generate(mode="auto")`` must route MLA to drain; GAR
               at attn/q_up and mlp/gate, T 8 and 512; the absorbed
               decode from the latent cache against ``forward``
               (TOL_DRAIN_FORWARD); card vs CPU at 2 layers).
  16. audio  - seamless-m4t-medium at full width, cut to 6 encoder and
               6 decoder layers of its 12 + 12: the serving launcher's
               state (text only calibration: the encoder's, the cross
               blocks' and ``frontend_proj``'s groups take plain SVD,
               logged), every cross block's ``gate`` then drawn from
               U(0.5, 1.5); phase
               13's drain checks (text-only requests: the encoder and the
               cross blocks do not run; GAR at the decoder's mlp/gate, T
               8 and 512, and at the multimodal check's T 4096:
               ``frontend_proj``, the encoder's attn/q and mlp/gate, the
               cross attn/k); card vs CPU at 1 + 1 layers. Then the
               multimodal check at row 0 (and the top row until the smoke
               passed 1050 s with phase 20): 4 prompts of 64
               tokens and 4 x 1024 audio frames, 16 greedy tokens (i) by
               ``forward(frontend=)``, (ii) by ``prefill``/``decode_step``
               with the encoder's output every step, (iii) by
               ``attach_cross_kv`` and one token a step; (ii) and (iii)
               identical with logits within TOL_DECODE, both within
               TOL_DRAIN_FORWARD of (i), every step under the sync debug
               mode "error"; ``run_encoder``, ``attach_cross_kv`` and a
               decode step of (ii) and of (iii) timed (host clock and
               kernel time); the same check card vs CPU at 1 + 1 layers on
               the first request.
  17. vision - llama-3.2-vision-11b at full width, one unit (4 self
               blocks and the cross block): phase 16's checks, with 4 x
               1601 image patches of width 7680 (passed raw every step to
               (ii), projected once by ``frontend_proj`` for (iii)), GAR at
               the self blocks' mlp/gate (T 8, 512), ``frontend_proj`` and
               the cross attn/k (T 6404), ``frontend_proj`` timed in place
               of the encoder; card vs CPU on one unit of 1 self block and
               the cross block.
  18. telemetry - the live telemetry plane on phase 3's state and
               requests (gpt2-small, full width): (a) plane off (phase 3's
               engine) and on (an engine built with ``RingTracer(4096)``,
               ``MetricsRegistry()``, ``Watchdog`` at its default
               thresholds with a postmortem directory, ``costaudit=True``)
               in turns, one each (three each until phase 21 took
               the partitioned runs): streams identical to phase 3's; a
               thread scrapes a ``StatusServer`` on port 0 (``/metrics``,
               ``/statusz``, ``/debug/trace?last_s=30``) every 0.25 s of an
               on-run and once after, at least once mid-run, each answer
               parsed and each dump valid, ``/metrics`` with the audit's
               error ratios; the
               registry's token counters equal ``ServingMetrics``'; tokens/s
               on against off, the audit's bandwidth and error ratios;
               (b) with lookahead (the sync debug mode "error" around
               planning, dispatch and the predicted advance) and
               speculatively (phase 11's settings, "error" around
               ``_enqueue_round``), plane on: streams identical to phase
               3's and to phase 11's speculative run, one watchdog tick an
               iteration; (c) in the lookahead run a TTFT SLO of 1e-6 s
               fires: its bundle's ring dump validates and its
               ``state.json`` has ``statusz``'s keys; (d)
               ``obs.profiling.profile`` around a sampled request (and a
               greedy one on the host sampling path): the trace names
               ``paged_sample_step``, ``paged_mixed_step`` and the three
               serving kernels, launches printed; (e) the serving launcher
               at ``--smoke`` with every new flag.
  21. dist   - right after the build, the training launcher's mesh path
               (``dist_check.py`` beside this script, two rank processes):
               deepseek-moe-16b at full width cut to 2 of 28 layers (the
               dense layer 0 and one MoE layer), seeded random weights,
               ``--mode dense`` with AdamW, 2 steps of 2 x 64 tokens at no
               drop and no aux loss; (a) a world of one over NCCL, started
               as the launcher starts it (the backend chosen from the
               card's UUID), at mesh 1 x 1 (``moe_apply_ep`` with one
               'model' rank) against the run without a process group:
               losses and parameters bit for bit; (b) two ranks on the
               card over gloo at (2, 1) and (1, 2) against (a)'s run
               (losses within TOL_TRAIN_LOSS, each parameter leaf within
               TOL_DIST_PARAM of its scale but for TOL_DIST_LEAF_SHARE of
               its entries, which stay within Adam's travel), every rank
               of a 'model' group's leaves bit for bit alike, the logits
               under (1, 2) against the forward without a mesh within
               TOL_GAR; each step's ms, its gradient all-reduce's, the two
               all-to-alls of the MoE call and each rank's peak memory
               printed; (c) gpt2-small's flexrank run at (1, 2); (d) a
               60-token prompt into a float32 decode cache of 128
               positions and 8 greedy steps, each rank with its part of
               the cache (``specs.cache_specs(mesh=)``) and of every leaf
               (the experts E / 2 at decode): at (1, 2), batch 2, and at
               (2, 1), batch 1, the cache's sequence over 'data' (the
               prompt and steps 1-4 on rank 0, steps 5-8 on rank 1),
               against one rank (logits within TOL_GAR, greedy tokens
               equal), each rank's parameter and cache bytes equal to the
               decode cell's ``placed``; then in this process
               llama4-scout-17b-a16e's decode_32k attention layer (B 8, Hq
               40, Hkv 8, D 128, T 32768, a bfloat16 cache) cut into 16
               shards, the rank's merge with its all-reduces replaced by
               maxima and sums in rank order, against whole
               ``chunked_attend`` (TOL_MERGE in float32, one bfloat16 ulp
               of the output's max in the cache's type), global and at a
               window of 8192; (e) back in the world of two, the same
               model in the GAR form (``--mode gar``'s leaves drawn by
               ``launch/dryrun.py:_make`` from seed 0 on both ranks) at
               (1, 2): (d)'s prompt and greedy steps, each rank with its
               part of ``v_tilde`` and ``u_hat`` (``perm_inv`` whole) and
               of the cache, against rank 0's one-rank decode (logits
               within TOL_GAR, greedy tokens equal), each rank's bytes
               equal to the gar decode cell's ``placed``, every GAR
               weight operand the rank's part and ``gar_matmul``'s fused
               and stage-2 entries launched on each rank.
  22. dryrun - run last (``launch/dryrun.py``): (a) two production cells
               on the host as rank 0 of a fake world, deepseek-moe-16b
               ``train_4k`` on (16, 16) (its all-to-alls from
               ``moe_apply_ep``, 4 experts a rank) and zamba2-7b
               ``long_500k`` on (2, 16, 16) (a batch of one held whole),
               each record's figures printed, ``status`` ``ok``; (b)
               gpt2-small at full depth, one rank (a 1 x 1 mesh, no
               group), 8 x 128 tokens, one dense AdamW step: traced on
               ``meta``, then the same step on the card (after one
               untraced warm-up call) under the same counter: FLOPs,
               products and collective bytes equal, and the step's own
               high-water mark on the card (``max_memory_allocated``
               after ``reset_peak_memory_stats``, less what was allocated
               before) within TOL_DRYRUN_PEAK of the meta trace's plus
               DRYRUN_PEAK_SLACK bytes; ``t_compute`` beside the step's
               ms, no gate; (c) the same counts equal for a ``flexrank``
               train step (``lowrank_matmul`` launched) and a ``gar``
               decode step over a 256-position cache (``gar_matmul``
               launched), each kernel's counted work equal to its plain
               version's on ``meta``.

The last line is ``{"ok": true, "device": {...}}``; before it come the
card's name and power limit and a JSON line of per-kernel numbers. Exits
non-zero, printing no result, without CUDA or without the repository.
``--profile`` serves the serving path's requests twice more, under
``torch.profiler`` (device time by kernel) and under ``cProfile`` (host
time by function), and takes 3 more training steps under
``torch.profiler`` for each of the three trained models, and serves
gemma3-27b's requests twice more as it does gpt2-small's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
ROOFLINE_NOTE = ("roofline at an NVIDIA H100 80GB HBM3 700 W's datasheet "
                 "peaks: 989 TFLOP/s bf16, 3.35 TB/s, 50 GB/s a link")
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 on the tensor cores
L2_BYTES = 50 * 2**20
TOL_ATTN = 2e-5                # float32 attention, absolute
TOL_GAR = 2e-4                 # GAR, relative to the output's max
TOL_PROBS = 1e-5               # warped probs, absolute; tokens identical
# paged_decode_step against paged_mixed_step with one token a slot, on the
# card: relative to the logits' max (the same kernels' arithmetic on the
# same rows; float32 sums of other launch shapes at most)
TOL_DECODE = 1e-5
GEMMA_DECODE_STEPS = 32        # decode-check steps on gemma3, each row
# a speculative stream may part from the plain engine's only where the
# plain run's choice is a near tie: greedy, the top two logits within this
# of the logits' max; sampled, the uniform within this of an edge of the
# drawn token's CDF interval. Verify runs and draft steps give the kernels
# other token counts than plain decode (GAR's token tile and split-K, the
# attention kernel's query tiles), so a row's logits can move in their last
# bits, which phase 9's constant bounds for one launch shape
TOL_SPEC_TIE = TOL_DECODE
SPEC_LEN = 4
# the top row drafting for itself proposes the target's own argmax, so a
# greedy draft is rejected only at a near tie between a draft step's logits
# and the verify run's: the acceptance rate must reach this
SELF_DRAFT_ACCEPT = 0.95
TOL_LOWRANK = 2e-4             # low-rank linear, relative to the output's max
# phase 13: a greedy request's prefill + decode logits against ``forward``
# of the whole sequence on the card, relative to the logits' max. The
# stateful path runs the recurrences' chunked plain forms (the prompt in
# 64-step chunks for rwkv6, one 128-step chunk for Mamba2, then single
# steps), the forward the kernels' own orders; TOL_RECUR_CHUNKED bounds
# one layer's difference, and the layers and the LM head carry it to the
# logits: 1e-3, twenty times the reference's own 2e-2
# (tests/test_models.py:test_decode_matches_forward, bfloat16 caches). The
# same bound holds the request's logits card vs CPU on the 2-layer cut
# (the same plain forms in other float32 orders, GAR within TOL_GAR)
TOL_DRAIN_FORWARD = 1e-3
DRAIN_NEW = 32                 # new tokens a phase-13 request
# the drain phases (13 (a)-(b), 15-17) serve DRAIN_REQUESTS requests at
# these budgets: row 0 only since the smoke passed 1050 s with phase 20
# (8 requests at 0.4 and 1.0 until then); the top row repeated GAR at full
# rank, which phases 3, 10 and 14 serve, and 13 (c) still serves drain at
# both rows
DRAIN_BUDGETS = (0.4,)
DRAIN_REQUESTS = 4
# phase 10's requests (8 until the smoke passed 1050 s with phase 20)
GEMMA_REQUESTS = 4
# phase 14, card vs CPU: a token's routing is a near tie when its k-th and
# (k+1)-th router probabilities lie within this of each other. The hidden
# state the router reads differs card vs CPU by the GAR kernel's error
# (within TOL_GAR of a projection's output max), so a probability can
# move by about that much
TOL_ROUTE = 2e-4
# phase 14, card vs CPU: a step's logits, relative to their max, while no
# token's expert set has differed; the bound of phase 13's card vs CPU
# logits (TOL_DRAIN_FORWARD): GAR within TOL_GAR a projection, the router's
# and the experts' float32 products in other orders
TOL_MOE_CROSS = TOL_DRAIN_FORWARD
# WKV6 and SSD, relative to the output's max: against the sequential
# recurrences (the kernel's own order of operations), and against the
# chunked forms the CPU runs, whose exponents (differences of cumulative
# log-decays up to some 900 in magnitude) float32 keeps to about 5e-5
TOL_RECUR_SEQ = 2e-5
TOL_RECUR_CHUNKED = 2e-4
# one training step card vs CPU: float32 sums in other orders through 12
# layers and back; the KL gradient is a difference of two softmaxes
TOL_TRAIN_LOSS = 1e-4          # relative
TOL_TRAIN_GRAD = 1e-3          # relative to each gradient leaf's max
# phase 19 (e): PowerSGD's ghat and error card vs CPU, relative to each
# leaf's gradient max (a float32 QR of the rank-8 projection on two
# libraries, as the CPU tests hold the port against JAX)
TOL_POWERSGD = 1e-4
# phase 21: the parameters after two AdamW steps across ranks against the
# one-rank run, relative to each leaf's scale, the larger of its max and
# the learning rates summed (tests/test_torch_dist.py's bound); an entry
# whose gradient is rounding noise around zero takes Adam's normalised
# step of either sign, as phase 19 (d) allows, so at most this share of
# each leaf's entries (rounded up: one entry of a leaf under 1e6) may pass
# it, each within twice the learning rates summed
TOL_DIST_PARAM = 2e-3
TOL_DIST_LEAF_SHARE = 1e-6
DIST_DEADLINE = 300            # seconds for phase 21's two rank processes
DIST_LOWRANK_LAYERS = 2        # phase 21 (c): gpt2-small's depth, of 12
# phase 21 (d): the prefill into the rank's part of the decode cache and
# the greedy steps after it
DIST_DECODE = {"prompt": 60, "cache": 128, "steps": 8}
# phase 21 (d): the 16-shard merge of llama4's decode_32k attention
# against whole chunked_attend, relative to the output's max, with the
# cache's values in float32 on both sides (the shards' sums reorder
# float32 additions only); in the cache's bfloat16 the two round their
# outputs apart by at most one ulp, 2^-7 of the output's max
TOL_MERGE = 1e-3
TOL_MERGE_BF16 = 2.0 ** -7
MERGE_CELL = dict(batch=8, heads=40, kv_heads=8, head_dim=128,
                  length=32768, shards=16)
# phase 19 (g): the nestedness trainer's prefix products U Pi_[r] V^T card
# vs CPU after 1000 Adam steps, relative to max |M*| (a 1-ulp change of the
# initial draws moves them by at most 6.4e-7 on the CPU, at 500 steps)
TOL_NESTED = 1e-5
# phase 22 (b): the card's high-water mark over one dense step against the
# meta trace's (live tensor bytes as the dispatcher sees them): a share
# for the caching allocator's 512-byte rounding and an op's internal
# scratch, and a fixed allowance for cuBLAS's workspaces, which the
# allocator holds outside any op's output
TOL_DRYRUN_PEAK = 0.05
DRYRUN_PEAK_SLACK = 64 << 20
PROJECTIONS = ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/gate", "mlp/up",
               "mlp/down")


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- timing

def _sleep_cycles(host_s: float, n: int) -> int:
    # keep the card busy while the host enqueues n calls, so the events
    # time the device work back to back and not the host's launch gaps
    return int(min(2e9 * host_s * (n + 2) * 2 + 2e6, 4e9))


def device_ms(calls, reps: int = 25) -> float:
    """Median device milliseconds of one call. ``calls`` is a list of
    zero-argument callables over distinct input copies, cycled so that the
    inputs of consecutive calls together exceed the L2 cache (the serving
    path reads each layer's weights and pools cold)."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls[0]()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(_sleep_cycles(host_s, reps))
    events[0].record()
    for i in range(reps):
        calls[i % len(calls)]()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def copies_for(nbytes: int) -> int:
    return min(64, max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound_ms(nbytes: float, flops: float, rate: float = FP32_FLOPS_PER_S
             ) -> tuple:
    """The least time for ``nbytes`` at the memory rate and ``flops`` at
    ``rate`` (float32 outside the tensor cores unless named), and which of
    the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32x3_bounds(nbytes: float, flops: float) -> dict:
    """Bounds of a kernel whose float32 products run as three TF32 products
    on the tensor cores (3xTF32): ``bound_ms`` at the rate its arithmetic
    uses, and the float32 bound beside it, named as such."""
    b, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return dict(bound_ms=b, bound_by=by,
                bound_fp32_ms=bound_ms(nbytes, flops)[0])


def kernel_line(e: dict) -> str:
    """One timed row: kernel, plain and library ms, kernel / library, the
    bound (and for 3xTF32 kernels the float32 bound beside it)."""
    lib = "-" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
    ratio = ("-" if e["library_ms"] is None
             else f"{e['ms'] / e['library_ms']:.2f}")
    fp32 = (f", float32 bound {e['bound_fp32_ms']:.4f} ms"
            if "bound_fp32_ms" in e else "")
    if "flops_form" in e:
        fp32 += f" (flops of the {e['flops_form']} form)"
    return (f"# kernel {e['kernel']} [{e['shape']}]: {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, library {lib} ms, kernel / "
            f"library {ratio}, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}){fp32}, max abs err {e['max_abs_err']:.2e}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------- kernels

def check_gar(dev, shapes, rng, report):
    """shapes: (label, t, v_tilde, u_hat, perm_inv): the deployed GAR
    leaves where the shape comes from the main path, else random factors.
    Ragged shapes are checked, not timed."""
    from repro_torch.kernels import gar_matmul as gk
    from repro_torch.kernels import ref
    worst = 0.0
    for label, t, v_tilde, u_hat, perm_inv in shapes:
        n, r = v_tilde.shape
        m = r + u_hat.shape[0]
        x = torch.as_tensor(rng.standard_normal((t, n)).astype(np.float32),
                            device=dev)
        y = gk.gar_matmul(x, v_tilde, u_hat, perm_inv)
        z, tail = ref.gar_matmul_ref(x, v_tilde, u_hat)
        y_plain = torch.cat([z, tail], dim=-1)[:, perm_inv]
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        scale = float(y_plain.abs().max()) + 1e-6
        if not err / scale < TOL_GAR:
            fail(f"gar_matmul {label}: rel err {err / scale:.3e}")
        worst = max(worst, err)
        if label.startswith("ragged"):
            continue
        work = nbytes(x, v_tilde, u_hat, perm_inv) + t * m * 4
        k = copies_for(nbytes(v_tilde, u_hat, perm_inv))
        sets = [(x, v_tilde.clone(), u_hat.clone(), perm_inv)
                for _ in range(k)]
        # yardstick: one dense product y = x @ W_r, W_r (n, m) rebuilt as
        # (v_tilde @ [I; u_hat]^T) with its columns put back in place
        u_tilde = torch.cat([torch.eye(r, device=dev), u_hat])
        w_r = (v_tilde @ u_tilde.T)[:, perm_inv].contiguous()
        if not float((x @ w_r - y_plain).abs().max()) / scale < 1e-3:
            fail(f"gar_matmul {label}: dense yardstick disagrees")
        dense = [w_r.clone() for _ in range(copies_for(nbytes(w_r)))]
        ms = device_ms([lambda s=s: gk.gar_matmul(*s) for s in sets])
        plain_ms = device_ms([lambda s=s: torch.cat(
            ref.gar_matmul_ref(*s[:3]), dim=-1)[:, s[3]] for s in sets])
        lib_ms = device_ms([lambda w=w: torch.matmul(x, w) for w in dense])
        flops = 2 * t * (n * r + (m - r) * r)
        report.append(dict(kernel="gar_matmul", shape=label, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           max_abs_err=err, **tf32x3_bounds(work, flops)))
    return worst


def check_gar_tail(dev, cases, rng, report):
    """cases: (label, t, r, m - r): the stage-2 entry ``gar_tail`` of a
    tensor-parallel rank (``models/tp.py``) on a given z and random rows of
    u_hat, held against its plain version and timed against its bound and
    one ``torch.matmul``. Returns the largest error."""
    from repro_torch.kernels import gar_matmul as gk
    from repro_torch.kernels import ref
    worst = 0.0
    for label, t, r, w in cases:
        z = torch.as_tensor(rng.standard_normal((t, r)).astype(np.float32),
                            device=dev)
        u = torch.as_tensor(rng.standard_normal((w, r)).astype(np.float32)
                            / math.sqrt(r), device=dev)
        sets = [(z, u.clone()) for _ in range(copies_for(nbytes(u)))]
        y, want = gk.gar_tail(z, u), ref.gar_tail_ref(z, u)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        scale = float(want.abs().max()) + 1e-6
        if not err / scale < TOL_GAR:
            fail(f"gar_tail {label}: rel err {err / scale:.3e}")
        worst = max(worst, err)
        ms = device_ms([lambda s=s: gk.gar_tail(*s) for s in sets])
        plain_ms = device_ms([lambda s=s: ref.gar_tail_ref(*s) for s in sets])
        lib_ms = device_ms([lambda s=s: torch.matmul(s[0], s[1].T)
                            for s in sets])
        report.append(dict(kernel="gar_tail", shape=label, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           max_abs_err=err, **tf32x3_bounds(
                               nbytes(z, u) + t * w * 4, 2 * t * r * w)))
    return worst


def check_lowrank(dev, cases, rng, report):
    """cases: (label, t, v, u, rank): factors of the training path's state
    where the shape comes from the main path, else random ones."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    worst = 0.0
    for label, t, v, u, rank in cases:
        n, r = v.shape
        m = u.shape[0]
        kr = lk.kept_rank(r, rank)
        x = torch.as_tensor(rng.standard_normal((t, n)).astype(np.float32),
                            device=dev)
        y = lk.lowrank_matmul(x, v, u, rank)
        y_plain = ref.lowrank_matmul_ref(x, v, u, rank)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        scale = float(y_plain.abs().max()) + 1e-6
        if not err / scale < TOL_LOWRANK:
            fail(f"lowrank_matmul {label}: rel err {err / scale:.3e}")
        if kr == 0 and bool(y.any()):
            fail(f"lowrank_matmul {label}: rank 0 left non-zeros")
        worst = max(worst, err)
        sets = [(x, v.clone(), u.clone(), rank)
                for _ in range(copies_for(nbytes(v, u)))]
        # yardstick: one dense product y = x @ W_r, W_r = (v * mask) @ u^T
        w_r = (v[:, :kr] @ u[:, :kr].T).contiguous()
        if not float((x @ w_r - y_plain).abs().max()) / scale < 1e-3:
            fail(f"lowrank_matmul {label}: dense yardstick disagrees")
        dense = [w_r.clone() for _ in range(copies_for(nbytes(w_r)))]
        ms = device_ms([lambda s=s: lk.lowrank_matmul(*s) for s in sets])
        plain_ms = device_ms([lambda s=s: ref.lowrank_matmul_ref(*s)
                              for s in sets])
        lib_ms = device_ms([lambda w=w: torch.matmul(x, w) for w in dense])
        # x read, y written, and the kr kept columns of v and u (the masked
        # ones add exact zeros and are skipped)
        work = 4 * (t * n + (n + m) * kr + t * m)
        report.append(dict(kernel="lowrank_matmul", shape=label, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           max_abs_err=err,
                           **tf32x3_bounds(work, 2 * t * kr * (n + m))))
    return worst


def _visible(lens, window):
    """Per row, the first key of its window: ``max(0, ctx - window)``."""
    return np.maximum(0, np.asarray(lens, np.int64) - (window or 1 << 30))


def _kv_work(rows, lens, window, bs, hkv, d, hq):
    """The distinct K/V bytes the rows' windows cover (whole blocks of
    each table row), and the flops of their visible keys."""
    lo, hi = {}, {}
    for s, c, f in zip(rows, lens, _visible(lens, window)):
        s = int(s)
        lo[s] = min(lo.get(s, f), int(f))
        hi[s] = max(hi.get(s, 0), int(c))
    blocks = sum(math.ceil(hi[s] / bs) - lo[s] // bs for s in hi)
    keys = int((np.asarray(lens, np.int64) - _visible(lens, window)).sum())
    return blocks * bs * hkv * d * 8, 4 * hq * d * keys


def _sdpa_operands(dev, q, kp, vp, per_row_tables, lens, window):
    """K/V gathered per row beforehand, heads repeated for GQA, and the
    mask of the visible keys: the library yardstick's inputs."""
    rows, hq, d = q.shape
    hkv = kp.shape[2]
    mb, bs = per_row_tables.shape[1], kp.shape[1]
    kg = kp[per_row_tables].reshape(rows, mb * bs, hkv, d).transpose(1, 2)
    vg = vp[per_row_tables].reshape(rows, mb * bs, hkv, d).transpose(1, 2)
    kg = kg.repeat_interleave(hq // hkv, 1).contiguous()
    vg = vg.repeat_interleave(hq // hkv, 1).contiguous()
    pos = torch.arange(mb * bs, device=dev)[None, :]
    lo = torch.as_tensor(_visible(lens.cpu().numpy(), window), device=dev)
    mask = ((pos < lens[:, None]) & (pos >= lo[:, None]))[:, None, None, :]
    return kg, vg, mask


def _attn_case(dev, rng, t, hq, hkv, d, bs, b, mb, decode, chunk):
    """A mixed batch like the engine's: ``decode`` tokens of distinct
    slots, one prefill chunk of ``chunk`` tokens in another slot, pads on
    the null row. Returns the operands."""
    nb = b * mb + 1
    kp = torch.as_tensor(rng.standard_normal((nb, bs, hkv, d))
                         .astype(np.float32), device=dev)
    vp = torch.as_tensor(rng.standard_normal((nb, bs, hkv, d))
                         .astype(np.float32), device=dev)
    tables = np.zeros((b + 1, mb), np.int32)
    tables[:b] = 1 + rng.permutation(b * mb).reshape(b, mb)
    sid = np.full(t, b, np.int32)
    lens = np.ones(t, np.int32)
    cap = mb * bs
    for i in range(decode):
        sid[i] = i
        lens[i] = rng.integers(cap // 4, cap + 1)
    start = int(rng.integers(0, cap - chunk + 1)) if chunk else 0
    for j in range(chunk):
        sid[decode + j] = decode
        lens[decode + j] = start + j + 1
    q = torch.as_tensor(rng.standard_normal((t, hq, d)).astype(np.float32),
                        device=dev)
    ops_ = [torch.as_tensor(a, device=dev) for a in (tables, sid, lens)]
    return (q, kp, vp, *ops_)


def _time_attention(name, label, kernel, plain, args, per_row_tables, rows,
                    window, err, report):
    """Time ``kernel`` and ``plain`` (each called as f(*args,
    window=window)) and SDPA over K/V gathered beforehand; append the
    report entry. ``rows`` name each query row's table row (the slot)."""
    import torch.nn.functional as F
    q, kp, vp = args[:3]
    lens = args[-1]
    kg, vg, mask = _sdpa_operands(q.device, q, kp, vp, per_row_tables, lens,
                                  window)
    yl = F.scaled_dot_product_attention(q[:, :, None, :], kg, vg,
                                        attn_mask=mask)[:, :, 0]
    # a timing yardstick only: at some shapes its float32 path runs on TF32
    # tensor cores, so it is held to computing the same function (a
    # gross-error guard), not to TOL_ATTN
    lib_err = float((yl - plain(*args, window=window)).abs().max())
    log(f"# yardstick SDPA [{name} {label}]: max abs diff {lib_err:.2e}")
    if not lib_err < 0.1:
        fail(f"{name} {label}: SDPA yardstick computes something else "
             f"({lib_err:.3e})")
    sets = [(q, kp.clone(), vp.clone(), *args[3:])
            for _ in range(copies_for(nbytes(kp, vp)))]
    # gathered per query row, K/V outgrow the L2 cache many times over at
    # gemma3's shapes (8.9 GB each at T=264): one set is read cold
    lib_sets = ([(kg, vg)] if nbytes(kg, vg) >= 4 * L2_BYTES else
                [(kg.clone(), vg.clone())
                 for _ in range(copies_for(nbytes(kg, vg)))])
    ms = device_ms([lambda s=s: kernel(*s, window=window) for s in sets])
    plain_ms = device_ms([lambda s=s: plain(*s, window=window)
                          for s in sets])
    lib_ms = device_ms([lambda s=s: F.scaled_dot_product_attention(
        q[:, :, None, :], s[0], s[1], attn_mask=mask) for s in lib_sets])
    # q read and the output written once, the distinct K/V blocks the rows'
    # windows cover, the routing tables
    _, bs, hkv, d = kp.shape
    kv_bytes, flops = _kv_work(rows.cpu().numpy(), lens.cpu().numpy(),
                               window, bs, hkv, d, q.shape[1])
    work = 2 * nbytes(q) + kv_bytes + nbytes(*args[3:])
    b, by = bound_ms(work, flops)
    report.append(dict(kernel=name, shape=label, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b, bound_by=by,
                       max_abs_err=err))


def check_attention(dev, cases, rng, report):
    """cases: (label, geometry, softcaps, windows). Every window is held
    against the plain version and timed unless the shape is ragged."""
    from repro_torch.kernels import paged_attention as ak
    from repro_torch.kernels import ref
    worst = 0.0
    for label, geom, softcaps, windows in cases:
        args = _attn_case(dev, rng, *geom)
        q, kp, vp, tables, sid, lens = args
        for window in windows:
            wl = label if window is None else f"{label} window={window}"
            err_w = 0.0
            for softcap in softcaps:
                y = ak.paged_prefill_attention(*args, softcap=softcap,
                                               window=window)
                y_plain = ref.paged_prefill_attention_ref(
                    *args, softcap=softcap, window=window)
                torch.cuda.synchronize()
                err = float((y - y_plain).abs().max())
                if not err < TOL_ATTN:
                    fail(f"paged_prefill_attention {wl} softcap={softcap}: "
                         f"abs err {err:.3e}")
                err_w = max(err_w, err)
            worst = max(worst, err_w)
            if not label.startswith("ragged"):
                _time_attention("paged_prefill_attention", wl,
                                ak.paged_prefill_attention,
                                ref.paged_prefill_attention_ref, args,
                                tables[sid.long()].long(), sid, window,
                                err_w, report)
    return worst


def _decode_case(dev, rng, b, hq, hkv, d, bs, mb, lo, hi):
    """``b`` slots, each its own table row of distinct random blocks,
    contexts uniform in [lo, hi]; block 0 is the null block."""
    nb = b * mb + 1
    kp, vp = (torch.as_tensor(rng.standard_normal((nb, bs, hkv, d))
                              .astype(np.float32), device=dev)
              for _ in range(2))
    tables = (1 + rng.permutation(b * mb).reshape(b, mb)).astype(np.int32)
    lens = rng.integers(lo, hi + 1, b).astype(np.int32)
    q = torch.as_tensor(rng.standard_normal((b, hq, d)).astype(np.float32),
                        device=dev)
    return (q, kp, vp, *(torch.as_tensor(a, device=dev)
                         for a in (tables, lens)))


def check_decode(dev, cases, rng, report):
    """cases: (label, geometry, softcaps, windows): the decode kernel held
    against ``ref.paged_attention_ref`` for every softcap and window, and
    timed (kernel, plain, SDPA, bound) for every window unless ragged."""
    from repro_torch.kernels import paged_attention as ak
    from repro_torch.kernels import ref
    worst = 0.0
    for label, geom, softcaps, windows in cases:
        args = _decode_case(dev, rng, *geom)
        tables = args[3]
        for window in windows:
            wl = label if window is None else f"{label} window={window}"
            err_w = 0.0
            for softcap in softcaps:
                y = ak.paged_attention(*args, softcap=softcap, window=window)
                y_plain = ref.paged_attention_ref(*args, softcap=softcap,
                                                  window=window)
                torch.cuda.synchronize()
                err = float((y - y_plain).abs().max())
                if not (err < TOL_ATTN and bool(torch.isfinite(y).all())):
                    fail(f"paged_attention {wl} softcap={softcap}: abs err "
                         f"{err:.3e}")
                err_w = max(err_w, err)
            worst = max(worst, err_w)
            if not label.startswith("ragged"):
                _time_attention("paged_attention", wl, ak.paged_attention,
                                ref.paged_attention_ref, args, tables.long(),
                                torch.arange(len(tables)), window, err_w,
                                report)
    return worst


def _tie_rows(rng, s, v):
    """Rows of the sampling edge cases: even rows greedy, with their max on
    both sides of the first split edge (the first occurrence must win);
    odd rows at temperature 0.7 and top-k 3 with five entries tied above
    the rest (every tied entry kept). Returns (logits, temperature, top_k,
    u) as numpy arrays."""
    from repro_torch.kernels import sampling as sk
    _, _, per, _ = sk.split_layout(s, v)
    edge = min(per * sk.BLOCK, v - 1)
    logits = rng.standard_normal((s, v)).astype(np.float32)
    greedy = np.arange(s) % 2 == 0
    logits[np.ix_(greedy, [edge - 1, edge])] = 9.0
    ties = np.linspace(0, v - 1, 5).astype(int)
    logits[np.ix_(~greedy, ties)] = 8.0
    return (logits, np.where(greedy, 0.0, 0.7).astype(np.float32),
            np.where(greedy, 0, 3).astype(np.int32),
            rng.random(s).astype(np.float32))


def check_sampling(dev, cases, rng, report):
    """cases: (label, S, V, ties). Random rows, half greedy, half at
    temperature 0.8 and top-k 40, or ``_tie_rows``; tokens equal to the
    plain version's with and without probs and through ``ops``, probs
    within TOL_PROBS. Unless ragged: times the kernel, the plain version
    and the serving call (``ops.topk_mask_sample_forward`` with per-row
    top-k, the threshold sort included)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sampling as sk
    worst = 0.0
    for label, s, v, ties in cases:
        if ties:
            arrays = _tie_rows(rng, s, v)
        else:
            arrays = ((rng.standard_normal((s, v)) * 3).astype(np.float32),
                      np.where(np.arange(s) % 2, 0.8, 0.0).astype(
                          np.float32),
                      np.where(np.arange(s) % 2, 40, 0).astype(np.int32),
                      rng.random(s).astype(np.float32))
        logits, temp, top_k, u = (torch.as_tensor(a, device=dev)
                                  for a in arrays)
        z = logits / torch.clamp(temp, min=1e-30)[:, None]
        # the tie rows only under their top-k threshold, where every kept
        # weight is exactly 1: untruncated, their draw crosses among ~2.6e5
        # weights near 3e-5, where two summation orders (the kernel's and
        # torch's) can put u * total on either side of a token
        thresholds = [ref.topk_threshold_ref(z, top_k)]
        if not ties:
            thresholds.append(torch.full((s,), -math.inf, device=dev))
        for thr in thresholds:
            tok, probs = sk.topk_mask_sample(logits, temp, thr, u,
                                             return_probs=True)
            tok_only = sk.topk_mask_sample(logits, temp, thr, u)
            t_ref, p_ref = ref.topk_mask_sample_ref(logits, temp, thr, u)
            torch.cuda.synchronize()
            if not (torch.equal(tok, t_ref) and torch.equal(tok_only, t_ref)):
                fail(f"topk_mask_sample {label}: tokens differ "
                     f"{tok.tolist()} vs {t_ref.tolist()}")
            err = float((probs - p_ref).abs().max())
            if not err < TOL_PROBS:
                fail(f"topk_mask_sample {label}: probs err {err:.3e}")
            worst = max(worst, err)
        # the serving call: ops dispatch, sort for top-k included
        tok_ops = ops.topk_mask_sample_forward(logits, temp, top_k, u)
        if not torch.equal(tok_ops, ref.topk_mask_sample_ref(
                logits, temp, ref.topk_threshold_ref(z, top_k), u)[0]):
            fail(f"topk_mask_sample {label}: ops dispatch differs")
        if label.startswith("ragged"):
            continue
        thr = ref.topk_threshold_ref(z, top_k)
        sets = [(logits.clone(), temp, thr, u)
                for _ in range(copies_for(nbytes(logits)))]
        ms = device_ms([lambda a=a: sk.topk_mask_sample(*a) for a in sets])
        plain_ms = device_ms([lambda a=a: ref.topk_mask_sample_ref(
            *a, return_probs=False) for a in sets])
        serve_ms = device_ms([lambda a=a: ops.topk_mask_sample_forward(
            a[0], temp, top_k, u) for a in sets])
        log(f"# topk_mask_sample [{label}]: the serving call (threshold "
            f"sort included) {serve_ms:.4f} ms, the kernel {ms:.4f} ms")
        work = nbytes(logits, temp, thr, u) + s * 4
        b, by = bound_ms(work, 12 * s * v)
        report.append(dict(kernel="topk_mask_sample", shape=label, ms=ms,
                           plain_ms=plain_ms, library_ms=None, bound_ms=b,
                           bound_by=by, max_abs_err=err))
    return worst


def _check_recurrence(name, dev, label, kernel, plain, op, seq, arrays,
                      chunk, work, flops, report, bounds=None):
    """Hold ``kernel`` (the wrapper) against the sequential recurrence
    ``seq`` and the op's chunked plain version ``plain`` on the card; time
    kernel, chunked plain version, and a forward and backward through the
    training path's ``op`` (the kernel, then the chunked recompute under
    autograd) unless the shape is ragged. Returns the max abs error
    against the sequential recurrence. ``bounds``: the row's bound keys
    (default ``bound_ms`` of ``work`` bytes and ``flops`` in float32)."""
    ts = [torch.as_tensor(a, device=dev) for a in arrays]
    y = kernel(*ts)
    y_seq = seq(*ts)
    y_plain = plain(*ts, chunk)
    torch.cuda.synchronize()
    scale = float(y_seq.abs().max()) + 1e-6
    err = float((y - y_seq).abs().max())
    err_chunked = float((y - y_plain).abs().max())
    if not err / scale < TOL_RECUR_SEQ:
        fail(f"{name} {label}: rel err {err / scale:.3e} against the "
             "sequential recurrence")
    if not err_chunked / scale < TOL_RECUR_CHUNKED:
        fail(f"{name} {label}: rel err {err_chunked / scale:.3e} against "
             "the chunked plain version")
    if label.startswith(("ragged", "large dt")):
        return err
    sets = [[t.clone() for t in ts]
            for _ in range(copies_for(nbytes(*ts)))]
    ms = device_ms([lambda a=a: kernel(*a) for a in sets])
    plain_ms = device_ms([lambda a=a: plain(*a, chunk) for a in sets])
    leaves = [t.clone().requires_grad_(True) for t in ts]
    dy = torch.randn_like(y)
    train_ms = device_ms([lambda: op(*leaves, chunk=chunk).backward(dy)])
    log(f"# {name} [{label}]: forward and backward through the op "
        f"{train_ms:.4f} ms (the kernel, then the chunked recompute)")
    if bounds is None:
        b, by = bound_ms(work, flops)
        bounds = dict(bound_ms=b, bound_by=by)
    report.append(dict(kernel=name, shape=label, ms=ms, plain_ms=plain_ms,
                       library_ms=None, max_abs_err=err, **bounds))
    return err


def check_wkv6(dev, cases, rng, report):
    """cases: (label, B, S, H). r/k/v/u standard normal, w log-uniform over
    (1e-14, 1) (some decays below the clamp), N = 64, chunk 64 as rwkv6."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk

    def seq(r, k, v, w, u):
        b, s, h, n = r.shape
        flat = [t.transpose(1, 2).reshape(b * h, s, n) for t in (r, k, v, w)]
        y = ref.wkv6_ref(*flat, u.repeat(b, 1))
        return y.reshape(b, h, s, n).transpose(1, 2)

    worst = 0.0
    for label, b, s, h in cases:
        shape = (b, s, h, 64)
        r, k, v = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
        w = (10.0 ** rng.uniform(-14, 0, shape)).astype(np.float32)
        u = rng.standard_normal((h, 64)).astype(np.float32)
        n_io = 5 * b * s * h * 64
        worst = max(worst, _check_recurrence(
            "wkv6", dev, label, wk.wkv6, ops._wkv_plain, ops.wkv6_forward,
            seq,
            (r, k, v, w, u), 64, 4 * (n_io + h * 64),
            5 * b * s * h * 64 * 64, report))
    return worst


def ssd_chunked_flops(b, s, h, g, q=128) -> int:
    """Flops of the ssd kernel's chunked form on these shapes (chunks of
    q steps, the last ragged): the scores C B^T once per (batch, group,
    chunk) and (G o L)(X dt) per head, over the triangles i >= j; C S per
    head in every chunk after the first and the state update in every
    chunk before the last (P = N = 64)."""
    n = p = 64
    total = 0
    for c0 in range(0, s, q):
        qc = min(q, s - c0)
        tri = qc * (qc + 1) // 2
        total += 2 * b * g * tri * n + 2 * b * h * tri * p
        if c0 > 0:
            total += 2 * b * h * qc * n * p
        if c0 + q < s:
            total += 2 * b * h * n * qc * p
    return total


def check_ssd(dev, cases, rng, report):
    """cases: (label, B, S, H, G, dt_scale). x, b, c standard normal; dt
    the softplus of a standard normal and a = -exp(0.3 N(0, 1)), or with
    dt_scale |N(0, 1)| x dt_scale and a = -|N(0, 1)| (a chunk's log-decay
    then passes -88.7); P = N = 64, chunk 128 as zamba2. The bound: bytes
    beside the chunked form's products in 3xTF32 (float32 after the
    slash)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as sk

    def seq(x, dt, a, bb, cc):
        b, s, h, p = x.shape
        rep = h // bb.shape[2]
        bf, cf = (t.repeat_interleave(rep, 2).transpose(1, 2).reshape(
            b * h, s, 64) for t in (bb, cc))
        y = ref.ssd_ref(x.transpose(1, 2).reshape(b * h, s, p),
                        dt.transpose(1, 2).reshape(b * h, s), a.repeat(b),
                        bf, cf)
        return y.reshape(b, h, s, p).transpose(1, 2)

    worst = 0.0
    for label, b, s, h, g, dt_scale in cases:
        x = rng.standard_normal((b, s, h, 64)).astype(np.float32)
        if dt_scale is None:
            dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
            a = -np.exp(0.3 * rng.standard_normal(h))
        else:
            dt = np.abs(rng.standard_normal((b, s, h))) * dt_scale
            a = -np.abs(rng.standard_normal(h))
        dt, a = dt.astype(np.float32), a.astype(np.float32)
        bb, cc = (rng.standard_normal((b, s, g, 64)).astype(np.float32)
                  for _ in range(2))
        work = 4 * (2 * b * s * h * 64 + b * s * h + h + 2 * b * s * g * 64)
        flops = ssd_chunked_flops(b, s, h, g, sk.CHUNK)
        worst = max(worst, _check_recurrence(
            "ssd", dev, label, sk.ssd, ops._ssd_plain, ops.ssd_forward, seq,
            (x, dt, a, bb, cc), 128, work, flops, report,
            dict(tf32x3_bounds(work, flops),
                 flops_form=f"chunked Q={sk.CHUNK}, triangles")))
    return worst


# ------------------------------------------------------------ main path

def greedy_loop(params, cfg, prompt, new_tokens, device, max_len=64,
                logits_out=None):
    """Greedy decode of one prompt through ``paged_mixed_step``, scoring
    the last token of each feed; returns (tokens, per-step top-2 margins
    over the logits' max). Each step's scored logits (float32 on the
    host) are appended to ``logits_out`` when given."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import PagedKVCache
    cache = PagedKVCache(cfg, max_batch=1, max_len=max_len, block_size=16,
                         prefix_cache=False, device=device)
    cache.open_slot(0)
    cache.extend_slot(0, len(prompt))
    feed = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    positions = torch.arange(len(prompt), dtype=torch.int32, device=device)
    toks, margins = [], []
    for _ in range(new_tokens):
        caches = {"slot_ids": torch.zeros_like(positions),
                  "positions": positions,
                  "block_tables": cache.device_tables(null_rows=1),
                  "segments": cache.pools,
                  "sample_ids": torch.tensor([feed.shape[1] - 1],
                                             device=device)}
        logits, _ = tfm.paged_mixed_step(params, cfg, caches, feed)
        last = logits[0, -1].float().cpu()
        if logits_out is not None:
            logits_out.append(last)
        top = torch.topk(last, 2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1])
                       / float(last.abs().max()))
        n = cache.slots[0].num_tokens
        cache.append_token(0)
        feed = torch.tensor([[toks[-1]]], dtype=torch.int32, device=device)
        positions = torch.tensor([n], dtype=torch.int32, device=device)
    return toks, margins


def fill_slots(params, cfg, caches, prompts, dev) -> torch.Tensor:
    """Open slot i of every cache in ``caches`` for ``prompts[i]`` and run
    each prompt through ``paged_mixed_step`` (one prompt a call) on the
    first cache. Returns the greedy first tokens, (B,) int32 on the
    card."""
    from repro_torch.models import transformer as tfm
    i32 = torch.int32
    first = []
    for slot, prompt in enumerate(prompts):
        for c in caches:
            c.open_slot(slot)
            c.extend_slot(slot, len(prompt))
        n = len(prompt)
        logits, _ = tfm.paged_mixed_step(params, cfg, {
            "slot_ids": torch.full((n,), slot, dtype=i32, device=dev),
            "positions": torch.arange(n, dtype=i32, device=dev),
            "block_tables": caches[0].device_tables(),
            "segments": caches[0].pools,
            "sample_ids": torch.tensor([n - 1], device=dev)},
            torch.as_tensor(prompt, dtype=i32, device=dev)[None])
        first.append(torch.argmax(logits[0, -1]).to(i32))
    return torch.stack(first)


def mixed_one_each(params, cfg, cache, tok) -> torch.Tensor:
    """The engine's decode iteration: ``paged_mixed_step`` on one token a
    slot (``tok``: (B,) int32, the slots already extended by it). Returns
    the logits (B, V)."""
    from repro_torch.models import transformer as tfm
    logits, _ = tfm.paged_mixed_step(params, cfg, {
        "slot_ids": torch.arange(len(tok), dtype=torch.int32,
                                 device=tok.device),
        "positions": cache.device_positions(),
        "block_tables": cache.device_tables(),
        "segments": cache.pools}, tok[None])
    return logits[0]


def decode_check(cfg, rows, prompts, steps, dev, max_len, smi=""):
    """Phase 9 (and the decode part of phase 10): for each budget row
    (``rows``: row -> deployed params), fill a ``PagedKVCache`` with
    ``prompts`` through ``paged_mixed_step`` (one prompt a call), copy it
    into a second cache, then take ``steps`` greedy steps on both: one
    through ``paged_decode_step`` over ``model_caches()``, the other through
    ``paged_mixed_step`` with one token a slot. Logits within TOL_DECODE
    of their max and identical greedy tokens at every step. Returns
    (decode kernel launches, worst relative difference, median ms of a
    decode step, median ms of a mixed step)."""
    from repro_torch.kernels import paged_attention as ak
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import PagedKVCache
    b = len(prompts)
    i32 = torch.int32
    worst, t_dec, t_mix = 0.0, [], []
    ak.decode_launches = 0
    for row, params in rows.items():
        caches = [PagedKVCache(cfg, max_batch=b, max_len=max_len,
                               block_size=16, prefix_cache=False, device=dev)
                  for _ in range(2)]
        tok = fill_slots(params, cfg, caches, prompts, dev)
        if not np.array_equal(caches[0].host_tables(),
                              caches[1].host_tables()):
            fail("decode check: the two caches allocated different blocks")
        for p0, p1 in zip(caches[0].pools, caches[1].pools):
            for k in "kv":
                p1[k].copy_(p0[k])
        for step in range(steps):
            for c in caches:
                for slot in range(b):
                    c.append_token(slot)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l_dec, new = tfm.paged_decode_step(params, cfg,
                                               caches[0].model_caches(),
                                               tok[:, None])
            torch.cuda.synchronize()
            t_dec.append(time.perf_counter() - t0)
            if not torch.equal(new["positions"],
                               caches[0].device_positions() + 1):
                fail("paged_decode_step: positions not advanced by one")
            t0 = time.perf_counter()
            l_mix = mixed_one_each(params, cfg, caches[1], tok)
            torch.cuda.synchronize()
            t_mix.append(time.perf_counter() - t0)
            l_dec = l_dec[:, 0]
            rel = float((l_dec - l_mix).abs().max()) / float(
                l_mix.abs().max())
            worst = max(worst, rel)
            g_dec, g_mix = torch.argmax(l_dec, -1), torch.argmax(l_mix, -1)
            if not (rel <= TOL_DECODE and torch.equal(g_dec, g_mix)
                    and bool(torch.isfinite(l_dec).all())):
                fail(f"{cfg.name} row {row} step {step}: decode vs mixed "
                     f"logits rel {rel:.3e}, greedy {g_dec.tolist()} vs "
                     f"{g_mix.tolist()}")
            tok = g_dec.to(i32)
    launches = ak.decode_launches
    if launches <= 0:
        fail(f"{cfg.name}: the decode kernel never launched")
    med_dec = statistics.median(t_dec) * 1e3
    med_mix = statistics.median(t_mix) * 1e3
    log(f"# decode: {cfg.name} rows {sorted(rows)}, {b} slots (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}), {steps} steps "
        f"each: paged_decode_step vs paged_mixed_step logits worst rel "
        f"{worst:.2e} (bit-identical: {'yes' if worst == 0.0 else 'no'}), "
        f"greedy tokens identical; median step {med_dec:.2f} ms (decode) vs "
        f"{med_mix:.2f} ms (mixed); decode kernel launches {launches} (two "
        f"a layer){'; ' + smi if smi else ''}")
    return launches, worst, med_dec, med_mix


def prefix_logits(params, cfg, tokens, dev, max_len) -> np.ndarray:
    """The plain model's next-token logits after ``tokens`` (float64 on the
    host), from one ``paged_mixed_step`` over the whole prefix."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import PagedKVCache
    n = len(tokens)
    i32 = torch.int32
    cache = PagedKVCache(cfg, max_batch=1, max_len=max_len, block_size=16,
                         prefix_cache=False, device=dev)
    cache.open_slot(0)
    cache.extend_slot(0, n)
    logits, _ = tfm.paged_mixed_step(params, cfg, {
        "slot_ids": torch.zeros(n, dtype=i32, device=dev),
        "positions": torch.arange(n, dtype=i32, device=dev),
        "block_tables": cache.device_tables(null_rows=1),
        "segments": cache.pools,
        "sample_ids": torch.tensor([n - 1], device=dev)},
        torch.as_tensor(tokens, dtype=i32, device=dev)[None])
    return logits[0, -1].double().cpu().numpy()


def spec_divergences(label, engine, reqs, plain, spec, dev, max_len,
                     req_ids=None) -> int:
    """Hold each speculative stream to the plain one: equal, or parting at
    a near tie of the plain run (``TOL_SPEC_TIE``). ``req_ids``: each
    request's id in the plain run (its keyed draws), default its index.
    Returns the count of near-tie partings; fails on any other."""
    from repro_torch.serving import SamplerState
    from repro_torch.serving import device_sampling as dsamp
    from repro_torch.serving.sampling import DRAW_TARGET
    ties = 0
    for i, (rq, a, b) in enumerate(zip(reqs, plain, spec)):
        rid = i if req_ids is None else req_ids[i]
        if len(a.tokens) != len(b.tokens):
            fail(f"{label}: request {rid} returned {len(b.tokens)} tokens, "
                 f"the plain engine {len(a.tokens)}")
        if np.array_equal(a.tokens, b.tokens):
            continue
        j = int(np.flatnonzero(a.tokens != b.tokens)[0])
        z = prefix_logits(engine._realize(a.budget_row), engine.cfg,
                          a.tokens[:j], dev, max_len)
        if rq.sampling is None:
            top = np.argsort(-z)[:2]
            gap = float(z[top[0]] - z[top[1]]) / float(np.abs(z).max())
            ok = (gap <= TOL_SPEC_TIE
                  and {int(a.tokens[j]), int(b.tokens[j])}
                  <= set(top.tolist()))
            what = f"top-2 gap {gap:.3e} of the logits' max"
        else:
            # the plain engine drew token j with the keyed DRAW_TARGET
            # uniform at position j
            p = SamplerState(rq.sampling, rid).probs(z)
            seed = np.int64(rq.sampling.seed).astype(np.uint32).view(
                np.int32)
            u = float(dsamp.keyed_uniform(
                *[torch.tensor([x], dtype=torch.int32)
                  for x in (seed, rid, DRAW_TARGET, j)])[0])
            cdf = np.cumsum(p)
            tok = int(a.tokens[j])
            lo = float(cdf[tok - 1]) if tok else 0.0
            dist = min(abs(u - lo), abs(float(cdf[tok]) - u))
            ok = dist <= TOL_SPEC_TIE
            what = f"uniform {dist:.3e} from its CDF interval's edge"
        log(f"# {label}: request {rid} parts from the plain stream at token "
            f"{j}: plain {int(a.tokens[j])}, spec {int(b.tokens[j])}, "
            f"{what}")
        if not ok:
            fail(f"{label}: request {rid} parts from the plain stream at "
                 f"token {j} beyond a near tie ({what}, tolerance "
                 f"{TOL_SPEC_TIE})")
        ties += 1
    return ties


@contextlib.contextmanager
def sync_free_rounds():
    """Queue every speculative round under the sync debug mode "error":
    any host synchronisation before the round's commit is read raises."""
    from repro_torch.spec.decoder import SpecDecoder
    queue = SpecDecoder._enqueue_round

    def checked(self, plans, chunks):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return queue(self, plans, chunks)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    SpecDecoder._enqueue_round = checked
    try:
        yield
    finally:
        SpecDecoder._enqueue_round = queue


def serve_timed(engine, reqs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(reqs, mode="continuous")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, engine.last_metrics.summary()


def spec_phase(label, engine, reqs, plain, plain_s, draft_rank, dev,
               max_len, prefix_cache=False):
    """Phase 11 (and the spec part of phase 10) on ``engine``, whose plain
    run of ``reqs`` gave ``plain`` (summary ``plain_s``): speculative,
    verify-only and greedy-at-the-top-row runs, each held to the plain
    streams. ``prefix_cache`` turns the engine's prefix caching on for
    these runs, so that each draft slot aliases its target's full prompt
    blocks instead of warming its cache ``gap_chunk`` (32) prompt tokens a
    round (the requests share no prompt, so no run hits the index).
    Returns the launches of the serving kernels in the speculative run and
    that run's Results."""
    from repro_torch.kernels import gar_matmul, paged_attention, sampling
    from repro_torch.serving import Request
    from repro_torch.spec import SpecConfig
    cfg = engine.cfg
    new = reqs[0].max_new_tokens
    engine.prefix_cache = prefix_cache
    engine.spec = SpecConfig(draft_rank=draft_rank, spec_len=SPEC_LEN)
    drafts = {r: engine.spec_draft_row(r)
              for r in range(engine.table.table.shape[0])}
    served = sorted({engine._budget_row(r.budget) for r in reqs}
                    | {engine._budget_row(1.0)})
    for r in served:                    # deploys are set-up, not serving
        if drafts[r] is not None:
            engine._realize(drafts[r])
    log(f"# {label} spec: draft_rank {draft_rank:.6f}, spec_len {SPEC_LEN}, "
        f"gap_chunk {engine.spec.gap_chunk}, prefix cache "
        f"{'on' if prefix_cache else 'off'}; draft row of each target row "
        f"{drafts}; rows served {served}")
    for k in (gar_matmul, paged_attention, sampling):
        k.launches = 0
    sampling.probs_launches = 0
    with sync_free_rounds():
        spec, wall, s = serve_timed(engine, reqs)
    counts = {"gar_matmul": gar_matmul.launches,
              "paged_prefill_attention": paged_attention.launches,
              "topk_mask_sample": sampling.launches,
              "topk_mask_sample_probs": sampling.probs_launches}
    for rq, rs in zip(reqs, spec):
        gen = rs.tokens[len(rq.prompt):]
        if len(gen) != new or gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail(f"{label} spec: a request returned {len(gen)} new tokens "
                 "or one out of the vocabulary")
    log(f"# {label} spec: {s['spec_rounds']:.0f} rounds, "
        f"{s['spec_draft_tokens']:.0f} drafted, "
        f"{s['spec_accepted_tokens']:.0f} accepted, acceptance rate "
        f"{s['spec_acceptance_rate']:.4f}, mean accepted tokens "
        f"{s['spec_mean_accepted_len']:.4f} a drafting sequence's round; "
        f"{s['mixed_iterations']:.0f} rounds and plain iterations in all")
    log(f"# {label} spec vs plain: {s['tokens_per_s']:.1f} vs "
        f"{plain_s['tokens_per_s']:.1f} tok/s, ttft mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} vs {plain_s['ttft_mean_s'] * 1e3:.1f}"
        f" ms, wall {wall:.2f} s, dispatch {s['dispatch_ms_mean']:.2f} ms / "
        f"host {s['host_ms_mean']:.2f} ms an iteration or round")
    log(f"# {label} spec kernels: launches in the speculative run "
        f"{json.dumps(counts)}; no host sync in any round before its "
        "commit was read")
    if min(counts.values()) <= 0:
        fail(f"{label} spec: a kernel of the speculative path never "
             f"launched: {counts}")
    greedy = [i for i, r in enumerate(reqs) if r.sampling is None]
    ties = spec_divergences(f"{label} spec greedy", engine,
                            [reqs[i] for i in greedy],
                            [plain[i] for i in greedy],
                            [spec[i] for i in greedy], dev, max_len, greedy)

    # verify-only: sampled requests run k = 0 rounds, token-identical to
    # the plain engine's draws (all served again, so the req_ids match)
    engine.spec = SpecConfig(draft_rank=draft_rank, spec_len=SPEC_LEN,
                             stochastic=False)
    with sync_free_rounds():
        vo, _, s_vo = serve_timed(engine, reqs)
    ties += spec_divergences(f"{label} verify-only", engine, reqs, plain, vo,
                             dev, max_len)
    log(f"# {label} verify-only (stochastic=False): {s_vo['spec_rounds']:.0f}"
        f" rounds, {s_vo['spec_draft_tokens']:.0f} drafted, "
        f"{s_vo['tokens_per_s']:.1f} tok/s; streams held to the plain "
        "engine's")

    # the greedy half at the top row, plain then speculative
    top = [Request(prompt=reqs[i].prompt, max_new_tokens=new, budget=1.0)
           for i in greedy]
    engine.spec = None
    top_plain, _, s_tp = serve_timed(engine, top)
    engine.spec = SpecConfig(draft_rank=draft_rank, spec_len=SPEC_LEN)
    with sync_free_rounds():
        top_spec, _, s_ts = serve_timed(engine, top)
    ties += spec_divergences(f"{label} greedy top row", engine, top,
                             top_plain, top_spec, dev, max_len)
    log(f"# {label} greedy at the top row: {s_ts['spec_rounds']:.0f} rounds,"
        f" acceptance rate {s_ts['spec_acceptance_rate']:.4f}, mean accepted"
        f" tokens {s_ts['spec_mean_accepted_len']:.4f}; "
        f"{s_ts['tokens_per_s']:.1f} vs {s_tp['tokens_per_s']:.1f} tok/s "
        f"plain, ttft mean {s_ts['ttft_mean_s'] * 1e3:.1f} vs "
        f"{s_tp['ttft_mean_s'] * 1e3:.1f} ms")

    # the draft path itself: the top row drafting for itself must accept
    # its greedy drafts (random weights leave the prefix rows' acceptance
    # near 0, where a fault in the drafts would not show)
    top_row = engine._budget_row(1.0)
    engine.spec_draft_row = lambda r: r if r == top_row else None
    try:
        with sync_free_rounds():
            top_self, _, s_self = serve_timed(engine, top)
    finally:
        del engine.spec_draft_row
    engine.spec = None
    engine.prefix_cache = False
    ties += spec_divergences(f"{label} self-draft", engine, top, top_plain,
                             top_self, dev, max_len)
    log(f"# {label} self-draft (row {top_row} drafting for itself, greedy): "
        f"{s_self['spec_rounds']:.0f} rounds, "
        f"{s_self['spec_draft_tokens']:.0f} drafted, acceptance rate "
        f"{s_self['spec_acceptance_rate']:.4f}, mean accepted tokens "
        f"{s_self['spec_mean_accepted_len']:.4f}; "
        f"{s_self['tokens_per_s']:.1f} vs {s_tp['tokens_per_s']:.1f} tok/s "
        "plain")
    if s_self["spec_acceptance_rate"] < SELF_DRAFT_ACCEPT:
        fail(f"{label}: the top row drafting for itself accepted "
             f"{s_self['spec_acceptance_rate']:.4f} of its greedy drafts "
             f"(at least {SELF_DRAFT_ACCEPT})")
    log(f"# {label} spec streams: greedy, verify-only, top-row greedy and "
        f"self-draft held to the plain engine's; near-tie partings {ties}")
    return counts, spec


@contextlib.contextmanager
def sync_free_lookahead():
    """Run every pipelined iteration's planning, dispatch and predicted
    advance under the sync debug mode "error": any host synchronisation
    between the read of one iteration's tokens and the next raises."""
    from repro_torch.serving.engine import ElasticEngine
    saved = {name: getattr(ElasticEngine, name)
             for name in ("_plan_iteration", "_dispatch_mixed_async",
                          "_advance_predicted")}

    def checked(fn):
        def run(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run
    for name, fn in saved.items():
        setattr(ElasticEngine, name, checked(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ElasticEngine, name, fn)


def stream_session(engine, reqs, rate: float, cancel_nth: int, seed: int,
                   wait_s: float = 300.0):
    """Serve ``reqs`` through a ``StreamSession`` on a worker thread, as the
    launcher's ``--stream`` does: Poisson arrivals at ``rate`` requests/s
    from ``seed``, every ``cancel_nth``-th request cancelled after 2
    tokens. Returns per request a dict of the streamed tokens, their
    arrival times on the client, the submit time, the req_id and the
    Result, and the session (whose ``emit_t`` holds when the engine emitted
    each token), and the caches the engine served from."""
    import asyncio
    import threading
    from repro_torch.serving.session import StreamSession

    class TimedSession(StreamSession):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.emit_t = {}

        def emit(self, req_id, index, token):
            self.emit_t.setdefault((req_id, index), time.perf_counter())
            super().emit(req_id, index, token)

    caches, errors = [], []
    drive = engine._serve_row_pipelined

    def recording(row, params, sched, cache, *a):
        caches.append(cache)
        return drive(row, params, sched, cache, *a)

    def serve(session):
        try:
            engine.serve_session(session)
        except BaseException as e:
            errors.append(e)
            raise

    async def client(session, i, rq):
        cancel_after = 2 if (i + 1) % cancel_nth == 0 else None
        out = {"t_submit": time.perf_counter(), "toks": [], "recv": []}
        h = session.submit(rq)
        async for tok in h.tokens():
            out["recv"].append(time.perf_counter())
            out["toks"].append(tok)
            if cancel_after is not None and len(out["toks"]) >= cancel_after:
                h.cancel()
        out["result"] = await h.wait_result()
        out["req_id"] = h.req_id
        return out

    async def main():
        session = TimedSession(stream_buffer=8)
        session.loop = asyncio.get_running_loop()
        worker = threading.Thread(target=serve, args=(session,), daemon=True)
        worker.start()
        rng = np.random.default_rng(seed)
        tasks = []
        try:
            for i, rq in enumerate(reqs):
                if i:
                    await asyncio.sleep(rng.exponential(1.0 / rate))
                tasks.append(asyncio.create_task(client(session, i, rq)))
            outs = await asyncio.wait_for(asyncio.gather(*tasks), wait_s)
        finally:
            session.close()
        await asyncio.wait_for(session.join(), wait_s)
        worker.join(wait_s)
        if worker.is_alive():
            fail("stream: the engine thread did not finish")
        return outs, session

    engine._serve_row_pipelined = recording
    try:
        outs, session = asyncio.run(main())
    finally:
        del engine._serve_row_pipelined
    if errors:
        fail(f"stream: the engine thread raised {errors[0]!r}")
    return outs, session, caches


def stream_phase(engine, reqs, plain, dev, max_len) -> dict:
    """Phase 12 on phase 3's engine: (a) the requests through the
    lookahead pipeline, timed in turns with the synchronous loop; (b) with
    forced rollbacks; (c) a streaming session with Poisson arrivals and
    cancels; (d) every pipelined iteration queued under the sync debug
    mode "error". ``plain`` holds phase 3's Results. Returns the launches
    of the serving kernels in (a)."""
    from repro_torch.kernels import gar_matmul, paged_attention, sampling
    kernels = {"gar_matmul": gar_matmul,
               "paged_prefill_attention": paged_attention,
               "topk_mask_sample": sampling}

    def same(label, res):
        for i, (a, b) in enumerate(zip(plain, res)):
            if not np.array_equal(a.tokens, b.tokens):
                fail(f"stream {label}: request {i} returned {b.tokens[-8:]}"
                     f", phase 3 {a.tokens[-8:]}")

    # (a) synchronous and lookahead in turns: sync, lookahead, lookahead,
    # sync, sync, lookahead; the launches are those of the first lookahead
    # run
    runs = {}
    for turn, look in enumerate((False, True, True, False, False, True)):
        engine.lookahead = look
        if turn == 1:
            for k in kernels.values():
                k.launches = 0
        res, wall, s = serve_timed(engine, reqs)
        if turn == 1:
            counts = {n: k.launches for n, k in kernels.items()}
        same(f"(a) {'lookahead' if look else 'sync'} turn {turn}", res)
        runs.setdefault(look, []).append((wall, s))
    for look, label in ((False, "sync"), (True, "lookahead")):
        def each(key, scale=1.0, fmt=".1f"):
            return ", ".join(f"{s[key] * scale:{fmt}}" for _, s in runs[look])
        tps = [s["tokens_per_s"] for _, s in runs[look]]
        ttft = [s["ttft_mean_s"] * 1e3 for _, s in runs[look]]
        log(f"# stream (a) {label}: tokens/s {each('tokens_per_s')} (mean "
            f"{statistics.mean(tps):.1f}), ttft mean "
            f"{each('ttft_mean_s', 1e3)} ms (mean "
            f"{statistics.mean(ttft):.1f}), dispatch "
            f"{each('dispatch_ms_mean', fmt='.2f')} ms / host "
            f"{each('host_ms_mean', fmt='.2f')} ms an iteration")
    s_look = runs[True][0][1]
    ratio = (statistics.mean(s["tokens_per_s"] for _, s in runs[True])
             / statistics.mean(s["tokens_per_s"] for _, s in runs[False]))
    log(f"# stream (a): lookahead / sync tokens/s {ratio:.4f}; lookahead "
        f"iterations {s_look['lookahead_iterations']}, rollbacks "
        f"{s_look['rollbacks']}, overlap share "
        f"{s_look['overlap_fraction']:.4f} (overlap "
        f"{s_look['overlap_ms_mean']:.2f} ms an iteration); streams "
        "identical to phase 3's")
    log(f"# stream (a) kernels: launches in the lookahead run "
        f"{json.dumps(counts)}")
    if min(counts.values()) <= 0:
        fail(f"stream: a kernel of the pipelined path never launched: "
             f"{counts}")
    if s_look["lookahead_iterations"] <= 0:
        fail("stream: the lookahead run queued no speculative iteration")

    # (b) forced rollbacks, in turns with plain lookahead runs (faulted,
    # plain, plain, faulted): a rollback abandons one queued dispatch
    engine.lookahead = True
    fault = lambda it: it % 3 == 0  # noqa: E731
    turns = {True: [], False: []}
    try:
        for faulted in (True, False, False, True):
            engine.lookahead_fault = fault if faulted else None
            res, _, s = serve_timed(engine, reqs)
            same(f"(b) {'forced rollbacks' if faulted else 'lookahead'}", res)
            turns[faulted].append(s)
    finally:
        engine.lookahead_fault = None
    s = turns[True][0]
    ratio = (statistics.mean(t["tokens_per_s"] for t in turns[True])
             / statistics.mean(t["tokens_per_s"] for t in turns[False]))
    log(f"# stream (b) forced rollbacks (every 3rd iteration): "
        f"{s['rollbacks']} rollbacks of {s['lookahead_iterations']} "
        f"lookahead iterations, {s['mixed_iterations'] + s['rollbacks']:.0f}"
        f" forwards for {s['mixed_iterations']:.0f} iterations; tokens/s "
        + ", ".join(f"{t['tokens_per_s']:.1f}" for t in turns[True])
        + " against "
        + ", ".join(f"{t['tokens_per_s']:.1f}" for t in turns[False])
        + f" without faults, ratio {ratio:.4f}; streams identical to "
        "phase 3's")
    if min(t["rollbacks"] for t in turns[True]) <= 0:
        fail("stream (b): no rollback")

    # (c) a streaming session: Poisson arrivals at 20 requests/s, every
    # 3rd request cancelled after 2 tokens
    outs, session, caches = stream_session(engine, reqs, 20.0, 3, 12)
    s = engine.last_metrics.summary()
    cut, full = [], []
    for i, o in enumerate(outs):
        res = o["result"]
        cancelled = (i + 1) % 3 == 0
        if o["req_id"] != i:
            fail(f"stream (c): request {i} drained as req_id {o['req_id']}")
        if res is None or res.cancelled != cancelled:
            fail(f"stream (c): request {i} finished "
                 f"{'cancelled' if res and res.cancelled else 'whole'}")
        gen = res.tokens[len(reqs[i].prompt):]
        if list(gen[:len(o['toks'])]) != o["toks"]:
            fail(f"stream (c): request {i} streamed other tokens than its "
                 "Result holds")
        (cut if cancelled else full).append(i)
        if cancelled and len(gen) >= len(plain[i].tokens) - len(
                reqs[i].prompt):
            fail(f"stream (c): cancelled request {i} ran to its end")
    # the session's batches are not phase 3's (the arrivals spread), so the
    # kernels see other token counts: a stream may part only at a near tie
    ties = spec_divergences(
        "stream (c)", engine, [reqs[i] for i in full + cut],
        [plain[i] for i in full]
        + [dataclasses.replace(plain[i],
                               tokens=plain[i].tokens[:len(
                                   outs[i]["result"].tokens)])
           for i in cut],
        [outs[i]["result"] for i in full + cut], dev, max_len,
        [outs[i]["req_id"] for i in full + cut])
    occupancy = [c.occupancy() for c in caches]
    if not caches or any(o != 0 for o in occupancy):
        fail(f"stream (c): cache occupancy at the end {occupancy}")
    lags = [o["recv"][j] - session.emit_t[(o["req_id"], j)]
            for o in outs for j in range(len(o["toks"]))]
    ttft_client = [o["recv"][0] - o["t_submit"] for o in outs if o["recv"]]
    generated = [len(outs[i]["result"].tokens) - len(reqs[i].prompt)
                 for i in cut]
    log(f"# stream (c) session: 8 requests at 20/s (Poisson, seed 12), "
        f"requests {cut} cancelled after 2 tokens ({generated} "
        f"generated); {len(full)} streams equal phase 3's, near-tie "
        f"partings {ties}; cache occupancy at the end {occupancy}")
    log(f"# stream (c) ttft: client clock mean "
        f"{statistics.mean(ttft_client) * 1e3:.1f} ms, engine clock mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms (generate's, (a) sync turn 0: "
        f"{runs[False][0][1]['ttft_mean_s'] * 1e3:.1f} ms); delivery lag "
        f"emit -> client mean {statistics.mean(lags) * 1e3:.3f} ms, max "
        f"{max(lags) * 1e3:.3f} ms over {len(lags)} tokens; "
        f"{s['tokens_per_s']:.1f} tokens/s, {s['lookahead_iterations']} "
        f"lookahead iterations, {s['rollbacks']} rollbacks, "
        f"{s['cancellations']} cancellations")

    # (d) every pipelined iteration queued without a host sync
    with sync_free_lookahead():
        res, _, s = serve_timed(engine, reqs)
    same("(d) sync debug", res)
    engine.lookahead = False
    log(f"# stream (d): {s['mixed_iterations']:.0f} iterations planned, "
        "dispatched and advanced under the sync debug mode \"error\": no "
        "host sync")
    return counts


def gemma_phase(dev, rng, report, profiling):
    """Phase 10: gemma3-27b at full width cut to 2 of its 62 layers, every
    2nd global (a 1024-token windowed layer and a global one: both kinds
    of the 5:1 pattern; 6 layers until the smoke passed 1050 s with
    phase 19): the serving launcher's state, GEMMA_REQUESTS requests
    (8 until the smoke passed 1050 s with phase 20) past the 1024-token
    window through ``ElasticEngine``, GAR
    at its shapes, the decode check, and one greedy request
    card vs CPU on the deployed row cut to 2 layers. Returns launches by
    kernel and the GAR error."""
    from repro_torch.configs import Segment, get_config
    from repro_torch.core import flexrank as FR
    from repro_torch.kernels import gar_matmul, paged_attention, sampling
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import ElasticEngine, Request, SamplingParams
    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full, segments=(Segment("attn", 2),),
                              num_layers=2, global_every=2)
    for c in (full, cfg):
        n = cm.param_count(tfm.model_spec(c))
        log(f"# gemma3: {c.num_layers} layers: {n / 1e9:.3f} B dense "
            f"parameters, {4 * n / 1e9:.1f} GB in float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, 0, timings=setup)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    peak_state = torch.cuda.max_memory_allocated() / 1e9
    # the first serve carries the metrics registry and the cost-model audit
    # (phase 18's plane, read here where bytes bound the step); the later
    # turns run without them and must give the same streams
    engine = ElasticEngine(cfg, params_fact, table, infos, device="cuda",
                           prefill_chunk=256, max_batch=8, max_len=2048,
                           registry=MetricsRegistry(), costaudit=True)
    budgets = (0.4, 1.0)
    rows = [engine._budget_row(b) for b in budgets]
    deployed = {r: engine._realize(r) for r in rows}
    log(f"# gemma3 setup: dense init {t_init:.2f} s, calibrate "
        f"{setup['calibrate']:.2f} s, decompose {setup['decompose']:.2f} s "
        f"(DataSVD, {len(infos)} groups x 2 layers on the card), DP "
        f"{setup['dp']:.2f} s ({table.table.shape[0]} rows), deploy "
        + ", ".join(f"row {r} (budget {b}) {engine.deploy_seconds[r]:.2f} s"
                    for b, r in zip(budgets, rows))
        + f"; peak device memory {peak_state:.2f} GB building the state")
    log(f"# gemma3 table: ranks by group {[i.path for i in infos]}: "
        + "; ".join(f"row {k} {table.table[k].tolist()}"
                    for k in range(table.table.shape[0])))

    # GAR at gemma3's shapes from the deployed leaves: gate at the 0.4 row
    # and at full rank, down at full rank (m - r = 0); decode and prefill T
    shapes = []
    for r, projs in ((rows[0], ("mlp/gate",)),
                     (rows[1], ("mlp/gate", "mlp/down"))):
        layer = deployed[r]["segments"][0]
        for proj in projs:
            leaf = cm.tree_get(layer, proj)
            vt, uh, pi = (leaf["v_tilde"][0], leaf["u_hat"][0],
                          leaf["perm_inv"][0])
            n, rr = vt.shape
            for t in (8, 264):
                shapes.append((f"gemma3 {proj} row {r} T={t} n={n} r={rr} "
                               f"m={rr + uh.shape[0]}", t, vt, uh, pi))
    gar_err = check_gar(dev, shapes, rng, report)

    prng = np.random.default_rng(2)
    reqs = []
    for i in range(GEMMA_REQUESTS):
        plen = int(prng.integers(1100, 1501))
        samp = (SamplingParams(temperature=0.8, top_k=40, seed=200 + i)
                if i % 2 else None)
        reqs.append(Request(
            prompt=prng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=32, budget=budgets[i % 2], sampling=samp))
    for k in (gar_matmul, paged_attention, sampling):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.generate(reqs, mode="continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"gar_matmul": gar_matmul.launches,
              "paged_prefill_attention": paged_attention.launches,
              "topk_mask_sample": sampling.launches}
    for rq, rs in zip(reqs, results):
        if len(rs.tokens) != len(rq.prompt) + 32:
            fail(f"gemma3: request of {len(rq.prompt)} tokens returned "
                 f"{len(rs.tokens)}")
        gen = rs.tokens[len(rq.prompt):]
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail("gemma3: generated token out of the vocabulary")
    s = engine.last_metrics.summary()
    log(f"# gemma3 serving: full width, 2 of 62 layers, {len(reqs)} "
        f"requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}"
        f", 32 new each, budgets 0.4/1.0 -> rows {rows}), wall {wall:.2f} s,"
        f" {s['tokens_per_s']:.1f} tok/s, ttft mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms, {s['mixed_iterations']:.0f} mixed "
        f"iterations, dispatch {s['dispatch_ms_mean']:.2f} ms / host "
        f"{s['host_ms_mean']:.2f} ms per iteration, preemptions "
        f"{s['preemptions']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"# gemma3 kernels: launches serving {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        fail(f"gemma3: a kernel of the serving path never launched: {counts}")
    audit = engine.costaudit.statusz()
    ratios = [c["error_ratio"] for c in audit["cells"]]
    snap = engine.registry.snapshot()
    if snap["repro_generated_tokens_total"] != len(reqs) * 32:
        fail(f"gemma3: the registry counted "
             f"{snap['repro_generated_tokens_total']} generated tokens")
    log(f"# gemma3 audit (registry and costaudit=True on this serve): "
        f"bandwidth {audit['bandwidth_gb_per_s']:.3f} GB/s, error ratios "
        f"{min(ratios):.4f}-{max(ratios):.4f} over {len(ratios)} cells "
        + json.dumps([[c["row"], c["bucket"], c["count"],
                       round(c["measured_mean_ms"], 4),
                       round(c["predicted_mb"], 3),
                       round(c["error_ratio"], 4)] for c in audit["cells"]])
        + " [row, bucket, iterations, measured ms, predicted MB, ratio]")
    engine.registry = engine.costaudit = None

    # the same requests through the lookahead pipeline and the synchronous
    # loop in turns (lookahead, sync, sync, lookahead), with prefix caching
    # on (windows, GQA, chunks of 256 and the prefix index under lookahead;
    # the prompts share nothing, so every stream stays the plain run's);
    # the lookahead turns plan, dispatch and advance under the sync debug
    # mode "error"
    engine.prefix_cache = True
    turns = {True: [], False: []}
    try:
        for look in (True, False, False, True):
            engine.lookahead = look
            with (sync_free_lookahead() if look
                  else contextlib.nullcontext()):
                res, _, s_turn = serve_timed(engine, reqs)
            for i, (a, b) in enumerate(zip(results, res)):
                if not np.array_equal(a.tokens, b.tokens):
                    fail(f"gemma3 {'lookahead' if look else 'sync'}: "
                         f"request {i} differs from the plain run")
            turns[look].append(s_turn)
    finally:
        engine.lookahead, engine.prefix_cache = False, False
    for look, label in ((False, "sync"), (True, "lookahead")):
        log(f"# gemma3 {label} turns: tokens/s "
            + ", ".join(f"{t['tokens_per_s']:.1f}" for t in turns[look])
            + ", ttft mean "
            + ", ".join(f"{t['ttft_mean_s'] * 1e3:.1f}" for t in turns[look])
            + " ms, dispatch "
            + ", ".join(f"{t['dispatch_ms_mean']:.2f}" for t in turns[look])
            + " ms / host "
            + ", ".join(f"{t['host_ms_mean']:.2f}" for t in turns[look])
            + " ms an iteration, overlap share "
            + ", ".join(f"{t['overlap_fraction']:.4f}" for t in turns[look]))
    ratio = (statistics.mean(t["tokens_per_s"] for t in turns[True])
             / statistics.mean(t["tokens_per_s"] for t in turns[False]))
    log(f"# gemma3 lookahead / sync tokens/s {ratio:.4f}; "
        f"{turns[True][0]['lookahead_iterations']} lookahead iterations, "
        f"{turns[True][0]['rollbacks']} rollbacks a run; streams identical "
        "to the plain run's, no host sync in any planned, dispatched and "
        "advanced iteration")
    if profiling:
        profile_main_path(engine, reqs)

    # speculation on the same engine and requests: a draft rank halfway
    # between rows 0 and 1's costs makes row 0 (deployed) the top row's
    # draft row; the draft slots alias the prompts' blocks (prompts of
    # 1100-1500 tokens would take some 40 rounds of 32-token warmup feeds,
    # longer than the 32 new tokens)
    cost = engine._cost_table
    draft_rank = float(cost[0] + cost[1]) / 2 / float(cost[-1])
    if FR.nested_prefix_row(table, rows[1], draft_rank, cost) != rows[0]:
        fail(f"gemma3: draft_rank {draft_rank} does not resolve row "
             f"{rows[0]} for row {rows[1]}")
    spec_counts, _ = spec_phase("gemma3", engine, reqs, results, s,
                                draft_rank, dev, 2048, prefix_cache=True)

    # the decode check on the served rows, 8 prompts past the window
    prompts = [prng.integers(0, cfg.vocab_size, int(prng.integers(1100, 1501))
                             ).astype(np.int32) for _ in range(8)]
    counts["paged_attention"], _, _, _ = decode_check(
        cfg, deployed, prompts, GEMMA_DECODE_STEPS, dev, 2048)

    for k in ("gar_matmul", "paged_prefill_attention", "topk_mask_sample"):
        counts[k] += spec_counts[k]
    return counts, gar_err


def _card_work(ev) -> bool:
    """Whether a profiler event is the card's own work (a kernel, a copy, a
    fill); operators and annotations carry their kernels' time."""
    return not (ev.key in ("paged_sample_step", "paged_mixed_step",
                           "expert_products")
                or ev.key.startswith("aten::")
                or "cuda" not in str(getattr(ev, "device_type", "")).lower())


def kernel_rows(prof) -> list:
    """(device us, launches, name) per kernel of a profiler run, largest
    first."""
    rows = []
    for ev in prof.key_averages():
        if not _card_work(ev):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals: the card's busy
    time, each overlap counted once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


PROFILE_TRIES = 2   # profiles ``profiled_kernel_ms`` takes at most
# a device sleep (~20 ms) at each end of a profile: late in a long run the
# profiler has dropped the first or last 6-8 kernels of a window
PAD_CYCLES = 40_000_000


def profiled_kernel_ms(fn, n: int):
    """``fn`` called ``n`` times under ``torch.profiler``, each call ending
    in a sync. Returns a dict a call: ``busy_ms`` (the union of the card's
    kernel intervals: GAR's second launch starts under its first by
    programmatic dependent launch, so the sum of kernel times counts the
    overlap twice), ``sum_ms``, ``launches``, ``wall_ms`` (the host's clock
    over the synced window), ``rows`` (``kernel_rows``) and ``tries``; or,
    where no profile passes the checks, a string that says why. The
    checks: the GAR kernels in the profile number the ``gar_matmul``
    wrapper's launches in the window, and the busy time is at most the
    window's wall time. A device sleep pads each end of the window,
    outside the calls; up to ``PROFILE_TRIES`` profiles are taken (each
    ``n`` more calls)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import gar_matmul
    why = []
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            before = gar_matmul.launches
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launched = gar_matmul.launches - before
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        work = [ev for ev in prof.events()
                if _card_work(ev) and "spin_kernel" not in ev.key]
        gar_seen = sum(1 for ev in work if "gar_stage" in ev.key)
        busy = busy_us((ev.time_range.start, ev.time_range.end)
                       for ev in work) / 1e3
        if gar_seen != launched:
            why.append(f"{gar_seen} GAR kernels of {launched} launched")
        elif busy > wall:
            why.append(f"{busy:.3f} ms busy in {wall:.3f} ms of wall time")
        else:
            return {"busy_ms": busy / n,
                    "sum_ms": sum(ev.time_range.elapsed_us() for ev in work)
                    / (1e3 * n),
                    "launches": len(work) / n, "wall_ms": wall / n,
                    "rows": [r for r in kernel_rows(prof)
                             if "spin_kernel" not in r[2]],
                    "tries": tries}
    return f"not measured ({'; '.join(why)} in {PROFILE_TRIES} profiles)"


def profile_main_path(engine, reqs) -> None:
    """Serve ``reqs`` again under ``torch.profiler`` and print the device
    time by kernel and the kernels' busy share of the window; then once
    more under ``cProfile`` and print the host time by function."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(reqs, mode="continuous")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    # the host's share: the same requests once more under cProfile
    import cProfile
    import pstats
    host = cProfile.Profile()
    host.enable()
    engine.generate(reqs, mode="continuous")
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
    log(f"# profile: wall {wall:.3f} s (profiler on), kernels busy "
        f"{busy:.3f} s = {100 * busy / wall:.1f}% of the wall, "
        f"{sum(r[1] for r in rows)} kernel launches")
    for dev_us, count, key in rows[:15]:
        log(f"#   {dev_us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    log(f"# host profile: {stats.total_tt:.3f} s of Python under cProfile, "
        "top functions by own time:")
    for (path, line, func), (_, ncalls, tottime, cumtime, _) in top:
        log(f"#   {tottime * 1e3:9.2f} ms own {cumtime * 1e3:9.2f} ms cum "
            f"{ncalls:7d}x  {Path(path).name}:{line} {func}")


def train_phase(cfg, dense, steps: int, kernels):
    """``launch.train.run`` at full width from ``dense`` (the teacher) on
    the launcher's default source (8 x 129 tokens a batch). ``kernels``:
    the kernel modules of the path, whose launch counts are set to 0 just
    before and read just after; each must have launched. Returns (the run,
    launches by kernel, median seconds per step)."""
    from repro_torch.data import make_source
    from repro_torch.launch import train
    source = make_source(cfg.vocab_size, 128, 8, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = train.run(cfg, dense, source, steps=steps, lr=1e-3, seed=0,
                    log=lambda msg: log(f"#   {msg}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    if not all(math.isfinite(x) for x in res.losses) or len(res.losses) \
            != steps:
        fail(f"{cfg.name}: training losses not finite: {res.losses}")
    if not all(math.isfinite(x) for x in res.eval_before + res.eval_after):
        fail(f"{cfg.name}: elastic eval CE not finite")
    if min(launches.values()) <= 0:
        fail(f"{cfg.name}: a kernel of the training path never launched: "
             f"{launches}")
    tokens = 8 * 128
    med = statistics.median(res.step_seconds[1:] or res.step_seconds)
    su = res.setup_seconds
    log(f"# train: {cfg.name} full width, {cfg.num_layers} layers, {steps} "
        f"steps of flexrank_kd (batch 8 x 128 = {tokens} tokens, AdamW lr "
        f"1e-3), wall {wall:.2f} s; setup: calibrate {su['calibrate']:.2f} "
        f"s, decompose {su['decompose']:.2f} s (DataSVD on the card), DP "
        f"{su['dp']:.2f} s ({res.table.table.shape[0]} rows x "
        f"{res.table.table.shape[1]} groups)")
    log(f"# train: step ms {[round(x * 1e3, 1) for x in res.step_seconds]}")
    log(f"# train: median {med * 1e3:.2f} ms/step after the first, "
        f"{tokens / med:.0f} training tokens/s; first step "
        f"{res.step_seconds[0] * 1e3:.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"# train: losses {[round(x, 5) for x in res.losses]}")
    log(f"# train: budget rows {res.budget_rows}")
    log(f"# train: CE per row before {[round(x, 4) for x in res.eval_before]}"
        f" after {[round(x, 4) for x in res.eval_after]}")
    log(f"# train: launches {json.dumps(launches)} (8 calibration "
        f"forwards, {steps} steps, {2 * res.table.table.shape[0]} eval "
        "forwards)")
    return res, launches, med


def cut_depth(tree, cfg, small):
    """The first layers of every segment of ``tree`` (params of ``cfg``)
    that ``small`` keeps: ``count`` of a segment, ``mamba_per_unit`` of a
    zamba unit's mamba stack and ``self_per_unit`` of a vision unit's self
    blocks."""
    from repro_torch.models import common as cm
    segs = []
    for seg, keep, p in zip(cfg.segments, small.segments, tree["segments"]):
        p = cm.tree_map(lambda a: a[:keep.count], p)
        if seg.kind == "zamba_unit":
            p["mambas"] = cm.tree_map(lambda a: a[:, :keep.mamba_per_unit],
                                      p["mambas"])
        if seg.kind == "vision_unit":
            p["selfs"] = cm.tree_map(lambda a: a[:, :keep.self_per_unit],
                                     p["selfs"])
        segs.append(p)
    return dict(tree, segments=segs)


def profile_train(cfg, res, dense, steps: int = 3) -> None:
    """``steps`` more training steps from ``res`` under ``torch.profiler``:
    device time by kernel and the kernels' busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import threefry
    from repro_torch.core import flexrank as FR
    from repro_torch.data import make_source
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    source = make_source(cfg.vocab_size, 128, 8, seed=0)
    loss_fn = FR.make_consolidation_loss(cfg, res.infos,
                                         FR.table_host(res.table), dense)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    params, state = res.params, res.opt_state
    batches = [{"tokens": torch.as_tensor(source.batch_at(100 + i)["tokens"],
                                          device="cuda")}
               for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            params, state, _ = train.train_step(
                params, state, loss_fn, opt_cfg, batch,
                threefry.fold_in(threefry.prng_key(1), 100 + i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"# train profile: {steps} steps, wall {wall:.3f} s (profiler on), "
        f"kernels busy {busy:.3f} s = {100 * busy / wall:.1f}% of the wall,"
        f" {sum(r[1] for r in rows)} kernel launches")
    for dev_us, count, key in rows[:15]:
        log(f"#   {dev_us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def cross_train_phase(cfg, trained, table, infos, dense, dev):
    """One consolidation step's loss and gradients from the ``trained``
    factors at budget row 0, on the card and on the CPU."""
    from repro_torch import threefry
    from repro_torch.core import flexrank as FR
    from repro_torch.data import make_source
    from repro_torch.models import common as cm
    table_rows = FR.table_host(table)
    seed = next(i for i in range(1000) if FR.budget_draw(
        threefry.prng_key(i), table_rows.shape[0]) == 0)
    tokens = make_source(cfg.vocab_size, 32, 2, seed=1).batch_at(0)["tokens"]
    out = []
    for device in (dev, torch.device("cpu")):
        params = cm.tree_map(
            lambda t: t.detach().to(device).clone().requires_grad_(True),
            trained)
        teacher = cm.tree_map(lambda t: t.to(device), dense)
        loss_fn = FR.make_consolidation_loss(cfg, infos, table_rows, teacher)
        t0 = time.perf_counter()
        loss, metrics = loss_fn(
            params, {"tokens": torch.as_tensor(tokens, device=device)},
            threefry.prng_key(seed))
        loss.backward()
        grads = [(name, torch.zeros(p.shape) if p.grad is None
                  else p.grad.cpu()) for name, p in cm.tree_items(params)]
        out.append((float(loss.detach()), metrics["budget_k"], grads,
                    time.perf_counter() - t0))
    (l_gpu, k_gpu, g_gpu, t_gpu), (l_cpu, k_cpu, g_cpu, t_cpu) = out
    if not k_gpu == k_cpu == 0:
        fail(f"budget rows differ: card {k_gpu}, CPU {k_cpu}")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst_name, worst = "", 0.0
    for (name, a), (_, b) in zip(g_gpu, g_cpu):
        e = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
        if e > worst:
            worst_name, worst = name, e
    log(f"# cross-train: {cfg.name} {cfg.num_layers} layers, row 0, loss "
        f"card {l_gpu:.7f} CPU {l_cpu:.7f} (rel "
        f"{loss_err:.2e}), {len(g_gpu)} gradient leaves, worst {worst:.2e} "
        f"of its max at {worst_name}; step {t_gpu:.2f} s card, {t_cpu:.2f} s"
        " CPU")
    if not loss_err < TOL_TRAIN_LOSS:
        fail(f"{cfg.name}: training loss card vs CPU: rel {loss_err:.3e}")
    if not worst < TOL_TRAIN_GRAD:
        fail(f"{cfg.name}: gradient {worst_name} card vs CPU: {worst:.3e} "
             "of its max")


def recurrent_phase(name, layers, keep, kernels, dev, profiling):
    """Phases 7 and 8: ``train_phase`` on ``name`` at full width cut to
    the segments ``layers`` (5 steps), then the card-vs-CPU step on the
    trained factors cut to the segments ``keep``. Returns (launches by
    kernel, median seconds per step, the run, its config)."""
    from repro_torch.configs import get_config
    from repro_torch.core import flexrank as FR
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    full = get_config(name)
    cfg = dataclasses.replace(full, segments=layers,
                              num_layers=_layer_count(layers))
    for c in (full, cfg):
        # float32 training state: the teacher, and the student with its
        # gradients and two AdamW moments
        dense_n = cm.param_count(tfm.model_spec(c))
        fact_n = cm.param_count(FR.factorized_spec(c))
        log(f"# {name}: {c.num_layers} layers: {dense_n / 1e9:.3f} B dense, "
            f"{fact_n / 1e9:.3f} B factorized parameters, training state "
            f"{4 * (dense_n + 4 * fact_n) / 1e9:.1f} GB")
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    log(f"# {name}: dense init {time.perf_counter() - t0:.2f} s at d "
        f"{cfg.d_model}, {cfg.num_layers} of {full.num_layers} layers")
    res, launches, med = train_phase(cfg, dense, 5, kernels)
    if profiling:
        profile_train(cfg, res, dense)
    small = dataclasses.replace(cfg, segments=keep,
                                num_layers=_layer_count(keep))
    cross_train_phase(small, cut_depth(res.params, cfg, small), res.table,
                      FR.group_infos(small), cut_depth(dense, cfg, small),
                      dev)
    return launches, med, res, cfg


# --------------------------------------------------- training modes

MODE_STEPS = 3                 # steps of each of phase 19's (a)-(c)


def _steps(label, step_fn, params, state, batch_at, key_at, lowrank):
    """``MODE_STEPS`` steps of ``step_fn(params, state, batch, key)``
    (metrics with ``loss``), each ended by reading its loss. Returns
    (params, state, lowrank launches, median ms/step after the first,
    peak device GB)."""
    lowrank.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(MODE_STEPS):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch_at(i), key_at(i))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    launches = lowrank.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 19 {label}: losses not finite: {losses}")
    med = statistics.median(secs[1:])
    log(f"# modes {label}: {MODE_STEPS} steps of 8 x 128, losses "
        f"{[round(x, 5) for x in losses]}, ms/step "
        f"{[round(x * 1e3, 1) for x in secs]} (median after the first "
        f"{med * 1e3:.2f}), peak {peak:.2f} GB, lowrank_matmul launches "
        f"{launches}")
    return params, state, launches, med * 1e3, peak


def _leaf_err(a, b) -> float:
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _cross_modes(cfg, trained, dense, dev, smi):
    """Phase 19 (d): one step of each of (a)-(c) from the same weights at
    2 layers on the card and on the CPU: the loss within TOL_TRAIN_LOSS,
    every gradient leaf and every updated parameter leaf within
    TOL_TRAIN_GRAD of its max. Where a gradient entry lies within
    TOL_TRAIN_GRAD of its leaf's max around zero, Adam's normalised step
    may take either sign on the two devices: such an entry may differ by
    up to twice the step's learning rate (counted in the log). Muon's
    matrix leaves are held instead against the same step in float64 from
    the CPU's gradient (on the card, in float64): the card's within twice
    the CPU's own distance from it (or TOL_TRAIN_GRAD of the leaf's
    max). Newton-Schulz in
    float32 loses the directions whose squared singular value falls
    below the Gram matrix's rounding, and a 64-token batch's gradients
    have many."""
    from repro_torch import threefry
    from repro_torch.core import flexrank as FR
    from repro_torch.data import make_source
    from repro_torch.launch import specs as SP
    from repro_torch.launch import train
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, muon
    small = dataclasses.replace(cfg, segments=cfg.segments[:2],
                                num_layers=2)   # gpt2: a segment a layer
    fact = cut_depth(trained.params, cfg, small)
    teacher = cut_depth(dense, cfg, small)
    tokens = make_source(cfg.vocab_size, 32, 2, seed=1).batch_at(0)["tokens"]
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=MODE_STEPS)
    mcfg = muon.MuonConfig(lr=1e-2, adamw=opt_cfg)
    table_rows = FR.table_host(trained.table)
    for label, start, ocfg in (("dense", teacher, opt_cfg),
                               ("flexrank", fact, opt_cfg),
                               ("flexrank_kd muon", fact, mcfg)):
        out = []
        for device in (dev, torch.device("cpu")):
            params = cm.tree_map(lambda t: t.detach().to(device).clone()
                                 .requires_grad_(True), start)
            if ocfg is mcfg:
                kd_loss = FR.make_consolidation_loss(
                    small, FR.group_infos(small), table_rows,
                    cm.tree_map(lambda t: t.to(device), teacher))

                def loss_fn(p, b, r):
                    return kd_loss(p, b, r)[0]
                state = muon.init(params, ocfg)
            else:
                loss_fn = SP.make_train_step(small, opt_cfg,
                                             mode=label).loss_fn
                state = adamw.init(params)
            t0 = time.perf_counter()
            with tfm.remat_blocks():
                loss = loss_fn(params, {"tokens": torch.as_tensor(
                    tokens, device=device)}, threefry.prng_key(3))
                loss.backward()
            grads = SP.grads_of(params)
            g_host = [g.detach().cpu().clone() for g in cm.tree_leaves(grads)]
            params, state, om = SP.apply_updates(params, grads, state,
                                                 ocfg)
            out.append((float(loss.detach()), g_host,
                        [p.detach().cpu() for p in cm.tree_leaves(params)],
                        om["lr"], time.perf_counter() - t0))
        (l_g, g_g, p_g, _, t_g), (l_c, g_c, p_c, lr, t_c) = out
        loss_err = abs(l_g - l_c) / abs(l_c)
        g_worst = max(_leaf_err(a, b) for a, b in zip(g_g, g_c))
        p_worst, p_name, flips, ns = 0.0, "", 0, []
        names = [n for n, _ in cm.tree_items(start)]
        for name, p0, a, b, g in zip(names, cm.tree_leaves(start), p_g, p_c,
                                     g_c):
            scale = float(b.abs().max()) + 1e-30
            err = (a - b).abs()
            if ocfg is mcfg and p0.dim() >= 2:
                # the first step: zero momentum, so the Nesterov update is
                # g (1 + momentum)
                o = muon.newton_schulz(
                    g.to(dev).double() * (1 + ocfg.momentum),
                    ocfg.ns_steps).cpu()
                step = ocfg.lr * math.sqrt(max(1.0, p0.shape[-2]
                                               / p0.shape[-1]))
                ref = p0.detach().cpu().double() - step * o
                e_card = float((a.double() - ref).abs().max())
                e_cpu = float((b.double() - ref).abs().max())
                ns.append((e_card / max(e_cpu, 1e-30), name))
                e = float(err.max()) / scale
                if e_card <= 2.0 * e_cpu:
                    e = 0.0
            else:
                noise = g.abs() <= TOL_TRAIN_GRAD * float(g.abs().max())
                flips += int(((err > TOL_TRAIN_GRAD * scale)
                              & noise).sum())
                err = torch.where(noise & (err <= 2.0 * lr + 1e-7),
                                  torch.zeros_like(err), err)
                e = float(err.max()) / scale
            if e > p_worst:
                p_worst, p_name = e, name
        ns_line = ""
        if ns:
            worst_ns = max(ns)
            ns_line = (f"; Muon matrix leaves: the card's distance from the "
                       f"float64 step at most {worst_ns[0]:.2f}x the CPU's "
                       f"({worst_ns[1]})")
        log(f"# modes (d) {label}: 2 layers, loss card {l_g:.7f} CPU "
            f"{l_c:.7f} (rel {loss_err:.2e}), worst gradient leaf "
            f"{g_worst:.2e} of its max, worst updated parameter leaf "
            f"{p_worst:.2e} ({p_name or 'none'}; {flips} entries at a "
            f"noise-level gradient moved by the other sign){ns_line}, step "
            f"{t_g:.2f} s card, {t_c:.2f} s CPU; {smi}")
        if not (loss_err < TOL_TRAIN_LOSS and g_worst < TOL_TRAIN_GRAD
                and p_worst < TOL_TRAIN_GRAD):
            fail(f"phase 19 (d) {label}: card vs CPU: loss {loss_err:.3e}, "
                 f"gradient {g_worst:.3e}, parameters {p_worst:.3e}")


def _powersgd_check(grads, smi):
    """Phase 19 (e): ``compress_decompress`` over a gradient tree on the
    card and on the CPU from the same ``init`` (drawn on the card)."""
    from repro_torch.models import common as cm
    from repro_torch.optim import compression as C
    pcfg = C.PowerSGDConfig()
    t0 = time.perf_counter()
    st = C.init(grads, pcfg, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    st_cpu = C.PowerSGDState(q=cm.tree_map(lambda t: t.cpu(), st.q),
                             error=cm.tree_map(lambda t: t.cpu(), st.error))
    g_cpu = cm.tree_map(lambda t: t.detach().cpu(), grads)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    gh, st2, m = C.compress_decompress(grads, st, pcfg)
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gh_c, st2_c, m_c = C.compress_decompress(g_cpu, st_cpu, pcfg)
    t_cpu = time.perf_counter() - t0
    worst = 0.0
    for a, b, ea, eb, g in zip(cm.tree_leaves(gh), cm.tree_leaves(gh_c),
                               cm.tree_leaves(st2.error),
                               cm.tree_leaves(st2_c.error),
                               cm.tree_leaves(g_cpu)):
        scale = float(g.abs().max()) + 1e-30
        worst = max(worst, float((a.cpu() - b).abs().max()) / scale)
        if ea.numel():
            worst = max(worst, float((ea.cpu() - eb).abs().max()) / scale)
    n_comp = sum(int(q.numel() > 0) for q in cm.tree_leaves(st.q))
    log(f"# modes (e) powersgd: rank {pcfg.rank}, {n_comp} of "
        f"{len(cm.tree_leaves(st.q))} leaves compressed, ratio "
        f"{m['powersgd_ratio']:.5f} ({m['powersgd_comp_bytes']} of "
        f"{m['powersgd_raw_bytes']} bytes), card {e0.elapsed_time(e1):.2f} "
        f"ms (init {t_init:.2f} s), CPU {t_cpu:.2f} s; ghat and error card "
        f"vs CPU worst {worst:.2e} of the leaf's gradient max; {smi}")
    if m != m_c or not worst < TOL_POWERSGD:
        fail(f"phase 19 (e): PowerSGD card vs CPU {worst:.3e} (metrics "
             f"{m} / {m_c})")


def _preempt_check(smi):
    """Phase 19 (f): the launcher at full width, ``--mode dense --steps 6
    --ckpt-every 2``: run 1 gets a real SIGTERM after step 3 and saves
    step 4; run 2 resumes there and finishes; an uninterrupted run in
    another directory; and the uninterrupted run again with
    ``--mesh-shape 4,1`` (no checkpoints), which shrinks to the one card
    and must train bit for bit as without the flag. Steps 4-5's losses
    and the final parameters within TOL_TRAIN_LOSS. The launcher's config
    is cut to 2 of gpt2's 12 layers
    (its ``get_config`` patched): at 12 the three runs took 27.3 s of the
    smoke's budget, most of it 1.5 GB checkpoints."""
    from unittest import mock
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import common as cm

    def two_layers(arch, smoke=False):
        """The launcher's config at full width, 2 of its layers (gpt2:
        a segment a layer)."""
        cfg = get_config(arch, smoke=smoke)
        return dataclasses.replace(cfg, segments=cfg.segments[:2],
                                   num_layers=2)
    tmp = tempfile.mkdtemp(prefix="smoke19_")
    stack = contextlib.ExitStack()
    args = ["--mode", "dense", "--steps", "6", "--ckpt-every", "2",
            "--seq-len", "128", "--batch", "8"]

    def sigterm_after_3(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        stack.enter_context(mock.patch.object(train, "get_config",
                                              two_layers))
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        _, first = train.main(args + ["--ckpt-dir", a],
                              step_hook=sigterm_after_3)
        t1 = time.perf_counter()
        steps_a = CheckpointManager(a).all_steps()
        p2, second = train.main(args + ["--ckpt-dir", a])
        t2 = time.perf_counter()
        p_full, full = train.main(args + ["--ckpt-dir", b])
        t3 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(b) for f in fs)
        p_mesh, meshed = train.main(args + ["--mesh-shape", "4,1"])
        t4 = time.perf_counter()
    finally:
        stack.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if len(first) != 4 or steps_a[-1:] != [4] or len(second) != 2 \
            or len(full) != 6:
        fail(f"phase 19 (f): preempted run {len(first)} steps, checkpoints "
             f"{steps_a}, resumed {len(second)}, uninterrupted {len(full)}")
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(second, full[4:]))
    worst = max(_leaf_err(x, y.cpu()) for x, y in
                zip(cm.tree_leaves(p2), cm.tree_leaves(p_full)))
    same = second == full[4:] and all(
        torch.equal(x, y) for x, y in zip(cm.tree_leaves(p2),
                                          cm.tree_leaves(p_full)))
    log(f"# modes (f) preemption, 2 of 12 layers: run 1 {len(first)} steps "
        f"then SIGTERM, "
        f"checkpoints {steps_a} ({t1 - t0:.2f} s), run 2 resumed at 4 "
        f"({t2 - t1:.2f} s), uninterrupted ({t3 - t2:.2f} s, "
        f"{size / 1e9:.2f} GB of checkpoints kept); steps 4-5 losses "
        f"{second} vs {full[4:]} (rel {loss_err:.2e}), final parameters "
        f"worst {worst:.2e} of a leaf's max, bit-identical: {same}; {smi}")
    if not (loss_err < TOL_TRAIN_LOSS and worst < TOL_TRAIN_LOSS):
        fail(f"phase 19 (f): resumed vs uninterrupted: losses "
             f"{loss_err:.3e}, parameters {worst:.3e}")
    mesh_same = meshed == full and all(
        torch.equal(x, y) for x, y in zip(cm.tree_leaves(p_mesh),
                                          cm.tree_leaves(p_full)))
    log(f"# modes (f) --mesh-shape 4,1 ({t4 - t3:.2f} s): 6 steps on a 1 x "
        f"1 mesh, losses {meshed}, bit-identical to the uninterrupted run: "
        f"{mesh_same}; {smi}")
    if not mesh_same:
        fail("phase 19 (f): --mesh-shape 4,1 trains otherwise than without "
             "the flag")


def _nested_check(smi):
    """Phase 19 (g): ``nestedness.train(nsl_loss)`` on the 6 x 5 target,
    1000 steps, on the card and on the CPU from the same draws: every
    prefix product within TOL_NESTED of max |M*|, and the card's NSL
    gaps below 5e-3 (Theorem 4.3, as ``tests/test_nestedness_theory.py``
    asserts)."""
    from repro_torch.core import nestedness as NS
    m_star = NS.make_target(np.random.default_rng(7), 6, 5, decay=1.2)
    out = []
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = NS.train(NS.nsl_loss, m_star, steps=1000, seed=1, device=device)
        pre = torch.cumsum(torch.einsum("mj,nj->jmn", p.u.double(),
                                        p.v.double()), 0).cpu()
        out.append((p, pre, time.perf_counter() - t0))
    (p_g, pre_g, t_g), (_, pre_c, t_c) = out
    err = float((pre_g - pre_c).abs().max()) / float(np.abs(m_star).max())
    gaps = NS.pareto_gaps(p_g, m_star)
    log(f"# modes (g) nestedness: NSL 1000 steps, card {t_g:.2f} s, CPU "
        f"{t_c:.2f} s; prefix products card vs CPU {err:.2e} of max |M*|; "
        f"card gaps {[float(f'{g:.3e}') for g in gaps]}; {smi}")
    if not (err < TOL_NESTED and gaps.max() < 5e-3):
        fail(f"phase 19 (g): nestedness card vs CPU {err:.3e}, gaps {gaps}")


def modes_phase(cfg, dense, trained, dev, lowrank, smi) -> int:
    """Phase 19 on phase 5's gpt2-small dense weights (``dense``) and
    trained factors (``trained``, the ``TrainRun``): (a) dense through
    ``make_train_step`` with remat, then one loss and gradient with and
    without remat from the same state; (b) ``flexrank`` mode on the
    uniform table; (c) ``flexrank_kd`` with Muon, its optimizer step
    timed by CUDA events; (d)-(g) as their helpers say. Returns the
    ``lowrank_matmul`` launches of (b) and (c)."""
    from repro_torch import threefry
    from repro_torch.core import flexrank as FR
    from repro_torch.data import make_source
    from repro_torch.launch import specs as SP
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, muon
    source = make_source(cfg.vocab_size, 128, 8, seed=0)

    def batch_at(step):
        return {"tokens": torch.as_tensor(source.batch_at(step)["tokens"],
                                          device=dev)}

    def key_at(step):
        return threefry.fold_in(threefry.prng_key(1), step)

    def fresh(tree):
        return cm.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), tree)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=MODE_STEPS)

    # (a) dense, remat, then one loss and gradient with and without it
    step_a = SP.make_train_step(cfg, opt_cfg, mode="dense")
    params = fresh(dense)
    params, state, _, ms_a, _ = _steps("(a) dense", step_a, params,
                                       adamw.init(params), batch_at, key_at,
                                       lowrank)
    rows = {}
    for remat in (True, False):
        SP.clear_grads(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tfm.remat_blocks() if remat else contextlib.nullcontext():
            loss = step_a.loss_fn(params, batch_at(MODE_STEPS),
                                  key_at(MODE_STEPS))
            loss.backward()
        loss = float(loss.detach())
        dt = time.perf_counter() - t0
        rows[remat] = (loss, SP.grads_of(params), dt,
                       (torch.cuda.max_memory_allocated() - base) / 1e9)
        SP.clear_grads(params)
    (l_r, g_r, t_r, m_r), (l_n, g_n, t_n, m_n) = rows[True], rows[False]
    loss_err = abs(l_r - l_n) / abs(l_n)
    g_worst = max(_leaf_err(a, b) for a, b in zip(cm.tree_leaves(g_r),
                                                  cm.tree_leaves(g_n)))
    same = l_r == l_n and all(torch.equal(a, b) for a, b in zip(
        cm.tree_leaves(g_r), cm.tree_leaves(g_n)))
    log(f"# modes (a) remat: loss {l_r:.7f} / {l_n:.7f} without (rel "
        f"{loss_err:.2e}), worst gradient leaf {g_worst:.2e}, bit-identical:"
        f" {same}; forward+backward {t_r * 1e3:.1f} ms with remat, "
        f"{t_n * 1e3:.1f} ms without; activation peak above the state "
        f"{m_r:.3f} GB with, {m_n:.3f} GB without; {smi}")
    if not (loss_err < TOL_TRAIN_LOSS and g_worst < TOL_TRAIN_GRAD):
        fail(f"phase 19 (a): remat vs not: loss {loss_err:.3e}, gradient "
             f"{g_worst:.3e}")
    del params, state, g_n, rows

    # (b) flexrank mode on the uniform table, from phase 5's factors
    params = fresh(trained.params)
    params, state, launches_b, _, _ = _steps(
        "(b) flexrank", SP.make_train_step(cfg, opt_cfg, mode="flexrank"),
        params, adamw.init(params), batch_at, key_at, lowrank)
    del params, state

    # (c) flexrank_kd with Muon, its optimizer step timed on the card
    mcfg = muon.MuonConfig(lr=1e-2, adamw=opt_cfg)
    loss_c = FR.make_consolidation_loss(cfg, trained.infos,
                                        FR.table_host(trained.table), dense)
    apply_ms = []

    def muon_step(params, state, batch, key):
        loss, m = loss_c(params, batch, key)
        loss.backward()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        params, state, _ = muon.apply_updates(params, SP.grads_of(params),
                                              state, mcfg)
        e1.record()
        SP.clear_grads(params)
        apply_ms.append((e0, e1))
        return params, state, m
    params = fresh(trained.params)
    params, state, launches_c, ms_c, _ = _steps(
        "(c) flexrank_kd muon", muon_step, params, muon.init(params, mcfg),
        batch_at, key_at, lowrank)
    torch.cuda.synchronize()
    apply = statistics.median(a.elapsed_time(b) for a, b in apply_ms[1:])
    emb = state.momentum["embed"]
    ns_ms = device_ms([lambda: muon.newton_schulz(emb)], reps=5)
    log(f"# modes (c) muon: apply_updates {apply:.2f} ms of a {ms_c:.2f} "
        f"ms step ({100 * apply / ms_c:.1f}%), newton_schulz on the "
        f"embedding {tuple(emb.shape)} {ns_ms:.2f} ms; {smi}")
    del params, state
    if min(launches_b, launches_c) <= 0:
        fail(f"phase 19: lowrank_matmul launches (b) {launches_b}, (c) "
             f"{launches_c}")
    gc.collect()
    torch.cuda.empty_cache()

    _cross_modes(cfg, trained, dense, dev, smi)
    _powersgd_check(g_r, smi)
    del g_r
    gc.collect()
    torch.cuda.empty_cache()
    _preempt_check(smi)
    _nested_check(smi)
    return launches_b + launches_c


# ------------------------------------------------------------ drain

def drain_requests(cfg, rng, budgets):
    """Phase 13's DRAIN_REQUESTS requests: prompts of 96-128 tokens, the
    first two 128 long (each batch's longest, a multiple of rwkv6's
    64-step chunk), DRAIN_NEW new tokens, cycling over ``budgets``, greedy
    and temperature 0.8 / top-k 40 mixed within each budget's batch."""
    from repro_torch.serving import Request, SamplingParams
    reqs = []
    for i in range(DRAIN_REQUESTS):
        plen = 128 if i < 2 else int(rng.integers(96, 129))
        samp = (SamplingParams(temperature=0.8, top_k=40, seed=200 + i)
                if i % 4 >= 2 else None)
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=DRAIN_NEW, budget=budgets[i % len(budgets)],
            sampling=samp))
    return reqs


@contextlib.contextmanager
def sync_free_drain():
    """Run every ``prefill``, ``decode_step`` and drain draw of the engine
    under the sync debug mode "error": a host synchronisation inside one
    raises. The drain loop's own reads (the first token, the batch's end)
    lie outside them."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ElasticEngine
    saved = (tfm.prefill, tfm.decode_step, ElasticEngine._drain_sample)

    def checked(fn):
        def run(*args, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return run
    tfm.prefill, tfm.decode_step, ElasticEngine._drain_sample = map(
        checked, saved)
    try:
        yield
    finally:
        tfm.prefill, tfm.decode_step, ElasticEngine._drain_sample = saved


def drain_greedy(params, cfg, prompt, new_tokens, device):
    """Greedy decode of one prompt through ``prefill`` and
    ``decode_step`` (float32 state). Returns (tokens, per-step top-2 gap
    over the logits' max, the per-step logits (new_tokens, V) on the
    device)."""
    from repro_torch.models import transformer as tfm
    state = tfm.init_decode_state(cfg, 1, len(prompt) + new_tokens,
                                  dtype=torch.float32, device=device)
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, state = tfm.prefill(params, cfg, state, tok)
    rows, toks, gaps = [logits[0, -1]], [], []
    for t in range(new_tokens):
        top = torch.topk(rows[-1].float(), 2)
        toks.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1])
                    / float(rows[-1].abs().max()))
        if t < new_tokens - 1:
            nxt = torch.tensor([[toks[-1]]], dtype=torch.int32,
                               device=device)
            logits, state = tfm.decode_step(params, cfg, state, nxt)
            rows.append(logits[0, 0])
    return toks, gaps, torch.stack(rows)


def parted_at_near_tie(label, a, b, gaps_a) -> int:
    """Greedy streams ``a`` and ``b`` equal, or parting first where the
    ``a`` run's top-2 gap is within TOL_SPEC_TIE of its logits' max (the
    streams go their own ways after it). Returns the parting step, or -1;
    fails on any other parting."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            if not gaps_a[i] <= TOL_SPEC_TIE:
                fail(f"{label}: streams part at step {i} ({x} vs {y}) "
                     f"beyond a near tie (top-2 gap {gaps_a[i]:.3e})")
            log(f"# {label}: streams part at step {i} at a near tie "
                f"(top-2 gap {gaps_a[i]:.3e})")
            return i
    return -1


def drain_phase(label, cfg, res, small, dev, rng, report, smi):
    """Phase 13 (a)/(b) and the serving of phases 15-17: serve ``res`` (a
    training phase's consolidated factors, table and infos, or the serving
    launcher's state) at full width through ``ElasticEngine.generate``
    with ``mode="auto"``, which must route the recurrent, MLA, audio or
    vision family to drain; the GAR rows of the family's new shapes;
    the decode-vs-forward check on the card; one greedy request card vs
    CPU on the cut ``small``. Returns (launches by kernel, worst GAR
    error, the deployed rows: row -> params)."""
    from repro_torch.kernels import gar_matmul, sampling
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ElasticEngine
    if tfm.paged_compatible(cfg):
        fail(f"{label}: expected a family the paged path does not cover")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = cm.tree_map(lambda t: t.detach(), res.params)
    engine = ElasticEngine(cfg, params, res.table, res.infos, device=dev,
                           max_batch=8, max_len=256)
    budgets = DRAIN_BUDGETS
    rows = [engine._budget_row(b) for b in budgets]
    with torch.no_grad():
        deployed = {r: engine._realize(r) for r in rows}
    log(f"# drain {label}: deploy "
        + ", ".join(f"row {r} (budget {b}) {engine.deploy_seconds[r]:.2f} s"
                    for b, r in zip(budgets, rows)))
    reqs = drain_requests(cfg, rng, budgets)
    for k in (gar_matmul, sampling):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_free_drain():
        results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"gar_matmul": gar_matmul.launches,
              "topk_mask_sample": sampling.launches}
    s = engine.last_metrics.summary()
    if s["mixed_iterations"] or not s["decode_steps"]:
        fail(f"{label}: generate(mode='auto') did not serve through drain")
    longest = {}
    for rq in reqs:
        row = engine._budget_row(rq.budget)
        longest[row] = max(longest.get(row, 0), len(rq.prompt))
    for i, (rq, rs) in enumerate(zip(reqs, results)):
        n, pad = len(rq.prompt), longest[rs.budget_row]
        if len(rs.tokens) != n + DRAIN_NEW:
            fail(f"{label}: request {i} of {n} tokens returned "
                 f"{len(rs.tokens)}")
        if rs.tokens[n:pad].any():
            fail(f"{label}: request {i}'s stream lacks its padding")
        gen = rs.tokens[pad:]
        if gen.size and (gen.min() < 0 or gen.max() >= cfg.vocab_size):
            fail(f"{label}: generated token out of the vocabulary")
    if min(counts.values()) <= 0:
        fail(f"{label}: a kernel of the drain path never launched: {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # ms per decode step at the engine's batch of the first row
    batch = [rq for rq in reqs if rq.budget == budgets[0]]
    padded = np.zeros((len(batch), longest[rows[0]]), np.int32)
    for i, rq in enumerate(batch):
        padded[i, :len(rq.prompt)] = rq.prompt
    step_ms = []
    with torch.no_grad():
        state = tfm.init_decode_state(cfg, len(batch), 256,
                                      dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, state = tfm.prefill(deployed[rows[0]], cfg, state,
                                    torch.as_tensor(padded, device=dev))
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        for _ in range(DRAIN_NEW - 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, state = tfm.decode_step(deployed[rows[0]], cfg, state,
                                            tok)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
        # the card's own time for a step: its kernels' busy time under
        # torch.profiler (a step queues some thousand launches, more than
        # the launch queue holds, so events behind a device sleep would
        # time the host's enqueue instead)
        prof = profiled_kernel_ms(
            lambda: tfm.decode_step(deployed[rows[0]], cfg, state, tok), 4)
    step_host = statistics.median(step_ms)
    step_kernels = prof if isinstance(prof, str) else (
        f"{prof['busy_ms']:.3f} ms of kernel busy time (kernel sum "
        f"{prof['sum_ms']:.3f} ms; profile {prof['tries']} of "
        f"{PROFILE_TRIES}) in {prof['launches']:.0f} launches (busy "
        f"{100 * prof['busy_ms'] / step_host:.1f}%; most: "
        + ", ".join(f"{k[:40]} {us / 4e3:.3f} ms"
                    for us, _, k in prof["rows"][:3]) + ")")
    log(f"# drain {label}: {len(reqs)} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)}, {DRAIN_NEW} new each, budgets "
        f"{'/'.join(map(str, budgets))} -> rows {rows}, half greedy), wall "
        f"{wall:.2f} s: "
        f"{s['tokens_per_s']:.1f} tok/s, ttft mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms, {s['decode_steps']:.0f} decode "
        f"steps; prefill at B={len(batch)} x {padded.shape[1]} "
        f"{prefill_ms:.2f} ms; decode_step at B={len(batch)} median "
        f"{step_host:.2f} ms on the host's clock, {step_kernels}; peak "
        f"device memory {peak:.2f} GB; {smi}")
    log(f"# drain {label}: launches {json.dumps(counts)}; every prefill, "
        "decode step and draw queued under the sync debug mode \"error\"")

    # GAR at the family's new shapes, from the deployed row 0: (label,
    # leaf path, index of the leaf's first layer, token counts)
    gar_shapes = []
    with torch.no_grad():
        tree = engine._realize(0)
    picks = {"rwkv": [("rwkv6 channel/k", "segments/0/channel/k", (0,),
                       (1024,))],
             "zamba_unit": [("zamba2 in_proj",
                             "segments/0/mambas/mamba/in_proj", (0, 0),
                             (8, 1024))],
             # MLA (minicpm3): a decode batch of 4 and a 4 x 128 prefill
             "attn": [("minicpm3 attn/q_up", "segments/0/attn/q_up", (0,),
                       (8, 512)),
                      ("minicpm3 mlp/gate", "segments/0/mlp/gate", (0,),
                       (8, 512))],
             # the drain batches (decode and prefill) of the audio and
             # vision families, then the multimodal check's: 4 x 1024
             # audio frames through the encoder, frontend_proj and the
             # cross K/V; 4 x 1601 image patches through frontend_proj and
             # the cross K/V
             "encoder": [("seamless decoder mlp/gate",
                          "segments/1/mlp/gate", (0,), (8, 512)),
                         ("seamless frontend_proj", "frontend_proj", (),
                          (4096,)),
                         ("seamless encoder attn/q", "segments/0/attn/q",
                          (0,), (4096,)),
                         ("seamless encoder mlp/gate", "segments/0/mlp/gate",
                          (0,), (4096,)),
                         ("seamless cross attn/k",
                          "segments/1/cross/attn/k", (0,), (4096,))],
             "vision_unit": [("vision selfs mlp/gate",
                              "segments/0/selfs/mlp/gate", (0, 0),
                              (8, 512)),
                             ("vision frontend_proj", "frontend_proj", (),
                              (6404,)),
                             ("vision cross attn/k",
                              "segments/0/cross/attn/k", (0,), (6404,))]}
    for what, path, at, ts in picks[cfg.segments[0].kind]:
        leaf = cm.tree_get(tree, path)
        vt, uh, pi = (leaf[k][at] for k in ("v_tilde", "u_hat", "perm_inv"))
        n, r = vt.shape
        for t in ts:
            gar_shapes.append((f"{what} row 0 T={t} n={n} r={r} "
                               f"m={r + uh.shape[0]}", t, vt, uh, pi))
    first = len(report)
    gar_err = check_gar(dev, gar_shapes, rng, report)
    for e in report[first:]:
        log(kernel_line(e))

    # decode vs forward on the card: the first request (greedy, 128
    # tokens) at row 0
    prompt = reqs[0].prompt
    with torch.no_grad():
        toks, gaps, dec = drain_greedy(deployed[rows[0]], cfg, prompt,
                                       DRAIN_NEW, dev)
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              dtype=torch.int32, device=dev)[None]
        full, _ = tfm.forward(deployed[rows[0]], cfg, seq)
    full = full[0, len(prompt) - 1:]
    rel = float((dec - full).abs().max()) / float(full.abs().max())
    agree = bool(torch.equal(torch.argmax(full, -1),
                             torch.as_tensor(toks, device=dev)))
    log(f"# drain {label}: prefill {len(prompt)} + {DRAIN_NEW - 1} decode "
        f"steps vs forward of the {seq.shape[1]} tokens: logits worst rel "
        f"{rel:.2e} (tolerance {TOL_DRAIN_FORWARD}), greedy choices "
        f"{'identical' if agree else 'differ'}")
    if not (rel <= TOL_DRAIN_FORWARD and bool(torch.isfinite(dec).all())):
        fail(f"{label}: decode vs forward logits rel {rel:.3e}")

    # one greedy request card vs CPU on the cut
    p_small = cut_depth(deployed[rows[0]], cfg, small)
    with torch.no_grad():
        t_gpu, g_gpu, l_gpu = drain_greedy(p_small, small, prompt, 8, dev)
        t0 = time.perf_counter()
        t_cpu, _, l_cpu = drain_greedy(cm.tree_map(lambda t: t.cpu(),
                                                   p_small),
                                       small, prompt, 8, torch.device("cpu"))
        secs = time.perf_counter() - t0
    cut = ", ".join(f"{g.kind} x{g.count}" + (
        f" ({g.mamba_per_unit} Mamba2)" if g.kind == "zamba_unit" else "")
        for g in small.segments)
    log(f"# drain {label}: card vs CPU on the cut [{cut}], "
        f"{len(prompt)}-token prompt, 8 greedy tokens: card {t_gpu}, CPU "
        f"{t_cpu} ({secs:.1f} s on the CPU)")
    part = parted_at_near_tie(f"drain {label} card vs CPU", t_gpu, t_cpu,
                              g_gpu)
    # the logits of the steps fed the same tokens on both sides
    same = part + 1 if part >= 0 else len(t_gpu)
    l_cpu = l_cpu[:same]
    rel = float((l_gpu[:same].cpu() - l_cpu).abs().max()) / float(
        l_cpu.abs().max())
    log(f"# drain {label}: card vs CPU logits over {same} steps: worst rel "
        f"{rel:.2e} (tolerance {TOL_DRAIN_FORWARD})")
    if not rel <= TOL_DRAIN_FORWARD:
        fail(f"{label}: card vs CPU logits rel {rel:.3e}")
    log(f"# drain {label}: {time.perf_counter() - t_phase:.1f} s in all")
    del engine, params
    return counts, gar_err, deployed


def drain_gpt2(engine, reqs, phase3, dev):
    """Phase 13 (c): each of phase 3's requests alone through the drain
    batch (its submission index keys its draws, as in phase 3) against
    its phase-3 stream, then all 8 through ``generate(mode="drain")``:
    each batch's longest prompt against its solo run. Equal, or parting
    at a near tie only. Returns launches by kernel."""
    from repro_torch.kernels import gar_matmul, sampling
    t_phase = time.perf_counter()
    for k in (gar_matmul, sampling):
        k.launches = 0
    with torch.no_grad():
        solo = [engine._serve_batch(engine._realize(r.budget_row),
                                    r.budget_row, [rq], [i])[0]
                for i, (rq, r) in enumerate(zip(reqs, phase3))]
    ties = spec_divergences("drain gpt2 solo vs phase 3", engine, reqs,
                            phase3, solo, dev, 256)
    with sync_free_drain():
        together = engine.generate(reqs, mode="drain")
    longest = {}
    for i, rq in enumerate(reqs):
        j = longest.get(phase3[i].budget_row)
        if j is None or len(rq.prompt) > len(reqs[j].prompt):
            longest[phase3[i].budget_row] = i
    idx = sorted(longest.values())
    ties += spec_divergences(
        "drain gpt2 batched vs solo", engine, [reqs[i] for i in idx],
        [solo[i] for i in idx], [together[i] for i in idx], dev, 256,
        req_ids=idx)
    counts = {"gar_matmul": gar_matmul.launches,
              "topk_mask_sample": sampling.launches}
    log(f"# drain gpt2: 8 solo runs against phase 3's streams, then the 8 "
        f"batched by row (longest of each: requests {idx}); near-tie "
        f"partings {ties}; launches {json.dumps(counts)}; "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return counts


# ------------------------------------------------------------ MoE and MLA

@contextlib.contextmanager
def routing_record(calls: list):
    """Record, for every ``moe_apply`` call, each token's expert set (its
    top-k ids in ascending order, (tokens, k)) and its own gap between
    its k-th and (k+1)-th router probabilities (tokens,), as host arrays
    (a host read: outside the sync-checked paths only)."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route

    def recorded(probs, k):
        out = route(probs, k)
        srt = torch.sort(probs.double(), dim=-1, descending=True).values
        gap = (srt[..., k - 1] - srt[..., k] if probs.shape[-1] > k
               else torch.full_like(srt[..., 0], math.inf))
        calls.append((torch.sort(out[1], dim=-1).values.reshape(-1, k)
                      .cpu().numpy(), gap.reshape(-1).cpu().numpy()))
        return out
    moe_mod.route = recorded
    try:
        yield
    finally:
        moe_mod.route = route


def moe_apply_split(p, cfg, dev, ts) -> list:
    """Device ms of one ``moe_apply`` call on a flat batch of T tokens, and
    of its three expert products alone at the same capacity (the rest:
    router, dispatch, SwiGLU, combine and the shared experts). Returns
    (T, capacity, call ms, products ms) per T."""
    from repro_torch.models import moe as moe_mod
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(14)
    out = []
    with torch.no_grad():
        for t in ts:
            cap = moe_mod.capacity(cfg, t)
            x = torch.randn((1, t, cfg.d_model), generator=gen, device=dev)
            ex = torch.randn((1, m.num_experts, cap, cfg.d_model),
                             generator=gen, device=dev)
            hid = torch.randn((1, m.num_experts, cap, m.d_ff_expert),
                              generator=gen, device=dev)
            exp = p["experts"]
            call = device_ms([lambda: moe_mod.moe_apply(p, x, cfg)])
            prods = device_ms([lambda: (
                moe_mod.expert_linear(exp["gate"], ex),
                moe_mod.expert_linear(exp["up"], ex),
                moe_mod.expert_linear(exp["down"], hid))])
            out.append((t, cap, call, prods))
    return out


@contextlib.contextmanager
def annotated_expert_products():
    """Run every ``expert_linear`` call inside a ``torch.profiler``
    annotation named "expert_products", so that a profile can sum the
    device time of the kernels it launches."""
    from repro_torch.models import moe as moe_mod
    linear = moe_mod.expert_linear

    def annotated(*args, **kw):
        with torch.profiler.record_function("expert_products"):
            return linear(*args, **kw)
    moe_mod.expert_linear = annotated
    try:
        yield
    finally:
        moe_mod.expert_linear = linear


def decode_iteration(params, cfg, prompts, dev, steps: int = 8):
    """The engine's decode iteration: fill a ``PagedKVCache`` with
    ``prompts`` (``fill_slots``), then ``steps`` iterations of one token a
    slot (``mixed_one_each``) on the host's clock, and 4 more under
    ``torch.profiler``. Returns (median host ms an iteration; from the
    profile, an iteration's kernel ms, its launches, and the ms of the
    kernels the expert products launched; the kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.kv_cache import PagedKVCache
    cache = PagedKVCache(cfg, max_batch=len(prompts), max_len=256,
                         block_size=16, prefix_cache=False, device=dev)
    with torch.no_grad():
        tok = fill_slots(params, cfg, [cache], prompts, dev)

        def step(tok):
            for slot in range(len(prompts)):
                cache.append_token(slot)
            return torch.argmax(mixed_one_each(params, cfg, cache, tok),
                                -1).to(torch.int32)
        host = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = step(tok)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with annotated_expert_products(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                tok = step(tok)
                torch.cuda.synchronize()
    krows = kernel_rows(prof)
    prods_us = sum(ev.device_time_total for ev in prof.events()
                   if ev.name == "expert_products"
                   and ev.device_type == DeviceType.CPU)
    return (statistics.median(host), sum(r[0] for r in krows) / 4e3,
            sum(r[1] for r in krows) / 4, prods_us / 4e3, krows)


def moe_cross_check(label, cfg, toks_gpu, toks_cpu, marg_cpu, calls_gpu,
                    calls_cpu, l_gpu, l_cpu) -> None:
    """The MoE phases' card vs CPU greedy request (``cfg`` the cut it ran
    on): at each step up to the first where the streams part (the feeds
    are equal until then), every token whose expert set differs card vs
    CPU must be a routing near tie on the CPU (its own k-th and (k+1)-th
    router probabilities within TOL_ROUTE); every near tie is logged,
    whether the expert sets differ or not. While no token's routing has
    differed, the step's logits agree within TOL_MOE_CROSS of their max.
    A parting is allowed only at a near tie of the logits (TOL_SPEC_TIE),
    or at or after a step where a token's experts differed. Fails
    otherwise."""
    n_moe = sum(s.count for s in cfg.segments if s.kind == "attn")
    steps = len(toks_cpu)
    for side, calls in (("card", calls_gpu), ("CPU", calls_cpu)):
        if len(calls) != steps * n_moe:
            fail(f"{label} cross-check: {len(calls)} routings recorded on "
                 f"the {side}, expected {steps * n_moe}")
    part = next((i for i, (a, b) in enumerate(zip(toks_gpu, toks_cpu))
                 if a != b), steps)
    routed_apart, worst = None, 0.0
    for i in range(min(part + 1, steps)):
        for j in range(i * n_moe, (i + 1) * n_moe):
            (e_g, _), (e_c, gap_c) = calls_gpu[j], calls_cpu[j]
            differs = (e_g != e_c).any(-1)
            for t in np.nonzero(~differs & (gap_c <= TOL_ROUTE))[0]:
                log(f"# {label} routing near tie: step {i}, MoE layer "
                    f"{j - i * n_moe}, token {t}: its k-th and (k+1)-th "
                    f"router probabilities {gap_c[t]:.3e} apart on the "
                    "CPU, the same experts on both")
            for t in np.nonzero(differs)[0]:
                what = (f"step {i}, MoE layer {j - i * n_moe}, token {t}: "
                        f"experts {e_g[t].tolist()} on the card, "
                        f"{e_c[t].tolist()} on the CPU, its k-th and "
                        f"(k+1)-th router probabilities {gap_c[t]:.3e} "
                        "apart on the CPU")
                if not gap_c[t] <= TOL_ROUTE:
                    fail(f"{label} card vs CPU: routing differs beyond a "
                         f"near tie ({what})")
                log(f"# {label} routing near tie: {what}")
                if routed_apart is None:
                    routed_apart = i
        if routed_apart is None:
            rel = float((l_gpu[i] - l_cpu[i]).abs().max()) / float(
                l_cpu[i].abs().max())
            worst = max(worst, rel)
            if not (rel <= TOL_MOE_CROSS
                    and bool(torch.isfinite(l_gpu[i]).all())):
                fail(f"{label} card vs CPU: step {i} logits rel {rel:.3e} "
                     f"(tolerance {TOL_MOE_CROSS})")
    n_cmp = min(part + 1, steps) if routed_apart is None else routed_apart
    log(f"# {label} card vs CPU logits: worst rel {worst:.2e} over "
        f"{n_cmp} steps (tolerance {TOL_MOE_CROSS}; compared up to the "
        f"first routing near tie: "
        f"{'none' if routed_apart is None else f'step {routed_apart}'})")
    if part < steps:
        what = (f"top-2 gap {marg_cpu[part]:.3e} of the logits' max, first "
                f"routing near tie at step {routed_apart}")
        if not (marg_cpu[part] <= TOL_SPEC_TIE
                or (routed_apart is not None and routed_apart <= part)):
            fail(f"{label}: card and CPU part at step {part} beyond a near "
                 f"tie ({what})")
        log(f"# {label} card vs CPU: part at step {part} at a near tie "
            f"({what})")


def nodrop_capacity(cfg):
    """``cfg`` with ``capacity_factor = num_experts * ceil(4 / top_k)``:
    no pair is dropped, and a batch of T one-token rows (the decode step)
    gets T times one row's slots (the floor of 4 slots a row, ``models/
    moe.py:capacity``, included), so ``paged_decode_step`` and
    ``paged_mixed_step`` run their expert products at the same shapes.
    At ``num_experts`` alone a top-1 model's decode row keeps the floor's
    4 slots against the mixed step's 1 a token, and the two steps' batched
    products (M 32 against 8 at 8 slots) round apart."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=float(m.num_experts * math.ceil(4 / m.top_k))))


@dataclasses.dataclass(frozen=True)
class MoECut:
    """What an MoE phase serves: ``arch`` at full width cut to
    ``segments``; the requests' budgets (cycled over phase 3's requests;
    each budget's row deployed); the (segment, projection) leaves whose
    GAR is held and timed; the segment whose MoE FFN ``moe_apply_split``
    times; and the seconds predicted before its first call to the card."""
    arch: str
    label: str
    segments: tuple
    budgets: tuple
    gar_leaves: tuple
    moe_segment: int
    predicted_s: float


def moe_phase(cut: MoECut, dev, rng, report, smi, base_reqs):
    """Phases 14 and 20: an MoE config at full width cut in depth
    (``cut``): the serving launcher's state, GAR at its new shapes,
    ``base_reqs`` (phase 3's prompts and sampling, at ``cut.budgets``)
    served through the continuous engine, then with lookahead under the
    sync debug mode "error" (identical streams), one ``moe_apply`` call's
    time split, the decode iteration's host and kernel time, the decode
    check at ``capacity_factor = num_experts``, and one greedy request
    card vs CPU on the same cut. Returns (launches by kernel, the GAR
    error)."""
    from repro_torch.configs import get_config
    from repro_torch.core import flexrank as FR
    from repro_torch.kernels import gar_matmul, paged_attention, sampling
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request, ElasticEngine
    label = cut.label
    log(f"# {label}: predicted {cut.predicted_s:.0f} s for this phase; "
        f"{smi}")
    t_phase = time.perf_counter()
    full = get_config(cut.arch)
    cfg = dataclasses.replace(full, segments=cut.segments,
                              num_layers=_layer_count(cut.segments))
    depth = f"{cfg.num_layers} of {full.num_layers} layers"
    for c in (full, cfg):
        n = cm.param_count(tfm.model_spec(c))
        nf = cm.param_count(FR.factorized_spec(c))
        log(f"# {label}: {c.num_layers} layers: {n / 1e9:.3f} B dense "
            f"parameters, {4 * n / 1e9:.1f} GB in float32; {nf / 1e9:.3f} B "
            f"factorized, {4 * nf / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, 0, timings=setup)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    peak_state = torch.cuda.max_memory_allocated() / 1e9
    engine = ElasticEngine(cfg, params_fact, table, infos, device=dev,
                           prefill_chunk=64, max_batch=8, max_len=256)
    budgets = cut.budgets
    rows = list(dict.fromkeys(engine._budget_row(b) for b in budgets))
    deployed = {r: engine._realize(r) for r in rows}
    n_exp = sum(int(np.prod(i.lead_dims)) for i in infos
                if "/experts/" in i.path)
    log(f"# {label} setup: dense init {t_init:.2f} s, calibrate "
        f"{setup['calibrate']:.2f} s, decompose {setup['decompose']:.2f} s "
        f"(DataSVD, {len(infos)} groups, {n_exp} expert projections, one "
        f"whitening a layer's moment), DP {setup['dp']:.2f} s "
        f"({table.table.shape[0]} rows), deploy "
        + ", ".join(f"row {r} {engine.deploy_seconds[r]:.2f} s"
                    for r in rows)
        + f"; peak device memory {peak_state:.2f} GB building the state; "
        f"{smi}")
    log(f"# {label} table: ranks by group {[i.path for i in infos]}: "
        + "; ".join(f"row {k} {table.table[k].tolist()}"
                    for k in range(table.table.shape[0])))

    # GAR at the new shapes, row 0, at a decode batch and a mixed
    # iteration
    shapes = []
    for seg, proj in cut.gar_leaves:
        leaf = cm.tree_get(deployed[rows[0]]["segments"][seg], proj)
        vt, uh, pi = (leaf["v_tilde"][0], leaf["u_hat"][0],
                      leaf["perm_inv"][0])
        n, r = vt.shape
        for t in (8, 72):
            shapes.append((f"{label} {proj} row {rows[0]} T={t} n={n} "
                           f"r={r} m={r + uh.shape[0]}", t, vt, uh, pi))
    first = len(report)
    gar_err = check_gar(dev, shapes, rng, report)
    for e in report[first:]:
        log(f"{kernel_line(e)}; {smi}")

    reqs = [Request(prompt=rq.prompt, max_new_tokens=32,
                    budget=budgets[i % len(budgets)], sampling=rq.sampling)
            for i, rq in enumerate(base_reqs)]
    for k in (gar_matmul, paged_attention, sampling):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, wall, s = serve_timed(engine, reqs)
    counts = {"gar_matmul": gar_matmul.launches,
              "paged_prefill_attention": paged_attention.launches,
              "topk_mask_sample": sampling.launches}
    for rq, rs in zip(reqs, results):
        if len(rs.tokens) != len(rq.prompt) + 32:
            fail(f"{label}: request of {len(rq.prompt)} tokens returned "
                 f"{len(rs.tokens)}")
        gen = rs.tokens[len(rq.prompt):]
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail(f"{label}: generated token out of the vocabulary")
    log(f"# {label} serving: full width, {depth}, 8 requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)}, 32 new each, budgets "
        f"{'/'.join(map(str, budgets))} -> rows {rows}, half top-k 40), "
        f"wall {wall:.2f} s, {s['tokens_per_s']:.1f} tok/s, ttft mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms, {s['mixed_iterations']:.0f} mixed "
        f"iterations, dispatch {s['dispatch_ms_mean']:.2f} ms / host "
        f"{s['host_ms_mean']:.2f} ms per iteration, preemptions "
        f"{s['preemptions']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{json.dumps(counts)}; {smi}")
    if min(counts.values()) <= 0:
        fail(f"{label}: a kernel of the serving path never launched: "
             f"{counts}")

    # the same requests with lookahead: the same batches give the same
    # capacities, so the streams are the synchronous run's
    engine.lookahead = True
    try:
        with sync_free_lookahead():
            look, _, s_look = serve_timed(engine, reqs)
    finally:
        engine.lookahead = False
    for i, (a, b) in enumerate(zip(results, look)):
        if not np.array_equal(a.tokens, b.tokens):
            fail(f"{label} lookahead: request {i} differs from the "
                 "synchronous run")
    log(f"# {label} lookahead: {s_look['tokens_per_s']:.1f} tok/s "
        f"(sync {s['tokens_per_s']:.1f}), ttft mean "
        f"{s_look['ttft_mean_s'] * 1e3:.1f} ms, "
        f"{s_look['lookahead_iterations']:.0f} lookahead iterations, "
        f"{s_look['rollbacks']:.0f} rollbacks, overlap share "
        f"{s_look['overlap_fraction']:.4f}; streams identical, no host sync "
        f"in any planned, dispatched and advanced iteration; {smi}")

    # one moe_apply call split, at a decode batch (T 8) and a mixed
    # iteration (T 72), and the decode iteration it sits in
    moe_p = cm.tree_map(
        lambda a: a[0], deployed[rows[0]]["segments"][cut.moe_segment]["mlp"])
    split = moe_apply_split(moe_p, cfg, dev, (8, 72))
    prng = np.random.default_rng(14)
    prompts = [prng.integers(0, cfg.vocab_size, int(prng.integers(90, 160))
                             ).astype(np.int32) for _ in range(8)]
    host_ms, kern_ms, launches, prods_ms, krows = decode_iteration(
        deployed[rows[0]], cfg, prompts, dev)
    n_moe = sum(sg.count for sg in cut.segments if sg.kind == "attn")
    for t, cap, call, prods in split:
        log(f"# {label} moe_apply: row {rows[0]}, T={t} (capacity {cap} an "
            f"expert): {call:.4f} ms a call, expert products {prods:.4f} ms "
            f"({100 * prods / call:.1f}%), the rest {call - prods:.4f} ms; "
            f"{smi}")
    log(f"# {label} decode iteration: row {rows[0]}, 8 slots one token each "
        f"through paged_mixed_step: {host_ms:.2f} ms on the host's clock, "
        f"{kern_ms:.3f} ms of kernels in {launches:.0f} launches (busy "
        f"{100 * kern_ms / host_ms:.1f}%; most: "
        + ", ".join(f"{k[:40]} {us / 4e3:.3f} ms" for us, _, k in krows[:3])
        + f"); the kernels of the expert products of its {n_moe} MoE "
        f"layers in the same profile {prods_ms:.3f} ms = "
        f"{100 * prods_ms / kern_ms:.1f}% of its kernel time; {smi}")

    # the decode check without drops, at the same expert-product shapes in
    # both steps (``nodrop_capacity``)
    nodrop = nodrop_capacity(cfg)
    for k in (gar_matmul, paged_attention):
        k.launches = 0
    counts["paged_attention"], _, _, _ = decode_check(
        nodrop, deployed, prompts, 32, dev, 256, smi)
    counts["gar_matmul"] += gar_matmul.launches
    counts["paged_prefill_attention"] += paged_attention.launches

    # card vs CPU: one greedy request on the first row; a parting only at
    # a near tie of the logits or of a token's routing
    p_gpu = deployed[rows[0]]
    p_cpu = cm.tree_map(lambda t: t.cpu(), p_gpu)
    prompt = prng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    calls_gpu, calls_cpu, l_gpu, l_cpu = [], [], [], []
    with torch.no_grad():
        with routing_record(calls_gpu):
            toks_gpu, _ = greedy_loop(p_gpu, cfg, prompt, 8, dev, 160,
                                      logits_out=l_gpu)
        t0 = time.perf_counter()
        with routing_record(calls_cpu):
            toks_cpu, marg_cpu = greedy_loop(p_cpu, cfg, prompt, 8,
                                             torch.device("cpu"), 160,
                                             logits_out=l_cpu)
        t_cpu = time.perf_counter() - t0
    moe_cross_check(label, cfg, toks_gpu, toks_cpu, marg_cpu, calls_gpu,
                    calls_cpu, l_gpu, l_cpu)
    log(f"# {label} cross-check: row {rows[0]} at {depth}, {len(prompt)} "
        f"prompt tokens: card {toks_gpu}, CPU {toks_cpu} ({t_cpu:.1f} s on "
        f"the CPU); {smi}")
    log(f"# {label}: {time.perf_counter() - t_phase:.1f} s in all "
        f"(predicted {cut.predicted_s:.0f} s); {smi}")
    del engine, deployed, params_fact, p_gpu, p_cpu
    return counts, gar_err


def moe_cuts():
    """Phase 14's and phase 20's ``MoECut``."""
    from repro_torch.configs import Segment
    return (
        # the dense layer 0 and one MoE layer (64 experts, top-6 of 1408, 2
        # shared); the second MoE layer went when the smoke passed 1050 s
        MoECut("deepseek-moe-16b", "deepseek-moe",
               (Segment("attn_dense", 1), Segment("attn", 1)), (0.4, 1.0),
               ((0, "mlp/gate"), (1, "mlp/shared/gate")), 1, 75.0),
        # one MoE layer (16 experts, top-1 of 8192, one shared), GQA 40/8;
        # row 0 only: the top row repeats GAR at full rank, which gemma3's
        # row 6 already times
        MoECut("llama4-scout-17b-a16e", "llama4", (Segment("attn", 1),),
               (0.4,), ((0, "attn/q"), (0, "mlp/shared/gate")), 0, 190.0))


def mla_phase(dev, report, smi):
    """Phase 15: minicpm3-4b at full width cut to 8 of its 62 layers: the
    serving launcher's state, then ``drain_phase`` (``generate(mode=
    "auto")`` must route MLA to drain). Returns (launches by kernel, the
    GAR error)."""
    from types import SimpleNamespace
    from repro_torch.configs import Segment, get_config
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    full = get_config("minicpm3-4b")
    cfg = dataclasses.replace(full, segments=(Segment("attn", 8),),
                              num_layers=8)
    for c in (full, cfg):
        n = cm.param_count(tfm.model_spec(c))
        log(f"# minicpm3: {c.num_layers} layers: {n / 1e9:.3f} B dense "
            f"parameters, {4 * n / 1e9:.2f} GB in float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, 0, timings=setup)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    log(f"# minicpm3 setup: dense init {t_init:.2f} s, calibrate "
        f"{setup['calibrate']:.2f} s, decompose {setup['decompose']:.2f} s "
        f"(DataSVD, {len(infos)} groups x 8 layers), DP {setup['dp']:.2f} s "
        f"({table.table.shape[0]} rows); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB building the "
        "state")
    small = dataclasses.replace(cfg, segments=(Segment("attn", 2),),
                                num_layers=2)
    counts, gar_err = drain_phase(
        "minicpm3-4b", cfg, SimpleNamespace(params=params_fact, table=table,
                                            infos=infos),
        small, dev, np.random.default_rng(15), report, smi)[:2]
    log(f"# minicpm3: {time.perf_counter() - t_phase:.1f} s in all")
    return counts, gar_err


# ------------------------------------------------------ audio and vision

MM_BATCH, MM_PROMPT, MM_NEW = 4, 64, 16   # the multimodal check's shapes
# host-clock samples of each timed call; the decode states keep spare
# rows for them and for ``profiled_kernel_ms``'s calls (4 a profile)
MM_HOST_REPS = 8
MM_SPARE = MM_HOST_REPS + 4 * PROFILE_TRIES


@contextlib.contextmanager
def sync_error():
    """The sync debug mode "error" on the card: a host synchronisation
    inside raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def cross_sources(params, cfg, frontend):
    """(the per-step source of way (ii), the projected source that
    ``attach_cross_kv`` takes in way (iii)): audio the encoder's output
    for both; vision the raw patches, and ``frontend_proj`` of them."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    if cfg.family == "audio":
        enc = tfm.run_encoder(params, cfg, frontend)
        return enc, enc
    return frontend, cm.linear(params["frontend_proj"], frontend)


def multimodal_ways(params, cfg, prompt, frontend, dev):
    """``MM_NEW`` greedy tokens three ways: (i) ``forward(frontend=)``
    over the whole sequence (prompt and (ii)'s tokens), (ii) ``prefill``
    then ``decode_step`` with the source every step, (iii)
    ``attach_cross_kv`` once, then one token a step from the first prompt
    token. Every prefill, decode step and attach of (ii) and (iii) runs
    under the sync debug mode "error" on the card. Returns (tokens (ii),
    tokens (iii), logits (ii), (iii) and (i), each (B, MM_NEW, V), the
    states of (ii) and (iii) with room for ``MM_SPARE`` more steps, the
    sources)."""
    from repro_torch.models import transformer as tfm
    b, p = prompt.shape
    cuda = prompt.is_cuda
    guard = sync_error if cuda else contextlib.nullcontext
    room = p + MM_NEW + MM_SPARE

    def greedy(logits):
        return torch.argmax(logits, -1).to(torch.int32)[:, None]

    with guard():
        step_src, proj_src = cross_sources(params, cfg, frontend)
        st2 = tfm.init_decode_state(cfg, b, room, dtype=torch.float32,
                                    device=dev)
        logits, st2 = tfm.prefill(params, cfg, st2, prompt,
                                  kv_source=step_src)
        rows2, toks2 = [logits[:, -1]], [greedy(logits[:, -1])]
        for _ in range(MM_NEW - 1):
            logits, st2 = tfm.decode_step(params, cfg, st2, toks2[-1],
                                          kv_source=step_src)
            rows2.append(logits[:, 0])
            toks2.append(greedy(logits[:, 0]))
        st3 = tfm.init_decode_state(
            cfg, b, room, dtype=torch.float32, device=dev,
            cross_kv_len=proj_src.shape[1])
        st3 = tfm.attach_cross_kv(params, cfg, st3, proj_src)
        for i in range(p):
            logits, st3 = tfm.decode_step(params, cfg, st3,
                                          prompt[:, i:i + 1])
        rows3, toks3 = [logits[:, 0]], [greedy(logits[:, 0])]
        for _ in range(MM_NEW - 1):
            logits, st3 = tfm.decode_step(params, cfg, st3, toks3[-1])
            rows3.append(logits[:, 0])
            toks3.append(greedy(logits[:, 0]))
    toks2, toks3 = torch.cat(toks2, 1), torch.cat(toks3, 1)
    seq = torch.cat([prompt, toks2[:, :-1]], dim=1)
    full, _ = tfm.forward(params, cfg, seq, frontend=frontend)
    return (toks2, toks3, torch.stack(rows2, 1), torch.stack(rows3, 1),
            full[:, p - 1:], st2, st3, step_src, proj_src)


def _rel_to(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


def multimodal_check(label, cfg, deployed, small, dev, rng, smi):
    """The multimodal check of phases 16-17 at each row of ``deployed``
    (row 0 since the drain phases' top row was cut): ``multimodal_ways``
    on a batch of ``MM_BATCH`` prompts of ``MM_PROMPT`` tokens with the
    frontend drawn from ``rng`` (audio
    frames (B, 1024, 1024), vision patches (B, 1601, 7680)): the streams
    of (ii) and (iii) identical, their logits within TOL_DECODE of each
    other, both within TOL_DRAIN_FORWARD of (i); then the frontend stage,
    ``attach_cross_kv`` and a decode step of (ii) and of (iii) timed (host
    clock; CUDA events or ``profiled_kernel_ms``); then the same check
    card vs CPU on row 0 cut to ``small``, on the first request. Returns
    the ``gar_matmul`` launches of the three ways on the card."""
    from repro_torch.kernels import gar_matmul
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    frames = 1024 if cfg.family == "audio" else cfg.cross_attn_kv_len
    prompt_np = rng.integers(0, cfg.vocab_size,
                             (MM_BATCH, MM_PROMPT)).astype(np.int32)
    front_np = rng.standard_normal(
        (MM_BATCH, frames, cfg.frontend_dim)).astype(np.float32)
    prompt = torch.as_tensor(prompt_np, device=dev)
    frontend = torch.as_tensor(front_np, device=dev)
    launches = 0
    rows = sorted(deployed)
    stage = "run_encoder" if cfg.family == "audio" else "frontend_proj"
    for row in rows:
        params = deployed[row]
        gar_matmul.launches = 0
        with torch.no_grad():
            t2, t3, l2, l3, l1, st2, st3, step_src, proj_src = \
                multimodal_ways(params, cfg, prompt, frontend, dev)
        torch.cuda.synchronize()
        launches += gar_matmul.launches
        same = torch.equal(t2, t3)
        if not same:
            k = int((t2 != t3).any(0).nonzero()[0])
            top = torch.topk(l2[:, k].float(), 2, dim=-1).values
            gap = float((top[:, 0] - top[:, 1]).min()) / float(
                l2[:, k].abs().max())
            fail(f"{label} multimodal row {row}: streams (ii) and (iii) "
                 f"part at step {k} (smallest top-2 gap {gap:.3e})")
        r23, r21, r31 = _rel_to(l3, l2), _rel_to(l2, l1), _rel_to(l3, l1)
        bits = torch.equal(l2, l3)
        log(f"# {label} multimodal row {row}: B={MM_BATCH}, "
            f"{MM_PROMPT}-token prompts, {MM_NEW} greedy tokens, frontend "
            f"{tuple(front_np.shape)}: streams (ii) and (iii) identical; "
            f"logits (iii) vs (ii) rel {r23:.2e} (tolerance {TOL_DECODE}; "
            f"{'bit-identical' if bits else 'not bit-identical'}), (ii) vs "
            f"forward (i) {r21:.2e}, (iii) vs (i) {r31:.2e} (tolerance "
            f"{TOL_DRAIN_FORWARD}); gar_matmul launches "
            f"{gar_matmul.launches}; every prefill, decode step and attach "
            "queued under the sync debug mode \"error\"")
        if not (r23 <= TOL_DECODE and r21 <= TOL_DRAIN_FORWARD
                and r31 <= TOL_DRAIN_FORWARD
                and bool(torch.isfinite(l2).all())):
            fail(f"{label} multimodal row {row}: logits (iii)/(ii) {r23:.3e},"
                 f" (ii)/(i) {r21:.3e}, (iii)/(i) {r31:.3e}")

        # time the frontend stage, the attach and a decode step each way
        def host_ms(fns, n):
            """Host ms of each of ``fns``, ``n`` calls each, in turns (a b,
            b a, ...) so that the host's drift falls on all: (median,
            least, most) of each."""
            out = [[] for _ in fns]
            for rep in range(n):
                for i in (range(len(fns)) if rep % 2 == 0
                          else reversed(range(len(fns)))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fns[i]()
                    torch.cuda.synchronize()
                    out[i].append((time.perf_counter() - t0) * 1e3)
            return [(statistics.median(o), min(o), max(o)) for o in out]

        def event_ms(fn, n=3):
            """Device ms a call by CUDA events around ``n`` calls: the
            card's time where the call is device-bound."""
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(n):
                fn()
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / n

        tok = t2[:, -1:].contiguous()
        with torch.no_grad():
            stage_fn = (lambda: tfm.run_encoder(params, cfg, frontend)) \
                if cfg.family == "audio" else \
                (lambda: cm.linear(params["frontend_proj"], frontend))
            attach_fn = lambda: tfm.attach_cross_kv(params, cfg, st3,
                                                    proj_src)
            states = {"(ii)": [st2], "(iii)": [st3]}

            def step(way):
                # each call takes the next of the state's spare rows
                src = step_src if way == "(ii)" else None
                states[way][0] = tfm.decode_step(
                    params, cfg, states[way][0], tok, kv_source=src)[1]
            fns = {stage: stage_fn, "attach_cross_kv": attach_fn,
                   "decode step (ii)": lambda: step("(ii)"),
                   "decode step (iii)": lambda: step("(iii)")}
            host = dict(zip(fns, host_ms(list(fns.values()), MM_HOST_REPS)))
            # the frontend stage and the attach are device-bound: CUDA
            # events time them; a decode step is host-bound: its kernels'
            # busy time comes from the profiler, where its readings pass
            # ``profiled_kernel_ms``'s checks
            dev_t = {k: event_ms(fns[k]) for k in (stage, "attach_cross_kv")}
            prof = {k: profiled_kernel_ms(fns[k], 4)
                    for k in ("decode step (ii)", "decode step (iii)")}

        def timed(k):
            h = host[k]
            out = (f"{k} {h[0]:.2f} ms on the host's clock ({h[1]:.2f}-"
                   f"{h[2]:.2f} over {MM_HOST_REPS}), ")
            if k in dev_t:
                return out + f"{dev_t[k]:.3f} ms of device time by CUDA events"
            pk = prof[k]
            if isinstance(pk, str):
                return out + f"kernel time {pk}"
            return out + (f"{pk['busy_ms']:.3f} ms of kernel busy time "
                          f"(kernel sum {pk['sum_ms']:.3f} ms, synced wall "
                          f"{pk['wall_ms']:.3f} ms; profile {pk['tries']} of "
                          f"{PROFILE_TRIES}) in {pk['launches']:.0f} "
                          "launches")
        ker = [prof[k] for k in ("decode step (ii)", "decode step (iii)")]
        ker_ratio = ("not measured" if any(isinstance(x, str) for x in ker)
                     else f"{ker[0]['busy_ms'] / ker[1]['busy_ms']:.2f}x")
        h2, h3 = host["decode step (ii)"], host["decode step (iii)"]
        log(f"# {label} timing row {row} (B={MM_BATCH}): "
            + "; ".join(timed(k) for k in fns)
            + "; decode step (ii) / (iii), the source every step against "
            f"the cached cross K/V: {h2[0] / h3[0]:.2f}x on the host's clock "
            f"(medians; {h2[1] / h3[2]:.2f}-{h2[2] / h3[1]:.2f} between the "
            f"extremes), {ker_ratio} in kernel busy time; {smi}")
        del st2, st3, step_src, proj_src

    # card vs CPU, row 0 cut to ``small``, the first request
    p_small = cut_depth(deployed[rows[0]], cfg, small)
    with torch.no_grad():
        gpu = multimodal_ways(p_small, small, prompt[:1], frontend[:1], dev)
        t0 = time.perf_counter()
        cpu = multimodal_ways(cm.tree_map(lambda t: t.cpu(), p_small), small,
                              prompt[:1].cpu(), frontend[:1].cpu(),
                              torch.device("cpu"))
        secs = time.perf_counter() - t0
    toks_g, toks_c = gpu[0][0].tolist(), cpu[0][0].tolist()
    if not (torch.equal(cpu[0], cpu[1]) and torch.equal(gpu[0], gpu[1])):
        fail(f"{label} multimodal cut: streams (ii) and (iii) differ")
    l2g = gpu[2][0]
    gaps = [float(g) for g in (torch.topk(l2g.float(), 2, -1).values.diff(
        dim=-1).abs()[:, 0] / l2g.abs().max())]
    part = parted_at_near_tie(f"{label} multimodal card vs CPU", toks_g,
                              toks_c, gaps)
    upto = part + 1 if part >= 0 else MM_NEW
    rel = max(_rel_to(g[0, :upto].cpu(), c[0, :upto])
              for g, c in zip(gpu[2:5], cpu[2:5]))
    cut = ", ".join(f"{g.kind} x{g.count}" + (
        f" ({g.self_per_unit} self)" if g.kind == "vision_unit" else "")
        for g in small.segments)
    log(f"# {label} multimodal card vs CPU on row {rows[0]} cut to [{cut}], "
        f"B=1: tokens card {toks_g}, CPU {toks_c}; logits of (ii), (iii) "
        f"and (i) over {upto} steps worst rel {rel:.2e} (tolerance "
        f"{TOL_DRAIN_FORWARD}); {secs:.1f} s on the CPU")
    if not rel <= TOL_DRAIN_FORWARD:
        fail(f"{label} multimodal card vs CPU logits rel {rel:.3e}")
    log(f"# {label} multimodal: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


def cross_phase(arch, cfg, small, dev, rng, report, smi):
    """Phases 16 (seamless-m4t-medium) and 17 (llama-3.2-vision-11b): the
    serving launcher's state for ``cfg`` (dense init, text-only
    calibration, DataSVD, DP; the groups left to plain SVD logged), every
    cross block's ``gate`` then drawn from U(0.5, 1.5) (at its zero init
    the cross-attention would not show); ``drain_phase`` (``generate(
    mode="auto")`` must route the family to drain); ``multimodal_check``
    on the deployed rows. Returns (launches by kernel, worst GAR error)."""
    from types import SimpleNamespace
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    n = cm.param_count(tfm.model_spec(cfg))
    log(f"# {arch}: {_layer_count(cfg.segments)} layers "
        f"({', '.join(f'{g.kind} x{g.count}' for g in cfg.segments)}): "
        f"{n / 1e9:.3f} B dense parameters, {4 * n / 1e9:.2f} GB in "
        "float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, 0, timings=setup)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    log(f"# {arch} setup: dense init {t_init:.2f} s, calibrate "
        f"{setup['calibrate']:.2f} s (text only), decompose "
        f"{setup['decompose']:.2f} s (DataSVD; {setup['plain_svd']} of "
        f"{len(infos)} groups plain SVD, no moment), DP "
        f"{setup['dp']:.2f} s ({table.table.shape[0]} rows); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB building "
        "the state")
    for i, seg in enumerate(cfg.segments):
        if seg.kind in ("decoder", "vision_unit"):
            g = params_fact["segments"][i]["cross"]
            g["gate"] = torch.as_tensor(rng.uniform(
                0.5, 1.5, tuple(g["gate"].shape)).astype(np.float32),
                device=dev)
    counts, gar_err, deployed = drain_phase(
        arch, cfg, SimpleNamespace(params=params_fact, table=table,
                                   infos=infos),
        small, dev, rng, report, smi)
    del params_fact
    counts["gar_matmul"] += multimodal_check(arch, cfg, deployed, small, dev,
                                             rng, smi)
    log(f"# {arch}: {time.perf_counter() - t_phase:.1f} s in all")
    del deployed
    gc.collect()
    torch.cuda.empty_cache()
    return counts, gar_err


# ------------------------------------------------------------ telemetry

TELEMETRY_KERNELS = {"gar_matmul": "gar_stage",
                     "paged_prefill_attention": "attend_kernel",
                     "topk_mask_sample": "draw_kernel"}


def scrape(url: str) -> str:
    """The body of a GET that answered 200 (any error status raises)."""
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def parse_prometheus(text: str) -> dict:
    """``name{labels}`` -> value of every sample line of a Prometheus text
    exposition; raises on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


class Scraper(threading.Thread):
    """Scrapes a status server's three routes every ``period_s`` until
    stopped, and once more after: each answer parsed, each trace dump
    validated. A ``/statusz`` answer marked ``partial`` fails, and so does
    one that holds an admitted, unfinished request (the scrape fell
    mid-run) without ``requests``, ``queues`` and ``kv``. ``rounds``
    records per round whether it fell mid-run and whether ``/metrics``
    held the audit's error ratios; the first failure stops the thread into
    ``error``."""

    def __init__(self, url: str, period_s: float = 0.25):
        super().__init__(daemon=True)
        self.url, self.period_s = url, period_s
        self.halt = threading.Event()
        self.rounds: list = []
        self.error = None

    def run(self):
        from repro_torch.obs import validate_chrome_trace
        while True:
            last = self.halt.is_set()
            try:
                prom = parse_prometheus(scrape(self.url + "/metrics"))
                status = json.loads(scrape(self.url + "/statusz"))
                trace = json.loads(scrape(self.url
                                          + "/debug/trace?last_s=30"))
                bad = validate_chrome_trace(trace)
                if bad:
                    raise RuntimeError(f"trace dump invalid: {bad[:3]}")
                if "partial" in status:
                    raise RuntimeError(f"/statusz partial: "
                                       f"{status['partial']}")
                mid = any(r["state"] in ("prefilling", "decoding")
                          for r in status.get("requests", {}).values())
                lack = {"requests", "queues", "kv"} - status.keys()
                if mid and lack:
                    raise RuntimeError(f"/statusz mid-run lacks {lack}")
            except Exception as e:          # reported by the phase
                self.error = repr(e)
                return
            self.rounds.append({
                "mid": mid,
                "ratio": any(k.startswith("repro_costmodel_error_ratio")
                             for k in prom),
                "events": len(trace["traceEvents"])})
            if last:
                return
            self.halt.wait(self.period_s)

    def finish(self) -> None:
        self.halt.set()
        self.join(timeout=60)
        if self.is_alive():
            fail("telemetry: the scraper did not stop")
        if self.error is not None:
            fail(f"telemetry: a scrape failed: {self.error}")


def plane_engine(engine, watchdog, **kw):
    """An engine of ``engine``'s state and settings with the whole live
    plane on (its deployed rows shared, so nothing deploys again) and a
    watchdog whose ticks are counted in ``ticks``."""
    from repro_torch import obs
    from repro_torch.serving import ElasticEngine
    on = ElasticEngine(engine.cfg, engine.params_fact, engine.table,
                       engine.infos, device=engine.device,
                       prefill_chunk=engine.prefill_chunk,
                       max_batch=engine.max_batch, max_len=engine.max_len,
                       tracer=obs.RingTracer(4096),
                       registry=obs.MetricsRegistry(), watchdog=watchdog,
                       costaudit=True, **kw)
    on._deployed = engine._deployed
    on.ticks = 0
    tick = watchdog.tick

    def counted(**kw):
        on.ticks += 1
        return tick(**kw)
    watchdog.tick = counted
    return on


def telemetry_phase(engine, reqs, plain, spec_plain, draft_rank) -> dict:
    """Phase 18 on phase 3's engine, requests and streams (``plain``) and
    phase 11's speculative streams (``spec_plain``, at ``draft_rank``):
    (a) plane off and on in turns, scraped live; (b) lookahead and
    speculation with the plane on; (c) a forced watchdog firing; (d) a
    ``torch.profiler`` trace through ``obs.profiling``; (e) the launcher
    with every new flag. Returns the launches of the serving kernels in
    (a)'s first on-run."""
    from repro_torch import obs
    from repro_torch.kernels import gar_matmul, paged_attention, sampling
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import Request
    from repro_torch.spec import SpecConfig
    kernels = {"gar_matmul": gar_matmul,
               "paged_prefill_attention": paged_attention,
               "topk_mask_sample": sampling}
    tmp = Path(tempfile.mkdtemp(prefix="telemetry-"))
    engine.lookahead, engine.spec, engine.prefix_cache = False, None, False

    def same(label, want, res):
        for i, (a, b) in enumerate(zip(want, res)):
            if not np.array_equal(a.tokens, b.tokens):
                fail(f"telemetry {label}: request {i} returned "
                     f"{b.tokens[-8:]}, plane off {a.tokens[-8:]}")

    # (a) off, then on, the on-run scraped live
    server = obs.StatusServer(port=0)
    server.start()
    for k in kernels.values():
        k.launches = 0
    turns = {False: [], True: []}
    audits, scrapes, fired = [], [], []
    try:
        for turn, on in enumerate((False, True)):
            if not on:
                res, wall, s = serve_timed(engine, reqs)
                same(f"(a) off turn {turn}", plain, res)
                turns[False].append(s)
                continue
            launches = {n: k.launches for n, k in kernels.items()}
            wd = obs.Watchdog(postmortem_dir=str(tmp / f"pm-{turn}"))
            eng = plane_engine(engine, wd)
            server.registry = eng.registry
            server.status_fn = eng.statusz
            server.trace_fn = eng.tracer.dump
            scraper = Scraper(server.url)
            scraper.start()
            try:
                res, wall, s = serve_timed(eng, reqs)
            finally:
                scraper.finish()
            for n, k in kernels.items():
                launches[n] = k.launches - launches[n]
            same(f"(a) on turn {turn}", plain, res)
            turns[True].append(s)
            m, snap = eng.last_metrics, eng.registry.snapshot()
            for key, want in (("repro_generated_tokens_total",
                               m.generated_tokens),
                              ("repro_prefill_tokens_total", m.prefill_tokens),
                              ("repro_requests_finished_total", len(reqs))):
                if snap.get(key) != want:
                    fail(f"telemetry (a): {key} {snap.get(key)}, "
                         f"ServingMetrics {want}")
            if eng.ticks != eng._iterations:
                fail(f"telemetry (a): {eng.ticks} watchdog ticks for "
                     f"{eng._iterations} iterations")
            mid = [r for r in scraper.rounds if r["mid"]]
            if not mid:
                fail(f"telemetry (a) turn {turn}: no scrape fell mid-run "
                     f"({len(scraper.rounds)} scrapes)")
            text = eng.registry.prometheus_text()
            if "repro_costmodel_error_ratio" not in text or not any(
                    r["ratio"] for r in scraper.rounds):
                fail("telemetry (a): /metrics holds no cost-model error "
                     "ratio")
            scrapes.append((len(scraper.rounds), len(mid),
                            max(r["events"] for r in scraper.rounds)))
            audits.append(eng.costaudit.statusz())
            fired += [(turn, r["rule"]) for r in wd.fired]
            if turn == 1:
                counts = launches
    finally:
        server.stop()
    tps = {on: [t["tokens_per_s"] for t in turns[on]] for on in turns}
    ratio = statistics.mean(tps[True]) / statistics.mean(tps[False])
    log(f"# telemetry (a): plane off tokens/s "
        + ", ".join(f"{x:.1f}" for x in tps[False]) + ", on "
        + ", ".join(f"{x:.1f}" for x in tps[True])
        + f"; on / off {ratio:.4f} (turn by turn "
        + ", ".join(f"{a / b:.4f}" for a, b in zip(tps[True], tps[False]))
        + "), ttft mean off "
        + ", ".join(f"{t['ttft_mean_s'] * 1e3:.1f}" for t in turns[False])
        + " ms, on "
        + ", ".join(f"{t['ttft_mean_s'] * 1e3:.1f}" for t in turns[True])
        + " ms; streams identical to phase 3's")
    log(f"# telemetry (a) scrapes (rounds, mid-run rounds, most dump "
        f"events) each on-run {scrapes}: every answer parsed, every trace "
        "dump valid; registry token counters equal ServingMetrics'; one "
        "watchdog tick an iteration; watchdog firings at the default "
        f"thresholds {fired}")
    for i, a in enumerate(audits):
        ratios = [c["error_ratio"] for c in a["cells"]]
        log(f"# telemetry (a) audit, on-run {i}: bandwidth "
            f"{a['bandwidth_gb_per_s']:.3f} GB/s, error ratios "
            f"{min(ratios):.4f}-{max(ratios):.4f} over {len(ratios)} "
            "(row, bucket) cells "
            + json.dumps([[c["row"], c["bucket"], c["count"],
                           round(c["measured_mean_ms"], 4),
                           round(c["predicted_mb"], 3),
                           round(c["error_ratio"], 4)]
                          for c in a["cells"]])
            + " [row, bucket, iterations, measured ms, predicted MB, "
            "ratio]")
    log(f"# telemetry (a) kernels: launches in the first on-run "
        f"{json.dumps(counts)}")
    if min(counts.values()) <= 0:
        fail(f"telemetry: a kernel of the serving path never launched with "
             f"the plane on: {counts}")

    # (b) lookahead, with (c) a forced TTFT firing in the same run, then
    # speculation; the plane on in both
    wd = obs.Watchdog(postmortem_dir=str(tmp / "forced"), ttft_slo_s=1e-6)
    eng = plane_engine(engine, wd, lookahead=True)
    with sync_free_lookahead():
        res, _, s_look = serve_timed(eng, reqs)
    same("(b) lookahead", plain, res)
    if s_look["lookahead_iterations"] <= 0:
        fail("telemetry (b): the lookahead run queued no speculative "
             "iteration")
    if eng.ticks != eng._iterations:
        fail(f"telemetry (b) lookahead: {eng.ticks} watchdog ticks for "
             f"{eng._iterations} iterations")
    look_ticks = eng.ticks
    if [r["rule"] for r in wd.fired] != ["ttft_slo"]:
        fail(f"telemetry (c): the TTFT SLO fired {wd.fired}")
    bundle = Path(wd.fired[0]["bundle"])
    files = sorted(p.name for p in bundle.iterdir())
    if files != ["metrics.json", "metrics.prom", "reason.json", "state.json",
                 "trace.json"]:
        fail(f"telemetry (c): bundle files {files}")
    dump = json.loads((bundle / "trace.json").read_text())
    bad = obs.validate_chrome_trace(dump)
    if bad:
        fail(f"telemetry (c): the bundle's ring dump is invalid: {bad[:3]}")
    state = json.loads((bundle / "state.json").read_text())
    if set(state) != set(eng.statusz()):
        fail(f"telemetry (c): state.json keys {sorted(state)}, statusz "
             f"{sorted(eng.statusz())}")
    reason = wd.fired[0]["reason"]
    wd = obs.Watchdog(postmortem_dir=str(tmp / "spec"))
    eng = plane_engine(engine, wd,
                       spec=SpecConfig(draft_rank=draft_rank,
                                       spec_len=SPEC_LEN))
    with sync_free_rounds():
        res, _, s_spec = serve_timed(eng, reqs)
    same("(b) speculative", spec_plain, res)
    if s_spec["spec_rounds"] <= 0:
        fail("telemetry (b): the speculative run drafted no round")
    if eng.ticks != eng._iterations:
        fail(f"telemetry (b) spec: {eng.ticks} watchdog ticks for "
             f"{eng._iterations} iterations")
    log(f"# telemetry (b): lookahead {s_look['tokens_per_s']:.1f} tok/s, "
        f"{s_look['lookahead_iterations']} lookahead iterations, "
        f"{look_ticks} ticks; speculative {s_spec['tokens_per_s']:.1f} "
        f"tok/s, {s_spec['spec_rounds']:.0f} rounds, {eng.ticks} ticks; "
        "plane on, streams identical to phases 3 and 11, one watchdog tick "
        "an iteration or round, no host sync in a pipelined iteration or "
        "before a round's commit")
    log(f"# telemetry (c): ttft_slo fired in the lookahead run ({reason}); "
        f"bundle {files}, ring dump of {len(dump['traceEvents'])} events "
        "valid, state.json holds statusz's keys")

    # (d) a sampled request of 4 new tokens, and a greedy one on the host
    # sampling path, under the profiler (an eager iteration is some 8000
    # trace events)
    prof_dir = tmp / "profile"
    before = {n: k.launches for n, k in kernels.items()}
    sampled = [Request(prompt=reqs[1].prompt, max_new_tokens=4, budget=1.0,
                       sampling=reqs[1].sampling)]
    greedy = [Request(prompt=reqs[0].prompt, max_new_tokens=2, budget=1.0)]
    with obs.profiling.profile(str(prof_dir)):
        engine.generate(sampled, mode="continuous")
        engine.device_sampling = False
        try:
            engine.generate(greedy, mode="continuous")
        finally:
            engine.device_sampling = True
        torch.cuda.synchronize()
    launched = {n: k.launches - before[n] for n, k in kernels.items()}
    (path,) = prof_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernel_names = [e.get("name", "") for e in events
                    if e.get("cat") == "kernel"]
    seen = {n: sum(1 for k in kernel_names if frag in k)
            for n, frag in TELEMETRY_KERNELS.items()}
    missing = [a for a in ("paged_sample_step", "paged_mixed_step")
               if a not in names] + [n for n, c in seen.items() if not c]
    if missing:
        fail(f"telemetry (d): the profiler trace names none of {missing}")
    log(f"# telemetry (d): profiler trace {path.stat().st_size} bytes, "
        f"{len(events)} events, annotations paged_sample_step and "
        f"paged_mixed_step; kernel records in the trace {json.dumps(seen)}"
        f", wrapper launches {json.dumps(launched)} (not compared: the "
        "profiler may lose records)")

    # (e) the launcher at --smoke with every new flag
    out = io.StringIO()
    argv = ["--smoke", "--requests", "3", "--budgets", "0.4,1.0",
            "--max-new", "4", "--prefill-chunk", "8",
            "--trace-ring", "4096", "--trace-out", str(tmp / "trace.json"),
            "--metrics-out", str(tmp / "metrics.prom"),
            "--statusz-port", "0", "--status-linger", "0.2", "--watchdog",
            "--postmortem-dir", str(tmp / "launcher-pm"),
            "--jax-profile", str(tmp / "launcher-profile")]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        launcher.main(argv)
    t_launch = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    trace = json.loads((tmp / "trace.json").read_text())
    metrics = (tmp / "metrics.prom").read_text()
    checks = {
        "statusz line": any(l.startswith("# statusz: http") for l in lines),
        "3 request lines": sum(l.startswith("req ") for l in lines) == 3,
        "serving line": any(l.startswith("# serving:") for l in lines),
        "trace valid": not obs.validate_chrome_trace(trace),
        "audit in metrics": "# TYPE repro_costmodel_error_ratio gauge"
                            in metrics,
        "profile written": bool(list((tmp / "launcher-profile").glob(
            "*.pt.trace.json")))}
    if not all(checks.values()):
        fail(f"telemetry (e): launcher checks {checks}; output "
             f"{lines[-12:]}")
    log(f"# telemetry (e): launcher --smoke with every new flag on the "
        f"card in {t_launch:.1f} s: "
        + ", ".join(checks)
        + "; " + next(l for l in lines if l.startswith("# serving:")))
    shutil.rmtree(tmp, ignore_errors=True)
    return counts


def _layer_count(segments) -> int:
    return sum(s.count * (s.mamba_per_unit + 1 if s.kind == "zamba_unit"
                          else s.self_per_unit + 1
                          if s.kind == "vision_unit" else 1)
               for s in segments)


def dist_phase(smi: str) -> None:
    """Phase 21: the launcher's mesh path in rank processes on the card
    (``dist_check.py`` beside this script, which raises on a failed
    check); prints its numbers beside the card's name and power limit."""
    import dist_check

    def port():
        import socket
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]
    d = tempfile.mkdtemp(prefix="dist_check_")
    spec = dict(arch="deepseek-moe-16b", smoke=False, cut=True,
                device="cuda", backend_a="nccl", batch=2, seq=64, steps=2,
                port_a=port(), port_b=port(), dir=d,
                tol_loss=TOL_TRAIN_LOSS, tol_param=TOL_DIST_PARAM,
                leaf_share=TOL_DIST_LEAF_SHARE, tol_logits=TOL_GAR,
                lowrank={"arch": "gpt2-small", "layers": DIST_LOWRANK_LAYERS},
                decode=DIST_DECODE, gar={"seed": 0})
    try:
        try:
            r = dist_check.run_pair(spec, DIST_DEADLINE)
        except RuntimeError as e:
            fail(f"phase 21: {e}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"# dist: deepseek-moe-16b 2 of 28 layers, {r['params'] / 1e9:.3f} "
        f"B parameters, dense init {r['init_s']:.2f} s; {smi}")
    log(f"# dist (a) no group, then the launcher's world of one "
        f"({r['a_backend']}, chosen from the card's UUID) at 1 x 1: losses "
        f"{r['a_losses']} bit for bit, parameters bit for bit; step ms "
        f"{[round(x, 1) for x in r['a_step_ms']]} without a group, "
        f"{[round(x, 1) for x in r['a_world_step_ms']]} in the world")
    for key in ("2x1", "1x2"):
        b = r[key]
        log(f"# dist (b) gloo {key}: losses {b['losses']} (rel "
            f"{b['loss_err']:.2e}), parameters at most {b['param_err']:.2e} "
            f"of a leaf's scale ({b['param_leaf']}); leaves with entries "
            f"past TOL_DIST_PARAM [past, allowed]: {b['past']}; step ms "
            f"{[round(x, 1) for x in b['step_ms']]}, "
            f"gradient all-reduce ms "
            f"{[round(x, 1) for x in b['allreduce_ms']]}, peak GB per rank "
            f"{[round(x, 2) for x in b['peak_gb']]}; {len(b['split'])} "
            f"leaves cut over 'model'; {smi}")
    for rank, sz in enumerate(r["1x2"]["bytes"]):
        log(f"# dist (b) 1x2 rank {rank}: parameters {sz['have']['params']} "
            f"B, AdamW moments {sz['have']['optimizer']} B; the dry run's "
            f"placed at (1, 2): parameters {sz['placed']['params']} B, "
            f"optimizer {sz['placed']['optimizer']} B (its int32 step "
            f"beside the moments); {smi}")
    c = r["c"]
    log(f"# dist (c) gpt2-small {DIST_LOWRANK_LAYERS} of 12 layers, "
        f"--mode flexrank, gloo 1x2 against one rank without a group: "
        f"losses {c['losses']} (rel {c['loss_err']:.2e}), parameters at "
        f"most {c['param_err']:.2e} of a leaf's scale ({c['param_leaf']}); "
        f"past [past, allowed]: {c['past']}; step ms "
        f"{[round(x, 1) for x in c['step_ms']]} (one rank: "
        f"{[round(x, 1) for x in r['c_one']['step_ms']]}); {smi}")
    for rank, cr in enumerate(c["ranks"]):
        log(f"# dist (c) 1x2 rank {rank}: {cr['calls']} low-rank products, "
            f"lowrank_matmul launches {cr['launches']} (one rank without a "
            f"group: {r['c_one']['calls']} products, "
            f"{r['c_one']['launches']} launches); (x, v, u) shapes "
            f"{cr['shapes']}; {smi}")
    log(f"# dist (b) 1x2 logits against the forward without a mesh: "
        f"{r['logits_err']:.2e} of their max; all-to-all of "
        f"{r['a2a_bytes'] / 1e6:.1f} MB ms: dispatch "
        f"{[round(x, 2) for x in r['a2a_ms']['dispatch']]}, return "
        f"{[round(x, 2) for x in r['a2a_ms']['return']]}")
    dc = DIST_DECODE
    log(f"# dist (d) in {r['d_s']:.1f} s on rank 0 (both meshes, and one "
        f"rank's runs); {smi}")
    for key, d in r["d"].items():
        for rank, x in enumerate(d["ranks"]):
            log(f"# dist (d) {key} rank {rank}: {dc['prompt']}-token prompt "
                f"into {dc['cache']} positions, {dc['steps']} greedy steps: "
                f"parameters {x['bytes']['params']} B, cache "
                f"{x['bytes']['cache']} B (the decode cell's placed, float32)"
                f", {x['rows']} rows written; step ms "
                f"{[round(t, 2) for t in x['step_ms']]}; {smi}")
        log(f"# dist (d) {key}: logits against one rank without a group "
            f"{d['logits_err']:.2e} of their max (TOL_GAR), greedy tokens "
            f"equal; one rank's cache {d['one_cache']} B, step ms "
            f"{[round(t, 2) for t in d['one_step_ms']]}; {smi}")
    e = r["e"]
    log(f"# dist (e) gar decode 1x2, deepseek-moe-16b 2 of 28 layers in the "
        f"GAR form ({e['params'] / 1e9:.3f} B parameters, _make from seed "
        f"0), {dc['prompt']}-token prompt, {dc['steps']} greedy steps: "
        f"logits against one rank {e['logits_err']:.2e} of their max "
        f"(TOL_GAR), greedy tokens equal; one rank's parameters "
        f"{e['one_params']} B, step ms "
        f"{[round(t, 2) for t in e['one_step_ms']]}; {e['s']:.1f} s on "
        f"rank 0; {smi}")
    for rank, x in enumerate(e["ranks"]):
        log(f"# dist (e) 1x2 rank {rank}: parameters {x['bytes']['params']}"
            f" B, cache {x['bytes']['cache']} B (the gar decode cell's "
            f"placed, float32 and int64); {x['products']} GAR products, "
            f"{x['tails']} of them stage 2 on a given z, every weight "
            f"operand the rank's part; gar_matmul launches "
            f"{x['launches']}, gar_tail launches {x['tail_launches']}; "
            f"step ms {[round(t, 2) for t in x['step_ms']]}; {smi}")
    pos = MERGE_CELL["length"] * 3 // 4 + 5
    for window in (MERGE_CELL["length"], 8192):
        t0 = time.perf_counter()
        m = dist_check.merge_check("cuda", pos=pos, window=window,
                                   **MERGE_CELL)
        torch.cuda.synchronize()
        if m["err"] > TOL_MERGE or m["bf16_err"] > TOL_MERGE_BF16:
            fail(f"phase 21 (d) merge at window {window}: {m}")
        log(f"# dist (d) merge: llama4-scout-17b-a16e decode_32k layer (B 8, "
            f"Hq 40, Hkv 8, D 128, T 32768, bfloat16 cache) in 16 shards of "
            f"2048 rows, query at {pos}, window {window}: {m['err']:.2e} of "
            f"the output's max in float32 (TOL_MERGE), {m['bf16_err']:.2e} "
            f"in bfloat16 (TOL_MERGE_BF16); "
            f"{(time.perf_counter() - t0):.2f} s; {smi}")


def dryrun_phase(dev, smi: str) -> None:
    """Phase 22: the dry run's figures, on the host and against the card
    (module note)."""
    from repro_torch import distributed as D
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import gar_matmul, lowrank_matmul
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import trace_analysis as TA

    for arch, shape, multi in (("deepseek-moe-16b", "train_4k", False),
                               ("zamba2-7b", "long_500k", True)):
        rec = DR.run_cell(arch, shape, multi_pod=multi, mode="dense",
                          out_dir=None)
        if rec["status"] != "ok":
            fail(f"phase 22 (a) {arch} {shape}: {rec.get('error')}")
        b, coll = rec["bytes_per_device"], rec["collectives"]
        log(f"# dryrun (a) {arch} {shape} on {rec['mesh']}, rank 0 of a "
            f"fake world (local batch {rec['local_batch']}): "
            f"{rec['hlo_flops_per_device'] / 1e12:.2f} TFLOP, "
            f"{rec['dot_count']} products; collective GB "
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in coll.items() if v)
            + f"; argument {b['argument'] / 1e9:.2f} GB, peak "
            f"{b['peak'] / 1e9:.2f} GB (placed "
            f"{rec['placed']['bytes_per_device']['total'] / 1e9:.2f} GB); "
            f"t_compute {rec['t_compute']:.4g} s, t_memory "
            f"{rec['t_memory']:.4g} s, t_collective "
            f"{rec['t_collective']:.4g} s, {rec['bottleneck']}-bound, "
            f"useful {rec['useful_flops_ratio']:.4f}; traced in "
            f"{rec['trace_s']:.1f} s ({ROOFLINE_NOTE})")
    D.shutdown_world()

    cfg = get_config("gpt2-small")
    mesh = DR.make_mesh((1, 1), ("data", "model"), devices=[dev])

    def both(label, shape, mode, kernel=None):
        """The step traced on meta and on the card; returns the two
        traces' figures and the card step's high-water mark and ms."""
        meta_step, meta_args, facts = DR.build_step(
            cfg, shape, mesh, mode, dtype=torch.float32)
        with D.mesh_context(mesh):
            _, meta = TA.trace(meta_step, *meta_args)
        step, args, _ = DR.build_step(cfg, shape, mesh, mode, device=dev,
                                      dtype=torch.float32)
        with D.mesh_context(mesh):
            step(*args)                   # warm-up: cuBLAS's handles
        torch.cuda.synchronize()
        gc.collect()
        launched = None if kernel is None else kernel.launches
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with D.mesh_context(mesh):
            _, card = TA.trace(step, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        high = torch.cuda.max_memory_allocated(dev) - before
        for key in ("flops_dot", "dot_count", "collective_bytes",
                    "kernel_work"):
            if meta[key] != card[key]:
                fail(f"phase 22 {label}: {key} {meta[key]} on meta, "
                     f"{card[key]} on the card")
        if kernel is not None and kernel.launches == launched:
            fail(f"phase 22 {label}: {kernel.__name__} not launched")
        log(f"# dryrun {label}: gpt2-small full depth, {shape.global_batch}"
            f" x {shape.seq_len} ({shape.kind}, {mode}"
            + (f", budget row {facts['budget_k']}" if "budget_k" in facts
               else "") + f"): {meta['flops_dot']:.6g} FLOPs, "
            f"{meta['dot_count']} products, collective bytes "
            f"{meta['collective_bytes_total']:.0f} on meta and on the card"
            + "".join(f"; {k} work {w}" for k, w in
                      card["kernel_work"].items())
            + f"; step high-water: meta {meta['bytes']['temp']} B (peak "
            f"{meta['bytes']['peak']} B), card trace "
            f"{card['bytes']['temp']} B, card allocator {high} B "
            f"(max_memory_allocated {torch.cuda.max_memory_allocated(dev)}"
            f" B); t_compute {meta['flops_dot'] / DR.PEAK_FLOPS * 1e3:.4f}"
            f" ms (datasheet peak) vs the step {ms:.1f} ms traced; {smi}")
        return meta, high

    meta, high = both("(b)", ShapeConfig("chip", 128, 8, "train"), "dense")
    want = meta["bytes"]["temp"]
    if abs(high - want) > TOL_DRYRUN_PEAK * want + DRYRUN_PEAK_SLACK:
        fail(f"phase 22 (b): the card's step high-water {high} B against "
             f"the meta trace's {want} B")
    both("(c) flexrank", ShapeConfig("chip", 128, 8, "train"), "flexrank",
         lowrank_matmul)
    both("(c) gar decode", ShapeConfig("chip", 256, 8, "decode"), "gar",
         gar_matmul)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import Segment, get_config
    from repro_torch.kernels import build, gar_matmul, lowrank_matmul, \
        paged_attention, sampling, ssd, wkv6
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    from repro_torch.models import common as cm
    from repro_torch.serving import ElasticEngine, Request, SamplingParams

    t_smoke = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"# device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {smi}")
    mark = [t_smoke]

    def phase_done(label):
        """Log the seconds since the last phase ended: each phase's share
        of the smoke's time limit."""
        now = time.perf_counter()
        log(f"# phase {label}: {now - mark[0]:.1f} s (at "
            f"{now - t_smoke:.1f} s)")
        mark[0] = now

    # 1. build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"# build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for k, (s, ptx) in build.build_log.items():
        for line in ptx.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {k}: {line.strip()}")

    phase_done("1 build")

    # 21. the training launcher's mesh path, while the card is empty
    dist_phase(smi)
    phase_done("21 dist")

    # main-path state (its deployed GAR leaves feed the kernel checks)
    cfg = get_config("gpt2-small")
    t0 = time.perf_counter()
    dense = dense_init(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, 0, timings=setup)
    engine = ElasticEngine(cfg, params_fact, table, infos, device="cuda",
                           prefill_chunk=64, max_batch=8, max_len=256)
    budgets = (0.4, 1.0)
    rows = [engine._budget_row(b) for b in budgets]
    deployed = {r: engine._realize(r) for r in rows}
    log(f"# setup: dense init {t_init:.2f} s, calibrate "
        f"{setup['calibrate']:.2f} s, decompose {setup['decompose']:.2f} s "
        f"(DataSVD), DP {setup['dp']:.2f} s ({table.table.shape[0]} rows x "
        f"{table.table.shape[1]} groups), deploy "
        + ", ".join(f"row {r} (budget {b}) {engine.deploy_seconds[r]:.2f} s"
                    for b, r in zip(budgets, rows)))

    phase_done("1 setup")

    # 2. kernels
    rng = np.random.default_rng(0)
    report: list = []
    gar_shapes = []
    for b, r in zip(budgets, rows):
        layer = deployed[r]["segments"][0]
        for proj in ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/gate",
                     "mlp/up", "mlp/down"):
            leaf = cm.tree_get(layer, proj)
            vt, uh, pi = (leaf["v_tilde"][0], leaf["u_hat"][0],
                          leaf["perm_inv"][0])
            for t in (8, 72):
                n, rr = vt.shape
                gar_shapes.append((f"{proj} budget {b} T={t} n={n} r={rr} "
                                   f"m={rr + uh.shape[0]}", t, vt, uh, pi))

    def rand_gar(n, m, r):
        return (torch.as_tensor(rng.standard_normal((n, r)).astype(
                    np.float32) / math.sqrt(n), device=dev),
                torch.as_tensor(rng.standard_normal((m - r, r)).astype(
                    np.float32) / math.sqrt(r), device=dev),
                torch.as_tensor(rng.permutation(m), device=dev))
    # ragged shapes, gemma3's widths among them (ranks 3001 and 5376; m - r
    # = 0)
    for t, n, m, r in ((33, 17, 29, 7), (100, 96, 80, 40), (5, 64, 64, 64),
                       (19, 3072, 768, 301), (19, 5376, 21504, 3001),
                       (5, 21504, 5376, 5376)):
        gar_shapes.append((f"ragged T={t} n={n} r={r} m={m}", t,
                           *rand_gar(n, m, r)))
    # a tensor-parallel rank's GAR products at llama4-scout-17b-a16e's
    # attn/q shard of (1, 2) (r 3500, m - r 1620: column-parallel, so
    # v_tilde by rank and u_hat by out; on (16, 16) neither divides and the
    # leaf stays whole): stage 1 alone (the fused call with an empty u_hat
    # and the identity permutation) on the rank's 1750 columns, then the
    # stage-2 entry on the gathered z and the rank's 810 rows of u_hat, at
    # a decode batch and a prefill chunk; then ragged ones
    def stage1(n, r):
        v = torch.as_tensor(rng.standard_normal((n, r)).astype(np.float32)
                            / math.sqrt(n), device=dev)
        return v, v.new_empty((0, r)), torch.arange(r, device=dev)
    tail_cases = []
    for t in (8, 256):
        gar_shapes.append((f"llama4 attn/q rank of 1x2 stage 1 T={t} n=5120 "
                           f"r=1750", t, *stage1(5120, 1750)))
        tail_cases.append((f"llama4 attn/q rank of 1x2 stage 2 T={t} r=3500 "
                           f"m-r=810", t, 3500, 810))
    gar_shapes.append(("ragged stage 1 T=5 n=17 r=3", 5, *stage1(17, 3)))
    tail_cases += [("ragged T=33 r=7 m-r=29", 33, 7, 29),
                   ("ragged T=100 r=301 m-r=130", 100, 301, 130)]
    gar_err = max(check_gar(dev, gar_shapes, rng, report),
                  check_gar_tail(dev, tail_cases, rng, report))
    attn_err = check_attention(dev, [
        ("T=8 decode Hq=Hkv=12 D=64 BS=16", (8, 12, 12, 64, 16, 8, 16, 8, 0),
         (0.0,), (None,)),
        ("T=72 decode7+chunk64 Hq=Hkv=12 D=64 BS=16",
         (72, 12, 12, 64, 16, 8, 16, 7, 64), (0.0, 30.0), (None,)),
        # gemma3's mixed iteration: 8 decode tokens and a 256-token chunk
        # over contexts to 2048, global and local (1024) layers, and a
        # window that starts mid-block
        ("gemma3 T=264 decode8+chunk256 Hq=32 Hkv=16 D=128 BS=16",
         (264, 32, 16, 128, 16, 9, 128, 8, 256), (0.0, 30.0),
         (None, 1024, 1000)),
        ("ragged GQA 12/4 D=40 BS=7", (10, 12, 4, 40, 7, 3, 3, 2, 5),
         (0.0, 30.0), (None, 9, 1)),
        ("ragged GQA 8/2 D=32 BS=8", (10, 8, 2, 32, 8, 3, 4, 2, 4), (0.0,),
         (None, 13)),
        # a D that is not a multiple of 4: the scalar path
        ("ragged GQA 6/2 D=18 BS=5", (12, 6, 2, 18, 5, 3, 4, 2, 6),
         (0.0, 30.0), (None, 7)),
    ], rng, report)
    log(f"# paged attention scratch (partials of every split) at gemma3 "
        f"T=264: {paged_attention.scratch_bytes(264, 32, 128, 128, 16)} "
        f"bytes a call")
    dec_err = check_decode(dev, [
        ("gpt2 B=8 Hq=Hkv=12 D=64 BS=16", (8, 12, 12, 64, 16, 16, 90, 256),
         (0.0, 30.0), (None,)),
        ("gemma3 B=8 Hq=32 Hkv=16 D=128 BS=16",
         (8, 32, 16, 128, 16, 128, 1024, 2048), (0.0, 30.0),
         (None, 1024, 1000)),
        ("ragged B=5 GQA 12/4 D=40 BS=7", (5, 12, 4, 40, 7, 3, 1, 21),
         (0.0, 30.0), (None, 9, 1)),
        ("ragged B=3 GQA 6/2 D=18 BS=5", (3, 6, 2, 18, 5, 4, 1, 20),
         (0.0,), (None, 7)),
    ], rng, report)
    samp_err = check_sampling(dev, [("S=8 V=50257", 8, 50257, False),
                                    ("S=4 V=50257", 4, 50257, False),
                                    ("S=8 V=262144", 8, 262144, False),
                                    ("ragged S=9 V=515", 9, 515, False),
                                    ("ragged S=3 V=64", 3, 64, False),
                                    ("ragged S=5 V=1025", 5, 1025, False),
                                    ("ragged ties S=8 V=262144", 8, 262144,
                                     True),
                                    ("ragged ties S=6 V=1025", 6, 1025,
                                     True)], rng, report)
    last = table.table.shape[0] - 1
    lr_cases = []
    for k in (0, last):
        layer = params_fact["segments"][0]
        for proj in PROJECTIONS:
            leaf = cm.tree_get(layer, proj)
            v, u = leaf["v"][0], leaf["u"][0]
            kr = int(table.table[k][[i.path for i in infos].index(
                f"segments/0/{proj}")])
            lr_cases.append((f"{proj} row {k} T=1024 n={v.shape[0]} "
                             f"r={v.shape[1]} rank={kr} m={u.shape[0]}",
                             1024, v, u, kr))

    def rand_lowrank(n, m, r):
        return (torch.as_tensor(rng.standard_normal((n, r)).astype(
                    np.float32) / math.sqrt(n), device=dev),
                torch.as_tensor(rng.standard_normal((m, r)).astype(
                    np.float32) / math.sqrt(r), device=dev))
    # a tensor-parallel shard (phase 21 (c), gpt2-small at (1, 2)): attn/q
    # column-parallel, v gathered whole and this rank's 384 of u's rows
    q = cm.tree_get(params_fact["segments"][0], "attn/q")
    kr = int(table.table[last][[i.path for i in infos].index(
        "segments/0/attn/q")])
    lr_cases.append((f"attn/q shard of 2 row {last} T=128 n=768 "
                     f"r={q['v'].shape[-1]} rank={kr} m=384", 128,
                     q["v"][0], q["u"][0][:384].contiguous(), kr))
    v, u = rand_lowrank(17, 29, 7)
    for rank in (3, 0, 7, None):
        lr_cases.append((f"ragged T=33 n=17 r=7 m=29 rank={rank}", 33, v, u,
                         rank))
    lr_cases.append(("ragged T=70 n=300 r=257 m=130 rank=129", 70,
                     *rand_lowrank(300, 130, 257), 129))
    # rwkv6-3b's channel/k at full rank and a ragged kept rank of zamba2's
    # width
    lr_cases.append(("rwkv6 channel/k T=1024 n=2560 r=2560 rank=2560 "
                     "m=8960", 1024, *rand_lowrank(2560, 8960, 2560), None))
    lr_cases.append(("ragged T=45 n=3584 r=3584 m=77 rank=3001", 45,
                     *rand_lowrank(3584, 77, 3584), 3001))
    lr_err = check_lowrank(dev, lr_cases, rng, report)
    # rwkv6-3b's and zamba2-7b's training shapes (8 x 128 tokens), then
    # ragged ones
    wkv_err = check_wkv6(dev, [("B=8 S=128 H=40 N=64", 8, 128, 40),
                               ("ragged B=3 S=70 H=5", 3, 70, 5),
                               ("ragged B=1 S=1 H=1", 1, 1, 1)], rng, report)
    ssd_err = check_ssd(dev, [
        ("B=8 S=128 H=112 G=1 P=N=64", 8, 128, 112, 1, None),
        ("ragged B=3 S=70 H=5 G=1", 3, 70, 5, 1, None),
        ("ragged B=1 S=33 H=6 G=2", 1, 33, 6, 2, None)], rng, report)
    # three chunks with two heads a group, and steps whose sums pass
    # float32's exponent range, from their own generator (the later
    # phases' draws stay as they were)
    ssd_err = max(ssd_err, check_ssd(dev, [
        ("ragged B=2 S=257 H=8 G=2", 2, 257, 8, 2, None),
        ("large dt B=2 S=200 H=4 G=2 (dt |N| x 4)", 2, 200, 4, 2, 4.0)],
        np.random.default_rng(18), report))
    # deepseek-moe-16b's serving shapes (phase 14: a decode batch and a
    # mixed iteration of 7 decode tokens and a 64-token chunk, 16 heads of
    # 128, vocab 102400) and minicpm3-4b's vocab (phase 15, drain batches
    # of 4 and 8), from their own generator (the later phases' draws stay
    # as they were)
    srng = np.random.default_rng(22)
    attn_err = max(attn_err, check_attention(dev, [
        ("deepseek T=8 decode Hq=Hkv=16 D=128 BS=16",
         (8, 16, 16, 128, 16, 8, 16, 8, 0), (0.0,), (None,)),
        ("deepseek T=72 decode7+chunk64 Hq=Hkv=16 D=128 BS=16",
         (72, 16, 16, 128, 16, 8, 16, 7, 64), (0.0,), (None,))],
        srng, report))
    dec_err = max(dec_err, check_decode(dev, [
        ("deepseek B=8 Hq=Hkv=16 D=128 BS=16",
         (8, 16, 16, 128, 16, 16, 90, 256), (0.0,), (None,))], srng, report))
    samp_err = max(samp_err, check_sampling(dev, [
        ("deepseek S=8 V=102400", 8, 102400, False),
        ("minicpm3 S=8 V=73448", 8, 73448, False),
        ("minicpm3 S=4 V=73448", 4, 73448, False)], srng, report))
    # seamless-m4t-medium's and llama-3.2-vision-11b's vocabularies
    # (phases 16-17, drain batches of 4 and 8), from their own generator
    samp_err = max(samp_err, check_sampling(dev, [
        ("seamless S=8 V=256206", 8, 256206, False),
        ("seamless S=4 V=256206", 4, 256206, False),
        ("vision S=8 V=128256", 8, 128256, False),
        ("vision S=4 V=128256", 4, 128256, False)],
        np.random.default_rng(23), report))
    # llama4-scout-17b-a16e's serving shapes (phase 20: GQA 40/8, a head
    # group of 5, so a tile window of 6 tokens, 30 of the 32 rows; vocab
    # 202048), and ragged ones with a group of 5 (a 10-token chunk over two
    # windows, a window that cuts a block), from their own generator
    lrng = np.random.default_rng(26)
    attn_err = max(attn_err, check_attention(dev, [
        ("llama4 T=8 decode Hq=40 Hkv=8 D=128 BS=16",
         (8, 40, 8, 128, 16, 8, 16, 8, 0), (0.0,), (None,)),
        ("llama4 T=72 decode7+chunk64 Hq=40 Hkv=8 D=128 BS=16",
         (72, 40, 8, 128, 16, 8, 16, 7, 64), (0.0,), (None,)),
        ("ragged GQA 10/2 D=40 BS=7", (13, 10, 2, 40, 7, 4, 4, 3, 10),
         (0.0, 30.0), (None, 9))], lrng, report))
    dec_err = max(dec_err, check_decode(dev, [
        ("llama4 B=8 Hq=40 Hkv=8 D=128 BS=16",
         (8, 40, 8, 128, 16, 16, 90, 256), (0.0,), (None,)),
        ("ragged B=3 GQA 10/2 D=40 BS=7", (3, 10, 2, 40, 7, 3, 1, 21),
         (0.0, 30.0), (None, 9))], lrng, report))
    samp_err = max(samp_err, check_sampling(dev, [
        ("llama4 S=8 V=202048", 8, 202048, False),
        ("llama4 S=4 V=202048", 4, 202048, False)], lrng, report))
    for e in report:
        log(kernel_line(e))

    phase_done("2 kernels")

    # 3. serving path
    prng = np.random.default_rng(1)
    reqs = []
    for i in range(8):
        plen = int(prng.integers(48, 161))
        samp = (SamplingParams(temperature=0.8, top_k=40, seed=100 + i)
                if i % 2 else None)
        reqs.append(Request(
            prompt=prng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=32, budget=budgets[i % 2], sampling=samp))
    kernels = (gar_matmul, paged_attention, sampling)
    for k in (*kernels, lowrank_matmul):
        k.launches = 0
    t0 = time.perf_counter()
    results = engine.generate(reqs, mode="continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    for rq, rs in zip(reqs, results):
        if len(rs.tokens) != len(rq.prompt) + 32:
            fail(f"request of {len(rq.prompt)} tokens returned "
                 f"{len(rs.tokens)}")
        gen = rs.tokens[len(rq.prompt):]
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail("generated token out of the vocabulary")
    s = engine.last_metrics.summary()
    log(f"# main path: gpt2-small full width, 8 requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}"
        f", 32 new each, budgets 0.4/1.0 -> rows {rows}), wall {wall:.2f} s")
    log(f"# serving: {s['tokens_per_s']:.1f} tok/s, ttft mean "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms, {s['mixed_iterations']:.0f} "
        f"mixed iterations, dispatch {s['dispatch_ms_mean']:.2f} ms / host "
        f"{s['host_ms_mean']:.2f} ms per iteration, preemptions "
        f"{s['preemptions']}")
    log(f"# kernels: launches on the main path {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        fail(f"a kernel of the serving path never launched: {counts}")

    if "--profile" in sys.argv[1:]:
        profile_main_path(engine, reqs)

    # 4. card vs CPU, one greedy request at the 0.4 row
    prompt = prng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    row = rows[0]
    res = engine.generate([Request(prompt=prompt, max_new_tokens=8,
                                   budget=budgets[0])])[0]
    eng_toks = res.tokens[32:].tolist()
    p_gpu = deployed[row]
    p_cpu = cm.tree_map(lambda t: t.cpu(), p_gpu)
    with torch.no_grad():
        toks_gpu, marg_gpu = greedy_loop(p_gpu, cfg, prompt, 8, dev)
        t0 = time.perf_counter()
        toks_cpu, marg_cpu = greedy_loop(p_cpu, cfg, prompt, 8,
                                         torch.device("cpu"))
        t_cpu = time.perf_counter() - t0
    log(f"# cross-check: card engine {eng_toks}, card loop {toks_gpu}, CPU "
        f"loop {toks_cpu} ({t_cpu:.1f} s on the CPU)")
    if not (eng_toks == toks_gpu == toks_cpu):
        for i, (a, b, c) in enumerate(zip(eng_toks, toks_gpu, toks_cpu)):
            if not a == b == c:
                fail(f"card and CPU part at step {i}: top-2 margin "
                     f"{marg_gpu[i]:.3e} on the card, {marg_cpu[i]:.3e} on "
                     "the CPU, of the logits' max")

    # rows 0 and the top one stay deployed for phase 9
    gpt2_rows = {0: engine._realize(0), last: engine._realize(last)}

    phase_done("3-4 serving, card vs CPU")

    # 5. training path, 6. one training step card vs CPU
    profiling = "--profile" in sys.argv[1:]
    del deployed, params_fact
    res, trained, _ = train_phase(cfg, dense, 20, (lowrank_matmul,))
    counts.update(trained)
    if profiling:
        profile_train(cfg, res, dense)
    cross_train_phase(cfg, res.params, res.table, res.infos, dense, dev)

    phase_done("5-6 training")

    # 19. the other training modes, Muon, PowerSGD, preemption and
    # restart through the launcher, the nestedness trainer, on phase 5's
    # weights
    counts["lowrank_matmul"] += modes_phase(cfg, dense, res, dev,
                                            lowrank_matmul, smi)
    del res, dense
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("19 training modes")

    # 7. rwkv6-3b (4 of 32 layers; 8 until the smoke passed 1050 s with
    # phase 19), 8. zamba2-7b: full width, cut in depth; each then
    # served through drain from its trained state (13 (a), (b))
    drng = np.random.default_rng(13)
    rwkv_counts, _, res, rcfg = recurrent_phase(
        "rwkv6-3b", (Segment("rwkv", 4),), (Segment("rwkv", 2),),
        (wkv6, lowrank_matmul), dev, profiling)
    res.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    drain_counts, err = drain_phase(
        "rwkv6-3b", rcfg, res, dataclasses.replace(
            rcfg, segments=(Segment("rwkv", 2),), num_layers=2),
        dev, drng, report, smi)[:2]
    gar_err = max(gar_err, err)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    zamba_counts, _, res, zcfg = recurrent_phase(
        "zamba2-7b", (Segment("zamba_unit", 1, mamba_per_unit=5),
                      Segment("mamba", 1)),
        (Segment("zamba_unit", 1, mamba_per_unit=1), Segment("mamba", 1)),
        (ssd, lowrank_matmul), dev, profiling)
    res.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    small = (Segment("zamba_unit", 1, mamba_per_unit=1), Segment("mamba", 1))
    zd_counts, err = drain_phase(
        "zamba2-7b", zcfg, res, dataclasses.replace(
            zcfg, segments=small, num_layers=_layer_count(small)),
        dev, drng, report, smi)[:2]
    gar_err = max(gar_err, err)
    for c in (drain_counts, zd_counts):
        counts["gar_matmul"] += c["gar_matmul"]
        counts["sampling"] += c["topk_mask_sample"]
    del res
    counts["wkv6"] = rwkv_counts["wkv6"]
    counts["ssd"] = zamba_counts["ssd"]
    if counts["ssd"] % ssd.LAUNCHES_A_CALL:
        fail(f"zamba2: {counts['ssd']} ssd launches, not a whole number of "
             f"calls of {ssd.LAUNCHES_A_CALL} launches")
    log(f"# zamba2: {counts['ssd']} ssd launches, "
        f"{counts['ssd'] // ssd.LAUNCHES_A_CALL} calls of "
        f"{ssd.LAUNCHES_A_CALL}")
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("7-8 and 13 (a)-(b) rwkv6, zamba2")

    # 9. the pure-decode path on gpt2-small: 8 prompts of 90-159 tokens, 32
    # steps at rows 0 and 6, decode vs mixed
    prompts = [prng.integers(0, cfg.vocab_size, int(prng.integers(90, 160))
                             ).astype(np.int32) for _ in range(8)]
    for k in (gar_matmul, paged_attention):
        k.launches = 0
    counts["paged_attention_decode"], _, _, _ = decode_check(
        cfg, gpt2_rows, prompts, 32, dev, 256)
    counts["gar_matmul"] += gar_matmul.launches
    counts["paged_attention"] += paged_attention.launches
    del gpt2_rows
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("9 decode")

    # 10. gemma3-27b at full width, 2 of 62 layers (every 2nd global)
    gemma_counts, gemma_gar_err = gemma_phase(dev, rng, report, profiling)
    gar_err = max(gar_err, gemma_gar_err)
    counts["gar_matmul"] += gemma_counts["gar_matmul"]
    counts["paged_attention"] += gemma_counts["paged_prefill_attention"]
    counts["paged_attention_decode"] += gemma_counts["paged_attention"]
    counts["sampling"] += gemma_counts["topk_mask_sample"]
    for e in report:
        if e["shape"].startswith("gemma3 mlp"):
            log(kernel_line(e))
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("10 gemma3")

    # 11. speculative decoding of gpt2-small on phase 3's engine: the same
    # requests plain (again, beside the speculative run), then speculative
    plain, _, plain_s = serve_timed(engine, reqs)
    spec_counts, spec11 = spec_phase("gpt2", engine, reqs, plain, plain_s,
                                     0.7, dev, 256)
    counts["gar_matmul"] += spec_counts["gar_matmul"]
    counts["paged_attention"] += spec_counts["paged_prefill_attention"]
    counts["sampling"] += spec_counts["topk_mask_sample"]

    phase_done("11 speculative")

    # 12. the lookahead pipeline and the streaming front door on phase 3's
    # engine and requests
    stream_counts = stream_phase(engine, reqs, results, dev, 256)
    counts["gar_matmul"] += stream_counts["gar_matmul"]
    counts["paged_attention"] += stream_counts["paged_prefill_attention"]
    counts["sampling"] += stream_counts["topk_mask_sample"]

    phase_done("12 stream")

    # 13 (c). gpt2-small through drain on phase 3's engine and requests
    gd_counts = drain_gpt2(engine, reqs, results, dev)
    counts["gar_matmul"] += gd_counts["gar_matmul"]
    counts["sampling"] += gd_counts["topk_mask_sample"]

    phase_done("13 (c) drain gpt2")

    # 14. deepseek-moe-16b (2 of 28 layers: the dense layer 0 and one MoE
    # layer; 3 until the smoke passed 1050 s with phase 20), 20.
    # llama4-scout-17b-a16e (1 of 48 layers, row 0 only) through the
    # continuous engine on phase 3's requests
    for cut, tag in zip(moe_cuts(), ("14 deepseek-moe", "20 llama4")):
        moe_counts, err = moe_phase(cut, dev, rng, report, smi, reqs)
        gar_err = max(gar_err, err)
        counts["gar_matmul"] += moe_counts["gar_matmul"]
        counts["paged_attention"] += moe_counts["paged_prefill_attention"]
        counts["paged_attention_decode"] += moe_counts["paged_attention"]
        counts["sampling"] += moe_counts["topk_mask_sample"]
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(tag)

    # 15. minicpm3-4b (8 of 62 layers) through drain
    mla_counts, err = mla_phase(dev, report, smi)
    gar_err = max(gar_err, err)
    counts["gar_matmul"] += mla_counts["gar_matmul"]
    counts["sampling"] += mla_counts["topk_mask_sample"]

    phase_done("15 minicpm3")

    # 16. seamless-m4t-medium at full width, 6 + 6 of its 12 + 12 layers
    # (cut when the smoke passed 1050 s with phase 18), 17.
    # llama-3.2-vision-11b at full width, one unit: drain, then the
    # multimodal check
    full = get_config("seamless-m4t-medium")
    full = dataclasses.replace(
        full, segments=(Segment("encoder", 6), Segment("decoder", 6)),
        num_layers=6, encoder_layers=6)
    vis = get_config("llama-3.2-vision-11b")
    vis = dataclasses.replace(vis, segments=(Segment("vision_unit", 1),),
                              num_layers=5)
    cuts = {
        "seamless-m4t-medium": (full, dataclasses.replace(
            full, segments=(Segment("encoder", 1), Segment("decoder", 1)),
            num_layers=1, encoder_layers=1)),
        "llama-3.2-vision-11b": (vis, dataclasses.replace(
            vis, segments=(Segment("vision_unit", 1, self_per_unit=1),),
            num_layers=2))}
    for i, (arch, (ccfg, csmall)) in enumerate(cuts.items()):
        cross_counts, err = cross_phase(arch, ccfg, csmall, dev,
                                        np.random.default_rng(16 + i),
                                        report, smi)
        gar_err = max(gar_err, err)
        counts["gar_matmul"] += cross_counts["gar_matmul"]
        counts["sampling"] += cross_counts["topk_mask_sample"]
        phase_done(f"{16 + i} {arch}")

    # 18. the live telemetry plane on phase 3's engine, requests and
    # streams, and phase 11's speculative streams
    tel_counts = telemetry_phase(engine, reqs, results, spec11, 0.7)
    counts["gar_matmul"] += tel_counts["gar_matmul"]
    counts["paged_attention"] += tel_counts["paged_prefill_attention"]
    counts["sampling"] += tel_counts["topk_mask_sample"]

    phase_done("18 telemetry")

    # 22. the dry run's figures (a fake world in this process: run last)
    dryrun_phase(dev, smi)
    phase_done("22 dryrun")

    # numbers, one entry per kernel, at its largest main-path shape
    replaces = {
        "gar_matmul": ("src/repro_torch/kernels/csrc/gar_matmul.cu",
                       "src/repro/kernels/gar_matmul.py:52", gar_err,
                       "mlp/gate budget 0.4 T=72"),
        "lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                           "src/repro/kernels/lowrank_matmul.py:46", lr_err,
                           f"mlp/gate row {last} T=1024"),
        "paged_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:97", dec_err,
            "gemma3 B=8"),
        "paged_prefill_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:164", attn_err, "T=72"),
        "topk_mask_sample": ("src/repro_torch/kernels/csrc/sampling.cu",
                             "src/repro/kernels/sampling.py:110", samp_err,
                             "S=8"),
        "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6_wkv.py:57", wkv_err, "B=8"),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                "src/repro/kernels/mamba2_ssd.py:53", ssd_err, "B=8"),
    }
    module_of = {"gar_matmul": "gar_matmul",
                 "lowrank_matmul": "lowrank_matmul",
                 "paged_attention": "paged_attention_decode",
                 "paged_prefill_attention": "paged_attention",
                 "topk_mask_sample": "sampling", "wkv6": "wkv6",
                 "ssd": "ssd"}
    line = []
    for kname, (src, rep, err, key) in replaces.items():
        e = next(x for x in report
                 if x["kernel"] == kname and x["shape"].startswith(key))
        line.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts[module_of[kname]],
                     "max_abs_err": err, "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                     "bound_by": e["bound_by"],
                     "library_ms": e["library_ms"], "shape": e["shape"]})
    log(f"# smoke: {time.perf_counter() - t_smoke:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
