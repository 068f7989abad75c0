#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (src/repro_torch/kernels/csrc: the GEMM library with its forward
and backward parts and the attention library with its forward, decode and
backward parts and the ABFT checksum lanes' parts, all compiled at once),
then runs sixteen phases, each printing one JSON line (phases 2 and 6 two,
phase 3 three) and raising on failure:

1. device     the card's name and power limit (nvidia-smi) and the build time;
2. kernels    each kernel against its plain PyTorch version at the shapes the
              qwen3-4b server and trainer run, timed beside its bound and
              one PyTorch call of the same function: the SFC fused GEMM
              (K1/K2) at every serve shape (decode M=4, batched prefill
              4 x 128, the LM head), every training-forward shape (2 x 256,
              the GLU in its preact mode) and one ragged case with every
              epilogue flag; the replicated form's partial copies (K4
              plain, K5 batched) and their layer sum (K6) at every serve
              shape at k_layers 1, 2, 4 and 8 (the LM head at 1 and 8; the
              GLU's two products with f32 copies), each timed alone, the
              unfused call (`fuse=False`) as a whole beside K1/K2 and
              torch.matmul of the same product, plus a ragged case of each
              input type with every epilogue flag at k_layers 2, kbf 4 and
              K = 203 (the 64 x 64 tile kernel); each K4 / K5 row names the
              kernel it launched: K4 (4 bf16 rows) the cluster kernel, each
              (tile, layer) task a cluster of L' CTAs over sub-slabs of its
              slab, held against the plain version summed over the same
              L' sub-slabs, K5 the wgmma kernel with its C tile; the NT
              (K7, dA) and TN (K8, dW) kernels at every training shape,
              single and dual, plus a ragged f32 case each;
              K8's update mode (AdamW in the flush, bf16 W stochastically
              rounded) and norm mode at every training shape, in bf16 and
              f32;
              the plain-mode bf16 rows of at most 16 (the decode projections
              and the LM head) launch the cluster kernel, each 64-column C
              tile split over L K slabs inside one launch, and are held
              against the plain version summed over the same L layers; each
              K1/K2 row names the kernel it launched and its L;
              the band flash forward (K11) at the prefill and training shapes
              and at 1 x 2000 with q_offset 0 and 48; the dense flash forward
              (K15); each K11 / K15 row (bf16) on the wgmma kernel with the
              W (q heads of one kv head a CTA) of `fwd_wgmma_grid`, named
              with it; the decode attention (K14, batch x Hkv clusters of S CTAs,
              one a cache segment; its plain version over the same S
              segments) at the serve's cache and at a 4096-row cache; the
              flash backward (K12 dQ, K13 dK/dV) at the training shape and
              at 1 x 2048 tokens (bf16: the wgmma kernels, K13 a cluster of
              CTAs, each a part of the GQA group's q heads, against the
              plain version summing those parts in turn) and a ragged GQA
              f32 case with S != T (the 64 x 64 tile kernels), each row
              naming its kernel and configuration; the
              grouped MoE kernels K3 (forward: GLU with silu in the flush,
              GLU preact, w_out), K9 (dA) and K10 (dW) at every olmoe-1b-7b
              shape (64 experts; decode 32, prefill and training 80 rows an
              expert), timed beside one torch.bmm, and each on ragged
              expert sizes (5, 0, 19, 32) and (80, 0, 45, 130) in f32 and
              bf16, each row naming the CUDA kernel and tile it launched
              (bf16 K3 / K9: the grouped wgmma kernels); K10's update
              mode (per-expert AdamW in the flush, bf16 W stochastically
              rounded) and norm mode at olmoe's two training shapes in
              bf16, timed beside torch.bmm + torch._fused_adamw_, and on
              the ragged sizes in f32 and bf16 (the empty expert's g = 0
              update included);
              the hybrid and xLSTM slices' K2 rows: the chunk_einsum
              products in their batched framing with per-batch B, the SSD
              scores at 4 x 128 and at the 1 x 600 prompt (three 256-step
              chunks), xlstm-1.3b's mLSTM qk block at 4 x 128 and at one
              512-step chunk of the 1 x 600 prompt and a ragged unaligned
              case (K 50, N 70: the tile kernel) in K2's f32-output mode
              (bf16 in, f32 out), a plain-mode A of 4 rows in that mode
              (K1's, the tile kernel; beside torch.mm), the SSD output
              product (bf16) at both prompts and the mLSTM output product
              (f32 in and out, the tile kernel, bound on the f32 peak) at
              both, each against its plain version and timed beside one
              torch.bmm (f32 out for the f32 mode), each batched bf16 one
              with its ABFT lane (in the "abft_lanes" line); K1/K2 at
              zamba2's shared-block shapes (d_model 2048, 32 heads of 64,
              d_ff 8192 GLU; decode M 4 and prefill 4 x 128); the
              encoder-decoder slice's rows: K1/K2 at seamless-m4t-
              medium's shapes (d_model 1024, the gelu MLP of 4096 in the
              flush; decode M 4, the encoder's 4 x 256 frames, the
              decoder's 4 x 128 prompt), K11 non-causal at (4, 256, 256)
              and (4, 128, 256) and causal at (4, 128, 128) with 16 / 16
              heads of 64 (W 1), K14 over the 256-row memory (every row
              valid) and over the decoder's cache; the last configs'
              rows: K1 at qwen2-72b's decode (M 4: q / o, k, v, the GLU
              of 2 x 29568, w_out over K 29568 and the 2.49 GB LM head of
              8192 x 152064) and K2 at its 4 x 128 prefill, the same at
              stablelm-1.6b's widths (d_model 2048, a GLU of 5632, vocab
              100352), K3 at qwen3-moe-30b-a3b's 128 experts (32 rows an
              expert at decode, 40 at the prefill; the GLU of 2 x 768 and
              w_out), K11 at (4, 128, 128) and K14 over the serve's cache
              with 64 / 8 heads of 128 and 32 / 32 heads of 64, each row's
              operands built alone;
              the ABFT checksum lanes ("abft_lanes" line): K1/K2 at every
              K1/K2 shape above and the ragged all-flags case, K3 at
              olmoe's decode, prefill and training shapes and both ragged
              sizes (bf16 the grouped wgmma kernel's lane, over its own
              128-row tiles), K8 dW (single, dual) at every training shape with the
              LM head, K8's update (bf16 stochastically rounded, f32) and
              norm modes at every layer's training shape, each in bf16 and
              f32: the lane within 1e-5 of the sum of |64 x 64 raw tile
              sums| of its plain version's lane (never more than
              robust.abft.tolerance(); a lane of 0, the plain lane less
              its last tile and the ragged case's sum after the epilogue
              must miss that limit), within tolerance() of the
              operand-side reference, the
              outputs with the lane on bitwise those with it off; timed in
              bf16 with the lane on and off beside the operand-side
              reference; a negative control per lane (one exponent bit of
              one element of A flipped after the launch: eager verify
              raises SdcDetected, "strict" in a step scope returns NaN and
              counts one detection) and K8's update with an all-NaN
              gradient (a NaN residual, no detection);
3. grad check full-width qwen3-4b cut to 4 layers, f32, batch 2 x 256: the
              loss and every parameter's gradient under sfc_cuda GEMMs with
              attn_impl="sfc" against the torch backend with blockwise
              attention, within the bf16 bound; every projection weight has
              a non-zero gradient; then the fused optimizer's step (AdamW in
              K8's update flush, exact clip in two phases) against the
              unfused sfc_cuda step from the same init, with a clip that
              binds, for two steps, and a third step whose gradients are
              all NaN, which must leave every weight and state bitwise;
              the same fused check again with both steps under
              BackendConfig(abft="detect"): no detection, the NaN step's
              NaN residuals none;
4. serve      ServingEngine serves full-width qwen3-4b (36 layers, bf16,
              random weights from a seeded torch.Generator), 4 requests,
              prompt 128, 16 new tokens, five times: sfc_cuda GEMMs with
              blockwise attention (exactly 217 x 16 GEMM launches), sfc_cuda
              GEMMs with attn_impl="sfc" (exactly 3,472 GEMM, 36 K11 and 540
              K14 launches, every K11 one on the wgmma kernel), the
              "replicated" backend (exactly 252 K5 and
              3,796 K4 launches, every K5 on the wgmma kernel and every K4
              on the cluster kernel, no K6 and no K1/K2: k_layers is 1 at
              every shape), the same with every product split over 8 K
              layers (as many K4/K5, 4,048 K6), and the torch backend.  The
              attn_impl="sfc" serve again under ABFT "detect" (the prefill
              in abft_mode, ServingEngine(verify_every=1)): 0 detections,
              the same tokens, the same 3,472 K1/K2 launches, every one
              with its checksum lane and checked (3,472 checks), the
              verify ledger, its TTFT and decode gap, the largest
              residual / tolerance; and one serve step (prefill and one
              decode step) on "replicated" split over 8 K layers under
              "detect" (the op-level K4/K5 + K6 checks).  A prefill
              under attn_impl="flash_pallas" must launch K15 36 times, on the
              wgmma kernel; the f32 prefills of "sfc" and "flash_pallas"
              launch K11 and K15 36 times each on the tile kernel.  One
              decode step of sfc_cuda, both replicated serves and torch is
              profiled (device busy time, idle share, GEMM kernel time).  The
              prefill logits of the same weights in f32 must agree with the
              torch backend's within the bf16 bound for each SFC variant,
              and each variant's bf16 logits must be as close to that f32
              model as the torch backend's are;
5. train      `launch.train.build_trainer` trains full-width qwen3-4b (36
              layers, bf16, AdamW on f32 master weights) for 3 steps of
              2 x 256 SyntheticLM tokens under sfc_cuda + attn_impl="sfc",
              with exactly 217 K1/K2, 217 K7, 217 K8, 36 K11, 36 K12 and 36
              K13 launches per step (every K11, K12 and K13 one on the wgmma
              kernels; the f32 gradient check's on the tile kernels), then
              the same 3 steps from the same
              init under torch + blockwise: every loss finite and within
              2^-7 of the torch backend's, every parameter changed; step
              times and peak memory, and a fourth step of each run under
              torch.profiler for its device-busy time by kernel group.  A
              third run, between them, trains the same 3 steps with
              fused_optimizer=True (K8 in its norm and update modes, exactly
              217 of each and no dW launch per step, no weight left with a
              .grad), its losses within 2^-7 of the unfused run's; and both
              again under BackendConfig(abft="detect") (no profiled step):
              the same launches a step, 217 K1/K2 and 217 (fused: 434) K8
              launches with the lane, 0 detections, losses within 2^-7 of
              the runs without ABFT (bitwise or not is reported), step
              times and peak memory, the largest residual / tolerance;
6. grad check olmoe-1b-7b at full width cut to 2 layers, f32, as phase 3:
              the router and the expert stacks through K3, K9 and K10
              (K3 and K9 on their 64 x 64 tile kernels only);
              then its fused step as phase 3's (K8's modes for q, k, v, o
              and the head, K10's for the expert stacks; the router, as in
              the JAX package, unrouted), with the NaN step;
7. serve      ServingEngine serves full-width, full-depth olmoe-1b-7b (16
              layers, 64 experts top-8, bf16, seeded random weights), 4
              requests, prompt 128, 16 new tokens: sfc_cuda GEMMs with
              blockwise attention and with attn_impl="sfc" (exactly 512 K3
              launches, all on the grouped wgmma kernel, and 1,296 K1/K2;
              16 K11, all on the wgmma kernel at W 1, and 240 K14 with
              "sfc"), and the torch backend; the
              f32 prefill logits of the same weights cut to 4 layers within
              the bf16 bound of the torch backend's (its 32 K3 launches on
              the tile kernel);
              where the bf16 greedy tokens part from torch's, the routing
              of both backends at that step (top-k sets that differ, the
              router's probability gap of the swapped experts); the
              sfc_cuda serve again under ABFT "detect" (verify_every=1):
              0 detections, tokens identical, 512 K3 and 1,296 K1/K2
              launches, every one with its lane;
8. train      `build_trainer` trains olmoe-1b-7b at full width on 8 of its 16
              layers (AdamW's 16 B a parameter: 57 GB) for 3 steps of 2 x 256
              tokens under sfc_cuda + attn_impl="sfc" (exactly 16 K3, 16 K9,
              16 K10 and 41 each of K1/K2, K7, K8 a step, K3 and K9 on the
              grouped wgmma kernels), the same steps with
              fused_optimizer=True (16 K10 norm and 16 update launches, 33
              K8 norm and 33 update, the router's 8 K8 dW, no K10 dW a step;
              no weight left with a .grad; losses within 2^-7 of the unfused
              run's), then under torch + blockwise from the same init:
              losses within 2^-7, every parameter moved, a profiled fourth
              step of each (K8's and K10's norm and update modes as groups
              of their own);
9. serve     ServingEngine serves full-width, full-depth zamba2-1.2b (38
              Mamba2 layers, the shared attention block after every 6,
              d_model 2048, vocab 32000, SSM state 64, SSD heads of 64,
              chunk 256, bf16, seeded random weights), 4 requests x 128 +
              16 tokens under sfc_cuda with blockwise and with "sfc"
              attention and under torch, and one 600-token prompt + 8 under
              sfc_cuda + "sfc" and torch: exactly 2 x 38 chunk_einsum K2
              launches a prefill (the 38 SSD scores in the f32-output mode,
              on its wgmma kernel), 6 K1/K2 a shared-block application (6
              a forward) and 6 K11 a prefill and 6 K14 a decode step under
              "sfc"; no K1/K2 under torch; the f32 prefill logits of each
              sfc_cuda serve within the bf16 bound of torch's, the bf16
              ones at accuracy parity; the parameter count, peak memory,
              TTFT, the p50 per-token gap, tokens/s and a profiled decode
              step;
10. serve    ServingEngine serves full-width, full-depth xlstm-1.3b (48
              blocks: 6 groups of 7 mLSTM blocks and an sLSTM block,
              d_model 2048, 4 heads of 1024, chunk 512, bf16, seeded random
              weights, 3.53 B parameters), 4 x 128 + 16 and 1 x 600 + 8
              (two chunks, the second padded), each under sfc_cuda and
              torch: exactly 2 x 42 K2 launches a prefill chunk (42 qk
              scores in the f32-output mode on its wgmma kernel, 42 output
              products in f32 on the tile kernel), none a decode step and
              none under torch; the f32 prefill logits of a cut to one
              group (8 blocks) within the bf16 bound of torch's at both
              prompts, its bf16 ones at accuracy parity; the parameter
              count, peak memory, TTFT, the p50 gap, tokens/s and a
              profiled decode step;
11. enc-dec  seamless-m4t-medium at full width and depth (12 + 12 layers,
              d_model 1024, 16 / 16 heads of 64, a gelu MLP of 4096, vocab
              256206, bf16, seeded weights, 0.88 B parameters): 4 x 256
              stub frame embeddings encoded, a 4 x 128 prompt prefilled
              and 16 tokens decoded greedily through EncDecLM under
              sfc_cuda with "sfc" and blockwise attention and under torch:
              exactly 72 K1/K2 and 12 non-causal K11 an encode, 216 K1/K2
              and 36 K11 a prefill (which encodes again), 96 K1/K2 on the
              cluster kernel and 24 K14 a decode step; the f32 prefill
              logits within the bf16 bound of torch's, the bf16 ones at
              accuracy parity; encode time, TTFT, the p50 gap, tokens/s;
12. vlm      qwen2-vl-72b at full width (d_model 8192, 64 / 8 heads of
              128, qkv bias, a GLU of 29568, vocab 152064, M-RoPE sections
              (16, 24, 24), theta 1e6) cut to 16 of its 80 layers (bf16,
              seeded weights, 16.5 B parameters; all 80 would be 145 GB):
              ServingEngine serves 4 x 128 + 16 as text under sfc_cuda with
              "sfc" and blockwise attention and under torch; the M-RoPE
              path (DecoderLM.prefill with 64 stub patch embeddings on an
              8 x 8 grid, positions (0, row, column) and the text's from 8
              on all three axes, then 16 greedy decode_steps at explicit
              (3, B, 1) positions) under sfc_cuda + "sfc" and torch;
              qwen2-72b served on the same weights under sfc_cuda + "sfc"
              and torch, its tokens and prefill logits bitwise the VLM's
              text-only serve's; exactly 6 K1/K2 a layer a forward and the
              head (the prefill's on the wgmma kernel, the rest on the
              cluster kernel), 16 K11 a prefill and 16 K14 a decode step
              under "sfc"; a 2-layer cut with the vision rows and M-RoPE:
              f32 prefill logits within the bf16 bound of torch's, bf16 at
              accuracy parity; peak memory, TTFT, the p50 gap, tokens/s and
              a profiled decode step;
13. moe128   qwen3-moe-30b-a3b at full width and depth (48 layers,
              d_model 2048, 32 / 4 heads of 128, qk-norm, 128 experts of
              768, top-8, bf16, seeded weights): 4 x 128 + 16 under
              sfc_cuda + "sfc" and torch, exactly 2 K3 a layer a forward
              (on the grouped wgmma kernel), 5 K1/K2 a layer and the head,
              48 K11 a prefill and 48 K14 a step; where the greedy tokens
              part from torch's, the routing at that step; the bf16 model
              freed, a 4-layer f32 cut's prefill logits within the bf16
              bound of torch's (its K3 on the tile kernel);
14. stablelm stablelm-1.6b at full width and depth (24 layers, LayerNorm,
              25% rotary, 32 / 32 heads of 64, bf16, seeded weights): 4 x
              128 + 16 under sfc_cuda with "sfc" and blockwise attention
              and under torch, exact launches; f32 prefill logits at full
              depth within the bf16 bound of torch's, bf16 at parity;
15. tune     qwen3-4b at full width and depth under sfc_cuda with "sfc"
              attention on a tune cache of its own: calibrate() (the fitted
              constants and their error), warmup(128, tune=True,
              tune_update=True) (every namespace keyed by the rows its
              launch runs: the rule's and the winner's launch and time,
              predicted against measured), a second warmup measuring
              nothing, the 4 x 128 + 16 serve and a fused and an unfused
              4 x 128 training step on the tuned cache against the same on
              an empty one (tokens bitwise or at parity, losses within
              2^-7); every tuned bucket launched there, and every shape
              launched in one held against its plain version;
4b. heal    right after the serve, on its weights (`phase_heal`): the
              fallback ladder healing a compile fault on the sfc_cuda rung
              of gemm and glu (launches and tokens those of the
              "replicated" serve), every kernel rung faulted (the torch
              rung, no SFC launch, logits at parity), a transient bitflip
              retried on the same rung under ABFT "detect" (tokens
              bitwise), an injected detection in the last verified decode
              step redone on the healed rungs (in f32, within twice
              the f32 bound, its quarantines marked injected); TrainLoop on a 2-layer cut: 6 fused steps of 2 x
              256, checkpoints every 2, a preemption at 4, a resume from
              other weights bitwise the uninterrupted run, an injected
              detection rolling back to 4; the seconds and GB of each save
              and restore; the ladder's host µs a call;
16. the {"kernels": [...]} line: per kernel and shape, launches in the run
              of its path (serve or train), max error, kernel / plain /
              library times and the bound (K1/K2 and K4/K5 rows: the kernel
              launched and its K layers, L' or tile; K11 / K15 rows: the
              kernel and its W; K14 rows: the segments); the lane rows (K1/K2, K3, K8 dW, update, norm
              with the lane) carry the launches of the ABFT
              run of their path, the time with the lane off, the operand
              reference's time and the partials their bound adds; before
              it, the seconds at which each phase began, the build's and
              the run's total.

The whole run is strict (``REPRO_STRICT=1``, on top of the card's
default, so no ``REPRO_ALLOW_FALLBACK`` in the caller's environment
loosens it): a fallback that was not injected raises, and before every phase the ladder's ledger must show no
fallback and no quarantine (the "strict" part of the clock line), so a
kernel that fails to build or launch fails the run.  ``--heal-only`` runs
phases 1, 4 and 4b alone and prints no result line.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository's src/repro_torch beside this file, it exits non-zero
and prints no result.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path
from typing import Optional

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel row
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20

# stated tolerances (kernel against its plain version, both f32-accumulated
# in different orders): f32 inputs at rtol 1e-4 (plus 1e-5 of the largest
# |value| for sums that cancel to near zero); bf16 inputs within one output
# rounding: |k - p| <= 2^-7 |p| + 1e-3 max|p|
F32_RTOL, F32_ATOL_REL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL_REL = 2.0**-7, 1e-3

PROMPT, NEW_TOKENS, BATCH = 128, 16, 4
# the trainer: 2 sequences of 256 tokens, 3 AdamW steps; the f32 gradient
# check cuts the model to 4 layers (full width)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 256, 3
GRAD_CHECK_LAYERS = 4
# a training loss may differ from the torch backend's by one bf16 rounding
TRAIN_LOSS_RTOL = 2.0**-7
# the fused-step check: a clip far under the gradient norm, so it binds
FUSED_CHECK_CLIP = 1e-3

# bf16 serving: the sfc_cuda prefill logits may be at most this many times
# further (mean |error|) from the same model run in f32 than the torch
# backend's bf16 logits are
ACCURACY_PARITY = 1.25

# olmoe-1b-7b (the MoE slice): served at full width and depth; trained at
# full width on 8 of its 16 layers (AdamW holds 16 B a parameter: 16 layers
# would need 111 GB); its f32 checks cut the depth further
MOE_ARCH = "olmoe_1b_7b"
MOE_TRAIN_LAYERS = 8
MOE_CHECK_LAYERS = 2  # the f32 gradient check
MOE_SERVE_F32_LAYERS = 4  # the f32 prefill-logits check
# expert row counts of the ragged checks: one expert empty, none a whole tile
RAGGED_GROUPS = (5, 0, 19, 32)
# and one expert over a 128-row tile of the wgmma kernels (K3, K9)
RAGGED_GROUPS_LONG = (80, 0, 45, 130)

# the replicated form (split-K): the K layers of phase 2's rows (the LM head
# at two of them), and those of the second "replicated" serve
REP_LAYERS = (1, 2, 4, 8)
REP_HEAD_LAYERS = (1, 8)
REP_SERVE_LAYERS = 8

# zamba2-1.2b (the hybrid slice): served at full width and depth, 4 x
# PROMPT + NEW_TOKENS, and one prompt of HYBRID_LONG_PROMPT tokens (three
# 256-step SSD chunks, the last padded) + HYBRID_LONG_NEW
HYBRID_ARCH = "zamba2_1_2b"
HYBRID_LONG_PROMPT, HYBRID_LONG_NEW = 600, 8

# xlstm-1.3b (the xLSTM slice): served at full width and depth as zamba2
# is (4 x PROMPT + NEW_TOKENS; one HYBRID_LONG_PROMPT prompt, two 512-step
# chunks, the second padded); its f32 check on a cut to one group of blocks
XLSTM_ARCH = "xlstm_1_3b"
XLSTM_CHECK_LAYERS = 8

# seamless-m4t-medium (the encoder-decoder slice): ENCDEC_FRAMES stub frame
# embeddings a request encoded, a PROMPT-token decoder prompt, NEW_TOKENS
# decoded greedily
ENCDEC_ARCH = "seamless_m4t_medium"
ENCDEC_FRAMES = 256

# qwen2-vl-72b and qwen2-72b (one tree: the VLM slice): full width cut to
# VLM_LAYERS of their 80 layers (bf16, 16.5 B parameters, 33.1 GB; all 80
# would be 145 GB, more than the card holds); the M-RoPE path's stub image
# of VLM_GRID patches on the leading rows; its f32 check on a cut to
# VLM_CHECK_LAYERS layers
VLM_ARCH, DENSE72_ARCH = "qwen2_vl_72b", "qwen2_72b"
VLM_LAYERS, VLM_CHECK_LAYERS = 16, 2
VLM_GRID = (8, 8)
# qwen3-moe-30b-a3b: full width and depth (30.5 B parameters, 61.1 GB in
# bf16); its f32 check on a cut to MOE128_CHECK_LAYERS layers
MOE128_ARCH = "qwen3_moe_30b_a3b"
MOE128_LAYERS, MOE128_CHECK_LAYERS = 48, 4
# stablelm-1.6b: full width and depth, its f32 check too
STABLELM_ARCH = "stablelm_1_6b"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def within(got, want, dtype):
    """(ok, max_abs_err, worst err/bound) under the stated tolerance."""
    import torch

    g, p = got.float(), want.float()
    err = (g - p).abs()
    mag = p.abs()
    if dtype == torch.float32:
        bound = F32_RTOL * mag + F32_ATOL_REL * mag.max()
    else:
        bound = BF16_RTOL * mag + BF16_ATOL_REL * mag.max()
    ok = bool(torch.isfinite(g).all()) and bool((err <= bound).all())
    worst = float((err / bound.clamp_min(1e-30)).max())
    return ok, float(err.max()), worst


def within_all(got, want, dtype):
    """`within` over a tensor or over matching tuples of tensors."""
    if not isinstance(got, (tuple, list)):
        return within(got, want, dtype)
    res = [within(g, w, dtype) for g, w in zip(got, want)]
    return all(r[0] for r in res), max(r[1] for r in res), max(r[2] for r in res)


def launched(counter, fn):
    """(fn(), the one key of ``counter`` that the call added to): which
    kernel (and split) a wrapper launched."""
    before = collections.Counter(counter)
    out = fn()
    (key,) = collections.Counter(counter) - before
    return out, key


def by_kernel(counter) -> dict:
    """A wrapper's ``launches_by_kernel`` summed by CUDA kernel name."""
    out = collections.Counter()
    for (name, _), n in counter.items():
        out[name] += n
    return dict(out)


def plain_layers(name, config) -> int:
    """The K layers a plain version sums over to follow a launch: the
    cluster kernel's L, else one."""
    return config if name == "sfc_gemm_cluster_kernel" else 1


# the kernel each bf16 product of the replicated serve launches: K4 (4
# rows) the cluster kernel, K5 (4 x 128 rows) the wgmma kernel
REP_ROUTES = {"K4": "sfc_gemm_replicated_cluster_kernel", "K5": "sfc_gemm_replicated_wgmma_kernel"}


def rep_split(name, config) -> int:
    """The sub-slabs a layer's copy sums over in the replicated plain
    version to follow a launch: the cluster kernel's L', else one."""
    return config if name == "sfc_gemm_replicated_cluster_kernel" else 1


WGMMA_SOURCE = "src/repro_torch/kernels/csrc/sfc_gemm_wgmma.cuh"
GEMM_SOURCE = "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu"


def kernel_source(name: str) -> str:
    """The file in the repository that holds a GEMM kernel: the wgmma
    header's K2 and K7; the TN wgmma kernels (K8, K10) and their flush are
    sfc_gemm_fused.cu's, over the header's main loop."""
    return WGMMA_SOURCE if "wgmma" in name and "tn_" not in name else GEMM_SOURCE


def time_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of fn(i) over reps calls, by CUDA events, with
    ``graph`` one replay of a CUDA graph of the reps calls: the package's
    `repro_torch.tune.timing.time_ms`, which the tuner times its
    candidates with."""
    from repro_torch.tune.timing import time_ms as timed

    return timed(fn, reps, warmup, graph)


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One GEMM of the main path: (batch, M) rows against (K, N) weights."""

    name: str
    mode: str  # "decode" (plain kernel mode) | "prefill" | "train" (batched mode)
    batch: int  # 0 = plain mode
    m: int
    k: int
    n: int
    glu: bool = False
    preact: bool = False  # the training forward's GLU: both pre-activations out
    act: Optional[str] = None  # the activation in the flush of a product that is not a GLU

    @property
    def path(self) -> str:
        return "train" if self.mode == "train" else "serve"

    @property
    def key(self):
        return (self.batch, self.m, self.k, self.n, self.glu)

    @property
    def rows(self) -> int:
        return max(self.batch, 1) * self.m

    def flops(self) -> float:
        return 2.0 * self.rows * self.k * self.n * (2 if self.glu else 1)

    def bytes(self, elem: int) -> float:
        outs = 2 if self.preact else 1
        return elem * (self.rows * self.k + self.k * self.n * (2 if self.glu else 1) + outs * self.rows * self.n)

    def bound(self, elem: int, peak_flops: float):
        return _bound(self.flops(), self.bytes(elem), peak_flops)


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, what bounds it) over the H100 SXM peaks."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _projections(cfg):
    """(name, K, N, glu) of each projection of a layer, forward (M, K) @ (K, N)."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim_
    kv = cfg.kv_heads * cfg.head_dim_
    return [("q", d, q, False), ("k,v", d, kv, False), ("o", q, d, False),
            ("mlp_glu", d, cfg.d_ff, True), ("mlp_out", cfg.d_ff, d, False)]


def main_path_gemms(cfg):
    """Every distinct forward GEMM the server and the trainer launch for
    this config: the decode step's (M = batch rows, flattened) and the
    batched prefill's, plus the LM head on the last position (plain mode in
    both phases); the training forward's, batched over 2 x 256 tokens, the
    GLU in its preact mode and the LM head on every position."""
    proj = _projections(cfg)
    d = cfg.d_model
    out = [Gemm(f"decode/{n}", "decode", 0, BATCH, k, nn, g) for n, k, nn, g in proj]
    out.append(Gemm("head", "decode", 0, BATCH, d, cfg.vocab))
    out += [Gemm(f"prefill/{n}", "prefill", BATCH, PROMPT, k, nn, g) for n, k, nn, g in proj]
    out += [Gemm(f"train/{n}", "train", TRAIN_BATCH, TRAIN_SEQ, k, nn, g, preact=g) for n, k, nn, g in proj]
    out.append(Gemm("train/head", "train", TRAIN_BATCH, TRAIN_SEQ, d, cfg.vocab))
    return out


@dataclasses.dataclass(frozen=True)
class BwdGemm:
    """One backward GEMM of the training step for the forward projection
    (M, K) @ (K, N): K7 ("nt", dA (M, K) = dC (M, N) W (K, N)^T) or K8
    ("tn", dW (K, N) = A (M, K)^T dC (M, N)); dual for the GLU."""

    name: str
    kind: str
    m: int
    k: int
    n: int
    dual: bool = False

    @property
    def key(self):  # the launches_by_shape key of sfc_gemm_nt / sfc_gemm_tn
        return (self.m, self.k, self.n, self.dual) if self.kind == "nt" else (self.k, self.n, self.m, self.dual)

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * (2 if self.dual else 1)

    def bytes(self, elem: int) -> float:
        pairs = 2 if self.dual else 1
        if self.kind == "nt":  # dC and W (twice when dual) in, dA out
            return elem * (pairs * (self.m * self.n + self.k * self.n) + self.m * self.k)
        return elem * (self.m * self.k + pairs * (self.m * self.n + self.k * self.n))  # A, dC in; dW out


def train_backward_gemms(cfg):
    """K7 and K8 at every projection of the training step (2 x 256 token
    rows), the LM head included."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    proj = _projections(cfg) + [("head", cfg.d_model, cfg.vocab, False)]
    return [BwdGemm(f"train/{name}", kind, rows, k, n, glu) for kind in ("nt", "tn") for name, k, n, glu in proj]


@dataclasses.dataclass(frozen=True)
class Attn:
    """One attention launch: a flash forward over (b, s) queries against
    (b, t) keys, or a decode step against a t-row cache with live lengths
    ``valid``."""

    name: str
    kernel: str  # "sfc_flash_fwd" (K11) | "flash_attention" (K15) | "sfc_decode_attention" (K14)
    b: int
    s: int
    t: int
    h: int
    hkv: int
    d: int
    causal: bool = True
    q_offset: int = 0
    valid: tuple = ()
    main_path: bool = True
    path: str = "serve"  # the run whose launches the row reports

    @property
    def decode(self) -> bool:
        return self.kernel == "sfc_decode_attention"

    def pairs(self) -> int:
        """(query, key) pairs attended over the batch and q heads: what
        these inputs need, not the padded tiles."""
        if self.decode:
            return sum(self.valid) * self.h
        if not self.causal:
            return self.b * self.h * self.s * self.t
        return self.b * self.h * sum(min(i + self.q_offset + 1, self.t) for i in range(self.s))

    def bytes(self, elem: int) -> float:
        """Each input read once and each output written once: q, the keys and
        values (the live cache rows for decode), o, and the f32 lse of K11."""
        if self.decode:
            return elem * (2 * self.b * self.h * self.d + 2 * sum(self.valid) * self.hkv * self.d) + 4 * self.b
        qo = 2 * self.b * self.s * self.h * self.d
        lse = 4 * self.b * self.s * self.h if self.kernel == "sfc_flash_fwd" else 0
        return elem * (qo + 2 * self.b * self.t * self.hkv * self.d) + lse

    def bound(self, elem: int):
        return _bound(4.0 * self.d * self.pairs(), self.bytes(elem))

    @property
    def key(self):  # the flash wrappers' launches_by_shape key (sfc_attention.shape_key)
        return (self.b, self.s, self.t, self.h, self.hkv, self.d, self.causal)

    def shape(self) -> dict:
        out = {"b": self.b, "s": self.s, "t": self.t, "h": self.h, "hkv": self.hkv, "d": self.d}
        out.update({"valid": list(self.valid)} if self.decode else {"causal": self.causal, "q_offset": self.q_offset})
        return out


def attention_cases(cfg):
    """The attention launches of the main paths (the serve's prefill and
    decode) and two long ragged checks of each kernel family."""
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_)
    cache = PROMPT + NEW_TOKENS + 1
    return [
        Attn("prefill", "sfc_flash_fwd", BATCH, PROMPT, PROMPT, **heads),
        Attn("train", "sfc_flash_fwd", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, path="train", **heads),
        Attn("long_1x2000", "sfc_flash_fwd", 1, 2000, 2000, main_path=False, **heads),
        Attn("long_1x2000_q_offset_48", "sfc_flash_fwd", 1, 2000, 2048, q_offset=48, main_path=False, **heads),
        Attn("prefill", "flash_attention", BATCH, PROMPT, PROMPT, **heads),
        Attn("decode", "sfc_decode_attention", BATCH, 1, cache, valid=(129, 134, 139, 144), **heads),
        Attn("long_cache_4096", "sfc_decode_attention", BATCH, 1, 4096, valid=(1, 1000, 2048, 4096),
             main_path=False, **heads),
    ]


def phase_attention(torch, cases, tsa, tfa, build):
    """Attention kernels against their plain versions, timed beside their
    bound and scaled_dot_product_attention (a yardstick the port never
    calls)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    dt = torch.bfloat16
    qc, kc = tsa.kernel_chunks()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, checks = [], []
    for c in cases:
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
        # enough copies that a timed loop streams its inputs from HBM
        copies = max(1, math.ceil(4 * L2_BYTES / c.bytes(2)))
        ins = [(r(c.b, c.s, c.h, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.t, c.hkv, c.d)) for _ in range(copies)]
        mask = None
        if c.decode:
            valid = torch.tensor(c.valid, dtype=torch.int32, device=dev)
            mask = (torch.arange(c.t, device=dev)[None, :] < valid[:, None])[:, None, None, :]

            splits = tsa.decode_splits(c.b, c.hkv, c.t, sms)

            def kernel(i):
                return tsa.sfc_decode_attention(*ins[i % copies], valid)

            def plain(i):
                return tsa.sfc_decode_attention_plain(*ins[i % copies], valid, k_chunk=build.DECODE_CHUNK,
                                                      splits=splits)
        elif c.kernel == "sfc_flash_fwd":
            kw = dict(causal=c.causal, q_offset=c.q_offset)

            def kernel(i):
                return tsa.sfc_flash_fwd(*ins[i % copies], **kw)

            def plain(i):
                return tsa.sfc_flash_fwd_plain(*ins[i % copies], q_chunk=qc, k_chunk=kc, **kw)
        else:
            def kernel(i):
                return tfa.flash_attention(*ins[i % copies], causal=c.causal)

            def plain(i):
                return tfa.flash_attention_plain(*ins[i % copies], causal=c.causal, q_chunk=qc, k_chunk=kc)
        if not c.decode and c.causal and (c.q_offset or c.s != c.t):
            qpos = torch.arange(c.s, device=dev)[:, None] + c.q_offset
            mask = torch.arange(c.t, device=dev)[None, :] <= qpos
        views = [tuple(x.transpose(1, 2) for x in trio) for trio in ins]
        causal_flag = not c.decode and c.causal and mask is None
        library = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            *views[i % copies], attn_mask=mask, is_causal=causal_flag, enable_gqa=True)
        if c.decode:
            got, launched_splits = launched(tsa.sfc_decode_attention.launches_by_splits, lambda: kernel(0))
            if launched_splits != splits:
                raise AssertionError(f"decode launched {launched_splits} segments, its plain version {splits}")
            route = None
        else:
            # every bf16 K11 / K15 row on the wgmma kernel, with the W of
            # `fwd_wgmma_grid` (q heads of one kv head a CTA) on this card
            wrapper = tsa.sfc_flash_fwd if c.kernel == "sfc_flash_fwd" else tfa.flash_attention
            got, route = launched(wrapper.launches_by_kernel, lambda: kernel(0))
            want_route = ("flash_fwd_wgmma_kernel", tsa.fwd_wgmma_grid(c.b, c.s, c.t, c.h, c.hkv, sms)[1])
            if route != want_route:
                raise AssertionError(f"{c.kernel} at {c} launched {route}, expected {want_route}")
        want, plain_ms = _once_ms(torch, lambda: plain(0))
        if c.kernel == "sfc_flash_fwd":
            (got, got_lse), (want, want_lse) = got, want
            ok_lse, err_lse, worst_lse = within(got_lse, want_lse, torch.float32)
        else:
            ok_lse, err_lse, worst_lse = True, 0.0, 0.0
        ok, err, worst = within(got, want, dt)
        checks.append({"case": f"{c.kernel}:{c.name}", "shape": c.shape(), "ok": ok and ok_lse, "max_abs_err": err,
                       "err_over_bound": worst, "lse_max_abs_err": err_lse, "lse_err_over_bound": worst_lse,
                       **({"kernel": route[0], "config": route[1]} if route else {})})
        if not (ok and ok_lse):
            raise AssertionError(f"{c.kernel} disagrees with its plain version at {c}: max err {err} "
                                 f"(err/bound {worst}), lse max err {err_lse} (err/bound {worst_lse})")
        reps = max(20, copies)
        ms = time_ms(kernel, reps=reps, graph=True)
        lib_ms = time_ms(library, reps=reps, graph=True)
        bound_ms, bound_by = c.bound(2)
        rows.append(dict(case=c, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         **({"splits": splits} if c.decode else {"kernel": route[0], "config": route[1]})))
        del ins, views
    return rows, checks


def phase_kernels(torch, cfg, gemms, tk, ops, ragged=True):
    """Kernel against plain version at the main path's shapes, timed; with
    ``ragged`` also the ragged cases with every epilogue flag."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    rows = []
    checks = []
    for gm in gemms:
        lead = (gm.batch,) if gm.batch else ()
        a = torch.randn((*lead, gm.m, gm.k), generator=gen, device=dev).to(dt)
        # enough weight copies that a timed loop streams them from HBM, as
        # the 8.8 GB model does, instead of finding them in the 50 MB L2
        w_bytes = gm.k * gm.n * 2 * (2 if gm.glu else 1)
        copies = max(1, math.ceil(4 * L2_BYTES / w_bytes))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)] if gm.glu else None
        # the serve's GLU applies its activation in the flush; the training
        # forward's (preact) flushes both pre-activations
        kw = dict(preact=True) if gm.preact else dict(activation=cfg.act if gm.glu else gm.act)

        def kernel(i):
            return tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None, **kw)

        bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)
        # which kernel the wrapper takes: the cluster kernel (M <= 16), its
        # plain version summed over the same K layers, the wgmma kernel (bf16
        # rows TMA can describe) with its C tile, or the tile kernel
        got, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: kernel(0))
        layers = plain_layers(name, config)

        def plain(i):
            return tk.sfc_gemm_fused_plain(a, ws[i % copies], gs[i % copies] if gs else None, bm=bm, bn=bn,
                                           k_layers=layers, **kw)

        want, plain_ms = _once_ms(torch, lambda: plain(0))
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": gm.name, "shape": [gm.batch, gm.m, gm.k, gm.n], "glu": gm.glu, "preact": gm.preact,
                       "kernel": name, "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at {gm}: max err {err}, err/bound {worst}")
        if gm.glu:
            cats = [torch.cat([g, w], dim=1) for g, w in zip(gs, ws)]
            library = lambda i: torch.matmul(a, cats[i % copies])  # noqa: E731
        else:
            library = lambda i: torch.matmul(a, ws[i % copies])  # noqa: E731
        ms = time_ms(kernel, reps=max(20, copies), graph=True)
        lib_ms = time_ms(library, reps=max(20, copies), graph=True)
        bound_ms, bound_by = gm.bound(2, PEAK_BF16_FLOPS)
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
        del ws, gs, a
        if gm.glu:
            del cats
    # ragged cases with every epilogue flag: K 203 in both input types (rows
    # TMA cannot describe: the tile kernel), and K 264 / N 328 in bf16 (the
    # wgmma kernel, whose TMA boxes run past every edge)
    for dtype, (m, k, n) in ((torch.float32, (77, 203, 133)), (torch.bfloat16, (77, 203, 133)),
                             (torch.bfloat16, (77, 264, 328))) if ragged else ():
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        args = (r(3, m, k), r(k, n) * 0.1, r(k, n) * 0.1, r(n), r(1, n), r(3, m, n))
        kw = dict(activation="gelu", out_scale=0.7)
        got, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tk.sfc_gemm_fused(*args, **kw))
        torch.cuda.synchronize()
        ok, err, worst = within(got, tk.sfc_gemm_fused_plain(*args, bm=32, bn=32, **kw), dtype)
        checks.append({"case": "all_epilogue_flags_ragged", "dtype": str(dtype), "shape": [3, m, k, n],
                       "kernel": name, "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
        if not ok or (name == "sfc_gemm_wgmma_kernel") != (k % 8 == 0 and dtype == torch.bfloat16):
            raise AssertionError(f"all-flags ragged case ({dtype}, K {k}) on {name} disagrees: max err {err}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class RepGemm:
    """One product of the replicated form at a serve shape: (batch, M) rows
    against (K, N) weights, split over ``layers`` K slabs into partial
    copies (K4, K5 batched) that K6 sums; the unfused GLU is two such
    products with f32 copies."""

    name: str
    batch: int  # 0 = plain mode (K4)
    m: int
    k: int
    n: int
    layers: int
    glu: bool = False

    @property
    def kernel(self) -> str:
        return "K5" if self.batch else "K4"

    @property
    def key(self):  # sfc_gemm_replicated.launches_by_shape
        return (self.batch, self.m, self.k, self.n, self.layers)

    @property
    def reduce_key(self):  # add_reduce.launches_by_shape
        return (self.batch, self.layers, self.m, self.n)

    @property
    def rows(self) -> int:
        return max(self.batch, 1) * self.m

    @property
    def copy_elem(self) -> int:
        return 4 if self.glu else 2

    def bound(self):
        """One K4/K5 launch: A and B read once, the L copies written once."""
        nbytes = 2 * (self.rows * self.k + self.k * self.n) + self.copy_elem * self.layers * self.rows * self.n
        return _bound(2.0 * self.rows * self.k * self.n, nbytes)

    def reduce_bound(self):
        """One K6 launch: the L copies read once, C written once."""
        return _bound(float((self.layers - 1) * self.rows * self.n),
                      self.copy_elem * (self.layers + 1) * self.rows * self.n, PEAK_F32_FLOPS)

    def shape(self) -> dict:
        return {"batch": self.batch, "m": self.m, "k": self.k, "n": self.n, "k_layers": self.layers,
                "glu": self.glu, "copies": "float32" if self.glu else "bfloat16"}


def replicated_gemms(cfg):
    """Every product the "replicated" serve launches (decode M = 4 in the
    plain mode, prefill 4 x 128 batched; the GLU's two products as one
    row), at each k_layers of REP_LAYERS, and the LM head at 1 and 8."""
    out = []
    for mode, batch, m in (("decode", 0, BATCH), ("prefill", BATCH, PROMPT)):
        for name, k, n, glu in _projections(cfg):
            out += [RepGemm(f"{mode}/{name}", batch, m, k, n, layers, glu) for layers in REP_LAYERS]
    out += [RepGemm("head", 0, BATCH, cfg.d_model, cfg.vocab, layers) for layers in REP_HEAD_LAYERS]
    return out


def phase_replicated(torch, cfg, gemms, tk, ops):
    """K4/K5 (the partial copies) and K6 (their sum) against their plain
    versions at every serve shape and k_layers, and the public unfused call
    (``ops.sfc_matmul`` / ``sfc_glu_matmul`` with ``fuse=False``) against
    the plain versions' composition; each timed alone and the call as a
    whole, beside the fused K1/K2 and torch.matmul of the same product.
    Then a ragged case of each input type with every epilogue flag at
    k_layers 2, kbf 4 and K = 203 (split 104 + 99, not ceil's 102 + 101),
    on the card against the same call on the CPU."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    dt = torch.bfloat16
    rows, checks = [], []

    def check(case, got, want, tol_dtype, **extra):
        ok, err, worst = within_all(got, want, tol_dtype)
        checks.append({"case": case, "ok": ok, "max_abs_err": err, "err_over_bound": worst, **extra})
        if not ok:
            raise AssertionError(f"{case} disagrees with its plain version: max err {err}, err/bound {worst}")
        return err

    for gm in gemms:
        lead = (gm.batch,) if gm.batch else ()
        kl, cdt = gm.layers, (torch.float32 if gm.glu else dt)
        a = torch.randn((*lead, gm.m, gm.k), generator=gen, device=dev).to(dt)
        # weight copies past the 50 MB L2, as phase 2's K1/K2 rows stream them
        copies = max(1, math.ceil(4 * L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1))))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt)
              for _ in range(copies)] if gm.glu else None
        bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)

        def k4(i):
            return tk.sfc_gemm_replicated(a, ws[i % copies], k_layers=kl, out_dtype=cdt)

        # which kernel the wrapper takes: at 4 bf16 rows (K4) the cluster
        # kernel, each task a cluster of L' CTAs over sub-slabs, its plain
        # version summed over the same split; batched (K5) the wgmma kernel
        # with its C tile
        parts, (name, config) = launched(tk.sfc_gemm_replicated.launches_by_kernel, lambda: k4(0))
        if name != REP_ROUTES[gm.kernel]:
            raise AssertionError(f"{gm.kernel} {gm.name}@L{kl} launched {name}, expected {REP_ROUTES[gm.kernel]}")
        split = rep_split(name, config)

        def k4_plain(i):
            return tk.sfc_gemm_replicated_plain(a, ws[i % copies], bm=bm, bn=bn, k_layers=kl, out_dtype=cdt,
                                                split=split)

        def public(i):
            if gm.glu:
                return ops.sfc_glu_matmul(a, gs[i % copies], ws[i % copies], activation=cfg.act, fuse=False,
                                          k_layers=kl)
            return ops.sfc_matmul(a, ws[i % copies], fuse=False, k_layers=kl)

        # K6's launch configuration (threads, V, CTAs) from its counter
        summed, (_, reduce_cfg) = (launched(tk.add_reduce.launches_by_kernel, lambda: tk.add_reduce(parts))
                                   if kl > 1 else (None, (None, None)))
        got = public(0)
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(torch, lambda: k4_plain(0))
        shape = [gm.batch, gm.m, gm.k, gm.n, kl]
        err = check(f"{gm.kernel}:{gm.name}@L{kl}", parts, want, cdt, shape=shape, copies=str(cdt), kernel=name,
                    config=config)
        err6 = check(f"K6:{gm.name}@L{kl}", summed, tk.add_reduce_plain(parts), cdt, shape=shape) if kl > 1 else None
        check(f"unfused:{gm.name}@L{kl}", got,
              composed(tk, a, ws[0], gs[0] if gs else None, activation=cfg.act if gm.glu else None, k_layers=kl),
              dt, shape=shape)
        del want, got, summed

        reps = max(20, copies)
        ms = time_ms(k4, reps=reps, graph=True)
        together_ms = time_ms(public, reps=reps, graph=True)
        fused_ms = time_ms(lambda i: tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None,
                                                       activation=cfg.act if gm.glu else None), reps=reps, graph=True)
        if gm.glu:
            cats = [torch.cat([g, w], dim=1) for g, w in zip(gs, ws)]
            matmul_ms = time_ms(lambda i: torch.matmul(a, cats[i % copies]), reps=reps, graph=True)
            del cats
        else:
            matmul_ms = time_ms(lambda i: torch.matmul(a, ws[i % copies]), reps=reps, graph=True)
        library_ms, library_note = None, None
        if not gm.glu and gm.k % kl == 0:
            # the same copies from one torch.matmul over the K slabs (bf16 out)
            a_sl = a.unflatten(-1, (kl, gm.k // kl)).movedim(-2, -3)
            w_sl = [w.view(kl, gm.k // kl, gm.n) for w in ws]
            library_ms = time_ms(lambda i: torch.matmul(a_sl, w_sl[i % copies]), reps=reps, graph=True)
            del a_sl, w_sl
        elif gm.k % kl == 0:
            # the GLU product's f32 copies from one torch.bmm over the K
            # slabs, the batch folded into the rows (a (L, rows, K / L) view)
            a_sl = a.reshape(-1, kl, gm.k // kl).transpose(0, 1)
            w_sl = [w.view(kl, gm.k // kl, gm.n) for w in ws]
            try:
                library_ms = time_ms(lambda i: torch.bmm(a_sl, w_sl[i % copies], out_dtype=torch.float32),
                                     reps=reps, graph=True)
            except (RuntimeError, NotImplementedError, TypeError) as exc:
                library_note = f"torch.bmm(out_dtype=torch.float32) has no kernel here: {exc}"[:200]
            del a_sl, w_sl
        bound_ms, bound_by = gm.bound()
        row = dict(gemm=gm, kernel=gm.kernel, cuda_kernel=name, config=config, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                   library_note=library_note, together_ms=together_ms, fused_ms=fused_ms, matmul_ms=matmul_ms)
        rows.append(row)
        if kl > 1:
            # K6 timed on copies rotated past the L2, as its bound counts
            # them from device memory (in the serve K4 has just written them)
            n_rot = max(1, math.ceil(4 * L2_BYTES / (parts.numel() * parts.element_size())))
            rot = [parts] + [parts.clone() for _ in range(n_rot - 1)]
            r_bound, r_by = gm.reduce_bound()
            # the yardstick, one copies.sum(-3) (torch's reduction sums bf16
            # in f32 and writes once), held to the plain version at the bf16
            # bound; the three calls float / sum / cast beside it
            k6_want, k6_plain_ms = _once_ms(torch, lambda: tk.add_reduce_plain(parts))
            check(f"K6_library:{gm.name}@L{kl}", parts.sum(-3), k6_want, torch.bfloat16, shape=shape)
            reps6 = max(20, n_rot)
            rows.append(dict(gemm=gm, kernel="K6", max_abs_err=err6, config=reduce_cfg._asdict(),
                             ms=time_ms(lambda i: tk.add_reduce(rot[i % n_rot]), reps=reps6, graph=True),
                             plain_ms=k6_plain_ms,
                             library_ms=time_ms(lambda i: rot[i % n_rot].sum(-3), reps=reps6, graph=True),
                             library_3_calls_ms=time_ms(lambda i: rot[i % n_rot].float().sum(-3).to(cdt), reps=reps6,
                                                        graph=True),
                             bound_ms=r_bound, bound_by=r_by))
            del rot
        del ws, gs, a, parts
        torch.cuda.empty_cache()

    # the ragged cases: every epilogue flag, k_layers 2, kbf 4, K = 203
    for dtype in (torch.float32, torch.bfloat16):
        m, k, n = 77, 203, 133
        r = lambda *shp: torch.randn(shp, generator=gen, device=dev).to(dtype)  # noqa: E731
        x, w, wg, bias, gbias, res = r(3, m, k), r(k, n) * 0.1, r(k, n) * 0.1, r(n), r(1, n), r(3, m, n)
        knobs = dict(k_layers=2, k_block_factor=4)
        kw = dict(bias=bias, out_scale=0.7, residual=res, fuse=False, **knobs)
        cpu = {key: v.cpu() if isinstance(v, torch.Tensor) else v for key, v in kw.items()}
        # f32, and bf16 rows TMA cannot describe (K 203): the tile kernel
        parts, (name, config) = launched(tk.sfc_gemm_replicated.launches_by_kernel,
                                         lambda: tk.sfc_gemm_replicated(x, w, **knobs))
        if name != "sfc_gemm_replicated_kernel":
            raise AssertionError(f"the ragged K5 case ({dtype}, K {k}) launched {name}, expected the tile kernel")
        got = ops.sfc_matmul(x, w, activation="gelu", **kw)
        got_glu = ops.sfc_glu_matmul(x, wg, w, activation="gelu", gate_bias=gbias, **kw)
        torch.cuda.synchronize()
        extra = dict(dtype=str(dtype), shape=[3, m, k, n], slab=tk.layer_slab(k, 2, 4), kernel=name, config=config)
        check("K5:ragged_kbf4", parts, tk.sfc_gemm_replicated_plain(x, w, bm=64, bn=64, **knobs), dtype, **extra)
        check("K6:ragged", tk.add_reduce(parts), tk.add_reduce_plain(parts), dtype, **extra)
        flags = dict(bias=bias, out_scale=0.7, residual=res, activation="gelu", **knobs)
        check("unfused:ragged_all_epilogue_flags", got, composed(tk, x, w, **flags), dtype, **extra)
        check("unfused_glu:ragged_all_epilogue_flags", got_glu, composed(tk, x, w, wg, gate_bias=gbias, **flags),
              dtype, **extra)
        if dtype == torch.float32:  # and against the whole call on the CPU
            check("unfused:ragged_f32_vs_cpu", got,
                  ops.sfc_matmul(x.cpu(), w.cpu(), activation="gelu", bm=64, bn=64, **cpu).to(dev), dtype, **extra)
            check("unfused_glu:ragged_f32_vs_cpu", got_glu,
                  ops.sfc_glu_matmul(x.cpu(), wg.cpu(), w.cpu(), activation="gelu", gate_bias=gbias.cpu(), bm=64,
                                     bn=64, **cpu).to(dev), dtype, **extra)
    return rows, checks


# kernel-name fragments of the serve's GEMM kernels in a profiler trace
_SERVE_KERNEL_GROUPS = (("sfc_gemm_replicated_kernel", "K4/K5"), ("sfc_gemm_replicated_cluster_kernel", "K4/K5"),
                        ("sfc_gemm_replicated_wgmma_kernel", "K4/K5"), ("add_reduce_kernel", "K6"),
                        ("sfc_gemm_fused_kernel", "K1/K2"), ("sfc_gemm_cluster_kernel", "K1 cluster"),
                        ("sfc_gemm_wgmma_kernel", "K2 wgmma"), ("decode_split_kernel", "K14"))


def profile_decode(torch, eng, tokens, ops, layers=None, kernel_groups=None):
    """One decode step of 4 sequences (after the 128-token prefill and a
    warm step) under torch.profiler: the wall time until its tokens reach
    the host, the device's busy time (kernels, memcpy, memset), the idle
    share, and the busy time of the GEMM kernels by group.  The profiler
    slows the host, so the wall time and idle share run above an
    unprofiled step's.  ``kernel_groups``: (name fragment, group) pairs,
    the first match a kernel's group (default the qwen3-4b serve's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with ops.knob_defaults(k_layers=layers):
        logits, cache = eng._prefill(tokens)
        logits, cache = eng._decode(logits.argmax(-1)[:, None], cache)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = eng._decode(tok, cache)
            logits.argmax(-1).tolist()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_groups = kernel_groups or _SERVE_KERNEL_GROUPS
    groups = {label: 0.0 for _, label in kernel_groups}
    groups["other"] = 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        groups[next((lab for frag, lab in kernel_groups if frag in ev.key), "other")] += us / 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms if busy else None,
            "device_ms_by_group": groups}


def composed(tk, a, w, w_gate=None, *, activation=None, bias=None, gate_bias=None, out_scale=None, residual=None,
             **knobs):
    """What the unfused call must return given the kernel's own copies:
    their f32 sum in the copies' type (f32 for the GLU's two products),
    then the epilogue in f32 and one cast.  In bf16 each copy is rounded
    before the sum, so the result is held to the copies the kernel wrote
    (themselves held to their plain version), not to a sum of other
    roundings."""
    import torch

    cdt = torch.float32 if w_gate is not None else a.dtype
    val, gate = (None if b is None else tk.add_reduce_plain(tk.sfc_gemm_replicated(a, b, out_dtype=cdt, **knobs))
                 for b in (w, w_gate))
    return tk._epilogue(val.float(), gate, bias, gate_bias, residual, activation, out_scale).to(a.dtype)


def phase_backward_gemms(torch, gemms, tk, ops):
    """K7 and K8 against their plain versions at every training shape
    (bf16), timed beside their bound and torch.matmul of the same product;
    plus one ragged f32 case of each (dual)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    dt = torch.bfloat16
    rows, checks = [], []

    def r(*shape, dtype=dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def operands(gm, dtype):
        """(args of the wrapper, args of torch.matmul's yardstick)."""
        m, k, n = gm.m, gm.k, gm.n
        if gm.kind == "nt":
            dc, w = r(m, n, dtype=dtype), r(k, n, dtype=dtype, scale=0.02)
            if not gm.dual:
                return (dc, w), (dc, w.T)
            dc2, w2 = r(m, n, dtype=dtype), r(k, n, dtype=dtype, scale=0.02)
            return (dc, w, dc2, w2), (torch.cat([dc, dc2], 1), torch.cat([w, w2], 1).T)
        x, dc = r(m, k, dtype=dtype), r(m, n, dtype=dtype)
        if not gm.dual:
            return (x, dc), (x.T, dc)
        dc2 = r(m, n, dtype=dtype)
        return (x, dc, dc2), (x.T, torch.cat([dc, dc2], 1))

    for gm in gemms:
        fn, plain_fn = (tk.sfc_gemm_nt, tk.sfc_gemm_nt_plain) if gm.kind == "nt" else (tk.sfc_gemm_tn, tk.sfc_gemm_tn_plain)
        out_rows, out_cols = (gm.m, gm.k) if gm.kind == "nt" else (gm.k, gm.n)
        bm, bn, _ = ops.pick_blocks(out_rows, out_cols, gm.n if gm.kind == "nt" else gm.m)
        # enough input copies that a timed loop streams them from HBM
        copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
        ins = [operands(gm, dt) for _ in range(copies)]
        # the wgmma kernel and its C tile, or the tile kernel
        got, (name, config) = launched(fn.launches_by_kernel, lambda: fn(*ins[0][0]))
        want, plain_ms = _once_ms(torch, lambda: plain_fn(*ins[0][0], bm=bm, bn=bn))
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": f"{gm.kind}:{gm.name}", "shape": [gm.m, gm.k, gm.n], "dual": gm.dual, "ok": ok,
                       "kernel": name, "config": config, "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"sfc_gemm_{gm.kind} disagrees with its plain version at {gm}: max err {err}, "
                                 f"err/bound {worst}")
        reps = max(20, copies)
        ms = time_ms(lambda i: fn(*ins[i % copies][0]), reps=reps, graph=True)
        lib_ms = time_ms(lambda i: torch.matmul(*ins[i % copies][1]), reps=reps, graph=True)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(2))
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
        del ins, got, want
    for kind in ("nt", "tn"):
        gm = BwdGemm("ragged_f32", kind, 77, 203, 133, dual=True)
        args, _ = operands(gm, torch.float32)
        plain_fn = tk.sfc_gemm_nt_plain if kind == "nt" else tk.sfc_gemm_tn_plain
        got = (tk.sfc_gemm_nt if kind == "nt" else tk.sfc_gemm_tn)(*args)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, plain_fn(*args, bm=32, bn=32), torch.float32)
        checks.append({"case": f"{kind}:ragged_dual_f32", "shape": [gm.m, gm.k, gm.n], "ok": ok,
                       "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"sfc_gemm_{kind} ragged f32 case disagrees: max err {err}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class UpdGemm:
    """K8 in its update or norm mode for the forward projection (M, K) @
    (K, N): dW (K, N) = A^T dC in the f32 accumulator, then AdamW against
    the f32 master / mu / nu and W written (update), or only sum(dW^2)
    (norm); dual for the GLU."""

    name: str
    mode: str  # "update" | "norm"
    m: int
    k: int
    n: int
    dual: bool = False

    @property
    def key(self):  # sfc_gemm_tn.launches_by_shape's key for the mode
        return (self.k, self.n, self.m, self.dual, self.mode)

    @property
    def sets(self) -> int:
        return 2 if self.dual else 1

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """A and dC read once; update: 12 B of f32 state read and 14 B (the
        state and W) written per weight element; norm: the per-task
        partials."""
        operands = elem * (self.m * self.k + self.sets * self.m * self.n)
        if self.mode == "update":
            return operands + 26.0 * self.sets * self.k * self.n
        return operands + 4.0 * self.sets * math.ceil(self.k / 64) * math.ceil(self.n / 64)


def train_update_gemms(cfg):
    """K8's update mode at every projection of the training step (its norm
    mode runs the same shapes)."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    proj = _projections(cfg) + [("head", cfg.d_model, cfg.vocab, False)]
    return [UpdGemm(f"train/{name}", "update", rows, k, n, glu) for name, k, n, glu in proj]


def phase_update_gemms(torch, cfg, tk, opt, gemms=None, dtypes=None):
    """K8's update and norm modes against their plain versions at every
    training shape, in bf16 (stochastic rounding on, the main path, timed)
    and in f32: master, mu and nu within the f32 bound; a bf16 W bitwise the
    stochastic rounding of the kernel's own master with the plain version's
    tile bits (the counter hash) and within the bf16 bound of the plain W
    (the two masters differ in their last bits, and a rounding with the
    same bits may then land one ulp apart), an f32 W the new master; the
    norms within the f32 bound, the norm mode's bitwise the update mode's.
    Yardstick: torch.mm to an f32 dW plus torch._fused_adamw_ on the same
    state (two calls; they write no bf16 W)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (3 << 16) + 5
    rows, checks = [], []

    def r(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(gm, dt):
        """(x, [dC per set], [(master, mu, nu, W) per set]): a later step's
        state, its moments on the scale of dW (about sqrt(M))."""
        g = math.sqrt(gm.m)
        x, dcs = r((gm.m, gm.k), 1.0, dt), [r((gm.m, gm.n), 1.0, dt) for _ in range(gm.sets)]
        sets = []
        for _ in range(gm.sets):
            mst = r((gm.k, gm.n), 0.02)
            sets.append((mst, r((gm.k, gm.n), 0.5 * g), r((gm.k, gm.n), 2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return x, dcs, sets

    def update(fn, x, dcs, sets, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        extra = dict(w2=rest[0][3]) if rest else {}
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, w=w1, salt=salt,
                  stochastic_round=dt == torch.bfloat16, **extra, **kw)

    def clone(sets):
        return [tuple(t.clone() for t in st) for st in sets]

    for gm in gemms or train_update_gemms(cfg):
        for dt in dtypes or (torch.bfloat16, torch.float32):
            x, dcs, sets = inputs(gm, dt)
            got_sets, want_sets = clone(sets), clone(sets)
            got, (name, config) = launched(tk.sfc_gemm_tn.launches_by_kernel,
                                           lambda: update(tk.sfc_gemm_tn, x, dcs, got_sets, dt))
            norm_only, norm_kernel = launched(tk.sfc_gemm_tn.launches_by_kernel,
                                              lambda: tk.sfc_gemm_tn(x, dcs[0], dcs[1] if gm.dual else None, norm=True))
            torch.cuda.synchronize()
            want, plain_upd_ms = _once_ms(torch, lambda: update(tk.sfc_gemm_tn_plain, x, dcs, want_sets, dt,
                                                                bm=64, bn=64))
            ok, norm_err, worst = within(got, want, torch.float32)
            res = {"case": f"tn_update:{gm.name}", "dtype": str(dt), "shape": [gm.m, gm.k, gm.n], "dual": gm.dual,
                   "kernel": name, "config": config, "norm_kernel": list(norm_kernel),
                   "norm_ok": ok, "norm_max_abs_err": norm_err, "norm_err_over_bound": worst,
                   "norm_mode_bitwise": bool(torch.equal(norm_only, got))}
            err, worst_state, w_bitwise = 0.0, 0.0, True
            for s, ((g_mst, g_mu, g_nu, g_w), (p_mst, p_mu, p_nu, p_w)) in enumerate(zip(got_sets, want_sets)):
                for g_, w_ in ((g_mst, p_mst), (g_mu, p_mu), (g_nu, p_nu), (g_w, p_w)):
                    ok_s, err_s, worst_s = within(g_, w_, torch.float32 if g_.dtype == torch.float32 else dt)
                    ok, err, worst_state = ok and ok_s, max(err, err_s), max(worst_state, worst_s)
                if dt == torch.bfloat16:
                    bits = tk._tile_bits(gm.k, gm.n, 64, 64, hyper, salt, *((1,) if s else ()))
                    w_bitwise &= bool(torch.equal(g_w, tk.stochastic_round_to(g_mst, bits, dt)))
                    del bits
                else:
                    w_bitwise &= bool(torch.equal(g_w, g_mst))
            res.update(ok=ok and w_bitwise and res["norm_mode_bitwise"], max_abs_err=err,
                       state_err_over_bound=worst_state, w_bitwise_sr_of_master=w_bitwise)
            checks.append(res)
            if not res["ok"]:
                raise AssertionError(f"sfc_gemm_tn update / norm mode disagrees with its plain version: {res}")
            del got_sets, want_sets
            if dt != torch.bfloat16:
                del x, dcs, sets
                continue
            # the main path's type: time both modes, the plain versions and the yardstick
            copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
            ins = [(x, dcs, sets)] + [inputs(gm, dt) for _ in range(copies - 1)]
            step_t = torch.zeros((), device=dev)

            def library(i):
                x_, dcs_, sets_ = ins[i % copies]
                grads = [torch.mm(x_.T, d, out_dtype=torch.float32) for d in dcs_]
                torch._fused_adamw_([st[0] for st in sets_], grads, [st[1] for st in sets_],
                                    [st[2] for st in sets_], [], [step_t] * len(sets_), lr=1e-2, beta1=0.9,
                                    beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

            reps = max(20, copies)
            upd_ms = time_ms(lambda i: update(tk.sfc_gemm_tn, *ins[i % copies], dt), reps=reps, graph=True)
            norm_ms = time_ms(lambda i: tk.sfc_gemm_tn(ins[i % copies][0], *ins[i % copies][1], norm=True),
                              reps=reps, graph=True)
            lib_ms = time_ms(library, reps=reps, graph=True)
            _, plain_norm_ms = _once_ms(torch, lambda: tk.sfc_gemm_tn_plain(x, *dcs, norm=True, bm=64, bn=64))
            for mode, ms, plain_ms, l_ms in (("update", upd_ms, plain_upd_ms, lib_ms),
                                             ("norm", norm_ms, plain_norm_ms, None)):
                g2 = dataclasses.replace(gm, mode=mode)
                bound_ms, bound_by = _bound(g2.flops(), g2.bytes(2))
                rows.append(dict(gemm=g2, max_abs_err=err if mode == "update" else norm_err, ms=ms, plain_ms=plain_ms,
                                 library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
            del ins, x, dcs, sets
            torch.cuda.empty_cache()
    return rows, checks


@dataclasses.dataclass(frozen=True)
class AttnBwd:
    """One flash backward: dQ (K12) and dK/dV (K13) for (b, s) queries
    against (b, t) keys."""

    name: str
    b: int
    s: int
    t: int
    h: int
    hkv: int
    d: int
    dtype: str
    causal: bool = True
    q_offset: int = 0
    main_path: bool = True
    timed: bool = True

    def pairs(self) -> int:
        return Attn("", "sfc_flash_fwd", self.b, self.s, self.t, self.h, self.hkv, self.d, self.causal,
                    self.q_offset).pairs()

    @property
    def key(self):  # the flash wrappers' launches_by_shape key (sfc_attention.shape_key)
        return (self.b, self.s, self.t, self.h, self.hkv, self.d, self.causal)

    def kernels(self):
        """The (K12, K13) CUDA kernels a call at this case launches: the
        wgmma kernels for bf16 (`uses_bwd_wgmma_kernel`: these cases' head
        dims, groups and layouts), the 64 x 64 tile kernels for f32."""
        if self.dtype == "bfloat16":
            return "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"
        return "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"

    def bound(self, kernel: str, elem: int):
        """K12 reads q, k, v, dO, lse and delta and writes dQ, with 6 D flops
        a pair (S, dP, dS k); K13 reads the same and writes dK and dV, with
        8 D flops a pair (S, dP, P^T dO, dS^T q)."""
        q_elems, kv_elems = self.b * self.s * self.h * self.d, self.b * self.t * self.hkv * self.d
        stats = 2 * 4 * self.b * self.s * self.h
        if kernel == "sfc_flash_bwd_dq":
            return _bound(6.0 * self.d * self.pairs(), elem * (3 * q_elems + 2 * kv_elems) + stats)
        return _bound(8.0 * self.d * self.pairs(), elem * (2 * q_elems + 4 * kv_elems) + stats)

    def shape(self) -> dict:
        return {"b": self.b, "s": self.s, "t": self.t, "h": self.h, "hkv": self.hkv, "d": self.d,
                "causal": self.causal, "q_offset": self.q_offset, "dtype": self.dtype}


def attention_bwd_cases(cfg):
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_)
    return [
        AttnBwd("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, dtype="bfloat16", **heads),
        # off the main path: one 2048-token sequence, where the band's flops,
        # not its bytes, bound the kernels
        AttnBwd("band_2048", 1, 2048, 2048, dtype="bfloat16", main_path=False, **heads),
        AttnBwd("ragged_gqa_f32", 1, 190, 250, dtype="float32", q_offset=60, main_path=False, timed=False, **heads),
    ]


def phase_attention_bwd(torch, cases, tsa, build):
    """K12 and K13 against their plain versions (K13's in the kernel's
    summation order: its cluster's parts of the GQA group in turn), each
    launch on the CUDA kernel its case names
    (`AttnBwd.kernels`), the timed cases beside their bound and the
    backward of scaled_dot_product_attention (a yardstick the port never
    calls: one graph of SDPA forward and backward, less one of the forward
    alone; it computes dQ, dK and dV together, so K12 and K13 share it)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rows, checks = [], []
    for c in cases:
        dt = getattr(torch, c.dtype)
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
        q, k, v, do = r(c.b, c.s, c.h, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.s, c.h, c.d)
        kw = dict(causal=c.causal, q_offset=c.q_offset)
        o, lse = tsa.sfc_flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        qc, kc = tsa.kernel_chunks()
        dqc, dkc = build.ATTN_DKV_TILE[build.DTYPE_NAMES[c.dtype]]
        # the plain versions take the launch's configuration: K13's, its CTAs
        # a cluster, the parts of the group it sums in turn (1 on the tile kernel)
        kernels = {
            "sfc_flash_bwd_dq": (lambda i: tsa.sfc_flash_bwd_dq(*args, **kw),
                                 lambda i, cfg: tsa.sfc_flash_bwd_dq_plain(*args, q_chunk=qc, k_chunk=kc, **kw)),
            "sfc_flash_bwd_dkv": (lambda i: tsa.sfc_flash_bwd_dkv(*args, **kw),
                                  lambda i, cfg: tsa.sfc_flash_bwd_dkv_plain(*args, q_chunk=dqc, k_chunk=dkc,
                                                                             group_parts=cfg, **kw)),
        }
        lib_ms = None
        if c.timed:
            views = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
            do_t = do.transpose(1, 2)

            def sdpa(i):
                return F.scaled_dot_product_attention(*views, is_causal=c.causal, enable_gqa=True)

            def sdpa_fwd_bwd(i):
                return torch.autograd.grad(sdpa(i), views, do_t)

            lib_ms = time_ms(sdpa_fwd_bwd, reps=20, graph=True) - time_ms(sdpa, reps=20, graph=True)
        for (name, (kernel, plain)), cuda_kernel in zip(kernels.items(), c.kernels()):
            got, (launched_kernel, config) = launched(getattr(tsa, name).launches_by_kernel, lambda: kernel(0))
            want, plain_ms = _once_ms(torch, lambda: plain(0, config))
            ok, err, worst = within_all(got, want, dt)
            checks.append({"case": f"{name}:{c.name}", "shape": c.shape(), "kernel": launched_kernel,
                           "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
            if launched_kernel != cuda_kernel:
                raise AssertionError(f"{name} at {c} launched {launched_kernel}, expected {cuda_kernel}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {c}: max err {err}, "
                                     f"err/bound {worst}")
            if not c.timed:
                continue
            bound_ms, bound_by = c.bound(name, 2)
            rows.append(dict(case=c, kernel=name, cuda_kernel=launched_kernel, config=config, max_abs_err=err,
                             ms=time_ms(kernel, reps=20, graph=True),
                             plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
    return rows, checks


def _is_projection(name: str) -> bool:
    return name.split(".")[-1] in ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "head", "router")


def phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, batch, layers=GRAD_CHECK_LAYERS,
                     cut=None, want=None):
    """The config at full width cut to ``layers`` layers, in f32: the loss
    and every parameter's gradient under sfc_cuda + attn_impl="sfc" (K1/K2,
    K7, K8, K11, K12, K13; for olmoe also K3, K9 and K10) against the torch
    backend with blockwise attention, within the bf16 bound; every
    projection weight (the router and the expert stacks included) must get
    a non-zero gradient; the flash forward and backward and K3 / K9 launch
    their 64 x 64 tile kernels only (f32).  ``cut``: the fields of the cut
    (default ``n_layers=layers``).  ``want``: the launches of each wrapper
    the loss and its backward must make (`family_train_want` of the cut
    under "none"), held exactly; without it, a decoder's ``layers`` flash
    calls of each kind.  The loss runs without remat, so every count is one
    forward's."""
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    wrappers = {"sfc_gemm_fused": tk.sfc_gemm_fused, "sfc_gemm_nt": tk.sfc_gemm_nt, "sfc_gemm_tn": tk.sfc_gemm_tn,
                "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_flash_bwd_dq": tsa.sfc_flash_bwd_dq,
                "sfc_flash_bwd_dkv": tsa.sfc_flash_bwd_dkv}
    want = {k: n for k, n in (want or {}).items() if k in wrappers}
    attentions = want.get("sfc_flash_fwd", layers)
    launched_before = {k: wrappers[k].launches for k in want}
    cfg4 = dataclasses.replace(cfg, **(cut or {"n_layers": layers}), param_dtype="float32")
    model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
    losses, grads = {}, {}
    # the f32 cut's flash forward and backward and (MoE) K3 / K9: every
    # launch on the 64 x 64 tile kernels
    flash_fns = (tsa.sfc_flash_fwd, tsa.sfc_flash_bwd_dq, tsa.sfc_flash_bwd_dkv)
    bwd_before = [collections.Counter(f.launches_by_kernel) for f in flash_fns]
    grouped_fns = (tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_nt)
    grouped_before = [collections.Counter(f.launches_by_kernel) for f in grouped_fns]
    for name, (gemm, impl) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc")), ("torch", ("torch", "blockwise"))):
        with gemm_backend(gemm), attention_backend(impl):
            loss = model.loss(batch, remat="none")
            loss.backward()
        torch.cuda.synchronize()
        if name == "sfc_cuda+sfc_attn":
            launched = {k: wrappers[k].launches - n for k, n in launched_before.items()}
        losses[name] = loss.detach()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    missing = {n: ("none" if g is None else "nan" if bool(torch.isnan(g).any()) else "zero")
               for n, g in grads["sfc_cuda+sfc_attn"].items()
               if _is_projection(n) and (g is None or not bool(g.abs().max() > 0))}
    if missing:
        nonfinite = sorted(n for n, g in grads["sfc_cuda+sfc_attn"].items()
                           if g is not None and not bool(torch.isfinite(g).all()))
        raise AssertionError(f"projection weights without a gradient under sfc_cuda: {missing}; losses "
                             f"{ {k: float(v) for k, v in losses.items()} }; non-finite gradients: {nonfinite}")
    bwd_kernels = [by_kernel(collections.Counter(f.launches_by_kernel) - before)
                   for f, before in zip(flash_fns, bwd_before)]
    want_flash = [{"flash_fwd_kernel": attentions}, {"flash_bwd_dq_kernel": attentions},
                  {"flash_bwd_dkv_kernel": attentions}] if attentions else [{}, {}, {}]
    if launched != want:
        raise AssertionError(f"the f32 cut's loss and backward launched {launched}, expected {want}")
    if bwd_kernels != want_flash:
        raise AssertionError(f"the f32 cut's flash forward and backward launched {bwd_kernels}, expected the tile "
                             "kernels")
    grouped_kernels = [by_kernel(collections.Counter(f.launches_by_kernel) - before)
                       for f, before in zip(grouped_fns, grouped_before)]
    tiles_only = [set(k) == ({"sfc_gemm_grouped_kernel"}, {"grouped_nt_kernel"})[i] if cfg.n_experts else not k
                  for i, k in enumerate(grouped_kernels)]
    if not all(tiles_only):
        raise AssertionError(f"the f32 cut's K3 / K9 launched {grouped_kernels}, expected the tile kernels only")
    ok_loss, err_loss, worst_loss = within(losses["sfc_cuda+sfc_attn"], losses["torch"], torch.bfloat16)
    per_param = {n: within(g, grads["torch"][n], torch.bfloat16) for n, g in grads["sfc_cuda+sfc_attn"].items()}
    bad = {n: r for n, r in per_param.items() if not r[0]}
    out = {"arch": cfg.name, "layers": cfg4.n_layers, "cut": cut or {"n_layers": layers}, "dtype": "float32",
           "tokens": list(batch["tokens"].shape),
           "launches": launched, "flash_launches_by_kernel": bwd_kernels,
           "grouped_launches_by_kernel": grouped_kernels,
           "loss": {"sfc_cuda+sfc_attn": float(losses["sfc_cuda+sfc_attn"]), "torch": float(losses["torch"]),
                    "ok": ok_loss, "err_over_bound": worst_loss},
           "params": len(per_param), "projections_with_gradient": sum(map(_is_projection, per_param)),
           "grad_worst_err_over_bound": max(r[2] for r in per_param.values()),
           "grad_max_abs_err": max(r[1] for r in per_param.values())}
    del model, grads
    if not ok_loss or bad:
        raise AssertionError(f"sfc_cuda gradients disagree with the torch backend's: loss ok={ok_loss} "
                             f"(err/bound {worst_loss}); parameters {sorted(bad)}")
    return out


def phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, batches,
                           layers=GRAD_CHECK_LAYERS, abft=None):
    """The config at full width cut to ``layers`` layers, in f32: two
    fused-optimizer steps (sfc_cuda + attn_impl="sfc", AdamW of every
    projection in K8's update flush and, for a MoE config, of every expert
    stack in K10's; the clip exact in two phases) against two unfused
    sfc_cuda steps from the same init, with a clip that binds: losses, grad
    norms, every parameter and every master / mu / nu within the f32 bound,
    exact norm and update launches of both kernels and no dW launch; then a
    third fused step whose gradients are all NaN (a hook on the final
    norm's output): every weight and state bitwise unchanged, the step
    counted.  ``abft``: both runs' `BackendConfig.abft`; under "detect" no
    step may count a detection (the NaN step's NaN residuals are none)."""
    from repro_torch.robust import abft as abft_lib

    abft_lib.reset_runtime_sdc()
    cfg4 = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32")
    kernels = {"sfc_gemm_tn": tk.sfc_gemm_tn, "sfc_gemm_grouped_tn": tk.sfc_gemm_grouped_tn}
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3, clip_norm=FUSED_CHECK_CLIP)
    runs, tn_kernels = {}, {}
    for name, fused in (("unfused", False), ("fused", True)):
        model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
        step = make_train_step(model, opt_cfg, backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                                     fused_optimizer=fused, abft=abft))
        state = opt.adamw_init(dict(model.named_parameters()))
        metrics = []
        modes0 = {k: dict(fn.launches_by_mode) for k, fn in kernels.items()}
        by_kernel0 = {k: collections.Counter(fn.launches_by_kernel) for k, fn in kernels.items()}
        for batch in batches[:2]:
            state, m = step(state, batch)
            metrics.append({"loss": m["loss"], "grad_norm": m["grad_norm"]})
        torch.cuda.synchronize()
        modes = {k: {mode: v - modes0[k].get(mode, 0) for mode, v in fn.launches_by_mode.items()}
                 for k, fn in kernels.items()}
        tn_kernels[name] = {k: by_kernel(collections.Counter(fn.launches_by_kernel) - by_kernel0[k])
                            for k, fn in kernels.items()}
        runs[name] = (model, step, state, metrics, modes)
    (mu_, _, su, metu, _), (mf, stepf, sf, metf, modesf) = runs["unfused"], runs["fused"]
    # the f32 cut's TN launches stay on the 64 x 64 tile kernels
    tile_only = not any("wgmma" in kn for run in tn_kernels.values() for ks in run.values() for kn in ks)
    # routed a layer: q, k, v, o and the GLU pair and w_out, or q, k, v, o
    # and the two expert projections; the head.  The MoE router stays
    # unrouted (as in the JAX package): its dW runs K8's dW mode.
    per_step = {"sfc_gemm_tn": layers * (4 if cfg.n_experts else 6) + 1,
                "sfc_gemm_grouped_tn": layers * 2 if cfg.n_experts else 0}
    dw_per_step = {"sfc_gemm_tn": layers if cfg.n_experts else 0, "sfc_gemm_grouped_tn": 0}
    worst, ok = 0.0, True
    for a, b in zip(metf, metu):
        for key in ("loss", "grad_norm"):
            ok_, _, w_ = within(a[key], b[key], torch.float32)
            ok, worst = ok and ok_, max(worst, w_)
    binds = all(float(m["grad_norm"]) > FUSED_CHECK_CLIP for m in metu)
    pf, pu = dict(mf.named_parameters()), dict(mu_.named_parameters())
    for n in pf:
        for a, b in [(pf[n], pu[n])] + [(sf[k][n], su[k][n]) for k in ("mu", "nu", "master")]:
            ok_, _, w_ = within(a.detach(), b.detach(), torch.float32)
            ok, worst = ok and ok_, max(worst, w_)
    no_grad = all(p.grad is None for p in pf.values())
    counts_ok = all(modesf[k].get("norm", 0) == modesf[k].get("update", 0) == 2 * n
                    and modesf[k].get("dw", 0) == 2 * dw_per_step[k] for k, n in per_step.items())
    del mu_, su, pu, runs
    # the non-finite case
    before = {n: p.detach().clone() for n, p in pf.items()}
    slots = {k: {n: t.clone() for n, t in sf[k].items()} for k in ("mu", "nu", "master")}
    hook = mf.final_norm.register_forward_hook(lambda mod, inp, out: out.register_hook(lambda g: g * float("nan"))
                                               and None)
    sf, m_nan = stepf(sf, batches[2])
    hook.remove()
    torch.cuda.synchronize()
    skipped = (not math.isfinite(float(m_nan["grad_norm"])) and int(sf["step"]) == 3
               and all(torch.equal(p.detach(), before[n]) for n, p in pf.items())
               and all(torch.equal(sf[k][n], slots[k][n]) for k in slots for n in slots[k]))
    out = {"arch": cfg.name, "layers": layers, "dtype": "float32", "clip_norm": FUSED_CHECK_CLIP,
           "clip_binds": binds,
           "losses": {"fused": [float(m["loss"]) for m in metf], "unfused": [float(m["loss"]) for m in metu]},
           "grad_norms": {"fused": [float(m["grad_norm"]) for m in metf],
                          "unfused": [float(m["grad_norm"]) for m in metu]},
           "worst_err_over_bound": worst, "within_f32_bound": ok, "no_weight_has_grad": no_grad,
           "launches_by_mode_2_steps": modesf, "tn_launches_by_kernel_2_steps": tn_kernels,
           "tn_on_tile_kernels": tile_only, "nonfinite_step_skipped_bitwise": skipped}
    clean = True
    if abft:
        out["abft"] = {"mode": abft, "sdc_detections": abft_lib.runtime_sdc_total(),
                       "checks": abft_lib.runtime_check_total(),
                       "max_residual_over_tol": abft_lib.runtime_max_ratio()}
        clean = out["abft"]["sdc_detections"] == 0 and out["abft"]["checks"] > 0
    del mf, sf, stepf, pf, before, slots
    if not (ok and binds and no_grad and counts_ok and skipped and clean and tile_only):
        raise AssertionError(f"the fused step disagrees with the unfused one: {out}")
    return out


# kernel-name fragments of the port's kernels in a profiler trace
_KERNEL_GROUPS = (("sfc_gemm_fused_kernel", "K1/K2"), ("sfc_gemm_wgmma_kernel", "K2 wgmma"), ("nt_kernel", "K7"),
                  ("nt_wgmma_kernel", "K7 wgmma"), ("tn_kernel", "K8"), ("tn_wgmma_kernel", "K8 wgmma"),
                  ("tn_update_kernel", "K8 norm/update"), ("tn_update_wgmma_kernel", "K8 wgmma norm/update"),
                  ("flash_fwd_kernel", "K11"), ("flash_fwd_wgmma_kernel", "K11 wgmma"),
                  ("flash_bwd_dq_kernel", "K12"), ("flash_bwd_dkv_kernel", "K13"),
                  ("flash_bwd_dq_wgmma_kernel", "K12 wgmma"), ("flash_bwd_dkv_wgmma_kernel", "K13 wgmma"))
# the MoE step's: the grouped kernels first, since "nt_kernel",
# "tn_kernel", "tn_update_kernel" and their wgmma names are fragments of
# their names too
_MOE_KERNEL_GROUPS = (("sfc_gemm_grouped_kernel", "K3"), ("sfc_gemm_grouped_wgmma_kernel", "K3 wgmma"),
                      ("grouped_nt_kernel", "K9"), ("grouped_nt_wgmma_kernel", "K9 wgmma"),
                      ("grouped_tn_kernel", "K10"), ("grouped_tn_wgmma_kernel", "K10 wgmma"),
                      ("grouped_tn_update_kernel", "K10 norm/update"),
                      ("grouped_tn_update_wgmma_kernel", "K10 wgmma norm/update"), *_KERNEL_GROUPS)


def _is_update(key: str) -> bool:
    """Whether a profiler key of a [grouped_]tn_update[_wgmma]_kernel is its
    update instantiation: the UPDATE template argument, the tile kernel's
    third (<T, DUAL, UPDATE, SR>), the wgmma kernel's second (<DUAL, UPDATE>)."""
    if "tn_update_wgmma_kernel<" in key:
        return key.split("tn_update_wgmma_kernel<")[1].split(">")[0].split(", ")[1] == "true"
    return key.split("tn_update_kernel<")[1].split(", ")[2] == "true"


def profile_step(torch, step_fn, opt_state, batch, kernel_groups=_KERNEL_GROUPS):
    """One more train step under torch.profiler: its wall time, the
    device's busy time (the sum of the device-side events: kernels, memcpy,
    memset), the idle share, and the busy time by group: the port's
    kernels by name, the rest (elementwise, reductions, cuBLAS, copies) as
    "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a "norm/update" kernel is two groups, split by its UPDATE template argument
    groups = {}
    for _, label in kernel_groups:
        base, split = label.removesuffix(" norm/update"), label.endswith(" norm/update")
        groups.update({f"{base} norm": 0.0, f"{base} update": 0.0} if split else {label: 0.0})
    groups["other"] = 0.0
    # the device's own activities (kernels, memcpy, memset) by name, from
    # the trace's raw events: key_averages() builds an event tree at about
    # 0.1 ms an event, minutes for a step of many small ops
    by_name = collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            by_name[ev.name()] += ev.duration_ns() / 1e6
    top = []
    for key, ms in by_name.items():
        label = next((lab for frag, lab in kernel_groups if frag in key), "other")
        if label.endswith(" norm/update"):
            label = label.removesuffix("norm/update") + ("update" if _is_update(key) else "norm")
        groups[label] += ms
        top.append((ms, key[:80]))
    busy = sum(groups.values()) / 1e3
    top.sort(reverse=True)
    # a trace with no device time measured nothing: no idle share then
    return opt_state, {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall if busy else None,
                       "device_ms_by_group": groups, "top_device_ms": top[:10]}


def _tn_mode_counts(counted):
    """Launches by mode of the TN kernels among ``counted`` (K8, and K10
    where the run counts it)."""
    return {f"{name}:{mode}": counted[name].launches_by_mode.get(mode, 0)
            for name in ("sfc_gemm_tn", "sfc_gemm_grouped_tn") if name in counted for mode in ("dw", "norm", "update")}


def _kernel_counts(counted):
    """K1/K2's, K3's, K7's, K8's, K9's, K10's, K11's, K12's and K13's
    launches on their wgmma kernels and on the 64 x 64 tile kernels (the
    cluster kernel takes none of a training step's)."""
    out = {}
    for name, tiles in (("sfc_gemm_fused", ("sfc_gemm_fused_kernel",)), ("sfc_gemm_nt", ("nt_kernel",)),
                        ("sfc_gemm_grouped", ("sfc_gemm_grouped_kernel",)),
                        ("sfc_gemm_grouped_nt", ("grouped_nt_kernel",)),
                        ("sfc_gemm_tn", ("tn_kernel", "tn_update_kernel")),
                        ("sfc_gemm_grouped_tn", ("grouped_tn_kernel", "grouped_tn_update_kernel")),
                        ("sfc_flash_fwd", ("flash_fwd_kernel",)),
                        ("sfc_flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                        ("sfc_flash_bwd_dkv", ("flash_bwd_dkv_kernel",))):
        if name in counted:
            kernels = by_kernel(counted[name].launches_by_kernel)
            out[f"{name}:wgmma"] = sum(n for k, n in kernels.items() if "wgmma" in k)
            out[f"{name}:tile"] = sum(kernels.get(t, 0) for t in tiles)
    return out


def digest(torch, t) -> int:
    """An exact digest of a tensor's bits: the wrapping int64 sum of each
    element's bits times an odd multiple of its index.  Equal bits give
    equal digests; a changed element changes it (short of a 2^-64 chance)."""
    bits = t.detach().contiguous().view(-1)
    bits = bits.view({4: torch.int32, 2: torch.int16}[bits.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 24
    for start in range(0, bits.numel(), step):
        chunk = bits[start:start + step].long()
        idx = torch.arange(start, start + chunk.numel(), dtype=torch.int64, device=t.device) * 2 + 1
        total += (chunk * idx * 0x9E3779B1).sum()
    return int(total)


def _train_run(torch, cfg, build_trainer, counted, gemm, impl, fused, kernel_groups=_KERNEL_GROUPS, abft=None,
               remat=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, profile=True, digests=False,
               probe=False):
    """``steps`` steps of `build_trainer` from seed 0 (TRAIN_STEPS of
    TRAIN_BATCH x TRAIN_SEQ tokens unless named), each step's launch
    counts, times and loss, then a profiled step.  Returns (run summary,
    launches by shape of every counted kernel, their totals).  ``abft``:
    `BackendConfig.abft`; such a run also counts each kernel's launches with
    the checksum lane (``"<kernel>:abft"``) and reports the runtime ABFT
    counters of its steps, and profiles no step.  ``remat``: the step's
    remat policy (None: `build_trainer`'s, "none").  ``digests``: the run
    also holds ``"digests"``, every parameter's and f32 master's `digest`
    after the steps (before the profiled one); ``probe``: ``"routed"``, the
    weights `optim.fused.probe_routed` routes for this model."""
    from repro_torch.optim.fused import probe_routed
    from repro_torch.robust import abft as abft_lib

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt_state, step_fn, batch_fn = build_trainer(
        cfg, batch=batch, seq=seq, total_steps=TRAIN_STEPS, seed=0,
        gemm_backend=gemm, attn_impl=impl, fused_optimizer=fused, abft=abft, device="cuda",
        **({"remat": remat} if remat else {}))
    params = dict(model.named_parameters())
    # a fingerprint of each initial parameter (its f64 sum): every
    # parameter's f32 master must move off it
    before = {n: float(p.detach().double().sum()) for n, p in params.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, times, launches = [], [], []
    for fn in counted.values():
        fn.launches = 0
        if hasattr(fn, "abft_launches"):
            fn.abft_launches = 0
        for counter in ("launches_by_shape", "launches_by_mode", "launches_by_kernel"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()
    abft_lib.reset_runtime_sdc()

    def counts():
        lanes = {f"{k}:abft": fn.abft_launches for k, fn in counted.items() if abft and hasattr(fn, "abft_launches")}
        return {**{k: fn.launches for k, fn in counted.items()}, **_tn_mode_counts(counted), **lanes,
                **_kernel_counts(counted)}

    for step in range(steps):
        batch_ = batch_fn(step)
        start = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(opt_state, batch_)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append({k: v - start[k] for k, v in counts().items()})
    unchanged = [n for n in params if float(opt_state["master"][n].double().sum()) == before[n]]
    run = {"remat": remat or "none", "batch": batch, "seq": seq, "losses": losses, "step_s": times,
           "setup_s": setup_s, "peak_memory_bytes": torch.cuda.max_memory_allocated(), "unchanged_params": unchanged,
           "params_with_grad": [n for n, p in params.items() if p.grad is not None],
           "launches_per_step": launches, "grad_norm_last": float(metrics["grad_norm"])}
    if probe:
        routed = probe_routed(model)
        run["routed"] = {"weights": len(routed), "paths": sorted({leaf.path for leaf in routed.values()})}
    if digests:
        run["digests"] = {**{n: digest(torch, p) for n, p in params.items()},
                          **{f"master:{n}": digest(torch, t) for n, t in opt_state["master"].items()}}
    if abft:
        run["abft"] = {"mode": abft, "sdc_detections": abft_lib.runtime_sdc_total(),
                       "checks": abft_lib.runtime_check_total(), "max_residual_over_tol": abft_lib.runtime_max_ratio()}
    by_shape = {k: dict(fn.launches_by_shape) for k, fn in counted.items() if hasattr(fn, "launches_by_shape")}
    by_shape["totals"] = counts()
    if profile and not abft:  # one more step, profiled, for the split of its time (not compared)
        opt_state, run["profiled_step"] = profile_step(torch, step_fn, opt_state, batch_fn(steps), kernel_groups)
    alive = weakref.ref(model)
    del model, opt_state, step_fn, batch_fn, params, metrics
    gc.collect()
    torch.cuda.empty_cache()
    # what the run leaves behind: nothing of its model, state or graphs
    run["left_allocated_bytes"] = torch.cuda.memory_allocated()
    run["model_freed"] = alive() is None
    print(f"train run {cfg.name} x{cfg.n_layers} {gemm} fused={fused} remat={run['remat']} {batch}x{seq}: peak "
          f"{run['peak_memory_bytes']}, left {run['left_allocated_bytes']}, model freed {run['model_freed']}",
          file=sys.stderr, flush=True)
    return run, by_shape


def _losses_close(a_run, b_run):
    return [math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
            for a, b in zip(a_run["losses"], b_run["losses"])]


def phase_train(torch, cfg, build_trainer, counted):
    """Three steps of `build_trainer` at full width under sfc_cuda +
    attn_impl="sfc", the same steps from the same init with the fused
    optimizer, then under torch + blockwise.  Returns (summary, launches by
    shape of each sfc run)."""
    per_step = cfg.n_layers * 6 + 1
    # every K11, K12 and K13 launch (bf16, D 128) on the wgmma kernels
    layers = {"sfc_flash_fwd": cfg.n_layers, "sfc_flash_bwd_dq": cfg.n_layers, "sfc_flash_bwd_dkv": cfg.n_layers,
              "sfc_flash_fwd:wgmma": cfg.n_layers, "sfc_flash_fwd:tile": 0,
              "sfc_flash_bwd_dq:wgmma": cfg.n_layers, "sfc_flash_bwd_dq:tile": 0,
              "sfc_flash_bwd_dkv:wgmma": cfg.n_layers, "sfc_flash_bwd_dkv:tile": 0}
    # every K1/K2, K7 and K8 launch (512 bf16 token rows) on the wgmma kernels
    want = {"sfc_gemm_fused": per_step, "sfc_gemm_nt": per_step, "sfc_gemm_tn": per_step, **layers,
            "sfc_gemm_tn:dw": per_step, "sfc_gemm_tn:norm": 0, "sfc_gemm_tn:update": 0,
            "sfc_gemm_fused:wgmma": per_step, "sfc_gemm_fused:tile": 0, "sfc_gemm_nt:wgmma": per_step,
            "sfc_gemm_nt:tile": 0, "sfc_gemm_tn:wgmma": per_step, "sfc_gemm_tn:tile": 0}
    # the fused step: K8 runs its norm mode in the backward and its update
    # mode after it, and never writes dW
    want_fused = {**want, "sfc_gemm_tn": 2 * per_step, "sfc_gemm_tn:dw": 0, "sfc_gemm_tn:norm": per_step,
                  "sfc_gemm_tn:update": per_step, "sfc_gemm_tn:wgmma": 2 * per_step}
    # under ABFT "detect": the same launches, every K1/K2 and K8 one with
    # its checksum lane (K7 and the attention kernels have none)
    want_abft = {**want, "sfc_gemm_fused:abft": per_step, "sfc_gemm_tn:abft": per_step}
    want_fused_abft = {**want_fused, "sfc_gemm_fused:abft": per_step, "sfc_gemm_tn:abft": 2 * per_step}
    runs, by_shape = {}, {}
    for name, (gemm, impl, fused, abft) in (
            ("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False, None)),
            ("sfc_cuda+sfc_attn+abft", ("sfc_cuda", "sfc", False, "detect")),
            ("sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True, None)),
            ("sfc_cuda+sfc_attn+fused_optimizer+abft", ("sfc_cuda", "sfc", True, "detect")),
            ("torch", ("torch", "blockwise", False, None))):
        runs[name], shapes = _train_run(torch, cfg, build_trainer, counted, gemm, impl, fused, abft=abft,
                                        digests=abft is None)
        if gemm == "sfc_cuda":
            by_shape[name] = shapes
    # the remat phase holds its runs to these, remat "none" (`build_trainer`'s)
    digests = {name: run.pop("digests") for name, run in runs.items() if "digests" in run}
    sfc, fused, ref = runs["sfc_cuda+sfc_attn"], runs["sfc_cuda+sfc_attn+fused_optimizer"], runs["torch"]
    sfc_abft, fused_abft = runs["sfc_cuda+sfc_attn+abft"], runs["sfc_cuda+sfc_attn+fused_optimizer+abft"]
    loss_ok, fused_ok = _losses_close(sfc, ref), _losses_close(fused, sfc)
    abft_ok = {"unfused": _losses_close(sfc_abft, sfc), "fused": _losses_close(fused_abft, fused)}
    abft_bitwise = {"unfused": sfc_abft["losses"] == sfc["losses"], "fused": fused_abft["losses"] == fused["losses"]}
    out = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches_expected_per_step": want,
           "fused_launches_expected_per_step": want_fused, "abft_launches_expected_per_step": want_abft,
           "fused_abft_launches_expected_per_step": want_fused_abft, "loss_within_2^-7": loss_ok,
           "fused_loss_within_2^-7_of_unfused": fused_ok, "abft_loss_within_2^-7_of_off": abft_ok,
           "abft_losses_bitwise_off": abft_bitwise, **{f"{k}": v for k, v in runs.items()}}
    emit(out)
    for run, expect in ((sfc, want), (fused, want_fused), (sfc_abft, want_abft), (fused_abft, want_fused_abft)):
        bad_counts = [i for i, c in enumerate(run["launches_per_step"]) if c != expect]
        if bad_counts:
            raise AssertionError(f"train steps {bad_counts} launched {run['launches_per_step']}, expected {expect}")
    if not all(loss_ok) or not all(fused_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"train losses {sfc['losses']} (fused {fused['losses']}) vs torch {ref['losses']}: "
                             "not within 2^-7 or not finite")
    for name, run in (("unfused", sfc_abft), ("fused", fused_abft)):
        if not all(abft_ok[name]) or run["abft"]["sdc_detections"] or not run["abft"]["max_residual_over_tol"] < 1:
            raise AssertionError(f"the {name} train run under ABFT detect: losses {run['losses']}, {run['abft']}")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"{name} training left parameters unchanged: {run['unchanged_params']}")
    if fused["params_with_grad"]:
        raise AssertionError(f"the fused step left weights with a .grad: {fused['params_with_grad']}")
    return out, by_shape, runs, digests


# ---------------------------------------------------------------------------
# olmoe-1b-7b: the grouped expert GEMMs (K3, K9, K10), serving and training
# ---------------------------------------------------------------------------


def moe_rows(cfg, groups: int, tokens_per_group: int) -> int:
    """Rows per expert of the MoE dispatch buffer: groups x capacity, the
    capacity as the JAX package's ``moe_forward`` sets it."""
    cap = max(math.ceil(tokens_per_group * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts), cfg.moe_top_k)
    return groups * cap


@dataclasses.dataclass(frozen=True)
class GroupedGemm:
    """One expert-GEMM launch of olmoe's main path, for the forward (E x
    rows, K) @ (E, K, N): K3 ("fwd"), K9 ("nt": dA (T, K) = dC (T, N)
    W[e]^T) or K10 ("tn": dW[e] (K, N) = A_e^T dC_e); dual for the GLU."""

    name: str
    kind: str  # "fwd" | "nt" | "tn"
    path: str  # the run whose launches the row reports: "serve" | "train"
    experts: int
    rows: int  # per expert
    k: int
    n: int
    glu: bool = False
    preact: bool = False

    @property
    def t(self) -> int:
        return self.experts * self.rows

    @property
    def sets(self) -> int:
        return 2 if self.glu else 1

    @property
    def kernel(self) -> str:
        return {"fwd": "sfc_gemm_grouped", "nt": "sfc_gemm_grouped_nt", "tn": "sfc_gemm_grouped_tn"}[self.kind]

    @property
    def replaces(self) -> str:
        return "src/repro/kernels/sfc_gemm.py:" + {"fwd": "883", "nt": "1642", "tn": "1859"}[self.kind]

    @property
    def key(self):  # the wrapper's launches_by_shape key
        if self.kind == "tn":
            return (self.experts, self.k, self.n, self.t, self.glu)
        return (self.experts, self.t, self.k, self.n, self.glu)

    def flops(self) -> float:
        return 2.0 * self.t * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """Each input read once, each output written once: every expert's
        weights (the dW stacks for K10) once per launch."""
        w = self.experts * self.k * self.n * self.sets
        if self.kind == "fwd":
            return elem * (self.t * self.k + w + (2 if self.preact else 1) * self.t * self.n)
        if self.kind == "nt":
            return elem * (self.sets * self.t * self.n + w + self.t * self.k)
        return elem * (self.t * self.k + self.sets * self.t * self.n + w)

    def shape(self) -> dict:
        return {"experts": self.experts, "rows_per_expert": self.rows, "k": self.k, "n": self.n, "dual": self.glu,
                "preact": self.preact}


def moe_grouped_gemms(cfg):
    """Every distinct expert GEMM of olmoe's serve (decode at batch 4, the
    4 x 128 prefill) and training step (2 x 256 tokens): the GLU (dual-B;
    the training forward's in preact mode) and w_out, forward, dA and dW."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dec, pre, tr = moe_rows(cfg, BATCH, 1), moe_rows(cfg, BATCH, PROMPT), moe_rows(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = []
    for path, label, rows in (("serve", "decode", dec), ("serve", "prefill", pre)):
        out += [GroupedGemm(f"{label}/glu", "fwd", path, e, rows, d, f, glu=True),
                GroupedGemm(f"{label}/w_out", "fwd", path, e, rows, f, d)]
    out += [GroupedGemm("train/glu_preact", "fwd", "train", e, tr, d, f, glu=True, preact=True),
            GroupedGemm("train/w_out", "fwd", "train", e, tr, f, d)]
    for kind in ("nt", "tn"):
        out += [GroupedGemm("train/glu", kind, "train", e, tr, d, f, glu=True),
                GroupedGemm("train/w_out", kind, "train", e, tr, f, d)]
    return out


def _grouped_operands(torch, gm, dtype, gen, rows=None):
    """(kernel args, kernel kwargs, library operands) of one grouped GEMM:
    the library call is one torch.bmm over the (E, rows, .) views, the dual
    forms on concatenated operands."""
    dev = torch.device("cuda")
    rows = rows if rows is not None else (gm.rows,) * gm.experts
    t, e, k, n = sum(rows), gm.experts, gm.k, gm.n

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    if gm.kind == "fwd":
        a, w = r(t, k), r(e, k, n, scale=0.02)
        if not gm.glu:
            return (a, w), {}, (a.view(e, -1, k), w) if len(set(rows)) == 1 else None
        wg = r(e, k, n, scale=0.02)
        kw = dict(preact=True) if gm.preact else dict(activation="silu")
        lib = (a.view(e, -1, k), torch.cat([wg, w], dim=2)) if len(set(rows)) == 1 else None
        return (a, w, wg), kw, lib
    if gm.kind == "nt":  # dA (T, K) = dC (T, N) W[e]^T, W as stored (E, K, N)
        dc, w = r(t, n), r(e, k, n, scale=0.02)
        if not gm.glu:
            return (dc, w), {}, (dc.view(e, -1, n), w.transpose(1, 2)) if len(set(rows)) == 1 else None
        dc2, w2 = r(t, n), r(e, k, n, scale=0.02)
        lib = ((torch.cat([dc, dc2], 1).view(e, -1, 2 * n), torch.cat([w, w2], 2).transpose(1, 2))
               if len(set(rows)) == 1 else None)
        return (dc, w, dc2, w2), {}, lib
    a, dc = r(t, k), r(t, n)
    dc2 = r(t, n) if gm.glu else None
    both = torch.cat([dc, dc2], 1) if gm.glu else dc
    lib = (a.view(e, -1, k).transpose(1, 2), both.view(e, -1, both.shape[1])) if len(set(rows)) == 1 else None
    return (a, dc, dc2), {}, lib


def phase_grouped_gemms(torch, gemms, tk, ragged=True):
    """K3, K9 and K10 against their plain versions at every given shape
    (bf16), timed beside their bound and one torch.bmm of the same product;
    with ``ragged`` then each on the ragged expert sizes RAGGED_GROUPS (one
    expert empty) and RAGGED_GROUPS_LONG (one over a 128-row tile) at the
    first shape's widths, in f32 and bf16.  Every row names the CUDA kernel and tile it launched:
    bf16 on the grouped wgmma kernels, f32 on the 64 x 64 tile kernels."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    dt = torch.bfloat16
    fns = {"fwd": (tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_plain),
           "nt": (tk.sfc_gemm_grouped_nt, tk.sfc_gemm_grouped_nt_plain),
           "tn": (tk.sfc_gemm_grouped_tn, tk.sfc_gemm_grouped_tn_plain)}
    rows, checks = [], []
    for gm in gemms:
        fn, plain_fn = fns[gm.kind]
        gs = dict(group_sizes=(gm.rows,) * gm.experts)
        # every launch streams every expert's weights (0.27-0.55 GB), far
        # past the 50 MB L2: one copy of the inputs is enough
        copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
        ins = [_grouped_operands(torch, gm, dt, gen) for _ in range(copies)]
        args, kw, _ = ins[0]
        # the CUDA kernel it launched and its tile
        got, (name, config) = launched(fn.launches_by_kernel, lambda: fn(*args, **gs, **kw))
        want = plain_fn(*args, **gs, bm=64, bn=64, **kw)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": f"{gm.kernel}:{gm.name}", "shape": gm.shape(), "ok": ok, "max_abs_err": err,
                       "err_over_bound": worst, "kernel": name, "config": config})
        if not ok:
            raise AssertionError(f"{gm.kernel} disagrees with its plain version at {gm}: max err {err}, "
                                 f"err/bound {worst}")
        if "wgmma" not in name:
            raise AssertionError(f"{gm.kernel} at {gm} launched {name}, not its wgmma kernel")
        del got, want
        reps = max(20, copies)
        ms = time_ms(lambda i: fn(*ins[i % copies][0], **gs, **ins[i % copies][1]), reps=reps, graph=True)
        lib_ms = time_ms(lambda i: torch.bmm(*ins[i % copies][2]), reps=reps, graph=True)
        plain_ms = time_ms(lambda i: plain_fn(*args, **gs, bm=64, bn=64, **kw), reps=1, warmup=0)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(2))
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
        del ins, args
        torch.cuda.empty_cache()
    if not ragged:
        return rows, checks
    # the ragged checks: the olmoe widths, four experts, one of them empty
    d, f = gemms[0].k, gemms[0].n
    e = len(RAGGED_GROUPS)
    ragged = [GroupedGemm("ragged/glu", "fwd", "-", e, 0, d, f, glu=True),
              GroupedGemm("ragged/glu_preact", "fwd", "-", e, 0, d, f, glu=True, preact=True),
              GroupedGemm("ragged/w_out", "fwd", "-", e, 0, f, d)]
    ragged += [GroupedGemm(f"ragged/{w}", kind, "-", e, 0, *kn, glu=glu) for kind in ("nt", "tn")
               for w, kn, glu in (("glu", (d, f), True), ("w_out", (f, d), False))]
    for sizes in (RAGGED_GROUPS, RAGGED_GROUPS_LONG):
        for dtype in (torch.float32, torch.bfloat16):
            for gm in ragged:
                fn, plain_fn = fns[gm.kind]
                args, kw, _ = _grouped_operands(torch, gm, dtype, gen, rows=sizes)
                got, (name, config) = launched(fn.launches_by_kernel, lambda: fn(*args, group_sizes=sizes, **kw))
                torch.cuda.synchronize()
                ok, err, worst = within_all(got, plain_fn(*args, group_sizes=sizes, bm=64, bn=64, **kw), dtype)
                if gm.kind == "tn":  # the empty expert's weight gradient is exactly zero
                    ok = ok and not any(bool(g[1].any()) for g in (got if gm.glu else [got]))
                checks.append({"case": f"{gm.kernel}:{gm.name}", "dtype": str(dtype), "group_sizes": list(sizes),
                               "shape": gm.shape(), "ok": ok, "max_abs_err": err, "err_over_bound": worst,
                               "kernel": name, "config": config})
                if not ok:
                    raise AssertionError(f"{gm.kernel} ragged case {gm.name} ({dtype}, {sizes}) disagrees: "
                                         f"max err {err}")
                if ("wgmma" in name) != (dtype == torch.bfloat16):
                    raise AssertionError(f"{gm.kernel} ragged case {gm.name} ({dtype}) launched {name}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class GroupedUpdGemm:
    """K10 in its update or norm mode for the expert projection (E x rows,
    K) @ (E, K, N): each dW_e (K, N) = A_e^T dC_e in the f32 accumulators,
    then per-expert AdamW against the f32 master / mu / nu stacks and W
    written (update), or only sum(dW^2) (norm); dual for the GLU pair."""

    name: str
    mode: str  # "update" | "norm"
    experts: int
    rows: int  # per expert
    k: int
    n: int
    glu: bool = False

    @property
    def t(self) -> int:
        return self.experts * self.rows

    @property
    def sets(self) -> int:
        return 2 if self.glu else 1

    @property
    def key(self):  # sfc_gemm_grouped_tn.launches_by_shape's key for the mode
        return (self.experts, self.k, self.n, self.t, self.glu, self.mode)

    def flops(self) -> float:
        return 2.0 * self.t * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """A and dC read once; update: 12 B of f32 state read and 14 B (the
        state and W) written per weight element of every expert; norm: the
        per-task partials."""
        operands = elem * (self.t * self.k + self.sets * self.t * self.n)
        if self.mode == "update":
            return operands + 26.0 * self.sets * self.experts * self.k * self.n
        return operands + 4.0 * self.sets * self.experts * math.ceil(self.k / 64) * math.ceil(self.n / 64)


def moe_update_gemms(cfg):
    """K10's update mode at olmoe's two expert projections of the training
    step, 80 rows an expert (its norm mode runs the same shapes)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    tr = moe_rows(cfg, TRAIN_BATCH, TRAIN_SEQ)
    return [GroupedUpdGemm("train/glu", "update", e, tr, d, f, glu=True),
            GroupedUpdGemm("train/w_out", "update", e, tr, f, d)]


def phase_grouped_update_gemms(torch, cfg, tk, opt):
    """K10's update and norm modes against their plain versions at olmoe's
    training shapes in bf16 (stochastic rounding on, the main path, timed),
    then on the ragged expert sizes RAGGED_GROUPS at olmoe's widths in f32
    and bf16, the empty expert's g = 0 update included: master, mu and nu
    within the f32 bound; a bf16 W bitwise the stochastic rounding of the
    kernel's own master with the plain version's grouped tile bits and
    within the bf16 bound of the plain W, an f32 W the new master; the
    norms within the f32 bound, the norm mode's bitwise the update mode's.
    Yardstick: torch.bmm per set to an f32 dW stack plus
    torch._fused_adamw_ on the same state (they write no bf16 W)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (5 << 16) + 3
    rows, checks = [], []

    def r(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(gm, dt, sizes):
        """(x, [dC per set], [(master, mu, nu, W) per set]): a later step's
        state, its moments on the scale of dW (about sqrt(rows))."""
        g, t, stack = math.sqrt(max(sizes)), sum(sizes), (gm.experts, gm.k, gm.n)
        x, dcs = r((t, gm.k), 1.0, dt), [r((t, gm.n), 1.0, dt) for _ in range(gm.sets)]
        sets = []
        for _ in range(gm.sets):
            mst = r(stack, 0.02)
            sets.append((mst, r(stack, 0.5 * g), r(stack, 2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return x, dcs, sets

    def update(fn, x, dcs, sets, sizes, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        extra = dict(w2=rest[0][3]) if rest else {}
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, group_sizes=sizes, w=w1,
                  salt=salt, stochastic_round=dt == torch.bfloat16, **extra, **kw)

    def check(gm, dt, sizes, case):
        """Kernel against plain on fresh inputs; returns (result, plain ms
        of the update, the inputs)."""
        x, dcs, sets = inputs(gm, dt, sizes)
        got_sets, want_sets = [tuple(v.clone() for v in st) for st in sets], [tuple(v.clone() for v in st)
                                                                               for st in sets]
        got, (name, config) = launched(tk.sfc_gemm_grouped_tn.launches_by_kernel,
                                       lambda: update(tk.sfc_gemm_grouped_tn, x, dcs, got_sets, sizes, dt))
        norm_only, norm_kernel = launched(tk.sfc_gemm_grouped_tn.launches_by_kernel,
                                          lambda: tk.sfc_gemm_grouped_tn(x, *dcs, group_sizes=sizes, norm=True))
        torch.cuda.synchronize()
        want = []
        plain_ms = time_ms(lambda i: want.append(update(tk.sfc_gemm_grouped_tn_plain, x, dcs, want_sets, sizes, dt,
                                                        bm=64, bn=64)), reps=1, warmup=0)
        ok, norm_err, worst = within(got, want[0], torch.float32)
        res = {"case": f"sfc_gemm_grouped_tn:update:{case}", "dtype": str(dt), "group_sizes": list(sizes),
               "shape": {"experts": gm.experts, "k": gm.k, "n": gm.n, "dual": gm.glu}, "kernel": name,
               "config": config, "norm_kernel": list(norm_kernel), "norm_ok": ok,
               "norm_max_abs_err": norm_err, "norm_err_over_bound": worst,
               "norm_mode_bitwise": bool(torch.equal(norm_only, got))}
        err, worst_state, w_bitwise, empty_moved = 0.0, 0.0, True, True
        for s, (g_set, p_set, o_set) in enumerate(zip(got_sets, want_sets, sets)):
            for g_, w_ in zip(g_set, p_set):
                ok_s, err_s, worst_s = within(g_, w_, torch.float32 if g_.dtype == torch.float32 else dt)
                ok, err, worst_state = ok and ok_s, max(err, err_s), max(worst_state, worst_s)
            if dt == torch.bfloat16:
                bits = tk._grouped_tile_bits(gm.experts, gm.k, gm.n, 64, 64, hyper, salt, s)
                w_bitwise &= bool(torch.equal(g_set[3], tk.stochastic_round_to(g_set[0], bits, dt)))
                del bits
            else:
                w_bitwise &= bool(torch.equal(g_set[3], g_set[0]))
            # an empty expert's moments decay: its g = 0 update ran
            empty_moved &= all(not torch.equal(g_set[1][e], o_set[1][e]) for e, z in enumerate(sizes) if z == 0)
        res.update(ok=ok and w_bitwise and empty_moved and res["norm_mode_bitwise"], max_abs_err=err,
                   state_err_over_bound=worst_state, w_bitwise_sr_of_master=w_bitwise,
                   empty_experts_updated=empty_moved)
        checks.append(res)
        if not res["ok"]:
            raise AssertionError(f"sfc_gemm_grouped_tn update / norm mode disagrees with its plain version: {res}")
        return res, plain_ms, (x, dcs, sets)

    for gm in moe_update_gemms(cfg):
        dt, sizes = torch.bfloat16, (gm.rows,) * gm.experts
        res, plain_upd_ms, (x, dcs, sets) = check(gm, dt, sizes, gm.name)
        # every launch streams 3.5-7 GB of state, far past the 50 MB L2: one copy of the inputs
        step_t = torch.zeros((), device=dev)
        e, rows_e = gm.experts, gm.rows

        def library(i):
            grads = [torch.bmm(x.view(e, rows_e, gm.k).transpose(1, 2), d.view(e, rows_e, gm.n),
                               out_dtype=torch.float32) for d in dcs]
            torch._fused_adamw_([st[0] for st in sets], grads, [st[1] for st in sets], [st[2] for st in sets], [],
                                [step_t] * len(sets), lr=1e-2, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                                amsgrad=False, maximize=False)

        upd_ms = time_ms(lambda i: update(tk.sfc_gemm_grouped_tn, x, dcs, sets, sizes, dt), reps=20, graph=True)
        norm_ms = time_ms(lambda i: tk.sfc_gemm_grouped_tn(x, *dcs, group_sizes=sizes, norm=True), reps=20,
                          graph=True)
        lib_ms = time_ms(library, reps=20, graph=True)
        plain_norm_ms = time_ms(lambda i: tk.sfc_gemm_grouped_tn_plain(x, *dcs, group_sizes=sizes, norm=True, bm=64,
                                                                       bn=64), reps=1, warmup=0)
        for mode, ms, plain_ms, l_ms in (("update", upd_ms, plain_upd_ms, lib_ms),
                                         ("norm", norm_ms, plain_norm_ms, None)):
            g2 = dataclasses.replace(gm, mode=mode)
            bound_ms, bound_by = _bound(g2.flops(), g2.bytes(2))
            rows.append(dict(gemm=g2, max_abs_err=res["max_abs_err"] if mode == "update" else res["norm_max_abs_err"],
                             ms=ms, plain_ms=plain_ms, library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by,
                             kernel=res["kernel"] if mode == "update" else res["norm_kernel"][0],
                             config=res["config"] if mode == "update" else res["norm_kernel"][1]))
        del x, dcs, sets
        torch.cuda.empty_cache()
    # the ragged checks: olmoe's widths, four experts, one of them empty
    for dt in (torch.float32, torch.bfloat16):
        for gm in moe_update_gemms(cfg):
            check(dataclasses.replace(gm, experts=len(RAGGED_GROUPS), rows=0), dt, RAGGED_GROUPS,
                  f"ragged/{gm.name.split('/')[1]}")
    torch.cuda.empty_cache()
    return rows, checks


def moe_routing_at_divergence(torch, np, engines, prompts, tokens_of, top_k, sfc="sfc_cuda"):
    """Why the bf16 sfc_cuda serve's greedy tokens (the run named ``sfc``)
    leave the torch backend's.  Both engines replay the serve (the same prompts, then
    decode steps fed the torch run's tokens, which both runs chose up to
    each request's first divergent token) with every MoE layer's routing
    recorded.  For each request that diverged, at the step that produced
    its first divergent token: the layers whose top-k expert sets differ
    between the backends, the first of them, and, per differing set, the
    torch router's probability of the expert it chose over the one sfc_cuda
    chose in its place (the swap's gap), beside the median gap between the
    torch router's k-th and (k+1)-th expert at that step and the largest
    difference of the two routers' probabilities there; the torch logits'
    top-1 margin at that step; and the (token, layer) sets of the request
    that differ over all its tokens up to that step (the prompt's included)."""
    import repro_torch.models.moe as moe_mod

    route = moe_mod.route
    seen = []

    def recording(*args, **kw):
        r = route(*args, **kw)
        g, tg = r.probs.shape[:2]
        seen.append((r.probs.float(), r.flat_e.reshape(g, tg, top_k)))
        return r

    first = {i: int(np.nonzero(tokens_of[sfc][i] != tokens_of["torch"][i])[0][0])
             for i in range(len(prompts)) if (tokens_of[sfc][i] != tokens_of["torch"][i]).any()}
    if not first:
        return {"diverged_requests": 0}
    steps = max(first.values())
    dev = engines["torch"].device
    forced = torch.from_numpy(tokens_of["torch"]).long().to(dev)
    rec = {}  # name -> [(routing of each layer, logits)] for step 0 (prefill) .. steps
    moe_mod.route = recording
    try:
        for name in (sfc, "torch"):
            eng, rec[name] = engines[name], []
            seen.clear()
            logits, cache = eng._prefill(torch.from_numpy(np.stack(prompts)).long().to(dev))
            rec[name].append((list(seen), logits.float()))
            for s in range(1, steps + 1):
                seen.clear()
                logits, cache = eng._decode(forced[:, s - 1:s], cache)
                rec[name].append((list(seen), logits.float()))
    finally:
        moe_mod.route = route
    out = {"diverged_requests": len(first), "requests": []}
    for i, j in sorted(first.items()):
        layers_s, logits_t = rec[sfc][j][0], rec["torch"][j][1]
        layers_t = rec["torch"][j][0]
        differ, gaps, margins, prob_diff = [], [], [], 0.0
        for layer, ((ps, es), (pt, et)) in enumerate(zip(layers_s, layers_t)):
            ps, es, pt, et = ps[i, -1], es[i, -1], pt[i, -1], et[i, -1]  # the step's last token
            top = torch.sort(pt, descending=True).values
            margins.append(float(top[top_k - 1] - top[top_k]))
            prob_diff = max(prob_diff, float((ps - pt).abs().max()))
            chose_s, chose_t = set(es.tolist()), set(et.tolist())
            if chose_s != chose_t:
                differ.append(layer)
                gaps.append(float(max(pt[e] for e in chose_t - chose_s) - min(pt[e] for e in chose_s - chose_t)))
        upto, total = 0, 0
        for k in range(j + 1):
            for (ps, es), (pt, et) in zip(rec[sfc][k][0], rec["torch"][k][0]):
                a, b = torch.sort(es[i], dim=-1).values, torch.sort(et[i], dim=-1).values
                upto += int((a != b).any(dim=-1).sum())
                total += a.shape[0]
        lt = torch.sort(logits_t[i], descending=True).values
        out["requests"].append({
            "request": i, "first_divergent_token": j, "step": "prefill" if j == 0 else f"decode {j}",
            "layers_with_different_topk": len(differ), "layers": len(layers_t),
            "first_layer_different": differ[0] if differ else None,
            "swapped_prob_gap_torch": gaps,
            # a model without MoE layers records no routing: nothing to take the median of
            "topk_margin_median_torch": float(np.median(margins)) if margins else None,
            "max_abs_router_prob_diff": prob_diff, "torch_top1_logit_margin": float(lt[0] - lt[1]),
            "sets_different_through_step": upto, "sets_through_step": total})
    return out


def phase_moe_serve(torch, np, cfg, build_model, ServingEngine, tk, tsa):
    """ServingEngine serves full-width, full-depth olmoe-1b-7b (bf16, random
    weights from a seeded torch.Generator), 4 requests x 128 + 16 tokens,
    under sfc_cuda GEMMs with blockwise attention and with attn_impl="sfc",
    and under the torch backend: exactly 2 K3 launches a layer a forward
    and 5 K1/K2 a layer (q, k, v, o, the router) plus the head; the
    prefill logits of the same weights cut to MOE_SERVE_F32_LAYERS layers
    in f32 within the bf16 bound of the torch backend's.  Then the sfc_cuda
    serve again under ABFT "detect" (the prefill in `abft_mode`, every
    decode step verified, ``verify_every=1``): no detection, the same
    tokens and launches, every K3 and K1/K2 launch with its checksum lane.
    Every bf16 K3 launch of the three sfc_cuda serves is on the grouped
    wgmma kernel, every one of the f32 cut's on the 64 x 64 tile kernel.
    Returns (summary, K3 launches by shape of the sfc_cuda run and of the
    one under ABFT)."""
    from repro_torch.robust import abft
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    variants = {"sfc_cuda": ("sfc_cuda", "blockwise"), "sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"),
                "torch": ("torch", "blockwise")}

    def engine(name, config, weights):
        gemm, impl = variants[name]
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), weights, max_batch=BATCH,
                             max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")

    engines = {name: engine(name, cfg, params) for name in variants}
    for eng in engines.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()
    n_layers = cfg.n_layers
    counted = {"sfc_gemm_grouped": tk.sfc_gemm_grouped, "sfc_gemm_fused": tk.sfc_gemm_fused,
               "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_decode_attention": tsa.sfc_decode_attention}
    gemm_want = {"sfc_gemm_grouped": 2 * n_layers * NEW_TOKENS, "sfc_gemm_fused": (5 * n_layers + 1) * NEW_TOKENS}
    want = {"sfc_cuda": {**gemm_want, "sfc_flash_fwd": 0, "sfc_decode_attention": 0},
            "sfc_cuda+sfc_attn": {**gemm_want, "sfc_flash_fwd": n_layers,
                                  "sfc_decode_attention": n_layers * (NEW_TOKENS - 1)},
            "torch": {k: 0 for k in counted}}
    # the prefill's K1/K2 (4 x 128 rows) on the wgmma kernel, every decode
    # step's (4 rows) and the prefill's head (its last positions) on the
    # cluster kernel
    want_by_kernel = {"sfc_gemm_wgmma_kernel": 5 * n_layers,
                      "sfc_gemm_cluster_kernel": (5 * n_layers + 1) * NEW_TOKENS - 5 * n_layers}
    # K3 (bf16): every launch on the grouped wgmma kernel
    want_grouped_by_kernel = {"sfc_gemm_grouped_wgmma_kernel": gemm_want["sfc_gemm_grouped"]}
    # K11 (bf16, olmoe's 16 / 16 heads: W 1): every launch on the wgmma kernel
    want_fwd_by_kernel = {"sfc_cuda": {}, "sfc_cuda+sfc_attn": {"flash_fwd_wgmma_kernel": n_layers}, "torch": {}}
    done, launches, by_shape, launches_by_kernel, grouped_by_kernel, fwd_by_kernel = {}, {}, {}, {}, {}, {}
    for name, eng in engines.items():
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_shape"):
                fn.launches_by_shape.clear()
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        tk.sfc_gemm_grouped.launches_by_kernel.clear()
        tsa.sfc_flash_fwd.launches_by_kernel.clear()
        done[name] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in counted.items()}
        launches_by_kernel[name] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
        grouped_by_kernel[name] = by_kernel(tk.sfc_gemm_grouped.launches_by_kernel)
        fwd_by_kernel[name] = by_kernel(tsa.sfc_flash_fwd.launches_by_kernel)
        if name == "sfc_cuda":
            by_shape = dict(tk.sfc_gemm_grouped.launches_by_shape)
    # the sfc_cuda serve under ABFT "detect": a fresh engine (its verify
    # ledger starts at 0) after a warm-up one
    for _ in range(2):
        abft_eng = ServingEngine(dataclasses.replace(cfg, attn_impl="blockwise"), params, max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1,
                                 gemm_backend="sfc_cuda", device="cuda", verify_every=1)
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_shape"):
                fn.launches_by_shape.clear()
        tk.sfc_gemm_grouped.abft_launches = tk.sfc_gemm_fused.abft_launches = 0
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        tk.sfc_gemm_grouped.launches_by_kernel.clear()
        abft.reset_runtime_sdc()
        with abft.abft_mode("detect"):
            done["sfc_cuda+abft"] = abft_eng.run(abft_eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
    launches_by_kernel["sfc_cuda+abft"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    grouped_by_kernel["sfc_cuda+abft"] = by_kernel(tk.sfc_gemm_grouped.launches_by_kernel)
    launches["sfc_cuda+abft"] = {**{k: fn.launches for k, fn in counted.items()},
                                 "sfc_gemm_grouped:abft": tk.sfc_gemm_grouped.abft_launches,
                                 "sfc_gemm_fused:abft": tk.sfc_gemm_fused.abft_launches}
    want["sfc_cuda+abft"] = {**want["sfc_cuda"], "sfc_gemm_grouped:abft": gemm_want["sfc_gemm_grouped"],
                             "sfc_gemm_fused:abft": gemm_want["sfc_gemm_fused"]}
    abft_by_shape = dict(tk.sfc_gemm_grouped.launches_by_shape)
    abft_serve = {"verify": abft_eng.degradation_report()["verify"], "sdc_detections": abft.runtime_sdc_total(),
                  "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio()}
    del abft_eng
    for batch in done.values():
        for r in batch:
            if (r.status != "completed" or len(r.output) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab for t in r.output)):
                raise AssertionError(f"olmoe request {r.uid} ended {r.status} with {len(r.output or [])} tokens")
    reports = {name: ServingEngine.latency_report(batch) for name, batch in done.items()}
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}
    abft_serve["tokens_identical_to_off"] = bool((tokens_of["sfc_cuda+abft"] == tokens_of["sfc_cuda"]).all())
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    divergence = moe_routing_at_divergence(torch, np, engines, prompts, tokens_of, cfg.moe_top_k)
    del engines, eng
    for name, lg in logits.items():
        if tuple(lg.shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"olmoe {name} prefill logits shape {tuple(lg.shape)} or non-finite values")
    # the f32 check on a cut: in bf16 the router's logits round to ties that
    # the two backends break differently, so only f32 isolates the kernels
    cut = dataclasses.replace(cfg, n_layers=MOE_SERVE_F32_LAYERS, param_dtype="float32")
    cut_params = {k: v.float() for k, v in params.items()
                  if not k.startswith("layers.") or int(k.split(".")[1]) < MOE_SERVE_F32_LAYERS}
    tk.sfc_gemm_grouped.launches_by_kernel.clear()
    logits32 = {name: engine(name, cut, cut_params)._prefill(tokens)[0] for name in variants}
    del cut_params
    torch.cuda.synchronize()
    # the f32 cut's K3 on the tile kernel: two launches a layer, two sfc_cuda variants
    grouped_by_kernel["f32_cut"] = by_kernel(tk.sfc_gemm_grouped.launches_by_kernel)
    want_grouped_f32 = {"sfc_gemm_grouped_kernel": 2 * 2 * MOE_SERVE_F32_LAYERS}
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits32[name], logits32["torch"], torch.bfloat16)))
                 for name in ("sfc_cuda", "sfc_cuda+sfc_attn")}
    out = {
        "phase": "serve_moe", "arch": cfg.name, "layers": n_layers, "d_model": cfg.d_model,
        "experts": cfg.n_experts, "top_k": cfg.moe_top_k, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
        "params": n_params, "init_s": init_s, "requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "launches": launches, "launches_expected": want,
        "sfc_gemm_fused_launches_by_kernel": launches_by_kernel, "by_kernel_expected": want_by_kernel,
        "sfc_gemm_grouped_launches_by_kernel": grouped_by_kernel, "sfc_flash_fwd_launches_by_kernel": fwd_by_kernel,
        "grouped_by_kernel_expected": {"bf16": want_grouped_by_kernel, "f32_cut": want_grouped_f32},
        "prefill_logits": {
            "f32_cut_layers": MOE_SERVE_F32_LAYERS, "f32_vs_torch": f32_agree,
            "bf16_sfc_cuda_vs_torch_mean_abs_err": float((logits["sfc_cuda"] - logits["torch"]).abs().mean()),
            "bf16_max_abs_logit": float(logits["torch"].abs().max()),
        },
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in ("sfc_cuda", "sfc_cuda+sfc_attn")},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean())
                               for name in ("sfc_cuda", "sfc_cuda+sfc_attn")},
        "routing_at_divergence": divergence,
        "latency": reports,
        "abft_detect": abft_serve,
    }
    emit(out)
    del model, params, logits, logits32
    gc.collect()
    torch.cuda.empty_cache()
    for name, expect in want.items():
        if launches[name] != expect:
            raise AssertionError(f"olmoe {name} serve launched {launches[name]}, expected {expect}")
        if name != "torch" and launches_by_kernel[name] != want_by_kernel:
            raise AssertionError(f"olmoe {name} serve launched K1/K2 {launches_by_kernel[name]} by kernel, "
                                 f"expected {want_by_kernel}")
        if name != "torch" and grouped_by_kernel[name] != want_grouped_by_kernel:
            raise AssertionError(f"olmoe {name} serve launched K3 {grouped_by_kernel[name]} by kernel, "
                                 f"expected {want_grouped_by_kernel}")
    if fwd_by_kernel != want_fwd_by_kernel:
        raise AssertionError(f"olmoe serves launched K11 {fwd_by_kernel} by kernel, expected {want_fwd_by_kernel}")
    if grouped_by_kernel["f32_cut"] != want_grouped_f32:
        raise AssertionError(f"the olmoe f32 cut launched K3 {grouped_by_kernel['f32_cut']} by kernel, expected "
                             f"{want_grouped_f32}")
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"olmoe f32 prefill logits {name} vs torch: max err {res['max_abs_err']}, "
                                 f"err/bound {res['err_over_bound']}")
    if abft_serve["sdc_detections"] or not abft_serve["tokens_identical_to_off"] or not (
            abft_serve["max_residual_over_tol"] < 1):
        raise AssertionError(f"the olmoe serve under ABFT detect: {abft_serve}")
    return out, by_shape, abft_by_shape


def phase_moe_train(torch, cfg, build_trainer, counted):
    """Three steps of `build_trainer` on olmoe-1b-7b at full width and
    MOE_TRAIN_LAYERS layers under sfc_cuda + attn_impl="sfc" (K3, K9, K10
    for the experts; K1/K2, K7, K8 for attention, the router and the head;
    K11-K13), the same steps from the same init with the fused optimizer
    (K8's and K10's norm and update modes, no dW launch, no routed weight
    left with a .grad), then under torch + blockwise: exact launches a
    step (by kernel too: every bf16 K3 / K9 launch on the grouped wgmma
    kernels), every unfused loss within 2^-7 of the torch backend's and every
    fused loss within 2^-7 of the unfused one's, every parameter moved;
    then a profiled step of each.  Returns (summary, launches by shape of
    each sfc run)."""
    cut = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    n_layers = MOE_TRAIN_LAYERS
    dense = 5 * n_layers + 1  # q, k, v, o and the router a layer, plus the head
    grouped = 2 * n_layers  # the GLU pair and w_out a layer
    want = {"sfc_gemm_fused": dense, "sfc_gemm_nt": dense, "sfc_gemm_tn": dense,
            "sfc_gemm_tn:dw": dense, "sfc_gemm_tn:norm": 0, "sfc_gemm_tn:update": 0,
            "sfc_gemm_fused:wgmma": dense, "sfc_gemm_fused:tile": 0, "sfc_gemm_nt:wgmma": dense,
            "sfc_gemm_nt:tile": 0,
            "sfc_gemm_grouped": grouped, "sfc_gemm_grouped_nt": grouped, "sfc_gemm_grouped_tn": grouped,
            "sfc_gemm_grouped:wgmma": grouped, "sfc_gemm_grouped:tile": 0, "sfc_gemm_grouped_nt:wgmma": grouped,
            "sfc_gemm_grouped_nt:tile": 0,
            "sfc_gemm_grouped_tn:dw": grouped, "sfc_gemm_grouped_tn:norm": 0, "sfc_gemm_grouped_tn:update": 0,
            "sfc_gemm_tn:wgmma": dense, "sfc_gemm_tn:tile": 0, "sfc_gemm_grouped_tn:wgmma": grouped,
            "sfc_gemm_grouped_tn:tile": 0, "sfc_flash_fwd": n_layers, "sfc_flash_bwd_dq": n_layers, "sfc_flash_bwd_dkv": n_layers,
            "sfc_flash_fwd:wgmma": n_layers, "sfc_flash_fwd:tile": 0,
            "sfc_flash_bwd_dq:wgmma": n_layers, "sfc_flash_bwd_dq:tile": 0,
            "sfc_flash_bwd_dkv:wgmma": n_layers, "sfc_flash_bwd_dkv:tile": 0}
    # the fused step: K8 and K10 run their norm mode in the backward and
    # their update mode after it, and never write a routed weight's dW; the
    # router stays unrouted, as in the JAX package (its dW: K8's dW mode)
    routed = dense - n_layers
    want_fused = {**want, "sfc_gemm_tn": 2 * routed + n_layers, "sfc_gemm_tn:dw": n_layers,
                  "sfc_gemm_tn:norm": routed, "sfc_gemm_tn:update": routed, "sfc_gemm_grouped_tn": 2 * grouped,
                  "sfc_gemm_grouped_tn:dw": 0, "sfc_gemm_grouped_tn:norm": grouped,
                  "sfc_gemm_grouped_tn:update": grouped, "sfc_gemm_tn:wgmma": 2 * routed + n_layers,
                  "sfc_gemm_grouped_tn:wgmma": 2 * grouped}
    runs, by_shape = {}, {}
    for name, (gemm, impl, fused) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False)),
                                      ("sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True)),
                                      ("torch", ("torch", "blockwise", False))):
        runs[name], shapes = _train_run(torch, cut, build_trainer, counted, gemm, impl, fused, _MOE_KERNEL_GROUPS,
                                        digests=fused)
        if gemm == "sfc_cuda":
            by_shape[name] = shapes
    digests = {name: run.pop("digests") for name, run in runs.items() if "digests" in run}
    sfc, fused, ref = runs["sfc_cuda+sfc_attn"], runs["sfc_cuda+sfc_attn+fused_optimizer"], runs["torch"]
    loss_ok, fused_ok = _losses_close(sfc, ref), _losses_close(fused, sfc)
    out = {"phase": "train_moe", "arch": cfg.name, "layers": n_layers, "layers_of_config": cfg.n_layers,
           "params_bytes_per_param": 16, "dtype": cfg.param_dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "launches_expected_per_step": want, "fused_launches_expected_per_step": want_fused,
           "loss_within_2^-7": loss_ok, "fused_loss_within_2^-7_of_unfused": fused_ok, **runs}
    emit(out)
    for run, expect in ((sfc, want), (fused, want_fused)):
        bad_counts = [i for i, c in enumerate(run["launches_per_step"]) if c != expect]
        if bad_counts:
            raise AssertionError(f"olmoe train steps {bad_counts} launched {run['launches_per_step']}, "
                                 f"expected {expect}")
    if not all(loss_ok) or not all(fused_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"olmoe train losses {sfc['losses']} (fused {fused['losses']}) vs torch "
                             f"{ref['losses']}: not within 2^-7 or not finite")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"olmoe {name} training left parameters unchanged: {run['unchanged_params']}")
    if fused["params_with_grad"]:
        raise AssertionError(f"the fused olmoe step left weights with a .grad: {fused['params_with_grad']}")
    return out, by_shape, runs, digests


# ---------------------------------------------------------------------------
# the hybrid family: zamba2-1.2b (Mamba2 SSD layers and a shared attention
# block); chunk_einsum on K2, its f32-output mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkGemm:
    """One `chunk_einsum` product in its batched framing, (batch, M, K) @
    (batch, K, N) with per-batch B, on K2: ``f32_out`` the f32-output mode
    (bf16 in, the f32 accumulator out), ``f32_in`` f32 in and out (the
    mLSTM's output product, the tile kernel), else bf16 in and out; batch
    0 a plain-mode (M, K) @ (K, N).  ``path``: the serve whose run launches
    it at this shape (e.g. "zamba2 serve", "xlstm serve 1x600"), None for a
    check row; ``unaligned``: A a view 2 bytes past a 16-byte boundary."""

    name: str
    batch: int
    m: int
    k: int
    n: int
    f32_out: bool
    path: Optional[str]
    unaligned: bool = False
    f32_in: bool = False

    @property
    def key(self):  # sfc_gemm_fused.launches_by_shape
        return (self.batch, self.m, self.k, self.n, False)

    @property
    def in_elem(self) -> int:
        return 4 if self.f32_in else 2

    @property
    def out_elem(self) -> int:
        return 4 if self.f32_out or self.f32_in else 2

    def flops(self) -> float:
        return 2.0 * max(self.batch, 1) * self.m * self.k * self.n

    def bytes(self) -> float:
        b = max(self.batch, 1)
        return self.in_elem * b * (self.m * self.k + self.k * self.n) + self.out_elem * b * self.m * self.n

    @property
    def peak(self) -> float:
        return PEAK_F32_FLOPS if self.f32_in else PEAK_BF16_FLOPS


def chunk_gemms(cfg, xcfg):
    """The SSD's two intra-chunk products at the zamba2 serve's shapes (4 x
    128: one 128-step chunk; the 1 x HYBRID_LONG_PROMPT prompt: chunks of
    ``ssm_chunk`` steps, the last padded), the scores in the f32-output
    mode and the output in bf16; xlstm-1.3b's two mLSTM products (4 heads
    of 1024) at its serve's shapes (4 x 128: one 128-step chunk; the 1 x
    HYBRID_LONG_PROMPT prompt: two 512-step chunks, one launch of each
    product a chunk), the qk scores in the f32-output mode, the output
    product in f32; a ragged unaligned case and a plain-mode A of 4 rows
    in the f32-output mode, off the path (its check rows)."""
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    short = min(cfg.ssm_chunk, PROMPT)
    long_ = min(cfg.ssm_chunk, HYBRID_LONG_PROMPT)
    chunks = math.ceil(HYBRID_LONG_PROMPT / long_)
    long_path = f"zamba2 serve 1x{HYBRID_LONG_PROMPT}"
    xh, xp = xcfg.n_heads, 2 * xcfg.d_model // xcfg.n_heads
    x_short, x_long = min(xcfg.ssm_chunk, PROMPT), min(xcfg.ssm_chunk, HYBRID_LONG_PROMPT)
    x_path = f"xlstm serve 1x{HYBRID_LONG_PROMPT}"
    return [
        ChunkGemm(f"ssd_scores@{BATCH}x{PROMPT}", BATCH * math.ceil(PROMPT / short), short, n, short, True,
                  "zamba2 serve"),
        ChunkGemm(f"ssd_scores@1x{HYBRID_LONG_PROMPT}", chunks, long_, n, long_, True, long_path),
        ChunkGemm(f"mlstm_qk@{BATCH}x{PROMPT}", BATCH * xh, x_short, xp, x_short, True, "xlstm serve"),
        ChunkGemm(f"mlstm_qk@1x{HYBRID_LONG_PROMPT}", xh, x_long, xp, x_long, True, x_path),
        ChunkGemm("ragged_unaligned", 3, 60, 50, 70, True, None, unaligned=True),
        ChunkGemm("plain_m4", 0, BATCH, 2048, 256, True, None),
        ChunkGemm(f"ssd_out@{BATCH}x{PROMPT}", BATCH * heads, short, short, p, False, "zamba2 serve"),
        ChunkGemm(f"ssd_out@1x{HYBRID_LONG_PROMPT}", chunks * heads, long_, long_, p, False, long_path),
        ChunkGemm(f"mlstm_out@{BATCH}x{PROMPT}", BATCH * xh, x_short, x_short, xp, False, "xlstm serve", f32_in=True),
        ChunkGemm(f"mlstm_out@1x{HYBRID_LONG_PROMPT}", xh, x_long, x_long, xp, False, x_path, f32_in=True),
    ]


def chunk_route(gm) -> str:
    """The kernel `sfc_gemm_fused` launches for a chunk product: the wgmma
    kernel (its f32-output twin for the f32 mode) where TMA can describe
    the rows of a batched bf16 product, else the tile kernel (its
    f32-output twin for the f32 mode)."""
    if gm.f32_in or gm.unaligned or gm.k % 8 or gm.n % 8 or not gm.batch:
        return "sfc_gemm_fused_f32out_kernel" if gm.f32_out else "sfc_gemm_fused_kernel"
    return "sfc_gemm_wgmma_f32out_kernel" if gm.f32_out else "sfc_gemm_wgmma_kernel"


def phase_chunk_gemms(torch, gemms, tk, abft, lanes=True):
    """K2 at the chunk-einsum shapes against its plain version, timed with
    inputs (A and the per-batch B) rotated past the L2 beside one
    ``torch.bmm`` (``out_dtype=torch.float32`` for the f32 mode; the
    plain-mode row ``torch.mm``); then each batched bf16 one with its ABFT
    lane: the lane within `lane_limit` of its plain version's and
    `tolerance()` of the operand-side reference, the output bitwise the
    lane-off one, timed on and off.  Returns (rows, checks, lane rows, lane
    checks)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    rows, checks, lane_rows, lane_checks = [], [], [], []
    for gm in gemms:
        idt = torch.float32 if gm.f32_in else torch.bfloat16
        odt = torch.float32 if gm.f32_out or gm.f32_in else torch.bfloat16
        lead = (gm.batch,) if gm.batch else ()
        copies = max(1, math.ceil(4 * L2_BYTES / (gm.in_elem * max(gm.batch, 1) * (gm.m * gm.k + gm.k * gm.n))))
        count = max(gm.batch, 1) * gm.m * gm.k

        def operand(i):
            flat = torch.randn(count + 8, generator=gen, device=dev).to(idt)
            a = (flat[1:1 + count] if gm.unaligned else flat[:count]).view(*lead, gm.m, gm.k)
            return a, (torch.randn((*lead, gm.k, gm.n), generator=gen, device=dev) * 0.1).to(idt)

        ops_ = [operand(i) for i in range(copies)]
        a, b = ops_[0]

        def kernel(i, lane=False):
            x, w = ops_[i % copies]
            return tk.sfc_gemm_fused(x, w, out_dtype=odt, abft=lane)

        got, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: kernel(0))

        def plain(i):
            x, w = ops_[i % copies]
            return tk.sfc_gemm_fused_plain(x, w, bm=64, bn=64, out_dtype=odt)

        want, plain_ms = _once_ms(torch, lambda: plain(0))
        ok, err, worst = within(got, want, odt)
        checks.append({"case": f"chunk_einsum:{gm.name}", "shape": [gm.batch, gm.m, gm.k, gm.n],
                       "in": str(idt), "out": str(odt), "kernel": name, "config": config, "ok": ok,
                       "max_abs_err": err, "err_over_bound": worst})
        if not ok or name != chunk_route(gm) or got.dtype != odt:
            raise AssertionError(f"chunk product {gm} on {name} ({got.dtype}) disagrees with its plain version: "
                                 f"max err {err}, err/bound {worst}")
        mm = torch.bmm if gm.batch else torch.mm
        if gm.f32_out:
            library = lambda i: mm(*ops_[i % copies], out_dtype=torch.float32)  # noqa: E731
        else:
            library = lambda i: mm(*ops_[i % copies])  # noqa: E731
        reps = max(20, copies)
        ms = time_ms(kernel, reps=reps, graph=True)
        lib_ms = time_ms(library, reps=reps, graph=True)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(), gm.peak)
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, kernel=name, config=config))
        if gm.f32_in or not gm.batch or not lanes:
            # no lane row: the f32 lanes and the plain-mode f32-output lane
            # are held at other shapes (the ragged rows, the card tests),
            # and the training shapes' lanes are those of their serve's
            del ops_, a, b, got, want
            continue
        # the lane: per batch element at the launch's C tile (per-batch B
        # walks each element's tiles in turn)
        on = kernel(0, True)
        plain_lane, lane_plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_fused_plain(a, b, bm=64, bn=64,
                                                                                   out_dtype=odt, abft=True))
        ref, mag = abft.gemm_checksum_ref(a, b)
        exact = torch.bmm(a.float(), b.float())
        tile = tuple(int(x) for x in config.split("x")) if "wgmma" in name else (LANE_TILE, LANE_TILE)
        tiles = raw_tile_sums(torch, exact, tile=tile)
        lane_name = name.replace("_kernel", "_abft_kernel")
        lane_checks.append(_lane_check(torch, abft, f"K2 chunk_einsum:{gm.name}", on[-1], plain_lane[-1], ref, mag,
                                       gm.k, on[:-1], (got,), tiles, _dropped(plain_lane[-1], tiles),
                                       dtype="bfloat16", out=str(odt), kernel=lane_name, config=config))
        on_ms = time_ms(lambda i: kernel(i, True), reps=reps, graph=True)
        ref_ms = time_ms(lambda i: abft.gemm_checksum_ref(*ops_[i % copies]), reps=reps, graph=True)
        slots = tk.build.WGMMA_LANE_SLOTS if "wgmma" in name else 1
        lane_rows.append(_lane_row("K2 chunk_einsum", gm, abs(float(on[-1]) - float(plain_lane[-1])), on_ms, ms,
                                   ref_ms, lane_plain_ms, (gm.flops(), gm.bytes(), PEAK_BF16_FLOPS),
                                   len(tiles) * slots, cuda_kernel=lane_name, config=config))
        del ops_, a, b, got, want, on, exact, tiles
    return rows, checks, lane_rows, lane_checks


def hybrid_projection_gemms(cfg):
    """The shared attention block's K1/K2 products of the zamba2 serve:
    decode (4 rows, the plain mode) and the 4 x 128 prefill (batched); the
    LM head and the mixers' in_proj / out_proj are torch.matmul."""
    return [dataclasses.replace(gm, name=f"zamba2/{gm.name}") for gm in main_path_gemms(cfg)
            if gm.mode != "train" and gm.name != "head"]


# a decode step's device time by group in the hybrid serve (first matching
# fragment wins: the SFC kernels before cuBLAS's GEMMs, whose names hold "gemm")
_HYBRID_KERNEL_GROUPS = (("sfc_gemm_wgmma_f32out_kernel", "K2 f32 out"), ("sfc_gemm_fused_f32out_kernel", "K2 f32 out"),
                         ("sfc_gemm_cluster_kernel", "K1 cluster"), ("sfc_gemm_wgmma_kernel", "K2 wgmma"),
                         ("sfc_gemm_fused_kernel", "K1/K2"), ("decode_split_kernel", "K14"),
                         ("flash_fwd", "K11"), ("gemm", "torch.matmul"), ("nvjet", "torch.matmul"))


def phase_hybrid_serve(torch, np, cfg, build_model, ServingEngine, tk, tsa, ops):
    """ServingEngine serves full-width, full-depth zamba2-1.2b (38 Mamba2
    layers, the shared attention block after every 6, d_model 2048, bf16,
    seeded random weights): 4 requests x PROMPT + NEW_TOKENS under sfc_cuda
    with blockwise and with "sfc" attention and under torch, and one
    HYBRID_LONG_PROMPT-token prompt + HYBRID_LONG_NEW under sfc_cuda +
    "sfc" and torch.  Launch counts exact, reckoned from the structure:
    per prefill 2 x n_layers chunk_einsum products on K2 (the n_layers
    scores in the f32-output mode), 6 K1/K2 a shared-block application
    (q, k, v, o, the GLU, w_out), and the same 6 an application a decode
    step on the cluster kernel; under "sfc" one K11 an application a
    prefill and one K14 an application a decode step; none under torch.
    The f32 prefill logits of the same weights under each sfc_cuda variant
    within the bf16 bound of torch's, and each bf16 variant's logits as
    close to that f32 model as torch's are (ACCURACY_PARITY).  Returns
    (summary, {run: sfc_gemm_fused launches by shape})."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    long_prompt = [rng.integers(0, cfg.vocab, size=HYBRID_LONG_PROMPT).astype(np.int32)]
    long_name = f"1x{HYBRID_LONG_PROMPT}"
    variants = {"sfc_cuda": ("sfc_cuda", "blockwise"), "sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"),
                "torch": ("torch", "blockwise")}

    def engine(name, config, weights, long_=False):
        gemm, impl = variants[name]
        seq = HYBRID_LONG_PROMPT + HYBRID_LONG_NEW + 1 if long_ else PROMPT + NEW_TOKENS + 1
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), weights, max_batch=BATCH, max_seq=seq,
                             gemm_backend=gemm, device="cuda")

    runs = {name: (engine(name, cfg, params), prompts, NEW_TOKENS) for name in variants}
    runs.update({f"{name}@{long_name}": (engine(name, cfg, params, True), long_prompt, HYBRID_LONG_NEW)
                 for name in ("sfc_cuda+sfc_attn", "torch")})
    for eng, ps, _ in runs.values():  # warm-up: first launches, allocator, task tables
        eng.run(eng.submit_many(ps[:1], max_new_tokens=2))
    torch.cuda.synchronize()

    groups = cfg.n_layers // cfg.attn_every
    shared = groups * 6  # q, k, v, o, the GLU, w_out an application

    def want(name, new):
        if name.startswith("torch"):
            return {"K1/K2": 0, "f32_out": 0, "by_kernel": {}, "K11": 0, "K14": 0}
        attn = "sfc_attn" in name
        return {"K1/K2": 2 * cfg.n_layers + shared + (new - 1) * shared, "f32_out": cfg.n_layers,
                "by_kernel": {"sfc_gemm_wgmma_f32out_kernel": cfg.n_layers,
                              "sfc_gemm_wgmma_kernel": cfg.n_layers + shared,
                              "sfc_gemm_cluster_kernel": (new - 1) * shared},
                "K11": groups if attn else 0, "K14": groups * (new - 1) if attn else 0}

    counts, by_shape, done, reports = {}, {}, {}, {}
    for name, (eng, ps, new) in runs.items():
        for fn in (tk.sfc_gemm_fused, tsa.sfc_flash_fwd, tsa.sfc_decode_attention):
            fn.launches = 0
        tk.sfc_gemm_fused.f32_out_launches = 0
        tk.sfc_gemm_fused.launches_by_shape.clear()
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        done[name] = eng.run(eng.submit_many(ps, max_new_tokens=new))
        torch.cuda.synchronize()
        counts[name] = {"K1/K2": tk.sfc_gemm_fused.launches, "f32_out": tk.sfc_gemm_fused.f32_out_launches,
                        "by_kernel": by_kernel(tk.sfc_gemm_fused.launches_by_kernel),
                        "K11": tsa.sfc_flash_fwd.launches, "K14": tsa.sfc_decode_attention.launches}
        by_shape[name] = dict(tk.sfc_gemm_fused.launches_by_shape)
        reports[name] = eng.latency_report(done[name])
        for r in done[name]:
            if r.status != "completed" or len(r.output) != new or not all(0 <= t < cfg.vocab for t in r.output):
                raise AssertionError(f"zamba2 {name}: request {r.uid} ended {r.status} with {len(r.output or [])} "
                                     "tokens")
    expected = {name: want(name, new) for name, (_, _, new) in runs.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    long_tokens = torch.from_numpy(np.stack(long_prompt)).long().cuda()
    decode_profile = profile_decode(torch, runs["sfc_cuda"][0], tokens, ops, kernel_groups=_HYBRID_KERNEL_GROUPS)
    logits = {name: eng._prefill(long_tokens if long_name in name else tokens)[0].float()
              for name, (eng, _, _) in runs.items()}
    del runs, eng
    params32 = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    for name in variants:
        logits[name + "_f32"] = engine(name, cfg32, params32)._prefill(tokens)[0]
    for name in ("sfc_cuda+sfc_attn", "torch"):
        logits[f"{name}@{long_name}_f32"] = engine(name, cfg32, params32, True)._prefill(long_tokens)[0]
    del params32
    sfc = ("sfc_cuda", "sfc_cuda+sfc_attn", f"sfc_cuda+sfc_attn@{long_name}")

    def torch_of(name):
        return f"torch@{long_name}" if long_name in name else "torch"

    for name in sfc:
        if not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"zamba2 {name}: non-finite prefill logits")
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits[name + "_f32"], logits[torch_of(name) + "_f32"], torch.bfloat16)))
                 for name in sfc}
    noise = {name: float((logits[name] - logits[torch_of(name) + "_f32"]).abs().mean())
             for name in (*sfc, "torch", f"torch@{long_name}")}
    parity = {name: noise[name] <= ACCURACY_PARITY * noise[torch_of(name)] for name in sfc}
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}
    summary = {
        "phase": "serve_hybrid", "arch": cfg.name, "layers": cfg.n_layers, "attn_every": cfg.attn_every,
        "shared_block_applications": groups, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "ssm_state": cfg.ssm_state, "ssm_head_dim": cfg.ssm_head_dim, "ssm_chunk": cfg.ssm_chunk,
        "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s, "peak_memory_gb": peak_gb,
        "requests": {"4x": [BATCH, PROMPT, NEW_TOKENS], long_name: [1, HYBRID_LONG_PROMPT, HYBRID_LONG_NEW]},
        "launches": counts, "launches_expected": expected,
        "prefill_logits": {"f32_vs_torch": f32_agree, "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity,
                           "first_token_match": {name: float((logits[name].argmax(-1) ==
                                                              logits[torch_of(name)].argmax(-1)).float().mean())
                                                 for name in sfc}},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of[torch_of(name)]).mean()) for name in sfc},
        "latency": {name: {key: rep[key] for key in ("ttft_mean_s", "ttft_p50_s", "token_p50_s", "tokens_per_s",
                                                     "latency_mean_s")} for name, rep in reports.items()},
        "decode_step_profile": decode_profile,
    }
    emit(summary)
    if counts != expected:
        raise AssertionError(f"zamba2 serves launched {counts}, expected {expected}")
    for name in sfc:
        if not f32_agree[name]["ok"]:
            raise AssertionError(f"zamba2 f32 prefill logits {name} vs torch: {f32_agree[name]}")
    if not all(parity.values()):
        raise AssertionError(f"zamba2 bf16 logits further from the f32 model than torch's: {noise}")
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape


# ---------------------------------------------------------------------------
# the xLSTM family: xlstm-1.3b (mLSTM and sLSTM blocks); the mLSTM's two
# chunk products on K2 in its two f32 modes
# ---------------------------------------------------------------------------


def _reset_gemm_counts(tk):
    tk.sfc_gemm_fused.launches = 0
    tk.sfc_gemm_fused.f32_out_launches = 0
    tk.sfc_gemm_fused.launches_by_shape.clear()
    tk.sfc_gemm_fused.launches_by_kernel.clear()


def _gemm_counts(tk) -> dict:
    return {"K1/K2": tk.sfc_gemm_fused.launches, "f32_out": tk.sfc_gemm_fused.f32_out_launches,
            "by_kernel": by_kernel(tk.sfc_gemm_fused.launches_by_kernel)}


def phase_xlstm_serve(torch, np, cfg, build_model, ServingEngine, tk, ops, gemm_backend):
    """ServingEngine serves full-width, full-depth xlstm-1.3b (48 blocks: 6
    groups of 7 mLSTM blocks and one sLSTM block, d_model 2048, 4 heads of
    1024, chunk 512, bf16, seeded random weights): 4 requests x PROMPT +
    NEW_TOKENS and one HYBRID_LONG_PROMPT-token prompt + HYBRID_LONG_NEW,
    each under sfc_cuda and torch.  Launch counts exact, reckoned from the
    structure: per prefill and chunk, each mLSTM block's qk scores in K2's
    f32-output mode (the wgmma kernel) and its output product in f32 (the
    tile kernel); none in a decode step (its products are torch.einsum and
    its projections torch.matmul) and none under torch.  The f32 prefill
    logits of a cut to one group (XLSTM_CHECK_LAYERS blocks) of the same
    weights under sfc_cuda within the bf16 bound of torch's at both prompt
    lengths, and the cut's bf16 sfc_cuda logits as close to the f32 torch
    ones as torch's bf16 are (ACCURACY_PARITY).  Returns (summary, {run:
    sfc_gemm_fused launches by shape})."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    del model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    long_prompt = [rng.integers(0, cfg.vocab, size=HYBRID_LONG_PROMPT).astype(np.int32)]
    long_name = f"1x{HYBRID_LONG_PROMPT}"

    def engine(gemm, long_=False):
        seq = HYBRID_LONG_PROMPT + HYBRID_LONG_NEW + 1 if long_ else PROMPT + NEW_TOKENS + 1
        return ServingEngine(cfg, params, max_batch=BATCH, max_seq=seq, gemm_backend=gemm, device="cuda")

    runs = {name: (engine(name), prompts, NEW_TOKENS, PROMPT) for name in ("sfc_cuda", "torch")}
    runs.update({f"{name}@{long_name}": (engine(name, True), long_prompt, HYBRID_LONG_NEW, HYBRID_LONG_PROMPT)
                 for name in ("sfc_cuda", "torch")})
    for eng, ps, _, _ in runs.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(ps[:1], max_new_tokens=2))
    torch.cuda.synchronize()

    n_mlstm = (cfg.n_layers // cfg.slstm_every) * (cfg.slstm_every - 1)

    def want(name, prompt_len):
        if name.startswith("torch"):
            return {"K1/K2": 0, "f32_out": 0, "by_kernel": {}}
        chunks = math.ceil(prompt_len / min(cfg.ssm_chunk, prompt_len))
        return {"K1/K2": 2 * n_mlstm * chunks, "f32_out": n_mlstm * chunks,
                "by_kernel": {"sfc_gemm_wgmma_f32out_kernel": n_mlstm * chunks,
                              "sfc_gemm_fused_kernel": n_mlstm * chunks}}

    counts, by_shape, done, reports = {}, {}, {}, {}
    for name, (eng, ps, new, _) in runs.items():
        _reset_gemm_counts(tk)
        done[name] = eng.run(eng.submit_many(ps, max_new_tokens=new))
        torch.cuda.synchronize()
        counts[name] = _gemm_counts(tk)
        by_shape[name] = dict(tk.sfc_gemm_fused.launches_by_shape)
        reports[name] = eng.latency_report(done[name])
        for r in done[name]:
            if r.status != "completed" or len(r.output) != new or not all(0 <= t < cfg.vocab for t in r.output):
                raise AssertionError(f"xlstm {name}: request {r.uid} ended {r.status} with {len(r.output or [])} "
                                     "tokens")
    expected = {name: want(name, plen) for name, (_, _, _, plen) in runs.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    long_tokens = torch.from_numpy(np.stack(long_prompt)).long().cuda()
    decode_profile = profile_decode(torch, runs["sfc_cuda"][0], tokens, ops, kernel_groups=_HYBRID_KERNEL_GROUPS)
    logits = {name: eng._prefill(long_tokens if long_name in name else tokens)[0].float()
              for name, (eng, _, _, _) in runs.items()}
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}
    del runs, eng

    # the cut: the first group's blocks, the embedding, the final norm and
    # the head of the same weights, in bf16 and f32
    cut = dataclasses.replace(cfg, n_layers=XLSTM_CHECK_LAYERS)
    kept = ("embed", "final_norm.", "head", "mlstm.0.", "slstm.0.")
    cut_params = {k: v for k, v in params.items() if k.startswith(kept)}
    del params
    cut_logits, cut_counts = {}, {}
    for dtype in ("bfloat16", "float32"):
        m = build_model(dataclasses.replace(cut, param_dtype=dtype), device="cuda")
        m.load_state_dict({k: v.to(getattr(torch, dtype)) for k, v in cut_params.items()})
        for gemm in ("sfc_cuda", "torch"):
            for name, toks in (("4x", tokens), (long_name, long_tokens)):
                _reset_gemm_counts(tk)
                with gemm_backend(gemm):
                    cut_logits[(gemm, dtype, name)] = m.prefill(toks)[0].float()
                torch.cuda.synchronize()
                if gemm == "sfc_cuda":
                    cut_counts[f"{dtype}@{name}"] = _gemm_counts(tk)
        del m
    f32_agree, noise, parity = {}, {}, {}
    for name in ("4x", long_name):
        ref = cut_logits[("torch", "float32", name)]
        f32_agree[name] = dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                   within(cut_logits[("sfc_cuda", "float32", name)], ref, torch.bfloat16)))
        noise[name] = {gemm: float((cut_logits[(gemm, "bfloat16", name)] - ref).abs().mean())
                       for gemm in ("sfc_cuda", "torch")}
        parity[name] = noise[name]["sfc_cuda"] <= ACCURACY_PARITY * noise[name]["torch"]
    # the cut in f32: both products of each of its mLSTM blocks on the tile
    # kernel (f32 in), none in the f32-output mode
    cut_m = XLSTM_CHECK_LAYERS - 1
    cut_expected = {}
    for dtype in ("bfloat16", "float32"):
        for name, plen in (("4x", PROMPT), (long_name, HYBRID_LONG_PROMPT)):
            chunks = math.ceil(plen / min(cfg.ssm_chunk, plen))
            cut_expected[f"{dtype}@{name}"] = (
                {"K1/K2": 2 * cut_m * chunks, "f32_out": cut_m * chunks,
                 "by_kernel": {"sfc_gemm_wgmma_f32out_kernel": cut_m * chunks,
                               "sfc_gemm_fused_kernel": cut_m * chunks}} if dtype == "bfloat16" else
                {"K1/K2": 2 * cut_m * chunks, "f32_out": 0, "by_kernel": {"sfc_gemm_fused_kernel": 2 * cut_m * chunks}})
    summary = {
        "phase": "serve_xlstm", "arch": cfg.name, "layers": cfg.n_layers, "slstm_every": cfg.slstm_every,
        "mlstm_blocks": n_mlstm, "d_model": cfg.d_model, "heads": cfg.n_heads, "vocab": cfg.vocab,
        "ssm_chunk": cfg.ssm_chunk, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "peak_memory_gb": peak_gb,
        "requests": {"4x": [BATCH, PROMPT, NEW_TOKENS], long_name: [1, HYBRID_LONG_PROMPT, HYBRID_LONG_NEW]},
        "launches": counts, "launches_expected": expected,
        "prefill_logits_full_depth": {
            name: {"finite": bool(torch.isfinite(logits[name]).all()),
                   "mean_abs_vs_torch": float((logits[name] - logits[name.replace("sfc_cuda", "torch")]).abs().mean()),
                   "first_token_match": float((logits[name].argmax(-1) ==
                                               logits[name.replace("sfc_cuda", "torch")].argmax(-1)).float().mean())}
            for name in ("sfc_cuda", f"sfc_cuda@{long_name}")},
        "cut": {"layers": XLSTM_CHECK_LAYERS, "f32_vs_torch": f32_agree, "bf16_mean_abs_err_vs_f32": noise,
                "parity_ok": parity, "launches": cut_counts, "launches_expected": cut_expected},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of[name.replace("sfc_cuda", "torch")]).mean())
                               for name in ("sfc_cuda", f"sfc_cuda@{long_name}")},
        "latency": {name: {key: rep[key] for key in ("ttft_mean_s", "ttft_p50_s", "token_p50_s", "tokens_per_s",
                                                     "latency_mean_s")} for name, rep in reports.items()},
        "decode_step_profile": decode_profile,
    }
    emit(summary)
    if counts != expected or cut_counts != cut_expected:
        raise AssertionError(f"xlstm serves launched {counts} (cut {cut_counts}), expected {expected} "
                             f"(cut {cut_expected})")
    for name, full in summary["prefill_logits_full_depth"].items():
        if not full["finite"]:
            raise AssertionError(f"xlstm {name}: non-finite prefill logits")
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"xlstm cut f32 prefill logits {name} vs torch: {res}")
    if not all(parity.values()):
        raise AssertionError(f"xlstm cut bf16 logits further from the f32 model than torch's: {noise}")
    del logits, cut_logits, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape


# ---------------------------------------------------------------------------
# the encoder-decoder family: seamless-m4t-medium (cross-attention on K11
# and K14, the non-gated gelu MLP on K1/K2)
# ---------------------------------------------------------------------------


def encdec_gemms(cfg):
    """The K1/K2 products of the seamless-m4t-medium run (d_model 1024, 16
    heads of 64, a gelu MLP of 4096): a decode step's (4 rows, the plain
    mode; the self and cross q / o and the self k / v share one shape),
    the encoder's over 4 x ENCDEC_FRAMES frames (its q, k, v, o and the
    decoder's cross k / v over the memory) and the decoder prefill's over 4
    x PROMPT tokens; the LM head is torch.matmul."""
    d, f = cfg.d_model, cfg.d_ff
    proj = [("attn", d, d, None), ("mlp_in", d, f, cfg.act), ("mlp_out", f, d, None)]
    out = [Gemm(f"seamless/decode/{n}", "decode", 0, BATCH, k, nn, act=a) for n, k, nn, a in proj]
    out += [Gemm(f"seamless/encoder/{n}", "prefill", BATCH, ENCDEC_FRAMES, k, nn, act=a) for n, k, nn, a in proj]
    out += [Gemm(f"seamless/prefill/{n}", "prefill", BATCH, PROMPT, k, nn, act=a) for n, k, nn, a in proj]
    return out


def encdec_attention_cases(cfg):
    """The seamless run's attention shapes (16 / 16 heads of 64): the
    encoder's bidirectional self-attention over the frames, the decoder
    prefill's causal self-attention and its cross-attention over the
    memory (K11); a decode step's self-attention over its cache (live
    PROMPT + 8 rows, the middle step) and cross-attention over the whole
    memory (K14)."""
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_, path="seamless")
    cache = PROMPT + NEW_TOKENS + 1
    return [
        Attn("seamless/encoder_self", "sfc_flash_fwd", BATCH, ENCDEC_FRAMES, ENCDEC_FRAMES, causal=False, **heads),
        Attn("seamless/decoder_self", "sfc_flash_fwd", BATCH, PROMPT, PROMPT, **heads),
        Attn("seamless/cross", "sfc_flash_fwd", BATCH, PROMPT, ENCDEC_FRAMES, causal=False, **heads),
        Attn("seamless/decode_self", "sfc_decode_attention", BATCH, 1, cache, valid=(PROMPT + 8,) * BATCH, **heads),
        Attn("seamless/decode_memory", "sfc_decode_attention", BATCH, 1, ENCDEC_FRAMES,
             valid=(ENCDEC_FRAMES,) * BATCH, **heads),
    ]


def phase_encdec(torch, np, cfg, build_model, tk, tsa, gemm_backend, attention_backend):
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers, d_model 1024, 16 / 16 heads of 64, d_ff 4096 gelu,
    vocab 256206, bf16, seeded random weights): the stub frontend's 4 x
    ENCDEC_FRAMES frame embeddings drawn from a seed, encoded; a 4 x
    PROMPT decoder prompt prefilled (EncDecLM.prefill encodes again) and
    NEW_TOKENS tokens decoded greedily, under sfc_cuda with "sfc" and
    blockwise attention and under torch.  Launch counts exact, reckoned
    from the structure: an encode 6 K1/K2 a layer and one non-causal K11;
    a prefill the encode's and 12 K1/K2 a decoder layer (self q, k, v, o;
    cross q and o; the memory's k and v twice, in the cross-attention and
    for the cache; the MLP's two), one causal and one non-causal K11; a
    decode step 8 K1/K2 a decoder layer on the cluster kernel, one K14
    over the self cache and one over the memory; none under torch.  The
    f32 prefill logits of the same weights (full depth) under each sfc_cuda
    variant within the bf16 bound of torch's, and each bf16 variant's as
    close to that f32 model as torch's are (ACCURACY_PARITY).  Returns
    (summary, sfc_gemm_fused launches by shape of the "sfc" run, its K11
    and K14 launches)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(BATCH, PROMPT))).long().cuda()
    frames = torch.randn((BATCH, ENCDEC_FRAMES, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    variants = {"sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"), "sfc_cuda": ("sfc_cuda", "blockwise"),
                "torch": ("torch", "blockwise")}
    cache_len = PROMPT + NEW_TOKENS + 1

    def encode(m, name):
        gemm, impl = variants[name]
        with gemm_backend(gemm), attention_backend(impl), torch.no_grad():
            t0 = time.perf_counter()
            m.encode(frames)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    def greedy(m, name, new):
        """(tokens (B, new), TTFT, the per-token gaps, the whole wall time)."""
        gemm, impl = variants[name]
        out, stamps = [], []
        with gemm_backend(gemm), attention_backend(impl):
            t0 = time.perf_counter()
            logits, cache = m.prefill(tokens, frames, cache_len=cache_len)
            tok = logits.argmax(-1)[:, None]
            out.append(tok[:, 0].tolist())
            stamps.append(time.perf_counter())
            for _ in range(new - 1):
                logits, cache = m.decode_step(tok, cache)
                tok = logits.argmax(-1)[:, None]
                out.append(tok[:, 0].tolist())
                stamps.append(time.perf_counter())
        gaps = np.diff(stamps)
        return np.array(out).T, stamps[0] - t0, gaps, stamps[-1] - t0

    def reset():
        _reset_gemm_counts(tk)
        for fn in (tsa.sfc_flash_fwd, tsa.sfc_decode_attention):
            fn.launches = 0
        tsa.sfc_flash_fwd.launches_by_kernel.clear()

    def read():
        return {**_gemm_counts(tk), "K11": tsa.sfc_flash_fwd.launches, "K14": tsa.sfc_decode_attention.launches,
                "K11_by_kernel": {f"{k}@W{w}": n for (k, w), n in tsa.sfc_flash_fwd.launches_by_kernel.items()}}

    for name in variants:  # warm-up: first launches, allocator, cuBLAS handles
        encode(model, name)
        greedy(model, name, 2)
    torch.cuda.synchronize()

    enc_l, dec_l = cfg.encoder_layers, cfg.n_layers
    w1 = tsa.fwd_wgmma_grid(BATCH, PROMPT, ENCDEC_FRAMES, cfg.n_heads, cfg.kv_heads,
                            torch.cuda.get_device_properties(0).multi_processor_count)[1]

    def want(name, encode_only):
        if name == "torch":
            return {"K1/K2": 0, "f32_out": 0, "by_kernel": {}, "K11": 0, "K14": 0, "K11_by_kernel": {}}
        attn = "sfc_attn" in name
        if encode_only:
            k11 = enc_l if attn else 0
            return {"K1/K2": 6 * enc_l, "f32_out": 0, "by_kernel": {"sfc_gemm_wgmma_kernel": 6 * enc_l}, "K11": k11,
                    "K14": 0, "K11_by_kernel": {f"flash_fwd_wgmma_kernel@W{w1}": k11} if k11 else {}}
        prefill = 6 * enc_l + 12 * dec_l
        decode = 8 * dec_l * (NEW_TOKENS - 1)
        k11 = enc_l + 2 * dec_l if attn else 0
        return {"K1/K2": prefill + decode, "f32_out": 0,
                "by_kernel": {"sfc_gemm_wgmma_kernel": prefill, "sfc_gemm_cluster_kernel": decode},
                "K11": k11, "K14": 2 * dec_l * (NEW_TOKENS - 1) if attn else 0,
                "K11_by_kernel": {f"flash_fwd_wgmma_kernel@W{w1}": k11} if k11 else {}}

    counts, expected, encode_s, runs, by_shape = {}, {}, {}, {}, {}
    for name in variants:
        reset()
        encode_s[name] = encode(model, name)
        counts[f"{name}/encode"], expected[f"{name}/encode"] = read(), want(name, True)
        reset()
        runs[name] = greedy(model, name, NEW_TOKENS)
        torch.cuda.synchronize()
        counts[name], expected[name] = read(), want(name, False)
        by_shape[name] = dict(tk.sfc_gemm_fused.launches_by_shape)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    logits = {}
    for name in variants:
        gemm, impl = variants[name]
        with gemm_backend(gemm), attention_backend(impl):
            logits[name] = model.prefill(tokens, frames, cache_len=cache_len)[0].float()
    model32 = build_model(dataclasses.replace(cfg, param_dtype="float32"), device="cuda")
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    del model
    for name in variants:
        gemm, impl = variants[name]
        with gemm_backend(gemm), attention_backend(impl):
            logits[name + "_f32"] = model32.prefill(tokens, frames, cache_len=cache_len)[0]
    del model32
    sfc = ("sfc_cuda+sfc_attn", "sfc_cuda")
    ref = logits["torch_f32"]
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits[name + "_f32"], ref, torch.bfloat16))) for name in sfc}
    noise = {name: float((logits[name] - ref).abs().mean()) for name in (*sfc, "torch")}
    parity = {name: noise[name] <= ACCURACY_PARITY * noise["torch"] for name in sfc}
    latency = {}
    for name, (toks, ttft, gaps, wall) in runs.items():
        latency[name] = {"encode_s": encode_s[name], "ttft_s": ttft, "token_p50_s": float(np.median(gaps)),
                         "tokens_per_s": toks.size / wall, "wall_s": wall}
    summary = {
        "phase": "encdec_seamless", "arch": cfg.name, "encoder_layers": enc_l, "decoder_layers": dec_l,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.kv_heads], "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
        "act": cfg.act, "vocab": cfg.vocab, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "peak_memory_gb": peak_gb, "frames": [BATCH, ENCDEC_FRAMES, cfg.d_model],
        "prompt": [BATCH, PROMPT], "new_tokens": NEW_TOKENS,
        "launches": counts, "launches_expected": expected,
        "prefill_logits": {"f32_vs_torch": f32_agree, "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity,
                           "first_token_match": {name: float((logits[name].argmax(-1) ==
                                                              logits["torch"].argmax(-1)).float().mean())
                                                 for name in sfc}},
        "greedy_token_match": {name: float((runs[name][0] == runs["torch"][0]).mean()) for name in sfc},
        "latency": latency,
    }
    emit(summary)
    if counts != expected:
        raise AssertionError(f"seamless runs launched {counts}, expected {expected}")
    for name in sfc:
        if tuple(logits[name].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"seamless {name}: prefill logits of shape {tuple(logits[name].shape)} or "
                                 "non-finite")
        if not f32_agree[name]["ok"]:
            raise AssertionError(f"seamless f32 prefill logits {name} vs torch: {f32_agree[name]}")
    if not all(parity.values()):
        raise AssertionError(f"seamless bf16 logits further from the f32 model than torch's: {noise}")
    del logits, ref
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape["sfc_cuda+sfc_attn"], counts["sfc_cuda+sfc_attn"]


# ---------------------------------------------------------------------------
# the last configs: the VLM family (qwen2-vl-72b, M-RoPE with stub vision
# embeddings) and qwen2-72b on one tree, qwen3-moe-30b-a3b (128 experts,
# top-8) and stablelm-1.6b (LayerNorm, 25% rotary, MHA of 64)
# ---------------------------------------------------------------------------


def serve_gemms(cfg, label):
    """The K1/K2 products of a decoder's serve: a decode step's (4 rows,
    the plain mode), the LM head's, and the 4 x PROMPT prefill's (batched);
    projections of one shape (q and o, or all four of an MHA of d_model)
    are one row, named together."""
    rows = {}
    for gm in main_path_gemms(cfg):
        if gm.mode == "train":
            continue
        if gm.key in rows:
            rows[gm.key] = dataclasses.replace(rows[gm.key], name=f"{rows[gm.key].name},{gm.name.split('/')[-1]}")
        else:
            rows[gm.key] = dataclasses.replace(gm, name=f"{label}/{gm.name}")
    return list(rows.values())


def last_attention_cases(cfg, label):
    """K11 at the serve's 4 x PROMPT prefill and K14 over its cache (live
    lengths of the middle decode step) with ``cfg``'s heads."""
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_, path=label)
    return [Attn(f"{label}/prefill", "sfc_flash_fwd", BATCH, PROMPT, PROMPT, **heads),
            Attn(f"{label}/decode", "sfc_decode_attention", BATCH, 1, PROMPT + NEW_TOKENS + 1,
                 valid=(129, 134, 139, 144), **heads)]


def moe128_grouped_gemms(cfg):
    """K3 at qwen3-moe-30b-a3b's serve (128 experts of 768, d_model 2048):
    the decode step's 32 rows an expert and the 4 x PROMPT prefill's 40,
    the GLU (silu in the flush) and w_out."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    out = []
    for label, rows in (("decode", moe_rows(cfg, BATCH, 1)), ("prefill", moe_rows(cfg, BATCH, PROMPT))):
        out += [GroupedGemm(f"qwen3-moe/{label}/glu", "fwd", "qwen3-moe serve", e, rows, d, f, glu=True),
                GroupedGemm(f"qwen3-moe/{label}/w_out", "fwd", "qwen3-moe serve", e, rows, f, d)]
    return out


def _reset_serve_counts(tk, tsa):
    _reset_gemm_counts(tk)
    for fn in (tk.sfc_gemm_grouped, tsa.sfc_flash_fwd, tsa.sfc_decode_attention):
        fn.launches = 0
        for attr in ("launches_by_shape", "launches_by_kernel", "launches_by_splits"):
            if hasattr(fn, attr):
                getattr(fn, attr).clear()


def _serve_counts(tk, tsa) -> dict:
    return {"K1/K2": tk.sfc_gemm_fused.launches, "by_kernel": by_kernel(tk.sfc_gemm_fused.launches_by_kernel),
            "K3": tk.sfc_gemm_grouped.launches, "K3_by_kernel": by_kernel(tk.sfc_gemm_grouped.launches_by_kernel),
            "K11": tsa.sfc_flash_fwd.launches,
            "K11_by_kernel": {f"{k}@W{w}": n for (k, w), n in tsa.sfc_flash_fwd.launches_by_kernel.items()},
            "K14": tsa.sfc_decode_attention.launches}


def decoder_want(cfg, variant, w, steps=NEW_TOKENS - 1) -> dict:
    """The launches of one BATCH x PROMPT prefill and ``steps`` decode
    steps of a DecoderLM under ``variant`` (gemm backend, attn_impl),
    reckoned from the structure (tests/test_torch_vlm.py and
    test_torch_configs.py count them at the call sites): a forward 6 K1/K2
    a dense layer (q, k, v, o, the GLU, w_out) or 5 a MoE layer (q, k, v,
    o, the router) and 2 K3 (the experts' GLU and w_out), and the head;
    the prefill's layers on the wgmma kernel, every 4-row product (the
    decode steps, the prefill's head) on the cluster kernel; under "sfc"
    one K11 (at W ``w``) a layer a prefill and one K14 a layer a step;
    none under torch."""
    gemm, impl = variant
    if gemm == "torch":
        return {"K1/K2": 0, "by_kernel": {}, "K3": 0, "K3_by_kernel": {}, "K11": 0, "K11_by_kernel": {}, "K14": 0}
    n = cfg.n_layers
    dense = (5 if cfg.n_experts else 6) * n
    fwd = dense + 1
    k3 = 2 * n * (1 + steps) if cfg.n_experts else 0
    attn = impl == "sfc"
    return {"K1/K2": fwd * (1 + steps),
            "by_kernel": {"sfc_gemm_wgmma_kernel": dense, "sfc_gemm_cluster_kernel": fwd * (1 + steps) - dense},
            "K3": k3, "K3_by_kernel": {"sfc_gemm_grouped_wgmma_kernel": k3} if k3 else {},
            "K11": n if attn else 0, "K11_by_kernel": {f"flash_fwd_wgmma_kernel@W{w}": n} if attn else {},
            "K14": n * steps if attn else 0}


# a decode step's device time by group (first matching fragment wins: the
# grouped kernels before the dense ones, the SFC kernels before cuBLAS's)
_DECODER_KERNEL_GROUPS = (("sfc_gemm_grouped_wgmma_kernel", "K3 wgmma"), ("sfc_gemm_grouped_kernel", "K3"),
                          *_HYBRID_KERNEL_GROUPS)


def serve_runs(torch, np, cfg, params, ServingEngine, tk, tsa, variants, prompts, label):
    """ServingEngine serves ``prompts`` x NEW_TOKENS on ``params`` under
    each of ``variants`` ({name: (gemm backend, attn_impl)}), after a
    warm-up.  Returns (engines, launches by run, K1/K2 and K3 launches by
    shape by run, latency by run, greedy tokens by run)."""
    engines = {name: ServingEngine(dataclasses.replace(cfg, attn_impl=impl), params, max_batch=BATCH,
                                   max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")
               for name, (gemm, impl) in variants.items()}
    for eng in engines.values():  # warm-up: first launches, allocator, task tables, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()
    counts, by_shape, reports, tokens_of = {}, {}, {}, {}
    for name, eng in engines.items():
        _reset_serve_counts(tk, tsa)
        done = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        counts[name] = _serve_counts(tk, tsa)
        by_shape[name] = {"K1/K2": dict(tk.sfc_gemm_fused.launches_by_shape),
                          "K3": dict(tk.sfc_gemm_grouped.launches_by_shape)}
        for r in done:
            if r.status != "completed" or len(r.output) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.output):
                raise AssertionError(f"{label} {name}: request {r.uid} ended {r.status} with "
                                     f"{len(r.output or [])} tokens")
        rep = eng.latency_report(done)
        reports[name] = {key: rep[key] for key in ("ttft_mean_s", "ttft_p50_s", "token_p50_s", "tokens_per_s",
                                                   "latency_mean_s")}
        tokens_of[name] = np.array([r.output for r in done])
    return engines, counts, by_shape, reports, tokens_of


def _cut(params, layers):
    """The tensors of a cut to the first ``layers`` layers (shared, not copied)."""
    return {k: v for k, v in params.items() if not k.startswith("layers.") or int(k.split(".")[1]) < layers}


def _agreement(torch, logits, sfc):
    """The f32 logits of each ``sfc`` run within the bf16 bound of the
    torch run's, and each bf16 run's mean |error| against the f32 torch
    run beside torch's own (accuracy parity)."""
    ref = logits["torch_f32"]
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits[name + "_f32"], ref, torch.bfloat16))) for name in sfc}
    noise = {name: float((logits[name] - ref).abs().mean()) for name in (*sfc, "torch")}
    parity = {name: noise[name] <= ACCURACY_PARITY * noise["torch"] for name in sfc}
    return f32_agree, noise, parity


def vlm_positions(torch, b, s, grid):
    """Qwen2-VL's (3, B, S) positions of a stub image of ``grid`` patches on
    the leading positions: (0, row, column) for patch i, then the text's
    running index on all three axes from the grid's largest index plus
    one; and the next text position, where decoding continues."""
    rows, cols = grid
    n_img = rows * cols
    i = torch.arange(n_img)
    img = torch.stack([torch.zeros_like(i), i // cols, i % cols])
    start = max(rows, cols)
    txt = torch.arange(start, start + s - n_img)[None].expand(3, -1)
    pos = torch.cat([img, txt], dim=1)[:, None].expand(3, b, s).contiguous()
    return pos.cuda(), start + s - n_img


def phase_vlm_serve(torch, np, cfg, dense_cfg, build_model, ServingEngine, tk, tsa, ops, gemm_backend):
    """qwen2-vl-72b at full width (d_model 8192, 64 / 8 heads of 128, qkv
    bias, a GLU of 29568, vocab 152064, M-RoPE sections (16, 24, 24), theta
    1e6) cut to VLM_LAYERS of its 80 layers (bf16, seeded weights: all 80
    would be 145 GB, more than the card holds).  ServingEngine serves 4 x
    PROMPT + NEW_TOKENS as text (no M-RoPE positions, as the JAX engine)
    under sfc_cuda with "sfc" and blockwise attention and under torch.  The
    M-RoPE path: `DecoderLM.prefill` of the same prompts with VLM_GRID stub
    patch embeddings (a seeded generator) on the leading rows and
    Qwen2-VL's grid positions, then NEW_TOKENS greedy `decode_step`s at
    explicit (3, B, 1) positions continuing the text's, under sfc_cuda +
    "sfc" and torch.  qwen2-72b (the same tree) served on the same weights
    under sfc_cuda + "sfc" and torch: its tokens and prefill logits bitwise
    the VLM's text-only serve's (M-RoPE with equal axes is RoPE).  Launch
    counts exact (`decoder_want`).  A VLM_CHECK_LAYERS-layer cut with the
    vision rows and M-RoPE: its f32 prefill logits under each sfc_cuda
    variant within the bf16 bound of torch's, its bf16 ones at accuracy
    parity.  Returns (summary, launches by shape of the sfc_cuda + "sfc"
    text serve, its launch counts)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    model = build_model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cut.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    variants = {"sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"), "sfc_cuda": ("sfc_cuda", "blockwise"),
                "torch": ("torch", "blockwise")}
    engines, counts, by_shape, reports, tokens_of = serve_runs(torch, np, cut, params, ServingEngine, tk, tsa,
                                                               variants, prompts, "qwen2-vl-72b")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = tsa.fwd_wgmma_grid(BATCH, PROMPT, PROMPT, cut.n_heads, cut.kv_heads, sms)[1]
    expected = {name: decoder_want(cut, v, w) for name, v in variants.items()}
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}

    # the M-RoPE path: the stub image's rows and grid positions
    n_img = VLM_GRID[0] * VLM_GRID[1]
    vision = torch.randn((BATCH, n_img, cut.d_model), generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda") * 0.02
    mpos, next_pos = vlm_positions(torch, BATCH, PROMPT, VLM_GRID)
    mrope = {}
    for name in ("sfc_cuda+sfc_attn", "torch"):
        m = engines[name].model
        _reset_serve_counts(tk, tsa)
        with gemm_backend(variants[name][0]):
            start = time.perf_counter()
            lg, cache = m.prefill(tokens, cache_len=PROMPT + NEW_TOKENS + 1, mrope_positions=mpos,
                                  vision_embeds=vision)
            logits[f"{name}@mrope"] = lg.float()
            tok = lg.argmax(-1)[:, None]
            out, stamps = [tok[:, 0].tolist()], [time.perf_counter()]
            for step in range(NEW_TOKENS):
                pos = torch.full((3, BATCH, 1), next_pos + step, dtype=torch.long, device="cuda")
                lg, cache = m.decode_step(tok, cache, mrope_positions=pos)
                tok = lg.argmax(-1)[:, None]
                out.append(tok[:, 0].tolist())
                stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        counts[f"{name}@mrope"] = _serve_counts(tk, tsa)
        expected[f"{name}@mrope"] = decoder_want(cut, variants[name], w, steps=NEW_TOKENS)
        toks = np.array(out).T
        mrope[name] = {"tokens": toks, "ttft_s": stamps[0] - start, "token_p50_s": float(np.median(np.diff(stamps))),
                       "tokens_per_s": toks.size / (stamps[-1] - start)}
        del cache
    mrope_moves = {name: float((logits[f"{name}@mrope"] - logits[name]).abs().max()) for name in mrope}

    # qwen2-72b on the same weights: the VLM's text-only serve, bitwise
    dense_cut = dataclasses.replace(dense_cfg, n_layers=VLM_LAYERS)
    dense_variants = {f"qwen2-72b:{name}": variants[name] for name in ("sfc_cuda+sfc_attn", "torch")}
    d_engines, d_counts, _, d_reports, d_tokens = serve_runs(torch, np, dense_cut, params, ServingEngine, tk, tsa,
                                                             dense_variants, prompts, "qwen2-72b")
    counts.update(d_counts)
    expected.update({name: decoder_want(dense_cut, v, w) for name, v in dense_variants.items()})
    reports.update(d_reports)
    bitwise = {}
    for name, eng in d_engines.items():
        vlm_name = name.split(":")[1]
        bitwise[name] = {"tokens": bool((d_tokens[name] == tokens_of[vlm_name]).all()),
                         "prefill_logits": bool(torch.equal(eng._prefill(tokens)[0].float(), logits[vlm_name]))}
    decode_profile = profile_decode(torch, engines["sfc_cuda+sfc_attn"], tokens, ops,
                                    kernel_groups=_DECODER_KERNEL_GROUPS)
    del d_engines, engines, eng, m
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the f32 check on a VLM_CHECK_LAYERS-layer cut, with the vision rows and M-RoPE
    check = dataclasses.replace(cfg, n_layers=VLM_CHECK_LAYERS)
    check_logits = {}
    for suffix in ("", "_f32"):
        weights = _cut(params, VLM_CHECK_LAYERS)
        conf = check
        if suffix:
            weights = {k: v.float() for k, v in weights.items()}
            conf = dataclasses.replace(check, param_dtype="float32")
        for name, (gemm, impl) in variants.items():
            eng = ServingEngine(dataclasses.replace(conf, attn_impl=impl), weights, max_batch=BATCH,
                                max_seq=PROMPT + 1, gemm_backend=gemm, device="cuda")
            with gemm_backend(gemm):
                check_logits[name + suffix] = eng.model.prefill(tokens, cache_len=PROMPT + 1, mrope_positions=mpos,
                                                                vision_embeds=vision)[0].float()
            del eng
        del weights
    sfc = ("sfc_cuda+sfc_attn", "sfc_cuda")
    f32_agree, noise, parity = _agreement(torch, check_logits, sfc)
    summary = {
        "phase": "serve_vlm", "arch": cfg.name, "dense_arch": dense_cfg.name, "layers": VLM_LAYERS,
        "layers_published": cfg.n_layers, "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.kv_heads],
        "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "mrope_sections": list(cfg.mrope_sections),
        "rope_theta": cfg.rope_theta, "qkv_bias": cfg.qkv_bias, "dtype": cfg.param_dtype, "params": n_params,
        "init_s": init_s, "peak_memory_gb": peak_gb, "requests": [BATCH, PROMPT, NEW_TOKENS],
        "vision_rows": n_img, "grid": list(VLM_GRID), "text_positions_from": int(mpos[0, 0, n_img]),
        "launches": counts, "launches_expected": expected,
        "qwen2_72b_bitwise_vlm_text_serve": bitwise,
        "mrope_vs_text_only_prefill_max_abs_diff": mrope_moves,
        "mrope_greedy_token_match": float((mrope["sfc_cuda+sfc_attn"]["tokens"] == mrope["torch"]["tokens"]).mean()),
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean()) for name in sfc},
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in sfc},
        "check_cut": {"layers": VLM_CHECK_LAYERS, "f32_vs_torch": f32_agree, "bf16_mean_abs_err_vs_f32": noise,
                      "parity_ok": parity},
        "latency": reports,
        "mrope_latency": {name: {k: v for k, v in run.items() if k != "tokens"} for name, run in mrope.items()},
        "decode_step_profile": decode_profile,
    }
    emit(summary)
    if counts != expected:
        raise AssertionError(f"qwen2-vl-72b / qwen2-72b runs launched {counts}, expected {expected}")
    if not all(all(b.values()) for b in bitwise.values()):
        raise AssertionError(f"qwen2-72b's serve is not bitwise the VLM's text-only serve: {bitwise}")
    for name, lg in logits.items():
        if tuple(lg.shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"qwen2-vl-72b {name}: prefill logits of shape {tuple(lg.shape)} or non-finite")
    if not all(v > 0 for v in mrope_moves.values()):
        raise AssertionError(f"the vision rows and M-RoPE positions left the prefill logits as they were: {mrope_moves}")
    for name in sfc:
        if not f32_agree[name]["ok"]:
            raise AssertionError(f"qwen2-vl-72b f32 prefill logits {name} vs torch: {f32_agree[name]}")
    if not all(parity.values()):
        raise AssertionError(f"qwen2-vl-72b bf16 logits further from the f32 model than torch's: {noise}")
    del model, params, logits, check_logits, vision
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape["sfc_cuda+sfc_attn"], counts["sfc_cuda+sfc_attn"]


def phase_moe128_serve(torch, np, cfg, build_model, ServingEngine, tk, tsa, ops):
    """qwen3-moe-30b-a3b at full width (d_model 2048, 32 / 4 heads of 128,
    qk-norm, 128 experts of 768, top-8, vocab 151936) and MOE128_LAYERS of
    its 48 layers (bf16, seeded weights): ServingEngine serves 4 x PROMPT +
    NEW_TOKENS under sfc_cuda + "sfc" and torch.  Launch counts exact
    (`decoder_want`: 2 K3 a layer a forward, every one on the grouped wgmma
    kernel).  Where the bf16 greedy tokens part from torch's, the routing
    at that step (`moe_routing_at_divergence`).  The bf16 model freed, the
    prefill logits of a MOE128_CHECK_LAYERS-layer cut in f32 within the
    bf16 bound of torch's (its K3 on the 64 x 64 tile kernel).  Returns
    (summary, launches by shape of the sfc_cuda + "sfc" serve, its launch
    counts)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cut = dataclasses.replace(cfg, n_layers=MOE128_LAYERS)
    model = build_model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cut.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    variants = {"sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"), "torch": ("torch", "blockwise")}
    engines, counts, by_shape, reports, tokens_of = serve_runs(torch, np, cut, params, ServingEngine, tk, tsa,
                                                               variants, prompts, "qwen3-moe")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = tsa.fwd_wgmma_grid(BATCH, PROMPT, PROMPT, cut.n_heads, cut.kv_heads, sms)[1]
    expected = {name: decoder_want(cut, v, w) for name, v in variants.items()}
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    divergence = moe_routing_at_divergence(torch, np, engines, prompts, tokens_of, cut.moe_top_k,
                                           sfc="sfc_cuda+sfc_attn")
    decode_profile = profile_decode(torch, engines["sfc_cuda+sfc_attn"], tokens, ops,
                                    kernel_groups=_DECODER_KERNEL_GROUPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the f32 cut: the bf16 model freed first, but for the tensors the cut keeps
    kept = _cut(params, MOE128_CHECK_LAYERS)
    del engines, model, params
    gc.collect()
    torch.cuda.empty_cache()
    params32 = {k: v.float() for k, v in kept.items()}
    del kept
    check = dataclasses.replace(cfg, n_layers=MOE128_CHECK_LAYERS, param_dtype="float32")
    _reset_serve_counts(tk, tsa)
    for name, (gemm, impl) in variants.items():
        eng = ServingEngine(dataclasses.replace(check, attn_impl=impl), params32, max_batch=BATCH,
                            max_seq=PROMPT + 1, gemm_backend=gemm, device="cuda")
        logits[name + "_f32"] = eng._prefill(tokens)[0]
        del eng
    torch.cuda.synchronize()
    k3_f32 = by_kernel(tk.sfc_gemm_grouped.launches_by_kernel)
    want_k3_f32 = {"sfc_gemm_grouped_kernel": 2 * MOE128_CHECK_LAYERS}
    del params32
    f32_agree = {"sfc_cuda+sfc_attn": dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                               within(logits["sfc_cuda+sfc_attn_f32"], logits["torch_f32"],
                                                      torch.bfloat16)))}
    summary = {
        "phase": "serve_moe128", "arch": cfg.name, "layers": MOE128_LAYERS, "layers_published": cfg.n_layers,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.kv_heads], "head_dim": cfg.head_dim_,
        "experts": cfg.n_experts, "top_k": cfg.moe_top_k, "expert_d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "qk_norm": cfg.qk_norm, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "peak_memory_gb": peak_gb, "requests": [BATCH, PROMPT, NEW_TOKENS],
        "rows_per_expert": {"decode": moe_rows(cfg, BATCH, 1), "prefill": moe_rows(cfg, BATCH, PROMPT)},
        "launches": counts, "launches_expected": expected,
        "f32_cut": {"layers": MOE128_CHECK_LAYERS, "f32_vs_torch": f32_agree, "K3_by_kernel": k3_f32,
                    "K3_by_kernel_expected": want_k3_f32},
        "bf16_sfc_vs_torch_mean_abs_err": float((logits["sfc_cuda+sfc_attn"] - logits["torch"]).abs().mean()),
        "first_token_match": float((logits["sfc_cuda+sfc_attn"].argmax(-1) == logits["torch"].argmax(-1))
                                   .float().mean()),
        "greedy_token_match": float((tokens_of["sfc_cuda+sfc_attn"] == tokens_of["torch"]).mean()),
        "routing_at_divergence": divergence,
        "latency": reports,
        "decode_step_profile": decode_profile,
    }
    emit(summary)
    if counts != expected:
        raise AssertionError(f"qwen3-moe serves launched {counts}, expected {expected}")
    if k3_f32 != want_k3_f32:
        raise AssertionError(f"the qwen3-moe f32 cut launched K3 {k3_f32} by kernel, expected {want_k3_f32}")
    for name in variants:
        lg = logits[name]
        if tuple(lg.shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"qwen3-moe {name}: prefill logits of shape {tuple(lg.shape)} or non-finite")
    if not f32_agree["sfc_cuda+sfc_attn"]["ok"]:
        raise AssertionError(f"qwen3-moe f32 prefill logits vs torch: {f32_agree}")
    del logits
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape["sfc_cuda+sfc_attn"], counts["sfc_cuda+sfc_attn"]


def phase_stablelm_serve(torch, np, cfg, build_model, ServingEngine, tk, tsa, ops):
    """stablelm-1.6b at full width and depth (24 layers, d_model 2048,
    LayerNorm, 25% rotary, MHA of 32 / 32 heads of 64, a GLU of 5632,
    vocab 100352, bf16, seeded weights): ServingEngine serves 4 x PROMPT +
    NEW_TOKENS under sfc_cuda with "sfc" and blockwise attention and under
    torch, launch counts exact (`decoder_want`); the f32 prefill logits at
    full depth under each sfc_cuda variant within the bf16 bound of
    torch's, the bf16 ones at accuracy parity.  Returns (summary, launches
    by shape of the sfc_cuda + "sfc" serve, its launch counts)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    variants = {"sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"), "sfc_cuda": ("sfc_cuda", "blockwise"),
                "torch": ("torch", "blockwise")}
    engines, counts, by_shape, reports, tokens_of = serve_runs(torch, np, cfg, params, ServingEngine, tk, tsa,
                                                               variants, prompts, "stablelm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = tsa.fwd_wgmma_grid(BATCH, PROMPT, PROMPT, cfg.n_heads, cfg.kv_heads, sms)[1]
    expected = {name: decoder_want(cfg, v, w) for name, v in variants.items()}
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    decode_profile = profile_decode(torch, engines["sfc_cuda+sfc_attn"], tokens, ops,
                                    kernel_groups=_DECODER_KERNEL_GROUPS)
    del engines
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params32 = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    for name, (gemm, impl) in variants.items():
        eng = ServingEngine(dataclasses.replace(cfg32, attn_impl=impl), params32, max_batch=BATCH,
                            max_seq=PROMPT + 1, gemm_backend=gemm, device="cuda")
        logits[name + "_f32"] = eng._prefill(tokens)[0]
        del eng
    del params32
    sfc = ("sfc_cuda+sfc_attn", "sfc_cuda")
    f32_agree, noise, parity = _agreement(torch, logits, sfc)
    summary = {
        "phase": "serve_stablelm", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.kv_heads], "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "norm": cfg.norm, "rotary_pct": cfg.rotary_pct, "dtype": cfg.param_dtype, "params": n_params,
        "init_s": init_s, "peak_memory_gb": peak_gb, "requests": [BATCH, PROMPT, NEW_TOKENS],
        "launches": counts, "launches_expected": expected,
        "prefill_logits": {"f32_vs_torch": f32_agree, "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity},
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in sfc},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean()) for name in sfc},
        "latency": reports,
        "decode_step_profile": decode_profile,
    }
    emit(summary)
    if counts != expected:
        raise AssertionError(f"stablelm serves launched {counts}, expected {expected}")
    for name in sfc:
        if tuple(logits[name].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"stablelm {name}: prefill logits of shape {tuple(logits[name].shape)} or non-finite")
        if not f32_agree[name]["ok"]:
            raise AssertionError(f"stablelm f32 prefill logits {name} vs torch: {f32_agree[name]}")
    if not all(parity.values()):
        raise AssertionError(f"stablelm bf16 logits further from the f32 model than torch's: {noise}")
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return summary, by_shape["sfc_cuda+sfc_attn"], counts["sfc_cuda+sfc_attn"]


# ---------------------------------------------------------------------------
# ABFT: the checksum lanes of K1/K2, K3 and K8 (dW, update, norm)
# ---------------------------------------------------------------------------

# exponent bit 4 of a bf16 / f32 element: flipped on an element of
# magnitude in [2, 65536), it multiplies that element by 2^16
_EXP_BIT4 = {"bfloat16": 1 << 11, "float32": 1 << 27}


def flip_exponent_bit(torch, x):
    """A copy of ``x`` with exponent bit 4 of its largest element flipped:
    one input element corrupted silently, 2^16 times larger."""
    flat = x.detach().reshape(-1).clone()
    i = int(flat.float().abs().argmax())
    if not 2.0 <= abs(float(flat[i])) < 65536.0:
        raise AssertionError(f"the largest element {float(flat[i])} is not in [2, 65536)")
    bits = flat.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    bits[i] = bits[i] ^ _EXP_BIT4[str(x.dtype).split(".")[1]]
    return flat.reshape(x.shape)


def _once_ms(torch, fn):
    """(result, ms) of one call, by CUDA events.  A row's ``plain_ms`` is
    this of the correctness check's own call of the plain version, the
    first at that shape: one call, not the mean of several, as the plain
    versions take up to 15 s a call and the rows hold more than 250."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# A lane and its plain version's lane sum the same f32 raw accumulators in
# other orders, so they are held far inside `tolerance()` (which allows for
# the operand side's reassociation and, for bf16, a cast): within LANE_RTOL
# of the sum of |each tile's raw sum| at LANE_TILE x LANE_TILE tiles.  A
# lane that wrote 0, dropped a task or summed after the epilogue misses it
# (the lane-side controls).  On an H100 the lanes came within 0.32 of it
# (bf16 at decode) and every control missed it by 3x or more.
LANE_RTOL = 1e-5
LANE_TILE = 64


def raw_tile_sums(torch, *raws, tile=(LANE_TILE, LANE_TILE)):
    """The f32 sum of each ``tile`` block (edge blocks clipped) of the last
    two dims of the raw products ``raws``, the raws added block by block as
    the GLU's lane adds its two accumulators: a lane's partials at that
    tile, flattened, the bottom-right block last."""
    tr, tc = tile
    total = None
    for c in raws:
        r, k = c.shape[-2:]
        c = torch.nn.functional.pad(c.float(), (0, -k % tc, 0, -r % tr))
        s = c.reshape(*c.shape[:-2], c.shape[-2] // tr, tr, c.shape[-1] // tc, tc).sum(dim=(-3, -1))
        total = s if total is None else total + s
    return total.reshape(-1)


def kernel_tiles(torch, name, config, *raws):
    """`raw_tile_sums` over the tiles a launch's lane sums: a wgmma
    kernel's C tile (``config``, "128x256"; K1/K2's over the rows of every
    batch element together, as shared weights fold the batch into the rows;
    K8's one set's (K, N) dW; K3's each expert's rows apart, the raws
    `grouped_raw`'s), else LANE_TILE x LANE_TILE tiles of each batch
    element."""
    if name not in ("sfc_gemm_wgmma_kernel", "tn_wgmma_kernel", "tn_update_wgmma_kernel",
                    "sfc_gemm_grouped_wgmma_kernel"):
        return raw_tile_sums(torch, *raws)
    tile = tuple(int(x) for x in config.split("x"))
    if name == "sfc_gemm_grouped_wgmma_kernel":
        return raw_tile_sums(torch, *raws, tile=tile)
    return raw_tile_sums(torch, *(c.reshape(-1, c.shape[-1]) for c in raws), tile=tile)


def lane_limit(tiles, tol):
    """How far a lane may sit from its plain version's: LANE_RTOL of the
    sum of |tile sums|, never more than ``tol`` (`tolerance()`)."""
    return min(LANE_RTOL * float(tiles.abs().sum()) + 1e-30, float(tol))


def grouped_raw(torch, a, w, sizes):
    """(E, max rows, N) f32 raw products of a grouped GEMM: expert e's rows
    of ``a`` (sorted by expert) against ``w[e]``, from row 0 of its slab
    (zero rows below), so that its row blocks are the kernel's."""
    e, dev = len(sizes), a.device
    sz = torch.tensor(sizes, device=dev)
    expert = torch.repeat_interleave(torch.arange(e, device=dev), sz, output_size=a.shape[0])
    pos = torch.arange(a.shape[0], device=dev) - (torch.cumsum(sz, 0) - sz)[expert]
    slab = torch.zeros((e, max(sizes, default=0), a.shape[1]), dtype=torch.float32, device=dev)
    slab[expert, pos] = a.float()
    return slab @ w.float()


def _lane_check(torch, abft, case, lane, plain_lane, ref, mag, depth, on, off, tiles, wrong=None, **extra):
    """The three checks of a lane: its checksum within `lane_limit` of its
    plain version's lane (``tiles``: `raw_tile_sums` of the launch's raw
    products), within `tolerance()` of the operand-side reference, and the
    outputs with the lane on bitwise those with it off.  ``wrong``: the
    lane-side controls, lanes of a faulty kernel ({name: value}), each of
    which must miss the plain lane by more than the limit."""
    tol = float(abft.tolerance(mag, depth))
    limit = lane_limit(tiles, tol)
    lane_f, plain_f, ref_f = float(lane), float(plain_lane), float(ref)
    res = {"case": case, **extra, "lane": lane_f, "plain_lane": plain_f, "operand_ref": ref_f, "tolerance": tol,
           "lane_limit": limit, "lane_vs_plain_over_limit": abs(lane_f - plain_f) / limit,
           "lane_vs_ref_over_tol": abs(lane_f - ref_f) / tol,
           "outputs_bitwise_lane_off": all(torch.equal(x, y) for x, y in zip(on, off))}
    if wrong:
        res["lane_side_controls_over_limit"] = {k: abs(float(v) - plain_f) / limit for k, v in wrong.items()}
    res["ok"] = (res["lane_vs_plain_over_limit"] <= 1 and res["lane_vs_ref_over_tol"] <= 1
                 and res["outputs_bitwise_lane_off"]
                 and all(r > 1 for r in res.get("lane_side_controls_over_limit", {}).values()))
    if not res["ok"]:
        raise AssertionError(f"ABFT lane check failed: {res}")
    return res


def _dropped(plain_lane, tiles):
    """The lane-side controls: a lane of 0, and the plain lane with its
    last tile's partial left out (a kernel that skipped its last task)."""
    return {"zero": 0.0, "last_tile_dropped": float(plain_lane) - float(tiles[-1])}


def _negative_control(torch, abft, namespace, out, chk, ref_of, a, depth):
    """One input element of A flipped after the launch (`flip_exponent_bit`)
    and the reference taken from the flipped A: eager `verify` must raise
    `SdcDetected`, and under "strict" in a step scope the output must come
    back NaN and the scope count one detection."""
    ref, mag = ref_of(flip_exponent_bit(torch, a))
    try:
        abft.verify(namespace, out, chk, ref, mag, contract_dim=depth, mode="detect")
        raised = False
    except abft.SdcDetected:
        raised = True
    before = abft.runtime_sdc_total()
    with abft.step_scope() as scope:
        poisoned = abft.verify(namespace, out, chk, ref, mag, contract_dim=depth, mode="strict")
    outs = poisoned if isinstance(poisoned, tuple) else (poisoned,)
    res = {"raised_sdc_detected": raised, "strict_output_nan": all(bool(torch.isnan(x).all()) for x in outs),
           "strict_counted": abft.runtime_sdc_total() - before, "scope_detections": scope.detections}
    if not (raised and res["strict_output_nan"] and res["strict_counted"] == 1):
        raise AssertionError(f"ABFT negative control in {namespace!r} failed: {res}")
    return res


def _lane_row(kernel, gm, lane_err, ms, off_ms, ref_ms, plain_ms, bound, partials, **extra):
    """A lane's row of the kernels line: its time with the lane on and off,
    the operand-side reference's, and the bound of the launch with the
    partials it writes (4 B each: one a task and set, the forward wgmma
    kernels' one a consumer warp of a task)."""
    flops, nbytes, peak = bound
    bound_ms, bound_by = _bound(flops, nbytes + 4.0 * partials, peak)
    return dict(kernel=kernel, gemm=gm, max_abs_err=lane_err, ms=ms, lane_off_ms=off_ms, operand_ref_ms=ref_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, partials=partials, **extra)


def phase_abft_lanes(torch, cfg, ocfg, tk, ops, abft, opt):
    """Each checksum lane against its plain version's lane and the
    operand-side reference within `tolerance()`, its outputs bitwise those
    with the lane off, at every shape of its path in bf16 and f32: K1/K2 at
    phase 2's K1/K2 shapes and its ragged case with every epilogue flag; K3
    at olmoe's decode, prefill and training shapes and on RAGGED_GROUPS; K8
    dW, single and dual, at every training shape, the LM head included;
    K8's update (bf16 stochastically rounded, f32) and norm modes at every
    layer's training shape.  In bf16 each is timed with the lane on and off
    beside the operand-side reference (`gemm_checksum_ref` /
    `tn_checksum_ref`).  Then a negative control per lane, and K8's update
    with an all-NaN gradient, whose NaN residual is no detection.  Returns
    (rows, checks, controls)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows, checks, controls = [], [], {}

    def r(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K1/K2 at the main path's shapes
    for gm in main_path_gemms(cfg):
        for dt in (torch.bfloat16, torch.float32):
            lead = (gm.batch,) if gm.batch else ()
            copies = max(1, math.ceil(4 * L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1)))) \
                if dt == torch.bfloat16 else 1
            a = r(*lead, gm.m, gm.k, dtype=dt)
            ws = [r(gm.k, gm.n, dtype=dt, scale=0.02) for _ in range(copies)]
            gs = [r(gm.k, gm.n, dtype=dt, scale=0.02) for _ in range(copies)] if gm.glu else [None] * copies
            kw = dict(preact=True) if gm.preact else dict(activation=cfg.act if gm.glu else gm.act)

            def call(i, lane):
                return tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies], abft=lane, **kw)

            on, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: call(0, True))
            layers = plain_layers(name, config)
            off = call(0, False)
            off = off if isinstance(off, tuple) else (off,)
            bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_fused_plain(a, ws[0], gs[0], bm=bm, bn=bn,
                                                                             k_layers=layers, abft=True, **kw))
            ref, mag = abft.gemm_checksum_ref(a, ws[0], gs[0])
            af = a.float()
            tiles = kernel_tiles(torch, name, config, *(af @ x.float() for x in (ws[0], gs[0]) if x is not None))
            del af
            checks.append(_lane_check(torch, abft, f"K1/K2:{gm.name}", on[-1], plain[-1], ref, mag, gm.k, on[:-1], off,
                                      tiles, _dropped(plain[-1], tiles) if gm.name == "decode/q" else None,
                                      dtype=str(dt), kernel=name.replace("_kernel", "_abft_kernel"), config=config))
            if dt == torch.bfloat16:
                if gm.name == "decode/q":
                    controls["K1/K2 decode/q"] = _negative_control(
                        torch, abft, "gemm", on[0], on[-1], lambda x: abft.gemm_checksum_ref(x, ws[0]), a, gm.k)
                reps = max(20, copies)
                ms = time_ms(lambda i: call(i, True), reps=reps, graph=True)
                off_ms = time_ms(lambda i: call(i, False), reps=reps, graph=True)
                ref_ms = time_ms(lambda i: abft.gemm_checksum_ref(a, ws[i % copies], gs[i % copies]), reps=reps,
                                 graph=True)
                rows.append(_lane_row("K1/K2", gm, abs(float(on[-1]) - float(plain[-1])), ms, off_ms, ref_ms,
                                      plain_ms, (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS),
                                      len(tiles) * (tk.build.WGMMA_LANE_SLOTS if "wgmma" in name else 1),
                                      cuda_kernel=name.replace("_kernel", "_abft_kernel"), config=config))
            del a, ws, gs, on, off, plain, tiles
    # the ragged cases with every epilogue flag: K 203 in both input types
    # (the tile kernel's lane), K 264 / N 328 in bf16 (the wgmma kernel's)
    for dt, (m, k, n) in ((torch.float32, (77, 203, 133)), (torch.bfloat16, (77, 203, 133)),
                          (torch.bfloat16, (77, 264, 328))):
        args = (r(3, m, k, dtype=dt), r(k, n, dtype=dt, scale=0.1), r(k, n, dtype=dt, scale=0.1), r(n, dtype=dt),
                r(1, n, dtype=dt), r(3, m, n, dtype=dt))
        kw = dict(activation="gelu", out_scale=0.7)
        on, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel,
                                      lambda: tk.sfc_gemm_fused(*args, abft=True, **kw))
        off = tk.sfc_gemm_fused(*args, **kw)
        plain = tk.sfc_gemm_fused_plain(*args, bm=32, bn=32, abft=True, **kw)
        ref, mag = abft.gemm_checksum_ref(args[0], args[1], args[2])
        tiles = kernel_tiles(torch, name, config, args[0].float() @ args[1].float(), args[0].float() @ args[2].float())
        wrong = {**_dropped(plain[-1], tiles), "after_epilogue": on[0].float().sum()}
        checks.append(_lane_check(torch, abft, "K1/K2:all_epilogue_flags_ragged", on[-1], plain[-1], ref, mag, k,
                                  on[:-1], (off,), tiles, wrong, dtype=str(dt), shape=[3, m, k, n],
                                  kernel=name.replace("_kernel", "_abft_kernel"), config=config))
    # K3 at olmoe's shapes, then on the ragged expert sizes (the second
    # with an expert over a 128-row tile)
    fwd = [gm for gm in moe_grouped_gemms(ocfg) if gm.kind == "fwd"]
    d, f = fwd[0].k, fwd[0].n
    e = len(RAGGED_GROUPS)
    ragged = [GroupedGemm("ragged/glu", "fwd", "-", e, 0, d, f, glu=True),
              GroupedGemm("ragged/glu_preact", "fwd", "-", e, 0, d, f, glu=True, preact=True),
              GroupedGemm("ragged/w_out", "fwd", "-", e, 0, f, d)]
    cases = [(gm, (gm.rows,) * gm.experts) for gm in fwd] + [(gm, RAGGED_GROUPS) for gm in ragged] + [
        (dataclasses.replace(gm, name=gm.name + "_long"), RAGGED_GROUPS_LONG) for gm in ragged]
    for gm, sizes in cases:
        for dt in (torch.bfloat16, torch.float32):
            args, kw, _ = _grouped_operands(torch, gm, dt, gen, rows=sizes)
            a, w, wg = args[0], args[1], args[2] if gm.glu else None

            def call(lane):
                return tk.sfc_gemm_grouped(*args, group_sizes=sizes, abft=lane, **kw)

            on, (name, config) = launched(tk.sfc_gemm_grouped.launches_by_kernel, lambda: call(True))
            off = call(False)
            off = off if isinstance(off, tuple) else (off,)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_grouped_plain(*args, group_sizes=sizes, bm=64, bn=64,
                                                                               abft=True, **kw))

            def ref_of(x):
                return abft.grouped_checksum_ref(x, w, wg, sizes)

            ref, mag = ref_of(a)
            tiles = kernel_tiles(torch, name, config,
                                 *(grouped_raw(torch, a, x, sizes) for x in (w, wg) if x is not None))
            # the last real tile: `grouped_raw` pads an expert's slab with zero rows
            wrong = (_dropped(plain[-1], tiles[tiles != 0]) if gm.name in ("decode/glu", "ragged/glu", "ragged/glu_long")
                     else None)
            lane_kernel = name.replace("_kernel", "_abft_kernel")
            checks.append(_lane_check(torch, abft, f"K3:{gm.name}", on[-1], plain[-1], ref, mag, gm.k, on[:-1], off,
                                      tiles, wrong, dtype=str(dt), group_sizes=list(sizes), kernel=lane_kernel,
                                      config=config))
            if dt == torch.bfloat16 and gm.path == "serve":
                if gm.name == "decode/glu":
                    controls["K3 decode/glu"] = _negative_control(torch, abft, "grouped_glu", on[0], on[-1], ref_of,
                                                                  a, gm.k)
                ms = time_ms(lambda i: call(True), reps=20, graph=True)
                off_ms = time_ms(lambda i: call(False), reps=20, graph=True)
                ref_ms = time_ms(lambda i: ref_of(a), reps=20, graph=True)
                rows.append(_lane_row("K3", gm, abs(float(on[-1]) - float(plain[-1])), ms, off_ms, ref_ms, plain_ms,
                                      (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS),
                                      len(tiles) * (tk.build.WGMMA_LANE_SLOTS if "wgmma" in name else 1),
                                      cuda_kernel=lane_kernel, config=config))
            del args, a, w, wg, on, off, plain, tiles
            torch.cuda.empty_cache()
    # K8 dW at every training shape
    for gm in [g for g in train_backward_gemms(cfg) if g.kind == "tn"]:
        for dt in (torch.bfloat16, torch.float32):
            copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2))) if dt == torch.bfloat16 else 1
            ins = [(r(gm.m, gm.k, dtype=dt), r(gm.m, gm.n, dtype=dt), r(gm.m, gm.n, dtype=dt) if gm.dual else None)
                   for _ in range(copies)]
            x, dc, dc2 = ins[0]
            on, (name, config) = launched(tk.sfc_gemm_tn.launches_by_kernel,
                                          lambda: tk.sfc_gemm_tn(x, dc, dc2, abft=True))
            off = tk.sfc_gemm_tn(x, dc, dc2)
            off = off if isinstance(off, tuple) else (off,)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_tn_plain(x, dc, dc2, bm=64, bn=64, abft=True))
            cuda_kernel = name.replace("_kernel", "_abft_kernel")
            for s, d_ in enumerate((dc, dc2) if gm.dual else (dc,)):
                ref, mag = abft.tn_checksum_ref(x, d_)
                tiles = kernel_tiles(torch, name, config, x.float().T @ d_.float())
                tasks = len(tiles) * (2 if gm.dual else 1)
                checks.append(_lane_check(torch, abft, f"K8 dW:{gm.name}[{s}]", on[-1][s, 0], plain[-1][s, 0], ref,
                                          mag, gm.m, on[:-1], off, tiles,
                                          _dropped(plain[-1][s, 0], tiles) if gm.name == "train/q" else None,
                                          dtype=str(dt), kernel=cuda_kernel, config=config))
                del tiles
            if dt == torch.bfloat16:
                if gm.name == "train/q":
                    controls["K8 dW train/q"] = _negative_control(
                        torch, abft, "tn", on[0], on[-1][0, 0], lambda a_: abft.tn_checksum_ref(a_, dc), x, gm.m)
                reps = max(20, copies)
                ms = time_ms(lambda i: tk.sfc_gemm_tn(*ins[i % copies], abft=True), reps=reps, graph=True)
                off_ms = time_ms(lambda i: tk.sfc_gemm_tn(*ins[i % copies]), reps=reps, graph=True)
                ref_ms = time_ms(lambda i: [abft.tn_checksum_ref(ins[i % copies][0], d_)
                                            for d_ in ins[i % copies][1:] if d_ is not None], reps=reps, graph=True)
                rows.append(_lane_row("K8 dW", gm, abs(float(on[-1][0, 0]) - float(plain[-1][0, 0])), ms, off_ms,
                                      ref_ms, plain_ms, (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS), tasks,
                                      cuda_kernel=cuda_kernel, config=config))
            del ins, x, dc, dc2, on, off, plain
            torch.cuda.empty_cache()
    # K8's update and norm modes at every layer's training shape
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (3 << 16) + 5

    def state(gm, dt):
        g = math.sqrt(gm.m)
        out = []
        for _ in range(gm.sets):
            mst = r(gm.k, gm.n, dtype=torch.float32, scale=0.02)
            out.append((mst, r(gm.k, gm.n, dtype=torch.float32, scale=0.5 * g),
                        r(gm.k, gm.n, dtype=torch.float32, scale=2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return out

    def update(fn, x, dcs, sets, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, w=w1,
                  w2=rest[0][3] if rest else None, salt=salt, stochastic_round=dt == torch.bfloat16, **kw)

    def clone(sets):
        return [tuple(t.clone() for t in st) for st in sets]

    for gm in [g for g in train_update_gemms(cfg) if g.name != "train/head"]:
        for dt in (torch.bfloat16, torch.float32):
            x, dcs, sets = r(gm.m, gm.k, dtype=dt), [r(gm.m, gm.n, dtype=dt) for _ in range(gm.sets)], state(gm, dt)
            on_sets, off_sets = clone(sets), clone(sets)
            (norms_on, chk), (name, config) = launched(tk.sfc_gemm_tn.launches_by_kernel,
                                                       lambda: update(tk.sfc_gemm_tn, x, dcs, on_sets, dt, abft=True))
            norms_off = update(tk.sfc_gemm_tn, x, dcs, off_sets, dt)
            cuda_kernel = name.replace("_kernel", "_abft_kernel")
            (_, plain_chk), plain_ms = _once_ms(torch, lambda: update(tk.sfc_gemm_tn_plain, x, dcs, clone(sets), dt,
                                                                      bm=64, bn=64, abft=True))
            nnorm_on, nchk = tk.sfc_gemm_tn(x, *dcs, norm=True, abft=True)
            nnorm_off = tk.sfc_gemm_tn(x, *dcs, norm=True)
            on_all = [norms_on, *(t for st in on_sets for t in st)]
            off_all = [norms_off, *(t for st in off_sets for t in st)]
            for s, d_ in enumerate(dcs):
                ref, mag = abft.tn_checksum_ref(x, d_)
                tiles = kernel_tiles(torch, name, config, x.float().T @ d_.float())
                tasks = len(tiles) * gm.sets
                wrong = _dropped(plain_chk[s, 0], tiles) if gm.name == "train/q" else None
                checks.append(_lane_check(torch, abft, f"K8 update:{gm.name}[{s}]", chk[s, 0], plain_chk[s, 0], ref,
                                          mag, gm.m, on_all, off_all, tiles, wrong, dtype=str(dt),
                                          stochastic_round=dt == torch.bfloat16, kernel=cuda_kernel, config=config))
                checks.append(_lane_check(torch, abft, f"K8 norm:{gm.name}[{s}]", nchk[s, 0], plain_chk[s, 0], ref,
                                          mag, gm.m, [nnorm_on], [nnorm_off], tiles, wrong, dtype=str(dt),
                                          kernel=cuda_kernel, config=config))
                del tiles
            if dt == torch.bfloat16:
                if gm.name == "train/q":
                    controls["K8 update train/q"] = _negative_control(
                        torch, abft, "tn_update", norms_on, chk[0, 0], lambda a_: abft.tn_checksum_ref(a_, dcs[0]),
                        x, gm.m)
                    # an all-NaN gradient: a NaN residual, which is no detection
                    nan_dc = torch.full_like(dcs[0], float("nan"))
                    _, nan_chk = update(tk.sfc_gemm_tn, x, [nan_dc], clone(sets), dt, abft=True)
                    nan_ref, nan_mag = abft.tn_checksum_ref(x, nan_dc)
                    before = abft.runtime_sdc_total()
                    abft.verify("tn_update", norms_on, nan_chk[0, 0], nan_ref, nan_mag, contract_dim=gm.m,
                                mode="detect")  # eager: raises on a detection
                    with abft.step_scope() as scope:
                        abft.verify("tn_update", norms_on, nan_chk[0, 0], nan_ref, nan_mag, contract_dim=gm.m,
                                    mode="strict")
                    controls["K8 update, all-NaN gradient"] = {
                        "lane_is_nan": bool(torch.isnan(nan_chk).all()), "detections": scope.detections,
                        "counted": abft.runtime_sdc_total() - before}
                    if not controls["K8 update, all-NaN gradient"]["lane_is_nan"] or scope.detections:
                        raise AssertionError(f"the NaN step's lane: {controls['K8 update, all-NaN gradient']}")
                ms = time_ms(lambda i: update(tk.sfc_gemm_tn, x, dcs, on_sets, dt, abft=True), reps=20, graph=True)
                off_ms = time_ms(lambda i: update(tk.sfc_gemm_tn, x, dcs, off_sets, dt), reps=20, graph=True)
                ref_ms = time_ms(lambda i: [abft.tn_checksum_ref(x, d_) for d_ in dcs], reps=20, graph=True)
                nms = time_ms(lambda i: tk.sfc_gemm_tn(x, *dcs, norm=True, abft=True), reps=20, graph=True)
                noff_ms = time_ms(lambda i: tk.sfc_gemm_tn(x, *dcs, norm=True), reps=20, graph=True)
                err = abs(float(chk[0, 0]) - float(plain_chk[0, 0]))
                for mode, t_on, t_off in (("update", ms, off_ms), ("norm", nms, noff_ms)):
                    g2 = dataclasses.replace(gm, mode=mode)
                    rows.append(_lane_row(f"K8 {mode}", g2, err, t_on, t_off, ref_ms, plain_ms,
                                          (g2.flops(), g2.bytes(2), PEAK_BF16_FLOPS), tasks,
                                          cuda_kernel=cuda_kernel, config=config))
            del x, dcs, sets, on_sets, off_sets
            torch.cuda.empty_cache()
    return rows, checks, controls


# ---------------------------------------------------------------------------
# remat (the JAX package's default training path, "dots") and the training
# of the families that only served: seamless-m4t-medium, zamba2-1.2b,
# xlstm-1.3b, qwen2-vl-72b
# ---------------------------------------------------------------------------

# the remat phase's policies beside "none" (the runs of phases 5 and 8)
REMAT_RUNS = ("dots", "full")
# one fused qwen3-4b step of LONG_SEQ-token sequences under "dots": the
# largest batch `fused_step_reckoning` fits on the card (2 x 2048 would
# need about 85 GB: the fused tape holds every projection's (a, dh, dg))
LONG_BATCH, LONG_SEQ = 1, 2048
CARD_BYTES = 80e9
# qwen2-vl-72b trains at full width on VLM_TRAIN_LAYERS of its 80 layers:
# AdamW holds 16 B a parameter unfused, the embedding and head are 2.49 B
# parameters and a layer 0.876 B, so 2 layers hold 67.9 GB and 1 layer
# 53.9 GB; 2 x 256 tokens under "dots" add about 1.5 GB (the head's f32
# logits and their gradient), so 2 layers fit with 10 GB to spare; its
# f32 gradient check on VLM_TRAIN_CHECK_LAYERS
VLM_TRAIN_LAYERS, VLM_TRAIN_CHECK_LAYERS = 2, 1


def family_train_want(cfg, seq, fused=False, remat="dots"):
    """The launches of each SFC wrapper in one train step of ``cfg`` at
    ``seq`` tokens a sequence under sfc_cuda + "sfc" attention, reckoned
    from the call sites (tests/test_torch_remat.py counts them on the CPU):
    under a policy other than "none" every kernel call of a remat unit's
    forward runs twice (the forward and its recompute), those outside the
    units (a decoder's LM head) once; each projection's backward launches
    K7 and K8 once (the fused step: K8's norm and update modes for a routed
    weight, one launch for a GLU pair), each chunk product's K2 twice (its
    dA and dB over per-batch B on the forward kernel), each attention K12
    and K13 once.  Units: a decoder or encoder layer (q, k, v, o and the
    MLP; a seamless decoder layer also the cross-attention's q, o and the
    memory's k, v), a hybrid group (2 chunk products a Mamba2 layer; the
    shared block's 6 projections) or tail block, an xLSTM group (2 chunk
    products a chunk of each mLSTM block; the sLSTM none)."""
    r = 1 if remat == "none" else 2
    if cfg.family == "audio":
        in_units, outside, chunk_bwd = 6 * cfg.encoder_layers + 10 * cfg.n_layers, 0, 0
        proj, attn = in_units, cfg.encoder_layers + 2 * cfg.n_layers
        routed = proj  # every projection reaches its call site once a step
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        in_units, outside, chunk_bwd = 2 * cfg.n_layers + 6 * groups, 0, 4 * cfg.n_layers
        # the shared block's weights serve every group: none is routed
        proj, attn, routed = 6 * groups, groups, 0
    elif cfg.family == "ssm":
        chunks = math.ceil(seq / min(cfg.ssm_chunk, seq))
        mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
        # the projections and the head are torch.matmul: no K7, K8
        in_units, outside, chunk_bwd = 2 * mlstm * chunks, 0, 4 * mlstm * chunks
        proj = attn = routed = 0
    else:  # a dense decoder or the VLM: q, k, v, o, the GLU, w_out a layer, and the LM head
        in_units, outside, chunk_bwd = 6 * cfg.n_layers, 1, 0
        proj, attn = 6 * cfg.n_layers + 1, cfg.n_layers
        routed = proj
    routed = routed if fused else 0
    return {"sfc_gemm_fused": r * in_units + outside + chunk_bwd, "sfc_gemm_nt": proj,
            "sfc_gemm_tn": proj + routed, "sfc_gemm_tn:dw": proj - routed, "sfc_gemm_tn:norm": routed,
            "sfc_gemm_tn:update": routed, "sfc_flash_fwd": r * attn, "sfc_flash_bwd_dq": attn,
            "sfc_flash_bwd_dkv": attn}


def fused_step_reckoning(cfg, batch, seq) -> dict:
    """GB a fused step of a dense decoder holds at its peak under "dots",
    reckoned from the shapes: the weights and their f32 master, mu and nu
    (14 B a parameter; the unrouted embedding's bf16 gradient besides), the
    fused tape (each projection's input a and cotangents dh, dg in bf16
    until the update: a layer's four distinct inputs and its outputs' 30 k
    columns, and the head's), the layer inputs remat keeps, the head's
    logits in bf16 and f32 and their f32 gradient; and what "none" keeps
    more: a layer's saved activations beyond the tape's (about 37 k
    elements a token for qwen3-4b)."""
    d, q, kv, ff, L, v = (cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.kv_heads * cfg.head_dim_, cfg.d_ff,
                          cfg.n_layers, cfg.vocab)
    tokens = batch * seq
    params = v * d * (1 if cfg.tie_embeddings else 2) + d + L * (d * (q + 2 * kv) + q * d + 3 * d * ff + 2 * d)
    state = params * 14 + v * d * 2
    a_cols, dh_cols = d + q + d + ff, q + 2 * kv + d + 2 * ff + d
    tape = 2 * tokens * (L * (a_cols + dh_cols) + d + v)
    inputs = 2 * tokens * d * L
    head = tokens * v * (2 + 4 + 4)
    none_more = 2 * tokens * L * (2 * d + 2 * (q + 2 * kv) + q + d + 2 * ff + ff - a_cols)
    gb = {"state": state, "tape": tape, "layer_inputs": inputs, "head": head}
    gb = {k: val / 1e9 for k, val in gb.items()}
    gb["dots_total"] = sum(gb.values())
    gb["none_total"] = gb["dots_total"] + none_more / 1e9
    return gb


def family_bwd_gemms(scfg, zcfg, vcfg):
    """K7 and K8 at each distinct projection shape of the families' training
    steps (2 x 256 token rows): seamless's attention (self and cross, one
    shape) and its gelu MLP, zamba2's shared block, qwen2-vl-72b's layer
    (its 2.49 GB head off: its plain TN alone takes seconds)."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    d = scfg.d_model
    shapes = [("seamless", "attention", d, d, False), ("seamless", "mlp_in", d, scfg.d_ff, False),
              ("seamless", "mlp_out", scfg.d_ff, d, False)]
    for label, c in (("zamba2", zcfg), ("qwen2-vl-72b", vcfg)):
        seen = set()
        for name, k, n, glu in _projections(c):
            if (k, n, glu) not in seen:
                seen.add((k, n, glu))
                shapes.append((label, name, k, n, glu))
    return [BwdGemm(f"{label}/train/{name}", kind, rows, k, n, glu)
            for kind in ("nt", "tn") for label, name, k, n, glu in shapes]


def family_update_gemms(vcfg):
    """K8's update and norm modes at qwen2-vl-72b's GLU, the widest routed
    pair of the families' fused steps: 8192 x 2 x 29568."""
    return [UpdGemm("qwen2-vl-72b/train/mlp_glu", "update", TRAIN_BATCH * TRAIN_SEQ, vcfg.d_model, vcfg.d_ff,
                    True)]


def family_attention_cases(scfg, zcfg, vcfg):
    """K11 at the families' training shapes (2 x 256): seamless's decoder
    self-attention (causal) and its encoder's and cross-attention's
    (non-causal, 256 queries over 256 frames, one shape), zamba2's shared
    block, the VLM's 64 / 8 heads."""
    def heads(c):
        return dict(h=c.n_heads, hkv=c.kv_heads, d=c.head_dim_)

    b, s = TRAIN_BATCH, TRAIN_SEQ
    return [Attn("seamless/train_decoder_self", "sfc_flash_fwd", b, s, s, path="seamless train", **heads(scfg)),
            Attn("seamless/train_encoder_self_and_cross", "sfc_flash_fwd", b, s, s, causal=False,
                 path="seamless train", **heads(scfg)),
            Attn("zamba2/train", "sfc_flash_fwd", b, s, s, path="zamba2 train", **heads(zcfg)),
            Attn("qwen2-vl-72b/train", "sfc_flash_fwd", b, s, s, path="qwen2-vl-72b train", **heads(vcfg))]


def family_attention_bwd_cases(scfg, zcfg, vcfg):
    """K12 and K13 at the same training shapes (bf16, the wgmma kernels),
    and one check off the path at S != T: 128 queries over 256 frames, the
    seamless serve's cross-attention shape."""
    def heads(c):
        return dict(h=c.n_heads, hkv=c.kv_heads, d=c.head_dim_, dtype="bfloat16")

    b, s = TRAIN_BATCH, TRAIN_SEQ
    return [AttnBwd("seamless/train_decoder_self", b, s, s, **heads(scfg)),
            AttnBwd("seamless/train_encoder_self_and_cross", b, s, s, causal=False, **heads(scfg)),
            AttnBwd("seamless/cross_128_over_256", b, PROMPT, ENCDEC_FRAMES, causal=False, main_path=False,
                    **heads(scfg)),
            AttnBwd("zamba2/train", b, s, s, **heads(zcfg)),
            AttnBwd("qwen2-vl-72b/train", b, s, s, **heads(vcfg))]


def family_chunk_gemms(zcfg, xcfg):
    """The chunk products of the training steps (2 x 256 tokens: one chunk
    a sequence for both) and their backward over per-batch B, the forward
    kernel on transposed operands (dA = dC B^T, dB = A^T dC; the f32-output
    products' cotangent cast to bf16 first): zamba2's SSD scores (f32 out)
    and output, xlstm-1.3b's mLSTM qk scores (f32 out) and output product
    (f32).  A backward product of a forward's shape shares its row."""
    b, s = TRAIN_BATCH, TRAIN_SEQ
    L = min(zcfg.ssm_chunk, s)
    nc = math.ceil(s / L)
    heads = zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_head_dim
    n, p = zcfg.ssm_state, zcfg.ssm_head_dim
    xl = min(xcfg.ssm_chunk, s)
    xh = xcfg.n_heads
    xp = 2 * xcfg.d_model // xh
    z, x = "zamba2 train", "xlstm train"
    return [
        ChunkGemm("zamba2/train/ssd_scores", b * nc, L, n, L, True, z),
        ChunkGemm("zamba2/train/ssd_scores_bwd_dC", b * nc, L, L, n, False, z),
        ChunkGemm("zamba2/train/ssd_scores_bwd_dB", b * nc, n, L, L, False, z),
        ChunkGemm("zamba2/train/ssd_out_and_bwd_dx", b * nc * heads, L, L, p, False, z),
        ChunkGemm("zamba2/train/ssd_out_bwd_dw", b * nc * heads, L, p, L, False, z),
        ChunkGemm("xlstm/train/mlstm_qk", b * xh, xl, xp, xl, True, x),
        ChunkGemm("xlstm/train/mlstm_qk_bwd_dq", b * xh, xl, xl, xp, False, x),
        ChunkGemm("xlstm/train/mlstm_qk_bwd_dk", b * xh, xp, xl, xl, False, x),
        ChunkGemm("xlstm/train/mlstm_out_and_bwd_dv", b * xh, xl, xl, xp, False, x, f32_in=True),
        ChunkGemm("xlstm/train/mlstm_out_bwd_datt", b * xh, xl, xp, xl, False, x, f32_in=True),
    ]


def _fwd_key(key: str) -> bool:
    """A launch-count key of a forward wrapper (run twice by a remat unit)."""
    return key.split(":")[0] in ("sfc_gemm_fused", "sfc_gemm_grouped", "sfc_flash_fwd")


def _remat_counts_ok(none_step: dict, step: dict, outside: dict) -> bool:
    """A step under remat launches each forward wrapper twice its "none"
    count less the launches outside the remat units (``outside``: the LM
    head's), and every backward wrapper as often."""
    return set(step) == set(none_step) and all(
        step[k] == (2 * n - outside.get(k, 0) if _fwd_key(k) else n) for k, n in none_step.items())


def forward_kept(torch, cfg, build_model, gemm_backend, attention_backend, make_batch_fn):
    """What one forward of ``cfg`` (bf16, seed 0, a TRAIN_BATCH x TRAIN_SEQ
    batch) leaves allocated for its backward, by backend and remat policy:
    the bytes allocated after the loss less before it, and the peak of the
    forward and backward (the gradients included) over the same base."""
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    batch = make_batch_fn(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, device="cuda")(0)
    out = {}
    for name, (gemm, impl) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc")), ("torch", ("torch", "blockwise"))):
        out[name] = {}
        for policy in ("none", *REMAT_RUNS):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            with gemm_backend(gemm), attention_backend(impl):
                loss = model.loss(batch, remat=policy)
            torch.cuda.synchronize()
            m1 = torch.cuda.memory_allocated()
            loss.backward()
            torch.cuda.synchronize()
            out[name][policy] = {"kept_bytes": m1 - m0, "fwd_bwd_peak_bytes": torch.cuda.max_memory_allocated() - m0}
            del loss
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_remat(torch, cfg, ocfg, build_trainer, build_model, make_batch_fn, gemm_backend, attention_backend,
                counted, moe_counted, base, moe_base):
    """Remat on the card.  qwen3-4b at full depth, 2 x 256 tokens, three
    steps under "dots" and "full" beside phase 5's "none" runs, unfused and
    fused under sfc_cuda + "sfc", and unfused under torch + blockwise;
    olmoe-1b-7b fused at MOE_TRAIN_LAYERS layers under "dots" beside phase
    8's.  The same kernels get the same inputs, so the losses and every
    parameter and f32 master (`digest`) must be bitwise "none"'s; each
    forward wrapper launches twice its "none" count a step but the head's
    (K2 at every layer projection, K11, K3), each backward one as often,
    and by shape each layer projection's K2 exactly twice.  A forward's
    kept bytes (`forward_kept`): under torch "dots" keeps the products'
    outputs, more than "full"; under sfc_cuda both keep the same (the
    layers' inputs), less than "none".  Then one fused qwen3-4b
    step at LONG_BATCH x LONG_SEQ under "dots" (`fused_step_reckoning`:
    "none" is reckoned, not run).  ``base`` / ``moe_base``: {run name:
    (run, launches by shape, digests)} of phases 5 and 8."""
    def head_key(c):
        return Gemm("train/head", "train", TRAIN_BATCH, TRAIN_SEQ, c.d_model, c.vocab).key

    head = {"sfc_gemm_fused": 1, "sfc_gemm_fused:wgmma": 1}
    out = {"phase": "remat", "arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS}
    bad = []

    def compare(label, name, base_run, base_shapes, base_digests, run, shapes, digests, head_shape):
        mism = sorted(n for n, v in digests.items() if v != base_digests[n])
        res = {"losses": run["losses"], "losses_bitwise_none": run["losses"] == base_run["losses"],
               "params_and_masters_bitwise_none": not mism, "differing": mism[:8], "step_s": run["step_s"],
               "peak_memory_bytes": run["peak_memory_bytes"]}
        if "profiled_step" in run:
            res["profiled_step"] = run["profiled_step"]
        if "sfc_gemm_fused" in shapes and base_run["launches_per_step"][0].get("sfc_gemm_fused"):
            res["launches_per_step"] = run["launches_per_step"]
            res["counts_ok"] = all(_remat_counts_ok(b, s, head)
                                   for b, s in zip(base_run["launches_per_step"], run["launches_per_step"]))
            fwd, none_fwd = shapes["sfc_gemm_fused"], base_shapes["sfc_gemm_fused"]
            res["k2_by_projection_twice_none"] = set(fwd) == set(none_fwd) and all(
                fwd[k] == (n if k == head_shape else 2 * n) for k, n in none_fwd.items())
            res["backward_by_shape_as_none"] = all(shapes[k] == base_shapes[k] for k in shapes if not _fwd_key(k)
                                                   and k != "totals")
            ok = res["counts_ok"] and res["backward_by_shape_as_none"] and res["k2_by_projection_twice_none"]
        else:
            ok = True
        if not (ok and res["losses_bitwise_none"] and res["params_and_masters_bitwise_none"]):
            bad.append(f"{label} {name}")
        return res

    for label, base_name, (gemm, impl, fused) in (
            ("qwen3-4b unfused", "sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False)),
            ("qwen3-4b fused", "sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True)),
            ("qwen3-4b torch", "torch", ("torch", "blockwise", False))):
        base_run, base_shapes, base_digests = base[base_name]
        res = {"none": {"losses": base_run["losses"], "step_s": base_run["step_s"],
                        "peak_memory_bytes": base_run["peak_memory_bytes"]}}
        for policy in REMAT_RUNS:
            run, shapes = _train_run(torch, cfg, build_trainer, counted, gemm, impl, fused, remat=policy,
                                     digests=True, profile=policy == "dots" and label == "qwen3-4b unfused")
            res[policy] = compare(label, policy, base_run, base_shapes, base_digests, run, shapes,
                                  run.pop("digests"), head_key(cfg))
        out[label] = res
    out["peak_memory_bytes"] = {label: {p: out[label][p]["peak_memory_bytes"] for p in ("none", *REMAT_RUNS)}
                                for label in ("qwen3-4b unfused", "qwen3-4b fused", "qwen3-4b torch")}
    # what a forward keeps for its backward (the step's peak is the eager
    # AdamW's, after the activations are gone)
    gc.collect()
    torch.cuda.empty_cache()
    kept = forward_kept(torch, cfg, build_model, gemm_backend, attention_backend, make_batch_fn)
    out["forward_kept"] = kept
    sfc_kept = {p: kept["sfc_cuda+sfc_attn"][p]["kept_bytes"] for p in ("none", *REMAT_RUNS)}
    torch_kept = {p: kept["torch"][p]["kept_bytes"] for p in ("none", *REMAT_RUNS)}
    out["torch_dots_keeps_more_than_full"] = torch_kept["dots"] > torch_kept["full"]
    out["sfc_dots_keeps_what_full_keeps"] = sfc_kept["dots"] == sfc_kept["full"] < sfc_kept["none"]
    if not (out["torch_dots_keeps_more_than_full"] and out["sfc_dots_keeps_what_full_keeps"]):
        bad.append(f"kept bytes: sfc {sfc_kept}, torch {torch_kept}")
    # olmoe's grouped tape under recompute
    cut = dataclasses.replace(ocfg, n_layers=MOE_TRAIN_LAYERS)
    base_run, base_shapes, base_digests = moe_base["sfc_cuda+sfc_attn+fused_optimizer"]
    run, shapes = _train_run(torch, cut, build_trainer, moe_counted, "sfc_cuda", "sfc", True, _MOE_KERNEL_GROUPS,
                             remat="dots", digests=True, profile=False)
    out["olmoe fused"] = {"layers": MOE_TRAIN_LAYERS, "none": {"losses": base_run["losses"],
                                                                "step_s": base_run["step_s"],
                                                                "peak_memory_bytes": base_run["peak_memory_bytes"]},
                          "dots": compare("olmoe fused", "dots", base_run, base_shapes, base_digests, run, shapes,
                                          run.pop("digests"), head_key(ocfg))}
    # one long fused step
    gc.collect()
    torch.cuda.empty_cache()
    reckon = {b: fused_step_reckoning(cfg, b, LONG_SEQ) for b in (1, 2)}
    run, _ = _train_run(torch, cfg, build_trainer, counted, "sfc_cuda", "sfc", True, remat="dots",
                        batch=LONG_BATCH, seq=LONG_SEQ, steps=1, profile=False)
    want = family_train_want(cfg, LONG_SEQ, fused=True)
    step = run["launches_per_step"][0]
    out["long_fused_step"] = {"batch": LONG_BATCH, "seq": LONG_SEQ, "remat": "dots", "loss": run["losses"][0],
                              "step_s": run["step_s"][0], "peak_memory_bytes": run["peak_memory_bytes"],
                              "reckoned_gb": reckon, "launches": step, "launches_expected": want,
                              "none_not_run": f"reckoned {reckon[LONG_BATCH]['none_total']:.1f} GB"}
    if not math.isfinite(run["losses"][0]) or {k: step[k] for k in want} != want:
        bad.append("the long fused step")
    emit(out)
    if bad:
        raise AssertionError(f"remat runs disagree with remat none: {bad}")
    return out


def phase_family_train(torch, cfg, build_trainer, build_model, make_batch_fn, gemm_backend, attention_backend,
                       counted, label, check_cut):
    """TRAIN_STEPS steps of `build_trainer` at full width (qwen2-vl-72b at
    VLM_TRAIN_LAYERS layers) and 2 x 256 tokens under the JAX package's
    default remat, "dots": under sfc_cuda + "sfc" (then one profiled
    step), with the fused optimizer where `probe_routed` routes a weight,
    and under torch + blockwise; exact launches a step
    (`family_train_want`), every unfused loss within 2^-7 of torch's and
    every fused one of the unfused one's, every parameter moved, no routed
    weight left with a .grad.  Then the f32 cut ``check_cut`` (config
    fields): loss and every gradient under sfc_cuda + "sfc" within the
    bf16 bound of torch's, its launches exact (`phase_grad_check`).
    Returns (summary, launches by shape of the sfc run and of the fused
    one)."""
    want = family_train_want(cfg, TRAIN_SEQ)
    runs, shapes = {}, {}
    runs["sfc_cuda+sfc_attn"], shapes["sfc_cuda+sfc_attn"] = _train_run(
        torch, cfg, build_trainer, counted, "sfc_cuda", "sfc", False, remat="dots", probe=True)
    routed = runs["sfc_cuda+sfc_attn"]["routed"]
    if routed["weights"]:
        runs["fused"], shapes["fused"] = _train_run(torch, cfg, build_trainer, counted, "sfc_cuda", "sfc", True,
                                                    remat="dots", profile=False)
    runs["torch"], _ = _train_run(torch, cfg, build_trainer, counted, "torch", "blockwise", False, remat="dots",
                                  profile=False)
    sfc, ref = runs["sfc_cuda+sfc_attn"], runs["torch"]
    bad = [i for i, c in enumerate(sfc["launches_per_step"]) if {k: c[k] for k in want} != want]
    loss_ok = _losses_close(sfc, ref)
    out = {"phase": f"train_{label}", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "remat": "dots", "routed": routed,
           "launches_expected_per_step": want, "loss_within_2^-7": loss_ok}
    if "fused" in runs:
        want_fused = family_train_want(cfg, TRAIN_SEQ, fused=True)
        out["fused_launches_expected_per_step"] = want_fused
        out["fused_loss_within_2^-7_of_unfused"] = _losses_close(runs["fused"], sfc)
        bad += [f"fused {i}" for i, c in enumerate(runs["fused"]["launches_per_step"])
                if {k: c[k] for k in want_fused} != want_fused]
        if not all(out["fused_loss_within_2^-7_of_unfused"]) or runs["fused"]["params_with_grad"]:
            bad.append("fused losses or .grad")
    out.update(runs)
    gc.collect()
    torch.cuda.empty_cache()
    cut_cfg = dataclasses.replace(cfg, **check_cut)
    batch = make_batch_fn(cut_cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=1, device="cuda")(0)
    out["grad_check"] = phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, batch,
                                         cut=check_cut, want=family_train_want(cut_cfg, TRAIN_SEQ, remat="none"))
    emit(out)
    if bad or not all(loss_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"{cfg.name} training: launches off at {bad} ({sfc['launches_per_step']}, expected "
                             f"{want}) or losses {sfc['losses']} vs torch {ref['losses']}")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"{cfg.name} {name} training left parameters unchanged: {run['unchanged_params']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out, shapes


# ---------------------------------------------------------------------------
# the tuner (item 13): calibration, warmup tuning of qwen3-4b's serve and
# train namespaces, the tuned serve and step
# ---------------------------------------------------------------------------

# the TPU kernel each tuned namespace's kernel replaces, and the CUDA source
TUNE_REPLACES = {"gemm": "src/repro/kernels/sfc_gemm.py:355", "glu": "src/repro/kernels/sfc_gemm.py:355",
                 "nt": "src/repro/kernels/sfc_gemm.py:1219", "nt_dual": "src/repro/kernels/sfc_gemm.py:1219",
                 "tn": "src/repro/kernels/sfc_gemm.py:1429", "tn_dual": "src/repro/kernels/sfc_gemm.py:1429",
                 "tn_update": "src/repro/kernels/sfc_gemm.py:1094",
                 "tn_update_dual": "src/repro/kernels/sfc_gemm.py:1094",
                 "attn_fwd": "src/repro/kernels/sfc_attention.py:204",
                 "attn_bwd": "src/repro/kernels/sfc_attention.py:509",
                 "attn_decode": "src/repro/kernels/sfc_attention.py:660"}
# a winner that sets one of these orders an element's sum differently from
# the rule (the cluster kernel's K layers, K13's parts of the group, K14's
# segments); the tile width, the worker group and W do not
SUM_ORDER_KEYS = ("layers", "cluster", "splits")


def tuned_shapes(deltas):
    """{(op, (m, n, k), heads): launches} of the tuned serve and steps, from
    the wrappers' ``launches_by_shape`` deltas, each key the resolver's: a
    GEMM's (rows, N, K), a shared weight's batch folded into its rows (no
    per-batch weight runs on qwen3-4b's sfc_cuda path), the TN kernel's (K,
    N, M) with the contraction M last, an attention's (Sq, Sk, D) or the
    decode's (H, T, D) with its (batch, q heads, kv heads)."""
    out = collections.Counter()
    for (batch, m, k, n, glu), c in deltas["sfc_gemm_fused"].items():
        out[("glu" if glu else "gemm", (max(batch, 1) * m, n, k), None)] += c
    for (m, n, k, dual), c in deltas["sfc_gemm_nt"].items():
        out[("nt_dual" if dual else "nt", (m, n, k), None)] += c
    for key, c in deltas["sfc_gemm_tn"].items():
        (k, n, m, dual), update = key[:4], len(key) == 5
        op = ("tn_update" if update else "tn") + ("_dual" if dual else "")
        out[(op, (k, n, m), None)] += c
    for op, wrapper in (("attn_fwd", "sfc_flash_fwd"), ("attn_bwd", "sfc_flash_bwd_dkv")):
        for (b, s_, t, h, hkv, d, _), c in deltas[wrapper].items():
            out[(op, (s_, t, d), (b, h, hkv))] += c
    for (b, h, t, hkv, d), c in deltas["sfc_decode_attention"].items():
        out[("attn_decode", (h, t, d), (b, h, hkv))] += c
    return out


def tuned_case(torch, tk, tsa, ops, ab, build, op, m, n, k, heads):
    """One launched shape of a tuned namespace on card operands, the call
    resolving its launch from the process-wide tune cache: (run(), the
    wrapper counter that names its launch, plain(key) its plain version
    over the split that key names, flops, bytes, library() or None, the
    comparison's dtype)."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dt)  # noqa: E731
    big = dict(bm=4096, bn=4096)  # coarse plain tiles: the same sum for every element, fewer host steps
    dual = op in ("glu", "nt_dual", "tn_dual", "tn_update_dual")
    if op in ("gemm", "glu"):
        a, b, bg = rnd(m, k), rnd(k, n), rnd(k, n)
        run = (lambda: ops.sfc_glu_matmul(a, bg, b)) if dual else (lambda: ops.sfc_matmul(a, b))

        def plain(key):  # the cluster kernel's L, else one K layer
            return tk.sfc_gemm_fused_plain(a, b, bg if dual else None, activation="silu" if dual else None,
                                           k_layers=key[1] if key[0] == "sfc_gemm_cluster_kernel" else 1, **big)

        lib = None if dual else (lambda: torch.matmul(a, b))
        nbytes = 2 * (m * k + k * n * (2 if dual else 1) + m * n)
        return run, tk.sfc_gemm_fused.launches_by_kernel, plain, 2.0 * m * n * k * (2 if dual else 1), nbytes, \
            lib, dt
    if op in ("nt", "nt_dual"):
        a, b = rnd(m, k), rnd(n, k)
        extra = (a, b) if dual else ()
        nbytes = 2 * ((m * k + n * k) * (2 if dual else 1) + m * n)
        return (lambda: ops.sfc_matmul_nt(a, b, *extra)), tk.sfc_gemm_nt.launches_by_kernel, \
            (lambda key: tk.sfc_gemm_nt_plain(a, b, *extra, **big)), 2.0 * m * n * k * (2 if dual else 1), \
            nbytes, (None if dual else (lambda: a @ b.T)), dt
    if op in ("tn", "tn_dual"):
        a, b = rnd(k, m), rnd(k, n)
        b2 = b if dual else None
        nbytes = 2 * (k * m + k * n * (2 if dual else 1) + m * n * (2 if dual else 1))
        return (lambda: ops.sfc_matmul_tn(a, b, b2)), tk.sfc_gemm_tn.launches_by_kernel, \
            (lambda key: tk.sfc_gemm_tn_plain(a, b, b2, **big)), 2.0 * m * n * k * (2 if dual else 1), nbytes, \
            (None if dual else (lambda: a.T @ b)), dt
    if op in ("tn_update", "tn_update_dual"):
        from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

        a, b = rnd(k, m), rnd(k, n)
        hyper = pack_adamw_hyper(AdamWConfig(), torch.ones((), dtype=torch.int32, device=dev),
                                 torch.ones((), dtype=torch.float32, device=dev))
        w0 = rnd(m, n)
        sets = 2 if dual else 1

        def state():
            return [(w0.float(), torch.zeros_like(w0, dtype=torch.float32), torch.zeros_like(w0, dtype=torch.float32),
                     w0.clone()) for _ in range(sets)]

        def update(st):
            (m1, u1, v1, w1), *rest = st
            second = (b, *rest[0][:3]) if dual else ()
            return ops.sfc_matmul_tn_update(a, b, m1, u1, v1, hyper, *second, w=w1,
                                            **({"w2": rest[0][3]} if dual else {}))

        def run():
            st = state()
            norms = update(st)
            return (torch.stack(list(norms)) if dual else norms.reshape(1), *(x[0] for x in st))

        def plain(key):
            st = state()
            (m1, u1, v1, w1), *rest = st
            second = (b, *rest[0][:3]) if dual else (None, None, None, None)
            norms = tk.sfc_gemm_tn_plain(a, b, second[0], m1, u1, v1, *second[1:], hyper, w=w1,
                                         w2=rest[0][3] if dual else None, **big)
            return (norms.reshape(-1), *(x[0] for x in st))

        fixed = state()
        run.timed = lambda: update(fixed)  # in place on one state
        nbytes = 2 * (k * m + k * n * sets) + sets * 4 * m * n * 3 * 2 + sets * 2 * m * n * 2
        return run, tk.sfc_gemm_tn.launches_by_kernel, plain, 2.0 * m * n * k * sets, nbytes, None, torch.float32
    b_, h, hkv = heads
    if op == "attn_decode":
        q, kk, vv = rnd(b_, 1, m, k), rnd(b_, n, hkv, k), rnd(b_, n, hkv, k)
        valid = torch.full((b_,), n, dtype=torch.int32, device=dev)
        views = [x.transpose(1, 2) for x in (q, kk, vv)]
        nbytes = 2 * (2 * b_ * n * hkv * k + 2 * b_ * m * k)
        return (lambda: ab.decode_attention(q, kk, vv, valid)), tsa.sfc_decode_attention.launches_by_splits, \
            (lambda key: tsa.sfc_decode_attention_plain(q, kk, vv, valid, k_chunk=build.DECODE_CHUNK, splits=key)), \
            4.0 * b_ * m * n * k, nbytes, \
            (lambda: F.scaled_dot_product_attention(*views, enable_gqa=True)), dt
    q, kk, vv, do = rnd(b_, m, h, k), rnd(b_, n, hkv, k), rnd(b_, n, hkv, k), rnd(b_, m, h, k)
    pairs = sum(min(i + 1, n) for i in range(m))  # causal (q, k) pairs of a head
    qc, kc = tsa.kernel_chunks()
    if op == "attn_fwd":
        views = [x.transpose(1, 2) for x in (q, kk, vv)]
        nbytes = 2 * (2 * b_ * m * h * k + 2 * b_ * n * hkv * k)
        return (lambda: ab.flash_attention(q, kk, vv, causal=True)), tsa.sfc_flash_fwd.launches_by_kernel, \
            (lambda key: tsa.sfc_flash_fwd_plain(q, kk, vv, causal=True, q_chunk=qc, k_chunk=kc,
                                                 p_dtype=torch.bfloat16)[0]), \
            4.0 * b_ * h * pairs * k, nbytes, \
            (lambda: F.scaled_dot_product_attention(*views, is_causal=True, enable_gqa=True)), dt
    o, lse = tsa.sfc_flash_fwd(q, kk, vv, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, kk, vv, do, lse, delta)
    dqc, dkc = build.ATTN_DKV_TILE["bf16"]

    def run():  # `_FlashCore.backward`'s launches: K13's C resolved under attn_bwd
        knobs = ab.resolve_attn_knobs(m, n, k, dt, op="attn_bwd", device=dev)
        return (tsa.sfc_flash_bwd_dq(*args, causal=True),
                *tsa.sfc_flash_bwd_dkv(*args, causal=True, cluster=(knobs.launch or {}).get("cluster")))

    def plain(key):
        return (tsa.sfc_flash_bwd_dq_plain(*args, causal=True, q_chunk=qc, k_chunk=kc),
                *tsa.sfc_flash_bwd_dkv_plain(*args, causal=True, q_chunk=dqc, k_chunk=dkc, group_parts=key[1]))

    # the library's backward alone: SDPA forward and backward less its forward
    views = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, kk, vv)]
    sdpa = lambda i: F.scaled_dot_product_attention(*views, is_causal=True, enable_gqa=True)  # noqa: E731
    run.library_ms = lambda: (time_ms(lambda i: torch.autograd.grad(sdpa(i), views, do.transpose(1, 2)), reps=20,
                                      graph=True) - time_ms(sdpa, reps=20, graph=True))
    nbytes = 2 * (3 * b_ * m * h * k + 4 * b_ * n * hkv * k) + 8 * b_ * m * h
    return run, tsa.sfc_flash_bwd_dkv.launches_by_kernel, plain, 10.0 * b_ * h * pairs * k, nbytes, None, dt


# the wrappers whose launches the tuned serve and steps count by shape
TUNED_WRAPPERS = ("sfc_gemm_fused", "sfc_gemm_nt", "sfc_gemm_tn", "sfc_flash_fwd", "sfc_flash_bwd_dkv",
                  "sfc_decode_attention")


def phase_tune(torch, np, cfg, build_model, ServingEngine, build_trainer, tk, tsa, ops):
    """Item 13 on the card: `repro_torch.tune.calibrate` (the fitted
    constants and their fit error), then `ServingEngine.warmup(PROMPT,
    tune=True, tune_update=True)` of full-width, full-depth qwen3-4b under
    sfc_cuda with attn_impl "sfc" (every namespace of its `tune_table`,
    keyed by the rows each launch runs: the projections' forward at BATCH x
    PROMPT rows, the LM head at BATCH and, for the step, at BATCH x PROMPT,
    their backward and fused-update buckets, and the three attention
    kernels), on a cache file of its own, so that no other phase sees a
    tuned entry.  For each namespace and bucket: the rule's launch and
    time, the winner's, the predicted-against-measured error of every
    candidate measured.  A second warmup measures nothing.  Then on the
    tuned cache the serve of BATCH x PROMPT + NEW_TOKENS against the same
    serve on an empty one (tokens bitwise where no winner orders a sum
    differently, else prefill and first-decode logits at accuracy parity
    with the torch backend against the f32 model), and one fused and one
    unfused training step of BATCH x PROMPT, the shape whose buckets the
    warmup tuned, each loss within 2^-7 of the same step's on the empty
    cache (the same init and batch).  Every tuned bucket must be resolved
    by that serve or those steps; every shape they launched in a tuned
    bucket is held, under the tuned cache, against its kernel's plain
    version over the split the launch's counter names, and timed.
    Returns (summary, kernel rows: one per tuned namespace and launched
    shape, its launches that shape's count)."""
    import tempfile

    from repro_torch.core import attention_backend as ab
    from repro_torch.core.device import sm_count
    from repro_torch.kernels import build
    from repro_torch.tune import KnobCache, calibrate, tuner, using_cache
    from repro_torch.tune.cache import shape_bucket

    wrappers = {"sfc_gemm_fused": tk.sfc_gemm_fused, "sfc_gemm_nt": tk.sfc_gemm_nt, "sfc_gemm_tn": tk.sfc_gemm_tn,
                "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_flash_bwd_dkv": tsa.sfc_flash_bwd_dkv,
                "sfc_decode_attention": tsa.sfc_decode_attention}

    def snapshot():
        return {name: collections.Counter(fn.launches_by_shape) for name, fn in wrappers.items()}

    def since(before):
        return {name: collections.Counter(fn.launches_by_shape) - before[name] for name, fn in wrappers.items()}

    t_start = time.perf_counter()
    dev, dt = torch.device("cuda"), torch.bfloat16
    sms = sm_count(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    tcache = KnobCache(str(Path(work) / "tuned.json"))
    empty = KnobCache(str(Path(work) / "empty.json"))
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    params = model.state_dict()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    acfg = dataclasses.replace(cfg, attn_impl="sfc")
    eng = ServingEngine(acfg, params, max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend="sfc_cuda",
                        device="cuda")
    heads = (BATCH, cfg.n_heads, cfg.kv_heads)
    with using_cache(empty):
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))  # first launches, allocator
        torch.cuda.synchronize()
        untuned = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
    with using_cache(tcache):
        t0 = time.perf_counter()
        constants = calibrate(device=dev)
        calibrate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = eng.warmup(PROMPT, tune=True, tune_update=True)
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = eng.warmup(PROMPT, tune=True, tune_update=True)
        warm_again_s = time.perf_counter() - t0
    if again["n_measured"] != 0:
        raise AssertionError(f"a second warmup on the tuned cache measured {again['n_measured']} candidates")
    table = eng.tune_table(PROMPT, backward=True, update=True)
    buckets = {(op, shape_bucket(m, n, k)) for op, m, n, k in table}
    namespaces, order_changed = [], []
    for op, m, n, k in table:
        bucket = "x".join(map(str, shape_bucket(m, n, k)))
        hd = heads if op.startswith("attn") else None
        entry = tcache.get(m, n, k, dt, "gpu", op)
        rule = tuner.rule_launch(op, m, n, k, dt, sms=sms, heads=hd)
        measured = [r for r in stats["report"] if r["op"] == op and r["bucket"] == bucket]
        rule_row = next((r for r in measured if r.get("rule")), None)
        winner = entry.launch or rule
        if entry.launch is not None and any(winner.get(key) != rule.get(key) for key in SUM_ORDER_KEYS):
            order_changed.append(f"{op}:{bucket}")
        # the entry's source reads back as "cached": a namespace with no
        # measurement cached its seed unmeasured ("analytical")
        namespaces.append({
            "op": op, "m": m, "n": n, "k": k, "bucket": bucket, "route": tuner.card_route(op, m, n, k, dt),
            "source": "measured" if measured else "analytical", "rule_launch": rule,
            "rule_ms": rule_row and rule_row["measured_s"] * 1e3, "winner_launch": winner,
            "winner_differs_from_rule": entry.launch is not None,
            "winner_ms": entry.time_s * 1e3 if measured else None,
            "candidates": [{"launch": r.get("launch"), "predicted_ms": r["predicted_s"] * 1e3,
                            "measured_ms": r["measured_s"] * 1e3,
                            "rel_err": abs(r["measured_s"] - r["predicted_s"]) / r["measured_s"]}
                           for r in measured]})

    # the serve on the tuned cache, its launches counted by shape
    before = snapshot()
    with using_cache(tcache):
        tuned = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    serve_deltas = since(before)
    tokens = {"untuned": np.array([r.output for r in untuned]), "tuned": np.array([r.output for r in tuned])}
    bitwise = bool((tokens["tuned"] == tokens["untuned"]).all())
    parity = None
    if order_changed:
        # the logits of the prefill and the first decode step, each variant
        # against the same model in f32 (torch backend)
        tok = torch.from_numpy(np.stack(prompts)).long().cuda()
        f32 = ServingEngine(dataclasses.replace(cfg, param_dtype="float32"), {k_: v.float() for k_, v in params.items()},
                            max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend="torch", device="cuda")
        ref_p, ref_cache = f32._prefill(tok)
        nxt = ref_p.argmax(-1)[:, None]
        ref_d, _ = f32._decode(nxt, ref_cache)
        del f32, ref_cache
        noise = {}
        for name, gemm, cache in (("sfc_cuda_tuned", "sfc_cuda", tcache), ("torch", "torch", empty)):
            e = ServingEngine(acfg if gemm == "sfc_cuda" else cfg, params, max_batch=BATCH,
                              max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")
            with using_cache(cache):
                lp, c_ = e._prefill(tok)
                ld, _ = e._decode(nxt, c_)
            noise[name] = float(((lp.float() - ref_p).abs().mean() + (ld.float() - ref_d).abs().mean()) / 2)
            del e, c_
        parity = {"mean_abs_err_vs_f32": noise,
                  "ok": noise["sfc_cuda_tuned"] <= ACCURACY_PARITY * noise["torch"]}
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # a fused and an unfused training step of BATCH x PROMPT, on the empty
    # and on the tuned cache, from the same init and batch
    steps, step_deltas = {}, collections.Counter()
    for fused in (True, False):
        for label, cache in (("untuned", empty), ("tuned", tcache)):
            with using_cache(cache):
                model, opt_state, step_fn, batch_fn = build_trainer(
                    cfg, batch=BATCH, seq=PROMPT, total_steps=TRAIN_STEPS, seed=0, gemm_backend="sfc_cuda",
                    attn_impl="sfc", fused_optimizer=fused, device="cuda")
                before = snapshot()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt_state, metrics = step_fn(opt_state, batch_fn(0))
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                steps[f"{'fused' if fused else 'unfused'}_{label}"] = {"loss": loss, "seconds": time.perf_counter() - t0}
                if label == "tuned":
                    for name, c in since(before).items():
                        step_deltas[name] = step_deltas.get(name, collections.Counter()) + c
            del model, opt_state, step_fn, batch_fn, metrics
            gc.collect()
            torch.cuda.empty_cache()
    losses_ok = {kind: math.isfinite(steps[f"{kind}_tuned"]["loss"])
                 and abs(steps[f"{kind}_tuned"]["loss"] - steps[f"{kind}_untuned"]["loss"])
                 <= TRAIN_LOSS_RTOL * abs(steps[f"{kind}_untuned"]["loss"]) for kind in ("fused", "unfused")}

    # every launched shape of a tuned bucket, held and timed under the tuned cache
    launched_shapes = tuned_shapes({name: serve_deltas[name] + step_deltas.get(name, collections.Counter())
                                    for name in wrappers})
    on_path = collections.Counter()
    rows, checks = [], []
    for (op, (m, n, k), hd), launches in sorted(launched_shapes.items(), key=str):
        bucket = shape_bucket(m, n, k)
        if (op, bucket) not in buckets:
            continue  # no entry: the rule, as in every earlier phase
        on_path[(op, bucket)] += launches
        run, counter, plain, flops, nbytes, lib, cmp_dt = tuned_case(torch, tk, tsa, ops, ab, build, op, m, n, k,
                                                                      hd or heads)
        with torch.no_grad(), using_cache(tcache):
            got, key = launched(counter, run)
            want, plain_ms = _once_ms(torch, lambda: plain(key))
            ok, err, worst = within_all(got, want, cmp_dt)
            timed = getattr(run, "timed", run)
            ms = time_ms(lambda i: timed(), reps=20, graph=True)
        with torch.no_grad():
            lib_ms = time_ms(lambda i: lib(), reps=20, graph=True) if lib is not None else None
        if hasattr(run, "library_ms"):
            lib_ms = run.library_ms()
        del got, want
        entry = tcache.get(m, n, k, dt, "gpu", op)
        name = f"{op}:{m}x{n}x{k}"
        checks.append({"case": name, "launch": entry.launch, "counter_key": str(key), "ok": ok,
                       "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"tuned {name} ({entry.launch}, {key}) disagrees with its plain version: max err "
                                 f"{err}, err/bound {worst}")
        bound_ms, bound_by = _bound(flops, nbytes)
        rows.append({"op": op, "shape": (m, n, k), "heads": hd, "bucket": "x".join(map(str, bucket)),
                     "key": key, "launch": entry.launch, "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        torch.cuda.empty_cache()
    off_path = sorted(f"{op}:{'x'.join(map(str, b))}" for op, b in buckets if not on_path[(op, b)])

    errs = [c["rel_err"] for ns_row in namespaces for c in ns_row["candidates"]]
    summary = {
        "phase": "tune", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype, "init_s": init_s,
        "calibration": {**constants.as_dict(), "seconds": calibrate_s},
        "warmup": {"n_namespaces": stats["n_namespaces"], "n_measured": stats["n_measured"],
                   "median_rel_err": stats["median_rel_err"], "seconds": warmup_s},
        "second_warmup": {"n_measured": again["n_measured"], "seconds": warm_again_s},
        "median_rel_err_all_candidates": float(np.median(errs)) if errs else None,
        "namespaces": namespaces, "winners_vs_plain": checks,
        "winners_that_order_sums_differently": order_changed,
        "serve": {"requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
                  "tokens_bitwise_untuned": bitwise, "parity": parity},
        "train_steps": {"batch": BATCH, "seq": PROMPT, **steps, "losses_within_2^-7": losses_ok},
        "tuned_buckets_launched": {f"{op}:{'x'.join(map(str, b))}": c for (op, b), c in sorted(on_path.items())},
        "tuned_buckets_never_launched": off_path,
        "seconds": time.perf_counter() - t_start,
    }
    emit(summary)
    for ns_row in namespaces:
        print(f"tune {ns_row['op']:>14} {ns_row['bucket']:>20} rule {ns_row['rule_launch']} "
              f"{ns_row['rule_ms']} ms -> winner {ns_row['winner_launch']} {ns_row['winner_ms']} ms "
              f"({ns_row['source']}); predicted/measured: "
              f"{[(round(c['predicted_ms'], 4), round(c['measured_ms'], 4)) for c in ns_row['candidates']]}",
              file=sys.stderr, flush=True)
    if off_path:
        raise AssertionError(f"tuned buckets that neither the tuned serve nor the tuned steps launched: {off_path}")
    if not order_changed and not bitwise:
        raise AssertionError("the tuned serve's tokens part from the untuned serve's, and no winner orders a sum "
                             "differently")
    if parity is not None and not parity["ok"]:
        raise AssertionError(f"the tuned serve's logits are further from the f32 model than torch's: {parity}")
    if not all(losses_ok.values()):
        raise AssertionError(f"a tuned step's loss is not within 2^-7 of the untuned step's: {steps}")
    kernel_rows = []
    for row in rows:
        # the launch's name as its wrapper counted it: (kernel, tile / L / W / C), or the decode's S
        kernel, config = row["key"] if isinstance(row["key"], tuple) else ("decode_split_kernel", row["key"])
        kernel_rows.append({
            "name": f"tuned:{row['op']}:{'x'.join(map(str, row['shape']))}",
            "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/sfc_attention.cu" if row["op"].startswith("attn")
                       else kernel_source(kernel)),
            "replaces": TUNE_REPLACES[row["op"]],
            "launches": row["launches"],
            "path": f"qwen3-4b's serve of {BATCH} x {PROMPT} + {NEW_TOKENS} and its fused and unfused steps of "
                    f"{BATCH} x {PROMPT} on the tuned cache",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": kernel,
            "config": config,
            "launch": row["launch"],
            "bucket": row["bucket"],
            "shape": dict(zip("mnk", row["shape"])),
        })
    return summary, kernel_rows


# ---------------------------------------------------------------------------
# the fallback ladder, fault injection, checkpoints and the train loop
# ---------------------------------------------------------------------------

# TrainLoop on qwen3-4b at full width cut to HEAL_TRAIN_LAYERS layers:
# HEAL_TRAIN_STEPS fused steps of TRAIN_BATCH x TRAIN_SEQ, a checkpoint
# every HEAL_CKPT_EVERY steps, a simulated preemption at HEAL_FAIL_AT
HEAL_TRAIN_LAYERS, HEAL_TRAIN_STEPS, HEAL_CKPT_EVERY, HEAL_FAIL_AT = 2, 6, 2, 4
# heal (d)'s gate, in units of the f32 bound (`within`): the redo runs all
# 36 layers on other rungs (sfc_reference, the attention oracle) in f32, so
# it carries one f32 rounding a layer where `within` allows one; measured
# 0.983 on an H100 80GB HBM3 at 700 W.  A redo in bf16 would read >= ~20
# (bf16 output rounding, 2^-9, over the bound's 1e-4).
HEAL_REDO_F32_MARGIN = 2.0
# host µs of a ladder call: calls a loop, loops (median)
LADDER_CALLS, LADDER_LOOPS = 500, 11


def assert_no_degradation(robust, after: str) -> dict:
    """Strict run: nothing fell back and nothing is quarantined."""
    rep = robust.degradation_report()
    if rep["fallback_calls"] or rep["quarantined"] or not rep["strict"]:
        raise AssertionError(f"after {after}: the fallback ladder degraded: {rep}")
    return {"total_calls": rep["total_calls"], "fallback_calls": 0, "quarantined": 0}


def ladder_summary(rep: dict) -> dict:
    """The ledger part of a degradation report a heal line shows."""
    quarantined = collections.Counter((r["namespace"], r["rung"], r["reason"], r["injected"])
                                      for r in rep["quarantined"])
    return {"total_calls": rep["total_calls"], "fallback_calls": rep["fallback_calls"], "served": rep["served"],
            "sdc": rep["sdc"],
            "quarantined": [{"namespace": ns, "rung": rung, "reason": why, "injected": inj, "shapes": n}
                            for (ns, rung, why, inj), n in sorted(quarantined.items())]}


def ladder_host_us(torch, np, gb, ops, robust):
    """Host µs of the GEMM ladder a call, where the device's time is
    negligible (`scripts/resolve_overhead_ab.py`'s shapes): a 4 x 64 @ 64 x
    64 product (decode's 2-D form) and a 4 x 8 x 64 batch over a shared
    weight, each as `ops.sfc_matmul` directly (the rung), through
    `run_with_fallback` with `gemm_backend.matmul`'s rung table (what
    ``matmul`` walks under sfc_cuda), and as `gemm_backend.matmul` itself;
    LADDER_LOOPS loops of LADDER_CALLS calls, each loop ending in one
    synchronisation, the three interleaved in alternating order, medians.
    Beside them the ladder alone: the same walk around a rung that does
    nothing, against that rung called directly (host only)."""
    from repro_torch.core.namespaces import NS_GEMM

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(bias=None, activation=None, out_scale=None, residual=None)

    def timed(fns):
        times = {k: [] for k in fns}
        for fn in fns.values():
            for _ in range(50):
                fn()
        torch.cuda.synchronize()
        for loop in range(LADDER_LOOPS):
            for key in (list(fns) if loop % 2 == 0 else list(fns)[::-1]):
                fn = fns[key]
                t0 = time.perf_counter()
                for _ in range(LADDER_CALLS):
                    fn()
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) / LADDER_CALLS * 1e6)
        return {k: float(np.median(v)) for k, v in times.items()}, times

    out = {}
    for name, shape in (("decode_4x64", (4, 64)), ("batched_4x8x64", (4, 8, 64))):
        a = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        def backend():
            with gb.gemm_backend("sfc_cuda"):
                return gb.matmul(a, w)

        med, each = timed({
            "direct": lambda: ops.sfc_matmul(a, w, **kw),
            "ladder": lambda: robust.run_with_fallback(NS_GEMM, gb._MATMUL_RUNGS, args=(a, w, kw),
                                                       shape_key=gb._rung_key),
            "gemm_backend_matmul": backend})
        out[name] = {"median_us": med, "each_us": each, "ladder_minus_direct_us": med["ladder"] - med["direct"],
                     "ladder_over_direct": med["ladder"] / med["direct"] - 1.0}

    def noop(x, w_, kw_):
        return x

    rungs = tuple((r, noop) for r in ("sfc_cuda", "replicated", "sfc_reference", "torch"))
    a = torch.randn(4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    med, _ = timed({"noop": lambda: noop(a, w, kw),
                    "ladder_around_noop": lambda: robust.run_with_fallback(NS_GEMM, rungs, args=(a, w, kw),
                                                                           shape_key=gb._rung_key)})
    out["ladder_alone_us"] = med["ladder_around_noop"] - med["noop"]
    return out


def phase_heal(torch, np, cfg, params, ServingEngine, tk, tsa, robust, gb, ops, abft, build_trainer,
               reset_counts, replicated_counts, done, want_rep, want_launches, ref, torch_noise):
    """The fallback ladder on the card, on phase 4's full-width qwen3-4b
    weights, the health registry reset before each part:

    (a) the sfc_cuda serve (blockwise attention) under a "compile" fault
        on the sfc_cuda rung of "gemm" and "glu": every projection heals to
        the replicated rung; launches and tokens are those of phase 4's
        "replicated" serve at k_layers 1 (K4 / K5, no K1/K2), the ledger
        shows the fallbacks and the injected quarantines;
    (b) every kernel rung of every namespace faulted (sfc_cuda,
        replicated, sfc_reference), attention "sfc": the serve lands on the
        torch rung with no SFC launch; its prefill logits at parity with
        the torch backend's (mean |error| from the f32 model at most
        ACCURACY_PARITY times torch's) and its tokens beside torch's;
    (c) under ABFT "detect", outside a step scope, a transient bitflip
        (fires once) on the last gemm call of the serve (a decode step's
        LM head, K1): the op is retried on the same rung, the ledger counts
        the detection and the heal, and tokens and launches are the clean
        serve's bitwise;
    (d) an injected detection in the step scope of the last decode step,
        the only verified one (verify_every = NEW_TOKENS - 1), on the
        weights in f32, attention "sfc": the engine quarantines the kernel
        rungs (every record marked injected) and redoes the step on
        sfc_reference (GEMMs) and the oracle (attention); the redone f32
        logits against the clean run's last step within
        HEAL_REDO_F32_MARGIN times the f32 bound (the bf16 bound's reading
        shown beside), one detection in the ledger;
    (e) `TrainLoop` on a HEAL_TRAIN_LAYERS-layer cut, fused optimizer,
        "sfc" attention: an uninterrupted run of HEAL_TRAIN_STEPS steps;
        a run checkpointing every HEAL_CKPT_EVERY steps preempted at
        HEAL_FAIL_AT (its losses bitwise the uninterrupted run's); a run
        from other weights resumed from that checkpoint under "detect"
        with an injected detection in its first step, which rolls back to
        HEAL_FAIL_AT and skips the data ahead; then a run from other
        weights resumed at HEAL_FAIL_AT to the end: losses and final
        weights bitwise the uninterrupted run's; seconds and GB of every
        save and restore;
    (f) the ladder's host µs a call (`ladder_host_us`)."""
    from repro_torch.robust import FaultSpec, fault_injection
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import CorruptionPolicy, TrainLoop, model_step

    reg = robust.get_registry()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    tokens_of = {name: [r.output for r in batch] for name, batch in done.items()}

    def engine(impl, weights=params, config=cfg, **kw):
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), weights, max_batch=BATCH,
                             max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend="sfc_cuda", device="cuda", **kw)

    def serve(eng):
        out = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        return [r.output for r in out]

    def sfc_launches():
        return {"K1/K2": tk.sfc_gemm_fused.launches, "K4/K5": tk.sfc_gemm_replicated.launches,
                "K6": tk.add_reduce.launches, "K11": tsa.sfc_flash_fwd.launches,
                "K14": tsa.sfc_decode_attention.launches}

    out = {"phase": "heal", "arch": cfg.name, "layers": cfg.n_layers, "requests": BATCH, "prompt": PROMPT,
           "new_tokens": NEW_TOKENS}
    t_phase = time.perf_counter()

    # (a) the sfc_cuda rung of gemm and glu refuses every shape
    reg.reset()
    eng = engine("blockwise")
    reset_counts()
    specs = [FaultSpec(ns, kind="compile", rungs=("sfc_cuda",)) for ns in ("gemm", "glu")]
    with fault_injection(*specs) as state:
        toks = serve(eng)
    rep = reg.degradation_report()
    calls = dict(state.calls)
    gemm_calls = calls["gemm"]
    launches = replicated_counts()
    by_kern = by_kernel(tk.sfc_gemm_replicated.launches_by_kernel)
    a_ok = (launches == want_rep and toks == tokens_of["replicated"]
            and by_kern == {REP_ROUTES[key]: want_rep[key] for key in ("K4", "K5")}
            and rep["fallback_calls"] == calls["gemm"] + calls["glu"]
            and all(r["injected"] and r["rung"] == "sfc_cuda" and r["reason"] == "compile"
                    for r in rep["quarantined"])
            and {r["namespace"] for r in rep["quarantined"]} == {"gemm", "glu"})
    out["a_compile_fault_heals_to_replicated"] = {
        "ok": a_ok, "launches": launches, "launches_expected": want_rep, "by_kernel": by_kern,
        "tokens_identical_to_replicated_serve": toks == tokens_of["replicated"], "ladder_calls": calls,
        "ledger": ladder_summary(rep)}
    if not a_ok:
        raise AssertionError(f"heal (a): {out['a_compile_fault_heals_to_replicated']}")
    del eng

    # (b) every kernel rung of every namespace refuses: the torch rung serves
    reg.reset()
    eng = engine("sfc")
    reset_counts()
    with fault_injection(FaultSpec("*", kind="compile", rungs=("sfc_cuda", "replicated", "sfc_reference"))) as state:
        toks = serve(eng)
        ptoks = torch.from_numpy(np.stack(prompts)).long().cuda()
        logits_b = eng._prefill(ptoks)[0].float()
    rep = reg.degradation_report()
    launches = sfc_launches()
    noise_b = float((logits_b - ref).abs().mean())
    match = float((np.array(toks) == np.array(tokens_of["torch"])).mean())
    b_ok = (not any(launches.values()) and rep["fallback_calls"] == rep["total_calls"] > 0
            and set(rep["served"]) == {"gemm", "glu", "attn_fwd", "attn_decode"}
            and all(set(r) == {"torch"} for r in rep["served"].values())
            and noise_b <= ACCURACY_PARITY * torch_noise)
    out["b_every_kernel_rung_faulted_serves_on_torch"] = {
        "ok": b_ok, "sfc_launches": launches, "ladder_calls": dict(state.calls),
        "prefill_logits_bf16_mean_abs_err_vs_f32": noise_b, "torch_backend_mean_abs_err_vs_f32": torch_noise,
        "parity_ok": noise_b <= ACCURACY_PARITY * torch_noise, "greedy_token_match_vs_torch": match,
        "ledger": ladder_summary(rep)}
    if not b_ok:
        raise AssertionError(f"heal (b): {out['b_every_kernel_rung_faulted_serves_on_torch']}")
    del eng, logits_b

    # (c) a transient flip on one decode K1 launch, detected eagerly and retried
    reg.reset()
    abft.reset_runtime_sdc()
    eng = engine("blockwise")
    reset_counts()
    target = gemm_calls - 1  # the LM head of the last decode step
    with abft.abft_mode("detect"), fault_injection(
            FaultSpec("gemm", kind="bitflip", calls=(target,), fires=1, rungs=("sfc_cuda",))) as state:
        toks = serve(eng)
    rep = reg.degradation_report()
    c_ok = (state.fired == [("gemm", "sfc_cuda", target, "bitflip")] and toks == tokens_of["sfc_cuda"]
            and rep["sdc"] == {"gemm": {"detected": 1, "healed": 1}} and not rep["quarantined"]
            and not rep["fallback_calls"] and tk.sfc_gemm_fused.launches == want_launches)
    out["c_transient_bitflip_retried_on_the_same_rung"] = {
        "ok": c_ok, "fired": state.fired, "call": target, "tokens_identical_to_clean": toks == tokens_of["sfc_cuda"],
        "k1_k2_launches": tk.sfc_gemm_fused.launches, "launches_expected": want_launches,
        "abft_checks": abft.runtime_check_total(), "ledger": ladder_summary(rep)}
    if not c_ok:
        raise AssertionError(f"heal (c): {out['c_transient_bitflip_retried_on_the_same_rung']}")
    del eng

    # (d) a detection in the last (verified) decode step: quarantine and redo, in f32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    last = {}

    def capture(eng, key):
        real = eng._decode

        def decode(token, cache):
            logits, cache = real(token, cache)
            last[key] = logits.clone()
            return logits, cache

        eng._decode = decode

    runs = {}
    for key, specs in (("clean", ()), ("detected", None)):
        reg.reset()
        abft.reset_runtime_sdc()
        eng = engine("sfc", params32, cfg32, verify_every=NEW_TOKENS - 1)
        capture(eng, key)
        if specs is None:  # the last gemm call of the serve: inside the verified step's scope
            specs = (FaultSpec("gemm", kind="bitflip", calls=(runs["clean"]["calls"]["gemm"] - 1,), fires=1,
                               rungs=("sfc_cuda",)),)
        reset_counts()
        t0 = time.perf_counter()
        with fault_injection(*specs) as state:
            toks = serve(eng)
        runs[key] = {"calls": dict(state.calls), "fired": state.fired, "tokens": toks,
                     "s": time.perf_counter() - t0, "report": eng.degradation_report(),
                     "launches": sfc_launches()}
        del eng
    del params32
    torch.cuda.empty_cache()
    rep = runs["detected"]["report"]
    ok16, err16, worst16 = within(last["detected"], last["clean"], torch.bfloat16)
    ok32, err32, worst32 = within(last["detected"], last["clean"], torch.float32)
    served = rep["served"]
    d_ok = (worst32 <= HEAL_REDO_F32_MARGIN and last["detected"].dtype == torch.float32
            and rep["verify"]["sdc_detections"] == 1 and rep["verify"]["verified_steps"] == 1
            and runs["clean"]["report"]["verify"]["sdc_detections"] == 0
            and served.get("gemm", {}).get("sfc_reference", 0) > 0 and served.get("glu", {}).get("sfc_reference", 0) > 0
            and served.get("attn_decode", {}).get("torch", 0) > 0 and all(r["injected"] for r in rep["quarantined"])
            and {(r["namespace"], r["rung"]) for r in rep["quarantined"]} == {
                (ns, rung) for ns in ("gemm", "glu", "grouped", "grouped_glu", "attn_fwd", "attn_decode")
                for rung in ("sfc_cuda", "replicated")})
    out["d_verified_step_redone_on_healed_rungs"] = {
        "ok": d_ok, "dtype": "float32", "verify_every": NEW_TOKENS - 1, "fired": runs["detected"]["fired"],
        "verify": rep["verify"], "redone_logits_vs_clean": {
            "f32_bound": {"ok": ok32, "max_abs_err": err32, "err_over_bound": worst32,
                          "gate": HEAL_REDO_F32_MARGIN},
            "bf16_bound": {"ok": ok16, "max_abs_err": err16, "err_over_bound": worst16}},
        "quarantines_injected": all(r["injected"] for r in rep["quarantined"]),
        "greedy_token_match_vs_clean": float((np.array(runs["detected"]["tokens"])
                                              == np.array(runs["clean"]["tokens"])).mean()),
        "serve_s": {k: v["s"] for k, v in runs.items()}, "launches": {k: v["launches"] for k, v in runs.items()},
        "ledger": ladder_summary(rep)}
    if not d_ok:
        raise AssertionError(f"heal (d): {out['d_verified_step_redone_on_healed_rungs']}")

    # (e) the fault-tolerant train loop, with checkpoints
    reg.reset()
    abft.reset_runtime_sdc()
    cut = dataclasses.replace(cfg, n_layers=HEAL_TRAIN_LAYERS)
    io = []  # (kind, step, seconds, GB)
    real_host, real_write, real_restore = ckpt_mod._host_leaves, ckpt_mod._save_host, ckpt_mod.restore

    def host_leaves(tree):
        t0 = time.perf_counter()
        leaves = real_host(tree)
        io.append(("save_host_copy", None, time.perf_counter() - t0, sum(a.nbytes for _, a, _ in leaves) / 1e9))
        return leaves

    def save_host(ckpt_dir, step, leaves, extra):
        t0 = time.perf_counter()
        path = real_write(ckpt_dir, step, leaves, extra)
        io.append(("save_hash_and_write", step, time.perf_counter() - t0, sum(a.nbytes for _, a, _ in leaves) / 1e9))
        return path

    def restore(ckpt_dir, step=None, *, target=None):
        t0 = time.perf_counter()
        tree, manifest = real_restore(ckpt_dir, step, target=target)
        torch.cuda.synchronize()
        gb_ = sum(int(np.prod(leaf["shape"])) * (2 if leaf["dtype"] == "bfloat16" else 4)
                  for leaf in manifest["leaves"]) / 1e9
        io.append(("restore", manifest["step"], time.perf_counter() - t0, gb_))
        return tree, manifest

    ckpt_mod._host_leaves, ckpt_mod._save_host, ckpt_mod.restore = host_leaves, save_host, restore
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    try:
        def trainer(seed, abft_mode=None):
            model, opt_state, step_fn, batch_fn = build_trainer(
                cut, batch=TRAIN_BATCH, seq=TRAIN_SEQ, total_steps=HEAL_TRAIN_STEPS, seed=seed,
                gemm_backend="sfc_cuda", attn_impl="sfc", fused_optimizer=True, abft=abft_mode, device="cuda")
            return model, opt_state, model_step(step_fn), batch_fn

        def losses_of(events):
            return {e["step"]: e["loss"] for e in events}

        def final_digest(model):
            return sum(digest(torch, p) for p in model.parameters()) & 0xFFFFFFFFFFFFFFFF

        # the uninterrupted run (no checkpoints)
        model, opt_state, step, data_fn = trainer(0)
        ev_u = []
        TrainLoop(step, data_fn, None, on_metrics=ev_u.append).run(
            dict(model.named_parameters()), opt_state, num_steps=HEAL_TRAIN_STEPS, resume=False, log_every=0)
        want, want_digest = losses_of(ev_u), final_digest(model)
        del model, opt_state, step
        gc.collect()
        torch.cuda.empty_cache()
        # checkpoints every HEAL_CKPT_EVERY steps, preempted at HEAL_FAIL_AT
        ckdir = str(Path(tmp.name) / "run")
        model, opt_state, step, _ = trainer(0)
        ev_p = []
        t0 = time.perf_counter()
        try:
            TrainLoop(step, data_fn, CheckpointManager(ckdir, interval=HEAL_CKPT_EVERY, keep=2),
                      on_metrics=ev_p.append).run(dict(model.named_parameters()), opt_state,
                                                  num_steps=HEAL_TRAIN_STEPS, resume=False, fail_at=HEAL_FAIL_AT,
                                                  log_every=0)
            raise AssertionError("the simulated preemption did not happen")
        except KeyboardInterrupt:
            pass
        preempt_s = time.perf_counter() - t0
        committed = ckpt_mod.latest_step(ckdir)
        del model, opt_state, step
        gc.collect()
        torch.cuda.empty_cache()
        # other weights, resumed under "detect": a detection in the first step rolls
        # back; preempted after the step that follows (no save: the resume below
        # is from HEAL_FAIL_AT again)
        model, opt_state, step, _ = trainer(1, abft_mode="detect")
        ev_s, logs = [], []
        with fault_injection(FaultSpec("*", kind="bitflip", calls=(0,), fires=1, rungs=("sfc_cuda",))) as state:
            try:
                TrainLoop(step, data_fn, CheckpointManager(ckdir, interval=HEAL_CKPT_EVERY, keep=2),
                          corruption_policy=CorruptionPolicy(rollback_on_sdc=True), on_metrics=ev_s.append).run(
                    dict(model.named_parameters()), opt_state, num_steps=HEAL_TRAIN_STEPS, resume=True,
                    fail_at=HEAL_FAIL_AT + 1, log_every=0, logger=logs.append)
                raise AssertionError("the SDC run was not preempted")
            except KeyboardInterrupt:
                pass
        sdc_fired = state.fired
        del model, opt_state, step
        gc.collect()
        torch.cuda.empty_cache()
        # other weights again, resumed at HEAL_FAIL_AT to the end
        model, opt_state, step, _ = trainer(2)
        ev_r, logs_r = [], []
        TrainLoop(step, data_fn, CheckpointManager(ckdir, interval=HEAL_CKPT_EVERY, keep=2),
                  on_metrics=ev_r.append).run(dict(model.named_parameters()), opt_state,
                                              num_steps=HEAL_TRAIN_STEPS, resume=True, log_every=0,
                                              logger=logs_r.append)
        got, got_digest = losses_of(ev_r), final_digest(model)
        del model, opt_state, step
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ckpt_mod._host_leaves, ckpt_mod._save_host, ckpt_mod.restore = real_host, real_write, real_restore
        tmp.cleanup()
    pre = losses_of(ev_p)
    rollback = [line for line in logs if "rolled back" in line]
    e_ok = (committed == HEAL_FAIL_AT and all(pre[k] == want[k] for k in pre) and len(pre) == HEAL_FAIL_AT
            and logs_r[:1] == [f"[ft] resumed from checkpoint at step {HEAL_FAIL_AT}"]
            and got == {k: v for k, v in want.items() if k > HEAL_FAIL_AT} and got_digest == want_digest
            and len(sdc_fired) == 1 and rollback == [
                f"[ft] SDC detected in step (1 checksum mismatches): rolled back {HEAL_FAIL_AT + 1} -> {HEAL_FAIL_AT}, "
                "data stream skipped ahead by 1"]
            and [e["step"] for e in ev_s] == [HEAL_FAIL_AT + 1] and ev_s[0]["sdc_delta"] == 0
            and all(math.isfinite(v) for v in want.values()))
    out["e_train_loop"] = {
        "ok": e_ok, "layers": HEAL_TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": HEAL_TRAIN_STEPS,
        "ckpt_every": HEAL_CKPT_EVERY, "fail_at": HEAL_FAIL_AT, "committed_at_preemption": committed,
        "losses_uninterrupted": want, "losses_before_preemption": pre, "losses_resumed": got,
        "resumed_bitwise": got == {k: v for k, v in want.items() if k > HEAL_FAIL_AT} and got_digest == want_digest,
        "sdc_run": {"fired": sdc_fired, "log": logs, "steps": [e["step"] for e in ev_s]},
        "preempted_run_s": preempt_s,
        "io": [{"kind": k, "step": s_, "s": t, "gb": g} for k, s_, t, g in io]}
    if not e_ok:
        raise AssertionError(f"heal (e): {out['e_train_loop']}")

    # (f) the ladder's host cost a call
    reg.reset()
    out["f_ladder_host_us"] = ladder_host_us(torch, np, gb, ops, robust)
    reg.reset()
    abft.reset_runtime_sdc()
    out["s"] = time.perf_counter() - t_phase
    out["ok"] = True
    return out


def small_reference_check(torch, get_config, build_model, gemm_backend):
    """Reduced qwen3-4b in f32 on the card: sfc_cuda logits against the
    Listing-1 reference backend at rtol 1e-4 (prefill and 3 decode steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3_4b").reduced()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda")
    outs = {}
    for backend in ("sfc_cuda", "sfc_reference"):
        with gemm_backend(backend):
            logits, cache = model.prefill(prompt, cache_len=16)
            seq = [logits]
            tok = prompt[:, -1:]
            for _ in range(3):
                logits, cache = model.decode_step(tok, cache)
                seq.append(logits)
        outs[backend] = torch.stack(seq)
    ok, err, worst = within(outs["sfc_cuda"], outs["sfc_reference"], torch.float32)
    if not ok:
        raise AssertionError(f"reduced model: sfc_cuda vs sfc_reference max err {err}")
    return {"ok": ok, "max_abs_err": err, "err_over_bound": worst}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    # the whole run is strict: a fallback that was not injected raises, so a
    # kernel that fails to build or launch fails the run
    os.environ["REPRO_STRICT"] = "1"

    # every phase resolves its launches on an empty tune cache (the kernels'
    # rules); the tune phase brings caches of its own
    tune_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_knobs_")
    os.environ["REPRO_TORCH_SFC_TUNE_CACHE"] = str(Path(tune_dir.name) / "knobs.json")

    from repro_torch.configs import get_config
    from repro_torch.core.attention_backend import attention_backend
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch import robust
    from repro_torch.core import gemm_backend as gb
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk
    from repro_torch.launch.train import build_trainer, make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as opt
    from repro_torch.robust import abft
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.train.step import BackendConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    # --heal-only: phases 1 and 4 and the heal phase, no result line (a quick check of the heal phase)
    heal_only = sys.argv[1:] == ["--heal-only"]
    strict = {}  # after each phase: the ladder served every call on its first rung

    def no_degradation(after: str) -> None:
        strict[after] = assert_no_degradation(robust, after)

    # ---- 1. device ---------------------------------------------------------
    run_t0 = time.perf_counter()
    phase_at = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_all()  # nvcc at first use, every part of both libraries at once
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_and_load_s": build_s})

    # ---- 2. kernels against their plain versions ---------------------------
    cfg = get_config("qwen3_4b")
    if not heal_only:
        phase_at[2] = time.perf_counter() - run_t0
        gemms = main_path_gemms(cfg)
        rows, checks = phase_kernels(torch, cfg, gemms, tk, ops)
        rep_rows, rep_checks = phase_replicated(torch, cfg, replicated_gemms(cfg), tk, ops)
        phase_at["2, after the replicated form's rows"] = time.perf_counter() - run_t0
        attn_rows, attn_checks = phase_attention(torch, attention_cases(cfg), tsa, tfa, build)
        bwd_rows, bwd_checks = phase_backward_gemms(torch, train_backward_gemms(cfg), tk, ops)
        upd_rows, upd_checks = phase_update_gemms(torch, cfg, tk, opt)
        attn_bwd_rows, attn_bwd_checks = phase_attention_bwd(torch, attention_bwd_cases(cfg), tsa, build)
        # the hybrid and xLSTM slices: K2 at the chunk-einsum shapes (its
        # f32-output mode with the lanes, the mLSTM output product in f32) and
        # K1/K2 at zamba2's shared-block shapes; the encoder-decoder slice:
        # K1/K2 at seamless's shapes (the gelu MLP), K11 non-causal and K14
        # over its memory
        zcfg, xcfg, scfg = get_config(HYBRID_ARCH), get_config(XLSTM_ARCH), get_config(ENCDEC_ARCH)
        chunk_rows, chunk_checks, chunk_lane_rows, chunk_lane_checks = phase_chunk_gemms(
            torch, chunk_gemms(zcfg, xcfg), tk, abft)
        hyb_rows, hyb_checks = phase_kernels(torch, zcfg, hybrid_projection_gemms(zcfg), tk, ops, ragged=False)
        encdec_rows, encdec_checks = phase_kernels(torch, scfg, encdec_gemms(scfg), tk, ops, ragged=False)
        encdec_attn_rows, encdec_attn_checks = phase_attention(torch, encdec_attention_cases(scfg), tsa, tfa, build)
        # the last configs: K1/K2 at qwen2-72b's serve shapes (the VLM's tree;
        # its LM head weight 2.49 GB) and stablelm-1.6b's, K3 at qwen3-moe's 128
        # experts, K11 / K14 with their heads (group 8 of D 128, MHA of D 64);
        # each row's operands built alone and freed before the next
        phase_at["2, the last configs' rows"] = time.perf_counter() - run_t0
        vcfg, mcfg, lcfg = get_config(VLM_ARCH), get_config(MOE128_ARCH), get_config(STABLELM_ARCH)
        vlm_rows, vlm_checks = phase_kernels(torch, vcfg, serve_gemms(vcfg, "qwen2-72b"), tk, ops, ragged=False)
        torch.cuda.empty_cache()
        lm_rows, lm_checks = phase_kernels(torch, lcfg, serve_gemms(lcfg, "stablelm"), tk, ops, ragged=False)
        moe128_rows, moe128_checks = phase_grouped_gemms(torch, moe128_grouped_gemms(mcfg), tk, ragged=False)
        last_attn_rows, last_attn_checks = phase_attention(
            torch, last_attention_cases(vcfg, "qwen2-72b") + last_attention_cases(lcfg, "stablelm"), tsa, tfa, build)
        torch.cuda.empty_cache()
        ocfg = get_config(MOE_ARCH)
        grouped_rows, grouped_checks = phase_grouped_gemms(torch, moe_grouped_gemms(ocfg), tk)
        grouped_upd_rows, grouped_upd_checks = phase_grouped_update_gemms(torch, ocfg, tk, opt)
        # the training shapes of the families that only served until now: K7 /
        # K8 at their widths, K8's update at qwen2-vl-72b's GLU, K11-K13 at
        # seamless's D 64 (and a check at S != T), zamba2's and the VLM's heads,
        # K2 at the chunk products and their per-batch backward
        phase_at["2, the families' training shapes"] = time.perf_counter() - run_t0
        fam_bwd_rows, fam_bwd_checks = phase_backward_gemms(torch, family_bwd_gemms(scfg, zcfg, vcfg), tk, ops)
        torch.cuda.empty_cache()
        fam_upd_rows, fam_upd_checks = phase_update_gemms(torch, vcfg, tk, opt, gemms=family_update_gemms(vcfg),
                                                          dtypes=(torch.bfloat16,))
        torch.cuda.empty_cache()
        fam_attn_rows, fam_attn_checks = phase_attention(torch, family_attention_cases(scfg, zcfg, vcfg), tsa, tfa, build)
        fam_attn_bwd_rows, fam_attn_bwd_checks = phase_attention_bwd(torch, family_attention_bwd_cases(scfg, zcfg, vcfg),
                                                                     tsa, build)
        fam_chunk_rows, fam_chunk_checks, _, _ = phase_chunk_gemms(torch, family_chunk_gemms(zcfg, xcfg), tk, abft,
                                                                   lanes=False)
        torch.cuda.empty_cache()
        phase_at["2, the ABFT lanes"] = time.perf_counter() - run_t0
        lane_rows, lane_checks, lane_controls = phase_abft_lanes(torch, cfg, ocfg, tk, ops, abft, opt)
        small = small_reference_check(torch, get_config, build_model, gemm_backend)
        emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": {
            "float32": f"|k-p| <= {F32_RTOL}|p| + {F32_ATOL_REL} max|p|",
            "bfloat16": f"|k-p| <= 2^-7 |p| + {BF16_ATOL_REL} max|p|",
            "lse": "float32 tolerance"},
            "tn_update": "master, mu, nu and the norms at the float32 tolerance; a bf16 W bitwise the stochastic "
                         "rounding of the kernel's master with the plain version's bits and within the bfloat16 "
                         "tolerance of the plain W",
            "checks": checks + rep_checks + attn_checks + bwd_checks + upd_checks + attn_bwd_checks + grouped_checks
                      + grouped_upd_checks + chunk_checks + hyb_checks + encdec_checks + encdec_attn_checks
                      + vlm_checks + lm_checks + moe128_checks + last_attn_checks + fam_bwd_checks + fam_upd_checks
                      + fam_attn_checks + fam_attn_bwd_checks + fam_chunk_checks,
            "reduced_model_f32_vs_reference": small})
        emit({"phase": "abft_lanes", "ok": True,
              "tolerance": f"|lane - plain lane| <= min({LANE_RTOL} * sum |{LANE_TILE}x{LANE_TILE} raw tile sums|, "
                           "robust.abft.tolerance(mag, depth)), and each lane-side control (a lane of 0, the plain lane "
                           "less its last tile, the ragged case's sum after the epilogue) beyond it; "
                           "|lane - operand reference| <= robust.abft.tolerance(mag, depth); "
                           "the outputs with the lane on bitwise those with it off",
              "max_lane_vs_plain_over_limit": max(c["lane_vs_plain_over_limit"] for c in lane_checks + chunk_lane_checks),
              "min_lane_side_control_over_limit": min(r for c in lane_checks + chunk_lane_checks
                                                      for r in c.get("lane_side_controls_over_limit", {}).values()),
              "max_lane_vs_ref_over_tol": max(c["lane_vs_ref_over_tol"] for c in lane_checks + chunk_lane_checks),
              "checks": lane_checks + chunk_lane_checks, "negative_controls": lane_controls,
              # K2's lane at the chunk-einsum shapes (the f32-output mode's
              # twins and the SSD output's): ms with the lane on and off, the
              # operand-side reference's, the bound with the partials
              "chunk_einsum_lane_times": [
                  {"case": row["gemm"].name, "kernel": row["cuda_kernel"], "config": row["config"], "ms": row["ms"],
                   "lane_off_ms": row["lane_off_ms"], "operand_ref_ms": row["operand_ref_ms"],
                   "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                   "partials": row["partials"], "lane_vs_plain_abs": row["max_abs_err"]} for row in chunk_lane_rows]})
        torch.cuda.empty_cache()

        # ---- 3. gradients of a 4-layer full-width model in f32 -----------------
        no_degradation("before phase 3")
        phase_at[3] = time.perf_counter() - run_t0
        data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=1))
        gc_batch = {key: torch.from_numpy(val).cuda() for key, val in data.batch(0).items()}
        emit({"phase": "grad_check", "ok": True,
              **phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, gc_batch)})
        torch.cuda.empty_cache()
        fc_batches = [{key: torch.from_numpy(val).cuda() for key, val in data.batch(i).items()} for i in range(3)]
        emit({"phase": "fused_step_check", "ok": True,
              **phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, fc_batches)})
        gc.collect()
        emit({"phase": "fused_step_check_abft", "ok": True,
              **phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, fc_batches,
                                       abft="detect")})
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 4. serve full-width qwen3-4b --------------------------------------
    no_degradation("before phase 4")
    phase_at[4] = time.perf_counter() - run_t0
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    # (gemm backend, attn_impl) of each served configuration
    variants = {"sfc_cuda": ("sfc_cuda", "blockwise"), "sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"),
                "torch": ("torch", "blockwise"), "sfc_cuda+flash_attn": ("sfc_cuda", "flash_pallas"),
                "replicated": ("replicated", "blockwise")}
    served = ("sfc_cuda", "sfc_cuda+sfc_attn", "replicated", "torch")

    def engine(name, config):
        gemm, impl = variants[name]
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), params_of[config.param_dtype],
                             max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")

    params_of = {cfg.param_dtype: params}
    engines = {name: engine(name, cfg) for name in served}
    for eng in engines.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()

    per_step = cfg.n_layers * 6 + 1  # q, k, v, o, GLU, w_out per layer, plus the head
    want_launches = per_step * NEW_TOKENS  # one prefill and 15 decode steps
    want_attn = {"sfc_flash_fwd": cfg.n_layers, "sfc_decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    attn_kernels = {"sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_decode_attention": tsa.sfc_decode_attention,
                    "flash_attention": tfa.flash_attention}
    # K11 and K15 by kernel: every bf16 launch (the serve's prefill) on the
    # wgmma kernel, every f32 one (the f32 prefills) on the tile kernel
    fwd_kernels = {"sfc_flash_fwd": tsa.sfc_flash_fwd, "flash_attention": tfa.flash_attention}
    want_fwd_by_kernel = {"sfc_flash_fwd": {"flash_fwd_wgmma_kernel": cfg.n_layers}}

    # K1/K2 by kernel: the prefill's 6 a layer (4 x 128 rows) on the wgmma
    # kernel, the rest (4 rows: the decode steps, the prefill's head) on the
    # cluster kernel, none on the tile kernel
    want_by_kernel = {"sfc_gemm_wgmma_kernel": cfg.n_layers * 6,
                      "sfc_gemm_cluster_kernel": want_launches - cfg.n_layers * 6}

    def reset_counts():
        for fn in (tk.sfc_gemm_fused, tk.sfc_gemm_replicated, tk.add_reduce):
            fn.launches = 0
            fn.launches_by_shape.clear()
            fn.launches_by_kernel.clear()
        tsa.sfc_decode_attention.launches_by_splits.clear()
        for fn in attn_kernels.values():
            fn.launches = 0
        for fn in fwd_kernels.values():
            fn.launches_by_kernel.clear()

    def replicated_counts():
        by_shape = tk.sfc_gemm_replicated.launches_by_shape
        return {"K5": sum(c for key, c in by_shape.items() if key[0]), "K4": sum(c for key, c in by_shape.items()
                                                                            if not key[0]),
                "K6": tk.add_reduce.launches, "K1/K2": tk.sfc_gemm_fused.launches}

    # the blockwise path: every projection on the GEMM kernel
    reset_counts()
    done = {"sfc_cuda": engines["sfc_cuda"].run(engines["sfc_cuda"].submit_many(prompts, max_new_tokens=NEW_TOKENS))}
    torch.cuda.synchronize()
    launches = tk.sfc_gemm_fused.launches
    by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    serve_by_kernel = {"sfc_cuda": by_kernel(tk.sfc_gemm_fused.launches_by_kernel)}
    if launches != want_launches or serve_by_kernel["sfc_cuda"] != want_by_kernel:
        raise AssertionError(f"sfc_cuda serve launched the kernel {launches} times, expected {want_launches}; "
                             f"by kernel {serve_by_kernel['sfc_cuda']}, expected {want_by_kernel}")
    # the attn_impl="sfc" path: projections on the GEMM, attention on K11 / K14
    reset_counts()
    eng = engines["sfc_cuda+sfc_attn"]
    done["sfc_cuda+sfc_attn"] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    attn_launches = {name: fn.launches for name, fn in attn_kernels.items()}
    fwd_by_kernel = {"sfc_flash_fwd": by_kernel(tsa.sfc_flash_fwd.launches_by_kernel)}
    attn_gemm_launches = tk.sfc_gemm_fused.launches
    attn_by_kernel = {"sfc_gemm_fused": {f"{name}@{config}": n for (name, config), n in
                                         tk.sfc_gemm_fused.launches_by_kernel.items()},
                      "sfc_decode_attention": {f"S{k}": n for k, n in
                                               tsa.sfc_decode_attention.launches_by_splits.items()},
                      "sfc_flash_fwd": {f"{name}@W{w}": n for (name, w), n in
                                        tsa.sfc_flash_fwd.launches_by_kernel.items()}}
    serve_by_kernel["sfc_cuda+sfc_attn"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    if (attn_gemm_launches != want_launches or any(attn_launches[k] != n for k, n in want_attn.items())
            or serve_by_kernel["sfc_cuda+sfc_attn"] != want_by_kernel
            or fwd_by_kernel["sfc_flash_fwd"] != want_fwd_by_kernel["sfc_flash_fwd"]):
        raise AssertionError(f"attn_impl='sfc' serve launched GEMM {attn_gemm_launches} (want {want_launches}; "
                             f"by kernel {serve_by_kernel['sfc_cuda+sfc_attn']}, want {want_by_kernel}) "
                             f"and attention {attn_launches} (want {want_attn}; K11 by kernel {fwd_by_kernel}) "
                             "times")
    # the replicated form: every projection a K5 (prefill) or K4 (decode)
    # launch, the GLU two; k_layers resolves to 1 at every shape, so no K6
    # and no K1/K2.  Then the same serve with every product split over
    # REP_SERVE_LAYERS K layers: as many K4/K5 launches, one K6 after each.
    per_layer = 7  # q, k, v, o, the GLU's two products, w_out
    want_rep = {"K5": cfg.n_layers * per_layer, "K4": cfg.n_layers * per_layer * (NEW_TOKENS - 1) + NEW_TOKENS,
                "K6": 0, "K1/K2": 0}
    want_split = dict(want_rep, K6=want_rep["K5"] + want_rep["K4"])
    # every K4 launch (4 rows) on the cluster kernel, every K5 on the wgmma kernel
    want_rep_by_kernel = {REP_ROUTES[key]: want_rep[key] for key in ("K4", "K5")}
    eng = engines["replicated"]
    rep_counts, rep_by_shape, rep_by_kernel = {}, {}, {}
    for name, layers, want in (("replicated", None, want_rep), (f"replicated@k{REP_SERVE_LAYERS}", REP_SERVE_LAYERS,
                                                                  want_split)):
        with ops.knob_defaults(k_layers=layers):
            eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))  # warm-up: this split's task tables
            torch.cuda.synchronize()
            reset_counts()
            done[name] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        rep_counts[name] = replicated_counts()
        rep_by_shape[name] = (dict(tk.sfc_gemm_replicated.launches_by_shape), dict(tk.add_reduce.launches_by_shape))
        rep_by_kernel[name] = {f"{kernel}@{config}": n for (kernel, config), n in
                               tk.sfc_gemm_replicated.launches_by_kernel.items()}
        if rep_counts[name] != want or by_kernel(tk.sfc_gemm_replicated.launches_by_kernel) != want_rep_by_kernel:
            raise AssertionError(f"{name} serve launched {rep_counts[name]} ({rep_by_kernel[name]}), expected {want} "
                                 f"({want_rep_by_kernel})")
    # the attn_impl="sfc" serve again under ABFT "detect": the prefill in
    # abft_mode (eager checks), every decode step verified in a step scope
    # (verify_every=1); a warm-up engine, then a fresh one (its ledger at 0)
    for prompts_, new in ((prompts[:1], 2), (prompts, NEW_TOKENS)):
        abft_eng = ServingEngine(dataclasses.replace(cfg, attn_impl="sfc"), params, max_batch=BATCH,
                                 max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend="sfc_cuda", device="cuda",
                                 verify_every=1)
        torch.cuda.synchronize()
        reset_counts()
        tk.sfc_gemm_fused.abft_launches = 0
        abft.reset_runtime_sdc()
        with abft.abft_mode("detect"):
            done_abft = abft_eng.run(abft_eng.submit_many(prompts_, max_new_tokens=new))
        torch.cuda.synchronize()
    abft_by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    serve_by_kernel["sfc_cuda+sfc_attn+abft"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    abft_serve = {
        "verify": abft_eng.degradation_report()["verify"], "sdc_detections": abft.runtime_sdc_total(),
        "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio(),
        "launches": {"sfc_gemm_fused": tk.sfc_gemm_fused.launches, "with_lane": tk.sfc_gemm_fused.abft_launches,
                     **{k: attn_kernels[k].launches for k in want_attn}},
        "tokens_identical_to_off": [r.output for r in done_abft] == [r.output for r in done["sfc_cuda+sfc_attn"]],
        "latency": abft_eng.latency_report(done_abft),
    }
    del abft_eng
    # one serve step (the prefill and one decode step) on "replicated" split
    # over REP_SERVE_LAYERS K layers under "detect": the op-level checks of
    # K4 / K5 + K6 (eager; a detection raises)
    eng = engines["replicated"]
    reset_counts()
    abft.reset_runtime_sdc()
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS), abft.abft_mode("detect"):
        rep_abft = eng.run(eng.submit_many(prompts, max_new_tokens=2))
    torch.cuda.synchronize()
    abft_serve[f"replicated@k{REP_SERVE_LAYERS}_one_decode_step"] = {
        "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio(),
        "launches": replicated_counts(),
        "tokens_identical_to_off": [r.output for r in rep_abft] == [r.output[:2] for r in
                                                                      done[f"replicated@k{REP_SERVE_LAYERS}"]]}
    done["torch"] = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=NEW_TOKENS))
    reports = {name: engines[name.split("@")[0]].latency_report(batch) for name, batch in done.items()}
    for batch in done.values():
        for r in batch:
            if (r.status != "completed" or len(r.output) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab for t in r.output)):
                raise AssertionError(f"request {r.uid} ended {r.status} with {len(r.output or [])} tokens")
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}

    # prefill logits against the torch backend.  In bf16 both backends sit
    # about 3% of a logit's spread away from the f32 model after 36 layers
    # (rounding noise that no bf16 implementation avoids), so the bf16
    # bound is asserted where only the implementations differ: the same
    # weights in f32 on every variant.  The bf16 logits must be no further
    # from that f32 reference than the torch backend's are.
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    split = f"replicated@k{REP_SERVE_LAYERS}"
    decode_profile = {name: profile_decode(torch, engines[name.split("@")[0]], tokens, ops, layers)
                      for name, layers in (("sfc_cuda", None), ("replicated", None), (split, REP_SERVE_LAYERS),
                                           ("torch", None))}
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS):
        logits[split] = engines["replicated"]._prefill(tokens)[0].float()
    del engines, eng
    # the attn_impl="flash_pallas" prefill: its attention on K15
    reset_counts()
    logits["sfc_cuda+flash_attn"] = engine("sfc_cuda+flash_attn", cfg)._prefill(tokens)[0].float()
    torch.cuda.synchronize()
    attn_launches["flash_attention"] = tfa.flash_attention.launches
    fwd_by_kernel["flash_attention"] = by_kernel(tfa.flash_attention.launches_by_kernel)
    want_fwd_by_kernel["flash_attention"] = {"flash_fwd_wgmma_kernel": cfg.n_layers}
    if attn_launches["flash_attention"] != cfg.n_layers or fwd_by_kernel["flash_attention"] != want_fwd_by_kernel[
            "flash_attention"]:
        raise AssertionError(f"flash_pallas prefill launched K15 {attn_launches['flash_attention']} times "
                             f"({fwd_by_kernel['flash_attention']}), expected {cfg.n_layers} on the wgmma kernel")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params_of["float32"] = {k: v.float() for k, v in params.items()}
    reset_counts()
    for name in ("torch", "sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn", "replicated"):
        logits[name + "_f32"] = engine(name, cfg32)._prefill(tokens)[0]
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS):
        logits[split + "_f32"] = engine("replicated", cfg32)._prefill(tokens)[0]
    del params_of["float32"]
    torch.cuda.synchronize()
    for name, fn in fwd_kernels.items():
        fwd_by_kernel[f"{name}_f32"] = by_kernel(fn.launches_by_kernel)
        want_fwd_by_kernel[f"{name}_f32"] = {"flash_fwd_kernel": cfg.n_layers}
    if fwd_by_kernel != want_fwd_by_kernel:
        raise AssertionError(f"K11 / K15 launched {fwd_by_kernel} by kernel, expected {want_fwd_by_kernel}")
    sfc_variants = ("sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn", "replicated", split)
    for name in sfc_variants:
        if tuple(logits[name].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"{name} prefill logits shape {tuple(logits[name].shape)} or non-finite values")
    ref = logits["torch_f32"]
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits[name + "_f32"], ref, torch.bfloat16))) for name in sfc_variants}
    ok16, err16, worst16 = within(logits["sfc_cuda"], logits["torch"], torch.bfloat16)
    noise = {b: float((logits[b] - ref).abs().mean()) for b in (*sfc_variants, "torch")}
    parity = {name: noise[name] <= ACCURACY_PARITY * noise["torch"] for name in sfc_variants}
    argmax = {b: float((logits[b].argmax(-1) == ref.argmax(-1)).float().mean()) for b in (*sfc_variants, "torch")}
    serve = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "launches": launches, "launches_expected": want_launches,
        "attn_impl_sfc_launches": {"sfc_gemm_fused": attn_gemm_launches, **{k: attn_launches[k] for k in want_attn}},
        "attn_impl_sfc_launches_by_kernel": attn_by_kernel,
        "sfc_gemm_fused_launches_by_kernel": serve_by_kernel, "by_kernel_expected": want_by_kernel,
        "flash_pallas_prefill_launches": attn_launches["flash_attention"],
        "flash_fwd_launches_by_kernel": fwd_by_kernel, "flash_fwd_by_kernel_expected": want_fwd_by_kernel,
        "replicated_launches": rep_counts, "replicated_launches_expected": {"replicated": want_rep,
                                                                           split: want_split},
        "replicated_launches_by_kernel": rep_by_kernel,
        "prefill_logits": {
            "f32_vs_torch": f32_agree,
            "bf16_sfc_cuda_vs_torch": {"within_bound": ok16, "max_abs_err": err16, "err_over_bound": worst16,
                                       "mean_abs_err": float((logits["sfc_cuda"] - logits["torch"]).abs().mean())},
            "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity,
            "argmax_match_vs_f32": argmax, "max_abs_logit": float(ref.abs().max()),
        },
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in sfc_variants},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean())
                               for name in ("sfc_cuda", "sfc_cuda+sfc_attn", "replicated", split)},
        "greedy_token_match_sfc_attn_vs_sfc_cuda":
            float((tokens_of["sfc_cuda+sfc_attn"] == tokens_of["sfc_cuda"]).mean()),
        "latency": reports,
        "decode_step_profile": decode_profile,
        "abft_detect": abft_serve,
    }
    emit(serve)
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"f32 prefill logits {name} vs torch: max err {res['max_abs_err']}, "
                                 f"err/bound {res['err_over_bound']}")
    # the split serve's bf16 copies are rounded once per K layer before the
    # sum (the JAX package's replicated result): its parity is reported,
    # not held; its f32 logits are held above like every variant's
    if not all(ok for name, ok in parity.items() if name != split):
        raise AssertionError(f"bf16 logits further from the f32 model than torch's: {noise}")
    rep_step = abft_serve[f"replicated@k{REP_SERVE_LAYERS}_one_decode_step"]
    if (abft_serve["sdc_detections"] or abft_serve["checks"] != want_launches or not abft_serve["tokens_identical_to_off"]
            or abft_serve["launches"] != {"sfc_gemm_fused": want_launches, "with_lane": want_launches, **want_attn}
            or abft_serve["verify"] != {"verify_every": 1, "decode_steps": NEW_TOKENS - 1,
                                        "verified_steps": NEW_TOKENS - 1, "sdc_detections": 0}
            or serve_by_kernel["sfc_cuda+sfc_attn+abft"] != want_by_kernel
            or not abft_serve["max_residual_over_tol"] < 1 or not rep_step["tokens_identical_to_off"]
            or not rep_step["max_residual_over_tol"] < 1 or not rep_step["checks"]):
        raise AssertionError(f"the serve under ABFT detect: {abft_serve}")
    # ---- 4b. heal: the fallback ladder, fault injection, the train loop ------
    no_degradation("before phase 4b")
    phase_at["4b, heal"] = time.perf_counter() - run_t0
    emit(phase_heal(torch, np, cfg, params, ServingEngine, tk, tsa, robust, gb, ops, abft, build_trainer,
                    reset_counts, replicated_counts, done, want_rep, want_launches, ref, noise["torch"]))
    if heal_only:
        return 0
    # the serve's model and every tensor of it leave the card before training
    del model, params, params_of, logits, ref
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. train full-width qwen3-4b --------------------------------------
    no_degradation("before phase 5")
    phase_at[5] = time.perf_counter() - run_t0
    counted = {"sfc_gemm_fused": tk.sfc_gemm_fused, "sfc_gemm_nt": tk.sfc_gemm_nt, "sfc_gemm_tn": tk.sfc_gemm_tn,
               "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_flash_bwd_dq": tsa.sfc_flash_bwd_dq,
               "sfc_flash_bwd_dkv": tsa.sfc_flash_bwd_dkv}
    _, counts_by_run, train_runs, train_digests = phase_train(torch, cfg, build_trainer, counted)
    train_counts, fused_counts = counts_by_run["sfc_cuda+sfc_attn"], counts_by_run["sfc_cuda+sfc_attn+fused_optimizer"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. olmoe-1b-7b: f32 gradients of a 2-layer full-width cut ---------
    no_degradation("before phase 6")
    phase_at[6] = time.perf_counter() - run_t0
    odata = SyntheticLM(SyntheticLMConfig(vocab=ocfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=1))
    ogc_batch = {key: torch.from_numpy(val).cuda() for key, val in odata.batch(0).items()}
    emit({"phase": "grad_check_moe", "ok": True,
          **phase_grad_check(torch, ocfg, build_model, gemm_backend, attention_backend, ogc_batch,
                             layers=MOE_CHECK_LAYERS)})
    gc.collect()
    torch.cuda.empty_cache()
    ofc_batches = [{key: torch.from_numpy(val).cuda() for key, val in odata.batch(i).items()} for i in range(3)]
    emit({"phase": "fused_step_check_moe", "ok": True,
          **phase_fused_step_check(torch, ocfg, build_model, tk, make_train_step, BackendConfig, opt, ofc_batches,
                                   layers=MOE_CHECK_LAYERS)})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. serve full-width, full-depth olmoe-1b-7b ------------------------
    no_degradation("before phase 7")
    phase_at[7] = time.perf_counter() - run_t0
    _, moe_serve_counts, moe_abft_counts = phase_moe_serve(torch, np, ocfg, build_model, ServingEngine, tk, tsa)

    # ---- 8. train olmoe-1b-7b at full width, 8 layers ----------------------
    no_degradation("before phase 8")
    phase_at[8] = time.perf_counter() - run_t0
    moe_counted = {**counted, "sfc_gemm_grouped": tk.sfc_gemm_grouped, "sfc_gemm_grouped_nt": tk.sfc_gemm_grouped_nt,
                   "sfc_gemm_grouped_tn": tk.sfc_gemm_grouped_tn}
    _, moe_train_counts, moe_train_runs, moe_train_digests = phase_moe_train(torch, ocfg, build_trainer, moe_counted)
    moe_fused_counts = moe_train_counts["sfc_cuda+sfc_attn+fused_optimizer"]["sfc_gemm_grouped_tn"]

    # ---- 9. serve full-width, full-depth zamba2-1.2b -----------------------
    no_degradation("before phase 9")
    phase_at[9] = time.perf_counter() - run_t0
    hybrid_serve, hybrid_by_shape = phase_hybrid_serve(torch, np, zcfg, build_model, ServingEngine, tk, tsa, ops)

    # ---- 10. serve full-width, full-depth xlstm-1.3b ----------------------
    no_degradation("before phase 10")
    phase_at[10] = time.perf_counter() - run_t0
    xlstm_serve, xlstm_by_shape = phase_xlstm_serve(torch, np, xcfg, build_model, ServingEngine, tk, ops,
                                                    gemm_backend)

    # ---- 11. seamless-m4t-medium at full width and depth --------------------
    no_degradation("before phase 11")
    phase_at[11] = time.perf_counter() - run_t0
    _, encdec_by_shape, encdec_counts = phase_encdec(torch, np, scfg, build_model, tk, tsa, gemm_backend,
                                                     attention_backend)

    # ---- 12. qwen2-vl-72b and qwen2-72b, full width, 16 of 80 layers -------
    no_degradation("before phase 12")
    phase_at[12] = time.perf_counter() - run_t0
    _, vlm_by_shape, vlm_counts = phase_vlm_serve(torch, np, vcfg, get_config(DENSE72_ARCH), build_model,
                                                  ServingEngine, tk, tsa, ops, gemm_backend)

    # ---- 13. qwen3-moe-30b-a3b at full width and depth -----------------------
    no_degradation("before phase 13")
    phase_at[13] = time.perf_counter() - run_t0
    _, moe128_by_shape, moe128_counts = phase_moe128_serve(torch, np, mcfg, build_model, ServingEngine, tk, tsa, ops)

    # ---- 14. stablelm-1.6b at full width and depth --------------------------
    no_degradation("before phase 14")
    phase_at[14] = time.perf_counter() - run_t0
    _, lm_by_shape, lm_counts = phase_stablelm_serve(torch, np, lcfg, build_model, ServingEngine, tk, tsa, ops)

    # ---- 15. remat: qwen3-4b at full depth, olmoe-1b-7b at 8 layers ----------
    no_degradation("before phase 15")
    phase_at[15] = time.perf_counter() - run_t0
    gc.collect()
    torch.cuda.empty_cache()
    phase_remat(torch, cfg, ocfg, build_trainer, build_model, make_batch_fn, gemm_backend, attention_backend,
                counted, moe_counted,
                {name: (train_runs[name], counts_by_run.get(name, {}), train_digests[name])
                 for name in train_digests},
                {name: (moe_train_runs[name], moe_train_counts[name], moe_train_digests[name])
                 for name in moe_train_digests})

    # ---- 16-19. train the families that only served (the VLM cut first) -----
    fam_shapes = {}
    for number, (label, fcfg, check_cut) in enumerate((
            # the VLM first: its 2-layer cut holds 68 GB, the most of the four
            ("qwen2-vl-72b", dataclasses.replace(vcfg, n_layers=VLM_TRAIN_LAYERS),
             {"n_layers": VLM_TRAIN_CHECK_LAYERS}),
            ("seamless", scfg, {"n_layers": scfg.n_layers}),
            ("zamba2", zcfg, {"n_layers": zcfg.n_layers}),
            ("xlstm", xcfg, {"n_layers": XLSTM_CHECK_LAYERS})), start=16):
        no_degradation(f"before phase {number}")
        phase_at[number] = time.perf_counter() - run_t0
        _, fam_shapes[label] = phase_family_train(torch, fcfg, build_trainer, build_model, make_batch_fn,
                                                  gemm_backend, attention_backend, counted, label, check_cut)

    # ---- 21. the tuner: calibrate, tune qwen3-4b's warmup, serve and step ----
    no_degradation("before phase 21")
    phase_at[21] = time.perf_counter() - run_t0
    gc.collect()
    torch.cuda.empty_cache()
    _, tune_rows = phase_tune(torch, np, cfg, build_model, ServingEngine, build_trainer, tk, tsa, ops)

    # ---- 20. the kernels line -----------------------------------------------
    no_degradation("before phase 20")
    phase_at[20] = time.perf_counter() - run_t0
    kernels = []
    for row in rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": (train_counts["sfc_gemm_fused"] if gm.path == "train" else by_shape).get(gm.key, 0),
            "path": gm.path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            # the CUDA kernel the wrapper launched at this shape, and its
            # configuration: the cluster kernel's K layers, the wgmma kernel's C tile
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu, "preact": gm.preact},
        })
    # the replicated form: launches of each kernel in its serve (K4/K5 in
    # the k_layers-1 serve, K6 in the split one), and at the row's shape in
    # the serve whose split it has
    rep_serves = {1: "replicated", REP_SERVE_LAYERS: split}
    for row in rep_rows:
        gm = row["gemm"]
        k6 = row["kernel"] == "K6"
        serve_name = split if k6 else "replicated"
        at_shape = rep_by_shape[rep_serves[gm.layers]][int(k6)] if gm.layers in rep_serves else {}
        kernels.append({
            "name": f"{'add_reduce' if k6 else 'sfc_gemm_replicated'}:{gm.name}@L{gm.layers}",
            "route": "cuda",
            "source": GEMM_SOURCE if k6 else kernel_source(row["cuda_kernel"]),
            "replaces": ("src/repro/kernels/sfc_gemm.py:2040" if k6 else
                         "src/repro/kernels/sfc_gemm.py:772" if gm.batch else "src/repro/kernels/sfc_gemm.py:656"),
            "launches": rep_counts[serve_name][row["kernel"] if k6 else gm.kernel],
            "launches_at_shape": at_shape.get(gm.reduce_key if k6 else gm.key, 0),
            "path": f"serve {serve_name}",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": ("copies.sum(-3)" if k6 else row.get("library_note") or (
                None if row["library_ms"] is None else
                "torch.bmm over the K slabs, f32 out" if gm.glu else "torch.matmul over the K slabs")),
            # K6: the launch configuration (threads a CTA, V vectors a
            # thread, CTAs a batch element), and the three-call yardstick
            **({"kernel": "add_reduce_kernel", "config": row["config"],
                "library_3_calls_ms": row["library_3_calls_ms"]} if k6 else {
                "kernel": row["cuda_kernel"], "config": row["config"], "unfused_call_ms": row["together_ms"],
                "fused_k1_k2_ms": row["fused_ms"], "torch_matmul_ms": row["matmul_ms"]}),
            "shape": gm.shape(),
        })
    for row in bwd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_{gm.kind}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1219" if gm.kind == "nt" else "src/repro/kernels/sfc_gemm.py:1429",
            "launches": train_counts[f"sfc_gemm_{gm.kind}"].get(gm.key, 0),
            "path": "train",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual},
        })
    for row in upd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_tn_{gm.mode}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1094",
            "launches": fused_counts["sfc_gemm_tn"].get(gm.key, 0),
            "path": "train, fused optimizer",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.mm to an f32 dW + torch._fused_adamw_ (two calls)" if gm.mode == "update" else None,
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual, "dtype": "bfloat16",
                      "stochastic_round": gm.mode == "update"},
        })
    # the checksum lanes: launches in the run of their path under ABFT
    # "detect" (the qwen3-4b serve with verify_every=1, its unfused and
    # fused training runs, the olmoe serve), at the row's shape
    abft_train, abft_fused = counts_by_run["sfc_cuda+sfc_attn+abft"], counts_by_run[
        "sfc_cuda+sfc_attn+fused_optimizer+abft"]
    lanes = {"K1/K2": ("sfc_gemm_fused_abft_kernel", "src/repro/kernels/sfc_gemm.py:246"),
             "K3": ("sfc_gemm_grouped_abft_kernel", "src/repro/kernels/sfc_gemm.py:1003"),
             "K8 dW": ("tn_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388"),
             "K8 update": ("tn_update_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388"),
             "K8 norm": ("tn_update_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388")}
    for row in lane_rows:
        gm, lane = row["gemm"], row["kernel"]
        if lane == "K1/K2":
            path = "train, abft detect" if gm.path == "train" else "serve, abft detect, verify_every=1"
            count = (abft_train["sfc_gemm_fused"] if gm.path == "train" else abft_by_shape).get(gm.key, 0)
        elif lane == "K3":
            path, count = "olmoe serve, abft detect, verify_every=1", moe_abft_counts.get(gm.key, 0)
        elif lane == "K8 dW":
            path, count = "train, abft detect", abft_train["sfc_gemm_tn"].get(gm.key, 0)
        else:
            path, count = "train, fused optimizer, abft detect", abft_fused["sfc_gemm_tn"].get(gm.key, 0)
        kernels.append({
            "name": f"{row.get('cuda_kernel', lanes[lane][0])}:{lane}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row.get("cuda_kernel", "")),
            "replaces": lanes[lane][1],
            "launches": count,
            "path": path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "lane_off_ms": row["lane_off_ms"],
            "operand_ref_ms": row["operand_ref_ms"],
            "partials": row["partials"],
            **({"config": row["config"]} if "config" in row else {}),
            "shape": dataclasses.asdict(gm),
        })
    replaces = {"sfc_flash_fwd": "src/repro/kernels/sfc_attention.py:204",
                "flash_attention": "src/repro/kernels/flash_attention.py:107",
                "sfc_decode_attention": "src/repro/kernels/sfc_attention.py:660",
                "sfc_flash_bwd_dq": "src/repro/kernels/sfc_attention.py:428",
                "sfc_flash_bwd_dkv": "src/repro/kernels/sfc_attention.py:509"}
    for row in attn_bwd_rows:
        c = row["case"]
        count = train_counts["totals"][row["kernel"]]
        kernels.append({
            "name": f"{row['kernel']}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[row["kernel"]],
            "kernel": row["cuda_kernel"],
            "config": row["config"],
            "launches": count,
            "launches_at_shape": count if c.main_path else 0,
            "path": "train",
            "main_path": c.main_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "scaled_dot_product_attention backward (dQ, dK, dV together)",
            "shape": c.shape(),
        })
    for row in attn_rows:
        c = row["case"]
        # every launch of a path's run is at its main-path shape; a check row
        # at another shape carries its kernel's count from that run
        count = train_counts["totals"][c.kernel] if c.path == "train" else attn_launches[c.kernel]
        kernels.append({
            "name": f"{c.kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[c.kernel],
            "launches": count,
            "launches_at_shape": count if c.main_path else 0,
            "path": c.path,
            "main_path": c.main_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **({"kernel": "decode_split_kernel", "splits": row["splits"]} if c.decode else
               {"kernel": row["kernel"], "config": row["config"]}),
            "shape": c.shape(),
        })
    for row in grouped_rows:
        gm = row["gemm"]
        counts = moe_serve_counts if gm.path == "serve" else moe_train_counts["sfc_cuda+sfc_attn"][gm.kernel]
        kernels.append({
            "name": f"{gm.kernel}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": gm.replaces,
            "launches": counts.get(gm.key, 0),
            "path": f"olmoe {gm.path}",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.bmm over the (E, rows, .) views (dual forms on concatenated operands)",
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": gm.shape(),
        })
    for row in grouped_upd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_grouped_tn_{gm.mode}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1859",
            "launches": moe_fused_counts.get(gm.key, 0),
            "path": "olmoe train, fused optimizer",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.bmm per set to an f32 dW stack + torch._fused_adamw_" if gm.mode == "update" else None,
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"experts": gm.experts, "rows_per_expert": gm.rows, "k": gm.k, "n": gm.n, "dual": gm.glu,
                      "dtype": "bfloat16", "stochastic_round": gm.mode == "update"},
        })
    # the hybrid and xLSTM slices: K2 at the chunk-einsum shapes (launches
    # at the row's shape in the run of its serve; a check row carries its
    # CUDA kernel's launches in the 4 x 128 sfc_cuda zamba2 serve) and
    # K1/K2 at the shared block's shapes (the 4 x 128 sfc_cuda serve)
    long_ = f"1x{HYBRID_LONG_PROMPT}"
    chunk_runs = {"zamba2 serve": hybrid_by_shape["sfc_cuda"],
                  f"zamba2 serve {long_}": hybrid_by_shape[f"sfc_cuda+sfc_attn@{long_}"],
                  "xlstm serve": xlstm_by_shape["sfc_cuda"], f"xlstm serve {long_}": xlstm_by_shape[f"sfc_cuda@{long_}"]}
    for row in chunk_rows:
        gm = row["gemm"]
        at_shape = chunk_runs[gm.path].get(gm.key, 0) if gm.path else 0
        kernels.append({
            "name": f"sfc_gemm_fused:chunk_einsum:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": at_shape if gm.path else hybrid_serve["launches"]["sfc_cuda"]["by_kernel"].get(
                row["kernel"], 0),
            "launches_at_shape": at_shape,
            "path": gm.path or "check (zamba2 serve, sfc_cuda)",
            "main_path": gm.path is not None,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": f"torch.{'bmm' if gm.batch else 'mm'}(a, b{', out_dtype=torch.float32' if gm.f32_out else ''})",
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "per_batch_b": bool(gm.batch),
                      "in": "float32" if gm.f32_in else "bfloat16",
                      "out": "float32" if gm.f32_out or gm.f32_in else "bfloat16", "unaligned": gm.unaligned},
        })
    for row in hyb_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": hybrid_by_shape["sfc_cuda"].get(gm.key, 0),
            "path": "zamba2 serve",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu, "preact": gm.preact},
        })
    # the encoder-decoder slice: K1/K2 at seamless's shapes (launches at the
    # row's shape in its sfc_cuda + "sfc" run: the prefill, which encodes,
    # and the decode steps) and K11 / K14 (the kernel's launches in that run)
    for row in encdec_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": encdec_by_shape.get(gm.key, 0),
            "path": "seamless encode, prefill and decode, sfc_cuda + sfc",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "activation": gm.act},
        })
    encdec_attn = {"sfc_flash_fwd": encdec_counts["K11"], "sfc_decode_attention": encdec_counts["K14"]}
    for row in encdec_attn_rows:
        c = row["case"]
        kernels.append({
            "name": f"{c.kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[c.kernel],
            "launches": encdec_attn[c.kernel],
            "path": "seamless encode, prefill and decode, sfc_cuda + sfc",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **({"kernel": "decode_split_kernel", "splits": row["splits"]} if c.decode else
               {"kernel": row["kernel"], "config": row["config"]}),
            "shape": c.shape(),
        })
    # the last configs: K1/K2 and K3 launches at the row's shape, K11 / K14
    # launches, in the sfc_cuda + "sfc" serve of the row's model
    last_runs = {"qwen2-72b": ("qwen2-vl-72b serve (16 of 80 layers), sfc_cuda + sfc", vlm_by_shape, vlm_counts),
                 "stablelm": ("stablelm-1.6b serve, sfc_cuda + sfc", lm_by_shape, lm_counts),
                 "qwen3-moe": ("qwen3-moe-30b-a3b serve, sfc_cuda + sfc", moe128_by_shape, moe128_counts)}
    for row in vlm_rows + lm_rows:
        gm = row["gemm"]
        path, at_shape, _ = last_runs[gm.name.split("/")[0]]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": at_shape["K1/K2"].get(gm.key, 0),
            "path": path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu},
        })
    for row in moe128_rows:
        gm = row["gemm"]
        path, at_shape, _ = last_runs["qwen3-moe"]
        kernels.append({
            "name": f"{gm.kernel}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": gm.replaces,
            "launches": at_shape["K3"].get(gm.key, 0),
            "path": path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.bmm over the (E, rows, .) views (the GLU on concatenated weights)",
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": gm.shape(),
        })
    for row in last_attn_rows:
        c = row["case"]
        path, _, run_counts = last_runs[c.path]
        kernels.append({
            "name": f"{c.kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[c.kernel],
            "launches": run_counts["K14" if c.decode else "K11"],
            "path": path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **({"kernel": "decode_split_kernel", "splits": row["splits"]} if c.decode else
               {"kernel": row["kernel"], "config": row["config"]}),
            "shape": c.shape(),
        })
    # the families' training shapes: launches at the row's shape in the
    # family's sfc_cuda + "sfc" run (K8's modes: its fused run); an
    # attention row's ``launches`` is its kernel's in that run, which the
    # family's main-path rows split by shape (seamless: its decoder's causal
    # self-attention, and its encoder's and cross-attention's non-causal
    # calls at one shape)
    for row in fam_bwd_rows:
        gm = row["gemm"]
        family = gm.name.split("/")[0]
        kernels.append({
            "name": f"sfc_gemm_{gm.kind}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1219" if gm.kind == "nt" else "src/repro/kernels/sfc_gemm.py:1429",
            "launches": fam_shapes[family]["sfc_cuda+sfc_attn"][f"sfc_gemm_{gm.kind}"].get(gm.key, 0),
            "path": f"{family} train",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual},
        })
    for row in fam_upd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_tn_{gm.mode}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1094",
            "launches": fam_shapes["qwen2-vl-72b"]["fused"]["sfc_gemm_tn"].get(gm.key, 0),
            "path": f"qwen2-vl-72b train ({VLM_TRAIN_LAYERS} layers), fused optimizer",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.mm to an f32 dW + torch._fused_adamw_ (two calls)" if gm.mode == "update" else None,
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual, "dtype": "bfloat16",
                      "stochastic_round": gm.mode == "update"},
        })
    split = collections.Counter()
    for row in fam_attn_rows + fam_attn_bwd_rows:
        c = row["case"]
        kernel = row.get("kernel") if "cuda_kernel" in row else c.kernel
        family = c.name.split("/")[0]
        run = fam_shapes[family]["sfc_cuda+sfc_attn"]
        at_shape = run[kernel].get(c.key, 0)
        if c.main_path:
            split[family, kernel] += at_shape
        kernels.append({
            "name": f"{kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[kernel],
            "launches": run["totals"][kernel],
            "launches_at_shape": at_shape,
            "path": f"{family} train",
            "main_path": c.main_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": ("scaled_dot_product_attention backward (dQ, dK, dV together)" if "cuda_kernel" in row
                        else "scaled_dot_product_attention"),
            "kernel": row.get("cuda_kernel", row["kernel"]),
            "config": row["config"],
            "shape": c.shape(),
        })
    unsplit = {f"{family}:{kernel}": (n, fam_shapes[family]["sfc_cuda+sfc_attn"]["totals"][kernel])
               for (family, kernel), n in split.items()
               if n != fam_shapes[family]["sfc_cuda+sfc_attn"]["totals"][kernel]}
    if unsplit:
        raise AssertionError(f"the families' attention launches at their rows' shapes do not sum to the run's: "
                             f"{unsplit}")
    for row in fam_chunk_rows:
        gm = row["gemm"]
        family = gm.name.split("/")[0]
        count = fam_shapes[family]["sfc_cuda+sfc_attn"]["sfc_gemm_fused"].get(gm.key, 0)
        kernels.append({
            "name": f"sfc_gemm_fused:chunk_einsum:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491",
            "launches": count,
            "launches_at_shape": count,
            "path": gm.path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": f"torch.bmm(a, b{', out_dtype=torch.float32' if gm.f32_out else ''})",
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "per_batch_b": True,
                      "in": "float32" if gm.f32_in else "bfloat16",
                      "out": "float32" if gm.f32_out or gm.f32_in else "bfloat16"},
        })
    kernels += tune_rows
    missing = [k["name"] for k in kernels if k["launches"] == 0 and k.get("main_path", True)]
    if missing:
        raise AssertionError(f"main-path kernels never launched in the run of their path: {missing}")
    # seconds since phase 1 began at the start of each later phase, and
    # the whole run's (the build included)
    no_degradation("the end")
    emit({"phase": "clock", "phase_start_s": phase_at, "build_and_load_s": build_s,
          "total_s": time.perf_counter() - run_t0, "strict": strict})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
