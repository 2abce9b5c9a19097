#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DPBalance on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the device: name, compute capability (must be 9.0), power limit;
  2. build the Hopper kernels from src/repro_torch/kernels/csrc;
  3. every kernel against its plain PyTorch twin on the card, at the
     paper's shapes, the large round's shapes, one ragged shape and, for
     rowmax, matvec and matvec_t, the production shape M=1024, K=131072
     (bitwise for rowmax, the boost sweeps and dual_step's g given x;
     1e-5 relative otherwise; matvec also bitwise from launch to launch),
     with CUDA-event times beside the twin's, a one-call PyTorch
     yardstick where one exists, and the bound; rowmax's and matvec's
     cluster size and block count per launch, and the boost sweeps'
     cluster size, tile and block count; the sweeps alone at the large
     round's M, N, K with C=8 (the swap beam's few candidates) and at a
     K whose leftover stays in device memory; the launch floor (an empty
     kernel launched back to back) beside the card's name and power limit;
     dual_step's ascent mode (the whole SP1 loop in one launch) at the
     paper, large and ragged shapes against the per-iteration loop over
     its step mode (iteration counts equal, lam bitwise), and its time
     per iteration beside that loop's and the launch floor; the lockstep
     fleet's batched forms of matvec, matvec_t and dual_step's ascent
     (FLEET_KERNEL_SHAPES: E episodes stacked on a leading axis, one
     launch) against their twins and against E lone launches (matvec and
     matvec_t bitwise; the ascent's lam bitwise and counts equal, with
     episodes stopping at different iterations), timed beside those E
     lone launches and torch.bmm (a yardstick only), with the ascent's
     cluster waves (E over the clusters the card holds at once);
  4. the paper episode (SimConfig(seed=0): 6 analysts x 25 pipelines,
     100 devices, K=2000, 10 rounds) through run_episode on the card, cold
     and warm SP1, every kernel's launch count above 0, and agreement with
     the same episode on the CPU; each round's SP1 exactly one dual_step
     launch with no host sync inside it (torch.cuda sync debug mode
     "error"), its iteration count and lam equal to the per-iteration
     loop's on the same operands (of the solves that run to the cap, the
     first);
  5. one round at the largest sched_scale geometry (M=32, N=32, K=16384,
     refine on), with its invariants, a swap sweep of C=256 candidates
     per analyst, SP1 as in phase 4 (one launch, the loop's count and
     lam), and repro's n_allocated, selected pairs and efficiency for the
     same round (REPRO_LARGE);
  6. where the time goes: SP1 and SP2 spans per round and, from
     torch.profiler, the card's kernel time and busy share, and the boost
     sweep kernel's time and share of it (separate traced runs, after the
     untimed checks); SP2's card time in the M=32 round by stage;
  7. the DP clip kernels (rownorms, clip_accumulate) against their twins
     on the card at the FL path's shapes (B=6 and B=8 rows of P =
     124,668,672 flaas-100m parameters), a ragged P and B=1, with a zero
     row: clip_accumulate bitwise given the same scales, rownorms within
     1e-5 relative, both bitwise from launch to launch; times beside the
     twin's, the bound and a one-call PyTorch yardstick;
  8. one DP-FedAvg round (sigma 0) of flaas-100m at full width, depth cut
     to 2 layers, client batches of FL_SEQ tokens, on the card and on the
     CPU (the worker below) from the same parameters (drawn on the CPU
     from seed 0) and data: equal cohort and kept set, parameters within
     RTOL_FL;
  9. the end-to-end FL loop (repro_torch.launch.fl_e2e.run) on the card
     at its defaults -- full flaas-100m, 8 devices, 2 analysts x 3
     pipelines, seq 256 -- for FL_ROUNDS rounds, with its invariants, the DP kernels
     launched once each per fl_round, and the scheduler's grants equal to
     a scheduler-only run of the same loop on the CPU;
 10. where the FL path's time goes: per round the scheduler, the clients'
     local steps, aggregate (of which the two kernels) and the noise, and
     the card's busy share over one round traced by torch.profiler;
 11. the attention kernels (flash_attention, decode_attention) against
     their twins on the card at flaas-100m's heads (12 query / 4 kv heads,
     dh 64): prefill at the serve default (B=4, S=32), B=4 S=2048 causal,
     B=2 S=1000 window 256 and B=1 S=512 non-causal; decode at B=4 Lc=48
     (cache_len 33 and 48), B=8 Lc=32768 (cache_len 32768 and 20000), a
     ragged Lc=5000 and the long serve's B=8 Lc=2112 at cache_len 2080;
     within rtol = atol = 2e-5 and bitwise from launch to launch, with
     times beside the twin's, the bound and the
     scaled_dot_product_attention yardstick (kv heads repeated); each
     decode case's split, split count, blocks and resident blocks per SM;
 12. serving full flaas-100m through repro_torch.launch.serve on the card
     at its defaults (B=4, prompt 32, gen 16): 12 flash launches and
     12 x 15 decode launches; prefill logits and teacher-forced decode
     logits within 1e-4 of the largest |logit| of the same run on the CPU
     (same parameters and prompts), greedy tokens equal wherever the CPU's
     top-two gap exceeds that bound (near-ties printed); then B=8, prompt
     2048, gen 64 on the card alone;
 13. where serving's time goes at B=8, prompt 2048: per decode step the
     embedding, the blocks (of which the decode kernel) and the LM head as
     synchronised host-clock spans, the card's busy share and kernel
     time by name from torch.profiler over a traced prefill and a traced
     decode of 8 steps, and a host-side profile of 8 decode steps (time
     inside PyTorch ops against the Python between them);
 14. the RG-LRU scan (rglru_scan) against its twin on the card, bitwise
     and bitwise from launch to launch, at recurrentgemma-2b's width (D =
     2560): the serve default's prefill (B=4, S=32), a long prefill with
     h0 (B=4, S=2048), the decode step (B=4, S=1, h0), a ragged B=3,
     S=1000, D=2597 and one sequence's long prefill (B=1, S=2048), each
     with its geometry (ring steps or the direct path, channels a block,
     the bytes in flight the ring is sized for), its share of the bound
     and, beside the decode step, the launch floor; then both attention
     kernels at recurrentgemma-2b's heads (10 query / 1 kv head, dh 256),
     at the serve defaults' shapes (prefill B=4 S=32 window 2048; decode
     B=4 Lc=48 at cache_len 33 and 47) and the long serve's (prefill B=4
     S=2048 window 2048; decode B=4 Lc=2048 at cache_len 2048 and 1000);
     times beside the twin's, the bound and (attention) the SDPA
     yardstick;
 15. serving recurrentgemma-2b through repro_torch.launch.serve: card vs
     CPU at full width with depth cut to one group (rec, rec, local),
     logits within RTOL_SERVE and greedy tokens as in phase 12; the full
     26 layers (3,038,753,280 parameters, drawn on the card by init_model)
     at the defaults with exactly 8 flash, 8 x 15 decode and 18 + 18 x 15
     scan launches; then B=4, prompt 2048, gen 64, so the local rings wrap
     during the decode;
 16. where recurrentgemma-2b's serving time goes at B=4, prompt 2048: the
     card's busy share, kernel time by name and the scan's share over a
     traced prefill and 8 traced decode steps (torch.profiler), and a
     host-side profile of 8 decode steps as in phase 13;
 17. the paper's comparison: dpbalance, dpf, dpk and fcfs through
     run_episode on the paper episode at beta 0.5, 2.2 and 5.0 (Figs. 6,
     2 / 4-5, 6), card against CPU (selections and n_allocated equal,
     every row within RTOL_PAPER), each scheduler's budget kernels and no
     other launched; at beta 2.2 run_simulation on the card against
     repro's values (REPRO_PAPER) and the legacy FlaasSimulator on the
     card against the engine, with ms per round (host clock, synchronised)
     and the card's busy share per scheduler;
 18. fleets: every scenario's fleet of FLEET_SEEDS episodes through
     run_fleet on the card for each scheduler ("auto": lockstep, "vmap"),
     each row equal to run_episode's, the fleets' wall time per scheduler,
     and one fleet with diagnostics=True; then paper_default at paper
     size with LOCKSTEP_SEEDS seeds for every scheduler (dpbalance cold,
     warm and with swap_beam=8) under both modes: vmap bitwise map on
     every key, each round's budget-kernel launches (a lockstep round
     launches as many as one episode's round, whatever E), and each
     mode's wall time and ms per episode;
 19. the certified swap beam (swap_beam=8): the paper episode and phase
     5's round bitwise the full sweep (per-round certificates printed);
     the reference's fleet-scale round (N=1000 pipelines, K=100,000 blocks,
     capacity 0.25) certifies and holds repro's n_allocated, efficiency
     and selections (REPRO_BEAM), its swap_eval launch (M=1, C=8) bitwise
     its twin on the same operands with times and bound, and the round's
     wall, card time, launches and peak device memory beside the same
     round with refine off;
 20. the service plane (repro_torch.service.FlaasService) at
     repro/service/load.py's defaults (paper_default, poisson, seed 0,
     beta 2.2; M=8 x N=25 slots, a 4096-slot ledger ring, chunks of 8,
     admission batches of 32, a queue of 1024): every scheduler through
     SERVICE_TICKS (3.1 ring wraps) with conservation checked every chunk,
     every wrapped chunk paged, every slot recycled, and exactly the
     path's budget kernels launched every tick; dpbalance's first 64
     ticks held to repro's n_allocated and cumulative metrics
     (REPRO_SERVICE); paged bitwise the carry body (cold and warm SP1,
     SERVICE_CPU_TICKS, rows and final state); card against CPU over them
     (dpbalance warm, dpf; selections equal, rows within RTOL_SERVICE);
     replay_gap against run_episode for every scheduler on the card; and
     where the time goes: ticks/s per scheduler, the PhaseProfiler split,
     the card's busy share over one wrapped chunk, the synchronising CUDA
     calls of a chunk beside 8 run_episode rounds, and the service tick
     against the engine round on the paper episode;
 21. service checkpoints and the block-sharded service at phase 20's
     defaults: for every scheduler a RESUME_TICKS run against one saved at
     tick RESUME_AT (async save, then wait) and resumed in a fresh service,
     bitwise (per-tick rows, selections, final state, summary
     fingerprint), paged and, for dpbalance, the carry body too;
     a checkpoint written by the port's manager with the reference's npz
     keys and a host payload naming repro.service classes, restored and
     resumed bitwise; rowmax, matvec and matvec_t against their twins at
     the stripe shapes; ShardedFlaasService through torch.multiprocessing
     spawn -- one stripe under NCCL and two under Gloo with CUDA tensors,
     both ranks on cuda:0 -- for every scheduler (dpbalance with warm
     SP1) over STRIPE_TICKS (past the first ring wrap) against the
     unsharded card run
     with the same config (selections equal, rows within
     RTOL_SERVICE, gap and overdraw <= 1e-4; one stripe's bitwise-ness
     reported), the sharded path's kernels launched every tick, dpf's
     elastic hand-off 1 -> 2 -> 1 stripes within RTOL_SERVICE of the
     unsharded run and 2 -> 2 bitwise; checkpoint ms (sync, async until
     wait returns), restore ms and bytes, ticks/s and collectives per
     tick at one and two stripes, beside the card's name and power limit;
     the spawned ranks run beside the resume and checkpoint checks and
     the unsharded runs (one stripe, then the two-stripe runs that
     restore its hand-off, in one thread; the warm dpbalance two-stripe
     run in another), so their ticks/s are measured under that sharing;
 22. training: (a) the scan's backward kernel (rglru_scan_bwd, no Pallas
     counterpart) bitwise its twin's backward at B=4 S=2048 D=2560 with
     h0, B=1 S=2048, the ragged B=3 S=1000 D=2597 with h0 (the direct
     path), the training microbatch's B=2 S=128 and B=2 S=1000 D=2560
     with h0 (a stage that does not divide S), each with the stage it ran
     and its time beside the twin's and the bound, and the ring kernel
     free of spills in phase 2; (b) repro_torch.launch.train.run at its
     defaults -- full flaas-100m, B=8 x 128, noise 0.2 -- cut to
     LAUNCH_STEPS steps with checkpoints every LAUNCH_STEPS / 2, then the
     last checkpoint deleted and the second half rerun from the first:
     metrics, parameters and optimizer state bitwise; one step traced
     (wall, card busy share, top kernels); one step without noise card vs
     CPU (the worker; metrics within RTOL_TRAIN, parameters within Adam's
     2 lr); (c) recurrentgemma-2b at full width, depth cut to one group
     (RG_TRAIN): two train steps, losses finite, exactly rec layers x
     microbatches scan and backward launches a step, one microbatch's
     gradients card vs CPU within GRAD_RTOL_TRAIN of the largest |g|;
     (d) a DP example-mode step on flaas-100m, rownorms and
     clip_accumulate launched once each;
 23. both attention kernels against their twins at the dense family's
     heads (dh 128): qwen2.5-3b 16 / 2, starcoder2-3b 24 / 2, qwen2.5-32b
     40 / 8 (decode G 5) and starcoder2-15b 48 / 4 (G 12, two head groups
     a kv head); flash at B=4 S=32 and S=2048 causal, decode at the serve
     defaults' 48-slot cache (n 33, 47) and the long serve's 2112 (n 2080,
     1000), with times, bound and SDPA; the G-12 decode against G 6 on the
     same cache with the L2 flushed before each launch (does the second
     head group's read of K/V come from L2?);
 24. serving the dense family through repro_torch.launch.serve:
     qwen2.5-3b and starcoder2-3b whole, starcoder2-15b at 8 of its 40
     layers and qwen2.5-32b at 4 of 64 (all drawn on the card by
     init_model, timed); each cut to DENSE_CPU_LAYERS layer of
     full width card vs CPU as in phase 12; each at the launcher's
     defaults and at B=4, prompt 2048, gen LONG_GEN with exactly one flash
     launch a layer and one decode launch a layer a step after the first,
     prefill ms, decode ms/step (median, range), tokens/s, peak memory and
     the card's busy share over a traced prefill (of at most LONG_TRACE
     tokens) and 4 decode steps at the same batch;
 25. serving xlstm-125m whole (12 layers, 114,510,408 parameters; no
     kernel on its path, none launched), card vs CPU: every block fed the
     CPU's input to it (a 32-token prefill and one decode step: outputs
     within RTOL_SERVE, states within RTOL_STATE of their largest value);
     one pattern group (mlstm x 3, slstm) of full width as in phase 15;
     the whole model's teacher-forced logits within SPREAD_FACTOR times
     what one-ulp parameter noise moves them by on the CPU (the model is
     that ill-conditioned at init: ~1.2e-3 of max|logit|) or RTOL_SERVE,
     the larger; then the
     defaults and the long serve as in phase 24, and the mLSTM / sLSTM
     time (synchronised spans) in a long prefill and 8 decode steps;
 26. training: two steps of qwen2.5-3b at full width cut to 2 layers at
     launch/train.py's configuration (B=8 x 128, two microbatches, noise
     0.2) and one microbatch's gradients card vs CPU as in phase 22 (c);
     launch/train.run(arch="xlstm-125m", steps=2); every xLSTM block's
     gradients card vs CPU on the same input and upstream gradient within
     GRAD_RTOL_TRAIN; the whole model's DP gradients without noise at
     the launcher's first step (its parameters, drawn on the card, and
     its batch), in microbatch mode (B=8 x 128, two microbatches) and
     example mode (2 examples): the card's loss, norm
     mean and max and clipped mean gradient each no further from the
     exact value (the same code in float64 on the card) than the larger
     of RTOL_TRAIN and SPREAD_FACTOR times the CPU float32's distance;
     finite losses, ms per step and peak memory throughout;
 27. both attention kernels at the cross-attention configs' shapes
     (CROSS_FLASH_CASES, CROSS_DECODE_CASES), against their twins as in
     phase 11: flash at Skv != S (non-causal) for llama-3.2-vision-11b's
     cross attention (32 over 8 heads, dh 128; prompts of 32 and 2048
     rows against 1601 memory rows) and whisper-medium's (16 over 16,
     dh 64; 32 and 384 rows against 1500 frames), whisper's encoder
     (non-causal, 1500 = 1500), each with its block count beside the
     card's 132 SMs; decode over the whole memory (B=4, 1601 and 1500
     rows); times, bound and SDPA (kv heads repeated, non-causal);
 28. serving llama-3.2-vision-11b whole (40 layers, 9,775,157,264
     parameters) and whisper-medium whole (24 + 24 layers, 811,333,632),
     drawn on the card by init_model, with norms, biases and the xattn
     gates seeded nonzero and a seeded 0.1 N(0, 1) memory / frames: each
     cut to one pattern group (llama: 4 attn + 1 xattn) or 2 + 2 layers
     (whisper) card vs CPU as in phase 12; each at the launcher's
     defaults and at a long serve (llama B=4, prompt 2048, gen LONG_GEN;
     whisper B=4, prompt 384, gen LONG_GEN, within repro's 448-token
     decoder cache)
     with exactly the launches _cross_launches counts (llama 40 flash a
     prefill, 40 decode a step; whisper 72 and 48), prefill ms, decode
     ms/step, tokens/s, peak memory and busy shares as in phase 24;
 29. both attention kernels at mixtral-8x22b's heads (48 over 8 heads,
     dh 128, G 6) against their twins as in phase 11: flash with its
     4096-token window at the serve prompt (B=4, S=32) and the long
     serve's (B=4, S=2048); decode at the serve defaults' 48-slot ring (33
     valid) and the long serve's 2112 (2080 valid); times, bound and SDPA;
 30. serving the MoE family through repro_torch.launch.serve:
     mixtral-8x22b at full width cut to 4 of its 56 layers
     (10,418,903,040 parameters, drawn on the card, norm scales seeded
     nonzero) at the launcher's defaults and at B=4, prompt 2048, gen
     LONG_GEN as in phase 24 (one flash launch a layer, one decode launch
     a layer a step); card vs CPU at 1 layer (gen MIX_CPU_GEN) as in
     phase 12, and every routing call's chosen experts (the prefill's B*S
     tokens, each decode step's B) equal on both devices except where the
     CPU's k-th and (k+1)-th router
     logits lie within ROUTE_TIE of their largest (counted); kimi-k2-1t-
     a32b's reduced config (dense prefix, 4 experts top 2, shared expert)
     card vs CPU the same way; moe_apply at kimi's routing geometry (384
     experts, top 8) at a narrow width with an overflowing expert, card vs
     CPU and bitwise from launch to launch;
 31. training at launch/train.py's configuration (two microbatches,
     noise 0.2) at B=8 x 128 (llama B=4): llama-3.2-vision-11b at full
     width cut to one pattern group and whisper-medium to 2 + 2 layers,
     gates, norms,
     biases and a 0.1 N(0, 1) memory / frames seeded nonzero, two steps
     each, then one microbatch's gradients card vs CPU within
     GRAD_RTOL_TRAIN of the largest |g|; one DP example-mode step on
     whisper (each example with its own frames; rownorms and
     clip_accumulate launched once each); reduced mixtral-8x22b two steps
     and reduced kimi-k2-1t-a32b through launch/train.run (Adafactor), each
     with one microbatch's gradients card vs CPU;
 32. both attention kernels on bfloat16 operands (att_flash_bf16,
     att_flash_wide_bf16, att_decode_bf16) against their twins fed the
     same bfloat16 inputs at every config's heads (_config_heads: each
     attention config's serve prompt and 48-slot decode, the cross
     configs' memory, qwen2.5-32b's and recurrentgemma-2b's long serves):
     every output within one bfloat16 ulp of the twin's plus ATT_TOL,
     bitwise from launch to launch; times beside the twin's, the bound
     (bfloat16 bytes; operations at the bfloat16 tensor-core peak) and
     SDPA in bfloat16;
 33. serving in bfloat16 (BF16_SERVE): qwen2.5-32b whole (64 layers,
     65.5 GB, drawn on the card) at the launcher's defaults and at B=4 x
     2048, starcoder2-15b and recurrentgemma-2b whole at the defaults,
     each with exactly its launches, prefill ms, decode ms/step, tok/s and
     peak memory, qwen2.5-32b's busy shares; each cut (1 layer, one
     group) drawn by the CPU worker and served on the card, held to the
     worker's bfloat16 serve within BF16_FACTOR x d (d: the worker's
     bfloat16 run from its float32 run on the same values, under
     BF16_VACUOUS of max|logit|), greedy tokens as in phase 12;
 34. training in bfloat16 with a float32 master at launch/train.py's
     configuration (BF16_TRAIN): qwen2.5-3b at 2 layers and
     recurrentgemma-2b at 3, two steps each (losses finite, exact scan
     launches, parameters the masters rounded once, ms per step, peak
     memory), one microbatch's gradients of the worker's cut card vs CPU
     within BF16_FACTOR x d plus half a bfloat16 ulp of the largest |g|;
     launch/train.run(param_dtype="bfloat16") on flaas-100m resumed from
     its first checkpoint, bitwise the uninterrupted run;
 35. the sharded training step (repro_torch.launch.sharded_train, ranks
     spawned after phase 21, beside no other phase): 4 Gloo
     ranks sharing the card -- flaas-100m at launch/train.py's defaults
     on (data 2, model 2), SHARD_STEPS steps, against the one-process
     card run on rank 0 (gradients with noise off within RTOL_TRAIN of
     each leaf's largest |g|, loss and grad_norm_mean within RTOL_TRAIN,
     parameters after SHARD_COMPARE_AT steps within Adam's 2 lr), each
     rank's bytes of parameters and optimizer state equal to the rules'
     count, ms per step a rank (the 2-rank and NCCL worlds run beside
     the 4 ranks); DP example mode one step (rownorms and
     clip_accumulate once a rank, on its share of the parameter vector,
     in a gradient pass with noise off and in the step; the gradients
     within RTOL_TRAIN of each leaf's largest |g|, loss and
     grad_norm_mean within RTOL_TRAIN);
     recurrentgemma-2b at one group on (data 1, model 2) on 2 more Gloo
     ranks, the scan and its backward on half the channels, exact
     launches, gradients within GRAD_RTOL_TRAIN of the largest |g|;
     pipeline_apply over flaas-100m's 12 blocks as 4 stages against the
     sequential forward; one NCCL rank on a (1, 1) mesh beside the Gloo
     ranks, bitwise the unsharded step.

float32 matrix products run in full float32 (TF32 off, set and printed);
bfloat16 products accumulate in float32 and round once
(allow_bf16_reduced_precision_reduction off, set and printed).
The CPU references of phases 4, 8, 17, 20, 22, 33 and 34 (seeded
episodes, services, an FL round, a training step, the bfloat16 cuts'
serves and gradients) run in one spawned worker process, started beside
the build, while the card phases run.
The second-to-last lines are a JSON object listing the kernels and the
card's name and power limit; the last line is the run's verdict as JSON.
Exits nonzero without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published HBM3 bandwidth
FP32_FLOP_PER_S = 67e12        # H100 SXM published fp32 (non-tensor) rate
BF16_FLOP_PER_S = 989e12       # H100 SXM published dense bf16 tensor rate
SOURCE = "src/repro_torch/kernels/csrc/budget_alloc.cu"
DP_SOURCE = "src/repro_torch/kernels/csrc/dp_clip_noise.cu"
DP_REPLACES = {
    "rownorms": "src/repro/kernels/dp_clip_noise.py:41",
    "clip_accumulate": "src/repro/kernels/dp_clip_noise.py:73",
}
P_FLAAS = 124_668_672          # flaas-100m parameters
# (name, B rows, P): the e2e aggregate (6 kept clients), DP-SGD example
# mode (8 examples), a ragged P, one row
DP_SHAPES = [("e2e", 6, P_FLAAS), ("example", 8, P_FLAAS),
             ("ragged", 3, 4096 * 7 + 13), ("one-row", 1, P_FLAAS)]
NORM_RTOL = 1e-5               # rownorms vs twin (sum order differs)
RTOL_FL = 1e-4                 # phase 8: card vs CPU, of the largest delta
FL_SEQ = 64                    # phase 8: tokens a client's batch row
FL_ROUNDS = 4                  # phase 9: the launcher's 12 rounds cut to 4
ATT_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
ATT_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:71",
    "decode_attention": "src/repro/kernels/decode_attention.py:56",
}
ATT_TOL = 2e-5                 # rtol and atol, kernel vs twin (repro's bound)
HEADS = (12, 4, 64)            # flaas-100m: query heads, kv heads, head dim
# (name, B, S, causal, window)
FLASH_CASES = [("serve", 4, 32, True, None), ("2k", 4, 2048, True, None),
               ("swa", 2, 1000, True, 256), ("full", 1, 512, False, None)]
# (name, B, cache slots Lc, cache_len)
DECODE_CASES = [("serve-33", 4, 48, 33), ("serve-48", 4, 48, 48),
                ("32k", 8, 32768, 32768), ("32k-20000", 8, 32768, 20000),
                ("ragged", 4, 5000, 4999), ("long-2080", 8, 2112, 2080)]
RTOL_SERVE = 1e-4              # phases 12, 15: card vs CPU, of max |logit|
RG_SOURCE = "src/repro_torch/kernels/csrc/rg_lru.cu"
RG_REPLACES = "src/repro/kernels/rg_lru.py:43"
RG_HEADS = (10, 1, 256)        # recurrentgemma-2b: query heads, kv heads, dh
# (name, B, S, D, with h0): the serve default's prefill, the long run's
# prefill, the decode step, a ragged shape, a single sequence's long prefill
RG_CASES = [("serve", 4, 32, 2560, False), ("2k", 4, 2048, 2560, True),
            ("decode", 4, 1, 2560, True), ("ragged", 3, 1000, 2560 + 37, True),
            ("b1-2k", 1, 2048, 2560, False)]
# the serve defaults' shapes (prompt 32; a 48-slot ring at cache_len 33..47)
# and the long serve's (prompt 2048; the 2048-slot ring full, and half full);
# flash also at the card tests' ragged shape and one sequence's long prefill
RG_FLASH_CASES = [("rg-serve", 4, 32, True, 2048),
                  ("rg-2k", 4, 2048, True, 2048),
                  ("rg-ragged", 2, 1037, True, 300),
                  ("rg-b1-2k", 1, 2048, True, 2048)]
RG_DECODE_CASES = [("rg-serve-33", 4, 48, 33), ("rg-serve-47", 4, 48, 47),
                   ("rg-2048", 4, 2048, 2048), ("rg-1000", 4, 2048, 1000)]
P_RG2B = 3_038_753_280         # recurrentgemma-2b parameters
# phases 23-26: the dense GQA family at dh 128 and xLSTM.  (name, layers
# served -- None: all -- and the label prefix of its kernel cases):
# qwen2.5-3b and starcoder2-3b whole; starcoder2-15b (63.8 GB whole) and
# qwen2.5-32b (131 GB) cut to 8 and 4 layers to fit float32 on one card
DENSE = (("qwen2.5-3b", None, "q3b"), ("starcoder2-3b", None, "sc3b"),
         ("starcoder2-15b", 8, "sc15b"), ("qwen2.5-32b", 4, "q32b"))
P_DENSE = {"qwen2.5-3b": 3_397_103_616, "starcoder2-3b": 3_180_813_312}
DENSE_CPU_LAYERS = 1           # card vs CPU: the model cut to 1 layer
DENSE_FLASH_CASES = [("serve", 4, 32, True, None), ("2k", 4, 2048, True, None)]
# the serve defaults' cache (48 slots) and the long serve's (2112)
DENSE_DECODE_CASES = [("serve-33", 4, 48, 33), ("serve-47", 4, 48, 47),
                      ("long-2080", 4, 2112, 2080),
                      ("long-1000", 4, 2112, 1000)]
# the launcher's defaults and a long serve (gen cut from 64 to LONG_GEN);
# a long serve's busy shares come from a traced prefill of LONG_TRACE
# tokens (tracing costs host time in proportion)
LONG_GEN, LONG_TRACE = 32, 1024
SERVE_RUNS = (("defaults", 4, 32, 16), ("long", 4, 2048, LONG_GEN))
P_XLSTM = 114_510_408          # xlstm-125m parameters
# phases 27-28: cross attention.  llama-3.2-vision-11b (attn x 4 + xattn,
# 8 groups; 32 query over 8 kv heads, dh 128, a 1601-row image memory)
# and whisper-medium (24 encoder and 24 encdec layers; 16 over 16 heads,
# dh 64, 1500 frames), each served whole in float32 on one card
XATTN, WHISPER = "llama-3.2-vision-11b", "whisper-medium"
P_CROSS = {XATTN: 9_775_157_264, WHISPER: 811_333_632}
# flash at Skv != S: each model's cross attention at the serve prompt and
# at its long serve's prompt (2048 / 384 rows against the memory), and
# whisper's encoder (non-causal self attention over the 1500 frames)
CROSS_FLASH_CASES = {
    XATTN: [("ll-x32", 4, 32, False, None, 1601),
            ("ll-x2048", 4, 2048, False, None, 1601)],
    WHISPER: [("wh-enc", 4, 1500, False, None),
              ("wh-x32", 4, 32, False, None, 1500),
              ("wh-x384", 4, 384, False, None, 1500)]}
# decode over every row of the memory (cache_len = the memory's length)
CROSS_DECODE_CASES = {XATTN: [("ll-x1601", 4, 1601, 1601)],
                      WHISPER: [("wh-x1500", 4, 1500, 1500)]}
# the serves: the launcher's defaults, and a long one -- llama like the
# dense family's; whisper's prompt and gen filling repro's 448-token
# decoder cache (DECODER_PROMPT_LEN)
CROSS_RUNS = {XATTN: SERVE_RUNS,
              WHISPER: (("defaults", 4, 32, 16), ("long", 4, 384, LONG_GEN))}
# card vs CPU: llama cut to one pattern group (4 attn + 1 xattn, 2.1 B
# parameters), whisper to 2 decoder and 2 encoder layers
CROSS_CPU_CUT = {XATTN: (5, None), WHISPER: (2, 2)}
# phases 29-31: the MoE family and training the cross-attention configs.
# mixtral-8x22b (swa blocks, window 4096, 48 query over 8 kv heads, dh 128,
# 8 experts top 2 of d_ff 16,384) at full width cut to 4 of its 56 layers
# (10,418,903,040 parameters, 41.7 GB in float32: one layer holds 2.42 B
# in its experts), card vs CPU at 1 layer (2,906,720,256); kimi-k2-1t-
# a32b on its reduced config (one of its MoE layers is 16.9 B parameters)
MIXTRAL, KIMI = "mixtral-8x22b", "kimi-k2-1t-a32b"
MIX_LAYERS, MIX_CPU_LAYERS = 4, 1
P_MIX = {4: 10_418_903_040, 1: 2_906_720_256}
MIX_FLASH_CASES = [("mx-serve", 4, 32, True, 4096),
                   ("mx-2k", 4, 2048, True, 4096)]
MIX_DECODE_CASES = [("mx-serve-33", 4, 48, 33),
                    ("mx-long-2080", 4, 2112, 2080)]
ROUTE_TIE = 1e-5               # k-th vs (k+1)-th router logit, of its max
# moe_apply at kimi's routing geometry (384 experts, top 8, capacity
# factor 1.25) at a narrow width: (tokens, d_model, d_ff); the router
# biased so that every token's first choice is one expert, past its
# capacity
KIMI_MOE = (4096, 256, 128)
# training the cross-attention configs at full width: llama-3.2-vision-11b
# cut to one pattern group (4 attn + 1 xattn, 2,141,237,250 parameters)
# and whisper-medium to 2 decoder + 2 encoder layers (164,982,784), at
# launch/train.py's configuration (two microbatches, noise 0.2) at B=8 x
# 128, llama's batch cut to 4 (so its CPU gradient check runs 2 x 128
# tokens), gates, norms, biases and memory / frames seeded nonzero; DP
# example mode on whisper (llama's [B, P] per-example gradients would
# take 34 GB beside its training state).  (layers, encoder layers,
# parameters, batch)
XTRAIN = {XATTN: (5, None, 2_141_237_250, 4),
          WHISPER: (2, 2, 164_982_784, 8)}
MIX_CPU_GEN = 8                # mixtral's card-vs-CPU serve: 8 tokens
# kernels phase 2 holds free of spills (mangled-name fragments): the scan's
# backward ring, and the decode split kernel at dh 128 for G 5 and 12
NO_SPILL = ("rg_scan_bwd_ring", "decode_split_kernelILi128ELi5E",
            "decode_split_kernelILi128ELi12E")
PARAM_NOISE = 1e-7             # one float32 ulp, relative: the spread probe
# xlstm-125m whole is ill-conditioned at init in float32 (the mLSTM divides
# by max(|q.n|, exp(-m)); a position near that max's kink takes the other
# branch under a rounding's difference): its logits move ~1.2e-3 of
# max|logit| on the CPU itself when every parameter moves PARAM_NOISE, and
# its float32 gradient is 5-33% from the exact one on the CPU.  So the
# whole model's logits are held to the larger of the usual bound and
# SPREAD_FACTOR times that spread, and its training loss, DP norms and
# gradient to the larger of RTOL_TRAIN and SPREAD_FACTOR times the CPU
# float32's distance from the exact (float64) value, both measured in the
# run; one pattern group to RTOL_SERVE, every block to RTOL_SERVE
# (outputs) and RTOL_STATE (states), every block's gradients to
# GRAD_RTOL_TRAIN
SPREAD_FACTOR = 4.0
RTOL_STATE = 1e-5              # recurrent states, of their largest |value|
# launch/train.py's defaults (B=8 x 128, two microbatches, noise 0.2), two
# steps; qwen2.5-3b at full width cut to 2 layers (776 M parameters, 622 M
# of them the 151,936-word embedding and LM head), xlstm-125m whole
NEW_TRAIN = dict(batch=8, seq=128, steps=2, dense_layers=2)
# phase 22: the scan's backward kernel, which replaces no Pallas kernel:
# repro takes the gradient of linear_scan by autodiff of associative_scan
RG_BWD_REPLACES = "src/repro/models/recurrent.py:64"
RG_BWD_NOTE = ("no Pallas counterpart: the gradient of "
               "src/repro/models/recurrent.py:64 linear_scan (autodiff of "
               "associative_scan)")
# recurrentgemma-2b trained at full width with its depth cut to one
# pattern group (rec, rec, local): 1,508,697,600 float32 parameters, 1.31 B
# of them the 256,000-word embedding and LM head, 53 GiB at the peak of a
# step with AdamW and DP state (all 26 layers would need ~85 GB); batch 4
# of 128 tokens, two microbatches of 2, so the scan runs at B=2 S=128
RG_TRAIN = dict(n_layers=3, batch=4, seq=128, steps=2)
# (name, B, S, D, with h0): phase 14's long prefill, one sequence's,
# the ragged direct-path shape, the training microbatch's, and an S that
# the ring's stage (24) does not divide
RG_BWD_CASES = [("2k", 4, 2048, 2560, True), ("b1-2k", 1, 2048, 2560, False),
                ("ragged", 3, 1000, 2560 + 37, True),
                ("train", 2, 128, 2560, False),
                ("ragged-s", 2, 1000, 2560, True)]
RTOL_TRAIN = 1e-5              # phase 22: card vs CPU loss, relative
LAUNCH_STEPS = 6               # phase 22: the launcher's 20 steps cut to 6
GRAD_RTOL_TRAIN = 1e-4         # card vs CPU gradients, of the largest |g|
REPLACES = {
    "rowmax": "src/repro/kernels/budget_alloc.py:41",
    "matvec": "src/repro/kernels/budget_alloc.py:75",
    "matvec_t": "src/repro/kernels/budget_alloc.py:95",
    "dual_step": "src/repro/kernels/budget_alloc.py:144",
    "boost_scan": "src/repro/kernels/budget_alloc.py:224",
    "swap_eval": "src/repro/kernels/budget_alloc.py:278",
}
# (name, M analysts, N pipelines, K blocks, C swap candidates per analyst)
SHAPES = [("paper", 6, 25, 2000, 156),
          ("large", 32, 32, 16384, 256),
          ("ragged", 5, 7, 53257, 11)]   # K % 4 != 0: 4-byte loads
# boost_scan and swap_eval alone: the large round's M, N, K with the swap
# beam's few candidates, and a K whose leftover stripes exceed 8 x 200 KB
# of shared memory (they stay in device memory)
SWEEP_SHAPES = [("beam", 32, 32, 16384, 8), ("spill", 1, 3, 450_000, 2)]
# repro's own values for phase 5's round (seed 0, beta 2.2, refine on),
# computed with repro's jnp path on a CPU: capacity -> (n_allocated,
# efficiency, selected (analyst, pipeline) pairs); at 3.0 analysts 9 and
# 24 get all 32 pipelines
REPRO_LARGE = {1.0: (0, None, []),
               3.0: (64, 0.7299625,
                     [[i, n] for i in (9, 24) for n in range(32)])}
REPRO_EFF_RTOL = 1e-5
# phase 17: the paper's comparison (SimConfig(seed=0)) at the betas of its
# Figs. 6 (0.5), 2 / 4-5 (2.2) and 6 (5.0); every continuous row card vs
# CPU within RTOL_PAPER relative and absolute
PAPER_BETAS = (0.5, 2.2, 5.0)
RTOL_PAPER = 1e-5
# repro's own run_simulation at beta 2.2 (engine path, on a CPU): per
# scheduler, n_allocated per round, final cumulative_efficiency and final
# cumulative_fairness_norm (float32)
REPRO_PAPER = {
    "dpbalance": ([25, 0, 0, 18, 20, 4, 0, 48, 0, 0], 2.9366531, 4.0074286),
    "dpf": ([25, 0, 0, 24, 25, 0, 0, 63, 0, 0], 2.4883106, 4.0065427),
    "dpk": ([25, 0, 0, 24, 25, 0, 0, 61, 0, 0], 2.5449417, 4.0065427),
    "fcfs": ([25, 0, 0, 24, 25, 0, 0, 35, 0, 0], 2.5413046, 4.0056357),
}
# the budget kernels each scheduler's round launches
PATH_KERNELS = {"dpbalance": ("rowmax", "matvec", "matvec_t", "dual_step",
                              "boost_scan", "swap_eval"),
                "dpf": ("rowmax",), "dpk": ("rowmax",), "fcfs": ("rowmax",)}
# phase 18: seeds per scenario in each fleet, and the lockstep fleet at
# paper size: its seeds, and the runs (scheduler, SchedulerConfig
# overrides) it takes under both modes
FLEET_SEEDS = 2
LOCKSTEP_SEEDS = 4
LOCKSTEP_RUNS = [("dpbalance", {}), ("dpbalance", {"sp1_warm_start": True}),
                 ("dpbalance", {"swap_beam": 8}), ("dpf", {}), ("dpk", {}),
                 ("fcfs", {})]
# phase 3: the lockstep fleet's batched SP1 kernels, (name, E episodes, M,
# K): phase 18's paper fleet, a fleet past one wave of dual clusters, and
# a few large rounds
FLEET_KERNEL_SHAPES = [("fleet-paper", LOCKSTEP_SEEDS, 6, 2000),
                       ("fleet-paper-256", 256, 6, 2000),
                       ("fleet-large", 4, 32, 16384)]
# phase 19: the reference's fleet-scale round
# (bench_scheduler_scale.py:_round(1, 100_000, 1000, cap=0.25): M, K, N,
# capacity), beta 2.2, refine on, a beam of 8; repro's values for it
# (jnp path, on a CPU): n_allocated, efficiency and the selected
# pipelines, with the beam and with refine off
BEAM_ROUND = (1, 100_000, 1000, 0.25)
BEAM_WIDTH = 8
REPRO_BEAM = {"beam": (8, 0.17649494, [71, 209, 292, 328, 357, 495, 503, 979]),
              "no_refine": (8, 0.17099118,
                            [71, 209, 292, 322, 328, 357, 495, 503])}
# phase 20: the service plane at repro/service/load.py's defaults
# (paper_default, poisson, seed 0, beta 2.2): M=8 analyst slots x N=25
# pipeline slots, a B=4096-slot ledger ring (200 blocks a tick: a wrap
# every 20.48 ticks), chunks of 8 ticks, admission batches of 32, a queue
# of 1024
SERVICE_GEOMETRY = dict(analyst_slots=8, pipeline_slots=25,
                        block_slots=4096, chunk_ticks=8, admit_batch=32,
                        max_pending=1024)
SERVICE_TICKS = 64             # 3.1 ring wraps (REPRO_SERVICE's ticks)
SERVICE_CPU_TICKS = 24         # card vs CPU: past the first wrap
RTOL_SERVICE = 1e-5            # continuous outputs, relative and absolute
# repro's own service at those defaults (cold SP1, on a CPU): per-tick
# n_allocated over the first 64 ticks, then cumulative_efficiency and
# cumulative_fairness_norm after them
REPRO_SERVICE = (
    [25, 0, 0, 18, 20, 4, 0, 48, 23, 0, 28, 1, 1, 0, 0, 0, 25, 0, 0, 0, 0,
     0, 0, 0, 2, 2, 0, 0, 0, 0, 0, 0, 101, 11, 0, 0, 0, 0, 0, 0, 64, 0, 0,
     0, 0, 0, 0, 0, 71, 0, 0, 0, 0, 0, 0, 0, 82, 0, 0, 0, 0, 0, 0, 0],
    5.85961267, 30.9422776)
# budget-kernel launches per tick of each scheduler's round on the card
SERVICE_PER_TICK = {"dpbalance": {"rowmax": 1, "matvec": 1, "matvec_t": 2,
                                  "dual_step": 1, "boost_scan": 2,
                                  "swap_eval": 1},
                    "dpf": {"rowmax": 1}, "dpk": {"rowmax": 1},
                    "fcfs": {"rowmax": 1}}
# phase 21: checkpoints and the sharded service at SERVICE_GEOMETRY
RESUME_TICKS, RESUME_AT = 40, 24      # an uninterrupted run; the save,
                                      # just past the first wrap
SHARD_TICKS = 32                      # the unsharded runs and dpf's hand-offs
ONE_STRIPE_TICKS = 24                 # past the first wrap
# a sharded axis runs SP1 as a host loop, an all_reduce and a host read
# an iteration (~1.1 ms under NCCL, ~2.6 ms under Gloo on one card, on an
# H100); cold SP1 takes ~2300 iterations a tick at these defaults (0.40 /
# 0.12 ticks/s at one / two stripes), warm ~830, so the sharded runs and
# their unsharded yardstick take dpbalance with warm SP1
SHARD_WARM = ("dpbalance",)
# ticks of each scheduler's sharded runs at (one, two) stripes: the warm
# dpbalance run's SP1 host loop runs ~1.3 ticks/s under NCCL and ~0.9
# under Gloo on an H100 host, so it crosses the first ring wrap and no
# more at either; the others run SHARD_TICKS at two stripes
STRIPE_TICKS = {"dpbalance": (ONE_STRIPE_TICKS, ONE_STRIPE_TICKS),
                "dpf": (ONE_STRIPE_TICKS, SHARD_TICKS),
                "dpk": (ONE_STRIPE_TICKS, SHARD_TICKS),
                "fcfs": (ONE_STRIPE_TICKS, SHARD_TICKS)}
ELASTIC_AT = (8, 16)                  # dpf: 1 -> 2 stripes, then 2 -> 1
# the sharded path's budget kernels: SP1's two-matvec path and the row-max
SHARD_KERNELS = {"dpbalance": ("rowmax", "matvec", "matvec_t"),
                 "dpf": ("rowmax",), "dpk": ("rowmax",), "fcfs": ("rowmax",)}
# (name, M, K): the regime repro/kernels/budget_alloc.py was written for
# ("M ~ 10^3 analysts, K ~ 10^5 live blocks"), 512 MB of float32, beyond
# the 50 MB L2; the dense kernels only (the sweeps' [M, N, K] demand would
# take 40+ GB)
PROD = ("prod", 1024, 131072)
# phases 4, 17 and 20: their CPU references need nothing of the card
# (seeded episodes and services), so one worker process computes them on
# CPU_REF_THREADS threads while the card phases run (bitwise the same
# results as on eight, on a CPU box)
CPU_REF_THREADS = 3
_CPU_REFS = {}                 # key -> the worker's pending result
# phases 32-34: bfloat16 parameters.  Kernel cases at every config's heads
# (CONFIG_HEADS below: each attention config's serve prompt B=4 S=32 and
# its decode at the serve defaults' 48-slot cache, 33 valid; the cross
# configs' memory; qwen2.5-32b's and recurrentgemma-2b's long serves).
# Served whole in bfloat16 (name, cut for card vs CPU, long serve):
# qwen2.5-32b (65.5 GB) at the defaults and B=4 x 2048, starcoder2-15b
# (31.9 GB) and recurrentgemma-2b (6.1 GB) at the defaults; each cut
# model is drawn on the CPU from BF16_SEED by the worker, which serves it
# in bfloat16 and, for the bound, in float32 on the same values
BF16_SERVE = (("qwen2.5-32b", 1, True), ("starcoder2-15b", 1, False),
              ("recurrentgemma-2b", 3, False))
P_BF16 = {"qwen2.5-32b": 32_763_876_352, "starcoder2-15b": 15_956_414_464,
          "recurrentgemma-2b": P_RG2B}
BF16_SEED = 7
# the CPU tests' bound (tests/test_torch_bf16.py): the card within FACTOR
# x d of the CPU's bfloat16 run, d its distance from the CPU's float32 run
# on the same values, itself under VACUOUS of max|logit|; gradients plus
# half a bfloat16 ulp of the largest (tests/test_torch_bf16_train.py)
BF16_FACTOR, BF16_VACUOUS, BF16_HALF_ULP = 2.0, 5e-2, 2.0 ** -9
# training in bfloat16 at the launcher's configuration (B=8 x 128, two
# microbatches, noise 0.2), two steps, full width: (name, layers); one
# microbatch of BF16_MB (rows, tokens) card vs CPU on a cut drawn by the
# worker; and launch/train.run(param_dtype="bfloat16") on flaas-100m
# resumed from its first checkpoint, bitwise
BF16_TRAIN = (("qwen2.5-3b", 2), ("recurrentgemma-2b", 3))
BF16_MB = (2, 64)
BF16_LAUNCH_STEPS = 4
# phase 35: the sharded training step across ranks sharing the card (Gloo;
# every rank on cuda:0): flaas-100m at full width at launch/train.py's
# defaults (B=8 x 128, two microbatches, AdamW, noise 0.2), SHARD_STEPS
# steps on (data 2, model 2), parameters compared after the CPU tests' 2;
# example mode one step; recurrentgemma-2b at full width cut to one group
# (rec, rec, local) on (data 1, model 2), one gradient pass of B=4 x 128;
# pipeline_apply over flaas-100m's 12 blocks as 4 stages of 3 (PIPE_X:
# n_micro, B, S); one rank under NCCL on a (1, 1) mesh, bitwise
SHARD_STEPS, SHARD_COMPARE_AT = 3, 2
PIPE_X = (4, 2, 128)
SHARD_TIMEOUT = 600


T_START = time.perf_counter()


def log(*a):
    """Print and flush; a phase's header line (``[N] ...``) also shows the
    seconds since the script started."""
    if a and isinstance(a[0], str) and a[0][:1] == "[":
        a = (*a, f"(t = {time.perf_counter() - T_START:.1f} s)")
    print(*a, flush=True)


def time_ms(fn, reps: int, trials: int = 5) -> float:
    """Device milliseconds per call of ``fn()``: the median over ``trials``
    of CUDA-event time around ``reps`` back-to-back calls, divided by
    ``reps``.  Each trial is queued behind a 20 ms device spin, so the
    calls run without waiting on the host's enqueue; inputs stay resident
    in L2 where they fit, as in the SP1 loop."""
    fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)          # ~20 ms at ~2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name, got, want, bitwise: bool) -> float:
    """Raise unless ``got`` matches ``want`` (bitwise, or elementwise
    within 1e-5 relative); return the max absolute error."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    if bitwise:
        ok = torch.equal(got, want)
    else:
        ok = bool(torch.all((got.double() - want.double()).abs()
                            <= 1e-5 * want.double().abs() + 1e-30))
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max abs err {err:.3e}, bitwise={bitwise})")
    return err


def _cpu_ref_keys():
    """The CPU references phases 4, 8, 17, 20 and 22 compare with, in the
    order they are needed: ``("episode", SchedulerConfig overrides,
    scheduler or None)`` on the paper episode, ``("fl_round",)`` (phase
    8's round), ``("service", scheduler, warm SP1, ticks)`` at
    SERVICE_GEOMETRY, ``("train_step",)`` (phase 22's step without
    noise), and phases 33-34's bfloat16 cuts, ``("bf16_serve", name,
    layers)`` and ``("bf16_grads", name, layers)``."""
    names = tuple(PATH_KERNELS)
    return ([("episode", (("sp1_warm_start", w),), None)
             for w in (False, True)] + [("fl_round",)] +
            [("episode", (("beta", b),), n) for b in PAPER_BETAS
             for n in names] +
            [("service", "dpbalance", True, SERVICE_CPU_TICKS),
             ("service", "dpf", False, SERVICE_CPU_TICKS),
             ("train_step",)] +
            [("bf16_serve", n, nl) for n, nl, _ in BF16_SERVE] +
            [("bf16_grads", n, nl) for n, nl in BF16_TRAIN])


def _fl_model():
    """Phase 8's model: flaas-100m cut to 2 layers, drawn on the CPU from
    seed 0 (so the worker and the card phase start from the same
    values), and its configuration."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_arch("flaas-100m"), n_layers=2)
    return cfg, init_model(cfg, 0, device="cpu")


def _fl_round_on(model, cfg, device):
    """Phase 8's DP-FedAvg round (sigma 0) of ``model`` on ``device``:
    ``(metrics, seconds)``; the model is updated in place."""
    from repro_torch.launch.fl_e2e import FEDAVG
    from repro_torch.training import FedAvgConfig, fl_round, make_loss_fn
    t0 = time.perf_counter()
    _, m = fl_round(model, make_loss_fn(cfg),
                    _fl_data(8, cfg.vocab, FL_SEQ, device), list(range(8)),
                    FedAvgConfig(**FEDAVG, seed=0), sigma=0.0, round_idx=0)
    if device == "cuda":
        torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def _quiet_step_state(device):
    """Phase 22's card-vs-CPU step: flaas-100m's launcher configuration
    without noise, its state drawn on the CPU from seed 0 and moved to
    ``device``; ``(cfg, tcfg, state)``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.training import make_state
    cfg = get_arch("flaas-100m")
    quiet = launcher.train_config(cfg, 8, 0.0, 1.0)
    host = make_state(0, cfg, quiet, device="cpu")
    if device == "cpu":
        return cfg, quiet, host
    dev = make_state(0, cfg, quiet, device=device)
    with torch.no_grad():
        dev["params"].flat.copy_(host["params"].flat)
        for k, t in host["opt"]["master"].items():
            dev["opt"]["master"][k].copy_(t)
    return cfg, quiet, dev


def _bf16_cut(name, n_layers):
    """Phases 33-34's cut: ``name`` at full width, ``n_layers`` layers,
    bfloat16, drawn on the CPU from BF16_SEED."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_arch(name), n_layers=n_layers)
    return cfg, init_model(cfg, BF16_SEED, device="cpu",
                           dtype=torch.bfloat16)


def _as_float32(model):
    """A float32 model on the same device holding ``model``'s values."""
    from repro_torch.models import Transformer
    out = Transformer(model.cfg, device=model.device)
    with torch.no_grad():
        for p, q in zip(out.parameters(), model.parameters()):
            p.copy_(q)
    return out


def _flats_to_files(model):
    """Each dtype buffer of ``model`` to a file (bfloat16 as its bits)."""
    return {str(dt): _to_file(buf.view(torch.int16) if dt == torch.bfloat16
                              else buf) for dt, buf in model.flats.items()}


def _flats_from_files(model, paths):
    with torch.no_grad():
        for dt, buf in model.flats.items():
            t = _from_file(paths[str(dt)])
            buf.copy_(t.view(torch.bfloat16) if dt == torch.bfloat16 else t)


def _flat_grads(model, mb):
    """The loss's gradients on ``mb`` as one float32 vector (each leaf
    cast exactly)."""
    from repro_torch.training import make_loss_fn
    bb = {k: v.to(model.device) for k, v in mb.items()}
    g = torch.autograd.grad(make_loss_fn(model.cfg)(model, bb),
                            list(model.parameters()))
    return torch.cat([x.reshape(-1).float() for x in g]).cpu()


def _logits_files(run):
    return {part: _to_file(x) for part, x in run["logits"].items()}


def _cpu_reference(key):
    """One CPU reference run (a key of ``_cpu_ref_keys``): ``(result,
    host seconds)``; an episode's outputs, or a service's ``_run_ticks``
    to its last tick."""
    t0 = time.perf_counter()
    if key[0] == "bf16_serve":
        # the cut served in bfloat16 (greedy), then in float32 on the same
        # values fed the bfloat16 run's tokens: d, the bound's measure
        from repro_torch.launch import serve
        _, host = _bf16_cut(key[1], key[2])
        b = serve.run(model=host, gen=16, keep_logits=True, log=None)
        f = serve.run(model=_as_float32(host), gen=16, feed=b["tokens"],
                      keep_logits=True, log=None)
        out = (_flats_to_files(host),
               {"prompts": b["prompts"], "tokens": b["tokens"],
                "logits": _logits_files(b)}, _logits_files(f))
    elif key[0] == "bf16_grads":
        cfg, host = _bf16_cut(key[1], key[2])
        mb = _batch_on(cfg, 0, *BF16_MB, "cpu")
        out = (_flats_to_files(host), _to_file(_flat_grads(host, mb)),
               _to_file(_flat_grads(_as_float32(host), mb)))
    elif key[0] == "fl_round":
        cfg, host = _fl_model()
        m, _ = _fl_round_on(host, cfg, "cpu")
        out = (m, _to_file(host.flat))
    elif key[0] == "train_step":
        from repro_torch.training import train_step
        cfg, quiet, st = _quiet_step_state("cpu")
        st, m = train_step(st, _batch_on(cfg, 0, 8, 128, "cpu"), cfg, quiet)
        out = (_to_file(st["params"].flat),
               {k: float(v) for k, v in m.items()})
    elif key[0] == "episode":
        from repro_torch.core import (SchedulerConfig, SimConfig,
                                      generate_episode, run_episode)
        _, over, name = key
        ep = generate_episode(SimConfig(seed=0), device="cpu")
        cfg = SchedulerConfig(**dict(over))
        out = run_episode(ep, cfg) if name is None else \
            run_episode(ep, cfg, name)
    else:
        _, name, warm, ticks = key
        out = _run_ticks(_service(name, device="cpu", warm=warm), ticks,
                         marks=(ticks,))
    return out, time.perf_counter() - t0


def _to_file(t):
    """A large worker result written to a temporary .npy file (its path
    goes back through the pool instead: the pool's result thread would
    hold the main process's interpreter lock for seconds unpickling
    hundreds of MB, stalling whatever phase runs)."""
    fd, path = tempfile.mkstemp(suffix=".npy", prefix="chip_smoke_ref_")
    with os.fdopen(fd, "wb") as f:
        np.save(f, t.numpy())
    return path


def _from_file(path):
    out = torch.from_numpy(np.load(path))
    os.unlink(path)
    return out


def _cpu_worker_init():
    torch.set_num_threads(CPU_REF_THREADS)


def cpu_ref(key):
    """The worker's result for ``key``, or the run itself where no worker
    was started (a phase called alone)."""
    pending = _CPU_REFS.get(key)
    return pending.get() if pending is not None else _cpu_reference(key)


@contextlib.contextmanager
def cpu_references():
    """One spawned worker process computing every key of
    ``_cpu_ref_keys`` in turn while the card phases run; terminated and
    joined on the way out, whatever happened."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        1, initializer=_cpu_worker_init)
    try:
        for key in _cpu_ref_keys():
            _CPU_REFS[key] = pool.apply_async(_cpu_reference, (key,))
        yield
    finally:
        _CPU_REFS.clear()
        pool.terminate()
        pool.join()


def phase_device():
    log("[1] device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    assert cap == (9, 0), f"needs a Hopper card (sm_90), got {cap}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products accumulate in float32 and round once, as XLA's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}, "
        f"torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction"
        f" = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return name, smi


def phase_build():
    _build_finish(_build_start())


def _build_start():
    """Start every nvcc (one per source, at once) in a thread; returns the
    thread's future and the start time."""
    import concurrent.futures
    from repro_torch.kernels import build
    log("[2] build (started; the phases that launch no kernel of ours run "
        "beside it)")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(build.build_all)
    pool.shutdown(wait=False)
    return fut, time.perf_counter()


def _build_finish(started):
    """Wait for the build, load every library, print ptxas' lines."""
    from repro_torch.kernels import build
    fut, t0 = started
    built = fut.result()
    log(f"[2] build finished {time.perf_counter() - t0:.2f} s after it "
        f"started")
    for name, (path, secs, nvcc_log) in built.items():
        build.library(name)
        log(f"built {path.name} in {secs:.2f} s (nvcc)")
        entry = ""                 # ptxas names a kernel, then its numbers
        for line in nvcc_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {entry}: {line.strip()}")
                if "spill" in line and any(k in entry for k in NO_SPILL):
                    assert line.count(" 0 bytes spill") == 2, \
                        f"{entry} spills: {line.strip()}"
    log(f"build total {time.perf_counter() - t0:.2f} s")


def make_inputs(M, N, K, C, seed=0):
    """Seeded inputs at one shape: demand-like shares (10% dense, with an
    all-zero row), duals, selections with unselected rows."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device="cuda")

    gamma = rng.uniform(0, 0.05, (M, K)) * (rng.random((M, K)) > 0.9)
    gamma[-1] = 0.0
    g_ord = rng.uniform(0, 0.05, (M, N, K)) * (rng.random((M, N, K)) > 0.9)
    g_ord[:, 0] = 0.0                                  # a row with no demand
    sel_c = rng.random((M, C, N)) > 0.5
    sel_c[:, 0] = False                                # a candidate with none
    mask = rng.random(M) > 0.2
    mask[0] = True
    return dict(
        gamma=t(gamma), lam=t(rng.uniform(0.5, 2.0, K)),
        x=t(rng.uniform(0.0, 2.0, M)),
        w_pow=t(rng.uniform(0.5, 50.0, M)), xcap=t(rng.uniform(1.0, 30.0, M)),
        mask=t(mask, np.int32), cap=t(rng.uniform(0.2, 1.0, K)),
        g_ord=t(g_ord), sel_c=t(sel_c, np.int32),
        sel=t(rng.random((M, N)) > 0.4, np.int32),
        left=t(rng.uniform(0.0, 0.5, (M, K))),
        left_c=t(rng.uniform(0.0, 0.5, (M, C, K))))


def make_dense_inputs(M, K, seed=0):
    """The dense kernels' inputs at the production shape, drawn on the
    card from a seed (the host would take seconds): shares as in
    make_inputs, an all-zero row, duals and a grant vector."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    gamma = u(0.0, 0.05, M, K) * (u(0.0, 1.0, M, K) > 0.9)
    gamma[-1] = 0.0
    return dict(gamma=gamma, lam=u(0.5, 2.0, K), x=u(0.0, 2.0, M))


def dense_cases(d, M, K):
    """rowmax, matvec and matvec_t: (launch, twin, yardstick, compare,
    bytes, flops) each."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref

    def cmp_matvec(got, want):
        again = ba.matvec(d["gamma"], d["lam"])
        if not torch.equal(got, again):
            raise AssertionError("matvec: not bitwise from launch to launch")
        return check("matvec", got, want, False)

    return {
        "rowmax": (lambda: ba.rowmax(d["gamma"]),
                   lambda: ref.rowmax_ref(d["gamma"]),
                   lambda: torch.amax(d["gamma"], dim=-1),
                   lambda g, w: check("rowmax", g, w, True),
                   4 * (M * K + M), M * K),
        "matvec": (lambda: ba.matvec(d["gamma"], d["lam"]),
                   lambda: ref.matvec_ref(d["gamma"], d["lam"]),
                   lambda: torch.mv(d["gamma"], d["lam"]),
                   cmp_matvec, 4 * (M * K + K + M), 2 * M * K),
        "matvec_t": (lambda: ba.matvec_t(d["gamma"], d["x"]),
                     lambda: ref.matvec_t_ref(d["gamma"], d["x"]),
                     lambda: torch.mv(d["gamma"].T, d["x"]),
                     lambda g, w: check("matvec_t", g, w, False),
                     4 * (M * K + M + K), 2 * M * K),
    }


def kernel_cases(d, M, N, K, C):
    """Per kernel: (launch, twin, yardstick or None, compare, bytes, flops)."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    kmax = 2.0
    cap_safe = torch.clamp(d["cap"], min=1e-12)
    dual_args = (d["gamma"], d["lam"], d["w_pow"], d["xcap"], d["mask"],
                 d["cap"], cap_safe)
    # the sweeps' work is a divide, a min and an FMA per nonzero demand
    # entry of a selected visit: count what these inputs need
    nnz = (d["g_ord"] != 0).sum(-1).double()                   # [M, N]
    sweep_ops = int(4 * (d["sel"].double() * nnz).sum())
    sweep_ops_c = int(4 * (d["sel_c"].double() * nnz[:, None, :]).sum())

    def cmp_dual(got, want):
        xk, gk = got
        e1 = check("dual_step x", xk, want[0], False)
        gtwin = ref.dual_residual_ref(d["gamma"], xk, d["cap"], cap_safe)
        return max(e1, check("dual_step g | x", gk, gtwin, True))

    def cmp_pair(got, want):
        return max(check("boost_scan extras", got[0], want[0], True),
                   check("boost_scan leftover", got[1], want[1], True))

    return {
        **dense_cases(d, M, K),
        "dual_step": (lambda: ba.dual_step(*dual_args, 2.2),
                      lambda: ref.dual_step_ref(*dual_args, 2.2),
                      None, cmp_dual,
                      4 * (M * K + 4 * K + 4 * M), 4 * M * K + 2 * K + 3 * M),
        "boost_scan": (lambda: ba.boost_scan(d["g_ord"], d["sel"], d["left"],
                                             kmax),
                       lambda: ref.boost_scan_ref(d["g_ord"], d["sel"],
                                                  d["left"], kmax),
                       None, cmp_pair,
                       4 * (M * N * K + 2 * M * N + 2 * M * K), sweep_ops),
        "swap_eval": (lambda: ba.swap_eval(d["g_ord"], d["sel_c"],
                                           d["left_c"], kmax),
                      lambda: ref.swap_eval_ref(d["g_ord"], d["sel_c"],
                                                d["left_c"], kmax),
                      None, lambda g, w: check("swap_eval", g, w, True),
                      4 * (M * N * K + 2 * M * C * N + M * C * K),
                      sweep_ops_c),
    }


def parent_ascent(args, beta, **kw):
    """SP1 as the parent ran it on the card: one ``dual_step`` launch an
    iteration (step mode), the update in torch, the stop rule on the host
    (``ref.dual_ascent_ref`` over ``ba.dual_step``)."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    return ref.dual_ascent_ref(*args, beta, **kw, step=ba.dual_step)


def check_ascent(name, got, want):
    """Raise unless two ascents ran the same count and reached the same lam
    bit for bit; returns the count."""
    (lam, n), (lam_p, n_p) = got, want
    n, n_p = int(n), int(n_p)
    if n != n_p or not torch.equal(lam.view(torch.int32),
                                   lam_p.view(torch.int32)):
        raise AssertionError(
            f"{name}: ascent {n} iterations, per-iteration loop {n_p}; lam "
            f"max abs diff {float((lam - lam_p).abs().max()):.3e}")
    return n


def ascent_case(d, shape, M, K, floor, card):
    """dual_step's ascent mode at one shape: checked against the
    per-iteration loop (cold, 200 iterations; adaptive, 4000 or the stop
    rule), then timed per iteration with the stop rule off (tol 0),
    beside the loop's time per iteration and the launch floor."""
    from repro_torch.kernels import budget_alloc as ba
    args = (d["gamma"], d["lam"], d["w_pow"], d["xcap"], d["mask"], d["cap"],
            torch.clamp(d["cap"], min=1e-12))
    counts = []
    for adaptive, max_iters, tol in ((False, 200, 0.0), (True, 4000, 1e-6)):
        kw = dict(adaptive=adaptive, max_iters=max_iters, tol=tol)
        counts.append(check_ascent(f"dual_ascent {shape} {kw}",
                                   ba.dual_ascent(*args, 2.2, **kw),
                                   parent_ascent(args, 2.2, **kw)))
    n = 4000 if shape == "paper" else 1000
    kw = dict(adaptive=False, max_iters=n, tol=0.0)
    ms = time_ms(lambda: ba.dual_ascent(*args, 2.2, **kw), 2, 3)
    loop_n = 50
    kw_loop = dict(adaptive=False, max_iters=loop_n, tol=0.0)
    loop_ms = time_ms(lambda: parent_ascent(args, 2.2, **kw_loop), 1, 3)
    per_iter_ops = 4 * M * K + 8 * K + 4 * M
    it_bound_us = bound_ms(0, per_iter_ops)[0] * 1e3
    us = ms * 1e3 / n
    log(f"  dual_ascent {shape:6s} M={M} K={K}: cs={ba.dual_split(M, K)}; "
        f"matches the per-iteration loop (lam bitwise; iterations "
        f"{counts[0]} cold, {counts[1]} adaptive); {n} iterations in one "
        f"launch {ms:.4f} ms = {us:.4f} us/iter; per-iteration loop "
        f"{loop_ms * 1e3 / loop_n:.4f} us/iter; launch floor "
        f"{floor * 1e3:.4f} us; bound {it_bound_us:.6f} us/iter "
        f"(operations, {card})")
    return dict(ascent_us_per_iter=us, ascent_loop_us_per_iter=loop_ms * 1e3
                / loop_n, ascent_bound_us_per_iter=it_bound_us,
                ascent_cs=ba.dual_split(M, K))


def make_fleet_inputs(E, M, K, seed=0):
    """SP1 operands of E episodes of one shape, stacked, drawn on the card
    from a seed and formed as alpha_fair_waterfill forms them (c half
    dense with an all-zero row, a fifth of the analysts masked), with warm
    duals and a grant vector per episode."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    c = u(0.0, 0.1, E, M, K) * (u(0.0, 1.0, E, M, K) < 0.5)
    c[:, -1] = 0.0
    w = torch.clamp(u(0.1, 1.0, E, M) * u(0.3, 1.0, E, M), min=1e-12)
    mask = u(0.0, 1.0, E, M) > 0.2
    cap = u(0.05, 0.5, E, K)
    w_pow = torch.where(mask, w ** (1.0 - 2.2), 0.0)
    ratio = torch.where(c > 1e-12, cap[:, None] / torch.clamp(c, min=1e-12),
                        float("inf"))
    xcap = torch.amin(ratio, dim=-1)
    mask = mask & (torch.amax(c, dim=-1) > 1e-12) & torch.isfinite(xcap)
    return dict(c=c, lam=torch.ones(E, K, device="cuda"),
                lam_warm=u(0.5, 2.0, E, K), w_pow=w_pow,
                xcap=torch.where(mask, xcap, 0.0),
                mask=mask.to(torch.int32), cap=cap,
                cap_safe=torch.clamp(cap, min=1e-12), x=u(0.0, 2.0, E, M))


def fleet_kernel_cases(rows, card):
    """The lockstep fleet's batched matvec, matvec_t and dual_step ascent
    at FLEET_KERNEL_SHAPES: each against its twin and against E lone
    launches on the episodes' operands, timed beside those lone launches
    and torch.bmm (a yardstick only); adds a ``by_shape`` entry to each
    kernel's row."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    for shape, E, M, K in FLEET_KERNEL_SHAPES:
        d = make_fleet_inputs(E, M, K)
        c, lam, x = d["c"], d["lam"], d["x"]
        dims = f"E={E} M={M} K={K}"

        def lone(fn, *ts):
            return torch.stack([fn(*(t[e] for t in ts)) for e in range(E)])

        y = ba.matvec(c, lam)
        if not torch.equal(y, lone(ba.matvec, c, lam)):
            raise AssertionError(f"matvec {shape}: not bitwise E lone "
                                 "launches")
        errs = {"matvec": check("matvec " + shape, y,
                                ref.matvec_ref(c, lam), False)}
        load = ba.matvec_t(c, x)
        if not torch.equal(load, lone(ba.matvec_t, c, x)):
            raise AssertionError(f"matvec_t {shape}: not bitwise E lone "
                                 "launches")
        errs["matvec_t"] = check("matvec_t " + shape, load,
                                 ref.matvec_t_ref(c, x), True)
        dense = {
            "matvec": (lambda: ba.matvec(c, lam),
                       lambda: lone(ba.matvec, c, lam),
                       lambda: ref.matvec_ref(c, lam),
                       lambda: torch.bmm(c, lam[..., None]),
                       4 * (E * M * K + E * K + E * M)),
            "matvec_t": (lambda: ba.matvec_t(c, x),
                         lambda: lone(ba.matvec_t, c, x),
                         lambda: ref.matvec_t_ref(c, x),
                         lambda: torch.bmm(x[:, None, :], c),
                         4 * (E * M * K + E * M + E * K)),
        }
        for name, (run, lones, twin, lib, nbytes) in dense.items():
            ms, lone_ms = time_ms(run, 20), time_ms(lones, 3)
            plain, lib_ms = time_ms(twin, 3), time_ms(lib, 20)
            b, by = bound_ms(nbytes, 2 * E * M * K)
            log(f"  {name:10s} {shape} {dims}: one launch bitwise {E} lone "
                f"launches, max_abs_err {errs[name]:.3e} against the twin; "
                f"kernel {ms:.4f} ms, {E} lone launches {lone_ms:.4f} ms, "
                f"twin {plain:.4f} ms, torch.bmm {lib_ms:.4f} ms, bound "
                f"{b:.6f} ms ({by}, {card})")
            r = rows[name]
            r["max_abs_err"] = max(r["max_abs_err"], errs[name])
            r["by_shape"][shape] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                        bound_by=by, library_ms=lib_ms,
                                        lone_ms=lone_ms, shape=dims)
        # the ascent: cold to a fixed count, adaptive warm to its stop
        # rule (capped where E lone launches would take seconds)
        ops = (c, lam, d["w_pow"], d["xcap"], d["mask"], d["cap"],
               d["cap_safe"])
        warm_ops = (c, d["lam_warm"]) + ops[2:]
        cap_iters = 4000 if E * M * K <= 200_000 else 1000
        counts = []
        for args, kw in ((ops, dict(adaptive=False, max_iters=200, tol=0.0)),
                         (warm_ops, dict(adaptive=True, max_iters=cap_iters,
                                         tol=1e-6))):
            lam_b, it_b = ba.dual_ascent(*args, 2.2, **kw)
            for e in range(E):
                counts.append(check_ascent(
                    f"fleet dual_ascent {shape} episode {e} {kw}",
                    (lam_b[e], it_b[e]),
                    ba.dual_ascent(*(t[e] for t in args), 2.2, **kw)))
        n = 200
        kw = dict(adaptive=False, max_iters=n, tol=0.0)
        ms = time_ms(lambda: ba.dual_ascent(*ops, 2.2, **kw), 2, 3)
        lone_ms = time_ms(lambda: [ba.dual_ascent(*(t[e] for t in ops), 2.2,
                                                  **kw) for e in range(E)],
                          1, 3)
        plain = time_ms(lambda: ref.dual_ascent_ref(*ops, 2.2, **kw), 1, 1)
        waves = ba.dual_waves(E, M, K)
        b, by = bound_ms(0, n * E * (4 * M * K + 8 * K + 4 * M))
        warm_counts = counts[E:]
        log(f"  dual_step  {shape} {dims} ascent: cs={ba.dual_split(M, K)}, "
            f"{E} clusters in {waves} wave(s); each episode's lam bitwise "
            f"its lone launch's, counts equal (cold {n}; adaptive warm "
            f"{min(warm_counts)}-{max(warm_counts)}); {n} iterations of "
            f"all {E} in one launch {ms:.4f} ms, {E} lone launches "
            f"{lone_ms:.4f} ms, the twin's loop {plain:.4f} ms; bound "
            f"{b:.6f} ms ({by}, {card})")
        rows["dual_step"]["by_shape"][shape] = dict(
            ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
            lone_ms=lone_ms, waves=waves, iterations=n, shape=dims,
            warm_iterations=[min(warm_counts), max(warm_counts)])
        del d, ops, warm_ops
        torch.cuda.empty_cache()


class AscentRecorder:
    """Within the block, every ``hotpath.dual_ascent`` call keeps a copy of
    its operands and its result, so each SP1 solve of a run can be
    replayed through the per-iteration loop afterwards; and every
    ``alpha_fair_waterfill`` of the scheduler runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside an
    SP1 solve raises."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def __call__(self):
        from repro_torch.core import hotpath
        from repro_torch.core import scheduler as sch
        orig_asc, orig_wf = hotpath.dual_ascent, sch.alpha_fair_waterfill

        def asc(*args, **kw):
            out = orig_asc(*args, **kw)
            self.calls.append(([a.clone() if torch.is_tensor(a) else a
                                for a in args], kw, out))
            return out

        def wf(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig_wf(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        hotpath.dual_ascent, sch.alpha_fair_waterfill = asc, wf
        try:
            yield self
        finally:
            hotpath.dual_ascent, sch.alpha_fair_waterfill = orig_asc, orig_wf

    def replay(self, label):
        """Each recorded solve against the per-iteration loop on the same
        operands, episode by episode where the solve had a leading fleet
        axis: equal counts and lam bitwise.  Of the solves that ran to
        ``max_iters`` only the first is replayed (the others count as the
        launch's own count).  Returns the counts."""
        counts, capped = [], False
        for r, (args, kw, out) in enumerate(self.calls):
            c, lam, w_pow, beta, xcap, mask, cap, cap_safe = args
            kw = dict(kw)
            assert not kw.pop("block_axis").sharded    # the one-device loop
            ops = (c, lam, w_pow, xcap, mask, cap, cap_safe)
            if c.dim() == 2:
                solves = [(ops, out)]
            else:
                solves = [(tuple(t[e] for t in ops), (out[0][e], out[1][e]))
                          for e in range(c.shape[0])]
            for e, (one, got) in enumerate(solves):
                if int(got[1]) == kw["max_iters"]:
                    if capped:
                        counts.append(int(got[1]))
                        continue
                    capped = True
                counts.append(check_ascent(f"{label} solve {r}.{e}", got,
                                           parent_ascent(one, beta, **kw)))
        return counts


def phase_kernels(card):
    log("[3] kernels against their twins on the card")
    from repro_torch.kernels import budget_alloc as ba
    floor = time_ms(lambda: torch.cuda._sleep(1), 100)
    log(f"  launch floor (torch.cuda._sleep(1) back to back) {floor:.4f} ms "
        f"({card})")
    rows = {}

    def measure(shape, dims, cases, slow=(), plain_reps=5):
        for name, (run, twin, lib, cmp, nbytes, flops) in cases.items():
            got = run()
            torch.cuda.synchronize()
            err = cmp(got, twin())
            grid = geo = None
            if name in ("rowmax", "matvec"):
                grid = dict(cs=ba.LAST_GRID[name][0],
                            blocks=ba.LAST_GRID[name][0] * ba.LAST_GRID[name][1])
            elif name in ("boost_scan", "swap_eval"):
                grid = dict(zip(("cs", "T", "blocks"),
                                ba.LAST_GRID["boost_sweep"]))
            if grid is not None:
                geo = " ".join(f"{k}={v}" for k, v in grid.items()) + "  "
            ms = time_ms(run, 3 if name in slow else 20)
            plain = time_ms(twin, 1 if name in slow else plain_reps)
            lib_ms = time_ms(lib, 20) if lib is not None else None
            b, by = bound_ms(nbytes, flops)
            log(f"  {name:10s} {shape:6s} {dims}: {geo or ''}max_abs_err {err:.3e}"
                f"  kernel {ms:.4f} ms  twin {plain:.4f} ms  yardstick "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
                f"{b:.6f} ms ({by}, {card})")
            r = rows.setdefault(name, {"max_abs_err": 0.0, "by_shape": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            nums = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=lib_ms, shape=dims)
            if grid is not None:
                nums.update(grid)
            r["by_shape"][shape] = nums
            if shape == "large":     # the JSON line's top level: large round
                r.update(nums)

    for shape, M, N, K, C in SHAPES:
        d = make_inputs(M, N, K, C)
        measure(shape, f"M={M} N={N} K={K} C={C}", kernel_cases(d, M, N, K, C),
                slow=() if shape == "paper" else ("boost_scan", "swap_eval"))
        rows["dual_step"]["by_shape"][shape].update(
            ascent_case(d, shape, M, K, floor, card))
        if shape == "large":
            rows["dual_step"].update(rows["dual_step"]["by_shape"][shape])
        del d
    for shape, M, N, K, C in SWEEP_SHAPES:
        d = make_inputs(M, N, K, C)
        cases = kernel_cases(d, M, N, K, C)
        measure(shape, f"M={M} N={N} K={K} C={C}",
                {k: cases[k] for k in ("boost_scan", "swap_eval")},
                slow=("boost_scan", "swap_eval"))
        del d
    shape, M, K = PROD
    d = make_dense_inputs(M, K)
    measure(shape, f"M={M} K={K}", dense_cases(d, M, K), plain_reps=1)
    del d
    torch.cuda.empty_cache()
    fleet_kernel_cases(rows, card)
    ba.reset_launches()
    return rows


def phase_episode():
    log("[4] paper episode (SimConfig(seed=0)) through run_episode")
    from repro_torch.core import (SchedulerConfig, SimConfig,
                                  generate_episode, run_episode)
    from repro_torch.kernels import budget_alloc as ba
    sim = SimConfig(seed=0)
    ep_gpu = generate_episode(sim, device="cuda")
    launches = None
    R = sim.n_rounds
    for warm in (False, True):
        cfg = SchedulerConfig(sp1_warm_start=warm)
        torch.cuda.synchronize()
        ba.reset_launches()
        rec = AscentRecorder()
        with rec():
            t0 = time.perf_counter()
            out = run_episode(ep_gpu, cfg)      # validate: conservation
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(ba.LAUNCHES)
        if launches is None:
            launches = counts
        assert all(v > 0 for v in counts.values()), \
            f"a kernel never launched on the main path: {counts}"
        # one SP1 solve a round, each one dual_step launch (ascent mode)
        assert len(rec.calls) == R and counts["dual_step"] == R, \
            (len(rec.calls), counts)
        loop_iters = rec.replay(f"{'warm' if warm else 'cold'} episode")
        assert float(out["overdraw"].max()) <= 1e-4
        assert float(out["conservation_gap"].max()) <= 1e-4
        ref, _ = cpu_ref(("episode", (("sp1_warm_start", warm),), None))
        g = {k: v.cpu() for k, v in out.items()}
        assert g["sp1_iters"].tolist() == loop_iters, \
            (g["sp1_iters"].tolist(), loop_iters)
        assert torch.equal(g["n_allocated"], ref["n_allocated"]), \
            (g["n_allocated"], ref["n_allocated"])
        assert torch.equal(g["selected"], ref["selected"])
        for k in ("round_efficiency", "round_fairness", "leftover"):
            assert torch.allclose(g[k], ref[k], rtol=1e-5, atol=0.0), \
                (k, g[k], ref[k])
        iters = g["sp1_iters"].tolist()
        log(f"  {'warm' if warm else 'cold'} SP1: {R / wall:.2f} rounds/s "
            f"({wall:.3f} s for {R} rounds), SP1 iters per round {iters} "
            f"(CPU run: {ref['sp1_iters'].tolist()}; the per-iteration loop "
            f"on the card, the first capped solve and every other: equal, "
            f"lam bitwise), n_allocated "
            f"{g['n_allocated'].tolist()}, launches {counts}, no host sync "
            f"inside SP1")
    return launches


def _round(M, K, N, seed=0, cap=1.0):
    """The seeded round of benchmarks/bench_scheduler_scale.py:_round."""
    from repro_torch.core import RoundInputs
    rng = np.random.default_rng(seed)
    demand = (rng.uniform(0, 0.05, (M, N, K)) *
              (rng.random((M, N, K)) > 0.9)).astype(np.float32)
    return RoundInputs.from_numpy(
        demand=demand, active=demand.sum(-1) > 0,
        arrival=np.zeros((M, N), np.float32),
        loss=np.ones((M, N), np.float32),
        capacity=np.full((K,), cap, np.float32),
        budget_total=np.ones(K, np.float32), now=0.0, device="cuda")


def phase_large_round():
    """The bench's round (capacity 1.0: every block 2.5x oversubscribed, so
    no pipeline fits its analyst's SP1 share and nothing is granted -- as
    in ``repro``) and the same round at capacity 3.0, where SP2 packs."""
    log("[5] one round at M=32, N=32, K=16384, refine on")
    from repro_torch.core import SchedulerConfig, schedule_round
    from repro_torch.kernels import budget_alloc as ba
    M, N, K = 32, 32, 16384
    cfg = SchedulerConfig(beta=2.2, refine=True)
    counts = None
    for cap in (1.0, 3.0):
        rnd = _round(M, K, N, cap=cap)
        schedule_round(rnd, cfg)               # warm-up (allocator)
        torch.cuda.synchronize()
        ba.reset_launches()
        rec = AscentRecorder()
        with rec():
            t0 = time.perf_counter()
            res = schedule_round(rnd, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = dict(ba.LAUNCHES)
        counts = counts or launched
        assert len(rec.calls) == 1 and launched["dual_step"] == 1, \
            (len(rec.calls), launched)
        loop_iters = rec.replay(f"large round capacity {cap}")
        assert loop_iters == [int(res.sp1_iters)], loop_iters
        c = rnd.capacity
        assert float((res.consumed - c).max()) <= 1e-4, "overdraw"
        assert float((c - res.consumed - res.leftover).abs().max()) <= 1e-4
        assert not bool((res.selected & ~rnd.active).any())
        x = res.x_pipeline
        assert bool(torch.all(torch.where(res.selected, x >= 1.0, x == 0.0)))
        for f in ("efficiency", "fairness", "platform", "jain"):
            assert bool(torch.isfinite(getattr(res, f))), f
        assert cap == 1.0 or int(res.n_allocated) > 0
        n_ref, eff_ref, sel_ref = REPRO_LARGE[cap]
        assert int(res.n_allocated) == n_ref, (int(res.n_allocated), n_ref)
        assert torch.nonzero(res.selected).tolist() == sel_ref, \
            torch.nonzero(res.selected).tolist()
        if eff_ref is not None:
            assert abs(float(res.efficiency) - eff_ref) <= \
                REPRO_EFF_RTOL * eff_ref, (float(res.efficiency), eff_ref)
        assert ba.LAUNCHES["swap_eval"] == 1 and \
            ba.LAST_GRID["swap_eval"] == (M, 256), \
            (ba.LAUNCHES, ba.LAST_GRID)
        log(f"  capacity {cap}: wall {wall:.3f} s, n_allocated "
            f"{int(res.n_allocated)}, SP1 iters {int(res.sp1_iters)} in one "
            f"launch (the per-iteration loop: equal, lam bitwise), "
            f"efficiency {float(res.efficiency):.7g} (repro: n_allocated, "
            f"efficiency and selected pairs equal), swap sweep grid "
            f"(analysts, candidates) {ba.LAST_GRID['swap_eval']} at (cs, T) "
            f"{ba.sweep_split(*ba.LAST_GRID['swap_eval'], K)}, launches "
            f"{launched}")
    return counts


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _stage_spans(fn):
    """Run ``fn`` with SP1 and SP2 wrapped in synchronised host-clock spans;
    returns ``{"sp1": s, "sp2": s, "iters": n}``."""
    from repro_torch.core import scheduler as sch
    spans = {"sp1": 0.0, "sp2": 0.0, "iters": 0}
    orig = {"sp1": sch.alpha_fair_waterfill, "sp2": sch.pack_all}

    def timed(stage):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[stage](*a, **k)
            torch.cuda.synchronize()
            spans[stage] += time.perf_counter() - t0
            if stage == "sp1":
                spans["iters"] += int(out.iters)
            return out
        return run

    sch.alpha_fair_waterfill, sch.pack_all = timed("sp1"), timed("sp2")
    try:
        fn()
    finally:
        sch.alpha_fair_waterfill, sch.pack_all = orig["sp1"], orig["sp2"]
    return spans


def _kernel_rows(prof):
    """``[(kernel, ms), ...]`` largest first, from a finished profiler: the
    card's activities (kernels, copies, sets) summed by name over its raw
    events (``key_averages`` would first build every host event, tens of
    seconds of host work over a long trace)."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            rows[e.name()] = rows.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return sorted(rows.items(), key=lambda r: -r[1])


def _device_kernels(fn):
    """Kernel time on the card during ``fn`` from ``torch.profiler``:
    ``(total ms, [(name, ms), ...] largest first, wall ms)``, the wall on
    the host clock between synchronisations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    return sum(r[1] for r in rows), rows, wall


def _stage_device_ms(fn, targets):
    """Card time of the kernels launched inside each ``(module, attribute,
    label)`` of ``targets`` while ``fn()`` runs: each target runs inside a
    ``torch.profiler.record_function(label)`` range, and a range's device
    time totals its kernels'.  Returns ``{label: ms}``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    orig = {label: getattr(mod, attr) for mod, attr, label in targets}

    def labelled(label):
        def run(*a, **k):
            with record_function(label):
                return orig[label](*a, **k)
        return run

    for mod, attr, label in targets:
        setattr(mod, attr, labelled(label))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, label in targets:
            setattr(mod, attr, orig[label])
    return {e.key: getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)) / 1e3
            for e in prof.key_averages() if e.key in orig}


def _host_ops(fn):
    """Host side of ``fn`` from ``torch.profiler`` (CPU activity only):
    ``(wall ms, ms inside top-level PyTorch ops, top-level ops,
    [(op, self ms), ...] largest first)``.  The wall less the time inside
    ops is the Python between them, the ctypes kernel calls included."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    top = [e for e in prof.events() if e.cpu_parent is None]
    rows = sorted(((e.key, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    return wall, sum(e.cpu_time_total for e in top) / 1e3, len(top), rows


def _op_counts(fn):
    """Calls of each event (ops, CUDA runtime calls, kernels) during
    ``fn`` from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()}


def _log_host_ops(decode, steps):
    """Print the host profile (``_host_ops``) of ``decode()``, ``steps``
    decode steps, per step."""
    wall, in_ops, n_ops, rows = _host_ops(decode)
    log(f"  host profile of {steps} decode steps: wall {wall / steps:.3f} "
        f"ms/step, inside PyTorch ops {in_ops / steps:.3f} ms/step in "
        f"{n_ops / steps:.1f} top-level ops per step, outside them "
        f"{(wall - in_ops) / steps:.3f} ms/step; top ops by self time (ms "
        f"per step): "
        + ", ".join(f"{k[:40]} {ms / steps:.3f}" for k, ms in rows[:8]))


@contextlib.contextmanager
def _timed_spans(targets, spans):
    """Within the block, each ``(module, attribute, key)`` of ``targets``
    runs inside a synchronised host-clock span added to ``spans[key]``
    (seconds)."""
    orig = {key: getattr(mod, attr) for mod, attr, key in targets}

    def timed(key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[key](*a, **k)
            torch.cuda.synchronize()
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    for mod, attr, key in targets:
        setattr(mod, attr, timed(key))
    try:
        yield
    finally:
        for mod, attr, key in targets:
            setattr(mod, attr, orig[key])


def phase_trace():
    """Where a round's time goes: untraced wall, then SP1/SP2 spans, then
    (for the shorter runs) the card's kernel time from the profiler."""
    log("[6] where the time goes (separate traced runs)")
    from repro_torch.core import (SchedulerConfig, SimConfig,
                                  generate_episode, run_episode,
                                  schedule_round)
    from repro_torch.core import hotpath
    from repro_torch.core import scheduler as sch
    from repro_torch.core import swap
    ep = generate_episode(SimConfig(seed=0), device="cuda")
    big = _round(32, 16384, 32, cap=3.0)
    cases = [
        ("paper episode cold", 10,
         lambda: run_episode(ep, SchedulerConfig()), False),
        ("paper episode warm", 10,
         lambda: run_episode(ep, SchedulerConfig(sp1_warm_start=True)),
         True),
        ("M=32 N=32 K=16384 capacity 3.0", 1,
         lambda: schedule_round(big, SchedulerConfig()), True),
    ]
    for label, rounds, fn, profiled in cases:
        fn()                                   # warm-up (allocator)
        wall = _wall(fn)
        sp = _stage_spans(fn)
        line = (f"  {label}: {wall / rounds * 1e3:.2f} ms/round untraced; "
                f"traced SP1 {sp['sp1'] / rounds * 1e3:.2f} ms/round "
                f"({sp['iters']} iters, {sp['sp1'] / max(sp['iters'], 1) * 1e3:.4f}"
                f" ms/iter), SP2 {sp['sp2'] / rounds * 1e3:.2f} ms/round")
        if profiled:
            dev_ms, rows, _ = _device_kernels(fn)
            top = ", ".join(f"{n[:40]} {ms:.2f}" for n, ms in rows[:5])
            busy = (f"{dev_ms / (wall * 1e3):.4f}" if dev_ms > 0
                    else "not measured (profiler saw no device time)")
            sweep = sum(ms for n, ms in rows if "sweep_tile_kernel" in n)
            line += (f"; card busy {dev_ms / rounds:.2f} ms/round, busy "
                     f"share {busy}; top kernels (ms): {top}; boost sweep "
                     f"(sweep_tile_kernel) {sweep / rounds:.4f} ms/round, "
                     f"{sweep / dev_ms if dev_ms > 0 else 0.0:.4f} of card "
                     f"time")
        log(line)
    # SP2's card time in the M=32 round by stage: the candidates' selection
    # sums (swap._selection_sums, elementwise), the two sweeps, the rest
    label, _, fn, _ = cases[-1]
    ms = _stage_device_ms(fn, [(sch, "pack_all", "sp2"),
                               (swap, "_selection_sums", "selection sums"),
                               (hotpath, "swap_eval", "swap_eval"),
                               (hotpath, "boost_scan", "boost_scan")])
    rest = ms["sp2"] - sum(v for k, v in ms.items() if k != "sp2")
    log(f"  {label}: SP2 card time {ms['sp2']:.3f} ms, of which "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items() if k != "sp2")
        + f", the rest {rest:.3f} (torch.profiler record_function ranges)")


def _dp_inputs(B, P, seed=0):
    """Gradient-like rows on the card, from a seeded torch.Generator: row
    scales 0.01-2, and row 1 (where B > 1) all zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((B, P), generator=gen, device="cuda")
    g *= torch.rand((B, 1), generator=gen, device="cuda") * 1.99 + 0.01
    if B > 1:
        g[1] = 0.0
    return g


def phase_dp_kernels(card):
    log("[7] DP clip kernels against their twins on the card")
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.kernels import ref
    rows = {}
    for shape, B, P in DP_SHAPES:
        g = _dp_inputs(B, P)
        sq, sq2 = dp.rownorms(g), dp.rownorms(g)
        s = dp.clip_scales(torch.sqrt(sq), 0.05)
        acc, acc2 = dp.clip_accumulate(g, s), dp.clip_accumulate(g, s)
        sq_twin = ref.rownorms_ref(g)
        acc_twin = ref.clip_accumulate_ref(g, s)
        torch.cuda.synchronize()
        assert torch.equal(sq, sq2) and torch.equal(acc, acc2), \
            f"{shape}: a kernel is not bitwise stable from launch to launch"
        assert B == 1 or (float(sq[1]) == 0.0 and float(s[1]) == 1.0)
        rel = float(((sq.double() - sq_twin.double()).abs()
                     / sq_twin.double().clamp(min=1e-30)).max())
        assert rel <= NORM_RTOL, f"rownorms {shape}: rel err {rel:.3e}"
        errs = {"rownorms": float((sq - sq_twin).abs().max()),
                "clip_accumulate": check("clip_accumulate " + shape, acc,
                                         acc_twin, True)}
        line = (f"  B={B} P={P} ({shape}): rownorms rel err {rel:.3e} "
                f"(max abs {errs['rownorms']:.3e}), clip_accumulate "
                f"bitwise, both stable")
        cases = {
            "rownorms": (lambda: dp.rownorms(g), lambda: ref.rownorms_ref(g),
                         lambda: torch.linalg.vector_norm(g, dim=1) ** 2,
                         4 * (B * P + B), 2 * B * P),
            "clip_accumulate": (lambda: dp.clip_accumulate(g, s),
                                lambda: ref.clip_accumulate_ref(g, s),
                                lambda: torch.mv(g.T, s),
                                4 * (B * P + B + P), 2 * B * P)}
        for name, (run, twin, lib, nbytes, flops) in cases.items():
            r = rows.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], errs[name])
            if P != P_FLAAS or B == 1:
                continue
            ms, plain, lib_ms = time_ms(run, 10), time_ms(twin, 1, 3), \
                time_ms(lib, 10)
            b, by = bound_ms(nbytes, flops)
            line += (f"\n    {name:15s} kernel {ms:.4f} ms  twin {plain:.4f} "
                     f"ms  yardstick {lib_ms:.4f} ms  bound {b:.4f} ms "
                     f"({by}, {card})")
            if shape == "e2e":     # the JSON line reports the e2e shape
                r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=lib_ms, shape=f"B={B} P={P}")
        log(line)
        del g, sq_twin, acc_twin
        torch.cuda.empty_cache()
    dp.reset_launches()
    return rows


def _fl_data(n_dev, vocab, seq, device, seed=0):
    """Per-device loaders of one seeded [2, seq] token batch each."""
    out = {}
    for d in range(n_dev):
        t = np.random.default_rng(seed + d).integers(
            0, vocab, (2, seq + 1)).astype(np.int32)
        t = torch.as_tensor(t, device=device)
        out[d] = (lambda t=t: [{"tokens": t[:, :-1], "labels": t[:, 1:]}])
    return out


def phase_fl_round():
    log("[8] one DP-FedAvg round of flaas-100m (full width, 2 layers), "
        "card vs CPU")
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.models import Transformer
    cfg, host = _fl_model()
    start = host.flat
    card = Transformer(cfg, device="cuda")
    with torch.no_grad():
        card.flat.copy_(host.flat)
    dp.reset_launches()
    m_card, t_card = _fl_round_on(card, cfg, "cuda")
    assert dp.LAUNCHES == {"rownorms": 1, "clip_accumulate": 1}, dp.LAUNCHES
    (m_host, host_flat), t_host = cpu_ref(("fl_round",))
    assert m_card == m_host, (m_card, m_host)
    got = card.flat.cpu().double()
    want = _from_file(host_flat).double()
    delta = float((want - start.double()).abs().max())
    diff = (got - want).abs()
    ulp = 2.0 ** -23 * want.abs().clamp(min=2.0 ** -126)
    ok = bool(torch.all(diff <= RTOL_FL * delta + ulp))
    log(f"  P={card.flat.numel()}, cohort {m_card['cohort']}, kept "
        f"{m_card['kept']}, stragglers {m_card['stragglers_dropped']}; "
        f"new params: max |card - CPU| {float(diff.max()):.3e} (at most "
        f"{float((diff / ulp).max()):.2f} ulp of the parameter; "
        f"{int((diff > 0).sum())} of {diff.numel()} differ), max |delta| "
        f"{delta:.3e}; bound {RTOL_FL} of max |delta| + one ulp; card "
        f"{t_card:.2f} s, CPU {t_host:.2f} s (the CPU worker)")
    assert ok, "card and CPU rounds disagree"


def phase_fl_e2e():
    log(f"[9] end-to-end FL loop on the card (flaas-100m, defaults, "
        f"{FL_ROUNDS} rounds)")
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch import fl_e2e
    from repro_torch.privacy import RdpAccountant

    def show(r):
        g = ", ".join(f"{tuple(x['pipeline'])}: grant {x['grant']:.6f} "
                      f"sigma {x['sigma']:.4f}" for x in r["granted"])
        log(f"  round {r['round']:2d} allocated={r['allocated']} "
            f"eff={r['efficiency']:.4f} live_blocks={r['live_blocks']} "
            f"loss={r['mean_pipeline_loss']:.4f} wall {r['wall_s']:.3f} s "
            f"(train {r['train_s']:.3f} s); {g}")
    torch.cuda.synchronize()
    dp.reset_launches()
    t0 = time.perf_counter()
    out = fl_e2e.run(rounds=FL_ROUNDS, device="cuda", log=show)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dp.LAUNCHES)
    recs = out["records"]
    n_rounds = sum(len(r["granted"]) for r in recs)
    cfg = out["cfg"]
    assert (cfg.name, cfg.n_layers, cfg.d_model) == ("flaas-100m", 12, 768)
    assert launches == {"rownorms": n_rounds, "clip_accumulate": n_rounds}, \
        (launches, n_rounds)
    assert n_rounds > 0
    ledger = out["ledger"]
    for b in range(len(ledger)):
        blk = ledger.block(b)
        assert blk.consumed <= blk.budget + 1e-6, f"block {b} overdrawn"
    fresh = RdpAccountant(alpha_star=8.0)
    for r in recs:
        assert math.isfinite(r["mean_pipeline_loss"]), r
        for x in r["granted"]:
            assert x["sigma"] == fresh.sigma_for_grant(x["grant"], 1), x
    for p in out["pipelines"].values():
        assert all(math.isfinite(v) for v in p["losses"])
    eps, alpha = out["pipelines"][(0, 0)]["acc"].certify(1e-5)
    assert math.isfinite(eps)
    dry = fl_e2e.run(rounds=FL_ROUNDS, device="cpu", train=False)
    for a, b in zip(recs, dry["records"]):
        assert a["selected"] == b["selected"], (a["round"], a, b)
        assert a["allocated"] == b["allocated"]
        assert [x["pipeline"] for x in a["granted"]] == \
            [x["pipeline"] for x in b["granted"]]
    p00 = out["pipelines"][(0, 0)]["losses"]
    log(f"  {len(recs)} rounds, {n_rounds} fl_rounds in {wall:.2f} s; "
        f"launches {launches}; pipeline (0,0) losses {p00[:2]} -> "
        f"{p00[-2:]}; certified ({eps:.3f}, 1e-5)-DP at alpha {alpha}; "
        f"selections equal to the scheduler-only CPU run; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_fl_trace():
    """Per-round spans of the FL path (synchronised host-clock spans) and
    the card's busy share over one round traced by torch.profiler."""
    log("[10] where the FL path's time goes (flaas-100m, 2 rounds)")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch import fl_e2e
    from repro_torch.training import fedavg
    spans = {}
    targets = [(fl_e2e, "schedule_round", "scheduler"),
               (fedavg, "client_update", "clients"),
               (fedavg, "aggregate", "aggregate"),
               (fedavg, "add_noise", "noise"),
               (dp, "rownorms", "rownorms"),
               (dp, "clip_accumulate", "clip_accumulate")]
    prof = profile(activities=[ProfilerActivity.CUDA])
    traced = {}

    def each_round(r):
        line = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in spans.items())
        log(f"  round {r['round']}: wall {r['wall_s'] * 1e3:.2f} ms; spans "
            f"(ms, aggregate includes noise and the kernels): {line}")
        spans.clear()
        if r["round"] == 0:
            prof.start()
        elif r["round"] == 1:
            torch.cuda.synchronize()
            prof.stop()
            traced["wall_ms"] = r["wall_s"] * 1e3

    with _timed_spans(targets, spans):
        fl_e2e.run(rounds=2, device="cuda", log=each_round)
    rows = _kernel_rows(prof)
    dev_ms = sum(r[1] for r in rows)
    top = ", ".join(f"{n[:40]} {ms:.2f}" for n, ms in rows[:6])
    busy = (f"{dev_ms / traced['wall_ms']:.4f}" if dev_ms > 0
            else "not measured (profiler saw no device time)")
    log(f"  traced round 1 (spans on): card busy {dev_ms:.2f} ms of "
        f"{traced['wall_ms']:.2f} ms wall, busy share {busy}; top kernels "
        f"(ms): {top}")


def _att_check(name, got, again, want) -> float:
    """Raise unless the kernel is bitwise stable and within rtol = atol =
    ATT_TOL of its twin; return the max absolute error."""
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: not bitwise stable from launch to "
                             "launch")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    if not bool(torch.all(diff <= ATT_TOL + ATT_TOL * want.double().abs())):
        raise AssertionError(f"{name}: kernel disagrees with its twin (max "
                             f"abs err {err:.3e})")
    return err


def _bf16_ulp(x):
    """One bfloat16 ulp at each element of ``x`` (8 significant bits)."""
    a = x.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _att_check_bf16(name, got, again, want) -> float:
    """Raise unless the bfloat16 kernel is bitwise stable and every output
    within one bfloat16 ulp of its twin's (fed the same bfloat16 inputs),
    plus ATT_TOL (1 + |want|): the float32 sums before the one rounding
    differ in order.  Returns the max absolute error."""
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: not bitwise stable from launch to "
                             "launch")
    assert got.dtype == want.dtype == torch.bfloat16, (got.dtype, want.dtype)
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    bound = _bf16_ulp(want) + ATT_TOL * (1 + want.double().abs())
    if not bool(torch.all(diff <= bound)):
        raise AssertionError(f"{name}: kernel disagrees with its twin (max "
                             f"abs err {err:.3e})")
    return err


def _pairs(S, causal, window) -> int:
    """(query, key) pairs the masks keep."""
    q = np.arange(S, dtype=np.int64)
    hi = q + 1 if causal else np.full(S, S, np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    return int((hi - lo).sum())


def _repeat_kv(x, G):
    """[B, L, KH, dh] -> [B, KH*G, L, dh] (SDPA's layout, kv repeated)."""
    return x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()


def _attention_cases(card, heads, flash_cases, decode_cases, rows, top=(),
                     dtype=torch.float32):
    """Both attention kernels against their twins at ``heads`` (query
    heads, kv heads, dh) on the given cases, with times; each case's
    numbers go to ``rows[kernel]["by_shape"][label]``, and those of the
    labels in ``top`` to ``rows[kernel]`` as well.  In ``dtype`` bfloat16
    the inputs are float32 draws rounded, the check one bfloat16 ulp
    (``_att_check_bf16``), the bound's bytes two a value and its
    operations at the bfloat16 tensor-core peak, SDPA fed bfloat16 too."""
    bf16 = dtype == torch.bfloat16
    att_check = _att_check_bf16 if bf16 else _att_check
    esize, peak = (2, BF16_FLOP_PER_S) if bf16 else (4, FP32_FLOP_PER_S)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KH, dh = heads
    G = H // KH
    gen = torch.Generator(device="cuda").manual_seed(0)

    def record(kname, label, shape, err, run, twin, lib, nbytes, flops,
               reps):
        ms = time_ms(run, reps)
        plain = time_ms(twin, max(1, reps // 10), 3)
        lib_ms = time_ms(lib, reps)
        b, by = bound_ms(nbytes, flops, peak)
        log(f"  {kname:16s} {shape}: max_abs_err {err:.3e}  kernel "
            f"{ms:.4f} ms  twin {plain:.4f} ms  sdpa (kv repeated) "
            f"{lib_ms:.4f} ms  bound {b:.6f} ms ({by}, {card})")
        r = rows.setdefault(kname, {"max_abs_err": 0.0, "by_shape": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nums = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                    library_ms=lib_ms, shape=shape)
        r["by_shape"][label] = nums
        if label in top:                  # the JSON line's shape
            r.update(nums)

    for label, B, S, causal, window, *cross in flash_cases:
        Skv = cross[0] if cross else S        # keys: S, or a memory's rows
        q = torch.randn((B, S, H, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KH, dh), generator=gen, device="cuda").to(
            dtype)
        v = torch.randn((B, Skv, KH, dh), generator=gen, device="cuda").to(
            dtype)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        again = fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        shape = (f"H/KH/dh={H}/{KH}/{dh} B={B} S={S}"
                 f"{f' Skv={Skv}' if cross else ''} causal={causal} "
                 f"window={window}{' bf16' if bf16 else ''} ({label})")
        err = att_check("flash_attention " + shape, got, again, want)
        log(f"  flash_attention  {shape}: launched "
            f"{fa.LAST_ENTRY['flash_attention']}, "
            f"{H * B * -(-S // fa.BQ)} blocks of {fa.BQ} query rows")
        del want
        qt = q.transpose(1, 2).contiguous()
        kr, vr = _repeat_kv(k, G), _repeat_kv(v, G)
        mask = None
        if window is not None:
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] > pos[:, None] - window
            if causal:
                mask &= pos[None, :] <= pos[:, None]
        lib = (lambda: sdpa(qt, kr, vr, attn_mask=mask)) if mask is not None \
            else (lambda: sdpa(qt, kr, vr, is_causal=causal))
        pairs = _pairs(S, causal, window) if Skv == S else S * Skv
        record("flash_attention", label, shape, err,
               lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window),
               lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window),
               lib, esize * (2 * B * S * H * dh + 2 * B * Skv * KH * dh),
               4 * dh * pairs * B * H, 20)
        del q, k, v, qt, kr, vr
        torch.cuda.empty_cache()

    for label, B, Lc, n in decode_cases:
        q = torch.randn((B, H, dh), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Lc, KH, dh), generator=gen, device="cuda").to(
            dtype)
        v = torch.randn((B, Lc, KH, dh), generator=gen, device="cuda").to(
            dtype)
        got = da.decode_attention_cuda(q, k, v, n)
        again = da.decode_attention_cuda(q, k, v, n)
        want = ref.decode_attention_ref(q, k, v, n)
        shape = (f"H/KH/dh={H}/{KH}/{dh} B={B} Lc={Lc} cache_len={n}"
                 f"{' bf16' if bf16 else ''} ({label})")
        err = att_check("decode_attention " + shape, got, again, want)
        split, nsplit, blocks, res = da.LAST_GRID["decode_attention"]
        log(f"  decode_attention {shape}: split {split}, nsplit {nsplit}, "
            f"blocks {blocks}, resident blocks per SM {res}")
        q4 = q[:, :, None]
        kr, vr = _repeat_kv(k[:, :n], G), _repeat_kv(v[:, :n], G)
        record("decode_attention", label, shape, err,
               lambda: da.decode_attention_cuda(q, k, v, n),
               lambda: ref.decode_attention_ref(q, k, v, n),
               lambda: sdpa(q4, kr, vr),
               esize * (2 * B * H * dh + 2 * B * n * KH * dh),
               4 * B * H * dh * n, 20)
        del q, k, v, kr, vr
        torch.cuda.empty_cache()
    fa.reset_launches()
    da.reset_launches()


def phase_attention(card):
    log("[11] attention kernels against their twins on the card")
    rows = {}
    _attention_cases(card, HEADS, FLASH_CASES, DECODE_CASES, rows,
                     top=("2k", "32k"))
    return rows


def _top2_gap(logits):
    top = torch.topk(logits.double(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _launch_counts():
    """The serving kernels' launch counters, as ``serve.run`` reports
    them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru
    return {**fa.LAUNCHES, **da.LAUNCHES, **rg_lru.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru
    for mod in (fa, da, rg_lru):
        mod.reset_launches()


def _card_vs_cpu(card, host, forced, gen, abs_bound=None):
    """Hold a card serve to the CPU's on the same model and prompts:
    prefill logits (``card``) and teacher-forced decode logits
    (``forced``) within RTOL_SERVE of the largest |logit| (or within
    ``abs_bound``), greedy tokens equal wherever the CPU's top-two gap
    exceeds that.  Returns ``(errs, near-ties, bound)``."""
    assert torch.equal(card["prompts"], host["prompts"])
    errs = {}
    for part, run in (("prefill", card), ("decode", forced)):
        got, want = run["logits"][part], host["logits"][part]
        assert bool(torch.isfinite(got).all()) and got.shape == want.shape
        bound = RTOL_SERVE * float(want.abs().max()) if abs_bound is None \
            else abs_bound
        errs[part] = float((got.double() - want.double()).abs().max())
        assert errs[part] <= bound, (part, errs[part], bound)
    # the logits that chose token t: the prefill's last position, then the
    # decode steps; a token may differ only where the CPU's top two tie
    # within the bound
    chooser = torch.cat([host["logits"]["prefill"][:, -1:],
                         host["logits"]["decode"]], dim=1)
    bound = RTOL_SERVE * float(chooser.abs().max()) if abs_bound is None \
        else abs_bound
    gap = _top2_gap(chooser)
    ties = []
    for name, run in (("forced", forced), ("free", card)):
        for r in range(card["tokens"].shape[0]):
            for t in range(gen):
                a, b = int(run["tokens"][r, t]), int(host["tokens"][r, t])
                if float(gap[r, t]) <= bound:
                    ties.append((name, r, t, a, b, float(gap[r, t])))
                    if name == "free" and a != b:
                        break             # the row's context differs from here
                    continue
                assert a == b, (name, r, t, a, b, float(gap[r, t]), bound)
    for tie in ties:
        log(f"  near-tie ({tie[0]}): row {tie[1]} token {tie[2]}: card "
            f"{tie[3]}, CPU {tie[4]}, CPU top-two gap {tie[5]:.3e}")
    return errs, ties, bound


def _long_serve(B, prompt, gen2, expect, **which):
    """A card-only serve of the model ``which`` names (``device=`` for a
    fresh draw of the default architecture, or ``model=``); its launches
    must equal ``expect``."""
    from repro_torch.launch import serve
    _reset_launches()
    long = serve.run(batch=B, prompt_len=prompt, gen=gen2, log=log, **which)
    assert long["launches"] == expect, long["launches"]
    assert long["tokens"].shape == (B, gen2)
    assert int(long["tokens"].min()) >= 0 and \
        int(long["tokens"].max()) < long["cfg"].vocab
    steps = long["step_ms"]
    log(f"  B={B} prompt={prompt} gen={gen2}: prefill "
        f"{long['prefill_ms']:.2f} ms, decode {statistics.median(steps):.3f} "
        f"ms/step median ({min(steps):.3f}-{max(steps):.3f}), "
        f"{long['tok_per_s']:.1f} tok/s, launches {long['launches']}, peak "
        f"card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return long


def phase_serve():
    log("[12] serve flaas-100m through repro_torch.launch.serve, card vs "
        "CPU")
    from repro_torch.launch import serve
    gen = 16
    torch.cuda.synchronize()
    _reset_launches()
    card = serve.run(device="cuda", gen=gen, keep_logits=True, log=log)
    launches = _launch_counts()
    cfg = card["cfg"]
    n = cfg.n_layers
    assert (cfg.name, n, cfg.d_model, cfg.vocab) == \
        ("flaas-100m", 12, 768, 32000)
    assert launches == {"flash_attention": n,
                        "decode_attention": n * (gen - 1),
                        "rglru_scan": 0}, launches
    assert card["launches"] == launches
    t0 = time.perf_counter()
    host = serve.run(device="cpu", gen=gen, keep_logits=True, log=log)
    host_s = time.perf_counter() - t0
    forced = serve.run(device="cuda", gen=gen, feed=host["tokens"],
                       keep_logits=True, log=None)
    errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
    log(f"  card vs CPU: prefill logits max err {errs['prefill']:.3e}, "
        f"teacher-forced decode logits max err {errs['decode']:.3e} (bound "
        f"{RTOL_SERVE} x max|logit| = {bound:.3e}); tokens equal except at "
        f"{len(ties)} printed near-ties; launches {launches}; card prefill "
        f"{card['prefill_ms']:.2f} ms, decode "
        f"{statistics.median(card['step_ms']):.2f} ms/step (median), "
        f"{card['tok_per_s']:.1f} tok/s; CPU run {host_s:.2f} s")
    log(f"  tokens (card, row 0): {card['tokens'][0].tolist()}")

    B, prompt, gen2 = 8, 2048, 64
    _long_serve(B, prompt, gen2,
                {"flash_attention": n, "decode_attention": n * (gen2 - 1),
                 "rglru_scan": 0}, device="cuda")
    return launches


def phase_serve_trace():
    log("[13] where serving's time goes (flaas-100m, B=8, prompt 2048)")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models import forward_with_cache, kv_cache, layers
    from repro_torch.training import serve_step
    cfg = get_arch("flaas-100m")
    params = serve.make_model(cfg, 0, torch.device("cuda"))
    B, prompt, steps = 8, 2048, 8
    prompts = torch.randint(0, cfg.vocab, (B, prompt),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32).cuda()
    total = prompt + 3 * steps + 1

    def prefill():
        logits, cache = forward_with_cache(params, prompts, cfg, total)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), cache

    def decode(tok, cache, start):
        for i in range(steps):
            tok, _, cache = serve_step(params, tok, cache, start + i, cfg)
        return tok

    prefill()                                   # warm-up
    state = {}
    pre_busy, pre_rows, pre_wall = _device_kernels(
        lambda: state.update(zip(("tok", "cache"), prefill())))
    flash_ms = sum(ms for k, ms in pre_rows if "flash_fwd" in k)
    log(f"  traced prefill: wall {pre_wall:.2f} ms, card busy "
        f"{pre_busy:.2f} ms (share {pre_busy / pre_wall:.4f}), flash kernel "
        f"{flash_ms:.2f} ms ({flash_ms / max(pre_busy, 1e-9):.4f} of busy); "
        f"top kernels (ms): "
        + ", ".join(f"{k[:40]} {ms:.2f}" for k, ms in pre_rows[:5]))
    tok, cache = state["tok"], state["cache"]
    tok = decode(tok, cache, prompt)            # warm-up, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = decode(tok, cache, prompt + steps)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3 / steps
    dec_busy, dec_rows, dec_wall = _device_kernels(
        lambda: decode(tok, cache, prompt + 2 * steps))
    att_ms = sum(ms for k, ms in dec_rows if "decode_split" in k or
                 "decode_combine" in k)
    log(f"  decode: {untraced:.3f} ms/step untraced; traced {steps} steps: "
        f"wall {dec_wall / steps:.3f} ms/step, card busy "
        f"{dec_busy / steps:.3f} ms/step (share {dec_busy / dec_wall:.4f}), "
        f"decode kernel {att_ms / steps:.3f} ms/step "
        f"({att_ms / max(dec_busy, 1e-9):.4f} of busy); top kernels (ms per "
        f"step): " + ", ".join(f"{k[:40]} {ms / steps:.3f}"
                               for k, ms in dec_rows[:6]))

    _log_host_ops(lambda: decode(tok, cache, prompt + 2 * steps), steps)

    # synchronised host-clock spans of one more decode run (spans on)
    spans = {}
    targets = [(layers, "embed", "embed"), (kv_cache, "apply_block", "blocks"),
               (kv_cache, "logits_head", "lm_head"),
               (da, "decode_attention_cuda", "decode kernel")]
    with _timed_spans(targets, spans):
        decode(tok, cache, prompt + 2 * steps)   # positions already written
    log("  spans per decode step (ms; blocks include the decode kernel): "
        + ", ".join(f"{k} {v * 1e3 / steps:.3f}" for k, v in spans.items()))


def phase_rglru(card, att_rows):
    log("[14] rglru_scan against its twin on the card; attention at "
        "recurrentgemma-2b's heads")
    from repro_torch.kernels import ref, rg_lru
    from repro_torch.kernels.decode_attention import SMS
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"max_abs_err": 0.0, "by_shape": {}}
    floor = time_ms(lambda: torch.cuda._sleep(1), 100)
    for label, B, S, D, with_h0 in RG_CASES:
        a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.499 + 0.5
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        h0 = torch.randn((B, D), generator=gen, device="cuda") \
            if with_h0 else None
        got = rg_lru.rglru_scan_cuda(a, b, h0)
        again = rg_lru.rglru_scan_cuda(a, b, h0)
        want = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        shape = f"B={B} S={S} D={D} h0={with_h0} ({label})"
        if not torch.equal(got, again):
            raise AssertionError(f"rglru_scan {shape}: not bitwise stable "
                                 "from launch to launch")
        err = check("rglru_scan " + shape, got, want, True)
        del want
        ms = time_ms(lambda: rg_lru.rglru_scan_cuda(a, b, h0), 20)
        plain = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), 1, 3)
        nbytes = 4 * (3 * B * S * D + (B * D if with_h0 else 0))
        bnd, by = bound_ms(nbytes, 2 * B * S * D)
        channels = rg_lru.SCAN_CHANNELS
        stage = rg_lru.scan_geometry(B, S, D)   # fresh, so 16-byte aligned
        ring = rg_lru.SCAN_STAGES * stage
        flight = (rg_lru.SCAN_STAGES - 1) * stage * 8 * B * D
        blocks = B * -(-D // channels)
        geo = (f"ring of {ring} steps ({flight} B in flight by design), "
               f"{channels} channels a block, at most "
               f"{-(-blocks // SMS) * channels} channels an SM"
               if stage else
               f"direct path (no ring), {channels} channels a block")
        log(f"  rglru_scan       {shape}: bitwise, stable  kernel "
            f"{ms:.4f} ms  twin {plain:.4f} ms  bound {bnd:.6f} ms ({by}, "
            f"{card}), share {bnd / ms:.3f}; {geo}"
            + (f"; launch floor {floor:.4f} ms" if S == 1 else "")
            + "; no single PyTorch call computes it")
        nums = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None, shape=shape)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["by_shape"][label] = nums
        if label == "2k":                  # the JSON line's shape
            row.update(nums)
        del a, b, h0, got, again
        torch.cuda.empty_cache()
    rg_lru.reset_launches()
    _attention_cases(card, RG_HEADS, RG_FLASH_CASES, RG_DECODE_CASES,
                     att_rows)
    return row


def phase_serve_hybrid():
    log("[15] serve recurrentgemma-2b through repro_torch.launch.serve")
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    full_cfg = get_arch("recurrentgemma-2b")
    gen = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_model(full_cfg, 0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0

    # card vs CPU on one model: full width, depth cut to (rec, rec, local)
    card_m = _cut_model(model, 3, "cuda")
    host_m = _cut_model(card_m, 3, "cpu")
    _reset_launches()
    card = serve.run(model=card_m, gen=gen, keep_logits=True, log=log)
    assert card["launches"] == {"flash_attention": 1,
                                "decode_attention": gen - 1,
                                "rglru_scan": 2 * gen}, card["launches"]
    t0 = time.perf_counter()
    host = serve.run(model=host_m, gen=gen, keep_logits=True, log=log)
    host_s = time.perf_counter() - t0
    forced = serve.run(model=card_m, gen=gen, feed=host["tokens"],
                       keep_logits=True, log=None)
    errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
    log(f"  one group ({card_m.flat.numel()} parameters) card vs CPU: "
        f"prefill logits max err {errs['prefill']:.3e}, teacher-forced "
        f"decode logits max err {errs['decode']:.3e} (bound {RTOL_SERVE} x "
        f"max|logit| = {bound:.3e}); tokens equal except at {len(ties)} "
        f"printed near-ties; CPU run {host_s:.2f} s")
    del host_m, card_m, card, host, forced
    torch.cuda.empty_cache()

    # the full 26 layers at the launcher's defaults
    kinds = [k for k, _ in full_cfg.layer_specs()]
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    assert (n_rec, n_local) == (18, 8) and model.flat.numel() == P_RG2B
    log(f"  recurrentgemma-2b: {model.flat.numel()} float32 parameters "
        f"drawn on the card by init_model in {draw_s:.2f} s (host clock)")
    _reset_launches()
    run = serve.run(model=model, gen=gen, keep_logits=True, log=log)
    launches = _launch_counts()
    expect = {"flash_attention": n_local,
              "decode_attention": n_local * (gen - 1),
              "rglru_scan": n_rec * gen}
    assert launches == expect == run["launches"], (launches, expect)
    for part in ("prefill", "decode"):
        assert bool(torch.isfinite(run["logits"][part]).all()), part
    assert run["logits"]["prefill"].shape == (4, 32, full_cfg.vocab)
    assert int(run["tokens"].min()) >= 0 and \
        int(run["tokens"].max()) < full_cfg.vocab
    log(f"  defaults (B=4, prompt 32, gen {gen}): launches {launches}; "
        f"prefill {run['prefill_ms']:.2f} ms, decode "
        f"{statistics.median(run['step_ms']):.2f} ms/step (median), "
        f"{run['tok_per_s']:.1f} tok/s; tokens (row 0) "
        f"{run['tokens'][0].tolist()}")
    del run
    B, prompt, gen2 = 4, 2048, 64
    long = _long_serve(B, prompt, gen2,
                       {"flash_attention": n_local,
                        "decode_attention": n_local * (gen2 - 1),
                        "rglru_scan": n_rec * gen2}, model=model)
    return launches, long["launches"], model


def phase_serve_hybrid_trace(model):
    log("[16] where recurrentgemma-2b's serving time goes (B=4, prompt "
        "2048)")
    from repro_torch.models import forward_with_cache
    from repro_torch.training import serve_step
    cfg = model.cfg
    B, prompt, steps = 4, 2048, 8
    prompts = torch.randint(0, cfg.vocab, (B, prompt),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32).cuda()
    total = prompt + 3 * steps + 1

    def prefill():
        logits, cache = forward_with_cache(model, prompts, cfg, total)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), cache

    def decode(tok, cache, start):
        for i in range(steps):
            tok, _, cache = serve_step(model, tok, cache, start + i, cfg)
        return tok

    def kernel_ms(rows, *keys):
        return sum(ms for k, ms in rows if any(key in k for key in keys))

    prefill()                                   # warm-up
    state = {}
    busy, rows, wall = _device_kernels(
        lambda: state.update(zip(("tok", "cache"), prefill())))
    scan, flash = kernel_ms(rows, "rg_scan"), kernel_ms(rows, "flash_fwd")
    log(f"  traced prefill: wall {wall:.2f} ms, card busy {busy:.2f} ms "
        f"(share {busy / wall:.4f}); rglru_scan {scan:.3f} ms "
        f"({scan / max(busy, 1e-9):.4f} of busy), flash {flash:.2f} ms "
        f"({flash / max(busy, 1e-9):.4f}); top kernels (ms): "
        + ", ".join(f"{k[:40]} {ms:.2f}" for k, ms in rows[:6]))
    tok, cache = state["tok"], state["cache"]
    tok = decode(tok, cache, prompt)            # warm-up, untimed
    busy, rows, wall = _device_kernels(
        lambda: decode(tok, cache, prompt + steps))
    scan = kernel_ms(rows, "rg_scan")
    att = kernel_ms(rows, "decode_split", "decode_combine")
    log(f"  traced decode, {steps} steps: wall {wall / steps:.3f} ms/step, "
        f"card busy {busy / steps:.3f} ms/step (share {busy / wall:.4f}); "
        f"rglru_scan {scan / steps:.4f} ms/step ({scan / max(busy, 1e-9):.4f}"
        f" of busy), decode attention {att / steps:.4f} ms/step "
        f"({att / max(busy, 1e-9):.4f}); top kernels (ms per step): "
        + ", ".join(f"{k[:40]} {ms / steps:.3f}" for k, ms in rows[:6]))
    _log_host_ops(lambda: decode(tok, cache, prompt + 2 * steps), steps)


def _launched(label, counts, need):
    """Raise unless every kernel in ``need`` launched and no other budget
    kernel did."""
    missing = [k for k in need if counts[k] == 0]
    extra = [k for k, v in counts.items() if v and k not in need]
    if missing or extra:
        raise AssertionError(f"{label}: kernels {missing} never launched, "
                             f"{extra} launched off the path: {counts}")


def _episodes_equal(label, got, want, rtol):
    """Selections, n_allocated and final_done equal; every continuous row
    within ``rtol`` relative and absolute (``rtol`` 0: bitwise)."""
    for k in ("selected", "n_allocated", "final_done"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), (label, k)
    for k in ("round_efficiency", "round_fairness", "round_fairness_norm",
              "round_jain", "leftover", "cumulative_efficiency",
              "cumulative_fairness", "cumulative_fairness_norm",
              "final_capacity"):
        g, w = got[k].cpu(), want[k].cpu()
        ok = torch.equal(g, w) if rtol == 0 else torch.allclose(
            g, w, rtol=rtol, atol=rtol)
        assert ok, (label, k, float((g.double() - w.double()).abs().max()))


def phase_paper_comparison():
    """DPBalance against DPF, DPK and FCFS on the paper's episode at three
    betas, card against CPU; at beta 2.2 against repro's values and the
    legacy simulator."""
    log("[17] the paper comparison: dpbalance, dpf, dpk, fcfs on "
        "SimConfig(seed=0) at beta 0.5 / 2.2 / 5.0, card vs CPU")
    from repro_torch.core import (SCHEDULER_NAMES, SchedulerConfig,
                                  SimConfig, generate_episode, run_episode,
                                  run_simulation)
    from repro_torch.kernels import budget_alloc as ba
    sim = SimConfig(seed=0)
    R = sim.n_rounds
    ep_gpu = generate_episode(sim, device="cuda")
    launches = {}
    for beta in PAPER_BETAS:
        cfg = SchedulerConfig(beta=beta)
        for name in SCHEDULER_NAMES:
            torch.cuda.synchronize()
            ba.reset_launches()
            out = run_episode(ep_gpu, cfg, name)
            torch.cuda.synchronize()
            counts = dict(ba.LAUNCHES)
            _launched(f"{name} beta {beta}", counts, PATH_KERNELS[name])
            host, _ = cpu_ref(("episode", (("beta", beta),), name))
            _episodes_equal(f"{name} beta {beta} card vs CPU", out, host,
                            RTOL_PAPER)
            if beta == 2.2:
                launches[name] = {k: v / R for k, v in counts.items()}
            log(f"  beta {beta} {name:9s}: n_allocated "
                f"{out['n_allocated'].tolist()}, cumulative efficiency "
                f"{float(out['cumulative_efficiency'][-1]):.7g}, fairness "
                f"(normalized) {float(out['cumulative_fairness_norm'][-1]):.7g}"
                f", SP1 iterations {out['sp1_iters'].tolist()}; the CPU run: "
                f"selections and n_allocated equal, rows within {RTOL_PAPER}")
    cfg = SchedulerConfig(beta=2.2)
    for name in SCHEDULER_NAMES:
        eng = run_simulation(name, sim, cfg, device="cuda")
        legacy = run_simulation(name, sim, cfg, engine=False, device="cuda")
        n_ref, eff_ref, fair_ref = REPRO_PAPER[name]
        assert eng["n_allocated"].tolist() == n_ref, (name, eng["n_allocated"])
        for got, want in ((eng["cumulative_efficiency"][-1], eff_ref),
                          (eng["cumulative_fairness_norm"][-1], fair_ref)):
            assert abs(float(got) - want) <= REPRO_EFF_RTOL * abs(want), \
                (name, float(got), want)
        assert legacy["n_allocated"].tolist() == n_ref, name
        for k, v in eng.items():
            assert np.allclose(legacy[k], v, rtol=RTOL_PAPER,
                               atol=RTOL_PAPER), (name, k, legacy[k], v)
        ep_fn = (lambda n=name: run_episode(ep_gpu, cfg, n))
        wall = _wall(ep_fn)
        dev_ms, _, traced = _device_kernels(ep_fn)
        log(f"  beta 2.2 {name:9s}: repro's n_allocated, cumulative "
            f"efficiency and fairness (REPRO_PAPER) equal; legacy "
            f"FlaasSimulator on the card within {RTOL_PAPER} of the engine; "
            f"{wall / R * 1e3:.2f} ms/round untraced, card busy "
            f"{dev_ms / R:.3f} ms/round, busy share "
            f"{dev_ms / (wall * 1e3):.4f} (traced wall {traced / R:.2f} "
            f"ms/round); budget-kernel launches per round "
            f"{launches[name]}")
    return launches


def _fleet_launches(name, over, E, R, mode, counts):
    """Raise unless a fleet run launched each budget kernel as its path
    does: per lockstep round (``"vmap"``) what one episode's round
    launches, per episode round (``"map"``) the same E times over.  A
    beam round launches the full sweep's extra swap_eval and boost_scan
    only where a certificate failed.  Returns the launches per round."""
    rounds = R if mode == "vmap" else E * R
    per = {k: v / rounds for k, v in counts.items() if v}
    need = SERVICE_PER_TICK[name]
    if name == "dpbalance" and over.get("swap_beam"):
        ok = (all(per.get(k) == v for k, v in need.items()
                  if k not in ("boost_scan", "swap_eval"))
              and 1 <= per["swap_eval"] <= 2
              and counts["boost_scan"] == counts["swap_eval"] + rounds)
    else:
        ok = per == {k: float(v) for k, v in need.items()}
    if not ok:
        raise AssertionError(f"{name} {over} {mode}: launches per round "
                             f"{per}, want {need}")
    return per


def phase_fleets():
    """Every scenario's fleet of FLEET_SEEDS episodes through run_fleet on
    the card for each scheduler (lockstep, by "auto"), each row equal to
    run_episode's; then the paper fleet of LOCKSTEP_SEEDS episodes under
    both modes, vmap bitwise map, with launches and walls."""
    from repro_torch.core import (SCENARIOS, SCHEDULER_NAMES,
                                  SchedulerConfig, generate_episode,
                                  make_fleet, resolve_fleet_mode,
                                  run_episode, run_fleet, scenario_config)
    from repro_torch.kernels import budget_alloc as ba
    log(f"[18] fleets: {len(SCENARIOS)} scenarios x {FLEET_SEEDS} seeds x "
        f"4 schedulers, run_fleet (mode 'auto' = "
        f"{resolve_fleet_mode('auto', 'cuda')!r} on the card) against "
        f"run_episode on the card")
    assert resolve_fleet_mode("auto", "cuda") == "vmap"
    cfg = SchedulerConfig(beta=2.2)
    fleets = {n: make_fleet(n, FLEET_SEEDS, device="cuda")
              for n in SCENARIOS}
    singles = {n: [generate_episode(scenario_config(n, seed=s),
                                    device="cuda")
                   for s in range(FLEET_SEEDS)] for n in SCENARIOS}
    for name in SCHEDULER_NAMES:
        wall, alloc = 0.0, 0
        for scen, fleet in fleets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_fleet(fleet, cfg, name)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            alloc += int(out["n_allocated"].sum())
            for e, ep in enumerate(singles[scen]):
                one = run_episode(ep, cfg, name)
                for k, v in one.items():
                    assert torch.equal(out[k][e], v), (name, scen, e, k)
        per_ep = wall / len(fleets) / FLEET_SEEDS * 1e3
        log(f"  {name:9s}: {len(fleets)} lockstep fleets of {FLEET_SEEDS} "
            f"episodes in {wall:.3f} s ({per_ep:.1f} ms an episode), "
            f"{alloc} pipelines allocated; every row equal to "
            f"run_episode's")
    diag = run_fleet(fleets["paper_default"], cfg, "dpbalance",
                     diagnostics=True)
    M, N = diag["selected"].shape[-2:]
    K = diag["final_capacity"].shape[-1]
    assert diag["granted_i"].shape == (FLEET_SEEDS, 10, M, K)
    for k in ("utility", "a_i", "gamma_i", "mu_i", "x_analyst", "granted_i",
              "cap_frac"):
        assert bool(torch.isfinite(diag[k]).all()), k
    log(f"  diagnostics=True (paper_default, dpbalance): per-round "
        f"utility, analyst_mask, a_i, gamma_i, mu_i, x_analyst, "
        f"sp1_violation, granted_i, cap_frac, selected; finite, granted_i "
        f"{tuple(diag['granted_i'].shape)}")
    del fleets, singles, diag

    E = LOCKSTEP_SEEDS
    fleet = make_fleet("paper_default", E, device="cuda")
    R = fleet.n_rounds
    log(f"  the lockstep fleet: paper_default x {E} seeds at paper size "
        f"(M={M} N={N} K={K} R={R}), every scheduler under both modes")
    for name, over in LOCKSTEP_RUNS:
        c = SchedulerConfig(beta=2.2, **over)
        run_fleet(fleet, c, name, mode="vmap")           # warm-up
        outs, walls, line = {}, {}, []
        for mode in ("vmap", "map"):
            torch.cuda.synchronize()
            ba.reset_launches()
            t0 = time.perf_counter()
            outs[mode] = run_fleet(fleet, c, name, mode=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per = _fleet_launches(name, over, E, R, mode, dict(ba.LAUNCHES))
            walls[mode] = wall
            unit = "lockstep round" if mode == "vmap" else "episode round"
            line.append(f"{mode} {wall:.3f} s ({wall / E * 1e3:.1f} ms an "
                        f"episode, launches per {unit} "
                        f"{ {k: round(v, 3) for k, v in per.items()} })")
        vm, mp = outs["vmap"], outs["map"]
        assert set(vm) == set(mp), (name, over)
        for k in mp:
            assert vm[k].dtype == mp[k].dtype and torch.equal(vm[k], mp[k]), \
                (name, over, k)
        log(f"  {name:9s} {over or ''}: vmap bitwise map on every key "
            f"({len(mp)}); " + "; ".join(line) + f"; map / vmap "
            f"{walls['map'] / walls['vmap']:.2f}x"
            + (f"; SP1 iterations per round, max over the fleet "
               f"{vm['sp1_iters'].amax(0).tolist()}" if name == "dpbalance"
               else ""))


def phase_beam(card):
    """The certified swap beam: bitwise the full sweep on the paper
    episode and the M=32 round; the fleet-scale round certifies and holds
    repro's values, and its swap_eval launch equals its twin."""
    log(f"[19] the certified swap beam (swap_beam={BEAM_WIDTH})")
    from repro_torch.core import (SchedulerConfig, SimConfig,
                                  generate_episode, run_episode,
                                  schedule_round)
    from repro_torch.core import hotpath
    from repro_torch.core import scheduler as sch
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    # 1. the paper episode, beam against the full sweep
    ep = generate_episode(SimConfig(seed=0), device="cuda")
    certs, orig = [], sch.pack_all_pruned

    def recorded(*a, **k):
        out = orig(*a, **k)
        certs.append((bool(out[1]), float(out[2])))
        return out

    sch.pack_all_pruned = recorded
    try:
        beam = run_episode(ep, SchedulerConfig(swap_beam=BEAM_WIDTH))
    finally:
        sch.pack_all_pruned = orig
    full = run_episode(ep, SchedulerConfig())
    assert set(beam) == set(full) and len(certs) == ep.n_rounds
    for k, v in full.items():
        assert torch.equal(beam[k], v), k
    log(f"  paper episode: every row bitwise the full sweep's; per round "
        f"swap_cert_ok {[c for c, _ in certs]}, margin "
        f"{[f'{m:.4g}' for _, m in certs]}")
    # 2. phase 5's round
    for cap in (1.0, 3.0):
        rnd = _round(32, 16384, 32, cap=cap)
        a = schedule_round(rnd, SchedulerConfig(beta=2.2))
        b = schedule_round(rnd, SchedulerConfig(beta=2.2,
                                                swap_beam=BEAM_WIDTH))
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if f in ("swap_cert_ok", "swap_cert_margin"):
                assert x is None and y is not None, f
            else:
                assert (x is None and y is None) or torch.equal(x, y), f
        assert int(b.n_allocated) == REPRO_LARGE[cap][0]
        log(f"  M=32 N=32 K=16384 capacity {cap}: bitwise phase 5's round "
            f"(n_allocated {int(b.n_allocated)}); swap_cert_ok "
            f"{bool(b.swap_cert_ok)}, margin {float(b.swap_cert_margin):.4g}")
        del rnd, a, b
    # 3. the fleet-scale round
    M, K, N, cap = BEAM_ROUND
    t0 = time.perf_counter()
    rnd = _round(M, K, N, cap=cap)
    log(f"  fleet-scale round M={M} N={N} K={K} capacity {cap}: drawn and "
        f"copied in {time.perf_counter() - t0:.2f} s")
    cfg = SchedulerConfig(beta=2.2, swap_beam=BEAM_WIDTH)
    calls, orig_se = [], hotpath.swap_eval

    def captured(*a):
        calls.append(a)
        return orig_se(*a)

    hotpath.swap_eval = captured
    try:
        res = schedule_round(rnd, cfg)         # also the warm-up
    finally:
        hotpath.swap_eval = orig_se
    assert len(calls) == 1, len(calls)
    g_ord, sel_c, left_c, kmax, bx = calls.pop()
    assert not bx.sharded
    C = sel_c.shape[1]
    assert tuple(sel_c.shape) == (M, BEAM_WIDTH, N), tuple(sel_c.shape)
    err = check("swap_eval (fleet-scale beam)",
                ba.swap_eval(g_ord, sel_c, left_c, kmax),
                ref.swap_eval_ref(g_ord, sel_c, left_c, kmax), True)
    geo = ba.LAST_GRID["boost_sweep"]
    ms = time_ms(lambda: ba.swap_eval(g_ord, sel_c, left_c, kmax), 3)
    plain = time_ms(lambda: ref.swap_eval_ref(g_ord, sel_c, left_c, kmax),
                    1, 3)
    # the data-dependent work: only rows some candidate selects are read,
    # and only their nonzero entries cost operations
    nnz = (g_ord != 0).sum(-1).double()
    ops = int(4 * (sel_c.double() * nnz[:, None, :]).sum())
    rows_read = int((sel_c != 0).any(1).sum())
    b_ms, by = bound_ms(4 * (rows_read * K + 2 * M * C * N + M * C * K), ops)
    row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
               library_ms=None, max_abs_err=err,
               shape=f"M={M} N={N} K={K} C={C}",
               **dict(zip(("cs", "T", "blocks"), geo)))
    log(f"  swap_eval M={M} C={C} N={N} K={K} (the beam's own operands): "
        f"bitwise its twin, cs={geo[0]} T={geo[1]} blocks={geo[2]}, kernel "
        f"{ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.6f} ms ({by}: "
        f"{rows_read} selected demand rows of {M * N}, {card})")
    del g_ord, sel_c, left_c, nnz
    n_ref, eff_ref, sel_ref = REPRO_BEAM["beam"]
    assert bool(res.swap_cert_ok), "the fleet-scale round did not certify"
    assert int(res.n_allocated) == n_ref, int(res.n_allocated)
    assert abs(float(res.efficiency) - eff_ref) <= REPRO_EFF_RTOL * eff_ref, \
        float(res.efficiency)
    assert torch.nonzero(res.selected[0])[:, 0].tolist() == sel_ref
    del res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ba.reset_launches()
    t0 = time.perf_counter()
    res = schedule_round(rnd, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ba.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    _launched("fleet-scale beam round", counts, PATH_KERNELS["dpbalance"])
    assert bool(res.swap_cert_ok) and int(res.n_allocated) == n_ref
    del res
    dev_ms, rows, traced = _device_kernels(lambda: schedule_round(rnd, cfg))
    # the host loops over N=1000 pipelines, as synchronised spans (nested:
    # the selection sums run inside the beam, the boosts inside it and in
    # the finish)
    from repro_torch.core import packing, swap
    spans = {}
    with _timed_spans([(sch, "alpha_fair_waterfill", "SP1"),
                       (packing, "greedy_cover", "greedy_cover"),
                       (swap, "swap_refine_beam", "swap_refine_beam"),
                       (swap, "_selection_sums", "_selection_sums"),
                       (packing, "proportional_boost", "proportional_boost")],
                      spans):
        span_wall = _wall(lambda: schedule_round(rnd, cfg))
    off = SchedulerConfig(beta=2.2, refine=False)
    res_off = schedule_round(rnd, off)
    n_off, eff_off, sel_off = REPRO_BEAM["no_refine"]
    assert int(res_off.n_allocated) == n_off
    assert abs(float(res_off.efficiency) - eff_off) <= \
        REPRO_EFF_RTOL * eff_off, float(res_off.efficiency)
    assert torch.nonzero(res_off.selected[0])[:, 0].tolist() == sel_off
    del res_off
    wall_off = _wall(lambda: schedule_round(rnd, off))
    top = ", ".join(f"{n[:40]} {v:.2f}" for n, v in rows[:6])
    log(f"  fleet-scale round, beam: swap_cert_ok True, n_allocated "
        f"{n_ref}, efficiency and selected pipelines equal repro's "
        f"(REPRO_BEAM); wall {wall * 1e3:.1f} ms (refine off: "
        f"{wall_off * 1e3:.1f} ms, also repro's values), card time "
        f"{dev_ms:.2f} ms (traced wall {traced:.1f} ms, busy share "
        f"{dev_ms / (wall * 1e3):.4f}), peak device memory "
        f"{peak / 2**30:.3f} GiB above the round's inputs "
        f"({base / 2**30:.3f} GiB); launches {counts}; top kernels (ms): "
        f"{top}")
    log(f"  fleet-scale round, beam, synchronised host spans (ms): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in spans.items())
        + f" of {span_wall * 1e3:.1f}")
    del rnd
    torch.cuda.empty_cache()
    return counts, row


def _service(scheduler, device="cuda", warm=False, paged=True, **over):
    """A service at SERVICE_GEOMETRY over load.py's default trace."""
    from repro_torch.core import SchedulerConfig
    from repro_torch.service import FlaasService, ServiceConfig, make_trace
    cfg = ServiceConfig(scheduler=scheduler,
                        sched=SchedulerConfig(beta=2.2, sp1_warm_start=warm),
                        paged=paged, **{**SERVICE_GEOMETRY, **over})
    return FlaasService(cfg, make_trace("paper_default", "poisson", seed=0),
                        device=device)


def _run_ticks(svc, ticks, marks=()):
    """Run ``svc`` chunk by chunk to ``ticks``; returns the per-tick rows
    (numpy, concatenated) and ``{mark: (summary, state copy)}`` at each
    tick in ``marks`` (multiples of the chunk)."""
    parts, at = [], {}
    while svc.tick < ticks:
        parts.append(svc.run_chunk(min(svc.cfg.chunk_ticks,
                                       ticks - svc.tick)))
        if svc.tick in marks:
            at[svc.tick] = (svc.summary(), {
                f.name: getattr(svc.state, f.name).clone()
                for f in dataclasses.fields(svc.state)})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}, at


def _service_rows_equal(label, got, want, n, rtol):
    """The first ``n`` ticks of two services' rows: selections,
    n_allocated and expiries equal; the rest within ``rtol`` relative and
    absolute (0: bitwise)."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k in got:
        g, w = got[k][:n], want[k][:n]
        if rtol == 0 or k in ("selected", "n_allocated", "expired") or \
                w.dtype.kind in "bi":
            assert np.array_equal(g, w), (label, k)
        else:
            assert np.allclose(g, w, rtol=rtol, atol=rtol), \
                (label, k, float(np.abs(g.astype(np.float64) - w).max()))


def _states_equal(label, a, b, rtol=0.0):
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        ok = torch.equal(x, y) if rtol == 0 or not x.is_floating_point() \
            else torch.allclose(x, y, rtol=rtol, atol=rtol)
        assert ok, (label, k)


def _count_syncs(fn) -> int:
    """Synchronising CUDA calls made while ``fn()`` runs, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_service(smi):
    """The streaming service plane at load.py's full-width defaults on the
    card: every scheduler through 3 ring wraps, paged bitwise the carry,
    card against CPU, repro's values, replay against run_episode, and
    where a tick's time goes."""
    log(f"[20] the service plane: FlaasService at load.py's defaults "
        f"({SERVICE_GEOMETRY}, paper_default, poisson, seed 0, beta 2.2), "
        f"{SERVICE_TICKS} ticks; {smi}")
    from repro_torch.core import (SCHEDULER_NAMES, SchedulerConfig,
                                  SimConfig, generate_episode, run_episode)
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.service import replay_gap
    T = SERVICE_GEOMETRY["chunk_ticks"]
    n_cpu = SERVICE_CPU_TICKS
    runs, launches, tps = {}, {}, {}
    # 1. every scheduler through >= 3 wraps, conservation checked per
    # chunk (ServiceConfig.validate), every wrapped chunk paged, every
    # slot recycled
    for name in SCHEDULER_NAMES:
        svc = _service(name)
        torch.cuda.synchronize()
        ba.reset_launches()
        t0 = time.perf_counter()
        ys, at = _run_ticks(svc, SERVICE_TICKS, marks=(n_cpu, 64))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ba.LAUNCHES)
        want = {k: SERVICE_TICKS * SERVICE_PER_TICK[name].get(k, 0)
                for k in counts}
        assert counts == want, (name, counts, want)
        s = svc.summary()
        modes = s["paging"]["mode_ticks"]
        wraps = SERVICE_TICKS * svc.trace.blocks_per_tick / \
            SERVICE_GEOMETRY["block_slots"]
        assert wraps >= 3 and modes["carry"] == 0 and \
            modes["paged"] == SERVICE_TICKS - modes["wrapfree"] and \
            modes["wrapfree"] * svc.trace.blocks_per_tick <= \
            SERVICE_GEOMETRY["block_slots"], (name, modes)
        stats = svc.queue.stats
        live = stats.pipelines_admitted - s["grants"] - \
            s["expired_pipelines"]
        assert int(svc.table.occupied.sum()) == live, (name, live)
        assert stats.offered == stats.admitted + stats.rejected + \
            svc.queue.depth
        assert stats.admitted > SERVICE_GEOMETRY["analyst_slots"]
        assert float(ys["overdraw"].max()) <= 1e-4 and \
            float(ys["conservation_gap"].max()) <= 1e-4
        for k in ("round_efficiency", "round_fairness_norm", "leftover"):
            assert np.isfinite(ys[k]).all(), (name, k)
        runs[name], launches[name] = (svc, ys, at), {
            k: v / SERVICE_TICKS for k, v in counts.items()}
        tps[name] = SERVICE_TICKS / wall
        log(f"  {name:9s}: {SERVICE_TICKS} ticks ({wraps:.2f} ring wraps) in "
            f"{wall:.3f} s = {tps[name]:.2f} ticks/s; modes {modes}; "
            f"{s['grants']} grants, {s['expired_pipelines']} expired, "
            f"{stats.admitted} of {stats.offered} submissions admitted, "
            f"queue depth mean {s['queue_depth_mean']:.2f}; cumulative "
            f"efficiency {s['cumulative_efficiency']:.7g}, fairness "
            f"(normalized) {s['cumulative_fairness_norm']:.7g}; max gap "
            f"{float(ys['conservation_gap'].max()):.3e}, overdraw "
            f"{float(ys['overdraw'].max()):.3e}; occupancy {live} equals "
            f"the admission ledger; budget-kernel launches per tick "
            f"{launches[name]}")
    # 4. repro's values for the first 64 dpbalance ticks
    svc, ys, at = runs["dpbalance"]
    n_ref, eff_ref, fair_ref = REPRO_SERVICE
    assert ys["n_allocated"][:64].tolist() == n_ref, ys["n_allocated"][:64]
    s64 = at[64][0]
    for got, want in ((s64["cumulative_efficiency"], eff_ref),
                      (s64["cumulative_fairness_norm"], fair_ref)):
        assert abs(got - want) <= RTOL_SERVICE * abs(want), (got, want)
    log(f"  dpbalance, first 64 ticks: repro's per-tick n_allocated equal, "
        f"cumulative efficiency {s64['cumulative_efficiency']:.9g} "
        f"(repro {eff_ref}), fairness (normalized) "
        f"{s64['cumulative_fairness_norm']:.9g} (repro {fair_ref}): "
        f"REPRO_SERVICE held")
    # 2. paged against carry on the card, bitwise, cold and warm
    warm = _service("dpbalance", warm=True)
    ys_w, at_w = _run_ticks(warm, n_cpu, marks=(n_cpu,))
    for label, (ya, sa) in (("cold", (ys, at[n_cpu][1])),
                            ("warm", (ys_w, at_w[n_cpu][1]))):
        carry = _service("dpbalance", warm=label == "warm", paged=False)
        yc, atc = _run_ticks(carry, n_cpu, marks=(n_cpu,))
        assert carry.summary()["paging"]["mode_ticks"]["paged"] == 0
        _service_rows_equal(f"paged vs carry {label}", ya, yc, n_cpu, 0.0)
        _states_equal(f"paged vs carry {label}", sa, atc[n_cpu][1])
        log(f"  dpbalance {label}: paged bitwise the carry body over "
            f"{n_cpu} ticks (per-tick rows and every ServiceState field)")
    # 3. card against CPU, dpbalance warm and dpf, past the first wrap
    for label, (ya, sa), name, w in (
            ("dpbalance warm", (ys_w, at_w[n_cpu][1]), "dpbalance", True),
            ("dpf", (runs["dpf"][1], runs["dpf"][2][n_cpu][1]), "dpf",
             False)):
        (yh, ath), cpu_s = cpu_ref(("service", name, w, n_cpu))
        _service_rows_equal(f"card vs CPU {label}", ya, yh, n_cpu,
                            RTOL_SERVICE)
        _states_equal(f"card vs CPU {label}", sa, ath[n_cpu][1],
                      RTOL_SERVICE)
        log(f"  {label}: card vs CPU over {n_cpu} ticks: selections, "
            f"n_allocated and expiries equal, rows and final state within "
            f"{RTOL_SERVICE} (CPU run {cpu_s:.1f} s on the host clock, on "
            f"{CPU_REF_THREADS} threads beside the card phases)")
    # 5. replay against run_episode on the card
    from repro_torch.service import make_trace
    for name in SCHEDULER_NAMES:
        gaps = replay_gap(make_trace("paper_default", "poisson", seed=0), 10,
                          SchedulerConfig(beta=2.2), name, chunk_ticks=T,
                          device="cuda")
        assert max(gaps.values()) <= 1e-5, (name, gaps)
        log(f"  replay_gap {name:9s} over 10 ticks on the card: max "
            f"{max(gaps.values()):.3e}")
    # 6. where the time goes
    svc = runs["dpbalance"][0]
    prof = svc.profiler.summary()
    total = sum(v["seconds"] for v in prof.values())
    log(f"  dpbalance PhaseProfiler over the {SERVICE_TICKS} ticks (host "
        "wall): " + ", ".join(
        f"{k} {v['seconds'] * 1e3:.1f} ms / {v['calls']} calls "
        f"({v['seconds'] / total:.4f})" for k, v in prof.items()))
    loop = svc.tick_loop_fn(T)                   # a wrapped chunk
    _wall(loop)
    dev_ms, rows, wall_ms = _device_kernels(loop)
    log(f"  dpbalance, one wrapped chunk's tick loop ({T} ticks) traced: "
        f"wall {wall_ms:.2f} ms, card busy {dev_ms:.3f} ms, busy share "
        f"{dev_ms / wall_ms:.4f}; top kernels " + ", ".join(
            f"{k[:40]} {v:.3f}" for k, v in rows[:6]))
    sync_chunk = _count_syncs(lambda: svc.run_chunk(T))
    ep8 = generate_episode(SimConfig(seed=0, n_analysts=8,
                                     pipelines_per_analyst=25, n_rounds=8),
                           device="cuda")
    sync_ep = _count_syncs(lambda: run_episode(ep8, SchedulerConfig(beta=2.2),
                                               "dpbalance"))
    log(f"  synchronising CUDA calls (set_sync_debug_mode): one dpbalance "
        f"service chunk of {T} ticks {sync_chunk}; run_episode of 8 rounds "
        f"at M=8 N=25 K=1600 {sync_ep}")
    sim = SimConfig(seed=0)
    ep = generate_episode(sim, device="cuda")
    R = sim.n_rounds
    for name in ("dpbalance", "dpf"):
        paper = _service(name, analyst_slots=sim.n_analysts,
                         pipeline_slots=sim.pipelines_per_analyst,
                         block_slots=sim.n_devices *
                         sim.blocks_per_round_per_device * R,
                         chunk_ticks=R, admit_batch=16, max_pending=256,
                         validate=False)
        paper.admit_boundary(R)
        tick_loop = paper.tick_loop_fn(R)
        cfg = SchedulerConfig(beta=2.2)
        engine = (lambda n=name: run_episode(ep, cfg, n, validate=False))
        tick_loop(), engine()
        t_loop, t_eng = [], []
        for _ in range(3):
            t_loop.append(_wall(tick_loop))
            t_eng.append(_wall(engine))
        ratio = (R / min(t_loop)) / (R / min(t_eng))
        log(f"  paper episode, {name}: service tick {min(t_loop) / R * 1e3:.2f}"
            f" ms, engine round {min(t_eng) / R * 1e3:.2f} ms (min of 3, "
            f"in turns): ticks/s over rounds/s {ratio:.3f}")
    log("  ticks/s: " + ", ".join(f"{k} {v:.2f}" for k, v in tps.items())
        + f"; {smi}")
    return launches


def _shard_job(scheduler, ticks, **extra):
    """A launcher job at SERVICE_GEOMETRY over load.py's default trace;
    dpbalance with warm SP1 (SHARD_WARM)."""
    return dict(scheduler=scheduler, ticks=ticks,
                sched=dict(beta=2.2,
                           sp1_warm_start=scheduler in SHARD_WARM),
                service=dict(SERVICE_GEOMETRY),
                trace=dict(scenario="paper_default", pattern="poisson",
                           seed=0), **extra)


def _rows_with_selections(svc, ticks):
    from repro_torch.launch.sharded_service import capture_selections
    sel = capture_selections(svc)
    rows, _ = _run_ticks(svc, ticks)
    rows["selected"] = np.concatenate(sel)
    return rows


def _fingerprint(summary):
    from repro_torch.service import summary_fingerprint
    return json.dumps(summary_fingerprint(summary), sort_keys=True)


def _state_copy(svc):
    return {f.name: getattr(svc.state, f.name).clone()
            for f in dataclasses.fields(svc.state)}


def _step_bytes(directory, step):
    d = Path(directory) / f"step_{step:010d}"
    return sum(p.stat().st_size for p in d.iterdir())


def _reference_form(path):
    """Rewrite a host payload as repro writes it: the same objects, their
    classes named in repro.service / repro.obs (protocol 2 names every
    class in a newline-terminated GLOBAL opcode, so the rename is exact)."""
    with open(path, "rb") as f:
        host = pickle.load(f)
    blob = pickle.dumps(host, protocol=2)
    n = blob.count(b"crepro_torch.service.") + blob.count(b"crepro_torch.obs.")
    blob = blob.replace(b"crepro_torch.service.", b"crepro.service.") \
        .replace(b"crepro_torch.obs.", b"crepro.obs.")
    assert n > 0 and b"repro_torch" not in blob, n
    with open(path, "wb") as f:
        f.write(blob)
    return n


def _resume_case(name, paged, root):
    """An uninterrupted RESUME_TICKS run against one saved at RESUME_AT and
    resumed in a fresh service: bitwise.  Returns the save/restore
    figures and the crashed service (for the reference-form check)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import budget_alloc as ba
    ref = _service(name, paged=paged)
    ba.reset_launches()
    want = _rows_with_selections(ref, RESUME_TICKS)
    for k in PATH_KERNELS[name]:
        assert ba.LAUNCHES[k] > 0, (name, k, dict(ba.LAUNCHES))
    crashed = _service(name, paged=paged)
    head = _rows_with_selections(crashed, RESUME_AT)
    _service_rows_equal(f"{name} head", head, want, RESUME_AT, 0.0)
    tag = f"{name}-{'paged' if paged else 'carry'}"
    sync = CheckpointManager(str(root / tag / "sync"))
    t0 = time.perf_counter()
    crashed.save_checkpoint(sync)
    sync_ms = (time.perf_counter() - t0) * 1e3
    mgr = CheckpointManager(str(root / tag / "async"), async_save=True)
    t0 = time.perf_counter()
    step = crashed.save_checkpoint(mgr)
    call_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    async_ms = (time.perf_counter() - t0) * 1e3
    assert step == RESUME_AT
    resumed = _service(name, paged=paged)
    t0 = time.perf_counter()
    assert resumed.load_checkpoint(CheckpointManager(mgr.dir)) == RESUME_AT
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    assert resumed.state.demand.is_cuda
    tail = _rows_with_selections(resumed, RESUME_TICKS)
    _service_rows_equal(f"{tag} resumed", tail,
                        {k: v[RESUME_AT:] for k, v in want.items()},
                        RESUME_TICKS - RESUME_AT, 0.0)
    _states_equal(f"{tag} resumed", _state_copy(resumed), _state_copy(ref))
    assert _fingerprint(resumed.summary()) == _fingerprint(ref.summary()), \
        tag
    modes = resumed.summary()["paging"]["mode_ticks"]
    assert modes["paged" if paged else "carry"] > 0, (tag, modes)
    return dict(sync_ms=sync_ms, call_ms=call_ms, async_ms=async_ms,
                restore_ms=restore_ms, bytes=_step_bytes(mgr.dir, step)), \
        (crashed, ref, want)


def _stripe_kernel_checks():
    """rowmax, matvec and matvec_t against their twins at the shapes the
    sharded service hands them: one analyst row per slot, the ring's
    stripe at one and two stripes."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    M, B = SERVICE_GEOMETRY["analyst_slots"], SERVICE_GEOMETRY["block_slots"]
    errs = {}
    for S in (1, 2):
        g = torch.rand((M, B // S), generator=torch.Generator().manual_seed(S))
        g = (g * (g > 0.5)).cuda()
        v = torch.rand(B // S, generator=torch.Generator().manual_seed(9))
        v, x = v.cuda(), torch.rand(M).cuda()
        for name, got, want, bitwise in (
                ("rowmax", ba.rowmax(g), ref.rowmax_ref(g), True),
                ("matvec", ba.matvec(g, v), ref.matvec_ref(g, v), False),
                ("matvec_t", ba.matvec_t(g, x), ref.matvec_t_ref(g, x),
                 True)):
            errs[f"{name}@{M}x{B // S}"] = check(
                f"{name} at stripe {M}x{B // S}", got, want, bitwise)
    return errs


def phase_checkpoint_shard(smi):
    """Service checkpoints (bitwise resume, the reference's form) and the
    block-sharded service (one stripe under NCCL, two under Gloo with CUDA
    tensors on one card, elastic hand-off) at phase 20's defaults."""
    log(f"[21] service checkpoints and the sharded service at load.py's "
        f"defaults ({SERVICE_GEOMETRY}); {smi}")
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import SCHEDULER_NAMES
    from repro_torch.launch.sharded_service import (service_job,
                                                    service_jobs, spawn)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    # 4. (started first, joined below) the sharded service in spawned
    # ranks beside this process's checks: one stripe under NCCL, then the
    # two-stripe runs that restore its hand-off, and at the same time the
    # warm dpbalance run at two stripes (Gloo, CUDA tensors, every rank on
    # cuda:0), each in a process group of its own
    import concurrent.futures
    e1, e2, e3 = (str(root / d) for d in ("e1", "e2", "e3"))

    def timed(n_shards, backend, jobs):
        t0 = time.perf_counter()
        out = spawn(service_jobs, n_shards, backend=backend, device="cuda",
                    args=(jobs,), timeout=900)[0]
        return out, time.perf_counter() - t0

    def one_then_two():
        one = timed(1, "nccl", [_shard_job(n, STRIPE_TICKS[n][0])
                                for n in SCHEDULER_NAMES] +
                    [_shard_job("dpf", ELASTIC_AT[0], save=e1)])
        two = timed(2, "gloo", [
            _shard_job(n, STRIPE_TICKS[n][1]) for n in SCHEDULER_NAMES
            if n not in SHARD_WARM] + [
            _shard_job("dpf", ELASTIC_AT[1], restore=e1, save=e2),
            _shard_job("dpf", SHARD_TICKS // 2, save=e3, async_save=True),
            _shard_job("dpf", SHARD_TICKS, restore=e3)])
        return one, two

    pool = concurrent.futures.ThreadPoolExecutor(2)
    chained = pool.submit(one_then_two)
    warm = pool.submit(timed, 2, "gloo", [_shard_job(n, STRIPE_TICKS[n][1])
                                          for n in SHARD_WARM])
    pool.shutdown(wait=False)
    # 1. bitwise resume, every scheduler paged, dpbalance carry too
    for name in SCHEDULER_NAMES:
        for paged in ((True, False) if name == "dpbalance" else (True,)):
            fig, kept = _resume_case(name, paged, root)
            if name == "dpbalance" and paged:
                crashed, ref, want = kept
            log(f"  {name:9s} {'paged' if paged else 'carry'}: "
                f"{RESUME_TICKS} ticks vs saved at {RESUME_AT} and "
                f"resumed: rows, selections, final state and summary "
                f"fingerprint bitwise; save sync {fig['sync_ms']:.2f} ms, "
                f"async {fig['call_ms']:.2f} ms to return and "
                f"{fig['async_ms']:.2f} ms until wait() returned, restore "
                f"{fig['restore_ms']:.2f} ms, {fig['bytes']} bytes on disk")
    # 2. a checkpoint in the reference's form, written by the port's
    # manager: repro's npz keys, a payload naming repro.service classes
    mgr = CheckpointManager(str(root / "reference-form"))
    step = crashed.save_checkpoint(mgr)
    with np.load(Path(mgr.dir) / f"step_{step:010d}" / "state.npz") as z:
        keys = sorted(z.files)
    assert keys == sorted(f"a:{f.name}" for f in
                          dataclasses.fields(crashed.state)), keys
    n = _reference_form(Path(mgr.dir) / f"step_{step:010d}" / "host.pkl")
    resumed = _service("dpbalance")
    assert resumed.load_checkpoint(mgr) == RESUME_AT
    subs = [s for q in resumed.queue._classes.values() for s in q]
    assert all(type(s).__module__ == "repro_torch.service.traces"
               for s in subs)
    tail = _rows_with_selections(resumed, RESUME_TICKS)
    _service_rows_equal("reference-form resumed", tail,
                        {k: v[RESUME_AT:] for k, v in want.items()},
                        RESUME_TICKS - RESUME_AT, 0.0)
    _states_equal("reference-form resumed", _state_copy(resumed),
                  _state_copy(ref))
    log(f"  reference-form checkpoint (npz keys {keys[:3]}..., {n} class "
        f"references renamed to repro.service / repro.obs, "
        f"{len(subs)} queued Submissions): restored as repro_torch "
        f"classes and resumed bitwise to tick {RESUME_TICKS}")
    # 3. the sharded path's kernels at the stripe shapes
    errs = _stripe_kernel_checks()
    log("  stripe shapes, kernel vs twin max abs err: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))
    # 4. the sharded service against the unsharded card run
    cuda = torch.device("cuda")
    plain = {n: service_job(0, 1, cuda, _shard_job(n, SHARD_TICKS),
                            sharded=False) for n in SCHEDULER_NAMES}
    (one, one_s), (rest, rest_s) = chained.result()
    warm_runs, warm_s = warm.result()
    by_name = dict(zip([n for n in SCHEDULER_NAMES if n not in SHARD_WARM],
                       rest))
    by_name.update(zip(SHARD_WARM, warm_runs))
    two = [by_name[n] for n in SCHEDULER_NAMES] + \
        rest[len(SCHEDULER_NAMES) - len(SHARD_WARM):]
    two_s = max(one_s + rest_s, warm_s)
    log(f"  the spawned ranks ran beside this process's checks (1-3 and "
        f"the unsharded runs): one stripe {one_s:.1f} s then two stripes "
        f"{rest_s:.1f} s, and the warm two-stripe run {warm_s:.1f} s of "
        f"host clock, start-ups included; their ticks/s are measured "
        f"under that sharing")
    launches = {}
    for S, runs, secs, backend in ((1, one, one_s, "nccl"),
                                   (2, two, two_s, "gloo")):
        for name, got in zip(SCHEDULER_NAMES, runs):
            n = STRIPE_TICKS[name][S - 1]
            want = dict(plain[name], rows={
                k: v[:n] for k, v in plain[name]["rows"].items()})
            label = f"S={S} {backend} {name}" + (
                " (warm SP1)" if name in SHARD_WARM else "")
            _service_rows_equal(label, got["rows"], want["rows"], n,
                                RTOL_SERVICE)
            assert float(got["rows"]["conservation_gap"].max()) <= 1e-4 \
                and float(got["rows"]["overdraw"].max()) <= 1e-4, label
            assert got["summary"]["sharding"]["n_shards"] == S
            assert got["summary"]["paging"]["mode_ticks"]["paged"] > 0
            per = got["launches_per_tick"]
            for k in SHARD_KERNELS[name]:
                assert per[k] >= 1.0, (label, k, per)
            for k in ("dual_step", "boost_scan", "swap_eval"):
                assert per[k] == 0.0, (label, k, per)
            bitwise = all(np.array_equal(got["rows"][k], want["rows"][k])
                          for k in want["rows"])
            launches[(S, name)] = per
            log(f"  {label:30s}: {n} ticks, selections and "
                f"n_allocated equal the unsharded card run, rows within "
                f"{RTOL_SERVICE}; rows bitwise {bitwise}; "
                f"{got['ticks_per_second']:.2f} ticks/s (unsharded "
                f"{want['ticks_per_second']:.2f}); collectives per tick "
                f"{got['collectives_per_tick']}; budget-kernel launches "
                f"per tick {{'rowmax': {per['rowmax']:.2f}, 'matvec': "
                f"{per['matvec']:.2f}, 'matvec_t': {per['matvec_t']:.2f}}}")
        log(f"  S={S} ({backend}, every rank on cuda:0): {secs:.1f} s of "
            f"host clock to the last rank's end, start-ups included")
    # 5. elastic: 1 -> 2 stripes at ELASTIC_AT[0], 2 -> 1 at ELASTIC_AT[1]
    # (the last leg on the unsharded service, a one-stripe ring)
    back = service_job(0, 1, cuda, _shard_job("dpf", SHARD_TICKS,
                                              restore=e2), sharded=False)
    mid = two[len(SCHEDULER_NAMES)]
    a, b = ELASTIC_AT
    chain = {k: np.concatenate([one[len(SCHEDULER_NAMES)]["rows"][k],
                                mid["rows"][k], back["rows"][k]])
             for k in back["rows"]}
    _service_rows_equal("elastic 1 -> 2 -> 1", chain, plain["dpf"]["rows"],
                        SHARD_TICKS, RTOL_SERVICE)
    ref2, resumed2 = two[SCHEDULER_NAMES.index("dpf")], two[-1]
    h = SHARD_TICKS // 2
    _service_rows_equal("elastic 2 -> 2", resumed2["rows"],
                        {k: v[h:] for k, v in ref2["rows"].items()},
                        SHARD_TICKS - h, 0.0)
    for k in ref2["state"]:
        assert np.array_equal(resumed2["state"][k], ref2["state"][k]), k
    assert _fingerprint(resumed2["summary"]) == \
        _fingerprint(ref2["summary"])
    log(f"  elastic dpf 1 -> 2 stripes at tick {a}, 2 -> 1 at {b}: "
        f"selections equal the unsharded run, rows within {RTOL_SERVICE}; "
        f"dpf 2 -> 2 at tick {h} (async save): bitwise; {smi}")
    shutil.rmtree(root)
    # budget-kernel launches per sharded tick: {kernel: {"S1": {scheduler:
    # n}, "S2": {...}}}
    return {k: {f"S{S}": {n: launches[(S, n)][k] for n in SCHEDULER_NAMES}
                for S in (1, 2)} for k in REPLACES}


def _twin_scan_bwd(a, h, g, h0):
    """The twin's backward (``_TwinScan.backward``) on the same operands."""
    from repro_torch.kernels import rg_lru
    ctx = type("Ctx", (), {"saved_tensors": (a, h, h0)})()
    return rg_lru._TwinScan.backward(ctx, g)


def _scan_bwd_cases(card):
    """Phase 22 (a): the backward kernel bitwise its twin at RG_BWD_CASES,
    times beside the twin's and the bound; the JSON row."""
    from repro_torch.kernels import rg_lru
    gen = torch.Generator(device="cuda").manual_seed(22)
    row = {"max_abs_err": 0.0, "by_shape": {}}
    for label, B, S, D, with_h0 in RG_BWD_CASES:
        a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.499 + 0.5
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        g = torch.randn((B, S, D), generator=gen, device="cuda")
        h0 = torch.randn((B, D), generator=gen, device="cuda") \
            if with_h0 else None
        h = rg_lru.rglru_scan_cuda(a, b, h0)
        got = rg_lru.rglru_scan_bwd_cuda(a, h, g, h0)
        again = rg_lru.rglru_scan_bwd_cuda(a, h, g, h0)
        want = _twin_scan_bwd(a, h, g, h0)
        torch.cuda.synchronize()
        shape = f"B={B} S={S} D={D} h0={with_h0} ({label})"
        err = 0.0
        for part, x, y, w in zip(("dL/da", "dL/db", "dL/dh0"), got, again,
                                 want):
            assert (x is None) == (y is None) == (w is None), part
            if x is None:
                continue
            if not torch.equal(x, y):
                raise AssertionError(f"rglru_scan_bwd {shape} {part}: not "
                                     "bitwise stable from launch to launch")
            err = max(err, check(f"rglru_scan_bwd {shape} {part}", x, w,
                                 True))
        del got, again, want
        ms = time_ms(lambda: rg_lru.rglru_scan_bwd_cuda(a, h, g, h0), 20)
        plain = time_ms(lambda: _twin_scan_bwd(a, h, g, h0), 1, 3)
        nbytes = 4 * (5 * B * S * D + (2 * B * D if with_h0 else 0))
        bnd, by = bound_ms(nbytes, 3 * B * S * D)
        stage = rg_lru.scan_bwd_geometry(B, S, D)  # fresh: 16-byte aligned
        geo = (f"stage {stage}, ring of {rg_lru.SCAN_STAGES * stage} steps "
               f"({(rg_lru.SCAN_STAGES - 1) * stage * 12 * B * D} B in "
               f"flight), {rg_lru.SCAN_BWD_CHANNELS} channels a block"
               if stage else f"stage 0: direct path (no ring), "
               f"{rg_lru.SCAN_CHANNELS} channels a block")
        log(f"  rglru_scan_bwd   {shape}: bitwise (dL/da, dL/db"
            + (", dL/dh0" if with_h0 else "") + f"), stable  kernel "
            f"{ms:.4f} ms  twin {plain:.4f} ms  bound {bnd:.6f} ms ({by}, "
            f"{card}), share {bnd / ms:.3f}; {geo}; no single PyTorch call "
            "computes it")
        nums = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None, shape=shape, stage=stage)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["by_shape"][label] = nums
        if label == "2k":                  # the JSON line's shape
            row.update(nums)
        del a, b, g, h0, h
        torch.cuda.empty_cache()
    return row


def _states_bitwise(label, a, b):
    """Raise unless two training states hold equal parameters (bit for
    bit, each dtype's buffer), optimizer leaves and step."""
    for dt, buf in a["params"].flats.items():
        other = b["params"].flats[dt]
        if dt == torch.bfloat16:
            buf, other = buf.view(torch.int16), other.view(torch.int16)
        assert torch.equal(buf, other), (label, dt)
    for part in ("m", "v", "master"):
        for k, t in a["opt"][part].items():
            assert torch.equal(t, b["opt"][part][k]), (label, part, k)
    assert int(a["step"]) == int(b["step"]), label


def _batch_on(cfg, i, batch, seq, device):
    """``synth_tokens`` step ``i`` as the launcher feeds it."""
    from repro_torch.data.pipeline import synth_tokens
    return {k: torch.as_tensor(v, device=device)
            for k, v in synth_tokens(i, batch, seq, cfg.vocab).items()}


def _launcher_runs(card):
    """Phase 22 (b): the launcher at its defaults, resumed from step 10,
    one traced step; returns the configuration."""
    from repro_torch.launch import train as launcher
    from repro_torch.training import train_step
    root = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    t0 = time.perf_counter()
    n, every = LAUNCH_STEPS, LAUNCH_STEPS // 2
    full = launcher.run(steps=n, ckpt_every=every, ckpt=str(root), log=None)
    full_s = time.perf_counter() - t0
    cfg, tcfg = full["cfg"], full["tcfg"]
    assert cfg.name == "flaas-100m" and full["checkpoints"] == [every, n]
    assert full["state"]["params"].flat.numel() == P_FLAAS
    losses = [r["loss"] for r in full["records"]]
    assert all(math.isfinite(x) for x in losses), losses
    shutil.rmtree(root / f"step_{n:010d}")
    rest = launcher.run(steps=n - every, ckpt_every=every, ckpt=str(root),
                        log=None)
    assert rest["resumed_from"] == every

    def strip(records):
        return [{k: v for k, v in r.items() if k != "wall_s"}
                for r in records]
    assert strip(rest["records"]) == strip(full["records"][every:]), \
        "resume"
    _states_bitwise("resume", rest["state"], full["state"])
    walls = [r["wall_s"] * 1e3 for r in full["records"][1:]]
    log(f"  launch/train.run at its defaults cut to {n} of 20 steps "
        f"(flaas-100m, {P_FLAAS} parameters, B=8 x 128, 2 microbatches, "
        f"noise 0.2, checkpoints every {every}): {full_s:.2f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; ms per step (host clock, "
        f"steps 1-{n - 1}) median {statistics.median(walls):.2f}, range "
        f"{min(walls):.2f}-{max(walls):.2f}; resumed at step {every} and "
        f"rerun to {n}: metrics, parameters and optimizer state bitwise "
        f"({card})")
    state = rest["state"]
    del full, rest
    shutil.rmtree(root)
    b = _batch_on(cfg, 20, 8, 128, "cuda")
    train_step(state, b, cfg, tcfg)                      # warm
    busy, rows, wall = _device_kernels(
        lambda: train_step(state, b, cfg, tcfg))
    log(f"  one traced train step: wall {wall:.2f} ms, card busy "
        f"{busy:.2f} ms (share {busy / wall:.4f}); top kernels (ms): "
        + ", ".join(f"{k[:40]} {ms:.2f}" for k, ms in rows[:6]))
    wall, in_ops, n_ops, rows = _host_ops(
        lambda: train_step(state, b, cfg, tcfg))
    launches = sum(n for k, n in _op_counts(
        lambda: train_step(state, b, cfg, tcfg)).items()
        if k.startswith("cudaLaunchKernel"))
    log(f"  host profile of one train step: wall {wall:.2f} ms, inside "
        f"PyTorch ops {in_ops:.2f} ms in {n_ops} top-level ops, "
        f"{launches} kernel launches; top ops by self time (ms): "
        + ", ".join(f"{k[:40]} {ms:.2f}" for k, ms in rows[:8]))
    return cfg


def _train_card_vs_cpu():
    """Phase 22 (b): one step without noise on the card and on the CPU
    (the CPU worker) from the same state."""
    from repro_torch.training import train_step
    cfg, quiet, dev = _quiet_step_state("cuda")
    t0 = time.perf_counter()
    st, m = train_step(dev, _batch_on(cfg, 0, 8, 128, "cuda"), cfg, quiet)
    pc, mc = st["params"].flat.cpu(), {k: float(v) for k, v in m.items()}
    card_s = time.perf_counter() - t0
    (ph, mh), host_s = cpu_ref(("train_step",))
    ph = _from_file(ph)
    for k in mh:
        assert abs(mc[k] - mh[k]) <= RTOL_TRAIN * abs(mh[k]), (k, mc, mh)
    # Adam's first step moves a parameter by lr * g / (|g| + eps): a
    # gradient that rounds to the other sign moves it by at most 2 lr
    pmax = float(ph.abs().max())
    perr = float((pc - ph).abs().max())
    assert perr <= 2 * quiet.lr + 1e-6 * pmax, perr
    n_off = int(((pc - ph).abs() > 1e-6 * pmax).sum())
    log(f"  one step without noise, card vs CPU: loss {mc['loss']:.6f} / "
        f"{mh['loss']:.6f}, metrics within {RTOL_TRAIN} relative; "
        f"parameters max err {perr:.3e} (bound 2 lr = {2 * quiet.lr:g}), "
        f"{n_off} of {ph.numel()} beyond 1e-6 of max|p|; card step "
        f"{card_s:.2f} s, CPU step {host_s:.2f} s (the CPU worker)")


def _train_hybrid():
    """Phase 22 (c): recurrentgemma-2b at full width, one group; returns
    the scan launches of RG_TRAIN["steps"] steps."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import rg_lru
    from repro_torch.launch import train as launcher
    from repro_torch.training import make_state, train_step
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b"),
                              n_layers=RG_TRAIN["n_layers"])
    n_rec = [k for k, _ in cfg.layer_specs()].count("rec")
    tcfg = launcher.train_config(cfg, RG_TRAIN["batch"], 0.2, 1.0)
    n_micro, steps = tcfg.dp.n_micro, RG_TRAIN["steps"]
    state = make_state(0, cfg, tcfg, device="cuda")
    batches = [_batch_on(cfg, i, RG_TRAIN["batch"], RG_TRAIN["seq"], "cuda")
               for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    walls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, tcfg)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    scan = {**rg_lru.LAUNCHES, **rg_lru.BWD_LAUNCHES}
    expect = n_rec * n_micro * steps
    assert scan == {"rglru_scan": expect, "rglru_scan_bwd": expect}, scan
    assert all(math.isfinite(x) for x in losses), losses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  recurrentgemma-2b, {cfg.n_layers} layers ({n_rec} rec), "
        f"{state['params'].flat.numel()} parameters, B={RG_TRAIN['batch']} "
        f"x {RG_TRAIN['seq']}, {n_micro} microbatches, noise 0.2: losses "
        f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
        f"{[round(w, 2) for w in walls]}; scan launches {scan} ({n_rec} rec "
        f"x {n_micro} microbatches x {steps} steps each); peak device "
        f"memory {peak:.2f} GiB")
    # one microbatch's gradients, card against CPU, from the same values
    model = state["params"]
    del state
    torch.cuda.empty_cache()
    _grads_card_vs_cpu(model, {k: v[:RG_TRAIN["batch"] // n_micro]
                               for k, v in batches[0].items()})
    return scan


def _grads_card_vs_cpu(model, mb):
    """Phases 22 (c) and 26: the loss's gradients on the microbatch
    ``mb``, card against CPU from the same values, within GRAD_RTOL_TRAIN
    of the largest |g|."""
    from repro_torch.models import Transformer
    from repro_torch.training import make_loss_fn
    host = Transformer(model.cfg, device="cpu")
    with torch.no_grad():
        host.flat.copy_(model.flat)
    loss_fn = make_loss_fn(model.cfg)
    grads = []
    for mdl in (model, host):
        t0 = time.perf_counter()
        bb = {k: v.to(mdl.flat.device) for k, v in mb.items()}
        g = torch.autograd.grad(loss_fn(mdl, bb), list(mdl.parameters()))
        grads.append(torch.cat([x.reshape(-1) for x in g]).cpu())
        del g
    gmax = float(grads[1].abs().max())
    gerr = float((grads[0] - grads[1]).abs().max())
    assert gerr <= GRAD_RTOL_TRAIN * gmax, (gerr, gmax)
    log(f"  one microbatch's gradients ({tuple(mb['tokens'].shape)} tokens) "
        f"card vs CPU: max err {gerr:.3e} of max|g| {gmax:.3e} (bound "
        f"{GRAD_RTOL_TRAIN} x max|g|); CPU {time.perf_counter() - t0:.2f} s")


def _train_example_mode(cfg):
    """Phase 22 (d): one DP example-mode step on flaas-100m."""
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.training import (DPConfig, TrainConfig, make_state,
                                      train_step)
    tcfg = TrainConfig(optimizer="adamw", param_dtype="float32",
                       dp=DPConfig(clip=1.0, noise_multiplier=0.2,
                                   mode="example"))
    state = make_state(1, cfg, tcfg, device="cuda")
    b = _batch_on(cfg, 0, 8, 128, "cuda")
    dp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = train_step(state, b, cfg, tcfg)
    loss = float(m["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(dp.LAUNCHES)
    assert launches == {"rownorms": 1, "clip_accumulate": 1}, launches
    assert math.isfinite(loss) and 0.0 <= float(m["clip_frac"]) <= 1.0
    log(f"  DP example mode, flaas-100m, B=8 x 128 (8 per-example "
        f"gradients of {P_FLAAS}): loss {loss:.4f}, clip_frac "
        f"{float(m['clip_frac']):.3f}, {wall:.2f} ms (host clock, first "
        f"step); launches {launches}")
    dp.reset_launches()


def phase_train(card):
    log("[22] training: the scan's backward kernel; launch/train.py on "
        "flaas-100m; recurrentgemma-2b at full width, 3 layers; DP example "
        "mode")
    t0 = time.perf_counter()
    row = _scan_bwd_cases(card)
    cfg = _launcher_runs(card)
    torch.cuda.empty_cache()
    _train_card_vs_cpu()
    torch.cuda.empty_cache()
    scan = _train_hybrid()
    torch.cuda.empty_cache()
    _train_example_mode(cfg)
    torch.cuda.empty_cache()
    log(f"  phase 22 took {time.perf_counter() - t0:.1f} s")
    per_step = {k: v // RG_TRAIN["steps"] for k, v in scan.items()}
    return row, per_step, scan["rglru_scan_bwd"]


def _l2_flushed_ms(fn, trials: int = 20) -> float:
    """Median device ms of one ``fn()`` launched right after 256 MB were
    written (five times the 50 MB L2), so its inputs come from HBM."""
    junk = torch.empty(64 * 2 ** 20, device="cuda")
    fn()
    times = []
    for _ in range(trials):
        junk.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del junk
    return statistics.median(times)


def phase_dense_attention(card, att_rows):
    log("[23] attention kernels at the dense family's heads (dh 128)")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    for name, _, short in DENSE:
        cfg = get_arch(name)
        log(f"  {name}: {cfg.n_heads} query heads over {cfg.kv_heads} kv "
            f"heads, dh {cfg.dh}; decode head groups "
            f"{da.HEAD_GROUPS[cfg.dh, cfg.n_heads // cfg.kv_heads]}, "
            f"resident split blocks per SM "
            f"{da.resident_blocks(cfg.dh, cfg.n_heads // cfg.kv_heads)}")
        _attention_cases(
            card, (cfg.n_heads, cfg.kv_heads, cfg.dh),
            [(f"{short}-{lb}", *c) for lb, *c in DENSE_FLASH_CASES],
            [(f"{short}-{lb}", *c) for lb, *c in DENSE_DECODE_CASES],
            att_rows)
    # starcoder2-15b's two head groups each read their kv head's K/V.  The
    # cache (34 MB) fits the 50 MB L2, so back-to-back launches read it
    # from L2; with the L2 flushed before each launch, a launch whose
    # second group also went to HBM would pay two reads of the cache over
    # the warm time, one whose second read hit L2 one.  G 6 (24 heads, one
    # group) on the same cache is the one-read yardstick.
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, L, n = 4, 2112, 2080
    k = torch.randn((B, L, 4, 128), generator=gen, device="cuda")
    v = torch.randn((B, L, 4, 128), generator=gen, device="cuda")
    nbytes = 2 * B * n * 4 * 128 * 4
    one_read = bound_ms(nbytes, 0)[0]
    for H in (48, 24):
        q = torch.randn((B, H, 128), generator=gen, device="cuda")
        warm = time_ms(lambda: da.decode_attention_cuda(q, k, v, n), 20)
        cold = _l2_flushed_ms(lambda: da.decode_attention_cuda(q, k, v, n))
        log(f"  {H} query heads over 4 (G {H // 4}, "
            f"{da.HEAD_GROUPS[128, H // 4]} head group(s)), B={B} n={n}: "
            f"L2 flushed {cold:.4f} ms, warm {warm:.4f} ms, difference "
            f"{cold - warm:.4f} ms against one HBM read of the "
            f"{nbytes}-byte cache {one_read:.4f} ms ({card})")
    da.reset_launches()


def _cut_model(model, n_layers, device, enc_layers=None):
    """``model``'s embedding, first ``n_layers`` blocks, final norm and LM
    head (and, with ``enc_layers``, its encoder's first ``enc_layers``
    blocks and final norm) as a model of ``n_layers`` layers on
    ``device``."""
    from repro_torch.configs import EncoderSpec
    from repro_torch.models import Transformer
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, encoder=EncoderSpec(enc_layers))
    out = Transformer(cfg, device=device, dtype=model.dtype)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(src[name])
    return out


def _busy_shares(model, B, prompt, steps=4, cross=None):
    """The card's busy share (torch.profiler) over a traced prefill of B
    seeded prompts of ``prompt`` tokens and over ``steps`` traced decode
    steps after it, each after an untraced warm-up of the same work.
    Short windows: tracing a whole long serve costs tens of seconds of
    the profiler's own host work.  ``cross`` holds the prefill's
    ``memory=`` or ``enc_frames=`` (moved to the card)."""
    from repro_torch.models import forward_with_cache
    from repro_torch.training import serve_step
    cfg = model.cfg
    prompts = torch.randint(0, cfg.vocab, (B, prompt),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32).cuda()
    total = prompt + 2 * steps + 1
    cross = {n: x.cuda() for n, x in (cross or {}).items()}

    def prefill():
        logits, cache = forward_with_cache(model, prompts, cfg, total,
                                           **cross)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), cache

    def decode(tok, cache, start):
        for i in range(steps):
            tok, _, cache = serve_step(model, tok, cache, start + i, cfg)
        return tok

    prefill()
    state = {}
    pre_busy, _, pre_wall = _device_kernels(
        lambda: state.update(zip(("tok", "cache"), prefill())))
    tok = decode(state["tok"], state["cache"], prompt)
    dec_busy, _, dec_wall = _device_kernels(
        lambda: decode(tok, state["cache"], prompt + steps))
    return pre_busy / pre_wall, dec_busy / dec_wall


def _serve_runs(model, expect_fn, label, trace_prompt=LONG_TRACE,
                runs=SERVE_RUNS,
                cross=None):
    """The launcher's defaults and the long serve (``runs``) on ``model``,
    each checked for its launches (``expect_fn(gen)``) and tokens, then
    the card's busy share over a traced prefill and 4 decode steps at the
    same shape (the traced prompt cut to ``trace_prompt`` tokens where
    given).  ``cross`` (``{"memory": x}`` or ``{"enc_frames": x}``, on
    the CPU) goes to every serve and traced prefill.  Returns ``{run:
    launches}``."""
    from repro_torch.launch import serve
    cfg = model.cfg
    cross = cross or {}
    out = {}
    for run_name, B, prompt, gen in runs:
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        run = serve.run(model=model, batch=B, prompt_len=prompt, gen=gen,
                        log=None, **cross)
        assert run["launches"] == expect_fn(gen), \
            (label, run_name, run["launches"])
        tok = run["tokens"]
        assert tok.shape == (B, gen) and int(tok.min()) >= 0 and \
            int(tok.max()) < cfg.vocab
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        traced = min(prompt, trace_prompt or prompt)
        pre, dec = _busy_shares(model, B, traced, cross=cross)
        steps = run["step_ms"]
        log(f"  {label} {run_name} (B={B}, prompt {prompt}, gen {gen}): "
            f"prefill {run['prefill_ms']:.2f} ms, decode "
            f"{statistics.median(steps):.3f} ms/step median "
            f"({min(steps):.3f}-{max(steps):.3f}), {run['tok_per_s']:.1f} "
            f"tok/s; card busy share {pre:.4f} over a traced prefill "
            f"of {traced} tokens, "
            f"{dec:.4f} over 4 traced decode steps; launches "
            f"{run['launches']}; peak card memory {peak:.2f} GiB")
        out[run_name] = run["launches"]
    _reset_launches()
    return out


def phase_serve_dense():
    log("[24] serve the dense family through repro_torch.launch.serve")
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    gen = 16
    launches = {}
    for name, layers, _ in DENSE:
        t_cfg = time.perf_counter()
        full = get_arch(name)
        cfg = dataclasses.replace(full, n_layers=layers) if layers else full
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_model(cfg, 0, device="cuda")
        how = "drawn on the card by init_model"
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        if name in P_DENSE:
            assert model.flat.numel() == P_DENSE[name], model.flat.numel()
        log(f"  {name}: {cfg.n_layers} of {full.n_layers} layers, "
            f"{model.flat.numel()} float32 parameters "
            f"({model.flat.numel() * 4 / 1e9:.1f} GB), {how} in "
            f"{draw_s:.2f} s (host clock)")

        # card vs CPU on the model cut to DENSE_CPU_LAYERS layers
        nl = DENSE_CPU_LAYERS
        card_m = _cut_model(model, nl, "cuda")
        host_m = _cut_model(card_m, nl, "cpu")
        _reset_launches()
        card = serve.run(model=card_m, gen=gen, keep_logits=True, log=None)
        assert card["launches"] == {"flash_attention": nl,
                                    "decode_attention": nl * (gen - 1),
                                    "rglru_scan": 0}, card["launches"]
        t0 = time.perf_counter()
        host = serve.run(model=host_m, gen=gen, keep_logits=True, log=None)
        host_s = time.perf_counter() - t0
        forced = serve.run(model=card_m, gen=gen, feed=host["tokens"],
                           keep_logits=True, log=None)
        errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
        log(f"  {name} at {nl} layers ({card_m.flat.numel()} parameters) "
            f"card vs CPU: prefill logits max err {errs['prefill']:.3e}, "
            f"teacher-forced decode logits max err {errs['decode']:.3e} "
            f"(bound {RTOL_SERVE} x max|logit| = {bound:.3e}); tokens equal "
            f"except at {len(ties)} printed near-ties; CPU run "
            f"{host_s:.2f} s")
        del card_m, host_m, card, host, forced
        torch.cuda.empty_cache()

        n = cfg.n_layers
        launches[name] = _serve_runs(
            model, lambda g: {"flash_attention": n,
                              "decode_attention": n * (g - 1),
                              "rglru_scan": 0}, name)
        del model
        torch.cuda.empty_cache()
        log(f"  {name} took {time.perf_counter() - t_cfg:.1f} s")
    return launches


def _rel_err(got, want):
    """Max |got - want| over max |want| (``got`` on either device)."""
    return float((got.cpu().double() - want.double()).abs().max() /
                 max(float(want.double().abs().max()), 1e-30))


def _xlstm_blocks_card_vs_cpu(model, host, prompt):
    """Phase 25: every block on the card fed the CPU model's input to it,
    a prefill of ``prompt`` tokens and one decode step from its state:
    block outputs within RTOL_SERVE and states within RTOL_STATE of their
    largest |value|.  Returns the worst of each."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import apply_block
    cfg = model.cfg
    tok = torch.randint(0, cfg.vocab, (4, prompt + 1),
                        generator=torch.Generator().manual_seed(2))
    worst = {"out": 0.0, "state": 0.0, "decode": 0.0}
    with torch.no_grad():
        h = L.embed(tok[:, :prompt], host.embed)
        x = L.embed(tok[:, prompt:], host.embed)
        pos, step = torch.arange(prompt), torch.full((1,), prompt)
        for i, (bh, bc) in enumerate(zip(host.blocks, model.blocks)):
            want, sw = apply_block(h, bh, bh.kind, cfg, positions=pos,
                                   attend=None)
            got, sg = apply_block(h.cuda(), bc, bc.kind, cfg,
                                  positions=pos.cuda(), attend=None)
            dw, _ = apply_block(x, bh, bh.kind, cfg, positions=step,
                                attend=None, state=sw)
            dg, _ = apply_block(x.cuda(), bc, bc.kind, cfg,
                                positions=step.cuda(), attend=None,
                                state=tuple(t.cuda() for t in sw))
            errs = {"out": _rel_err(got - h.cuda(), want - h),
                    "state": max(_rel_err(a, b) for a, b in zip(sg, sw)),
                    "decode": _rel_err(dg - x.cuda(), dw - x)}
            assert errs["out"] <= RTOL_SERVE and \
                errs["decode"] <= RTOL_SERVE and \
                errs["state"] <= RTOL_STATE, (i, bh.kind, errs)
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
            h = want
    return worst


def phase_serve_xlstm():
    log("[25] serve xlstm-125m through repro_torch.launch.serve")
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.models import recurrent as R
    t_phase = time.perf_counter()
    cfg = get_arch("xlstm-125m")
    gen = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = serve.make_model(cfg, 0, torch.device("cuda"))
    torch.cuda.synchronize()
    assert model.flat.numel() == P_XLSTM
    log(f"  make_model(xlstm-125m): {P_XLSTM} float32 parameters, "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    host_m = Transformer(cfg, device="cpu")
    with torch.no_grad():
        host_m.flat.copy_(model.flat)
    worst = _xlstm_blocks_card_vs_cpu(model, host_m, 32)
    log(f"  every block fed the CPU's input to it, card vs CPU: outputs "
        f"{worst['out']:.3e}, states {worst['state']:.3e}, one decode "
        f"step's outputs {worst['decode']:.3e} of their largest |value| "
        f"(bounds {RTOL_SERVE}, {RTOL_STATE}, {RTOL_SERVE})")

    # one pattern group (mlstm x 3, slstm) of full width, as phase 15
    zero = {"flash_attention": 0, "decode_attention": 0, "rglru_scan": 0}
    group = len(cfg.pattern)
    runs = {}
    for name, mdl, hm in (("group", _cut_model(model, group, "cuda"),
                           _cut_model(host_m, group, "cpu")),
                          ("whole", model, host_m)):
        _reset_launches()
        card = serve.run(model=mdl, gen=gen, keep_logits=True, log=None)
        assert card["launches"] == zero, card["launches"]
        host = serve.run(model=hm, gen=gen, keep_logits=True, log=None)
        forced = serve.run(model=mdl, gen=gen, feed=host["tokens"],
                           keep_logits=True, log=None)
        runs[name] = (card, host, forced, hm)
    card, host, forced, _ = runs["group"]
    errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
    log(f"  one group ({group} layers, {card['cfg'].n_layers} of "
        f"{cfg.n_layers}) card vs CPU: prefill logits max err "
        f"{errs['prefill']:.3e}, teacher-forced decode logits max err "
        f"{errs['decode']:.3e} (bound {RTOL_SERVE} x max|logit| = "
        f"{bound:.3e}); tokens equal except at {len(ties)} printed "
        f"near-ties")
    # the whole model beside its own spread: the CPU run again with every
    # parameter moved PARAM_NOISE relative (one float32 ulp)
    card, host, forced, hm = runs.pop("whole")
    noisy = Transformer(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        noisy.flat.copy_(hm.flat * (1 + PARAM_NOISE * torch.randn(
            hm.flat.shape, generator=g)))
    spread = serve.run(model=noisy, gen=gen, feed=host["tokens"],
                       keep_logits=True, log=None)
    for part in ("prefill", "decode"):
        err = _rel_err(forced["logits"][part], host["logits"][part])
        own = _rel_err(spread["logits"][part], host["logits"][part])
        assert err <= max(RTOL_SERVE, SPREAD_FACTOR * own), (part, err, own)
        log(f"  whole model, {part} logits (teacher-forced): card vs CPU "
            f"{err:.3e} of max|logit|; the CPU against itself with every "
            f"parameter moved {PARAM_NOISE:g} relative {own:.3e} (bound "
            f"the larger of {RTOL_SERVE} and {SPREAD_FACTOR} x that)")
    same = float((card["tokens"] == host["tokens"]).float().mean())
    log(f"  whole model, free-running greedy tokens equal to the CPU's: "
        f"{same:.4f} of {card['tokens'].numel()}")
    del runs, card, host, forced, hm, noisy, spread
    # a traced prefill of 2048 tokens is ~90,000 launches of the sLSTM's
    # loop (each step the same ~15), tens of seconds of the profiler's own
    # work: the busy share is taken over 256 tokens
    launches = _serve_runs(model, lambda _: zero, "xlstm-125m",
                           trace_prompt=256)
    # the sLSTM's host loop: its share of a long prefill and 8 decode steps
    spans = {}
    B, prompt = SERVE_RUNS[1][1:3]
    with _timed_spans([(R, "slstm_scan", "slstm"),
                       (R, "mlstm_chunkwise", "mlstm"),
                       (R, "mlstm_decode_step", "mlstm step")], spans):
        run = serve.run(model=model, batch=B, prompt_len=prompt, gen=9,
                        log=None)
    log(f"  synchronised spans over a B={B} x {prompt} prefill "
        f"({run['prefill_ms']:.2f} ms) and 8 decode steps "
        f"({sum(run['step_ms']):.2f} ms): "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in spans.items())
        + f" (3 sLSTM blocks: {prompt} host steps each in the prefill, 1 "
        f"a decode step); phase 25 took {time.perf_counter() - t_phase:.1f}"
        f" s")
    return launches


def _xlstm_block_grads(model, host, tokens):
    """Phase 26: every block's gradients on the card (``model``), fed the
    CPU model's (``host``, the same values) input to it and the same
    seeded upstream gradient: the input's and every parameter's within
    GRAD_RTOL_TRAIN of its largest |g|.  Returns the worst."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import apply_block_train
    cfg = model.cfg
    with torch.no_grad():
        h = L.embed(tokens, host.embed)
    gen = torch.Generator().manual_seed(3)
    pos = torch.arange(tokens.shape[1])
    worst = 0.0
    for i, (bh, bc) in enumerate(zip(host.blocks, model.blocks)):
        gy = torch.randn(h.shape, generator=gen)
        out = []
        for blk, dev in ((bh, "cpu"), (bc, "cuda")):
            x = h.to(dev).requires_grad_(True)
            y = apply_block_train(x, blk, blk.kind, cfg,
                                  positions=pos.to(dev))
            out.append(torch.autograd.grad((y * gy.to(dev)).sum(),
                                           [x, *blk.parameters()]))
        for want, got in zip(*out):
            err = _rel_err(got, want)
            assert err <= GRAD_RTOL_TRAIN, (i, bh.kind, err)
            worst = max(worst, err)
        with torch.no_grad():
            h = apply_block_train(h, bh, bh.kind, cfg, positions=pos)
    return worst


def _xlstm_dp_card_vs_exact(cfg, card):
    """Phase 26: DP-SGD's gradients of xlstm-125m at ``card``'s parameters
    (on the card) without noise, in the launcher's microbatch mode (B=8 x
    128, two microbatches) and in example mode (its first 2 examples): the
    card's float32, the CPU's float32 and the exact values (float64 on the
    card, ``repro_torch.fp.float64``; for example mode, microbatches of one
    example).  The card's loss, norm mean and max and clipped mean
    gradient are each no further from the exact value than the larger of
    RTOL_TRAIN (relative) and SPREAD_FACTOR times the CPU's own distance
    from it."""
    from repro_torch.fp import float64
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.models import Transformer
    from repro_torch.training import dp_gradients, make_loss_fn
    loss_fn = make_loss_fn(cfg)
    host = Transformer(cfg, device="cpu")
    exact = Transformer(cfg, device="cuda")
    with torch.no_grad():
        host.flat.copy_(card.flat)
        exact.flat.copy_(card.flat)
    exact = exact.double()
    full = _batch_on(cfg, 0, NEW_TRAIN["batch"], NEW_TRAIN["seq"], "cpu")
    for mode, B, n_micro in (("microbatch", NEW_TRAIN["batch"], 2),
                             ("example", 2, 1)):
        out, secs = {}, {}
        for name, mdl, kw in (
                ("card", card, dict(mode=mode, n_micro=n_micro)),
                ("cpu", host, dict(mode=mode, n_micro=n_micro)),
                ("exact", exact, dict(mode="microbatch", n_micro=(
                    n_micro if mode == "microbatch" else B)))):
            dev = next(mdl.parameters()).device
            bb = {k: v[:B].to(dev) for k, v in full.items()}
            t0 = time.perf_counter()
            with float64() if name == "exact" else contextlib.nullcontext():
                g, m = dp_gradients(loss_fn, mdl, bb, torch.Generator(
                    device=dev).manual_seed(0), clip=1.0, **kw)
            out[name] = (torch.cat([x.reshape(-1) for x in g.values()]
                                   ).double().cpu(),
                         {k: float(v) for k, v in m.items()})
            secs[name] = time.perf_counter() - t0
            del g
        dp.reset_launches()
        ref_g, ref_m = out["exact"]
        dist = {n: float((out[n][0] - ref_g).norm() / ref_g.norm())
                for n in ("card", "cpu")}
        assert dist["card"] <= max(RTOL_TRAIN, SPREAD_FACTOR * dist["cpu"]), \
            (mode, dist)
        for k in ("loss_mean", "grad_norm_mean", "grad_norm_max"):
            err = {n: abs(out[n][1][k] - ref_m[k]) for n in ("card", "cpu")}
            assert err["card"] <= max(RTOL_TRAIN * abs(ref_m[k]),
                                      SPREAD_FACTOR * err["cpu"]), \
                (mode, k, {n: out[n][1] for n in out})
        assert out["card"][1]["clip_frac"] == ref_m["clip_frac"], mode
        show = {n: {k: round(out[n][1][k], 7) for k in
                    ("loss_mean", "grad_norm_mean", "grad_norm_max")}
                for n in ("card", "cpu", "exact")}
        log(f"  whole model, DP {mode} mode, B={B} x {NEW_TRAIN['seq']}, "
            f"{n_micro if mode == 'microbatch' else B} units, no noise: "
            f"{show}; clipped mean gradient, |g - exact| / |exact| card "
            f"{dist['card']:.4e}, CPU {dist['cpu']:.4e} (bound the larger "
            f"of {RTOL_TRAIN} and {SPREAD_FACTOR} x the CPU's, each number "
            f"alike); host clock card {secs['card']:.2f} s, CPU "
            f"{secs['cpu']:.2f} s, exact {secs['exact']:.2f} s")
    del host, exact


def phase_train_new():
    log("[26] training the dense family and xlstm-125m at launch/train.py's "
        "configuration, card vs CPU")
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.models import Transformer
    from repro_torch.training import make_state, train_step
    t_phase = time.perf_counter()
    B, S, steps = NEW_TRAIN["batch"], NEW_TRAIN["seq"], NEW_TRAIN["steps"]

    # qwen2.5-3b at full width, cut to 2 layers: two steps, then one
    # microbatch's gradients card vs CPU (as phase 22 (c))
    cfg = dataclasses.replace(get_arch("qwen2.5-3b"),
                              n_layers=NEW_TRAIN["dense_layers"])
    tcfg = launcher.train_config(cfg, B, 0.2, 1.0)
    torch.cuda.reset_peak_memory_stats()
    state = make_state(0, cfg, tcfg, device="cuda")
    batches = [_batch_on(cfg, i, B, S, "cuda") for i in range(steps)]
    walls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, tcfg)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    assert all(math.isfinite(x) for x in losses), losses
    log(f"  qwen2.5-3b at full width, {cfg.n_layers} layers "
        f"({state['params'].flat.numel()} parameters), B={B} x {S}, "
        f"{tcfg.dp.n_micro} microbatches, noise 0.2: losses "
        f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
        f"{[round(w, 2) for w in walls]}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    model = state["params"]
    del state
    torch.cuda.empty_cache()
    _grads_card_vs_cpu(model, {k: v[:B // tcfg.dp.n_micro]
                               for k, v in batches[0].items()})
    del model, batches
    torch.cuda.empty_cache()

    # xlstm-125m whole through the launcher itself
    root = Path(tempfile.mkdtemp(prefix="train_xlstm_"))
    torch.cuda.reset_peak_memory_stats()
    run = launcher.run(arch="xlstm-125m", steps=steps, batch=B, seq=S,
                       ckpt=str(root), log=None)
    shutil.rmtree(root)
    losses = [r["loss"] for r in run["records"]]
    assert all(math.isfinite(x) for x in losses), losses
    assert run["state"]["params"].flat.numel() == P_XLSTM
    log(f"  launch/train.run(arch='xlstm-125m', steps={steps}): B={B} x "
        f"{S}, {run['tcfg'].dp.n_micro} microbatches, noise 0.2: losses "
        f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
        f"{[round(r['wall_s'] * 1e3, 2) for r in run['records']]}; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB")
    model, cfg, run_tcfg = run["state"]["params"], run["cfg"], run["tcfg"]
    del run
    mb = {k: v[:B // 2] for k, v in _batch_on(cfg, 0, B, S, "cpu").items()}
    host = Transformer(cfg, device="cpu")
    with torch.no_grad():
        host.flat.copy_(model.flat)
    worst = _xlstm_block_grads(model, host, mb["tokens"])
    log(f"  every block's gradients (input and parameters) fed the CPU's "
        f"input to it and the same upstream gradient, card vs CPU: worst "
        f"{worst:.3e} of the largest |g| (bound {GRAD_RTOL_TRAIN})")
    del model, host
    torch.cuda.empty_cache()
    # the whole model's DP gradients at the launcher's starting point on
    # the card, card and CPU against the exact values
    _xlstm_dp_card_vs_exact(cfg, make_state(0, cfg, run_tcfg,
                                            device="cuda")["params"])
    torch.cuda.empty_cache()
    log(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s")


def _cross_launches(cfg, gen):
    """The serving kernels' launches of one serve of ``cfg`` with ``gen``
    tokens: a flash launch per layer in the prefill (self attention, or
    an ``xattn`` block's cross attention), one more per ``encdec`` layer
    (its cross attention) and one per encoder layer; a decode launch per
    layer and one more per ``encdec`` layer in each step after the
    first."""
    kinds = [k for k, _ in cfg.layer_specs()]
    n = len(kinds) + kinds.count("encdec")
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return {"flash_attention": n + enc, "decode_attention": n * (gen - 1),
            "rglru_scan": 0}


def _seed_nonzero(model, seed):
    """What repro's init leaves zero or one, seeded so that a wrong index
    shows: every norm scale and bias and QKV bias moved by 0.1 N(0, 1),
    the xattn gates set to 0.5 and -0.7 plus 0.1 N(0, 1) (at zero a
    cross-attention block adds nothing).  Drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias", "bq", "bk", "bv"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
            elif leaf in ("gate_x", "gate_m"):
                base = 0.5 if leaf == "gate_x" else -0.7
                p.fill_(base + 0.1 * float(torch.randn((), generator=gen)))


def phase_cross_attention(card, att_rows):
    log("[27] attention kernels at the cross-attention configs' shapes")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    for name in (XATTN, WHISPER):
        cfg = get_arch(name)
        G = cfg.n_heads // cfg.kv_heads
        log(f"  {name}: {cfg.n_heads} query heads over {cfg.kv_heads} kv "
            f"heads, dh {cfg.dh}, {cfg.cross_memory_len} memory rows; "
            f"resident decode split blocks per SM "
            f"{da.resident_blocks(cfg.dh, G)}")
        _attention_cases(card, (cfg.n_heads, cfg.kv_heads, cfg.dh),
                         CROSS_FLASH_CASES[name], CROSS_DECODE_CASES[name],
                         att_rows)


def phase_serve_cross():
    log("[28] serve llama-3.2-vision-11b and whisper-medium through "
        "repro_torch.launch.serve")
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    gen = 16
    launches = {}
    for name in (XATTN, WHISPER):
        t_cfg = time.perf_counter()
        cfg = get_arch(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_model(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        assert model.flat.numel() == P_CROSS[name], model.flat.numel()
        _seed_nonzero(model, 1)
        kind = "enc_frames" if cfg.encoder is not None else "memory"
        cross = {kind: 0.1 * torch.randn(
            (4, cfg.cross_memory_len, cfg.d_model),
            generator=torch.Generator().manual_seed(2))}
        enc = (f" + {cfg.encoder.n_layers} encoder layers"
               if cfg.encoder is not None else "")
        log(f"  {name}: {cfg.n_layers} layers{enc}, "
            f"{model.flat.numel()} float32 parameters "
            f"({model.flat.numel() * 4 / 1e9:.1f} GB), drawn on the card by "
            f"init_model in {draw_s:.2f} s (host clock); norms, biases and "
            f"gates seeded nonzero, {kind} 0.1 N(0, 1) of "
            f"{tuple(cross[kind].shape)}")

        # card vs CPU on the model cut to CROSS_CPU_CUT
        nl, ne = CROSS_CPU_CUT[name]
        card_m = _cut_model(model, nl, "cuda", ne)
        host_m = _cut_model(card_m, nl, "cpu", ne)
        _reset_launches()
        card = serve.run(model=card_m, gen=gen, keep_logits=True, log=None,
                         **cross)
        assert card["launches"] == _cross_launches(card_m.cfg, gen), \
            card["launches"]
        t0 = time.perf_counter()
        host = serve.run(model=host_m, gen=gen, keep_logits=True, log=None,
                         **cross)
        host_s = time.perf_counter() - t0
        forced = serve.run(model=card_m, gen=gen, feed=host["tokens"],
                           keep_logits=True, log=None, **cross)
        errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
        enc = f" + {ne} encoder layers" if ne else ""
        log(f"  {name} at {nl} layers{enc} ({card_m.flat.numel()} "
            f"parameters) card vs CPU: prefill "
            f"logits max err {errs['prefill']:.3e}, teacher-forced decode "
            f"logits max err {errs['decode']:.3e} (bound {RTOL_SERVE} x "
            f"max|logit| = {bound:.3e}); tokens equal except at {len(ties)} "
            f"printed near-ties; launches {card['launches']}; CPU run "
            f"{host_s:.2f} s")
        del card_m, host_m, card, host, forced
        torch.cuda.empty_cache()

        launches[name] = _serve_runs(
            model, lambda g, c=cfg: _cross_launches(c, g), name,
            runs=CROSS_RUNS[name], cross=cross)
        del model
        torch.cuda.empty_cache()
        log(f"  {name} took {time.perf_counter() - t_cfg:.1f} s")
    return launches


def phase_moe_attention(card, att_rows):
    log("[29] attention kernels at mixtral-8x22b's heads (48 over 8, dh "
        "128, window 4096)")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    cfg = get_arch(MIXTRAL)
    G = cfg.n_heads // cfg.kv_heads
    log(f"  {MIXTRAL}: {cfg.n_heads} query heads over {cfg.kv_heads} kv "
        f"heads (G {G}), dh {cfg.dh}, window {cfg.window}; decode head "
        f"groups {da.HEAD_GROUPS[cfg.dh, G]}, resident split blocks per SM "
        f"{da.resident_blocks(cfg.dh, G)}")
    _attention_cases(card, (cfg.n_heads, cfg.kv_heads, cfg.dh),
                     MIX_FLASH_CASES, MIX_DECODE_CASES, att_rows)


@contextlib.contextmanager
def _routes():
    """Record every ``moe.route`` call's chosen experts and router logits
    (on the CPU) while the block runs."""
    from repro_torch.models import moe
    calls, route = [], moe.route

    def record(x, router, top_k, capacity):
        r = route(x, router, top_k, capacity)
        calls.append((r.experts.cpu(), r.logits.detach().cpu()))
        return r
    moe.route = record
    try:
        yield calls
    finally:
        moe.route = route


def _experts_equal(label, got, want, k):
    """The card's chosen experts equal the CPU's call by call, except
    tokens whose k-th and (k+1)-th CPU logits lie within ROUTE_TIE of
    their largest |logit| (near-ties, counted).  Returns (near-ties,
    tokens)."""
    assert len(got) == len(want), (label, len(got), len(want))
    ties = tokens = 0
    for (eg, _), (ew, lw) in zip(got, want):
        s = torch.sort(lw.double(), dim=-1, descending=True).values
        tie = (s[:, k - 1] - s[:, k]) <= ROUTE_TIE * lw.abs().amax(-1)
        assert torch.equal(eg[~tie], ew[~tie]), label
        ties += int(tie.sum())
        tokens += tie.numel()
    return ties, tokens


def _serve_card_vs_cpu_moe(label, card_m, host_m, gen):
    """Phase 12's card-vs-CPU serve on a MoE model, with every routing
    call's chosen experts (the prefill's B*S tokens, each decode step's
    B) held to the CPU's under the near-tie rule."""
    from repro_torch.launch import serve
    k = card_m.cfg.moe.top_k
    _reset_launches()
    with _routes() as card_r:
        card = serve.run(model=card_m, gen=gen, keep_logits=True, log=None)
    n = card_m.cfg.n_layers
    assert card["launches"] == {"flash_attention": n,
                                "decode_attention": n * (gen - 1),
                                "rglru_scan": 0}, card["launches"]
    t0 = time.perf_counter()
    with _routes() as host_r:
        host = serve.run(model=host_m, gen=gen, keep_logits=True, log=None)
    host_s = time.perf_counter() - t0
    with _routes() as forced_r:
        forced = serve.run(model=card_m, gen=gen, feed=host["tokens"],
                           keep_logits=True, log=None)
    errs, ties, bound = _card_vs_cpu(card, host, forced, gen)
    n_moe = sum(m for _, m in card_m.cfg.layer_specs())
    pre = n_moe                          # the prefill's routing calls
    rt, rn = _experts_equal(label + " prefill", card_r[:pre], host_r[:pre],
                            k)
    dt, dn = _experts_equal(label + " forced decode", forced_r, host_r, k)
    log(f"  {label} ({card_m.flat.numel()} parameters) card vs CPU: "
        f"prefill logits max err {errs['prefill']:.3e}, teacher-forced "
        f"decode logits max err {errs['decode']:.3e} (bound {RTOL_SERVE} x "
        f"max|logit| = {bound:.3e}); tokens equal except at {len(ties)} "
        f"printed near-ties; chosen experts equal over {rn} prefill and "
        f"{dn} prefill + decode token routings but {rt} and {dt} near-ties "
        f"(k-th/(k+1)-th gap <= {ROUTE_TIE} of max|logit|); launches "
        f"{card['launches']}; card prefill {card['prefill_ms']:.2f} ms, "
        f"decode {statistics.median(card['step_ms']):.3f} ms/step (median, "
        f"B=4, prompt 32, gen {gen}), {card['tok_per_s']:.1f} tok/s; CPU "
        f"run {host_s:.2f} s")


def _kimi_moe_apply(card):
    """moe_apply at kimi's routing geometry, narrow: card vs CPU and
    bitwise from launch to launch; ms per call (CUDA events)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    spec = get_arch(KIMI).moe
    E, k = spec.n_experts, spec.top_k
    T, D, Fw = KIMI_MOE
    gen = torch.Generator().manual_seed(5)
    p = {"router": torch.randn((D, E), generator=gen) / D ** 0.5}
    for n, shape in (("w_up", (E, D, Fw)), ("w_gate", (E, D, Fw)),
                     ("w_down", (E, Fw, D))):
        p[n] = torch.randn(shape, generator=gen) / E ** 0.5
    p["router"][0, 3] += 6.0                 # every token's first: 3
    x = 0.5 * torch.randn((T, D), generator=gen)
    x[:, 0] = 1.0 + 0.05 * torch.randn((T,), generator=gen)
    cap = M.moe_capacity(T, k, E, spec.capacity_factor)
    want = M.moe_apply(x, p, top_k=k, capacity=cap, act="silu")
    with _routes() as host_r:
        M.moe_apply(x, p, top_k=k, capacity=cap, act="silu")
    xd, pd = x.cuda(), {n: t.cuda() for n, t in p.items()}
    got = M.moe_apply(xd, pd, top_k=k, capacity=cap, act="silu")
    again = M.moe_apply(xd, pd, top_k=k, capacity=cap, act="silu")
    assert torch.equal(got, again), "moe_apply not bitwise launch to launch"
    with _routes() as card_r:
        M.moe_apply(xd, pd, top_k=k, capacity=cap, act="silu")
    ties, _ = _experts_equal("kimi moe_apply", card_r, host_r, k)
    # a token's output depends on its own row and its experts alone: held
    # wherever both devices routed it alike (experts and slots)
    r, rd = M.route(x, p["router"], k, cap), M.route(xd, pd["router"], k, cap)
    dropped = int((r.slot < 0).sum())
    assert dropped > 0
    alike = (rd.experts.cpu() == r.experts).all(-1) & \
        (rd.slot.cpu() == r.slot).all(-1)
    err = float((got.cpu() - want).abs()[alike].max())
    assert err <= 1e-5 * float(want.abs().max()), err
    ms = time_ms(lambda: M.moe_apply(xd, pd, top_k=k, capacity=cap,
                                     act="silu"), 5)
    log(f"  moe_apply at kimi's geometry ({E} experts, top {k}, capacity "
        f"{cap} of {T} tokens, d_model {D}, d_ff {Fw}; router biased so "
        f"{dropped} of {T * k} assignments overflow): chosen experts equal "
        f"but {ties} near-ties of {T} tokens; card vs CPU max err {err:.3e} "
        f"over the {int(alike.sum())} tokens routed alike (bound 1e-5 x "
        f"max|out| = {1e-5 * float(want.abs().max()):.3e}); bitwise from "
        f"launch to launch; {ms:.3f} ms a call (CUDA events, {card})")


def phase_serve_moe(card):
    log("[30] serve mixtral-8x22b (4 of 56 layers, full width) and "
        "kimi-k2-1t-a32b (reduced) through repro_torch.launch.serve")
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import init_model
    t_phase = time.perf_counter()
    full = get_arch(MIXTRAL)
    cfg = dataclasses.replace(full, n_layers=MIX_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    assert model.flat.numel() == P_MIX[MIX_LAYERS], model.flat.numel()
    _seed_nonzero(model, 1)
    log(f"  {MIXTRAL}: {cfg.n_layers} of {full.n_layers} layers, "
        f"{model.flat.numel()} float32 parameters "
        f"({model.flat.numel() * 4 / 1e9:.1f} GB), drawn on the card by "
        f"init_model in {draw_s:.2f} s (host clock), norm scales seeded "
        f"nonzero; experts N(0, 1/E) as repro draws them")
    nl = MIX_CPU_LAYERS
    card_m = _cut_model(model, nl, "cuda")
    assert card_m.flat.numel() == P_MIX[nl]
    host_m = _cut_model(card_m, nl, "cpu")
    _serve_card_vs_cpu_moe(f"{MIXTRAL} at {nl} layer", card_m, host_m,
                           MIX_CPU_GEN)
    del card_m, host_m
    torch.cuda.empty_cache()
    n = cfg.n_layers
    launches = {MIXTRAL: _serve_runs(
        model, lambda g: {"flash_attention": n,
                          "decode_attention": n * (g - 1),
                          "rglru_scan": 0}, MIXTRAL)}
    del model
    torch.cuda.empty_cache()

    kcfg = reduced(get_arch(KIMI))
    kimi = init_model(kcfg, 0, device="cuda")
    _seed_nonzero(kimi, 2)
    _serve_card_vs_cpu_moe(f"{KIMI} reduced ({kcfg.n_layers} layers: "
                           f"dense prefix, {kcfg.moe.n_experts} experts "
                           f"top {kcfg.moe.top_k} + shared)", kimi,
                           _cut_model(kimi, kcfg.n_layers, "cpu"), 16)
    del kimi
    _kimi_moe_apply(card)
    torch.cuda.empty_cache()
    log(f"  phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _train_steps(label, make, cfg, tcfg, batches):
    """``train_step`` over ``batches`` from the state ``make()`` returns
    (made here, so no caller holds the first step's optimizer state while
    the next runs), each timed on the host clock; logs and returns the
    new state."""
    from repro_torch.training import train_step
    torch.cuda.reset_peak_memory_stats()
    state = make()
    walls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, tcfg)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    assert all(math.isfinite(x) for x in losses), losses
    log(f"  {label}: {state['params'].flat.numel()} parameters, "
        f"{tcfg.optimizer}, DP {tcfg.dp.mode} mode"
        f"{f' ({tcfg.dp.n_micro})' if tcfg.dp.mode == 'microbatch' else ''}"
        f", noise {tcfg.dp.noise_multiplier}: losses "
        f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
        f"{[round(w, 2) for w in walls]}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return state


def _train_cross(name):
    """Phase 31: one cross-attention config at full width, cut; two steps
    at the launcher's configuration with a seeded memory / frames, then
    one microbatch's gradients card vs CPU (whisper's DP example mode:
    phase_train_example_cross, after the build)."""
    from repro_torch.configs import EncoderSpec, get_arch
    from repro_torch.launch import train as launcher
    nl, ne, count, B = XTRAIN[name]
    S = NEW_TRAIN["seq"]
    cfg = dataclasses.replace(get_arch(name), n_layers=nl)
    if ne is not None:
        cfg = dataclasses.replace(cfg, encoder=EncoderSpec(ne))
    key = "enc_frames" if cfg.encoder is not None else "memory"
    cross = 0.1 * torch.randn((B, cfg.cross_memory_len, cfg.d_model),
                              generator=torch.Generator().manual_seed(3))
    cross = cross.cuda()
    tcfg = launcher.train_config(cfg, B, 0.2, 1.0)
    batches = [dict(_batch_on(cfg, i, B, S, "cuda"), **{key: cross})
               for i in range(NEW_TRAIN["steps"])]
    enc = f" + {ne} encoder layers" if ne else ""
    state = _train_steps(f"{name} at {nl} layers{enc}, full width, B={B} x "
                         f"{S}, {key} {tuple(cross.shape)} 0.1 N(0, 1)",
                         lambda: _seeded_state(0, cfg, tcfg, 4, count),
                         cfg, tcfg, batches)
    model = state["params"]
    del state
    torch.cuda.empty_cache()
    m = B // tcfg.dp.n_micro
    _grads_card_vs_cpu(model, {k: v[:m] for k, v in batches[0].items()})
    del model
    torch.cuda.empty_cache()


def _seeded_state(seed, cfg, tcfg, nonzero, count=None):
    """``make_state`` on the card with ``_seed_nonzero``'s values (the
    optimizer's master copy too)."""
    from repro_torch.training import make_state
    state = make_state(seed, cfg, tcfg, device="cuda")
    if count is not None:
        assert state["params"].flat.numel() == count
    _seed_nonzero(state["params"], nonzero)
    with torch.no_grad():
        for k, t in state["opt"]["master"].items():
            t.copy_(state["params"].get_parameter(k))
    return state


def phase_train_example_cross():
    """Phase 31, after the build: one DP example-mode step on whisper-medium
    (2 + 2 layers), each example with its own frames."""
    from repro_torch.configs import EncoderSpec, get_arch
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch import train as launcher
    from repro_torch.training import DPConfig
    log("[31] (after the build) training whisper-medium in DP example mode")
    nl, ne, _, B = XTRAIN[WHISPER]
    S = NEW_TRAIN["seq"]
    cfg = dataclasses.replace(get_arch(WHISPER), n_layers=nl,
                              encoder=EncoderSpec(ne))
    frames = 0.1 * torch.randn((B, cfg.cross_memory_len, cfg.d_model),
                               generator=torch.Generator().manual_seed(3))
    b = dict(_batch_on(cfg, 0, B, S, "cuda"), enc_frames=frames.cuda())
    ex = dataclasses.replace(launcher.train_config(cfg, B, 0.2, 1.0),
                             dp=DPConfig(clip=1.0, noise_multiplier=0.2,
                                         mode="example"))
    dp.reset_launches()
    _train_steps(f"{WHISPER} at {nl} + {ne} layers, DP example mode ({B} "
                 f"examples of {S} tokens, each with its own enc_frames "
                 f"row)", lambda: _seeded_state(1, cfg, ex, 5), cfg, ex, [b])
    assert dict(dp.LAUNCHES) == {"rownorms": 1, "clip_accumulate": 1}, \
        dp.LAUNCHES
    log(f"  example mode launches {dict(dp.LAUNCHES)}")
    dp.reset_launches()
    torch.cuda.empty_cache()


def phase_train_cross_moe():
    log("[31] training llama-3.2-vision-11b and whisper-medium (full width, "
        "cut), reduced mixtral-8x22b and reduced kimi-k2-1t-a32b (the "
        "launcher, Adafactor), card vs CPU; beside the build (no kernel of "
        "ours on these paths; the step times share the host with nvcc)")
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train as launcher
    from repro_torch.training import make_state
    t_phase = time.perf_counter()
    log(f"  card memory allocated at the start "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    for name in (XATTN, WHISPER):
        _train_cross(name)
    B, S, steps = NEW_TRAIN["batch"], NEW_TRAIN["seq"], NEW_TRAIN["steps"]
    cfg = reduced(get_arch(MIXTRAL))
    tcfg = launcher.train_config(cfg, B, 0.2, 1.0)
    batches = [_batch_on(cfg, i, B, S, "cuda") for i in range(steps)]
    state = _train_steps(f"{MIXTRAL} reduced, B={B} x {S}",
                         lambda: make_state(0, cfg, tcfg, device="cuda"),
                         cfg, tcfg, batches)
    _grads_card_vs_cpu(state["params"], {k: v[:B // tcfg.dp.n_micro]
                                         for k, v in batches[0].items()})
    root = Path(tempfile.mkdtemp(prefix="train_kimi_"))
    run = launcher.run(arch=KIMI, smoke=True, steps=steps, batch=B, seq=S,
                       ckpt=str(root), log=None)
    shutil.rmtree(root)
    assert run["tcfg"].optimizer == "adafactor"
    losses = [r["loss"] for r in run["records"]]
    assert all(math.isfinite(x) for x in losses), losses
    log(f"  launch/train.run(arch={KIMI!r}, smoke=True, steps={steps}): "
        f"B={B} x {S}, {run['tcfg'].optimizer}, noise 0.2: losses "
        f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
        f"{[round(r['wall_s'] * 1e3, 2) for r in run['records']]}")
    _grads_card_vs_cpu(run["state"]["params"],
                       {k: v[:B // 2] for k, v in
                        _batch_on(run["cfg"], 0, B, S, "cpu").items()})
    torch.cuda.empty_cache()
    log(f"  phase 31 took {time.perf_counter() - t_phase:.1f} s")


def _config_heads():
    """Every config with attention: (label, (H, KH, dh), flash cases,
    decode cases) -- phase 32's bfloat16 kernel cases."""
    from repro_torch.configs import ARCHS, get_arch
    out = []
    for name in sorted(ARCHS):
        cfg = get_arch(name)
        kinds = {k for k, _ in cfg.layer_specs()}
        if not kinds & {"attn", "swa", "local", "xattn", "encdec"}:
            continue                      # xlstm-125m: no attention
        win = cfg.window if kinds & {"swa", "local"} else None
        short = "bf16-" + name
        flash = [(f"{short}-serve", 4, 32, True, win)]
        decode = [(f"{short}-serve-33", 4, 48, 33)]
        if cfg.cross_memory_len:
            M = cfg.cross_memory_len
            flash.append((f"{short}-x{M}", 4, 32, False, None, M))
            decode.append((f"{short}-x{M}", 4, M, M))
        if name in ("qwen2.5-32b", "recurrentgemma-2b"):   # long serves
            flash.append((f"{short}-2k", 4, 2048, True, win))
            decode.append((f"{short}-long", 4, 2112, 2080) if win is None
                          else (f"{short}-long", 4, 2048, 2048))
        out.append((name, (cfg.n_heads, cfg.kv_heads, cfg.dh), flash,
                    decode))
    return out


def phase_bf16_attention(card, att_rows):
    log("[32] attention kernels on bfloat16 operands at every config's "
        "heads")
    from repro_torch.kernels import decode_attention as da
    t0 = time.perf_counter()
    for name, heads, flash, decode in _config_heads():
        G = heads[0] // heads[1]
        log(f"  {name}: {heads[0]} query heads over {heads[1]} kv heads, dh "
            f"{heads[2]}; bfloat16 resident split blocks per SM "
            f"{da.resident_blocks(heads[2], G, True)} (float32 "
            f"{da.resident_blocks(heads[2], G)})")
        _attention_cases(card, heads, flash, decode, att_rows,
                         dtype=torch.bfloat16)
    log(f"  phase 32 took {time.perf_counter() - t0:.1f} s")


def _bf16_expect(cfg, gen):
    kinds = [k for k, _ in cfg.layer_specs()]
    n_att = len(kinds) - kinds.count("rec")
    return {"flash_attention": n_att, "decode_attention": n_att * (gen - 1),
            "rglru_scan": kinds.count("rec") * gen}


def _bf16_card_vs_cpu(name, nl, gen=16):
    """Phase 33: the worker's bfloat16 cut of ``name`` served on the card,
    held to the CPU's bfloat16 serve within BF16_FACTOR x d."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    (paths, host, f32), host_s = cpu_ref(("bf16_serve", name, nl))
    host["logits"] = {k: _from_file(v) for k, v in host["logits"].items()}
    f32 = {k: _from_file(v) for k, v in f32.items()}
    cfg = dataclasses.replace(get_arch(name), n_layers=nl)
    card_m = Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    _flats_from_files(card_m, paths)
    _reset_launches()
    card = serve.run(model=card_m, gen=gen, keep_logits=True, log=None)
    assert card["launches"] == _bf16_expect(cfg, gen), card["launches"]
    forced = serve.run(model=card_m, gen=gen, feed=host["tokens"],
                       keep_logits=True, log=None)
    d = max(float((host["logits"][p].double() - f32[p].double()).abs()
                  .max()) for p in f32)
    scale = max(float(f32[p].abs().max()) for p in f32)
    assert 0 < d < BF16_VACUOUS * scale, (name, d, scale)
    errs, ties, bound = _card_vs_cpu(card, host, forced, gen,
                                     abs_bound=BF16_FACTOR * d)
    log(f"  {name} at {nl} layers ({card_m.n_params} parameters, "
        f"bfloat16) card vs CPU: prefill logits max err "
        f"{errs['prefill']:.3e}, teacher-forced decode logits max err "
        f"{errs['decode']:.3e} (bound {BF16_FACTOR} x d = {bound:.3e}, d = "
        f"the CPU's bfloat16 run from its float32 run = {d / scale:.3e} of "
        f"max|logit| {scale:.3f}); tokens equal except at {len(ties)} "
        f"printed near-ties; CPU runs {host_s:.2f} s (the CPU worker)")


def phase_serve_bf16(card):
    log("[33] serve in bfloat16 through repro_torch.launch.serve: "
        "qwen2.5-32b whole, starcoder2-15b whole, recurrentgemma-2b whole")
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    t_phase = time.perf_counter()
    launches = {}
    for name, nl, long in BF16_SERVE:
        t_cfg = time.perf_counter()
        _bf16_card_vs_cpu(name, nl)
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_model(cfg, 0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        assert model.n_params == P_BF16[name], model.n_params
        nbytes = sum(b.numel() * b.element_size()
                     for b in model.flats.values())
        log(f"  {name}: all {cfg.n_layers} layers, {model.n_params} "
            f"parameters in bfloat16 ({nbytes / 1e9:.1f} GB; "
            f"{model.flats[torch.float32].numel()} of them float32), drawn "
            f"on the card by init_model in {draw_s:.2f} s (host clock)")
        runs = SERVE_RUNS if long else SERVE_RUNS[:1]
        launches[name] = {}
        for run_name, B, prompt, gen in runs:
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            run = serve.run(model=model, batch=B, prompt_len=prompt, gen=gen,
                            log=None)
            assert run["launches"] == _bf16_expect(cfg, gen), run["launches"]
            tok = run["tokens"]
            assert tok.shape == (B, gen) and int(tok.min()) >= 0 and \
                int(tok.max()) < cfg.vocab
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = run["step_ms"]
            log(f"  {name} bf16 {run_name} (B={B}, prompt {prompt}, gen "
                f"{gen}): prefill {run['prefill_ms']:.2f} ms, decode "
                f"{statistics.median(steps):.3f} ms/step median "
                f"({min(steps):.3f}-{max(steps):.3f}), "
                f"{run['tok_per_s']:.1f} tok/s; launches {run['launches']}; "
                f"peak card memory {peak:.2f} GiB ({card})")
            launches[name][run_name] = run["launches"]
            del run
        if long:     # the host-bound decode: its busy share at the defaults
            pre, dec = _busy_shares(model, 4, 32)
            log(f"  {name} bf16: card busy share {pre:.4f} over a traced "
                f"prefill of 4 x 32 tokens, {dec:.4f} over 4 traced decode "
                f"steps; the weights' read {nbytes / HBM_BYTES_PER_S * 1e3:.2f}"
                f" ms a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        del model
        torch.cuda.empty_cache()
        _reset_launches()
        log(f"  {name} took {time.perf_counter() - t_cfg:.1f} s")
    log(f"  phase 33 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _bf16_grads_card_vs_cpu(name, nl):
    """Phase 34: one microbatch's gradients of the worker's bfloat16 cut,
    card against the CPU's bfloat16 run within BF16_FACTOR x d plus half a
    bfloat16 ulp of the largest |g|."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Transformer
    (paths, gb, g32), host_s = cpu_ref(("bf16_grads", name, nl))
    gb, g32 = _from_file(gb), _from_file(g32)
    cfg = dataclasses.replace(get_arch(name), n_layers=nl)
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    _flats_from_files(model, paths)
    got = _flat_grads(model, _batch_on(cfg, 0, *BF16_MB, "cpu"))
    del model
    gmax = float(g32.abs().max())
    d = float((gb - g32).abs().max())
    assert 0 < d < BF16_VACUOUS * gmax, (name, d, gmax)
    bound = BF16_FACTOR * d + BF16_HALF_ULP * gmax
    err = float((got - gb).abs().max())
    assert err <= bound, (name, err, bound)
    log(f"  {name} at {nl} layers, one microbatch {BF16_MB} of bfloat16 "
        f"gradients card vs CPU: max err {err:.3e} (bound {bound:.3e}: "
        f"{BF16_FACTOR} x d {d:.3e} + half an ulp of max|g| {gmax:.3e}); "
        f"CPU runs {host_s:.2f} s (the CPU worker)")


def phase_train_bf16(card):
    log("[34] training in bfloat16 with a float32 master: qwen2.5-3b at 2 "
        "layers, recurrentgemma-2b at 3; launch/train.run resumed")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import rg_lru
    from repro_torch.launch import train as launcher
    from repro_torch.training import make_state, train_step
    t_phase = time.perf_counter()
    for name, nl in BF16_TRAIN:
        cfg = dataclasses.replace(get_arch(name), n_layers=nl)
        tcfg = launcher.train_config(cfg, 8, 0.2, 1.0, "bfloat16")
        state = make_state(0, cfg, tcfg, device="cuda")
        assert state["params"].dtype == torch.bfloat16 and \
            state["opt"]["master"]["embed.table"].dtype == torch.float32
        n_rec = [k for k, _ in cfg.layer_specs()].count("rec")
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        walls, losses = [], []
        for i in range(2):
            b = _batch_on(cfg, i, 8, 128, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, b, cfg, tcfg)
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        scan = {**rg_lru.LAUNCHES, **rg_lru.BWD_LAUNCHES}
        want = n_rec * tcfg.dp.n_micro * 2
        assert scan == {"rglru_scan": want, "rglru_scan_bwd": want}, scan
        assert all(math.isfinite(x) for x in losses), losses
        master = state["opt"]["master"]
        for k, p in state["params"].named_parameters():
            assert torch.equal(p, master[k].to(p.dtype)), k
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {name}, {nl} layers ({state['params'].n_params} parameters,"
            f" bfloat16, AdamW with a float32 master), B=8 x 128, "
            f"{tcfg.dp.n_micro} microbatches, noise 0.2: losses "
            f"{[round(x, 4) for x in losses]}; ms per step (host clock) "
            f"{[round(w, 2) for w in walls]}; scan launches {scan}; peak "
            f"card memory {peak:.2f} GiB ({card})")
        del state
        torch.cuda.empty_cache()
        _bf16_grads_card_vs_cpu(name, nl)
        torch.cuda.empty_cache()
    _reset_launches()

    # the launcher in bfloat16, resumed from its first checkpoint: bitwise
    root = Path(tempfile.mkdtemp(prefix="train_ckpt_bf16_"))
    n, every = BF16_LAUNCH_STEPS, BF16_LAUNCH_STEPS // 2
    t0 = time.perf_counter()
    full = launcher.run(steps=n, ckpt_every=every, ckpt=str(root), log=None,
                        param_dtype="bfloat16")
    full_s = time.perf_counter() - t0
    assert full["checkpoints"] == [every, n]
    assert full["state"]["params"].dtype == torch.bfloat16
    shutil.rmtree(root / f"step_{n:010d}")
    rest = launcher.run(steps=n - every, ckpt_every=every, ckpt=str(root),
                        log=None, param_dtype="bfloat16")
    assert rest["resumed_from"] == every
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in full["records"][every:]]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in rest["records"]], "resume"
    _states_bitwise("bf16 resume", rest["state"], full["state"])
    walls = [r["wall_s"] * 1e3 for r in full["records"][1:]]
    log(f"  launch/train.run(param_dtype='bfloat16') on flaas-100m, {n} "
        f"steps with checkpoints every {every}: {full_s:.2f} s, ms per step "
        f"(host clock) {[round(w, 2) for w in walls]}; resumed at step "
        f"{every} and rerun to {n}: metrics, bfloat16 parameters and the "
        f"optimizer's float32 state bitwise")
    del full, rest
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    log(f"  phase 34 took {time.perf_counter() - t_phase:.1f} s")


def _sharded_jobs():
    """Phase 35's jobs (repro_torch.launch.sharded_train.jobs): for the 4
    Gloo ranks sharing the card, for 2 more Gloo ranks (recurrentgemma-2b
    on (data 1, model 2)) and for one rank under NCCL."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import synth_tokens
    from repro_torch.launch import train as launcher
    from repro_torch.training import DPConfig, TrainConfig
    cfg = get_arch("flaas-100m")
    tcfg = launcher.train_config(cfg, 8, 0.2, 1.0, "float32")
    batches = [synth_tokens(i, 8, 128, cfg.vocab) for i in range(SHARD_STEPS)]
    mesh = ((2, 2), ("data", "model"))
    example = dataclasses.replace(tcfg, dp=dataclasses.replace(
        tcfg.dp, mode="example"))
    rg = dataclasses.replace(get_arch("recurrentgemma-2b"),
                             n_layers=RG_TRAIN["n_layers"])
    rg_tcfg = TrainConfig(optimizer="sgd", param_dtype="float32",
                          dp=DPConfig(clip=1.0, noise_multiplier=0.0,
                                      n_micro=2))
    gloo = [("train", dict(cfg=cfg, tcfg=tcfg, mesh=mesh, batches=batches,
                           grads=True, gather_after=SHARD_COMPARE_AT,
                           reference=True)),
            ("train", dict(cfg=cfg, tcfg=example, mesh=mesh,
                           batches=batches[:1], grads=True, gather=False,
                           reference=True)),
            ("pipeline", dict(n_stages=4, cfg=cfg, reference=True,
                              x_shape=PIPE_X + (cfg.d_model,)))]
    pair = [("train", dict(cfg=rg, tcfg=rg_tcfg,
                           mesh=((1, 2), ("data", "model")),
                           batches=[synth_tokens(0, RG_TRAIN["batch"],
                                                 RG_TRAIN["seq"], rg.vocab)],
                           steps=0, grads=True, gather=False,
                           reference=True))]
    nccl = [("bitwise", dict(cfg=cfg, tcfg=tcfg, batches=batches[:2],
                             backend="nccl"))]
    return gloo, pair, nccl, cfg, tcfg, rg


def phase_sharded(smi):
    """Phase 35, on its own after phase 21: three worlds at once on the
    card -- 4 Gloo ranks, 2 Gloo ranks and one rank under NCCL."""
    import concurrent.futures
    from repro_torch.launch import sharded_train
    from repro_torch.launch.sharded_service import spawn
    t_phase = time.perf_counter()
    log(f"[35] the sharded training step and pipeline_apply on ranks "
        f"sharing the card; {smi}")
    torch.cuda.empty_cache()
    gloo, pair, nccl, cfg, tcfg, rg = _sharded_jobs()

    def timed(n, backend, todo):
        t0 = time.perf_counter()
        out = spawn(sharded_train.jobs, n, backend=backend, device="cuda",
                    args=(todo,), timeout=SHARD_TIMEOUT)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        f_gloo = pool.submit(timed, 4, "gloo", gloo)
        f_pair = pool.submit(timed, 2, "gloo", pair)
        f_nccl = pool.submit(timed, 1, "nccl", nccl)
        (res, secs), (act, secs2), (one, secs1) = (
            f_gloo.result(), f_pair.result(), f_nccl.result())
    log(f"  beside one another: 4 Gloo ranks ({secs:.1f} s with their "
        f"start), 2 Gloo ranks ({secs2:.1f} s), one NCCL rank "
        f"({secs1:.1f} s), all on the card")
    flaas, example, pipe = ([r[j] for r in res] for j in range(3))
    act = [r[0] for r in act]
    lr2 = 2 * tcfg.lr
    # (a) flaas-100m at the launcher's defaults on (data 2, model 2)
    r0 = flaas[0]
    for r in flaas:
        assert r["bytes"] == r["rule_bytes"], (r["coords"], r["bytes"],
                                               r["rule_bytes"])
    assert r0["grad_err_per_leaf"] <= RTOL_TRAIN, r0["grad_err_per_leaf"]
    assert max(r0["metric_rel_err"].values()) <= RTOL_TRAIN, \
        r0["metric_rel_err"]
    assert r0["param_err"] <= lr2, r0["param_err"]
    log(f"  flaas-100m ({P_FLAAS} parameters), mesh (data 2, model 2), "
        f"B=8 x 128, 2 microbatches, AdamW, noise 0.2, {SHARD_STEPS} steps: "
        f"losses {[round(x['loss'], 5) for x in r0['records']]}; against "
        f"the one-process card run: gradients (noise off) {r0['grad_err_per_leaf']:.3e} "
        f"of each leaf's largest |g| (bound {RTOL_TRAIN}), loss / "
        f"grad_norm_mean rel err {r0['metric_rel_err']['loss']:.3e} / "
        f"{r0['metric_rel_err']['grad_norm_mean']:.3e} (bound "
        f"{RTOL_TRAIN}), parameters after {SHARD_COMPARE_AT} steps "
        f"{r0['param_err']:.3e} (bound 2 lr = {lr2:.1e})")
    for r in flaas:
        log(f"    rank {r['rank']} {r['coords']}: ms per step (host clock, "
            f"4 ranks sharing one card and its host: no scale-out figure; "
            f"{smi}) {[round(x['ms'], 1) for x in r['records']]}; parameters "
            f"+ optimizer state {r['bytes']} bytes, the rules' count "
            f"{r['rule_bytes']}")
    # (b) example mode: rownorms / clip_accumulate on each rank's share
    e0 = example[0]
    assert e0["grad_err_per_leaf"] <= RTOL_TRAIN, e0["grad_err_per_leaf"]
    assert max(e0["metric_rel_err"].values()) <= RTOL_TRAIN, \
        e0["metric_rel_err"]
    dp_launches = {k: [r["launches"][k] for r in example]
                   for k in ("rownorms", "clip_accumulate")}
    grad_launches = {k: [r["launches_grads"][k] for r in example]
                     for k in ("rownorms", "clip_accumulate")}
    assert all(v == [1] * 4 for v in dp_launches.values()), dp_launches
    assert all(v == [1] * 4 for v in grad_launches.values()), grad_launches
    log(f"  DP example mode, B=8, one step: the gradients (noise off; "
        f"rownorms and clip_accumulate on each rank's share of the "
        f"parameter vector) against the one-process card run "
        f"{e0['grad_err_per_leaf']:.3e} of each leaf's largest |g| (bound "
        f"{RTOL_TRAIN}); loss / grad_norm_mean rel err "
        f"{e0['metric_rel_err']['loss']:.3e} / "
        f"{e0['metric_rel_err']['grad_norm_mean']:.3e}; launches per rank "
        f"in that gradient pass {grad_launches} and in the step "
        f"{dp_launches}; ms {[round(r['records'][0]['ms'], 1) for r in example]}")
    # (c) recurrentgemma-2b on (data 1, model 2): the scan on half the
    # channels, its backward too
    n_rec = [k for k, _ in rg.layer_specs()].count("rec")
    rg_launches = {k: [r["launches_grads"][k] for r in act]
                   for k in ("rglru_scan", "rglru_scan_bwd")}
    assert all(v == [n_rec * 2] * 2 for v in rg_launches.values()), \
        rg_launches
    for r in act:
        assert r["local_shapes"]["blocks.0.rg.w_x"] == (
            rg.d_model, rg.d_model // 2), r["local_shapes"]["blocks.0.rg.w_x"]
    g0 = act[0]
    assert g0["grad_err"] <= GRAD_RTOL_TRAIN * g0["grad_max"], \
        (g0["grad_err"], g0["grad_max"])
    log(f"  recurrentgemma-2b, {rg.n_layers} layers, mesh (data 1, model "
        f"2), B={RG_TRAIN['batch']} x {RG_TRAIN['seq']}, 2 microbatches: the "
        f"scan and its backward on {rg.d_model // 2} of {rg.d_model} "
        f"channels a rank, launches per rank {rg_launches}; gradients "
        f"against the one-process card run max err {g0['grad_err']:.3e} "
        f"of max|g| {g0['grad_max']:.3e} (bound {GRAD_RTOL_TRAIN} x "
        f"max|g|)")
    # (d) pipeline_apply: 12 blocks as 4 stages of 3
    p0 = pipe[0]
    assert p0["err"] <= 1e-5 * p0["y_max"], (p0["err"], p0["y_max"])
    log(f"  pipeline_apply, flaas-100m's {cfg.n_layers} blocks as 4 stages "
        f"of {cfg.n_layers // 4}, x {p0['shape']}: max |pipeline - "
        f"sequential| {p0['err']:.3e} of max|y| {p0['y_max']:.3e} (bound "
        f"1e-5 x max|y|); ms per rank {[round(r['ms'], 1) for r in pipe]}")
    # (e) one rank under NCCL, (1, 1): bitwise the unsharded step
    b = one[0][0]
    assert b["bitwise"], b
    log(f"  one rank under NCCL, mesh (1, 1), 2 steps of flaas-100m at "
        f"the launcher's defaults: metrics, "
        f"parameters and optimizer state bitwise the unsharded step")
    log(f"  seconds per job on a world's rank 0 (the comparison with the "
        f"one-process run included): flaas (2, 2) {flaas[0]['job_s']:.1f}, "
        f"example mode {example[0]['job_s']:.1f}; recurrentgemma-2b "
        f"{act[0]['job_s']:.1f}")
    log(f"  phase 35 took {time.perf_counter() - t_phase:.1f} s")
    return {"dp": dp_launches, "rg": rg_launches}


def main() -> int:
    name, smi = phase_device()
    with cpu_references():            # the worker starts beside the build
        started = _build_start()
        phase_train_cross_moe()       # launches no kernel of ours
        _build_finish(started)
        return _card_phases(name, smi)


def _card_phases(name, smi) -> int:
    rows = phase_kernels(smi)
    launches = phase_episode()
    large = phase_large_round()
    phase_trace()
    dp_rows = phase_dp_kernels(smi)
    phase_fl_round()
    dp_launches = phase_fl_e2e()
    phase_fl_trace()
    att_rows = phase_attention(smi)
    att_launches = phase_serve()
    phase_serve_trace()
    rg_row = phase_rglru(smi, att_rows)
    rg_launches, rg_long_launches, rg_model = phase_serve_hybrid()
    phase_serve_hybrid_trace(rg_model)
    del rg_model
    torch.cuda.empty_cache()
    phase_dense_attention(smi, att_rows)
    dense_launches = phase_serve_dense()
    phase_serve_xlstm()
    paper = phase_paper_comparison()
    phase_fleets()
    beam_launches, beam_row = phase_beam(smi)
    rows["swap_eval"]["by_shape"]["fleet-beam"] = beam_row
    rows["swap_eval"]["max_abs_err"] = max(rows["swap_eval"]["max_abs_err"],
                                           beam_row["max_abs_err"])
    service_launches = phase_service(smi)
    shard_launches = phase_checkpoint_shard(smi)
    sharded_launches = phase_sharded(smi)
    bwd_row, per_train_step, bwd_launches = phase_train(smi)
    phase_train_new()
    phase_cross_attention(smi, att_rows)
    cross_launches = phase_serve_cross()
    phase_moe_attention(smi, att_rows)
    moe_launches = phase_serve_moe(smi)
    phase_train_example_cross()
    torch.cuda.empty_cache()
    phase_bf16_attention(smi, att_rows)
    bf16_launches = phase_serve_bf16(smi)
    phase_train_bf16(smi)
    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=launches[k], launches_large_round=large[k],
                    launches_per_round_paper_comparison={
                        n: c[k] for n, c in paper.items()},
                    launches_fleet_beam_round=beam_launches[k],
                    launches_per_service_tick={
                        n: c[k] for n, c in service_launches.items()},
                    launches_per_sharded_tick=shard_launches[k],
                    **rows[k]) for k in REPLACES]
    kernels += [dict(name=k, route="cuda", source=DP_SOURCE,
                     replaces=DP_REPLACES[k], launches=dp_launches[k],
                     launches_sharded_example_per_rank=sharded_launches[
                         "dp"][k],
                     **dp_rows[k]) for k in DP_REPLACES]
    kernels += [dict(name=k, route="cuda", source=ATT_SOURCE,
                     replaces=ATT_REPLACES[k], launches=att_launches[k],
                     launches_recurrentgemma=rg_launches[k],
                     launches_dense_serve={
                         n: {r: c[k] for r, c in runs.items()}
                         for n, runs in dense_launches.items()},
                     launches_cross_serve={
                         n: {r: c[k] for r, c in runs.items()}
                         for n, runs in cross_launches.items()},
                     launches_moe_serve={
                         n: {r: c[k] for r, c in runs.items()}
                         for n, runs in moe_launches.items()},
                     launches_bf16_serve={
                         n: {r: c[k] for r, c in runs.items()}
                         for n, runs in bf16_launches.items()},
                     **att_rows[k]) for k in ATT_REPLACES]
    kernels.append(dict(name="rglru_scan", route="cuda", source=RG_SOURCE,
                        replaces=RG_REPLACES,
                        launches=rg_launches["rglru_scan"],
                        launches_long_serve=rg_long_launches["rglru_scan"],
                        launches_per_train_step=per_train_step["rglru_scan"],
                        launches_sharded_grads_per_rank=sharded_launches[
                            "rg"]["rglru_scan"],
                        **rg_row))
    kernels.append(dict(name="rglru_scan_bwd", route="cuda", source=RG_SOURCE,
                        replaces=RG_BWD_REPLACES, note=RG_BWD_NOTE,
                        launches=bwd_launches,
                        launches_per_train_step=per_train_step[
                            "rglru_scan_bwd"],
                        launches_sharded_grads_per_rank=sharded_launches[
                            "rg"]["rglru_scan_bwd"],
                        **bwd_row))
    assert len(kernels) == 12, [k["name"] for k in kernels]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
