#!/usr/bin/env python3
"""On-card smoke test of tamgcn_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be available; prints the CUDA version and the card's
     name and power limit (nvidia-smi);
  2. build: compiles every CUDA source of the port (one nvcc each, all
     started together) and prints the seconds;
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes of the main paths (K1 at the test batch 64 and at the
     training batch 16, K2 and K3 at the training batch 16, plus V=24 and
     ragged shapes; the joint-tiled designs K1t and K2t, and K3, at V=25,
     configs/scene256.yaml's blocks (V=256, batch 8), a ragged V=37 and the
     joint-tiled design's edges: T of 13 with C of 80, T of 40, N = 1), f32
     with TF32 off, and times both with CUDA events and each kernel also by
     a CUDA graph (device time), with its blocks a launch: K1, K2 and K3 at
     least 132 at every main-path shape, and the whole-V K1's and K2's
     launchers as ops/cuda/ctr_gc.py:whole_v_blocks says. Each launch must
     count on the counter of the design the shape takes (the whole-V K1 and
     K2 up to V=24). K1 and K2 are held within rtol 1e-5 and atol
     1e-5*max|plain|; K3's outputs are sums of up to N*T*V*V terms taken in
     another order, so each is held within rtol 1e-4 and atol
     1e-4*max|plain| (dalpha, one sum over all N*S*V*V*C terms, within rtol
     1e-3); two launches of every kernel must agree bit for bit;
  4. test main path: `python -m tamgcn_tpu_torch recognition --phase test`
     run in-process through `__main__.main` at full NW-UCLA width
     (base_channel 64, 10 blocks, T=52, V=20, batch 64, 256 synthetic val
     samples) on weights of the port's seeded init with alpha, the TAM offset
     conv and the gcn1 BN scale perturbed; checks that K1 was launched 10
     times per batch and that the logits of one batch match the same model
     on the CPU through the plain path; times the eval forward with the
     kernel and with the plain unit op, and lists its device time by kernel
     name (torch.profiler);
  5. train main path: `python -m tamgcn_tpu_torch recognition --phase
     train` in-process at full width on configs/nucla/smoke.yaml (batch 16,
     2 epochs of 128 synthetic samples, eval after each), then `--resume`
     for a third epoch; checks K1 = K2 = K3 = 10 launches per train step
     (and K1 10 per eval batch), finite losses, the checkpoints and
     progress_info.csv; takes 3 SGD steps from the perturbed weights on the
     same batches on the card (f32) and on the CPU (plain path, f64) and
     holds the card's losses and every tensor of its state to the f64 run
     within 10x the f32 error of two references (CPU f32, card f32 with the
     plain unit op) plus a floor, per tensor a share of its own change, for
     the flips of relu and max-pool decisions, after every step; the same
     check with each of K3's six outputs zeroed in turn must fail
     (check_trajectory); times the train step at batch
     16 and 64, with the plain unit op beside it at 16, and lists its device
     time by kernel name;
  6. fast eval: holds K5, the whole eval-mode GCN+TCN block, against its
     plain version at the ten blocks' shapes at batch 64 plus V=25, V=28, a
     ragged shape (Cin != C) and the tensor-core design's edges (N = 1, T
     of 13, Cin of 30 and 136, C of 48 and 144, the epilogue at 16 rows and
     in its wide design), f32 with TF32 off, within rtol 1e-5 and atol
     1e-4*max|plain| (four products in a row, each summing up to 3*C terms in
     another order), two launches bitwise equal, and times it, its plain
     version and the folded path with K1 and cuBLAS products
     (use_kernel=False), by events and by a CUDA graph; runs `--phase test
     --fast_eval true` through `__main__.main` at full width (as phase 4)
     and checks that K5 was launched 10 times per batch and K1-K3 never,
     and the logits of one batch against the unfused model on the CPU;
     times the forward at batch 64 three ways (fast eval with K5, fast eval
     with use_kernel=False, the unfused model) and lists their device time
     by kernel name. K5's bf16 form (gcn_tcn_block_bf16: a bf16 x and
     outputs, the JAX kernel's bf16 body) against its plain bf16 version at
     the same shapes: at least 95% of each output's elements bit for bit
     equal and every element within 2^-7 of max |plain|, two launches bit
     for bit equal, its CUDA-graph time beside its bound (2-byte
     activations), its plain version and the f32 form on the same values;
  7. fused-conv3 training and CTRGC: holds K6, the x3 gradient carried
     through conv3's VJP, against its plain version at the l5-l10 shapes at
     batch 16 plus V=25, a ragged shape (odd T, Cin != 4k) and the
     two-phase design's edges (N = 1, Cin = C = 136 at T = 11, V = 24 and
     32 at R = 32), f32 with TF32 off: dx within rtol 1e-5 and atol
     1e-4*max|plain| (two products in a row), dw3 and db3 (sums over N*T*V rows) within rtol 1e-4 and atol
     1e-4*max|plain|; two K6 launches must agree bit for bit; times K6, its
     plain version and the unfused composition (K2, two torch.matmul
     products and a sum). Runs `--phase train` for one epoch with
     TAMGCN_FUSE_CONV3=1 (set around the call and restored after) and checks
     K1 = 10 per step and eval batch, K2 = 4, K6 = 6 and K3 = 10 per step,
     finite losses and the checkpoint; runs check_trajectory with the switch
     on, whose planted faults then zero each of K6's outputs; times the train
     step with the switch on at batch 16 and 64 beside the default step,
     with device time by kernel name. Then the standalone CTRGC module,
     forward and backward on the card (K1 and K2 at S = 1, K4's path) against
     the same module with the plain single-subset op, and ctr_gc_fused
     without b4 against its plain version, at (N=16, T=52, V=20, Cin=64,
     C=128) and V=25 (K1t and K2t there), each launch on the counter of the
     design the shape takes, and times K4's work (K1 and K2 at S = 1)
     against its plain version.
  8. experiment kernels T1 and T2: holds T1, the eval multi-scale TCN, against
     its plain version at the ten fast-eval blocks' branch shapes at batch 64
     plus V=25, a ragged shape (N=3, odd T at stride 2, bc=5) and the
     tensor-core design's edges (bc=128 at stride 1 and, with odd T, at
     stride 2; bc=5 at stride 1; bc=200; V=600), f32 with TF32 off, within
     rtol 1e-5 and atol 1e-4*max|plain| (each output sums up to 5*bc terms
     in another order than cuDNN's), two launches bitwise equal, and times
     it beside its plain version and the engine's cuDNN composition; runs
     T1 on the ten folded blocks of the phase-4 model with prefixes from its
     K5 blocks (ms_tcn_operands); holds T2 in every form (tile, win, floor,
     flat with and without the subset sum, f32; tile on bf16 operands)
     against its plain version at the tools' shape (N=64, T=13, V=20,
     C=256, S=3), V=25 and a ragged shape, and at the streaming design's
     edges (V=32, V=1, L=10, N*T=21; there also the floor form in bf16, with
     and without the subset sum), f32 within rtol 1e-5 and atol
     1e-5*max|plain|, bf16 within one rounding of the output (rtol 2^-7), two
     launches bitwise equal, timed beside its plain version and one
     torch.einsum call (a line per f32 form at the tools' shape and V=25
     says which is faster), and on m and x3 views 4- but not 16-byte aligned
     and, in bf16, 2-byte aligned; then runs the three port tools
     (exp_ms_tcn, exp_stage2, exp_stage2b) in-process and checks each one's
     launches. T1's bf16 form (ms_tcn_bf16: a bf16 prefix and output) as
     K5's in phase 6, at T1's shapes, beside the f32 form and the engine's
     cuDNN composition on the widened prefix; then the bf16 block path: the
     ten blocks of a fast-eval forward at batch 64 on bf16 x through
     gcn_tcn_block_fused and ms_tcn_fused (the ops are the bf16 forms' entry
     points: JAX's engine takes no bf16 prefix), the counts set to 0 just
     before and K5_bf16 = T1_bf16 = 10 just after, every output finite
     bf16.
  9. scene256: `python -m tamgcn_tpu_torch recognition -c
     configs/scene256.yaml` (V=256, the synthetic random-tree graph, batch 8)
     in-process: --phase train for 2 epochs of 8 steps, then --phase test and
     --phase test --fast_eval true on perturbed, calibrated weights; checks
     the joint-tiled K1 = 10 per forward, the joint-tiled K2 = K3 = 10 per
     train step, and no whole-V K1 or K2, no K5 and no K6; holds the logits
     of one batch of each test run to the same model on the card with the
     plain unit op within 1e-4*max|logit|, and times the eval forward, the
     fast-eval forward and the train step with their device time by kernel.
 10. bf16: the bf16 forms of K1, K2 and K3 (bf16 activations, f32
     parameters; K1t and K2t at a ragged V=37 and the joint-tiled design's
     edges, two launches of each bitwise equal) against their bf16 plain
     versions at the NW-UCLA eval forward's and train step's shapes: bf16
     outputs within 2^-7 of their max |value| and equal in all but 1% of
     their elements, K3's f32 outputs as in phase 3, two K3 launches bitwise
     equal, each launch on its bf16 counter (K3-bf16, a design of its own in
     csrc/unit_ctr_gc_bwd_param_bf16.cu, at V = 25, 37 and 256 too; every
     launch check requires its wrapper's count to be the count its C
     launcher keeps); `--phase test` (also with
     `--fast_eval true`, which on a bf16 model at V=20 is its own forward:
     the same K1-bf16 launches and the same scores) and one epoch of
     `--phase train` through `__main__.main` at full width with
     `--model_args dtype=bfloat16` (configs/nucla/gcn_bf16.yaml's compute
     dtype): K1-bf16 10 per forward, K2-bf16 and K3-bf16 10 per train step
     and no f32 unit-op kernel, the logits of one batch against the card's
     plain bf16 unit op within 2^-5 of max |logit|, finite progress and f32
     checkpoints; 3 bf16 SGD steps with the kernels held to the same steps
     with the plain bf16 unit op after the first step, within twice the
     distance of an f32 run from them (the loss and each tensor; later
     losses finite; check_trajectory_bf16, which prints the spread of two
     plain runs per step), which must fail with each of K3-bf16's outputs
     and K2-bf16's dx3 zeroed; the bf16 eval forward at
     batch 64 and train step at batch 16 and 64 timed beside the f32 ones;
     tools/bf16_convergence.py in-process for 2 small epochs with a launch
     check of every counter.
 11. bf16 with TAMGCN_FUSE_CONV3=1 and the standalone CTRGC in bf16: holds
     K6-bf16 (bf16 activations, its x3 gradient kept in bf16 inside, bf16
     products fed by cp.async)
     against its bf16 plain version at phase 7's shapes (l5-l10 at batch 16,
     V=25, a ragged shape with odd T and Cin not a multiple of 8, the
     two-phase design's edges): dx, dw3 and db3 within 2^-7 of their max
     |plain| and equal in all but 1% of the elements, two launches bitwise
     equal, timed beside its plain version and the unfused composition
     (K2-bf16, two bf16 torch.matmul products and a sum); one epoch of
     `--phase train` through `__main__.main` at full width with
     `--model_args dtype=bfloat16` and TAMGCN_FUSE_CONV3=1 (set around the
     call and restored): K1-bf16 10 per step and eval batch, K2-bf16 4,
     K6-bf16 6 and K3-bf16 10 per step, no f32 kernel, finite losses and
     f32 checkpoints; check_trajectory_bf16 with the switch on (phase 10's
     references), which must fail with each of K6-bf16's outputs zeroed;
     the bf16 train step with the switch at batch 16 and 64 timed beside the
     bf16 default step, with device time by kernel name; then
     CTRGC(dtype="bfloat16") forward and backward on the card through
     K4-bf16 (bf16 x1, x2, x3, f32 output) against the same module with its
     plain versions at (N=16, T=52, V=20, Cin=64, C=128) and V=25, each
     launch on the counter of its direction and design, and K4-bf16's
     forward and transpose on the module's operands within 1e-4 *
     max|plain|, two launches bitwise equal, timed against its plain
     version.
 12. compiled steps: the trainer runs its train, eval and fast-eval steps
     as CUDA graphs on the card (tamgcn_tpu_torch/train/graphs.py), so every
     path of phases 4-11 that goes through the trainer, and every
     trajectory check with its planted faults, ran graphed; this phase holds
     the graphed train step (packed state, train/packing.py) to the eager
     one over 3 steps at batch 16, f32, bf16 and with TAMGCN_FUSE_CONV3=1:
     losses, parameters, momentum and BatchNorm statistics bit for bit with
     cuDNN's deterministic algorithms (with its default ones two eager runs
     already differ, and the distances are printed), and the graphed eval
     and fast-eval logits at batch 64 to the eager ones bit for bit; shows
     that eval and fast-eval graphs captured before a train step and a
     weights load score the new weights; and times the eager and graphed
     forms in turns (the f32 train step at batch 16 and 64, the bf16 one at
     16, the eval and fast-eval forward at 64, the scene256 train step at
     8): wall ms, device-busy ms, idle share, host launches (the launch
     calls torch.profiler records on the host; a replay is one).
 13. the rest of the NW-UCLA skeleton path: writes synthetic NW-UCLA clips
     in the dataset's layout (<name>/<name>.json, "skeletons" T x 20 x 3)
     for every name of both split lists, T drawn per clip from a seeded
     generator; times the assembly of each batch of one epoch of
     configs/nucla/gcn.yaml's train feeder at batch 16 by both backends
     (numpy on the loader's thread pool, the native C++ core by name), which
     must agree bit for bit, beside phase 12's graphed f32 train step; runs
     gcn.yaml's train phase (one epoch, repeat 5 as shipped, full width)
     through `__main__.main` with backend="native" for both feeders (K1-K3
     10 per step and warm-up call, K1 10 per eval batch) and times the train
     loop (loader, prefetch, graphed step) with each backend, wall and
     device busy; runs configs/nucla/stgcn.yaml through `__main__.main` for
     one graphed epoch (repeat cut to 1) and --phase test on the best.pt it
     wrote (no port kernel launched; the card's logits against a CPU f64 run
     within 1e-4 * max), times the ST-GCN step eager and graphed, and runs
     tamgcn_tpu_torch.tools.train_stgcn_importance for one epoch (its
     label_weights.json normalised to max 1 per class); runs --phase test on
     phase 4's weights as a .pt, a reference-named .npz and a Flax-layout
     .npz (equal scores bit for bit); a short train run with --profile_dir
     (the trace holds K1-K3 and the graph launches); and --debug_nans, which
     must stop at a NaN planted in l5.tcn1.pw_conv's weight naming that
     module, with the step timed with the check on and off.
 14. NTU-60, the RGB and the cross-modal families: K1t, K2t and K3 against
     their plain versions at configs/ntu60.yaml's train-step shapes (N*M =
     256, T = 64, V = 25, past the whole-V design), K1t also at its eval
     shapes and K5 at its fast-eval shapes (batch 256, N*M = 512), with
     phase 3's and phase 6's tolerances; synthetic NTU clips (two persons
     in the mutual actions A050-A060, one in the rest; 30-300 frames) in the
     generic skeleton feeder's layout; ntu60.yaml as shipped but for
     --distributed false through `__main__.main`: 3 graphed train steps at
     batch 128 and the eval (K1t, K2t, K3 10 per step and warm-up call, K1t
     10 per eval batch), --phase test on the run's checkpoint directory and
     --phase test --fast_eval true (K5 10 per batch), the two runs' scores
     within 1e-4 * max of each other; numpy batch assembly at batch 128
     (NTU_ASSEMBLY_BATCHES batches after the first) beside the graphed
     step's wall and busy time and each kernel's device time a step beside
     its bound. recognition_rgb_only at
     configs/nucla/resnet.yaml's shapes (224 x 224, batch 16, synthetic
     images), f32 and bf16: one epoch of 4 graphed steps with its eval and
     --phase test (no port kernel), the graphed step against the eager one
     over 3 steps bit for bit with deterministic cuDNN, each step's wall
     and busy time and kernels. recognition_cross_modal at
     configs/nucla/cross_modal.yaml's shapes (batch 16, T = 52, 15 x 224 x
     224) with --weights phase 4's CTR-GCN .pt: one epoch of 3 graphed
     steps with its eval, K1 10 per step and eval forward and K2 = K3 = 0,
     the GCN's parameters and BatchNorm statistics after training bit for
     bit the CTR-GCN's, the fusion model's `gcn` features bit for bit the
     CTR-GCN's own; on weights with calibrated BatchNorm statistics the
     test phase's logits against a CPU f64 run within 1e-4 * max |logit|
     (TF32 off) and, with --model_args dtype=bfloat16 (K1_bf16 10 per
     batch), within 2^-5 * max of the card's plain bf16 unit op; the
     graphed step's wall and busy time. Phase 14 times every step twice:
     with TF32 off, as every numerics check of the run holds, and with the
     TF32 switches the port's trainer runs with (torch's defaults: cuDNN
     convolutions in TF32), each step captured under its setting.
 15. seeded dropout and the serving export: gcn.yaml's CTR-GCN at full
     width with drop_out 0.5 (ops/dropout.py: masks keyed on the seed and
     the packed state's device step counter): one train epoch through
     `__main__.main` (K1-K3 10 per step and warm-up call); two replays of
     the graphed train step, whose head dropout must each be the seeded mask
     of the step the counter held, bit for bit, and differ from each other;
     the mask on the card equal to the CPU's, its kept share within 5 sigma
     of 1 - p; the graphed step against the eager one over 3 steps and a
     run resumed from a checkpoint at step 2 against an unbroken one of 4,
     bit for bit with deterministic cuDNN. Then phase 4's CTR-GCN exported
     at batch 64 by tamgcn_tpu_torch.tools.export_serving in-process (its
     eval forward, held on the card and, moved, on the CPU; the --fast_eval
     engine; a --poly_batch artifact), each reloaded in a process that
     imports tamgcn_tpu_torch.ops alone: K1 10 launches a call (K5 10 with
     --fast_eval), the logits within 1e-5 * max |logit| of the live graphed
     eval and fast-eval forwards (the --poly_batch artifact also at batch
     17 against the live model), and the check must fail on the logits of
     the artifact with the unit op's CUDA implementation returning zeros;
     prints each artifact's bytes, export seconds, ms a call and samples/s
     (CUDA events), device busy and kernels (torch.profiler) beside the
     graphed eval forward; serving.entry() on the card (K1 10).
 16. the parallel layer on two gloo ranks sharing the card (NCCL refuses
     two ranks on one card): one launch of two ranks (parallel/launch.py:
     run_ranks, each rank phase16_rank) runs tamgcn_tpu_torch.serving's dry
     run at full width (dryrun_plan(2, full=True)) with phase 5's weights
     and batches (gcn.yaml's CTR-GCN, base_channel 64, T = 52, global batch
     16): DP over (2, 1) and the joint ring (k = 2, vb = 10) and SP (T = 52
     as 26 + 26 frames) for 3 SGD steps, TP of the head for one, the ring at
     configs/scene256.yaml's widths (V = 256, vb = 128, batch 8), ST-GCN's
     ring and the TP of cross_modal.yaml's attention MLP (224 x 224 images)
     for one each, the same two models time-sharded (SP: T = 52 as 26 + 26
     frames; the fusion model's CTR-GCN split, its RGB trunk whole on both
     ranks) for one each, and the ring's unit op, output and VJP, against the
     dense plain version at each block shape of both CTR-GCNs (the output
     within 1e-5 of its max, the gradients within 1e-4, alpha's 1e-3); then
     each planted fault's mode once more with the fault in place. Each
     mode's first loss within 1e-4 of the single rank's on the card, SP's
     of DP's (serving.verify_dryrun); DP, the ring, SP and TP held to phase
     5's f64 CPU run by check_trajectory's rule after every step; scene256's
     ring, ST-GCN's ring and SP step and the fusion TP and SP steps held,
     state and reduced gradients per tensor, to their model's single-rank
     f64 step on the card with the plain unit op by the same rule
     (grid_references), every parameter bit for bit alike on both ranks
     (check_ranks_agree). The
     ring with one block skipped, with x2's gradient left unsummed,
     scene256's ring with K2t's dx3s or K3's dw4s zeroed, and in each SP
     mode (the CTR-GCN's, ST-GCN's, the fusion model's) every halo frame
     zeroed, and the time-sharded gradient shares averaged instead of summed
     (in the fusion model, whose CTR-GCN is frozen, the replicated gradients
     summed instead of averaged) must each leave its check on both ranks;
     the phase prints its seconds split into the launch, the dry run, the
     earlier four faults, the six SP faults and the checks. Per rank: K1 =
     K2 = K3 = 20 a ring train step (whole-V), K1t = K2t = K3 = 20 at scene256 and no whole-V kernel there, 10 a DP or SP
     step; every step's wall, and the scene256 step's kernel and copy time
     by torch.profiler beside phase 12's dense step. Then `python -m
     torch.distributed.run --nproc_per_node 2 -m tamgcn_tpu_torch
     recognition` (--graph_partition ring --model_parallel 2 --distributed
     true --device 0 0) trains one short epoch at gcn.yaml's widths, its
     closing eval on the two ranks writing the scores; one process's
     --phase test on the epoch's checkpoint gives the same scores within
     1e-5 * max |score|. Then `--debug_nans true` on the two ranks
     (--sequence_parallel, --model_parallel 2, gcn.yaml's widths) with a NaN
     planted in the last frame of every clip, the second rank's frames
     alone: both ranks raise FloatingPointError naming the same module
     within the launch's timeout. The ranks' launches are counted in their
     own processes.
A kernel launched inside a CUDA-graph capture counts once on its wrapper's
counter and runs at every replay: every launch check counts the launches
that ran on the card, the wrappers' counts less what the captures counted
plus the replays' (train/graphs.py:launches_run), and a run through the
trainer prints each step's captures, warm-up calls and replays. The launch
checks of phases 4-11 also require K6 = 0 (except with the
switch on), T1 = T2 = 0 (except in the tools' runs), the joint-tiled
designs at 0 outside phase 9, the bf16 forms at 0 outside phases 10-11 and
K6-bf16 and K4-bf16 at 0 outside phase 11; phase 14's require every
kernel its path does not run at 0. The
last lines are the card line, the
kernels JSON and the result JSON. The kernels JSON gives, for each kernel,
its times and bound summed over the launches of one eval forward at batch 64
(K1; per train step at batch 16 under "per_train_step"), of one train step at batch 16 (K2, K3 with its CUDA-graph time under
"device_ms"; K6 with the switch on, with the unfused composition's time
under "unfused_k2_cublas_ms"), of one scene256 eval forward or train step at
batch 8 (the joint-tiled K1t, K2t), of one CTRGC
forward and backward (K4), of one fast-eval forward at batch 64 (K5, its
CUDA-graph time under "device_ms", the folded path's under
"folded_k1_cublas_ms" and "folded_k1_cublas_device_ms"; T1 at the ten blocks'
branch shapes, with the engine composition's time as "library_ms") or of one
tile-form call at the tools' shape (T2, with one einsum's time as
"library_ms"), of one bf16 eval forward at batch 64 (K1_bf16) or bf16 train
step at batch 16 (K2_bf16, K3_bf16; K6_bf16 with the switch on, the
composition's time under "unfused_k2_cublas_ms"), of one bf16 CTRGC forward
and backward (K4_bf16), of one fast-eval forward's blocks at batch 64 on
bf16 x (K5_bf16, its launches from the bf16 block path) or one call at each
tool shape on a bf16 prefix (T1_bf16, with the cuDNN composition on the
widened prefix as "library_ms"), each bf16 form's CUDA-graph time under
"device_ms" beside its f32 form's on the same values ("f32_device_ms"),
and each shape's row under "shapes";
the unit-op kernels' CUDA-graph device time under "device_ms". K1t, K2t, K3
and K5 also carry phase 14's NTU-60 rows and sums under "ntu60" (per train
step at batch 128; K5 per fast-eval forward at batch 256), K1 the
cross-modal train epoch's launches under "cross_modal", and K1 and K5 the
launches of one call of phase 15's serving artifacts under "serving".
"""
from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1
N_SAMPLES = 256
BATCH = 64
TRAIN_BATCH = 16
TRAIN_SAMPLES = 128  # configs/nucla/smoke.yaml: 8 steps per epoch
EVAL_SAMPLES = 64  # configs/nucla/smoke.yaml test split: 4 batches of 16
LOGIT_RTOL = 1e-4  # |gpu - cpu| <= LOGIT_RTOL * max|cpu|: sum order differs
TRAJ_STEPS = 3
TRAJ_TIMES = 10
TRAJ_LOSS_FLOOR = 1e-2
TRAJ_TENSOR_FLOOR = 2e-2
# K3's outputs; a planted fault zeroes each in turn, and the trajectory
# check must fail for every one
K3_OUTPUTS = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
K6_OUTPUTS = ("dx", "dw3", "db3")
# K6 shapes (N, T, V, Cin, C, R) at the training batch, with the launches per
# train step with TAMGCN_FUSE_CONV3=1 (the blocks with C >= 128)
K6_MAIN_PATH = [
    ("l5", (TRAIN_BATCH, 52, 20, 64, 128, 8), 1),
    ("l6-l7", (TRAIN_BATCH, 26, 20, 128, 128, 16), 2),
    ("l8", (TRAIN_BATCH, 26, 20, 128, 256, 16), 1),
    ("l9-l10", (TRAIN_BATCH, 13, 20, 256, 256, 32), 2),
]
K6_EXTRA = [
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 128, 16)),
    ("V=25 R=32", (TRAIN_BATCH, 13, 25, 256, 256, 32)),
    ("ragged", (3, 7, 20, 30, 40, 10)),  # odd T, Cin != 4k, partial tile
    # the two-phase design's edges: N = 1; rows not a multiple of the
    # 64-row product tile or the 32-row chunk, Cin and S*C not multiples of
    # the 64-wide tiles; V = 24 at R = 32 (the whole-V x3 gradient's last V)
    # and V = 32 at R = 32 (the joint-tiled x3 gradient)
    ("N=1", (1, 13, 20, 256, 256, 32)),
    ("Cin=C=136", (1, 11, 20, 136, 136, 16)),
    ("V=24 R=32", (2, 9, 24, 64, 128, 32)),
    ("V=32 R=32", (2, 9, 32, 64, 128, 32)),
]
# the standalone CTRGC module (N, T, V, Cin, C): its first shape is K4's main
# path, one forward and backward
CTRGC_SHAPES = [
    ("l5 widths", (TRAIN_BATCH, 52, 20, 64, 128)),
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 128)),
]
# T1 shapes (N, T, V, bc, stride): exp_ms_tcn's six shapes (bc = C/4), the
# ten fast-eval blocks' branch halves at N=64 and an NTU-shaped block, each
# launched as often in one run of the tool; and a ragged one the tool lacks
T1_TOOL_SHAPES = [
    ("l1-l4", (64, 52, 20, 16, 1)),
    ("l5", (64, 52, 20, 32, 2)),
    ("l6-l7", (64, 26, 20, 32, 1)),
    ("l8", (64, 26, 20, 64, 2)),
    ("l9-l10", (64, 13, 20, 64, 1)),
    ("V=25", (32, 64, 25, 16, 1)),
]
T1_EXTRA = [
    ("ragged", (3, 7, 20, 5, 2)),  # odd T at stride 2, bc not a multiple of 4
    # the tensor-core design's edges: two channel slices (bc = 128), with odd
    # T at stride 2; bc = 5 at stride 1; slices of 32 channels and blocks of
    # fewer joints than V (bc = 200); joint tiles (V = 600)
    ("bc=128", (4, 13, 20, 128, 1)),
    ("bc=128 s=2", (2, 11, 25, 128, 2)),
    ("bc=5 s=1", (2, 9, 20, 5, 1)),
    ("bc=200", (2, 9, 20, 200, 1)),
    ("V=600", (1, 7, 600, 16, 2)),
]
# T2 shapes (N, T, V, C, S): the stage-2 tools' shape, V=25, a ragged one;
# and the cases (form, subset sum, operand type) held at each
T2_SHAPES = [
    ("tool shape", (64, 13, 20, 256, 3)),
    ("V=25", (64, 13, 25, 256, 3)),
    ("ragged", (3, 5, 7, 10, 3)),
]
T2_CASES = [("tile", False, "float32"), ("tile", False, "bfloat16"),
            ("win", False, "float32"), ("floor", False, "float32"),
            ("flat", False, "float32"), ("flat", True, "float32")]
# the streaming design's edges, in those cases and the floor rule in bf16:
# V = 32, V = 1, L = 10 (4-byte copies), N*T = 21 (not a multiple of a
# warp's row group)
T2_EXTRA = [
    ("V=32", (2, 7, 32, 64, 3)),
    ("V=1", (3, 5, 1, 16, 3)),
    ("L=10", (2, 3, 20, 10, 1)),
    ("N*T=21", (3, 7, 20, 64, 3)),
]
T2_EXTRA_CASES = T2_CASES + [("floor", False, "bfloat16"), ("floor", True, "bfloat16")]
# views whose data_ptr is offset from their storage by a number of elements:
# 4-byte but not 16-byte aligned (f32 by 1, bf16 by 2), 2-byte (bf16 by 1)
T2_UNALIGNED = [("tile", "float32", 1), ("floor", "float32", 1), ("win", "bfloat16", 2),
                ("floor", "bfloat16", 2), ("tile", "bfloat16", 1), ("floor", "bfloat16", 1)]

# unit op shapes (N, T, V, C, R), with the launches per eval forward at N=64
K1_MAIN_PATH = [
    ("l1", (64, 52, 20, 64, 8), 1),
    ("l2-l4", (64, 52, 20, 64, 8), 3),
    ("l5", (64, 52, 20, 128, 8), 1),
    ("l6-l7", (64, 26, 20, 128, 16), 2),
    ("l8", (64, 26, 20, 256, 16), 1),
    ("l9-l10", (64, 13, 20, 256, 32), 2),
]
K1_EXTRA = [
    ("V=24", (64, 26, 24, 128, 16)),  # the whole-V design's last V
    ("ragged", (3, 7, 20, 80, 10)),  # odd T, partial channel tile, R < 16
]
# K5 shapes (N, T, V, Cin, C, R), with the launches per fast-eval forward at
# N=64; P = 3C/4 and BC = C/4, a folded down conv where Cin != C
K5_MAIN_PATH = [
    ("l1", (64, 52, 20, 3, 64, 8), 1),
    ("l2-l4", (64, 52, 20, 64, 64, 8), 3),
    ("l5", (64, 52, 20, 64, 128, 8), 1),
    ("l6-l7", (64, 26, 20, 128, 128, 16), 2),
    ("l8", (64, 26, 20, 128, 256, 16), 1),
    ("l9-l10", (64, 13, 20, 256, 256, 32), 2),
]
K5_EXTRA = [
    ("V=25", (64, 26, 25, 128, 128, 16)),
    ("ragged", (3, 7, 20, 80, 64, 10)),  # odd T, Cin != C, partial tile
    # the tensor-core design's edges: N = 1 with T not a multiple of the
    # 8-frame chunk; Cin not a multiple of 4 or of the 32-channel x chunk, C
    # and P not multiples of the 64-column pass; V = 28; the epilogue at 16
    # rows (C 1024) and in its wide design (C 2048)
    ("N=1", (1, 13, 20, 256, 256, 32)),
    ("Cin=30 C=48", (3, 7, 20, 30, 48, 10)),
    ("Cin=136 C=144", (2, 9, 20, 136, 144, 16)),
    ("V=28", (64, 13, 28, 128, 128, 16)),
    ("C=1024", (1, 2, 20, 1024, 1024, 8)),
    ("C=2048", (1, 2, 20, 2048, 2048, 8)),
]
# the same blocks at the training batch, with the launches per train step
BWD_MAIN_PATH = [(name, (TRAIN_BATCH,) + shape[1:], count)
                 for name, shape, count in K1_MAIN_PATH]
BWD_EXTRA = [
    ("V=24", (TRAIN_BATCH, 26, 24, 128, 16)),
    ("V=24 R=32", (TRAIN_BATCH, 13, 24, 256, 32)),
    ("ragged", (3, 7, 20, 80, 10)),
    ("N=1", (1, 13, 20, 256, 32)),
]
# configs/scene256.yaml: V=256, T=32, batch 8 (train and test); its blocks
# (N, T, V, C, R) with the launches per forward (and per train step) of the
# joint-tiled K1 (K2), and a ragged V that leaves partial joint tiles
SCENE = os.path.join(REPO, "configs", "scene256.yaml")
SCENE_BATCH = 8
SCENE_TRAIN_STEPS = 8  # 64 train samples in batches of 8
SCENE_EVALS = 4  # 32 val samples in batches of 8
SCENE_MAIN_PATH = [
    ("l1-l4", (SCENE_BATCH, 32, 256, 64, 8), 4),
    ("l5", (SCENE_BATCH, 32, 256, 128, 8), 1),
    ("l6-l7", (SCENE_BATCH, 16, 256, 128, 16), 2),
    ("l8", (SCENE_BATCH, 16, 256, 256, 16), 1),
    ("l9-l10", (SCENE_BATCH, 8, 256, 256, 32), 2),
]
TILED_EXTRA = [
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 16)),  # NTU's joints, past the whole-V design
    ("ragged V=37", (3, 7, 37, 80, 10)),
    # the joint-tiled design's edges: T not a multiple of the frame tile (13
    # of 16; 40 of 32, a second chunk of 8) with C not a multiple of the
    # channel tile (80 of 64), and N = 1
    ("T=13 C=80", (2, 13, 37, 80, 10)),
    ("T=40", (2, 40, 256, 64, 8)),
    ("N=1", (1, 16, 256, 128, 16)),
]
# K3 runs every V with one design: the scene256 blocks and the ragged V are
# held and timed beside the NW-UCLA train step's shapes
K3_EXTRA = BWD_EXTRA + [(name, shape) for name, shape, _ in SCENE_MAIN_PATH] + TILED_EXTRA
K3_MIN_BLOCKS = 132  # one block per SM at least, at every BWD_MAIN_PATH shape
# K1 and K2 at every shape of K1_MAIN_PATH and BWD_MAIN_PATH: a block per SM
# at least (the whole-V design's blocks hold 8 warps, two or three an SM)
UNIT_MIN_BLOCKS = 132
# phase 10 (bf16): a bf16 output within one rounding of its max |value| of
# its plain version and equal to it in all but 1% of its elements (the
# kernels and the plain versions differ only in f32 sum order before one
# rounding, which flips a value at a near-tie; a missed rounding of stage
# 1's operands changes more: tests/test_torch_bf16.py); the bf16 model's
# logits against the card's plain bf16 unit op; and the bf16 trajectory's
# factor (check_trajectory_bf16)
BF16_TOL = 2.0 ** -7
BF16_SHARE = 0.01
BF16_LOGIT_TOL = 2.0 ** -5
BF16_TRAJ_TIMES = 2.0
# the biases of the convs that feed a train-mode BatchNorm directly: a
# per-channel shift that the BatchNorm removes, so their gradient is zero in
# exact arithmetic and rounding noise in bf16
BN_FED_BIASES = ("down_conv.bias", "offset_conv.bias", "prefix_conv.bias",
                 "tconv_conv.bias", "pw_conv.bias", "residual.conv.bias")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_inputs(shape, seed: int, device):
    """(x1s, x2s, x3s, w4s, b4s, alpha, As, g): the unit op's inputs with a
    random non-symmetric A and alpha != 0, and a gradient g of its output."""
    import torch

    N, T, V, C, R = shape
    S = 3
    g = torch.Generator().manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(device)

    return (
        randn(N, S, V, R), randn(N, S, V, R), randn(N, T, V, S * C),
        randn(S, R, C, scale=0.1), randn(S, C, scale=0.1),
        (torch.rand(1, generator=g) + 0.5).to(device),
        torch.rand((S, V, V), generator=g).to(device),
        randn(N, T, V, C),
    )


# The k*_bound functions return (ms, 'bytes'|'operations'): the larger of
# the f32 values each input read once and each output written once over HBM,
# and the FMAs (2 ops) over the f32 peak, at the published H100 SXM peaks
# (tamgcn_tpu_torch/utils/roofline.py).


def k1_bound(shape, act_bytes=4):
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_sol

    return unit_ctr_gc_sol(*shape, act_bytes=act_bytes)


def k2_bound(shape, act_bytes=4):
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_dx3_sol

    return unit_ctr_gc_dx3_sol(*shape, act_bytes=act_bytes)


def k3_bound(shape, act_bytes=4):
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_param_sol

    return unit_ctr_gc_param_sol(*shape, act_bytes=act_bytes)


# K1, K2 and K3 on unit_inputs' (x1s, x2s, x3s, w4s, b4s, alpha, As, g), and
# their plain versions; in the dtype of the activations they are given


def k1(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    return ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)


def k1_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops import aggregation as agg

    return agg.unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)


def k2(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    return ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)


def k2_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops import aggregation as agg

    return agg.unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)


def k3(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    return ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)


def k3_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
    from tamgcn_tpu_torch.ops import aggregation as agg

    return agg.unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)


def k6_bound(shape):
    """K6's bound (utils/roofline.py: its FMAs at the 3xTF32 rate)."""
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_bwd_conv3_sol

    return unit_ctr_gc_bwd_conv3_sol(*shape)


def k4_bound(shape):
    """K4's work on one CTRGC forward and backward: the single-subset forward
    and its x3 gradient (x1, x2, x3, g, w4, b4, alpha, A in; out, dx3 out),
    K1's and K2's, so its FMAs at their 3xTF32 rate (utils/roofline.py)."""
    from tamgcn_tpu_torch.utils.roofline import TF32X3_FLOPS, bound

    N, T, V, Cin, C = shape
    R = 8 if Cin in (3, 9) else Cin // 8
    elems = 2 * N * V * R + 4 * N * T * V * C + R * C + C + 1 + V * V
    return bound(elems, 4 * N * (V * V * R * C + T * V * V * C), f32_peak=TF32X3_FLOPS)


def block_inputs(shape, seed: int, device):
    """K5's inputs as keywords: alpha != 0, b4 != 0, a random non-symmetric A,
    a BN affine gy far from (1, 0), and a down conv where Cin != C."""
    import torch

    N, T, V, Cin, C, R = shape
    S, P, BC = 3, 3 * C // 4, C // 4
    g = torch.Generator().manual_seed(seed)

    def w(*s, fan=4):
        return torch.randn(s, generator=g) / fan ** 0.5

    args = dict(
        x=torch.randn((N, T, V, Cin), generator=g),
        x1s=torch.randn((N, S, V, R), generator=g),
        x2s=torch.randn((N, S, V, R), generator=g),
        w3=w(Cin, S * C, fan=Cin), b3=w(S * C), w4s=w(S, R, C, fan=R), b4s=w(S, C),
        alpha=torch.tensor([0.7]), As=torch.rand((S, V, V), generator=g),
        gy=torch.stack([1.0 + 0.5 * torch.randn(C, generator=g),
                        0.3 * torch.randn(C, generator=g)]),
        wo=w(C, C, fan=C), bo=w(C), wp=w(C, P, fan=C), bp=w(P),
        wpw=w(C, BC, fan=C), bpw=w(BC),
        wd=None if Cin == C else w(Cin, C, fan=Cin), bd=None if Cin == C else w(C),
    )
    return {k: None if a is None else a.to(device) for k, a in args.items()}


def k5_bound(shape):
    """K5's bound (utils/roofline.py: its FMAs at the 3xTF32 rate)."""
    from tamgcn_tpu_torch.utils.roofline import gcn_tcn_block_sol

    return gcn_tcn_block_sol(*shape)


def _within(got, want, rtol, atol_frac):
    """(ok, max |got - want|, max |want|)."""
    import torch

    err = (got - want).abs()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and not bool(
        (err > rtol * want.abs() + atol_frac * scale).any())
    return ok, err.max().item(), scale


def check_unit_shapes(kname: str, fn, plain, bound_fn, shapes, seed: int, device,
                      plain_iters: int = 20) -> list:
    """`kname` (K1, K1t, K2, K2t or K3: `fn`) against its plain version at
    each (name, shape (N, T, V, C, R), launches per step) of `shapes`, two
    launches bitwise equal, each launch on the counter of the design the
    shape takes, the blocks a launch at a main-path shape (count > 0) at
    least UNIT_MIN_BLOCKS (K3_MIN_BLOCKS), timed by events and by a CUDA
    graph beside its bound (the plain version over `plain_iters` calls);
    returns a row per shape."""
    import torch

    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.utils.timing import graph_ms

    blocks_of = {"K1": ctr_gc.fwd_blocks, "K1t": ctr_gc.fwd_blocks,
                 "K2": ctr_gc.dx3_blocks, "K2t": ctr_gc.dx3_blocks}
    rows = []
    for i, (name, shape, count) in enumerate(shapes):
        args = unit_inputs(shape, seed=seed + i, device=device)
        with torch.no_grad():
            reset_launches()
            got = fn(*args)
            launched = {k: v for k, v in read_launches().items() if v}
            if launched != {kname: 1}:
                raise AssertionError(f"{kname} {name} {shape}: launches {launched}, "
                                     f"expected {kname} once")
            want = plain(*args)
            again = fn(*args)
            torch.cuda.synchronize()
            if kname == "K3":
                for part, a, b in zip(K3_OUTPUTS, got, again):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"K3 {name} {shape}: two launches differ in {part}")
                errs = [(part,) + _within(a, b, *((1e-3, 0.0) if part == "dalpha"
                                                  else (1e-4, 1e-4)))
                        for part, a, b in zip(K3_OUTPUTS, got, want)]
            else:
                if not torch.equal(got, again):
                    raise AssertionError(f"{kname} {name} {shape}: two launches differ")
                rtol = 1e-5
                errs = [("out",) + _within(got, want, rtol, rtol)]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"{kname} {name} {shape} {part}: max |kernel - plain| "
                        f"{max_err:.3e} (max|plain| {scale:.3e}) beyond the "
                        "stated tolerance")
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: plain(*args), iters=plain_iters)
            extra_row = dict(device_ms=graph_ms(lambda: fn(*args)))
            N, T, V, C, R = shape
            if kname == "K3":
                blocks = ctr_gc.bwd_param_blocks(N, 3, V, C)
                floor = K3_MIN_BLOCKS
            else:
                blocks = blocks_of[kname](N, 3, T, V, R, C)
                floor = UNIT_MIN_BLOCKS
                if kname in ("K1", "K2") and blocks != ctr_gc.whole_v_blocks(
                        N, 3, T, C, fwd=kname == "K1"):
                    raise AssertionError(
                        f"{kname} {name} {shape}: the launcher's {blocks} blocks are "
                        "not ops/cuda/ctr_gc.py:whole_v_blocks'")
            if count and kname in ("K1", "K2", "K3") and blocks < floor:
                raise AssertionError(f"{kname} {name} {shape}: {blocks} blocks, "
                                     f"fewer than {floor}")
            extra_row["blocks"] = blocks
        bound_ms, bound_by = bound_fn(shape)
        check_above_bound(f"{kname} {name}", extra_row["device_ms"], bound_ms)
        # the worst output relative to its own scale
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip("NTVCR", shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, **extra_row))
        print(f"{kname:3s} {name:11s} N,T,V,C,R={shape}: max_abs_err "
              f"{worst[2]:.3e} in {worst[0]} (max|plain| {worst[3]:.3e}) "
              f"kernel {ms * 1e3:.1f} us, device {extra_row['device_ms'] * 1e3:.1f} "
              f"us in {blocks} blocks, plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def check_kernels(device):
    """K1 (at the eval and the training batch), K2 (each in its whole-V and
    its joint-tiled design: K1t, K2t) and K3 against their plain versions at
    every shape, two launches of each bitwise equal; each launch must count
    on the counter of the design the shape takes, and K1, K2 and K3 must
    launch at least UNIT_MIN_BLOCKS (K3_MIN_BLOCKS) blocks at every main-path
    shape. Returns {'K1': rows, 'K1_train': rows, 'K1t': rows, 'K2': rows,
    'K2t': rows, 'K3': rows}."""
    # (label, kernel, its call, plain version, bound, main path, extra shapes)
    plan = [
        ("K1", "K1", k1, k1_plain, k1_bound, K1_MAIN_PATH, K1_EXTRA),
        ("K1_train", "K1", k1, k1_plain, k1_bound, BWD_MAIN_PATH, []),
        ("K1t", "K1t", k1, k1_plain, k1_bound, SCENE_MAIN_PATH, TILED_EXTRA),
        ("K2", "K2", k2, k2_plain, k2_bound, BWD_MAIN_PATH, BWD_EXTRA),
        ("K2t", "K2t", k2, k2_plain, k2_bound, SCENE_MAIN_PATH, TILED_EXTRA),
        ("K3", "K3", k3, k3_plain, k3_bound, BWD_MAIN_PATH, K3_EXTRA),
    ]
    out = {}
    for label, kname, fn, plain, bound_fn, main_path, extra in plan:
        shapes = [(n, s, c) for n, s, c in main_path] + [(n, s, 0) for n, s in extra]
        out[label] = check_unit_shapes(kname, fn, plain, bound_fn, shapes, 100, device)
    for label, what in (("K1", f"eval forward at batch {BATCH}"),
                        ("K1_train", f"train step at batch {TRAIN_BATCH}"),
                        ("K2", f"train step at batch {TRAIN_BATCH}"),
                        ("K3", f"train step at batch {TRAIN_BATCH}")):
        summ = kernel_summary(out[label], what)
        device_ms = sum(r["device_ms"] * r["launches_per_step"] for r in out[label])
        print(f"{label[:2]} per {what}: {summ['ms']:.4f} ms by events, {device_ms:.4f} ms "
              f"device (graph), bound {summ['bound_ms']:.4f} ms; at least "
              f"{min(r['blocks'] for r in out[label] if r['launches_per_step'])} blocks a "
              "launch", flush=True)
    return out


def check_k5(device):
    """K5 against its plain version at every shape, two launches bitwise
    equal, and the times of K5, the plain version and the folded path with
    K1 and cuBLAS products (the engine's use_kernel=False); returns the
    rows."""
    shapes = [(n, s, c) for n, s, c in K5_MAIN_PATH] + [(n, s, 0) for n, s in K5_EXTRA]
    return check_k5_shapes(shapes, 300, device)


def check_k5_shapes(shapes, seed: int, device, plain_iters: int = 20) -> list:
    """check_k5 at each (name, shape (N, T, V, Cin, C, R), launches per
    forward) of `shapes`, the plain and folded paths over `plain_iters`
    calls."""
    import torch

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc
    from tamgcn_tpu_torch.ops.cuda.gcn_tcn_block import gcn_tcn_block_fwd
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_plain
    from tamgcn_tpu_torch.utils.timing import graph_ms

    rows = []
    for i, (name, shape, count) in enumerate(shapes):
        args = block_inputs(shape, seed=seed + i, device=device)
        with torch.no_grad():
            got = gcn_tcn_block_fwd(**args)
            again = gcn_tcn_block_fwd(**args)
            want = gcn_tcn_block_plain(**args)
            torch.cuda.synchronize()
            for part, a, b in zip(("prefix", "pw"), got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K5 {name} {shape}: two launches differ in {part}")
            errs = [(part,) + _within(a, b, 1e-5, 1e-4)
                    for part, a, b in zip(("prefix", "pw"), got, want)]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"K5 {name} {shape} {part}: max |kernel - plain| {max_err:.3e} "
                        f"(max|plain| {scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: gcn_tcn_block_fwd(**args))
            plain_ms = cuda_ms(lambda: gcn_tcn_block_plain(**args), iters=plain_iters)
            folded_ms = cuda_ms(lambda: gcn_tcn_block_plain(**args, aggregate=unit_ctr_gc),
                                iters=plain_iters)
            # device time alone, as K6's
            device_ms = graph_ms(lambda: gcn_tcn_block_fwd(**args))
            folded_device_ms = graph_ms(
                lambda: gcn_tcn_block_plain(**args, aggregate=unit_ctr_gc))
        bound_ms, bound_by = k5_bound(shape)
        check_above_bound(f"K5 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, folded_k1_cublas_ms=folded_ms,
                         device_ms=device_ms, folded_k1_cublas_device_ms=folded_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K5 {name:9s} N,T,V,Cin,C,R={shape}: max_abs_err {worst[2]:.3e} in "
              f"{worst[0]} (max|plain| {worst[3]:.3e}) kernel {ms * 1e3:.1f} us "
              f"(device {device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, folded "
              f"K1+cuBLAS {folded_ms * 1e3:.1f} us (device {folded_device_ms * 1e3:.1f}), "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


# the bf16 forms of K5 and T1 against their plain bf16 versions: at least
# BF16_FORM_SHARE of each output's elements bit for bit equal and every
# element within BF16_FORM_TOL of its max |plain| (each sums in another order
# than the plain version before its one rounding to bf16, which flips a value
# at a near-tie; a wrong rounding policy leaves 60-80% equal:
# tests/test_torch_bf16_block.py)
BF16_FORM_SHARE = 0.95
BF16_FORM_TOL = 2.0 ** -7


def check_bf16_form(what: str, got, again, want) -> tuple:
    """One bf16 output of a bf16 form against its plain version and a second
    launch's; raises unless it is bf16, bit for bit the second launch's and
    within the criterion. Returns (share bit for bit equal, max |got -
    want|, max |want|)."""
    import torch

    if got.dtype != torch.bfloat16 or not torch.equal(got, again):
        raise AssertionError(f"{what}: {got.dtype}, or two launches differ")
    a, b = got.float(), want.float()
    share = (a == b).float().mean().item()
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    if not (share >= BF16_FORM_SHARE and err <= BF16_FORM_TOL * scale
            and bool(torch.isfinite(a).all())):
        raise AssertionError(f"{what}: {share:.4%} of the elements equal to the plain "
                             f"version's, max |kernel - plain| {err:.3e} (max |plain| "
                             f"{scale:.3e}) beyond the stated criterion")
    return share, err, scale


def _bf16_row(parts, **times):
    """The row of one shape of a bf16 form: its worst output's numbers."""
    worst = max(parts, key=lambda p: p[2] / max(p[3], 1e-30))
    return dict(times, max_abs_err=worst[2], max_abs_plain=worst[3],
                share_equal=min(p[1] for p in parts), worst_output=worst[0])


def kernel_split(split: dict) -> dict:
    """{short kernel name: device ms a call} of utils/timing.py:graph_split's
    names (the demangled signature cut to the kernel's name; the instances
    of one template summed)."""
    out = {}
    for name, ms in split.items():
        short = name.removeprefix("void ").replace("(anonymous namespace)::", "")
        short = short.split("(")[0].split("<")[0]
        out[short] = out.get(short, 0.0) + ms
    return out


def check_k5_bf16(device, plain_iters: int = 3) -> list:
    """K5's bf16 form (csrc/gcn_tcn_block.cu: gcn_tcn_block_bf16) on a bf16 x
    against its plain bf16 version at phase 6's shapes (BF16_FORM_SHARE,
    BF16_FORM_TOL), two launches bit for bit equal, timed by events and by a
    CUDA graph beside its bound (2-byte activations), its plain version
    (over `plain_iters` calls) and the f32 form on the same values, with the
    device time of each of its four kernels (torch.profiler over a CUDA-graph
    replay); returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.cuda.gcn_tcn_block import gcn_tcn_block_fwd
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_plain
    from tamgcn_tpu_torch.utils.roofline import gcn_tcn_block_sol
    from tamgcn_tpu_torch.utils.timing import graph_ms, graph_split

    shapes = [(n, s, c) for n, s, c in K5_MAIN_PATH] + [(n, s, 0) for n, s in K5_EXTRA]
    rows = []
    for i, (name, shape, count) in enumerate(shapes):
        args = block_inputs(shape, seed=900 + i, device=device)
        args["x"] = args["x"].to(torch.bfloat16)
        f32 = dict(args, x=args["x"].float())  # the f32 form on the same values
        with torch.no_grad():
            got = gcn_tcn_block_fwd(**args)
            again = gcn_tcn_block_fwd(**args)
            want = gcn_tcn_block_plain(**args)
            torch.cuda.synchronize()
            parts = [(part,) + check_bf16_form(f"K5_bf16 {name} {shape} {part}", a, b, w)
                     for part, a, b, w in zip(("prefix", "pw"), got, again, want)]
            times = dict(ms=cuda_ms(lambda: gcn_tcn_block_fwd(**args)),
                         plain_ms=cuda_ms(lambda: gcn_tcn_block_plain(**args),
                                          iters=plain_iters),
                         device_ms=graph_ms(lambda: gcn_tcn_block_fwd(**args)),
                         f32_device_ms=graph_ms(lambda: gcn_tcn_block_fwd(**f32)),
                         split_ms=kernel_split(graph_split(lambda: gcn_tcn_block_fwd(**args))))
        bound_ms, bound_by = gcn_tcn_block_sol(*shape, act_bytes=2)
        check_above_bound(f"K5_bf16 {name}", times["device_ms"], bound_ms)
        rows.append(_bf16_row(parts, name=name, launches_per_step=count,
                              shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                              bound_ms=bound_ms, bound_by=bound_by, **times))
        r = rows[-1]
        print(f"K5_bf16 {name:9s} N,T,V,Cin,C,R={shape}: {r['share_equal']:.4%} equal, "
              f"max_abs_err {r['max_abs_err']:.3e} (max|plain| {r['max_abs_plain']:.3e}) "
              f"kernel {r['ms'] * 1e3:.1f} us (device {r['device_ms'] * 1e3:.1f}), f32 form "
              f"device {r['f32_device_ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by}); device us by kernel "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in r["split_ms"].items())
              + f" (sum {sum(r['split_ms'].values()) * 1e3:.1f})", flush=True)
    return rows


def make_weights(path: str, seed: int, model_args=None, feeder_args=None,
                 batch: int = BATCH, device="cpu") -> None:
    """The port's seeded init with what hides the kernels moved off its
    degenerate values (alpha=0 makes M = A and zeroes dx1, dx2, dw4 and db4,
    the 1e-6 gcn1.bn scale scales the aggregation away, the offset conv
    starts at zero) and calibrated BatchNorm running stats. The model and
    the synthetic feeder are NW-UCLA's unless model_args and feeder_args say
    otherwise; the calibration pass runs on `device`."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.norm import BatchNorm
    from tamgcn_tpu_torch.train.checkpoint import save_weights

    model = get_model("ctrgcn", generator=torch.Generator().manual_seed(SEED),
                      **(model_args or nucla_model_args()))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("gcn1.alpha"):
                t.copy_(0.5 * noise)
            elif "offset_conv.weight" in name:
                t.add_(0.02 * noise)
            elif name.endswith("gcn1.bn.weight"):
                t.copy_(1.0 + 0.1 * noise)
    # running stats from one train-mode pass over a batch of train samples
    # (momentum 1), so that eval activations stay O(1) through the ten
    # blocks instead of growing by orders of magnitude, which would make the
    # CPU/GPU comparison of the logits a test of conditioning
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    feeder = SyntheticSkeletonFeeder(num_samples=batch, split="train", seed=SEED,
                                     **(feeder_args or {}))
    x = torch.from_numpy(np.stack([feeder[i][0] for i in range(batch)]))
    with torch.no_grad():
        model.to(device).train()(x.to(device))
    for bn in bns:
        bn.momentum = 0.1
    save_weights(model.cpu(), path)


def nucla_model_args() -> dict:
    return dict(num_class=10, num_point=20, num_person=1, graph="ucla",
                graph_args={"labeling_mode": "spatial"}, base_channel=64)


# each kernel's launch counter in ops/cuda/ctr_gc.py; K1t and K2t are the
# joint-tiled designs of K1 and K2, the *_bf16 kernels the bf16 forms; K4
# and K4t the bf16 form of K4 forward in either design, K4dx3 and K4dx3t
# its transpose (the x3 gradient)
UNIT_COUNTERS = {"K1": "launches", "K1t": "launches_tiled", "K2": "bwd_dx3_launches",
                 "K2t": "bwd_dx3_tiled_launches", "K3": "bwd_param_launches",
                 "K6": "bwd_conv3_launches", "K1_bf16": "launches_bf16",
                 "K1t_bf16": "launches_tiled_bf16", "K2_bf16": "bwd_dx3_launches_bf16",
                 "K2t_bf16": "bwd_dx3_tiled_launches_bf16",
                 "K3_bf16": "bwd_param_launches_bf16", "K6_bf16": "bwd_conv3_launches_bf16",
                 "K4_bf16": "k4_launches_bf16", "K4t_bf16": "k4_tiled_launches_bf16",
                 "K4dx3_bf16": "k4_t_launches_bf16", "K4dx3t_bf16": "k4_t_tiled_launches_bf16"}
KERNELS = ("K1", "K1t", "K2", "K2t", "K3", "K5", "K6", "T1", "T2", "K1_bf16", "K1t_bf16",
           "K2_bf16", "K2t_bf16", "K3_bf16", "K6_bf16", "K4_bf16", "K4t_bf16", "K4dx3_bf16",
           "K4dx3t_bf16", "K5_bf16", "T1_bf16")


# each kernel's counter in ops/cuda.launch_counts()
COUNTER_KEYS = {k: f"ctr_gc.{c}" for k, c in UNIT_COUNTERS.items()} | {
    "K5": "gcn_tcn_block.launches", "T1": "ms_tcn.launches", "T2": "stage2.launches",
    "K5_bf16": "gcn_tcn_block.launches_bf16", "T1_bf16": "ms_tcn.launches_bf16"}
# K3_bf16's count in its C launcher when the wrappers' counts were last reset
C_COUNT_BASE = {"K3_bf16": 0}


def reset_launches():
    """Every launch counter and the CUDA graphs' records (train/graphs.py:
    captures, warm-ups, replays) to 0."""
    from tamgcn_tpu_torch.ops.cuda import ctr_gc, gcn_tcn_block, ms_tcn, stage2
    from tamgcn_tpu_torch.train import graphs

    for counter in UNIT_COUNTERS.values():
        setattr(ctr_gc, counter, 0)
    gcn_tcn_block.launches = ms_tcn.launches = stage2.launches = 0
    gcn_tcn_block.launches_bf16 = ms_tcn.launches_bf16 = 0
    graphs.reset_stats()
    C_COUNT_BASE["K3_bf16"] = ctr_gc.param_bf16_launched()


def read_launches() -> dict:
    """Every kernel's launches on the card since the last reset (KERNELS):
    the wrappers' counts, which count a launch inside a CUDA-graph capture
    once, less what the captures counted plus what the graphs' replays ran
    (train/graphs.py:launches_run). K3_bf16's wrapper count must be the
    count its C launcher kept (both count at capture)."""
    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.train import graphs

    launched = ctr_gc.param_bf16_launched() - C_COUNT_BASE["K3_bf16"]
    if launched != ctr_gc.bwd_param_launches_bf16:
        raise AssertionError(f"K3_bf16: its wrapper counted {ctr_gc.bwd_param_launches_bf16} "
                             f"launches, its C launcher {launched}")
    counts = graphs.launches_run()
    return {k: counts[COUNTER_KEYS[k]] for k in KERNELS}


def read_graphs() -> dict:
    """{step name: (captures, warm-up calls, replays, {kernel: launches its
    captures counted})} of the CUDA graphs since the last reset."""
    from tamgcn_tpu_torch.train import graphs

    names = {v: k for k, v in COUNTER_KEYS.items()}
    return {name: (s.captures, s.warmups, s.replays,
                   {names[c]: n for c, n in s.captured.items() if n})
            for name, s in graphs.stats.items()}


def graphed(label: str, steps: dict) -> dict:
    """The launches a run through the trainer's CUDA graphs must have made,
    after checking its graphs: `steps` {step name ("train", "eval",
    "fast_eval"): (calls, {kernel: launches a call})}, each step called
    `calls` times. Each graph of a step holds a call's launches (its
    capture counted them once), the step's replays are `calls`, and the
    card ran a call's launches at every replay and at every warm-up call
    before a capture. Prints the captures and replays."""
    seen = read_graphs()
    if set(seen) != set(steps):
        raise AssertionError(f"{label}: CUDA graphs of {sorted(seen)}, expected {sorted(steps)}")
    total = {}
    for name, (calls, per_call) in steps.items():
        captures, warmups, replays, captured = seen[name]
        if replays != calls or captures < 1 or captured != {
                k: n * captures for k, n in per_call.items()}:
            raise AssertionError(
                f"{label}: the {name} step's graphs: {captures} captures counting "
                f"{captured}, {replays} replays; expected {calls} replays of graphs "
                f"holding {per_call} each")
        for k, n in per_call.items():
            total[k] = total.get(k, 0) + n * (calls + warmups)
        print(f"{label}: {name} step, {captures} CUDA graph(s) captured ({warmups} "
              f"warm-up calls), {replays} replays of {per_call} each", flush=True)
    return only(**total)


def only(**counts) -> dict:
    """The launch counts of read_launches with every kernel not named at 0."""
    return dict.fromkeys(KERNELS, 0) | counts


def fuse_conv3(on: bool = True):
    """TAMGCN_FUSE_CONV3 set to 1 (or 0) in os.environ, restored after."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"TAMGCN_FUSE_CONV3": "1" if on else "0"})


def plain_unit_op():
    """The unit op's plain version on the card in place of K1-K3, with the
    switch off so that no block takes the conv3-fused op: the model's math
    without its kernels."""
    from unittest import mock

    from tamgcn_tpu_torch.ops import aggregation

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(aggregation, "unit_ctr_gc",
                                          aggregation.unit_ctr_gc_plain))
    stack.enter_context(fuse_conv3(False))
    return stack


def run_cli(argv):
    """The user's entry point, in-process; returns (seconds, launches)."""
    import torch

    from tamgcn_tpu_torch.__main__ import main

    reset_launches()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    return seconds, launches


def run_test_path(work_dir: str, weights: str, *extra):
    return run_cli([
        "recognition", "-c", os.path.join(REPO, "configs/nucla/smoke.yaml"),
        "--phase", "test", "--weights", weights, "--work_dir", work_dir,
        "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
        "--save_result", "true", "--test_batch_size", str(BATCH),
        "--test_feeder_args", f"num_samples={N_SAMPLES}",
        "--model_args", "base_channel=64", *extra,
    ])


def check_logits(work_dir: str, weights: str):
    """Logits of the first batch from the run's score pickle against the same
    model on the CPU (plain path). Returns the max relative error."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    feeder = SyntheticSkeletonFeeder(num_samples=N_SAMPLES, split="val", seed=SEED)
    if len(scores) != N_SAMPLES:
        raise AssertionError(f"{len(scores)} scores for {N_SAMPLES} samples")
    gpu = np.stack([scores[feeder.sample_name[i]] for i in range(BATCH)])
    x = np.stack([feeder[i][0] for i in range(BATCH)])
    model = get_model("ctrgcn", generator=torch.Generator().manual_seed(SEED),
                      **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    with torch.inference_mode():
        cpu = model.eval()(torch.from_numpy(x)).numpy()
    if gpu.shape != (BATCH, 10) or not np.isfinite(gpu).all():
        raise AssertionError(f"bad logits: shape {gpu.shape}")
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > LOGIT_RTOL:
        raise AssertionError(
            f"GPU logits differ from the CPU plain path: max|d|/max|cpu| "
            f"{rel:.3e} > {LOGIT_RTOL}"
        )
    return rel, x


# the first kernel each wrapper launches, by its counter's name; a bf16 form
# is the same template on __nv_bfloat16, so its name holds "bfloat16", but
# K3's, a design of its own, and K5's, whose aggregation reads f32 operands
# in either form, are named here; K4's kernels (its bf16 form alone) name
# their direction, true for the forward
KERNEL_SYMBOLS = {"K1": "unit_ctr_gc_fwd_kernel", "K1t": "unit_ctr_gc_fwd_tiled_kernel",
                  "K2": "unit_ctr_gc_bwd_dx3_kernel",
                  "K2t": "unit_ctr_gc_bwd_dx3_tiled_kernel",
                  "K3": "unit_ctr_gc_bwd_param_kernel", "K5": "block_agg_kernel",
                  "K6": "unit_ctr_gc_bwd_conv3_kernel", "T1": "ms_tcn_kernel",
                  "T2": "stage2_kernel", "K4": "ctr_gc_fused_kernel<true",
                  "K4t": "ctr_gc_fused_tiled_kernel<true",
                  "K4dx3": "ctr_gc_fused_kernel<false",
                  "K4dx3t": "ctr_gc_fused_tiled_kernel<false",
                  "K3_bf16": "unit_ctr_gc_bwd_param_bf16_kernel",
                  "K5_bf16": "block_agg_bf16_kernel"}


def is_kernel(kname: str, event_name: str) -> bool:
    """Whether a profiler event is the first kernel of `kname` (KERNELS)."""
    base, bf16 = kname.removesuffix("_bf16"), kname.endswith("_bf16")
    if bf16 and kname in KERNEL_SYMBOLS:  # a bf16 form named on its own: K3_bf16
        return KERNEL_SYMBOLS[kname] in event_name
    if base.startswith("K4"):
        return KERNEL_SYMBOLS[base] in event_name
    return KERNEL_SYMBOLS[base] in event_name and ("bfloat16" in event_name) == bf16


def profile_device(fn, reps: int = 5):
    """Device time by kernel name over `reps` calls of fn (torch.profiler):
    (busy_ms, n_kernels, top 10 (name, ms, launches)), all per call. The
    trace must hold every launch of the port's kernels that the wrappers
    counted while it ran; a partial trace is taken once more, then raises.
    One call of fn runs first in the profiler's warm-up step, whose trace
    is discarded: a fresh trace can drop its first kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    attempts = 2
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.01)  # the window's edges away from any kernel
            before = read_launches()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in read_launches().items() if n > before[k]}
            time.sleep(0.01)
            prof.step()
        averages = prof.key_averages()
        traced = {k: sum(e.count for e in averages if is_kernel(k, e.key))
                  for k in launched}
        if traced == launched:
            break
        print(f"torch.profiler traced {traced} of the launches {launched} "
              f"(attempt {attempt} of {attempts})", flush=True)
    else:
        raise AssertionError("torch.profiler missed launches of the port's kernels")
    events = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
              for e in averages if e.self_device_time_total > 0]
    if not events:
        raise AssertionError("the profiler saw no device time")
    events.sort(key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in events)
    n_kernels = sum(count for _, _, count in events)
    return busy_ms, n_kernels, events


def check_above_bound(what: str, device_ms: float, bound_ms: float):
    """A device time below the speed of light is a broken measurement."""
    if device_ms < bound_ms:
        raise AssertionError(f"{what}: device time {device_ms * 1e3:.2f} us below its "
                             f"bound {bound_ms * 1e3:.2f} us")


def print_profile(what, wall_ms, busy_ms, n_kernels, events):
    print(f"{what} device time (torch.profiler): {busy_ms:.3f} ms busy of "
          f"{wall_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle) in "
          f"{n_kernels} kernel launches; top kernels, ms and launches per call:",
          flush=True)
    for name, ms, count in events[:10]:
        print(f"  {ms:8.4f} ms {count:4d}x  {name[:100]}", flush=True)


def time_eval(weights: str, x, device):
    """Steady-state eval forward of one batch of 64: with the kernel and
    with the plain version of the unit op swapped in (CUDA events, in turns
    kernel, plain, kernel), and the device time by kernel name."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: model(xb))
        with plain_unit_op():
            plain_ms = cuda_ms(lambda: model(xb))
        kernel_ms_2 = cuda_ms(lambda: model(xb))
        busy_ms, n_kernels, events = profile_device(lambda: model(xb))
    return min(kernel_ms, kernel_ms_2), plain_ms, busy_ms, n_kernels, events


def time_fast_eval(weights: str, x, device):
    """Steady-state forward of one batch of 64 three ways (CUDA events, in
    turns fast, folded, unfused, then again in reverse): fast eval with K5,
    fast eval with use_kernel=False (K1 and cuBLAS products), the unfused
    model; and the device time by kernel name of each. Returns {way: (ms,
    busy_ms, n_kernels, events)}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    out = {}
    with torch.inference_mode():
        ways = {"fast eval, K5": make_fast_eval(model),
                "fast eval, use_kernel=False": make_fast_eval(model, use_kernel=False),
                "unfused model": model}
        ms = {way: [] for way in ways}
        for order in (list(ways), list(ways)[::-1]):
            for way in order:
                ms[way].append(cuda_ms(lambda: ways[way](xb)))
        for way, fn in ways.items():
            out[way] = (min(ms[way]),) + profile_device(lambda: fn(xb))
    return out


def train_argv(work_dir: str) -> list:
    return [
        "recognition", "-c", os.path.join(REPO, "configs/nucla/smoke.yaml"),
        "--phase", "train", "--work_dir", work_dir, "--use_gpu", "true",
        "--device", "0", "--seed", str(SEED), "--model_args", "base_channel=64",
        "--batch_size", str(TRAIN_BATCH), "--test_batch_size", str(TRAIN_BATCH),
        "--train_feeder_args", f"num_samples={TRAIN_SAMPLES}",
        "--test_feeder_args", f"num_samples={EVAL_SAMPLES}",
        "--eval_interval", "1", "--save_interval", "1",
    ]


def check_train_files(work_dir: str, total: int, epochs: int, label: str):
    """The checkpoints of epochs 1..total, and the last `epochs` rows of
    progress_info.csv (train loss, test loss, top1, top5) finite; returns
    those rows."""
    import numpy as np

    for n in range(1, total + 1):
        if not os.path.isfile(os.path.join(work_dir, "checkpoints", f"epoch{n}.pt")):
            raise AssertionError(f"checkpoints/epoch{n}.pt missing ({label})")
    with open(os.path.join(work_dir, "progress_info.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    # one row per eval of the run
    progress = np.asarray(rows, dtype=np.float64)[total - epochs:]
    if len(progress) != epochs or not np.isfinite(progress).all():
        raise AssertionError(f"progress_info.csv ({label}): {rows}")
    return progress


def run_train_path(work_dir: str):
    """--phase train for 2 epochs, then --resume for a third; checks the
    launch counts, the losses and the files. Returns a summary dict."""
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    argv = train_argv(work_dir)
    summary = {}
    ckpt = os.path.join(work_dir, "checkpoints")
    for label, epochs, extra in (("train", 2, []),
                                 ("resume", 1, ["--resume", "true"])):
        total = 2 + (label == "resume")
        seconds, launches = run_cli(argv + ["--num_epoch", str(total), *extra])
        want = graphed(f"--phase train ({label})", {
            "train": (epochs * steps, dict(K1=10, K2=10, K3=10)),
            "eval": (epochs * evals, dict(K1=10))})
        if launches != want:
            raise AssertionError(
                f"--phase train ({label}): launches {launches}, expected {want} "
                f"(10 per train step of {steps} a epoch, K1 also 10 per eval "
                f"batch of {evals}, each also per warm-up call)")
        progress = check_train_files(work_dir, total, epochs, label)
        if label == "train" and (progress[:, 2].max() > 0) != os.path.isfile(
                os.path.join(ckpt, "best.pt")):
            raise AssertionError("best.pt does not follow the best top-1")
        summary[label] = dict(seconds=seconds, launches=launches,
                              progress=progress.tolist())
        print(f"train path ({label}): {epochs} epoch(s) of {steps} steps at "
              f"batch {TRAIN_BATCH} in {seconds:.2f} s (incl. model build, data "
              f"and eval), launches {launches}; progress (train loss, test "
              f"loss, top1, top5) {progress.tolist()}", flush=True)
    return summary


def train_batches(n: int, batch: int):
    import numpy as np

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder

    feeder = SyntheticSkeletonFeeder(num_samples=n * batch, split="train", seed=SEED)
    out = []
    for b in range(n):
        items = [feeder[i] for i in range(b * batch, (b + 1) * batch)]
        out.append((np.stack([it[0] for it in items]),
                    np.asarray([it[1] for it in items], np.int64)))
    return out


def train_model(weights: str, device, dtype=None, compute=None, capture=None,
                model_args=None, model_name="ctrgcn", check_finite=False, freeze=()):
    """The NW-UCLA model on `weights`, its parameters in `dtype` (float32
    by default) and its compute dtype `compute` (model_args.dtype), with the
    train phase's packed state (train/packing.py: SGD, Nesterov, lr 0.05,
    weight decay 1e-4): (model, state, step), `step(x, y) -> (loss, hits)`
    the fused train step, on the card as CUDA graphs (train/graphs.py, the
    trainer's form) unless `capture` is False (the eager step). `model_args`
    other than NW-UCLA's make another model (scene256's); `model_name` another
    family (ST-GCN: "stgcn"); `check_finite` adds --debug_nans' check (the
    step returns (loss, hits, finite)); `freeze` the --freeze_params
    prefixes."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    model = get_model(model_name, **(model_args or nucla_model_args()), dtype=compute)
    model.load_state_dict(load_weights(weights))
    model.to(device, dtype or torch.float32).train()
    state = PackedTrainState(model, "SGD", weight_decay=1e-4, freeze_prefixes=freeze)
    state.set_lr(0.05)
    step = make_fused_train_step(state, check_finite=check_finite)
    if capture is None:
        capture = torch.device(device).type == "cuda"
    if capture:
        step = GraphedStep(step, "train", state.tensors())
    return model, state, step


def trajectory(weights: str, batches, where, dtype, compute=None):
    """SGD steps from `weights`, one on each of `batches`, through the fused
    train step (on the card its CUDA graph, as the trainer runs it):
    (losses, [state before the first step, after each step], each {name:
    f64 CPU tensor})."""
    import torch

    def state():
        return {k: v.detach().cpu().double().clone()
                for k, v in model.state_dict().items()}

    model, _, step = train_model(weights, where, dtype, compute)
    losses, states = [], [state()]
    for x, y in batches:
        loss, _ = step(torch.from_numpy(x).to(where, dtype), torch.from_numpy(y).to(where))
        losses.append(loss.item())
        states.append(state())
    return losses, states


def trajectory_limits(ref, refs, times=TRAJ_TIMES):
    """The tolerance of a trajectory against `ref` (f64), from the f32
    trajectories `refs`: per step, `times` (TRAJ_TIMES) x the largest |f32 -
    f64| of `refs` + TRAJ_LOSS_FLOOR x |loss|; per tensor after each step,
    `times` x the largest max|f32 - f64| of `refs` + TRAJ_TENSOR_FLOOR x the
    tensor's own change (max abs) from its start over the f64 run."""
    (ref_l, ref_s) = ref
    loss = [times * max(abs(r[0][i] - want) for r in refs)
            + TRAJ_LOSS_FLOOR * abs(want) for i, want in enumerate(ref_l)]
    tensor = [{k: times * max((r[1][i][k] - want).abs().max().item()
                              for r in refs)
               + TRAJ_TENSOR_FLOOR * (want - ref_s[0][k]).abs().max().item()
               for k, want in ref_s[i].items()}
              for i in range(1, len(ref_s))]
    return loss, tensor


def trajectory_ratios(run, ref, limits):
    """{what: |run - ref| / limit} for the loss of every step and every
    tensor after every step (inf where the run is not finite)."""
    import torch

    out = {}
    for i, (got, want, lim) in enumerate(zip(run[0], ref[0], limits[0])):
        out[f"loss of step {i}"] = (abs(got - want) / lim if math.isfinite(got)
                                    else math.inf)
    for i, lims in enumerate(limits[1], start=1):
        for k, lim in lims.items():
            got, want = run[1][i][k], ref[1][i][k]
            err = (got - want).abs().max().item()
            out[f"{k} after step {i}"] = (
                math.inf if not torch.isfinite(got).all()
                else 0.0 if err == 0 else err / lim if lim else math.inf)
    return out


# the planted faults of check_trajectory: the kernel, its wrapper and outputs
FAULTS = {"K3": ("unit_ctr_gc_bwd_param", K3_OUTPUTS),
          "K6": ("unit_ctr_gc_bwd_conv3", K6_OUTPUTS)}


def check_trajectory(weights: str, device, faulted: str = "K3", references=None):
    """TRAJ_STEPS SGD steps from the same weights on the same batches: on the
    card with its kernels (f32), and as references on the CPU in f64 and, for
    the size of f32 rounding, on the CPU in f32 and on the card in f32 with
    the plain unit op. Relu and max-pool decisions at near-ties flip under
    rounding-size changes, each flip moving some gradients: one step's
    gradients in f32 leave the f64 ones by percent, and through ten blocks
    of train-mode BatchNorm the trajectory is chaotic. So the card is held
    to the f64 run, after every step, within trajectory_limits. The same
    check is then run on the card with each output of the kernel `faulted`
    (K3, or K6 with TAMGCN_FUSE_CONV3=1) zeroed in turn, and must fail each
    time. `references` (what an earlier call returned) skips the reference
    runs: they compute the model's math whichever conv3 path the card takes
    (tests/test_torch_conv3.py holds the two within 1e-10 in f64). Returns
    the worst (err / limit), its name and the references."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    if references is None:
        batches = train_batches(TRAJ_STEPS, TRAIN_BATCH)
        ref = trajectory(weights, batches, "cpu", torch.float64)
        refs = [trajectory(weights, batches, "cpu", torch.float32)]
        with plain_unit_op():
            refs.append(trajectory(weights, batches, device, torch.float32))
        references = batches, ref, refs, trajectory_limits(ref, refs)
    batches, ref, refs, limits = references
    card = trajectory(weights, batches, device, torch.float32)
    ratios = trajectory_ratios(card, ref, limits)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])
    print(f"card vs CPU, {TRAJ_STEPS} SGD steps at batch {TRAIN_BATCH}: losses "
          f"card {card[0]}, cpu f32 {refs[0][0]}, card f32 plain unit op "
          f"{refs[1][0]}, cpu f64 {ref[0]}; tolerance after every step: |card "
          f"- f64| <= {TRAJ_TIMES} x max(|cpu f32 - f64|, |card plain - f64|) "
          f"+ {TRAJ_LOSS_FLOOR} x |loss| for the loss, + {TRAJ_TENSOR_FLOOR} "
          f"x the tensor's own change over the f64 run for each tensor; worst "
          f"of {len(ratios)}: " + ", ".join(f"{k} {v:.3f}" for k, v in worst[:5])
          + f"; median {sorted(ratios.values())[len(ratios) // 2]:.3f} of its "
          "limit", flush=True)
    if worst[0][1] > 1:
        raise AssertionError("the card's training trajectory left the CPU's")

    wrapper, outputs = FAULTS[faulted]
    real = getattr(ctr_gc, wrapper)
    for part in outputs:
        def faulty(*args, part=part):
            return tuple(t.zero_() if name == part else t
                         for name, t in zip(outputs, real(*args)))

        with mock.patch.object(ctr_gc, wrapper, faulty):
            f_ratios = trajectory_ratios(
                trajectory(weights, batches, device, torch.float32), ref, limits)
        beyond = sorted((k for k, v in f_ratios.items() if v > 1),
                        key=lambda k: -f_ratios[k])
        print(f"planted fault, {faulted}'s {part} zeroed: {len(beyond)} of "
              f"{len(f_ratios)} beyond their limit, worst "
              + ", ".join(f"{k} {f_ratios[k]:.3f}" for k in beyond[:5]), flush=True)
        if not beyond:
            raise AssertionError(
                f"the trajectory check passed with {faulted}'s {part} zeroed")
    return worst[0][1], worst[0][0], references


def time_train(weights: str, device):
    """Steady-state train step (forward, backward, SGD step) at batch 16
    (kernels, plain unit op, kernels) and 64 (kernels), CUDA events; the
    device time by kernel name at both. Returns a dict of ms."""
    import torch

    out = {}
    for batch in (TRAIN_BATCH, 64):
        _, _, eager = train_model(weights, device, capture=False)
        (x, y), = train_batches(1, batch)
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

        def step():
            eager(x, y)

        out[f"kernel_ms_{batch}"] = cuda_ms(step, iters=10)
        if batch == TRAIN_BATCH:
            with plain_unit_op():
                out["plain_ms_16"] = cuda_ms(step, iters=10)
            out["kernel_ms_16"] = min(out["kernel_ms_16"], cuda_ms(step, iters=10))
        busy, n_kernels, events = profile_device(step)
        out.update({f"busy_ms_{batch}": busy, f"n_kernels_{batch}": n_kernels,
                    f"events_{batch}": events})
    return out


def conv3_inputs(shape, seed: int, device):
    """K6's inputs (x1s, x2s, g, x, w3, w4s, b4s, alpha, As): the unit op's
    of unit_inputs, conv3's input x and its weight w3 (Cin, S*C), a
    transposed view of a contiguous (S*C, Cin) tensor as in the model."""
    import torch

    N, T, V, Cin, C, R = shape
    x1s, x2s, _, w4s, b4s, alpha, As, g = unit_inputs((N, T, V, C, R), seed, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((N, T, V, Cin), generator=gen).to(device)
    w3 = (torch.randn((3 * C, Cin), generator=gen) / Cin ** 0.5).to(device).t()
    return x1s, x2s, g, x, w3, w4s, b4s, alpha, As


def check_k6(device):
    """K6 against its plain version at every shape, two launches bitwise
    equal, and the times of K6, its plain version and the unfused
    composition it replaces (K2, dx3s @ w3^T and x^T dx3s by torch.matmul,
    the sum for db3); returns the rows."""
    import torch

    from tamgcn_tpu_torch.utils.timing import graph_ms

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_bwd_conv3_plain as plain
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    k6 = ctr_gc.unit_ctr_gc_bwd_conv3

    def unfused(x1s, x2s, g, x, w3, w4s, b4s, alpha, As):
        dx3s = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        flat = dx3s.reshape(-1, dx3s.shape[-1])
        return (torch.matmul(dx3s, w3.t()),
                torch.matmul(x.reshape(-1, x.shape[-1]).t(), flat), flat.sum(dim=0))

    rows = []
    shapes = [(n, s, c) for n, s, c in K6_MAIN_PATH] + [(n, s, 0) for n, s in K6_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        args = conv3_inputs(shape, seed=500 + i, device=device)
        with torch.no_grad():
            got = k6(*args)
            again = k6(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            for part, a, b in zip(K6_OUTPUTS, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K6 {name} {shape}: two launches differ in {part}")
            errs = [(part,) + _within(a, b, rtol, 1e-4)
                    for part, a, b, rtol in zip(K6_OUTPUTS, got, want, (1e-5, 1e-4, 1e-4))]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"K6 {name} {shape} {part}: max |kernel - plain| {max_err:.3e} "
                        f"(max|plain| {scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: k6(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            unfused_ms = cuda_ms(lambda: unfused(*args))
            # device time alone: the composition's four short kernels can
            # wait on the host between launches
            device_ms = graph_ms(lambda: k6(*args))
            unfused_device_ms = graph_ms(lambda: unfused(*args))
        bound_ms, bound_by = k6_bound(shape)
        check_above_bound(f"K6 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, unfused_k2_cublas_ms=unfused_ms,
                         device_ms=device_ms,
                         unfused_k2_cublas_device_ms=unfused_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K6 {name:9s} N,T,V,Cin,C,R={shape}: max_abs_err {worst[2]:.3e} in "
              f"{worst[0]} (max|plain| {worst[3]:.3e}) kernel {ms * 1e3:.1f} us "
              f"(device {device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, unfused "
              f"K2+cuBLAS {unfused_ms * 1e3:.1f} us (device {unfused_device_ms * 1e3:.1f}), "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def run_fused_train_path(work_dir: str):
    """--phase train for one epoch with TAMGCN_FUSE_CONV3=1: K6 at the six
    blocks with C >= 128, K2 at the other four; checks the launch counts, the
    losses and the checkpoint. Returns a summary dict."""
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    with fuse_conv3():
        seconds, launches = run_cli(train_argv(work_dir) + ["--num_epoch", "1"])
    want = graphed("--phase train with TAMGCN_FUSE_CONV3=1", {
        "train": (steps, dict(K1=10, K2=4, K3=10, K6=6)), "eval": (evals, dict(K1=10))})
    if launches != want:
        raise AssertionError(
            f"--phase train with TAMGCN_FUSE_CONV3=1: launches {launches}, "
            f"expected {want} (per train step of {steps} K1 10, K2 4, K6 6, K3 "
            f"10; K1 also 10 per eval batch of {evals})")
    progress = check_train_files(work_dir, 1, 1, "fused conv3")
    print(f"train path (TAMGCN_FUSE_CONV3=1): 1 epoch of {steps} steps at batch "
          f"{TRAIN_BATCH} in {seconds:.2f} s (incl. model build, data and eval), "
          f"launches {launches}; progress (train loss, test loss, top1, top5) "
          f"{progress.tolist()}", flush=True)
    return dict(seconds=seconds, launches=launches, progress=progress.tolist())


def time_train_fused(weights: str, device, compute=None):
    """Steady-state train step at batch 16 and 64 with TAMGCN_FUSE_CONV3=1
    beside the default step, CUDA events in turns default, fused, fused,
    default; the fused step's device time by kernel name; in the compute
    dtype `compute` (model_args.dtype, float32 by default). Returns {batch:
    dict}."""
    import torch

    out = {}
    for batch in (TRAIN_BATCH, 64):
        _, _, eager = train_model(weights, device, compute=compute, capture=False)
        (x, y), = train_batches(1, batch)
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

        def step():
            eager(x, y)

        ms = {False: [], True: []}
        for fused in (False, True, True, False):
            with fuse_conv3(fused):
                ms[fused].append(cuda_ms(step, iters=10))
        with fuse_conv3():
            busy, n_kernels, events = profile_device(step)
        out[batch] = dict(default_ms=min(ms[False]), fused_ms=min(ms[True]),
                          busy_ms=busy, n_kernels=n_kernels, events=events)
    return out


def check_ctrgc(device):
    """The standalone CTRGC module, forward and backward on the card (K1 and
    K2 at S = 1), against the same module with the plain single-subset op;
    ctr_gc_fused without b4 against ctr_gc_fused_plain; and K4's work on the
    module's operands (K1 and K2 at S = 1) against its plain version, timed
    by events and by a CUDA graph. Outputs within rtol 1e-5 and atol
    1e-5*max, gradients within rtol 1e-4 and atol 1e-4*max (alpha's, one sum
    over every term, within rtol 1e-3).
    Returns (rows, launches of the first module's forward and backward)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.models import CTRGC, ctrgcn
    from tamgcn_tpu_torch.ops import aggregation as agg
    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.utils.timing import graph_ms

    def check(what, got, want, rtol, atol_frac):
        ok, max_err, scale = _within(got, want, rtol, atol_frac)
        if not ok:
            raise AssertionError(f"CTRGC {what}: max |route - plain| {max_err:.3e} "
                                 f"(max|plain| {scale:.3e}) beyond the stated tolerance")
        return max_err, scale

    def fwd_bwd(fn, leaves, g):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    rows, main_launches = [], None
    for i, (name, (N, T, V, Cin, C)) in enumerate(CTRGC_SHAPES):
        gen = torch.Generator().manual_seed(600 + i)
        module = CTRGC(Cin, C, generator=gen)
        with torch.no_grad():
            module.conv4_bias.normal_(0.0, 0.1, generator=gen)
        module.to(device)
        x = torch.randn((N, T, V, Cin), generator=gen).to(device)
        A = torch.rand((V, V), generator=gen).to(device)
        alpha = torch.tensor([0.7], device=device)
        g = torch.randn((N, T, V, C), generator=gen).to(device)

        def run():
            module.zero_grad(set_to_none=True)
            out = fwd_bwd(module, (x, A, alpha), g)
            return out + [p.grad for p in module.parameters()]

        reset_launches()
        got = run()
        torch.cuda.synchronize()
        launches = read_launches()
        # the designs the launchers take at S = 1 (whole-V up to V = 24)
        R = module.conv4_kernel.shape[2]
        k1, k2 = (("K1", "K2") if ctr_gc.fwd_variant(1, V, R) == "whole" else ("K1t", "K2t"))
        if ctr_gc.dx3_variant(1, V, R) != ctr_gc.fwd_variant(1, V, R) or launches != only(
                **{k1: 1, k2: 1}):
            raise AssertionError(f"CTRGC {name}: launches {launches}, expected {k1} "
                                 f"and {k2} once each")
        if main_launches is None:
            main_launches = launches[k1] + launches[k2]
        with mock.patch.object(ctrgcn, "ctr_gc_fused", agg.ctr_gc_fused_plain):
            want = run()
        names = ["out", "x", "A", "alpha"] + [k for k, _ in module.named_parameters()]
        for what, a, b in zip(names, got, want):
            check(f"{name} {what}", a, b, *((1e-5, 1e-5) if what == "out" else
                                            (1e-3, 0.0) if what == "alpha" else (1e-4, 1e-4)))
        # the op without b4, on the module's operands
        with torch.no_grad():
            x1, x2 = module.conv1(x).mean(dim=1), module.conv2(x).mean(dim=1)
            x3, w4, b4 = module.conv3(x), module.conv4_kernel[0, 0], module.conv4_bias
        ops = (x1, x2, x3, w4, alpha, A)
        for what, a, b in zip(("out", "x1", "x2", "x3", "w4", "alpha", "A"),
                              fwd_bwd(lambda *t: agg.ctr_gc_fused(*t[:4], None, *t[4:]), ops, g),
                              fwd_bwd(lambda *t: agg.ctr_gc_fused_plain(*t[:4], None, *t[4:]),
                                      ops, g)):
            check(f"{name} without b4 {what}", a, b, *((1e-5, 1e-5) if what == "out" else
                                                       (1e-3, 0.0) if what == "alpha"
                                                       else (1e-4, 1e-4)))
        # K4's work: the forward and the x3 gradient at S = 1
        unit = (x1[:, None], x2[:, None], x3, w4[None], b4[None], alpha, A[None])

        def k4():
            return (ctr_gc.unit_ctr_gc_fwd(*unit),
                    ctr_gc.unit_ctr_gc_bwd_dx3(*unit[:2], g, *unit[3:]))

        def k4_plain():
            m = agg.ctr_gc_dynamic_adjacency(x1, x2, w4, b4, alpha, A)
            return agg.ctr_gc_aggregate(m, x3), torch.einsum("nuvc,ntuc->ntvc", m, g)

        with torch.no_grad():
            errs = [(part,) + check(f"{name} K4 {part}", a, b, 1e-5, 1e-5)
                    for part, a, b in zip(("out", "dx3"), k4(), k4_plain())]
            ms = cuda_ms(k4)
            plain_ms = cuda_ms(k4_plain)
            device_ms = graph_ms(k4)
        route_ms = cuda_ms(run)
        bound_ms, bound_by = k4_bound((N, T, V, Cin, C))
        check_above_bound(f"K4 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[1] / max(e[2], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C"),
                                                   (N, T, V, Cin, C))),
                         launches_per_step=int(i == 0), max_abs_err=worst[1],
                         max_abs_plain=worst[2], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, device_ms=device_ms, module_fwd_bwd_ms=route_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K4 (CTRGC) {name:9s} N,T,V,Cin,C={(N, T, V, Cin, C)}: module forward and "
              f"backward (K1, K2 at S=1) {route_ms:.3f} ms, launches {launches}; K4's work "
              f"(forward + x3 gradient) {ms * 1e3:.1f} us (device {device_ms * 1e3:.1f}), "
              f"plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by}), max_abs_err {worst[1]:.3e} in "
              f"{worst[0]} (max|plain| {worst[2]:.3e})", flush=True)
    return rows, main_launches


def t1_inputs(shape, seed: int, device):
    """T1's operands (prefix, w, b, mp_affine) for (N, T, V, bc, stride)."""
    import torch

    N, T, V, bc, _ = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((N, T, V, 3 * bc), generator=g).to(device),
            (torch.randn((2, 5, bc, bc), generator=g) / (5 * bc) ** 0.5).to(device),
            (0.1 * torch.randn((2, bc), generator=g)).to(device),
            torch.stack([1.0 + 0.5 * torch.randn(bc, generator=g),
                         0.3 * torch.randn(bc, generator=g)]).to(device))


def engine_branches(w, b, mp_affine):
    """The fast-eval engine's composition on T1's operands, as
    models/ctrgcn_infer.py:_apply_block runs it from the folded block: two
    F.conv2d on (out, in, k, 1) kernels, F.max_pool2d, the affine and
    torch.cat. The kernels are laid out once, outside the returned call."""
    import torch
    import torch.nn.functional as F

    bc = w.shape[-1]
    kerns = [w[i].permute(2, 1, 0)[..., None].contiguous() for i in range(2)]

    def run(prefix, stride):
        outs = [F.conv2d(prefix[..., i * bc:(i + 1) * bc].permute(0, 3, 1, 2), kerns[i],
                         b[i], stride=(stride, 1), padding=(2 * (i + 1), 0),
                         dilation=(i + 1, 1)).permute(0, 2, 3, 1) for i in range(2)]
        mp = F.max_pool2d(prefix[..., 2 * bc:].permute(0, 3, 1, 2), kernel_size=(3, 1),
                          stride=(stride, 1), padding=(1, 0))
        outs.append(mp.permute(0, 2, 3, 1) * mp_affine[0] + mp_affine[1])
        return torch.cat(outs, dim=-1)

    return run


def check_t1(device):
    """T1 against its plain version at every shape (rtol 1e-5 + atol
    1e-4*max|plain|: each output sums up to 5*bc terms in another order than
    cuDNN's), two launches bitwise equal, and the times of T1, its plain
    version and the engine's composition; returns the rows."""
    import torch

    from tamgcn_tpu_torch.utils.timing import graph_ms

    from tamgcn_tpu_torch.ops.cuda.ms_tcn import ms_tcn_fwd
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_plain
    from tamgcn_tpu_torch.utils.roofline import ms_tcn_sol

    rows = []
    from tamgcn_tpu_torch.tools.exp_ms_tcn import SHAPES

    if [(n, t, v, 4 * bc, s) for n, t, v, bc, s in dict(T1_TOOL_SHAPES).values()] \
            != list(SHAPES):
        raise AssertionError(f"T1_TOOL_SHAPES are not exp_ms_tcn's {SHAPES}")
    # weight 1 at each tool shape: the summary is one call at each
    shapes = [(n, s, 1) for n, s in T1_TOOL_SHAPES] + [(n, s, 0) for n, s in T1_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        prefix, w, b, mp = t1_inputs(shape, seed=800 + i, device=device)
        stride = shape[-1]
        library = engine_branches(w, b, mp)
        with torch.no_grad():
            got = ms_tcn_fwd(prefix, w, b, mp, stride)
            again = ms_tcn_fwd(prefix, w, b, mp, stride)
            want = ms_tcn_plain(prefix, w, b, mp, stride)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"T1 {name} {shape}: two launches differ")
            ok, max_err, scale = _within(got, want, 1e-5, 1e-4)
            if not ok:
                raise AssertionError(
                    f"T1 {name} {shape}: max |kernel - plain| {max_err:.3e} (max|plain| "
                    f"{scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride))
            plain_ms = cuda_ms(lambda: ms_tcn_plain(prefix, w, b, mp, stride))
            library_ms = cuda_ms(lambda: library(prefix, stride))
            # device time alone: short launches wait on the host, and the
            # composition is five to seven of them
            device_ms = graph_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride))
            library_device_ms = graph_ms(lambda: library(prefix, stride))
        bound_ms, bound_by = ms_tcn_sol(*shape)
        check_above_bound(f"T1 {name}", device_ms, bound_ms)
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "bc", "stride"), shape)),
                         launches_per_step=count, max_abs_err=max_err, max_abs_plain=scale,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         device_ms=device_ms, library_device_ms=library_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"T1 {name:9s} N,T,V,bc,s={shape}: max_abs_err {max_err:.3e} (max|plain| "
              f"{scale:.3e}) kernel {ms * 1e3:.1f} us (device {device_ms * 1e3:.1f}), "
              f"plain {plain_ms * 1e3:.1f} us, engine composition (cuDNN) "
              f"{library_ms * 1e3:.1f} us (device {library_device_ms * 1e3:.1f}), bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def check_t1_bf16(device, plain_iters: int = 5) -> list:
    """T1's bf16 form (csrc/ms_tcn.cu: ms_tcn_bf16) on a bf16 prefix against
    its plain bf16 version at phase 8's shapes (BF16_FORM_SHARE,
    BF16_FORM_TOL), two launches bit for bit equal, timed beside its bound
    (2-byte activations), its plain version, the f32 form on the same values
    and the engine's cuDNN composition on the widened prefix (its output
    rounded to bf16); returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.cuda.ms_tcn import ms_tcn_fwd
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_plain
    from tamgcn_tpu_torch.utils.roofline import ms_tcn_sol
    from tamgcn_tpu_torch.utils.timing import graph_ms

    shapes = [(n, s, 1) for n, s in T1_TOOL_SHAPES] + [(n, s, 0) for n, s in T1_EXTRA]
    rows = []
    for i, (name, shape, count) in enumerate(shapes):
        prefix32, w, b, mp = t1_inputs(shape, seed=1800 + i, device=device)
        prefix = prefix32.to(torch.bfloat16)
        f32 = prefix.float()  # the f32 form on the same values
        stride = shape[-1]
        engine = engine_branches(w, b, mp)

        def library():
            return engine(prefix.float(), stride).to(torch.bfloat16)

        with torch.no_grad():
            got = ms_tcn_fwd(prefix, w, b, mp, stride)
            again = ms_tcn_fwd(prefix, w, b, mp, stride)
            want = ms_tcn_plain(prefix, w, b, mp, stride)
            torch.cuda.synchronize()
            parts = [("out",) + check_bf16_form(f"T1_bf16 {name} {shape}", got, again, want)]
            times = dict(ms=cuda_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride)),
                         plain_ms=cuda_ms(lambda: ms_tcn_plain(prefix, w, b, mp, stride),
                                          iters=plain_iters),
                         library_ms=cuda_ms(library, iters=plain_iters),
                         device_ms=graph_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride)),
                         f32_device_ms=graph_ms(lambda: ms_tcn_fwd(f32, w, b, mp, stride)),
                         library_device_ms=graph_ms(library))
        bound_ms, bound_by = ms_tcn_sol(*shape, act_bytes=2)
        check_above_bound(f"T1_bf16 {name}", times["device_ms"], bound_ms)
        rows.append(_bf16_row(parts, name=name, launches_per_step=count,
                              shape=dict(zip(("N", "T", "V", "bc", "stride"), shape)),
                              bound_ms=bound_ms, bound_by=bound_by, **times))
        r = rows[-1]
        print(f"T1_bf16 {name:9s} N,T,V,bc,s={shape}: {r['share_equal']:.4%} equal, "
              f"max_abs_err {r['max_abs_err']:.3e} (max|plain| {r['max_abs_plain']:.3e}) "
              f"kernel {r['ms'] * 1e3:.1f} us (device {r['device_ms'] * 1e3:.1f}), f32 form "
              f"device {r['f32_device_ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
              f"cuDNN composition on the widened prefix {r['library_ms'] * 1e3:.1f} us "
              f"(device {r['library_device_ms'] * 1e3:.1f}), bound {bound_ms * 1e3:.1f} us "
              f"({bound_by})", flush=True)
    return rows


def run_bf16_block_path(device) -> dict:
    """The bf16 forms' path: the ten blocks of a fast-eval forward at batch
    64 (K5_MAIN_PATH), each block's whole eval block and its multi-scale TCN
    on a bf16 x through the ops' entry points (ops/gcn_tcn_block.py:
    gcn_tcn_block_fused, then ops/ms_tcn.py:ms_tcn_fused on the block's bf16
    prefix at the block's stride), as a user calls them: the JAX package
    feeds K5 and T1 a bf16 input through these ops alone (its fast-eval
    engine's convolutions refuse a bf16 prefix against f32 weights). The
    counts are set to 0 just before the run and must read K5_bf16 = T1_bf16
    = 10 just after; every output bf16, finite and of its shape. Returns
    {"launches", "seconds"}."""
    import torch

    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_fused
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_fused

    blocks = []
    for name, shape, count in K5_MAIN_PATH:
        N, T, V, Cin, C, R = shape
        stride = 2 if name in ("l5", "l8") else 1
        for j in range(count):
            args = block_inputs(shape, seed=1900 + len(blocks), device=device)
            args["x"] = args["x"].to(torch.bfloat16)
            _, w, b, mp = t1_inputs((N, T, V, C // 4, stride), seed=1950 + len(blocks),
                                    device=device)
            blocks.append((args, (w, b, mp), stride))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = []
    with torch.no_grad():
        for args, (w, b, mp), stride in blocks:
            prefix, pw = gcn_tcn_block_fused(**args)
            outs.append((pw, ms_tcn_fused(prefix, w, b, mp, stride), stride))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if launches != only(K5_bf16=10, T1_bf16=10):
        raise AssertionError(f"the bf16 block path launched {launches}, expected K5_bf16 "
                             "and T1_bf16 10 times each and nothing else")
    for (args, _, _), (pw, out, stride) in zip(blocks, outs):
        N, T, V, _ = args["x"].shape
        want = (N, -(-T // stride), V, 3 * args["wpw"].shape[-1])
        for t, shape in ((pw, (N, T, V, want[-1] // 3)), (out, want)):
            if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not bool(
                    torch.isfinite(t.float()).all()):
                raise AssertionError(f"the bf16 block path: an output {t.dtype} "
                                     f"{tuple(t.shape)}, expected finite bf16 {shape}")
    print(f"bf16 block path (ten blocks at batch {BATCH} through gcn_tcn_block_fused and "
          f"ms_tcn_fused on bf16 x): launches {launches['K5_bf16']} K5_bf16, "
          f"{launches['T1_bf16']} T1_bf16 in {seconds * 1e3:.1f} ms", flush=True)
    return {"launches": launches, "seconds": seconds}


def check_t1_real_weights(weights: str, x, device):
    """T1 on the ten folded blocks of the full-width model: operands from
    ms_tcn_operands, prefixes from the model's own K5 blocks in a fast-eval
    forward of the phase-4 batch, each against the plain version on the same
    operands (the tolerance of check_t1). Returns the worst (err, scale)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.models import ctrgcn_infer, get_model
    from tamgcn_tpu_torch.ops.cuda.ms_tcn import ms_tcn_fwd
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_operands, ms_tcn_plain
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    prefixes = []
    real_k5 = ctrgcn_infer.gcn_tcn_block_fused

    def recording(*args):
        prefix, pw = real_k5(*args)
        prefixes.append(prefix)
        return prefix, pw

    with torch.inference_mode():
        folded = ctrgcn_infer.fold_model(model)
        with mock.patch.object(ctrgcn_infer, "gcn_tcn_block_fused", recording):
            ctrgcn_infer.make_fast_eval_fn(model)(folded, torch.from_numpy(x).to(device))
        if len(prefixes) != len(folded["blocks"]):
            raise AssertionError(f"{len(prefixes)} K5 prefixes for "
                                 f"{len(folded['blocks'])} blocks")
        errs = []
        for i, (fb, prefix) in enumerate(zip(folded["blocks"], prefixes)):
            ops = ms_tcn_operands(fb)
            got, want = ms_tcn_fwd(prefix, *ops), ms_tcn_plain(prefix, *ops)
            ok, max_err, scale = _within(got, want, 1e-5, 1e-4)
            if not ok:
                raise AssertionError(
                    f"T1 on block l{i + 1}'s folded weights: max |kernel - plain| "
                    f"{max_err:.3e} (max|plain| {scale:.3e}) beyond the stated tolerance")
            errs.append((max_err, scale))
    worst = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
    print(f"T1 on the ten folded blocks of the full-width model (K5 prefixes of one "
          f"batch of {BATCH}): worst max_abs_err {worst[0]:.3e} (max|plain| "
          f"{worst[1]:.3e})", flush=True)
    return worst


def t2_inputs(shape, form: str, dtype, seed: int, device):
    """T2's operands for (N, T, V, C, S) in a form's layout: M (V, V, S*C)
    (flattened to (V, V*S*C) for the flat form) and x3 (N, T, V, S*C)
    (flattened to (N, T, V*S*C))."""
    import torch

    N, T, V, C, S = shape
    g = torch.Generator().manual_seed(seed)
    m = (0.05 * torch.randn((V, V, S * C), generator=g)).to(device, dtype)
    x3 = torch.randn((N, T, V, S * C), generator=g).to(device, dtype)
    if form == "flat":
        return m.reshape(V, -1), x3.reshape(N, T, -1)
    return m, x3


def t2_library(m, x3, form: str, S: int, subset_sum: bool):
    """One torch.einsum call computing the form's function (for the diagonal
    forms on the M they expand to, expanded here, outside the timed call)."""
    import torch

    from tamgcn_tpu_torch.ops.stage2 import diag_to_vu, stage2_dims

    mv, xv, N, T, V, L = stage2_dims(m, x3, form, S, subset_sum)
    if form == "floor":
        return lambda: torch.einsum("jul,ntul->ntul", mv, xv)
    m_vu = mv if form == "tile" else diag_to_vu(mv)
    if subset_sum:
        m5, x5 = m_vu.reshape(V, V, S, L // S), xv.reshape(N, T, V, S, L // S)
        return lambda: torch.einsum("vusc,ntvsc->ntuc", m5, x5)
    return lambda: torch.einsum("vul,ntvl->ntul", m_vu, xv)


def check_t2(device):
    """T2 in every form against its plain version at every shape, f32 within
    rtol 1e-5 + atol 1e-5*max|plain| (sums of V terms, S*V with the subset
    sum, in another order); the tile form (at the edge shapes also the floor
    form) on bf16 operands, within one rounding of the output (rtol 2^-7, a
    bf16 ulp, + atol 1e-5*max|plain|); two launches bitwise equal; times of
    T2, its plain version and one einsum call. Then T2 on unaligned views
    (check_t2_unaligned). Returns the rows."""
    import torch

    from tamgcn_tpu_torch.utils.timing import graph_ms

    from tamgcn_tpu_torch.ops.cuda import stage2 as t2
    from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain
    from tamgcn_tpu_torch.tools.exp_stage2 import PROBES
    from tamgcn_tpu_torch.utils.roofline import stage2_sol

    # the summary's weights: the probes one exp_stage2 run times at the tool
    # shape in f32 (each launched as often), by (form, subset sum)
    weights = {("flat", True): 1, ("flat", False): 1}
    for _, form in PROBES:
        weights[form, False] = weights.get((form, False), 0) + 1
    rows = []
    k = 0
    cases = [(name, shape, case) for name, shape in T2_SHAPES for case in T2_CASES]
    cases += [(name, shape, case) for name, shape in T2_EXTRA for case in T2_EXTRA_CASES]
    for name, shape, (form, subset_sum, dtype_name) in cases:
        dtype = getattr(torch, dtype_name)
        k += 1
        N, T, V, C, S = shape
        m, x3 = t2_inputs(shape, form, dtype, seed=900 + k, device=device)
        library = t2_library(m, x3, form, S, subset_sum)
        with torch.no_grad():
            before = t2.launches
            got = stage2_aggregate(m, x3, form, S, subset_sum)
            again = stage2_aggregate(m, x3, form, S, subset_sum)
            if t2.launches != before + 2:
                raise AssertionError(f"T2 {form}: the dispatcher did not launch T2")
            want = stage2_plain(m, x3, form, S, subset_sum)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"T2 {name} {form}: two launches differ")
            rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            ok, max_err, scale = _within(got.float(), want.float(), rtol, 1e-5)
            if not ok:
                raise AssertionError(
                    f"T2 {name} {shape} {form} subset_sum={subset_sum} {dtype}: max "
                    f"|kernel - plain| {max_err:.3e} (max|plain| {scale:.3e}) beyond "
                    "the stated tolerance")
            ms = cuda_ms(lambda: stage2_aggregate(m, x3, form, S, subset_sum))
            plain_ms = cuda_ms(lambda: stage2_plain(m, x3, form, S, subset_sum))
            library_ms = cuda_ms(library)
            device_ms = graph_ms(lambda: stage2_aggregate(m, x3, form, S, subset_sum))
            library_device_ms = graph_ms(library)
        bound_ms, bound_by = stage2_sol(N, T, V, S * C, S if subset_sum else 1,
                                        itemsize=x3.element_size())
        case = f"{form}{' ss' if subset_sum else ''} {str(dtype)[6:]}"
        check_above_bound(f"T2 {name} {case}", device_ms, bound_ms)
        weight = weights.get((form, subset_sum), 0) \
            if name == "tool shape" and dtype == torch.float32 else 0
        rows.append(dict(name=f"{name} {case}", shape=dict(zip("NTVCS", shape)),
                         form=form, subset_sum=subset_sum, dtype=str(dtype),
                         launches_per_step=weight, max_abs_err=max_err,
                         max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, device_ms=device_ms,
                         library_device_ms=library_device_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"T2 {name:10s} N,T,V,C,S={shape} {case:16s}: max_abs_err {max_err:.3e} "
              f"(max|plain| {scale:.3e}) kernel {ms * 1e3:.1f} us (device "
              f"{device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, einsum "
              f"{library_ms * 1e3:.1f} us (device {library_device_ms * 1e3:.1f}), bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    for r in rows:
        if r["dtype"] == "torch.float32" and r["shape"]["C"] == 256:
            faster = "faster" if r["device_ms"] <= r["library_device_ms"] else "SLOWER"
            print(f"T2 {r['name']}: device {r['device_ms'] * 1e3:.1f} us, one einsum "
                  f"{r['library_device_ms'] * 1e3:.1f} us: the kernel is {faster}", flush=True)
    check_t2_unaligned(device)
    return rows


def check_t2_unaligned(device):
    """T2 on m and x3 views offset from their storage (T2_UNALIGNED), with
    and without the subset sum, against the plain version on the same values
    at check_t2's tolerances, two launches bitwise equal."""
    import torch

    from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain

    N, T, V, C, S = 3, 5, 20, 12, 3
    g = torch.Generator().manual_seed(990)
    for form, dtype_name, offset in T2_UNALIGNED:
        dtype = getattr(torch, dtype_name)

        def view(shape, scale):
            n = math.prod(shape)
            return (scale * torch.randn(n + offset, generator=g)).to(device, dtype)[offset:].view(
                shape)

        m, x3 = view((V, V, S * C), 0.05), view((N, T, V, S * C), 1.0)
        for subset_sum in (False, True):
            with torch.no_grad():
                got = stage2_aggregate(m, x3, form, S, subset_sum)
                again = stage2_aggregate(m, x3, form, S, subset_sum)
                want = stage2_plain(m, x3, form, S, subset_sum)
            torch.cuda.synchronize()
            what = (f"T2 {form} {dtype_name} subset_sum={subset_sum} on views offset by "
                    f"{offset} element(s) (data_ptr % 16 = {x3.data_ptr() % 16})")
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two launches differ")
            rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            ok, max_err, scale = _within(got.float(), want.float(), rtol, 1e-5)
            if not ok:
                raise AssertionError(f"{what}: max |kernel - plain| {max_err:.3e} (max|plain| "
                                     f"{scale:.3e}) beyond the stated tolerance")
            print(f"{what}: max_abs_err {max_err:.3e} (max|plain| {scale:.3e})", flush=True)


def run_tools():
    """The three port tools in-process on the card, each with the counts set
    to 0 just before it and read just after; checks each tool's launches.
    Returns {tool: (seconds, launches)}."""
    from tamgcn_tpu_torch.tools import exp_ms_tcn, exp_stage2, exp_stage2b

    def timed(chain, iters, warmup=2):
        return (warmup + iters) * chain  # launches of one time_chained

    expected = {
        "exp_ms_tcn": {"T1": len(exp_ms_tcn.SHAPES) * (1 + timed(60, 10))},
        "exp_stage2": {"K1": len(exp_stage2.PRODUCTION) * timed(30, 5),
                       "T2": (len(exp_stage2.PROBES) + 2) * timed(30, 5) + 1},
        "exp_stage2b": {"K1": exp_stage2b.REPS * timed(30, 10),
                        "T2": exp_stage2b.REPS * (len(exp_stage2b.CANDIDATES) - 1)
                        * timed(30, 10)},
    }
    out = {}
    for tool, mod in (("exp_ms_tcn", exp_ms_tcn), ("exp_stage2", exp_stage2),
                      ("exp_stage2b", exp_stage2b)):
        reset_launches()
        t0 = time.perf_counter()
        mod.main([])
        seconds = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(launches, 0) | expected[tool]
        if launches != want:
            raise AssertionError(f"{tool}: launches {launches}, expected {want}")
        out[tool] = (seconds, launches)
        print(f"tool {tool}: {seconds:.2f} s, launches {launches}", flush=True)
    return out


def scene_model_args() -> dict:
    """configs/scene256.yaml's model_args."""
    return dict(num_class=10, num_point=256, num_person=1, graph="synthetic",
                graph_args={"labeling_mode": "spatial", "num_node": 256})


def scene_argv(work_dir: str, phase: str, *extra) -> list:
    return ["recognition", "-c", SCENE, "--phase", phase, "--work_dir", work_dir,
            "--use_gpu", "true", "--device", "0", "--seed", str(SEED), *extra]


def check_scene_logits(work_dir: str, weights: str, device):
    """Logits of the first batch from a scene256 test run's score pickle
    against the same model on the card with the plain unit op (M of one
    subset at l9 is 0.5 GB at batch 8, so the reference is the card's plain
    version rather than the CPU's), TF32 off for matmuls and convolutions on
    both sides. Returns (max relative error, the batch)."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    feeder = SyntheticSkeletonFeeder(num_samples=SCENE_EVALS * SCENE_BATCH, split="val",
                                     seed=SEED, num_point=256, time_steps=32)
    if len(scores) != SCENE_EVALS * SCENE_BATCH:
        raise AssertionError(f"{len(scores)} scores for {SCENE_EVALS * SCENE_BATCH} samples")
    got = np.stack([scores[feeder.sample_name[i]] for i in range(SCENE_BATCH)])
    x = np.stack([feeder[i][0] for i in range(SCENE_BATCH)])
    model = get_model("ctrgcn", **scene_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    with torch.inference_mode(), plain_unit_op():
        want = model(torch.from_numpy(x).to(device)).cpu().numpy()
    if got.shape != (SCENE_BATCH, 10) or not np.isfinite(got).all():
        raise AssertionError(f"bad scene256 logits: shape {got.shape}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if rel > LOGIT_RTOL:
        raise AssertionError(
            f"scene256 logits differ from the card's plain unit op: max|d|/max|plain| "
            f"{rel:.3e} > {LOGIT_RTOL}")
    return rel, x


def run_scene256(work_dir: str, device):
    """Phase 9: configs/scene256.yaml (V=256) through __main__.main on the
    card: --phase train for 2 epochs of 8 steps (eval after each), --phase
    test and --phase test --fast_eval true on perturbed, calibrated weights.
    Checks the launches (the joint-tiled K1 10 per forward, the joint-tiled
    K2 and K3 10 per train step, no whole-V K1 or K2, no K5, no K6), the
    losses and files, and the logits of one batch of each test run against
    the card's plain unit op. Times the eval forward, the fast-eval forward
    and the train step at batch 8, with their device time by kernel name.
    Returns a summary dict."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    out = {}
    train_dir = os.path.join(work_dir, "scene256_train")
    seconds, launches = run_cli(scene_argv(train_dir, "train", "--num_epoch", "2",
                                           "--save_interval", "1"))
    steps, evals = SCENE_TRAIN_STEPS, SCENE_EVALS
    want = graphed("scene256 --phase train", {
        "train": (2 * steps, dict(K1t=10, K2t=10, K3=10)), "eval": (2 * evals, dict(K1t=10))})
    if launches != want:
        raise AssertionError(f"scene256 --phase train: launches {launches}, expected "
                             f"{want} (10 per train step of {steps} an epoch, K1t "
                             f"also 10 per eval batch of {evals})")
    progress = check_train_files(train_dir, 2, 2, "scene256")
    out["train"] = dict(seconds=seconds, launches=launches, progress=progress.tolist())
    print(f"scene256 train: 2 epochs of {steps} steps at batch {SCENE_BATCH} in "
          f"{seconds:.2f} s (incl. model build, data and eval), launches {launches}; "
          f"progress (train loss, test loss, top1, top5) {progress.tolist()}", flush=True)

    weights = os.path.join(work_dir, "scene256_weights.pt")
    make_weights(weights, seed=7, model_args=scene_model_args(),
                 feeder_args=dict(num_point=256, time_steps=32), batch=SCENE_BATCH,
                 device=device)
    for label, extra in (("test", []), ("fast_eval", ["--fast_eval", "true"])):
        test_dir = os.path.join(work_dir, f"scene256_{label}")
        seconds, launches = run_cli(scene_argv(test_dir, "test", "--weights", weights,
                                               "--save_result", "true", *extra))
        if launches != graphed(f"scene256 --phase test {' '.join(extra)}", {
                "fast_eval" if extra else "eval": (evals, dict(K1t=10))}):
            raise AssertionError(
                f"scene256 --phase test {' '.join(extra)}: launches {launches}, expected "
                f"the joint-tiled K1 10 x {evals} batches and warm-up calls and no other "
                "kernel (no block of V=256 takes K5)")
        rel, x = check_scene_logits(test_dir, weights, device)
        out[label] = dict(seconds=seconds, launches=launches, logit_rel_err=rel)
        print(f"scene256 {label}: {evals} batches of {SCENE_BATCH} in {seconds:.2f} s, "
              f"launches {launches}, logits vs the card's plain unit op max rel err "
              f"{rel:.3e}", flush=True)

    model = get_model("ctrgcn", **scene_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device)
    xb = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        model.eval()
        fast = make_fast_eval(model)
        for way, fn in (("eval forward", lambda: model(xb)),
                        ("fast-eval forward", lambda: fast(xb))):
            ms = cuda_ms(fn, iters=10)
            out[way] = (ms,) + profile_device(fn, reps=3)
            print_profile(f"scene256 {way}, batch {SCENE_BATCH}: {ms:.3f} ms;", ms,
                          *out[way][1:])
    model.train()
    state = PackedTrainState(model, "SGD", weight_decay=1e-4)
    state.set_lr(0.05)
    eager = make_fused_train_step(state)
    y = torch.zeros(SCENE_BATCH, dtype=torch.long, device=device)

    def step():
        eager(xb, y)

    ms = cuda_ms(step, iters=5, warmup=2)
    out["train step"] = (ms,) + profile_device(step, reps=3)
    print_profile(f"scene256 train step, batch {SCENE_BATCH}: {ms:.3f} ms;", ms,
                  *out["train step"][1:])
    return out


def bf16_inputs(shape, seed: int, device):
    """unit_inputs with the activations (x1s, x2s, x3s, g) in bf16 and the
    parameters in f32."""
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = unit_inputs(shape, seed, device)
    return (x1s.bfloat16(), x2s.bfloat16(), x3s.bfloat16(), w4s, b4s, alpha, As,
            g.bfloat16())


def bf16_within(got, want):
    """(ok, max |got - want|, max |want|) of a bf16 output against its plain
    version: within BF16_TOL of max |want| and equal in all but BF16_SHARE
    of the elements."""
    import torch

    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    share = (got != want).float().mean().item()
    ok = (bool(torch.isfinite(got).all()) and got.dtype == want.dtype == torch.bfloat16
          and err.max().item() <= BF16_TOL * scale and share <= BF16_SHARE)
    return ok, err.max().item(), scale


def check_kernels_bf16(device):
    """Phase 10's kernel checks: K1, K2 and K3 on bf16 activations with f32
    parameters against their bf16 plain versions on the card, at the shapes
    of the NW-UCLA eval forward (K1, batch 64) and train step (K2, K3, batch
    16) and at TILED_EXTRA (a ragged V=37 and the joint-tiled design's
    edges), where K1 and K2 take their joint-tiled designs. Each launch must
    count on the bf16 counter of the design the shape takes and on no other.
    bf16 outputs within BF16_TOL of their max |value| and equal in all but
    BF16_SHARE of their elements; K3's f32 outputs as in phase 3; two
    launches of K3, and of the joint-tiled K1 and K2, bitwise equal. Times each by CUDA
    events and by a CUDA graph (device), beside the bound with 2-byte
    activations. Returns {'K1_bf16': rows, 'K2_bf16': rows, 'K3_bf16': rows}."""
    import torch

    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.utils.timing import graph_ms

    plan = [("K1_bf16", k1, k1_plain, k1_bound, K1_MAIN_PATH),
            ("K2_bf16", k2, k2_plain, k2_bound, BWD_MAIN_PATH),
            ("K3_bf16", k3, k3_plain, k3_bound, BWD_MAIN_PATH)]
    out = {}
    for kname, fn, plain, bound_fn, main_path in plan:
        rows = []
        shapes = [(n, s, c) for n, s, c in main_path] + [(n, s, 0) for n, s in TILED_EXTRA]
        for i, (name, shape, count) in enumerate(shapes):
            args = bf16_inputs(shape, seed=300 + i, device=device)
            N, T, V, C, R = shape
            design = "whole"
            if kname != "K3_bf16":
                design = (ctr_gc.fwd_variant if kname == "K1_bf16" else ctr_gc.dx3_variant)(
                    3, V, R)
            counter = kname.replace("_bf16", "t_bf16") if design == "tiled" else kname
            with torch.no_grad():
                reset_launches()
                got = fn(*args)
                launched = {k: v for k, v in read_launches().items() if v}
                if launched != {counter: 1}:
                    raise AssertionError(f"{kname} {name} {shape}: launches {launched}, "
                                         f"expected {counter} once")
                want = plain(*args)
                torch.cuda.synchronize()
                if kname == "K3_bf16":
                    again = fn(*args)
                    torch.cuda.synchronize()
                    for part, a, b in zip(K3_OUTPUTS, got, again):
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"K3_bf16 {name} {shape}: two launches differ in {part}")
                    errs = [(part,) + (bf16_within(a, b) if part in ("dx1s", "dx2s") else
                                       _within(a, b, *((1e-3, 0.0) if part == "dalpha"
                                                       else (1e-4, 1e-4))))
                            for part, a, b in zip(K3_OUTPUTS, got, want)]
                else:
                    if design == "tiled":
                        again = fn(*args)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{kname} {name} {shape} (tiled): two "
                                                 "launches differ")
                    errs = [("out",) + bf16_within(got, want)]
                for part, ok, max_err, scale in errs:
                    if not ok:
                        raise AssertionError(
                            f"{kname} {name} {shape} {part}: max |kernel - plain| "
                            f"{max_err:.3e} (max|plain| {scale:.3e}) beyond the "
                            "stated tolerance")
                ms = cuda_ms(lambda: fn(*args))
                plain_ms = cuda_ms(lambda: plain(*args))
                device_ms = graph_ms(lambda: fn(*args))
            bound_ms, bound_by = bound_fn(shape, act_bytes=2)
            check_above_bound(f"{kname} {name}", device_ms, bound_ms)
            worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
            rows.append(dict(name=name, shape=dict(zip("NTVCR", shape)), design=design,
                             launches_per_step=count, max_abs_err=worst[2],
                             max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                             plain_ms=plain_ms, device_ms=device_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"{kname:7s} {name:11s} N,T,V,C,R={shape} ({design}): max_abs_err "
                  f"{worst[2]:.3e} in {worst[0]} (max|plain| {worst[3]:.3e}) kernel "
                  f"{ms * 1e3:.1f} us, device {device_ms * 1e3:.1f} us, plain "
                  f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by})",
                  flush=True)
        out[kname] = rows
    return out


def check_bf16_logits(work_dir: str, weights: str, device):
    """Logits of the first batch of a bf16 test run's score pickle against
    the same bf16 model on the card with the plain bf16 unit op: within
    BF16_LOGIT_TOL of max |logit| (the kernels and the plain versions differ
    in f32 sum order, which flips a bf16 rounding at a near-tie, and ten
    blocks of bf16 carry such flips on). Returns the max relative error."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    feeder = SyntheticSkeletonFeeder(num_samples=N_SAMPLES, split="val", seed=SEED)
    got = np.stack([scores[feeder.sample_name[i]] for i in range(BATCH)])
    x = np.stack([feeder[i][0] for i in range(BATCH)])
    model = get_model("ctrgcn", **nucla_model_args(), dtype="bfloat16")
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    with torch.inference_mode(), plain_unit_op():
        want = model(torch.from_numpy(x).to(device))
    if want.dtype != torch.float32 or got.shape != (BATCH, 10) or not np.isfinite(got).all():
        raise AssertionError(f"bad bf16 logits: shape {got.shape}, dtype {want.dtype}")
    want = want.cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if rel > BF16_LOGIT_TOL:
        raise AssertionError(
            f"bf16 logits differ from the card's plain bf16 unit op: max|d|/max|plain| "
            f"{rel:.3e} > {BF16_LOGIT_TOL}")
    return rel


# the planted faults of check_trajectory_bf16: each of K3's outputs, and K2's;
# with the switch on, each of K6's
BF16_FAULTS = [("unit_ctr_gc_bwd_param", K3_OUTPUTS, part) for part in K3_OUTPUTS] + [
    ("unit_ctr_gc_bwd_dx3", ("dx3s",), "dx3s")]
BF16_FUSED_FAULTS = [("unit_ctr_gc_bwd_conv3", K6_OUTPUTS, part) for part in K6_OUTPUTS]


def bf16_trajectory_ratios(run, plain, f32):
    """{what: |run - plain| / its limit} of check_trajectory_bf16, after the
    first step: the loss, within BF16_TRAJ_TIMES x |f32 - plain| +
    TRAJ_LOSS_FLOOR x |loss|; each tensor but the alphas and the biases that
    feed a train-mode BatchNorm (BN_FED_BIASES), within BF16_TRAJ_TIMES x
    max |f32 - plain| + TRAJ_TENSOR_FLOOR x the tensor's own change; the
    alphas as one vector, within |f32 - plain| (L2). The losses of the later
    steps only have to be finite."""
    import torch

    got, want, w32 = run[0][0], plain[0][0], f32[0][0]
    lim = BF16_TRAJ_TIMES * abs(w32 - want) + TRAJ_LOSS_FLOOR * abs(want)
    out = {"loss of step 1": abs(got - want) / lim if math.isfinite(got) else math.inf}
    for i, loss in enumerate(run[0][1:], start=2):
        if not math.isfinite(loss):
            out[f"loss of step {i}"] = math.inf
    start, got, want, w32 = plain[1][0], run[1][1], plain[1][1], f32[1][1]
    alphas = [k for k in want if k.endswith("gcn1.alpha")]
    for k in want:
        if k in alphas or k.endswith(BN_FED_BIASES):
            continue
        err = (got[k] - want[k]).abs().max().item()
        lim = (BF16_TRAJ_TIMES * (w32[k] - want[k]).abs().max().item()
               + TRAJ_TENSOR_FLOOR * (want[k] - start[k]).abs().max().item())
        out[f"{k} after step 1"] = (math.inf if not torch.isfinite(got[k]).all()
                                    else 0.0 if err == 0 else err / lim if lim else math.inf)

    def vec(state):
        return torch.cat([state[k] for k in alphas])

    out["the alphas after step 1"] = ((vec(got) - vec(want)).norm()
                                      / (vec(w32) - vec(want)).norm()).item()
    return out


def trajectory_spread(runs, ref):
    """Per step, for each run of `runs` ({name: trajectory}) against `ref`:
    |loss - ref's| and the median over the tensors of max |tensor - ref's|
    / the tensor's own change over `ref` (tensors that do not change left
    out). Returns {name: [(loss distance, median), ...]}."""
    out = {}
    for name, run in runs.items():
        rows = []
        for i in range(1, len(ref[1])):
            start, want, got = ref[1][0], ref[1][i], run[1][i]
            rel = sorted((got[k] - want[k]).abs().max().item() / change
                         for k in want
                         if (change := (want[k] - start[k]).abs().max().item()) > 0)
            rows.append((abs(run[0][i - 1] - ref[0][i - 1]), rel[len(rel) // 2]))
        out[name] = rows
    return out


def check_trajectory_bf16(weights: str, device, fused: bool = False, references=None):
    """TRAJ_STEPS SGD steps in bf16 (model_args.dtype) from the same weights
    on the same batches: on the card with K1-K3's bf16 forms (with `fused`,
    TAMGCN_FUSE_CONV3=1: K6-bf16 at the six blocks with C >= 128); twice with the
    plain bf16 unit op on the card; and on the card in f32 with the f32
    kernels (phase 5 holds those to the CPU). The kernels and the plain
    versions differ only in f32 sum order before a rounding, bf16 and f32 in
    every rounding, so after the first step the kernels' run is held to the
    plain bf16 run within BF16_TRAJ_TIMES x the f32 run's distance from it
    (bf16_trajectory_ratios). Past the first step nothing is held but that
    the losses are finite: the two runs of the plain bf16 unit op, the same
    code, differ there by a share of each tensor's own change that grows
    step by step (cuDNN's backward sums are not in a fixed order, and a
    flipped bf16 rounding grows through ten train-mode BatchNorms), as the
    kernels' run differs from the plain one; the printed spread per step
    shows it. The biases that feed a train-mode BatchNorm have a zero
    gradient in exact arithmetic, so theirs is rounding noise and they are
    not held; the alphas' gradients (each one sum of every term) are held as
    one vector. The same check with each output of K3's bf16 form, and K2's
    dx3 (with `fused`: each of K6-bf16's outputs), zeroed in turn must fail.
    `references` (what an earlier call returned) skips the f32 and plain
    runs: the plain unit op computes the model's math whichever conv3 path
    the card takes. Returns (worst ratio, its name, the spread per step,
    the references)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    if references is None:
        batches = train_batches(TRAJ_STEPS, TRAIN_BATCH)
        f32 = trajectory(weights, batches, device, torch.float32)
        with plain_unit_op():
            plain = trajectory(weights, batches, device, torch.float32, "bfloat16")
            plain_again = trajectory(weights, batches, device, torch.float32, "bfloat16")
        references = batches, f32, plain, plain_again
    batches, f32, plain, plain_again = references
    reset_launches()
    with fuse_conv3(fused):
        card = trajectory(weights, batches, device, torch.float32, "bfloat16")
    launches = read_launches()
    per_step = dict(K1_bf16=10, K2_bf16=10, K3_bf16=10)
    if fused:
        per_step.update(K2_bf16=4, K6_bf16=6)
    want = graphed("bf16 trajectory", {"train": (TRAJ_STEPS, per_step)})
    if launches != want:
        raise AssertionError(f"bf16 trajectory: launches {launches}, expected {want}")
    spread = trajectory_spread({"kernels": card, "plain bf16 again": plain_again,
                                "f32": f32}, plain)
    print("bf16 trajectory, distance from the plain bf16 unit op's run per step "
          "(|loss difference|, median over tensors of max|difference| / the tensor's "
          "change): " + "; ".join(
              f"{name} " + ", ".join(f"step {i} {d:.4g} {m:.3g}"
                                     for i, (d, m) in enumerate(rows, start=1))
              for name, rows in spread.items()), flush=True)
    ratios = bf16_trajectory_ratios(card, plain, f32)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])
    print(f"bf16 trajectory{' with TAMGCN_FUSE_CONV3=1' if fused else ''}, {TRAJ_STEPS} "
          f"SGD steps at batch {TRAIN_BATCH}: losses card "
          f"bf16 {card[0]}, card plain bf16 unit op {plain[0]} and {plain_again[0]}, card "
          f"f32 {f32[0]}; tolerance after step 1: |kernels - plain bf16| <= "
          f"{BF16_TRAJ_TIMES} x |f32 - plain bf16| + {TRAJ_LOSS_FLOOR} x |loss| (the loss), "
          f"+ {TRAJ_TENSOR_FLOOR} x the tensor's own change (each tensor), the alphas as "
          f"one vector within |f32 - plain bf16|; later losses finite; worst of "
          f"{len(ratios)}: " + ", ".join(f"{k} {v:.3f}" for k, v in worst[:5])
          + f"; median {sorted(ratios.values())[len(ratios) // 2]:.3f} of its limit",
          flush=True)
    if worst[0][1] > 1:
        raise AssertionError("the card's bf16 trajectory left the plain bf16 run's")
    for wrapper, outputs, part in BF16_FUSED_FAULTS if fused else BF16_FAULTS:
        real = getattr(ctr_gc, wrapper)

        def faulty(*args, real=real, outputs=outputs, part=part):
            result = real(*args)
            if isinstance(result, torch.Tensor):
                return result.zero_()
            return tuple(t.zero_() if name == part else t for name, t in zip(outputs, result))

        with mock.patch.object(ctr_gc, wrapper, faulty), fuse_conv3(fused):
            f_ratios = bf16_trajectory_ratios(
                trajectory(weights, batches, device, torch.float32, "bfloat16"), plain, f32)
        beyond = sorted((k for k, v in f_ratios.items() if v > 1), key=lambda k: -f_ratios[k])
        print(f"planted fault, the bf16 {wrapper}'s {part} zeroed: {len(beyond)} of "
              f"{len(f_ratios)} beyond their limit, worst "
              + ", ".join(f"{k} {f_ratios[k]:.3f}" for k in beyond[:5]), flush=True)
        if not beyond:
            raise AssertionError(
                f"the bf16 trajectory check passed with {wrapper}'s {part} zeroed")
    return worst[0][1], worst[0][0], spread, references


def time_bf16(weights: str, x, device):
    """The bf16 model's steady-state eval forward at batch 64 and train step
    at batch 16 and 64: CUDA events, and device time by kernel name.
    Returns {what: (ms, busy_ms, n_kernels, events)}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    out = {}
    model = get_model("ctrgcn", **nucla_model_args(), dtype="bfloat16")
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(xb))
        out[f"eval forward, batch {BATCH}"] = (ms,) + profile_device(lambda: model(xb))
    for batch in (TRAIN_BATCH, 64):
        _, _, eager = train_model(weights, device, compute="bfloat16", capture=False)
        (xt, yt), = train_batches(1, batch)
        xt, yt = torch.from_numpy(xt).to(device), torch.from_numpy(yt).to(device)

        def step():
            eager(xt, yt)

        ms = cuda_ms(step, iters=10)
        out[f"train step, batch {batch}"] = (ms,) + profile_device(step)
    return out


def run_convergence_tool():
    """tamgcn_tpu_torch/tools/bf16_convergence.py in-process at a small size
    (2 epochs of 64 samples in batches of 16, full width): each run finite,
    the f32 run through the f32 kernels only and the bf16 run through the
    bf16 forms only, 10 launches per train step (K1 also per eval batch),
    each run's steps through one train and one eval CUDA graph.
    Returns the tool's record."""
    import io

    from tamgcn_tpu_torch.tools import bf16_convergence

    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        bf16_convergence.main(["--epochs", "2", "--samples", "64", "--batch", "16"])
    from tamgcn_tpu_torch.train.graphs import WARMUP

    launched = read_launches()
    graphs = read_graphs()
    record = json.loads(buf.getvalue().strip().splitlines()[-1])
    steps, evals, epochs = 64 // 16, 64 // 16, 2
    # each run captures one train and one eval graph, each after WARMUP calls
    want_graphs = {"train": (2, 2 * WARMUP, 2 * epochs * steps),
                   "eval": (2, 2 * WARMUP, 2 * epochs * evals)}
    if {k: v[:3] for k, v in graphs.items()} != want_graphs:
        raise AssertionError(f"bf16_convergence: CUDA graphs {graphs}")
    per_run = dict(K1=10 * (epochs * (steps + evals) + 2 * WARMUP),
                   K2=10 * (epochs * steps + WARMUP), K3=10 * (epochs * steps + WARMUP))
    want = only(**per_run, **{f"{k}_bf16": n for k, n in per_run.items()})
    if launched != want:
        raise AssertionError(f"bf16_convergence: launches {launched}, expected {want}")
    for run, suffix in (("f32", ""), ("bf16", "_bf16")):
        want = dict.fromkeys(bf16_convergence.COUNTERS, 0) | {
            "launches" + suffix: per_run["K1"],
            "bwd_dx3_launches" + suffix: per_run["K2"],
            "bwd_param_launches" + suffix: per_run["K3"]}
        if record[run]["launches"] != want:
            raise AssertionError(f"bf16_convergence, {run} run: launches "
                                 f"{record[run]['launches']}, expected {want}")
        if not all(math.isfinite(v) for v in record[run]["train_loss"] + record[run]["test_loss"]):
            raise AssertionError(f"bf16_convergence, {run} run: losses not finite")
    print(f"bf16_convergence (2 epochs, 64 samples, batch 16): train loss f32 "
          f"{record['f32']['train_loss']}, bf16 {record['bf16']['train_loss']}; best top-1 "
          f"f32 {record['f32']['best_top1']}, bf16 {record['bf16']['best_top1']}; launches "
          f"f32 {record['f32']['launches']}, bf16 {record['bf16']['launches']}", flush=True)
    return record


def run_bf16(work_dir: str, weights: str, x, device):
    """Phase 10: bf16 mixed precision (configs/nucla/gcn_bf16.yaml's
    model_args.dtype) on the NW-UCLA model at full width through K1-K3's bf16
    forms: the kernel checks, `--phase test` (also with `--fast_eval true`)
    and one epoch of `--phase train` through __main__.main with
    `--model_args dtype=bfloat16` (launch
    checks, the logits against the card's plain bf16 unit op, the files,
    f32 checkpoints), the bf16 trajectory check with its planted faults, the
    timings, and the convergence tool at a small size. Returns a summary."""
    import numpy as np
    import torch

    out = {"kernels": check_kernels_bf16(device)}
    batches = math.ceil(N_SAMPLES / BATCH)
    test_dir = os.path.join(work_dir, "test_bf16")
    seconds, launches = run_test_path(test_dir, weights, "--model_args", "dtype=bfloat16")
    if launches != graphed("bf16 --phase test", {"eval": (batches, dict(K1_bf16=10))}):
        raise AssertionError(f"the bf16 test phase launched {launches}, expected the bf16 "
                             f"K1 10 x {batches} batches and warm-up calls and no other kernel")
    rel = check_bf16_logits(test_dir, weights, device)
    out["test"] = dict(seconds=seconds, launches=launches, logit_rel_err=rel)
    print(f"bf16 test path: {batches} batches of {BATCH} in {seconds:.2f} s, launches "
          f"{launches}, logits vs the card's plain bf16 unit op max rel err {rel:.3e} "
          f"(bound {BF16_LOGIT_TOL})", flush=True)

    # --fast_eval on a bf16 model at V=20 is the model's own bf16 forward, as
    # the JAX package's `auto` policy (models/ctrgcn_infer.py)
    fast_dir = os.path.join(work_dir, "fast_eval_bf16")
    seconds, launches = run_test_path(fast_dir, weights, "--fast_eval", "true",
                                      "--model_args", "dtype=bfloat16")
    if launches != graphed("bf16 --phase test --fast_eval true",
                           {"fast_eval": (batches, dict(K1_bf16=10))}):
        raise AssertionError(f"the bf16 fast-eval test phase launched {launches}, expected "
                             f"the bf16 K1 10 x {batches} batches and warm-up calls and no other "
                             "kernel")
    scores = []
    for d in (test_dir, fast_dir):
        with open(os.path.join(d, "test_result.pkl"), "rb") as f:
            scores.append(pickle.load(f))
    if scores[0].keys() != scores[1].keys() or any(
            not np.array_equal(scores[0][k], scores[1][k]) for k in scores[0]):
        raise AssertionError("the bf16 fast-eval scores differ from the bf16 test phase's")
    print(f"bf16 fast-eval test path: {seconds:.2f} s, launches {launches}, scores equal "
          "to the bf16 test phase's", flush=True)

    steps, evals = TRAIN_SAMPLES // TRAIN_BATCH, math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    train_dir = os.path.join(work_dir, "train_bf16")
    seconds, launches = run_cli(train_argv(train_dir) + [
        "--num_epoch", "1", "--model_args", "dtype=bfloat16"])
    want = graphed("bf16 --phase train", {
        "train": (steps, dict(K1_bf16=10, K2_bf16=10, K3_bf16=10)),
        "eval": (evals, dict(K1_bf16=10))})
    if launches != want:
        raise AssertionError(f"the bf16 train phase launched {launches}, expected {want}")
    progress = check_train_files(train_dir, 1, 1, "bf16")
    tree = torch.load(os.path.join(train_dir, "checkpoints", "epoch1.pt"), weights_only=True)
    if any(v.is_floating_point() and v.dtype != torch.float32 for v in tree["model"].values()):
        raise AssertionError("a bf16 run's checkpoint holds tensors that are not float32")
    out["train"] = dict(seconds=seconds, launches=launches, progress=progress.tolist())
    print(f"bf16 train path: 1 epoch of {steps} steps at batch {TRAIN_BATCH} in "
          f"{seconds:.2f} s, launches {launches}; progress {progress.tolist()}; "
          "checkpoint tensors float32", flush=True)

    out["trajectory"] = check_trajectory_bf16(weights, device)
    out["times"] = time_bf16(weights, x, device)
    out["convergence"] = run_convergence_tool()
    return out


def k6_bf16_bound(shape):
    """K6-bf16's bound (utils/roofline.py: its stage 1 and products at the
    bf16 peak, its aggregation as two TF32 terms, 2-byte activations)."""
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_bwd_conv3_bf16_sol

    return unit_ctr_gc_bwd_conv3_bf16_sol(*shape)


def check_k6_bf16(device):
    """Phase 11's K6 checks: K6's bf16 form (bf16 x1s, x2s, g, x, w3; f32
    parameters) against its bf16 plain version at K6_MAIN_PATH (l5-l10 at
    batch 16) and K6_EXTRA (V=25, a ragged shape with odd T and Cin not a
    multiple of 8, the two-phase design's edges): dx, dw3 and db3 within
    BF16_TOL of their max |plain| and equal in all but BF16_SHARE of the
    elements, two launches bitwise equal, each launch on the bf16 counter
    alone; times it, its plain version and the unfused composition it
    replaces (K2-bf16, two bf16 torch.matmul products and a sum), by events
    and by a CUDA graph. Returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_bwd_conv3_plain as plain
    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.utils.timing import graph_ms

    k6 = ctr_gc.unit_ctr_gc_bwd_conv3

    def unfused(x1s, x2s, g, x, w3, w4s, b4s, alpha, As):
        dx3s = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        flat = dx3s.reshape(-1, dx3s.shape[-1])
        return (torch.matmul(dx3s, w3.t()),
                torch.matmul(x.reshape(-1, x.shape[-1]).t(), flat), flat.sum(dim=0))

    rows = []
    shapes = [(n, s, c) for n, s, c in K6_MAIN_PATH] + [(n, s, 0) for n, s in K6_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        x1s, x2s, g, x, w3, w4s, b4s, alpha, As = conv3_inputs(shape, seed=700 + i,
                                                               device=device)
        args = [t.bfloat16() for t in (x1s, x2s, g, x, w3)] + [w4s, b4s, alpha, As]
        with torch.no_grad():
            reset_launches()
            got = k6(*args)
            launched = {k: v for k, v in read_launches().items() if v}
            if launched != {"K6_bf16": 1}:
                raise AssertionError(f"K6_bf16 {name} {shape}: launches {launched}, "
                                     "expected K6_bf16 once")
            again = k6(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            for part, a, b in zip(K6_OUTPUTS, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K6_bf16 {name} {shape}: two launches differ in "
                                         f"{part}")
            errs = [(part,) + bf16_within(a, b) for part, a, b in zip(K6_OUTPUTS, got, want)]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"K6_bf16 {name} {shape} {part}: max |kernel - plain| {max_err:.3e} "
                        f"(max|plain| {scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: k6(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            unfused_ms = cuda_ms(lambda: unfused(*args))
            device_ms = graph_ms(lambda: k6(*args))
            unfused_device_ms = graph_ms(lambda: unfused(*args))
        bound_ms, bound_by = k6_bf16_bound(shape)
        check_above_bound(f"K6_bf16 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, unfused_k2_cublas_ms=unfused_ms,
                         device_ms=device_ms,
                         unfused_k2_cublas_device_ms=unfused_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K6_bf16 {name:9s} N,T,V,Cin,C,R={shape}: max_abs_err {worst[2]:.3e} in "
              f"{worst[0]} (max|plain| {worst[3]:.3e}) kernel {ms * 1e3:.1f} us (device "
              f"{device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, unfused "
              f"K2_bf16+cuBLAS {unfused_ms * 1e3:.1f} us (device "
              f"{unfused_device_ms * 1e3:.1f}), bound {bound_ms * 1e3:.1f} us ({bound_by})",
              flush=True)
    return rows


def run_fused_bf16_train_path(work_dir: str):
    """One epoch of --phase train with --model_args dtype=bfloat16 and
    TAMGCN_FUSE_CONV3=1 (set around the call, restored after) through
    __main__.main: K6-bf16 at the six blocks with C >= 128, K2-bf16 at the
    other four; checks the launches (no f32 unit-op kernel, no f32 K6), the
    losses and an f32 checkpoint. Returns a summary dict."""
    import torch

    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    with fuse_conv3():
        seconds, launches = run_cli(train_argv(work_dir) + [
            "--num_epoch", "1", "--model_args", "dtype=bfloat16"])
    want = graphed("bf16 --phase train with TAMGCN_FUSE_CONV3=1", {
        "train": (steps, dict(K1_bf16=10, K2_bf16=4, K3_bf16=10, K6_bf16=6)),
        "eval": (evals, dict(K1_bf16=10))})
    if launches != want:
        raise AssertionError(
            f"--phase train, bf16, TAMGCN_FUSE_CONV3=1: launches {launches}, expected "
            f"{want} (per train step of {steps} K1_bf16 10, K2_bf16 4, K6_bf16 6, K3_bf16 "
            f"10; K1_bf16 also 10 per eval batch of {evals})")
    progress = check_train_files(work_dir, 1, 1, "bf16, fused conv3")
    tree = torch.load(os.path.join(work_dir, "checkpoints", "epoch1.pt"), weights_only=True)
    if any(v.is_floating_point() and v.dtype != torch.float32 for v in tree["model"].values()):
        raise AssertionError("a bf16 run's checkpoint holds tensors that are not float32")
    print(f"bf16 train path (TAMGCN_FUSE_CONV3=1): 1 epoch of {steps} steps at batch "
          f"{TRAIN_BATCH} in {seconds:.2f} s (incl. model build, data and eval), launches "
          f"{launches}; progress (train loss, test loss, top1, top5) {progress.tolist()}; "
          "checkpoint tensors float32", flush=True)
    return dict(seconds=seconds, launches=launches, progress=progress.tolist())


def check_ctrgc_bf16(device):
    """CTRGC(dtype="bfloat16") forward and backward on the card through
    K4's bf16 form against the same module with K4-bf16's plain versions,
    at CTRGC_SHAPES (whole-V at V=20, joint-tiled at V=25), each launch on
    the counter of its direction and of the design the shape takes: the f32
    output within 1e-4 * max; the gradients behind the kernel's x3 gradient
    (x, conv3) within BF16_TOL * max (one bf16 rounding of dx3 may flip at a
    near-tie); the rest, plain PyTorch on the same operands in both, within
    rtol 1e-4 and atol 1e-4 * max (alpha's within rtol 1e-3). Then K4-bf16's
    work on the module's operands (the forward and the transpose) against
    its plain versions, within 1e-4 * max, timed by events and by a CUDA
    graph. Returns (rows, launches of the first module's forward and
    backward)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.models import CTRGC
    from tamgcn_tpu_torch.ops import aggregation as agg
    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.utils.roofline import ctr_gc_fused_bf16_sol
    from tamgcn_tpu_torch.utils.timing import graph_ms

    def check(what, got, want, rtol, atol_frac):
        ok, max_err, scale = _within(got, want, rtol, atol_frac)
        if not ok:
            raise AssertionError(f"CTRGC bf16 {what}: max |kernel - plain| {max_err:.3e} "
                                 f"(max|plain| {scale:.3e}) beyond the stated tolerance")
        return max_err, scale

    rows, main_launches = [], None
    for i, (name, (N, T, V, Cin, C)) in enumerate(CTRGC_SHAPES):
        gen = torch.Generator().manual_seed(800 + i)
        module = CTRGC(Cin, C, generator=gen, dtype="bfloat16")
        with torch.no_grad():
            module.conv4_bias.normal_(0.0, 0.1, generator=gen)
        module.to(device)
        x = torch.randn((N, T, V, Cin), generator=gen).to(device)
        A = torch.rand((V, V), generator=gen).to(device)
        alpha = torch.tensor([0.7], device=device)
        g = torch.randn((N, T, V, C), generator=gen).to(device)

        def run():
            leaves = [t.detach().clone().requires_grad_() for t in (x, A, alpha)]
            module.zero_grad(set_to_none=True)
            out = module(*leaves)
            out.backward(g)
            grads = {k: p.grad for k, p in module.named_parameters()}
            grads.update(zip(("x", "A", "alpha"), (t.grad for t in leaves)))
            return out.detach(), grads

        reset_launches()
        out, grads = run()
        torch.cuda.synchronize()
        launches = read_launches()
        R = module.conv4_kernel.shape[2]
        design = "t" if ctr_gc.fwd_variant(1, V, R) == "tiled" else ""
        if launches != only(**{f"K4{design}_bf16": 1, f"K4dx3{design}_bf16": 1}):
            raise AssertionError(f"CTRGC bf16 {name}: launches {launches}, expected "
                                 f"K4{design}_bf16 and K4dx3{design}_bf16 once each")
        if main_launches is None:
            main_launches = sum(launches.values())
        if out.dtype != torch.float32:
            raise AssertionError(f"CTRGC bf16 {name}: output {out.dtype}, not float32")
        with mock.patch.object(agg, "_fused_kernels", lambda device, bf16: (
                agg.ctr_gc_fused_plain, agg.ctr_gc_fused_dx3_plain)):
            want_out, want = run()
        check(f"{name} out", out, want_out, 0.0, 1e-4)
        for k, w in want.items():
            check(f"{name} d{k}", grads[k], w,
                  *((0.0, BF16_TOL) if k in ("x", "conv3.weight", "conv3.bias") else
                    (1e-3, 0.0) if k == "alpha" else (1e-4, 1e-4)))
        # K4-bf16's work: the forward and the transpose on the module's operands
        with torch.no_grad():
            x1, x2 = module.conv1(x).mean(dim=1), module.conv2(x).mean(dim=1)
            x3, w4, b4 = module.conv3(x), module.conv4_kernel[0, 0], module.conv4_bias

            def k4():
                return (ctr_gc.ctr_gc_fused_bf16(x1, x2, x3, w4, b4, alpha, A),
                        ctr_gc.ctr_gc_fused_t_bf16(x1, x2, g, w4, b4, alpha, A))

            def k4_plain():
                return (agg.ctr_gc_fused_plain(x1, x2, x3, w4, b4, alpha, A),
                        agg.ctr_gc_fused_dx3_plain(x1, x2, g, w4, b4, alpha, A))

            first, again = k4(), k4()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"K4_bf16 {name}: two launches differ")
            errs = [(part,) + check(f"{name} K4_bf16 {part}", a, b, 0.0, 1e-4)
                    for part, a, b in zip(("out", "dx3"), first, k4_plain())]
            ms = cuda_ms(k4)
            plain_ms = cuda_ms(k4_plain)
            device_ms = graph_ms(k4)
        route_ms = cuda_ms(run)
        bound_ms, bound_by = ctr_gc_fused_bf16_sol(N, T, V, C, R)
        check_above_bound(f"K4_bf16 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[1] / max(e[2], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C"),
                                                   (N, T, V, Cin, C))),
                         launches_per_step=int(i == 0), max_abs_err=worst[1],
                         max_abs_plain=worst[2], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, device_ms=device_ms, module_fwd_bwd_ms=route_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K4_bf16 (CTRGC bf16) {name:9s} N,T,V,Cin,C={(N, T, V, Cin, C)}: module "
              f"forward and backward {route_ms:.3f} ms, launches "
              f"{ {k: v for k, v in launches.items() if v} }; K4_bf16's work (forward + "
              f"transpose) {ms * 1e3:.1f} us (device {device_ms * 1e3:.1f}), plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}), "
              f"max_abs_err {worst[1]:.3e} in {worst[0]} (max|plain| {worst[2]:.3e})",
              flush=True)
    return rows, main_launches


def run_bf16_fused(work_dir: str, weights: str, device, references):
    """Phase 11: K6's bf16 form (bf16 training with TAMGCN_FUSE_CONV3=1) and
    K4's (CTRGC(dtype="bfloat16")): the K6-bf16 checks, one bf16 train
    epoch with the switch through __main__.main, check_trajectory_bf16 with
    the switch on (its planted faults zero each of K6-bf16's outputs; the
    references are phase 10's), the bf16 train step with the switch timed
    beside the bf16 default step, and the bf16 CTRGC checks. Returns a
    summary."""
    out = {"k6_rows": check_k6_bf16(device)}
    print("library_ms: none for K6_bf16 (no single PyTorch call computes it); the "
          "unfused composition's time is under unfused_k2_cublas_ms", flush=True)
    out["train"] = run_fused_bf16_train_path(os.path.join(work_dir, "train_bf16_fused"))
    out["trajectory"] = check_trajectory_bf16(weights, device, fused=True,
                                              references=references)
    out["times"] = time_train_fused(weights, device, compute="bfloat16")
    out["k4_rows"], out["k4_launches"] = check_ctrgc_bf16(device)
    print("library_ms: none for K4_bf16 (no single PyTorch call computes it)", flush=True)
    return out


# phase 12: the CUDA runtime calls that launch work on the card, counted per
# call by torch.profiler (one graph replay is one cudaGraphLaunch)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# the cases phase 12 holds the graphed train step to the eager one in:
# (label, the model's compute dtype, TAMGCN_FUSE_CONV3)
EQUAL_CASES = (("f32", None, False), ("bf16", "bfloat16", False),
               ("f32, TAMGCN_FUSE_CONV3=1", None, True))


def host_launches(fn, reps: int = 1) -> tuple:
    """(launches, {runtime call: count}) per call of fn (warmed up, so no
    capture falls in the trace): the `cuda*` and `cu*` launch calls of
    LAUNCH_CALLS that torch.profiler records on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    calls = {e.key: e.count / reps for e in prof.key_averages() if e.key in LAUNCH_CALLS}
    if not calls:
        raise AssertionError("torch.profiler recorded no launch call on the host")
    return sum(calls.values()), calls


@contextlib.contextmanager
def deterministic_cudnn():
    """torch.backends.cudnn.deterministic on, restored after."""
    import torch

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def packed_run(weights: str, batches, device, compute, capture: bool):
    """TRAJ_STEPS train steps from `weights` on `batches` through the fused
    step, eager or as CUDA graphs: ([loss tensor of each step], {flat
    buffer: tensor} of the state after the last: parameters, momentum,
    BatchNorm statistics)."""
    import torch

    _, state, step = train_model(weights, device, compute=compute, capture=capture)
    losses = [step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))[0]
              for x, y in batches]
    flats = {"parameters": state.params.flats, "momentum":
             state.optimizer.state["momentum_buffer"], "statistics": state.stats.flats}
    return losses, {k: torch.cat([f.reshape(-1) for f in v]) for k, v in flats.items()}


def differences(a, b) -> dict:
    """{what: max |a - b|} over the losses of each step and each flat buffer;
    an empty dict where a and b are equal bit for bit."""
    out = {f"loss of step {i}": abs(float(u) - float(v))
           for i, (u, v) in enumerate(zip(a[0], b[0])) if not bool((u == v).all())}
    out.update({k: float((a[1][k].double() - b[1][k].double()).abs().max())
                for k in a[1] if not a[1][k].equal(b[1][k])})
    return out


def check_graphed_equals_eager(weights: str, x, device):
    """The graphed train step against the eager one over TRAJ_STEPS steps at
    batch 16, f32, bf16 and with TAMGCN_FUSE_CONV3=1: the loss of every step,
    every parameter, the momentum and the BatchNorm statistics bit for bit
    with cuDNN's deterministic algorithms; with cuDNN's default algorithm
    choice two eager runs already differ (its convolution backward sums in no
    fixed order), so there the f32 distances are printed and the graphed
    step is held to the check_trajectory limits (phases 5, 7, 10 and 11 run
    those checks on the graphed step). Then the graphed eval and fast-eval forward
    at batch 64 against their eager forms, bit for bit (no backward, no
    nondeterminism). Returns {case: distances}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_eval_step, make_fast_eval_step
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.graphs import GraphedStep

    batches = train_batches(TRAJ_STEPS, TRAIN_BATCH)
    out = {}
    for label, compute, fused in EQUAL_CASES:
        with fuse_conv3(fused):
            with deterministic_cudnn():
                eager = packed_run(weights, batches, device, compute, False)
                graphed_ = packed_run(weights, batches, device, compute, True)
            # the default algorithms once, in f32: what names the op
            default = ([packed_run(weights, batches, device, compute, capture)
                        for capture in (False, False, True)] if label == "f32" else None)
        bitwise = differences(graphed_, eager)
        out[label] = dict(deterministic=bitwise)
        line = (f"compiled steps, {label} train step, batch {TRAIN_BATCH}, {TRAJ_STEPS} "
                f"steps: graphed vs eager with deterministic cuDNN: "
                f"{'equal bit for bit' if not bitwise else bitwise}")
        if default:
            out[label].update(eager_vs_eager=differences(default[1], default[0]),
                              graphed_vs_eager=differences(default[2], default[0]))
            line += (f"; with cuDNN's default algorithms, eager vs eager "
                     f"{out[label]['eager_vs_eager'] or 'equal'}, graphed vs eager "
                     f"{out[label]['graphed_vs_eager'] or 'equal'}")
        print(line, flush=True)
        if bitwise:
            raise AssertionError(f"the graphed {label} train step differs from the eager one "
                                 f"with deterministic cuDNN: {bitwise}")

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    yb = torch.arange(len(x), device=device) % 10

    with torch.inference_mode():
        for name, fn in (("eval", make_eval_step(model)),
                         ("fast_eval", make_fast_eval_step(model))):
            want = fn(xb, yb)
            got = GraphedStep(fn, name)(xb, yb)
            if not (got[0].equal(want[0]) and got[1].equal(want[1])):
                raise AssertionError(
                    f"the graphed {name} step differs from the eager one: max |d logits| "
                    f"{float((got[1] - want[1]).abs().max())}")
            print(f"compiled steps, {name} forward, batch {len(x)}: graphed logits and loss "
                  "equal to the eager ones bit for bit", flush=True)
    return out


def check_graphs_see_new_weights(weights: str, x, device):
    """Eval and fast-eval CUDA graphs captured first, then a graphed train
    step, then the weights file loaded into the model (what --weights and
    --resume do, in place): after each, the graphs' logits equal an eager
    evaluation of the weights the model holds, bit for bit, and they moved."""
    import torch

    from tamgcn_tpu_torch.models.ctrgcn_infer import (make_eval_step, make_fast_eval,
                                                      make_fast_eval_step)
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.graphs import GraphedStep

    model, state, train = train_model(weights, device)
    xb = torch.from_numpy(x).to(device)
    yb = torch.arange(len(x), device=device) % 10

    graphs = {"eval": GraphedStep(make_eval_step(model), "eval"),
              "fast_eval": GraphedStep(make_fast_eval_step(model), "fast_eval")}
    eager = {"eval": lambda: model(xb), "fast_eval": lambda: make_fast_eval(model)(xb)}

    def scores(when, before=None):
        model.eval()
        out = {}
        with torch.inference_mode():
            for name, graph in graphs.items():
                got, want = graph(xb, yb)[1], eager[name]()
                if not got.equal(want):
                    raise AssertionError(f"{when}: the {name} graph's logits differ from an "
                                         f"eager evaluation by {float((got - want).abs().max())}")
                if before is not None and got.equal(before[name]):
                    raise AssertionError(f"{when}: the {name} graph's logits did not move")
                out[name] = got
        model.train()
        return out

    first = scores("at capture")
    (xt, yt), = train_batches(1, TRAIN_BATCH)
    train(torch.from_numpy(xt).to(device), torch.from_numpy(yt).to(device))
    trained = scores("after a graphed train step", first)
    model.load_state_dict(load_weights(weights))
    reloaded = scores("after loading the weights file", trained)
    for name in graphs:
        if not reloaded[name].equal(first[name]):
            raise AssertionError(f"the {name} graph on the reloaded weights differs from its "
                                 "first scores")
    print("compiled steps: eval and fast-eval graphs captured before a train step and a "
          "weights load score the weights the model holds after each, bit for bit "
          f"(CUDA graphs {read_graphs_brief()})", flush=True)


def read_graphs_brief() -> str:
    return ", ".join(f"{name}: {c} captured, {r} replays"
                     for name, (c, _, r, _) in read_graphs().items())


def time_compiled(weights: str, scene_weights: str, x, device) -> dict:
    """Each step eager and as CUDA graphs, timed in turns eager, graphed,
    graphed, eager (CUDA events, ms a call): the f32 train step at batch 16
    and 64, the bf16 train step at 16, the eval and fast-eval forward at 64
    and the scene256 train step at 8; for each form the device-busy ms and
    kernels (profile_device, a run of its own under the profiler: where the
    card is never idle it can read a little above the wall time), the idle
    share of the wall time and the host launches (host_launches). Returns
    {path: {form: dict}}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_eval_step, make_fast_eval_step
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.graphs import GraphedStep

    def train_forms(w, batch, compute=None, model_args=None, feeder=None):
        (xt, yt), = (feeder or train_batches)(1, batch)
        xt, yt = torch.from_numpy(xt).to(device), torch.from_numpy(yt).to(device)
        forms = {}
        for form, capture in (("eager", False), ("graphed", True)):
            step = train_model(w, device, compute=compute, capture=capture,
                               model_args=model_args)[2]
            forms[form] = (lambda step=step: step(xt, yt))
        return forms

    def eval_forms():
        model = get_model("ctrgcn", **nucla_model_args())
        model.load_state_dict(load_weights(weights))
        model.to(device).eval()
        xb = torch.from_numpy(x).to(device)
        yb = torch.arange(len(x), device=device) % 10

        out = {}
        for name, fn in (("eval", make_eval_step(model)),
                         ("fast_eval", make_fast_eval_step(model))):
            graph = GraphedStep(fn, name)
            out[name] = {"eager": lambda fn=fn: fn(xb, yb),
                         "graphed": lambda graph=graph: graph(xb, yb)}
        return out

    def scene_batches(n, batch):
        del n
        g = torch.Generator().manual_seed(SEED)
        return [(torch.randn(batch, 3, 32, 256, 1, generator=g).numpy(),
                 (torch.arange(batch) % 10).numpy())]

    evals = eval_forms()
    paths = {
        f"f32 train step, batch {TRAIN_BATCH}": (train_forms(weights, TRAIN_BATCH), False),
        "f32 train step, batch 64": (train_forms(weights, 64), False),
        f"bf16 train step, batch {TRAIN_BATCH}": (
            train_forms(weights, TRAIN_BATCH, "bfloat16"), False),
        f"eval forward, batch {BATCH}": (evals["eval"], True),
        f"fast-eval forward, batch {BATCH}": (evals["fast_eval"], True),
        f"scene256 train step, batch {SCENE_BATCH}": (train_forms(
            scene_weights, SCENE_BATCH, model_args=scene_model_args(),
            feeder=scene_batches), False),
    }
    out = {}
    for path, (forms, inference) in paths.items():
        ctx = torch.inference_mode if inference else contextlib.nullcontext
        with ctx():
            ms = {form: [] for form in forms}
            for form in ("eager", "graphed", "graphed", "eager"):
                ms[form].append(cuda_ms(forms[form], iters=10))
            out[path] = {}
            for form, fn in forms.items():
                busy, n_kernels, events = profile_device(fn, reps=3)
                launches, calls = host_launches(fn)
                wall = min(ms[form])
                out[path][form] = dict(wall_ms=wall, busy_ms=busy,
                                       idle=1 - busy / wall, kernels=n_kernels,
                                       host_launches=launches, calls=calls)
                print(f"compiled steps, {path}, {form}: {wall:.3f} ms a call, device busy "
                      f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle), {n_kernels} "
                      f"kernels on the card, {launches:.0f} host launches {calls}", flush=True)
    print(f"compiled steps, CUDA graphs: {read_graphs_brief()}", flush=True)
    return out


def run_compiled_steps(work_dir: str, weights: str, x, device) -> dict:
    """Phase 12: the trainer's steps as CUDA graphs (train/graphs.py): the
    graphed train step against the eager one (check_graphed_equals_eager),
    graphs that see new weights (check_graphs_see_new_weights) and the eager
    and graphed forms timed (time_compiled). The trajectory checks of phases
    5, 7, 10 and 11, with their planted faults, ran on the graphed step."""
    out = {"equal": check_graphed_equals_eager(weights, x, device)}
    phase("12. compiled steps: new weights")
    check_graphs_see_new_weights(weights, x, device)
    phase("12. compiled steps: times")
    out["times"] = time_compiled(weights, os.path.join(work_dir, "scene256_weights.pt"),
                                 x, device)
    return out


# ---- phase 13: the rest of the NW-UCLA skeleton path ---------------------------

GCN_YAML = os.path.join(REPO, "configs", "nucla", "gcn.yaml")
STGCN_YAML = os.path.join(REPO, "configs", "nucla", "stgcn.yaml")
CLIP_FRAMES = (10, 80)  # each synthetic clip's length T, drawn uniformly
STGCN_MODEL_ARGS = dict(in_channels=3, num_class=10, num_point=20, num_person=1,
                        graph="ucla", graph_args={"labeling_mode": "spatial"},
                        edge_importance_weighting=True)
LOOP_STEPS = 40  # timed steps of the train loop with its loader
NAN_MODULE = "l5.tcn1.pw_conv"  # where --debug_nans' planted NaN sits


def write_nucla_clips(root: str) -> int:
    """Synthetic NW-UCLA clips in the dataset's own layout,
    `<root>/<name>/<name>.json` holding "skeletons" (T, 20, 3), for every
    name of both split lists, T drawn per clip from a seeded generator over
    CLIP_FRAMES (the real skeletons are not in the repository). Returns the
    number of clips."""
    import numpy as np

    from tamgcn_tpu_torch.data.splits import load_nucla_split

    rng = np.random.default_rng(SEED)
    n = 0
    for split in ("train", "val"):
        for info in load_nucla_split(split):
            name = info["file_name"]
            os.makedirs(os.path.join(root, name), exist_ok=True)
            frames = int(rng.integers(CLIP_FRAMES[0], CLIP_FRAMES[1] + 1))
            skeleton = rng.normal(size=(frames, 20, 3)).round(4)
            with open(os.path.join(root, name, f"{name}.json"), "w") as f:
                json.dump({"skeletons": skeleton.tolist()}, f)
            n += 1
    return n


def gcn_train_loaders(clips: str, backends=("numpy", "native")) -> dict:
    """{backend: Loader} of configs/nucla/gcn.yaml's train split (its feeder
    args, repeat 5) on `clips`, as the trainer builds it (batch 16,
    shuffled, drop_last, the config's num_worker threads for the numpy
    path); each feeder asks for its backend by name."""
    from tamgcn_tpu_torch.data import Loader, NUCLAFeederGCN
    from tamgcn_tpu_torch.train.config import load_config

    arg = load_config(["-c", GCN_YAML])
    out = {}
    for backend in backends:
        feeder = NUCLAFeederGCN(**dict(arg.train_feeder_args, data_path=clips),
                                seed=SEED, backend=backend)
        if feeder.backend != backend:
            raise AssertionError(f"asked for backend {backend}, got {feeder.backend}")
        out[backend] = Loader(feeder, batch_size=arg.batch_size, shuffle=True,
                              drop_last=True, seed=SEED, num_workers=arg.num_worker)
    return out


def time_batch_assembly(clips: str) -> dict:
    """One epoch of gcn.yaml's train feeder at batch 16, each batch assembled
    by both backends in turns (numpy: `__getitem__` on the loader's thread
    pool; native: `get_batch`), host clock; the batches must be equal bit
    for bit. Returns {backend: (median ms, mean ms)} and the batch count."""
    import numpy as np

    loaders = gcn_train_loaders(clips)
    iters = {b: iter(loader) for b, loader in loaders.items()}
    ms = {b: [] for b in iters}
    n = len(loaders["native"])
    for _ in range(n):
        batch = {}
        for backend, it in iters.items():
            t0 = time.perf_counter()
            batch[backend] = next(it)
            ms[backend].append(1e3 * (time.perf_counter() - t0))
        for a, b in zip(batch["native"], batch["numpy"]):
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError("the native batch differs from the numpy batch")
    return {b: (float(np.median(v)), float(np.mean(v))) for b, v in ms.items()}, n


def time_train_loop(weights: str, clips: str, device, backend: str) -> dict:
    """The trainer's train loop on gcn.yaml's train feeder: the loader with
    `backend`, the producer thread's host-to-device copy (loader.prefetch)
    and the graphed f32 train step at batch 16 on `weights`: wall ms a step
    over LOOP_STEPS steps after the capture (host clock, synchronised at
    both ends), device-busy ms a step (profile_device over 10 steps of the
    loop) and the idle share."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data.loader import prefetch

    loader = gcn_train_loaders(clips, (backend,))[backend]
    _, _, step = train_model(weights, device)

    def put(batch):
        return (torch.from_numpy(batch[0]).to(device),
                torch.from_numpy(batch[1].astype(np.int64)).to(device))

    batches = prefetch(iter(loader), put)
    step(*next(batches))  # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_STEPS):
        step(*next(batches))
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / LOOP_STEPS
    busy, n_kernels, _ = profile_device(lambda: step(*next(batches)), reps=10)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall, kernels=n_kernels)


def epoch_samples_per_second(work_dir: str) -> float:
    """The samples/s of the last train epoch in the run's log."""
    import re

    with open(os.path.join(work_dir, "log.txt")) as f:
        rates = re.findall(r"Training loss: .* \| ([0-9.]+) samples/s", f.read())
    return float(rates[-1])


def run_gcn_native(work_dir: str, clips: str) -> dict:
    """configs/nucla/gcn.yaml's train phase through `__main__.main` on the
    clips at full width, one epoch (repeat 5 as shipped), backend="native"
    by name for both feeders; the launches of its graphed steps."""
    from tamgcn_tpu_torch.data.splits import load_nucla_split

    steps = len(load_nucla_split("train")) * 5 // TRAIN_BATCH
    evals = math.ceil(len(load_nucla_split("val")) / BATCH)
    seconds, launches = run_cli([
        "recognition", "-c", GCN_YAML, "--phase", "train", "--num_epoch", "1",
        "--work_dir", work_dir, "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
        "--train_feeder_args", f"data_path={clips}", "backend=native",
        "--test_feeder_args", f"data_path={clips}", "backend=native"])
    want = graphed("gcn.yaml --phase train, native", {
        "train": (steps, dict(K1=10, K2=10, K3=10)), "eval": (evals, dict(K1=10))})
    if launches != want:
        raise AssertionError(f"gcn.yaml train phase: launches {launches}, expected {want}")
    with open(os.path.join(work_dir, "log.txt")) as f:
        log = f.read()
    for split in ("train", "test"):
        if f"{split} feeder: NUCLAFeederGCN, backend native" not in log:
            raise AssertionError(f"the {split} feeder did not take the native backend")
    check_train_files(work_dir, 1, 1, "gcn.yaml native")
    step_ms = 1e3 * TRAIN_BATCH / epoch_samples_per_second(work_dir)
    return dict(seconds=seconds, steps=steps, step_ms=step_ms, launches=launches)


def stgcn_logits_against_cpu(work_dir: str, weights: str, clips: str) -> float:
    """The card's test-phase scores of the first BATCH val samples against
    the same weights in f64 on the CPU (the val feeder's numpy path);
    returns max |card - cpu| / max |cpu|."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import NUCLAFeederGCN
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    feeder = NUCLAFeederGCN(clips, split="val", backend="numpy")
    gpu = np.stack([scores[feeder.sample_name[i]] for i in range(BATCH)])
    x = np.stack([feeder[i][0] for i in range(BATCH)]).astype(np.float64)
    model = get_model("stgcn", **STGCN_MODEL_ARGS).double()
    model.load_state_dict(load_weights(weights))
    with torch.no_grad():
        cpu = model.eval()(torch.from_numpy(x)).numpy()
    if gpu.shape != (BATCH, 10) or not np.isfinite(gpu).all():
        raise AssertionError(f"bad ST-GCN logits: shape {gpu.shape}")
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > LOGIT_RTOL:
        raise AssertionError(f"ST-GCN card logits differ from the CPU f64 run: {rel:.3e}")
    return rel


def time_stgcn_step(weights: str, clips: str, device) -> dict:
    """The ST-GCN train step at batch 16 on a batch of the clips, eager and
    graphed, timed in turns eager, graphed, graphed, eager (CUDA events),
    with device-busy ms (profile_device)."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import NUCLAFeederGCN

    feeder = NUCLAFeederGCN(clips, split="train", backend="native", seed=SEED)
    x, y, _ = feeder.get_batch(np.arange(TRAIN_BATCH))
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    steps = {form: train_model(weights, device, capture=capture, model_name="stgcn",
                               model_args=STGCN_MODEL_ARGS)[2]
             for form, capture in (("eager", False), ("graphed", True))}
    ms = {form: [] for form in steps}
    for form in ("eager", "graphed", "graphed", "eager"):
        ms[form].append(cuda_ms(lambda: steps[form](x, y), iters=10))
    out = {}
    for form, step in steps.items():
        busy, n_kernels, _ = profile_device(lambda: step(x, y), reps=3)
        wall = min(ms[form])
        out[form] = dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall, kernels=n_kernels)
    return out


def run_stgcn(work_dir: str, clips: str, device) -> dict:
    """configs/nucla/stgcn.yaml through `__main__.main` on the clips: one
    train epoch (repeat cut to 1) graphed, then --phase test on the best.pt
    it wrote, its logits against a CPU f64 run; the step timed eager and
    graphed; the importance tool for one epoch."""
    from tamgcn_tpu_torch.data.splits import load_nucla_split
    from tamgcn_tpu_torch.tools import train_stgcn_importance

    steps = len(load_nucla_split("train")) // TRAIN_BATCH
    evals = math.ceil(len(load_nucla_split("val")) / BATCH)
    train_dir = os.path.join(work_dir, "stgcn_train")
    base = ["--use_gpu", "true", "--device", "0", "--seed", str(SEED),
            "--test_feeder_args", f"data_path={clips}", "backend=native"]
    seconds, launches = run_cli([
        "recognition", "-c", STGCN_YAML, "--phase", "train", "--num_epoch", "1",
        "--work_dir", train_dir, "--train_feeder_args", f"data_path={clips}", "repeat=1",
        "backend=native", *base])
    graphs_seen = read_graphs()
    if launches != only() or set(graphs_seen) != {"train", "eval"}:
        raise AssertionError(f"ST-GCN train phase: launches {launches}, graphs {graphs_seen}")
    (captures, _, replays, _), (_, _, e_replays, _) = (graphs_seen["train"],
                                                       graphs_seen["eval"])
    if replays != steps or captures != 1 or e_replays != evals:
        raise AssertionError(f"ST-GCN train phase not graphed as expected: {graphs_seen}")
    check_train_files(train_dir, 1, 1, "stgcn.yaml")
    best = os.path.join(train_dir, "checkpoints", "best.pt")
    test_dir = os.path.join(work_dir, "stgcn_test")
    test_seconds, launches = run_cli([
        "recognition", "-c", STGCN_YAML, "--phase", "test", "--weights", best,
        "--work_dir", test_dir, "--save_result", "true", *base])
    if launches != only() or read_graphs()["eval"][2] != evals:
        raise AssertionError(f"ST-GCN test phase: launches {launches}, graphs {read_graphs()}")
    rel = stgcn_logits_against_cpu(test_dir, best, clips)
    times = time_stgcn_step(best, clips, device)

    tool_dir = os.path.join(work_dir, "stgcn_importance")
    reset_launches()
    t0 = time.perf_counter()
    rc = train_stgcn_importance.main([
        "--data_path", clips, "--num_epoch", "1", "--samples_per_class", "8",
        "--train_feeder_args", "repeat=1", "--work_dir", tool_dir, "--use_gpu", "true",
        "--device", "0", "--seed", str(SEED)])
    tool_seconds = time.perf_counter() - t0
    if rc != 0 or read_launches() != only():
        raise AssertionError(f"the importance tool: rc {rc}, launches {read_launches()}")
    with open(os.path.join(tool_dir, "label_weights.json")) as f:
        weights = json.load(f)
    if sorted(weights, key=int) != [str(g) for g in range(10)]:
        raise AssertionError(f"label_weights.json classes {sorted(weights)}")
    for g, parts in weights.items():
        if max(parts.values()) != 1.0 or min(parts.values()) < 0:
            raise AssertionError(f"class {g} not normalised to max 1: {parts}")
    return dict(seconds=seconds, steps=steps, graphs=graphs_seen, test_seconds=test_seconds,
                rel=rel, times=times, tool_seconds=tool_seconds)


def check_weight_forms(work_dir: str, weights: str) -> dict:
    """One CTR-GCN's weights (phase 4's) as the port's .pt, as a
    reference-named .npz (tests/_weight_forms.py: the importer's inverse) and
    as a Flax-layout .npz; --phase test on each (phase 4's run) must give
    the same scores bit for bit, through K1 as always."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _weight_forms import to_flax_arrays, to_reference_state

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    state = load_weights(weights)
    paths = {"pt": weights, "reference npz": os.path.join(work_dir, "reference.npz"),
             "flax npz": os.path.join(work_dir, "flax.npz")}
    np.savez(paths["reference npz"], **to_reference_state(state, "ctrgcn"))
    np.savez(paths["flax npz"], **to_flax_arrays(state, model))
    batches = math.ceil(N_SAMPLES / BATCH)
    scores, seconds = {}, {}
    for form, path in paths.items():
        out = os.path.join(work_dir, "forms", form.replace(" ", "_"))
        seconds[form], launches = run_test_path(out, path)
        if launches != graphed(f"--phase test --weights ({form})",
                               {"eval": (batches, dict(K1=10))}):
            raise AssertionError(f"--weights ({form}): launches {launches}")
        with open(os.path.join(out, "log.txt")) as f:
            if f"({form})" not in f.read():
                raise AssertionError(f"the log does not name the form {form}")
        with open(os.path.join(out, "test_result.pkl"), "rb") as f:
            scores[form] = pickle.load(f)
    for form in paths:
        if list(scores[form]) != list(scores["pt"]) or not all(
                np.array_equal(scores[form][k], scores["pt"][k]) for k in scores["pt"]):
            raise AssertionError(f"--weights ({form}) scores differ from the .pt's")
    return seconds


def check_profile_dir(work_dir: str) -> dict:
    """--profile_dir on a short train run (configs/nucla/smoke.yaml, one
    epoch): the Chrome trace exists and holds the steps' device activity.
    Returns what it records: kernel events (K1-K3 by name, beside the
    launches that ran), graph launches, runtime events and the keys of a
    kernel event's args."""
    import glob

    prof = os.path.join(work_dir, "profile")
    seconds, launches = run_cli(train_argv(os.path.join(work_dir, "profiled")) + [
        "--num_epoch", "1", "--profile_dir", prof])
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile_dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(is_kernel(k, e.get("name", "")) for e in kernels)
              for k in ("K1", "K2", "K3")}
    graph_launches = sum("GraphLaunch" in e.get("name", "") for e in events
                         if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    if min(traced.values()) == 0 or graph_launches < steps:
        raise AssertionError(f"the trace holds no device activity of the steps: kernels "
                             f"{traced}, graph launches {graph_launches}")
    return dict(seconds=seconds, size_mb=os.path.getsize(traces[0]) / 2 ** 20,
                kernels=len(kernels), traced=traced,
                launched={k: launches[k] for k in traced}, graph_launches=graph_launches,
                kernel_args=sorted(kernels[0].get("args", {})))


def check_debug_nans(work_dir: str, weights: str, device) -> dict:
    """--debug_nans: a NaN planted in one weight of l5 stops the train phase
    with FloatingPointError naming that module; on clean weights the graphed
    train step at batch 16 timed with the check (its flag read on the host
    after every step, as the trainer does) and without, in turns."""
    import torch

    from tamgcn_tpu_torch.train.checkpoint import load_weights

    state = load_weights(weights)
    state[f"{NAN_MODULE}.weight"][0, 0] = float("nan")
    nan_path = os.path.join(work_dir, "nan_weights.pt")
    torch.save(state, nan_path)
    try:
        run_cli(train_argv(os.path.join(work_dir, "nan")) + [
            "--num_epoch", "1", "--weights", nan_path, "--debug_nans", "true"])
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("--debug_nans did not stop at the planted NaN")
    if f"module {NAN_MODULE}," not in message:
        raise AssertionError(f"--debug_nans named another place: {message}")
    (x, y), = train_batches(1, TRAIN_BATCH)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    off = train_model(weights, device)[2]
    on = train_model(weights, device, check_finite=True)[2]
    forms = {"off": lambda: off(x, y), "on": lambda: bool(on(x, y)[2])}
    ms = {form: [] for form in forms}
    for form in ("off", "on", "on", "off"):
        ms[form].append(cuda_ms(forms[form], iters=20))
    return dict(message=message, off_ms=min(ms["off"]), on_ms=min(ms["on"]))


def run_skeleton_path(work_dir: str, weights: str, device, step_ms: float) -> dict:
    """Phase 13: synthetic NW-UCLA clips, batch assembly per backend beside
    the graphed step, gcn.yaml's train phase with the native backend (and
    the train loop with each backend), stgcn.yaml and the importance tool,
    the three weight forms, --profile_dir and --debug_nans. Each result
    line ends with the card's name and power limit."""
    out = {}
    card = card_line()

    def report(line: str):
        print(f"phase 13: {line} [{card}]", flush=True)

    clips = os.path.join(work_dir, "nucla_clips")
    t0 = time.perf_counter()
    out["clips"] = write_nucla_clips(clips)
    report(f"{out['clips']} synthetic NW-UCLA clips (T in {CLIP_FRAMES}) written in "
           f"{time.perf_counter() - t0:.1f} s")
    out["assembly"], out["batches"] = time_batch_assembly(clips)
    report(f"batch assembly, gcn.yaml train feeder, batch {TRAIN_BATCH}, one epoch "
           f"({out['batches']} batches), bit for bit equal: " + ", ".join(
               f"{b} {med:.3f} ms median ({mean:.3f} mean)"
               for b, (med, mean) in out["assembly"].items())
           + f"; the graphed f32 train step in this run (phase 12): {step_ms:.3f} ms")

    phase("13. skeleton path: gcn.yaml train phase, native")
    out["gcn"] = g = run_gcn_native(os.path.join(work_dir, "gcn_native"), clips)
    report(f"gcn.yaml train phase, native: {g['steps']} steps in {g['seconds']:.2f} s "
           f"(incl. model build, data and eval), {g['step_ms']:.3f} ms a step over the epoch")
    out["loop"] = {b: time_train_loop(weights, clips, device, b) for b in ("native", "numpy")}
    for b, r in out["loop"].items():
        report(f"train loop (loader {b}, prefetch, graphed f32 step), batch {TRAIN_BATCH}: "
               f"{r['wall_ms']:.3f} ms a step, device busy {r['busy_ms']:.3f} ms "
               f"({100 * r['idle']:.1f}% idle)")

    phase("13. skeleton path: ST-GCN")
    out["stgcn"] = s = run_stgcn(work_dir, clips, device)
    report(f"stgcn.yaml train phase: {s['steps']} graphed steps in {s['seconds']:.2f} s; "
           f"test phase {s['test_seconds']:.2f} s, logits vs CPU f64 max rel err "
           f"{s['rel']:.3e}; importance tool (1 epoch) {s['tool_seconds']:.2f} s")
    for form, r in s["times"].items():
        report(f"ST-GCN train step, batch {TRAIN_BATCH}, {form}: {r['wall_ms']:.3f} ms, "
               f"device busy {r['busy_ms']:.3f} ms ({100 * r['idle']:.1f}% idle), "
               f"{r['kernels']} kernels")

    phase("13. skeleton path: weight forms, flags")
    out["forms"] = check_weight_forms(work_dir, weights)
    report("--weights as .pt, reference .npz and Flax .npz: test-phase scores equal bit "
           "for bit; " + ", ".join(f"{k} {v:.2f} s" for k, v in out["forms"].items()))
    out["profile"] = p = check_profile_dir(work_dir)
    report(f"--profile_dir trace ({p['size_mb']:.1f} MiB): {p['kernels']} kernel events, "
           f"K1-K3 traced {p['traced']} of launched {p['launched']}, {p['graph_launches']} "
           f"graph launches; kernel event args {p['kernel_args']}")
    out["nans"] = n = check_debug_nans(work_dir, weights, device)
    report(f"--debug_nans: {n['message']}; graphed f32 train step, batch {TRAIN_BATCH}: "
           f"{n['off_ms']:.3f} ms without the check, {n['on_ms']:.3f} ms with it (the flag "
           "read every step)")
    return out


# ---- phase 14: NTU-60 two-person training, the RGB and cross-modal families ----

NTU_YAML = os.path.join(REPO, "configs", "ntu60.yaml")
RESNET_YAML = os.path.join(REPO, "configs", "nucla", "resnet.yaml")
CROSS_MODAL_YAML = os.path.join(REPO, "configs", "nucla", "cross_modal.yaml")
NTU_FRAMES = (30, 300)  # each synthetic NTU clip's length T, drawn uniformly
NTU_MUTUAL = 50  # NTU-60's actions A050-A060 are the mutual (two-person) ones
NTU_BATCH, NTU_TEST_BATCH = 128, 256  # configs/ntu60.yaml
NTU_TRAIN_STEPS = 3
NTU_ASSEMBLY_BATCHES = 16  # numpy batches timed, after the loader's first
# the unit op's shapes (N*M, T, V, C, R) in an NTU train step at batch 128
# (two persons), with the launches per step of the joint-tiled K1 and K2
# (V = 25 is past the whole-V design) and of K3
NTU_UNIT_PATH = [
    ("l1-l4", (2 * NTU_BATCH, 64, 25, 64, 8), 4),
    ("l5", (2 * NTU_BATCH, 64, 25, 128, 8), 1),
    ("l6-l7", (2 * NTU_BATCH, 32, 25, 128, 16), 2),
    ("l8", (2 * NTU_BATCH, 32, 25, 256, 16), 1),
    ("l9-l10", (2 * NTU_BATCH, 16, 25, 256, 32), 2),
]
# the joint-tiled K1's shapes and launches in an eval forward at the test batch
NTU_EVAL_UNIT_PATH = [(name, (2 * NTU_TEST_BATCH, *shape[1:]), n)
                      for name, shape, n in NTU_UNIT_PATH]
# K5's blocks (N*M, T, V, Cin, C, R) in a fast-eval forward at the test batch
NTU_K5_PATH = [
    ("l1", (2 * NTU_TEST_BATCH, 64, 25, 3, 64, 8), 1),
    ("l2-l4", (2 * NTU_TEST_BATCH, 64, 25, 64, 64, 8), 3),
    ("l5", (2 * NTU_TEST_BATCH, 64, 25, 64, 128, 8), 1),
    ("l6-l7", (2 * NTU_TEST_BATCH, 32, 25, 128, 128, 16), 2),
    ("l8", (2 * NTU_TEST_BATCH, 32, 25, 128, 256, 16), 1),
    ("l9-l10", (2 * NTU_TEST_BATCH, 16, 25, 256, 256, 32), 2),
]
PLAIN_ITERS = 3  # the plain versions at NTU's shapes take tens of ms a call
RGB_SAMPLES, RGB_EVAL = 64, 32  # configs/nucla/resnet.yaml: 4 steps of 16, a test batch of 32
FUSION_SAMPLES, FUSION_EVAL = 48, 32  # cross_modal.yaml: 3 steps of 16, a test batch of 32
FUSION_CPU_SAMPLES = 8  # of the first test batch, held to a CPU f64 run


def fusion_feeder(split: str, num_samples: int):
    """The synthetic fusion feeder as the trainer builds it from
    fusion_argv: its constructor takes no `seed` by name (it passes its
    keywords on), so the trainer gives it none and it keeps seed 0, in the
    JAX package too (data/__init__.py:feeder_accepts_seed)."""
    from tamgcn_tpu_torch.data import SyntheticFusionFeeder

    return SyntheticFusionFeeder(num_samples=num_samples, split=split, image_size=224,
                                 temporal_rgb_frames=5)


def config_args(path: str, *extra):
    from tamgcn_tpu_torch.train.config import load_config

    return load_config(["-c", path, *extra])


def write_ntu_clips(root: str, counts=(NTU_TRAIN_STEPS * NTU_BATCH, NTU_TEST_BATCH)) -> int:
    """Synthetic NTU-60 clips in the generic skeleton feeder's layout:
    `<root>/<split>_split.json` ({"file_name", "label" 1..60}) and
    `<root>/<name>.json` holding "skeletons" (T, 25, 3) for one person or
    (T, 2, 25, 3) for two (the mutual actions, as in NTU-60: 11 of its 60
    classes), T drawn per clip from a seeded generator over NTU_FRAMES
    (NTU-60 is not in the repository; its clips are at most 300 frames, the
    spread within that is assumed), the
    coordinates whole millimetres (JSON integers, which write and parse
    faster than floats; the feeder reads either). Returns the number of
    clips."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    n = 0
    for split, count in zip(("train", "val"), counts):
        records = []
        for i in range(count):
            action = i % 60 + 1
            name = f"S{1 + i // 60:03d}C001P{i:03d}R{1 + (split == 'val')}A{action:03d}"
            frames = int(rng.integers(NTU_FRAMES[0], NTU_FRAMES[1] + 1))
            persons = (frames, 2, 25, 3) if action >= NTU_MUTUAL else (frames, 25, 3)
            skeleton = (1000 * rng.normal(size=persons)).round().astype(np.int64)
            with open(os.path.join(root, f"{name}.json"), "w") as f:
                # json.dumps encodes in C, json.dump chunk by chunk in Python
                f.write(json.dumps({"skeletons": skeleton.tolist()}))
            records.append({"file_name": name, "label": action})
            n += 1
        with open(os.path.join(root, f"{split}_split.json"), "w") as f:
            json.dump(records, f)
    return n


def ntu_argv(work_dir: str, clips: str, *extra) -> list:
    """configs/ntu60.yaml as shipped on one card: --distributed false, the
    synthetic clips as its data_path."""
    return ["recognition", "-c", NTU_YAML, "--distributed", "false", "--work_dir", work_dir,
            "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
            "--train_feeder_args", f"data_path={clips}", "--test_feeder_args",
            f"data_path={clips}", *extra]


def read_scores(work_dir: str):
    import numpy as np

    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    return list(scores), np.stack(list(scores.values()))


def time_step(step, inputs, label: str) -> dict:
    """A train step (graphed or eager) timed (CUDA events, ms a call) with
    its device busy time and kernels (profile_device)."""
    wall = cuda_ms(lambda: step(*inputs), iters=10)
    busy, n_kernels, events = profile_device(lambda: step(*inputs), reps=3)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall, kernels=n_kernels,
                events=events, label=label)


TRAINER_TF32 = {}  # main: the TF32 switches as torch starts; the trainer never sets them


@contextlib.contextmanager
def trainer_tf32():
    """The TF32 switches the port's trainer runs with (TRAINER_TF32),
    restored after: the run holds its numerics checks with TF32 off."""
    import torch

    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = TRAINER_TF32["matmul"]
    torch.backends.cudnn.allow_tf32 = TRAINER_TF32["cudnn"]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def time_step_tf32(build, inputs, label: str) -> dict:
    """time_step of the step that `build()` makes, with TF32 off ("off")
    and with the trainer's TF32 switches ("trainer"), each built and
    captured under its setting (a graph keeps the convolutions its capture
    chose)."""
    out = {"off": time_step(build(), inputs, label)}
    with trainer_tf32():
        out["trainer"] = time_step(build(), inputs, label)
    return out


def step_line(t: dict) -> str:
    return "; ".join(f"TF32 {tf32}: {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms "
                     f"({100 * r['idle']:.1f}% idle), {r['kernels']} kernels"
                     for tf32, r in t.items())


def run_ntu(work_dir: str, device, report) -> dict:
    """configs/ntu60.yaml (full width, batch 128, two persons, V = 25, T =
    64) with --distributed false through `__main__.main` on synthetic NTU
    clips: K1t, K2t and K3 against their plain versions at its train step's
    shapes, K1t (K1t_eval) at its eval shapes and K5 at its fast-eval
    shapes (batch 256), NTU_TRAIN_STEPS
    graphed train steps and the eval, --phase test on the checkpoint
    directory and --phase test --fast_eval true (launch checks; the two
    test runs' scores agree); numpy batch assembly at batch 128 (the native
    core takes single-person datasets only) over NTU_ASSEMBLY_BATCHES
    batches after the first beside the graphed step's wall and busy time
    (time_step_tf32), and each kernel's device time a step beside its
    bound."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import Loader, SkeletonFeederGCN

    out = {}
    rows = {}
    for kname, fn, plain, bound in (("K1t", k1, k1_plain, k1_bound),
                                    ("K2t", k2, k2_plain, k2_bound),
                                    ("K3", k3, k3_plain, k3_bound)):
        rows[kname] = check_unit_shapes(kname, fn, plain, bound, NTU_UNIT_PATH, 700, device,
                                        plain_iters=PLAIN_ITERS)
    rows["K1t_eval"] = check_unit_shapes("K1t", k1, k1_plain, k1_bound, NTU_EVAL_UNIT_PATH,
                                         750, device, plain_iters=PLAIN_ITERS)
    rows["K5"] = check_k5_shapes(NTU_K5_PATH, 800, device, plain_iters=PLAIN_ITERS)
    out["kernels"] = rows

    clips = os.path.join(work_dir, "ntu_clips")
    os.makedirs(clips)
    t0 = time.perf_counter()
    n = write_ntu_clips(clips)
    report(f"ntu60: {n} synthetic NTU clips (two persons in A0{NTU_MUTUAL}-A060, T in {NTU_FRAMES}) written "
           f"in {time.perf_counter() - t0:.1f} s")

    train_dir = os.path.join(work_dir, "ntu_train")
    seconds, launches = run_cli(ntu_argv(train_dir, clips, "--phase", "train",
                                         "--num_epoch", "1"))
    want = graphed("ntu60.yaml --phase train", {
        "train": (NTU_TRAIN_STEPS, dict(K1t=10, K2t=10, K3=10)), "eval": (1, dict(K1t=10))})
    if launches != want:
        raise AssertionError(f"ntu60.yaml --phase train: launches {launches}, expected {want}")
    with open(os.path.join(train_dir, "log.txt")) as f:
        if "train feeder: SkeletonFeederGCN, backend numpy" not in f.read():
            raise AssertionError("the two-person NTU feeder did not take numpy")
    check_train_files(train_dir, 1, 1, "ntu60.yaml")
    out["train"] = dict(seconds=seconds, launches=launches)
    report(f"ntu60.yaml --phase train: {NTU_TRAIN_STEPS} graphed steps at batch {NTU_BATCH} "
           f"and the eval in {seconds:.2f} s (incl. model build, data and captures), "
           f"launches {launches}")

    checkpoints = os.path.join(train_dir, "checkpoints")
    scores = {}
    for label, step, kernel, extra in (("test", "eval", "K1t", []),
                                       ("fast_eval", "fast_eval", "K5", ["--fast_eval", "true"])):
        test_dir = os.path.join(work_dir, f"ntu_{label}")
        seconds, launches = run_cli(ntu_argv(test_dir, clips, "--phase", "test", "--weights",
                                             checkpoints, "--save_result", "true", *extra))
        if launches != graphed(f"ntu60.yaml --phase test {' '.join(extra)}",
                               {step: (1, {kernel: 10})}):
            raise AssertionError(f"ntu60.yaml --phase test {' '.join(extra)}: launches "
                                 f"{launches}, expected {kernel} 10 per batch and warm-up call")
        scores[label] = read_scores(test_dir)
        out[label] = dict(seconds=seconds, launches=launches)
        report(f"ntu60.yaml --phase test {' '.join(extra)} on the checkpoint directory: "
               f"{NTU_TEST_BATCH} samples in {seconds:.2f} s, launches {launches}")
    (names, test), (fast_names, fast) = scores["test"], scores["fast_eval"]
    rel = float(np.abs(test - fast).max() / np.abs(test).max())
    if names != fast_names or test.shape != (NTU_TEST_BATCH, 60) or not np.isfinite(
            test).all() or rel > LOGIT_RTOL:
        raise AssertionError(f"ntu60.yaml test and fast-eval scores: shape {test.shape}, "
                             f"max rel difference {rel:.3e}")
    out["fast_vs_test"] = rel
    report(f"ntu60.yaml scores, the fast eval (K5) against the test phase (K1t): max rel "
           f"difference {rel:.3e}")

    arg = config_args(NTU_YAML)
    # the feeder's `repeat` gives the loader enough distinct samples
    repeat = -(-(NTU_ASSEMBLY_BATCHES + 1) * NTU_BATCH // (NTU_TRAIN_STEPS * NTU_BATCH))
    feeder = SkeletonFeederGCN(**dict(arg.train_feeder_args, data_path=clips, repeat=repeat),
                               seed=SEED)
    loader = Loader(feeder, batch_size=NTU_BATCH, shuffle=True, drop_last=True, seed=SEED,
                    num_workers=arg.num_worker)
    times, batches = [], iter(loader)
    for _ in range(NTU_ASSEMBLY_BATCHES + 1):
        t0 = time.perf_counter()
        x, y, _ = next(batches)
        times.append(1e3 * (time.perf_counter() - t0))
    times = times[1:]  # the first batch also starts the loader's thread pool
    out["assembly_ms"] = dict(median=float(np.median(times)), mean=float(np.mean(times)),
                              min=float(np.min(times)), max=float(np.max(times)))

    model_args = dict(arg.model_args)
    weights = os.path.join(checkpoints, "epoch1.pt")
    inputs = (torch.from_numpy(x).to(device), torch.from_numpy(y.astype(np.int64)).to(device))
    out["step"] = steps = time_step_tf32(
        lambda: train_model(weights, device, model_args=model_args)[2], inputs, "ntu60")
    a = out["assembly_ms"]
    report(f"ntu60 batch assembly (numpy, {arg.num_worker} threads), batch {NTU_BATCH}, "
           f"{len(times)} batches after the first: median {a['median']:.3f} ms, mean "
           f"{a['mean']:.3f}, min {a['min']:.3f}, max {a['max']:.3f}; the graphed train "
           f"step: {step_line(steps)}")
    t = steps["trainer"]
    for kname in ("K1t", "K2t", "K3"):
        traced = sum(ms for name, ms, _ in t["events"] if is_kernel(kname, name))
        device_ms = sum(r["device_ms"] * r["launches_per_step"] for r in rows[kname])
        bound_ms = sum(r["bound_ms"] * r["launches_per_step"] for r in rows[kname])
        report(f"ntu60 {kname} per train step: {device_ms:.4f} ms device (CUDA graph), "
               f"bound {bound_ms:.4f} ms; in the step's trace (the trainer's TF32) "
               f"{traced:.4f} ms, {100 * traced / t['busy_ms']:.1f}% of the device time")
    device_ms = sum(r["device_ms"] * r["launches_per_step"] for r in rows["K1t_eval"])
    bound_ms = sum(r["bound_ms"] * r["launches_per_step"] for r in rows["K1t_eval"])
    report(f"ntu60 K1t per eval forward at batch {NTU_TEST_BATCH}: {device_ms:.4f} ms "
           f"device (CUDA graph), bound {bound_ms:.4f} ms")
    device_ms = sum(r["device_ms"] * r["launches_per_step"] for r in rows["K5"])
    bound_ms = sum(r["bound_ms"] * r["launches_per_step"] for r in rows["K5"])
    report(f"ntu60 K5 per fast-eval forward at batch {NTU_TEST_BATCH}: {device_ms:.4f} ms "
           f"device (CUDA graph), bound {bound_ms:.4f} ms")
    return out


def rgb_batches(n: int, batch: int, image_size: int = 224):
    import numpy as np

    from tamgcn_tpu_torch.data import SyntheticRGBFeeder

    feeder = SyntheticRGBFeeder(num_samples=n * batch, image_size=image_size, split="train",
                                seed=SEED)
    return [(np.stack([feeder[i][0] for i in range(b * batch, (b + 1) * batch)]),
             feeder.label[b * batch:(b + 1) * batch].astype(np.int64)) for b in range(n)]


def packed_rgb_run(weights: str, batches, device, compute, capture: bool):
    """packed_run for ResNetOnly (resnet.yaml's model) on RGB batches."""
    import torch

    _, state, step = train_model(weights, device, compute=compute, capture=capture,
                                 model_args=dict(num_class=10), model_name="resnet_only")
    losses = [step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))[0]
              for x, y in batches]
    flats = {"parameters": state.params.flats, "momentum":
             state.optimizer.state["momentum_buffer"], "statistics": state.stats.flats}
    return losses, {k: torch.cat([f.reshape(-1) for f in v]) for k, v in flats.items()}


def rgb_argv(work_dir: str, *extra) -> list:
    """configs/nucla/resnet.yaml's shapes (224 x 224, batch 16, test batch
    32) on synthetic class-prototype images (the ST-ROI images are not in
    the repository)."""
    return ["recognition_rgb_only", "-c", RESNET_YAML, "--feeder", "synthetic_rgb",
            "--work_dir", work_dir, "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
            "--train_feeder_args", f"num_samples={RGB_SAMPLES}", "image_size=224",
            "--test_feeder_args", f"num_samples={RGB_EVAL}", "image_size=224", *extra]


def run_rgb(work_dir: str, device, report) -> dict:
    """recognition_rgb_only at resnet.yaml's shapes, f32 and bf16: one train
    epoch (4 graphed steps) with its eval, --phase test on the checkpoint
    directory (no port kernel launched; finite scores); the graphed train
    step against the eager one over 3 steps bit for bit with deterministic
    cuDNN; each step's wall and busy time and kernels, graphed and eager."""
    import numpy as np
    import torch

    out = {}
    steps = RGB_SAMPLES // 16
    batches = rgb_batches(TRAJ_STEPS, 16)
    for label, compute in (("f32", None), ("bf16", "bfloat16")):
        extra = ["--model_args", "dtype=bfloat16"] if compute else []
        train_dir = os.path.join(work_dir, f"rgb_{label}")
        seconds, launches = run_cli(rgb_argv(train_dir, "--num_epoch", "1", *extra))
        if launches != graphed(f"recognition_rgb_only {label}",
                               {"train": (steps, {}), "eval": (1, {})}):
            raise AssertionError(f"recognition_rgb_only {label}: launches {launches}")
        checkpoints = os.path.join(train_dir, "checkpoints")
        test_dir = os.path.join(work_dir, f"rgb_{label}_test")
        test_seconds, launches = run_cli(rgb_argv(test_dir, "--phase", "test", "--weights",
                                                  checkpoints, "--save_result", "true",
                                                  *extra))
        if launches != graphed(f"recognition_rgb_only {label} --phase test",
                               {"eval": (1, {})}):
            raise AssertionError(f"recognition_rgb_only {label} test: launches {launches}")
        _, scores = read_scores(test_dir)
        if scores.shape != (RGB_EVAL, 10) or not np.isfinite(scores).all():
            raise AssertionError(f"recognition_rgb_only {label}: scores {scores.shape}")
        weights = os.path.join(checkpoints, "epoch1.pt")
        with deterministic_cudnn():
            eager = packed_rgb_run(weights, batches, device, compute, False)
            graphed_ = packed_rgb_run(weights, batches, device, compute, True)
        bitwise = differences(graphed_, eager)
        if bitwise:
            raise AssertionError(f"the graphed ResNet {label} train step differs from the "
                                 f"eager one with deterministic cuDNN: {bitwise}")
        (x, y), = rgb_batches(1, 16)
        inputs = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
        forms = {form: time_step_tf32(lambda: train_model(
            weights, device, compute=compute, capture=capture, model_args=dict(num_class=10),
            model_name="resnet_only")[2], inputs, form)
            for form, capture in (("eager", False), ("graphed", True))}
        out[label] = dict(seconds=seconds, test_seconds=test_seconds, times=forms)
        report(f"recognition_rgb_only {label}: {steps} graphed steps at batch 16, 224 x 224, "
               f"with the eval in {seconds:.2f} s, --phase test {test_seconds:.2f} s; no port "
               f"kernel launched; graphed vs eager over {TRAJ_STEPS} steps with "
               "deterministic cuDNN: equal bit for bit")
        for form, t in forms.items():
            report(f"ResNet-50 {label} train step, batch 16, {form}: {step_line(t)}")
    return out


def fusion_argv(work_dir: str, *extra) -> list:
    """configs/nucla/cross_modal.yaml's shapes (batch 16, T = 52, 15 x 224 x
    224, test batch 32) on the synthetic skeleton + RGB pairs."""
    return ["recognition_cross_modal", "-c", CROSS_MODAL_YAML, "--feeder", "synthetic_fusion",
            "--work_dir", work_dir, "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
            "--train_feeder_args", f"num_samples={FUSION_SAMPLES}", "image_size=224",
            "--test_feeder_args", f"num_samples={FUSION_EVAL}", "image_size=224", *extra]


def calibrate_fusion(weights: str, out: str, device) -> None:
    """The fusion model of `weights` with the running statistics of its
    ResNet and attention BatchNorms taken from one train-mode pass over a
    batch of 16 train samples (momentum 1; the frozen GCN keeps its own),
    so that its eval activations stay O(1) and the card-CPU comparison of
    the logits tests the port, not conditioning."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.norm import BatchNorm
    from tamgcn_tpu_torch.train.checkpoint import load_weights, save_weights

    model = get_model("resnet_gcn_attention", **dict(config_args(CROSS_MODAL_YAML).model_args))
    model.load_state_dict(load_weights(weights))
    feeder = fusion_feeder("train", 16)
    items = [feeder[i] for i in range(16)]
    xg, xr = (torch.from_numpy(np.stack([it[k] for it in items])).to(device) for k in (0, 1))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        model.to(device).train()(xg, xr)
    for bn in bns:
        bn.momentum = 0.1
    save_weights(model.cpu(), out)


def fusion_logits_against_cpu(work_dir: str, weights: str) -> float:
    """The card's test-phase scores of the first FUSION_CPU_SAMPLES val
    samples against the same weights in f64 on the CPU."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    names, scores = read_scores(work_dir)
    feeder = fusion_feeder("val", FUSION_EVAL)
    if names != feeder.sample_name or scores.shape != (FUSION_EVAL, 10):
        raise AssertionError(f"fusion scores: {scores.shape} for {len(names)} names")
    items = [feeder[i] for i in range(FUSION_CPU_SAMPLES)]
    xg, xr = (torch.from_numpy(np.stack([it[k] for it in items]).astype(np.float64))
              for k in (0, 1))
    model = get_model("resnet_gcn_attention", **dict(config_args(CROSS_MODAL_YAML).model_args))
    model.load_state_dict(load_weights(weights))
    with torch.no_grad():
        cpu = model.double().eval()(xg, xr).numpy()
    gpu = scores[:FUSION_CPU_SAMPLES]
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if not np.isfinite(scores).all() or rel > LOGIT_RTOL:
        raise AssertionError(f"fusion card logits differ from the CPU f64 run: {rel:.3e}")
    return rel


def run_cross_modal(work_dir: str, weights: str, device, report) -> dict:
    """recognition_cross_modal at cross_modal.yaml's shapes with --weights
    the phase-4 CTR-GCN `.pt` (into the frozen `gcn`): one train epoch (3
    graphed steps) and its eval, K1 10 per step and eval forward and never
    K2 or K3; the GCN's parameters and BatchNorm statistics after training
    bit for bit the CTR-GCN's; the fusion model's `gcn` features bit for bit
    those of the CTR-GCN alone; on calibrated weights the test phase's
    logits against a CPU f64 run, and in bf16 against the card's plain bf16
    unit op; the graphed step's wall and busy time."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    out = {}
    steps = FUSION_SAMPLES // 16
    train_dir = os.path.join(work_dir, "fusion_train")
    seconds, launches = run_cli(fusion_argv(train_dir, "--weights", weights, "--num_epoch", "1"))
    if launches != graphed("recognition_cross_modal --phase train", {
            "train": (steps, dict(K1=10)), "eval": (1, dict(K1=10))}):
        raise AssertionError(f"recognition_cross_modal train: launches {launches}, expected "
                             "K1 10 per step and eval forward, no K2 or K3")
    trained = load_weights(os.path.join(train_dir, "checkpoints", "epoch1.pt"))
    ctrgcn = load_weights(weights)
    moved = [k for k, v in ctrgcn.items() if not k.startswith("fc.")
             and not torch.equal(trained[f"gcn.{k}"], v)]
    if moved or len(ctrgcn) - 2 != sum(k.startswith("gcn.") for k in trained):
        raise AssertionError(f"the frozen GCN moved in training: {moved[:5]}")
    out["train"] = dict(seconds=seconds, launches=launches)
    report(f"recognition_cross_modal: {steps} graphed steps at batch 16 (T 52, 15 x 224 x "
           f"224) and the eval in {seconds:.2f} s, launches {launches}; the GCN's "
           f"{len(ctrgcn) - 2} parameters and BatchNorm statistics bit for bit the CTR-GCN's")

    args = dict(config_args(CROSS_MODAL_YAML).model_args)
    fusion = get_model("resnet_gcn_attention", **args)
    fusion.load_state_dict(trained)
    alone = get_model("ctrgcn", **nucla_model_args())
    alone.load_state_dict(ctrgcn)
    feeder = fusion_feeder("val", 16)
    xg = torch.from_numpy(np.stack([feeder[i][0] for i in range(16)])).to(device)
    with torch.inference_mode():
        mine = fusion.to(device).eval().extract_feature(xg)[0]
        theirs = alone.to(device).eval().extract_feature(xg)[0]
    if not torch.equal(mine, theirs):
        raise AssertionError("the fusion model's gcn features differ from the CTR-GCN's: "
                             f"{float((mine - theirs).abs().max())}")

    calibrated = os.path.join(work_dir, "fusion_calibrated.pt")
    calibrate_fusion(os.path.join(train_dir, "checkpoints", "epoch1.pt"), calibrated, device)
    runs = {}
    for label, extra, plain, want in (
            ("f32", [], False, dict(K1=10)),
            ("bf16", ["--model_args", "dtype=bfloat16"], False, dict(K1_bf16=10)),
            ("bf16 plain", ["--model_args", "dtype=bfloat16"], True, {})):
        test_dir = os.path.join(work_dir, f"fusion_test_{label.replace(' ', '_')}")
        with plain_unit_op() if plain else contextlib.nullcontext():
            test_seconds, launches = run_cli(fusion_argv(
                test_dir, "--phase", "test", "--weights", calibrated, "--save_result", "true",
                *extra))
        if launches != graphed(f"recognition_cross_modal --phase test ({label})",
                               {"eval": (1, want)}):
            raise AssertionError(f"recognition_cross_modal test ({label}): launches {launches}")
        runs[label] = (test_dir, test_seconds)
    rel = fusion_logits_against_cpu(runs["f32"][0], calibrated)
    _, bf16 = read_scores(runs["bf16"][0])
    _, plain = read_scores(runs["bf16 plain"][0])
    bf16_rel = float(np.abs(bf16 - plain).max() / np.abs(plain).max())
    if not np.isfinite(bf16).all() or bf16_rel > BF16_LOGIT_TOL:
        raise AssertionError(f"fusion bf16 logits against the plain bf16 unit op: {bf16_rel:.3e}")
    out.update(cpu_rel=rel, bf16_rel=bf16_rel)
    report(f"recognition_cross_modal --phase test ({FUSION_EVAL} samples, K1 10 per batch): "
           f"{runs['f32'][1]:.2f} s; the gcn features bit for bit the CTR-GCN's; logits vs "
           f"a CPU f64 run max rel err {rel:.3e}; bf16 (K1_bf16) vs the card's plain bf16 "
           f"unit op {bf16_rel:.3e}")

    items = [fusion_feeder("train", 16)[i] for i in range(16)]
    inputs = tuple(torch.from_numpy(np.stack([it[k] for it in items])).to(device)
                   for k in (0, 1)) + (torch.arange(16, device=device) % 10,)
    out["step"] = t = time_step_tf32(lambda: train_model(
        calibrated, device, model_args=args, model_name="resnet_gcn_attention",
        freeze=("gcn",))[2], inputs, "cross-modal")
    report(f"cross-modal graphed train step, batch 16: {step_line(t)}")
    return out


def run_phase14(work_dir: str, weights: str, device) -> dict:
    """Phase 14: NTU-60 (run_ntu), the RGB family (run_rgb) and the
    cross-modal fusion (run_cross_modal); each result line ends with the
    card's name and power limit."""
    card = card_line()

    def report(line: str):
        print(f"phase 14: {line} [{card}]", flush=True)

    out = {"ntu": run_ntu(work_dir, device, report)}
    phase("14. RGB")
    out["rgb"] = run_rgb(work_dir, device, report)
    phase("14. cross-modal")
    out["cross_modal"] = run_cross_modal(work_dir, weights, device, report)
    return out


# ---- phase 15: seeded dropout in training, the serving export ------------------

DROP_OUT = 0.5  # the head's dropout of gcn.yaml's CTR-GCN in phase 15
DROPOUT_STEPS = 4  # the unbroken run; the resumed one stops after RESUME_AT
RESUME_AT = 2
SERVE_RTOL = 1e-5  # an artifact's logits vs the live graphed forward, x max |logit|
SERVE_POLY_BATCH = 17  # the --poly_batch artifact's second batch
SERVE_TIMED = 20  # artifact calls between two CUDA events
# a process that serves the artifacts: it imports tamgcn_tpu_torch.ops and
# nothing else of the port, loads each artifact of DIR, runs it on DIR/x.npy
# (the launches of one call, ms a call by CUDA events, device busy and
# kernels by torch.profiler), then the unit op's CUDA implementation
# replaced by one that returns zeros (a planted fault), and prints one JSON
# line
SERVE_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import tamgcn_tpu_torch.ops
from tamgcn_tpu_torch.ops.cuda import ctr_gc, gcn_tcn_block
from torch.profiler import ProfilerActivity, profile

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work, timed, poly_batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
x = torch.from_numpy(np.load(work + "/x.npy")).cuda()


def counts():
    return {"K1": ctr_gc.launches, "K1t": ctr_gc.launches_tiled,
            "K5": gcn_tcn_block.launches}


out = {}
with torch.inference_mode():
    for name in ("model", "fast", "poly"):
        program = torch.export.load(work + "/" + name + ".pt2").module()
        before = counts()
        logits = program(x)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in counts().items()}
        np.save(work + "/" + name + "_logits.npy", logits.cpu().numpy())
        if name == "poly":
            np.save(work + "/poly_small_logits.npy", program(x[:poly_batch]).cpu().numpy())
        for _ in range(3):
            program(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed):
            program(x)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / timed
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                program(x)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out[name] = dict(launches=launched, ms=ms,
                         busy_ms=sum(e.self_device_time_total for e in events) / 5e3,
                         kernels=sum(e.count for e in events) // 5)
    ctr_gc.unit_ctr_gc_fwd = lambda x1s, x2s, x3s, w4s, *rest: torch.zeros(
        x3s.shape[:3] + (w4s.shape[-1],), device=x3s.device, dtype=x3s.dtype)
    program = torch.export.load(work + "/model.pt2").module()
    np.save(work + "/fault_logits.npy", program(x).cpu().numpy())
out["modules"] = sorted(m for m in sys.modules if m.startswith("tamgcn_tpu_torch"))
print(json.dumps(out))
"""


def dropout_model_args() -> dict:
    return nucla_model_args() | {"drop_out": DROP_OUT}


def dropout_run(weights: str, batches, device, capture: bool, resume_at=None,
                checkpoints=None):
    """Train steps of gcn.yaml's CTR-GCN with drop_out DROP_OUT from
    `weights`, one on each of `batches`, eager or as CUDA graphs; with
    `resume_at` k, after k steps the model, the optimiser and the step go to
    a checkpoint file (train/checkpoint.py, as the trainer saves a resume
    point) and a new model, packed state and step restored from it, as
    --resume does, take the rest. Returns what packed_run returns."""
    import torch

    from tamgcn_tpu_torch.train.checkpoint import Checkpoints

    model, state, step = train_model(weights, device, capture=capture,
                                     model_args=dropout_model_args())
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == resume_at:
            store = Checkpoints(checkpoints)
            store.save(f"epoch{i}", model, i, state.optimizer_state_dict())
            tree = store.load(f"epoch{i}")
            model, state, step = train_model(weights, device, capture=capture,
                                             model_args=dropout_model_args())
            model.load_state_dict(tree["model"])
            state.load_optimizer_state_dict(tree["optimizer"])
            state.set_step(tree["step"])
        losses.append(step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))[0])
    if int(state.step) != len(batches):
        raise AssertionError(f"the device step counter reads {int(state.step)} after "
                             f"{len(batches)} steps")
    flats = {"parameters": state.params.flats, "momentum":
             state.optimizer.state["momentum_buffer"], "statistics": state.stats.flats}
    return losses, {k: torch.cat([f.reshape(-1) for f in v]) for k, v in flats.items()}


def five_sigma(kept: int, n: int, q: float) -> bool:
    return abs(kept - q * n) <= 5 * math.sqrt(n * q * (1 - q))


def check_dropout_replays(weights: str, device) -> dict:
    """Two replays of the graphed train step with drop_out DROP_OUT: a hook
    on the head's dropout site copies its input and output into buffers the
    capture records, so each replay leaves its own; each replay's output is
    the seeded mask of its step (ops/dropout.py:keep_mask with the step the
    device counter held) applied to its input, bit for bit, and the two
    replays' masks differ. The mask function on the card equals the CPU's
    bit for bit, and its kept share lies within 5 sigma of 1 - p."""
    import torch

    from tamgcn_tpu_torch.ops.dropout import keep_mask

    model, state, step = train_model(weights, device, model_args=dropout_model_args())
    seen = []

    def hook(module, args, out):
        if not seen:  # the first warm-up call, before the capture
            seen.extend([torch.empty_like(args[0]), torch.empty_like(out)])
        seen[0].copy_(args[0].detach())
        seen[1].copy_(out.detach())

    model.dropout.register_forward_hook(hook)
    masks = []
    for k, (x, y) in enumerate(train_batches(2, TRAIN_BATCH)):
        step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
        h, out = seen[0].clone(), seen[1].clone()
        keep = keep_mask(h.shape, DROP_OUT, state.seed, k, 0, device)
        if not out.equal(torch.where(keep, h / (1 - DROP_OUT), 0.0)):
            raise AssertionError(f"replay {k}: the dropout site's output is not the "
                                 f"seeded mask of step {k} on its input")
        masks.append(keep)
    if masks[0].equal(masks[1]) or int(state.step) != 2:
        raise AssertionError("two replays of the graphed train step drew the same "
                             f"dropout mask (counter {int(state.step)})")
    n = 1 << 22
    big = keep_mask((n,), DROP_OUT, SEED, torch.tensor(7, device=device), 0)
    if not big.cpu().equal(keep_mask((n,), DROP_OUT, SEED, 7, 0)):
        raise AssertionError("the dropout mask on the card differs from the CPU's")
    kept = int(big.sum()) + sum(int(m.sum()) for m in masks)
    total = n + sum(m.numel() for m in masks)
    if not five_sigma(kept, total, 1 - DROP_OUT):
        raise AssertionError(f"dropout kept {kept} of {total} at p {DROP_OUT}")
    agree = int((masks[0] == masks[1]).sum())
    return dict(kept_share=kept / total, replay_mask_agreement=agree / masks[0].numel(),
                elements=total)


def run_dropout(work_dir: str, weights: str, device) -> dict:
    """Phase 15, dropout: gcn.yaml's CTR-GCN (full width, batch 16) with
    drop_out DROP_OUT; one train epoch through `__main__.main` (K1-K3 10 per
    step and warm-up call, K1 10 per eval batch), two graph replays' masks
    (check_dropout_replays), the graphed train step against the eager one
    over TRAJ_STEPS steps and a run resumed at step RESUME_AT against an
    unbroken one of DROPOUT_STEPS, both bit for bit with deterministic
    cuDNN."""
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    seconds, launches = run_cli(train_argv(os.path.join(work_dir, "train_dropout")) + [
        "--num_epoch", "1", "--model_args", f"drop_out={DROP_OUT}"])
    want = graphed("--phase train, drop_out", {
        "train": (steps, dict(K1=10, K2=10, K3=10)), "eval": (evals, dict(K1=10))})
    if launches != want:
        raise AssertionError(f"--phase train with drop_out {DROP_OUT}: launches {launches}, "
                             f"expected {want}")
    out = {"cli": dict(seconds=seconds, launches=launches)}
    out["replays"] = check_dropout_replays(weights, device)
    batches = train_batches(DROPOUT_STEPS, TRAIN_BATCH)
    with deterministic_cudnn():
        eager = dropout_run(weights, batches[:TRAJ_STEPS], device, False)
        graphed_ = dropout_run(weights, batches[:TRAJ_STEPS], device, True)
        unbroken = dropout_run(weights, batches, device, True)
        resumed = dropout_run(weights, batches, device, True, resume_at=RESUME_AT,
                              checkpoints=os.path.join(work_dir, "dropout_checkpoints"))
    out["graphed_vs_eager"] = differences(graphed_, eager)
    out["resumed_vs_unbroken"] = differences(resumed, unbroken)
    if out["graphed_vs_eager"] or out["resumed_vs_unbroken"]:
        raise AssertionError(f"dropout: graphed vs eager {out['graphed_vs_eager']}, "
                             f"resumed vs unbroken {out['resumed_vs_unbroken']}")
    if not all(a.equal(b) for a, b in zip(unbroken[0], graphed_[0])):
        raise AssertionError("dropout: the unbroken run's first steps differ from the "
                             "graphed run's")
    print(f"dropout, batch {TRAIN_BATCH}, drop_out {DROP_OUT}: graphed vs eager over "
          f"{TRAJ_STEPS} steps and resumed at step {RESUME_AT} vs unbroken over "
          f"{DROPOUT_STEPS} steps equal bit for bit (deterministic cuDNN); two replays' "
          f"masks agree in {out['replays']['replay_mask_agreement']:.4f} of the elements, "
          f"kept share {out['replays']['kept_share']:.5f}", flush=True)
    return out


def check_serving(got, want, what: str) -> float:
    """An artifact's logits against the live forward's: the shape, finite,
    within SERVE_RTOL * max |logit|; returns the max abs difference."""
    import numpy as np

    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: logits of shape {got.shape}, expected {want.shape}")
    err = float(np.abs(got - want).max())
    if err > SERVE_RTOL * float(np.abs(want).max()):
        raise AssertionError(f"{what}: max |d logits| {err:.3e} > {SERVE_RTOL} x "
                             f"{float(np.abs(want).max()):.3e}")
    return err


def run_serving(work_dir: str, weights: str, x, device) -> dict:
    """Phase 15, serving: phase 4's CTR-GCN exported at batch 64 by
    `python -m tamgcn_tpu_torch.tools.export_serving` in-process (its eval
    forward, held on the card and, moved, on the CPU; its --fast_eval
    engine; a --poly_batch artifact), each reloaded and run on phase 4's
    batch in a process that imports tamgcn_tpu_torch.ops alone
    (SERVE_SCRIPT): K1 10 launches a call (K5 10 with --fast_eval), logits
    against the live graphed eval and fast-eval forwards within SERVE_RTOL *
    max |logit|, the --poly_batch artifact also at SERVE_POLY_BATCH against
    the live model; the check must fail on the logits of the artifact
    whose unit op returns zeros. Prints and returns the artifacts' bytes,
    export seconds, ms a call and samples/s beside the graphed eval
    forward's ms, busy ms and kernels."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_eval_step, make_fast_eval_step
    from tamgcn_tpu_torch.serving import entry
    from tamgcn_tpu_torch.tools import export_serving
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.graphs import GraphedStep

    serve = os.path.join(work_dir, "serve")
    os.makedirs(serve, exist_ok=True)
    np.save(os.path.join(serve, "x.npy"), x)
    records = {}
    for name, extra in (("model", ["--platforms", "cuda,cpu"]), ("fast", ["--fast_eval"]),
                        ("poly", ["--poly_batch"])):
        records[name] = export_serving.run([
            "--out", os.path.join(serve, f"{name}.pt2"), "--weights", weights,
            "--batch", str(BATCH), *extra, "-c", GCN_YAML])
        print(f"serving export ({name}): {json.dumps(records[name])}", flush=True)
    done = subprocess.run(
        [sys.executable, "-c", SERVE_SCRIPT, serve, str(SERVE_TIMED), str(SERVE_POLY_BATCH)],
        capture_output=True, text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    if done.returncode:
        raise AssertionError(f"the serving process failed:\n{done.stderr[-4000:]}")
    served = json.loads(done.stdout.strip().splitlines()[-1])
    extra_modules = [m for m in served["modules"] if m != "tamgcn_tpu_torch"
                     and not m.startswith("tamgcn_tpu_torch.ops")]
    if extra_modules:
        raise AssertionError(f"the serving process imported {extra_modules}")
    for name, want in (("model", dict(K1=10, K1t=0, K5=0)), ("fast", dict(K1=0, K1t=0, K5=10)),
                       ("poly", dict(K1=10, K1t=0, K5=0))):
        if served[name]["launches"] != want:
            raise AssertionError(f"the {name} artifact launched {served[name]['launches']} "
                                 f"a call, expected {want}")

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    yb = torch.arange(len(x), device=device) % 10
    with torch.inference_mode():
        graphs = {"eval": GraphedStep(make_eval_step(model), "eval"),
                  "fast_eval": GraphedStep(make_fast_eval_step(model), "fast_eval")}
        live = {k: g(xb, yb)[1].cpu().numpy() for k, g in graphs.items()}
        small = model(xb[:SERVE_POLY_BATCH]).cpu().numpy()
        eval_ms = cuda_ms(lambda: graphs["eval"](xb, yb))
        fast_ms = cuda_ms(lambda: graphs["fast_eval"](xb, yb))
        eval_busy, eval_kernels, _ = profile_device(lambda: graphs["eval"](xb, yb))
        fn, args = entry()
        reset_launches()
        logits = fn(*args)
        if logits.shape != (8, 10) or not bool(torch.isfinite(logits).all()) or (
                read_launches() != only(K1=10)):
            raise AssertionError(f"serving.entry: logits {tuple(logits.shape)}, launches "
                                 f"{read_launches()}")

    def served_logits(name):
        return np.load(os.path.join(serve, f"{name}_logits.npy"))

    errors = {"model": check_serving(served_logits("model"), live["eval"], "the artifact"),
              "fast": check_serving(served_logits("fast"), live["fast_eval"],
                                    "the --fast_eval artifact"),
              "poly": check_serving(served_logits("poly"), live["eval"],
                                    "the --poly_batch artifact"),
              "poly_small": check_serving(served_logits("poly_small"), small,
                                          f"the --poly_batch artifact at {SERVE_POLY_BATCH}")}
    try:
        check_serving(served_logits("fault"), live["eval"], "the artifact, K1 zeroed")
    except AssertionError as e:
        print(f"serving: the planted fault (the unit op's CUDA implementation returns "
              f"zeros) fails the check, as it must: {e}", flush=True)
    else:
        raise AssertionError("the artifact's check passed with its unit op zeroed")
    card = card_line()
    for name, label in (("model", "eval forward"), ("fast", "--fast_eval"),
                        ("poly", "--poly_batch")):
        r, s = records[name], served[name]
        print(f"serving artifact ({label}), batch {BATCH}: {r['bytes']} bytes, exported in "
              f"{r['export_seconds']:.2f} s; {s['ms']:.3f} ms a call "
              f"({BATCH / s['ms'] * 1e3:.1f} samples/s), device busy {s['busy_ms']:.3f} ms "
              f"in {s['kernels']} kernels, launches {s['launches']}; logits vs the live "
              f"forward max |d| {errors[name]:.3e} [{card}]", flush=True)
    print(f"serving: the graphed eval forward in this run {eval_ms:.3f} ms a batch of "
          f"{BATCH} ({BATCH / eval_ms * 1e3:.1f} samples/s), device busy {eval_busy:.3f} ms "
          f"in {eval_kernels} kernels; the graphed fast-eval forward {fast_ms:.3f} ms "
          f"[{card}]", flush=True)
    return dict(records=records, served=served, errors=errors, eval_ms=eval_ms,
                fast_eval_ms=fast_ms, eval_busy_ms=eval_busy)


def run_phase15(work_dir: str, weights: str, x, device) -> dict:
    """Phase 15: seeded dropout in training (run_dropout) and the serving
    export (run_serving)."""
    out = {"dropout": run_dropout(work_dir, weights, device)}
    print(f"phase 15: dropout {json.dumps(out['dropout'])} [{card_line()}]", flush=True)
    phase("15. serving")
    out["serving"] = run_serving(work_dir, weights, x, device)
    return out


PARALLEL_RANKS = 2  # two gloo ranks share the one card (NCCL refuses that)
# per rank and train step: each of ten blocks rings its unit op over 2 ranks
RING_LAUNCHES = 20
# the one-step modes held to their own single-rank f64 run (grid_references);
# the time-sharded ST-GCN and fusion model to their model's (SP_MODES: the
# mode whose single-rank run they share)
ONE_STEP_MODES = ("scene_ring", "stgcn_ring", "fusion_tp", "stgcn_sp", "fusion_sp")
SP_MODES = {"stgcn_sp": "stgcn_ring", "fusion_sp": "fusion_tp"}
# the planted faults of phase 16: name -> (the mode it runs in, what it plants)
GRID_FAULTS = {
    "ring_skip_block": ("ring", "the ring with its second block skipped on every rank"),
    "ring_x2_unsummed": ("ring", "the ring with x2's gradient unsummed (each rank keeps "
                                 "the part its own rows make)"),
    "scene_K2t_zeroed": ("scene_ring", "scene256's ring with K2t's dx3s zeroed"),
    "scene_K3_zeroed": ("scene_ring", "scene256's ring with K3's dw4s zeroed"),
    # sequence parallelism, "<mode>_<sp_fault's name>"
    # (tests/_torch_dist_worker.py:sp_fault): the halo frames zeroed, and
    # the time-sharded gradient shares averaged instead of summed; the
    # fusion model's CTR-GCN is frozen (no gradient shares), so there the
    # replicated gradients are summed instead of averaged
    "sp_halo_zeroed": ("sp", "SP with every halo frame zeroed"),
    "stgcn_sp_halo_zeroed": ("stgcn_sp", "ST-GCN's SP with every halo frame zeroed"),
    "fusion_sp_halo_zeroed": ("fusion_sp", "the fusion SP with every halo frame zeroed"),
    "sp_shares_averaged": ("sp", "SP with the time-sharded gradient shares averaged"),
    "stgcn_sp_shares_averaged": ("stgcn_sp", "ST-GCN's SP with the time-sharded gradient "
                                             "shares averaged"),
    "fusion_sp_replicated_summed": ("fusion_sp", "the fusion SP with the replicated "
                                                 "gradients summed"),
}


def _sp_fault(name: str) -> bool:
    """Whether GRID_FAULTS[name] runs in a sequence-parallel mode."""
    mode = GRID_FAULTS[name][0]
    return mode == "sp" or mode in SP_MODES


def grid_fault(name: str):
    """The patch that plants GRID_FAULTS[name] in this process."""
    from unittest import mock

    from tamgcn_tpu_torch.ops.cuda import ctr_gc
    from tamgcn_tpu_torch.parallel import graph_parallel

    if _sp_fault(name):  # the CPU tests' plant, imported by its path
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from _torch_dist_worker import sp_fault

        return sp_fault(name.removeprefix(GRID_FAULTS[name][0] + "_"))
    if name == "ring_skip_block":
        real, calls = graph_parallel.unit_ctr_gc, [0]

        def skipping(*args):
            calls[0] += 1
            out = real(*args)
            return out * 0 if calls[0] % 2 == 0 else out  # the second of each k = 2 ring

        return mock.patch.object(graph_parallel, "unit_ctr_gc", skipping)
    if name == "ring_x2_unsummed":
        enter = graph_parallel._replicated_inputs

        def unsummed(group, *tensors):
            out = enter(group, *tensors)
            if len(tensors) == 6:  # ring_unit_ctr_gc: x1, x2, w4, b4, alpha, A
                out[1] = tensors[1]
            return out

        return mock.patch.object(graph_parallel, "_replicated_inputs", unsummed)
    if name == "scene_K2t_zeroed":
        real_dx3 = ctr_gc.unit_ctr_gc_bwd_dx3
        return mock.patch.object(ctr_gc, "unit_ctr_gc_bwd_dx3",
                                 lambda *args: real_dx3(*args).zero_())
    real_param = ctr_gc.unit_ctr_gc_bwd_param
    return mock.patch.object(ctr_gc, "unit_ctr_gc_bwd_param", lambda *args: tuple(
        t.zero_() if part == "dw4s" else t
        for part, t in zip(K3_OUTPUTS, real_param(*args))))


def phase16_rank(mesh_rank: int = 0, world: int = 1, *, plan: dict, device: str) -> dict:
    """One rank of phase 16 (run by parallel/launch.py:run_ranks): the dry
    run's modes and unit-op check (serving.py:_dryrun_rank), then the first
    step of each planted fault's mode with the fault in place; the seconds
    of each under "seconds"."""
    from tamgcn_tpu_torch.parallel.drive import train_on_grid
    from tamgcn_tpu_torch.serving import _dryrun_rank

    t0 = time.perf_counter()
    out = _dryrun_rank(mesh_rank, world, plan=plan, device=device)
    seconds = {"dry run": time.perf_counter() - t0}
    for name, (mode, _) in GRID_FAULTS.items():
        spec = dict(plan["modes"][mode], profile=False)
        spec["batches"] = spec["batches"][:1]
        t0 = time.perf_counter()
        with grid_fault(name):
            out[name] = train_on_grid(mesh_rank, world, device=device, **spec)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _as_trajectory(record, steps=None):
    """(losses, states as f64) of a train_on_grid record, its first
    `steps` steps."""
    losses = record["losses"][:steps]
    states = [{k: v.double() for k, v in st.items()}
              for st in record["states"][:None if steps is None else steps + 1]]
    return losses, states


def _with_grads(record):
    """The first step of a train_on_grid record as a trajectory whose state
    after the step also holds each parameter's reduced gradient ("grad
    <name>", 0 before the step)."""
    import torch

    losses, (before, after) = _as_trajectory(record, 1)
    grads = {f"grad {k}": v.double() for k, v in record["grads"].items()}
    return losses, [before | {k: torch.zeros_like(v) for k, v in grads.items()},
                    after | grads]


def _first(ref, limits, steps):
    return ((ref[0][:steps], ref[1][:steps + 1]), (limits[0][:steps], limits[1][:steps]))


def _must_fail(what: str, ratios: dict) -> float:
    """Raises unless a tensor of `ratios` is beyond its limit; the worst
    ratio."""
    beyond = sorted((k for k, v in ratios.items() if v > 1), key=lambda k: -ratios[k])
    print(f"planted fault, {what}: {len(beyond)} of {len(ratios)} beyond their limit, "
          "worst " + ", ".join(f"{k} {ratios[k]:.3f}" for k in beyond[:3]), flush=True)
    if not beyond:
        raise AssertionError(f"the check passed with {what}")
    return ratios[beyond[0]]


def grid_references(plan: dict, device) -> dict:
    """{mode: (reference, limits)} of each one-step mode of ONE_STEP_MODES:
    its model's single-rank step on `device` with the plain unit op (the
    model's math without its kernels, TF32 off) in f64, the reference, and
    in f32, whose distance from it sets the limits (trajectory_limits, the
    gradients among the tensors). The time-sharded modes (SP_MODES) are held
    as phase 5 holds the CTR-GCN's SP step, by check_trajectory's limits:
    the f32 distances of the card's single-rank step and of the CPU's.
    Splitting a clip's frames sums each rank's half-clip share of a weight
    gradient before the shares cancel across the ranks, so the SP step's f32
    rounding is not the card's one order of the single-rank sums (PERF.md
    §6)."""
    import torch

    from tamgcn_tpu_torch.parallel.drive import train_on_grid
    from tamgcn_tpu_torch.serving import GRID_ARGS

    runs, out = {}, {}
    for mode in ONE_STEP_MODES:
        base = SP_MODES.get(mode, mode)
        spec = {k: v for k, v in plan["modes"][base].items() if k not in GRID_ARGS}
        spec["profile"] = False
        if base not in runs:
            with plain_unit_op():
                runs[base] = [_with_grads(train_on_grid(device=str(device), dtype=dtype, **spec))
                              for dtype in (torch.float64, torch.float32)]
        f64, f32 = runs[base]
        refs = [f32]
        if mode in SP_MODES:
            refs.append(_with_grads(train_on_grid(device="cpu", dtype=torch.float32, **spec)))
        out[mode] = f64, trajectory_limits(f64, refs)
    return out


def check_grid_trajectories(plan: dict, ranks: list, references, device):
    """Each grid mode of phase 16 on every rank against an f64 run by
    check_trajectory's rule (its limits: 10x the f32 references' distance
    plus floors), per tensor: DP, the ring, SP and TP after every step
    against phase 5's f64 CPU run; the one-step modes' state and reduced
    gradients against their own f64 run (grid_references). Every planted
    fault of GRID_FAULTS must leave its check on every rank. Returns
    ({mode: worst ratio}, {fault: [its worst ratio on each rank]})."""
    _, ref, _, limits = references
    own = grid_references(plan, device)

    def ratios(rec, mode):
        if mode in own:
            want, lims = own[mode]
            return trajectory_ratios(_with_grads(rec), want, lims)
        steps = len(rec["losses"])
        want, lims = _first(ref, limits, steps)
        return trajectory_ratios(_as_trajectory(rec), want, lims)

    worst = {}
    for mode in ("dp", "ring", "sp", "tp") + ONE_STEP_MODES:
        for r in ranks:
            got = ratios(r[mode], mode)
            top = max(got, key=got.get)
            worst[mode] = max(worst.get(mode, 0.0), got[top])
            if got[top] > 1:
                raise AssertionError(f"phase 16 {mode}, rank {r[mode]['rank']}: {top} "
                                     f"{got[top]:.3f} of its limit")
    faults = {name: [_must_fail(f"{what}, rank {r[name]['rank']}", ratios(r[name], mode))
                      for r in ranks]
              for name, (mode, what) in GRID_FAULTS.items()}
    return worst, faults


def check_ranks_agree(ranks: list) -> dict:
    """Every parameter bit for bit the same on every rank after every step
    of every mode (the gradient sum makes the replicated ones one over the
    grid, as JAX's one array is); returns {mode: the largest difference
    between the ranks of a buffer (the BatchNorm statistics, each rank's
    own forward), a share of its max}."""
    import torch

    out = {}
    for mode in ("dp", "ring", "sp", "tp") + ONE_STEP_MODES:
        names = ranks[0][mode]["grads"].keys()
        worst = 0.0
        for step, states in enumerate(zip(*(r[mode]["states"] for r in ranks))):
            first = states[0]
            for other in states[1:]:
                for k, v in first.items():
                    if k in names:
                        if not torch.equal(v, other[k]):
                            raise AssertionError(
                                f"phase 16 {mode}: {k} differs between ranks after step "
                                f"{step}: max |d| {(v - other[k]).abs().max().item():.3e}")
                    elif v.is_floating_point():
                        scale = max(v.abs().max().item(), 1e-30)
                        worst = max(worst, (v - other[k]).abs().max().item() / scale)
        out[mode] = worst
    return out


def check_grid_launches(ranks: list) -> dict:
    """The kernels each rank launched per mode: the ring's unit op through
    K1, K2 and K3 (whole-V at vb = 10) in every ring step, scene256's ring
    through K1t, K2t and K3 (vb = 128) and no whole-V kernel there."""
    names = {"K1": "launches", "K1t": "launches_tiled", "K2": "bwd_dx3_launches",
             "K2t": "bwd_dx3_tiled_launches", "K3": "bwd_param_launches"}

    def count(rec):
        return {k: rec["launches"].get(f"ctr_gc.{c}", 0) for k, c in names.items()}

    per_rank = []
    for r in ranks:
        steps = len(r["ring"]["losses"])
        want = {"dp": dict(K1=10 * steps, K2=10 * steps, K3=10 * steps, K1t=0, K2t=0),
                "ring": dict(K1=RING_LAUNCHES * steps, K2=RING_LAUNCHES * steps,
                             K3=RING_LAUNCHES * steps, K1t=0, K2t=0),
                "sp": dict(K1=10 * steps, K2=10 * steps, K3=10 * steps, K1t=0, K2t=0),
                "scene_ring": dict(K1t=RING_LAUNCHES, K2t=RING_LAUNCHES,
                                   K3=RING_LAUNCHES, K1=0, K2=0)}
        got = {mode: count(r[mode]) for mode in want}
        for mode, counts in want.items():
            if got[mode] != counts:
                raise AssertionError(f"phase 16 {mode}, rank {r['dp']['rank']}: launches "
                                     f"{got[mode]}, expected {counts}")
        per_rank.append(got)
    return {"per_rank": per_rank}


# the 2-rank CLI's learning rate: at smoke.yaml's 0.05 its f32 check
# measures conditioning, not the ring (grid_cli_f64 holds the ring to one
# process in f64 at both rates; PERF.md)
GRID_CLI_LR = 0.001
GRID_F64_SAMPLES = 32  # run_grid_cli's train and test split sizes, batch 16


def grid_f64_rank(mesh_rank: int = 0, world: int = 1, *, weights: dict, batches,
                  test_x, lr: float, model_args: dict) -> dict:
    """One rank of grid_cli_f64 (with world 1, the one dense process): SGD
    steps of the CTR-GCN of `model_args` on `batches` in f64 on the
    CPU, over the joint ring with the split head on a (1, world) grid, at
    `lr`, then the eval forward of `test_x`: {"losses", "scores", "state"
    (full tensors)}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.parallel.mesh import make_mesh
    from tamgcn_tpu_torch.parallel.sharded import GradientSum, full_state_dict, parallelize
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // max(world, 2)))
    mesh = make_mesh(1, world)
    net = get_model("ctrgcn", **model_args).double()
    net.load_state_dict({k: v.double() if v.is_floating_point() else v
                         for k, v in weights.items()})
    parallelize(net, mesh, "ring" if world > 1 else "none")
    net.train()
    state = PackedTrainState(net, "SGD", nesterov=True, weight_decay=1e-4,
                             mesh=mesh if world > 1 else None)
    if world > 1:
        state.reduce = GradientSum(state, mesh, False)
    step = make_fused_train_step(state)
    state.set_lr(lr)
    losses = [float(step(torch.from_numpy(x).double(), torch.from_numpy(y).long())[0])
              for x, y in batches]
    net.eval()
    with torch.no_grad():
        scores = net(torch.from_numpy(test_x).double())
    return {"losses": losses, "scores": scores,
            "state": {k: v.detach().clone() for k, v in full_state_dict(net).items()}}


def grid_cli_f64(lrs=(GRID_CLI_LR, 0.05), model_args=None) -> dict:
    """run_grid_cli's comparison in f64 on the CPU, through the packed step
    (the CLI computes in f32 or bf16 only), at gcn.yaml's widths unless
    `model_args` says otherwise: make_weights' calibrated
    weights, two SGD steps at batch 16 over the joint ring on two gloo
    ranks (--graph_partition ring --model_parallel 2) at each lr, then the
    ring's eval scores of GRID_F64_SAMPLES val clips against one dense
    process's on the ring's final weights (the CLI's check), and the
    ring's trajectory against one dense process's (losses; each tensor's
    max |ring - dense| over its max, but BN_FED_BIASES' and the running
    means, which move by rounding noise alone). Agreement within 1e-9 of max |score|
    at 0.05 says the f32 CLI's 9.5e-4 there is conditioning; a larger gap
    is a fault of the port. Prints one JSON line; run it alone:
    `python3 -c 'import chip_smoke; chip_smoke.grid_cli_f64()'`."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.parallel.launch import run_ranks
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model_args = model_args or nucla_model_args()
    with tempfile.TemporaryDirectory(prefix="grid_f64_") as tmp:
        path = os.path.join(tmp, "weights.pt")
        make_weights(path, seed=7, model_args=model_args)
        weights = load_weights(path)
    train = SyntheticSkeletonFeeder(num_samples=GRID_F64_SAMPLES, split="train", seed=SEED)
    val = SyntheticSkeletonFeeder(num_samples=GRID_F64_SAMPLES, split="val", seed=SEED)
    batches = [(np.stack([train[i][0] for i in range(b, b + 16)]),
                np.asarray([train[i][1] for i in range(b, b + 16)]))
               for b in range(0, GRID_F64_SAMPLES, 16)]
    test_x = np.stack([val[i][0] for i in range(GRID_F64_SAMPLES)])
    out = {}
    for lr in lrs:
        t0 = time.perf_counter()
        args = dict(weights=weights, batches=batches, test_x=test_x, lr=lr,
                    model_args=model_args)
        ring = run_ranks("chip_smoke:grid_f64_rank", PARALLEL_RANKS, args, timeout=1500)
        one = grid_f64_rank(**args)
        dense = get_model("ctrgcn", **model_args).double()
        dense.load_state_dict(ring[0]["state"])
        with torch.no_grad():
            on_ring = dense.eval()(torch.from_numpy(test_x).double())
        top = ring[0]["scores"].abs().max().item()
        # the biases that feed a train-mode BatchNorm move by rounding noise
        # alone (their gradient is zero in exact arithmetic), and the running
        # means of those BatchNorms with them: left out
        trajectory = max(((v - one["state"][k]).abs().max() / one["state"][k].abs().max()
                          .clamp_min(1e-300)).item()
                         for k, v in ring[0]["state"].items()
                         if v.is_floating_point() and not k.endswith(BN_FED_BIASES)
                         and not k.endswith("running_mean"))
        out[str(lr)] = dict(
            score_err=max((r["scores"] - on_ring).abs().max().item() for r in ring) / top,
            max_score=top, ring_losses=ring[0]["losses"], one_losses=one["losses"],
            trajectory_err=trajectory, seconds=time.perf_counter() - t0)
    print("grid CLI comparison in f64 (CPU, 2 gloo ranks): " + json.dumps(out), flush=True)
    return out


def run_grid_cli(work_dir: str, weights: str, lr: float = GRID_CLI_LR, device: str = "cuda"):
    """`python -m torch.distributed.run --nproc_per_node 2 -m tamgcn_tpu_torch
    recognition` at gcn.yaml's widths (base_channel 64, T = 52, batch 16;
    synthetic clips) with --graph_partition ring --model_parallel 2 on the
    one card (--device 0 0: gloo): one short train epoch, whose closing eval
    on the two ranks writes its scores with its best checkpoint; one
    process's --phase test on that checkpoint gives the same scores within
    1e-5 x max |score|. TF32 is off on both sides (this process's switches;
    NVIDIA_TF32_OVERRIDE=0 in the ranks' environment): a TF32 rounding turns
    the ring's other sum order into differences of 2^-11 of a value. With
    device="cpu" the ranks and the one process run on the CPU."""
    import pickle

    import numpy as np

    from tamgcn_tpu_torch.__main__ import main
    from tamgcn_tpu_torch.parallel.launch import free_port, run_command

    common = ["-c", os.path.join(REPO, "configs", "nucla", "smoke.yaml"),
              "--train_feeder_args", "num_samples=32", "--test_feeder_args", "num_samples=32",
              "--num_epoch", "1", "--num_worker", "2", "--print_log", "false",
              "--base_lr", str(lr)] + (["--use_gpu", "false"] if device == "cpu" else [])
    train_dir, one_dir = (os.path.join(work_dir, d) for d in ("grid_train", "grid_one"))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(PARALLEL_RANKS), "--master_port", str(free_port()), "-m", "tamgcn_tpu_torch",
           "recognition", *common, "--graph_partition", "ring", "--model_parallel", "2",
           "--distributed", "true", *(["--device", "0", "0"] if device != "cpu" else []),
           "--work_dir", train_dir, "--weights", weights]
    rc, err = run_command(cmd, timeout=300, env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    if rc:
        raise AssertionError(f"{' '.join(cmd[3:])} failed ({rc}):\n{err[-4000:]}")
    seconds = time.perf_counter() - t0
    scores = os.path.join(train_dir, "test_result_epoch1.pkl")
    if not os.path.exists(scores):
        raise AssertionError("the 2-rank epoch's eval scored no hit: no best checkpoint "
                             "and no scores to compare")
    if main(["recognition", *common, "--work_dir", one_dir, "--phase", "test", "--weights",
             os.path.join(train_dir, "checkpoints", "best.pt"), "--save_result", "true"]):
        raise AssertionError("one process's test phase failed")
    with open(scores, "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(one_dir, "test_result.pkl"), "rb") as f:
        got = pickle.load(f)
    top = max(float(np.abs(v).max()) for v in want.values())
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"grid CLI (ring, model_parallel 2, 2 ranks on {device}, lr {lr}): train epoch "
          f"and its eval in {seconds:.1f} s; one process's scores on its checkpoint within "
          f"{err / top:.2e} of max |score| {top:.3e}", flush=True)
    if sorted(got) != sorted(want) or err > 1e-5 * top:
        raise AssertionError(f"one process's scores on the grid's checkpoint: max err "
                             f"{err:.3e} of max |score| {top:.3e}")
    return {"seconds": seconds, "score_err": err / top}


def debug_nans_rank(mesh_rank: int = 0, world: int = 1, *, argv) -> str | None:
    """One rank of run_grid_debug_nans: the CPU test's rank function,
    tests/_torch_dist_worker.py:debug_nans_cli (the CLI with a NaN planted
    in the last frame of every synthetic clip; the FloatingPointError's
    message), imported by its path: a package named `tests` elsewhere on
    the path would shadow the repository's."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_dist_worker import debug_nans_cli

    return debug_nans_cli(mesh_rank, world, argv=argv)


def run_grid_debug_nans(work_dir: str) -> dict:
    """`--debug_nans true` on two gloo ranks sharing the card
    (--sequence_parallel, --model_parallel 2, gcn.yaml's widths) with a NaN
    planted in the last frame of every clip, the second rank's frames
    alone (debug_nans_rank): both ranks must raise FloatingPointError
    naming the same module, within the launch's timeout (a rank that
    raised alone would leave the other in a collective)."""
    from tamgcn_tpu_torch.parallel.launch import run_ranks

    argv = ["recognition", "-c", os.path.join(REPO, "configs", "nucla", "smoke.yaml"),
            "--work_dir", os.path.join(work_dir, "grid_nans"), "--device", "0",
            "--model_args", "base_channel=64", "--model_parallel", "2",
            "--sequence_parallel", "true", "--debug_nans", "true", "--num_epoch", "1",
            "--train_feeder_args", "num_samples=32", "--num_worker", "2",
            "--print_log", "false"]
    t0 = time.perf_counter()
    messages = run_ranks("chip_smoke:debug_nans_rank", PARALLEL_RANKS, {"argv": argv},
                         timeout=300)
    seconds = time.perf_counter() - t0
    if any(m is None for m in messages) or len(set(messages)) != 1 \
            or "non-finite value in the output of module" not in messages[0]:
        raise AssertionError(f"--debug_nans on two ranks: {messages}")
    print(f"--debug_nans on 2 ranks (SP, NaN in rank 1's frames): both raised in "
          f"{seconds:.1f} s: {messages[0]}", flush=True)
    return {"seconds": seconds, "message": messages[0]}


def run_phase16(work_dir: str, weights: str, references, device,
                scene_dense_ms: float | None = None) -> dict:
    """Phase 16: the parallel layer on two gloo ranks sharing the card: the
    dry run of serving.py (dryrun_plan(2, full=True) with phase 5's weights
    and batches: DP, the joint ring at k = 2 for 3 steps, TP of the head for
    one, SP for 3, the ring at scene256, ST-GCN's and the fusion model's TP
    for one; the ring's unit op and its VJP against the dense plain op per
    block shape of both CTR-GCNs) in one launch whose ranks also run the
    planted faults (phase16_rank: the rings' four and the SP modes' six),
    held by serving.verify_dryrun; every mode's state and gradients held to
    an f64 run, every fault made to fail on every rank, the launch counts
    per rank (check_grid_trajectories, check_grid_launches); then the CLI on two ranks (run_grid_cli). Two
    ranks on one card are not a scaling figure: their times show the
    collectives' cost, beside `scene_dense_ms`, phase 12's graphed scene256
    step on one rank."""
    from tamgcn_tpu_torch.parallel.launch import run_ranks
    from tamgcn_tpu_torch.serving import dryrun_plan, verify_dryrun
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    t0 = time.perf_counter()
    plan = dryrun_plan(PARALLEL_RANKS, full=True, weights=load_weights(weights),
                       batches=references[0])
    ranks = run_ranks("chip_smoke:phase16_rank", PARALLEL_RANKS,
                      {"plan": plan, "device": "cuda"}, timeout=600)
    launch_s = time.perf_counter() - t0
    verify_dryrun(plan, ranks, "cuda")
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst, faults = check_grid_trajectories(plan, ranks, references, device)
    buffers = check_ranks_agree(ranks)
    launches = check_grid_launches(ranks)
    checks_s = time.perf_counter() - t0
    card = card_line()
    for r in ranks:
        for mode in ("dp", "ring", "sp", "tp") + ONE_STEP_MODES:
            rec = r[mode]
            busy = ("not measured" if rec["busy_ms"] is None
                    else f"{rec['busy_ms']:.3f} ms in kernels, {rec['copy_ms']:.3f} ms "
                         "in copies")
            print(f"rank {rec['rank']} {mode}: losses {rec['losses']}, step wall "
                  f"{', '.join(f'{ms:.1f}' for ms in rec['step_ms'])} ms, last step's "
                  f"device busy {busy} [{card}]", flush=True)
    unit = {part: max(e[part] for r in ranks for e in r["unit_errors"])
            for part in ranks[0]["unit_errors"][0]}
    scene = ranks[0]["scene_ring"]
    print(f"scene256 ring train step (2 ranks on one card, gloo): wall "
          f"{[round(r['scene_ring']['step_ms'][-1], 1) for r in ranks]} ms, kernels "
          f"{[r['scene_ring']['busy_ms'] for r in ranks]} ms and copies "
          f"{[r['scene_ring']['copy_ms'] for r in ranks]} ms of device time per "
          f"rank (the two ranks' kernels time-share the card), beside the "
          f"dense graphed step's "
          f"{'(phase 12 not run)' if scene_dense_ms is None else f'{scene_dense_ms:.3f} ms'}"
          f" in phase 12; not a scaling figure [{card}]", flush=True)
    print(f"phase 16 dry run: {seconds:.1f} s, trajectories' worst share of their limit "
          f"{json.dumps(worst)}; the ring unit op against the dense plain op at "
          f"{len(plan['unit_shapes'])} block shapes, worst share of max |plain| per part "
          f"{json.dumps(unit)}; every parameter the same on both ranks after every "
          f"step, the buffers' largest difference between them as a share of their max "
          f"{json.dumps(buffers)}", flush=True)
    print("phase 16 planted faults, each one's worst ratio to its limit on each rank: "
          + json.dumps(faults), flush=True)
    in_rank = {k: max(r["seconds"][k] for r in ranks) for k in ranks[0]["seconds"]}
    split = {"launch of the two ranks": launch_s,
             "in the ranks: the dry run's modes and unit op": in_rank.pop("dry run"),
             "in the ranks: the four ring faults": sum(
                 v for k, v in in_rank.items() if not _sp_fault(k)),
             "in the ranks: the six SP faults": sum(
                 v for k, v in in_rank.items() if _sp_fault(k)),
             "the dry run's checks (verify_dryrun)": seconds - launch_s,
             "the trajectories' checks (their references included), ranks and launches":
                 checks_s}
    print(f"phase 16 seconds: {json.dumps(split)}; each fault in the ranks "
          f"{json.dumps(in_rank)} [{card}]", flush=True)
    cli = run_grid_cli(work_dir, weights)
    nans = run_grid_debug_nans(work_dir)
    return {"ranks": ranks, "launches": launches, "worst": worst, "faults": faults,
            "cli": cli, "nans": nans, "unit_errors": unit, "buffers": buffers,
            "dry_seconds": seconds, "seconds": split,
            "scene_step_ms": scene["step_ms"][-1]}


def kernel_summary(rows, per):
    """Sum of each timing over the launches of one forward / step."""
    used = [r for r in rows if r["launches_per_step"]]

    def total(key):
        return sum(r[key] * r["launches_per_step"] for r in used)

    bound_ms = total("bound_ms")
    ops_ms = sum(r["bound_ms"] * r["launches_per_step"] for r in used
                 if r["bound_by"] == "operations")
    return dict(ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bound_ms / 2 else "bytes",
                per=per)


_START = time.perf_counter()


def phase(name: str):
    print(f"== phase {name} at {time.perf_counter() - _START:.1f} s", flush=True)


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tamgcn_tpu_torch.ops.cuda import build

    device = torch.device("cuda", 0)
    TRAINER_TF32.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                        cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}",
          flush=True)

    # ---- 3. kernels against their plain versions ----
    phase("3. kernels")
    rows = check_kernels(device)
    print("library_ms: none for K1, K2, K3 (no single PyTorch call computes "
          "the unit op or its gradients)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        weights = os.path.join(work_dir, "weights.pt")
        make_weights(weights, seed=7)

        # ---- 4. test main path ----
        phase("4. test main path")
        test_dir = os.path.join(work_dir, "test")
        seconds, launches = run_test_path(test_dir, weights)
        batches = math.ceil(N_SAMPLES / BATCH)
        if launches != graphed("--phase test", {"eval": (batches, dict(K1=10))}):
            raise AssertionError(
                f"the test phase launched {launches}, expected K1 10 x "
                f"{batches} batches and warm-up calls and no backward kernel")
        test_launches = launches["K1"]
        rel, x = check_logits(test_dir, weights)
        kernel_ms, plain_ms, busy_ms, n_kernels, events = time_eval(weights, x, device)
        eval32 = (kernel_ms, busy_ms, n_kernels)
        print(f"test path: {batches} batches of {BATCH} in {seconds:.2f} s (incl. "
              f"model build and data), K1 launches {test_launches}, logits vs "
              f"CPU plain path max rel err {rel:.3e}", flush=True)
        print(f"eval forward, batch {BATCH}: {kernel_ms:.3f} ms/batch "
              f"({BATCH / kernel_ms * 1e3:.1f} samples/s) with K1; {plain_ms:.3f} "
              f"ms/batch with the plain unit op", flush=True)
        print_profile("eval forward", kernel_ms, busy_ms, n_kernels, events)

        # ---- 5. train main path ----
        phase("5. train main path")
        train = run_train_path(os.path.join(work_dir, "train"))
        *_, references = check_trajectory(weights, device)
        t = time_train(weights, device)

        # ---- 6. fast eval ----
        phase("6. fast eval")
        k5_rows = check_k5(device)
        print("library_ms: none for K5 (no single PyTorch call computes the "
              "block)", flush=True)
        k5_bf16_rows = check_k5_bf16(device)
        print("library_ms: none for K5_bf16 (no single PyTorch call computes the "
              "block); the f32 form's device time on the same values is under "
              "f32_device_ms", flush=True)
        fast_dir = os.path.join(work_dir, "fast_eval")
        seconds, launches = run_test_path(fast_dir, weights, "--fast_eval", "true")
        if launches != graphed("--phase test --fast_eval true",
                               {"fast_eval": (batches, dict(K5=10))}):
            raise AssertionError(
                f"the fast-eval test phase launched {launches}, expected K5 10 x "
                f"{batches} batches and warm-up calls and no other kernel")
        fast_launches = launches["K5"]
        fast_rel, _ = check_logits(fast_dir, weights)
        print(f"fast-eval test path: {batches} batches of {BATCH} in {seconds:.2f} s "
              f"(incl. model build, folding and data), K5 launches {fast_launches}, "
              f"logits vs the unfused CPU model max rel err {fast_rel:.3e}", flush=True)
        fast = time_fast_eval(weights, x, device)
        for way, (ms, busy, n_kernels, events) in fast.items():
            print(f"forward, batch {BATCH}, {way}: {ms:.3f} ms/batch "
                  f"({BATCH / ms * 1e3:.1f} samples/s)", flush=True)
            print_profile(f"forward ({way})", ms, busy, n_kernels, events)

        # ---- 7. fused-conv3 training and CTRGC ----
        phase("7. fused-conv3 training and CTRGC")
        k6_rows = check_k6(device)
        print("library_ms: none for K6 (no single PyTorch call computes it); "
              "the unfused composition's time is under unfused_k2_cublas_ms",
              flush=True)
        fused_train = run_fused_train_path(os.path.join(work_dir, "train_fused"))
        with fuse_conv3():
            check_trajectory(weights, device, faulted="K6", references=references)
        tf = time_train_fused(weights, device)
        k4_rows, k4_launches = check_ctrgc(device)
        print("library_ms: none for K4 (no single PyTorch call computes it)",
              flush=True)

        # ---- 8. experiment kernels T1 and T2 ----
        phase("8. experiment kernels T1 and T2")
        t1_rows = check_t1(device)
        check_t1_real_weights(weights, x, device)
        t1_bf16_rows = check_t1_bf16(device)
        bf16_path = run_bf16_block_path(device)
        t2_rows = check_t2(device)
        tools = run_tools()

        # ---- 9. configs/scene256.yaml ----
        phase("9. scene256")
        scene = run_scene256(work_dir, device)

        # ---- 10. bf16 mixed precision ----
        phase("10. bf16")
        bf16 = run_bf16(work_dir, weights, x, device)

        # ---- 11. bf16 with TAMGCN_FUSE_CONV3=1 (K6-bf16), CTRGC in bf16 (K4-bf16) ----
        phase("11. bf16 with the switch, CTRGC in bf16")
        bf16_fused = run_bf16_fused(work_dir, weights, device, bf16["trajectory"][3])

        # ---- 12. the compiled steps: the trainer's steps as CUDA graphs ----
        phase("12. compiled steps")
        compiled = run_compiled_steps(work_dir, weights, x, device)

        # ---- 13. the rest of the NW-UCLA skeleton path ----
        phase("13. skeleton path")
        t13 = time.perf_counter()
        run_skeleton_path(work_dir, weights, device, compiled["times"][
            f"f32 train step, batch {TRAIN_BATCH}"]["graphed"]["wall_ms"])
        print(f"phase 13: {time.perf_counter() - t13:.1f} s [{card}]", flush=True)

        # ---- 14. NTU-60 two-person training, the RGB and cross-modal families ----
        phase("14. NTU-60, RGB, cross-modal")
        t14 = time.perf_counter()
        p14 = run_phase14(work_dir, weights, device)
        print(f"phase 14: {time.perf_counter() - t14:.1f} s [{card}]", flush=True)

        # ---- 15. seeded dropout in training, the serving export ----
        phase("15. dropout")
        t15 = time.perf_counter()
        p15 = run_phase15(work_dir, weights, x, device)
        print(f"phase 15: {time.perf_counter() - t15:.1f} s [{card}]", flush=True)

        # ---- 16. the parallel layer: two gloo ranks on the card ----
        phase("16. parallel")
        t16 = time.perf_counter()
        p16 = run_phase16(work_dir, weights, references, device, compiled["times"][
            f"scene256 train step, batch {SCENE_BATCH}"]["graphed"]["wall_ms"])
        print(f"phase 16: {time.perf_counter() - t16:.1f} s [{card}]", flush=True)
        phase("end")
    print("compiled steps (phase 12): " + json.dumps({
        path: {form: {k: r[k] for k in ("wall_ms", "busy_ms", "idle", "kernels",
                                         "host_launches")} for form, r in forms.items()}
        for path, forms in compiled["times"].items()}), flush=True)
    print(f"train step (forward, backward, SGD), batch {TRAIN_BATCH}: "
          f"{t['kernel_ms_16']:.3f} ms ({TRAIN_BATCH / t['kernel_ms_16'] * 1e3:.1f} "
          f"samples/s) with K1-K3; {t['plain_ms_16']:.3f} ms with the plain unit "
          f"op; batch 64: {t['kernel_ms_64']:.3f} ms "
          f"({64 / t['kernel_ms_64'] * 1e3:.1f} samples/s)", flush=True)
    for batch in (64, TRAIN_BATCH):
        events = t[f"events_{batch}"]
        print_profile(f"train step, batch {batch},", t[f"kernel_ms_{batch}"],
                      t[f"busy_ms_{batch}"], t[f"n_kernels_{batch}"], events)
    for kname, prefix in (("K1", "unit_ctr_gc_fwd_kernel"),
                          ("K2", "unit_ctr_gc_bwd_dx3_kernel"),
                          ("K3", "unit_ctr_gc_bwd_param")):
        ms = sum(e[1] for e in t["events_16"] if prefix in e[0])
        print(f"  {kname}: {ms:.4f} ms per train step at batch {TRAIN_BATCH}, "
              f"{100 * ms / t['busy_ms_16']:.1f}% of the device time", flush=True)
    for way in ("eval forward", "fast-eval forward", "train step"):
        ms, busy, _, events = scene[way]
        for kname in ("K1t", "K2t", "K3"):
            kms = sum(e[1] for e in events if is_kernel(kname, e[0]))
            if kms:
                print(f"  scene256 {way}: {kname} {kms:.4f} ms, {100 * kms / busy:.1f}% "
                      "of the device time", flush=True)
    f32_times = {f"eval forward, batch {BATCH}": eval32} | {
        f"train step, batch {b}": (t[f"kernel_ms_{b}"], t[f"busy_ms_{b}"],
                                   t[f"n_kernels_{b}"]) for b in (TRAIN_BATCH, 64)}
    for what, (ms, busy, n_kernels, events) in bf16["times"].items():
        ms32, busy32, n32 = f32_times[what]
        print(f"bf16 {what}: {ms:.3f} ms, device busy {busy:.3f} ms in {n_kernels} "
              f"launches; f32 in this run {ms32:.3f} ms, busy {busy32:.3f} ms in {n32} "
              "launches", flush=True)
        print_profile(f"bf16 {what},", ms, busy, n_kernels, events)
        for kname in ("K1_bf16", "K2_bf16", "K3_bf16"):
            kms = sum(e[1] for e in events if is_kernel(kname, e[0]))
            if kms:
                print(f"  {kname}: {kms:.4f} ms, {100 * kms / busy:.1f}% of the device "
                      "time", flush=True)
    for kname, f32_name, per in (("K1_bf16", "K1", f"eval forward, batch {BATCH}"),
                                 ("K2_bf16", "K2", f"train step, batch {TRAIN_BATCH}"),
                                 ("K3_bf16", "K3", f"train step, batch {TRAIN_BATCH}")):
        def path(rows, key):
            return sum(r[key] * r["launches_per_step"] for r in rows)

        b_rows, f_rows = bf16["kernels"][kname], rows[f32_name]
        print(f"{kname} per {per} (CUDA graph): {path(b_rows, 'device_ms'):.4f} ms "
              f"device, bound {path(b_rows, 'bound_ms'):.4f} ms; the f32 form "
              f"{path(f_rows, 'device_ms'):.4f} ms, bound {path(f_rows, 'bound_ms'):.4f} ms",
              flush=True)
    for label, times in (("", tf), ("bf16 ", bf16_fused["times"])):
        for batch, r in times.items():
            print(f"{label}train step, batch {batch}: {r['fused_ms']:.3f} ms with "
                  f"TAMGCN_FUSE_CONV3=1, {r['default_ms']:.3f} ms default (in turns)",
                  flush=True)
            print_profile(f"{label}train step with TAMGCN_FUSE_CONV3=1, batch {batch},",
                          r["fused_ms"], r["busy_ms"], r["n_kernels"], r["events"])
            for kname, prefix in (("K1", "unit_ctr_gc_fwd_kernel"),
                                  ("K2", "unit_ctr_gc_bwd_dx3_kernel"),
                                  ("K3", "unit_ctr_gc_bwd_param"),
                                  ("K6", "unit_ctr_gc_bwd_conv3")):
                ms = sum(e[1] for e in r["events"] if prefix in e[0])
                print(f"  {label}{kname}: {ms:.4f} ms per train step at batch {batch}, "
                      f"{100 * ms / r['busy_ms']:.1f}% of the device time", flush=True)

    sources = {"K1": ("unit_ctr_gc_fwd", "unit_ctr_gc_fwd.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:367",
                      test_launches, "eval forward, batch 64"),
               "K1t": ("unit_ctr_gc_fwd, joint-tiled design", "unit_ctr_gc_fwd.cu",
                       "tamgcn_tpu/ops/pallas/ctr_gc.py:367",
                       scene["test"]["launches"]["K1t"],
                       "eval forward, configs/scene256.yaml, batch 8"),
               "K2": ("unit_ctr_gc_bwd_dx3", "unit_ctr_gc_bwd_dx3.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:494",
                      train["train"]["launches"]["K2"], "train step, batch 16"),
               "K2t": ("unit_ctr_gc_bwd_dx3, joint-tiled design", "unit_ctr_gc_bwd_dx3.cu",
                       "tamgcn_tpu/ops/pallas/ctr_gc.py:494",
                       scene["train"]["launches"]["K2t"],
                       "train step, configs/scene256.yaml, batch 8"),
               "K3": ("unit_ctr_gc_bwd_param", "unit_ctr_gc_bwd_param.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:717",
                      train["train"]["launches"]["K3"], "train step, batch 16"),
               "K4": ("ctr_gc_fused", "unit_ctr_gc_fwd.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:83", k4_launches,
                      "CTRGC forward and backward, N=16, T=52, V=20, Cin=64, "
                      "C=128 (K1 and K2 at S=1)"),
               "K5": ("gcn_tcn_block", "gcn_tcn_block.cu",
                      "tamgcn_tpu/ops/pallas/gcn_tcn_block.py:52",
                      fast_launches, "fast-eval forward, batch 64"),
               "K6": ("unit_ctr_gc_bwd_conv3", "unit_ctr_gc_bwd_conv3.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:510",
                      fused_train["launches"]["K6"],
                      "train step, batch 16, TAMGCN_FUSE_CONV3=1"),
               "T1": ("ms_tcn", "ms_tcn.cu", "tools/exp_ms_tcn.py:44",
                      tools["exp_ms_tcn"][1]["T1"],
                      "one call at each of exp_ms_tcn's six shapes; one run of "
                      "the tool launches T1 equally often at each (no model path "
                      "runs T1)"),
               "T2": ("stage2_aggregate", "stage2_aggregate.cu",
                      "tools/exp_stage2.py:134", tools["exp_stage2"][1]["T2"],
                      "one call of each of exp_stage2's twelve T2 probes at "
                      "N=64, T=13, V=20, C=256, S=3, f32 (7 tile, win, 2 floor, "
                      "flat with and without the subset sum); one run of the "
                      "tool launches each probe equally often"),
               "K1_bf16": ("unit_ctr_gc_fwd_bf16", "unit_ctr_gc_fwd.cu",
                           "tamgcn_tpu/ops/pallas/ctr_gc.py:367",
                           bf16["test"]["launches"]["K1_bf16"],
                           "eval forward, batch 64, bf16 (--model_args dtype=bfloat16)"),
               "K2_bf16": ("unit_ctr_gc_bwd_dx3_bf16", "unit_ctr_gc_bwd_dx3.cu",
                           "tamgcn_tpu/ops/pallas/ctr_gc.py:494",
                           bf16["train"]["launches"]["K2_bf16"], "train step, batch 16, bf16"),
               "K3_bf16": ("unit_ctr_gc_bwd_param_bf16", "unit_ctr_gc_bwd_param_bf16.cu",
                           "tamgcn_tpu/ops/pallas/ctr_gc.py:717",
                           bf16["train"]["launches"]["K3_bf16"], "train step, batch 16, bf16"),
               "K6_bf16": ("unit_ctr_gc_bwd_conv3_bf16", "unit_ctr_gc_bwd_conv3.cu",
                           "tamgcn_tpu/ops/pallas/ctr_gc.py:510",
                           bf16_fused["train"]["launches"]["K6_bf16"],
                           "train step, batch 16, bf16, TAMGCN_FUSE_CONV3=1"),
               "K4_bf16": ("ctr_gc_fused_bf16", "ctr_gc_fused.cu",
                           "tamgcn_tpu/ops/pallas/ctr_gc.py:83", bf16_fused["k4_launches"],
                           "CTRGC(dtype=bfloat16) forward and backward, N=16, T=52, V=20, "
                           "Cin=64, C=128 (the forward and the transpose)"),
               "K5_bf16": ("gcn_tcn_block_bf16", "gcn_tcn_block.cu",
                           "tamgcn_tpu/ops/pallas/gcn_tcn_block.py:52",
                           bf16_path["launches"]["K5_bf16"],
                           "the ten blocks of a fast-eval forward at batch 64 on bf16 x, "
                           "through gcn_tcn_block_fused (the bf16 block path)"),
               "T1_bf16": ("ms_tcn_bf16", "ms_tcn.cu", "tools/exp_ms_tcn.py:44",
                           bf16_path["launches"]["T1_bf16"],
                           "one call at each of exp_ms_tcn's six shapes on a bf16 prefix; "
                           "launches: the bf16 block path's ten blocks through "
                           "ms_tcn_fused")}
    rows.update(K4=k4_rows, K5=k5_rows, K6=k6_rows, T1=t1_rows, T2=t2_rows, **bf16["kernels"],
                K6_bf16=bf16_fused["k6_rows"], K4_bf16=bf16_fused["k4_rows"],
                K5_bf16=k5_bf16_rows, T1_bf16=t1_bf16_rows)
    kernels = {}
    for kname, (name, source, replaces, count, per) in sources.items():
        kernels[kname] = {
            "name": name,
            "route": "cuda",
            "source": f"tamgcn_tpu_torch/csrc/{source}",
            "replaces": replaces,
            # launches on the main path's run (test phase for K1, the first
            # two train epochs for K2 and K3, scene256's test phase for K1t
            # and its train phase for K2t, the fused-conv3 epoch for K6,
            # the first CTRGC forward and backward for K4, the exp_ms_tcn
            # run for T1, the exp_stage2 run for T2, the bf16 test phase
            # for K1_bf16 and the bf16 train epoch for K2_bf16 and K3_bf16,
            # the bf16 train epoch with the switch for K6_bf16, the first
            # bf16 CTRGC forward and backward for K4_bf16)
            "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows[kname]),
            "library_ms": None,
            **kernel_summary(rows[kname], per),
            "shapes": rows[kname],
        }
    kernels["K4"]["sources"] = [f"tamgcn_tpu_torch/csrc/{f}" for f in (
        "unit_ctr_gc_fwd.cu", "unit_ctr_gc_bwd_dx3.cu")]
    for kname in ("K1t", "K2t"):
        kernels[kname]["sources"] = [kernels[kname]["source"],
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_tiled.cuh"]
    for kname in ("K1", "K2"):
        kernels[kname]["sources"] = [kernels[kname]["source"],
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh"]
    for kname in ("K1", "K1t", "K2", "K2t", "K3", "K1_bf16", "K2_bf16", "K3_bf16"):
        kernels[kname]["device_ms"] = sum(r["device_ms"] * r["launches_per_step"]
                                          for r in rows[kname])
    # K1 on the train path: its batch-16 shapes, summed per train step
    train_rows = [dict(r, path=f"train step, batch {TRAIN_BATCH}") for r in rows["K1_train"]]
    kernels["K1"]["per_train_step"] = dict(
        kernel_summary(train_rows, f"train step, batch {TRAIN_BATCH}"),
        device_ms=sum(r["device_ms"] * r["launches_per_step"] for r in train_rows),
        launches=train["train"]["launches"]["K1"])
    kernels["K1"]["shapes"] = rows["K1"] + train_rows
    kernels["K1"]["max_abs_err"] = max(r["max_abs_err"] for r in kernels["K1"]["shapes"])
    for kname in ("K1_bf16", "K2_bf16"):
        kernels[kname]["sources"] = [kernels[kname]["source"],
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_common.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_tiled.cuh"]
    kernels["K3_bf16"]["sources"] = [kernels["K3_bf16"]["source"],
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_param.cuh",
                                     "tamgcn_tpu_torch/csrc/mma_bf16.cuh",
                                     "tamgcn_tpu_torch/csrc/mma_tf32x3.cuh"]
    for key in ("folded_k1_cublas_ms", "folded_k1_cublas_device_ms", "device_ms"):
        kernels["K5"][key] = sum(r[key] * r["launches_per_step"] for r in k5_rows)
    kernels["K5"]["sources"] = [kernels["K5"]["source"],
                                "tamgcn_tpu_torch/csrc/mma_tf32x3.cuh",
                                "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh"]
    kernels["K6"]["sources"] = [kernels["K6"]["source"],
                                "tamgcn_tpu_torch/csrc/mma_tf32x3.cuh",
                                "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh"]
    for kname in ("K6", "K6_bf16"):
        for key in ("unfused_k2_cublas_ms", "unfused_k2_cublas_device_ms", "device_ms"):
            kernels[kname][key] = sum(r[key] * r["launches_per_step"] for r in rows[kname])
    kernels["K6_bf16"]["sources"] = [kernels["K6_bf16"]["source"],
                                     "tamgcn_tpu_torch/csrc/mma_bf16.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_tiled.cuh"]
    for kname in ("K4", "K4_bf16"):
        kernels[kname]["device_ms"] = sum(r["device_ms"] * r["launches_per_step"]
                                          for r in rows[kname])
    kernels["K4_bf16"]["sources"] = [kernels["K4_bf16"]["source"],
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_common.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh",
                                     "tamgcn_tpu_torch/csrc/unit_ctr_gc_tiled.cuh"]
    # T1's library call: the engine's cuDNN composition (T1_bf16's on the
    # widened prefix); T2's: one einsum
    for kname in ("T1", "T2", "T1_bf16"):
        for key in ("library_ms", "device_ms", "library_device_ms"):
            kernels[kname][key] = sum(r[key] * r["launches_per_step"] for r in rows[kname])
    # the bf16 forms beside their f32 forms on the same values, per path
    for kname in ("K5_bf16", "T1_bf16"):
        for key in ("device_ms", "f32_device_ms"):
            kernels[kname][key] = sum(r[key] * r["launches_per_step"] for r in rows[kname])
        kernels[kname]["share_equal"] = min(r["share_equal"] for r in rows[kname])
        kernels[kname]["sources"] = [kernels[kname]["source"],
                                     "tamgcn_tpu_torch/csrc/mma_bf16.cuh"]
    # K5_bf16's aggregation: K1's body, its products 3xTF32
    kernels["K5_bf16"]["sources"] += ["tamgcn_tpu_torch/csrc/unit_ctr_gc_whole.cuh",
                                      "tamgcn_tpu_torch/csrc/mma_tf32x3.cuh"]
    # phase 14's paths: NTU-60's train step (K1t, K2t, K3) and fast eval (K5),
    # the cross-modal train step and eval forward (K1)
    ntu = p14["ntu"]
    for kname, per, launched in (
            ("K1t", "train step, configs/ntu60.yaml, batch 128 (N*M = 256)", ntu["train"]),
            ("K2t", "train step, configs/ntu60.yaml, batch 128 (N*M = 256)", ntu["train"]),
            ("K3", "train step, configs/ntu60.yaml, batch 128 (N*M = 256)", ntu["train"]),
            ("K5", "fast-eval forward, configs/ntu60.yaml, batch 256 (N*M = 512)",
             ntu["fast_eval"])):
        ntu_rows = ntu["kernels"][kname]
        kernels[kname]["ntu60"] = dict(
            kernel_summary(ntu_rows, per),
            device_ms=sum(r["device_ms"] * r["launches_per_step"] for r in ntu_rows),
            launches=launched["launches"][kname], shapes=ntu_rows)
        kernels[kname]["max_abs_err"] = max(kernels[kname]["max_abs_err"],
                                            max(r["max_abs_err"] for r in ntu_rows))
    eval_rows = ntu["kernels"]["K1t_eval"]
    kernels["K1t"]["ntu60_eval"] = dict(
        kernel_summary(eval_rows, "eval forward, configs/ntu60.yaml, batch 256 (N*M = 512)"),
        device_ms=sum(r["device_ms"] * r["launches_per_step"] for r in eval_rows),
        launches=ntu["test"]["launches"]["K1t"], shapes=eval_rows)
    kernels["K1t"]["max_abs_err"] = max(kernels["K1t"]["max_abs_err"],
                                        max(r["max_abs_err"] for r in eval_rows))
    kernels["K1"]["cross_modal"] = dict(
        launches=p14["cross_modal"]["train"]["launches"]["K1"],
        per="recognition_cross_modal train epoch (3 steps at batch 16, their warm-up calls "
            "and one eval batch of 32)")
    served = p15["serving"]["served"]
    for kname, artifact, counter in (("K1", "model", "K1"), ("K5", "fast", "K5")):
        kernels[kname]["serving"] = dict(
            launches=served[artifact]["launches"][counter],
            per=f"one call of the {'--fast_eval ' if artifact == 'fast' else ''}serving "
                f"artifact at batch {BATCH} (tools/export_serving.py), in a process that "
                "imports tamgcn_tpu_torch.ops alone",
            artifact_ms=served[artifact]["ms"], artifact_busy_ms=served[artifact]["busy_ms"])
    ring_shapes = {"K1": "gcn.yaml CTR-GCN, batch 16: (N=16, T=52|26|13, V=vb=10, "
                         "C=64|128|256) per ring step",
                   "K2": "as K1", "K3": "as K1 (gcn.yaml) and scene256",
                   "K1t": "scene256, batch 8: (N=8, T=32|16|8, V=vb=128, C=64|128|256) "
                          "per ring step", "K2t": "as K1t"}
    for kname, mode in (("K1", "ring"), ("K2", "ring"), ("K3", "ring"),
                        ("K1t", "scene_ring"), ("K2t", "scene_ring")):
        kernels[kname]["parallel"] = dict(
            launches_per_rank=[r[mode][kname] for r in p16["launches"]["per_rank"]],
            per=f"{'3 train steps' if mode == 'ring' else 'one train step'} of the joint "
                f"ring over 2 gloo ranks on one card (--graph_partition ring, "
                f"{'gcn.yaml' if mode == 'ring' else 'configs/scene256.yaml'})",
            shapes=ring_shapes[kname])
    kernels["K3"]["parallel"]["scene256_launches_per_rank"] = [
        r["scene_ring"]["K3"] for r in p16["launches"]["per_rank"]]
    kernels["T2"]["replaces_also"] = [
        "tools/exp_stage2.py:64", "tools/exp_stage2.py:100", "tools/exp_stage2.py:174",
        "tools/exp_stage2b.py:37"]
    kernels = list(kernels.values())
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
