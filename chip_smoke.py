#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (serving, training, the tools) and check its kernels.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); the kernels built from
     signaltrain_tpu_torch/csrc/*.cu, one nvcc per source, all at once;
  2. each of the five kernels held against its plain PyTorch version on the
     card, on seeded random inputs with the tolerance stated: A, B, C at the
     serving shapes and at the training shapes (flagship geometry, batch
     200), D and E at the training shapes. A and D are checked on three
     seeds, A's first check straight after the build; A, B, D and E each on
     both of its float32 schedules (wgmma, the split-TF32 products of
     csrc/wgmma_product.cuh, which the rule picks at these shapes, and the
     mma.sync loop). A: every magnitude, the
     phase in two classes by the bin's magnitude (atan2 turns an error e of
     the spectrum into e / mag), and at the training batch its magnitude
     error against a float64 spectrum beside the plain version's (within 2 x
     it + 1e-7; the control, one TF32 product with no split, more than
     GAP_F32 times over). D with
     unit-normal phase cotangents (dphs / |spec| is ill-conditioned on bins of
     near-zero magnitude, so the kernel is held against a float64 plain
     version, with the slack each element's conditioning gives it; the
     control, the plain version on operands cut to TF32, more than GAP_F32
     times over) and with well-conditioned ones (every element
     of dxp and dW against the plain version), dW without dxp bit-equal to
     dW with it; A, B, D and E run twice on the
     same inputs and must be bit-equal; B (at both batches) and E are also
     held, as A is, to their largest error against a float64 plain version
     beside the plain f32 version's (within twice it plus 1e-6 *
     max|result|; the control, the plain version on operands cut to TF32,
     more than GAP_F32 times over); E's edge frames must be exact zeros. C
     is bit-equal to its plain version at every shape; its
     chunked schedule (a 30 s row) must be bit-equal to its row schedule on
     the serving path's gain curve, on randn and on a step to silence that
     never meets; the adversarial rows (cli/time_smoother.adversarial_rows:
     ties, +-0.0, subnormals, the alphas' extremes) by rows and chunked,
     and by rows from memory 4 bytes off a 16-byte boundary (the row scan's
     4-byte copies), bit-equal to the plain version;
  2b. the bf16 modes of A, B, D and E (compute_dtype=torch.bfloat16), each
     against its plain bf16 version (the same operands rounded to bf16, a
     float32 product with TF32 off) at the training shapes, A and B also at
     the serving batch: A's magnitude and phase by A's float32 rule, with the
     float32 kernel more than 20x further off (the operands were rounded); B
     and E element by element (3e-4 and 5e-4 + 5e-4|g|); D, which rounds its
     own dspec before its products, against the float64 plain version of the
     same bf16-rounded computation with unit-normal (at the training and the
     serving batch) and well-conditioned phase cotangents (within 2 x the
     plain f32 version's error + 1e-3 * max|g|, each element's error less
     the slack a flip of dspec's bf16 rounding gives it,
     cuda_frontend.fused_analysis_bwd_flip_slack), E also so; B, D and E
     twice, bit-equal. A, B, D and E on both of their bf16 schedules (wgmma,
     which the rule picks at these shapes, and mma.sync), A and B at both
     batches, each with its control; A's edge frames exactly 1e-18 and 0 on
     both. The slack's own measure:
     the spectrum D forms again, read through E's product
     (cli/time_frontend.spectrum_error), within FLIP_SIGMA (root mean
     square) and FLIP_K * FLIP_SIGMA (largest) times max|spectrum| of
     float64 on both schedules at both batches. Each check's control:
     the float32 kernel on the same inputs must land more than GAP_B, GAP_D,
     GAP_E times over its limit;
  2c. kernel L (csrc/iir.cu, lfilter) bit-equal to its plain version, each
     case run twice and bit-equal: the Compressor's dB envelope at (200,
     8192), order 1 with its steady-state zi and per-row cutoffs over the
     knob range; the LowPass at (200, 8192), order 3, with rows at 10, 100
     and 2000 Hz; the Compressor's envelope over one 30 s row; the
     adversarial rows of orders 1 and 3 (cli/time_lfilter.adversarial_inputs),
     also from memory 4 bytes off;
  3. the serving path, with every kernel counter set to 0 just before it and
     read just after: demo/model_comp4c_demo.tar loaded onto the card, a
     seeded 30 s music-like clip through predict_long at the comp_4c knobs
     [-25, 4, 0.005, 0.02], and the comp_4c target by Compressor_4c.go_wc
     and calc_ct. A, B and C (go_wc's whole-clip row by its chunked schedule)
     must have launched, A and B on the wgmma schedule (fused_analysis_mma
     and fused_synthesis_mma 0), and no plain version run;
     the prediction must be finite, of the expected length, correlate >= 0.98
     with the target (the floor of tests/test_shipped_model_quality.py) and
     agree with the plain CPU path on a short clip (atol 1e-3);
  4. the training paths, float32 then bfloat16 (the JAX package's default),
     each with the counters set to 0 just before and read just after:
     train() on the card (comp_4c, fused front-end, fresh seeded weights,
     batch 200, 3 epochs x 20 steps, lr_max 2e-4) in a temporary directory,
     every step and validation batch but the first (the capture's warm-up)
     a CUDA-graph replay (training/graphs.py; the counters add each graph's captured kernels
     once a replay), then its checkpoint through load_model (strict, in the
     same compute dtype) and predict_long on a 2 s clip. The path's four
     front-end kernels (A, B, D, E in its mode) and C must have launched,
     none of the other mode, none on the mma.sync schedule (A, B, D and E
     take wgmma at this shape in both modes), and no plain version run;
     every loss finite;
     the mean validation MAE lower after the last epoch than after the
     first; parameters float32; the served output finite and of the
     expected length. Then the same run dispatched op by op (the eager
     loop, the same capturable Adam): all 60 losses, the 3 mean validation
     MAEs and every weight bit-equal to train()'s. In each dtype one more
     step on each of STEP_CHECK_BATCHES batches through
     frontend="fused" (the kernels) and "gemm" (plain autograd in float32,
     the bf16 gemm policy in bfloat16), each against the gemm step with
     float64 parameters (in bf16 the same roundings, the front-end's bf16
     operands summed in float64): on every batch the fused loss within twice
     the gemm step's relative error plus 1e-5, every fused gradient within
     twice the gemm step's error plus 1e-3 * max|g| of its leaf (bf16:
     STEP_LOSS_FLOOR_BF16, STEP_GRAD_FLOOR_BF16), and in bf16 a control, the
     bf16 model on the float32 kernels, more than GAP_STEP times over each
     limit on its worst batch;
  4b. every synthesized effect trained (the JAX package's registry but
     comp_4c_large, comp_large's class, and files): train() on the card in
     bfloat16, fused front-end, flagship geometry, batch 200, seeded weights,
     1 epoch x 4 steps under CUDA graphs, the counters set to 0 just before
     and read just after each: A, B, D, E (bf16) launched, C for the
     compressors built on compressor_4controls (comp_4c, comp_large, comp_t,
     comp_one, decomp_4c), L for comp and lowpass, no plain version, every
     loss finite; for denoise, timealign and pitch the same run dispatched op
     by op, bit-equal (losses, validation MAE, weights); each effect's data
     synthesis alone, its card busy ms and kernels a batch;
  4c. demo/modelcheckpoint_denoise.tar served, counted: loaded strict onto
     the card, a seeded 3 s clip plus uniform noise of strength 0.25 through
     predict_long at knob 0.25/0.5 - 0.5; A and B launched, no plain version;
     MAE(prediction, clean) at most 0.3 x MAE(noisy, clean), the output
     aligned 6,144 samples into the input; the card within 1e-3 of the plain
     CPU path on a short clip;
  5. timing with CUDA events: each kernel, its plain version and the
     PyTorch library calls nearest to it, beside the bound computed from this
     run's shapes (HBM 3.35 TB/s; for A, B, D and E, whose products run as
     three TF32 tensor-core products, a third of the 495 TFLOP/s dense TF32
     peak = 165 TFLOP/s of f32-accurate work, with the bound at the CUDA
     cores' f32 67 TFLOP/s beside it: the H100 SXM data-sheet rates at 700 W;
     for C the f32 67 TFLOP/s, and beside it the floor of its schedule's
     dependent chain: W + L steps chunked, a row's length by rows), with the
     TFLOP/s that A, B, D and E reach; C chunked on the serving gain curve, on
     randn and on the row that never meets (at most 1.2 x the row schedule),
     each beside the row schedule, with W, L, the virtual rows and the steps
     re-run; predict_long's
     audio-seconds per second; the
     train step with either front-end in either dtype (host clock, least and
     most of two turns) and the data synthesis alone; one torch.profiler
     window over each for the card's busy time and the kernels launched; the
     loop as train() runs it (data + step, blocks of 20, one fetch a block)
     in f32 and bf16 under CUDA graphs and dispatched op by op, and under
     graphs with a fetch after every step (as train() fetches when the
     status cadence does not divide the epoch), in turns (graph, graph with
     a fetch a step, eager, eager, graph with a fetch a step, graph), with
     each way's card busy time, kernels
     on the card and launch calls from the host a step, and the capture
     time, after the graph's first 20 steps have shown the batches of steps
     0, 1 and 19 bit-equal to batch_fn run eagerly; the kernels of one f32
     step (torch.profiler): the split-TF32 wgmma products of A, B, D and E
     (A's and D's FrameSpectrum32, D's AnalysisDspecW32, B's SynthesisFrames
     on RowProduct32, E's SynthesisDspecW32, D's and E's FrameGrad32) and no
     K-slice pass (sum_analysis_partials, synthesis_adjoint,
     sum_synthesis_partials); float32 A and B (both batches), D (with and
     without dxp) and E on both schedules in turns (wgmma, mma.sync,
     mma.sync, wgmma), each also as one CUDA-graph replay; the
     bf16 modes of A, B, D and E at the training shapes (A and B also at the
     serving batch) beside their plain bf16 versions, cuDNN's bf16
     convolutions and the bound at the dense bf16 rate (989 TFLOP/s); beside
     every cuDNN call, in either dtype, the cuBLAS products that the gemm
     front-end runs for the same linear part at the same shapes
     (cli/time_frontend.cublas_*: A's frames times the stacked matrix, B's
     frame product, D's and E's two backward products); bf16 A and B (at both
     batches), D (with and without dxp) and E on both schedules in turns
     (wgmma, mma.sync, mma.sync, wgmma), each also as one CUDA-graph replay
     (the card's time with no host work between the passes); L on
     its three cases beside its bound (8 B a sample at 3.35 TB/s) and its
     chain floor (cli/time_lfilter.chain_cycles: order 1 is fma -> mul ->
     fma, 12 cycles a step; order 3 about 9.3; at the SM clock).
  6. file datasets at the flagship geometry, batch 200, bf16, each part in a
     temporary directory and counted: 6a cli.gen_dataset on the card, comp_4c
     at --dur 5 --device-batch 64 --seed 1 with -n 250 (float32 wavs, 201
     Train and 49 Val pairs of 221,184 samples) and -n 50 --pcm16, and -e
     comp -n 16: C (row schedule) or L launched once a device batch of whole
     files (64, 221,184), no plain version, the split's counts, the names,
     effect_info.ini read back by FileEffect, two targets of each held to the
     effect's plain version on the written input; files/s and card ms a
     device batch; C and L timed at that shape beside their bounds, chain
     floors and plain versions; 6b train(datapath=) on the resident f32 tier (-e files, 3 epochs
     x 20 steps under CUDA graphs): A, B, D, E (bf16) launched, not C, the
     validation MAE falling, and the same run dispatched op by op bit-equal
     (losses, validation MAEs, every weight); 6c the int16 tier on the
     --pcm16 set, forced by the budget argument: its batches for step
     generators 0, 1, 19 bit-equal to the f32 tier's, 20 steps bit-equal to
     eager; 6d the host tier, forced by a budget below the int16 size: 20
     prefetched batches (pinned) bit-equal to host_batch replayed from
     default_rng(seed), 20 steps of the arrays-fed graph bit-equal to
     host_steps on the same batches; 6e -t chunk on the resident tier (comp_4c
     re-run on each crop): C counted in every replay, bit-equal to eager; 6f
     the 6b checkpoint served by cli.predict_long -e files on a Val input: A
     and B launched, the output finite, corr(prediction, target) printed.
     Then each tier's loop (synthetic comp_4c, f32, int16, host, chunk) under
     CUDA graphs in turns: ms a step [least, most], examples/s, card busy ms
     and the gap.
  7. train()'s whole surface at the flagship geometry, batch 200, bf16,
     comp_4c, 3 epochs x 20 steps, lr_max 2e-4, phase 4's seed, each part in
     a temporary directory: 7a train() with make_plots (plot_every 3) and a
     checkpoint every epoch on the background writer, inside
     utils/profiling.trace, counted: its losses, validation figures and
     final weights bit-equal to phase 4's bf16 run, 50 val_data_*.png and
     the six spectrogram and weight images, the checkpoint loaded strict and
     equal to the final weights, both .dat logs equal to the history, A-E
     (bf16) and C launched and no plain version run, the trace naming A-E;
     7b from the trace's second train.block span (20 replays) the card's ms a
     step in five groups by each replay's kernel order (data synthesis, the
     front-end kernels, the autoencoders, the loss, clip + Adam) and the ten
     kernels of most time; 7c train() in turns, two turns each, 3 epochs of
     60 steps and 15 validation batches: its defaults (status every 10
     batches, 30 steps a fetch), a status cadence that does not divide the
     epoch (a fetch a step, read one step behind), the 50 validation plots
     every epoch, a checkpoint every epoch; epoch 2's wall time a step
     (ST_TPU_TIMING), least and most, the gaps to the defaults, and phase
     4's bf16 epoch 2 beside them; 7d cli.lr_finder -b 200 --npoints 8 --trials 2 on
     the card, counted: 8 finite rows in lrfind.dat, lrfind.png, A-E and C
     launched, no plain version; 7e a model with dropout_rate 0.2 (its
     biases moved off zero) run twice with deterministic=False from one
     generator seed: bit-equal, whole (example, bin) rows dropped, the kept
     share within 3 sigma of 0.8.
  8. the rest of the single-card surface, each part counted, in at most
     PHASE8_LIMIT_S (60 s): 8a cli.gen_dataset comp_4c --dur 5 -n 64
     --device-batch 8 with --backend host (8 spawned workers, the C++
     compressor; no kernel touched) and with --backend device (C once a
     batch), files/s of each; every host target against kernel C on its
     input read back from its file, within HOST_HEAD_TOL over the first 8192
     samples and HOST_WHOLE_TOL over the whole file; --backend auto on the
     card prints its pull rate and picks device; 8b the DCT front-end (ft
     1024, w 2048, hop 1024) on (200, 8192) and the FNN front-end on (200,
     25, 1024) frames, TF32 off, in float32 and in bfloat16, each module
     against float64 on the same parameters (in bf16 the same bf16-rounded
     operands) within 1e-4, the round trips (DCT correlation > 0.95, FNN
     within 1e-4), finite gradients, their times; 8c cli.viz on the demo
     checkpoint: no kernel and no plain version run (return_acts takes the
     gemm front-end), the activations within 1e-3 of the CPU model's on the
     same input, the PNG's size; 8d cli.knob_sweep --frames 8 and
     DemoState.run: A, B and C once a frame and once a run, no plain
     version, frame 0 within 1e-3 of the CPU model's, 8 PNGs, ms a frame; 8e
     the facades: SynthAudioDataSet(...).batches(200, steps=3) launches C 3
     times with the right shapes, st.nn_proc.st_model() has the JAX
     package's 4,211,090 parameters, st.train.make_train_multi_step's graph
     replays a step (A, B, D, E, C launched).
  9. data parallelism (parallel/, training/oracle.py, predict_long(mesh=)),
     in at most PHASE9_LIMIT_S (60 s); every rank counts its own launches
     and returns them, none may run a plain version: 9b's two gloo ranks
     are spawned first (parallel/launch.spawn, with a deadline), and this
     process runs 9a and the oracles meanwhile; 9a, in this process, a world
     of one under NCCL: train() bf16, comp_4c, batch 200, 1 epoch x 20
     steps, its losses, validation figures and every weight bit-equal to
     the same run without a mesh (A, B, D, E bf16 and C launched), and the
     train graph with and without the mesh (two graphs around the
     all-reduce, or one) bit-equal over 60 steps, their ms a step in turns
     once the ranks are done; 9b the two gloo ranks on the one card,
     float32, global batch 200, DP_STEPS steps through the split graphs
     against training/oracle.oracle_steps in this process within atol 2e-6
     / rtol 2e-5 (losses rtol 1e-5), the oracle with reduce="sum" more
     than DP_CONTROL_GAP times over, the gloo ranks' ms a step (this
     process's work on the card at the same time); 9c predict_long(mesh=)
     on the two ranks over phase 3's 30 s clip within 2e-5 of phase 3's
     output; 9d rank 0's checkpoint after 9b resumed by train() at world 1
     (4 steps) against the oracle run on.
 10. tensor parallelism (parallel/tensor.py, the JAX 'model' axis), in
     spawned ranks, in at most PHASE10_LIMIT_S (60 s); every rank counts its
     own launches (C in each rank's data synthesis; the split front-end is
     the gemm path), none may run a plain version: 10b 1 x 2 and 2 x 2 as
     gloo ranks on the one card at once (gloo's collectives cannot be
     captured: op by op), float32, global batch 200, TP_STEPS steps at the
     JAX dp x tp test's schedule against training/oracle.oracle_steps at
     n_data shards, run in this process meanwhile, within
     oracle.state_excess <= 1 (the weights and Adam's moments within atol
     2e-6 / rtol 2e-5, each moment's norm within rtol), the losses within
     rtol 1e-5, the replicated weights bit-equal across the ranks; at 2 x 2
     the sum-not-mean oracle more than TP_CONTROL_GAP times over and the
     two scale controls (parallel/tensor.scale_control) over; each rank's
     ms a step and the peak memory of one step beside an unsharded rank's
     at the same rows; 10c the 2 x 2 checkpoint (whole matrices) loaded
     strict into one card, its next step against the oracle's, and phase
     4's checkpoint resumed by train() at 1 x 2 (4 steps; only rank 0
     writes) against the oracle; 10a, in this process while the 10b ranks
     run, a world of one under NCCL: the split front-end on a model group
     of one, its collectives captured in the train graphs, bf16, batch 200,
     60 steps bit-equal to the gemm graph without a mesh (losses, weights,
     Adam's moments; every sum runs in the same order), their ms a step in
     turns once the ranks are done, and the split analysis' full-width
     product (ops/frontend.py) timed beside one rank's bins alone at
     n_model 2 and 4 (cli/time_data_parallel.analysis_product_ms).
 11. ST_TPU_MICROBATCH (train.microbatches, train.loss_and_grads(micro=)),
     in at most PHASE11_LIMIT_S (60 s): 11a the flagship comp_4c train graph
     at micro=MICRO (4 slices of 50 rows inside the one capture), batch 200,
     MB_STEPS steps in float32 and in bfloat16, each with the counters set
     to 0 just before and read just after: bit-equal to eager_steps at the
     same micro (losses and weights), A, B, D, E launched MICRO times a step
     and C once, no plain version; 11b one float32 step at micro=MICRO
     against the unsliced step on one batch: the loss within rtol 1e-5 and
     every gradient within 1e-5 of its leaf's largest element, but the
     analysis matrices' (the phase adjoint's ill-conditioning), which may
     instead each lie within twice the unsliced step's distance from a
     float64 step (the gemm model in float64); 11c a world of one under NCCL
     at micro=MICRO (the split graphs around the all-reduce) bit-equal to the
     single graph without a mesh; 11d bf16 at batch 200 and 1600, micro 1
     and MICRO: ms a step (blocks of MB_TIMED replays, in turns) and the
     peak memory of a step above the model (torch.cuda.max_memory_allocated
     over the warm-up and the capture).
The script's seconds in all, then the kernels JSON line and the result line,
end the output.

Exits non-zero with no result when torch.cuda.is_available() is false, or
when it is not next to the signaltrain_tpu_torch package it drives.
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CKPT = HERE / "demo" / "model_comp4c_demo.tar"
KNOBS_WC = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)
CLIP_SECONDS = 30.0
MIN_CORR = 0.98
BF16 = torch.bfloat16
F32 = torch.float32
TRAIN_BATCH = 200
TRAIN_EPOCHS, TRAIN_POINTS, TRAIN_LR = 3, 4000, 2e-4  # 3 epochs x 20 steps
TRAIN_SEED = 218
LOOP_BLOCK = 20  # steps a timed block, one fetch of the losses after it (as train() runs)
SEEDS = (0, 1, 2)
# the controls of the bf16 checks: how many times over a check's limit the
# float32 kernel (or, for the train step, the bf16 model on the float32
# kernels) must land
GAP_B, GAP_D, GAP_E, GAP_STEP = 5.0, 2.0, 4.0, 2.0
# the control of the float32 kernels' float64 rules (A's magnitude, D's
# gradients under unit-normal phase cotangents): one TF32 product, its
# operands cut to TF32 with no split, must land more than GAP_F32 times over
GAP_F32 = 10.0
# the bf16 train step's floors, loss (relative) and gradients (of a leaf's
# max|g|), each near the geometric mean of the fused step's largest reading
# and its control's smallest over the STEP_CHECK_BATCHES batches (loss 1.0e-6
# and 3.6e-5, gradients 7.8e-3 and 4.7e-2 on the H100; PERF.md, section 6)
STEP_LOSS_FLOOR_BF16, STEP_GRAD_FLOOR_BF16 = 6e-6, 2e-2
STEP_CHECK_BATCHES = 3  # the step checks' batches: the steps after the 60 trained ones


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card over reps calls, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def off_boundary(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary: the row scan of kernels C and L then copies 4 bytes at
    a time instead of in bulk."""
    view = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)[1 : 1 + t.numel()]
    return view.view(t.shape).copy_(t)


def disagreement(name: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """The failure message of a kernel check: where the worst error sits."""
    idx = np.unravel_index(int(torch.argmax((got - want).abs())), tuple(got.shape))
    return (f"kernel {name} disagrees with its plain version: worst at {tuple(map(int, idx))}, "
            f"kernel {got[idx].item()!r} plain {want[idx].item()!r}")


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() by the host clock, the card drained before
    and after: what a step costs with its host work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def elementwise_excess(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """Largest error, and its largest excess over tol + tol*|want|."""
    err = (got - want).abs()
    return float(err.max()), float((err - (tol + tol * want.abs())).max())


# the host's calls that put work on the card, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def card_busy(fn, reps: int) -> dict:
    """One torch.profiler window over reps calls of fn(): the card's busy
    milliseconds (all kernel and copy times summed), the kernels that ran on
    the card and the host's launch calls that the profiler saw (LAUNCH_CALLS;
    a kernel launched from the port's own libraries may not show there),
    per call. Raises if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    on_card = torch.autograd.DeviceType.CUDA
    # an annotation (Optimizer.step#...) shows on both timelines; a kernel only on the card's
    host_names = {e.key for e in rows if e.device_type != on_card}
    kernels = [e for e in rows if e.device_type == on_card and e.key not in host_names]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "torch.profiler reported no device time")
    launch_calls = sum(e.count for e in rows if e.device_type != on_card
                       and e.key.startswith(LAUNCH_CALLS))
    return {"card_busy_ms": busy_us / 1e3 / reps,
            "kernels_launched": sum(e.count for e in kernels) / reps,
            "host_launch_calls": launch_calls / reps}


def card_kernel_names(fn, reps: int = 3) -> set:
    """The names of the kernels that reps calls of fn() run on the card
    (torch.profiler; the first kernels of a window can go unrecorded, so a
    name is taken from any of the calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


def phase_classes(phs: torch.Tensor, rphs: torch.Tensor, rmag: torch.Tensor) -> dict:
    """Kernel A's phase against the plain version's, in two classes. The
    phase atan2(im, re + 1e-7) turns an error e of the spectrum into e / mag,
    and any other order of adding the products moves the spectrum by ~5e-7.
    Bins whose plain magnitude is >= 1e-2 are held to the wrapped 2e-4 +
    2e-4*|phs| (a 1-ulp change of im at the branch cut moves atan2 by 2 pi);
    smaller ones to 2e-6 / mag, four times an f32 product's own largest error
    against a float64 one. Returns each class's count, worst difference and
    largest excess over its limit."""
    d = ((phs.double() - rphs.double() + np.pi).remainder(2 * np.pi) - np.pi).abs()
    big = rmag >= 1e-2
    limit = torch.where(big, 2e-4 + 2e-4 * rphs.double().abs(), 2e-6 / rmag.double())
    out = {}
    for name, sel in (("regular", big), ("small", ~big)):
        n_sel = int(sel.sum())
        out[name] = dict(bins=n_sel, worst=float(d[sel].max()) if n_sel else 0.0,
                         excess=float((d[sel] - limit[sel]).max()) if n_sel else -1.0)
    return out


def as_accurate(name: str, got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
                floor: float, slack: torch.Tensor | None = None) -> tuple[float, float]:
    """Largest errors of a kernel's and of its plain version's result against
    a float64 one; raises unless the kernel's is within twice the plain
    version's plus floor. The statement 'as accurate as f32' for quantities
    too ill-conditioned to compare two f32 results with each other.
    ``slack``: a per-element allowance taken off each element's error first
    (the returned error is then the largest of those)."""
    diff = (got.double() - exact).abs()
    err = float((diff if slack is None else diff - slack).max())
    plain_err = float((plain.double() - exact).abs().max())
    check(err <= 2 * plain_err + floor,
          f"kernel {name}: error {err:.3e} against float64, the plain version's is {plain_err:.3e}")
    return err, plain_err


def f64_rule(name: str, got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
             slack: torch.Tensor | None = None) -> tuple:
    """A bf16 mode's result that rounds one of its own results (D's dspec) or
    a gradient: the kernel's largest error against the float64 plain version
    of the same bf16-rounded computation within twice the plain f32
    version's plus 1e-3 * max|exact|, each element's error taken less its
    ``slack`` first (bf16 D: the moves a flip of dspec's bf16 rounding can
    make, cuda_frontend.fused_analysis_bwd_flip_slack). Returns both errors."""
    return as_accurate(name, got, plain, exact, 1e-3 * float(exact.abs().max()), slack)


def f64_rule_ratio(got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
                   slack: torch.Tensor | None = None, share: float = 1e-3) -> float:
    """How many times over f64_rule's limit ``got`` lands (a control);
    ``share``: the limit's floor as a share of max|exact| (the float32
    kernels' rule: 1e-6)."""
    diff = (got.double() - exact).abs()
    err = float((diff if slack is None else diff - slack).max())
    plain_err = float((plain.double() - exact).abs().max())
    return err / (2 * plain_err + share * float(exact.abs().max()))


def one_tf32_synthesis(cf, mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor, ft: int,
                       hop: int) -> torch.Tensor:
    """Kernel B's function with its frame product as one TF32 product (the
    spectrum and the weights cut to TF32, no split): the control of float32
    B's float64 rule."""
    from signaltrain_tpu_torch.ops import framing

    spec = torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], -1)
    wave = framing.overlap_add((cf.split_tf32(spec)[0] @ cf.split_tf32(w)[0]).transpose(0, 1), hop)
    return wave[:, ft : wave.shape[1] - ft]


def rounding_shows(name: str, ratio: float, factor: float) -> float:
    """The control of a bf16 check: ``ratio`` is how many times over the
    check's limit the float32 kernel lands on the same inputs (a mode that
    forgot to round); raises unless it exceeds ``factor``."""
    check(ratio > factor, f"{name}: the control is only {ratio:.2f}x the bf16 check's limit "
                          f"(needs > {factor:g}x): the check cannot tell a mode that did not round")
    return ratio


def excess_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The largest of |got - want| / (tol + tol*|want|): over 1 fails that check."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def check_bf16_kernels(cf, dev, w_an, w_syn, ft, hop, chunk, out_frames, n_windows) -> tuple:
    """Phase 2b: the bf16 modes of A, B, D and E, each against its plain bf16
    version (the same operands rounded to bf16, a float32 product with TF32
    off) at the training shapes, A and B also at the serving batch. Returns
    the results and the inputs the timing reuses."""
    half = ft // 2 + 1
    out_len = (out_frames - 1) * hop - ft
    res, ins = {}, {}
    # A and B on both schedules (cuda_frontend.SCHEDULES: wgmma, the rule's
    # pick at these shapes, and mma.sync), at the training and serving batch
    check(cf.schedule_for(None, BF16, ft, hop, chunk + 2 * ft) == "wgmma",
          "bf16 A: the rule does not pick wgmma")
    check(cf.schedule_for(None, BF16, ft, hop, None) == "wgmma", "bf16 B: the rule does not pick wgmma")
    a_errs = {sched: {"mag": 0.0, "phs": 0.0, "small": 0.0, "gap": float("inf")}
              for sched in cf.SCHEDULES}
    for nb in (TRAIN_BATCH, n_windows):
        sg = torch.Generator(device=dev).manual_seed(300 + nb)
        xp = torch.nn.functional.pad(torch.randn(nb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
        rmag, rphs = cf.fused_analysis_reference(xp, w_an, ft, hop, BF16)
        f32_mag = cf.fused_analysis(xp, w_an, ft, hop)[0]
        gap = float((f32_mag - rmag).abs().max())
        for sched in cf.SCHEDULES:
            mag, phs = cf.fused_analysis(xp, w_an, ft, hop, BF16, schedule=sched)
            torch.cuda.synchronize()
            check(mag.shape == rmag.shape and mag.dtype == torch.float32, "bf16 A: shape or dtype")
            m_err, mag_excess = elementwise_excess(mag, rmag, 2e-5)
            cls = phase_classes(phs, rphs, rmag)
            print(f"A bf16 {sched} xp {tuple(xp.shape)}: max|dmag| {m_err:.3e} (tolerance "
                  f"2e-5+2e-5|mag|); wrapped phase {cls['regular']['worst']:.3e} on "
                  f"{cls['regular']['bins']} bins >= 1e-2 (2e-4+2e-4|phs|), "
                  f"{cls['small']['worst']:.3e} on {cls['small']['bins']} smaller (2e-6/mag); the "
                  f"float32 kernel is {gap:.3e} off the plain bf16 version")
            check(mag_excess <= 0, disagreement(f"A bf16 {sched} (magnitude)", mag, rmag))
            for name, c in cls.items():
                check(c["excess"] <= 0, f"kernel A bf16 {sched} (phase, {name} bins): "
                                        f"{c['worst']:.3e}")
            check(gap > 20 * m_err, f"kernel A bf16 {sched} is as close to the float32 kernel as "
                                    "to its plain bf16 version: the operands were not rounded")
            check(all(bool(torch.all(mag[e] == np.float32(1e-18))) and bool(torch.all(phs[e] == 0))
                      for e in (0, -1)),
                  f"kernel A bf16 {sched}: an edge frame's magnitude is not exactly 1e-18 or its "
                  "phase not 0")
            e = a_errs[sched]
            a_errs[sched] = {"mag": max(e["mag"], m_err), "phs": max(e["phs"], cls["regular"]["worst"]),
                             "small": max(e["small"], cls["small"]["worst"]),
                             "gap": min(e["gap"], gap)}
        ins["xp", nb] = xp

    def a_summary(e):
        return dict(max_abs_err=e["mag"], max_phase_err=e["phs"], max_small_bin_phase_err=e["small"],
                    f32_kernel_gap=e["gap"])

    res["bf16_fused_analysis"] = dict(
        **a_summary(a_errs["wgmma"]), schedule="wgmma", mma_sync=a_summary(a_errs["mma"]),
        tolerance="against the plain bf16 version: mag 2e-5 + 2e-5*|mag|; wrapped phase 2e-4 + "
                  "2e-4*|phs| where mag >= 1e-2, 2e-6/mag below; the float32 kernel > 20x further; "
                  "both schedules at batches 200 and 643; edge frames exactly 1e-18 and 0")

    b_res = {sched: {"max_abs_err": 0.0, "f32_kernel_gap": float("inf")} for sched in cf.SCHEDULES}
    for nb in (TRAIN_BATCH, n_windows):
        sg = torch.Generator(device=dev).manual_seed(400 + nb)
        smag = torch.nn.functional.softplus(torch.randn(out_frames, nb, half, generator=sg, device=dev))
        sphs = torch.randn(out_frames, nb, half, generator=sg, device=dev) * 2.0
        rwave = cf.fused_synthesis_reference(smag, sphs, w_syn, ft, hop, BF16)
        f32_wave = cf.fused_synthesis(smag, sphs, w_syn, ft, hop)
        gap = excess_ratio(f32_wave, rwave, 3e-4)
        for sched in cf.SCHEDULES:
            wave = cf.fused_synthesis(smag, sphs, w_syn, ft, hop, BF16, schedule=sched)
            wave2 = cf.fused_synthesis(smag, sphs, w_syn, ft, hop, BF16, schedule=sched)
            torch.cuda.synchronize()
            check(wave.shape == (nb, out_len), f"bf16 synthesis shape {tuple(wave.shape)}")
            check(torch.equal(wave, wave2), f"kernel B bf16 {sched}: two runs are not bit-equal")
            err, excess = elementwise_excess(wave, rwave, 3e-4)
            print(f"B bf16 {sched} mag {tuple(smag.shape)}: max|dwave| {err:.3e} (tolerance "
                  f"3e-4+3e-4|wave|, max|wave| {float(rwave.abs().max()):.3f}); two runs bit-equal; "
                  f"the float32 kernel is {gap:.2f}x the tolerance off the plain bf16 version")
            check(excess <= 0, disagreement(f"B bf16 {sched}", wave, rwave))
            r = b_res[sched]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["f32_kernel_gap"] = min(r["f32_kernel_gap"], rounding_shows("B bf16", gap, GAP_B))
        ins["syn", nb] = (smag, sphs)
    res["bf16_fused_synthesis"] = dict(
        **b_res["wgmma"], schedule="wgmma", mma_sync=b_res["mma"],
        tolerance=f"3e-4 + 3e-4*|wave| against the plain bf16 version, the float32 kernel > {GAP_B:g}x "
                  "it; both schedules at batches 200 and 643; two runs bit-equal")

    # D: unit-normal and well-conditioned phase cotangents, both against
    # float64, on both schedules (cuda_frontend.SCHEDULES: wgmma, the rule's
    # pick at this shape, and mma.sync); the unit-normal ones also at the
    # serving batch. Each element's error is taken less the slack a flip of
    # dspec's one bf16 rounding gives it (fused_analysis_bwd_flip_slack)
    tb, lp = TRAIN_BATCH, chunk + 2 * ft
    frames = (lp - ft) // hop + 1
    check(cf.schedule_for(None, BF16, ft, hop, lp) == "wgmma", "bf16 D: the rule does not pick wgmma")
    d_err = {sched: {} for sched in cf.SCHEDULES}
    d_gap, d_cases = {}, []
    for nb in (tb, n_windows):
        sg = torch.Generator(device=dev).manual_seed(500 if nb == tb else 510)
        txp = torch.nn.functional.pad(torch.randn(nb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
        tdmag = torch.randn(frames, nb, half, generator=sg, device=dev) * (64.0 / ft)
        tdphs = torch.randn(frames, nb, half, generator=sg, device=dev) * (64.0 / ft)
        d_cases.append((nb, "unit-normal", txp, tdmag, tdphs))
        if nb == tb:
            kmag = cf.fused_analysis_reference(txp, w_an, ft, hop)[0]
            d_cases.append((nb, "well-conditioned", txp, tdmag, tdphs * (kmag >= 0.25 * kmag.median())))
            ins["D"] = (txp, tdmag, tdphs)
            d_sg = sg
    for nb, cot, txp, tdmag, dphs in d_cases:
        args = (txp, w_an, tdmag, dphs, ft, hop)
        rdxp, rdw = cf.fused_analysis_bwd_reference(*args, compute_dtype=BF16)
        xdxp, xdw = cf.fused_analysis_bwd_reference(*(a.double() for a in args[:4]), ft, hop, BF16)
        sdxp, sdw = cf.fused_analysis_bwd_flip_slack(*args)
        fdxp, fdw = cf.fused_analysis_bwd(*args)
        sl = slice(ft, -ft) if cot == "unit-normal" else slice(None)
        # the float32 kernel against the same limits: how far over them it lands
        gap = max(f64_rule_ratio(fdxp[:, sl], rdxp[:, sl], xdxp[:, sl], sdxp[:, sl]),
                  f64_rule_ratio(fdw, rdw, xdw, sdw))
        d_gap[nb, cot] = gap
        del fdxp, fdw
        for sched in cf.SCHEDULES:
            dxp, dw = cf.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=sched)
            dxp2, dw2 = cf.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=sched)
            torch.cuda.synchronize()
            check(torch.equal(dw, dw2) and torch.equal(dxp, dxp2),
                  f"kernel D bf16 ({sched}): runs not bit-equal")
            ex, ex_plain = f64_rule(f"D bf16 {sched} ({cot} dx, batch {nb})", dxp[:, sl], rdxp[:, sl],
                                    xdxp[:, sl], sdxp[:, sl])
            ew, ew_plain = f64_rule(f"D bf16 {sched} ({cot} dW, batch {nb})", dw, rdw, xdw, sdw)
            raw_w = float((dw.double() - xdw).abs().max())
            raw_x = float((dxp[:, sl].double() - xdxp[:, sl]).abs().max())
            print(f"D bf16 {sched} xp {tuple(txp.shape)}, {cot} phase cotangents, against float64 "
                  f"less the flip slack: dx kernel {ex:.3e} plain {ex_plain:.3e} (max "
                  f"{float(xdxp[:, sl].abs().max()):.3e}); dW kernel {ew:.3e} (without the slack "
                  f"{raw_w:.3e}) plain {ew_plain:.3e} (max {float(xdw.abs().max()):.3e}); limit 2 x "
                  f"plain + 1e-3 max; two runs bit-equal; the float32 kernel {gap:.2f}x the limit")
            d_err[sched][nb, cot] = (ew, ex, raw_w, raw_x)
        del xdxp, xdw, sdxp, sdw
    for (nb, cot), gap in d_gap.items():
        rounding_shows(f"D bf16 ({cot}, batch {nb})", gap, GAP_D)
    # the slack's own measure on the card: how far the spectrum D forms again
    # lies from float64 on each schedule, read through E's product
    # (time_frontend.spectrum_error), within its sigma (root mean square) and
    # k * sigma (largest), each a share of max|spectrum|
    from signaltrain_tpu_torch.cli import time_frontend

    spec_err = {}
    for nb, cot, txp, *_ in d_cases:
        for sched in cf.SCHEDULES if cot == "unit-normal" else ():
            e = spec_err[sched, nb] = time_frontend.spectrum_error(txp[:, ft:-ft], w_an, ft, hop,
                                                                   sched)
            print(f"D bf16 {sched}, batch {nb}: the spectrum it forms again against float64 "
                  f"(through E): " + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
            sigma = cf.FLIP_SIGMA * e["spec_max"]
            check(e["rms"] <= sigma and e["max"] <= cf.FLIP_K * sigma,
                  f"D bf16 {sched}, batch {nb}: the spectrum's error (rms {e['rms']:.3e}, max "
                  f"{e['max']:.3e}) exceeds the flip slack's sigma {sigma:.3e} or "
                  f"{cf.FLIP_K:g} sigma")

    def d_summary(errs):
        """dW's and dx's largest error against float64 (unit-normal cotangents,
        the training batch), the same less each element's flip slack (what the
        rule holds), the well-conditioned case's and the serving batch's."""
        return dict(max_abs_err=errs[tb, "unit-normal"][2], max_dx_err=errs[tb, "unit-normal"][3],
                    max_err_less_slack=errs[tb, "unit-normal"][0],
                    max_dx_err_less_slack=errs[tb, "unit-normal"][1],
                    max_regular_err=max(errs[tb, "well-conditioned"][2:]),
                    max_abs_err_at_serving_batch=errs[n_windows, "unit-normal"][2])

    res["bf16_fused_analysis_bwd"] = dict(
        **d_summary(d_err["wgmma"]), f32_kernel_gap=min(d_gap.values()), schedule="wgmma",
        mma_sync=d_summary(d_err["mma"]),
        spectrum_err={f"{sched}_{nb}": e for (sched, nb), e in spec_err.items()},
        tolerance="against the float64 plain version of the same bf16-rounded computation, with "
                  "unit-normal (batches 200 and 643) and with well-conditioned phase cotangents, "
                  "each element's error less the slack of a flip of dspec's bf16 rounding "
                  "(cuda_frontend.fused_analysis_bwd_flip_slack): within 2 x the plain f32 "
                  "version's error + 1e-3*max|g| (dx on the unpadded signal under unit-normal "
                  f"ones), the float32 kernel > {GAP_D:g}x that limit in every case; both "
                  "schedules; two runs bit-equal")

    tmag, tphs = ins["syn", TRAIN_BATCH]
    tdout = torch.randn(tb, out_len, generator=d_sg, device=dev)
    args = (tmag, tphs, w_syn, tdout, ft, hop)
    check(cf.schedule_for(None, BF16, ft, hop, out_len + 2 * ft) == "wgmma",
          "bf16 E: the rule does not pick wgmma")
    want = cf.fused_synthesis_bwd_reference(*args, compute_dtype=BF16)
    exact = cf.fused_synthesis_bwd_reference(*(a.double() for a in args[:4]), ft, hop, BF16)
    f32_got = cf.fused_synthesis_bwd(*args)
    e_res = {}
    for sched in cf.SCHEDULES:
        got = cf.fused_synthesis_bwd(*args, compute_dtype=BF16, schedule=sched)
        again = cf.fused_synthesis_bwd(*args, compute_dtype=BF16, schedule=sched)
        torch.cuda.synchronize()
        e_err = e_f64 = 0.0
        e_gap = float("inf")
        for name, g1, g2, r, x, f in zip(("dmag", "dphs", "dW"), got, again, want, exact, f32_got):
            check(torch.equal(g1, g2), f"kernel E bf16 ({sched}): two runs differ in {name}")
            err, excess = elementwise_excess(g1, r, 5e-4)
            check(excess <= 0, disagreement(f"E bf16 {sched} ({name})", g1, r))
            f64, f64_plain = f64_rule(f"E bf16 {sched} ({name})", g1, r, x)
            gap = excess_ratio(f, r, 5e-4)
            print(f"E bf16 {sched} {name}: max error {err:.3e} (tolerance 5e-4+5e-4|g|); against "
                  f"float64: kernel {f64:.3e}, plain {f64_plain:.3e} (max {float(x.abs().max()):.3e}); "
                  f"the float32 kernel is {gap:.2f}x the tolerance off the plain bf16 version")
            e_err, e_f64 = max(e_err, err), max(e_f64, f64)
            e_gap = min(e_gap, rounding_shows(f"E bf16 ({name})", gap, GAP_E))
        for g1 in got[:2]:
            check(bool(torch.all(g1[0] == 0)) and bool(torch.all(g1[-1] == 0)),
                  f"kernel E bf16 ({sched}): an edge frame's gradient is not exactly 0")
        e_res[sched] = dict(max_abs_err=e_err, max_err_vs_float64=e_f64, f32_kernel_gap=e_gap)
    res["bf16_fused_synthesis_bwd"] = dict(
        **e_res["wgmma"], schedule="wgmma", mma_sync=e_res["mma"],
        tolerance="5e-4 + 5e-4*|g| against the plain bf16 version (the float32 kernel > "
                  f"{GAP_E:g}x it), and against float64 within 2 x the plain version's error + "
                  "1e-3*max|g|; both schedules; two runs bit-equal; edge frames 0")
    ins["E"] = tdout
    return res, ins


class Bf16GemmFloat64(torch.autograd.Function):
    """The float64 reference's front-end product in bf16: the bf16 gemm
    policy of ops/frontend.Bf16Gemm (the operands and the cotangent rounded
    to bf16, the bf16 operands kept for the backward) with every product
    summed in float64."""

    @staticmethod
    def forward(ctx, a, b):
        ac, bc = a.to(BF16).double(), b.to(BF16).double()
        ctx.save_for_backward(ac, bc)
        return ac @ bc

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        gc = g.to(BF16).double()
        return gc @ bc.t(), ac.reshape(-1, ac.shape[-1]).t() @ gc.reshape(-1, gc.shape[-1])


def step_errors(train_mod, model, ref, l_ref, bx, by, bk) -> tuple[float, list]:
    """One step of ``model`` on the batch: its loss's relative error and each
    leaf's gradient error against the float64 reference step."""
    loss = train_mod.loss_and_grads(model, bx, by, bk)
    torch.cuda.synchronize()
    rel = abs(float(loss) - float(l_ref)) / abs(float(l_ref))
    return rel, [float((p.grad.double() - px.grad).abs().max())
                 for p, px in zip(model.parameters(), ref.parameters())]


def step_against_float64(train_mod, fused, gemm, batches, prefix: str, loss_floor: float,
                         grad_floor: float, control=None) -> dict:
    """One more step on each of ``batches`` through frontend="fused" (the
    kernels) and "gemm", each against the gemm step with float64 parameters
    (in bf16 the same roundings: the bf16 autoencoders, and the front-end's
    bf16 operands summed in float64 by Bf16GemmFloat64): on every batch the
    fused loss within twice the gemm step's relative error plus loss_floor,
    every fused gradient within twice the gemm step's error plus
    grad_floor * max|g| of its leaf. ``control``, a model that must fail
    these rules, is held to them too: on its worst batch its loss, and on its
    worst batch its worst leaf, each more than GAP_STEP times over (the
    control's reading varies several-fold from batch to batch: PERF.md,
    section 6)."""
    from unittest import mock

    from signaltrain_tpu_torch.ops import _cuda, frontend

    names = [n for n, _ in gemm.named_parameters()]
    out = {key: [] for key in ("loss_rel_vs_f64", "gemm_loss_rel_vs_f64", "grad_err_vs_f64",
                               "gemm_grad_err_vs_f64")}
    if control is not None:
        out.update(control_loss_rel_vs_f64=[], control_grad_err_vs_f64=[],
                   control_loss_over_limit=[], control_grad_over_limit=[])
    for i, (bx, by, bk) in enumerate(batches):
        ref = copy.deepcopy(gemm).double()
        with mock.patch.object(frontend, "Bf16Gemm", Bf16GemmFloat64):
            l_ref = train_mod.loss_and_grads(ref, bx.double(), by.double(), bk.double())
        _cuda.reset_counts()
        rel, errs = step_errors(train_mod, fused, ref, l_ref, bx, by, bk)
        check(all(_cuda.COUNTERS[prefix + c].launches == 1 for c in
                  ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd")),
              f"the fused step did not launch {prefix}A, B, D and E once each")
        rel_gemm, errs_gemm = step_errors(train_mod, gemm, ref, l_ref, bx, by, bk)
        scales = [float(px.grad.abs().max()) for px in ref.parameters()]
        check(min(scales) > 0, f"{prefix}a float64 gradient is all zero")
        loss_limit = 2 * rel_gemm + loss_floor
        limits = [2 * e + grad_floor * m for e, m in zip(errs_gemm, scales)]
        over = max(e / lim for e, lim in zip(errs, limits))
        worst, worst_gemm = (max(e / m for e, m in zip(es, scales)) for es in (errs, errs_gemm))
        print(f"{prefix or 'f32 '}fused vs gemm step on the card, batch {i}: loss against float64: "
              f"fused {rel:.2e}, gemm {rel_gemm:.2e} (limit 2 x gemm's + {loss_floor:g}); worst "
              f"gradient error against float64 in units of the leaf's max|g|: fused {worst:.2e}, "
              f"gemm {worst_gemm:.2e} (limit 2 x gemm's + {grad_floor:g}; the fused step at "
              f"{over:.2f}x its worst leaf's limit); the leaves' max|g| run {min(scales):.2e} to "
              f"{max(scales):.2e}")
        for key, v in (("loss_rel_vs_f64", rel), ("gemm_loss_rel_vs_f64", rel_gemm),
                       ("grad_err_vs_f64", worst), ("gemm_grad_err_vs_f64", worst_gemm)):
            out[key].append(v)
        if control is not None:
            rel_c, errs_c = step_errors(train_mod, control, ref, l_ref, bx, by, bk)
            over_c = max(e / lim for e, lim in zip(errs_c, limits))
            worst_c = max(e / m for e, m in zip(errs_c, scales))
            for key, v in (("control_loss_rel_vs_f64", rel_c), ("control_grad_err_vs_f64", worst_c),
                           ("control_loss_over_limit", rel_c / loss_limit),
                           ("control_grad_over_limit", over_c)):
                out[key].append(v)
            print(f"{prefix}control (the bf16 model on the float32 kernels), batch {i}: loss "
                  f"against float64 {rel_c:.2e} ({rel_c / loss_limit:.2f}x the limit); worst "
                  f"gradient error {worst_c:.2e} of its leaf's max|g| ({over_c:.2f}x its limit)")
        # the loss takes the phase as an input of the autoencoder, so a bin at
        # atan2's branch cut moves it: each loss is held against float64
        check(rel <= loss_limit, f"the {prefix}fused loss is off the float64 one on batch {i}")
        for name, e, lim, e_gemm, m in zip(names, errs, limits, errs_gemm, scales):
            check(e <= lim, f"{prefix}fused gradient of {name} is off the float64 one by {e:.3e} on "
                            f"batch {i}, the gemm step's by {e_gemm:.3e} (max|g| {m:.3e})")
    if control is not None:
        rounding_shows(f"{prefix}train step (loss)", max(out["control_loss_over_limit"]), GAP_STEP)
        rounding_shows(f"{prefix}train step (gradients)", max(out["control_grad_over_limit"]),
                       GAP_STEP)
    return out


# every synthesized effect of the port, trained in phase 4b: the JAX package's
# registry but "comp_4c_large" (the class of "comp_large") and "files"
EFFECT_NAMES = ("comp", "comp_4c", "comp_large", "comp_t", "comp_one", "echo", "pitch", "denoise",
                "decomp_4c", "timealign", "lowpass")
EFFECT_POINTS = 4 * TRAIN_BATCH  # one epoch of 4 steps and one validation batch
RANDOM_EFFECTS = ("denoise", "timealign", "pitch")  # held bit for bit to eager dispatch
DENOISE_CKPT = HERE / "demo" / "modelcheckpoint_denoise.tar"
DENOISE_STRENGTH = 0.25
DENOISE_MAX_MAE_RATIO = 0.3  # MAE(prediction, clean) over MAE(noisy, clean)


def check_lfilter(dev) -> dict:
    """Phase 2c: kernel L bit-equal to its plain version on the cases of
    cli/time_lfilter.py and its adversarial rows, each run twice and
    bit-equal."""
    from signaltrain_tpu_torch.cli import time_lfilter

    cases = {}
    for case in time_lfilter.CASES:
        cases[case] = time_lfilter.check(case, dev)
    # the adversarial rows of each order, also from memory 4 bytes off (the
    # row scan's 4-byte copies instead of its bulk ones)
    for order in (1, 3):
        b, a, x, zi = time_lfilter.adversarial_inputs(8192, order, dev)
        cases[f"adversarial_{order}"] = time_lfilter.check_inputs(f"adversarial, order {order}",
                                                                  b, a, x, zi)
        cases[f"adversarial_{order}_off"] = time_lfilter.check_inputs(
            f"adversarial, order {order}, 4 bytes off", b, a, off_boundary(x), zi)
    for case, r in cases.items():
        print(f"L lfilter {case} x {r['shape']} order {r['order']}: bit-equal to the plain version "
              f"(max|dy| {r['max_abs_err']:.3e}); two runs bit-equal; plain version "
              f"{r['plain_s']:.2f} s")
    return {"max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "elements_differing": {c: r["elements_differing"] for c, r in cases.items()},
            "plain_s_all_checks": sum(r["plain_s"] for r in cases.values()),
            "plain_ms": cases["comp"]["plain_s"] * 1e3,
            "lowpass_plain_ms": cases["lowpass"]["plain_s"] * 1e3,
            "row_30s_plain_ms": cases["row_30s"]["plain_s"] * 1e3,
            "tolerance": "bit-equal to the plain version (the same fma steps), the adversarial "
                         "rows (time_lfilter.adversarial_inputs) included; two runs bit-equal"}


def train_every_effect(dev, results: dict, chunk: int, out_chunk: int, sr: int) -> dict:
    """Phase 4b: train() on the card for every effect of EFFECT_NAMES in
    bfloat16 (fused front-end, flagship geometry, batch 200, seeded weights,
    1 epoch x 4 steps, every step but the first a CUDA-graph replay), each
    with the counters set to 0 just before and read just after: A, B, D, E
    (bf16) launched and not their f32 modes, C for the compressors built on
    compressor_4controls, L for comp and lowpass, no plain version; every
    loss finite. For RANDOM_EFFECTS the same run dispatched op by op: losses,
    validation MAE and weights bit-equal. Then each effect's data synthesis
    alone: card busy ms and kernels a batch (torch.profiler), host ms."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.training import train as train_mod

    bf16_names = ["bf16_fused_analysis", "bf16_fused_synthesis", "bf16_fused_analysis_bwd",
                  "bf16_fused_synthesis_bwd"]
    report, cwd = {}, os.getcwd()
    for name in EFFECT_NAMES:
        effect = effects.make_effect(name, sr=sr, device=dev)
        _cuda.reset_counts()
        t_path = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                model, hist = train_mod.train(
                    effect, epochs=1, n_data_points=EFFECT_POINTS, batch_size=TRAIN_BATCH,
                    cp_every=1, sr=sr, lr_max=TRAIN_LR, seed=TRAIN_SEED, device=dev,
                    compute_dtype=BF16, make_plots=False)
            finally:
                os.chdir(cwd)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t_path
        counts = {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}
        uses_c = name != "comp" and "comp" in name
        uses_l = name in ("comp", "lowpass")
        for k in bf16_names:
            check(counts[k][0] > 0, f"training {name}: kernel {k} never launched")
        for k in bf16_names:
            check(counts[k[5:]][0] == 0, f"training {name}: the float32 kernel {k[5:]} launched")
        for k in MMA_NAMES:
            check(counts[k][0] == 0, f"training {name}: a kernel took the mma.sync schedule ({k})")
        check((counts["switched_one_pole"][0] > 0) == uses_c,
              f"training {name}: kernel C launched {counts['switched_one_pole'][0]} times")
        check((counts["lfilter"][0] > 0) == uses_l,
              f"training {name}: kernel L launched {counts['lfilter'][0]} times")
        for k, (_, plain) in counts.items():
            check(plain == 0, f"training {name} ran the plain version of {k}")
        for k in bf16_names + ["switched_one_pole", "lfilter"]:
            results[k]["launches_effects"] = results[k].get("launches_effects", 0) + counts[k][0]
        losses = hist["train_loss"]
        check(len(losses) == EFFECT_POINTS // TRAIN_BATCH and bool(np.all(np.isfinite(losses)))
              and bool(np.all(np.isfinite(hist["val_mae_mean"]))),
              f"training {name}: a loss is not finite or a step is missing: {losses}")
        batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=True)
        entry = {"effect": effect.name, "num_knobs": effect.num_knobs, "train_s": t_path,
                 "losses": losses, "val_mae_mean": hist["val_mae_mean"],
                 "launches": {k: counts[k][0] for k in bf16_names + ["switched_one_pole", "lfilter"]}}
        if name in RANDOM_EFFECTS:
            m = st_model(device=dev, sr=sr, num_knobs=effect.num_knobs, compute_dtype=BF16,
                         generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
            opt, lr_fn = train_mod.make_optimizer(m, TRAIN_LR, EFFECT_POINTS, 1, TRAIN_BATCH)
            g = torch.Generator(device=dev)
            eager = train_mod.eager_steps(m, opt, lr_fn, batch_fn, TRAIN_BATCH, g, TRAIN_SEED, 0,
                                          len(losses)).cpu().tolist()
            m.eval()
            val_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=False)
            maes = train_mod.eager_validation(m, val_fn, TRAIN_BATCH, g, 1)[1].cpu().numpy()
            check(eager == losses and [float(maes.mean())] == hist["val_mae_mean"],
                  f"training {name}: CUDA graphs and eager dispatch differ: {losses} {eager}")
            check(all(torch.equal(a, b) for a, b in zip(m.parameters(), model.parameters())),
                  f"training {name}: CUDA graphs and eager dispatch differ in the weights")
            entry["graph_equals_eager"] = True
        data_gen = torch.Generator(device=dev)

        def data():
            return batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, TRAIN_SEED, 0))

        prof = card_busy(data, reps=3)
        entry.update(data_card_ms=prof["card_busy_ms"], data_kernels=prof["kernels_launched"],
                     data_host_ms=host_ms(data, reps=3, warmup=1))
        report[name] = entry
        print(f"train({name}, bf16) {t_path:.2f} s: losses {[f'{v:.4e}' for v in losses]}, "
              f"validation MAE {hist['val_mae_mean'][0]:.4e}; launches {json.dumps(entry['launches'])}"
              + ("; bit-equal to eager dispatch" if name in RANDOM_EFFECTS else "")
              + f"; data synthesis {entry['data_card_ms']:.3f} ms on the card in "
              f"{entry['data_kernels']:.0f} kernels ({entry['data_host_ms']:.3f} ms host)")
        del model
    return report


def serve_denoise(dev, results: dict, sr: int) -> dict:
    """Phase 4c: demo/modelcheckpoint_denoise.tar (strict) on the card, a
    seeded 3 s clip plus uniform noise of strength DENOISE_STRENGTH through
    predict_long at knob s/0.5 - 0.5, counted: A and B launched, no plain
    version; MAE(prediction, clean) at most DENOISE_MAX_MAE_RATIO x
    MAE(noisy, clean); the card within 1e-3 of the plain CPU path on a short
    clip."""
    from signaltrain_tpu_torch.dsp import synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.utils.load_model import load_model

    clean = synths.music_like_clip(3.0, sr=sr, seed=0)
    noise = DENOISE_STRENGTH * (2.0 * np.random.RandomState(0).rand(len(clean)) - 1.0)
    noisy = (clean + noise).astype(np.float32)
    knobs = np.array([DENOISE_STRENGTH / 0.5 - 0.5], np.float32)
    _cuda.reset_counts()
    model, rv = load_model(str(DENOISE_CKPT), device=dev)
    y = pl.predict_long(noisy, knobs, model)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}
    for k in ("fused_analysis", "fused_synthesis"):
        check(counts[k][0] > 0, f"Denoise serving never launched kernel {k}")
        results[k]["launches_denoise"] = counts[k][0]
    for k, (_, plain) in counts.items():
        check(plain == 0, f"Denoise serving ran the plain version of {k}")
    check(rv["knob_names"] == ["strength"] and model.spec.num_knobs == 1, "Denoise: its knobs")
    lookback = model.spec.in_chunk_size - model.spec.out_chunk_size
    check(y.shape == (len(noisy) - lookback,) and bool(np.all(np.isfinite(y))),
          "Denoise: prediction length or not finite")
    aligned = slice(lookback, lookback + len(y))
    mae_pred = float(np.abs(y - clean[aligned]).mean())
    mae_noisy = float(np.abs(noisy - clean)[aligned].mean())
    corr_pred = float(np.corrcoef(y, clean[aligned])[0, 1])
    corr_noisy = float(np.corrcoef(noisy[aligned], clean[aligned])[0, 1])
    short = noisy[: 8192 + 4 * 2048 + 300]
    d_cpu = float(np.abs(pl.predict_long(short, knobs, model)
                         - pl.predict_long(short, knobs, load_model(str(DENOISE_CKPT),
                                                                    device="cpu")[0])).max())
    out = {"strength": DENOISE_STRENGTH, "mae_pred": mae_pred, "mae_noisy": mae_noisy,
           "mae_ratio": mae_pred / mae_noisy, "corr_pred": corr_pred, "corr_noisy": corr_noisy,
           "card_vs_cpu_max_abs": d_cpu, "parameters": sum(p.numel() for p in model.parameters())}
    print(f"Denoise served ({out['parameters']} parameters), 3 s clip + uniform noise of strength "
          f"{DENOISE_STRENGTH}: MAE(prediction, clean) {mae_pred:.4f}, MAE(noisy, clean) "
          f"{mae_noisy:.4f}, ratio {out['mae_ratio']:.3f} (limit {DENOISE_MAX_MAE_RATIO}); corr "
          f"{corr_pred:.4f} against {corr_noisy:.4f}; card vs plain CPU path max|dy| {d_cpu:.3e} "
          f"(tolerance 1e-3)")
    check(out["mae_ratio"] <= DENOISE_MAX_MAE_RATIO, "Denoise: the prediction does not denoise")
    check(d_cpu <= 1e-3, "Denoise: card and plain CPU path disagree")
    return out


# ---- phase 6: file datasets (cli/gen_dataset.py, data/file_data.py, train(datapath=))
GEN_ARGS = ["--dur", "5", "--device-batch", "64", "--seed", "1"]
GEN_BATCH = 64
# the three datasets of 6a: (arguments, effect, files); the f32 set's Train
# corpus (201 files of 221,184 samples) is 356 MB on the card
GEN_RUNS = {"f32": (["-n", "250"], "comp_4c", 250),
            "pcm16": (["-n", "50", "--pcm16"], "comp_4c", 50),
            "comp": (["-e", "comp", "-n", "16"], "comp", 16)}
GEN_TOL = {"comp_4c": 1e-5, "comp": 1e-4}  # the card against the plain version (EFFECT_TOL)
FILE_STEPS = TRAIN_POINTS // TRAIN_BATCH  # 20 steps an epoch, 5 validation batches
BF16_NAMES = ["bf16_fused_analysis", "bf16_fused_synthesis", "bf16_fused_analysis_bwd",
              "bf16_fused_synthesis_bwd"]
# the counters of the mma.sync schedule of the kernels in both modes, which
# the main paths at the flagship geometry never take (the rule picks wgmma
# there)
F32_MMA_NAMES = ["fused_analysis_mma", "fused_synthesis_mma", "fused_analysis_bwd_mma",
                 "fused_synthesis_bwd_mma"]
MMA_NAMES = [name + "_mma" for name in BF16_NAMES] + F32_MMA_NAMES


def counted(fn):
    """(fn(), {counter: (launches, plain calls)}), every counter set to 0 just
    before fn() and read just after it (the card drained)."""
    from signaltrain_tpu_torch.ops import _cuda

    _cuda.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}


def no_plain(counts: dict, what: str) -> None:
    for k, (_, plain) in counts.items():
        check(plain == 0, f"{what} ran the plain version of {k}")


def in_dir(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def gen_against_plain(name: str, kernel, plain) -> dict:
    """A kernel at gen_dataset's shape against its plain version on the same
    inputs: the kernel's mean ms over 5 calls (CUDA events) and the plain's
    ms for one call; the outputs of the last timed kernel call and of the
    plain call held bit for bit to each other on every row."""
    kept = {}
    ms = cuda_ms(lambda: kept.update(got=kernel()), reps=5)
    plain_ms = cuda_ms(lambda: kept.update(want=plain()), reps=1, warmup=0)
    got, want = kept["got"], kept["want"]
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
          disagreement(f"{name} at {tuple(got.shape)}", got, want))
    return {"gen_ms": ms, "gen_plain_ms": plain_ms, "gen_max_abs_err": err,
            "gen_tolerance": "bit-equal to the plain version on every row"}


def gen_datasets(dev, root: str, results: dict) -> dict:
    """Phase 6a: the three datasets of GEN_RUNS written by cli.gen_dataset on
    the card, each counted: C (comp_4c; its row schedule) or L (comp) once a
    device batch of whole files, no plain version; the file counts of the
    80/20 split, the names, effect_info.ini read back by FileEffect; two
    targets of each held to the effect's plain version on the written input
    (the same knob arithmetic; rounded to 16 bits for --pcm16). Then C and L
    at that shape, all 64 rows bit-equal to their plain versions, timed
    beside their bounds, chain floors and plain versions."""
    from signaltrain_tpu_torch.cli import gen_dataset, time_lfilter, time_smoother
    from signaltrain_tpu_torch.data import audio_io, file_data
    from signaltrain_tpu_torch.dsp import effects, iir
    from signaltrain_tpu_torch.dsp import knobs as knobs_mod
    from signaltrain_tpu_torch.ops import cuda_kernels
    from signaltrain_tpu_torch.utils.card import sm_clock_mhz
    from signaltrain_tpu_torch.utils.card import bound_ms as bound

    report = {}
    for tag, (extra, name, n_files) in GEN_RUNS.items():
        argv = [tag] + GEN_ARGS + extra
        stats, counts = counted(lambda: in_dir(root, lambda: gen_dataset.main(argv)))
        path, batches = os.path.join(root, tag), math.ceil(n_files / GEN_BATCH)
        kernel = "lfilter" if name == "comp" else "switched_one_pole"
        check(counts[kernel][0] == batches,
              f"gen_dataset {tag}: kernel {kernel} launched {counts[kernel][0]} times, not "
              f"{batches}")
        check(counts["switched_one_pole_chunked"][0] == 0, f"gen_dataset {tag}: C ran chunked")
        check(name != "comp" or counts["switched_one_pole"][0] == 0, "gen_dataset comp launched C")
        no_plain(counts, f"gen_dataset {tag}")
        results[kernel]["launches_gen_dataset"] = (results[kernel].get("launches_gen_dataset", 0)
                                                   + counts[kernel][0])
        effect = effects.make_effect(name, device="cpu")
        n_val = sum(1 for i in range(n_files) if i / n_files > 0.8)
        listing = {sub: sorted(os.listdir(os.path.join(path, sub))) for sub in ("Train", "Val")}
        for sub, want in (("Train", n_files - n_val), ("Val", n_val)):
            targets = [f for f in listing[sub] if f.startswith("target_")]
            check(len(targets) == want and len(listing[sub]) == 2 * want,
                  f"gen_dataset {tag}: {len(listing[sub])} files in {sub}, wanted 2 x {want}")
            for f in targets:
                check(f.split("_")[2] == effect.name.split("_")[0] and f.count("__")
                      == effect.num_knobs and f"input_{f.split('_')[1]}_.wav" in listing[sub],
                      f"gen_dataset {tag}: a target's name {f}")
        fx = effects.make_effect("files", path=path, device=dev)
        check(fx.name == effect.name + "(files)" and fx.knob_names == effect.knob_names
              and np.array_equal(fx.knob_ranges, effect.knob_ranges),
              f"gen_dataset {tag}: effect_info.ini does not read back")
        err = 0.0
        for f in [f for f in listing["Train"] if f.startswith("target_")][:2]:
            x, _ = audio_io.read_audio_file(
                os.path.join(path, "Train", f"input_{f.split('_')[1]}_.wav"))
            y, _ = audio_io.read_audio_file(os.path.join(path, "Train", f))
            knobs_nn = knobs_mod.knobs_nn_from_wc(file_data.parse_knob_string(f)[None],
                                                  effect.knob_ranges)
            want = effect.go_batch(x[None], knobs_nn)[0][0].numpy()  # the plain versions
            if tag == "pcm16":
                want = audio_io.to_pcm16(want) / 32767.0
            check(x.shape == y.shape == (stats["signal_length"],), f"gen_dataset {tag}: lengths")
            err = max(err, float(np.abs(y - want).max()))
        tol = GEN_TOL[name] + (1.0 / 32767 if tag == "pcm16" else 0.0)
        check(err <= tol, f"gen_dataset {tag}: targets {err:.3e} off the plain version (tol {tol})")
        report[tag] = {"files": n_files, "seconds": stats["seconds"],
                       "files_per_s": stats["files_per_s"],
                       "steady_files_per_s": stats["steady_files_per_s"],
                       "batch_done_s": stats["batch_done_s"],
                       "card_ms_per_batch": stats["card_ms_per_batch"],
                       "card_ms_batches": stats["card_ms_batches"], "device_batches": batches,
                       "signal_length": stats["signal_length"],
                       "launches": counts[kernel][0], "kernel": kernel,
                       "max_abs_err_vs_plain": err, "tolerance": tol}
        steady = stats["steady_files_per_s"]
        rate = (f"{steady:.1f} files/s after the first batch" if steady is not None else
                "one device batch, a smoke reading, no steady rate")
        print(f"gen_dataset {tag} ({name}, {n_files} files of {stats['signal_length']} samples): "
              f"{stats['seconds']:.2f} s in all, {stats['files_per_s']:.1f} files/s ({rate}); card "
              f"{stats['card_ms_per_batch']:.3f} ms a device batch of {GEN_BATCH} "
              f"({[round(v, 3) for v in stats['card_ms_batches']]}); {kernel} launched "
              f"{counts[kernel][0]} times; 2 targets within {err:.3e} of the plain version "
              f"(tol {tol:.3e})")

    # C and L at gen_dataset's shape: whole files, a device batch
    n = report["f32"]["signal_length"]
    sm_mhz = sm_clock_mhz()
    g = torch.Generator(device=dev).manual_seed(GEN_BATCH)
    gx = torch.randn(GEN_BATCH, n, generator=g, device=dev)
    check(not cuda_kernels.uses_chunks(GEN_BATCH, n), "gen_dataset's C shape is not by rows")
    r = results["switched_one_pole"]
    aa, ar = torch.full((GEN_BATCH,), 0.99, device=dev), torch.full((GEN_BATCH,), 0.95, device=dev)
    r.update(gen_against_plain(
        "C", lambda: cuda_kernels.switched_one_pole_batched(gx, aa, ar),
        lambda: cuda_kernels.switched_one_pole_reference(gx, aa, ar)))
    r["gen_bound_ms"], r["gen_bound_by"] = bound(4.0 * gx.numel(),
                                                 4.0 * (2 * gx.numel() + 2 * GEN_BATCH))
    r["gen_chain_floor_ms"] = n * time_smoother.CHAIN_CYCLES / (sm_mhz * 1e3)
    r["gen_chain_cycles"] = time_smoother.CHAIN_CYCLES
    r["gen_shape"] = f"g {tuple(gx.shape)} (gen_dataset's device batch; row schedule)"
    r = results["lfilter"]
    attack = torch.empty(GEN_BATCH, device=dev).uniform_(1e-3, 4e-2, generator=g)
    b, a = iir.butter_lowpass(1, 1.0 / (attack * 44100.0))
    db = 20.0 * torch.log10(gx.abs() * 0.3 + 1e-6)
    zi = ((b[:, 1] - a[:, 1] * b[:, 0]) / (1.0 + a[:, 1]) * db[:, 0])[:, None]
    r.update(gen_against_plain("L", lambda: iir.lfilter(b, a, db, zi),
                               lambda: iir.lfilter_reference(b, a, db, zi)))
    r["gen_bound_ms"], r["gen_bound_by"] = time_lfilter.bound_ms(db, 1)
    r["gen_chain_floor_ms"] = time_lfilter.chain_floor_ms(n, 1, sm_mhz)
    r["gen_chain_cycles"] = time_lfilter.chain_cycles(1)
    r["gen_shape"] = f"x {tuple(db.shape)}, order 1 (gen_dataset -e comp's device batch)"
    for k in ("switched_one_pole", "lfilter"):
        r = results[k]
        r["gen_cycles_per_step"] = r["gen_ms"] * sm_mhz * 1e3 / n
        print(f"{k} at {r['gen_shape']}: {r['gen_ms']:.4f} ms, {r['gen_cycles_per_step']:.2f} "
              f"cycles a step (bound {r['gen_bound_ms']:.4f} ms by {r['gen_bound_by']}, chain "
              f"floor {r['gen_chain_floor_ms']:.4f} ms, {r['gen_chain_cycles']:.2f} cycles a step, "
              f"at {sm_mhz:.0f} MHz, plain {r['gen_plain_ms']:.1f} ms); all {GEN_BATCH} rows "
              f"bit-equal to the plain version (max|d| {r['gen_max_abs_err']:.1e})")
    return report


def train_and_replay(dev, tag: str, effect, datapath: str, epochs: int, limit: int,
                     sr: int, target_type: str = "stream") -> dict:
    """train(datapath=...) on the card in bf16 (batch 200, FILE_STEPS steps an
    epoch, seeded weights) in a temporary directory, counted; then the same
    run dispatched op by op on the same data (eager_steps on the dataset's
    batch function, or host_steps on a prefetcher of the same rng for the
    host tier): every loss, validation MAE and weight bit-equal. Returns the
    trained model, its history, the counts, the checkpoint's bytes and the
    tier."""
    from signaltrain_tpu_torch.data import file_data
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import train as train_mod

    points = FILE_STEPS * TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (model, hist), counts = counted(lambda: in_dir(tmp, lambda: train_mod.train(
            effect, epochs=epochs, n_data_points=points, batch_size=TRAIN_BATCH, cp_every=epochs,
            sr=sr, lr_max=TRAIN_LR, seed=TRAIN_SEED, device=dev, compute_dtype=BF16,
            datapath=datapath, target_type=target_type, device_resident_limit_bytes=limit,
            make_plots=False)))
        seconds = time.perf_counter() - t0
        ckpt = open(os.path.join(tmp, "modelcheckpoint.tar"), "rb").read()
    for k in BF16_NAMES:
        check(counts[k][0] > 0, f"file training {tag}: kernel {k} never launched")
        check(counts[k[5:]][0] == 0, f"file training {tag}: the float32 kernel {k[5:]} launched")
    for k in MMA_NAMES:
        check(counts[k][0] == 0, f"file training {tag}: a kernel took the mma.sync schedule ({k})")
    no_plain(counts, f"file training {tag}")
    check(len(hist["train_loss"]) == epochs * FILE_STEPS
          and bool(np.all(np.isfinite(hist["train_loss"]))), f"file training {tag}: the losses")

    kw = dict(sr=sr, rerun=target_type != "stream", device_resident_limit_bytes=limit)
    spec = model.spec
    tds = file_data.FileDataset(datapath + "/Train/", effect, spec.in_chunk_size,
                                spec.out_chunk_size, augment=True, **kw)
    host = not tds.device_resident
    tier = "host" if host else ("int16" if tds.device_resident_int16 else "f32")
    if host:
        kw["device_resident_limit_bytes"] = 0
    vds = file_data.FileDataset(datapath + "/Val/", effect, spec.in_chunk_size,
                                spec.out_chunk_size, augment=False, **kw)
    m = st_model(device=dev, sr=sr, num_knobs=effect.num_knobs, compute_dtype=BF16,
                 generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
    opt, lr_fn = train_mod.make_optimizer(m, TRAIN_LR, points, epochs, TRAIN_BATCH)
    g, losses, maes = torch.Generator(device=dev), [], []
    val_steps = max(1, (points // 4) // TRAIN_BATCH)
    pf = tds.prefetch_batches(TRAIN_BATCH, np.random.default_rng(TRAIN_SEED)) if host else None
    try:
        for epoch in range(epochs):
            s0 = epoch * FILE_STEPS
            if host:
                part = train_mod.host_steps(m, opt, lr_fn, pf.next, s0, FILE_STEPS)
            else:
                part = train_mod.eager_steps(m, opt, lr_fn, tds.batch_fn, TRAIN_BATCH, g,
                                             TRAIN_SEED, s0, FILE_STEPS)
            losses += part.cpu().tolist()
            m.eval()
            if host:
                vrng = np.random.default_rng(7)
                mae = train_mod.host_validation(
                    m, (vds.host_batch(TRAIN_BATCH, vrng) for _ in range(val_steps)))[1]
            else:
                mae = train_mod.eager_validation(m, vds.batch_fn, TRAIN_BATCH, g, val_steps)[1]
            maes.append(float(mae.cpu().numpy().mean()))
            m.train()
    finally:
        if pf is not None:
            pf.close()
    check(losses == hist["train_loss"] and maes == hist["val_mae_mean"],
          f"file training {tag}: CUDA graphs and eager dispatch differ: {hist['train_loss']} "
          f"{losses} {hist['val_mae_mean']} {maes}")
    check(all(torch.equal(a, b) for a, b in zip(m.parameters(), model.parameters())),
          f"file training {tag}: CUDA graphs and eager dispatch differ in the weights")
    print(f"train(datapath, {tag}, {tier} tier) {seconds:.2f} s: losses first "
          f"{hist['train_loss'][0]:.4e} last {hist['train_loss'][-1]:.4e}, mean validation MAE "
          f"by epoch {hist['val_mae_mean']}; launches "
          f"{json.dumps({k: v[0] for k, v in counts.items() if v[0]})}; bit-equal to eager "
          f"dispatch ({len(losses)} losses, {len(maes)} validation passes, every weight)")
    return {"model": model, "hist": hist, "counts": counts, "ckpt": ckpt, "tier": tier,
            "seconds": seconds, "train_ds": tds}


def file_datasets(dev, results: dict, sr: int, smi: str) -> dict:
    """Phase 6: file datasets at the flagship geometry, batch 200, bf16, each
    part in a temporary directory: 6a gen_dataset on the card; 6b train() on
    the resident f32 tier (3 x 20 steps, bit-equal to eager, the validation
    MAE falling); 6c the int16 tier on the --pcm16 set (its batches for step
    generators 0, 1, 19 equal to the f32 tier's; 20 steps bit-equal); 6d the
    host tier (the prefetched batches equal to host_batch replayed from
    default_rng(seed); 20 graph steps bit-equal to eager on the same
    batches); 6e -t chunk (C counted inside the replays); 6f the 6b
    checkpoint served by cli.predict_long -e files. Then each tier's loop
    timed in turns with the synthetic comp_4c loop."""
    from signaltrain_tpu_torch.cli import predict_long as pl_cli
    from signaltrain_tpu_torch.data import audio_io, file_data, synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    report = {}
    with tempfile.TemporaryDirectory() as root:
        t_phase = time.perf_counter()
        report["gen_dataset"] = gen_datasets(dev, root, results)
        f32set, p16set = os.path.join(root, "f32"), os.path.join(root, "pcm16")
        fx = effects.make_effect("files", path=f32set, device=dev)
        fx16 = effects.make_effect("files", path=p16set, device=dev)
        comp4c = effects.make_effect("comp_4c", sr=sr, device=dev)

        # 6b: the resident f32 tier, 3 epochs
        b = train_and_replay(dev, "6b", fx, f32set, TRAIN_EPOCHS, 4 << 30, sr)
        maes = b["hist"]["val_mae_mean"]
        check(b["tier"] == "f32", f"6b ran the {b['tier']} tier")
        check(b["counts"]["switched_one_pole"][0] == 0, "6b launched C (the targets are files)")
        check(maes[-1] < maes[0], f"6b: the validation MAE did not fall: {maes}")
        chunk, out_chunk = b["model"].spec.in_chunk_size, b["model"].spec.out_chunk_size
        f32_bytes = 2 * len(b["train_ds"].lengths) * int(b["train_ds"].lengths.max()) * 4

        # 6c: the int16 tier on the 16-bit set, its batches against the f32 tier's
        p32 = file_data.FileDataset(p16set + "/Train/", fx16, chunk, out_chunk)
        limit16 = 2 * len(p32.lengths) * int(p32.lengths.max()) * 4 - 1
        p16 = file_data.FileDataset(p16set + "/Train/", fx16, chunk, out_chunk,
                                    device_resident_limit_bytes=limit16)
        check(p16.device_resident_int16 and p16.x.dtype == torch.int16, "6c: not the int16 tier")
        g1, g2 = torch.Generator(device=dev), torch.Generator(device=dev)
        for step in (0, 1, 19):
            u = p16.batch_fn(TRAIN_BATCH, synth_data.step_generator(g1, TRAIN_SEED, step))
            v = p32.batch_fn(TRAIN_BATCH, synth_data.step_generator(g2, TRAIN_SEED, step))
            check(all(torch.equal(a, b_) for a, b_ in zip(u, v)),
                  f"6c: the int16 tier's batch of step {step} differs from the f32 tier's")
        print("6c: the int16 tier's batches of steps 0, 1, 19 are the f32 tier's, bit for bit")
        c = train_and_replay(dev, "6c", fx16, p16set, 1, limit16, sr)
        check(c["tier"] == "int16", f"6c ran the {c['tier']} tier")

        # 6d: the host tier, below the int16 size of the f32 set
        limit_host = f32_bytes // 2 - 1
        hds = file_data.FileDataset(f32set + "/Train/", fx, chunk, out_chunk,
                                    device_resident_limit_bytes=limit_host)
        check(not hds.device_resident, "6d: not the host tier")
        pf, rng = hds.prefetch_batches(TRAIN_BATCH, np.random.default_rng(TRAIN_SEED)), \
            np.random.default_rng(TRAIN_SEED)
        try:
            for _ in range(FILE_STEPS):
                hb = pf.next()
                want = hds.host_batch(TRAIN_BATCH, rng)
                check(all(np.array_equal(t_.numpy(), w) for t_, w in zip(hb.tensors, want)),
                      "6d: a prefetched batch differs from host_batch")
                check(all(t_.is_pinned() for t_ in hb.tensors), "6d: a host buffer is not pinned")
                hb.release()
        finally:
            pf.close()
        print(f"6d: {FILE_STEPS} prefetched batches are host_batch's from default_rng(seed)")
        d = train_and_replay(dev, "6d", fx, f32set, 1, limit_host, sr)
        check(d["tier"] == "host", f"6d ran the {d['tier']} tier")

        # 6e: -t chunk, C inside the captured step and validation batch
        e = train_and_replay(dev, "6e", comp4c, f32set, 1, 4 << 30, sr, target_type="chunk")
        c_launches = e["counts"]["switched_one_pole"][0]
        check(c_launches == FILE_STEPS + (FILE_STEPS * TRAIN_BATCH // 4) // TRAIN_BATCH,
              f"6e: C launched {c_launches} times")
        results["switched_one_pole"]["launches_file_training"] = c_launches
        for k in BF16_NAMES:
            results[k]["launches_file_training"] = sum(r["counts"][k][0] for r in (b, c, d, e))

        # 6f: the 6b checkpoint served by predict_long -e files on a Val input
        with tempfile.TemporaryDirectory() as tmp:
            open(os.path.join(tmp, "files.tar"), "wb").write(b["ckpt"])
            val = sorted(f for f in os.listdir(f32set + "/Val") if f.startswith("target_"))[0]
            idx = val.split("_")[1]
            knobs = file_data.parse_knob_string(val)
            argv = ["files.tar", os.path.join(f32set, "Val", f"input_{idx}_.wav"), "-e", "files",
                    "--knobs=" + ",".join(str(float(v)) for v in knobs)]
            _, counts = counted(lambda: in_dir(tmp, lambda: pl_cli.main(argv)))
            preds = [f for f in os.listdir(tmp) if f.startswith("pl_pred")]
            check(len(preds) == 1, f"6f: predict_long wrote {preds}")
            pred, _ = audio_io.read_audio_file(os.path.join(tmp, preds[0]))
        for k in ("fused_analysis", "fused_synthesis"):
            check(counts[k][0] > 0, f"6f: serving never launched kernel {k}")
            results[k]["launches_file_serving"] = counts[k][0]
        no_plain(counts, "6f serving")
        target, _ = audio_io.read_audio_file(os.path.join(f32set, "Val", val))
        lookback = chunk - out_chunk
        check(pred.shape == target.shape and bool(np.all(np.isfinite(pred))),
              "6f: the prediction's length, or it is not finite")
        corr = float(np.corrcoef(pred[lookback:], target[lookback:])[0, 1])
        print(f"6f: predict_long -e files on Val input {idx} ({len(pred)} samples) with the 6b "
              f"checkpoint: corr(prediction, target) {corr:.4f}; launches "
              f"{json.dumps({k: v[0] for k, v in counts.items() if v[0]})}")
        report["training"] = {
            k: {"tier": r["tier"], "seconds": r["seconds"], "losses": r["hist"]["train_loss"],
                "val_mae_mean": r["hist"]["val_mae_mean"], "graph_equals_eager": True,
                "launches": {n_: v[0] for n_, v in r["counts"].items() if v[0]}}
            for k, r in (("6b_f32", b), ("6c_int16", c), ("6d_host", d), ("6e_chunk", e))}
        report["serving"] = {"corr": corr, "samples": len(pred)}

        # each tier's loop in turns with the synthetic comp_4c loop: blocks of
        # LOOP_BLOCK steps under CUDA graphs, one fetch a block, as train() runs
        def fresh():
            m = st_model(device=dev, sr=sr, num_knobs=4, compute_dtype=BF16,
                         generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
            return m, *train_mod.make_optimizer(m, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS,
                                                TRAIN_BATCH)

        rerun = file_data.FileDataset(f32set + "/Train/", comp4c, chunk, out_chunk,
                                      rerun=True)
        sources = {"synthetic": synth_data.make_synth_batch_fn(comp4c, chunk, out_chunk, sr=sr),
                   "f32": b["train_ds"].batch_fn, "int16": p16.batch_fn, "chunk": rerun.batch_fn}
        loops, prefetchers = {}, []
        try:
            for way, batch_fn in sources.items():
                m, opt, lr_fn = fresh()
                loops[way] = graphs.TrainGraph(m, opt, lr_fn, batch_fn, TRAIN_BATCH,
                                               torch.Generator(device=dev), TRAIN_SEED, LOOP_BLOCK)
            m, opt, lr_fn = fresh()
            prefetchers.append(hds.prefetch_batches(TRAIN_BATCH, np.random.default_rng(TRAIN_SEED)))
            shapes = [(TRAIN_BATCH, chunk), (TRAIN_BATCH, out_chunk), (TRAIN_BATCH, 4)]
            loops["host"] = graphs.ArraysTrainGraph(m, opt, lr_fn, prefetchers[0].next, shapes,
                                                    LOOP_BLOCK)
            for graph in loops.values():
                graph(0, LOOP_BLOCK)  # the capture's warm-up and 19 replays
            runs = {way: [] for way in loops}
            order = ["synthetic", "f32", "int16", "host", "chunk"]
            for way in order + order[::-1]:
                runs[way].append(host_ms(lambda: loops[way](LOOP_BLOCK, LOOP_BLOCK).cpu(), reps=3,
                                         warmup=1) / LOOP_BLOCK)
            timing = {}
            for way, graph in loops.items():
                ms = sum(runs[way]) / len(runs[way])
                prof = card_busy(lambda: graph(LOOP_BLOCK, LOOP_BLOCK).cpu(), reps=1)
                busy = prof["card_busy_ms"] / LOOP_BLOCK
                timing[way] = {"loop_ms": ms, "loop_ms_min_max": [min(runs[way]), max(runs[way])],
                               "examples_per_s": TRAIN_BATCH / ms * 1e3, "card_busy_ms": busy,
                               "gap_ms": ms - busy,
                               "kernels_on_card": prof["kernels_launched"] / LOOP_BLOCK,
                               "host_launch_calls": prof["host_launch_calls"] / LOOP_BLOCK}
                print(f"file loop {way} (bf16, batch {TRAIN_BATCH}, data + step, {LOOP_BLOCK} "
                      f"steps a block): {ms:.3f} ms a step [{min(runs[way]):.3f}, "
                      f"{max(runs[way]):.3f}], {timing[way]['examples_per_s']:.0f} examples/s; "
                      f"card busy {busy:.3f} ms, gap {ms - busy:.3f} ms, "
                      f"{timing[way]['kernels_on_card']:.1f} kernels a step on {smi}")
        finally:
            for p in prefetchers:
                p.close()
        report["loop"] = timing
        report["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"file_datasets": report}))
    return report


# ---- phase 7: train()'s whole surface (plots, the background writer,
# --profile, the fetches one block and one epoch behind, lr_finder, dropout)
SURFACE_POINTS = 3 * TRAIN_POINTS  # 7c: 60 steps an epoch, 15 validation batches
SURFACE_STEPS = SURFACE_POINTS // TRAIN_BATCH
# 7c's loops, each otherwise train()'s defaults (status every 10 batches: 30
# steps a fetch; plots every 10 epochs; a checkpoint every 25): the defaults;
# a status cadence that does not divide the epoch (a fetch a step); the 50
# validation plots every epoch; a checkpoint every epoch
SURFACE_LOOPS = {"default": {}, "ragged": dict(status_every=7), "plots": dict(plot_every=1),
                 "checkpoints": dict(cp_every=1)}
# the kernels of the front-end's libraries (csrc/frontend.cu, frontend_bwd.cu,
# tc_product.cuh, wgmma_product.cuh), by base name: a train step launches them
# in four runs, A, B, E, D (the wgmma schedules' products, A's and B's
# included, are all "product<...>")
FRONTEND_KERNELS = {"product", "spectrum_rows", "overlap_add", "halve_to_bf16", "pack_weights",
                    "pack_transposed", "pack_split_weights", "pack_split_transposed",
                    "pack_split_synthesis_rows", "pad_dout",
                    "pad_dout_zero_edges", "synthesis_adjoint", "sum_analysis_partials",
                    "sum_synthesis_partials"}
# a name each of A-E launches and nothing else does (the template argument of
# A's and D's and E's products, B's first pass, C's row schedule)
KERNEL_MARKS = {"A": "AnalysisFwd", "B": "spectrum_rows", "C": "smoother_kernel",
                "D": "AnalysisDspec", "E": "SynthesisDspec"}
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
DROPOUT_RATE = 0.2


def timed(fn):
    """(fn(), {epoch: {bucket: seconds}}, stdout): fn() with ST_TPU_TIMING=1,
    its per-epoch timing lines (stderr) parsed and its stdout kept aside."""
    import contextlib
    import io
    import re

    err, out = io.StringIO(), io.StringIO()
    os.environ["ST_TPU_TIMING"] = "1"
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            result = fn()
    finally:
        del os.environ["ST_TPU_TIMING"]
    epochs = {}
    for m in re.finditer(r"\[timing\] epoch (\d+): total=([\d.]+)s (.*)", err.getvalue()):
        buckets = dict(kv.split("=") for kv in m.group(3).split())
        epochs[int(m.group(1))] = {"total": float(m.group(2)),
                                   **{k: float(v) for k, v in buckets.items()}}
    return result, epochs, out.getvalue()


def kernel_base(name: str) -> str:
    """A kernel's function name without namespaces, template arguments or
    parameters."""
    import re

    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", n, 1)[0].split("::")[-1].strip()


def block_split(trace_path: str, steps: int, block: int = 1) -> dict:
    """The card's time a step in one ``train.block`` span of a torch.profiler
    trace of train() (the ``block``-th, all graph replays), in five groups
    by each replay's kernel order: its device events grouped by the
    correlation of their cudaGraphLaunch, the front-end's library kernels in
    four runs (A, the autoencoders, B, the loss, E, the autoencoders' backward,
    D), data synthesis before the first run, clip + Adam after the last. The
    front-end's weight stacking and its backward (plain torch copies) fall in
    the groups beside its runs. Returns ms a step by group, kernels a step by
    group, and the ten kernels of most time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    blocks = sorted((e for e in events if e.get("name") == "train.block"
                     and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    check(len(blocks) > block, f"trace: {len(blocks)} train.block spans")
    t0, t1 = blocks[block]["ts"], blocks[block]["ts"] + blocks[block]["dur"]
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")
                and t0 <= e["ts"] <= t1}
    check(len(launches) == steps, f"trace: {len(launches)} graph launches in the block, not {steps}")
    replays = {}
    for e in events:
        if e.get("cat") in DEVICE_EVENTS and e.get("args", {}).get("correlation") in launches:
            replays.setdefault(e["args"]["correlation"], []).append(e)
    check(len(replays) == steps, f"trace: device events of {len(replays)} replays, not {steps}")
    groups = ("data_synthesis", "frontend_kernels", "autoencoders", "loss", "clip_adam")
    ms = dict.fromkeys(groups, 0.0)
    kernels = dict.fromkeys(groups, 0)
    by_name = {}
    for evs in replays.values():
        evs.sort(key=lambda e: e["ts"])
        lib = [kernel_base(e["name"]) in FRONTEND_KERNELS for e in evs]
        starts = [i for i in range(len(evs)) if lib[i] and (i == 0 or not lib[i - 1])]
        ends = [i for i in range(len(evs)) if lib[i] and (i + 1 == len(evs) or not lib[i + 1])]
        check(len(starts) == 4, f"trace: a replay's front-end kernels in {len(starts)} runs, not 4: "
              + ", ".join(kernel_base(e["name"]) for e in evs if kernel_base(e["name"])
                          in FRONTEND_KERNELS))
        for i, e in enumerate(evs):
            if lib[i]:
                g = "frontend_kernels"
            elif i < starts[0]:
                g = "data_synthesis"
            elif i > ends[3]:
                g = "clip_adam"
            elif ends[1] < i < starts[2]:
                g = "loss"
            else:
                g = "autoencoders"
            ms[g] += e["dur"] / 1e3 / steps
            kernels[g] += 1
            key = kernel_base(e["name"]) or e["name"]
            t, c = by_name.get(key, (0.0, 0))
            by_name[key] = (t + e["dur"] / 1e3 / steps, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"ms_a_step": ms, "total_ms_a_step": sum(ms.values()),
            "kernels_a_step": {g: c / steps for g, c in kernels.items()},
            "top_kernels": [{"name": k, "ms_a_step": t, "launches_a_step": c / steps}
                            for k, (t, c) in top]}


def train_surface(dev, results: dict, sr: int, smi: str, phase4: dict) -> dict:
    """Phase 7 (module docstring): 7a train() with plots, the writer and
    --profile, bit-equal to phase 4's bf16 run; 7b the card's split of a step
    from its trace; 7c the loop's ms a step by fetch cadence and with the
    whole surface on; 7d lr_finder; 7e dropout."""
    from signaltrain_tpu_torch.cli import lr_finder
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import train as train_mod
    from signaltrain_tpu_torch.utils import profiling
    from signaltrain_tpu_torch.utils.load_model import load_model

    t_phase = time.perf_counter()
    report = {}
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    kw = dict(batch_size=TRAIN_BATCH, sr=sr, lr_max=TRAIN_LR, seed=TRAIN_SEED, device=dev,
              compute_dtype=BF16)
    kernel_names = BF16_NAMES + ["switched_one_pole"]

    # ---- 7a: the default run (phase 4's bf16 one) with plots, a checkpoint
    # an epoch on the writer, inside the profiler
    with tempfile.TemporaryDirectory() as tmp:
        def run():
            with profiling.trace(os.path.join(tmp, "trace")):
                return train_mod.train(effect, epochs=TRAIN_EPOCHS, n_data_points=TRAIN_POINTS,
                                       cp_every=1, plot_every=3, make_plots=True, **kw)

        t0 = time.perf_counter()
        ((model, hist), epochs, _), counts = counted(lambda: in_dir(tmp, lambda: timed(run)))
        report["7a_seconds"] = time.perf_counter() - t0
        check(hist["train_loss"] == phase4["hist"]["train_loss"],
              "7a: train() with its surface differs from phase 4's bf16 run in the losses")
        for key in ("val_loss", "val_mae", "val_mae_mean", "step"):
            check(hist[key] == phase4["hist"][key], f"7a: history {key} differs from phase 4's")
        check(all(torch.equal(v, phase4["weights"][k]) for k, v in model.state_dict().items()),
              "7a: the final weights differ from phase 4's bf16 run")
        names = os.listdir(tmp)
        check(sorted(n for n in names if n.startswith("val_data_"))
              == sorted(f"val_data_{i}.png" for i in range(50)), "7a: not 50 val_data_*.png")
        check({"mag.png", "mag_hat.png", "conv_anal_real.png", "conv_anal_imag.png",
               "conv_synth_real.png", "conv_synth_imag.png"} <= set(names),
              "7a: a spectrogram or weight image is missing")
        served, rv = load_model(os.path.join(tmp, "modelcheckpoint.tar"), device=dev,
                                compute_dtype=BF16)  # strict inside
        check(rv["optax_step"] == len(hist["train_loss"]) and rv["epoch"] == TRAIN_EPOCHS,
              "7a: the checkpoint's step or epoch")
        check(all(torch.equal(a, b) for a, b in zip(served.state_dict().values(),
                                                   model.state_dict().values())),
              "7a: the checkpoint's weights are not the final ones")
        vl = [ln.split() for ln in open(os.path.join(tmp, "vl_avg_out.dat")).read().splitlines()]
        mae = [ln.split() for ln in open(os.path.join(tmp, "val_err_mae.dat")).read().splitlines()]
        check(vl == [[str(e + 1), f"{v:.3e}"] for e, v in enumerate(hist["val_loss"])],
              "7a: vl_avg_out.dat differs from history")
        check(mae == [[str(e + 1), f"{a:.3e}", f"{b:.3e}"] for e, (a, b) in
                      enumerate(zip(hist["val_mae"], hist["val_mae_mean"]))],
              "7a: val_err_mae.dat differs from history")
        for k in kernel_names:
            check(counts[k][0] > 0, f"7a: kernel {k} never launched")
            results[k]["launches_surface"] = counts[k][0]
        no_plain(counts, "7a")
        traces = sorted(os.listdir(os.path.join(tmp, "trace")))
        check(len(traces) == 1, f"7a: trace files {traces}")
        trace_path = os.path.join(tmp, "trace", traces[0])
        text = open(trace_path).read()
        missing = [k for k, mark in KERNEL_MARKS.items() if mark not in text]
        check(not missing, f"7a: the trace names no kernel of {missing}")
        report["7a_trace_mb"] = len(text) / 2**20
        report["7a_epoch_ms_a_step"] = {e: v["total"] * 1e3 / (TRAIN_POINTS // TRAIN_BATCH)
                                        for e, v in epochs.items()}
        # ---- 7b: the card's time a step, split, from the second block
        report["7b"] = block_split(trace_path, TRAIN_POINTS // TRAIN_BATCH)
    b = report["7b"]
    print(f"7a: train() with plots (plot_every 3), a checkpoint an epoch on the writer and the "
          f"profiler: bit-equal to phase 4's bf16 run; 50 val_data plots and 6 images; the "
          f"checkpoint strict; trace {report['7a_trace_mb']:.1f} MB naming A-E; "
          f"{report['7a_seconds']:.2f} s")
    print(f"7b: card ms a step (one block of {TRAIN_POINTS // TRAIN_BATCH} replays, bf16, batch "
          f"{TRAIN_BATCH}): " + ", ".join(f"{g} {v:.4f} ({b['kernels_a_step'][g]:.0f} kernels)"
                                          for g, v in b["ms_a_step"].items())
          + f"; total {b['total_ms_a_step']:.4f} ms on {smi}")
    print("7b: top kernels, ms a step: " + "; ".join(
        f"{k['name'][:60]} {k['ms_a_step']:.4f} ({k['launches_a_step']:.0f})"
        for k in b["top_kernels"]))

    # ---- 7c: ms a step by cadence, in turns (each train() in its own
    # directory; epoch 2's wall time over its 60 steps and 15 validation
    # batches: the steady epoch, its graphs captured in epoch 1)
    runs, buckets = {way: [] for way in SURFACE_LOOPS}, {}
    for way in ("default", "ragged", "plots", "checkpoints", "checkpoints", "plots", "ragged",
                "default"):
        with tempfile.TemporaryDirectory() as tmp:
            (_, h), epochs, _ = in_dir(tmp, lambda: timed(lambda: train_mod.train(
                effect, epochs=3, n_data_points=SURFACE_POINTS, **{**kw, **SURFACE_LOOPS[way]})))
            check(len(h["train_loss"]) == 3 * SURFACE_STEPS, f"7c {way}: step count")
            runs[way].append(epochs[2]["total"] * 1e3 / SURFACE_STEPS)
            buckets[way] = epochs[2]  # the last turn's epoch 2, seconds by bucket
    loops = {way: {"ms_a_step": sum(v) / len(v), "min_max": [min(v), max(v)],
                   "n_inner": train_mod.pick_n_inner(
                       SURFACE_STEPS, SURFACE_LOOPS[way].get("status_every", 10)),
                   "epoch2_seconds": buckets[way]}
             for way, v in runs.items()}
    base = loops["default"]["ms_a_step"]
    for v in loops.values():
        v["gap_vs_default"] = v["ms_a_step"] / base - 1
    p4 = phase4["epochs"][2]["total"] * 1e3 / (TRAIN_POINTS // TRAIN_BATCH)
    loops["phase4_bf16_epoch2_ms_a_step"] = p4
    loops["default_vs_phase4"] = base / p4 - 1
    report["7c"] = loops
    for way in SURFACE_LOOPS:
        v = loops[way]
        print(f"7c: {way} (n_inner {v['n_inner']}, {SURFACE_LOOPS[way] or 'the defaults'}): "
              f"{v['ms_a_step']:.4f} ms a step [{v['min_max'][0]:.4f}, {v['min_max'][1]:.4f}], "
              f"{v['gap_vs_default']:+.2%} against the defaults; epoch 2 in s: "
              + " ".join(f"{k} {t:.4f}" for k, t in v["epoch2_seconds"].items()) + f" on {smi}")
    print(f"7c: phase 4's bf16 train() in its epoch 2: {p4:.4f} ms a step (20 steps, 5 validation "
          f"batches); the defaults at 60 steps {loops['default_vs_phase4']:+.2%} against it")

    # ---- 7d: lr_finder on the card, counted
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (_, _, _), counts = counted(lambda: in_dir(tmp, lambda: timed(lambda: lr_finder.main(
            ["-b", str(TRAIN_BATCH), "--npoints", "8", "--trials", "2", "--sr", str(sr),
             "--device", str(dev)]))))
        seconds = time.perf_counter() - t0
        found = np.loadtxt(os.path.join(tmp, "lrfind.dat"))
        check(found.shape == (8, 2) and bool(np.all(np.isfinite(found))),
              f"7d: lrfind.dat {found.shape}, finite {bool(np.all(np.isfinite(found)))}")
        check(os.path.isfile(os.path.join(tmp, "lrfind.png")), "7d: no lrfind.png")
    for k in kernel_names:
        check(counts[k][0] > 0, f"7d: kernel {k} never launched")
        results[k]["launches_lr_finder"] = counts[k][0]
    no_plain(counts, "7d")
    report["7d"] = {"seconds": seconds, "losses": found[:, 1].tolist()}
    print(f"7d: lr_finder -b {TRAIN_BATCH} --npoints 8 --trials 2 on the card, {seconds:.2f} s: "
          f"losses {[f'{v:.3e}' for v in found[:, 1]]}")

    # ---- 7e: dropout on the card, twice from one generator seed
    # float32: a bf16 product rounds to an exact zero now and then, as a drop does
    m = st_model(device=dev, sr=sr, generator=torch.Generator().manual_seed(TRAIN_SEED),
                 compute_dtype=torch.float32, dropout_rate=DROPOUT_RATE).train()
    with torch.no_grad():  # biases off zero, as training leaves them: a row that an
        # earlier dropout zeroed then reaches the output nonzero, and only the
        # last dropout's rows come out zero
        cpu_gen = torch.Generator().manual_seed(1)
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=cpu_gen).to(dev) * 0.1)
    spec = m.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size,
                                              sr=sr)
    x, _, knobs = batch_fn(TRAIN_BATCH, synth_data.step_generator(torch.Generator(device=dev),
                                                                   TRAIN_SEED, 0))
    with torch.no_grad():
        outs = [m(x, knobs, deterministic=False, return_acts=True,
                  generator=torch.Generator(device=dev).manual_seed(11)) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(outs[0][:3] + tuple(outs[0][3]),
                                               outs[1][:3] + tuple(outs[1][3]))),
          "7e: two runs from one generator seed differ")
    rows = outs[0][3][4 + 10 + 9]  # the phase autoencoder's output, (B, F, OT), after dropout
    dropped = (rows == 0).all(-1)
    check(torch.equal(dropped, (rows == 0).any(-1)), "7e: a row is dropped in part")
    kept = 1.0 - float(dropped.float().mean())
    sigma = (DROPOUT_RATE * (1 - DROPOUT_RATE) / dropped.numel()) ** 0.5
    check(abs(kept - (1 - DROPOUT_RATE)) <= 3 * sigma,
          f"7e: kept share {kept:.5f}, not within 3 sigma ({3 * sigma:.5f}) of 0.8")
    report["7e"] = {"kept_share": kept, "three_sigma": 3 * sigma, "rows": dropped.numel()}
    print(f"7e: dropout {DROPOUT_RATE} on the card: two runs bit-equal; whole rows; kept share "
          f"{kept:.5f} of {dropped.numel()} rows (0.8 +- {3 * sigma:.5f})")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 7: {report['seconds']:.2f} s")
    return report


# ---- phase 8: the rest of the single-card surface: gen_dataset's host
# backend, the DCT and FNN front-ends, cli.viz, cli.knob_sweep, DemoState and
# the reference-API facades
HOST_ARGS = ["--dur", "5", "-n", "64", "--device-batch", "8", "--seed", "1", "-e", "comp_4c"]
HOST_FILES, HOST_WORKERS = 64, 8
# the C++ compressor (float64) against kernel C (float32) over a file's first
# 8192 samples: the JAX package's tolerance for them at that length
# (tests/test_native_oracle.py:10-18)
HOST_HEAD, HOST_HEAD_TOL = 8192, 2e-5
# Over whole 5 s files (221,184 steps) the two recursions part further, but
# not without bound: kernel C's float32 rounding of the dB envelope is carried
# only over the smoother's memory, 1/(1 - alpha) <= 800 steps at comp_4c's
# slowest setting (0.04 s), about 1e-3 dB on a 30 dB envelope, 1.6e-4 of a
# sample at the very worst. Its plain version (bit-equal to C) showed 5.1e-6
# on 64 such files on the CPU; the limit is ten times that reading.
HOST_WHOLE_TOL = 5e-5
DCT_GEOM = (1024, 2048, 1024)  # ft, w, hop
FE_BATCH, FE_TOL = 200, 1e-4  # the DCT and FNN front-ends against float64
SWEEP_FRAMES = 8
SERVE_TOL = 1e-3  # the card against the CPU path (the model-output tolerance)
ST_MODEL_PARAMS = 4211090  # the JAX package's st_model() at its defaults
PHASE8_LIMIT_S = 60.0
SERVING_KERNELS = ("fused_analysis", "fused_synthesis", "switched_one_pole")


def host_backend(dev, root: str) -> dict:
    """8a: gen_dataset's host backend beside its device backend on one
    corpus size; the host targets against kernel C on the inputs read back;
    --backend auto on the card."""
    import contextlib
    import io
    import re

    from signaltrain_tpu_torch.cli import gen_dataset
    from signaltrain_tpu_torch.data import audio_io
    from signaltrain_tpu_torch.data.file_data import parse_knob_string
    from signaltrain_tpu_torch.dsp import effects

    host, counts = counted(lambda: in_dir(root, lambda: gen_dataset.main(
        ["host", *HOST_ARGS, "--backend", "host", "--workers", str(HOST_WORKERS)])))
    check(all(v == (0, 0) for v in counts.values()),
          f"8a: the host backend used the card: {counts}")
    check(host["backend"] == "host" and host["files"] == HOST_FILES
          and host["workers"] == HOST_WORKERS, f"8a: host backend {host}")
    device, counts = counted(lambda: in_dir(root, lambda: gen_dataset.main(
        ["device", *HOST_ARGS, "--backend", "device", "--device", str(dev)])))
    check(counts["switched_one_pole"][0] == HOST_FILES // 8,
          f"8a: the device backend launched C {counts['switched_one_pole'][0]} times")
    no_plain(counts, "8a (device backend)")
    launches = counts["switched_one_pole"][0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        auto = in_dir(root, lambda: gen_dataset.main(
            ["auto", "--dur", "5", "-n", "8", "--device-batch", "8", "--backend", "auto",
             "--device", str(dev)]))
    said = re.search(r"device->host pull (\d+) MB/s -> (\w+)", out.getvalue())
    check(said is not None and said.group(2) == "device" and auto["backend"] == "device",
          f"8a: --backend auto on the card: {said and said.group(0)}, {auto['backend']}")

    xs, ys, kws = [], [], []
    for sub in ("Train", "Val"):
        d = os.path.join(root, "host", sub)
        for name in sorted(f for f in os.listdir(d) if f.startswith("target_")):
            xs.append(audio_io.read_audio_file(os.path.join(d, f"input_{name.split('_')[1]}_.wav"),
                                               warn=False)[0])
            ys.append(audio_io.read_audio_file(os.path.join(d, name), warn=False)[0])
            kws.append(parse_knob_string(name))
    check(len(xs) == HOST_FILES, f"8a: {len(xs)} host targets")
    fx = effects.Compressor_4c(device=dev)
    x = torch.from_numpy(np.stack(xs)).to(dev)
    (yd, _), counts = counted(lambda: fx.go_wc(x, torch.from_numpy(np.stack(kws)).to(dev)))
    check(counts["switched_one_pole"][0] > 0, "8a: the comparison did not launch C")
    no_plain(counts, "8a (the card's targets)")
    launches += counts["switched_one_pole"][0]
    err = np.abs(yd.cpu().numpy() - np.stack(ys))
    head, whole = float(err[:, :HOST_HEAD].max()), float(err.max())
    check(head <= HOST_HEAD_TOL, f"8a: host targets against kernel C over the first {HOST_HEAD} "
          f"samples: {head:.3e} > {HOST_HEAD_TOL}")
    check(whole <= HOST_WHOLE_TOL, f"8a: host targets against kernel C over whole files: "
          f"{whole:.3e} > {HOST_WHOLE_TOL}")
    return {"host_files_per_s": host["files_per_s"], "host_seconds": host["seconds"],
            "device_files_per_s": device["files_per_s"],
            "device_steady_files_per_s": device["steady_files_per_s"],
            "device_seconds": device["seconds"], "device_card_ms_per_batch":
            device["card_ms_per_batch"], "auto_pull_mb_s": float(said.group(1)),
            "head_max_abs_err": head, "whole_max_abs_err": whole,
            "signal_length": host["signal_length"], "c_launches": launches}


def frontend_variants(dev) -> dict:
    """8b: the DCT front-end on (200, 8192) and the FNN front-end on (200,
    25, 1024) frames, each against float64 on the same parameters (in bf16
    the same operands rounded to bf16), the round trips, finite gradients,
    and their times."""
    from signaltrain_tpu_torch.ops import dct_frontend, framing, frontend

    ft, w, hop = DCT_GEOM
    half = ft // 2 + 1
    g = torch.Generator(device=dev).manual_seed(8)
    x = 0.3 * torch.randn(FE_BATCH, 8192, generator=g, device=dev)
    frames = torch.randn(FE_BATCH, 25, ft, generator=g, device=dev)
    report = {}
    for dtype in (torch.float32, BF16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        rnd = (lambda a: a.detach().to(BF16).double()) if dtype == BF16 else (
            lambda a: a.detach().double())
        ana = dct_frontend.DCTAnalysis(ft, w, hop, device=dev, compute_dtype=dtype)
        syn = dct_frontend.DCTSynthesis(ft, w, hop, device=dev, compute_dtype=dtype)
        fa = frontend.FNNAnalysis(ft, device=dev, compute_dtype=dtype)
        fs = frontend.FNNSynthesis(ft, device=dev, compute_dtype=dtype)
        with torch.no_grad():
            ana.bias.copy_(0.01 * torch.randn(ft, generator=g, device=dev))
        spec = ana(x)
        wave = syn(spec)
        tied = dct_frontend.tied_transform(ana.weight, spec, hop, ft, dtype)
        re, im = fa(frames)
        rec = fs(re, im)

        def trim(a):
            return a[:, ft : a.shape[1] - ft]

        wr, wi = frontend.fold_synthesis_weights(fs.w_real, fs.w_imag, half)
        want = {
            "dct_analysis": (spec, framing.frame_signal(rnd(x), w, hop, pad=ft)
                             @ rnd(ana.weight).t() + ana.bias.detach().double()),
            "dct_synthesis": (wave, trim(framing.overlap_add(rnd(spec) @ rnd(syn.weight), hop))),
            "tied": (tied, trim(framing.overlap_add(rnd(spec) @ rnd(ana.weight), hop))),
            "fnn_analysis": (torch.cat([re, im], -1), rnd(frames) @ rnd(
                torch.cat([fa.w_real[:half], fa.w_imag[:half]]).t())),
            "fnn_synthesis": (rec, rnd(torch.cat([re, im], -1)) @ rnd(torch.cat([wr, wi]))),
        }
        errs = {}
        for name, (got, ref) in want.items():
            check(tuple(got.shape) == tuple(ref.shape) and bool(torch.isfinite(got).all()),
                  f"8b {tag} {name}: shape {tuple(got.shape)} against {tuple(ref.shape)}")
            errs[name] = float((got.detach().double() - ref).abs().max())
            check(errs[name] <= FE_TOL, f"8b {tag} {name}: {errs[name]:.3e} > {FE_TOL} "
                  "against float64")
        cot = torch.randn(wave.shape, generator=g, device=dev)
        ((wave * cot).sum() + (rec * torch.randn(rec.shape, generator=g, device=dev)).sum()
         ).backward()
        grads = [p.grad for m in (ana, syn, fa, fs) for p in m.parameters()]
        check(all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads),
              f"8b {tag}: a gradient is missing or not finite")
        r = {"max_abs_err_vs_float64": errs}
        if dtype == torch.float32:
            a = wave.detach()[:, 2048:-2048].double()
            b = x[:, 2048 : 2048 + wave.shape[1] - 4096].double()
            corr = float(((a - a.mean(1, keepdim=True)) * (b - b.mean(1, keepdim=True))).sum()
                         / (a.std(1) * b.std(1) * (a.shape[1] - 1)).sum())
            check(corr > 0.95, f"8b: the DCT round trip's correlation {corr:.4f} <= 0.95")
            rt = float((rec.detach() - frames).abs().max())
            check(rt <= FE_TOL, f"8b: the FNN round trip is off by {rt:.3e}")
            r.update(dct_round_trip_corr=corr, fnn_round_trip_err=rt)
        with torch.no_grad():
            r["ms"] = {"dct_analysis": cuda_ms(lambda: ana(x), reps=20),
                       "dct_synthesis": cuda_ms(lambda: syn(spec), reps=20),
                       "fnn_analysis": cuda_ms(lambda: fa(frames), reps=20),
                       "fnn_synthesis": cuda_ms(lambda: fs(re, im), reps=20)}
        report[tag] = r
    return report


def tools(dev, root: str) -> dict:
    """8c cli.viz on the card against the CPU path; 8d cli.knob_sweep and
    DemoState.run, counted, against the CPU path."""
    from signaltrain_tpu_torch.cli import bokeh_sliders, knob_sweep, viz
    from signaltrain_tpu_torch.utils.load_model import load_model

    cpu_model, _ = load_model(str(CKPT), device="cpu")
    report, launches = {}, dict.fromkeys(SERVING_KERNELS, 0)
    png = os.path.join(root, "viz.png")
    card, counts = counted(lambda: viz.main([str(CKPT), "--device", str(dev), "--out", png]))
    no_plain(counts, "8c")
    check(all(c == (0, 0) for c in counts.values()),
          f"8c: viz launched a kernel (return_acts runs the gemm front-end): {counts}")
    ref = viz.forward_acts(cpu_model, card["x"].cpu(), card["knobs"])
    worst = max(float((a.float().cpu() - b).abs().max()) for a, b in zip(card["acts"], ref))
    check(worst <= SERVE_TOL, f"8c: viz activations {worst:.3e} from the CPU path")
    report["viz"] = {"max_abs_err_vs_cpu": worst, "png_bytes": os.path.getsize(png),
                     "png_shape": list(card["image"].shape), "tiles": card["tiles"]}
    print(f"8c: viz {card['image'].shape[1]}x{card['image'].shape[0]}, {card['tiles']} tiles, "
          f"{os.path.getsize(png)} bytes; activations within {worst:.3e} of the CPU path")

    sweep, counts = counted(lambda: in_dir(root, lambda: knob_sweep.main(
        [str(CKPT), "--frames", str(SWEEP_FRAMES), "--device", str(dev)])))
    for k in SERVING_KERNELS:
        check(counts[k][0] == SWEEP_FRAMES, f"8d: knob_sweep launched {k} {counts[k][0]} times")
        launches[k] += counts[k][0]
    no_plain(counts, "8d (knob_sweep)")
    f0 = sweep["frames"][0]
    with torch.no_grad():
        want = cpu_model(torch.from_numpy(f0["x_in"])[None],
                         torch.from_numpy(f0["knobs_nn"])[None])[0][0].numpy()
    err = float(np.abs(f0["pred"] - want).max())
    check(err <= SERVE_TOL, f"8d: knob_sweep frame 0 is {err:.3e} from the CPU path")
    pngs = sorted(os.listdir(os.path.join(root, "knob_sweep")))
    check(pngs == [f"sweep_{i:04d}.png" for i in range(SWEEP_FRAMES)], f"8d: frames {pngs}")
    bokeh_sliders.EFFECT_CHECKPOINTS["comp_4c"] = str(CKPT)
    state = bokeh_sliders.DemoState("comp_4c", device=dev)
    (xi, yt, yp), counts = counted(lambda: state.run([-30.0, 5.0, 0.002, 0.002]))
    for k in SERVING_KERNELS:
        check(counts[k][0] == 1, f"8d: DemoState.run launched {k} {counts[k][0]} times")
        launches[k] += counts[k][0]
    no_plain(counts, "8d (DemoState)")
    check(bool(np.isfinite(yp).all()) and yp.shape == (state.out_chunk,), "8d: DemoState output")
    report["knob_sweep"] = {"frames": SWEEP_FRAMES, "ms_a_frame": sweep["ms_a_frame"],
                            "frame0_max_abs_err_vs_cpu": err}
    report["launches"] = launches
    return report


def facades(dev) -> dict:
    """8e: the reference-API facades on the card."""
    import signaltrain_tpu_torch as st
    from signaltrain_tpu_torch.data import synth_data

    effect = st.audio.Compressor_4c(device=dev)
    ds = st.datasets.SynthAudioDataSet(8192, effect, y_size=2048)
    shapes, counts = counted(lambda: [tuple(a.shape) for b in ds.batches(TRAIN_BATCH, steps=3)
                                      for a in b])
    check(shapes == [(TRAIN_BATCH, 8192), (TRAIN_BATCH, 2048), (TRAIN_BATCH, 4)] * 3,
          f"8e: SynthAudioDataSet.batches shapes {shapes}")
    check(counts["switched_one_pole"][0] == 3, "8e: the dataset's batches did not launch C")
    no_plain(counts, "8e (datasets)")
    launches = {"switched_one_pole": counts["switched_one_pole"][0]}
    model = st.nn_proc.st_model(device=dev, generator=torch.Generator().manual_seed(TRAIN_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == ST_MODEL_PARAMS, f"8e: st_model() has {n_params} parameters")
    tx = st.train.make_optimizer(model, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS, TRAIN_BATCH)
    batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048)
    graph = st.train.make_train_multi_step(model, tx, batch_fn, TRAIN_BATCH, 2, seed=TRAIN_SEED)
    losses, counts = counted(lambda: graph(0, 2))
    check(graph.graph.replays == 1 and bool(torch.isfinite(losses).all()),
          f"8e: make_train_multi_step: {graph.graph.replays} replays, losses {losses.tolist()}")
    for k in ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd",
              "switched_one_pole"):
        check(counts[k][0] > 0, f"8e: the train graph never launched {k}")
        launches[k] = launches.get(k, 0) + counts[k][0]
    no_plain(counts, "8e (train graph)")
    return {"batches": 3, "st_model_params": n_params, "losses": losses.tolist(),
            "launches": launches}


def single_card_surface(dev, results: dict, smi: str) -> dict:
    """Phase 8; its failures raise, and it must end within PHASE8_LIMIT_S."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = {"8a": host_backend(dev, tmp)}
        a = report["8a"]
        print(f"8a: gen_dataset comp_4c, {HOST_FILES} files of {a['signal_length']} samples: host "
              f"backend ({HOST_WORKERS} workers) {a['host_files_per_s']:.2f} files/s "
              f"({a['host_seconds']:.2f} s), device backend {a['device_files_per_s']:.2f} files/s "
              f"({a['device_seconds']:.2f} s; {a['device_steady_files_per_s']:.2f} after the "
              f"first batch; {a['device_card_ms_per_batch']:.3f} card ms a batch of 8); host "
              f"targets against kernel C: {a['head_max_abs_err']:.3e} over the first {HOST_HEAD} "
              f"samples (limit {HOST_HEAD_TOL}), {a['whole_max_abs_err']:.3e} over whole files "
              f"(limit {HOST_WHOLE_TOL}); auto: pull {a['auto_pull_mb_s']:.0f} MB/s -> device; "
              f"on {smi}")
        report["8b"] = frontend_variants(dev)
        for tag, r in report["8b"].items():
            errs = {k: float(f"{v:.3e}") for k, v in r["max_abs_err_vs_float64"].items()}
            print(f"8b {tag}: DCT (ft {DCT_GEOM[0]}, w {DCT_GEOM[1]}, hop {DCT_GEOM[2]}) on "
                  f"({FE_BATCH}, 8192), FNN (ft {DCT_GEOM[0]}) on ({FE_BATCH}, 25, {DCT_GEOM[0]}): "
                  f"against float64 {json.dumps(errs)}; "
                  f"ms {json.dumps({k: round(v, 4) for k, v in r['ms'].items()})} on {smi}")
        report["8cd"] = tools(dev, tmp)
    d = report["8cd"]["knob_sweep"]
    print(f"8d: knob_sweep {d['frames']} frames, {d['ms_a_frame']:.3f} ms a frame (effect, model "
          f"and copies to the host, host clock), frame 0 within "
          f"{d['frame0_max_abs_err_vs_cpu']:.3e} of the CPU path; DemoState.run: A, B, C once "
          f"each; on {smi}")
    report["8e"] = facades(dev)
    print(f"8e: SynthAudioDataSet.batches(200, steps=3) launched C 3 times; st_model() "
          f"{report['8e']['st_model_params']} parameters; make_train_multi_step: warm-up + 1 "
          f"replay, losses {report['8e']['losses']}")
    for k in SERVING_KERNELS + ("fused_analysis_bwd", "fused_synthesis_bwd"):
        n_launch = (report["8cd"]["launches"].get(k, 0) + report["8e"]["launches"].get(k, 0)
                    + (report["8a"]["c_launches"] if k == "switched_one_pole" else 0))
        results[k]["launches_tools"] = n_launch
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: {report['seconds']:.2f} s (limit {PHASE8_LIMIT_S:.0f} s)")
    check(report["seconds"] <= PHASE8_LIMIT_S,
          f"phase 8 took {report['seconds']:.2f} s > {PHASE8_LIMIT_S:.0f} s")
    return report


# ---- phase 9: data parallelism (parallel/, training/oracle.py, predict_long(mesh=)).
# One card takes a world of one under NCCL, in this process (NCCL refuses two
# ranks on one device), and two spawned ranks under gloo (parallel/launch.spawn),
# on the same split graphs that run on several cards.
PHASE9_LIMIT_S = 60.0
DP_STEPS = 3  # 9b: steps of the 2 ranks against the oracle
DP_OPT = (TRAIN_LR, 4 * TRAIN_BATCH, 1, TRAIN_BATCH)  # 9b's schedule, and 9d's resume: 4 steps
DP_CONTROL_GAP = 10.0  # how many times over the limit the sum-not-mean oracle must land
DP_PREDICT_TOL = 2e-5  # tests/test_predict_long_parity.py:88
DP_TIMED_STEPS = 20
F32_NAMES = [name.removeprefix("bf16_") for name in BF16_NAMES]


def _rank_counts() -> dict:
    from signaltrain_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    return {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}


def _weights(model) -> dict:
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}


def _graph_ms(graph, step0: int, steps: int) -> float:
    """Host milliseconds a step of ``steps`` replays of a train graph, one
    fetch of the losses at the end (as train() runs a block)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph(step0, steps).cpu()
    return (time.perf_counter() - t0) * 1e3 / steps


def dp_world_one(dev, workdir: str, sr: int, before_timing) -> dict:
    """9a, in this process, in a world of one under NCCL (a file store in a
    temporary directory): train() in bf16 (counted), then the train graph
    with and without the mesh from the same weights; ``before_timing()``
    (which waits until the card is this process's alone), then two blocks
    of each in turns: their losses and weights bit-equal, and their ms a
    step."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.parallel import distributed
    from signaltrain_tpu_torch.parallel import mesh as meshlib
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    with tempfile.TemporaryDirectory() as store:
        distributed.initialize("file://" + os.path.join(store, "store"), 1, 0, "nccl", dev)
        try:
            mesh = meshlib.make_mesh(device=dev)
            effect = effects.make_effect("comp_4c", sr=sr, device=dev)
            _cuda.reset_counts()
            model, hist = in_dir(workdir, lambda: train_mod.train(
                effect, epochs=1, n_data_points=TRAIN_POINTS, batch_size=TRAIN_BATCH, sr=sr,
                lr_max=TRAIN_LR, seed=TRAIN_SEED, device=dev, compute_dtype=BF16,
                make_plots=False))
            counts = _rank_counts()
            batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)
            loops = {}
            for way, m in (("single", None), ("mesh", mesh)):
                net = st_model(device=dev, sr=sr, generator=torch.Generator().manual_seed(TRAIN_SEED),
                               compute_dtype=BF16).train()
                opt, lr_fn = train_mod.make_optimizer(net, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS,
                                                      TRAIN_BATCH)
                g = graphs.TrainGraph(net, opt, lr_fn, batch_fn, TRAIN_BATCH,
                                      torch.Generator(device=dev), TRAIN_SEED,
                                      capacity=DP_TIMED_STEPS, mesh=m)
                loops[way] = {"net": net, "graph": g, "losses": g(0, DP_TIMED_STEPS).cpu(),
                              "ms": []}
            before_timing()
            for turn, way in enumerate(("single", "mesh", "mesh", "single")):
                loops[way]["ms"].append(_graph_ms(loops[way]["graph"],
                                                  DP_TIMED_STEPS * (1 + turn // 2), DP_TIMED_STEPS))
            graph_equal = torch.equal(loops["single"]["losses"], loops["mesh"]["losses"]) and all(
                torch.equal(a, b) for a, b in zip(loops["single"]["net"].parameters(),
                                                  loops["mesh"]["net"].parameters()))
            return {"hist": hist, "weights": {k: v.cpu() for k, v in _weights(model).items()},
                    "counts": counts, "graphs_bit_equal": graph_equal,
                    "ms": {way: v["ms"] for way, v in loops.items()}}
        finally:
            distributed.shutdown()


def dp_two_ranks(mesh, ckpt: str, sr: int, clip, knobs_nn) -> dict:
    """9b and 9c, in one of two gloo ranks on one card: DP_STEPS train steps
    in float32 through the split graphs at global batch TRAIN_BATCH (rank 0
    saves the checkpoint after them), predict_long(mesh=) on the demo
    checkpoint over phase 3's clip, then the ms a step of more replays."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.training import checkpoint, graphs
    from signaltrain_tpu_torch.training import train as train_mod
    from signaltrain_tpu_torch.utils.load_model import load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    model = st_model(device=dev, sr=sr, generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
    opt, lr_fn = train_mod.make_optimizer(model, *DP_OPT)
    batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)
    graph = graphs.TrainGraph(model, opt, lr_fn, batch_fn, TRAIN_BATCH, torch.Generator(device=dev),
                              TRAIN_SEED, capacity=DP_TIMED_STEPS, mesh=mesh)
    _cuda.reset_counts()
    losses = graph(0, DP_STEPS).cpu()
    counts = _rank_counts()
    weights = _weights(model)
    if mesh.rank == 0:
        checkpoint.save_checkpoint(ckpt, model.spec, effect, 0,
                                   checkpoint.training_tensors(model, opt), DP_STEPS)
    served, _ = load_model(str(CKPT), device=dev)
    _cuda.reset_counts()
    y = pl.predict_long(clip, knobs_nn, served, mesh=mesh)
    predict_counts = _rank_counts()
    ms = [_graph_ms(graph, DP_STEPS + i * DP_TIMED_STEPS, DP_TIMED_STEPS) for i in range(2)]
    return {"losses": losses, "weights": weights, "counts": counts, "predict": y,
            "predict_counts": predict_counts, "ms": ms, "replays": graph.graph.replays,
            "memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def data_parallel(dev, results: dict, smi: str, sr: int, clip, knobs_nn, y_pred) -> dict:
    """Phase 9 (module docstring); its failures raise, and it must end
    within PHASE9_LIMIT_S."""
    import concurrent.futures

    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.parallel import launch
    from signaltrain_tpu_torch.training import checkpoint, oracle
    from signaltrain_tpu_torch.training import train as train_mod

    t_phase = time.perf_counter()
    report = {}
    launches: dict[str, int] = {}

    def add(counts: dict, what: str) -> None:
        for k, (n_launch, plain) in counts.items():
            check(plain == 0, f"{what} ran the plain version of {k}")
            launches[k] = launches.get(k, 0) + n_launch

    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the 9b ranks start first; this process runs 9a and the oracles meanwhile.
        # Every directory this process works in outlives the ranks: a rank
        # starts in this process's working directory of the moment.
        ckpt = os.path.join(tmp, "world2.tar")
        spawned = pool.submit(launch.spawn, dp_two_ranks, [str(dev)] * 2, "gloo",
                              args=(ckpt, sr, clip, knobs_nn), timeout_s=120)
        dirs = {d: os.path.join(tmp, d) for d in ("single", "world1", "resume")}
        for d in dirs.values():
            os.makedirs(d)
        # ---- 9a: a world of one under NCCL against the same run without a mesh
        effect = effects.make_effect("comp_4c", sr=sr, device=dev)
        model, hist = in_dir(dirs["single"], lambda: train_mod.train(
            effect, epochs=1, n_data_points=TRAIN_POINTS, batch_size=TRAIN_BATCH, sr=sr,
            lr_max=TRAIN_LR, seed=TRAIN_SEED, device=dev, compute_dtype=BF16, make_plots=False))
        batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)

        def fresh():
            m = st_model(device=dev, sr=sr,
                         generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
            return m, *train_mod.make_optimizer(m, *DP_OPT)

        om, oopt, lr_fn = fresh()  # 9b's oracle
        o_losses = oracle.oracle_steps(om, oopt, lr_fn, batch_fn, TRAIN_BATCH, 2,
                                       torch.Generator(device=dev), TRAIN_SEED, 0, DP_STEPS)
        want = _weights(om)
        bm, bopt, _ = fresh()  # the control: the shards' gradients summed, not averaged
        oracle.oracle_steps(bm, bopt, lr_fn, batch_fn, TRAIN_BATCH, 2, torch.Generator(device=dev),
                            TRAIN_SEED, 0, DP_STEPS, reduce="sum")
        control = oracle.excess(_weights(bm), want)
        runs = {}

        def ranks_done():  # the card is 9a's alone from here
            runs["ranks"] = spawned.result()

        a = dp_world_one(dev, dirs["world1"], sr, ranks_done)
        for key in ("train_loss", "val_loss", "val_mae", "val_mae_mean", "step"):
            check(a["hist"][key] == hist[key], f"9a: train() at world 1 differs in {key}")
        check(all(torch.equal(torch.as_tensor(a["weights"][k]), v.detach().float().cpu())
                  for k, v in model.state_dict().items()),
              "9a: train() at world 1 differs from the run without a mesh in the weights")
        check(a["graphs_bit_equal"], "9a: the split graphs differ from the single graph")
        for k in BF16_NAMES + ["switched_one_pole"]:
            check(a["counts"][k][0] > 0, f"9a: train() at world 1 never launched {k}")
        add(a["counts"], "9a")
        report["9a"] = {"steps": len(hist["train_loss"]), "ms_a_step": a["ms"]}
        print(f"9a: train() bf16 at world 1 under NCCL (in this process), "
              f"{len(hist['train_loss'])} steps: losses, "
              f"validation and every weight bit-equal to the run without a mesh; the split graphs "
              f"bit-equal to the single graph; ms a step (host clock, blocks of {DP_TIMED_STEPS}, "
              f"in turns) single {a['ms']['single']}, mesh {a['ms']['mesh']} on {smi}")

        # ---- 9b, 9c: two gloo ranks on this card against the oracle
        ranks = runs["ranks"]
        excess = [oracle.excess(r["weights"], want) for r in ranks]
        delta = max(oracle.max_param_delta(r["weights"], om) for r in ranks)
        loss_err = max(float(np.abs(r["losses"] / o_losses.cpu().numpy() - 1).max()) for r in ranks)
        check(max(excess) <= 1.0, f"9b: the 2 ranks are off the oracle: {excess} x the limit")
        check(loss_err <= 1e-5, f"9b: the losses are off the oracle by {loss_err:.3e} (rtol 1e-5)")
        check(control > DP_CONTROL_GAP, f"9b: the sum-not-mean control is only {control:.2f} x over")
        for r in ranks:
            check(r["replays"] == DP_STEPS - 1 + 2 * DP_TIMED_STEPS, "9b: replay count")
            for k in F32_NAMES + ["switched_one_pole"]:
                check(r["counts"][k][0] > 0, f"9b: a rank never launched {k}")
            add(r["counts"], "9b")
        report["9b"] = {"max_param_delta": delta, "excess": excess, "loss_rel_err": loss_err,
                        "bit_equal": delta == 0.0, "control_excess": control,
                        "ms_a_step": ranks[0]["ms"], "memory_gb": [r["memory_gb"] for r in ranks]}
        print(f"9b: 2 gloo ranks on one card, f32, global batch {TRAIN_BATCH}, {DP_STEPS} steps "
              f"through the split graphs against the oracle: max |dW| {delta:.3e} "
              f"({'bit-equal' if delta == 0.0 else 'not bit-equal'}), {max(excess):.3f} x the "
              f"limit (atol {oracle.ATOL}, rtol {oracle.RTOL}), losses within {loss_err:.2e}; "
              f"sum-not-mean control {control:.1f} x over (must be > {DP_CONTROL_GAP}); "
              f"{ranks[0]['ms']} ms a step (host clock, blocks of {DP_TIMED_STEPS}; this process's 9a "
              f"run and oracles on the card at the same time); peak memory "
              f"{report['9b']['memory_gb']} GB a rank on {smi}")

        # ---- 9c: predict_long split over the two ranks against phase 3's output
        p_err = max(float(np.abs(r["predict"] - y_pred).max()) for r in ranks)
        check(all(r["predict"].shape == y_pred.shape for r in ranks), "9c: prediction length")
        check(p_err <= DP_PREDICT_TOL, f"9c: predict_long(mesh=) off phase 3's by {p_err:.3e}")
        for r in ranks:
            for k in ("fused_analysis", "fused_synthesis"):
                check(r["predict_counts"][k][0] > 0, f"9c: a rank never launched {k}")
            add(r["predict_counts"], "9c")
        report["9c"] = {"max_abs_err": p_err, "samples": int(y_pred.shape[0])}
        print(f"9c: predict_long(mesh=) on 2 ranks over the {CLIP_SECONDS:.0f} s clip: within "
              f"{p_err:.3e} of phase 3's (limit {DP_PREDICT_TOL})")

        # ---- 9d: the world-2 checkpoint resumed at world 1 against the oracle run on
        state, rv = checkpoint.load_checkpoint(ckpt)
        check(rv["optax_step"] == DP_STEPS, "9d: the checkpoint's step")
        check(all(torch.equal(v, torch.as_tensor(ranks[0]["weights"][k]))
                  for k, v in state.items()), "9d: the checkpoint is not rank 0's weights")
        resumed, r_hist = in_dir(dirs["resume"], lambda: train_mod.train(
            effect, epochs=DP_OPT[2], n_data_points=DP_OPT[1], batch_size=TRAIN_BATCH, sr=sr,
            lr_max=DP_OPT[0], seed=TRAIN_SEED, device=dev, compute_dtype=torch.float32,
            make_plots=False, in_checkpointname=ckpt))
        n_more = DP_OPT[1] // TRAIN_BATCH
        o_more = oracle.oracle_steps(om, oopt, lr_fn, batch_fn, TRAIN_BATCH, 1,
                                     torch.Generator(device=dev), TRAIN_SEED, DP_STEPS, n_more)
        r_excess = oracle.excess(_weights(resumed), _weights(om))
        r_loss_err = float(np.abs(np.asarray(r_hist["train_loss"]) / o_more.cpu().numpy() - 1).max())
        check(r_hist["step"] == DP_STEPS + n_more, "9d: the resumed run's step")
        check(r_excess <= 1.0 and r_loss_err <= 1e-5,
              f"9d: the resumed run is off the oracle: {r_excess:.3f} x the limit, losses "
              f"{r_loss_err:.3e}")
        report["9d"] = {"excess": r_excess, "loss_rel_err": r_loss_err, "steps": n_more}
        print(f"9d: the world-2 checkpoint (step {DP_STEPS}) resumed by train() at world 1 for "
              f"{n_more} steps: {r_excess:.3f} x the limit against the oracle run on, losses within "
              f"{r_loss_err:.2e}")
    for k, v in launches.items():
        if k in results and v:
            results[k]["launches_parallel"] = v
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {report['seconds']:.2f} s (limit {PHASE9_LIMIT_S:.0f} s)")
    check(report["seconds"] <= PHASE9_LIMIT_S,
          f"phase 9 took {report['seconds']:.2f} s > {PHASE9_LIMIT_S:.0f} s")
    return report


# ---- phase 10: tensor parallelism (parallel/tensor.py, the JAX 'model' axis).
# One card: 10a a world of one under NCCL with the split front-end forced on a
# model group of one, its collectives captured in the graphs; 10b 1 x 2 and
# 2 x 2 as gloo ranks on the card (NCCL refuses two ranks on one device, and
# gloo's collectives cannot be captured, so their steps run op by op); 10c
# the 2 x 2 checkpoint on one card, and phase 4's checkpoint resumed at 1 x 2.
PHASE10_LIMIT_S = 60.0
TP_STEPS = 3  # 10b: checked steps a mesh, and each control's
TP_TIMED_STEPS = 20  # 10a: steps a graph and a timed block
TP_CONTROL_GAP = 10.0  # how many times over the limit the sum-not-mean oracle must land
# 10b's schedule: the JAX dp x tp test's (tests/test_multichip_oracle.py, _setup:
# make_optimizer(1e-4, 256, 2, 16), 32 steps) at batch 200, the first steps of a
# 1cycle; its atol is 1% of such an update (lr ~1e-4), and in the schedule's
# first steps 10-30% of one
TP_OPT = (1e-4, 16 * TRAIN_BATCH, 2, TRAIN_BATCH)


def _gathered(state: dict) -> dict:
    """A copy of ``checkpoint.training_tensors``' dict on the host."""
    return {k: {n: v.detach().float().cpu() for n, v in d.items()} for k, d in state.items()}


def split_graph_check(dev, sr: int, before_timing) -> dict:
    """10a, in this process, in a world of one under NCCL (a file store in a
    temporary directory): the gemm front-end's train graph without a mesh
    and the split front-end's on the mesh (a model group of one: every sum
    in the same order), bf16, TP_TIMED_STEPS steps each, every count set to
    0 just before and read just after; then ``before_timing()`` (which waits
    until the card is this process's alone) and two more blocks each in
    turns; their losses, weights and Adam moments compared, their ms a
    step."""
    from signaltrain_tpu_torch.cli import time_data_parallel
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.parallel import distributed
    from signaltrain_tpu_torch.parallel import mesh as meshlib
    from signaltrain_tpu_torch.training import checkpoint, graphs
    from signaltrain_tpu_torch.training import train as train_mod

    with tempfile.TemporaryDirectory() as store:
        distributed.initialize("file://" + os.path.join(store, "store"), 1, 0, "nccl", dev)
        try:
            mesh = meshlib.make_mesh(device=dev)
            effect = effects.make_effect("comp_4c", sr=sr, device=dev)
            batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)
            loops = {}
            _cuda.reset_counts()
            for way, m in (("gemm", None), ("split", mesh)):
                net = STModel(compute_spec(sr=sr), frontend="gemm", device=dev,
                              compute_dtype=BF16, mesh=m,
                              generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
                opt, lr_fn = train_mod.make_optimizer(net, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS,
                                                      TRAIN_BATCH)
                g = graphs.TrainGraph(net, opt, lr_fn, batch_fn, TRAIN_BATCH,
                                      torch.Generator(device=dev), TRAIN_SEED,
                                      capacity=TP_TIMED_STEPS, mesh=m)
                loops[way] = {"net": net, "opt": opt, "graph": g,
                              "losses": g(0, TP_TIMED_STEPS).cpu(), "ms": []}
            counts = _rank_counts()
            before_timing()
            for turn, way in enumerate(("gemm", "split", "split", "gemm")):
                loops[way]["ms"].append(_graph_ms(loops[way]["graph"],
                                                  TP_TIMED_STEPS * (1 + turn // 2), TP_TIMED_STEPS))
            # what the split analysis' full-width product costs beside one rank's bins
            product_ms = {n: time_data_parallel.analysis_product_ms(loops["gemm"]["net"], n)
                          for n in (2, 4)}
            a, b = (checkpoint.training_tensors(loops[w]["net"], loops[w]["opt"])
                    for w in ("gemm", "split"))
            return {"losses_equal": torch.equal(loops["gemm"]["losses"], loops["split"]["losses"]),
                    "state_equal": {k: all(torch.equal(v, b[k][n]) for n, v in d.items())
                                    for k, d in a.items()},
                    "counts": counts, "ms": {w: v["ms"] for w, v in loops.items()},
                    "steps": loops["split"]["graph"].graph.replays + 1,
                    "analysis_product_ms": product_ms}
        finally:
            distributed.shutdown()


def tp_ranks(mesh, workdir: str, phase4_ckpt: str, sr: int) -> dict:
    """10b and 10c, in one gloo rank of a 1 x 2 or 2 x 2 mesh on the card, in
    float32: TP_STEPS steps op by op at global batch TRAIN_BATCH (the first
    the warm-up, the others timed), the whole weights and moments gathered
    (2 x 2: rank 0 saves them as the checkpoint), each scale control's
    (2 x 2), the peak memory of one step beside an unsharded rank's at the
    same rows; at 1 x 2 train() resumed from phase 4's checkpoint."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.parallel import tensor as tp
    from signaltrain_tpu_torch.training import checkpoint
    from signaltrain_tpu_torch.training import train as train_mod

    clock = {"start": time.time()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)

    def steps(m=mesh, n=TP_STEPS):
        model = st_model(device=dev, sr=sr, generator=torch.Generator().manual_seed(TRAIN_SEED),
                         mesh=m).train()
        opt, lr_fn = train_mod.make_optimizer(model, *TP_OPT)
        g = torch.Generator(device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        first = train_mod.eager_steps(model, opt, lr_fn, batch_fn, TRAIN_BATCH, g, TRAIN_SEED, 0,
                                      1, mesh=mesh)
        memory = torch.cuda.max_memory_allocated(dev) / 1e9
        if n == 1:
            return model, opt, first, memory, None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rest = train_mod.eager_steps(model, opt, lr_fn, batch_fn, TRAIN_BATCH, g, TRAIN_SEED, 1,
                                     n - 1, mesh=mesh)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
        return model, opt, torch.cat([first, rest]), memory, ms

    _cuda.reset_counts()
    model, opt, losses, memory, ms = steps()
    counts = _rank_counts()
    clock["steps"] = time.time()
    state = checkpoint.training_tensors(model, opt)  # gathered over the model group
    if mesh.n_data == 2 and mesh.rank == 0:
        checkpoint.save_checkpoint(os.path.join(workdir, "tp2x2.tar"), model.spec, effect, 0,
                                   state, TP_STEPS)
    params = dict(model.named_parameters())
    # rank 0 sends the whole state (every rank gathers the same); each rank
    # its replicated weights and a digest of its rows (equal across its data group)
    out = {"losses": losses, "state": _gathered(state) if mesh.rank == 0 else None,
           "counts": counts, "ms": ms, "memory_gb": memory,
           "replicated": {k: v.detach().clone() for k, v in params.items() if "dft_" not in k},
           "shard_digest": [float(params[k].double().sum()) for k in train_mod.FRONTEND_PARAMS]
           + [float(params[k].double().square().sum()) for k in train_mod.FRONTEND_PARAMS],
           "controls": {}}
    del model, opt, params, state
    if mesh.n_data == 2:
        for name in tp.SCALE_CONTROLS:
            with tp.scale_control(name):
                c_model, c_opt = steps()[:2]
                c_state = checkpoint.training_tensors(c_model, c_opt)
                if mesh.rank == 0:
                    out["controls"][name] = _gathered(c_state)
    clock["controls"] = time.time()
    out["memory_gb_unsharded"] = steps(None, 1)[3]  # the same rows, the front-end whole
    clock["unsharded"] = time.time()
    if mesh.n_data == 1:
        here = os.path.join(workdir, f"rank{mesh.rank}")
        os.makedirs(here)
        resumed, hist = in_dir(here, lambda: train_mod.train(
            effect, epochs=DP_OPT[2], n_data_points=DP_OPT[1], batch_size=TRAIN_BATCH, sr=sr,
            lr_max=DP_OPT[0], seed=TRAIN_SEED, device=dev, compute_dtype=torch.float32,
            make_plots=False, in_checkpointname=phase4_ckpt, n_model=2))
        weights = checkpoint.training_tensors(resumed)["state_dict"]
        out["resume"] = {"hist": hist, "files": sorted(os.listdir(here)),
                         "weights": _gathered({"w": weights})["w"] if mesh.rank == 0 else None}
    clock["end"] = time.time()
    out["clock"] = clock
    return out


def tensor_parallel(dev, results: dict, smi: str, sr: int, phase4: dict) -> dict:
    """Phase 10 (module docstring); its failures raise, and it must end
    within PHASE10_LIMIT_S."""
    import concurrent.futures

    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.parallel import launch
    from signaltrain_tpu_torch.training import checkpoint, oracle
    from signaltrain_tpu_torch.training import train as train_mod

    t_phase, t_wall = time.perf_counter(), time.time()
    report = {}
    launches = 0

    def add(counts: dict, what: str) -> None:
        nonlocal launches
        for k, (n_launch, plain) in counts.items():
            check(plain == 0, f"{what} ran the plain version of {k}")
        check(counts["switched_one_pole"][0] > 0, f"{what} never launched kernel C")
        launches += counts["switched_one_pole"][0]

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 10b: 1 x 2 and 2 x 2 gloo ranks on this card, spawned at once; the
        # oracles run in this process meanwhile
        ckpt4 = os.path.join(tmp, "phase4.tar")
        with open(ckpt4, "wb") as f:
            f.write(phase4["checkpoint"])
        dirs = {s: os.path.join(tmp, s) for s in ("1x2", "2x2")}
        for d in dirs.values():
            os.makedirs(d)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spawned = {s: pool.submit(launch.spawn, tp_ranks, [str(dev)] * w, "gloo",
                                      args=(dirs[s], ckpt4, sr), timeout_s=120, n_model=2)
                       for s, w in (("2x2", 4), ("1x2", 2))}
            effect = effects.make_effect("comp_4c", sr=sr, device=dev)
            batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)

            def fresh(schedule=TP_OPT):  # the oracle's model: the ranks' gemm front-end, whole
                m = STModel(compute_spec(sr=sr), frontend="gemm", device=dev,
                            generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
                return m, *train_mod.make_optimizer(m, *schedule)

            def run_oracle(n_data: int, step0: int = 0, n: int = TP_STEPS, reduce: str = "mean",
                           state=None):
                m, o, lr_fn = fresh() if state is None else state
                losses = oracle.oracle_steps(m, o, lr_fn, batch_fn, TRAIN_BATCH, n_data,
                                             torch.Generator(device=dev), TRAIN_SEED, step0, n,
                                             reduce=reduce)
                return (m, o, lr_fn), losses.cpu().numpy(), _gathered(
                    checkpoint.training_tensors(m, o))

            oracles = {"1x2": run_oracle(1), "2x2": run_oracle(2)}
            summed = run_oracle(2, reduce="sum")[2]
            # 10c's references: the 2 x 2 oracle one step on, and phase 4's
            # checkpoint run on 4 steps at one shard under train()'s schedule there
            _, o_next, want_next = run_oracle(2, TP_STEPS, 1, state=oracles["2x2"][0])
            p4_state, p4_rv = checkpoint.load_checkpoint(ckpt4)
            pm, popt, p_lr_fn = fresh(DP_OPT)
            pm.load_state_dict(p4_state, strict=True)
            checkpoint.restore_optimizer(pm, popt, p4_rv["optax_state"], p4_rv["optax_step"])
            n_more = DP_OPT[1] // TRAIN_BATCH
            _, p_losses, p_want = run_oracle(1, p4_rv["optax_step"], n_more,
                                             state=(pm, popt, p_lr_fn))
            t_oracles = time.perf_counter() - t_phase
            runs = {}

            def ranks_done():  # the card is 10a's alone from here
                runs.update({s: f.result() for s, f in spawned.items()})
                report["10b_seconds"] = time.perf_counter() - t_phase

            # ---- 10a meanwhile: the split front-end's graph on a model group of
            # one under NCCL, in this process; timed once the ranks are done
            a = split_graph_check(dev, sr, ranks_done)
            report["10a_returned_s"] = time.perf_counter() - t_phase
        print("10b clocks (s from the phase's start):", json.dumps(
            {s: [{k: round(v - t_wall, 2) for k, v in r["clock"].items()} for r in rs]
             for s, rs in runs.items()}), f"oracles {t_oracles:.2f}")
        report["10b"] = {}
        for shape, n_data in (("1x2", 1), ("2x2", 2)):
            ranks = runs[shape]
            _, o_losses, want = oracles[shape]
            excess = oracle.state_excess(ranks[0]["state"], want)
            loss_err = max(float(np.abs(r["losses"] / o_losses - 1).max()) for r in ranks)
            check(excess <= 1.0, f"10b {shape}: the ranks are off the oracle: {excess:.3f} x")
            check(loss_err <= 1e-5, f"10b {shape}: the losses are off the oracle by {loss_err:.3e}")
            check(all(np.array_equal(v, ranks[0]["replicated"][k]) for r in ranks
                      for k, v in r["replicated"].items()),
                  f"10b {shape}: the replicated weights differ across the ranks")
            check(all(r["shard_digest"] == ranks[r_i % 2]["shard_digest"]
                      for r_i, r in enumerate(ranks)),
                  f"10b {shape}: a data group's ranks hold different rows")
            for r in ranks:
                add(r["counts"], f"10b {shape}")
            rep = {"excess": excess, "loss_rel_err": loss_err, "replicated_bit_equal": True,
                   "ms_a_step": [r["ms"] for r in ranks],
                   "memory_gb": [r["memory_gb"] for r in ranks],
                   "memory_gb_unsharded": [r["memory_gb_unsharded"] for r in ranks]}
            if shape == "2x2":
                rep["control_excess"] = oracle.state_excess(ranks[0]["state"], summed)
                check(rep["control_excess"] > TP_CONTROL_GAP,
                      f"10b: the sum-not-mean control is only {rep['control_excess']:.2f} x over")
                rep["scale_control_excess"] = {
                    name: oracle.state_excess(st, want)
                    for name, st in ranks[0]["controls"].items()}
                for name, v in rep["scale_control_excess"].items():
                    check(v > 1.0, f"10b: the scale control {name} passes the check ({v:.3f} x)")
            report["10b"][shape] = rep
            print(f"10b: {shape} as gloo ranks on one card, f32, global batch {TRAIN_BATCH}, "
                  f"{TP_STEPS} steps op by op against the oracle at {n_data} shard(s): "
                  f"{excess:.4f} x the limit over the weights and Adam's moments (atol "
                  f"{oracle.ATOL}, rtol {oracle.RTOL}), losses within {loss_err:.2e}; the "
                  f"replicated weights bit-equal across the ranks; "
                  + (f"sum-not-mean control {rep['control_excess']:.1f} x over (must be > "
                     f"{TP_CONTROL_GAP}), scale controls {rep['scale_control_excess']} x; "
                     if shape == "2x2" else "")
                  + f"ms a step {rep['ms_a_step']} (both meshes, the oracles and 10a's checked "
                  f"steps at once on the card); peak memory of a step {rep['memory_gb']} GB a "
                  f"rank, an unsharded rank's {rep['memory_gb_unsharded']} GB, on {smi}")

        report["10b_checked_s"] = time.perf_counter() - t_phase
        # ---- 10c: the 2 x 2 checkpoint on one card; phase 4's resumed at 1 x 2
        state, rv = checkpoint.load_checkpoint(os.path.join(dirs["2x2"], "tp2x2.tar"))
        single, sopt, lr_fn = fresh()
        single.load_state_dict(state, strict=True)
        checkpoint.restore_optimizer(single, sopt, rv["optax_state"], rv["optax_step"])
        _, l_single, got_next = run_oracle(2, TP_STEPS, 1, state=(single, sopt, lr_fn))
        c_excess = oracle.state_excess(got_next, want_next)
        c_loss = float(np.abs(l_single / o_next - 1).max())
        check(rv["optax_step"] == TP_STEPS and c_excess <= 1.0 and c_loss <= 1e-5,
              f"10c: the 2 x 2 checkpoint's next step is off the oracle's: {c_excess:.3f} x, "
              f"losses {c_loss:.3e}")
        r0, r1 = (r["resume"] for r in runs["1x2"])
        r_excess = oracle.excess(r0["weights"], p_want["state_dict"])
        r_loss = float(np.abs(np.asarray(r0["hist"]["train_loss"]) / p_losses - 1).max())
        check(r0["hist"] == r1["hist"] and r1["files"] == []
              and "modelcheckpoint.tar" in r0["files"],
              "10c: the 1 x 2 ranks' histories differ, or rank 1 wrote")
        check(r0["hist"]["step"] == p4_rv["optax_step"] + n_more and r_excess <= 1.0
              and r_loss <= 1e-5,
              f"10c: phase 4's checkpoint resumed at 1 x 2 is off the oracle: {r_excess:.3f} x, "
              f"losses {r_loss:.3e}")
        report["10c"] = {"excess": c_excess, "loss_rel_err": c_loss, "resume_excess": r_excess,
                         "resume_loss_rel_err": r_loss, "resume_steps": n_more}
        print(f"10c: the 2 x 2 checkpoint (whole matrices) loads strict into one card, its next "
              f"step {c_excess:.4f} x the limit of the oracle's (losses {c_loss:.2e}); phase 4's "
              f"checkpoint (step {p4_rv['optax_step']}) resumed by train() at 1 x 2 for {n_more} "
              f"steps: {r_excess:.4f} x, losses within {r_loss:.2e}; only rank 0 wrote")

        # ---- 10a's verdict
        check(a["losses_equal"] and all(a["state_equal"].values()),
              f"10a: the split front-end's graph differs from the gemm graph: losses equal "
              f"{a['losses_equal']}, state equal {a['state_equal']}")
        add(a["counts"], "10a")
        report["10a"] = {"steps": a["steps"], "bit_equal": True, "ms_a_step": a["ms"],
                         "analysis_product_ms": a["analysis_product_ms"]}
        print(f"10a: the split front-end on a model group of one under NCCL, its collectives "
              f"captured, bf16, batch {TRAIN_BATCH}, {a['steps']} steps: losses, weights and Adam "
              f"moments bit-equal to the gemm front-end's graph without a mesh; ms a step (host "
              f"clock, blocks of {TP_TIMED_STEPS}, in turns) gemm {a['ms']['gemm']}, split "
              f"{a['ms']['split']} on {smi}")
        print("10a: the split analysis' product of a step's frames (200 rows), CUDA-event ms: "
              "the full width each rank runs against one rank's bins alone at n_model 2 and 4: "
              + json.dumps({n: {k: round(v, 4) for k, v in d.items()}
                            for n, d in a["analysis_product_ms"].items()}))
    report["oracles_seconds"] = t_oracles
    results["switched_one_pole"]["launches_tensor_parallel"] = launches
    report["launches"] = {"switched_one_pole": launches}
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {report['seconds']:.2f} s (limit {PHASE10_LIMIT_S:.0f} s): the oracles "
          f"by {t_oracles:.2f} s, the 10b ranks returned by {report['10b_seconds']:.2f}, 10a by "
          f"{report['10a_returned_s']:.2f}, 10b checked by {report['10b_checked_s']:.2f}")
    check(report["seconds"] <= PHASE10_LIMIT_S,
          f"phase 10 took {report['seconds']:.2f} s > {PHASE10_LIMIT_S:.0f} s")
    return report


# ---- phase 11: ST_TPU_MICROBATCH (train.microbatches): the forward and the
# backward of a step in k slices of the synthesized batch, inside the one
# captured graph (training/graphs.TrainGraph(micro=)).
PHASE11_LIMIT_S = 60.0
MICRO = 4  # slices a step: 50 rows of the batch of 200
MB_STEPS = 3  # 11a, 11c: steps a graph (its warm-up and two replays)
MB_TIMED = 10  # 11d: replays a timed block
MB_BATCHES = (TRAIN_BATCH, 1600)  # 11d: the training batch, and the batch of JAX's one gain
MB_RTOL = 1e-5  # 11b: the loss, relative; each gradient, of its leaf's largest element
# 11b: the leaves that may miss MB_RTOL for the phase adjoint's ill-conditioning
# (dphs / |spec|), held instead each against a float64 step
MB_ILL_CONDITIONED = ("mpaec.dft_analysis.conv_analysis_real.weight",
                      "mpaec.dft_analysis.conv_analysis_imag.weight")


def microbatch(dev, results: dict, smi: str, sr: int) -> dict:
    """Phase 11 (module docstring); its failures raise, and it must end
    within PHASE11_LIMIT_S."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.ops import _cuda
    from signaltrain_tpu_torch.parallel import distributed
    from signaltrain_tpu_torch.parallel import mesh as meshlib
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    t_phase = time.perf_counter()
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    batch_fn = synth_data.make_synth_batch_fn(effect, 8192, 2048, sr=sr, augment=True)

    def fresh(dtype, frontend="fused"):
        m = STModel(compute_spec(sr=sr), frontend=frontend, device=dev, compute_dtype=dtype,
                    generator=torch.Generator().manual_seed(TRAIN_SEED)).train()
        return m, *train_mod.make_optimizer(m, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS, TRAIN_BATCH)

    def graph(net, opt, lr_fn, batch, capacity, micro, mesh=None):
        return graphs.TrainGraph(net, opt, lr_fn, batch_fn, batch, torch.Generator(device=dev),
                                 TRAIN_SEED, capacity, mesh=mesh, micro=micro)

    report = {"micro": MICRO, "11a": {}}
    launches = {}
    # ---- 11a: the main path, counted: the graph at k = MICRO against eager at k = MICRO
    for tag, dtype in (("f32", F32), ("bf16", BF16)):
        (gm, gopt, lr_fn), (em, eopt, _) = fresh(dtype), fresh(dtype)
        g = graph(gm, gopt, lr_fn, TRAIN_BATCH, MB_STEPS, MICRO)
        _cuda.reset_counts()
        got = g(0, MB_STEPS)
        counts = _rank_counts()
        want = train_mod.eager_steps(em, eopt, lr_fn, batch_fn, TRAIN_BATCH,
                                     torch.Generator(device=dev), TRAIN_SEED, 0, MB_STEPS,
                                     micro=MICRO)
        check(torch.equal(got, want) and all(torch.equal(p, q) for p, q in
                                              zip(gm.parameters(), em.parameters())),
              f"11a {tag}: the microbatched graph differs from eager dispatch at micro={MICRO}")
        prefix = "bf16_" if dtype == BF16 else ""
        for name, (n_launch, plain) in counts.items():
            check(plain == 0, f"11a {tag} ran the plain version of {name}")
        for name in F32_NAMES:  # the front-end kernels: once a slice
            n_launch = counts[prefix + name][0]
            check(n_launch == MICRO * MB_STEPS,
                  f"11a {tag}: {prefix + name} launched {n_launch} times, not {MICRO} a step")
            launches[prefix + name] = n_launch
        check(counts["switched_one_pole"][0] == MB_STEPS,
              f"11a {tag}: C launched {counts['switched_one_pole'][0]} times, not once a step")
        launches["switched_one_pole"] = launches.get("switched_one_pole", 0) + MB_STEPS
        report["11a"][tag] = {"steps": MB_STEPS, "bit_equal": True, "losses": got.tolist(),
                              "counted": {k: v[0] for k, v in counts.items() if v[0]}}
        print(f"11a {tag}: TrainGraph at micro={MICRO} ({TRAIN_BATCH // MICRO} rows a slice), "
              f"{MB_STEPS} steps bit-equal to eager_steps at micro={MICRO}; A, B, D, E "
              f"{MICRO} launches a step, C one (the whole batch's synthesis)")
        del gm, gopt, em, eopt, g
    report["11a_s"] = time.perf_counter() - t_phase

    # ---- 11b: one float32 step, sliced against unsliced, on one batch
    m1 = fresh(F32)[0]
    m4 = copy.deepcopy(m1)
    bx, by, bk = batch_fn(TRAIN_BATCH, synth_data.step_generator(torch.Generator(device=dev),
                                                                 TRAIN_SEED, 0))
    l1 = float(train_mod.loss_and_grads(m1, bx, by, bk))
    l4 = float(train_mod.loss_and_grads(m4, bx, by, bk, micro=MICRO))
    loss_rel = abs(l4 / l1 - 1)
    names = [k for k, _ in m1.named_parameters()]
    g1 = [p.grad for p in m1.parameters()]
    g4 = [p.grad for p in m4.parameters()]
    errs = {k: float((a - b).abs().max() / b.abs().max()) for k, a, b in zip(names, g4, g1)}
    misses = [k for k, e in errs.items() if e > MB_RTOL]
    check(loss_rel <= MB_RTOL, f"11b: the loss at micro={MICRO} is {loss_rel:.2e} off k = 1's")
    check(set(misses) <= set(MB_ILL_CONDITIONED),
          f"11b: gradients at micro={MICRO} off k = 1's beyond {MB_RTOL} of their largest "
          f"element: {[(k, errs[k]) for k in misses]}")
    vs_f64 = {}
    if misses:  # each against a float64 step: k = MICRO within 2 x k = 1's distance
        ref = copy.deepcopy(m1).double()
        ref.mpaec.frontend = "gemm"
        train_mod.loss_and_grads(ref, bx.double(), by.double(), bk.double())
        r64 = dict(ref.named_parameters())
        for k in misses:
            i = names.index(k)
            d1, d4 = (float((g[i].double() - r64[k].grad).abs().max()) for g in (g1, g4))
            vs_f64[k] = {"k1": d1, f"k{MICRO}": d4, "max_g": float(r64[k].grad.abs().max())}
            check(d4 <= 2 * d1, f"11b: {k} at micro={MICRO} is {d4:.3e} off float64, over twice "
                                f"k = 1's {d1:.3e}")
        del ref, r64
    report["11b"] = {"loss_rel": loss_rel, "grad_rel": errs, "rule": (
        f"every gradient within {MB_RTOL} of its leaf's max|g|" if not misses else
        f"within {MB_RTOL} of max|g| but {misses}, each within 2 x k = 1's distance from a "
        "float64 step"), "vs_float64": vs_f64}
    print(f"11b: one f32 step at micro={MICRO} against k = 1 on one batch of {TRAIN_BATCH}: loss "
          f"{loss_rel:.2e} relative (limit {MB_RTOL}); the worst gradient {max(errs.values()):.2e} "
          f"of its leaf's max|g| ({max(errs, key=errs.get)}); "
          + ("every leaf within the limit" if not misses else
             "the ill-conditioned leaves against float64: " + json.dumps(vs_f64)))
    del m1, m4, g1, g4
    report["11b_s"] = time.perf_counter() - t_phase

    # ---- 11c: a world of one under NCCL at k = MICRO against no mesh
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize("file://" + os.path.join(store, "store"), 1, 0, "nccl", dev)
        try:
            mesh = meshlib.make_mesh(device=dev)
            runs = []
            for m in (None, mesh):
                net, opt, lr_fn = fresh(BF16)
                losses = graph(net, opt, lr_fn, TRAIN_BATCH, MB_STEPS, MICRO, mesh=m)(0, MB_STEPS)
                runs.append((losses, [p.detach().clone() for p in net.parameters()]))
        finally:
            distributed.shutdown()
    (l_single, w_single), (l_mesh, w_mesh) = runs
    check(torch.equal(l_single, l_mesh) and all(torch.equal(a, b) for a, b in zip(w_single, w_mesh)),
          f"11c: the world of one under NCCL at micro={MICRO} differs from no mesh")
    report["11c"] = {"steps": MB_STEPS, "bit_equal": True}
    print(f"11c: a world of one under NCCL (the split graphs around the all-reduce) at "
          f"micro={MICRO}, bf16, {MB_STEPS} steps bit-equal to the single graph without a mesh")
    del runs, w_single, w_mesh
    report["11c_s"] = time.perf_counter() - t_phase

    # ---- 11d: bf16 ms a step and the peak memory of a step, k = 1 against k = MICRO
    report["11d"] = {}
    for batch in MB_BATCHES:
        made = {}
        for k in (1, MICRO):
            net, opt, lr_fn = fresh(BF16)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            g = graph(net, opt, lr_fn, batch, MB_TIMED, k)
            g(0, 1)  # the warm-up step, dispatched op by op, and the capture
            torch.cuda.synchronize(dev)
            made[k] = {"graph": g, "net": net, "next": 1, "ms": [],
                       "peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9}
        for k in (1, MICRO, MICRO, 1):
            run = made[k]
            run["ms"].append(_graph_ms(run["graph"], run["next"], MB_TIMED))
            run["next"] += MB_TIMED
        report["11d"][batch] = {f"k{k}": {"ms_a_step": v["ms"], "peak_gb_a_step": v["peak_gb"]}
                                for k, v in made.items()}
        print(f"11d: bf16, batch {batch}: ms a step (host clock, blocks of {MB_TIMED} replays, in "
              f"turns) k = 1 {made[1]['ms']}, k = {MICRO} {made[MICRO]['ms']}; the peak memory of "
              f"a step above the model (the warm-up and the capture) k = 1 "
              f"{made[1]['peak_gb']:.3f} GB, k = {MICRO} {made[MICRO]['peak_gb']:.3f} GB, on {smi}")
        del made
    for name, n_launch in launches.items():
        results[name]["launches_microbatch"] = n_launch
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {report['seconds']:.2f} s (limit {PHASE11_LIMIT_S:.0f} s): 11a by "
          f"{report['11a_s']:.2f}, 11b by {report['11b_s']:.2f}, 11c by {report['11c_s']:.2f}")
    check(report["seconds"] <= PHASE11_LIMIT_S,
          f"phase 11 took {report['seconds']:.2f} s > {PHASE11_LIMIT_S:.0f} s")
    return report


def main() -> None:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the port on a CUDA card")
    if not (HERE / "signaltrain_tpu_torch" / "__init__.py").is_file() or not CKPT.is_file():
        fail(f"run from a checkout of the repository: {HERE} lacks the package or {CKPT.name}")
    sys.path.insert(0, str(HERE))

    from signaltrain_tpu_torch.cli import time_frontend, time_smoother
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects, synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, cuda_kernels
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod
    from signaltrain_tpu_torch.utils.card import (PEAK_BF16_FLOPS,
                                                  PEAK_SPLIT_TF32_FLOPS, sm_clock_mhz)
    from signaltrain_tpu_torch.utils.card import bound_ms as bound
    from signaltrain_tpu_torch.utils.load_model import load_model

    c_chain_cycles = time_smoother.CHAIN_CYCLES  # C's floor: an fma and a select a step
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # ---- 1. card, model and clip, build (the build last, so that kernel
    # A's first check follows it directly)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    model, rv = load_model(str(CKPT), device=dev)
    spec = model.spec
    ft, hop, half = spec.ft_size, spec.hop_size, spec.ft_size // 2 + 1
    chunk, out_chunk = spec.in_chunk_size, spec.out_chunk_size
    sr = int(rv["sr"])
    clip = synths.music_like_clip(CLIP_SECONDS, sr=sr, seed=0)
    n_windows = pl._num_windows(len(clip), chunk, chunk - out_chunk)
    ct_batch = (len(clip) - out_chunk) // out_chunk + 1  # calc_ct's full-length windows
    lp = chunk + 2 * ft
    frames, out_frames = spec.time_frames, spec.output_time_frames
    out_len = spec.out_chunk_size
    with torch.no_grad():
        w_an = model.mpaec.dft_analysis.stacked_weights().contiguous()
        w_syn = model.mpaec.dft_synthesis.stacked_weights().contiguous()
    print(f"main path: {CLIP_SECONDS} s clip, {n_windows} windows of {chunk} -> {out_chunk}, "
          f"ft {ft} hop {hop} T {frames} OT {out_frames}")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built) or 'nothing (cached)'}"
          f" {json.dumps({k: round(v, 2) for k, v in built.items()})}")
    for name in _cuda.sources():
        for line in _cuda.build_report(name):
            print(f"  ptxas[{name}]: {line}")

    occupancy = _cuda.function("frontend", "st_analysis_blocks_per_sm", [ctypes.c_int])
    print(f"blocks of the tensor-core product an SM holds at once: {occupancy(0)} (float32), "
          f"{occupancy(1)} (bfloat16)")

    # ---- 2. kernels against their plain versions, on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    with torch.inference_mode():
        # A on both schedules (the rule's wgmma at these shapes, and mma.sync):
        # the serving batch on three seeds, the first straight after the
        # build, the training batch in between (the timing takes the last xp)
        check(cuda_frontend.schedule_for(None, F32, ft, hop, lp, "A") == "wgmma",
              "f32 A: the rule does not pick wgmma at the flagship geometry")
        a_err = {sched: dict(mag=0.0, phs=0.0, small=0.0) for sched in cuda_frontend.SCHEDULES}
        a_checks = [(seed, n_windows) for seed in SEEDS]
        a_checks.insert(1, (len(SEEDS), TRAIN_BATCH))
        for seed, nb in a_checks:
            sg = torch.Generator(device=dev).manual_seed(seed)
            xp = torch.nn.functional.pad(
                torch.randn(nb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
            rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop)
            if nb == TRAIN_BATCH:  # as accurate as f32: against a float64 spectrum
                spec64 = (xp.unfold(1, ft, hop).transpose(0, 1).double() * 0.5) @ w_an.double()
                mag64 = torch.sqrt(spec64[..., :half] ** 2 + spec64[..., half:] ** 2)
                mag64 = mag64.clamp_min(1e-18)
                del spec64
            for sched in cuda_frontend.SCHEDULES:
                mag, phs = cuda_frontend.fused_analysis(xp, w_an, ft, hop, schedule=sched)
                again = cuda_frontend.fused_analysis(xp, w_an, ft, hop, schedule=sched)
                torch.cuda.synchronize()
                check(mag.shape == (frames, nb, half), f"analysis shape {tuple(mag.shape)}")
                check(torch.equal(mag, again[0]) and torch.equal(phs, again[1]),
                      f"kernel A ({sched}): two runs on the same inputs are not bit-equal")
                m_err = float((mag - rmag).abs().max())
                mag_excess = float(((mag - rmag).abs() - (2e-5 + 2e-5 * rmag.abs())).max())
                cls = phase_classes(phs, rphs, rmag)
                print(f"A fused_analysis {sched} xp {tuple(xp.shape)} seed {seed}: max|dmag| "
                      f"{m_err:.3e} (tolerance 2e-5+2e-5|mag|); wrapped phase: "
                      f"{cls['regular']['bins']} bins of magnitude >= 1e-2, worst "
                      f"{cls['regular']['worst']:.3e} (tolerance 2e-4+2e-4|phs|); "
                      f"{cls['small']['bins']} smaller bins, worst {cls['small']['worst']:.3e} "
                      f"(tolerance 2e-6/mag); two runs bit-equal")
                check(mag_excess <= 0, disagreement(f"A {sched} (magnitude, seed {seed})", mag, rmag))
                for name, c in cls.items():
                    check(c["excess"] <= 0, f"kernel A {sched} (phase, {name} bins, seed {seed}): "
                                            f"worst difference {c['worst']:.3e}, {c['excess']:.3e} "
                                            f"over its limit")
                check(all(bool(torch.all(mag[e] == np.float32(1e-18))) and bool(torch.all(phs[e] == 0))
                          for e in (0, -1)), f"kernel A {sched}: an edge frame is not exactly (1e-18, 0)")
                e = a_err[sched]
                e["mag"] = max(e["mag"], m_err)
                e["phs"] = max(e["phs"], cls["regular"]["worst"])
                e["small"] = max(e["small"], cls["small"]["worst"])
                if nb == TRAIN_BATCH:
                    e["f64"], e["f64_plain"] = as_accurate(f"A {sched} (magnitude)", mag, rmag,
                                                           mag64, 1e-7)
                    print(f"A {sched} against a float64 spectrum, xp {tuple(xp.shape)}: max "
                          f"magnitude error kernel {e['f64']:.3e}, plain version "
                          f"{e['f64_plain']:.3e}; limit 2 x plain + 1e-7; max|mag| "
                          f"{float(mag64.max()):.3f}")
            if nb == TRAIN_BATCH:
                fr = xp.unfold(1, ft, hop).transpose(0, 1).reshape(-1, ft) * 0.5
                emu = cuda_frontend.split_tf32_matmul(fr, w_an, chunk=32)
                emu_err = float((cuda_frontend.mag_phs(emu[:, :half], emu[:, half:])[0]
                                 - mag64.reshape(-1, half)).abs().max())
                # the control: one TF32 product (the operands cut to TF32, no
                # split) against the same float64 rule
                one = cuda_frontend.split_tf32(fr)[0] @ cuda_frontend.split_tf32(w_an)[0]
                one_err = float((cuda_frontend.mag_phs(one[:, :half], one[:, half:])[0]
                                 - mag64.reshape(-1, half)).abs().max())
                a_gap = one_err / (2 * a_err["wgmma"]["f64_plain"] + 1e-7)
                print(f"A: split_tf32_matmul(chunk=32) against float64 {emu_err:.3e}; the control, "
                      f"one TF32 product, {one_err:.3e}: {a_gap:.1f}x the limit (needs > "
                      f"{GAP_F32:g}x)")
                check(a_gap > GAP_F32, f"A's float64 rule cannot tell one TF32 product: {a_gap:.2f}x")
                del mag64, emu, one, fr

        def a_summary(e):
            return dict(max_abs_err=e["mag"], max_phase_err=e["phs"],
                        max_small_bin_phase_err=e["small"], max_err_vs_float64=e["f64"],
                        plain_max_err_vs_float64=e["f64_plain"])

        results["fused_analysis"] = dict(
            **a_summary(a_err["wgmma"]), schedule="wgmma",
            mma_sync=dict(**a_summary(a_err["mma"]), counter="fused_analysis_mma"),
            control_one_tf32_product=a_gap,
            tolerance="mag 2e-5 + 2e-5*|mag|; wrapped phase 2e-4 + 2e-4*|phs| where mag >= 1e-2, "
                      "2e-6/mag below; magnitude error against float64 <= 2 x plain's + 1e-7, one "
                      f"TF32 product > {GAP_F32:g}x that limit; both schedules at batches 200 and "
                      "643; two runs bit-equal; edge frames exactly 1e-18 and 0")

        # B on both schedules (the rule's wgmma at every shape, and mma.sync)
        # at the training and the serving batch; the float64 rule's control:
        # the plain version on operands cut to TF32 (one product, no split)
        check(cuda_frontend.schedule_for(None, F32, ft, hop, None, "B") == "wgmma",
              "f32 B: the rule does not pick wgmma")
        b_err = {sched: dict(err=0.0, f64=0.0, f64_plain=0.0) for sched in cuda_frontend.SCHEDULES}
        b_gap = math.inf
        for nb in (TRAIN_BATCH, n_windows):  # smag, sphs end as the serving ones, for the timing
            smag = torch.nn.functional.softplus(
                torch.randn(out_frames, nb, half, generator=gen, device=dev))
            sphs = torch.randn(out_frames, nb, half, generator=gen, device=dev) * 2.0
            rwave = cuda_frontend.fused_synthesis_reference(smag, sphs, w_syn, ft, hop)
            xwave = cuda_frontend.fused_synthesis_reference(smag.double(), sphs.double(),
                                                            w_syn.double(), ft, hop)
            b_floor = 1e-6 * float(xwave.abs().max())
            gap = f64_rule_ratio(one_tf32_synthesis(cuda_frontend, smag, sphs, w_syn, ft, hop),
                                 rwave, xwave, share=1e-6)
            print(f"B mag {tuple(smag.shape)}: the control, one TF32 product, uses {gap:.1f}x the "
                  f"float64 rule's limit (needs > {GAP_F32:g}x)")
            check(gap > GAP_F32, f"B's float64 rule cannot tell one TF32 product: {gap:.2f}x")
            b_gap = min(b_gap, gap)
            for sched in cuda_frontend.SCHEDULES:
                wave = cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop, schedule=sched)
                wave2 = cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop, schedule=sched)
                torch.cuda.synchronize()
                check(wave.shape == (nb, out_len), f"synthesis shape {tuple(wave.shape)}")
                check(torch.equal(wave, wave2),
                      f"kernel B ({sched}): two runs on the same inputs are not bit-equal")
                err, syn_excess = elementwise_excess(wave, rwave, 3e-4)
                f64, f64_plain = as_accurate(f"B {sched}", wave, rwave, xwave, b_floor)
                print(f"B fused_synthesis {sched} mag {tuple(smag.shape)}: max|dwave| {err:.3e}; "
                      f"tolerance 3e-4+3e-4|wave|; against float64: kernel {f64:.3e}, plain "
                      f"version {f64_plain:.3e} (limit 2 x plain + 1e-6 max|wave|, max|wave| "
                      f"{float(xwave.abs().max()):.3f}); two runs bit-equal")
                check(syn_excess <= 0, disagreement(f"B {sched}", wave, rwave))
                e = b_err[sched]
                e["err"], e["f64"], e["f64_plain"] = (max(e["err"], err), max(e["f64"], f64),
                                                      max(e["f64_plain"], f64_plain))
            del xwave

        def err_summary(e):
            return dict(max_abs_err=e["err"], max_err_vs_float64=e["f64"],
                        plain_max_err_vs_float64=e["f64_plain"])

        results["fused_synthesis"] = dict(
            **err_summary(b_err["wgmma"]), schedule="wgmma",
            mma_sync=dict(**err_summary(b_err["mma"]), counter="fused_synthesis_mma"),
            control_one_tf32_product=b_gap,
            tolerance="3e-4 + 3e-4*|wave|; error against float64 <= 2 x plain's + 1e-6*max|wave|, "
                      f"one TF32 product > {GAP_F32:g}x that limit; both schedules at batches 200 "
                      "and 643; two runs bit-equal")

        smooth_shapes = [(1, len(clip)), (1, chunk), (ct_batch, chunk), (TRAIN_BATCH, chunk)]
        smooth_err, plain_c_s = 0.0, 0.0
        for b, n in smooth_shapes:
            g = torch.randn(b, n, generator=gen, device=dev)
            aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            plain_c_s += time.perf_counter() - t_start
            err = float((s - rs).abs().max())
            smooth_err = max(smooth_err, err)
            print(f"C switched_one_pole g {(b, n)} ({'chunked' if cuda_kernels.uses_chunks(b, n) else 'row'}"
                  f" schedule, {cuda_kernels.rows_per_block(b, sms)} rows a block): bit-equal to the "
                  f"plain version {torch.equal(s, rs)} (plain version "
                  f"{time.perf_counter() - t_start:.2f} s)")
            check(torch.equal(s, rs) and bool(torch.all(s[:, 0] == 0)), disagreement("C", s, rs))
        # the adversarial rows (ties, +-0.0, subnormals, the alphas' extremes),
        # by rows at the training chunk and chunked at 70,000 samples, from
        # aligned memory (bulk copies) and from memory 4 bytes off (4-byte copies)
        for n in (chunk, 70_000):
            g, aa, ar = time_smoother.adversarial_rows(n, dev)
            s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
            moved = cuda_kernels.smoother_rows(off_boundary(g), aa, ar)
            t_start = time.perf_counter()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            plain_c_s += time.perf_counter() - t_start
            same = all(torch.equal(v.view(torch.int32), rs.view(torch.int32)) for v in (s, moved))
            print(f"C adversarial rows g {tuple(g.shape)} "
                  f"({'chunked' if cuda_kernels.uses_chunks(*g.shape) else 'row'} schedule; by rows "
                  f"from memory 4 bytes off too): bit-equal to the plain version {same}")
            check(same, disagreement("C (adversarial rows)", s, rs))
        # the chunked schedule on whole-clip rows, bit-equal to the row schedule:
        # the serving path's own gain curve, randn, and a row that never meets
        plain_c_ms = None
        for case in ("serving_curve", "randn", "step_to_silence"):
            g, aa, ar = time_smoother.long_rows(case, dev)
            s, stats = cuda_kernels.smoother_chunked(g, aa, ar)
            rows = cuda_kernels.smoother_rows(g, aa, ar)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            t_plain = time.perf_counter() - t_start
            plain_c_s += t_plain
            if case == "serving_curve":
                plain_c_ms = t_plain * 1e3
            err = float((s - rs).abs().max())
            smooth_err = max(smooth_err, err)
            print(f"C chunked schedule, {case} g {tuple(g.shape)}: bit-equal to the row schedule "
                  f"{torch.equal(s, rows)}, to the plain version {torch.equal(s, rs)} "
                  f"({t_plain:.2f} s); W {int(stats[0, 0])}, L {cuda_kernels.CHUNK}, "
                  f"{math.ceil(g.shape[1] / cuda_kernels.CHUNK)} virtual rows, "
                  f"{int(stats[0, 1])} steps re-run")
            check(torch.equal(s, rows), f"kernel C: the chunked schedule differs from the row "
                                        f"schedule on {case}")
            check(torch.equal(s, rs), disagreement(f"C (chunked, {case})", s, rs))
        print(f"C: the plain version took {plain_c_s:.2f} s in all")
        results["switched_one_pole"] = dict(
            max_abs_err=smooth_err, plain_s_all_checks=plain_c_s,
            tolerance="bit-equal to the plain version at every shape, the adversarial rows "
                      "(time_smoother.adversarial_rows) included; the chunked schedule bit-equal "
                      "to the row schedule")

        # D and E at the training shapes; cotangents scaled by 64/ft so the
        # gradients stay O(1-10), as in the CPU tests against the JAX package
        tb, tlp = TRAIN_BATCH, chunk + 2 * ft
        check(cuda_frontend.schedule_for(None, F32, ft, hop, tlp, "D") == "wgmma",
              "f32 D: the rule does not pick wgmma at the flagship geometry")
        d_err = {sched: dict(dw=0.0, dx=0.0, reg=0.0, dx_share=0.0, dw_share=0.0)
                 for sched in cuda_frontend.SCHEDULES}
        for seed in SEEDS:
            sg = torch.Generator(device=dev).manual_seed(100 + seed)
            txp = torch.nn.functional.pad(
                torch.randn(tb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
            tdmag = torch.randn(frames, tb, half, generator=sg, device=dev) * (64.0 / ft)
            tdphs = torch.randn(frames, tb, half, generator=sg, device=dev) * (64.0 / ft)
            rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, tdphs, ft, hop)
            xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(
                txp.double(), w_an.double(), tdmag.double(), tdphs.double(), ft, hop)
            # With a unit-normal phase cotangent on every bin, dphs / |spec|
            # amplifies the ~5e-7 by which two f32 spectra differ: two f32
            # results cannot be compared element by element (the plain version
            # itself is off a float64 one by ~1e-2 in dx and ~1e-3 * max|dW| in
            # dW). So the kernel, and the plain version beside it, are held
            # against float64, every element to 5e-4 + 5e-4|g| plus the slack
            # its conditioning gives it. dx on the unpadded signal: the
            # padding's part carries the adjoint of the all-zero frames.
            sdxp, sdw = cuda_frontend.fused_analysis_bwd_conditioning(txp, w_an, tdmag, tdphs, ft, hop)
            sl = slice(ft, -ft)

            def shares(gx, gw):
                ex = (gx[:, sl] - xdxp[:, sl]).abs()
                ew = (gw - xdw).abs()
                return (float(ex.max()), float(ew.max()),
                        float((ex / (5e-4 + 5e-4 * xdxp[:, sl].abs() + sdxp[:, sl])).max()),
                        float((ew / (5e-4 + 5e-4 * xdw.abs() + sdw)).max()))

            plain = shares(rdxp, rdw)
            if seed == SEEDS[0]:  # the control: the plain version on operands cut to TF32
                cut = cuda_frontend.split_tf32
                d_gap = min(shares(*cuda_frontend.fused_analysis_bwd_reference(
                    cut(txp)[0], cut(w_an)[0], tdmag, tdphs, ft, hop))[2:])
                print(f"D: the control, the plain version on operands cut to TF32, uses {d_gap:.1f}x "
                      f"its tolerance against float64 (needs > {GAP_F32:g}x)")
                check(d_gap > GAP_F32, f"D's float64 rule cannot tell one TF32 product: {d_gap:.2f}x")
            # the same with the phase cotangent zeroed on the bins of small
            # magnitude (the all-padding frames among them): dphs / |spec| is
            # then well conditioned and every element of dxp and dW is held
            kmag = cuda_frontend.fused_analysis_reference(txp, w_an, ft, hop)[0]
            cphs = tdphs * (kmag >= 0.25 * kmag.median())
            rcdxp, rcdw = cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, cphs, ft, hop)
            for sched in cuda_frontend.SCHEDULES:
                dxp, dw = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop,
                                                           schedule=sched)
                dxp2, dw2 = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop,
                                                             schedule=sched)
                only_dw = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop,
                                                           need_dxp=False, schedule=sched)[1]
                torch.cuda.synchronize()
                check(dxp.shape == (tb, tlp) and dw.shape == (ft, 2 * half), "D: shapes")
                check(torch.equal(dw, dw2) and torch.equal(dxp, dxp2) and torch.equal(dw, only_dw),
                      f"kernel D ({sched}): two runs on the same inputs, or with and without dxp, "
                      "are not bit-equal")
                dx_err, dw_err, dx_share, dw_share = shares(dxp, dw)
                print(f"D fused_analysis_bwd {sched} xp {tuple(txp.shape)} seed {seed}, against "
                      f"float64: max dx error {dx_err:.3e} (plain version {plain[0]:.3e}), max dW "
                      f"error {dw_err:.3e} (plain version {plain[1]:.3e}, max|dW| "
                      f"{float(xdw.abs().max()):.3e}); largest share of the tolerance "
                      f"5e-4+5e-4|g|+slack used: dx {dx_share:.3f} (plain {plain[2]:.3f}), dW "
                      f"{dw_share:.3f} (plain {plain[3]:.3f}); median slack dx "
                      f"{float(sdxp[:, sl].median()):.2e}, dW {float(sdw.median()):.2e}; two runs, "
                      "and dW without dxp, bit-equal")
                check(dx_share <= 1, f"kernel D {sched} (dx, seed {seed}) is {dx_share:.2f} of its "
                                     "tolerance off the float64 result")
                check(dw_share <= 1, f"kernel D {sched} (dW, seed {seed}) is {dw_share:.2f} of its "
                                     "tolerance off the float64 result")
                dxp, dw = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, cphs, ft, hop,
                                                           schedule=sched)
                torch.cuda.synchronize()
                rx_err, rx_excess = elementwise_excess(dxp, rcdxp, 5e-4)
                rw_err, rw_excess = elementwise_excess(dw, rcdw, 5e-4)
                print(f"D {sched} well-conditioned, seed {seed}: max|d dxp| {rx_err:.3e} (median|dxp| "
                      f"{float(rcdxp.abs().median()):.3e}), max|d dW| {rw_err:.3e} (median|dW| "
                      f"{float(rcdw.abs().median()):.3e}, max {float(rcdw.abs().max()):.3e}); "
                      f"tolerance 5e-4+5e-4|g| on every element")
                check(rx_excess <= 0, disagreement(f"D {sched} (dxp, well-conditioned, seed {seed})",
                                                   dxp, rcdxp))
                check(rw_excess <= 0, disagreement(f"D {sched} (dW, well-conditioned, seed {seed})",
                                                   dw, rcdw))
                e = d_err[sched]
                e["dw"], e["dx"] = max(e["dw"], dw_err), max(e["dx"], dx_err)
                e["dx_share"], e["dw_share"] = max(e["dx_share"], dx_share), max(e["dw_share"], dw_share)
                e["reg"] = max(e["reg"], rw_err, rx_err)
            del xdxp, xdw, sdxp, sdw

        def d_summary(e):
            return dict(max_abs_err=e["dw"], max_dx_err=e["dx"], max_regular_err=e["reg"],
                        max_dx_share=e["dx_share"], max_dw_share=e["dw_share"])

        results["fused_analysis_bwd"] = dict(
            **d_summary(d_err["wgmma"]), schedule="wgmma",
            mma_sync=dict(**d_summary(d_err["mma"]), counter="fused_analysis_bwd_mma"),
            control_one_tf32_product=d_gap,
            tolerance="unit-normal phase cotangents, against float64: 5e-4 + 5e-4*|g| + the "
                      "element's conditioning slack, dx on the unpadded signal and dW, the plain "
                      f"version on operands cut to TF32 > {GAP_F32:g}x it; well-conditioned ones, "
                      "against the plain version: 5e-4 + 5e-4*|g| on every element of dxp and dW; "
                      "both schedules on three seeds; two runs, and dW without dxp, bit-equal")

        tmag = torch.nn.functional.softplus(
            torch.randn(out_frames, tb, half, generator=gen, device=dev))
        tphs = torch.randn(out_frames, tb, half, generator=gen, device=dev) * 2.0
        tdout = torch.randn(tb, out_len, generator=gen, device=dev)
        check(cuda_frontend.schedule_for(None, F32, ft, hop, out_len + 2 * ft, "E") == "wgmma",
              "f32 E: the rule does not pick wgmma at the flagship geometry")
        e_want = cuda_frontend.fused_synthesis_bwd_reference(tmag, tphs, w_syn, tdout, ft, hop)
        e_exact = cuda_frontend.fused_synthesis_bwd_reference(
            tmag.double(), tphs.double(), w_syn.double(), tdout.double(), ft, hop)
        # the control: the plain version on operands cut to TF32 (dout and w)
        cut = cuda_frontend.split_tf32
        e_ones = cuda_frontend.fused_synthesis_bwd_reference(tmag, tphs, cut(w_syn)[0],
                                                             cut(tdout)[0], ft, hop)
        e_gap = min(f64_rule_ratio(o, r, x, share=1e-6) for o, r, x in zip(e_ones, e_want, e_exact))
        print(f"E: the control, the plain version on operands cut to TF32, uses {e_gap:.1f}x the "
              f"float64 rule's limit (needs > {GAP_F32:g}x)")
        check(e_gap > GAP_F32, f"E's float64 rule cannot tell one TF32 product: {e_gap:.2f}x")
        del e_ones
        e_errs = {sched: dict(err=0.0, f64=0.0, f64_plain=0.0) for sched in cuda_frontend.SCHEDULES}
        for sched in cuda_frontend.SCHEDULES:
            e_got = cuda_frontend.fused_synthesis_bwd(tmag, tphs, w_syn, tdout, ft, hop,
                                                      schedule=sched)
            e_again = cuda_frontend.fused_synthesis_bwd(tmag, tphs, w_syn, tdout, ft, hop,
                                                        schedule=sched)
            torch.cuda.synchronize()
            e = e_errs[sched]
            for name, g1, g2, r, x in zip(("dmag", "dphs", "dW"), e_got, e_again, e_want, e_exact):
                check(torch.equal(g1, g2), f"kernel E ({sched}): two runs differ in {name}")
                err = float((g1 - r).abs().max())
                excess = float(((g1 - r).abs() - (5e-4 + 5e-4 * r.abs())).max())
                check(excess <= 0, disagreement(f"E {sched} ({name})", g1, r))
                f64, f64_plain = as_accurate(f"E {sched} ({name})", g1, r, x,
                                             1e-6 * float(x.abs().max()))
                print(f"E {sched} {name}: max error {err:.3e}; against float64: kernel {f64:.3e}, "
                      f"plain version {f64_plain:.3e} (max|{name}| {float(x.abs().max()):.3e})")
                e["err"], e["f64"], e["f64_plain"] = (max(e["err"], err), max(e["f64"], f64),
                                                      max(e["f64_plain"], f64_plain))
            for g1 in e_got[:2]:  # frames wholly inside the trimmed margin
                check(bool(torch.all(g1[0] == 0)) and bool(torch.all(g1[-1] == 0)),
                      f"kernel E ({sched}): the first or last frame's gradient is not exactly 0")
            print(f"E fused_synthesis_bwd {sched} mag {tuple(tmag.shape)}: max error "
                  f"{e['err']:.3e} (tolerance 5e-4+5e-4|g|); two runs bit-equal; edge frames "
                  "exactly 0")
        del e_exact
        results["fused_synthesis_bwd"] = dict(
            **err_summary(e_errs["wgmma"]), schedule="wgmma",
            mma_sync=dict(**err_summary(e_errs["mma"]), counter="fused_synthesis_bwd_mma"),
            control_one_tf32_product=e_gap,
            tolerance="5e-4 + 5e-4*|g| for dmag, dphs, dW; error against float64 <= 2 x plain's + "
                      f"1e-6*max|g|, the plain version on operands cut to TF32 > {GAP_F32:g}x that "
                      "limit; both schedules; two runs bit-equal; edge frames exactly 0")
    torch.cuda.synchronize()

    # ---- 2b. the bf16 modes of A, B, D and E against their plain bf16 versions
    with torch.inference_mode():
        bf16_results, bf16_ins = check_bf16_kernels(cuda_frontend, dev, w_an, w_syn, ft, hop, chunk,
                                                    out_frames, n_windows)
    results.update(bf16_results)

    # ---- 2c. kernel L against its plain version
    results["lfilter"] = check_lfilter(dev)

    # ---- 3. the serving path, counted
    kr = np.asarray(rv["knob_ranges"], np.float32)
    knobs_nn = (KNOBS_WC - kr[:, 0]) / (kr[:, 1] - kr[:, 0]) - 0.5
    _cuda.reset_counts()
    t_path = time.perf_counter()
    y_pred = pl.predict_long(clip, knobs_nn, model)
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    y_st, _ = effect.go_wc(clip, KNOBS_WC)
    y_st = y_st.cpu().numpy()
    y_ct = pl.calc_ct(clip, effect, KNOBS_WC, out_chunk, chunk)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    counts = {name: (c.launches, c.plain_calls) for name, c in _cuda.COUNTERS.items()}
    print(f"serving path {t_path:.2f} s; launches / plain calls: {json.dumps(counts)}")
    for name in ("fused_analysis", "fused_synthesis", "switched_one_pole",
                 "switched_one_pole_chunked"):
        check(counts[name][0] > 0, f"serving path never launched kernel {name}")
    for name in F32_MMA_NAMES:  # float32 A and B on the wgmma schedule only
        check(counts[name][0] == 0, f"serving path launched {name} (the mma.sync schedule)")
    for name in results:
        check(counts[name][1] == 0, f"serving path ran the plain version of {name}")
        results[name]["launches_serving"] = counts[name][0]

    lookback = chunk - out_chunk
    check(y_pred.shape == (len(clip) - lookback,), f"prediction length {y_pred.shape}")
    check(bool(np.all(np.isfinite(y_pred))), "prediction is not finite")

    def corr(a, b):
        a, b = a - a.mean(), b - b.mean()
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    n = min(len(y_pred), len(y_st) - lookback)
    c_st = corr(y_pred[:n], y_st[lookback : lookback + n])
    c_ct = corr(y_pred[:n], y_ct[lookback : lookback + n])
    print(f"corr(prediction, streamed target) {c_st:.6f}; corr(prediction, chunked target) "
          f"{c_ct:.6f}; floor {MIN_CORR}")
    check(c_st >= MIN_CORR and c_ct >= MIN_CORR, "prediction does not follow the target")

    short = clip[: chunk + 20 * out_chunk + 77]
    cpu_model, _ = load_model(str(CKPT), device="cpu")
    y_cpu = pl.predict_long(short, knobs_nn, cpu_model)
    y_card = pl.predict_long(short, knobs_nn, model)
    d_cpu = float(np.abs(y_card - y_cpu).max())
    print(f"card vs plain CPU path on {len(short)} samples: max|dy| {d_cpu:.3e}; tolerance 1e-3")
    check(d_cpu <= 1e-3, "card and plain CPU path disagree")

    # ---- 4. the training paths, float32 then bfloat16, each counted
    short_clip = synths.music_like_clip(2.0, sr=sr, seed=1)
    steps = TRAIN_EPOCHS * (TRAIN_POINTS // TRAIN_BATCH)
    f32_names = ["fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd"]
    bf16_names = ["bf16_" + name for name in f32_names]

    steps_per_epoch, val_steps = TRAIN_POINTS // TRAIN_BATCH, (TRAIN_POINTS // 4) // TRAIN_BATCH
    batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=True)
    val_batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=False)

    def fresh(compute_dtype):
        """The model and capturable Adam that train() starts from."""
        m = st_model(device=dev, sr=sr, generator=torch.Generator().manual_seed(TRAIN_SEED),
                     compute_dtype=compute_dtype).train()
        return m, *train_mod.make_optimizer(m, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS, TRAIN_BATCH)

    def eager_train(compute_dtype):
        """train()'s loop dispatched op by op on the card, from the same
        weights and seeds: (model, per-step losses, mean validation MAE per
        epoch)."""
        m, opt, lr_fn = fresh(compute_dtype)
        g = torch.Generator(device=dev)
        losses, maes = [], []
        for epoch in range(TRAIN_EPOCHS):
            losses += train_mod.eager_steps(m, opt, lr_fn, batch_fn, TRAIN_BATCH, g, TRAIN_SEED,
                                            epoch * steps_per_epoch, steps_per_epoch).cpu().tolist()
            m.eval()
            maes.append(float(train_mod.eager_validation(m, val_batch_fn, TRAIN_BATCH, g,
                                                         val_steps)[1].cpu().numpy().mean()))
            m.train()
        return m, losses, maes

    def training_path(compute_dtype, names, others):
        """train() on the card in compute_dtype in a temporary directory (every
        step and validation batch but the first a CUDA-graph replay), its checkpoint through
        load_model (strict) and predict_long, with every counter set to 0
        just before and read just after: the kernels in names and C must have
        launched, none in others, and no plain version run. Then the same
        run dispatched op by op: every loss, every mean validation MAE and
        every weight bit-equal. Returns the served model, the mean validation
        MAEs and the seconds the path took."""
        tag = str(compute_dtype).removeprefix("torch.")
        cwd = os.getcwd()
        _cuda.reset_counts()
        t_path = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                (trained, hist), epochs, _ = timed(lambda: train_mod.train(
                    effect, epochs=TRAIN_EPOCHS, n_data_points=TRAIN_POINTS,
                    batch_size=TRAIN_BATCH, cp_every=TRAIN_EPOCHS, sr=sr, lr_max=TRAIN_LR,
                    seed=TRAIN_SEED, device=dev, compute_dtype=compute_dtype))
                val_lines = [ln.split() for ln in open("val_err_mae.dat").read().strip().splitlines()]
                vl_lines = [ln.split() for ln in open("vl_avg_out.dat").read().strip().splitlines()]
                served, served_rv = load_model("modelcheckpoint.tar", device=dev,  # strict inside
                                               compute_dtype=compute_dtype)
                with open("modelcheckpoint.tar", "rb") as f:
                    saved = f.read()
            finally:
                os.chdir(cwd)
        y_served = pl.predict_long(short_clip, knobs_nn, served)
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t_path
        counts = {name: (c.launches, c.plain_calls) for name, c in _cuda.COUNTERS.items()}
        print(f"\ntraining path, {tag}, {t_path:.2f} s; launches / plain calls: {json.dumps(counts)}")
        for name in names + ["switched_one_pole"]:
            check(counts[name][0] > 0, f"{tag} training path never launched kernel {name}")
            results[name][f"launches_training_{tag}"] = counts[name][0]
        for name in others:
            check(counts[name][0] == 0, f"{tag} training path launched kernel {name}")
        for name in results:
            check(counts[name][1] == 0, f"{tag} training path ran the plain version of {name}")
        check(len(hist["train_loss"]) == steps and hist["step"] == steps, "train(): step count")
        check(bool(np.all(np.isfinite(hist["train_loss"]))), "train(): a training loss is not finite")
        check(len(val_lines) == TRAIN_EPOCHS and len(vl_lines) == TRAIN_EPOCHS, "train(): log lines")
        check(all(np.isfinite(float(v)) for ln in val_lines + vl_lines for v in ln),
              "train(): a logged validation figure is not finite")
        mean_maes = [float(ln[2]) for ln in val_lines]
        print(f"train({tag}): loss first {hist['train_loss'][0]:.4e} last "
              f"{hist['train_loss'][-1]:.4e}; mean validation MAE by epoch {mean_maes}")
        check(mean_maes[-1] < mean_maes[0], f"validation MAE did not fall: {mean_maes}")
        check(served_rv["optax_step"] == steps, "checkpoint: optimizer step")
        check(all(torch.equal(a, b) for a, b in zip(served.state_dict().values(),
                                                   trained.state_dict().values())),
              "checkpoint: the served weights are not the trained ones")
        check(all(p.dtype == torch.float32 for p in served.parameters()),
              "checkpoint: a parameter is not float32")
        check(y_served.shape == (len(short_clip) - lookback,) and bool(np.all(np.isfinite(y_served))),
              "predict_long on the trained checkpoint: wrong length or not finite")
        eager, eager_losses, eager_maes = eager_train(compute_dtype)
        check(eager_losses == hist["train_loss"],
              f"{tag}: train() under CUDA graphs and eager dispatch differ in the losses")
        check(eager_maes == hist["val_mae_mean"],
              f"{tag}: train() under CUDA graphs and eager dispatch differ in validation MAE")
        check(all(torch.equal(a, b) for a, b in zip(eager.parameters(), trained.parameters())),
              f"{tag}: train() under CUDA graphs and eager dispatch differ in the weights")
        print(f"train({tag}) under CUDA graphs = eager dispatch, bit for bit: {len(eager_losses)} "
              f"losses, {len(eager_maes)} validation passes, every weight")
        phase4 = {"hist": hist, "epochs": epochs, "checkpoint": saved,
                  "weights": {k: v.clone() for k, v in trained.state_dict().items()}}
        return served, hist, mean_maes, t_path, phase4

    # bf16 A, B, D and E at this shape take the wgmma schedule: their mma.sync
    # schedule's counters must stay 0 on both paths
    served, hist, mean_maes, t_path, _ = training_path(torch.float32, f32_names,
                                                       bf16_names + MMA_NAMES)
    served_b, hist_b, mean_maes_b, t_path_b, phase4_b = training_path(BF16, bf16_names,
                                                                       f32_names + MMA_NAMES)
    for name in MMA_NAMES:  # checked 0 on both training paths
        r = results[name.removesuffix("_mma")]
        r["launches_mma_sync_training_float32"] = r["launches_mma_sync_training_bfloat16"] = 0

    # ---- 4b. every effect trained; 4c. the Denoise checkpoint served
    effects_report = train_every_effect(dev, results, chunk, out_chunk, sr)
    denoise = serve_denoise(dev, results, sr)
    print(json.dumps({"effects": effects_report, "denoise": denoise}))

    # ---- 6. file datasets; 7. train()'s whole surface
    file_datasets(dev, results, sr, smi)
    surface = train_surface(dev, results, sr, smi, phase4_b)
    print(json.dumps({"surface": surface}))
    # ---- 8. the rest of the single-card surface
    print(json.dumps({"single_card_surface": single_card_surface(dev, results, smi)}))
    # ---- 9. data parallelism
    print(json.dumps({"data_parallel": data_parallel(dev, results, smi, sr, clip, knobs_nn,
                                                     y_pred)}))
    # ---- 10. tensor parallelism
    print(json.dumps({"tensor_parallel": tensor_parallel(dev, results, smi, sr, phase4_b)}))
    # ---- 11. ST_TPU_MICROBATCH
    print(json.dumps({"microbatch": microbatch(dev, results, smi, sr)}))
    for name, r in results.items():
        r["launches"] = sum(v for k, v in r.items() if k.startswith("launches_"))

    # one more step on each of a few batches, in each dtype: the kernels against the
    # gemm front-end (plain autograd in float32, the bf16 gemm policy in
    # bfloat16), both against the gemm step in float64. The front-end's
    # gradients carry the phase adjoint dphs / |spec|, which amplifies the
    # ~5e-7 by which the kernels' spectrum and cuBLAS's differ (and in bf16
    # moves roundings by an ulp), so the two steps are never compared with
    # each other, only each with float64.
    data_gen = torch.Generator(device=dev)
    step_batches = [batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, TRAIN_SEED, s))
                    for s in range(steps, steps + STEP_CHECK_BATCHES)]
    bx, by, bk = step_batches[0]
    gemm = copy.deepcopy(served)
    gemm.mpaec.frontend = "gemm"
    gemm_b = copy.deepcopy(served_b)
    gemm_b.mpaec.frontend = "gemm"
    # the control of the bf16 rule: the bf16 model with its front-end on the
    # float32 kernels, as if the modes had not rounded
    control_b = copy.deepcopy(served_b)
    control_b.mpaec.dft_analysis.compute_dtype = torch.float32
    control_b.mpaec.dft_synthesis.compute_dtype = torch.float32
    for m in (served, gemm, served_b, gemm_b, control_b):
        m.train()
    # In bf16 the gemm step shares the reference's bf16 autoencoders and
    # roundings, so it lands within float32 noise of it, while any
    # float32-level difference in the kernels' spectrum moves a bf16 rounding
    # downstream by an ulp (2^-8): the fused step is held to floors between
    # its own readings and the control's (PERF.md, Findings).
    step_checks = {"float32": step_against_float64(train_mod, served, gemm, step_batches, "", 1e-5,
                                                   1e-3),
                   "bfloat16": step_against_float64(train_mod, served_b, gemm_b, step_batches,
                                                    "bf16_", STEP_LOSS_FLOOR_BF16,
                                                    STEP_GRAD_FLOOR_BF16, control=control_b)}

    # ---- 5. timing at the main paths' shapes
    with torch.inference_mode():
        results["fused_analysis"]["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop), reps=10)
        w_conv = w_an.t().contiguous()[:, None, :]  # (2*half, 1, ft)
        results["fused_analysis"]["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(xp[:, None, :], w_conv, stride=hop), reps=10)
        results["fused_analysis"]["cublas_ms"] = cuda_ms(
            time_frontend.cublas_analysis(xp, w_an, ft, hop, F32), reps=10)
        a_flops = 2.0 * n_windows * frames * ft * 2 * half
        a_bytes = 4.0 * (n_windows * lp + ft * 2 * half + 2 * frames * n_windows * half)
        results["fused_analysis"].update(zip(("bound_ms", "bound_by"),
                                             bound(a_flops, a_bytes, PEAK_SPLIT_TF32_FLOPS)))
        results["fused_analysis"]["bound_ms_cuda_cores"] = bound(a_flops, a_bytes)[0]
        results["fused_analysis"]["shape"] = f"xp {tuple(xp.shape)}, w {tuple(w_an.shape)}"

        results["fused_synthesis"]["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(smag, sphs, w_syn, ft, hop), reps=10)
        spec_bct = torch.cat([smag * torch.cos(sphs), smag * torch.sin(sphs)], -1).permute(1, 2, 0)
        spec_bct = spec_bct.contiguous()  # (B, 2*half, OT)
        w_tconv = w_syn[:, None, :].contiguous()  # (2*half, 1, ft)
        results["fused_synthesis"]["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(spec_bct, w_tconv, stride=hop), reps=10)
        results["fused_synthesis"]["cublas_ms"] = cuda_ms(time_frontend.cublas_synthesis(
            time_frontend.synthesis_spectrum(smag, sphs), w_syn, F32), reps=10)
        la = (out_frames - 1) * hop + ft
        reach = [max(0, min(t * hop + ft, la - ft) - max(t * hop, ft))
                 for t in range(out_frames)]  # each frame's samples in the trimmed output
        overlap = sum(reach)
        live = sum(n > 0 for n in reach)  # B and E need mag and phs of these frames only
        r = results["fused_synthesis"]
        b_flops = 2.0 * n_windows * 2 * half * overlap
        b_bytes = 4.0 * (2 * live * n_windows * half + 2 * half * ft + n_windows * out_len)
        r.update(zip(("bound_ms", "bound_by"), bound(b_flops, b_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(b_flops, b_bytes)[0]
        r["shape"] = f"mag {tuple(smag.shape)}, w {tuple(w_syn.shape)}"

        # C on the whole clip as one row, chunked: the serving path's gain
        # curve, the randn input of earlier runs, and the row that never meets,
        # each beside the row schedule; the statistics read after the timing
        r = results["switched_one_pole"]
        for case, key in (("serving_curve", ""), ("randn", "randn_"), ("step_to_silence", "worst_")):
            g, aa, ar = time_smoother.long_rows(case, dev)
            r[f"{key}ms"] = cuda_ms(lambda: cuda_kernels.smoother_chunked(g, aa, ar), reps=20)
            r[f"{key}rows_ms"] = cuda_ms(lambda: cuda_kernels.smoother_rows(g, aa, ar), reps=5,
                                         warmup=1)
            stats = cuda_kernels.smoother_chunked(g, aa, ar)[1].tolist()[0]
            r[f"{key}warmup"], r[f"{key}rerun_steps"] = stats
            print(f"C at g {tuple(g.shape)}, {case}: chunked {r[f'{key}ms']:.4f} ms, row schedule "
                  f"{r[f'{key}rows_ms']:.4f} ms; W {stats[0]}, L {cuda_kernels.CHUNK}, "
                  f"{math.ceil(g.shape[1] / cuda_kernels.CHUNK)} virtual rows, {stats[1]} steps re-run")
        check(r["worst_ms"] <= 1.2 * r["worst_rows_ms"],
              f"kernel C: the chunked schedule on a row that never meets takes {r['worst_ms']:.3f} ms, "
              f"over 1.2 x the row schedule's {r['worst_rows_ms']:.3f}")
        r["chunk"] = cuda_kernels.CHUNK
        r["virtual_rows"] = math.ceil(len(clip) / cuda_kernels.CHUNK)
        r["plain_ms"] = plain_c_ms
        r["library_ms"] = None
        r.update(zip(("bound_ms", "bound_by"), bound(4.0 * len(clip), 4.0 * (2 * len(clip) + 2))))
        # the chunked design's own floor: each virtual row's dependent chain of
        # W + L steps, at the SM clock the card reports while it is busy
        sm_mhz = sm_clock_mhz()
        r["sm_clock_mhz"] = sm_mhz
        r["chain_floor_ms"] = (r["warmup"] + r["chunk"]) * c_chain_cycles / (sm_mhz * 1e3)
        r["chain_cycles"] = c_chain_cycles
        # a virtual row's W + L steps in the call's time (phase 1, the verify walk, launches)
        r["cycles_per_step"] = r["ms"] * sm_mhz * 1e3 / (r["warmup"] + r["chunk"])
        r["shape"] = (f"g {(1, len(clip))} (go_wc on the whole clip, the serving gain curve; "
                      f"chunked schedule)")
        gb = torch.randn(ct_batch, chunk, generator=gen, device=dev)
        ab = torch.full((ct_batch,), 0.99, device=dev)
        rb = torch.full((ct_batch,), 0.95, device=dev)
        batch_ms = cuda_ms(lambda: cuda_kernels.switched_one_pole_batched(gb, ab, rb), reps=10)
        print(f"C at calc_ct's batch {tuple(gb.shape)}: {batch_ms:.4f} ms, "
              f"{batch_ms * sm_mhz * 1e3 / chunk:.2f} cycles a step at {sm_mhz:.0f} MHz (chain "
              f"floor {c_chain_cycles}), {cuda_kernels.rows_per_block(ct_batch, sms)} rows a block")

        def serve():
            pl.predict_long(clip, knobs_nn, model)

        serve_s = cuda_ms(serve, reps=3, warmup=1) / 1e3
        print(f"predict_long: {CLIP_SECONDS / serve_s:.1f} audio-seconds per second "
              f"({serve_s * 1e3:.1f} ms for the {CLIP_SECONDS} s clip, host-to-host)")

        # D and E at the training shapes (the inputs of their check)
        r = results["fused_analysis_bwd"]
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, tdphs, ft, hop),
            reps=5)
        x_in = (txp * 0.5)[:, None, :]
        dspec_bct = torch.randn(tb, 2 * half, frames, generator=gen, device=dev)
        r["library_ms"] = cuda_ms(  # the linear part only: dspec -> (dxp, dW) by cuDNN
            lambda: (torch.nn.grad.conv1d_input(x_in.shape, w_conv, dspec_bct, stride=hop),
                     torch.nn.grad.conv1d_weight(x_in, w_conv.shape, dspec_bct, stride=hop)),
            reps=5)
        # the gemm front-end's two backward products for the same linear part (cuBLAS)
        d_frames = txp.unfold(1, ft, hop).reshape(-1, ft)
        d_spec = torch.randn(tb * frames, 2 * half, generator=gen, device=dev)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_backward(d_frames, w_an, d_spec, F32), reps=5)
        d_flops = 3 * 2.0 * tb * frames * ft * 2 * half
        d_bytes = 4.0 * (2 * tb * tlp + 2 * ft * 2 * half + 2 * frames * tb * half)
        r.update(zip(("bound_ms", "bound_by"), bound(d_flops, d_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(d_flops, d_bytes)[0]
        r["shape"] = f"xp {tuple(txp.shape)}, w {tuple(w_an.shape)}, dmag/dphs {tuple(tdmag.shape)}"

        r = results["fused_synthesis_bwd"]
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_bwd_reference(tmag, tphs, w_syn, tdout, ft, hop),
            reps=5)
        dacc = torch.nn.functional.pad(tdout, (ft, ft))[:, None, :]
        spec_t = torch.randn(tb, 2 * half, out_frames, generator=gen, device=dev)
        r["library_ms"] = cuda_ms(  # the linear part only: dout -> (dspec, dW) by cuDNN
            lambda: (torch.nn.functional.conv1d(dacc, w_tconv, stride=hop),
                     torch.nn.grad.conv1d_weight(dacc, w_tconv.shape, spec_t, stride=hop)),
            reps=5)
        e_frames = dacc[:, 0].unfold(1, ft, hop).reshape(-1, ft)  # the padded dout's frames
        e_spec = time_frontend.synthesis_spectrum(tmag, tphs).reshape(-1, 2 * half)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_backward(e_spec, w_syn, e_frames, F32),
                                 reps=5)
        e_flops = 2 * 2.0 * tb * 2 * half * overlap  # the live frame samples only
        e_bytes = 4.0 * (2 * (live + out_frames) * tb * half + 2 * 2 * half * ft + tb * out_len)
        r.update(zip(("bound_ms", "bound_by"), bound(e_flops, e_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(e_flops, e_bytes)[0]
        r["shape"] = f"mag/phs {tuple(tmag.shape)}, w {tuple(w_syn.shape)}, dout {tuple(tdout.shape)}"

        # f32 A and B at both batches, D (with and without dxp) and E on both
        # schedules, in turns (wgmma, mma, mma, wgmma): the mean of each way,
        # its least and most, and one CUDA-graph replay of a call
        f32_ways = {
            ("A", "ms"): lambda sched: cuda_frontend.fused_analysis(xp, w_an, ft, hop,
                                                                    schedule=sched),
            ("A", "train_ms"): lambda sched: cuda_frontend.fused_analysis(txp, w_an, ft, hop,
                                                                          schedule=sched),
            ("D", "ms"): lambda sched: cuda_frontend.fused_analysis_bwd(
                txp, w_an, tdmag, tdphs, ft, hop, schedule=sched),
            ("D", "ms_without_dxp"): lambda sched: cuda_frontend.fused_analysis_bwd(
                txp, w_an, tdmag, tdphs, ft, hop, need_dxp=False, schedule=sched),
            ("B", "ms"): lambda sched: cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop,
                                                                     schedule=sched),
            ("B", "train_ms"): lambda sched: cuda_frontend.fused_synthesis(tmag, tphs, w_syn, ft,
                                                                           hop, schedule=sched),
            ("E", "ms"): lambda sched: cuda_frontend.fused_synthesis_bwd(
                tmag, tphs, w_syn, tdout, ft, hop, schedule=sched)}
        f32_results = {"A": "fused_analysis", "B": "fused_synthesis", "D": "fused_analysis_bwd",
                       "E": "fused_synthesis_bwd"}
        f32_turns = {(way, sched): [] for way in f32_ways for sched in cuda_frontend.SCHEDULES}
        for sched in ("wgmma", "mma", "mma", "wgmma"):
            for way, fn in f32_ways.items():
                f32_turns[way, sched].append(cuda_ms(lambda: fn(sched), reps=10))
        for (kernel, key), fn in f32_ways.items():
            r = results[f32_results[kernel]]
            for sched, into in (("wgmma", r), ("mma", r["mma_sync"])):
                runs = f32_turns[(kernel, key), sched]
                into[key] = sum(runs) / len(runs)
                into[f"{key}_min_max"] = [min(runs), max(runs)]
                graph_key = key.replace("ms", "graph_ms") if kernel == "D" else (
                    "graph_ms" if key == "ms" else "train_graph_ms")
                into[graph_key] = time_frontend.graph_ms(lambda: fn(sched))
        r = results["fused_analysis"]
        r["tflops"] = a_flops / r["ms"] / 1e9
        r["mma_sync"]["tflops"] = a_flops / r["mma_sync"]["ms"] / 1e9
        r = results["fused_analysis_bwd"]
        r["tflops"] = d_flops / r["ms"] / 1e9
        r["tflops_without_dxp"] = d_flops * 2 / 3 / r["ms_without_dxp"] / 1e9
        r["mma_sync"]["tflops"] = d_flops / r["mma_sync"]["ms"] / 1e9
        r["mma_sync"]["tflops_without_dxp"] = d_flops * 2 / 3 / r["mma_sync"]["ms_without_dxp"] / 1e9
        # without dxp: two products, and no dxp written
        r["bound_ms_without_dxp"] = bound(d_flops * 2 / 3, d_bytes - 4.0 * tb * tlp,
                                          PEAK_SPLIT_TF32_FLOPS)[0]
        r["cublas_dw_ms"] = cuda_ms(lambda: d_frames.t() @ d_spec, reps=5)  # the dW product alone
        for name, flops in (("fused_synthesis", b_flops), ("fused_synthesis_bwd", e_flops)):
            r = results[name]
            r["tflops"] = flops / r["ms"] / 1e9
            r["mma_sync"]["tflops"] = flops / r["mma_sync"]["ms"] / 1e9
        for kernel, name in f32_results.items():
            r = results[name]
            print(f"f32 {kernel} by schedule, in turns: " + "; ".join(
                f"{key} wgmma {r[key]:.4f} {r[key + '_min_max']}, mma.sync {r['mma_sync'][key]:.4f} "
                f"{r['mma_sync'][key + '_min_max']}" for k, key in f32_ways if k == kernel)
                  + f" on {smi}")

        # A, B, C once more at the training shapes
        r = results["fused_analysis"]
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(txp, w_an, ft, hop), reps=10)
        txp_c = txp[:, None, :]
        r["train_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(txp_c, w_conv, stride=hop), reps=10)
        r["train_cublas_ms"] = cuda_ms(time_frontend.cublas_analysis(txp, w_an, ft, hop, F32),
                                       reps=10)
        at_flops = 2.0 * tb * frames * ft * 2 * half
        at_bytes = 4.0 * (tb * tlp + ft * 2 * half + 2 * frames * tb * half)
        r["train_bound_ms"] = bound(at_flops, at_bytes, PEAK_SPLIT_TF32_FLOPS)[0]
        r["train_bound_ms_cuda_cores"] = bound(at_flops, at_bytes)[0]
        r["train_tflops"] = at_flops / r["train_ms"] / 1e9
        r["train_shape"] = f"xp {tuple(txp.shape)}"
        r = results["fused_synthesis"]
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(tmag, tphs, w_syn, ft, hop), reps=10)
        tspec_bct = torch.cat([tmag * torch.cos(tphs), tmag * torch.sin(tphs)], -1)
        tspec_bct = tspec_bct.permute(1, 2, 0).contiguous()  # (B, 2*half, OT)
        r["train_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(tspec_bct, w_tconv, stride=hop), reps=10)
        r["train_cublas_ms"] = cuda_ms(time_frontend.cublas_synthesis(
            time_frontend.synthesis_spectrum(tmag, tphs), w_syn, F32), reps=10)
        bt_flops = 2.0 * tb * 2 * half * overlap
        bt_bytes = 4.0 * (2 * live * tb * half + 2 * half * ft + tb * out_len)
        r["train_bound_ms"] = bound(bt_flops, bt_bytes, PEAK_SPLIT_TF32_FLOPS)[0]
        r["train_bound_ms_cuda_cores"] = bound(bt_flops, bt_bytes)[0]
        r["train_tflops"] = bt_flops / r["train_ms"] / 1e9
        r["mma_sync"]["train_tflops"] = bt_flops / r["mma_sync"]["train_ms"] / 1e9
        r["train_shape"] = f"mag {tuple(tmag.shape)}"
        r = results["switched_one_pole"]
        gt = torch.randn(tb, chunk, generator=gen, device=dev)
        at, rt = torch.full((tb,), 0.99, device=dev), torch.full((tb,), 0.95, device=dev)
        r["train_ms"] = cuda_ms(lambda: cuda_kernels.switched_one_pole_batched(gt, at, rt), reps=10)
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_kernels.switched_one_pole_reference(gt, at, rt), reps=1, warmup=0)
        r["train_bound_ms"] = bound(4.0 * gt.numel(), 4.0 * (2 * gt.numel() + 2 * tb))[0]
        r["train_chain_floor_ms"] = chunk * c_chain_cycles / (sm_mhz * 1e3)  # one thread a row
        r["train_cycles_per_step"] = r["train_ms"] * sm_mhz * 1e3 / chunk
        r["ct_batch_cycles_per_step"] = batch_ms * sm_mhz * 1e3 / chunk
        r["train_shape"] = f"g {tuple(gt.shape)} (go_batch in data synthesis; row schedule)"
        r["ct_batch_ms"] = batch_ms

        # L at the Compressor's training shape (its main path), the LowPass's
        # and the 30 s row, beside its bound and the floor of its chain
        from signaltrain_tpu_torch.cli import time_lfilter

        r = results["lfilter"]
        for case, key in (("comp", ""), ("lowpass", "lowpass_"), ("row_30s", "row_30s_")):
            x_l = time_lfilter.inputs(case, dev)[2]
            order = 3 if case == "lowpass" else 1
            r[f"{key}ms"] = time_lfilter.time_case(case, dev, reps=5 if case == "row_30s" else 20)
            r[f"{key}bound_ms"], r[f"{key}bound_by"] = time_lfilter.bound_ms(x_l, order)
            r[f"{key}chain_cycles"] = time_lfilter.chain_cycles(order)
            r[f"{key}chain_floor_ms"] = time_lfilter.chain_floor_ms(x_l.shape[1], order, sm_mhz)
            r[f"{key}cycles_per_step"] = r[f"{key}ms"] * sm_mhz * 1e3 / x_l.shape[1]
            r[f"{key}shape"] = f"x {tuple(x_l.shape)}, order {order}"
        r["library_ms"] = None
        r["sm_clock_mhz"] = sm_mhz

        # the bf16 modes at the training shapes (A and B also at the serving
        # batch), on the inputs of their checks; the bound at the dense bf16
        # rate; the library calls the same linear parts in bf16 (cuDNN)
        w_conv16, w_tconv16 = w_conv.to(BF16), w_tconv.to(BF16)
        bxp, sxp = bf16_ins["xp", TRAIN_BATCH], bf16_ins["xp", n_windows]
        bmag, bphs = bf16_ins["syn", TRAIN_BATCH]
        smag_b, sphs_b = bf16_ins["syn", n_windows]
        # bf16 A and B on both schedules at both batches, in turns (wgmma, mma,
        # mma, wgmma): the mean of each way, its least and most, and one
        # CUDA-graph replay of a call
        fwd = {
            ("A", ""): lambda sched: cuda_frontend.fused_analysis(bxp, w_an, ft, hop, BF16, sched),
            ("A", "serve_"): lambda sched: cuda_frontend.fused_analysis(sxp, w_an, ft, hop, BF16,
                                                                        sched),
            ("B", ""): lambda sched: cuda_frontend.fused_synthesis(bmag, bphs, w_syn, ft, hop, BF16,
                                                                   sched),
            ("B", "serve_"): lambda sched: cuda_frontend.fused_synthesis(smag_b, sphs_b, w_syn, ft,
                                                                         hop, BF16, sched)}
        fwd_turns = {(way, sched): [] for way in fwd for sched in cuda_frontend.SCHEDULES}
        for sched in ("wgmma", "mma", "mma", "wgmma"):
            for way, fn in fwd.items():
                fwd_turns[way, sched].append(cuda_ms(lambda: fn(sched), reps=20))
        fwd_graph = {(way, sched): time_frontend.graph_ms(lambda: fn(sched))
                     for way, fn in fwd.items() for sched in cuda_frontend.SCHEDULES}

        def fwd_times(r, kernel, flops, serve_flops):
            """A's or B's times on both schedules into its results: the wgmma
            schedule's at the top level, the mma.sync one's under mma_sync."""
            for sched, into in (("wgmma", r), ("mma", r["mma_sync"])):
                for pre, fl in (("", flops), ("serve_", serve_flops)):
                    runs = fwd_turns[(kernel, pre), sched]
                    into[f"{pre}ms"] = sum(runs) / len(runs)
                    into[f"{pre}ms_min_max"] = [min(runs), max(runs)]
                    into[f"{pre}graph_ms"] = fwd_graph[(kernel, pre), sched]
                    into[f"{pre}tflops"] = fl / into[f"{pre}ms"] / 1e9

        r = results["bf16_fused_analysis"]
        fwd_times(r, "A", at_flops, a_flops)
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(bxp, w_an, ft, hop, BF16), reps=10)
        bxp16 = bxp[:, None, :].to(BF16)
        r["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(bxp16, w_conv16, stride=hop), reps=10)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_analysis(bxp, w_an, ft, hop, BF16), reps=10)
        r.update(zip(("bound_ms", "bound_by"), bound(at_flops, at_bytes, PEAK_BF16_FLOPS)))
        r["shape"] = f"xp {tuple(bxp.shape)}, w {tuple(w_an.shape)}"
        r["serve_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(sxp, w_an, ft, hop, BF16), reps=10)
        sxp16 = sxp[:, None, :].to(BF16)
        r["serve_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(sxp16, w_conv16, stride=hop), reps=10)
        r["serve_cublas_ms"] = cuda_ms(time_frontend.cublas_analysis(sxp, w_an, ft, hop, BF16),
                                       reps=10)
        r["serve_bound_ms"] = bound(a_flops, a_bytes, PEAK_BF16_FLOPS)[0]
        r["serve_shape"] = f"xp {tuple(sxp.shape)}"

        r = results["bf16_fused_synthesis"]
        fwd_times(r, "B", bt_flops, b_flops)
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(bmag, bphs, w_syn, ft, hop, BF16), reps=10)
        bspec16 = torch.cat([bmag * torch.cos(bphs), bmag * torch.sin(bphs)], -1).permute(1, 2, 0)
        bspec16 = bspec16.contiguous().to(BF16)  # (B, 2*half, OT)
        r["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(bspec16, w_tconv16, stride=hop), reps=10)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_synthesis(
            time_frontend.synthesis_spectrum(bmag, bphs), w_syn, BF16), reps=10)
        r.update(zip(("bound_ms", "bound_by"), bound(bt_flops, bt_bytes, PEAK_BF16_FLOPS)))
        r["shape"] = f"mag {tuple(bmag.shape)}, w {tuple(w_syn.shape)}"
        r["serve_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(smag_b, sphs_b, w_syn, ft, hop, BF16),
            reps=10)
        sspec16 = torch.cat([smag_b * torch.cos(sphs_b), smag_b * torch.sin(sphs_b)], -1)
        sspec16 = sspec16.permute(1, 2, 0).contiguous().to(BF16)  # (B, 2*half, OT)
        r["serve_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(sspec16, w_tconv16, stride=hop), reps=10)
        r["serve_cublas_ms"] = cuda_ms(time_frontend.cublas_synthesis(
            time_frontend.synthesis_spectrum(smag_b, sphs_b), w_syn, BF16), reps=10)
        r["serve_bound_ms"] = bound(b_flops, b_bytes, PEAK_BF16_FLOPS)[0]
        r["serve_shape"] = f"mag {tuple(smag_b.shape)}"

        # bf16 D and E on both schedules, in turns (wgmma, mma, mma, wgmma):
        # the mean of each way, and its least and most
        r = results["bf16_fused_analysis_bwd"]
        dxp_in, ddmag, ddphs = bf16_ins["D"]
        edout = bf16_ins["E"]
        ways = {
            "ms": lambda sched: cuda_frontend.fused_analysis_bwd(
                dxp_in, w_an, ddmag, ddphs, ft, hop, compute_dtype=BF16, schedule=sched),
            "ms_without_dxp": lambda sched: cuda_frontend.fused_analysis_bwd(
                dxp_in, w_an, ddmag, ddphs, ft, hop, need_dxp=False, compute_dtype=BF16,
                schedule=sched),
            "e_ms": lambda sched: cuda_frontend.fused_synthesis_bwd(
                bmag, bphs, w_syn, edout, ft, hop, compute_dtype=BF16, schedule=sched)}
        turns = {(way, sched): [] for way in ways for sched in cuda_frontend.SCHEDULES}
        for sched in ("wgmma", "mma", "mma", "wgmma"):
            for way, fn in ways.items():
                turns[way, sched].append(cuda_ms(lambda: fn(sched), reps=10))
        sched_ms = {k: sum(v) / len(v) for k, v in turns.items()}
        # one CUDA-graph replay of a call: the card's time with no host work
        # between the passes, as the train graphs run them
        graph = {(way, sched): time_frontend.graph_ms(lambda: fn(sched))
                 for way, fn in ways.items() for sched in cuda_frontend.SCHEDULES}
        r["ms"], r["ms_without_dxp"] = sched_ms["ms", "wgmma"], sched_ms["ms_without_dxp", "wgmma"]
        r["ms_min_max"] = [min(turns["ms", "wgmma"]), max(turns["ms", "wgmma"])]
        r["ms_without_dxp_min_max"] = [min(turns["ms_without_dxp", "wgmma"]),
                                       max(turns["ms_without_dxp", "wgmma"])]
        r["graph_ms"], r["graph_ms_without_dxp"] = graph["ms", "wgmma"], graph["ms_without_dxp", "wgmma"]
        r["mma_sync"].update(
            graph_ms=graph["ms", "mma"], graph_ms_without_dxp=graph["ms_without_dxp", "mma"],
            ms=sched_ms["ms", "mma"], ms_without_dxp=sched_ms["ms_without_dxp", "mma"],
            ms_min_max=[min(turns["ms", "mma"]), max(turns["ms", "mma"])],
            ms_without_dxp_min_max=[min(turns["ms_without_dxp", "mma"]),
                                    max(turns["ms_without_dxp", "mma"])],
            tflops=d_flops / sched_ms["ms", "mma"] / 1e9,
            tflops_without_dxp=d_flops * 2 / 3 / sched_ms["ms_without_dxp", "mma"] / 1e9)
        r["plain_ms"] = cuda_ms(lambda: cuda_frontend.fused_analysis_bwd_reference(
            dxp_in, w_an, ddmag, ddphs, ft, hop, BF16), reps=5)
        x_in16, dspec16 = x_in.to(BF16), dspec_bct.to(BF16)
        r["library_ms"] = cuda_ms(
            lambda: (torch.nn.grad.conv1d_input(x_in16.shape, w_conv16, dspec16, stride=hop),
                     torch.nn.grad.conv1d_weight(x_in16, w_conv16.shape, dspec16, stride=hop)),
            reps=5)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_backward(
            dxp_in.unfold(1, ft, hop).reshape(-1, ft), w_an, d_spec, BF16), reps=5)
        r.update(zip(("bound_ms", "bound_by"), bound(d_flops, d_bytes, PEAK_BF16_FLOPS)))
        # without dxp: two products, and no dxp written
        r["bound_ms_without_dxp"] = bound(d_flops * 2 / 3, d_bytes - 4.0 * tb * tlp,
                                          PEAK_BF16_FLOPS)[0]
        r["tflops"] = d_flops / r["ms"] / 1e9
        r["tflops_without_dxp"] = d_flops * 2 / 3 / r["ms_without_dxp"] / 1e9
        r["shape"] = f"xp {tuple(dxp_in.shape)}, w {tuple(w_an.shape)}, dmag/dphs {tuple(ddmag.shape)}"

        r = results["bf16_fused_synthesis_bwd"]
        r["ms"] = sched_ms["e_ms", "wgmma"]
        r["ms_min_max"] = [min(turns["e_ms", "wgmma"]), max(turns["e_ms", "wgmma"])]
        r["graph_ms"] = graph["e_ms", "wgmma"]
        r["mma_sync"].update(ms=sched_ms["e_ms", "mma"], graph_ms=graph["e_ms", "mma"],
                             ms_min_max=[min(turns["e_ms", "mma"]), max(turns["e_ms", "mma"])],
                             tflops=e_flops / sched_ms["e_ms", "mma"] / 1e9)
        r["plain_ms"] = cuda_ms(lambda: cuda_frontend.fused_synthesis_bwd_reference(
            bmag, bphs, w_syn, edout, ft, hop, BF16), reps=5)
        dacc16 = torch.nn.functional.pad(edout, (ft, ft))[:, None, :].to(BF16)
        spec_t16 = spec_t.to(BF16)
        r["library_ms"] = cuda_ms(
            lambda: (torch.nn.functional.conv1d(dacc16, w_tconv16, stride=hop),
                     torch.nn.grad.conv1d_weight(dacc16, w_tconv16.shape, spec_t16, stride=hop)),
            reps=5)
        r["cublas_ms"] = cuda_ms(time_frontend.cublas_backward(
            time_frontend.synthesis_spectrum(bmag, bphs).reshape(-1, 2 * half), w_syn,
            torch.nn.functional.pad(edout, (ft, ft)).unfold(1, ft, hop).reshape(-1, ft), BF16),
            reps=5)
        r.update(zip(("bound_ms", "bound_by"), bound(e_flops, e_bytes, PEAK_BF16_FLOPS)))
        r["tflops"] = e_flops / r["ms"] / 1e9
        r["shape"] = f"mag/phs {tuple(bmag.shape)}, w {tuple(w_syn.shape)}, dout {tuple(edout.shape)}"
    torch.cuda.synchronize()

    # the train step (forward, loss, backward, clip, Adam) on one fixed batch,
    # the two front-ends in turns, and the data synthesis alone; host clock,
    # the card drained before and after
    training = {"batch": TRAIN_BATCH, "steps": steps, "train_path_s": t_path,
                "val_mae_mean": mean_maes, "loss_first": hist["train_loss"][0],
                "loss_last": hist["train_loss"][-1], "train_path_s_bf16": t_path_b,
                "val_mae_mean_bf16": mean_maes_b, "loss_first_bf16": hist_b["train_loss"][0],
                "loss_last_bf16": hist_b["train_loss"][-1], "step_checks": step_checks}
    models = {"fused": served, "gemm": gemm, "fused_bf16": served_b, "gemm_bf16": gemm_b}
    opts = {name: train_mod.make_optimizer(m, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS, TRAIN_BATCH)
            for name, m in models.items()}
    step_ms = {name: [] for name in models}
    for name in ("fused", "gemm", "fused_bf16", "gemm_bf16", "gemm_bf16", "fused_bf16", "gemm",
                 "fused"):
        m, (opt, lr_fn) = models[name], opts[name]
        step_ms[name].append(host_ms(
            lambda: train_mod.train_step_from_arrays(m, opt, lr_fn, 0, bx, by, bk), reps=20))
    for name, runs in step_ms.items():
        training[f"step_ms_{name}"] = sum(runs) / len(runs)
        training[f"step_ms_{name}_min_max"] = [min(runs), max(runs)]
        training[f"examples_per_s_{name}"] = TRAIN_BATCH / training[f"step_ms_{name}"] * 1e3
    with torch.no_grad():
        training["forward_ms_fused"] = host_ms(lambda: served(bx, bk), reps=20)
    training["forward_backward_ms_fused"] = host_ms(
        lambda: train_mod.loss_and_grads(served, bx, by, bk), reps=20)
    training["data_ms"] = host_ms(
        lambda: batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, TRAIN_SEED, 0)), reps=20)
    # the card's own share of each: host time that is not card time is launch work
    training["profile"] = {
        "data": card_busy(
            lambda: batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, TRAIN_SEED, 0)),
            reps=10)}
    for name, m in models.items():
        mopt, mlr_fn = opts[name]
        training["profile"][f"step_{name}"] = card_busy(
            lambda: train_mod.train_step_from_arrays(m, mopt, mlr_fn, 0, bx, by, bk), reps=10)
    # the f32 step's A, B, D and E on the wgmma schedule's split-TF32
    # products (A's FrameSpectrum32, B's SynthesisFrames on RowProduct32, D's
    # AnalysisDspecW32 and FrameGrad32, E's SynthesisDspecW32 and its
    # SynthesisDw on FrameGrad32), with no K-slice pass (sum_analysis_partials,
    # synthesis_adjoint, sum_synthesis_partials) anywhere
    names = card_kernel_names(lambda: train_mod.train_step_from_arrays(
        served, *opts["fused"], 0, bx, by, bk))
    marks = (("AnalysisFwdT", "FrameSpectrum32"), ("SynthesisFrames", "RowProduct32"),
             ("AnalysisDspecW32",), ("AnalysisDw", "FrameGrad32"), ("SynthesisDspecW32",),
             ("SynthesisDw", "FrameGrad32"))
    k_slice_passes = ("sum_analysis_partials", "synthesis_adjoint", "sum_synthesis_partials")
    front = sorted(n for n in names if any(m[-1] in n for m in marks)
                   or any(k in n for k in k_slice_passes))
    print("f32 train step, the front-end products on the card: " + "; ".join(front))
    for m in marks:
        check(any(all(part in n for part in m) for n in names),
              f"the f32 train step did not run the split-TF32 wgmma product {' on '.join(m)}")
    for k in k_slice_passes:
        check(not any(k in n for n in names), f"the f32 train step ran {k}: a product took K slices")
    training["f32_step_frontend_kernels"] = front

    # the loop as train() runs it (data synthesis and step, LOOP_BLOCK steps,
    # then one fetch of their losses), fused, in each dtype: under CUDA graphs
    # and dispatched op by op, and under graphs with a fetch after every step
    # (train() with a status cadence that does not divide the epoch), in
    # turns, from fresh seeded weights. The graph's first 20 steps, one replay a call,
    # check the data stream: the batches of steps 0, 1 and 19 equal to
    # batch_fn run eagerly on step_generator.
    loops = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", BF16)):
        gm, gopt, lr_fn = fresh(dtype)
        em, eopt, _ = fresh(dtype)
        graph = graphs.TrainGraph(gm, gopt, lr_fn, batch_fn, TRAIN_BATCH,
                                  torch.Generator(device=dev), TRAIN_SEED, capacity=LOOP_BLOCK)
        eg = torch.Generator(device=dev)
        for step in range(20):
            graph(step, 1)
            if step in (0, 1, 19):
                want = batch_fn(TRAIN_BATCH, synth_data.step_generator(eg, TRAIN_SEED, step))
                check(all(torch.equal(a, b) for a, b in zip(graph.batch, want)),
                      f"{tag}: the batch of step {step} under the graph differs from batch_fn's")
        ways = {"graph": lambda: graph(20, LOOP_BLOCK).cpu(),
                "graph_fetch_each_step": lambda: [graph(s, 1).cpu() for s in range(20, 20 + LOOP_BLOCK)],
                "eager": lambda: train_mod.eager_steps(em, eopt, lr_fn, batch_fn, TRAIN_BATCH, eg,
                                                       TRAIN_SEED, 20, LOOP_BLOCK).cpu()}
        runs = {way: [] for way in ways}
        for way in ("graph", "graph_fetch_each_step", "eager", "eager", "graph_fetch_each_step",
                    "graph"):
            runs[way].append(host_ms(ways[way], reps=3, warmup=1) / LOOP_BLOCK)
        for way, fn in ways.items():
            ms = sum(runs[way]) / len(runs[way])
            prof = card_busy(fn, reps=1)
            loops[f"{tag}_{way}"] = {
                "loop_ms": ms, "loop_ms_min_max": [min(runs[way]), max(runs[way])],
                "examples_per_s": TRAIN_BATCH / ms * 1e3,
                "card_busy_ms": prof["card_busy_ms"] / LOOP_BLOCK,
                "kernels_on_card": prof["kernels_launched"] / LOOP_BLOCK,
                "host_launch_calls": prof["host_launch_calls"] / LOOP_BLOCK}
        loops[f"{tag}_graph"]["capture_s"] = graph.graph.capture_s
        loops[f"{tag}_graph"]["counted_per_replay"] = graph.graph.counts
        gm.eval()
        evals = graphs.EvalGraph(gm, val_batch_fn, TRAIN_BATCH, torch.Generator(device=dev),
                                 val_steps)
        evals()
        gm.train()
        loops[f"{tag}_graph"]["eval_capture_s"] = evals.graph.capture_s
        loops[f"{tag}_graph"]["eval_counted_per_replay"] = evals.graph.counts
    training["loop"] = loops
    print(f"train step at batch {TRAIN_BATCH}, host clock, mean [least, most] of two turns: fused "
          f"{training['step_ms_fused']:.3f} {training['step_ms_fused_min_max']} ms "
          f"({training['examples_per_s_fused']:.0f} examples/s), gemm {training['step_ms_gemm']:.3f} "
          f"{training['step_ms_gemm_min_max']} ms "
          f"({training['examples_per_s_gemm']:.0f} examples/s); fused forward "
          f"{training['forward_ms_fused']:.3f} ms, forward+backward "
          f"{training['forward_backward_ms_fused']:.3f} ms; data synthesis {training['data_ms']:.3f} ms "
          f"on {smi}")
    print(f"bf16 train step at batch {TRAIN_BATCH}: fused {training['step_ms_fused_bf16']:.3f} "
          f"{training['step_ms_fused_bf16_min_max']} ms, gemm {training['step_ms_gemm_bf16']:.3f} "
          f"{training['step_ms_gemm_bf16_min_max']} ms; card busy per call: " + ", ".join(
              f"{k} {v['card_busy_ms']:.3f} ms ({v['kernels_launched']:.0f} kernels)"
              for k, v in training["profile"].items()))
    for key, v in loops.items():
        print(f"loop {key} (data + step, {LOOP_BLOCK} steps a block): {v['loop_ms']:.3f} ms a step "
              f"[{v['loop_ms_min_max'][0]:.3f}, {v['loop_ms_min_max'][1]:.3f}], "
              f"{v['examples_per_s']:.0f} examples/s; card busy {v['card_busy_ms']:.3f} ms, "
              f"{v['kernels_on_card']:.1f} kernels on the card and {v['host_launch_calls']:.1f} "
              f"launch calls from the host a step"
              + (f"; capture {v['capture_s']:.3f} s, the eval graph's {v['eval_capture_s']:.3f} s"
                 if "capture_s" in v else "") + f" on {smi}")
    print(json.dumps({"training": training}))

    sources = {
        "fused_analysis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                           "signaltrain_tpu/ops/pallas_frontend.py:286"),
        "fused_synthesis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                            "signaltrain_tpu/ops/pallas_frontend.py:458"),
        "switched_one_pole": ("signaltrain_tpu_torch/csrc/smoother.cu",
                              "signaltrain_tpu/ops/pallas_kernels.py:174"),
        "fused_analysis_bwd": ("signaltrain_tpu_torch/csrc/frontend_bwd.cu",
                               "signaltrain_tpu/ops/pallas_frontend.py:326"),
        "fused_synthesis_bwd": ("signaltrain_tpu_torch/csrc/frontend_bwd.cu",
                                "signaltrain_tpu/ops/pallas_frontend.py:499"),
        # no pallas_call: the JAX package's lfilter is a lax.scan
        "lfilter": ("signaltrain_tpu_torch/csrc/iir.cu", "signaltrain_tpu/dsp/iir.py:102"),
    }
    for name in f32_names:  # the bf16 modes: the same sources and TPU kernels
        sources["bf16_" + name] = sources[name]
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{k: r[k] for k in (
                "launches_serving", "launches_training_float32", "launches_training_bfloat16",
                "launches_effects", "launches_denoise", "elements_differing", "lowpass_ms",
                "lowpass_bound_ms", "lowpass_chain_floor_ms", "lowpass_shape", "lowpass_plain_ms",
                "chain_cycles", "lowpass_chain_cycles",
                "row_30s_ms", "row_30s_bound_ms", "row_30s_chain_floor_ms", "row_30s_shape",
                "row_30s_plain_ms",
                "max_phase_err", "f32_kernel_gap", "serve_ms", "serve_plain_ms",
                "serve_library_ms", "serve_bound_ms", "serve_shape",
                "max_small_bin_phase_err", "max_err_vs_float64", "plain_max_err_vs_float64",
                "max_dx_err", "max_regular_err", "ms_without_dxp", "bound_ms_cuda_cores", "tflops",
                "tflops_without_dxp", "sm_clock_mhz", "chain_floor_ms", "rows_ms", "randn_ms",
                "randn_rows_ms", "worst_ms", "worst_rows_ms", "warmup", "rerun_steps",
                "randn_warmup", "randn_rerun_steps", "worst_warmup", "worst_rerun_steps", "chunk",
                "virtual_rows", "plain_s_all_checks", "ct_batch_ms", "train_ms",
                "train_plain_ms", "train_library_ms", "train_bound_ms", "train_chain_floor_ms",
                "train_bound_ms_cuda_cores", "train_tflops", "train_shape", "gen_ms",
                "gen_plain_ms", "gen_bound_ms", "gen_bound_by", "gen_chain_floor_ms", "gen_shape",
                "gen_max_abs_err", "gen_tolerance", "launches_gen_dataset", "cycles_per_step",
                "lowpass_cycles_per_step", "row_30s_cycles_per_step", "train_cycles_per_step",
                "ct_batch_cycles_per_step", "gen_cycles_per_step", "gen_chain_cycles", "launches_file_training",
                "launches_file_serving", "launches_surface", "launches_lr_finder", "launches_tools",
                "launches_parallel", "launches_microbatch", "cublas_ms", "train_cublas_ms",
                "serve_cublas_ms", "schedule", "mma_sync", "ms_min_max", "ms_without_dxp_min_max",
                "serve_ms_min_max", "serve_graph_ms", "serve_tflops",
                "bound_ms_without_dxp", "max_err_less_slack", "max_dx_err_less_slack", "graph_ms",
                "graph_ms_without_dxp",
                "max_abs_err_at_serving_batch", "launches_mma_sync_training_bfloat16",
                "launches_mma_sync_training_float32", "control_one_tf32_product", "max_dx_share",
                "max_dw_share", "train_graph_ms", "train_ms_min_max", "cublas_dw_ms")
               if k in r},
        })
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        if "cublas_ms" in r:
            lib += f", the gemm front-end's cuBLAS products {r['cublas_ms']:.4f} ms"
        extra = ""
        if "bound_ms_cuda_cores" in r:
            extra = (f"; {r['tflops']:.1f} TFLOP/s of f32-accurate work, bound at the CUDA cores' "
                     f"67 TFLOP/s {r['bound_ms_cuda_cores']:.4f} ms")
        elif "tflops" in r:
            extra = f"; {r['tflops']:.1f} TFLOP/s of bf16 products (bound at 989 TFLOP/s dense)"
        if "serve_ms" in r:
            extra += (f"; at the serving shape {r['serve_shape']}: {r['serve_ms']:.4f} ms (bound "
                      f"{r['serve_bound_ms']:.4f} ms, plain {r['serve_plain_ms']:.4f} ms, library "
                      f"{r['serve_library_ms']:.4f} ms, cuBLAS {r['serve_cublas_ms']:.4f} ms)")
        if name == "lfilter":
            extra = (f"; at {r['shape']} {r['cycles_per_step']:.2f} cycles a step, its chain "
                     f"floor ({r['chain_cycles']:.2f} cycles a step at "
                     f"{r['sm_clock_mhz']:.0f} MHz) {r['chain_floor_ms']:.4f} ms; LowPass "
                     f"{r['lowpass_shape']}: {r['lowpass_ms']:.4f} ms, "
                     f"{r['lowpass_cycles_per_step']:.2f} cycles a step (bound "
                     f"{r['lowpass_bound_ms']:.4f}, chain floor {r['lowpass_chain_floor_ms']:.4f} at "
                     f"{r['lowpass_chain_cycles']:.2f} cycles a step, "
                     f"plain {r['lowpass_plain_ms']:.1f}); one row {r['row_30s_shape']}: "
                     f"{r['row_30s_ms']:.4f} ms, {r['row_30s_cycles_per_step']:.2f} cycles a step "
                     f"(bound {r['row_30s_bound_ms']:.4f}, chain floor "
                     f"{r['row_30s_chain_floor_ms']:.4f}, plain {r['row_30s_plain_ms']:.1f})")
        elif "chain_floor_ms" in r:
            extra = (f"; {r['cycles_per_step']:.2f} cycles a step of a virtual row's W + L; the "
                     f"chunked design's chain floor (W {r['warmup']} + L {r['chunk']}) x "
                     f"{c_chain_cycles} cycles at {r['sm_clock_mhz']:.0f} MHz {r['chain_floor_ms']:.4f} "
                     f"ms; row schedule {r['rows_ms']:.4f} ms; randn input {r['randn_ms']:.4f} ms "
                     f"(row schedule {r['randn_rows_ms']:.4f}); never meeting {r['worst_ms']:.4f} "
                     f"ms (row schedule {r['worst_rows_ms']:.4f}); {r['rerun_steps']} steps re-run")
        if "mma_sync" in r:
            m = r["mma_sync"]
            extra += (f"; schedule {r['schedule']}, one graph replay {r['graph_ms']:.4f} ms" + (
                f"; without dxp {r['ms_without_dxp']:.4f} ms, replay "
                f"{r['graph_ms_without_dxp']:.4f} (bound {r['bound_ms_without_dxp']:.4f})"
                if "ms_without_dxp" in r else "") + f"; the mma.sync schedule {m['ms']:.4f} ms, "
                f"replay {m['graph_ms']:.4f}"
                + (f", without dxp {m['ms_without_dxp']:.4f} ms, replay "
                   f"{m['graph_ms_without_dxp']:.4f}" if "ms_without_dxp" in m else "")
                + f", {m['tflops']:.1f} TFLOP/s"
                + (f"; at the serving shape replay {r['serve_graph_ms']:.4f} ms, the mma.sync "
                   f"schedule {m['serve_ms']:.4f} ms, replay {m['serve_graph_ms']:.4f}"
                   if "serve_graph_ms" in r else ""))
        print(f"{name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}{extra}) on {smi}")
        if "train_ms" in r:
            tlib = f"{r['train_library_ms']:.4f} ms" if "train_library_ms" in r else "n/a"
            if "train_cublas_ms" in r:
                tlib += f", cuBLAS {r['train_cublas_ms']:.4f} ms"
            ttf = f", {r['train_tflops']:.1f} TFLOP/s" if "train_tflops" in r else ""
            tcy = (f", {r['train_cycles_per_step']:.2f} cycles a step against a chain floor of "
                   f"{r['chain_cycles']:.2f} ({r['train_chain_floor_ms']:.4f} ms); calc_ct's batch "
                   f"{r['ct_batch_ms']:.4f} ms, {r['ct_batch_cycles_per_step']:.2f} cycles a step"
                   if "train_cycles_per_step" in r else "")
            print(f"  at the training shape {r['train_shape']}: {r['train_ms']:.4f} ms (bound "
                  f"{r['train_bound_ms']:.4f} ms, plain {r['train_plain_ms']:.4f} ms, library "
                  f"{tlib}{ttf}{tcy})")
    print(f"chip_smoke: {time.perf_counter() - t_main:.2f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
