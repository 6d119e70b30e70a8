#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # what CI runs: build, check, serve, train
    python3 chip_smoke.py --profile  # also trace one served batch and one train step of each model
    python3 chip_smoke.py --only 27  # phases 1, 2 and 27 alone (also --only 3c)

Phases, each printed as it runs; any failure exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: every CUDA source under efficient_rpe_vit_torch/csrc, with nvcc,
     all at once;
  3. KERPLE kernels (forward; 3b: backward dq, dkv, dc, dc_reduce) against
     their plain PyTorch versions on the card at the serving and training
     shapes and at ragged shapes, in bf16 and fp32 (both also in bf16 at the
     edges of the forward's, dq, dkv and dc kernels' tiles and at batches of
     1 and 3), timed (calls replayed from a CUDA graph, so without the
     wrapper's host work) beside their bounds; each logs its kernels'
     launch_info (the bf16 forward, dq, dkv and dc kernels must be the
     mma.sync ones at F=266, the fp32 forward, dq and dc the staged ones)
     and calls the forward, dq and dc twice at every shape (out and den,
     dq', windows and dcoeffs bit for bit);
  3c. flash kernels (softmax forward; backward fused, dq, dkv) against their
     plain versions in bf16 and fp32 at the serving, training and ragged
     shapes, with [B,1,N,N] and [B,H,N,N] masks and with dropout (whose
     keep-mask must equal dropout_keep_dense bit for bit), the backward
     fused and two-pass where the fused kernel fits, by its own choice
     (two-pass) at D=128 and at N=4097; in bf16 also at the edges of the
     fused mma.sync kernel's tiles, checking through launch_info which fused
     kernel runs;
     timed beside their bounds and beside scaled_dot_product_attention;
  3d. rotation kernels (Circulant-STRING forward and backward) against
     their plain versions in bf16 and fp32, keep_cls off and on, at the
     serving, training, long-N and the JAX tests' shapes, at D=80 and
     D=128, and at the edges of the bf16 mma.sync kernels' 128-row tiles
     (N = 15, 127, 129, 1000) and head dims (16, 32, 48); CLS rows bit for
     bit, bitwise backward reruns, the head split's strided views, and a
     bf16 view with rows of 68 elements (the staged kernels); each shape's
     launch_info logged and checked (bf16 at D a multiple of 16 up to 64 on
     the mma.sync kernels, no spills at the main paths' shapes; the rest
     staged); timed beside their bounds, the plain DFT chain arm and the
     torch.fft route (rfft, complex product, irfft: three calls);
  3e. the fused-phi KERPLE forward (phi+ and phi_relu computed in the
     kernel from raw q, k and Omega) against its plain version in bf16 and
     fp32 at the serving, training, ragged and the JAX tests' shapes, and in
     bf16 at the edges of its mma.sync kernel's tiles and at batches of 1
     and 3; out and den bitwise on a rerun at every shape; its launch_info
     logged and checked (bf16 on the mma.sync kernel with no spills, fp32 on
     the staged one); timed beside its bound and the unfused route it
     replaces (two phi_positive calls and the KERPLE forward kernel);
  3f. the materialised-T KERPLE kernels (forward; backward dq, dkv, dT),
     each first logging its launch_info (bf16 at the pallas_ab shapes and
     N=4097 on the mma.sync kernels, fp32 on the staged ones; dT's batch
     groups, the wrapper's mirror of them equal to the library's), against
     their plain versions in bf16 and fp32 at the pallas_ab entry point's
     three shapes, the ViT-B/16 training shape, a ragged shape and the JAX
     tests' shape, and at N=4097 in bf16; over a T that is not Toeplitz at
     a pallas_ab shape and a ragged one (both dtypes), at N=4097, at the
     mma.sync kernels' tile edges (N = 31, 33, 63, 64, 65, 127, 128, 129),
     batches of 1 and 3 and a batch dT's groups do not divide (bf16); the
     backward bitwise on a rerun; at the training shape the same function
     as the coefficient kernels (T = toeplitz_from_coeffs(c); dT's diagonal
     sums = dcoeffs); timed beside their bounds, the coefficient route and
     the residual backward in PyTorch;
  4. serve KERPLE: ViT-B/16 performer_favor_most_general (bf16, random
     weights from a seed) answers 4 requests of 32 images through
     `make_eval_step`; launch counts, logits against the same model on the
     plain (dense) KERPLE path (top-1 agreement arbitrated in fp32, as in
     phases 9 and 13), bitwise run to run, ms per batch;
  5. train KERPLE: the same model takes 5 steps of batch 64 through
     `create_train_state` / `make_train_step`; launch counts per step,
     finite gradients for every parameter, step-1 gradients against the
     dense KERPLE path and bitwise across two runs, finite losses beside the
     dense path's, and ms per step for both;
  6. serve baseline: ViT-B/16 `baseline` (softmax attention) as phase 4 on
     the flash forward (48 launches), against the dense softmax arm;
  7. train baseline at N=197: as phase 5 at batch 64; per step 12 flash_fwd
     and 12 flash_bwd_fused launches and no two-pass launch;
  8. long-N train: `baseline` on 1024x1024 images (N=4097), batch 4,
     attention and output dropout 0.1: step 1 twice (bitwise gradients), one
     warm-up step, two timed; per step 12 flash_fwd, 12 flash_bwd_dq and 12
     flash_bwd_dkv launches and no fused launch; finite gradients and
     losses, ms per step and peak memory (no dense arm: it would hold 12
     blocks of [4, 12, 4097, 4097] fp32; phase 3c checks this shape at the
     op level).
  9. serve `baseline_circulant` as phase 6 with the rotation on its kernels
     (`rpe_config={"method": "pallas"}`, against the dense softmax and the
     DFT chain): 96 rotation and 48 flash forward launches;
 10. train `baseline_circulant` as phase 7: per step 24 rotation forward, 24
     rotation backward, 12 flash_fwd and 12 flash_bwd_fused launches;
 11. long-N train `baseline_circulant` as phase 8: per step 24 rotation
     forward and backward launches beside the flash two-pass launches;
 12. every other rotation and hyperbolic-feature variant (RoPE, RoPE2D,
     FAVOR+/ReLU circulant, block-circulant, favor_hyper*) and ReLU KERPLE
     with fused phi at ViT-B width, depth 2: one served batch of 32 on the
     kernel arms against the dense/chain arms and one train step with
     finite gradients; before them every KERPLE kernel at favor_hyper's
     F = 532 ([2, 12, 197, 532], both dtypes) against its plain version
     (the forward, dq, dkv and dc on their staged kernels, checked through
     launch_info);
 13. serve fused phi: ViT-B/16 performer_favor_most_general with
     attention_config={"fused_phi": True} as phase 4 (12 fused-phi launches
     and no KERPLE forward launch per forward), logits against the unfused
     kernel arm and the dense arm, ms per batch of all three;
 14. train fused phi: the same model as phase 5 (per step 12 fused-phi
     launches and 12 of each backward kernel), step-1 gradients against
     the unfused kernel arm and bitwise across two runs, ms per step of
     both arms;
 15. the port's pallas_ab entry point at its three shapes: every row's
     time and output finite, the forward kernel launched in every *_pallas*
     row and no other, dq and dkv in the grad_pallas_fused rows only, dT
     only where T needs a gradient; the rows in ms;
 16. long-N KERPLE: the coefficient kernels at N=4097 against their plain
     versions, timed; the fft arm against them (forward at [4, 12, 4097],
     forward and gradients at [2, 12, 1025]); ViT-B/16
     performer_favor_most_general on 1024x1024 images, batch 4, dropout 0,
     trained as phase 8 (12 launches of the forward and of each backward
     kernel per step, bitwise step-1 gradients, ms per step, peak memory)
     and serving one batch on the kernels against the fft arm.
 17. K steps per CUDA-graph replay (`make_multi_step`): #1 and #2 at the
     JAX bench_headline row's shape (256, 2, 197, 44, 16) against their plain
     versions, timed; dropout masks drawn in a replayed graph equal the eager
     draws from the same generator, and a second replay draws new ones (feature
     redraw inside a graph: phase 23 e); the card's
     capturable adam, adamw and sgd against the CPU's optax-equal path
     (6 updates, warmup-cosine, weight decay); the headline model
     (mnist_config at patch 2, batch 256, bf16, dropout 0.1, depth 3) at
     K=25: the first call's 25 eager warm-up steps and the capture, their
     launches read apart (the counts zeroed between them; 25 x 3 of #1 and
     of each backward kernel in each, the capture's on the kernels line), then
     two replays, each bitwise against 25 eager make_train_step steps of a
     twin model (losses, corrects, parameters, Adam moments, generators), ms
     per step replayed and eager; ViT-B widths (N=197, batch 64) at K=5, one
     replay against 5 eager steps; the headline model under sgd (momentum,
     its capturable update: a device lr, foreach ops) at K=5, one replay
     against 5 eager steps, bitwise, momentum traces included;
 18. the engine: a synthetic MNIST-shaped uint8 DeviceDataset on the card
     (flagged synthetic), one epoch of the headline model at dropout 0
     through train_epoch per batch, with make_multi_step (K=4) and
     gather-fused (K=4): equal metrics and bitwise equal parameters;
     evaluate per batch against gather-fused (K=3, a tail chunk);
 19. the entry points on the card, in process, in a temporary directory:
     a. `experiments.train.main` trains performer_favor_most_general at the
        JAX mnist_config widths (dim 32, depth 3, 2 heads, patch 7: N=17,
        F=44, D=16) on the flagged synthetic MNIST, bf16, 2 epochs of K=4
        steps per replay, keeping the best checkpoint: #1 and #2 (dq, dkv,
        dc) launched by the run, the metrics JSON with every key of the JAX
        CLI's schema and finite values, epoch seconds and inference
        images/s; #1 and #2 checked against their plain versions at the
        run's shape and timed;
     b. `experiments.predict.main` from that checkpoint: the test accuracy
        of the checkpointed epoch exactly, its loss within 1e-6 relative;
     c. `--resume auto --epochs 3` starts after the checkpointed epoch (the
        best; a tie keeps the earlier) and writes a row per epoch to 3;
     d. ViT-B/16 performer_favor_most_general with the soft-MoE MLP (4
        experts), bf16, batch 64, Adam, dropout 0.1: one train step with
        remat and one without from the same weights and generator state,
        every gradient within 1e-6 relative (bitwise equality logged), #1
        launched 24 times per step with remat and 12 without, peak memory
        of each (lower with remat) and ms per step (5 after 3).
 20. the benchmark runner (`experiments.benchmark.main`) in process in a
     temporary directory, performer_favor_most_general and baseline at the
     mnist_config widths in bf16 (N=17, D=16; dropout 0.1), seeds 42 and
     153, 2 epochs of K=4 steps per replay:
     a. sequential, each model's seeds sharing one `shared` dict: #1, #2,
        #6 and 7a launched, every run's metrics with the JAX CLI's keys and
        finite values, seed 153's per-epoch metrics bitwise equal to a
        train CLI run of seed 153 alone (train seconds with and without
        `shared` logged); `--skip-existing` again launches no kernel;
     b. `--ensemble`: each member's per-epoch metrics bitwise equal to the
        sequential run of its seed, the two members different, epoch
        seconds of the ensemble and of the two sequential runs; then one
        chunk (K=4 x 32) of a 2-member make_ensemble_gather_multi_step and
        of one model's make_gather_multi_step: the launches each graph
        holds (counted at capture) 2x the single model's, replays timed;
     c. #6 and 7a against their plain versions at (32, 2, 17, 16), bf16,
        dropout 0.1, their launch_info logged, timed beside their bounds
        and SDPA.
 21. serving artifacts (`efficient_rpe_vit_torch.serve`), in a temporary
     directory; each artifact is saved, loaded with `load_exported` and
     served from counts of 0, its logits bitwise equal to the live model's:
     a. ViT-B/16 performer_favor_most_general (phase 4's model and
        weights, bf16) exported on the card: #1 (launch_info: the mma.sync
        kernel) launched 12 times per forward at batches 1, 32 and 256,
        nothing else; artifact and live model timed at 32;
     b. `baseline`, the fused-phi flagship and `baseline_circulant` at the
        mnist_config widths (N=17, D=16, bf16), exported on the card, batch
        32: #6 (3 per forward), #3 (3) and #8 (6, beside 3 of #6);
     c. the flagship at those widths exported on the CPU and moved to the
        card: #1 (3 per forward) against a live model on the card;
     d./e. `experiments.serve_bench.main --vitb --quick` (ViT-B baseline,
        10 synthetic fit steps, batches 1 / 32 / 256): its rows logged, the
        bf16 and int8 artifacts smaller than 0.75x and 0.6x the fp32 one,
        their top-1 agreement and logit MAE against the fp32 artifact on 64
        probes logged; then #6, #3 and #8 against their plain versions at
        the mnist-width artifacts' shape, timed beside their bounds.
 22. parallelism (`efficient_rpe_vit_torch.parallel`), the flagship of
     phase 4 at batch 64, dropout 0, weights from seed 0:
     a. one rank on NCCL (a FileStore in a temporary directory): the
        parallel step on data=1, data=1 with FSDP and model=1, each held
        bit for bit to make_train_step on the same weights and batch (loss,
        correct, gradients, parameters after the step), #1 and each #2
        kernel launched 12 times per step, ms per step beside
        make_train_step's; make_parallel_multi_step at K=4 captured with
        its NCCL all-reduces inside (counted at capture), two replays
        bitwise against 8 eager parallel steps, replay and eager ms/step;
        the GPipe step on pipe=1 with M = 4 microbatches of 16, held to
        make_train_step at b's bf16 tolerances (the microbatch split
        changes the GEMMs' shapes and the order of the sums), #1 and each
        #2 kernel launched 12 x 4 = 48 times per step, ms per step;
     b. two spawned ranks sharing the card over gloo: data=2, data=2 with
        FSDP, model=2 (6 heads per rank; #1's launch_info logged), seq=2
        on the flagship (ring KERPLE) and on `baseline` (ring softmax),
        expert=2 with the soft-MoE MLP (4 experts), pipe=2 (GPipe, M = 4,
        6 blocks per rank; no bubble tick runs a block), one step each held
        to the single-process step on the card (loss, correct count, every
        gradient of the rank's part; bf16 tolerances), launches per step
        (pipe=2: (12 / 2) x 4 = 24 of #1 and of each #2 on each rank),
        host-staged ms per step, each rank's peak memory beside the single
        process's; #1 and #2 checked and timed first at a rank's shapes
        (half the batch, half the heads, the pipeline's microbatch of 16);
     c. seq=2 at 1024x1024 (N = 4097), batch 4, the same way, each rank's
        peak memory logged;
     d. with more than one card, b and c again over NCCL, one card per
        rank; with one, a line saying it was not run and why.
 23. the rest of the port's modules, mnist_config widths (N=17, D=16,
     F=44) unless said otherwise:
     a. the ensemble over a mesh: two spawned ranks share the card over
        gloo, S = 4 flagship members sharded over data=2 (bf16, batch 32,
        dropout 0.1, members from seeds 100..103): three calls of
        make_ensemble_train_step(mesh=) (the warm-up and capture, two
        replays), each rank's members and every call's gathered losses and
        corrects bit for bit those of the single-process 4-member step on
        the card; each rank's graph holds 2 members' launches (6 of #1 and
        of each #2 kernel, counted at capture); replay ms;
     b. sharded checkpoints (`save_checkpoint_sharded`) of the phase 22
        flagship (ViT-B, batch 64) after one step: on one NCCL rank
        (data=1) and on the two gloo ranks of a (data=2, FSDP): a fresh
        state of another seed restores it bit for bit (parameters or
        shards, Adam moments, step); the bytes each rank writes beside the
        single gathered file, save and load seconds; on the NCCL rank also
        make_parallel_multi_step (K=4) of the flagship with feature redraw
        every 2 calls, two replays bitwise against 8 eager parallel steps;
     c. the importer: a reference-format file (`torch.save` of a port
        model's state_dict, fp32) imported on the card, then `predict
        --input` serves it: #1 launched 3 times, predictions the source
        model's; the imported model's logits bit for bit the source's on
        the card;
     d. the 11-variant throughput sweep at cifar10 and mnist, batch 256,
        bf16, SWEEP_STEPS chained steps a run: every row finite and
        positive; #1 / #2 (KERPLE variants), #6 / 7a (softmax) and #8 / #9
        (circulant) launched; #1, #2, #6, 7a, #8 and #9 checked and timed
        at the sweep's shapes;
     e. feature redraw inside CUDA graphs: the headline model (phase 17)
        with feature_redraw_interval 2 and 3, make_multi_step at K=4,
        called until two calls have replayed (one graph per pattern of
        redraw positions: 1 capture at interval 2, 3 at interval 3), every
        call bitwise against 4 eager steps of a twin (losses, corrects,
        parameters, Adam moments, Omega, redraw counters, generators), #1
        and #2 launches counted at each capture; one make_gather_multi_step
        chunk and one 2-member make_ensemble_gather_multi_step chunk with
        redraw, captured then replayed, bitwise against eager steps;
     then `parallel.dryrun.dryrun_multichip(8)`: every part of the JAX dry
     run on 8 CPU ranks;
 24. the `auto` dispatch (constants from the H100 rows of PERF.md §6):
     a. the flagship, `baseline` and performer_favor_circulant with every
        auto default, ViT-B/16 widths at depth 2, batch 8, at N = 17, 197
        and 1025, and `baseline` / baseline_circulant with return_attention
        at N = 197 and N = 4097: each eval forward from counts of 0 launches
        what the arms its rules name launch (#1, #6, #8 or nothing), its
        logits (and maps) bit for bit those of a twin on the named explicit
        arms; return_attention past SOFTMAX_DENSE_MEMORY_BUDGET refused;
     b. performer_favor_circulant exported under a symbolic batch (auto's
        rotation on the kernels, as at a concrete batch) served against its
        twin on the named arms, bitwise;
     c. fused_masked_linear_attention(bwd_mode="auto") below and past
        KERPLE_DENSE_MEMORY_BUDGET: the launches of the mode the rule names
        (#5's dq and dkv past MASKED_LINEAR_BWD_CROSSOVER_N), gradients
        bitwise the named mode's; toeplitz_matmul's auto on either side of
        FFT_MIN_N and FFT_MAX_D, bitwise its named arm;
     d. each kernel that a-c launched, against its plain version and timed
        (bound, SDPA for flash) at each shape it was launched at: the
        `dispatch_auto_<shape>` / `dispatch_auto_bwd_<shape>` rows;
     e. the dense KERPLE and dense softmax arms captured in make_multi_step
        graphs at the headline's shape, bitwise against eager steps;
     f. the nine dispatch experiments in process at small settings: every
        row finite, both arms present.
 25. the JAX package's last experiments, ported:
     a. experiments/vitbase_bench.py at full ViT-B width, a quarter of its
        timed steps: baseline, performer_favor and the flagship at N = 197 /
        1025 / 4097 (batch 64 / 16 / 4); no row failed, 0 < MFU < 1 against
        the card's dense bf16 peak, each row's launches per step those of
        the auto rules (#6 + 7a at N=197, #6 + 7b past it, #1 + #2 at every
        N, none for performer_favor), the flagship's N=197 FLOPs within 10%
        of bench_torch.py's count; #1 / #2 and #6 / 7b first checked and
        timed at the 1025 row's shapes;
     b. experiments/vitb_batch_sweep.py at batch 64 and 128 (#1 / #2 checked
        and timed at 128 first), then K=8 steps a CUDA-graph replay at the
        best: finite rows, #1 / #2 12 launches a step, at the fused row 12 x
        (1 + 2 x 8) (the counted step, the first call's eager steps and its
        capture) and none in the replays;
     c. experiments/longn_train.py at its defaults (ViT-B, N=4097, batch 4,
        dropout 0.1, lr 1e-4, 120 steps) for baseline (#6 + 7b) and the
        flagship (#1 + #2): finite, the mean of the last five losses below
        the first five's, every launch counted; the baseline's loss falls to
        chance (ln 10), which a model learns with its head alone, so its
        model cut to depth 2 then takes one step on the flash kernels and
        one on the dense arm (the plain formula, the same hash-dropout
        cells) from the same weights, inputs and seed: every gradient
        within GRAD_REL_TOL in norm;
     d. experiments/flash_tune.py and coeffs_tune.py at N=4097 with the
        backward, on reduced grids (the shipped kernels and points at which
        every kernel runs another tile): every variant held against the
        plain versions, then timed; its launch_info logged (the flash
        variants' shared memory equal to the sweep's count); both sweeps'
        variants start their nvcc together at the start of d.
     Each experiment's call starts from launch counts of 0; its rows' own
     launch counts add up to the counters read after it.
 26. the phi+ kernels (csrc/phi_positive.cu; run after phase 3e):
     a. launch_info of the forward and backward at (F, D) = (266, 64) and
        (44, 16), no spills at F=266; the built (D, F) rule equal to
        `phi_kernel_takes` on a grid;
     b. at both flagship cells' shapes, (128, 12, 197, 64, 266) and (4, 12,
        4097, 64, 266), and at PHI_EDGE_SHAPES, x in the head split's
        layout: phi within one bf16 step of the plain chain and bitwise on
        a rerun; the kernels' products u = x Omega and dz Omega^T against
        fp64 within PHI_PRODUCT_RATIO of cuBLAS fp32's error; dx within
        PHI_DX_TOL of the plain chain's backward, in x's strides, bitwise on
        a rerun; at the two cells' shapes timed beside phi_bounds and the
        plain chain (the `phi_<shape>` rows);
     c. a flagship train step at ViT-B/16, batch 128: 24 phi+ forwards and
        24 backwards, the plain chain never on a CUDA tensor, loss and
        gradients against a twin on the plain chain, ms/step and peak of
        both; the FAVOR+ variants without KERPLE at depth 2: 4 of each.
 27. SAM ViT-H's attention with the decomposed relative-position bias
     (#6r, 7r; run after phase 26), at the benchmark cell's two calls
     (100, 16, 196, 80) on 14 x 14 and (4, 16, 4096, 80) on 64 x 64:
     a. launch_info of the forward, dq and dkv bias kernels: mma.sync, no
        spills;
     b. on the same card tensors, the forward (out, lse) and the backward
        (dq, dk, dv, d rel_h, d rel_w; dq and dkv launched, not the fused
        pass; bitwise on a rerun) against the plain versions, within
        FLASH_TOL, and the plain versions with rel_h or rel_w zeroed
        outside it (the check sees a dropped term); the same calls without
        the bias (D = 80: fused where it fits and two-pass) against theirs;
        each bias kernel timed beside the same kernel without the bias, the
        plain version, scaled_dot_product_attention with the bias
        materialised as a float mask (its gradient summed back onto the
        rows) and counts/sam.py's least time of the call;
     c. one eager ViT-H train step (batch 4, 1024 x 1024, bf16, tables
        drawn N(0, 0.02)) with the counts zeroed before it: 28 + 28 + 28
        windowed and 4 + 4 + 4 global launches of the bias kernels and no
        other flash launch, loss and gradients finite, every table's
        gradient nonzero; the `*_rel` rows of the kernels line.
The line before the last lists every kernel as JSON, one row per kernel and
main path; the last line is {"ok": true, "device": {...}}. Without a GPU, or
without the rest of the repository beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# bytes / memory rate and operations / compute rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # tensor core bf16, fp32 FMA

# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain|.
# fp32: only the summation order differs (~1e-6 relative at F=266).
# bf16: outputs are rounded to bf16 (2^-8 relative); a weight whose fp32
# value lands on the other side of a bf16 rounding boundary may differ by
# one ulp, so allow ~2.5 ulps of the output plus a small absolute floor.
# den is fp32 in both versions: only the summation order differs.
OUT_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
DEN_RTOL = 1e-4

# served logits, kernel vs dense path, both bf16: the two paths round
# different fp32 sums to bf16 in each of 12 blocks; allow 5% of the logit
# range, and require >= 99% top-1 agreement.
LOGIT_REL_TOL = 5e-2
MIN_TOP1_AGREEMENT = 0.99
# Top-1 flips between two bf16 arms happen only at near-ties (a top-2 gap
# below twice the logit noise), so at 128 random-weight images the agreement
# is a statistic of that noise. Where an arbitrated phase falls below
# MIN_TOP1_AGREEMENT, both bf16 arms are held against the dense arm in fp32:
# the kernel arm passes if its max and mean logit errors are within
# BF16_ERROR_FACTOR of the dense bf16 arm's (the repo's bf16 rule against
# the JAX package, PERF.md section 2) and it keeps MIN_TOP1_AGREEMENT of the
# fp32 model's top-1 on the images whose fp32 top-2 gap exceeds twice the
# dense bf16 arm's largest logit error (decisions that arm's noise cannot
# flip).
BF16_ERROR_FACTOR = 2.0

# backward kernels vs their plain versions: max |kernel - plain| <= tol *
# max |plain| per output. fp32: summation order only. bf16: dA and A*T are
# rounded to bf16 from fp32 sums taken in another order, so an element may
# round the other way (one bf16 ulp, 2^-8 relative) before the products.
# dcoeffs and the dc windows are fp32 sums of fp32 products in both dtypes.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DCOEFF_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

# flash kernels vs their plain versions, max |kernel - plain| <= tol *
# max |plain| for out, dq, dk, dv: fp32 differs in summation order (and the
# online softmax's rescaling) only. bf16: the kernel rounds p = exp(s - m)
# against the running row max of its 64-column tiles, the plain version
# against the final max, so a probability may round one bf16 ulp the other
# way before the value product; likewise dS. lse is fp32 from fp32 sums in
# both: absolute tolerance.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-4

# rotation kernels vs their plain versions, max |kernel - plain| <= tol *
# max |plain| for out and dx: both compute fp32 DFT products (in another
# summation order) and round once to the input dtype, so a bf16 element may
# round one ulp the other way. dct, dst: fp32 sums in both dtypes.
ROT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ROT_ANGLE_TOL = 1e-4

# train step-1 gradients, kernel path vs dense path (same weights, bf16):
# ||g_kernel - g_dense|| / ||g_dense|| per parameter tensor.
GRAD_REL_TOL = 5e-2
# the fused-phi forward is held to OUT_TOL, and den to FUSED_DEN_RTOL: phi
# is computed by the same rules on both sides, but from u = x Omega summed
# in another order, so in bf16 a feature may round one ulp (up to 2^-7
# relative) the other way before the score product. A q-side feature moves
# all of its row's scores together: den_i by up to 2^-7 times that
# feature's share of den_i (a few percent for phi+ at F=266; 2.6e-4
# measured at B=32). fp32 rounds no feature: DEN_RTOL.
FUSED_DEN_RTOL = {"float32": DEN_RTOL, "bfloat16": 2 ** -8}

VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000,
            dim=768, depth=12, heads=12, mlp_dim=3072, dropout=0.0,
            compute_dtype="bfloat16", batch_size=32)
REQUESTS = 4
TRAIN_BATCH = 64
TRAIN_STEPS = 5
TIMED_STEPS = 5
# long-N training: 1024x1024 images at patch 16 (N = 64^2 + 1 = 4097), the
# JAX package's reference-default dropout 0.1
LONGN = dict(VITB, image_size=1024, dropout=0.1, batch_size=4)
LONGN_N = (LONGN["image_size"] // LONGN["patch_size"]) ** 2 + 1
LONGN_STEPS = 2   # step 1 (bitwise against a first run), then a warm-up step
LONGN_TIMED = 2
DTYPES = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
BF16_ONLY = DTYPES[:1]
# KERPLE forward shapes (B, H, N, F, D): the ViT-B/16 serving shape, the
# training shape, one ragged q/kv tile, three tiles the last ragged, the JAX
# package's kernel-test shape
FWD_SHAPES = [(32, 12, 197, 266, 64), (TRAIN_BATCH, 12, 197, 266, 64),
              (4, 12, 17, 266, 64), (4, 12, 130, 266, 64), (2, 2, 197, 44, 16)]
# ViT-B/16 KERPLE at 1024x1024 (phase 16)
KERPLE_LONGN = (LONGN["batch_size"], 12, LONGN_N, 266, 64)
# (B, H, N, F, D): the ViT-B/16 training shape, ragged shapes, the JAX
# package's kernel-test shape
BWD_SHAPES = [(TRAIN_BATCH, 12, 197, 266, 64), (4, 12, 17, 266, 64),
              (4, 12, 130, 266, 64), (2, 2, 197, 44, 16)]
# bf16 shapes at the edges of the forward's and the dq kernel's tiles
# (128-row query blocks against 64-row key/value stages), the dkv kernel's
# (64 key/value rows against 32-row query tiles) and the dc kernel's
# (128-row query blocks of two 64-row window tiles, 64-row key/value
# stages): one row short of, at and past each; and batches of 1 and 3, the
# ends of the dc kernel's ordered batch sum
KERPLE_EDGE_SHAPES = [(2, 12, 31, 266, 64), (2, 12, 33, 266, 64), (2, 12, 63, 266, 64),
                      (2, 12, 64, 266, 64), (2, 12, 65, 266, 64), (2, 3, 127, 266, 64),
                      (2, 3, 128, 266, 64), (2, 3, 129, 266, 64), (1, 12, 197, 266, 64),
                      (3, 12, 129, 266, 64)]
BWD_KERNELS = ("masked_linear_coeffs_bwd_dq", "masked_linear_coeffs_bwd_dkv",
               "masked_linear_coeffs_bwd_dc", "masked_linear_coeffs_bwd_dc_reduce")
KERPLE_FORWARDS = ("masked_linear_coeffs_fwd", "kerple_fused_phi_fwd")
# fused-phi shapes (B, H, N, D, F): serving, training, ragged, the JAX
# package's kernel-test shape
FUSED_SHAPES = [(VITB["batch_size"], 12, 197, 64, 266), (TRAIN_BATCH, 12, 197, 64, 266),
                (4, 12, 17, 64, 266), (4, 12, 130, 64, 266), (2, 2, 197, 16, 44)]
# bf16 fused-phi shapes at the edges of the mma.sync kernel's tiles (128-row
# query blocks against 64-row key/value stages): one row short of, at and
# past each; and batches of 1 and 3
FUSED_EDGE_SHAPES = [(2, 12, 31, 64, 266), (2, 12, 33, 64, 266), (2, 12, 63, 64, 266),
                     (2, 12, 64, 64, 266), (2, 12, 65, 64, 266), (2, 3, 127, 64, 266),
                     (2, 3, 128, 64, 266), (2, 3, 129, 64, 266), (1, 12, 197, 64, 266),
                     (3, 12, 129, 64, 266)]
# phase 26, the phi+ kernels (csrc/phi_positive.cu), shapes (B, H, N, D, F):
# the two flagship cells' (batch 128 at N=197, batch 4 at N=4097), then
# groups of 16 rows across several batches (N < 16), narrow and mid F, head
# dims that are not multiples of 16, the smallest F and D the rule takes
PHI_SHAPES = [(128, 12, 197, 64, 266), (4, 12, 4097, 64, 266)]
PHI_EDGE_SHAPES = [(3, 2, 17, 16, 44), (5, 3, 7, 64, 266), (2, 3, 31, 64, 272),
                   (4, 2, 33, 48, 128), (3, 2, 19, 40, 64), (2, 1, 5, 8, 2), (2, 12, 197, 24, 266)]
# the kernels' products (u = x Omega, dz Omega^T) held to an fp64 product:
# their largest error at most this many times cuBLAS fp32's (TF32 off)
PHI_PRODUCT_RATIO = 4.0
# dx against the plain chain's backward: max |dx - plain| / max |plain|. The
# two differ only in fp32 summation orders (the projection, the feature sum
# behind ||x||^2's gradient), each of which can move a bf16 rounding of the
# chain (bf16(dz Omega^T), bf16(-sum dz), the sum) by one step: 2^-7 is one
# bf16 step at the largest element.
PHI_DX_TOL = 2.0 ** -7
# ViT-B/16 at one of the flagship cells' shapes (224 px, batch 128) for the
# launches of an eager train step, and the FAVOR+ variants without KERPLE at
# depth 2, batch 8
PHI_TRAIN = dict(VITB, batch_size=128)
PHI_VARIANTS = ("performer_favor", "performer_favor_rope", "favor_plus_rope_2d",
                "performer_favor_circulant")
# phase 3f, the materialised-T kernels (#4, #5), beside the pallas_ab entry
# point's own shapes (B, H, N, F, D): the ViT-B/16 training shape, a ragged
# shape, the JAX package's kernel-test shape; long N in bf16 only
ML_SHAPES = [(TRAIN_BATCH, 12, 197, 266, 64), (3, 2, 17, 44, 16), (2, 2, 197, 44, 16)]
# a T that is not Toeplitz (uniform in [0.5, 1.5) per element) at a
# pallas_ab shape and a ragged shape in both dtypes, and at long N in bf16
ML_RANDOM_T = [(256, 2, 197, 44, 16), (3, 2, 17, 44, 16)]
# bf16, T not Toeplitz, at the edges of the mma.sync kernels' tiles (128-row
# query blocks against 64-row key/value stages for the forward, dq and dT;
# 64 key/value rows against 32-row query tiles for dkv): one row short of,
# at and past each, in the wide (F = 266) and narrow (F = 44, D = 16)
# instantiations; batches of 1 and 3; and a batch that dT's groups do not
# divide (B = 20 at N = 300: 7 groups of 3, the last of 2)
ML_EDGE_SHAPES = [(2, 3, n, 266, 64) for n in (31, 33, 63, 64, 65, 127, 128, 129)] + [
    (2, 3, n, 44, 16) for n in (63, 65, 129)] + [
    (1, 12, 197, 266, 64), (3, 12, 129, 266, 64), (3, 2, 300, 128, 64), (20, 2, 300, 44, 16)]
ML_KERNELS = ("masked_linear_fwd", "masked_linear_bwd_dq", "masked_linear_bwd_dkv",
              "masked_linear_bwd_dt")
# phase 16, the fft arm against the kernels with gradients: (B, H, N, F, D)
FFT_GRAD_SHAPE = (2, 12, 1025, 266, 64)
# favor_hyper's KERPLE shape: F = 2 * 266
F532 = (2, 12, 197, 532, 64)
# flash cases (B, H, N, D, mask, dropout rate): the serving and training
# shapes, ragged shapes, the JAX package's kernel-test shape, both mask
# layouts, dropout alone and with a mask, the largest head dim, and SAM
# ViT-H's head dim 80 (staged at 80) at its windows' N
FLASH_CASES = [(VITB["batch_size"], 12, 197, 64, None, 0.0),
               (TRAIN_BATCH, 12, 197, 64, None, 0.0),
               (4, 12, 17, 64, None, 0.0), (4, 12, 130, 64, None, 0.0),
               (2, 2, 197, 16, None, 0.0),
               (4, 12, 197, 64, "B1NN", 0.0), (4, 12, 197, 64, "BHNN", 0.0),
               (4, 12, 197, 64, None, 0.1), (4, 12, 197, 64, "BHNN", 0.1),
               (2, 2, 197, 128, None, 0.0), (4, 16, 196, 80, None, 0.0)]
FLASH_LONGN = (LONGN["batch_size"], 12, LONGN_N, 64, None, LONGN["dropout"])
# bf16 cases at the edges of the fused mma.sync kernel's tiles (32-row query
# tiles, one block holding up to 208 key/value rows): one row short of, at
# and past each, with a mask and dropout; N=209 takes the staged fused kernel
FLASH_EDGE_CASES = [(2, 3, 31, 64, None, 0.0), (2, 3, 33, 64, None, 0.1),
                    (2, 3, 207, 64, "BHNN", 0.0), (2, 3, 208, 64, "B1NN", 0.1),
                    (2, 3, 209, 64, None, 0.0)]
# the kernel the fused pass runs at each edge case's N (launch_info's "kernel")
FUSED_MMA_MAX_N = 208
# SAM ViT-H's attention calls with the decomposed relative-position bias
# (B, H, N, D, kh, kw), as the benchmark cell SAM_CELL runs them: the
# windowed call (4 images x 25 windows of 14 x 14) and the global one (64 x
# 64); phase 27's train step at the cell's batch
SAM_CELL = "sam-h-train-n4096"
SAM_SHAPES = {"sam_window_train": (100, 16, 196, 80, 14, 14),
              "sam_global_train": (4, 16, 4096, 80, 64, 64)}
SAM_TRAIN_BATCH = 4
# the phases `--only` can run alone after phases 1 and 2
ONLY_PHASES = ("3c", "27")
# rotation shapes (B, H, N, D): serving, training and long-N (each a main
# path), the JAX package's kernel-test shapes, a head dim whose column
# groups leave threads idle (80, ViT-H's) and the largest head dim
ROT_PATHS = {(VITB["batch_size"], 12, 197, 64): "circulant_serve",
             (TRAIN_BATCH, 12, 197, 64): "circulant_train",
             (LONGN["batch_size"], 12, LONGN_N, 64): "circulant_longn_train"}
ROT_SHAPES = list(ROT_PATHS) + [(2, 3, 190, 16), (1, 2, 17, 16), (3, 1, 65, 64),
                                (2, 2, 130, 80), (2, 2, 197, 128)]
# the bf16 mma.sync rotation kernels' edges: one row short of, at and past
# the 16-row warp tiles and 128-row blocks, their other head dims, and
# batch groups with a short last group
ROT_SHAPES += [(2, 2, 15, 64), (2, 3, 127, 64), (3, 2, 129, 64), (1, 3, 128, 32),
               (5, 2, 200, 48), (7, 12, 1000, 64)]
# phase 12: (variant, rpe_config of the kernel arm, of the dense arm), at
# ViT-B width and depth VARIANT_DEPTH
BLOCK_CIRCULANT = {"block_size": 16, "enable_block_circulant": True}
# marks a phase-12 kernel arm that takes attention_config={"fused_phi": True}
FUSED_PHI = "fused_phi"
OTHER_VARIANTS = [
    ("baseline_rope", None, None), ("performer_favor_rope", None, None),
    ("performer_relu_rope", None, None), ("softmax_rope_2d", None, None),
    ("favor_plus_rope_2d", None, None), ("relu_rope_2d", None, None),
    ("performer_favor_circulant", {"method": "pallas"}, {"method": "chain"}),
    ("performer_relu_circulant", {"method": "pallas"}, {"method": "chain"}),
    ("baseline_circulant", BLOCK_CIRCULANT, BLOCK_CIRCULANT),
    ("favor_hyper", None, None),
    ("favor_hyper_circulant", {"method": "pallas"}, {"method": "chain"}),
    ("favor_hyper_most_general", {"method": "pallas"}, {"method": "dense"}),
    ("performer_relu_most_general", FUSED_PHI, {"method": "dense"}),
]
VARIANT_DEPTH = 2
# phase 17: the JAX bench_headline row's model (mnist_config: depth 3, dim
# 32, 2 heads, dropout 0.1) at patch 2 (N = 197), batch 256, bf16, K steps
# per CUDA-graph replay; its attention runs #1 / #2 at (256, 2, 197, 44, 16)
HEADLINE = dict(patch_size=2, batch_size=256, compute_dtype="bfloat16")
HEADLINE_K = 25
HEADLINE_SHAPE = (256, 2, 197, 44, 16)
# and the bench_vitb_kerple row's (28x28 at patch 2: N = 197, ViT-B widths)
ENGINE_VITB = dict(patch_size=2, batch_size=TRAIN_BATCH, dim=768, depth=12, heads=12,
                   mlp_dim=3072, dropout=0.0, compute_dtype="bfloat16")
ENGINE_VITB_K = 5
# phase 18: a synthetic MNIST of ENGINE_N train and ENGINE_N // 4 test
# images, one epoch of the headline model at dropout 0 per loop
ENGINE_N = 4096
ENGINE_K = 4
ENGINE_EVAL_K = 3

# phase 19: the train CLI's run (the flagship at the JAX mnist_config widths,
# patch 7: N = 17, F = 44, D = 16; default batch 32), its #1 / #2 shape, the
# JAX CLI's metrics keys, and the ViT-B MoE model trained with and without remat
CLI_FLAGS = ["--model", "performer_favor_most_general", "--dataset", "mnist",
             "--compute-dtype", "bfloat16", "--fused-steps", "4", "--save-model",
             "--seed", "0", "--quiet"]
CLI_SHAPE = (32, 2, 17, 44, 16)
CLI_METRICS_KEYS = {
    "metadata": ["model_name", "dataset", "attention_type", "rpe_type", "seed",
                 "num_parameters", "backend", "synthetic_data", "config"],
    "per_epoch": ["epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy",
                  "epoch_time"],
    "aggregate": ["best_test_accuracy", "final_test_accuracy", "final_test_loss",
                  "log_likelihood", "aic", "bic", "final_train_accuracy", "final_train_loss",
                  "total_train_time"],
    "inference": ["mode", "chain_length", "num_chains", "fetch_rt_ms",
                  "throughput_images_per_sec", "latency_mean_ms", "latency_std_ms",
                  "latency_min_ms", "latency_max_ms", "latency_p50_ms",
                  "latency_ms_per_sample", "batch_size", "num_iterations"],
}
# phase 20: the benchmark runner (experiments.benchmark) at the dataset
# config's widths in bf16, 2 seeds x 2 epochs of K = 4 steps per replay,
# sequential (one `shared` dict per model), then --skip-existing, then as
# one ensemble: the flagship on #1 / #2 at CLI_SHAPE, the baseline on #6 /
# 7a at BENCH_FLASH_SHAPE (B, H, N, D) with the config's dropout 0.1
BENCH_MODELS = ("performer_favor_most_general", "baseline")
BENCH_SEEDS = (42, 153)
BENCH_FLAGS = ["--models", *BENCH_MODELS, "--num-runs", "2", "--epochs", "2",
               "--fused-steps", "4", "--compute-dtype", "bfloat16", "--quiet"]
BENCH_ROWS = ("epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy")
BENCH_FLASH_SHAPE = (32, 2, 17, 16)
BENCH_FLASH_RATE = 0.1
BENCH_KERNELS = {"performer_favor_most_general": ("masked_linear_coeffs_fwd",
                                                  "masked_linear_coeffs_bwd_dq",
                                                  "masked_linear_coeffs_bwd_dkv",
                                                  "masked_linear_coeffs_bwd_dc"),
                 "baseline": ("flash_fwd", "flash_bwd_fused")}
# the ensemble's capture against one model's, one chunk of K steps of B
ENSEMBLE_K, ENSEMBLE_S = 4, 2
MOE_VITB = dict(VITB, batch_size=TRAIN_BATCH, dropout=0.1)
MOE_EXPERTS = 4
MOE_GRAD_RTOL = 1e-6
MOE_WARMUP, MOE_TIMED = 3, 5

# phase 22: parallelism (efficient_rpe_vit_torch.parallel) on the one card.
# PAR is phase 4's flagship at the training batch, dropout 0. a) one rank on
# NCCL: every collective runs over one rank, a copy, so each parallel step
# must equal make_train_step's bit for bit; PAR_K steps per CUDA-graph
# replay against PAR_K eager parallel steps, bitwise. b) two ranks share the
# card over gloo (the collectives go through host memory: their times are
# no measure of NCCL), each case held to the single-process step on the
# card, bf16: the loss to PAR_LOSS_RTOL and each gradient tensor (this
# rank's part: a TP / EP slice, an FSDP shard) to GRAD_REL_TOL of its norm.
# A half batch runs other cuBLAS tile choices and #2's dc sums its batch in
# another order; the rings sum their blocks in fp32 in another order than
# the kernels; the Megatron all-reduce rounds the projections' partial sums
# to bf16 before they are added. An arg-max may flip at a near-tie of the
# 1000 random-weight logits: the correct counts may differ by
# PAR_CORRECT_SLACK. c) context parallelism at long N: the flagship at
# 1024x1024 (N = 4097), batch 4, seq=2, held the same way.
PAR = dict(VITB, batch_size=TRAIN_BATCH)
PAR_FLAGSHIP = "performer_favor_most_general"
PAR_WORLD1 = (("data1", "data=1", False), ("fsdp1", "data=1", True), ("model1", "model=1", False))
PAR_K = 4
PAR_TIMED = 3
PAR_LOSS_RTOL = 1e-2
PAR_CORRECT_SLACK = 2
PAR_EXPERTS = 4
PAR_MICROBATCHES = 4  # GPipe's M on pipe=1 (22 a) and pipe=2 (22 b)
# (path, mesh, model, options): each case's model is built from seed 0
PAR_CASES = (("parallel_dp2", "data=2", PAR_FLAGSHIP, {}),
             ("parallel_fsdp2", "data=2", PAR_FLAGSHIP, {"fsdp": True}),
             ("parallel_tp2", "model=2", PAR_FLAGSHIP, {}),
             ("parallel_cp2", "seq=2", PAR_FLAGSHIP, {}),
             ("parallel_cp2_baseline", "seq=2", "baseline", {}),
             ("parallel_ep2", "expert=2", PAR_FLAGSHIP, {"moe": PAR_EXPERTS}),
             ("parallel_pp2", "pipe=2", PAR_FLAGSHIP, {"microbatches": PAR_MICROBATCHES}))
PAR_LONGN = dict(LONGN, dropout=0.0)
# the KERPLE kernels' shapes on a rank: half the batch (DP, FSDP), half the
# heads (TP), one GPipe microbatch (PP)
PAR_SHAPES = {"half_batch": (TRAIN_BATCH // 2, 12, 197, 266, 64),
              "half_heads": (TRAIN_BATCH, 6, 197, 266, 64),
              "microbatch": (TRAIN_BATCH // PAR_MICROBATCHES, 12, 197, 266, 64)}

# phase 21: serving artifacts (efficient_rpe_vit_torch.serve). The ViT-B
# flagship artifact (phase 4's model and weights) serves these batches; the
# mnist_config-width artifacts (dim 32, depth 3, 2 heads, patch 7: N = 17,
# D = 16, F = 44) serve SERVE_MNIST_BATCH, their kernels at SERVE_SHAPE
# (B, H, N, D, F). A reloaded artifact runs the same kernels on the same
# weights as the live model, so its logits must equal the live model's
# bitwise. serve_bench --vitb fits SERVE_FIT_STEPS steps and times short
# chains; its reduced artifacts must be smaller than the fp32 one by the JAX
# package's test factors (bf16 < 0.75x, int8 < 0.6x).
SERVE_BATCHES = (1, 32, 256)
SERVE_MNIST = dict(compute_dtype="bfloat16")
SERVE_MNIST_BATCH = 32
SERVE_SHAPE = (SERVE_MNIST_BATCH, 2, 17, 16, 44)
SERVE_FIT_STEPS = 10
SERVE_BYTES_FACTOR = {"artifact_bf16": 0.75, "artifact_int8": 0.6}

# phase 23: the rest of Queue A. QA is the mnist_config width (phase 19's
# CLI_SHAPE at batch 32) in bf16; the ensemble has QA_S members over 2
# ranks. QA_CKPT is phase 22's flagship. The sweep runs SWEEP_STEPS steps a
# run (the JAX default is 60; cut so that the phase stays near 90 s); its
# KERPLE kernels are checked at SWEEP_SHAPE, its flash and rotation kernels
# at SWEEP_FLASH_SHAPE.
QA = dict(compute_dtype="bfloat16", dropout=0.1)
QA_S = 4
QA_CALLS = 3  # the warm-up and capture, then two replays
QA_CKPT = PAR
SWEEP_BATCH = 256
SWEEP_STEPS = 20
SWEEP_SHAPE = (SWEEP_BATCH, 2, 17, 44, 16)
SWEEP_FLASH_SHAPE = (SWEEP_BATCH, 2, 17, 16)
REDRAW_K = 4
REDRAW_INTERVALS = (2, 3)
REDRAW_REPLAYS = 2

# phase 24: the `auto` dispatch. DISPATCH is ViT-B/16 at depth 2 and batch 8;
# each rule is read at every image of DISPATCH_IMAGES (N = 17, 197, 1025)
# and return_attention also at DISPATCH_LONG (N = 4097, past the softmax
# budget); the materialised-T backward below and past the KERPLE budget at
# DISPATCH_BWD (B, H, N, F, D); the Toeplitz product's auto at
# DISPATCH_TOEPLITZ [B, H, N, d] (either side of FFT_MIN_N and FFT_MAX_D);
# the dense arms captured in K-step graphs at the headline's shape; each
# dispatch experiment at DISPATCH_EXPERIMENTS' small settings
DISPATCH = dict(VITB, depth=2, batch_size=8)
DISPATCH_IMAGES = (64, 224, 512)
DISPATCH_LONG = dict(DISPATCH, image_size=1024, batch_size=4)
DISPATCH_BWD = [(256, 2, 197, 44, 16), (7, 12, 4097, 266, 64)]
DISPATCH_TOEPLITZ = [(8, 2, 1024, 44), (8, 2, 2048, 44), (2, 12, 2048, 266), (2, 12, 2048, 272)]
DISPATCH_CAPTURE_K = 2
_AB_MODEL = ["--width", "768", "2", "12", "3072", "--shape", "28", "2", "8", "--steps", "2"]
DISPATCH_EXPERIMENTS = {
    "crossover_ab": ["--sizes", "197", "--steps", "3", "--toeplitz", "8", "2", "44"],
    "flash_ab": ["--sizes", "197", "--steps", "3"],
    "flash_crossover": _AB_MODEL,
    "kerple_pallas_ab": _AB_MODEL,
    "rotation_kernel_ab": _AB_MODEL,
    "rot_isolated_ab": ["--steps", "3"],
    "fused_phi_ab": _AB_MODEL,
    "chain_dtype_ab": _AB_MODEL,
    "scaling_ab": ["--sizes", "256", "--steps", "3", "--wall-images", "16", "--wall-max", "2",
                   "--width", "768", "2", "12", "3072"],
}

# phase 25: the JAX package's last experiments, ported. vitbase_bench at
# full ViT-B width with a quarter of its timed steps (3-5); the batch sweep
# at batches 64 and 128, then K=8 at the best; longn_train at its defaults
# (both variants, N=4097, 120 steps); the tile sweeps at their default
# shapes (N=4097) on a reduced grid: the shipped kernels plus points at
# which every kernel runs a tile other than its shipped one, all built in
# parallel
EXP_VITBASE = ["--steps-scale", "0.25"]
EXP_BATCHES = ["--batches", "64", "128"]
TUNE_FLASH_POINTS = [(64, 64)]
TUNE_COEFFS_POINTS = [(64, 32), (32, 32)]
TUNE_STEPS = 4
# longn_train's baseline model (ViT-B widths, 128x128 images at patch 2:
# N=4097, batch 4, dropout 0.1) cut to depth 2, whose step-1 gradients on
# the flash kernels are held to the dense arm's
EXP_LONGN_GRADS = dict(VITB, image_size=128, patch_size=2, in_channels=1, num_classes=10,
                       depth=2, dropout=0.1, batch_size=4)
# a row's flops_per_step against bench_torch.train_flops_per_step at the
# flagship's N=197 row: the two count the same products (phi+'s ops by
# their FLOP formulas, as the counter saw the checkpointed plain chain) but
# for the KERPLE kernels' backward (pallas_attention_flops counts four
# products of the forward's size, bench_torch two: about 6% of the step)
# and the patch embedding's input gradient, which no step takes
EXP_FLOPS_RTOL = 0.10

# --profile sums device time by these groups of kernel names, first match wins
PROFILE_GROUPS = [
    ("KERPLE kernels (this repo)", lambda k: "mlc_" in k or "kfp_" in k),
    ("flash attention kernels (this repo)", lambda k: "flash_fwd" in k or "flash_bwd" in k),
    ("phi+ kernels (this repo)", lambda k: "phi_pos_" in k),
    ("rotation kernels (this repo)",
     lambda k: "rot_fwd_" in k or "rot_bwd_" in k or "group_sum_kernel" in k),
    ("fp32 GEMMs (phi projection x@Omega on the plain chain)",
     lambda k: "f32f32" in k or "sgemm" in k),
    ("bf16 GEMMs (cuBLAS)", lambda k: "nvjet" in k or "gemm" in k),
    ("optimizer (multi-tensor apply)", lambda k: "multi_tensor" in k),
    ("copies and casts", lambda k: "copy" in k),
    ("reductions", lambda k: "reduce" in k),
    ("other elementwise", lambda k: "elementwise" in k),
    ("other", lambda k: True),
]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
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


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device time of one kernel call: `iters` calls captured in one
    CUDA graph, so the wrapper's host work (checks, allocation, ctypes) is
    outside the timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def kerple_bound(B, H, N, F, D, dtype: str):
    """(bound_ms, bound_by) for one KERPLE forward: inputs read once,
    outputs written once; S = q'k'^T and W v products plus the
    mask/rowsum/divide elementwise work."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * B * H * N * F + 2 * B * H * N * D) \
        + 4 * (H * (2 * N - 1) + B * H * N)
    ops = 2 * B * H * N * N * (F + D) + 3 * B * H * N * N + B * H * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kerple_bwd_bounds(B, H, N, F, D, dtype: str, tile: int):
    """{kernel: (bound_ms, bound_by)} for the four backward kernels with
    `tile`-row tiles (the wrapper's BWD_TILE): each input read once (gn, v,
    q', k' in the input dtype; s, coeffs, windows in fp32), each output
    written once; the products M = gn v^T, A = q'k'^T and the
    accumulations, plus the elementwise mask / subtract / multiply work.
    The reduce is fp32 adds, outside the tensor cores."""
    elt = 2 if dtype == "bfloat16" else 4
    bhn, nn = B * H * N, B * H * N * N
    n_t = -(-N // tile)
    win_bytes = 4 * H * n_t * n_t * (2 * tile - 1)
    coef_bytes, s_bytes = 4 * H * (2 * N - 1), 4 * bhn
    peak = PEAK_OPS_PER_S[dtype]
    work = {
        "masked_linear_coeffs_bwd_dq": (
            elt * bhn * (D + D + F + F) + s_bytes + coef_bytes,
            2 * nn * (D + F) + 3 * nn, peak),
        "masked_linear_coeffs_bwd_dkv": (
            elt * bhn * (D + D + F + F + F + D) + s_bytes + coef_bytes,
            2 * nn * (2 * F + 2 * D) + 5 * nn, peak),
        "masked_linear_coeffs_bwd_dc": (
            elt * bhn * (D + D + F + F) + s_bytes + win_bytes,
            2 * nn * (F + D) + 3 * nn + H * n_t * n_t * tile * tile, peak),
        "masked_linear_coeffs_bwd_dc_reduce": (
            win_bytes + coef_bytes, H * n_t * n_t * (2 * tile - 1),
            PEAK_OPS_PER_S["float32"]),
    }
    out = {}
    for name, (nbytes, ops, rate) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _max_rel(got, want) -> float:
    """max |got - want| / max |want| over the tensor."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def kerple_mma_rule(F, D, dtype, fused=False) -> str:
    """The kernel a forward, dq, dkv, dc or fused-phi launch runs by the
    sources' shape rule: the mma.sync one in bf16 at even F <= 272 and
    D <= 64, else the staged one. The fused-phi forward (D the head dim of
    q, k and v, Dv = D as launch_info asks) also needs D % 8 == 0: its raw
    q and k rows move as 16-byte words."""
    takes = dtype == torch.bfloat16 and F <= 272 and F % 2 == 0 and D <= 64
    if fused:
        takes = takes and D % 8 == 0
    return "mma.sync" if takes else "staged"


def check_kerple_rule(mlc, kname, N, F, D, dtype, phase="kernel"):
    """launch_info of `kname` at (N, F, D) in `dtype`, logged; raises unless
    it runs the kernel kerple_mma_rule names."""
    info = mlc.launch_info(kname, N, F, D, dtype)
    name = str(dtype).split(".")[-1]
    log(phase, f"{kname} N={N} F={F} D={D} {name}: " + ", ".join(
        f"{key} {value}" for key, value in info.items()))
    want = kerple_mma_rule(F, D, dtype, fused=kname == KERPLE_FORWARDS[1])
    if info["kernel"] != want:
        raise AssertionError(f"the {kname} launch at F={F} D={D} {name} runs the "
                             f"{info['kernel']} kernel, expected the {want} one")
    return info


def kerple_launch_info(mlc, N, F, D):
    """{kernel: launch_info} of the bf16 KERPLE backward kernels dq, dkv
    and dc at (N, F, D), logged: rows per tile, threads, shared memory,
    blocks per SM, registers, spilled bytes and which kernel runs. Each
    must run the kernel of kerple_mma_rule (the mma.sync ones at even
    F <= 272 and D <= 64), and the fp32 dq and dc the staged ones."""
    out = {kname: check_kerple_rule(mlc, kname, N, F, D, torch.bfloat16)
           for kname in BWD_KERNELS[:3]}
    for kname in (BWD_KERNELS[0], BWD_KERNELS[2]):
        check_kerple_rule(mlc, kname, N, F, D, torch.float32)
    return out


def check_bwd_kernels(mlc, shapes=BWD_SHAPES, dtypes=DTYPES, timed=BWD_SHAPES[0]):
    """Phase 3b: the four backward kernels, one by one and through the
    backward wrapper, against their plain versions on the card; timed in
    bf16 at the shape `timed` (phase 16 calls it at long N; None: no
    timing), whose launch_info (else the first shape's) is logged and kept
    in the timed rows."""
    results = {}
    infos = kerple_launch_info(mlc, *(timed or shapes[0])[2:])
    for B, H, N, F, D in shapes:
        for name, dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(N * 1000 + F + 7)
            q = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            k = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            cot = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            out, den = mlc.masked_linear_attention_coeffs_reference(q, k, v, c)
            gn, s = mlc.kerple_bwd_residuals(den, out, cot)
            shape = f"B{B} H{H} N{N} F{F} D{D} {name}"
            # dq twice: dq' bit for bit (each block sums its stages in order)
            same = torch.equal(mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, k, c),
                               mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, k, c))
            log("kernel", f"masked_linear_coeffs_bwd_dq {shape}: dq' bitwise on a rerun: {same}")
            if not same:
                raise AssertionError(f"dq is not bitwise the same on a rerun at {shape}")
            windows = mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k)
            # dc twice: windows and dcoeffs bit for bit (sums in a fixed order)
            again = mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k)
            same = torch.equal(windows, again) and torch.equal(
                mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, N),
                mlc.masked_linear_attention_coeffs_bwd_dc_reduce(again, N))
            log("kernel", f"masked_linear_coeffs_bwd_dc {shape}: windows and dcoeffs bitwise "
                f"on a rerun: {same}")
            if not same:
                raise AssertionError(f"dc is not bitwise the same on a rerun at {shape}")
            del again
            runs = {
                "masked_linear_coeffs_bwd_dq": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, k, c),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dq_reference(gn, s, v, k, c),
                    BWD_TOL[name]),
                "masked_linear_coeffs_bwd_dkv": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, q, k, c),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dkv_reference(gn, s, v, q, k, c),
                    BWD_TOL[name]),
                "masked_linear_coeffs_bwd_dc": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reference(gn, s, v, q, k),
                    DCOEFF_TOL[name]),
                # the reduce is held against its plain version on the same windows
                "masked_linear_coeffs_bwd_dc_reduce": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, N),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reduce_reference(windows, N),
                    DCOEFF_TOL[name]),
            }
            for kname, (kernel_fn, plain_fn, tol) in runs.items():
                got, want = kernel_fn(), plain_fn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rels = [_max_rel(a, b) for a, b in zip(got, want)]
                errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
                finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
                log("kernel", f"{kname} {shape}: max|err|/max|plain| "
                    f"{', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), finite {finite}")
                if not (finite and max(rels) <= tol):
                    raise AssertionError(f"{kname} disagrees with its plain version at {shape}")
                if (B, H, N, F, D) == timed and name == "bfloat16":
                    ms = kernel_ms(kernel_fn)
                    plain_ms = time_ms(plain_fn, iters=5, warmup=1)
                    bound_ms, bound_by = kerple_bwd_bounds(
                        B, H, N, F, D, name, mlc.BWD_TILE[dtype])[kname]
                    log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                        f"kernel/bound {ms / bound_ms:.2f}x")
                    results[kname] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          **({"launch": infos[kname]} if kname in infos else {}))
            # the whole backward, as autograd calls it, against the plain backward
            got = mlc.masked_linear_attention_coeffs_bwd(q, k, v, c, den, out, cot)
            want = mlc.masked_linear_attention_coeffs_bwd_reference(q, k, v, c, den, out, cot)
            tols = (BWD_TOL[name],) * 3 + (DCOEFF_TOL[name],)
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            log("kernel", f"masked_linear_attention_coeffs_bwd {shape}: (dq', dk', dv, "
                f"dcoeffs) max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)}")
            if any(r > t for r, t in zip(rels, tols)):
                raise AssertionError(f"the backward disagrees with its plain version at {shape}")
    return results


def check_kernels(mlc, shapes=FWD_SHAPES, dtypes=DTYPES, timed=FWD_SHAPES[:2]):
    """Phase 3: the KERPLE forward kernel against its plain version on the
    card, out and den bitwise on a rerun at every shape; timed at the
    shapes `timed` (bf16, and fp32 below the training batch). Logs the
    launch_info of the first timed shape (else the first shape) in both
    dtypes, checked against kerple_mma_rule. Returns {(dtype, B): row} of
    the timed shapes."""
    results = {}
    N0, F0, D0 = (timed[0] if timed else shapes[0])[2:]
    infos = {name: check_kerple_rule(mlc, KERPLE_FORWARDS[0], N0, F0, D0, dtype)
             for name, dtype in DTYPES}
    for B, H, N, F, D in shapes:
        for name, dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(N * 1000 + F)
            q = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            k = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            out, den = mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)
            # twice: out and den bit for bit (every sum in a fixed order)
            again = mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)
            torch.cuda.synchronize()
            shape = f"B{B} H{H} N{N} F{F} D{D} {name}"
            same = torch.equal(out, again[0]) and torch.equal(den, again[1])
            log("kernel", f"masked_linear_coeffs_fwd {shape}: out and den bitwise on a rerun: "
                f"{same}")
            if not same:
                raise AssertionError(f"the forward is not bitwise the same on a rerun at {shape}")
            del again
            ref_out, ref_den = mlc.masked_linear_attention_coeffs_reference(q, k, v, c)
            rtol, atol = OUT_TOL[name]
            err = (out.float() - ref_out.float()).abs()
            ok_out = bool((err <= atol + rtol * ref_out.float().abs()).all())
            den_rel = ((den - ref_den).abs() / ref_den.abs().clamp_min(1e-30)).max().item()
            finite = bool(torch.isfinite(out.float()).all())
            log("kernel", f"masked_linear_coeffs_fwd {shape}: max|out err| "
                f"{err.max().item():.3e} (rtol {rtol}, atol {atol}), max den "
                f"rel err {den_rel:.3e} (rtol {DEN_RTOL}), finite {finite}")
            if not (ok_out and den_rel <= DEN_RTOL and finite):
                raise AssertionError(f"kernel disagrees with its plain version at {shape}")
            # timed at the serving shape (both dtypes) and the training shape (bf16)
            if (B, H, N, F, D) in timed and (name == "bfloat16" or B != TRAIN_BATCH):
                ms = kernel_ms(lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c))
                plain_ms = time_ms(lambda: mlc.masked_linear_attention_coeffs_reference(q, k, v, c))
                bound_ms, bound_by = kerple_bound(B, H, N, F, D, name)
                log("kernel", f"masked_linear_coeffs_fwd {shape}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"kernel/bound {ms / bound_ms:.2f}x")
                results[(name, B)] = dict(max_abs_err=err.max().item(), ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by, launch=infos[name])
    return results


def fused_phi_bound(B, H, N, D, F, dtype: str):
    """(bound_ms, bound_by) for one fused-phi forward (Dv = D): q, k, v
    read once, out written once in the input dtype, den written and Omega
    and the coefficients read once in fp32; phi of q and k once (2 B H N D F
    operations each) and the S = q'k'^T and W v products."""
    elt = 2 if dtype == "bfloat16" else 4
    bhn = B * H * N
    nbytes = elt * 4 * bhn * D + 4 * (bhn + H * D * F + H * (2 * N - 1))
    ops = 2 * 2 * bhn * D * F + 2 * B * H * N * N * (F + D)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _fused_inputs(B, H, N, D, F, dtype):
    """L2-normalised q, k, v, Gaussian Omega [H, D, F] and coefficients."""
    g = torch.Generator(device="cuda").manual_seed(N * 1000 + F + B)
    q, k = (_unit_rows(torch.randn(B, H, N, D, generator=g, device="cuda")).to(dtype)
            for _ in range(2))
    v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
    omega = torch.randn(H, D, F, generator=g, device="cuda")
    c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
    return q, k, v, omega, c


def _unit_rows(x):
    return x / x.norm(dim=-1, keepdim=True)


def check_fused_kernels(mlc):
    """Phase 3e: the fused-phi forward against its plain version on the
    card, both feature kinds, in both dtypes at FUSED_SHAPES and in bf16 at
    FUSED_EDGE_SHAPES, out and den bitwise on a rerun at every shape. Logs
    launch_info at the main path's (F, D) = (266, 64) and at the JAX tests'
    (44, 16) in both dtypes, checked against kerple_mma_rule (bf16 on the
    mma.sync kernel, with no spilled bytes at the main path's shape; fp32
    on the staged one). Returns {(dtype, B): row} for the serving and
    training shapes (phi+, the main path's kind), the row holding the
    unfused route's time and the launch_info."""
    from efficient_rpe_vit_torch.ops import phi_positive

    kname = KERPLE_FORWARDS[1]
    infos = {(name, F): check_kerple_rule(mlc, kname, 197, F, D, dtype)
             for F, D in ((266, 64), (44, 16)) for name, dtype in DTYPES}
    if infos[("bfloat16", 266)]["spill_bytes"]:
        raise AssertionError(f"the bf16 {kname} kernel spills "
                             f"{infos[('bfloat16', 266)]['spill_bytes']} bytes at F=266 D=64")
    results = {}
    cases = [(shape, DTYPES) for shape in FUSED_SHAPES] + \
        [(shape, BF16_ONLY) for shape in FUSED_EDGE_SHAPES]
    for (B, H, N, D, F), dtypes in cases:
        for name, dtype in dtypes:
            q, k, v, omega, c = _fused_inputs(B, H, N, D, F, dtype)
            for kind in ("favor_plus", "relu"):
                out, den = mlc.kerple_attention_fused_phi_fwd(q, k, v, omega, c, kind)
                # twice: out and den bit for bit (every sum in a fixed order)
                again = mlc.kerple_attention_fused_phi_fwd(q, k, v, omega, c, kind)
                torch.cuda.synchronize()
                shape = f"B{B} H{H} N{N} D{D} F{F} {kind} {name}"
                same = torch.equal(out, again[0]) and torch.equal(den, again[1])
                log("kernel", f"{kname} {shape}: out and den bitwise on a rerun: {same}")
                if not same:
                    raise AssertionError(f"the fused-phi forward is not bitwise the same on a "
                                         f"rerun at {shape}")
                del again
                ref_out, ref_den = mlc.kerple_attention_fused_phi_fwd_reference(
                    q, k, v, omega, c, kind)
                rtol, atol = OUT_TOL[name]
                err = (out.float() - ref_out.float()).abs()
                ok_out = bool((err <= atol + rtol * ref_out.float().abs()).all())
                den_rel = ((den - ref_den).abs() / ref_den.abs().clamp_min(1e-30)).max().item()
                finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(den).all())
                log("kernel", f"{kname} {shape}: max|out err| {err.max().item():.3e} "
                    f"(rtol {rtol}, atol {atol}), max den rel err {den_rel:.3e} (rtol "
                    f"{FUSED_DEN_RTOL[name]:.3e}), finite {finite}")
                if not (ok_out and den_rel <= FUSED_DEN_RTOL[name] and finite):
                    raise AssertionError(f"fused-phi kernel disagrees with its plain version "
                                         f"at {shape}")
                # timed at the serving and training shapes, bf16 phi+
                if (B, H, N, D, F) not in FUSED_SHAPES[:2] or name != "bfloat16" \
                        or kind != "favor_plus":
                    continue
                ms = kernel_ms(lambda: mlc.kerple_attention_fused_phi_fwd(q, k, v, omega, c))
                plain_ms = time_ms(lambda: mlc.kerple_attention_fused_phi_fwd_reference(
                    q, k, v, omega, c), iters=5, warmup=1)
                unfused_ms = kernel_ms(lambda: mlc.masked_linear_attention_coeffs_fwd(
                    phi_positive(q, omega), phi_positive(k, omega), v, c))
                bound_ms, bound_by = fused_phi_bound(B, H, N, D, F, name)
                log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, unfused route (2 x phi_positive + "
                    f"masked_linear_coeffs_fwd) {unfused_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}), kernel/bound {ms / bound_ms:.2f}x, unfused/kernel "
                    f"{unfused_ms / ms:.2f}x")
                results[(name, B)] = dict(max_abs_err=err.max().item(), ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by, library_ms=None,
                                          unfused_ms=unfused_ms,
                                          launch=infos[(name, F)])
    return results


def phi_bounds(B, H, N, D, F):
    """{kernel: (bound_ms, bound_by)} for the phi+ forward (x read, phi
    written, Omega read once per SM) and backward (x and g read, dx
    written), bf16 tensors; the products as the kernels run them on bf16
    tensor cores: three passes of 2 B H N D F forward, three (the
    recompute) plus six (dz Omega^T) backward."""
    bhn, flops = B * H * N, 2 * B * H * N * D * F
    omega_bytes = 4 * H * D * F
    work = {"phi_positive_fwd": (2 * bhn * (D + F) + omega_bytes, 3 * flops),
            "phi_positive_bwd": (2 * bhn * (2 * D + F) + omega_bytes, 9 * flops)}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bfloat16"]
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _phi_inputs(B, H, N, D, F):
    """x as the flagship hands phi q and k (L2-normalised rows, bf16, the
    head split's [B, N, H, D] layout seen as [B, H, N, D]), orthogonal Omega
    [H, D, F] (fp32) and a bf16 cotangent."""
    from efficient_rpe_vit_torch.ops.feature_maps import orthogonal_gaussian_features

    g = torch.Generator(device="cuda").manual_seed(B * 7919 + N * 31 + D + F)
    x = _unit_rows(torch.randn(B, N, H, D, generator=g, device="cuda")).to(torch.bfloat16)
    omega = orthogonal_gaussian_features(g, H, D, F)
    cot = (torch.randn(B, H, N, F, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    return x.transpose(1, 2), omega, cot


def _bf16_steps(got, want) -> float:
    """The largest |got - want| in bf16 steps (ulps) of want."""
    want = want.float()
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got.float() - want).abs() / step).max().item()


def check_phi_kernels(pk, shapes, timed: bool):
    """Phase 26 a: the phi+ forward and backward kernels against the plain
    chain on the card. Per shape: phi within one bf16 step of the plain
    phi, and bitwise on a rerun; the kernels' products u = x Omega and
    dz Omega^T against fp64 within PHI_PRODUCT_RATIO of cuBLAS fp32's error
    (dz formed on the host from the kernel's own u, as the backward forms
    it); dx within PHI_DX_TOL of
    the plain chain's backward, bitwise on a rerun. Timed (`timed`) beside
    phi_bounds, the plain forward and the plain forward + backward. Returns
    {(kernel, shape): row}."""
    from efficient_rpe_vit_torch.ops.feature_maps import phi_positive_plain

    rows = {}
    for B, H, N, D, F in shapes:
        x, omega, cot = _phi_inputs(B, H, N, D, F)
        shape = f"B{B} H{H} N{N} D{D} F{F}"
        phi = pk.phi_positive_fwd(x, omega)
        same = torch.equal(phi, pk.phi_positive_fwd(x, omega))
        plain = phi_positive_plain(x, omega)
        steps = _bf16_steps(phi, plain)
        differ = (phi != plain).float().mean().item()
        log("phi", f"phi_positive_fwd {shape}: {steps:.2f} bf16 steps at most from the plain "
            f"chain, {100 * differ:.4f}% of elements differ, bitwise on a rerun: {same}")
        if steps > 1.0 or not same or not bool(torch.isfinite(phi.float()).all()):
            raise AssertionError(f"phi_positive_fwd disagrees with the plain chain at {shape}")
        del plain
        # the products: the kernel's against fp64 beside cuBLAS fp32's
        u = pk.kernel_products(x, omega)
        want = torch.matmul(x.double(), omega.double())
        err_k = (u.double() - want).abs().max().item()
        err_32 = (torch.matmul(x.float(), omega).double() - want).abs().max().item()
        del want
        nh = (x * x).sum(dim=-1, keepdim=True) / 2.0
        mx = u.amax(dim=-1, keepdim=True)
        dz = (cot.float() * pk.scale_of(F)) * torch.exp(u - mx - nh)
        del u, mx
        p = pk.kernel_products(x, omega, dz)
        want = torch.matmul(dz.double(), omega.double().transpose(-1, -2))
        berr_k = (p.double() - want).abs().max().item()
        berr_32 = (torch.matmul(dz, omega.transpose(-1, -2)).double() - want).abs().max().item()
        del want, dz, p
        log("phi", f"products {shape}: u = x Omega max err vs fp64 {err_k:.3e} (cuBLAS fp32 "
            f"{err_32:.3e}, {err_k / err_32:.2f}x); dz Omega^T {berr_k:.3e} (cuBLAS fp32 "
            f"{berr_32:.3e}, {berr_k / berr_32:.2f}x; tol {PHI_PRODUCT_RATIO}x)")
        if err_k > PHI_PRODUCT_RATIO * err_32 or berr_k > PHI_PRODUCT_RATIO * berr_32:
            raise AssertionError(f"the phi+ kernels' products lose fp32 accuracy at {shape}")
        dx = pk.phi_positive_bwd(cot, x, omega)
        same = torch.equal(dx, pk.phi_positive_bwd(cot, x, omega))
        ref = pk.phi_positive_bwd_reference(cot, x, omega)
        rel = _max_rel(dx, ref)
        differ = (dx != ref).float().mean().item()
        log("phi", f"phi_positive_bwd {shape}: max|dx - plain| / max|plain| {rel:.3e} (tol "
            f"{PHI_DX_TOL:.3e}), {100 * differ:.4f}% of elements differ, strides "
            f"{tuple(dx.stride())} (x {tuple(x.stride())}), bitwise on a rerun: {same}")
        if rel > PHI_DX_TOL or not same or dx.stride() != x.stride():
            raise AssertionError(f"phi_positive_bwd disagrees with the plain chain at {shape}")
        del ref
        if not timed:
            continue
        bounds = phi_bounds(B, H, N, D, F)
        fwd_ms = kernel_ms(lambda: pk.phi_positive_fwd(x, omega))
        bwd_ms = kernel_ms(lambda: pk.phi_positive_bwd(cot, x, omega))
        xg = x.detach().requires_grad_(True)

        def plain_step():
            torch.autograd.backward(phi_positive_plain(xg, omega), cot)

        plain_fwd_ms = time_ms(lambda: phi_positive_plain(x, omega), iters=5, warmup=1)
        plain_both_ms = time_ms(plain_step, iters=5, warmup=1)
        for name, ms, plain_ms in (("phi_positive_fwd", fwd_ms, plain_fwd_ms),
                                   ("phi_positive_bwd", bwd_ms, plain_both_ms - plain_fwd_ms)):
            bound_ms, bound_by = bounds[name]
            log("phi", f"{name} {shape}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), kernel/bound {ms / bound_ms:.2f}x; plain chain {plain_ms:.4f} "
                f"ms ({plain_ms / ms:.1f}x the kernel)")
            rows[(name, (B, H, N, D, F))] = dict(
                max_abs_err=(phi.float() - phi_positive_plain(x, omega).float()).abs().max()
                .item() if name == "phi_positive_fwd" else rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=[B, H, N, D, F], product_err_ratio=(err_k / err_32 if name ==
                                                          "phi_positive_fwd"
                                                          else berr_k / berr_32))
        log("phi", f"phi+ {shape}: forward + backward {fwd_ms + bwd_ms:.4f} ms against the "
            f"plain chain's {plain_both_ms:.4f} ms; per flagship step (2 x 12 layers) "
            f"{24 * (fwd_ms + bwd_ms):.2f} ms against {24 * plain_both_ms:.2f} ms")
        del xg
    return rows


def phi_train_launches(pk, card: str):
    """Phase 26 b: eager train steps on the card. The flagship at PHI_TRAIN
    (ViT-B/16, batch 128, N=197) launches 24 phi+ forwards and 24 backwards
    a step and never runs the plain chain on a CUDA tensor; its loss and
    gradients agree with a twin whose phi takes the plain chain (GRAD_REL_TOL
    on each tensor's norm), and its step time is logged beside the twin's.
    Then each of PHI_VARIANTS at depth 2 launches 4 of each. Returns the
    flagship's launches a step."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.ops import feature_maps
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    wrappers = {"phi_positive_fwd": pk.phi_positive_fwd, "phi_positive_bwd": pk.phi_positive_bwd}
    plain = feature_maps.phi_positive_plain
    on_card = [0]

    def counted_plain(x, omega):
        on_card[0] += int(x.is_cuda)
        return plain(x, omega)

    def run(name, fields, force_plain=False, timed=0):
        cfg = mnist_config(**fields)
        model = create_model(name, cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        step = make_train_step(model)
        state = create_train_state(model, cfg, steps_per_epoch=100)
        g = torch.Generator(device="cuda").manual_seed(2)
        size, batch = fields["image_size"], fields["batch_size"]
        x = torch.randn(batch, size, size, fields["in_channels"], generator=g, device="cuda")
        y = torch.randint(0, fields["num_classes"], (batch,), generator=g, device="cuda")
        saved = feature_maps.phi_kernel_takes
        if force_plain:
            feature_maps.phi_kernel_takes = lambda *a, **k: False  # noqa: E731
        feature_maps.phi_positive_plain = counted_plain
        try:
            zero_counts(wrappers)
            on_card[0] = 0
            state, loss, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            launches, plain_calls = counts(wrappers), on_card[0]
            grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
            ms = None
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(timed):
                    state, _, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(3))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / timed * 1e3
        finally:
            feature_maps.phi_kernel_takes = saved
            feature_maps.phi_positive_plain = plain
        del model, state
        return launches, plain_calls, loss.item(), grads, ms

    depth = PHI_TRAIN["depth"]
    torch.cuda.reset_peak_memory_stats()
    launches, plain_calls, loss, grads, ms = run("performer_favor_most_general", PHI_TRAIN,
                                                 timed=3)
    peak = torch.cuda.max_memory_allocated()
    want = {n: 2 * depth for n in wrappers}
    log("phi", f"flagship train step (batch {PHI_TRAIN['batch_size']}, N=197): launches "
        f"{launches} (expected {want}), plain chain on CUDA tensors {plain_calls} times, "
        f"loss {loss:.6f}, {ms:.2f} ms/step eager, peak {peak / 2**30:.3f} GiB")
    if launches != want or plain_calls:
        raise AssertionError(f"flagship step: phi+ launches {launches}, plain calls "
                             f"{plain_calls}; expected {want} and none")
    torch.cuda.reset_peak_memory_stats()
    p_launches, p_calls, p_loss, p_grads, p_ms = run("performer_favor_most_general", PHI_TRAIN,
                                                     force_plain=True, timed=3)
    p_peak = torch.cuda.max_memory_allocated()
    rel = {n: ((grads[n] - p_grads[n]).norm() / p_grads[n].norm().clamp_min(1e-30)).item()
           for n in grads}
    worst = max(rel, key=rel.get)
    log("phi", f"plain twin: launches {p_launches}, plain calls {p_calls}, loss {p_loss:.6f} "
        f"(rel gap {abs(loss - p_loss) / abs(p_loss):.3e}), {p_ms:.2f} ms/step eager, peak "
        f"{p_peak / 2**30:.3f} GiB; gradients: worst {worst} {rel[worst]:.3e}, median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (tol {GRAD_REL_TOL}) on {card}")
    if rel[worst] > GRAD_REL_TOL or abs(loss - p_loss) > 1e-2 * abs(p_loss) or any(
            p_launches.values()):
        raise AssertionError("the flagship's step on the phi+ kernels disagrees with the plain "
                             "chain's")
    del grads, p_grads
    small = dict(PHI_TRAIN, depth=2, batch_size=8)
    for name in PHI_VARIANTS:
        got, calls, vloss, _, _ = run(name, small)
        log("phi", f"{name} depth 2: launches {got}, plain calls on CUDA {calls}, loss "
            f"{vloss:.6f}")
        if got != {n: 4 for n in wrappers} or calls or not math.isfinite(vloss):
            raise AssertionError(f"{name}: phi+ launches {got}, plain calls {calls}")
    return launches


def phi_phase(card: str):
    """Phase 26: the phi+ kernels. launch_info at the flagship's (F, D) =
    (266, 64) and the narrow (44, 16) (no spills at F=266), the built rule
    against `phi_kernel_takes` over a grid of (D, F), the kernels against
    the plain chain (check_phi_kernels) and in train steps
    (phi_train_launches). Returns (rows of the kernels line, the flagship
    step's launches)."""
    from efficient_rpe_vit_torch.ops.feature_maps import phi_kernel_takes
    from efficient_rpe_vit_torch.ops.kernels import phi_positive as pk

    for kernel in pk._KINDS:
        for F, D in ((266, 64), (44, 16)):
            info = pk.launch_info(kernel, F, D)
            log("phi", f"{kernel} F={F} D={D}: {info}")
            if F == 266 and info["spill_bytes"]:
                raise AssertionError(f"{kernel} spills {info['spill_bytes']} bytes at F=266")
    for D in (0, 8, 16, 24, 40, 60, 64, 72):
        for F in (1, 2, 44, 64, 65, 266, 272, 273, 274):
            x = torch.empty(1, 2, 3, D, dtype=torch.bfloat16, device="cuda")
            om = torch.empty(2, D, F, device="cuda")
            if bool(pk.kernel_rule(D, F)) != phi_kernel_takes(x, om):
                raise AssertionError(f"the built rule and phi_kernel_takes differ at D={D} F={F}")
    log("phi", "the built (D, F) rule equals phi_kernel_takes on a grid of 72 points")
    rows = check_phi_kernels(pk, PHI_SHAPES, timed=True)
    check_phi_kernels(pk, PHI_EDGE_SHAPES, timed=False)
    return rows, phi_train_launches(pk, card)


def flash_bound(B, H, N, D, dtype: str):
    """(bound_ms, bound_by) for one flash forward: q, k, v read once, out
    and lse written once; the two products S = q k^T and P v (the softmax's
    exp, max and sums, and the dropout hash, are not counted)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * 4 * B * H * N * D + 4 * B * H * N
    ops = 2 * 2 * B * H * N * N * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bwd_bounds(B, H, N, D, dtype: str):
    """{kernel: (bound_ms, bound_by)} for the flash backward kernels: each
    reads q, k, v, g in the input dtype and lse, delta in fp32 once and
    writes its gradients once; products of 2 B H N^2 D operations each:
    S, dP, dv, dk, dq for the fused pass, S, dP, dq for the dq pass, S,
    dP, dv, dk for the dkv pass."""
    elt = 2 if dtype == "bfloat16" else 4
    bhnd, rows = B * H * N * D, 8 * B * H * N
    product = 2 * B * H * N * N * D
    out = {}
    for name, n_out, n_products in (("flash_bwd_fused", 3, 5), ("flash_bwd_dq", 1, 3),
                                    ("flash_bwd_dkv", 2, 4)):
        t_bytes = (elt * bhnd * (4 + n_out) + rows) / HBM_BYTES_PER_S
        t_ops = n_products * product / PEAK_OPS_PER_S[dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _flash_inputs(B, H, N, D, mask_kind, rate, dtype):
    """q, k, v, cotangent, mask (diagonal kept) and seed for a flash case."""
    g = torch.Generator(device="cuda").manual_seed(N * 100 + D + B)
    q, k, v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
                    for _ in range(4))
    mask = None
    if mask_kind is not None:
        hm = 1 if mask_kind == "B1NN" else H
        mask = torch.rand(B, hm, N, N, generator=g, device="cuda") > 0.3
        mask |= torch.eye(N, dtype=torch.bool, device="cuda")  # every row keeps a cell
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda") if rate else None
    return q, k, v, cot, mask, seed


def _sdpa_ms(q, k, v, cot):
    """(forward ms, backward ms) of scaled_dot_product_attention at these
    inputs, from CUDA-graph replays; the backward is the replay of forward
    and backward together less the forward's."""
    fwd_ms = kernel_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg)
        return torch.autograd.grad(out, (qg, kg, vg), cot)

    return fwd_ms, kernel_ms(fwd_bwd) - fwd_ms


def flash_launch_info(fa):
    """{(kernel, N): launch_info} of the bf16 flash kernels at the main
    paths' N (D=64), logged: rows per block, threads, shared memory, blocks
    per SM, registers and spilled bytes."""
    out = {}
    for n in (197, LONGN_N):
        for kname in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
            if kname == "flash_bwd_fused" and not fa.fused_fits(n, 64, torch.bfloat16):
                continue
            info = fa.launch_info(kname, n, 64, torch.bfloat16)
            out[(kname, n)] = info
            log("kernel", f"{kname} N={n} D=64 bfloat16: " + ", ".join(
                f"{key} {value}" for key, value in info.items()))
    return out


def check_flash_keep_mask(fa):
    """The dropout keep-mask the kernels use, read out of their results, is
    dropout_keep_dense's bit for bit. With q = k = 0 every probability is
    1/N, so out[:, :, i, j - c0] = P'[i, j] / l for one-hot values v_j =
    e_(j - c0) over a window of D = 64 columns, and dv[:, :, j, i - c0] =
    P'[i, j] for one-hot cotangents g_i = e_(i - c0) over 64 rows: nonzero
    exactly where the cell is kept. Forward, fused and dkv passes."""
    B, H, N, D, rate = 2, 3, 197, 64, 0.1
    seed = torch.tensor([-7], dtype=torch.int32, device="cuda")
    want = fa.dropout_keep_dense(seed, B, H, N, N, rate)
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        zeros = torch.zeros(B, H, N, D, dtype=dtype, device="cuda")
        got = {"fwd": torch.zeros(B, H, N, N, dtype=torch.bool, device="cuda")}
        got["fused"], got["dkv"] = torch.zeros_like(got["fwd"]), torch.zeros_like(got["fwd"])
        out0, lse0 = fa.flash_attention_fwd(zeros, zeros, zeros, 1.0, None, rate, seed)
        for c0 in range(0, N, D):
            w = min(D, N - c0)
            onehot = torch.zeros(N, D, dtype=dtype, device="cuda")
            onehot[c0:c0 + w, :w] = torch.eye(w, dtype=dtype, device="cuda")
            onehot = onehot.expand(B, H, N, D).contiguous()
            out, _ = fa.flash_attention_fwd(zeros, zeros, onehot, 1.0, None, rate, seed)
            got["fwd"][..., c0:c0 + w] = out[..., :w] != 0
            # rows c0..c0+w of P' through dv = P'^T g
            delta = fa.flash_delta(out0, onehot)
            dv = fa.flash_attention_bwd_fused(zeros, zeros, zeros, onehot, lse0, delta, 1.0,
                                              None, rate, seed)[2]
            got["fused"][..., c0:c0 + w, :] = (dv[..., :w] != 0).transpose(-1, -2)
            dv = fa.flash_attention_bwd_dkv(zeros, zeros, zeros, onehot, lse0, delta, 1.0,
                                            None, rate, seed)[1]
            got["dkv"][..., c0:c0 + w, :] = (dv[..., :w] != 0).transpose(-1, -2)
        torch.cuda.synchronize()
        for kernel, mask in got.items():
            differ = int((mask != want).sum())
            log("kernel", f"dropout keep-mask of {kernel} B{B} H{H} N{N} rate {rate} {name}: "
                f"{differ} of {mask.numel()} cells differ from dropout_keep_dense "
                f"(kept share {mask.float().mean().item():.4f})")
            if differ:
                raise AssertionError(f"{kernel} drops other cells than dropout_keep_dense")


def check_flash_kernels(fa):
    """Phase 3c: the four flash kernels against their plain versions on the
    card. Returns {(kernel, path): row} for the main paths' shapes."""
    infos = flash_launch_info(fa)
    check_flash_keep_mask(fa)
    results = {}
    cases = [(c, name, dtype) for c in FLASH_CASES for name, dtype in
             (("bfloat16", torch.bfloat16), ("float32", torch.float32))]
    cases += [(c, "bfloat16", torch.bfloat16) for c in FLASH_EDGE_CASES]
    cases.append((FLASH_LONGN, "bfloat16", torch.bfloat16))
    wrappers = flash_wrappers(fa)
    for (B, H, N, D, mask_kind, rate), name, dtype in cases:
        q, k, v, cot, mask, seed = _flash_inputs(B, H, N, D, mask_kind, rate, dtype)
        scale = D ** -0.5
        shape = f"B{B} H{H} N{N} D{D} mask {mask_kind} dropout {rate} {name}"
        tol = FLASH_TOL[name]
        out, lse = fa.flash_attention_fwd(q, k, v, scale, mask, rate, seed)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_softmax_attention_reference(q, k, v, scale, mask, rate, seed)
        rel = _max_rel(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        log("kernel", f"flash_fwd {shape}: out max|err|/max|plain| {rel:.3e} (tol {tol}), "
            f"lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}")
        if not (finite and rel <= tol and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash_fwd disagrees with its plain version at {shape}")
        fwd_err = (out.float() - ref_out.float()).abs().max().item()

        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, cot, scale, mask, rate, seed)
        long_n = (B, H, N, D, mask_kind, rate) == FLASH_LONGN
        # both strategies forced where the fused kernel fits, else its own choice
        fits = fa.fused_fits(N, D, dtype)
        bwd_errs = {}  # fused choice -> max|err| of (dq, dk, dv)
        if fits and name == "bfloat16":
            kind = fa.launch_info("flash_bwd_fused", N, D, dtype)["kernel"]
            want_kind = "mma.sync" if N <= FUSED_MMA_MAX_N and 32 < D <= 64 else "staged"
            log("kernel", f"flash_bwd_fused at N={N} D={D} bfloat16 runs the {kind} kernel")
            if kind != want_kind:
                raise AssertionError(f"the fused pass at N={N} D={D} runs the {kind} kernel, "
                                     f"expected the {want_kind} one")
        for fused in ((True, False) if fits else (None,)):
            before = counts(wrappers)
            got = fa.flash_attention_bwd(q, k, v, out, lse, cot, scale, mask, rate, seed,
                                         fused=fused)
            torch.cuda.synchronize()
            ran = {n: c - before[n] for n, c in counts(wrappers).items() if c != before[n]}
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            log("kernel", f"flash backward (fused={fused}, launched {ran}) {shape}: (dq, dk, dv) "
                f"max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), "
                f"finite {finite}")
            if not (finite and max(rels) <= tol):
                raise AssertionError(f"the flash backward disagrees with its plain version at {shape}")
            bwd_errs[fused] = [(a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)]
            if not fits and set(ran) != {"flash_bwd_dq", "flash_bwd_dkv"}:
                raise AssertionError(f"at N={N} D={D} the backward should take the "
                                     f"two-pass split, ran {ran}")
        # timed at the main paths' shapes: serve (B=32) and train (B=64)
        # without dropout, long-N training with dropout 0.1
        path = {(VITB["batch_size"], 197): "baseline_serve",
                (TRAIN_BATCH, 197): "baseline_train",
                (FLASH_LONGN[0], LONGN_N): "baseline_longn_train"}.get((B, N))
        if name != "bfloat16" or mask_kind is not None or path is None:
            continue
        plain_iters = 1 if long_n else 5
        delta = fa.flash_delta(out, cot)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, cot)
        log("kernel", f"scaled_dot_product_attention {shape.replace(f'dropout {rate}', 'dropout 0.0')}: "
            f"forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms")
        bwd_bounds = flash_bwd_bounds(B, H, N, D, name)
        bwd_args = (q, k, v, cot, lse, delta, scale, None, rate, seed)
        timed = {"flash_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, scale, None, rate, seed),
            lambda: fa.flash_softmax_attention_reference(q, k, v, scale, None, rate, seed),
            flash_bound(B, H, N, D, name), lib_fwd, fwd_err)}
        if path == "baseline_train":
            timed["flash_bwd_fused"] = (
                lambda: fa.flash_attention_bwd_fused(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args),
                bwd_bounds["flash_bwd_fused"], lib_bwd, max(bwd_errs[True]))
        if path == "baseline_longn_train":
            timed["flash_bwd_dq"] = (
                lambda: fa.flash_attention_bwd_dq(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args)[0],
                bwd_bounds["flash_bwd_dq"], lib_bwd, bwd_errs[None][0])
            timed["flash_bwd_dkv"] = (
                lambda: fa.flash_attention_bwd_dkv(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args)[1:],
                bwd_bounds["flash_bwd_dkv"], lib_bwd, max(bwd_errs[None][1:]))
        extra = {}  # kernel -> further keys of its row
        if path == "baseline_train":
            # the two-pass split at the shape where the dispatch picks the
            # fused pass: whether the fused kernel still earns its place
            split = {kname: kernel_ms(lambda fn=fn: fn(*bwd_args)) for kname, fn in (
                ("flash_bwd_dq", fa.flash_attention_bwd_dq),
                ("flash_bwd_dkv", fa.flash_attention_bwd_dkv))}
            log("kernel", f"two-pass split {shape}: dq {split['flash_bwd_dq']:.4f} ms + dkv "
                f"{split['flash_bwd_dkv']:.4f} ms = "
                f"{split['flash_bwd_dq'] + split['flash_bwd_dkv']:.4f} ms (the fused pass runs here)")
            extra["flash_bwd_fused"] = {"split_ms": split}
        if path == "baseline_longn_train":
            # like for like with SDPA, which is timed without dropout
            no_drop_args = (q, k, v, cot, lse, delta, scale)
            for kname, fn in (("flash_fwd", lambda: fa.flash_attention_fwd(q, k, v, scale)),
                              ("flash_bwd_dq", lambda: fa.flash_attention_bwd_dq(*no_drop_args)),
                              ("flash_bwd_dkv",
                               lambda: fa.flash_attention_bwd_dkv(*no_drop_args))):
                ms0 = kernel_ms(fn)
                log("kernel", f"{kname} {shape.replace(f'dropout {rate}', 'dropout 0.0')}: "
                    f"kernel {ms0:.4f} ms (the dropout hash's share is the difference)")
                extra[kname] = {"ms_dropout0": ms0}
        for kname, (kernel_fn, plain_fn, (bound_ms, bound_by), library_ms, err) in timed.items():
            ms = kernel_ms(kernel_fn)
            plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=0 if long_n else 1)
            log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"kernel/bound {ms / bound_ms:.2f}x")
            results[(kname, path)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          library_ms=library_ms,
                                          launch=infos[(kname, N)],
                                          **extra.get(kname, {}))
    return results


def sam_bias_inputs(B, H, N, D, kh, kw):
    """bf16 q, k, v, cotangent and fp32 bias rows (rel_h, rel_w) of unit
    scale for one of SAM's attention calls: a bias that moves every score
    by O(1), so that a kernel that drops either term is far off."""
    g = torch.Generator(device="cuda").manual_seed(N * 100 + D + B)
    q, k, v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(4))
    rel_h = torch.randn(B, H, N, kh, generator=g, device="cuda")
    rel_w = torch.randn(B, H, N, kw, generator=g, device="cuda")
    return q, k, v, cot, (rel_h, rel_w)


def _sdpa_bias_ms(q, k, v, cot, rel, scale):
    """(forward ms, backward ms) of the library route to the same function:
    the bias materialised as a [B, H, N, N] bf16 mask from the two row
    blocks, then scaled_dot_product_attention; the backward's gradient of
    the mask summed back onto the rows. Timed eagerly (CUDA events), as
    the plain versions are; (None, None) where the library refuses it."""
    B, H, N, _ = q.shape
    kh, kw = rel[0].shape[-1], rel[1].shape[-1]

    def bias(rel_h, rel_w):
        return (rel_h[..., :, None] + rel_w[..., None, :]).view(B, H, N, N).to(q.dtype)

    leaves = [t.detach().requires_grad_() for t in (q, k, v, *rel)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=bias(*leaves[3:]),
                                             scale=scale)
        return torch.autograd.grad(out, leaves, cot)

    try:
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias(*rel), scale=scale), iters=10, warmup=2)
        return fwd_ms, time_ms(fwd_bwd, iters=10, warmup=2) - fwd_ms
    except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
        log("sam", f"scaled_dot_product_attention with a float mask at {tuple(q.shape)}: "
            f"refused ({str(err).splitlines()[0][:200]})")
        return None, None


def check_sam_bias_kernels(fa):
    """Phase 27 a-b: the bias kernels (#6r, 7r) at SAM_SHAPES against the
    plain versions on the same card tensors; the no-bias kernels at the same
    (B, H, N, D = 80) too. Returns {(kernel, path): row}."""
    from perfbench import spec
    from perfbench.counts import sam as sam_counts

    cell = spec.load_cell(SAM_CELL)
    peak = {"bfloat16_flops_per_s": PEAK_OPS_PER_S["bfloat16"],
            "float32_flops_per_s": PEAK_OPS_PER_S["float32"],
            "hbm_bytes_per_s": HBM_BYTES_PER_S}
    least = sam_counts.op_least_seconds(cell.config, cell.mix, peak)
    wrappers = flash_wrappers(fa)
    tol = FLASH_TOL["bfloat16"]
    rows = {}
    for path, (B, H, N, D, kh, kw) in SAM_SHAPES.items():
        shape = f"B{B} H{H} N{N} D{D} grid {kh}x{kw} bfloat16"
        infos = {}
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            infos[kname] = info = fa.launch_info(kname, N, D, torch.bfloat16, (kh, kw))
            log("sam", f"{kname} with the bias at {shape}: " + ", ".join(
                f"{key} {value}" for key, value in info.items()))
            if info["kernel"] != "mma.sync" or info["spill_bytes"]:
                raise AssertionError(f"{kname} with the bias at {shape} runs the "
                                     f"{info['kernel']} kernel, {info['spill_bytes']} B spilled")
        q, k, v, cot, rel = sam_bias_inputs(B, H, N, D, kh, kw)
        scale = D ** -0.5
        zero_h, zero_w = (torch.zeros_like(rel[0]), rel[1]), (rel[0], torch.zeros_like(rel[1]))

        out, lse = fa.flash_attention_fwd(q, k, v, scale, rel_pos=rel)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_softmax_attention_reference(q, k, v, scale, rel_pos=rel)
        rel_out = _max_rel(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        dropped = {name: _max_rel(out, fa.flash_softmax_attention_reference(
            q, k, v, scale, rel_pos=r)[0]) for name, r in (("rel_h", zero_h), ("rel_w", zero_w))}
        log("sam", f"flash_fwd with the bias {shape}: out max|err|/max|plain| {rel_out:.3e} "
            f"(tol {tol}), lse max|err| {lse_err:.3e} (tol {LSE_ATOL}); against the plain "
            f"version without rel_h {dropped['rel_h']:.3e}, without rel_w {dropped['rel_w']:.3e}")
        if not (rel_out <= tol and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash_fwd with the bias disagrees with its plain version "
                                 f"at {shape}")
        if min(dropped.values()) <= tol:
            raise AssertionError(f"the forward check at {shape} would pass a kernel that "
                                 f"drops a bias term")
        fwd_err = (out.float() - ref_out.float()).abs().max().item()

        delta = fa.flash_delta(out, cot)
        zero_counts(wrappers)
        got = fa.flash_attention_bwd(q, k, v, out, lse, cot, scale, rel_pos=rel)
        again = fa.flash_attention_bwd(q, k, v, out, lse, cot, scale, rel_pos=rel)
        torch.cuda.synchronize()
        ran = counts(wrappers)
        names = ("dq", "dk", "dv", "d rel_h", "d rel_w")
        want = fa.flash_bwd_reference(q, k, v, cot, lse, delta, scale, rel_pos=rel)
        rels = [_max_rel(a, b) for a, b in zip(got, want)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        log("sam", f"flash backward with the bias {shape} (launched {ran}): "
            + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels))
            + f" max|err|/max|plain| (tol {tol}); bitwise on a rerun {bitwise}")
        if max(rels) > tol or not bitwise or ran != {
                "flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}:
            raise AssertionError(f"the backward with the bias disagrees with its plain "
                                 f"version at {shape}, or ran {ran}")
        for name, r in (("rel_h", zero_h), ("rel_w", zero_w)):
            off = [_max_rel(a, b) for a, b in zip(got[:3], fa.flash_bwd_reference(
                q, k, v, cot, lse, delta, scale, rel_pos=r)[:3])]
            log("sam", f"  (dq, dk, dv) against the plain backward without {name}: "
                + ", ".join(f"{x:.3e}" for x in off))
            if max(off) <= tol:
                raise AssertionError(f"the backward check at {shape} would pass a kernel "
                                     f"that drops {name}")
        bwd_errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        del again, want

        # the same call without the bias, D = 80 (fused where it fits, then
        # the two passes), against its plain version
        base_out, base_lse = fa.flash_attention_fwd(q, k, v, scale)
        base_ref = fa.flash_softmax_attention_reference(q, k, v, scale)[0]
        base_want = fa.flash_attention_bwd_reference(q, k, v, base_out, base_lse, cot, scale)
        fits = fa.fused_fits(N, D, torch.bfloat16)
        for fused in ((True, False) if fits else (False,)):
            base = fa.flash_attention_bwd(q, k, v, base_out, base_lse, cot, scale, fused=fused)
            errs = [_max_rel(a, b) for a, b in zip(base, base_want)]
            log("sam", f"without the bias {shape}: out {_max_rel(base_out, base_ref):.3e}, "
                f"(dq, dk, dv) fused={fused} " + ", ".join(f"{e:.3e}" for e in errs))
            if max(errs + [_max_rel(base_out, base_ref)]) > tol:
                raise AssertionError(f"the no-bias kernels disagree at {shape}")
        del base_ref, base_want, base

        plain_iters, warmup = (1, 0) if N > 1024 else (5, 1)
        args = (q, k, v, cot, lse, delta, scale)
        base_delta = fa.flash_delta(base_out, cot)
        base_args = (q, k, v, cot, base_lse, base_delta, scale)
        lib_fwd, lib_bwd = _sdpa_bias_ms(q, k, v, cot, rel, scale)
        call = least["window" if path == "sam_window_train" else "global"]
        bounds = {"flash_fwd": (call["forward"] * 1e3, "the call's forward"),
                  "flash_bwd_dq": (call["backward"] * 1e3, "the call's backward (dq + dkv)"),
                  "flash_bwd_dkv": (call["backward"] * 1e3, "the call's backward (dq + dkv)")}
        timed = {
            "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale, rel_pos=rel),
                          lambda: fa.flash_softmax_attention_reference(q, k, v, scale,
                                                                       rel_pos=rel),
                          lambda: fa.flash_attention_fwd(q, k, v, scale), lib_fwd, fwd_err),
            "flash_bwd_dq": (lambda: fa.flash_attention_bwd_dq(*args, rel_pos=rel),
                             lambda: fa.flash_bwd_reference(*args, rel_pos=rel),
                             lambda: fa.flash_attention_bwd_dq(*base_args), lib_bwd,
                             max(bwd_errs[:1] + bwd_errs[3:])),
            "flash_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(*args, rel_pos=rel),
                              lambda: fa.flash_bwd_reference(*args, rel_pos=rel),
                              lambda: fa.flash_attention_bwd_dkv(*base_args), lib_bwd,
                              max(bwd_errs[1:3]))}
        for kname, (kernel_fn, plain_fn, base_fn, library_ms, err) in timed.items():
            ms, base_ms = kernel_ms(kernel_fn), kernel_ms(base_fn)
            plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=warmup)
            bound_ms, bound_of = bounds[kname]
            lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
            log("sam", f"{kname} with the bias {shape}: kernel {ms:.4f} ms (without the bias "
                f"{base_ms:.4f}), plain {plain_ms:.4f} ms, SDPA with a float mask {lib}, "
                f"bound {bound_ms:.4f} ms ({bound_of}, counts/sam.py)")
            rows[(kname, path)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_of, library_ms=library_ms, no_bias_ms=base_ms,
                shape=[B, H, N, D, kh, kw], launch=infos[kname])
        del q, k, v, cot, rel, out, got
        torch.cuda.empty_cache()
    return rows


def sam_train_launches(fa, card: str):
    """Phase 27 c: one eager train step of SAM's ViT-H (`create_model(
    "sam_vit_h")`, bf16, batch SAM_TRAIN_BATCH at 1024 x 1024) with the
    flash wrappers' counts zeroed just before it: 28 windowed and 4 global
    launches each of the forward, dq and dkv bias kernels, and no other
    flash launch; a finite loss and finite gradients, the tables' nonzero.
    Returns the step's launches by wrapper, and by kernel and N."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    cfg = mnist_config(image_size=1024, patch_size=16, in_channels=3, num_classes=1000,
                       batch_size=SAM_TRAIN_BATCH, compute_dtype="bfloat16", dropout=0.0)
    model = create_model("sam_vit_h", cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # SAM's zero tables would keep the bias rows at 0
        for name, p in model.named_parameters():
            if "rel_pos" in name:
                p.normal_(0.0, 0.02)
    step = make_train_step(model)
    state = create_train_state(model, cfg, steps_per_epoch=100)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(SAM_TRAIN_BATCH, 1024, 1024, 3, generator=g, device="cuda")
    y = torch.randint(0, 1000, (SAM_TRAIN_BATCH,), generator=g, device="cuda")
    wrappers = flash_wrappers(fa)
    by_kernel = {}
    real_launch = fa.launch

    def recording(errors, name, fn, device, *args):
        key = f"{name} N={args[0].shape[2]}"
        by_kernel[key] = by_kernel.get(key, 0) + 1
        return real_launch(errors, name, fn, device, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launch = recording
    try:
        zero_counts(wrappers)
        state, loss, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        launches = counts(wrappers)
    finally:
        fa.launch = real_launch
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    tables = min(float(p.grad.abs().max()) for n, p in model.named_parameters()
                 if "rel_pos" in n)
    blocks = len(model.blocks)
    n_global = len(model.global_attn_indexes)
    want = {"flash_fwd": blocks, "flash_bwd_fused": 0, "flash_bwd_dq": blocks,
            "flash_bwd_dkv": blocks}
    want_by_kernel = {f"{name}_rel N={n}": count
                      for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                      for n, count in ((SAM_SHAPES["sam_window_train"][2], blocks - n_global),
                                       (SAM_SHAPES["sam_global_train"][2], n_global))}
    log("sam", f"ViT-H train step (batch {SAM_TRAIN_BATCH}, 1024 x 1024, bf16): launches "
        f"{launches} (expected {want}), by kernel {by_kernel}, loss {loss.item():.6f}, "
        f"gradients finite {finite}, least max|d table| {tables:.3e}, peak "
        f"{peak / 2**30:.3f} GiB on {card}")
    if launches != want or by_kernel != want_by_kernel:
        raise AssertionError(f"the SAM step launched {launches} / {by_kernel}, expected "
                             f"{want} / {want_by_kernel}")
    if not (finite and math.isfinite(loss.item()) and tables > 0):
        raise AssertionError("the SAM step's loss or gradients are not finite, or a table "
                             "got no gradient")
    del model, state, step, x
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_kernel


def sam_phase(fa, card: str):
    """Phase 27: SAM's attention on the bias kernels. Returns the kernels
    line's rows (name, source, replaces, path, row, launches)."""
    rows = check_sam_bias_kernels(fa)
    _, by_kernel = sam_train_launches(fa, card)
    src = "efficient_rpe_vit_torch/csrc"
    out = []
    for (name, path), row in rows.items():
        n = SAM_SHAPES[path][2]
        source = "flash_attention_fwd.cu" if name == "flash_fwd" else "flash_attention_bwd.cu"
        out.append((f"{name}_rel", f"{src}/{source}",
                    "none (the JAX package's flash kernels take no score bias)", path, row,
                    by_kernel[f"{name}_rel N={n}"]))
    return out


def rotation_bounds(B, H, N, D, dtype: str):
    """{kernel: (bound_ms, bound_by)} for the rotation kernels: x (and g)
    read once and out (dx) written once in the input dtype, ct and st read
    once (and dct, dst written once) in fp32; the DFT products, 8 rows D K
    operations forward (two products of 2K columns) and 12 rows D K
    backward (the reverse rotation and the recomputed spectrum), rows =
    B H N, K = D/2 + 1. In bf16 the products count on the tensor cores at
    the bf16 peak, three times over: the split bf16 products (hi and lo
    parts of the constants and of the rotated spectrum) that give them fp32
    accuracy; the bytes then bound every main-path shape. In fp32 they
    count at the fp32 FMA rate."""
    elt = 2 if dtype == "bfloat16" else 4
    rows, K = B * H * N, D // 2 + 1
    table = 4 * H * N * K
    rate = PEAK_OPS_PER_S["bfloat16"] / 3 if dtype == "bfloat16" else PEAK_OPS_PER_S["float32"]
    out = {}
    for name, n_rows, n_tables, ops in (
            ("circulant_rotate_fwd", 2, 2, 8 * rows * D * K),
            ("circulant_rotate_bwd", 3, 4, 12 * rows * D * K)):
        t_bytes = (elt * rows * D * n_rows + table * n_tables) / HBM_BYTES_PER_S
        t_ops = ops / rate
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def rot_mma_rule(D, dtype, strides) -> str:
    """The kernel a rotation launch runs by the source's rot_mma_takes rule:
    the mma.sync one in bf16 at D a multiple of 16 up to 64 with element
    strides that are multiples of 8, else the staged one."""
    takes = (dtype == torch.bfloat16 and D % 16 == 0 and 16 <= D <= 64
             and all(s % 8 == 0 for s in strides))
    return "mma.sync" if takes else "staged"


def check_rotation_launch_info(cr, N, D, dtype, strides, main_path=False):
    """{kernel: launch_info} of the rotation forward and backward at (N, D)
    in `dtype` with x's strides, logged; raises unless each runs the kernel
    of rot_mma_rule, and at a main path's shape unless that is the mma.sync
    kernel with no spilled bytes."""
    name = str(dtype).split(".")[-1]
    out = {}
    for kname in ("circulant_rotate_fwd", "circulant_rotate_bwd"):
        info = cr.launch_info(kname, N, D, dtype, strides)
        log("kernel", f"{kname} N={N} D={D} {name} strides {tuple(strides)}: " + ", ".join(
            f"{key} {value}" for key, value in info.items()))
        want = rot_mma_rule(D, dtype, strides)
        if info["kernel"] != want:
            raise AssertionError(f"the {kname} launch at N={N} D={D} {name} runs the "
                                 f"{info['kernel']} kernel, expected the {want} one")
        if main_path and (want != "mma.sync" or info["spill_bytes"]):
            raise AssertionError(f"the {kname} launch at a main path's shape is not the "
                                 f"mma.sync kernel without spills: {info}")
        out[kname] = info
    return out


def fft_rotation(x, ct, st):
    """The rotation as torch.fft's three calls: irfft(rfft(x) (ct + i st)),
    in x's dtype (a yardstick: the port never calls it)."""
    spectrum = torch.fft.rfft(x.float()) * torch.complex(ct, st)
    return torch.fft.irfft(spectrum, n=x.shape[-1]).to(x.dtype)


def check_rotation_kernels(cr):
    """Phase 3d: the rotation kernels against their plain versions on the
    card. Returns {(kernel, path): row} for the main paths' shapes."""
    from efficient_rpe_vit_torch.ops import rotations

    results = {}
    for B, H, N, D in ROT_SHAPES:
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            gen = torch.Generator(device="cuda").manual_seed(N * 10 + D + B)
            x, cot = (torch.randn(B, H, N, D, generator=gen, device="cuda").to(dtype)
                      for _ in range(2))
            theta = torch.randn(H, N, D // 2 + 1, generator=gen, device="cuda") * 0.3
            ct, st = theta.cos(), theta.sin()
            shape = f"B{B} H{H} N{N} D{D} {name}"
            path = ROT_PATHS.get((B, H, N, D))
            main_path = path is not None and dtype == torch.bfloat16
            infos = check_rotation_launch_info(cr, N, D, dtype, x.stride()[:3], main_path)
            errs = {}
            for keep in (False, True):
                out = cr.circulant_rotate_fwd(x, ct, st, keep)
                grads = cr.circulant_rotate_bwd(cot, x, ct, st, keep)
                torch.cuda.synchronize()
                want = (cr.circulant_rotate_fwd_reference(x, ct, st, keep),
                        *cr.circulant_rotate_bwd_reference(cot, x, ct, st, keep))
                got = (out, *grads)
                rels = [_max_rel(a, b) for a, b in zip(got, want)]
                tols = (ROT_TOL[name],) * 2 + (ROT_ANGLE_TOL,) * 2
                finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
                cls_ok = (not keep) or (torch.equal(out[:, :, 0], x[:, :, 0])
                                        and torch.equal(grads[0][:, :, 0], cot[:, :, 0])
                                        and not grads[1][:, 0].any() and not grads[2][:, 0].any())
                log("kernel", f"circulant_rotate {shape} keep_cls={keep}: (out, dx, dct, dst) "
                    f"max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)} (tol "
                    f"{tols[0]}, {tols[2]}), finite {finite}, CLS row bit for bit {cls_ok}")
                if not (finite and cls_ok and all(r <= t for r, t in zip(rels, tols))):
                    raise AssertionError(f"circulant_rotate disagrees with its plain version "
                                         f"at {shape} keep_cls={keep}")
                errs[keep] = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
            # the batch sums run in a fixed order: a rerun is bitwise equal
            again = cr.circulant_rotate_bwd(cot, x, ct, st, True)
            if not all(torch.equal(a, b) for a, b in zip(again, grads)):
                raise AssertionError(f"circulant_rotate_bwd is not bitwise reproducible at {shape}")
            if path == "circulant_serve":
                # the head split's transposed views go in without a copy
                xv, gv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, cot))
                same = torch.equal(cr.circulant_rotate_fwd(xv, ct, st, True), out) and all(
                    torch.equal(a, b) for a, b in zip(cr.circulant_rotate_bwd(gv, xv, ct, st, True),
                                                      grads))
                log("kernel", f"circulant_rotate {shape}: strided (head-split) inputs give the "
                    f"contiguous results bit for bit: {same}")
                if not same:
                    raise AssertionError("strided inputs change the rotation's results")
                if dtype == torch.bfloat16:
                    # rows of 68 elements: strides the mma.sync kernels do not take
                    xw, gw = (torch.zeros(B, H, N, D + 4, dtype=dtype, device="cuda")
                              for _ in range(2))
                    xw[..., :D], gw[..., :D] = x, cot
                    xs, gs = xw[..., :D], gw[..., :D]
                    check_rotation_launch_info(cr, N, D, dtype, xs.stride()[:3])
                    got = (cr.circulant_rotate_fwd(xs, ct, st, True),
                           *cr.circulant_rotate_bwd(gs, xs, ct, st, True))
                    want = (cr.circulant_rotate_fwd_reference(x, ct, st, True),
                            *cr.circulant_rotate_bwd_reference(cot, x, ct, st, True))
                    rels = [_max_rel(a, b) for a, b in zip(got, want)]
                    log("kernel", f"circulant_rotate {shape} rows of {D + 4} (staged): "
                        f"max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)}")
                    if not all(r <= t for r, t in zip(rels, (ROT_TOL[name],) * 2
                                                      + (ROT_ANGLE_TOL,) * 2)):
                        raise AssertionError("the staged rotation kernels disagree with "
                                             "their plain version")
            if path is None or name != "bfloat16":
                continue
            # timed on the main paths' shapes, with keep_cls as the model runs them
            bounds = rotation_bounds(B, H, N, D, name)
            mats = rotations._rdft_matrices(D, x.device)
            xg, ctg, stg = (t.detach().clone().requires_grad_() for t in (x, ct, st))

            def chain_fwd_bwd():
                y = rotations._dft_chain(xg, ctg[None], stg[None], *mats)
                return torch.autograd.grad(y, (xg, ctg, stg), cot)

            chain_fwd = kernel_ms(lambda: rotations._dft_chain(x, ct[None], st[None], *mats))
            chain_bwd = kernel_ms(chain_fwd_bwd) - chain_fwd

            def fft_fwd_bwd():
                return torch.autograd.grad(fft_rotation(xg, ctg, stg), (xg, ctg, stg), cot)

            fft_fwd = kernel_ms(lambda: fft_rotation(x, ct, st))
            fft_bwd = kernel_ms(fft_fwd_bwd) - fft_fwd
            # rows past CLS: the fft route does not keep it
            fft_err = _max_rel(fft_rotation(x, ct, st)[:, :, 1:],
                               cr.circulant_rotate_fwd_reference(x, ct, st)[:, :, 1:])
            log("kernel", f"torch.fft route {shape}: forward {fft_fwd:.4f} ms, backward "
                f"{fft_bwd:.4f} ms (three calls, not one library call), "
                f"max|err|/max|plain| {fft_err:.3e}")
            plain_iters = 1 if path == "circulant_longn_train" else 5
            timed = {
                "circulant_rotate_fwd": (
                    lambda: cr.circulant_rotate_fwd(x, ct, st, True),
                    lambda: cr.circulant_rotate_fwd_reference(x, ct, st, True),
                    chain_fwd, fft_fwd, errs[True][0]),
                "circulant_rotate_bwd": (
                    lambda: cr.circulant_rotate_bwd(cot, x, ct, st, True),
                    lambda: cr.circulant_rotate_bwd_reference(cot, x, ct, st, True),
                    chain_bwd, fft_bwd, max(errs[True][1:])),
            }
            for kname, (kernel_fn, plain_fn, chain_ms, fft_ms, err) in timed.items():
                if path == "circulant_serve" and kname == "circulant_rotate_bwd":
                    continue  # serving runs no backward
                ms = kernel_ms(kernel_fn)
                plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=1)
                bound_ms, bound_by = bounds[kname]
                log("kernel", f"{kname} {shape} keep_cls: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, DFT chain arm {chain_ms:.4f} ms, torch.fft route "
                    f"{fft_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), kernel/bound "
                    f"{ms / bound_ms:.2f}x")
                results[(kname, path)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                              bound_ms=bound_ms, bound_by=bound_by,
                                              library_ms=None, chain_ms=chain_ms,
                                              fft_route_ms=fft_ms, launch=infos[kname])
    return results


def masked_linear_bounds(B, H, N, F, D, dtype: str):
    """{kernel: (bound_ms, bound_by)} for #4 and #5: q', k', v, gn in the
    input dtype and s in fp32 read once, T [H, N, N] fp32 read once (dT
    written once), the other outputs written once; the products at the
    input type's peak, 2 B H N^2 (F + D) operations per pair: S and W v
    (forward), M and dA k' (dq), A, M, dA^T q' and W^T gn (dkv), A and M (dT)."""
    elt = 2 if dtype == "bfloat16" else 4
    bhn, t_bytes = B * H * N, 4 * H * N * N
    pair = 2 * B * H * N * N * (F + D)
    work = {"masked_linear_fwd": (elt * bhn * (2 * F + 2 * D) + 4 * bhn + t_bytes, pair),
            "masked_linear_bwd_dq": (elt * bhn * (2 * D + 2 * F) + 4 * bhn + t_bytes, pair),
            "masked_linear_bwd_dkv": (elt * bhn * (3 * D + 3 * F) + 4 * bhn + t_bytes,
                                      2 * pair),
            "masked_linear_bwd_dt": (elt * bhn * (2 * D + 2 * F) + 4 * bhn + t_bytes, pair)}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
        out[name] = (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")
    return out


def masked_linear_launch_info(ml, ab_shapes):
    """{kernel: {shape: launch_info}} of #4 and #5 at the bf16 `ab_shapes`
    and KERPLE_LONGN, logged first: each must run the mma.sync kernel (the
    sources' rule, `ml.mma_takes`), and in fp32 the staged one; with dT's
    batch groups, whose Python mirror (`ml.dt_batch_groups`,
    `ml.dt_scratch_floats`) must equal the built library's count."""
    infos = {kname: {} for kname in ML_KERNELS}
    for B, H, N, F, D in list(ab_shapes) + [KERPLE_LONGN]:
        for kname in ML_KERNELS:
            for dtype in (torch.bfloat16, torch.float32):
                info = ml.launch_info(kname, N, F, D, dtype)
                want = "mma.sync" if ml.mma_takes(F, D, dtype) else "staged"
                name = str(dtype).split(".")[-1]
                log("kernel", f"{kname} N={N} F={F} D={D} {name}: " + ", ".join(
                    f"{key} {value}" for key, value in info.items()))
                if info["kernel"] != want or (dtype == torch.bfloat16) != (want == "mma.sync"):
                    raise AssertionError(f"the {kname} launch at N={N} F={F} D={D} {name} runs "
                                         f"the {info['kernel']} kernel, expected the mma.sync "
                                         f"one in bf16 and the staged one in fp32")
                if dtype == torch.bfloat16:
                    infos[kname][(B, H, N, F, D)] = info
    lib = ml._bwd_fns()
    for B, H, N, F, D in list(ab_shapes) + [KERPLE_LONGN] + ML_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            is_bf16 = int(dtype == torch.bfloat16)
            built = (lib.mlt_bwd_dt_groups(B, H, N, F, D, is_bf16),
                     lib.mlt_bwd_dt_scratch_floats(B, H, N, F, D, is_bf16))
            mirror = (ml.dt_batch_groups(B, H, N, F, D, dtype),
                      ml.dt_scratch_floats(B, H, N, F, D, dtype))
            if built != mirror:
                raise AssertionError(f"dT's batch groups and scratch at {(B, H, N, F, D)} "
                                     f"{dtype}: the library counts {built}, the wrapper's "
                                     f"mirror {mirror}")
    log("kernel", "dT batch groups (pallas_ab shapes, long N): " + ", ".join(
        f"{shape} {ml.dt_batch_groups(*shape, torch.bfloat16)}"
        for shape in list(ab_shapes) + [KERPLE_LONGN]) + "; the wrapper's mirror equals the "
        "library at every phase-3f shape")
    return infos


def check_masked_linear_kernels(ml, mlc, ab_shapes):
    """Phase 3f: the materialised-T forward (#4) and backward (#5: dq, dkv,
    dT) kernels against their plain versions on the card, at the pallas_ab
    entry point's shapes `ab_shapes` and ML_SHAPES in both dtypes and at
    KERPLE_LONGN in bf16, over a Toeplitz T; over a T that is not Toeplitz
    at ML_RANDOM_T (both dtypes), long N and ML_EDGE_SHAPES (bf16); the
    backward bitwise on a rerun; at the ViT-B/16 training shape, #4 over
    T = toeplitz_from_coeffs(c) against #1 over c and #5 against #2 (dT's
    diagonal sums against dcoeffs). First each kernel's launch_info
    (masked_linear_launch_info). Timed in bf16 at `ab_shapes` and long N
    (Toeplitz T) beside their bounds, the coefficient route (#1, #2) and the
    residual backward in PyTorch. Returns {(kernel, shape): row}."""
    from efficient_rpe_vit_torch.ops.fft_toeplitz import toeplitz_diag_sums, toeplitz_from_coeffs

    infos = masked_linear_launch_info(ml, ab_shapes)
    results = {}
    cases = [(shape, name, dtype, True) for shape in list(ab_shapes) + ML_SHAPES
             for name, dtype in DTYPES] + [(KERPLE_LONGN, "bfloat16", torch.bfloat16, True)]
    cases += [(shape, name, dtype, False) for shape in ML_RANDOM_T for name, dtype in DTYPES]
    cases += [(shape, "bfloat16", torch.bfloat16, False)
              for shape in [KERPLE_LONGN] + ML_EDGE_SHAPES]
    for (B, H, N, F, D), name, dtype, toeplitz in cases:
        g = torch.Generator(device="cuda").manual_seed(N * 1000 + F + 11)
        q, k = ((torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
                for _ in range(2))
        v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype) for _ in range(2))
        c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
        t = (toeplitz_from_coeffs(c, N) if toeplitz
             else torch.rand(H, N, N, generator=g, device="cuda") + 0.5)
        shape = f"B{B} H{H} N{N} F{F} D{D} {name}{'' if toeplitz else ', T not Toeplitz'}"
        out, den = ml.masked_linear_fwd(q, k, v, t)
        torch.cuda.synchronize()
        ref_out, ref_den = ml.masked_linear_fwd_reference(q, k, v, t)
        rtol, atol = OUT_TOL[name]
        err = (out.float() - ref_out.float()).abs()
        ok_out = bool((err <= atol + rtol * ref_out.float().abs()).all())
        den_rel = ((den - ref_den).abs() / ref_den.abs().clamp_min(1e-30)).max().item()
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(den).all())
        log("kernel", f"masked_linear_fwd {shape}: max|out err| {err.max().item():.3e} "
            f"(rtol {rtol}, atol {atol}), max den rel err {den_rel:.3e} (rtol {DEN_RTOL}), "
            f"finite {finite}")
        if not (ok_out and den_rel <= DEN_RTOL and finite):
            raise AssertionError(f"masked_linear_fwd disagrees with its plain version at {shape}")
        errs = {"masked_linear_fwd": err.max().item()}
        del err, ref_out
        del ref_den
        gn, s = mlc.kerple_bwd_residuals(den, out, cot)
        runs = {
            "masked_linear_bwd_dq": (
                lambda: ml.masked_linear_bwd_dq(gn, s, v, k, t),
                lambda: mlc.kerple_dense_bwd_dq(gn, s, v, k, t), BWD_TOL[name]),
            "masked_linear_bwd_dkv": (
                lambda: ml.masked_linear_bwd_dkv(gn, s, v, q, k, t),
                lambda: mlc.kerple_dense_bwd_dkv(gn, s, v, q, k, t), BWD_TOL[name]),
            "masked_linear_bwd_dt": (
                lambda: ml.masked_linear_bwd_dt(gn, s, v, q, k),
                lambda: mlc.kerple_dense_bwd_dt(gn, s, v, q, k), DCOEFF_TOL[name]),
        }
        for kname, (kernel_fn, plain_fn, tol) in runs.items():
            got = kernel_fn()
            torch.cuda.synchronize()
            want = plain_fn()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            errs[kname] = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            log("kernel", f"{kname} {shape}: max|err|/max|plain| "
                f"{', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), finite {finite}")
            if not (finite and max(rels) <= tol):
                raise AssertionError(f"{kname} disagrees with its plain version at {shape}")
            del got, want
        # the whole backward as autograd calls it: against the residual
        # formula, and bitwise on a rerun (no atomics)
        got = ml.masked_linear_bwd(q, k, v, t, den, out, cot)
        again = ml.masked_linear_bwd(q, k, v, t, den, out, cot)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = ml.masked_linear_bwd_reference(q, k, v, t, den, out, cot)
        tols = (BWD_TOL[name],) * 3 + (DCOEFF_TOL[name],)
        rels = [_max_rel(a, b) for a, b in zip(got, want)]
        del want
        log("kernel", f"masked_linear_bwd {shape}: (dq', dk', dv, dT) max|err|/max|plain| "
            f"{', '.join(f'{r:.3e}' for r in rels)}, bitwise on a rerun {bitwise}")
        if any(r > tol for r, tol in zip(rels, tols)) or not bitwise:
            raise AssertionError(f"masked_linear_bwd disagrees with its plain version or is "
                                 f"not bitwise reproducible at {shape}")
        if (B, H, N, F, D) == ML_SHAPES[0] and toeplitz:
            # the same function as the coefficient kernels over c
            c_out, c_den = mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)
            c_grads = mlc.masked_linear_attention_coeffs_bwd(q, k, v, c, den, out, cot)
            torch.cuda.synchronize()
            vs = [_max_rel(out, c_out), ((den - c_den).abs() / c_den.abs()).max().item(),
                  *(_max_rel(a, b) for a, b in zip(got[:3], c_grads[:3])),
                  _max_rel(toeplitz_diag_sums(got[3]), c_grads[3])]
            tols = (OUT_TOL[name][0], DEN_RTOL) + (BWD_TOL[name],) * 3 + (DCOEFF_TOL[name],)
            log("kernel", f"#4/#5 over T against #1/#2 over c {shape}: (out, den, dq', dk', dv, "
                f"diag sums of dT vs dcoeffs) max rel {', '.join(f'{r:.3e}' for r in vs)}")
            if any(r > tol for r, tol in zip(vs, tols)):
                raise AssertionError(f"#4/#5 over T disagree with #1/#2 over c at {shape}")
            del c_grads
        del got
        long_n = (B, H, N, F, D) == KERPLE_LONGN
        if name != "bfloat16" or not toeplitz or not ((B, H, N, F, D) in ab_shapes or long_n):
            continue
        plain_iters = 1 if long_n else 5
        jnp_ms = time_ms(lambda: ml.masked_linear_bwd_reference(q, k, v, t, den, out, cot),
                         iters=plain_iters, warmup=1)
        kernels_ms = kernel_ms(lambda: ml.masked_linear_bwd(q, k, v, t, den, out, cot,
                                                            need_dt=False))
        log("kernel", f"masked_linear_bwd {shape}: dq + dkv kernels and residuals "
            f"{kernels_ms:.4f} ms, the residual backward in PyTorch (bwd_mode "
            f"'jnp_residual') {jnp_ms:.4f} ms")
        bounds = masked_linear_bounds(B, H, N, F, D, name)
        timed = {
            "masked_linear_fwd": (
                lambda: ml.masked_linear_fwd(q, k, v, t),
                lambda: ml.masked_linear_fwd_reference(q, k, v, t),
                lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)),
            "masked_linear_bwd_dq": (*runs["masked_linear_bwd_dq"][:2],
                                     lambda: mlc.masked_linear_attention_coeffs_bwd_dq(
                                         gn, s, v, k, c)),
            "masked_linear_bwd_dkv": (*runs["masked_linear_bwd_dkv"][:2],
                                      lambda: mlc.masked_linear_attention_coeffs_bwd_dkv(
                                          gn, s, v, q, k, c)),
            "masked_linear_bwd_dt": (*runs["masked_linear_bwd_dt"][:2],
                                     lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reduce(
                                         mlc.masked_linear_attention_coeffs_bwd_dc(
                                             gn, s, v, q, k), N)),
        }
        for kname, (kernel_fn, plain_fn, route_fn) in timed.items():
            ms, route_ms = kernel_ms(kernel_fn), kernel_ms(route_fn)
            plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=1)
            bound_ms, bound_by = bounds[kname]
            log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"coefficient route (#1/#2) {route_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), kernel/bound {ms / bound_ms:.2f}x")
            results[(kname, (B, H, N, F, D))] = dict(
                max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, coeffs_route_ms=route_ms,
                launch=infos[kname][(B, H, N, F, D)],
                **({} if kname == "masked_linear_fwd" else {"jnp_residual_bwd_ms": jnp_ms}),
                **({"dt_groups": ml.dt_batch_groups(B, H, N, F, D, dtype)}
                   if kname == "masked_linear_bwd_dt" else {}))
    return results


def pallas_ab_phase(pallas_ab, card: str):
    """Phase 15: the port's pallas_ab entry point at its shapes, counts set
    to 0 before each shape and read after it. The forward kernel runs in
    every *_pallas* row and no other, dq and dkv in the two grad_pallas_fused
    rows only (none in grad_pallas_jnp), dT only where T needs a gradient
    (grad_pallas_fused_t); every row's time and output is finite. Returns
    {shape: launches of that shape's run}."""
    per_shape = {}
    for shape in pallas_ab.SHAPES:
        zero_counts(pallas_ab.WRAPPERS)
        ran = {}
        rows = pallas_ab.bench_shape(*shape, device="cuda", launches=ran)
        torch.cuda.synchronize()
        per_shape[shape] = counts(pallas_ab.WRAPPERS)
        B, H, N, F, D = shape
        log("pallas_ab", f"B={B} H={H} N={N} F={F} D={D} on {card}: "
            + "  ".join(f"{row}={sec * 1e3:.4f}ms" for row, sec in rows.items()))
        log("pallas_ab", f"launches by row {ran}; in all {per_shape[shape]}")
        for row, got in ran.items():
            fused = row.startswith("grad_pallas_fused")
            want = {"masked_linear_fwd": "pallas" in row, "masked_linear_bwd_dq": fused,
                    "masked_linear_bwd_dkv": fused,
                    "masked_linear_bwd_dt": row == "grad_pallas_fused_t"}
            if {n: c > 0 for n, c in got.items()} != want:
                raise AssertionError(f"pallas_ab row {row} at {shape} launched {got}; "
                                     f"expected launches only of {[n for n, w in want.items() if w]}")
        outputs = {row: pallas_ab.run_row(row, *pallas_ab.make_inputs(*shape, "cuda"))
                   for row in rows}
        bad = [row for row, sec in rows.items() if not (sec > 0 and sec == sec)] + [
            row for row, out in outputs.items()
            if not all(bool(torch.isfinite(x.float()).all())
                       for x in (out if isinstance(out, tuple) else (out,)))]
        if bad:
            raise AssertionError(f"pallas_ab rows {bad} at {shape} are not finite")
        del outputs
    return per_shape


# ─── the models' main paths ─────────────────────────────────────────────

def kerple_wrappers(mlc):
    return {"masked_linear_coeffs_fwd": mlc.masked_linear_attention_coeffs_fwd,
            "masked_linear_coeffs_bwd_dq": mlc.masked_linear_attention_coeffs_bwd_dq,
            "masked_linear_coeffs_bwd_dkv": mlc.masked_linear_attention_coeffs_bwd_dkv,
            "masked_linear_coeffs_bwd_dc": mlc.masked_linear_attention_coeffs_bwd_dc,
            "masked_linear_coeffs_bwd_dc_reduce":
                mlc.masked_linear_attention_coeffs_bwd_dc_reduce,
            "kerple_fused_phi_fwd": mlc.kerple_attention_fused_phi_fwd}


def flash_wrappers(fa):
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_fused": fa.flash_attention_bwd_fused,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv}


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def zero_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def serve(phase: str, name: str, arms, wrappers, per_forward, card: str, profile: bool,
          arbiter: bool = False):
    """ViT-B/16 `name` answers REQUESTS batches through make_eval_step on
    the kernel arm, checked against the dense arm, and any further arm,
    from the same weights. `arms` maps "kernel", "dense" and optional other
    arm names to create_model keyword arguments; `per_forward` is each of
    `wrappers`' expected launches in one forward. With `arbiter`, where the
    kernel arm's top-1 agreement with a reference arm falls below
    MIN_TOP1_AGREEMENT, both are held against the dense arm in fp32 instead
    (module constants). Returns the launch counts of that run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import make_eval_step

    cfg = mnist_config(**VITB)
    t0 = time.perf_counter()
    models = {arm: create_model(name, cfg, device="cuda",
                                generator=torch.Generator().manual_seed(0), **kw)
              for arm, kw in arms.items()}
    model = models["kernel"]
    for arm, other in models.items():
        other.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log(phase, f"ViT-B/16 {name} bf16, {n_params} params, {len(models)} arms "
        f"built in {time.perf_counter() - t0:.1f} s (set-up)")
    steps = {arm: make_eval_step(m) for arm, m in models.items()}

    g = torch.Generator(device="cuda").manual_seed(1)
    B = VITB["batch_size"]
    requests = [
        (torch.randn(B, 224, 224, 3, generator=g, device="cuda"),
         torch.randint(0, VITB["num_classes"], (B,), generator=g, device="cuda"))
        for _ in range(REQUESTS)
    ]

    # the main path: counts from 0, read right after
    zero_counts(wrappers)
    answers = [steps["kernel"](x, y) for x, y in requests]
    torch.cuda.synchronize()
    launches = counts(wrappers)
    expected = {n: c * REQUESTS for n, c in per_forward.items()}
    log(phase, f"{REQUESTS} requests x {B} images answered; kernel launches {launches} "
        f"(expected {expected}: {per_forward} per forward)")
    if launches != expected:
        raise AssertionError(f"kernels launched {launches}, expected {expected}")
    for loss, correct, preds in answers:
        if not (torch.isfinite(loss) and preds.shape == (B,)):
            raise AssertionError("served a non-finite loss or malformed predictions")

    # correctness: the same weights on the other arms
    with torch.inference_mode():
        logits = {arm: torch.cat([m(x) for x, _ in requests]) for arm, m in models.items()}
    got = logits["kernel"]
    served_preds = torch.cat([p for _, _, p in answers])
    if got.shape != (B * REQUESTS, VITB["num_classes"]) or not torch.isfinite(got).all():
        raise AssertionError(f"logits malformed or non-finite: {tuple(got.shape)}")
    for arm in [a for a in models if a != "kernel"]:
        want = logits[arm]
        ref_preds = torch.cat([steps[arm](x, y)[2] for x, y in requests])
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (served_preds == ref_preds).float().mean().item()
        spread = got.std(dim=0).mean().item()
        top2 = want.topk(2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        log(phase, f"logits vs {arm} arm: max|diff|/max|logit| {rel:.3e} "
            f"(tol {LOGIT_REL_TOL}), top-1 agreement {agree:.4f} "
            f"(min {MIN_TOP1_AGREEMENT}), mean per-class std over images {spread:.3e}, "
            f"median top-2 gap {gaps.median().item():.3e}")
        for i in (served_preds != ref_preds).nonzero().flatten().tolist():
            log(phase, f"image {i}: top-1 differs from the {arm} arm; its top-2 gap "
                f"{gaps[i].item():.3e}, max|diff| of its logits "
                f"{(got[i] - want[i]).abs().max().item():.3e}")
        if rel > LOGIT_REL_TOL:
            raise AssertionError(f"served logits disagree with the {arm} arm")
        if agree >= MIN_TOP1_AGREEMENT:
            continue
        if not arbiter:
            raise AssertionError(f"served top-1 predictions disagree with the {arm} arm")
        if "fp32" not in logits:
            fp32 = create_model(name, mnist_config(**dict(VITB, compute_dtype="float32")),
                                device="cuda", generator=torch.Generator().manual_seed(0),
                                **arms["dense"])
            fp32.load_state_dict(model.state_dict())
            with torch.inference_mode():
                logits["fp32"] = torch.cat([fp32(x) for x, _ in requests])
            del fp32
        ref = logits["fp32"]
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * (want - ref).abs().max()
        errs = {}
        for label, arm_logits in (("kernel", got), (arm, want)):
            diff = (arm_logits - ref).abs()
            errs[label] = (diff.max().item(), diff.mean().item())
            same = arm_logits.argmax(-1) == ref.argmax(-1)
            log(phase, f"{label} arm (bf16) vs the dense arm in fp32: max|diff| "
                f"{errs[label][0]:.3e}, mean|diff| {errs[label][1]:.3e} (max|logit| "
                f"{ref.abs().max().item():.3e}), top-1 agreement {same.float().mean().item():.4f}, "
                f"on the {int(decided.sum())} images the dense bf16 arm's noise cannot flip "
                f"{same[decided].float().mean().item():.4f}")
            if label == "kernel":
                agree_decided = same[decided].float().mean().item()
        if any(k > BF16_ERROR_FACTOR * d for k, d in zip(errs["kernel"], errs[arm])) \
                or agree_decided < MIN_TOP1_AGREEMENT:
            raise AssertionError(f"the kernel arm is further from the fp32 model than the "
                                 f"{arm} bf16 arm allows")
        log(phase, f"top-1 agreement {agree:.4f} between the kernel and {arm} bf16 arms is "
            f"below {MIN_TOP1_AGREEMENT}; against the fp32 model the kernel arm's logit errors "
            f"are within {BF16_ERROR_FACTOR}x of the {arm} bf16 arm's and it keeps "
            f"{agree_decided:.4f} of the decided top-1 predictions")
    with torch.inference_mode():
        if not torch.equal(model(requests[0][0]), got[:B]):
            raise AssertionError("served logits changed between two runs")
    log(phase, "served logits are bitwise identical run to run")

    # throughput: host clock around synchronised steps, after warm-up
    for label, fn in steps.items():
        for x, y in requests[:2]:
            fn(x, y)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for i in range(iters):
            x, y = requests[i % REQUESTS]
            fn(x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(phase, f"{name} {label} arm: forward {dt / iters * 1e3:.3f} ms/batch "
            f"of {B}, {B * iters / dt:.1f} images/s on {card}")

    if profile:
        profile_step(f"one served batch of {name}", lambda: steps["kernel"](*requests[0]), card)
    del models, steps
    return launches


def train(phase: str, name: str, cfg_fields, arms, wrappers, per_step, steps: int,
          timed: int, card: str, profile: bool):
    """ViT-B/16 `name` trains `steps` steps through create_train_state /
    make_train_step on the kernel arm, and on each other arm of `arms` from
    the same weights, whose step-1 gradients the kernel arm's are held to.
    `per_step` is each wrapper's expected launches in one step. Returns the
    launch counts of the kernel arm's main-path run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    cfg = mnist_config(**cfg_fields)
    batch = cfg_fields["batch_size"]
    t0 = time.perf_counter()
    models = {arm: create_model(name, cfg, device="cuda",
                                generator=torch.Generator().manual_seed(0), **kw)
              for arm, kw in arms.items()}
    initial = {k: v.clone() for k, v in models["kernel"].state_dict().items()}
    steps_of = {arm: make_train_step(m) for arm, m in models.items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    size = cfg_fields["image_size"]
    x = torch.randn(batch, size, size, cfg_fields["in_channels"], generator=g, device="cuda")
    y = torch.randint(0, cfg_fields["num_classes"], (batch,), generator=g, device="cuda")
    seq_len = (size // cfg_fields["patch_size"]) ** 2 + 1
    log(phase, f"ViT-B/16 {name} bf16, {size}x{size} images (N={seq_len}), batch {batch}, dropout "
        f"{cfg_fields['dropout']}, optimizer {cfg.train.optimizer} / {cfg.train.scheduler} lr "
        f"{cfg.train.learning_rate}; {len(models)} model(s) built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    def fresh(arm):
        """The arm's model reset to the initial weights, with a new state."""
        models[arm].load_state_dict(initial)
        return create_train_state(models[arm], cfg, steps_per_epoch=100)

    def one_step(arm, state):
        state, loss, _ = steps_of[arm](state, x, y, torch.Generator(device="cuda").manual_seed(3))
        return state, loss

    def grads(arm):
        missing = [n for n, p in models[arm].named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"{arm} arm: no gradient reached {missing}")
        return {n: p.grad.detach().clone() for n, p in models[arm].named_parameters()}

    # step 1 on the kernel arm: launch counts, finite gradients
    zero_counts(wrappers)
    one_step("kernel", fresh("kernel"))
    torch.cuda.synchronize()
    got = counts(wrappers)
    log(phase, f"kernel launches in one train step: {got} (expected {per_step})")
    if got != per_step:
        raise AssertionError(f"expected {per_step} launches per step, got {got}")
    g1 = grads("kernel")
    bad = [n for n, t in g1.items() if not bool(torch.isfinite(t).all())]
    if bad:
        raise AssertionError(f"non-finite gradients: {bad}")
    log(phase, f"all {len(g1)} parameter tensors have finite gradients")

    # the main path's run: `steps` steps from the same weights, whose first
    # step must give bitwise the same gradients
    zero_counts(wrappers)
    state, loss = one_step("kernel", fresh("kernel"))
    differ = [n for n, t in grads("kernel").items() if not torch.equal(t, g1[n])]
    if differ:
        raise AssertionError(f"step-1 gradients differ between two runs: {differ}")
    log(phase, "step-1 gradients are bitwise identical across two runs")
    losses = [loss]
    for _ in range(steps - 1):
        state, loss = one_step("kernel", state)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = counts(wrappers)
    expected = {n: c * steps for n, c in per_step.items()}
    log(phase, f"{steps} steps: kernel launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"expected {expected} launches, got {launches}")

    states = {"kernel": state}
    all_losses = list(losses)
    for arm in (a for a in models if a != "kernel"):
        state_d, loss_d = one_step(arm, fresh(arm))
        gd = grads(arm)
        rel = {n: ((g1[n].float() - gd[n].float()).norm()
                   / gd[n].float().norm().clamp_min(1e-30)).item() for n in g1}
        worst = max(rel, key=rel.get)
        for n in sorted(rel):
            if "rel_pos_bias" in n or "attention.qkv" in n:
                log(phase, f"  grad {n}: ||kernel - {arm}|| / ||{arm}|| {rel[n]:.3e}")
        log(phase, f"step-1 gradients vs {arm} arm: worst tensor {worst} at "
            f"{rel[worst]:.3e} (tol {GRAD_REL_TOL}); median "
            f"{sorted(rel.values())[len(rel) // 2]:.3e}")
        if rel[worst] > GRAD_REL_TOL:
            raise AssertionError(f"gradient of {worst} disagrees with the {arm} arm")
        losses_d = [loss_d]
        for _ in range(steps - 1):
            state_d, loss_d = one_step(arm, state_d)
            losses_d.append(loss_d)
        states[arm] = state_d
        for i, (a, b) in enumerate(zip(losses, losses_d)):
            log(phase, f"step {i + 1}: loss kernel arm {a.item():.6f}, {arm} arm {b.item():.6f}")
        all_losses += losses_d
    if len(models) == 1:
        for i, a in enumerate(losses):
            log(phase, f"step {i + 1}: loss {a.item():.6f}")
    if not all(bool(torch.isfinite(v)) for v in all_losses):
        raise AssertionError("a training loss is not finite")

    # time per step: host clock around synchronised steps, after the warm-up above
    for arm in states:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            states[arm], _ = one_step(arm, states[arm])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / timed
        log(phase, f"{name} {arm} arm: {dt * 1e3:.3f} ms/step of {batch} (N={seq_len}), "
            f"{batch / dt:.1f} images/s on {card}")
    log(phase, f"peak device memory in this phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_step(f"one train step of {name} (N={seq_len})",
                     lambda: one_step("kernel", states["kernel"]), card)
    del models, states
    return launches


def profile_step(what: str, run, card: str) -> None:
    """Device time by kernel for one call of `run` (torch.profiler); only
    the device-side kernel events are summed, not the operators that
    launched them nor user-annotated ranges (the optimizer's step), which
    overlap the kernels inside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        log("profile", "the profiler recorded no device time (not measured)")
        return
    log("profile", f"{what}: device busy {total:.1f} us of {wall_us:.1f} us wall "
        f"({100 * total / wall_us:.1f}%) on {card}")
    for dev, count, key in sorted(rows, reverse=True)[:16]:
        log("profile", f"{dev:10.1f} us {100 * dev / total:5.1f}% x{count:<4d} {key[:90]}")
    groups = {}
    for dev, count, key in rows:
        group = next(g for g, hit in PROFILE_GROUPS if hit(key))
        groups[group] = groups.get(group, 0.0) + dev
    for group, dev in sorted(groups.items(), key=lambda kv: -kv[1]):
        log("profile", f"group {group}: {dev:.1f} us ({100 * dev / total:.1f}%)")


def kerple_f532_check(mlc):
    """favor_hyper doubles the features: under KERPLE its kernels see
    F = 2 * 266 = 532, where the F = 266 tile layouts of the fp32 forward
    and of dq and dkv outgrow shared memory and smaller tiles take over.
    Each KERPLE kernel launches at F532 in both dtypes and is held against
    its plain version (phase 3 / 3b tolerances) and timed; a refused launch
    raises."""
    B, H, N, F, D = F532
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        # the staged forward, dq, dkv and dc kernels by their rule
        for kname in (KERPLE_FORWARDS[0], *BWD_KERNELS[:3]):
            check_kerple_rule(mlc, kname, N, F, D, dtype, phase="variants")
        g = torch.Generator(device="cuda").manual_seed(532)
        q = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
        k = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
        v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype) for _ in range(2))
        c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
        out, den = mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)
        torch.cuda.synchronize()
        ref_out, ref_den = mlc.masked_linear_attention_coeffs_reference(q, k, v, c)
        gn, s = mlc.kerple_bwd_residuals(ref_den, ref_out, cot)
        rtol, atol = OUT_TOL[name]
        fwd_ok = bool(((out.float() - ref_out.float()).abs()
                       <= atol + rtol * ref_out.float().abs()).all()) and \
            ((den - ref_den).abs() / ref_den.abs()).max().item() <= DEN_RTOL
        fwd_ms = kernel_ms(lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c))
        log("variants", f"KERPLE at F={F}: masked_linear_coeffs_fwd B{B} H{H} N{N} D{D} {name}: "
            f"launched, within (rtol {rtol}, atol {atol}) and den rtol {DEN_RTOL}: {fwd_ok}, "
            f"kernel {fwd_ms:.4f} ms")
        if not fwd_ok:
            raise AssertionError(f"masked_linear_coeffs_fwd disagrees with its plain version "
                                 f"at F={F} {name}")
        for kname, kernel_fn, plain_fn, tol in (
                ("masked_linear_coeffs_bwd_dq",
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, k, c),
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dq_reference(gn, s, v, k, c),
                 BWD_TOL[name]),
                ("masked_linear_coeffs_bwd_dkv",
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, q, k, c),
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dkv_reference(gn, s, v, q, k, c),
                 BWD_TOL[name]),
                ("masked_linear_coeffs_bwd_dc",
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k),
                 lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reference(gn, s, v, q, k),
                 DCOEFF_TOL[name])):
            got = kernel_fn()
            torch.cuda.synchronize()
            want = plain_fn()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            log("variants", f"KERPLE at F={F}: {kname} B{B} H{H} N{N} D{D} {name}: launched, "
                f"max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), "
                f"finite {finite}, kernel {kernel_ms(kernel_fn):.4f} ms")
            if not (finite and max(rels) <= tol):
                raise AssertionError(f"{kname} disagrees with its plain version at F={F} {name}")


def other_variants(wrappers, card: str):
    """Phase 12: each of OTHER_VARIANTS at ViT-B width and VARIANT_DEPTH
    serves one batch of 32 on its kernel arms against its dense / chain
    arms, then takes one train step on the kernel arms with finite
    gradients for every parameter. A full circulant must launch the
    rotation forward twice per block and forward (q and k), and its
    backward twice per block and step; a KERPLE variant its forward kernel
    (the fused-phi one under FUSED_PHI, else masked_linear_coeffs_fwd) once
    per block and forward, and each backward kernel once per block and
    step."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    cfg = mnist_config(**dict(VITB, depth=VARIANT_DEPTH))
    B = VITB["batch_size"]
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(B, 224, 224, 3, generator=g, device="cuda")
    y = torch.randint(0, VITB["num_classes"], (B,), generator=g, device="cuda")
    for name, kernel_rpe, dense_rpe in OTHER_VARIANTS:
        softmax = name.startswith(("baseline", "softmax"))
        fused = kernel_rpe == FUSED_PHI
        label = name + (" (block-circulant)" if kernel_rpe == BLOCK_CIRCULANT
                        else " (fused phi)" if fused else "")
        models = {}
        for arm, rpe, method in (("kernel", kernel_rpe, "flash"), ("dense", dense_rpe, "dense")):
            attention = {"method": method} if softmax else None
            if arm == "kernel" and fused:
                rpe, attention = None, {"fused_phi": True}
            models[arm] = create_model(
                name, cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                rpe_config=rpe, attention_config=attention)
        models["dense"].load_state_dict(models["kernel"].state_dict())
        rotating = kernel_rpe == {"method": "pallas"} and "circulant" in name
        per_forward = 2 * VARIANT_DEPTH if rotating else 0
        kerple_fwd = None
        if name.endswith("most_general"):
            kerple_fwd = "kerple_fused_phi_fwd" if fused else "masked_linear_coeffs_fwd"
        zero_counts(wrappers)
        with torch.inference_mode():
            got = models["kernel"](x)
            torch.cuda.synchronize()
            served = counts(wrappers)
            want = models["dense"](x)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log("variants", f"{label}: served {B} images, logits vs dense/chain arm "
            f"max|diff|/max|logit| {rel:.3e} (tol {LOGIT_REL_TOL}), top-1 agreement "
            f"{agree:.4f}, launches {served}")
        if not (torch.isfinite(got).all() and rel <= LOGIT_REL_TOL):
            raise AssertionError(f"{label}: served logits disagree with the dense arm")
        if (served["circulant_rotate_fwd"], served["circulant_rotate_bwd"]) != (per_forward, 0):
            raise AssertionError(f"{label}: expected {per_forward} rotation forward launches")
        kerple_served = {n: c for n, c in served.items() if n in KERPLE_FORWARDS or n in BWD_KERNELS}
        if kerple_served != {n: VARIANT_DEPTH if n == kerple_fwd else 0 for n in kerple_served}:
            raise AssertionError(f"{label}: expected {VARIANT_DEPTH} {kerple_fwd} launches "
                                 f"and no other KERPLE launch, got {kerple_served}")
        model = models["kernel"]
        step = make_train_step(model)
        state = create_train_state(model, cfg, steps_per_epoch=100)
        zero_counts(wrappers)
        _, loss, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        trained = counts(wrappers)
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        log("variants", f"{label}: one train step, loss {loss.item():.4f}, launches {trained}, "
            f"{len(bad)} parameter tensors without a finite gradient")
        if bad or not torch.isfinite(loss):
            raise AssertionError(f"{label}: missing or non-finite gradients {bad}")
        if rotating and trained["circulant_rotate_bwd"] != per_forward:
            raise AssertionError(f"{label}: expected {per_forward} rotation backward launches")
        if kerple_fwd is not None and any(
                trained[n] != VARIANT_DEPTH for n in (kerple_fwd, *BWD_KERNELS)):
            raise AssertionError(f"{label}: expected {VARIANT_DEPTH} launches of {kerple_fwd} "
                                 f"and of each backward kernel per step, got {trained}")
        del models, model, state, step
    log("variants", f"{len(OTHER_VARIANTS)} variants on {card}, each served and trained one step")


def fft_op_check(card: str):
    """Phase 16, op level: KERPLE's fft arm (torch.fft, no kernel) against
    the kernel arm, bf16: the forward at KERPLE_LONGN, forward and
    gradients over (q', k', v, coeffs) at FFT_GRAD_SHAPE (with gradients
    every block's spectra are kept, ~1.7 GB each there and ~3.4 GB at
    KERPLE_LONGN). The two arms round at other places (fft: k'v and D1 to
    bf16; kernels: W to bf16): outputs to LOGIT_REL_TOL of their maximum,
    gradients to GRAD_REL_TOL in norm."""
    from efficient_rpe_vit_torch.ops.attention_core import kerple_linear_attention

    for (B, H, N, F, D), with_grads in ((KERPLE_LONGN, False), (FFT_GRAD_SHAPE, True)):
        g = torch.Generator(device="cuda").manual_seed(N + F)
        q, k = ((torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1)
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn(B, H, N, D, generator=g, device="cuda").to(torch.bfloat16)
        c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
        arms = {}
        for method in ("fft", "pallas"):
            leaves = [x.detach().clone().requires_grad_(with_grads) for x in (q, k, v, c)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = kerple_linear_attention(*leaves, method=method)
            if with_grads:
                (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            arms[method] = (out.detach(), [x.grad for x in leaves if with_grads],
                            (time.perf_counter() - t0) * 1e3)
            del out, leaves
        (out_f, grads_f, ms_f), (out_k, grads_k, ms_k) = arms["fft"], arms["pallas"]
        rel = _max_rel(out_f, out_k)
        grad_rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(grads_f, grads_k)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (out_f, *grads_f))
        shape = f"B{B} H{H} N{N} F{F} D{D} bfloat16"
        log("longn-kerple", f"fft arm vs kernel arm {shape}{' with gradients' if with_grads else ''}: "
            f"out max|diff|/max|out| {rel:.3e} (tol {LOGIT_REL_TOL}), gradients (q', k', v, "
            f"coeffs) ||diff||/||kernel|| {', '.join(f'{r:.3e}' for r in grad_rel)} (tol "
            f"{GRAD_REL_TOL}), finite {finite}; one call (host clock) fft {ms_f:.1f} ms, "
            f"kernels {ms_k:.1f} ms on {card}")
        if not (finite and rel <= LOGIT_REL_TOL and all(r <= GRAD_REL_TOL for r in grad_rel)):
            raise AssertionError(f"the fft arm disagrees with the kernel arm at {shape}")
        del arms, out_f, grads_f, out_k, grads_k


def longn_kerple_serve(wrappers, card: str):
    """Phase 16, serving: ViT-B/16 performer_favor_most_general on 1024x1024
    images (N=4097) answers one batch of 4 on the kernel arm (12 forward
    launches), held against the same weights on the fft arm by the logit
    rule (LOGIT_REL_TOL). Returns the kernel arm's launches."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model

    cfg = mnist_config(**dict(LONGN, dropout=0.0))
    models = {method: create_model("performer_favor_most_general", cfg, device="cuda",
                                   generator=torch.Generator().manual_seed(0),
                                   rpe_config={"method": method})
              for method in ("pallas", "fft")}
    models["fft"].load_state_dict(models["pallas"].state_dict())
    B, size = LONGN["batch_size"], LONGN["image_size"]
    x = torch.randn(B, size, size, 3, generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    logits, ms = {}, {}
    with torch.inference_mode():
        for method in ("pallas", "fft"):
            if method == "pallas":
                zero_counts(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[method] = models[method](x)
            torch.cuda.synchronize()
            ms[method] = (time.perf_counter() - t0) * 1e3
            if method == "pallas":
                launches = counts(wrappers)
    got, want = logits["pallas"], logits["fft"]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    expected = {n: VITB["depth"] if n == "masked_linear_coeffs_fwd" else 0 for n in wrappers}
    log("longn-kerple", f"served a batch of {B} at N={LONGN_N}: kernel launches {launches} "
        f"(expected {expected}); logits vs the fft arm max|diff|/max|logit| {rel:.3e} (tol "
        f"{LOGIT_REL_TOL}), top-1 agreement {agree:.2f}; one forward (host clock, first "
        f"call) kernel arm {ms['pallas']:.1f} ms, fft arm {ms['fft']:.1f} ms on {card}")
    if launches != expected:
        raise AssertionError(f"expected {expected} launches, got {launches}")
    if got.shape != (B, VITB["num_classes"]) or not torch.isfinite(got).all() \
            or rel > LOGIT_REL_TOL:
        raise AssertionError("long-N KERPLE logits are malformed or disagree with the fft arm")
    del models, logits
    return launches


def _params_differ(a, b):
    """Names of the parameters and buffers where models a and b differ."""
    sb = b.state_dict()
    return [n for n, t in a.state_dict().items() if not torch.equal(t, sb[n])]


def check_replayed_masks() -> None:
    """Dropout masks drawn inside a CUDA graph (`train.training._Replays`,
    whose generator takes the caller's state before a replay and gives the
    advanced state back): each call's masks equal the eager draws from the
    same generator, and a second replay draws new ones."""
    from efficient_rpe_vit_torch.models.dense import Dropout
    from efficient_rpe_vit_torch.train.training import _Replays

    drop = Dropout(0.1).train()
    x = torch.ones(1 << 16, device="cuda")
    replays = _Replays(torch.device("cuda"))
    g, ref = (torch.Generator(device="cuda").manual_seed(3) for _ in range(2))
    got = [replays(("masks",), lambda t, gen: (drop(t, gen),), (x,), g)[0]
           for _ in range(3)]  # the warm-up and capture, then two replays
    want = [drop(x, ref) for _ in range(3)]
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    fresh = not torch.equal(got[1], got[2])
    log("multistep", f"dropout masks: eager warm-up, replay 1, replay 2 equal to the eager "
        f"draws {same}; replay 2 differs from replay 1: {fresh}")
    if not (all(same) and fresh and torch.equal(g.get_state(), ref.get_state())):
        raise AssertionError("replayed dropout masks do not follow the generator")


def check_capturable_optimizer() -> None:
    """The card's adam, adamw and sgd (`create_optimizer` builds them capturable,
    with a device fp32 lr, the update every card train step and replay
    takes) against the CPU's, the path tests/test_torch_train.py holds to
    optax: one parameter set and one gradient sequence, weight decay 0.05
    (coupled for adam, decoupled for adamw), a warmup-cosine schedule over
    6 updates through `TrainState.apply_gradients`, the lr checked at each.

    Tolerance: |card - cpu| <= 1e-6 |cpu| + 2e-5 x the CPU parameter's path
    (the sum of its 6 updates' sizes). Capturable Adam computes the bias
    corrections 1 - beta^t on the device in fp32 (optax does too), the CPU
    in float64: fp32(0.999) is within half an ulp, 2.98e-8, of 0.999, so
    1 - beta2^t is within 3e-5 of itself and the update, which divides by
    its root, within 1.5e-5 (beta1's share is 3e-7). A wrong lr, decay or
    bias correction moves an update by far more than that. sgd's update is
    the same fp32 products on both sides (the card multiplies by its device
    lr, the CPU by the same fp32 value)."""
    import torch.nn as nn
    from efficient_rpe_vit_torch.train import TrainState, create_lr_scheduler, create_optimizer

    g = torch.Generator().manual_seed(5)
    w0, b0 = torch.randn(48, 64, generator=g), torch.randn(48, generator=g)
    grads = [(torch.randn(48, 64, generator=g), torch.randn(48, generator=g))
             for _ in range(6)]
    schedule = create_lr_scheduler("warmup_cosine", 0.05, 6, 1, 2)
    for optimizer in ("adam", "adamw", "sgd"):
        states, path = {}, [torch.zeros_like(w0), torch.zeros_like(b0)]
        for device in ("cpu", "cuda"):
            layer = nn.Linear(64, 48).to(device)
            with torch.no_grad():
                layer.weight.copy_(w0)
                layer.bias.copy_(b0)
            states[device] = state = TrainState(model=layer, optimizer=create_optimizer(
                optimizer, layer.parameters(), schedule, 0.05), schedule=schedule)
            for i, (gw, gb) in enumerate(grads):
                before = [p.detach().clone() for p in layer.parameters()]
                layer.weight.grad = gw.to(device)
                layer.bias.grad = gb.to(device)
                state.apply_gradients()
                lr = state.optimizer.param_groups[0]["lr"]
                if device == "cpu":
                    for total, p, q in zip(path, layer.parameters(), before):
                        total += (p.detach() - q).abs()
                    ok = lr == schedule(i)
                else:
                    ok = torch.equal(lr, torch.tensor(schedule(i), dtype=torch.float32,
                                                      device=device))
                if not ok:
                    raise AssertionError(f"{optimizer} on {device}: lr {lr} at update {i}, "
                                         f"schedule {schedule(i)}")
        card = states["cuda"].optimizer
        if not all(g["capturable"] and torch.is_tensor(g["lr"]) and g["lr"].is_cuda
                   for g in card.param_groups):
            raise AssertionError(f"{optimizer} on the card is not capturable with a device lr")
        excess, gap = [], []
        for p_cpu, p_card, walked in zip(states["cpu"].model.parameters(),
                                         states["cuda"].model.parameters(), path):
            diff = (p_card.detach().cpu() - p_cpu.detach()).abs()
            excess.append(float((diff - 1e-6 * p_cpu.detach().abs() - 2e-5 * walked).max()))
            gap.append(float((diff / walked).max()))
        log("multistep", f"capturable {optimizer} on the card vs the CPU path over 6 updates "
            f"(warmup-cosine, peak lr 0.05, weight decay 0.05): max |card - cpu| / path "
            f"{max(gap):.3e}, max |card - cpu| - (1e-6 |cpu| + 2e-5 path) {max(excess):.3e} "
            f"(must be <= 0); path up to {max(float(t.max()) for t in path):.3e}")
        if max(excess) > 0 or min(float(t.min()) for t in path) == 0:
            raise AssertionError(f"capturable {optimizer} on the card differs from the CPU's")


def multistep_check(phase: str, cfg_fields, k: int, replays: int, wrappers, per_step,
                    card: str, profile: bool = False, timed: int = 0,
                    name: str = "performer_favor_most_general", model_kw=None):
    """`make_multi_step` on the card: twin models from one seed, one through
    K-step calls, the other through K eager `make_train_step` steps per
    call, with generators of one seed. The first call runs K eager steps (the
    warm-up) and captures the graph; each of `replays` later calls replays
    it. Losses, corrects, parameters (and the optimiser's state) and the
    generators' states must be bitwise equal after every call; a replay
    launches nothing through a wrapper, so launches are counted at capture:
    the counts are read and zeroed between the warm-up and the capture
    (`_Replays.before_capture`), and read again after the capture. Returns
    the capture's counts as read (expected: K times `per_step`). `name` and
    `model_kw` (create_model keyword arguments) choose the model."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_multi_step, make_train_step

    cfg = mnist_config(**cfg_fields)
    batch, size = cfg_fields["batch_size"], cfg.model.image_size
    models = [create_model(name, cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                           **(model_kw or {})) for _ in range(2)]
    states = [create_train_state(m, cfg, steps_per_epoch=100) for m in models]
    multi, step = make_multi_step(models[0]), make_train_step(models[1])
    g = torch.Generator(device="cuda").manual_seed(7)
    xs = torch.randn(k, batch, size, size, 1, generator=g, device="cuda")
    ys = torch.randint(0, 10, (k, batch), generator=g, device="cuda")
    gens = [torch.Generator(device="cuda").manual_seed(11) for _ in range(2)]
    log(phase, f"{name} {model_kw or ''} dim {cfg.model.dim} depth {cfg.model.depth} "
        f"heads {cfg.model.heads}, N={cfg.model.seq_len}, batch {batch}, bf16, dropout "
        f"{cfg.model.dropout}, {cfg.train.optimizer}, K={k} steps per call")

    def eager():
        out = [step(states[1], xs[i], ys[i], gens[1])[1:] for i in range(k)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def compare(call: str, got):
        want = eager()
        torch.cuda.synchronize()
        differ = _params_differ(models[0], models[1])
        moments = sorted({key for a, b in zip(states[0].optimizer.state.values(),
                                              states[1].optimizer.state.values())
                          for key, t in a.items() if not torch.equal(t, b[key])})
        ok = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and not differ
              and not moments and torch.equal(gens[0].get_state(), gens[1].get_state())
              and states[0].step == states[1].step)
        log(phase, f"{call}: losses {got[0][0].item():.6f} .. {got[0][-1].item():.6f}, "
            f"corrects {got[1].sum().item()}; vs {k} eager steps: losses and corrects "
            f"bitwise {torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])}, "
            f"parameters differing {differ[:3]}{'...' if len(differ) > 3 else ''}, "
            f"optimiser state differing {moments}, generators equal "
            f"{torch.equal(gens[0].get_state(), gens[1].get_state())}, step {states[0].step}")
        if not ok:
            raise AssertionError(f"{call} differs from {k} eager steps")
        if not all(bool(torch.isfinite(t).all()) for t in got[0]):
            raise AssertionError("a training loss is not finite")

    warm_up = {}

    def between_warm_up_and_capture():
        warm_up.update(counts(wrappers))
        zero_counts(wrappers)

    multi.replays.before_capture = between_warm_up_and_capture
    zero_counts(wrappers)
    first = multi(states[0], xs, ys, gens[0])[1:]
    torch.cuda.synchronize()
    captured = counts(wrappers)
    expected = {n: k * c for n, c in per_step.items()}
    log(phase, f"first call: launches in the {k} eager warm-up steps {warm_up}, in the "
        f"capture of {k} steps {captured} (expected {expected} each: {k} x {per_step} "
        "per step; a replay runs them without Python)")
    if warm_up != expected or captured != expected:
        raise AssertionError(f"expected {expected} launches in the warm-up and in the "
                             f"capture, got {warm_up} and {captured}")
    compare("first call", first)
    for r in range(replays):
        zero_counts(wrappers)
        got = multi(states[0], xs, ys, gens[0])[1:]
        torch.cuda.synchronize()
        if any(counts(wrappers).values()):
            raise AssertionError(f"a replay counted launches: {counts(wrappers)}")
        compare(f"replay {r + 1}", got)
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            multi(states[0], xs, ys, gens[0])
        fetch = float(states[0].model.mlp_head[1].weight.detach().float().sum())
        replay_ms = (time.perf_counter() - t0) / (timed * k) * 1e3
        t0 = time.perf_counter()
        for _ in range(timed):
            eager()
        fetch += float(states[1].model.mlp_head[1].weight.detach().float().sum())
        eager_ms = (time.perf_counter() - t0) / (timed * k) * 1e3
        log(phase, f"host clock per step over {timed} calls of {k}: replayed "
            f"{replay_ms:.3f} ms ({batch / replay_ms * 1e3:.1f} images/s), eager "
            f"{eager_ms:.3f} ms ({batch / eager_ms * 1e3:.1f} images/s): "
            f"{eager_ms / replay_ms:.2f}x, on {card} (fetched {fetch:.3f})")
    if profile:
        profile_step(f"one replay of {k} steps", lambda: multi(states[0], xs, ys, gens[0]),
                     card)
    del models, states, multi
    return captured


def engine_phase(wrappers, per_step, per_forward, card: str):
    """Phase 18: a synthetic MNIST DeviceDataset on the card, one epoch of
    the headline model at dropout 0 through `train_epoch` with each loop
    (per batch, K-step `make_multi_step`, gather-fused
    `make_gather_multi_step`) from the same weights and batches: equal
    metrics and bitwise equal parameters; then `evaluate` per batch against
    the gather-fused `make_gather_multi_eval`. Returns the launch counts of
    the loops' run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.data import DeviceDataset
    from efficient_rpe_vit_torch.data.datasets import _synthetic
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import (create_train_state, evaluate, make_eval_step,
                                               make_gather_multi_eval, make_gather_multi_step,
                                               make_multi_step, make_train_step, train_epoch)

    cfg = mnist_config(**dict(HEADLINE, dropout=0.0))
    batch = cfg.train.batch_size
    raw = _synthetic(ENGINE_N, ENGINE_N // 4, 28, 1)
    t0 = time.perf_counter()

    def dataset(split):
        train = split == "train"
        return DeviceDataset(raw[f"{split}_images"], raw[f"{split}_labels"], cfg.data.mean,
                             cfg.data.std, batch, shuffle=train, drop_last=train, seed=0,
                             device="cuda", synthetic=raw["synthetic"])

    probe = dataset("train")
    log("engine", f"synthetic: {probe.synthetic}; MNIST-shaped uint8 dataset on the card: "
        f"{ENGINE_N} train / {ENGINE_N // 4} test images, {tuple(probe.images.shape)} "
        f"{probe.images.dtype}, made in {time.perf_counter() - t0:.2f} s (set-up)")
    if not probe.synthetic:
        raise AssertionError("the synthetic dataset is not flagged")
    loops = {"per batch": lambda m: dict(train_step=make_train_step(m)),
             f"multi_step K={ENGINE_K}": lambda m: dict(
                 train_step=None, multi_step=make_multi_step(m), fused_steps=ENGINE_K),
             f"gather-fused K={ENGINE_K}": lambda m: dict(
                 train_step=None, gather_step=make_gather_multi_step(m),
                 fused_steps=ENGINE_K)}
    runs = {}
    zero_counts(wrappers)
    for name, make in loops.items():
        model = create_model("performer_favor_most_general", cfg, device="cuda",
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, cfg, steps_per_epoch=len(probe))
        t0 = time.perf_counter()
        state, metrics = train_epoch(state, dataset=dataset("train"),
                                     generator=torch.Generator(device="cuda").manual_seed(1),
                                     verbose=False, **make(model))
        log("engine", f"train_epoch, {name}: {metrics} in {time.perf_counter() - t0:.2f} s "
            f"(first calls of each shape run eagerly and capture)")
        runs[name] = (model, metrics)
    (m0, r0), *rest = runs.values()
    for name, (m, r) in zip(list(runs)[1:], rest):
        differ = _params_differ(m0, m)
        same = all(r[key] == r0[key] for key in ("loss", "accuracy", "samples"))
        log("engine", f"{name} vs per batch: metrics equal {same}, parameters differing "
            f"{differ[:3]}")
        if not same or differ:
            raise AssertionError(f"train_epoch with {name} differs from the per-batch loop")
    if not (r0["samples"] == len(probe) * batch and 0 < r0["loss"] < 10):
        raise AssertionError(f"implausible epoch metrics {r0}")
    test = dataset("test")
    plain = evaluate(make_eval_step(m0), test, num_classes=10, detailed=True)
    fused = evaluate(None, test, num_classes=10, detailed=True,
                     gather_eval=make_gather_multi_eval(m0), fused_steps=ENGINE_EVAL_K)
    torch.cuda.synchronize()
    launches = counts(wrappers)
    rel = abs(fused["loss"] - plain["loss"]) / plain["loss"]
    log("engine", f"evaluate: per batch loss {plain['loss']:.6f} acc {plain['accuracy']:.2f}% "
        f"f1_macro {plain['f1_macro']:.4f}; gather-fused K={ENGINE_EVAL_K} loss "
        f"{fused['loss']:.6f} acc {fused['accuracy']:.2f}% (loss rel diff {rel:.1e}, "
        f"sums in another order; tol 1e-6)")
    if not (rel <= 1e-6 and fused["accuracy"] == plain["accuracy"]
            and fused["confusion_matrix"] == plain["confusion_matrix"]
            and fused["samples"] == plain["samples"] == ENGINE_N // 4):
        raise AssertionError("gather-fused evaluate differs from the per-batch one")
    # launches: per batch, and per fused loop the eager warm-up of each
    # chunk shape plus its capture (replays run no wrapper); the evaluations
    # likewise
    steps, chunks = len(probe), -(-len(probe) // ENGINE_K)
    fused_steps = 2 * min(ENGINE_K, steps) + (2 * (steps % ENGINE_K) if steps % ENGINE_K else 0)
    n_eval = len(test)
    eval_fwd = n_eval + 2 * min(ENGINE_EVAL_K, n_eval) + (
        2 * (n_eval % ENGINE_EVAL_K) if n_eval % ENGINE_EVAL_K else 0)
    expected = {n: c * (steps + 2 * fused_steps) + per_forward.get(n, 0) * eval_fwd
                for n, c in per_step.items()}
    log("engine", f"launches {launches} (expected {expected}: {steps} steps per epoch, "
        f"{chunks} chunks per fused epoch)")
    if launches != expected:
        raise AssertionError(f"expected {expected} launches, got {launches}")
    return launches


def _check_metrics(metrics, phase: str = "entry") -> None:
    """The train CLI's metrics hold every key of the JAX CLI's schema, with
    finite numbers, and say the data was synthetic."""
    missing = [f"{section}.{key}" for section, keys in CLI_METRICS_KEYS.items()
               for key in keys
               if key not in (metrics[section][0] if section == "per_epoch"
                              else metrics[section])]
    numbers = [v for section in ("aggregate", "inference") for v in metrics[section].values()
               if isinstance(v, (int, float))]
    numbers += [v for row in metrics["per_epoch"] for v in row.values()]
    finite = all(math.isfinite(v) for v in numbers)
    log(phase, f"metrics JSON: {sum(map(len, CLI_METRICS_KEYS.values()))} keys of the JAX "
        f"schema, missing {missing}; {len(numbers)} numbers all finite: {finite}; "
        f"synthetic_data {metrics['metadata']['synthetic_data']}, backend "
        f"{metrics['metadata']['backend']!r}")
    if missing or not finite or not metrics["metadata"]["synthetic_data"]:
        raise AssertionError("the train CLI's metrics do not follow the JAX schema")


def entry_points_phase(mlc, wrappers, card: str):
    """Phase 19 a-c: the train CLI (`experiments.train.main`) on the card,
    predict from its checkpoint, and a resumed run. Returns the kernel rows'
    timings at the run's shape and the train run's launch counts."""
    import tempfile

    from efficient_rpe_vit_torch.experiments import predict
    from efficient_rpe_vit_torch.experiments import train as train_cli

    fwd_row = check_kernels(mlc, [CLI_SHAPE], BF16_ONLY, timed=[CLI_SHAPE])
    bwd_rows = check_bwd_kernels(mlc, [CLI_SHAPE], BF16_ONLY, timed=CLI_SHAPE)
    with tempfile.TemporaryDirectory() as out:
        flags = CLI_FLAGS + ["--output-dir", out]
        zero_counts(wrappers)
        t0 = time.perf_counter()
        metrics = train_cli.main(flags + ["--epochs", "2"])
        torch.cuda.synchronize()
        launches = counts(wrappers)
        log("entry", f"train CLI {' '.join(flags[:-2])} --epochs 2: done in "
            f"{time.perf_counter() - t0:.1f} s; KERPLE launches {launches}")
        grew = [n for n in ("masked_linear_coeffs_fwd", *BWD_KERNELS[:3]) if launches[n] == 0]
        if grew:
            raise AssertionError(f"the train CLI did not launch {grew}")
        _check_metrics(metrics)
        for row in metrics["per_epoch"]:
            log("entry", f"epoch {row['epoch']}: {row['epoch_time']:.3f} s, train loss "
                f"{row['train_loss']:.4f} acc {row['train_accuracy']:.2f}%, test loss "
                f"{row['test_loss']:.4f} acc {row['test_accuracy']:.2f}%")
        inf = metrics["inference"]
        log("entry", f"inference ({inf['mode']}, chains of {inf['chain_length']}, batch "
            f"{inf['batch_size']}): {inf['throughput_images_per_sec']:.1f} images/s, "
            f"{inf['latency_mean_ms']:.4f} ms/batch mean, p50 {inf['latency_p50_ms']:.4f} ms "
            f"(CUDA events), on {card}")

        # b. predict from the best checkpoint: the checkpointed epoch's numbers
        ckpt = f"{out}/performer_favor_most_general_mnist_best.pt"
        best = max(metrics["per_epoch"], key=lambda r: r["test_accuracy"])  # the first best
        result = predict.main(["--checkpoint", ckpt])
        rel = abs(result["loss"] - best["test_loss"]) / best["test_loss"]
        log("entry", f"predict from the epoch-{best['epoch']} checkpoint: acc "
            f"{result['accuracy']:.2f}% over {result['samples']} (train run "
            f"{best['test_accuracy']:.2f}%), loss {result['loss']:.6f} (train run "
            f"{best['test_loss']:.6f}, rel diff {rel:.1e}, tol 1e-6)")
        if result["accuracy"] != best["test_accuracy"] or rel > 1e-6:
            raise AssertionError("predict disagrees with the train run's evaluation")

        # c. resume from the run's own checkpoint, the best epoch's (ties
        # keep the earlier one, as in JAX): it runs the epochs after it
        resumed = train_cli.main(flags + ["--resume", "auto", "--epochs", "3"])
        epochs = [row["epoch"] for row in resumed["per_epoch"]]
        want = list(range(best["epoch"] + 1, 4))
        log("entry", f"--resume auto --epochs 3 from the epoch-{best['epoch']} checkpoint: "
            f"epochs run {epochs} (expected {want}), test acc "
            f"{resumed['aggregate']['final_test_accuracy']:.2f}%")
        if epochs != want:
            raise AssertionError(f"the resumed run ran epochs {epochs}, expected {want}")
    return fwd_row[("bfloat16", CLI_SHAPE[0])], bwd_rows, launches


def moe_remat_phase(wrappers, card: str):
    """Phase 19 d: ViT-B/16 performer_favor_most_general with the soft-MoE
    MLP, one train step with remat and one without, from the same weights
    and generator state: gradients, #1's launches per step (the recompute
    runs each block's forward again), peak memory and ms per step. Returns
    the remat arm's launch counts of one step."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import count_parameters, create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    cfg = mnist_config(**MOE_VITB)
    batch, size = MOE_VITB["batch_size"], MOE_VITB["image_size"]
    mlp = {"mlp_type": "moe", "num_experts": MOE_EXPERTS}
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(batch, size, size, 3, generator=g, device="cuda")
    y = torch.randint(0, MOE_VITB["num_classes"], (batch,), generator=g, device="cuda")
    arms, grads, launches, peaks = {}, {}, {}, {}
    for remat in (False, True):
        model = create_model("performer_favor_most_general", cfg, mlp_config=mlp,
                             remat=remat, device="cuda",
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, cfg, steps_per_epoch=100)
        step = make_train_step(model)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        state, loss, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), before)
        launches[remat] = counts(wrappers)
        grads[remat] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        arms[remat] = (model, state, step)
        log("moe-remat", f"remat={remat}: {count_parameters(model)['total']:,} parameters, "
            f"step-1 loss {loss.item():.6f}, launches in one step {launches[remat]}, peak "
            f"memory {peaks[remat][0] / 2**30:.3f} GiB ({(peaks[remat][0] - before) / 2**30:.3f} "
            f"GiB above the {before / 2**30:.3f} GiB held before the step)")
        if not bool(torch.isfinite(loss)):
            raise AssertionError("the MoE train loss is not finite")
    rel = {n: ((grads[True][n].float() - t.float()).norm()
               / t.float().norm().clamp_min(1e-30)).item() for n, t in grads[False].items()}
    worst = max(rel, key=rel.get)
    bitwise = all(torch.equal(grads[True][n], t) for n, t in grads[False].items())
    log("moe-remat", f"gradients remat vs plain: {len(rel)} tensors, worst {worst} at "
        f"{rel[worst]:.3e} (tol {MOE_GRAD_RTOL}); bitwise equal: {bitwise}")
    fwd = "masked_linear_coeffs_fwd"
    depth = MOE_VITB["depth"]
    peak_step = {r: peaks[r][0] - peaks[r][1] for r in peaks}
    if rel[worst] > MOE_GRAD_RTOL:
        raise AssertionError("remat gradients disagree with the plain ones")
    if launches[True][fwd] != 2 * depth or launches[False][fwd] != depth:
        raise AssertionError(f"#1 per step: {launches[True][fwd]} with remat, "
                             f"{launches[False][fwd]} without (expected {2 * depth}, {depth})")
    if not peak_step[True] < peak_step[False]:
        raise AssertionError("remat did not lower the step's peak memory")
    for remat, (model, state, step) in arms.items():
        gen = torch.Generator(device="cuda").manual_seed(4)
        for _ in range(MOE_WARMUP):
            state, _, _ = step(state, x, y, gen)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(MOE_TIMED):
            state, loss, _ = step(state, x, y, gen)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / MOE_TIMED
        log("moe-remat", f"remat={remat}: {ms:.3f} ms/step of {batch} (N=197, CUDA events over "
            f"{MOE_TIMED} steps after {MOE_WARMUP}), {batch / ms * 1e3:.1f} images/s, step "
            f"peak {peak_step[remat] / 2**30:.3f} GiB, on {card}")
        if not bool(torch.isfinite(loss)):
            raise AssertionError("the MoE train loss is not finite")
    del arms
    return launches[True]


def _bench_runs(out: str):
    """{(model, run index): metrics} of a benchmark results tree."""
    return {(m, i): json.loads(Path(out, m, f"run_{i}_seed_{seed}",
                                    f"{m}_mnist_metrics.json").read_text())
            for m in BENCH_MODELS for i, seed in enumerate(BENCH_SEEDS)}


def _bench_rows(metrics):
    return [[row[k] for k in BENCH_ROWS] for row in metrics["per_epoch"]]


def _bench_launched(phase: str, launches) -> None:
    missing = [n for names in BENCH_KERNELS.values() for n in names if launches[n] == 0]
    log(phase, f"launches {launches}")
    if missing:
        raise AssertionError(f"the benchmark did not launch {missing}")


def benchmark_phase(wrappers, card: str):
    """Phase 20 a, b: `experiments.benchmark.main` on the card, sequential
    (each model's seeds sharing one `shared` dict), its seed-153 runs
    against standalone train CLI runs bit for bit, `--skip-existing`
    launching nothing, then `--ensemble`, each member bit for bit its
    sequential seed's run. Returns the launch counts of the sequential and
    the ensemble call."""
    import tempfile

    from efficient_rpe_vit_torch.experiments import benchmark
    from efficient_rpe_vit_torch.experiments import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        seq_dir, ens_dir = f"{tmp}/seq", f"{tmp}/ens"
        zero_counts(wrappers)
        t0 = time.perf_counter()
        summary = benchmark.main(BENCH_FLAGS + ["--output-dir", seq_dir])
        torch.cuda.synchronize()
        log("bench", f"benchmark {' '.join(BENCH_FLAGS)}: done in "
            f"{time.perf_counter() - t0:.1f} s")
        seq_launches = counts(wrappers)
        _bench_launched("bench", seq_launches)
        if {m: summary.get(m, {}).get("num_runs") for m in BENCH_MODELS} != dict.fromkeys(
                BENCH_MODELS, 2):
            raise AssertionError(f"the summary lacks runs: {summary}")
        seq = _bench_runs(seq_dir)
        for (model, i), metrics in seq.items():
            _check_metrics(metrics, "bench")
            log("bench", f"{model} seed {BENCH_SEEDS[i]}: epochs " + ", ".join(
                f"{r['epoch_time']:.3f} s" for r in metrics["per_epoch"])
                + f", train {metrics['aggregate']['total_train_time']:.3f} s"
                f"{' (shared: the graphs of seed 42 replayed)' if i else ''}, test acc "
                f"{metrics['aggregate']['final_test_accuracy']:.2f}%, inference "
                f"{metrics['inference']['throughput_images_per_sec']:.1f} images/s, on {card}")

        # seed 153 of each model without `shared`: the same numbers
        args = benchmark.parse_args(BENCH_FLAGS)
        for model in BENCH_MODELS:
            t0 = time.perf_counter()
            alone = train_cli.main(benchmark.train_cli_args(model, BENCH_SEEDS[1],
                                                            f"{tmp}/alone", args))
            torch.cuda.synchronize()
            same = _bench_rows(alone) == _bench_rows(seq[(model, 1)])
            log("bench", f"{model} seed {BENCH_SEEDS[1]} alone: train "
                f"{alone['aggregate']['total_train_time']:.3f} s (with shared "
                f"{seq[(model, 1)]['aggregate']['total_train_time']:.3f} s), the run "
                f"{time.perf_counter() - t0:.3f} s; per-epoch metrics bitwise equal to the "
                f"shared run's: {same}")
            if not same:
                raise AssertionError(f"{model}: the shared run differs from the run alone")

        zero_counts(wrappers)
        again = benchmark.main(BENCH_FLAGS + ["--output-dir", seq_dir, "--skip-existing"])
        idle = counts(wrappers)
        log("bench", f"--skip-existing: runs {[again[m]['num_runs'] for m in BENCH_MODELS]}, "
            f"launches {idle}")
        if any(idle.values()) or any(again[m]["num_runs"] != 2 for m in BENCH_MODELS):
            raise AssertionError("--skip-existing ran kernels or lost runs")

        zero_counts(wrappers)
        t0 = time.perf_counter()
        benchmark.main(BENCH_FLAGS + ["--output-dir", ens_dir, "--ensemble"])
        torch.cuda.synchronize()
        log("ensemble", f"benchmark --ensemble: done in {time.perf_counter() - t0:.1f} s")
        ens_launches = counts(wrappers)
        _bench_launched("ensemble", ens_launches)
        ens = _bench_runs(ens_dir)
        for model in BENCH_MODELS:
            for i, seed in enumerate(BENCH_SEEDS):
                _check_metrics(ens[(model, i)], "ensemble")
                same = _bench_rows(ens[(model, i)]) == _bench_rows(seq[(model, i)])
                log("ensemble", f"{model} member {i} (seed {seed}): per-epoch metrics "
                    f"bitwise equal to the sequential run's: {same}; {_bench_rows(ens[(model, i)])}")
                if not same:
                    raise AssertionError(f"{model} member {i} differs from its sequential run")
            if _bench_rows(ens[(model, 0)]) == _bench_rows(ens[(model, 1)]):
                raise AssertionError(f"{model}: the two members trained alike")
            shared_epochs = [r["epoch_time"] for r in ens[(model, 0)]["per_epoch"]]
            seq_epochs = [sum(seq[(model, i)]["per_epoch"][e]["epoch_time"] for i in range(2))
                          for e in range(len(shared_epochs))]
            log("ensemble", f"{model}: epoch s, ensemble of 2 " + ", ".join(
                f"{t:.3f}" for t in shared_epochs) + "; the two sequential runs together "
                + ", ".join(f"{t:.3f}" for t in seq_epochs) + f" (host clock, on {card})")
    return seq_launches, ens_launches


def ensemble_capture_check(wrappers, card: str) -> None:
    """Phase 20 b: one chunk of K steps of B through
    make_ensemble_gather_multi_step (S members) and through one model's
    make_gather_multi_step, each model at the benchmark's widths: the
    launches each graph holds, counted at capture, S times the single
    model's; then each replayed, timed."""
    import numpy as np

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.data import DeviceDataset
    from efficient_rpe_vit_torch.data.datasets import _synthetic
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import (create_ensemble_train_state, create_train_state,
                                               make_ensemble_gather_multi_step,
                                               make_gather_multi_step)

    cfg = mnist_config(compute_dtype="bfloat16")
    batch = cfg.train.batch_size
    raw = _synthetic(ENSEMBLE_K * batch * 2, 0, 28, 1)
    ds = DeviceDataset(raw["train_images"], raw["train_labels"], cfg.data.mean, cfg.data.std,
                       batch, device="cuda", synthetic=True)
    data = (ds.images, ds.labels, ds.mean, ds.std)
    idx = np.stack([np.random.default_rng(s).permutation(ds.n)[:ENSEMBLE_K * batch]
                    .reshape(ENSEMBLE_K, batch) for s in range(ENSEMBLE_S)])
    for name, kernels in BENCH_KERNELS.items():
        def build(seed):
            return create_model(name, cfg, device="cuda",
                                generator=torch.Generator().manual_seed(seed))

        models = [build(s) for s in range(ENSEMBLE_S)]
        ens_state = create_ensemble_train_state(models, cfg)
        ens_step = make_ensemble_gather_multi_step(models, per_member_order=True)
        single_model = build(0)
        single_state = create_train_state(single_model, cfg)
        single_step = make_gather_multi_step(single_model)
        gens = [torch.Generator(device="cuda").manual_seed(s) for s in range(ENSEMBLE_S)]
        captured, ms = {}, {}
        for arm, step, call in (
                ("ensemble", ens_step, lambda: ens_step(ens_state, *data, idx, gens)),
                ("single", single_step, lambda: single_step(single_state, *data, idx[0],
                                                            gens[0]))):
            step.replays.before_capture = lambda: zero_counts(wrappers)
            call()  # warm-up and capture
            torch.cuda.synchronize()
            captured[arm] = counts(wrappers)
            call()
            ms[arm] = time_ms(call, iters=5, warmup=1)
        want = {n: ENSEMBLE_S * c for n, c in captured["single"].items()}
        log("ensemble", f"{name}: one chunk of K={ENSEMBLE_K} x B={batch}, launches held by "
            f"the graph: ensemble of {ENSEMBLE_S} {captured['ensemble']}, one model "
            f"{captured['single']}; replay {ms['ensemble']:.3f} ms against {ms['single']:.3f} "
            f"ms for one model (CUDA events over 5 replays, on {card})")
        if captured["ensemble"] != want or not all(captured["single"][n] for n in kernels):
            raise AssertionError(f"{name}: the ensemble's graph holds {captured['ensemble']}, "
                                 f"expected {want}")


def bench_flash_check(fa, card: str, flash_shape=BENCH_FLASH_SHAPE):
    """Phase 20 c: #6 and 7a against their plain versions at the
    benchmark baseline's shape (bf16, dropout 0.1; phase 23 d: the sweep's),
    each one's launch_info logged, timed beside its bound and SDPA (dropout
    0; the kernels also at dropout 0, `ms_dropout0`). Returns {kernel:
    row}."""
    B, H, N, D = flash_shape
    rate, dtype, name = BENCH_FLASH_RATE, torch.bfloat16, "bfloat16"
    q, k, v, cot, _, seed = _flash_inputs(B, H, N, D, None, rate, dtype)
    scale = D ** -0.5
    shape = f"B{B} H{H} N{N} D{D} dropout {rate} {name}"
    tol = FLASH_TOL[name]
    infos = {}
    for kname in ("flash_fwd", "flash_bwd_fused"):
        infos[kname] = fa.launch_info(kname, N, D, dtype)
        log("bench-kernel", f"{kname} N={N} D={D} {name}: " + ", ".join(
            f"{key} {value}" for key, value in infos[kname].items()))
    out, lse = fa.flash_attention_fwd(q, k, v, scale, None, rate, seed)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_softmax_attention_reference(q, k, v, scale, None, rate, seed)
    delta = fa.flash_delta(out, cot)
    bwd_args = (q, k, v, cot, lse, delta, scale, None, rate, seed)
    got = fa.flash_attention_bwd_fused(*bwd_args)
    want = fa.flash_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    rels = [_max_rel(out, ref_out)] + [_max_rel(a, b) for a, b in zip(got, want)]
    lse_err = (lse - ref_lse).abs().max().item()
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, *got))
    log("bench-kernel", f"flash {shape}: out, dq, dk, dv max|err|/max|plain| "
        f"{', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), lse max|err| {lse_err:.3e} "
        f"(tol {LSE_ATOL}), finite {finite}")
    if not (finite and max(rels) <= tol and lse_err <= LSE_ATOL):
        raise AssertionError(f"#6 / 7a disagree with their plain versions at {shape}")
    errs = {"flash_fwd": (out.float() - ref_out.float()).abs().max().item(),
            "flash_bwd_fused": max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(got, want))}
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, cot)
    no_drop = (q, k, v, cot, lse, delta, scale)
    timed = {"flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale, None, rate, seed),
                           lambda: fa.flash_softmax_attention_reference(q, k, v, scale, None,
                                                                        rate, seed),
                           lambda: fa.flash_attention_fwd(q, k, v, scale),
                           flash_bound(B, H, N, D, name), lib_fwd),
             "flash_bwd_fused": (lambda: fa.flash_attention_bwd_fused(*bwd_args),
                                 lambda: fa.flash_bwd_reference(*bwd_args),
                                 lambda: fa.flash_attention_bwd_fused(*no_drop),
                                 flash_bwd_bounds(B, H, N, D, name)["flash_bwd_fused"],
                                 lib_bwd)}
    rows = {}
    for kname, (kernel_fn, plain_fn, no_drop_fn, (bound_ms, bound_by), library_ms) in (
            timed.items()):
        ms, ms0 = kernel_ms(kernel_fn), kernel_ms(no_drop_fn)
        plain_ms = time_ms(plain_fn, iters=5, warmup=1)
        log("bench-kernel", f"{kname} {shape}: kernel {ms:.4f} ms (dropout 0: {ms0:.4f}), "
            f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), kernel/bound {ms / bound_ms:.1f}x, on {card}")
        rows[kname] = dict(max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms, ms_dropout0=ms0,
                           launch=infos[kname], shape=list(flash_shape))
    return rows


def timed_against_plain(phase: str, label: str, kernel_fn, plain_fn, agrees, bound,
                        library_fn, shape, card: str, plain_iters: int = 5) -> dict:
    """One kernel row: the kernel's outputs against its plain version's
    (`agrees(got, want)` on each pair, all finite; raises otherwise), then
    the kernel timed in a CUDA graph (kernel_ms), its plain version
    (time_ms), and the library call if there is one, beside `bound`
    (bound_ms, bound_by)."""
    def outputs(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    got, want = outputs(kernel_fn), outputs(plain_fn)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    ok = all(agrees(a, b) and bool(torch.isfinite(a.float()).all()) for a, b in zip(got, want))
    del got, want
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: max|err| {err:.3e}")
    ms = kernel_ms(kernel_fn)
    plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=1)
    library_ms = kernel_ms(library_fn) if library_fn is not None else None
    bound_ms, bound_by = bound
    log(phase, f"{label}: max|err| {err:.3e}, agrees with its plain version; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{'' if library_ms is None else f'SDPA {library_ms:.4f} ms, '}bound "
        f"{bound_ms:.5f} ms ({bound_by}), kernel/bound {ms / bound_ms:.1f}x, on {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=list(shape))


def served_kernel_rows(mlc, fa, cr, card: str):
    """Phase 21: #6, #3 and #8 against their plain versions at the
    mnist-width artifacts' shape (SERVE_SHAPE, bf16, no mask, dropout 0, the
    rotation keeping CLS), timed beside their bounds (#6 also beside SDPA).
    Returns {kernel: row}."""
    B, H, N, D, F_ = SERVE_SHAPE
    name, dtype = "bfloat16", torch.bfloat16
    q, k, v, _, _, _ = _flash_inputs(B, H, N, D, None, 0.0, dtype)
    scale = D ** -0.5
    qf, kf, vf, omega, c = _fused_inputs(B, H, N, D, F_, dtype)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
    theta = torch.randn(H, N, D // 2 + 1, generator=g, device="cuda")
    ct, st = theta.cos().contiguous(), theta.sin().contiguous()
    rtol, atol = OUT_TOL[name]
    cases = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale)[0],
                      lambda: fa.flash_softmax_attention_reference(q, k, v, scale)[0],
                      lambda got, want: _max_rel(got, want) <= FLASH_TOL[name],
                      flash_bound(B, H, N, D, name),
                      lambda: F.scaled_dot_product_attention(q, k, v)),
        "kerple_fused_phi_fwd": (
            lambda: mlc.kerple_attention_fused_phi_fwd(qf, kf, vf, omega, c)[0],
            lambda: mlc.kerple_attention_fused_phi_fwd_reference(qf, kf, vf, omega, c)[0],
            lambda got, want: bool(((got.float() - want.float()).abs()
                                    <= atol + rtol * want.float().abs()).all()),
            fused_phi_bound(B, H, N, D, F_, name), None),
        "circulant_rotate_fwd": (
            lambda: cr.circulant_rotate_fwd(x, ct, st, True),
            lambda: cr.circulant_rotate_fwd_reference(x, ct, st, True),
            lambda got, want: _max_rel(got, want) <= ROT_TOL[name],
            rotation_bounds(B, H, N, D, name)["circulant_rotate_fwd"], None),
    }
    return {kname: timed_against_plain(
        "serve-export", f"{kname} B{B} H{H} N{N} D{D}{f' F{F_}' if 'phi' in kname else ''} "
        f"{name}", *case, SERVE_SHAPE, card) for kname, case in cases.items()}


def serve_artifact(label: str, model, live, wrappers, per_forward, batches, out_dir: str,
                   export_device: str, card: str):
    """One artifact of `model` exported on `export_device`, saved under
    `out_dir` and loaded on the card with `load_exported`; at each batch one
    forward of the artifact from counts of 0 must launch `per_forward`, and
    its logits must equal the live model `live`'s bitwise. Returns the
    launches summed over the batches."""
    from efficient_rpe_vit_torch.serve import load_exported, save_exported

    m = live.image_size, live.in_channels
    t0 = time.perf_counter()
    path = save_exported(f"{out_dir}/{label}.pt2", model, image_size=m[0], in_channels=m[1],
                         device=export_device)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, meta = load_exported(path)
    log("serve-export", f"{label}: exported on {meta['device']} in {t_export:.1f} s, "
        f"{Path(path).stat().st_size} bytes, loaded on the card in "
        f"{time.perf_counter() - t0:.1f} s; out_avals {meta['out_avals']}")
    g = torch.Generator(device="cuda").manual_seed(3)
    total = {n: 0 for n in wrappers}
    for B in batches:
        x = torch.randn(B, m[0], m[0], m[1], generator=g, device="cuda")
        # the main path: counts from 0, read right after
        zero_counts(wrappers)
        got = fn(x)
        torch.cuda.synchronize()
        launches = counts(wrappers)
        with torch.inference_mode():
            want = live(x)
        diff = (got - want).abs().max().item()
        log("serve-export", f"{label} B={B}: launches {launches} (expected {per_forward}); "
            f"logits {tuple(got.shape)} vs the live model: max|diff| {diff:.3e}, bitwise "
            f"{torch.equal(got, want)}")
        if launches != per_forward:
            raise AssertionError(f"{label} launched {launches} at B={B}, expected {per_forward}")
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{label}'s logits differ from the live model's at B={B}")
        for n in total:
            total[n] += launches[n]
    if 32 in batches:
        x = torch.randn(32, m[0], m[0], m[1], generator=g, device="cuda")
        times = {}
        for arm, run in (("artifact", fn), ("live", live)):
            with torch.inference_mode():
                for _ in range(2):
                    run(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    run(x)
                torch.cuda.synchronize()
            times[arm] = (time.perf_counter() - t0) / 10 * 1e3
        log("serve-export", f"{label} B=32, host clock over 10 forwards: artifact "
            f"{times['artifact']:.3f} ms, live model {times['live']:.3f} ms, on {card}")
    return total


def serve_export_phase(mlc, fa, cr, card: str):
    """Phase 21: serving artifacts (`efficient_rpe_vit_torch.serve`) on the
    card: a. the ViT-B/16 flagship (phase 4's model) exported on the card,
    #1 launched 12 times per forward at SERVE_BATCHES; b. `baseline`, the
    fused-phi flagship and `baseline_circulant` at mnist_config widths,
    exported on the card (#6, #3, #8); c. the flagship at those widths
    exported on the CPU, moved to the card (#1); d./e. serve_bench --vitb
    (reduced-weight artifacts: bytes and top-1 agreement against the fp32
    artifact; latency rows). Returns {path: (kernel, launches)} and the
    served kernels' rows at SERVE_SHAPE."""
    import tempfile

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.experiments import serve_bench
    from efficient_rpe_vit_torch.models import create_model

    t_phase = time.perf_counter()
    kerple, flash_k = kerple_wrappers(mlc), flash_wrappers(fa)
    served = {**kerple, **flash_k, "circulant_rotate_fwd": cr.circulant_rotate_fwd}
    info = mlc.launch_info("masked_linear_coeffs_fwd", 197, 266, 64, torch.bfloat16)
    log("serve-export", "masked_linear_coeffs_fwd N=197 F=266 D=64 bfloat16: " + ", ".join(
        f"{key} {value}" for key, value in info.items()))
    if info["kernel"] != "mma.sync":
        raise AssertionError("the flagship artifact's #1 is not the mma.sync kernel")

    def per_forward(**nonzero):
        return {n: nonzero.get(n, 0) for n in served}

    seed = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # a. the ViT-B/16 flagship, exported on the card
        vitb = create_model("performer_favor_most_general", mnist_config(**VITB),
                            device="cuda", generator=seed(), rpe_config={"method": "pallas"})
        out["serve_export_vitb"] = ("masked_linear_coeffs_fwd", serve_artifact(
            "vitb_flagship", vitb, vitb, served,
            per_forward(masked_linear_coeffs_fwd=VITB["depth"]), SERVE_BATCHES, tmp,
            "cuda", card))
        del vitb
        # b. mnist_config widths, exported on the card
        cfg = mnist_config(**SERVE_MNIST)
        depth = cfg.model.depth
        for path, name, kw, kname, n in (
                ("serve_export_baseline", "baseline", {}, "flash_fwd", depth),
                ("serve_export_fused", "performer_favor_most_general",
                 {"attention_config": {"fused_phi": True}}, "kerple_fused_phi_fwd", depth),
                ("serve_export_circulant", "baseline_circulant", {}, "circulant_rotate_fwd",
                 2 * depth)):
            model = create_model(name, cfg, device="cuda", generator=seed(), **kw)
            want = per_forward(**{kname: n}, **({"flash_fwd": depth}
                                                if name == "baseline_circulant" else {}))
            out[path] = (kname, serve_artifact(path.removeprefix("serve_export_"), model, model,
                                               served, want, (SERVE_MNIST_BATCH,), tmp, "cuda",
                                               card))
        # c. the flagship at those widths exported on the CPU, served on the card
        on_cpu = create_model("performer_favor_most_general", cfg, device="cpu",
                              generator=seed())
        live = create_model("performer_favor_most_general", cfg, device="cuda",
                            generator=seed())
        out["serve_export_cpu"] = ("masked_linear_coeffs_fwd", serve_artifact(
            "flagship_cpu_export", on_cpu, live, served,
            per_forward(masked_linear_coeffs_fwd=depth), (SERVE_MNIST_BATCH,), tmp, "cpu",
            card))

        # d. / e. serve_bench --vitb: reduced weights and latency rows
        zero_counts(served)
        t0 = time.perf_counter()
        result = serve_bench.main(["--vitb", "--fit-steps", str(SERVE_FIT_STEPS), "--quick",
                                   "--batches", *map(str, SERVE_BATCHES),
                                   "--out", f"{tmp}/serve_bench.json"])
        torch.cuda.synchronize()
        launches = counts(served)
        log("serve-bench", f"serve_bench --vitb ({result['model']}) in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        if launches["flash_fwd"] == 0:
            raise AssertionError("serve_bench --vitb launched no flash forward")
        out["serve_bench_vitb"] = ("flash_fwd", launches)
    for row in result["rows"]:
        log("serve-bench", json.dumps(row))
    size = {r["case"]: r["artifact_bytes"] for r in result["rows"] if "artifact_bytes" in r}
    agreement = result["agreement_vs_fp32_artifact"]
    for label, factor in SERVE_BYTES_FACTOR.items():
        ratio = size[label] / size["artifact_fp32"]
        a = agreement[label]
        log("serve-bench", f"{label}: {size[label]} bytes, {ratio:.4f}x the fp32 artifact's "
            f"{size['artifact_fp32']} (limit {factor}x); top-1 agreement with the fp32 "
            f"artifact {a['top1_agreement']:.4f} on 64 probes, logit MAE {a['logit_mae']:.4f} "
            f"(|logit| max {a['logit_max_abs']:.2f}), on {card}")
        if ratio >= factor or not math.isfinite(a["logit_mae"]):
            raise AssertionError(f"{label} is not smaller than {factor}x the fp32 artifact "
                                 "or its logits are not finite")
    rows = served_kernel_rows(mlc, fa, cr, card)
    log("serve-export", f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return {path: (kname, launches[kname]) for path, (kname, launches) in out.items()}, rows


def _par_batch(cfg_fields, seed: int = 5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    size, batch = cfg_fields["image_size"], cfg_fields["batch_size"]
    x = torch.randn(batch, size, size, 3, generator=g, device="cuda")
    y = torch.randint(0, cfg_fields["num_classes"], (batch,), generator=g, device="cuda")
    return x, y


def _par_model(name, cfg, mesh=None, moe=None):
    from efficient_rpe_vit_torch.models import create_model

    attention = {"seq_mesh": mesh} if mesh is not None and "seq" in mesh else None
    mlp = None
    if moe:
        mlp = {"mlp_type": "moe", "num_experts": moe}
        if mesh is not None and "expert" in mesh:
            mlp["expert_mesh"] = mesh
    return create_model(name, cfg, attention_config=attention, mlp_config=mlp, device="cuda",
                        generator=torch.Generator().manual_seed(0))


def _par_step_ms(step, state, x, y, gen, steps: int = PAR_TIMED) -> float:
    """Host clock around `steps` steps after one, ended by a synchronise:
    the collectives of a gloo rank wait on the host."""
    state, _, _ = step(state, x, y, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss, _ = step(state, x, y, gen)
    float(loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def parallel_world1(kerple, per_step, card: str):
    """Phase 22 a: one rank on NCCL, in process. The flagship's parallel
    step on data=1, data=1 with FSDP and model=1 against make_train_step on
    the same weights and batch (loss, correct, every gradient and the
    parameters after the step, bit for bit; #1 and #2 launched 12 times
    each), then make_parallel_multi_step at K=4 captured with its NCCL
    all-reduces against 2 x 4 eager parallel steps, bitwise. Returns
    {path: launches}."""
    import os
    import tempfile

    import torch.distributed as dist

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.parallel import (
        comm,
        create_sharded_train_state,
        make_mesh_from_spec,
        make_parallel_multi_step,
        make_parallel_train_step,
    )
    from efficient_rpe_vit_torch.parallel.train_parallel import full_payload
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    out = {}
    try:
        log("parallel", f"world 1 on {dist.get_backend()}: every collective over one rank")
        cfg = mnist_config(**PAR)
        x, y = _par_batch(PAR)
        ref = _par_model(PAR_FLAGSHIP, cfg)
        rstate = create_train_state(ref, cfg, steps_per_epoch=100)
        rstep = make_train_step(ref)
        rstate, rloss, rcorrect = rstep(rstate, x, y, torch.Generator(device="cuda").manual_seed(3))
        ref_grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
        ref_params = {n: t.clone() for n, t in ref.state_dict().items()}
        ref_ms = _par_step_ms(rstep, rstate, x, y, torch.Generator(device="cuda").manual_seed(4))
        del ref, rstate, rstep
        torch.cuda.empty_cache()
        log("parallel", f"make_train_step: loss {rloss.item():.6f}, {ref_ms:.3f} ms/step of "
            f"{PAR['batch_size']} (host clock over {PAR_TIMED} steps after one), on {card}")
        for label, spec, fsdp in PAR_WORLD1:
            mesh = make_mesh_from_spec(spec, device="cuda")
            model = _par_model(PAR_FLAGSHIP, cfg)
            state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=100, fsdp=fsdp)
            step = make_parallel_train_step(model, mesh, state)
            zero_counts(kerple)
            state, loss, correct = step(state, x, y, torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            launches = counts(kerple)
            grads = {n: (state.fsdp.shards[n].grad, state.fsdp.local(n, g)) if fsdp
                     else (dict(model.named_parameters())[n].grad, g)
                     for n, g in ref_grads.items()}
            params = full_payload(state)["model"]
            same = {"loss": torch.equal(loss, rloss), "correct": int(correct) == int(rcorrect),
                    "gradients": all(torch.equal(a, b) for a, b in grads.values()),
                    "parameters": all(torch.equal(params[n], t) for n, t in ref_params.items())}
            ms = _par_step_ms(step, state, x, y, torch.Generator(device="cuda").manual_seed(4))
            log("parallel", f"{label} ({spec}{', fsdp' if fsdp else ''}): launches in one step "
                f"{launches}; bitwise against make_train_step: {same}; {ms:.3f} ms/step "
                f"(make_train_step {ref_ms:.3f}), on {card}")
            if not all(same.values()):
                worst = max(((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)
                             ).item() for a, b in grads.values())
                raise AssertionError(f"world-1 {label} step differs from make_train_step "
                                     f"(worst gradient rel {worst:.3e})")
            if launches != per_step:
                raise AssertionError(f"world-1 {label}: launches {launches}, want {per_step}")
            out[f"parallel_world1_{label}"] = launches
            del model, state, step
            torch.cuda.empty_cache()
        # K steps per CUDA-graph replay with the NCCL all-reduces inside
        mesh = make_mesh_from_spec("data=1", device="cuda")
        g = torch.Generator(device="cuda").manual_seed(6)
        xs = torch.randn(2 * PAR_K, *x.shape, generator=g, device="cuda")
        ys = torch.randint(0, PAR["num_classes"], (2 * PAR_K, x.shape[0]), generator=g,
                           device="cuda")
        graphed, twin = _par_model(PAR_FLAGSHIP, cfg), _par_model(PAR_FLAGSHIP, cfg)
        gstate = create_sharded_train_state(graphed, cfg, mesh, steps_per_epoch=100)
        tstate = create_sharded_train_state(twin, cfg, mesh, steps_per_epoch=100)
        multi = make_parallel_multi_step(graphed, mesh, gstate)
        eager = make_parallel_train_step(twin, mesh, tstate)
        reduces = {"n": 0}
        plain_all_reduce = comm.all_reduce

        def counted(*args, **kwargs):
            reduces["n"] += 1
            return plain_all_reduce(*args, **kwargs)

        warm = {}

        def before_capture():
            warm.update(counts(kerple))
            zero_counts(kerple)
            reduces["n"] = 0
            comm.all_reduce = counted

        multi.replays.before_capture = before_capture
        zero_counts(kerple)
        gen_g, gen_t = (torch.Generator(device="cuda").manual_seed(7) for _ in range(2))
        try:
            gstate, losses1, _ = multi(gstate, xs[:PAR_K], ys[:PAR_K], gen_g)
        finally:
            comm.all_reduce = plain_all_reduce
        captured = counts(kerple)
        captured_reduces = reduces["n"]
        gstate, losses2, corrects2 = multi(gstate, xs[PAR_K:], ys[PAR_K:], gen_g)
        twin_losses = []
        for i in range(2 * PAR_K):
            tstate, loss, _ = eager(tstate, xs[i], ys[i], gen_t)
            twin_losses.append(loss)
        torch.cuda.synchronize()
        same = (torch.equal(torch.cat([losses1, losses2]), torch.stack(twin_losses))
                and all(torch.equal(a, b) for a, b in zip(graphed.parameters(), twin.parameters())))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        gstate, _, _ = multi(gstate, xs[PAR_K:], ys[PAR_K:], gen_g)
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / PAR_K
        eager_ms = _par_step_ms(eager, tstate, xs[0], ys[0], gen_t, PAR_K)
        log("parallel", f"make_parallel_multi_step K={PAR_K} on NCCL: the first call's "
            f"{PAR_K} eager warm-up steps launched {warm}; the capture holds {captured} "
            f"launches and {captured_reduces} NCCL all-reduces (gradient bucket and metrics per "
            f"step); two replays bitwise against {2 * PAR_K} eager parallel steps: {same}; "
            f"replay {replay_ms:.3f} ms/step (CUDA events over one replay), eager "
            f"{eager_ms:.3f} ms/step, on {card}")
        want = {n: PAR_K * c for n, c in per_step.items()}
        if not same or captured != want or captured_reduces != 2 * PAR_K:
            raise AssertionError(f"the K={PAR_K} parallel graph: bitwise {same}, launches "
                                 f"{captured} (want {want}), all-reduces {captured_reduces}")
        out["parallel_multistep_nccl"] = captured
        del graphed, twin, gstate, tstate, multi, eager
        torch.cuda.empty_cache()
        out["pipeline"] = pipeline_world1(cfg, x, y, rloss, rcorrect, ref_grads, ref_ms,
                                          kerple, per_step, card)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return out


def pipeline_world1(cfg, x, y, rloss, rcorrect, ref_grads, ref_ms, kerple, per_step,
                    card: str):
    """Phase 22 a, GPipe: the flagship staged on pipe=1 and trained through
    make_pipeline_train_step at M = 4 against make_train_step's step 1 on
    the same weights and batch, at 22 b's bf16 tolerances; #1 and each #2
    kernel launched M times their per-step count. Returns the launches."""
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        make_mesh_from_spec,
        make_pipeline_train_step,
    )
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    M = PAR_MICROBATCHES
    mesh = make_mesh_from_spec("pipe=1", device="cuda")
    peaks = {}
    for arm in ("make_train_step", "pipeline"):  # the step's peak, above what it began with
        model = _par_model(PAR_FLAGSHIP, cfg)
        if arm == "pipeline":
            state = create_pipeline_train_state(model, cfg, mesh, steps_per_epoch=100)
            step = make_pipeline_train_step(model, mesh, state, n_microbatches=M)
        else:
            state = create_train_state(model, cfg, steps_per_epoch=100)
            step = make_train_step(model)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        zero_counts(kerple)
        state, loss, correct = step(state, x, y, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        peaks[arm] = (torch.cuda.max_memory_allocated() - start) / 2**30
        if arm == "make_train_step":
            del model, state, step
    launches = counts(kerple)
    rel = {n: ((p.grad.float() - ref_grads[n].float()).norm()
               / ref_grads[n].float().norm().clamp_min(1e-30)).item()
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss.item() - rloss.item()) / abs(rloss.item())
    ms = _par_step_ms(step, state, x, y, torch.Generator(device="cuda").manual_seed(4))
    want = {n: M * c for n, c in per_step.items()}
    log("parallel", f"pipeline (pipe=1, M={M} microbatches of {x.shape[0] // M}): launches in "
        f"one step {launches} (want {want}); loss {loss.item():.6f} against make_train_step's "
        f"{rloss.item():.6f} (rel {loss_rel:.3e}, tol {PAR_LOSS_RTOL}), correct {int(correct)} "
        f"({int(rcorrect)}), worst gradient {worst} at {rel[worst]:.3e} of its norm (tol "
        f"{GRAD_REL_TOL}); {ms:.3f} ms/step (make_train_step {ref_ms:.3f}); step peak "
        f"{peaks['pipeline']:.3f} GiB above its start (make_train_step "
        f"{peaks['make_train_step']:.3f}), on {card}")
    if (loss_rel > PAR_LOSS_RTOL or rel[worst] > GRAD_REL_TOL
            or abs(int(correct) - int(rcorrect)) > PAR_CORRECT_SLACK or launches != want):
        raise AssertionError(f"world-1 pipeline step: loss rel {loss_rel:.3e}, worst gradient "
                             f"{worst} {rel[worst]:.3e}, launches {launches} (want {want})")
    del model, state, step
    return launches


def _par_case(label, spec, name, opts, cfg_fields, wrappers, per_step):
    """One parallel case on this rank against the single-process step on
    the card from the same weights and batch; returns its numbers, raises
    when they disagree."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        create_sharded_train_state,
        host_batch_slice,
        make_mesh_from_spec,
        make_parallel_train_step,
        make_pipeline_train_step,
    )
    from efficient_rpe_vit_torch.parallel.mesh import local_slice, param_layouts
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    cfg = mnist_config(**cfg_fields)
    x, y = _par_batch(cfg_fields)
    moe = opts.get("moe")
    ref = _par_model(name, cfg, moe=moe)
    rstate = create_train_state(ref, cfg, steps_per_epoch=100)
    zero_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    ref_start = torch.cuda.memory_allocated()
    _, rloss, rcorrect = make_train_step(ref)(rstate, x, y,
                                              torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    ref_peak = torch.cuda.max_memory_allocated()
    ref_launches = counts(wrappers)
    ref_grads = {n: p.grad.float().clone() for n, p in ref.named_parameters()}
    del ref, rstate
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh_from_spec(spec, device="cuda")
    model = _par_model(name, cfg, mesh, moe)
    if "pipe" in mesh:  # the GPipe step takes the global batch
        state = create_pipeline_train_state(model, cfg, mesh, steps_per_epoch=100)
        step = make_pipeline_train_step(model, mesh, state, n_microbatches=opts["microbatches"])
        rows = slice(None)
    else:
        state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=100,
                                           fsdp=opts.get("fsdp", False))
        step = make_parallel_train_step(model, mesh, state)
        rows = host_batch_slice(x.shape[0], mesh)
    zero_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    state, loss, correct = step(state, x[rows], y[rows],
                                torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counts(wrappers)
    layouts = param_layouts(model)
    rel = {}
    for n, p in model.named_parameters():
        want = ref_grads[n]
        if n in layouts:
            shard, dim, blocks = layouts[n]
            want = local_slice(want, dim, blocks, shard.index, shard.count)
        got = p.grad
        if state.fsdp is not None:
            want, got = state.fsdp.local(n, want), state.fsdp.shards[n].grad
        rel[n] = ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    ms = _par_step_ms(step, state, x[rows], y[rows], torch.Generator(device="cuda").manual_seed(4),
                      steps=1)
    heads = next(b.attention.heads for b in model.transformer_blocks if hasattr(b, "attention"))
    result = dict(loss=loss.item(), ref_loss=rloss.item(), correct=int(correct),
                  ref_correct=int(rcorrect), worst=worst, worst_rel=rel[worst], ms=ms,
                  launches=launches, ref_launches=ref_launches, heads=heads, peak=peak,
                  ref_peak=ref_peak, start=start, ref_start=ref_start)
    loss_rel = abs(result["loss"] - result["ref_loss"]) / abs(result["ref_loss"])
    if (loss_rel > PAR_LOSS_RTOL or rel[worst] > GRAD_REL_TOL
            or abs(result["correct"] - result["ref_correct"]) > PAR_CORRECT_SLACK
            or (per_step is not None and launches != per_step)):
        raise AssertionError(f"{label}: {result}")
    del model, state, step, ref_grads
    torch.cuda.empty_cache()
    return result


def _par_rank(rank: int, tmp: str, backend: str) -> None:
    """A rank of phase 22 b / c: two processes share the card over gloo
    (or, with NCCL, rank r takes card r)."""
    import os

    import torch.distributed as dist

    from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
    from efficient_rpe_vit_torch.parallel import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = backend == "nccl"
    torch.cuda.set_device(rank if nccl else 0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 2),
                            rank=rank, world_size=2,
                            **({"device_id": torch.device("cuda", rank)} if nccl else {}))
    wrappers = {**kerple_wrappers(mlc), **flash_wrappers(fa)}
    kerple_step = {n: 0 if n == "kerple_fused_phi_fwd" else VITB["depth"]
                   for n in kerple_wrappers(mlc)}
    none = {n: 0 for n in wrappers}
    results = {}
    for label, spec, name, opts in PAR_CASES:
        per_step = ({**none, **kerple_step} if name == PAR_FLAGSHIP and "seq" not in spec
                    else none)
        if "pipe" in spec:  # a stage's blocks, once per microbatch
            per_step = {n: c * opts["microbatches"] // 2 for n, c in per_step.items()}
        results[label] = _par_case(label, spec, name, opts, PAR, wrappers, per_step)
    results["parallel_cp2_longn"] = _par_case("parallel_cp2_longn", "seq=2", PAR_FLAGSHIP, {},
                                              PAR_LONGN, wrappers, none)
    results["staged"] = sorted(comm.staged_ops())
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def parallel_two_ranks(card: str, backend: str = "gloo"):
    """Phase 22 b / c: two spawned processes share the card over gloo
    (d: with NCCL, one card each), the kernels already built by this
    process; returns rank 0's results, each case's launches checked on
    both ranks."""
    import multiprocessing
    import tempfile

    tmp = tempfile.mkdtemp()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_par_rank, args=(rank, tmp, backend)) for rank in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"the two {backend} ranks exited with {codes}")
    ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(2)]
    where = "one card over gloo" if backend == "gloo" else "two cards over NCCL"
    log("parallel", f"two ranks on {where}: {time.perf_counter() - t0:.1f} s "
        f"including the spawn; ops staged through host memory: {ranks[0]['staged']}")
    for label in (*(c[0] for c in PAR_CASES), "parallel_cp2_longn"):
        for r, res in enumerate(ranks):
            log("parallel", f"{label} rank {r}: loss {res[label]['loss']:.6f} (single process "
                f"{res[label]['ref_loss']:.6f}), correct {res[label]['correct']} "
                f"({res[label]['ref_correct']}), worst gradient {res[label]['worst']} at "
                f"{res[label]['worst_rel']:.3e} of its norm (tol {GRAD_REL_TOL}), "
                f"{res[label]['heads']} heads per rank, launches in one step "
                f"{res[label]['launches']} (single process {res[label]['ref_launches']}), "
                f"{res[label]['ms']:.1f} ms/step ({'host-staged gloo' if backend == 'gloo' else 'NCCL'}), peak memory "
                f"{res[label]['peak'] / 2**30:.3f} GiB, {res[label]['start'] / 2**30:.3f} at the "
                f"step's start (single process {res[label]['ref_peak'] / 2**30:.3f}, "
                f"{res[label]['ref_start'] / 2**30:.3f}), on {card}")
        if ranks[0][label]["launches"] != ranks[1][label]["launches"]:
            raise AssertionError(f"{label}: the ranks launched different kernels")
        if label == "parallel_pp2":
            gib = lambda r, k: round(r[label][k] / 2**30, 3)  # noqa: E731
            log("parallel", f"parallel_pp2 (pipe=2, M={PAR_MICROBATCHES}): rank peak memory "
                f"{[gib(r, 'peak') for r in ranks]} GiB (allocated when the step began "
                f"{[gib(r, 'start') for r in ranks]}) against the single process's "
                f"{gib(ranks[0], 'ref_peak')} ({gib(ranks[0], 'ref_start')}) GiB; host-staged "
                f"{[round(r[label]['ms'], 1) for r in ranks]} ms/step, on {card}")
    if ranks[0]["parallel_tp2"]["heads"] != 6:
        raise AssertionError("the model=2 rank does not hold 6 heads")
    return ranks[0]


def parallel_phase(mlc, kerple, card: str):
    """Phase 22: parallelism on the one card. Returns {path: (launches,
    forward row, backward rows)} for the kernels line."""
    depth = VITB["depth"]
    per_step = {n: 0 if n == "kerple_fused_phi_fwd" else depth for n in kerple}
    world1 = parallel_world1(kerple, per_step, card)
    log("parallel", f"#1 launch_info at the model=2 rank's shape (H = 6 of 12 heads): "
        f"{check_kerple_rule(mlc, KERPLE_FORWARDS[0], 197, 266, 64, torch.bfloat16, 'parallel')}")
    rows = {}
    for key, shape in PAR_SHAPES.items():
        rows[key] = (check_kernels(mlc, [shape], BF16_ONLY, timed=[shape])[("bfloat16", shape[0])],
                     check_bwd_kernels(mlc, [shape], BF16_ONLY, timed=shape))
    two = parallel_two_ranks(card)
    if torch.cuda.device_count() > 1:
        parallel_two_ranks(card, "nccl")
    else:
        log("parallel", "22 d not run: this machine has 1 card, and NCCL takes one rank per "
            "card, so the multi-rank cases ran over gloo on the one card (22 b)")
    return world1, rows, two

# ─── phase 23: the rest of Queue A ──────────────────────────────────────

def _qa_member(cfg, i):
    from efficient_rpe_vit_torch.models import create_model

    return create_model(PAR_FLAGSHIP, cfg, device="cuda",
                        generator=torch.Generator().manual_seed(100 + i))


def _qa_batch(cfg, seed: int = 9):
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = cfg.model
    batch = cfg.train.batch_size
    x = torch.randn(batch, m.image_size, m.image_size, m.in_channels, generator=g,
                    device="cuda")
    return x, torch.randint(0, m.num_classes, (batch,), generator=g, device="cuda")


def _cpu_state(model):
    return {n: t.detach().cpu() for n, t in model.state_dict().items()}


def _ckpt_tensors(state):
    """This rank's own tensors of a train state by name: the model's (or its
    FSDP shards), the optimiser's state and the step."""
    owned = dict(state._stepped())
    out = {f"model.{n}": owned.get(n, t) for n, t in state.model.state_dict().items()}
    for n, p in owned.items():
        out.update((f"optimizer.{n}.{k}", v) for k, v in state.optimizer.state[p].items())
    out["step"] = torch.tensor(state.step)
    return out


def _sharded_round_trip(label, build, x, y, out_dir: str):
    """Phase 23 b on one layout: `build(seed)` -> (state, step); one step,
    then the sharded directory and the single gathered file of that state,
    each timed; a fresh state of another seed loads the directory (timed)
    and must hold this rank's tensors bit for bit. Returns a dict of bytes
    and seconds."""
    import os

    import torch.distributed as dist

    from efficient_rpe_vit_torch.train import (load_checkpoint_sharded, save_checkpoint,
                                               save_checkpoint_sharded)

    rank = dist.get_rank()
    state, step = build(0)
    state, _, _ = step(state, x, y, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    path = os.path.join(out_dir, f"{label}_orbax")
    t0 = time.perf_counter()
    save_checkpoint_sharded(path, state, epoch=1)
    save_s = time.perf_counter() - t0
    single = os.path.join(out_dir, f"{label}.pt")
    t0 = time.perf_counter()
    save_checkpoint(single, state, epoch=1)
    dist.barrier()
    single_s = time.perf_counter() - t0
    want = {k: t.detach().clone() for k, t in _ckpt_tensors(state).items()}
    del state, step
    fresh, _ = build(7)  # a fresh Adam makes its moments on the load
    t0 = time.perf_counter()
    fresh, _ = load_checkpoint_sharded(path, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = _ckpt_tensors(fresh)
    differ = sorted(k for k in set(want) | set(got)
                    if k not in got or k not in want or not torch.equal(want[k], got[k]))
    files = sorted(f for f in os.listdir(path) if f.endswith(".distcp"))
    result = {"rank_bytes": os.path.getsize(os.path.join(path, f"__{rank}_0.distcp")),
              "files": files, "single_bytes": os.path.getsize(single),
              "save_s": save_s, "single_s": single_s, "load_s": load_s, "differ": differ}
    del fresh
    torch.cuda.empty_cache()
    return result


def _qa_ckpt_states(mesh, fsdp: bool):
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.parallel import (create_sharded_train_state,
                                                  make_parallel_train_step)

    cfg = mnist_config(**QA_CKPT)

    def build(seed):
        model = create_model(PAR_FLAGSHIP, cfg, device="cuda",
                             generator=torch.Generator().manual_seed(seed))
        state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=100, fsdp=fsdp)
        return state, make_parallel_train_step(model, mesh, state)

    return build


def _qa_rank(rank: int, tmp: str) -> None:
    """A rank of phase 23 a and b: two processes share the card over gloo.
    a) this rank's members of the S = 4 ensemble through three calls of
    make_ensemble_train_step(mesh=); b) the FSDP flagship's sharded
    checkpoint."""
    import os

    import torch.distributed as dist

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
    from efficient_rpe_vit_torch.parallel import host_batch_slice, make_mesh_from_spec
    from efficient_rpe_vit_torch.train import (create_ensemble_train_state, ensemble_members,
                                               make_ensemble_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2),
                            rank=rank, world_size=2)
    mesh = make_mesh_from_spec("data=2", device="cuda")
    wrappers = kerple_wrappers(mlc)
    cfg = mnist_config(**QA)
    mine = list(ensemble_members(QA_S, mesh))
    models = [_qa_member(cfg, i) for i in mine]
    state = create_ensemble_train_state(models, cfg, steps_per_epoch=100)
    step = make_ensemble_train_step(models, mesh=mesh)
    x, y = _qa_batch(cfg)
    gens = [torch.Generator(device="cuda").manual_seed(200 + i) for i in mine]
    step.replays.before_capture = lambda: zero_counts(wrappers)
    calls, captured = [], None
    for call in range(QA_CALLS):
        state, losses, corrects = step(state, x, y, gens)
        if call == 0:
            captured = counts(wrappers)
        calls.append((losses.cpu(), corrects.cpu()))
    members = {i: _cpu_state(m.model) for i, m in zip(mine, state.members)}
    replay_ms = time_ms(lambda: step(state, x, y, gens), iters=5, warmup=1)
    del state, step, models
    torch.cuda.empty_cache()

    ckpt_x, ckpt_y = _par_batch(QA_CKPT)
    rows = host_batch_slice(ckpt_x.shape[0], mesh)
    ckpt = _sharded_round_trip("fsdp2", _qa_ckpt_states(mesh, fsdp=True), ckpt_x[rows],
                               ckpt_y[rows], tmp)
    torch.save({"mine": mine, "calls": calls, "members": members, "captured": captured,
                "replay_ms": replay_ms, "ckpt": ckpt}, os.path.join(tmp, f"qa{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def qa_two_ranks(per_member, card: str):
    """Phase 23 a and the gloo half of b: spawn the two ranks, then hold
    their ensemble members and results to the single-process ensemble on
    the card. Returns the launches a rank's graph holds."""
    import multiprocessing
    import os
    import shutil
    import tempfile

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.train import create_ensemble_train_state, make_ensemble_train_step

    cfg = mnist_config(**QA)
    models = [_qa_member(cfg, i) for i in range(QA_S)]
    state = create_ensemble_train_state(models, cfg, steps_per_epoch=100)
    step = make_ensemble_train_step(models)
    x, y = _qa_batch(cfg)
    gens = [torch.Generator(device="cuda").manual_seed(200 + i) for i in range(QA_S)]
    single = []
    for _ in range(QA_CALLS):
        state, losses, corrects = step(state, x, y, gens)
        single.append((losses.cpu(), corrects.cpu()))
    single_members = [_cpu_state(m) for m in models]
    single_ms = time_ms(lambda: step(state, x, y, gens), iters=5, warmup=1)
    del state, step, models
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_qa_rank, args=(rank, tmp)) for rank in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"the two phase-23 ranks exited with {codes}")
    ranks = [torch.load(os.path.join(tmp, f"qa{r}.pt")) for r in range(2)]
    shutil.rmtree(tmp, ignore_errors=True)
    log("qa-ensemble", f"two gloo ranks on the card: {time.perf_counter() - t0:.1f} s "
        "including the spawn")
    want = {n: 2 * c for n, c in per_member.items()}
    for r, res in enumerate(ranks):
        same_calls = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                      for a, b in zip(res["calls"], single)]
        differ = {i: [n for n, t in res["members"][i].items()
                      if not torch.equal(t, single_members[i][n])] for i in res["mine"]}
        log("qa-ensemble", f"rank {r}: members {res['mine']}, {QA_CALLS} calls' gathered "
            f"losses and corrects bitwise the single-process step's {same_calls} (last "
            f"losses {res['calls'][-1][0].tolist()}), members' tensors differing {differ}, "
            f"launches its graph holds {res['captured']} (want {want}: 2 members x "
            f"{per_member}), replay {res['replay_ms']:.3f} ms a step of its 2 members against "
            f"{single_ms:.3f} ms for the single process's 4 (CUDA events, host-staged "
            f"all-gather included; on {card})")
        if not all(same_calls) or any(differ.values()) or res["captured"] != want:
            raise AssertionError(f"phase 23 a rank {r}: the sharded ensemble differs")
    if sorted(i for res in ranks for i in res["mine"]) != list(range(QA_S)):
        raise AssertionError("the ranks do not hold the S members between them")
    for r, res in enumerate(ranks):
        c = res["ckpt"]
        log("qa-checkpoint", f"data=2 FSDP over gloo, rank {r}: files {c['files']}, this "
            f"rank's {c['rank_bytes']} bytes against the single gathered file's "
            f"{c['single_bytes']} ({c['rank_bytes'] / c['single_bytes']:.3f}x); sharded save "
            f"{c['save_s']:.3f} s, gathered save {c['single_s']:.3f} s, sharded load "
            f"{c['load_s']:.3f} s; tensors differing after the load {c['differ']} (on {card})")
        if c["differ"] or c["files"] != ["__0_0.distcp", "__1_0.distcp"]:
            raise AssertionError(f"phase 23 b rank {r}: the FSDP restore differs")
    return ranks[0]["captured"]


def qa_world1(per_step, card: str):
    """Phase 23 b on one NCCL rank (in process): the flagship's sharded
    checkpoint on data=1, then make_parallel_multi_step of the headline
    model with feature redraw every 2 calls. Returns the redraw graph's
    launches counted at capture."""
    import os
    import tempfile

    import torch.distributed as dist

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
    from efficient_rpe_vit_torch.parallel import (create_sharded_train_state,
                                                  make_mesh_from_spec, make_parallel_multi_step,
                                                  make_parallel_train_step)

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh_from_spec("data=1", device="cuda")
        x, y = _par_batch(QA_CKPT)
        c = _sharded_round_trip("data1", _qa_ckpt_states(mesh, fsdp=False), x, y, tmp)
        log("qa-checkpoint", f"data=1 on NCCL: {c['files']}, {c['rank_bytes']} bytes against "
            f"the single file's {c['single_bytes']} "
            f"({c['rank_bytes'] / c['single_bytes']:.3f}x); sharded save {c['save_s']:.3f} s, "
            f"single-file save {c['single_s']:.3f} s, sharded load {c['load_s']:.3f} s; "
            f"tensors differing after the load {c['differ']} (on {card})")
        if c["differ"]:
            raise AssertionError("phase 23 b: the data=1 restore differs")

        cfg = mnist_config(**HEADLINE)
        wrappers = kerple_wrappers(mlc)
        twins = []
        for _ in range(2):
            model = create_model(PAR_FLAGSHIP, cfg, device="cuda",
                                 attention_config={"feature_redraw_interval": 2},
                                 generator=torch.Generator().manual_seed(0))
            state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=100)
            twins.append((model, state))
        multi = make_parallel_multi_step(twins[0][0], mesh, twins[0][1])
        eager = make_parallel_train_step(twins[1][0], mesh, twins[1][1])
        g = torch.Generator(device="cuda").manual_seed(7)
        size, batch = cfg.model.image_size, cfg.train.batch_size
        xs = torch.randn(REDRAW_K, batch, size, size, 1, generator=g, device="cuda")
        ys = torch.randint(0, 10, (REDRAW_K, batch), generator=g, device="cuda")
        gens = [torch.Generator(device="cuda").manual_seed(11) for _ in range(2)]
        multi.replays.before_capture = lambda: zero_counts(wrappers)
        results = []
        for call in range(1 + REDRAW_REPLAYS):
            _, losses, corrects = multi(twins[0][1], xs, ys, gens[0])
            if call == 0:
                captured = counts(wrappers)
            want = [eager(twins[1][1], xs[i], ys[i], gens[1])[1:] for i in range(REDRAW_K)]
            torch.cuda.synchronize()
            differ = _params_differ(twins[0][0], twins[1][0])
            results.append(torch.equal(losses, torch.stack([w[0] for w in want]))
                           and torch.equal(corrects, torch.stack([w[1] for w in want]))
                           and not differ and torch.equal(gens[0].get_state(),
                                                          gens[1].get_state()))
        want_launches = {n: REDRAW_K * c for n, c in per_step.items()}
        log("qa-redraw", f"make_parallel_multi_step K={REDRAW_K} on NCCL, headline model with "
            f"feature redraw every 2 calls: graphs {len(multi.replays.graphs)}, calls bitwise "
            f"against eager parallel steps (Omega and counters included) {results}, launches "
            f"at capture {captured} (want {want_launches}), on {card}")
        if not all(results) or len(multi.replays.graphs) != 1 or captured != want_launches:
            raise AssertionError("phase 23 b: the parallel redraw graph differs")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return captured


def qa_importer(mlc, card: str):
    """Phase 23 c: a reference-format file from a port model, imported on
    the card and served by predict. Returns (launches, #1's row at the
    served shape, fp32)."""
    import os
    import tempfile

    import numpy as np

    from efficient_rpe_vit_torch.configs import get_dataset_config
    from efficient_rpe_vit_torch.experiments import import_checkpoint, predict
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, load_checkpoint

    tmp = tempfile.mkdtemp()
    cfg = get_dataset_config("mnist")
    source = create_model(PAR_FLAGSHIP, cfg, device="cpu",
                          generator=torch.Generator().manual_seed(11))
    ref = os.path.join(tmp, "ref.pt")
    torch.save({"model_state_dict": source.state_dict(), "epoch": 5,
                "metrics": {"test_accuracy": 93.0}}, ref)
    out = os.path.join(tmp, "imported.pt")
    t0 = time.perf_counter()
    import_checkpoint.main(["--torch-checkpoint", ref, "--model", PAR_FLAGSHIP,
                            "--dataset", "mnist", "--output", out])
    import_s = time.perf_counter() - t0
    x = np.random.default_rng(0).normal(size=(CLI_SHAPE[0], 28, 28, 1)).astype(np.float32)
    np.save(os.path.join(tmp, "x.npy"), x)
    wrappers = kerple_wrappers(mlc)
    zero_counts(wrappers)
    preds = predict.main(["--checkpoint", out, "--input", os.path.join(tmp, "x.npy")])
    torch.cuda.synchronize()
    launches = counts(wrappers)
    source = source.to("cuda").eval()
    imported = create_model(PAR_FLAGSHIP, cfg, device="cuda",
                            generator=torch.Generator().manual_seed(3))
    state, meta = load_checkpoint(out, create_train_state(imported, cfg))
    data = cfg.data
    xn = torch.from_numpy(predict._normalise(x, np.asarray(data.mean, np.float32),
                                             np.asarray(data.std, np.float32))).cuda()
    with torch.inference_mode():
        want, got = source(xn), state.model.eval()(xn)
    same = torch.equal(want, got)
    agree = preds.tolist() == want.argmax(-1).tolist()
    per_forward = {n: cfg.model.depth if n == "masked_linear_coeffs_fwd" else 0
                   for n in wrappers}
    log("qa-import", f"imported in {import_s:.2f} s on the card (metadata {meta['metadata']}); "
        f"predict --input: launches {launches} (want {per_forward}), predictions the source "
        f"model's {agree}; imported logits bitwise the source model's {same} (on {card})")
    if not (same and agree) or launches != per_forward:
        raise AssertionError("phase 23 c: the imported checkpoint does not serve the source model")
    row = check_kernels(mlc, [CLI_SHAPE], DTYPES[1:], timed=[CLI_SHAPE])[("float32", CLI_SHAPE[0])]
    return launches, row


def sweep_rotation_check(cr, card: str):
    """Phase 23 d: the rotation kernels (#8, #9) at the sweep's shape
    SWEEP_FLASH_SHAPE in bf16 with keep_cls, on q and k as the circulant
    variants give them (views of the fused qkv's head split): launch_info
    (the mma.sync kernels, no spills), the results against the plain
    versions, and times beside rotation_bounds. Returns {kernel: row}."""
    B, H, N, D = SWEEP_FLASH_SHAPE
    shape = f"B{B} H{H} N{N} D{D} bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(23)
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device="cuda").to(torch.bfloat16)
    x, cot = (t.reshape(B, N, H, D).transpose(1, 2) for t in qkv.chunk(3, dim=-1)[:2])
    theta = torch.randn(H, N, D // 2 + 1, generator=gen, device="cuda") * 0.3
    ct, st = theta.cos(), theta.sin()
    infos = check_rotation_launch_info(cr, N, D, torch.bfloat16, x.stride()[:3], main_path=True)
    fns = {
        "circulant_rotate_fwd": (lambda: cr.circulant_rotate_fwd(x, ct, st, True),
                                 lambda: cr.circulant_rotate_fwd_reference(x, ct, st, True)),
        "circulant_rotate_bwd": (lambda: cr.circulant_rotate_bwd(cot, x, ct, st, True),
                                 lambda: cr.circulant_rotate_bwd_reference(cot, x, ct, st, True)),
    }
    got = (fns["circulant_rotate_fwd"][0](), *fns["circulant_rotate_bwd"][0]())
    want = (fns["circulant_rotate_fwd"][1](), *fns["circulant_rotate_bwd"][1]())
    torch.cuda.synchronize()
    rels = [_max_rel(a, b) for a, b in zip(got, want)]
    tols = (ROT_TOL["bfloat16"],) * 2 + (ROT_ANGLE_TOL,) * 2
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    log("kernel", f"circulant_rotate {shape} keep_cls, strides {tuple(x.stride())}: (out, dx, "
        f"dct, dst) max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)} (tol {tols[0]}, "
        f"{tols[2]}), finite {finite}")
    if not (finite and all(r <= t for r, t in zip(rels, tols))):
        raise AssertionError(f"phase 23 d: circulant_rotate disagrees with its plain version "
                             f"at {shape}")
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    errs = {"circulant_rotate_fwd": errs[0], "circulant_rotate_bwd": max(errs[1:])}
    bounds = rotation_bounds(B, H, N, D, "bfloat16")
    rows = {}
    for kname, (kernel_fn, plain_fn) in fns.items():
        ms = kernel_ms(kernel_fn)
        plain_ms = time_ms(plain_fn, iters=5, warmup=1)
        bound_ms, bound_by = bounds[kname]
        log("kernel", f"{kname} {shape} keep_cls: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}), kernel/bound {ms / bound_ms:.2f}x, on {card}")
        rows[kname] = dict(max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None, launch=infos[kname])
    return rows


def qa_sweep(mlc, fa, cr, wrappers, card: str):
    """Phase 23 d: the throughput sweep at cifar10 and mnist. Returns
    ({path: launches}, {kernel: row at the sweep's shapes})."""
    import math

    from efficient_rpe_vit_torch.experiments import throughput_sweep

    out = {}
    for dataset in ("cifar10", "mnist"):
        zero_counts(wrappers)
        t0 = time.perf_counter()
        results = throughput_sweep.sweep(dataset, SWEEP_BATCH, SWEEP_STEPS, card, verbose=False)
        torch.cuda.synchronize()
        launched = counts(wrappers)
        for name, row in results["variants"].items():
            log("qa-sweep", f"{dataset} bs {SWEEP_BATCH} bf16 {name}: "
                f"{row['images_per_sec']} images/s, {row['ms_per_step']} ms/step "
                f"({results['protocol']}, on {card})")
            if not all(math.isfinite(v) and v > 0 for v in row.values()):
                raise AssertionError(f"phase 23 d: {dataset} {name} row {row}")
        log("qa-sweep", f"{dataset}: {len(results['variants'])} variants in "
            f"{time.perf_counter() - t0:.1f} s; launches {launched}")
        if not all(launched[n] for n in (*KERPLE_FORWARDS[:1], *BWD_KERNELS, "flash_fwd",
                                         "flash_bwd_fused", "circulant_rotate_fwd",
                                         "circulant_rotate_bwd")):
            raise AssertionError(f"phase 23 d: a kernel of the sweep was not launched: {launched}")
        out[f"sweep_{dataset}"] = launched
    fwd_row = check_kernels(mlc, [SWEEP_SHAPE], BF16_ONLY, timed=[SWEEP_SHAPE])[
        ("bfloat16", SWEEP_BATCH)]
    bwd_rows = check_bwd_kernels(mlc, [SWEEP_SHAPE], BF16_ONLY, timed=SWEEP_SHAPE)
    flash_rows = bench_flash_check(fa, card, SWEEP_FLASH_SHAPE)
    return out, (fwd_row, bwd_rows, flash_rows, sweep_rotation_check(cr, card))


def redraw_multistep_check(interval: int, wrappers, per_step, card: str):
    """Phase 23 e: make_multi_step of the headline model with feature redraw
    every `interval` calls at K = REDRAW_K, called until REDRAW_REPLAYS
    calls have replayed; every call against REDRAW_K eager steps of a twin.
    Returns the launches of the first capture."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_multi_step, make_train_step

    cfg = mnist_config(**HEADLINE)
    models = [create_model(PAR_FLAGSHIP, cfg, device="cuda",
                           attention_config={"feature_redraw_interval": interval},
                           generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    states = [create_train_state(m, cfg, steps_per_epoch=100) for m in models]
    multi, step = make_multi_step(models[0]), make_train_step(models[1])
    g = torch.Generator(device="cuda").manual_seed(7)
    size, batch = cfg.model.image_size, cfg.train.batch_size
    xs = torch.randn(REDRAW_K, batch, size, size, 1, generator=g, device="cuda")
    ys = torch.randint(0, 10, (REDRAW_K, batch), generator=g, device="cuda")
    gens = [torch.Generator(device="cuda").manual_seed(11) for _ in range(2)]
    captures = []
    multi.replays.before_capture = lambda: zero_counts(wrappers)
    replayed, calls, log_calls = 0, 0, []
    want_launches = {n: REDRAW_K * c for n, c in per_step.items()}
    while replayed < REDRAW_REPLAYS:
        graphs = len(multi.replays.graphs)
        zero_counts(wrappers)
        _, losses, corrects = multi(states[0], xs, ys, gens[0])
        captured = len(multi.replays.graphs) > graphs
        if captured:
            captures.append(counts(wrappers))
        else:
            replayed += 1
            if any(counts(wrappers).values()):
                raise AssertionError(f"a replay counted launches: {counts(wrappers)}")
        out = [step(states[1], xs[i], ys[i], gens[1])[1:] for i in range(REDRAW_K)]
        torch.cuda.synchronize()
        differ = _params_differ(models[0], models[1])  # Omega and counters included
        moments = sorted({key for a, b in zip(states[0].optimizer.state.values(),
                                              states[1].optimizer.state.values())
                          for key, t in a.items() if not torch.equal(t, b[key])})
        ok = (torch.equal(losses, torch.stack([o[0] for o in out]))
              and torch.equal(corrects, torch.stack([o[1] for o in out])) and not differ
              and not moments and torch.equal(gens[0].get_state(), gens[1].get_state()))
        calls += 1
        log_calls.append(("capture" if captured else "replay", ok))
        if not ok:
            raise AssertionError(f"redraw interval {interval}, call {calls}: differs from "
                                 f"{REDRAW_K} eager steps: {differ[:3]} {moments}")
        if calls > 2 + interval * 2:
            raise AssertionError(f"redraw interval {interval}: no replay after {calls} calls")
    counter = int(models[0].transformer_blocks[0].attention.redraw_counter)
    t = time_ms(lambda: multi(states[0], xs, ys, gens[0]), iters=3, warmup=0) / REDRAW_K
    log("qa-redraw", f"headline model, feature_redraw_interval {interval}, K={REDRAW_K}: "
        f"calls {log_calls} each bitwise against {REDRAW_K} eager steps (losses, corrects, "
        f"parameters, Omega, counters, Adam moments, generators); graphs "
        f"{len(multi.replays.graphs)} (one per pattern of redraw positions), counter after "
        f"the checked calls {counter}; launches at each capture {captures} (want "
        f"{want_launches}); replayed {t:.3f} ms/step (CUDA events over 3 calls, on {card})")
    if any(c != want_launches for c in captures) or len(multi.replays.graphs) != len(captures):
        raise AssertionError(f"redraw interval {interval}: captures {captures}")
    return captures[0]


def redraw_gather_check(card: str) -> None:
    """Phase 23 e: one make_gather_multi_step chunk and one 2-member
    make_ensemble_gather_multi_step chunk with feature redraw (interval 2),
    each called twice (the capture, then a replay), bitwise against each
    model's eager make_train_step steps on the same gathered batches."""
    import numpy as np

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.data import DeviceDataset
    from efficient_rpe_vit_torch.data.datasets import _synthetic
    from efficient_rpe_vit_torch.data.pipeline import _gather_batch
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import (create_ensemble_train_state, create_train_state,
                                               make_ensemble_gather_multi_step,
                                               make_gather_multi_step, make_train_step)

    cfg = mnist_config(**QA)
    batch = cfg.train.batch_size
    raw = _synthetic(REDRAW_K * batch * 2, 0, 28, 1)
    ds = DeviceDataset(raw["train_images"], raw["train_labels"], cfg.data.mean, cfg.data.std,
                       batch, device="cuda", synthetic=True)
    data = (ds.images, ds.labels, ds.mean, ds.std)
    idx = np.stack([np.random.default_rng(s).permutation(ds.n)[:REDRAW_K * batch]
                    .reshape(REDRAW_K, batch) for s in range(2)])

    def build(seed):
        return create_model(PAR_FLAGSHIP, cfg, device="cuda",
                            attention_config={"feature_redraw_interval": 2},
                            generator=torch.Generator().manual_seed(seed))

    def eager(model, state, rows, gen):
        step = make_train_step(model)
        out = []
        for r in rows:
            x, y = _gather_batch(*data[:2], torch.from_numpy(r).cuda(), *data[2:], None, None)
            out.append(step(state, x, y, gen)[1:])
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    single = [build(0), build(0)]
    sstates = [create_train_state(m, cfg) for m in single]
    gather = make_gather_multi_step(single[0])
    members = [build(1), build(2)]
    twins = [build(1), build(2)]
    ens_state = create_ensemble_train_state(members, cfg)
    tstates = [create_train_state(m, cfg) for m in twins]
    ens = make_ensemble_gather_multi_step(members, per_member_order=True)
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (5, 5, 6, 6, 7, 7)]
    results = []
    for call in ("capture", "replay"):
        _, losses, corrects = gather(sstates[0], *data, idx[0], gens[0])
        want = eager(single[1], sstates[1], idx[0], gens[1])
        torch.cuda.synchronize()
        results.append(("gather", call, torch.equal(losses, want[0])
                        and torch.equal(corrects, want[1])
                        and not _params_differ(single[0], single[1])
                        and torch.equal(gens[0].get_state(), gens[1].get_state())))
        _, losses, corrects = ens(ens_state, *data, idx, [gens[2], gens[4]])
        for i, (twin, tstate, gen, mgen) in enumerate(zip(twins, tstates, (gens[3], gens[5]),
                                                          (gens[2], gens[4]))):
            want = eager(twin, tstate, idx[i], gen)
            torch.cuda.synchronize()
            results.append((f"ensemble member {i}", call, torch.equal(losses[i], want[0])
                            and torch.equal(corrects[i], want[1])
                            and not _params_differ(members[i], twin)
                            and torch.equal(mgen.get_state(), gen.get_state())))
    log("qa-redraw", f"gather-fused chunk and 2-member ensemble chunk (K={REDRAW_K} x "
        f"B={batch}, redraw every 2 calls): bitwise against eager steps {results}, graphs "
        f"{len(gather.replays.graphs)} and {len(ens.replays.graphs)} (on {card})")
    if not all(r[2] for r in results) or len(gather.replays.graphs) != 1 \
            or len(ens.replays.graphs) != 1:
        raise AssertionError("phase 23 e: a gather-fused redraw chunk differs")


def qa_phase(mlc, fa, cr, card: str):
    """Phase 23: the rest of Queue A. Returns {path: (launches, forward
    row, backward rows, flash rows)} for the kernels line."""
    from efficient_rpe_vit_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    kerple = kerple_wrappers(mlc)
    per_member = {n: 0 if n == "kerple_fused_phi_fwd" else 3 for n in kerple}
    out = {}
    out["parallel_multistep_redraw"] = qa_world1(per_member, card)
    out["ensemble_mesh"] = qa_two_ranks(per_member, card)
    out["import_predict"], import_row = qa_importer(mlc, card)
    rotation = {"circulant_rotate_fwd": cr.circulant_rotate_fwd,
                "circulant_rotate_bwd": cr.circulant_rotate_bwd}
    sweep_launches, sweep_rows = qa_sweep(mlc, fa, cr,
                                          {**kerple, **flash_wrappers(fa), **rotation}, card)
    for interval in REDRAW_INTERVALS:
        out[f"redraw_multistep_i{interval}"] = redraw_multistep_check(interval, kerple,
                                                                      per_member, card)
    redraw_gather_check(card)
    t0 = time.perf_counter()
    dryrun_multichip(8, timeout=400)
    log("qa-dryrun", f"dryrun_multichip(8) on the CPU: every part of the JAX dry run passed "
        f"in {time.perf_counter() - t0:.1f} s")
    log("qa", f"phase 23 in {time.perf_counter() - t_phase:.1f} s")
    return out, import_row, sweep_launches, sweep_rows


def _named_arms(name: str, cfg, return_attention: bool = False):
    """The arm each `auto` rule names for `name` at cfg's shape: {rule: arm}
    for softmax ('flash' / 'dense' / 'refused'), KERPLE and the rotation."""
    from efficient_rpe_vit_torch.models.attention import rotation_prefers_kernel
    from efficient_rpe_vit_torch.ops import attention_core, rotations

    m = cfg.model
    b, h, n = cfg.train.batch_size, m.heads, m.seq_len
    arms = {}
    softmax = name.startswith("baseline")
    if softmax:
        try:
            arms["softmax"] = attention_core.softmax_arm("auto", b, h, n, return_attention)
        except NotImplementedError:
            return {"softmax": "refused"}
    if name.endswith("most_general"):
        arms["kerple"] = attention_core.kerple_arm(b, h, n)
    if name.endswith("circulant"):
        consumer = arms["softmax"] == "flash" if softmax else rotations.KERNEL_BEFORE_PHI
        arms["rotation"] = "pallas" if rotation_prefers_kernel(None, consumer) else "chain"
    return arms


def _arm_kwargs(arms) -> dict:
    kw = {}
    if "softmax" in arms:
        kw["attention_config"] = {"method": arms["softmax"]}
    if "kerple" in arms or "rotation" in arms:
        kw["rpe_config"] = {"method": arms.get("kerple", arms.get("rotation"))}
    return kw


def _arm_launches(arms, depth: int, wrappers) -> dict:
    """The launches one eval forward makes on the arms `arms` name."""
    want = {n: 0 for n in wrappers}
    if arms.get("softmax") == "flash":
        want["flash_fwd"] = depth
    if arms.get("kerple") == "pallas":
        want["masked_linear_coeffs_fwd"] = depth
    if arms.get("rotation") == "pallas":
        want["circulant_rotate_fwd"] = 2 * depth
    return want


def dispatch_models(wrappers, card: str):
    """Phase 24 a/b: the flagship, `baseline`, and the circulant variants
    built with every `auto` default on each image of DISPATCH_IMAGES (and
    with return_attention): each eval forward from counts of 0 must launch
    what the arms its rules name launch, and its logits (and attention maps)
    must equal bit for bit those of a twin built on the named explicit arms
    from the same seed; return_attention past the softmax budget must be
    refused. Then performer_favor_circulant exported under a symbolic batch
    (the rotation's auto on the kernels, as with a concrete batch) served
    against its twin on the named arms. Returns ({rule: arms seen},
    {(kernel, shape): launches} of the auto forwards: [B, H, N, F, D] for
    #1, [B, H, N, D] for #6 and #8)."""
    import tempfile

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.models.attention import _KernelAttention

    seen, total = {}, {}
    cases = [(name, dict(DISPATCH, image_size=image), False)
             for name in ("performer_favor_most_general", "baseline", "performer_favor_circulant")
             for image in DISPATCH_IMAGES]
    cases += [("baseline", DISPATCH, True), ("baseline_circulant", DISPATCH, True),
              ("baseline", DISPATCH_LONG, True)]
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, fields, ra in cases:
        cfg = mnist_config(**fields)
        arms = _named_arms(name, cfg, ra)
        for rule, arm in arms.items():
            seen.setdefault(rule, set()).add(arm)
        seed = lambda: torch.Generator().manual_seed(0)  # noqa: E731
        auto = create_model(name, cfg, device="cuda", generator=seed())
        x = torch.randn(fields["batch_size"], fields["image_size"], fields["image_size"],
                        fields["in_channels"], generator=g, device="cuda")
        label = f"{name} N={cfg.model.seq_len} B={fields['batch_size']}" + (
            " return_attention" if ra else "")
        if arms.get("softmax") == "refused":
            try:
                with torch.inference_mode():
                    auto(x, return_attention=True)
            except NotImplementedError as e:
                log("dispatch", f"{label}: refused past SOFTMAX_DENSE_MEMORY_BUDGET ({e})")
                continue
            raise AssertionError(f"{label}: return_attention past the budget was not refused")
        named = create_model(name, cfg, device="cuda", generator=seed(), **_arm_kwargs(arms))
        with torch.inference_mode():
            zero_counts(wrappers)
            got = auto(x, return_attention=True) if ra else auto(x)
            torch.cuda.synchronize()
            launches = counts(wrappers)
            want = named(x, return_attention=True) if ra else named(x)
        want_launches = _arm_launches(arms, cfg.model.depth, wrappers)
        got_t = [got[0], *got[1]] if ra else [got]
        want_t = [want[0], *want[1]] if ra else [want]
        bitwise = all(torch.equal(a, b) for a, b in zip(got_t, want_t))
        log("dispatch", f"{label}: the rules name {arms}; auto launched "
            f"{ {k: v for k, v in launches.items() if v} } (expected "
            f"{ {k: v for k, v in want_launches.items() if v} }); logits"
            f"{' and maps' if ra else ''} bitwise the named arms' {bitwise}")
        if launches != want_launches or not bitwise or not torch.isfinite(got_t[0]).all():
            raise AssertionError(f"{label}: auto did not take the arms {arms}")
        m = cfg.model
        bhn = (fields["batch_size"], m.heads, m.seq_len)
        features = [mod.m for mod in auto.modules() if isinstance(mod, _KernelAttention)]
        for k, n in launches.items():
            if n:
                shape = bhn + ((features[0],) if k == "masked_linear_coeffs_fwd" else ()) + (
                    m.head_dim,)
                total[(k, shape)] = total.get((k, shape), 0) + n
        del auto, named
    # under a symbolic batch the rules name what they name for a concrete one
    cfg = mnist_config(**dict(DISPATCH, image_size=224))
    arms = _named_arms("performer_favor_circulant", cfg)
    auto = create_model("performer_favor_circulant", cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    named = create_model("performer_favor_circulant", cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0), **_arm_kwargs(arms))
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_artifact("dispatch_circulant_symbolic", auto, named, wrappers,
                                _arm_launches(arms, cfg.model.depth, wrappers),
                                (DISPATCH["batch_size"],), tmp, "cuda", card)
    log("dispatch", f"performer_favor_circulant exported under a symbolic batch: the rules "
        f"name {arms}; launches {served}")
    log("dispatch", f"arms taken by rule: {seen}")
    return seen, total


def dispatch_bwd_and_toeplitz(ml, card: str):
    """Phase 24 c: `fused_masked_linear_attention(bwd_mode="auto")` below
    and past KERPLE_DENSE_MEMORY_BUDGET (DISPATCH_BWD): the launches of the
    backward kernels and gradients bit for bit those of the named mode; the
    Toeplitz product's auto at DISPATCH_TOEPLITZ bit for bit its named arm.
    Returns ({rule: arms seen}, {(kernel, [B, H, N, F, D]): launches} of the
    auto backwards)."""
    from efficient_rpe_vit_torch.experiments.pallas_ab import make_inputs
    from efficient_rpe_vit_torch.ops import fft_toeplitz
    from efficient_rpe_vit_torch.ops.fft_toeplitz import toeplitz_from_coeffs

    bwd = {"masked_linear_bwd_dq": ml.masked_linear_bwd_dq,
           "masked_linear_bwd_dkv": ml.masked_linear_bwd_dkv,
           "masked_linear_bwd_dt": ml.masked_linear_bwd_dt}
    seen, launched = {}, {}
    for B, H, N, F, D in DISPATCH_BWD:
        mode = ml.masked_linear_bwd_mode(B, H, N)
        seen.setdefault("bwd_mode", set()).add(mode)
        qp, kp, v, c = make_inputs(B, H, N, F, D, torch.device("cuda"))
        t = toeplitz_from_coeffs(c, N)

        def grads(m):
            leaves = [x.detach().requires_grad_() for x in (qp, kp, v)]
            out = ml.fused_masked_linear_attention(*leaves, t, bwd_mode=m)
            return torch.autograd.grad((out.float() ** 2).sum(), leaves)

        zero_counts(bwd)
        got = grads("auto")
        torch.cuda.synchronize()
        launches = counts(bwd)
        want = grads(mode)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        kernels = mode == "pallas"
        expected = {"masked_linear_bwd_dq": int(kernels), "masked_linear_bwd_dkv": int(kernels),
                    "masked_linear_bwd_dt": 0}
        log("dispatch", f"fused_masked_linear_attention {(B, H, N, F, D)} bf16: 5 B H N^2 4 = "
            f"{5 * B * H * N * N * 4} B against KERPLE_DENSE_MEMORY_BUDGET; auto's backward "
            f"{mode}, launches {launches} (expected {expected}), gradients bitwise the named "
            f"mode's {bitwise}")
        if launches != expected or not bitwise:
            raise AssertionError(f"the materialised-T auto backward did not take {mode}")
        for k, n in launches.items():
            if n:
                launched[(k, (B, H, N, F, D))] = n
        del got, want, qp, kp, v, t
    g = torch.Generator(device="cuda").manual_seed(6)
    for B, H, N, d in DISPATCH_TOEPLITZ:
        arm = "fft" if fft_toeplitz.fft_window(N, d) else "dense"
        seen.setdefault("toeplitz", set()).add(arm)
        x = torch.randn(B, H, N, d, generator=g, device="cuda").to(torch.bfloat16)
        c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.05)
        same = torch.equal(fft_toeplitz.toeplitz_matmul(c, x),
                           fft_toeplitz.toeplitz_matmul(c, x, method=arm))
        log("dispatch", f"toeplitz_matmul [{B}, {H}, {N}, {d}] bf16: auto is {arm} "
            f"(window [{fft_toeplitz.FFT_MIN_N}, {fft_toeplitz.FFT_MAX_N}), d < "
            f"{fft_toeplitz.FFT_MAX_D}), bitwise the named arm {same}")
        if not same:
            raise AssertionError(f"toeplitz_matmul auto differs from its {arm} arm")
    return seen, launched


def dispatch_kernel_rows(mlc, fa, cr, ml, launched, card: str) -> dict:
    """Phase 24's kernel rows: each kernel that the auto forwards and
    backwards launched, against its plain version and timed (with its bound,
    and SDPA for flash) at each shape it was launched at, in bf16 on fresh
    inputs. Returns {(kernel, shape): row}."""
    rows = {}
    for kname, shape in sorted(launched):
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        dt, name = torch.bfloat16, "bfloat16"
        label = f"{kname} {list(shape)} {name}"
        rtol, atol = OUT_TOL[name]

        def close(got, want):
            return bool(((got.float() - want.float()).abs()
                         <= atol + rtol * want.float().abs()).all())

        if kname == "masked_linear_coeffs_fwd":
            B, H, N, F_, D = shape
            q, k = ((torch.randn(B, H, N, F_, generator=g, device="cuda").abs() * 0.1).to(dt)
                    for _ in range(2))
            v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dt)
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            case = (lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)[0],
                    lambda: mlc.masked_linear_attention_coeffs_reference(q, k, v, c)[0],
                    close, kerple_bound(B, H, N, F_, D, name), None)
        elif kname == "flash_fwd":
            B, H, N, D = shape
            q, k, v, _, _, _ = _flash_inputs(B, H, N, D, None, 0.0, dt)
            case = (lambda: fa.flash_attention_fwd(q, k, v, D ** -0.5)[0],
                    lambda: fa.flash_softmax_attention_reference(q, k, v, D ** -0.5)[0],
                    lambda got, want: _max_rel(got, want) <= FLASH_TOL[name],
                    flash_bound(B, H, N, D, name), lambda: F.scaled_dot_product_attention(q, k, v))
        elif kname == "circulant_rotate_fwd":
            B, H, N, D = shape
            x = torch.randn(B, H, N, D, generator=g, device="cuda").to(dt)
            theta = torch.randn(H, N, D // 2 + 1, generator=g, device="cuda")
            ct, st = theta.cos().contiguous(), theta.sin().contiguous()
            case = (lambda: cr.circulant_rotate_fwd(x, ct, st, True),
                    lambda: cr.circulant_rotate_fwd_reference(x, ct, st, True),
                    lambda got, want: _max_rel(got, want) <= ROT_TOL[name],
                    rotation_bounds(B, H, N, D, name)["circulant_rotate_fwd"], None)
        else:  # the materialised-T backward kernels, on a Toeplitz T
            from efficient_rpe_vit_torch.ops.fft_toeplitz import toeplitz_from_coeffs

            B, H, N, F_, D = shape
            q, k = ((torch.randn(B, H, N, F_, generator=g, device="cuda").abs() * 0.1).to(dt)
                    for _ in range(2))
            v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(dt)
                      for _ in range(2))
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            t = toeplitz_from_coeffs(c, N)
            out, den = ml.masked_linear_fwd(q, k, v, t)
            gn, s = mlc.kerple_bwd_residuals(den, out, cot)
            pair = {"masked_linear_bwd_dq": (lambda: ml.masked_linear_bwd_dq(gn, s, v, k, t),
                                             lambda: mlc.kerple_dense_bwd_dq(gn, s, v, k, t)),
                    "masked_linear_bwd_dkv": (
                        lambda: ml.masked_linear_bwd_dkv(gn, s, v, q, k, t),
                        lambda: mlc.kerple_dense_bwd_dkv(gn, s, v, q, k, t))}[kname]
            case = (*pair, lambda got, want: _max_rel(got, want) <= BWD_TOL[name],
                    masked_linear_bounds(B, H, N, F_, D, name)[kname], None)
        rows[(kname, shape)] = timed_against_plain(
            "dispatch", label, *case, shape, card, plain_iters=1 if shape[2] > 2048 else 5)
        del case
        torch.cuda.empty_cache()
    return rows


def dispatch_experiments(card: str) -> None:
    """Phase 24 f: each dispatch experiment in process at its small
    DISPATCH_EXPERIMENTS settings on the card: its first line the card's
    label, every number of its JSON finite, both arms of every row present."""
    import contextlib
    import importlib
    import io

    def finite(value):
        if isinstance(value, dict):
            return all(finite(v) for v in value.values())
        if isinstance(value, list):
            return all(finite(v) for v in value)
        return not isinstance(value, float) or math.isfinite(value)

    for name, argv in DISPATCH_EXPERIMENTS.items():
        module = importlib.import_module(f"efficient_rpe_vit_torch.experiments.{name}")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(argv)
        lines = buf.getvalue().strip().splitlines()
        result = json.loads(lines[-1])
        rows = result.get("rows") or result.get("kerple")
        arms = [sorted(r[key]) for r in rows for key in ("fwd_ms", "grad_ms") if key in r]
        arms += [sorted(k for k, v in r.items() if isinstance(v, dict)
                        and "step_ms" in v) for r in rows if "variant" in r]
        if name == "crossover_ab":
            arms += [sorted(r["ms"]) for r in result["toeplitz"]]
        if name == "scaling_ab":
            arms += [[w["rule"]] for w in result["walls"]]
        log("dispatch-ab", f"{name} {' '.join(argv)}: {len(rows)} row(s), arms {arms}, in "
            f"{time.perf_counter() - t0:.1f} s; first line {lines[0]!r}")
        if lines[0] != card or not finite(result) or not arms or any(
                len(a) < 2 for a in arms if name != "scaling_ab"):
            raise AssertionError(f"{name}: a row is not finite or lacks an arm: {lines[-1][:400]}")


def dispatch_phase(mlc, fa, cr, ml, card: str):
    """Phase 24: the `auto` dispatch on the card (models, the materialised-T
    backward and the Toeplitz product on each side of each constant, the
    dense arms captured in K-step graphs, the nine dispatch experiments).
    Returns {(kernel, shape): (launches, row)}: each kernel the auto
    forwards and backwards launched, its launches at that shape and its row
    timed there."""
    from efficient_rpe_vit_torch.ops import attention_core, rotations

    t_phase = time.perf_counter()
    log("dispatch", f"FLASH_MIN_N {attention_core.FLASH_MIN_N}, SOFTMAX_DENSE_MEMORY_BUDGET "
        f"{attention_core.SOFTMAX_DENSE_MEMORY_BUDGET}, KERPLE_DENSE_CROSSOVER_N "
        f"{attention_core.KERPLE_DENSE_CROSSOVER_N}, KERPLE_DENSE_MEMORY_BUDGET "
        f"{attention_core.KERPLE_DENSE_MEMORY_BUDGET}, MASKED_LINEAR_BWD_CROSSOVER_N "
        f"{ml.MASKED_LINEAR_BWD_CROSSOVER_N}, KERNEL_BEFORE_PHI "
        f"{rotations.KERNEL_BEFORE_PHI} (PERF.md §6, Dispatch on the H100)")
    wrappers = {**kerple_wrappers(mlc), **flash_wrappers(fa),
                "circulant_rotate_fwd": cr.circulant_rotate_fwd,
                "circulant_rotate_bwd": cr.circulant_rotate_bwd}
    seen, forwards = dispatch_models(wrappers, card)
    more, backward = dispatch_bwd_and_toeplitz(ml, card)
    seen.update(more)
    # every rule showed each arm its constants leave a shape for: both arms
    # of the rotation and the Toeplitz product; softmax flash, dense
    # (return_attention) and the refusal; KERPLE's dense arm and the
    # residual backward only where a shape lies below their crossovers
    want = {"softmax": {"flash", "dense", "refused"}, "rotation": {"pallas", "chain"},
            "toeplitz": {"fft", "dense"},
            "bwd_mode": {"pallas"} | ({"jnp_residual"} if ml.MASKED_LINEAR_BWD_CROSSOVER_N
                                      > DISPATCH_BWD[0][2] else set()),
            "kerple": {"pallas"} | ({"dense"} if attention_core.KERPLE_DENSE_CROSSOVER_N > 17
                                    else set())}
    if attention_core.FLASH_MIN_N == 0:
        log("dispatch", "FLASH_MIN_N is 0: no N lies below it, softmax's dense arm is "
            "reached through return_attention")
    if attention_core.KERPLE_DENSE_CROSSOVER_N <= 17:
        log("dispatch", "KERPLE_DENSE_CROSSOVER_N is at or below the shortest N here: the "
            "kernel at every N, no shape on the dense side")
    if ml.MASKED_LINEAR_BWD_CROSSOVER_N <= DISPATCH_BWD[0][2]:
        log("dispatch", "MASKED_LINEAR_BWD_CROSSOVER_N is at or below the shortest N here: "
            "the backward kernels on both sides of KERPLE_DENSE_MEMORY_BUDGET")
    for rule, arms in want.items():
        if not arms <= seen.get(rule, set()):
            raise AssertionError(f"phase 24: rule {rule} showed {seen.get(rule)}, expected {arms}")
    launched = {**forwards, **backward}
    rows = dispatch_kernel_rows(mlc, fa, cr, ml, launched, card)
    # the dense arms capture: K-step graphs at the headline's shape, bitwise
    # against eager steps, no kernel launched
    for label, name, kw, wr in (
            ("dispatch-capture-kerple", "performer_favor_most_general",
             {"rpe_config": {"method": "dense"}}, kerple_wrappers(mlc)),
            ("dispatch-capture-softmax", "baseline", {"attention_config": {"method": "dense"}},
             flash_wrappers(fa))):
        multistep_check(label, HEADLINE, DISPATCH_CAPTURE_K, 1, wr, {n: 0 for n in wr}, card,
                        name=name, model_kw=kw)
    dispatch_experiments(card)
    log("dispatch", f"phase 24 in {time.perf_counter() - t_phase:.1f} s")
    return {key: (n, rows[key]) for key, n in launched.items()}


def flash_two_pass_rows(fa, shape, card: str) -> dict:
    """#6 and 7b (dq, dkv) against their plain versions at `shape` (B, H, N,
    D), bf16, dropout 0, each timed beside its bound and SDPA's forward or
    backward. Returns {kernel: row}."""
    B, H, N, D = shape
    q, k, v, cot, _, _ = _flash_inputs(B, H, N, D, None, 0.0, torch.bfloat16)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, scale)
    args = (q, k, v, cot, lse, fa.flash_delta(out, cot), scale)
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, cot)
    bounds = flash_bwd_bounds(B, H, N, D, "bfloat16")
    label = f"B{B} H{H} N{N} D{D} bfloat16"

    def close(got, want):
        return _max_rel(got, want) <= FLASH_TOL["bfloat16"]

    rows = {}
    for kname, kernel_fn, plain_fn, bound, library_ms in (
            ("flash_fwd", lambda: fa.flash_attention_fwd(q, k, v, scale)[0],
             lambda: fa.flash_softmax_attention_reference(q, k, v, scale)[0],
             flash_bound(B, H, N, D, "bfloat16"), lib_fwd),
            ("flash_bwd_dq", lambda: fa.flash_attention_bwd_dq(*args),
             lambda: fa.flash_bwd_reference(*args)[0], bounds["flash_bwd_dq"], lib_bwd),
            ("flash_bwd_dkv", lambda: fa.flash_attention_bwd_dkv(*args),
             lambda: fa.flash_bwd_reference(*args)[1:], bounds["flash_bwd_dkv"], lib_bwd)):
        rows[kname] = timed_against_plain("experiments", f"{kname} {label}", kernel_fn, plain_fn,
                                          close, bound, None, shape, card)
        rows[kname]["library_ms"] = library_ms
    return rows


def _quiet(fn, *args):
    """fn(*args) with its standard output kept off this script's (whose
    last two lines are the kernels and ok lines): (result, its lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue().strip().splitlines()


def _summed(launch_dicts) -> dict:
    out = {}
    for launches in launch_dicts:
        for name, n in launches.items():
            out[name] = out.get(name, 0) + n
    return out


def _check_launch_total(what: str, rows_launches, total: dict) -> None:
    """The rows' own launch counts add up to the counters read around the
    experiment's call."""
    summed = _summed(rows_launches)
    nonzero = {k: n for k, n in total.items() if n}
    if summed != nonzero:
        raise AssertionError(f"{what}: the rows' launches {summed} are not the counters' "
                             f"{nonzero}")


def experiments_phase(mlc, fa, kerple_rows, flash_rows, card: str):
    """Phase 25: the JAX package's last experiments, ported, on the card.
    `kerple_rows` {(B, N): {kernel: row}} and `flash_rows` hold the kernel
    rows earlier phases timed at these experiments' shapes; this phase
    checks and times the rest. Returns [(kernel, path, row, launches)] for
    the kernels line."""
    import tempfile

    import bench_torch
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.experiments import (ab_steps, coeffs_tune, flash_tune,
                                                     longn_train, tile_trial, vitb_batch_sweep,
                                                     vitbase_bench)

    t_phase = time.perf_counter()
    depth = VITB["depth"]
    kerple, flash_k = kerple_wrappers(mlc), flash_wrappers(fa)
    wrappers = {**kerple, **flash_k}
    kerple_step = {n: depth for n in kerple if n != "kerple_fused_phi_fwd"}
    out = []

    def rows_for(launches: dict, B: int, N: int, path: str) -> None:
        """Kernel-line rows of `path` (launches by kernel) at (B, N)."""
        timed = {**kerple_rows.get((B, N), {}), **flash_rows.get((B, N), {})}
        for name, n in launches.items():
            if n and name not in timed:
                raise AssertionError(f"{path}: {name} launched at B={B} N={N}, no timed row")
            if n:
                row = dict(timed[name])
                row.setdefault("shape", [B, 12, N])
                out.append((name, path, row, n))

    # the shapes no earlier phase timed: #1 / #2 at the 1025 row and at batch
    # 128, #6 / 7b at the 1025 row
    for B, N in ((16, 1025), (128, 197)):
        shape = (B, 12, N, 266, 64)
        fwd = check_kernels(mlc, [shape], BF16_ONLY, timed=[shape])[("bfloat16", B)]
        kerple_rows[(B, N)] = {"masked_linear_coeffs_fwd": fwd,
                               **check_bwd_kernels(mlc, [shape], BF16_ONLY, timed=shape)}
    flash_rows[(16, 1025)] = flash_two_pass_rows(fa, (16, 12, 1025, 64), card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # a. vitbase_bench: 9 rows at full ViT-B width
        zero_counts(wrappers)
        t0 = time.perf_counter()
        result, lines = _quiet(vitbase_bench.main,
                               [*EXP_VITBASE, "--out", f"{tmp}/vitbase_bench.json"])
        total = counts(wrappers)
        for line in lines[1:-1]:
            log("exp-vitbase", line)
        if lines[0] != card:
            raise AssertionError(f"vitbase_bench's first line {lines[0]!r} is not the card's")
        log("exp-vitbase", f"{len(result['rows'])} rows in {time.perf_counter() - t0:.1f} s; "
            f"launches {total}")
        _check_launch_total("vitbase_bench", [r.get("launches", {}) for r in result["rows"]],
                            total)
        for r in result["rows"]:
            if "error" in r:
                raise AssertionError(f"vitbase_bench row failed: {r}")
            N, B = r["N"], r["batch"]
            if r["variant"] == "performer_favor":
                want = {}
            elif r["variant"] == "baseline":
                bwd = (("flash_bwd_fused",) if fa.fused_fits(N, 64, torch.bfloat16)
                       else ("flash_bwd_dq", "flash_bwd_dkv"))
                want = {n: depth for n in ("flash_fwd", *bwd)}
            else:
                want = kerple_step
            calls = 1 + vitbase_bench.WARMUP + r["timed_steps"]
            if r["launches_per_step"] != want or r["launches"] != {
                    n: c * calls for n, c in want.items()}:
                raise AssertionError(f"vitbase_bench {r['variant']} N={N}: launches "
                                     f"{r['launches_per_step']} a step, {r['launches']} in "
                                     f"all; expected {want} a step")
            if not (r["mfu"] is not None and 0 < r["mfu_counted"] <= r["mfu"] < 1):
                raise AssertionError(f"vitbase_bench {r['variant']} N={N}: MFU {r['mfu']} "
                                     f"(counted {r['mfu_counted']}) out of (0, 1)")
            if r["variant"] == "performer_favor_most_general" and N == 197:
                cfg = mnist_config(image_size=28, patch_size=2, batch_size=B,
                                   **ab_steps.VITB_WIDTHS)
                analytic = bench_torch.train_flops_per_step(cfg.model, 266, B)
                rel = abs(r["flops_per_step"] - analytic) / analytic
                log("exp-vitbase", f"flagship N=197 B={B}: flops_per_step "
                    f"{r['flops_per_step']:.6e} (counted {r['flops_per_step_counted']:.6e} + "
                    f"kernels {r['pallas_attention_flops']:.6e}) against bench_torch's "
                    f"{analytic:.6e}: {rel:.4f} apart (tol {EXP_FLOPS_RTOL})")
                if rel > EXP_FLOPS_RTOL:
                    raise AssertionError("vitbase_bench's FLOPs disagree with bench_torch's")
        for label, _, _, N, B, _ in vitbase_bench.SHAPES:
            rows_for(_summed(r["launches"] for r in result["rows"] if r["N"] == N), B, N,
                     f"vitbase_bench_n{N}")

        # b. the batch sweep at 64 and 128, then K=8 at the best
        zero_counts(wrappers)
        t0 = time.perf_counter()
        result, lines = _quiet(vitb_batch_sweep.main,
                               [*EXP_BATCHES, "--out", f"{tmp}/vitb_batch_sweep.json"])
        total = counts(wrappers)
        log("exp-batch-sweep", f"{len(result['rows'])} rows in "
            f"{time.perf_counter() - t0:.1f} s; launches {total}")
        _check_launch_total("vitb_batch_sweep", [r.get("launches", {}) for r in result["rows"]],
                            total)
        for r in result["rows"]:
            log("exp-batch-sweep", json.dumps(r))
            if "error" in r or not (math.isfinite(r["step_ms"]) and 0 < r["mfu"] < 1):
                raise AssertionError(f"vitb_batch_sweep row not finite: {r}")
            K = r["fused_k"]
            # fused: the counted eager step, then the first call's K eager
            # steps and its capture; replays launch nothing
            want_total = {n: c * ((1 + 2 * K) if K else (1 + vitb_batch_sweep.WARMUP
                                                         + r["timed_steps"]))
                          for n, c in kerple_step.items()}
            if r["launches"] != want_total or r["launches_per_step"] != (
                    {} if K else kerple_step):
                raise AssertionError(f"vitb_batch_sweep B={r['batch']} K={K}: launches "
                                     f"{r['launches']} ({r['launches_per_step']} a timed "
                                     f"step), expected {want_total}")
            path = (f"vitb_batch_sweep_k{K}_b{r['batch']}" if K
                    else f"vitb_batch_sweep_b{r['batch']}")
            rows_for(r["launches"], r["batch"], 197, path)
        if [r["fused_k"] for r in result["rows"]] != [None, None, vitb_batch_sweep.FUSED_K]:
            raise AssertionError("vitb_batch_sweep: no K=8 row after the two batches")

        # c. long-N training, both variants, 120 steps
        zero_counts(wrappers)
        t0 = time.perf_counter()
        result, lines = _quiet(longn_train.main, ["--out", f"{tmp}/longn_train.json"])
        total = counts(wrappers)
        _check_launch_total("longn_train", [r["launches"] for r in result["runs"]], total)
        for r in result["runs"]:
            log("exp-longn", f"{r['variant']} N={result['N']}: loss first5 "
                f"{r['loss_first5_mean']:.4f}, last5 {r['loss_last5_mean']:.4f}, decreased "
                f"{r['decreased']}, finite {r['finite']}, accuracy (last) {r['accuracies'][-1]}, "
                f"wall {r['wall_s']:.1f} s; launches {r['launches']}; losses "
                f"{[round(x, 4) for x in r['losses']]}")
            kernel = r["variant"] != "baseline"
            want = ({n: c * r["steps"] for n, c in kerple_step.items()} if kernel else
                    {n: depth * r["steps"] for n in ("flash_fwd", "flash_bwd_dq",
                                                      "flash_bwd_dkv")})
            if not (r["finite"] and r["decreased"]) or r["launches"] != want:
                raise AssertionError(f"longn_train {r['variant']}: finite {r['finite']}, "
                                     f"decreased {r['decreased']}, launches {r['launches']} "
                                     f"(expected {want})")
            rows_for(r["launches"], 4, LONGN_N,
                     f"longn_train_{'kerple' if kernel else 'baseline'}")
        log("exp-longn", f"both runs in {time.perf_counter() - t0:.1f} s")
        # the baseline's fall to chance needs no attention gradient: its
        # flash step's gradients against the dense arm's, at depth 2
        train("exp-longn-grads", "baseline", EXP_LONGN_GRADS,
              {arm: {"attention_config": {"method": method}}
               for arm, method in (("kernel", "flash"), ("dense", "dense"))}, flash_k,
              {"flash_fwd": 2, "flash_bwd_fused": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
              1, 1, card, False)

    # d. the tile sweeps on their reduced grids, every variant's nvcc
    # started together: each variant against its plain versions, then timed
    sweeps = (("flash", flash_tune, TUNE_FLASH_POINTS, (4, 12, LONGN_N, 64)),
              ("coeffs", coeffs_tune, TUNE_COEFFS_POINTS, (4, 12, LONGN_N, 266, 64)))
    t_build = time.perf_counter()
    running = {what: module.start_builds(points) for what, module, points, _ in sweeps}
    for what, module, points, shape in sweeps:
        built = tile_trial.finish_copies(running[what])
        log(f"exp-{what}-tune", f"variants {points} built {time.perf_counter() - t_build:.1f} "
            "s after the sweeps' builds started")
        zero_counts(wrappers)
        t0 = time.perf_counter()
        result = module.sweep(points, built, *shape, TUNE_STEPS, True,
                              torch.device("cuda"), card)
        total = counts(wrappers)
        for line in (module.report(result, True) if module is flash_tune
                     else module.report(result)):
            log(f"exp-{what}-tune", line)
        log(f"exp-{what}-tune", f"{len(result['rows'])} rows in "
            f"{time.perf_counter() - t0:.1f} s; launches {total}")
        failed = [r for r in result["rows"] if "failed" in r]
        if failed:
            raise AssertionError(f"{what}_tune: {failed[0]['label']}: {failed[0]['failed']}")
        for r in result["rows"][1:]:
            log(f"exp-{what}-tune", f"{r['label']}: launch_info {r['launch_info']}; "
                f"max rel err {r['max_rel_err']}")
            for kname, info in r["launch_info"].items():
                if "smem_bytes" in r and info["smem_bytes"] != r["smem_bytes"][kname]:
                    raise AssertionError(f"flash_tune {r['label']} {kname}: launch_info "
                                         f"{info['smem_bytes']} B of shared memory, the "
                                         f"sweep's count {r['smem_bytes'][kname]}")
        for kname in module.KERNELS:
            if all(kname in r["shipped"] for r in result["rows"]):
                raise AssertionError(f"{what}_tune ran no tile of {kname} but the shipped one")
        rows_for(total, shape[0], shape[2], f"{what}_tune")
    log("experiments", f"phase 25 in {time.perf_counter() - t_phase:.1f} s")
    return out


def print_results(rows) -> None:
    """The last two lines: the kernels line (one JSON row per kernel and
    main path: (name, source, replaces, path, row, launches)) and ok."""
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row.get("library_ms"),
        # the row's own further numbers (shape, the routes it was timed beside)
        **{key: value for key, value in row.items() if key not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name, source, replaces, path, row, launches in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one served batch and one train step of each "
                             "model with torch.profiler")
    parser.add_argument("--only", action="append", choices=ONLY_PHASES,
                        help="run phases 1 and 2, then this phase alone (repeatable); the "
                             "kernels line holds phase 27's rows")
    args = parser.parse_args()
    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from efficient_rpe_vit_torch.experiments import pallas_ab
    from efficient_rpe_vit_torch.ops.kernels import _build
    from efficient_rpe_vit_torch.ops.kernels import circulant_rotate as cr
    from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
    from efficient_rpe_vit_torch.ops.kernels import masked_linear as ml
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc

    # 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off for matmuls and cuDNN: fp32 plain versions run in full fp32")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log("build", f"{len(logs)} CUDA source(s) compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name, text in logs.items():
        entry = ""  # the kernel ptxas reports on, mangled
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log("build", f"{name}: {entry}: {line.strip()}")

    if args.only:
        if "3c" in args.only:
            check_flash_kernels(fa)
        rows = sam_phase(fa, card) if "27" in args.only else []
        log("done", f"phases 1, 2 and {', '.join(args.only)} passed in "
            f"{time.perf_counter() - started:.1f} s of command time")
        print_results(rows)
        return 0

    # 3. kernels against their plain versions
    kernel = check_kernels(mlc)
    check_kernels(mlc, KERPLE_EDGE_SHAPES, BF16_ONLY, timed=[])
    kernel_bwd = check_bwd_kernels(mlc)
    check_bwd_kernels(mlc, KERPLE_EDGE_SHAPES, BF16_ONLY, timed=None)
    flash = check_flash_kernels(fa)
    rotation = check_rotation_kernels(cr)
    fused = check_fused_kernels(mlc)
    phi_rows, phi_step = phi_phase(card)
    sam_rows = sam_phase(fa, card)
    materialised = check_masked_linear_kernels(ml, mlc, pallas_ab.SHAPES)

    # 4. serve and 5. train ViT-B/16 with KERPLE
    depth = VITB["depth"]
    kerple = kerple_wrappers(mlc)
    kerple_arms = {arm: {"rpe_config": {"method": method}}
                   for arm, method in (("kernel", "pallas"), ("dense", "dense"))}
    serve_launches = serve("serve", "performer_favor_most_general", kerple_arms, kerple,
                           {n: depth if n == "masked_linear_coeffs_fwd" else 0 for n in kerple},
                           card, args.profile, arbiter=True)
    train_launches = train("train", "performer_favor_most_general",
                           dict(VITB, batch_size=TRAIN_BATCH), kerple_arms, kerple,
                           {n: 0 if n == "kerple_fused_phi_fwd" else depth for n in kerple},
                           TRAIN_STEPS, TIMED_STEPS, card, args.profile)

    # 6. serve, 7. train and 8. train at long N the softmax baseline
    flash_k = flash_wrappers(fa)
    flash_arms = {arm: {"attention_config": {"method": method}}
                  for arm, method in (("kernel", "flash"), ("dense", "dense"))}
    base_serve = serve("serve-baseline", "baseline", flash_arms, flash_k,
                       {n: depth if n == "flash_fwd" else 0 for n in flash_k}, card, args.profile)
    base_train = train("train-baseline", "baseline", dict(VITB, batch_size=TRAIN_BATCH),
                       flash_arms, flash_k,
                       {"flash_fwd": depth, "flash_bwd_fused": depth,
                        "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                       TRAIN_STEPS, TIMED_STEPS, card, args.profile)
    base_longn = train("longn-baseline", "baseline", LONGN,
                       {"kernel": flash_arms["kernel"]}, flash_k,
                       {"flash_fwd": depth, "flash_bwd_fused": 0,
                        "flash_bwd_dq": depth, "flash_bwd_dkv": depth},
                       LONGN_STEPS, LONGN_TIMED, card, args.profile)

    # 9. serve, 10. train and 11. train at long N baseline_circulant: the
    # flash kernels with the rotation on its kernels
    rot_k = {**flash_k, "circulant_rotate_fwd": cr.circulant_rotate_fwd,
             "circulant_rotate_bwd": cr.circulant_rotate_bwd}
    circ_arms = {arm: {"attention_config": {"method": attn}, "rpe_config": {"method": rot}}
                 for arm, attn, rot in (("kernel", "flash", "pallas"), ("dense", "dense", "chain"))}
    circ_serve = serve("serve-circulant", "baseline_circulant", circ_arms, rot_k,
                       {"flash_fwd": depth, "flash_bwd_fused": 0, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0, "circulant_rotate_fwd": 2 * depth,
                        "circulant_rotate_bwd": 0}, card, args.profile, arbiter=True)
    rot_step = {"circulant_rotate_fwd": 2 * depth, "circulant_rotate_bwd": 2 * depth}
    circ_train = train("train-circulant", "baseline_circulant", dict(VITB, batch_size=TRAIN_BATCH),
                       circ_arms, rot_k,
                       {"flash_fwd": depth, "flash_bwd_fused": depth, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0, **rot_step},
                       TRAIN_STEPS, TIMED_STEPS, card, args.profile)
    circ_longn = train("longn-circulant", "baseline_circulant", LONGN,
                       {"kernel": circ_arms["kernel"]}, rot_k,
                       {"flash_fwd": depth, "flash_bwd_fused": 0, "flash_bwd_dq": depth,
                        "flash_bwd_dkv": depth, **rot_step},
                       LONGN_STEPS, LONGN_TIMED, card, args.profile)

    # 12. every other rotation and hyperbolic-feature variant, depth 2
    kerple_f532_check(mlc)
    other_variants({**kerple, **rot_k}, card)

    # 13. serve and 14. train ViT-B/16 KERPLE with phi fused into the forward kernel
    fused_arms = {"kernel": {"attention_config": {"fused_phi": True}},
                  "dense": kerple_arms["dense"], "unfused": kerple_arms["kernel"]}
    fused_serve = serve("serve-fused", "performer_favor_most_general", fused_arms, kerple,
                        {n: depth if n == "kerple_fused_phi_fwd" else 0 for n in kerple},
                        card, args.profile, arbiter=True)
    fused_train = train("train-fused", "performer_favor_most_general",
                        dict(VITB, batch_size=TRAIN_BATCH),
                        {"kernel": fused_arms["kernel"], "unfused": kerple_arms["kernel"]},
                        kerple, {n: 0 if n == "masked_linear_coeffs_fwd" else depth for n in kerple},
                        TRAIN_STEPS, TIMED_STEPS, card, args.profile)

    # 15. the pallas_ab entry point on the materialised-T kernels, shape by shape
    ab_launches = pallas_ab_phase(pallas_ab, card)

    # 16. long-N KERPLE: #1 and #2 at N=4097 against their plain versions,
    # the fft arm against them, then ViT-B/16 training and serving at 1024x1024
    longn_fwd = check_kernels(mlc, [KERPLE_LONGN], BF16_ONLY, timed=[KERPLE_LONGN])
    longn_bwd = check_bwd_kernels(mlc, [KERPLE_LONGN], BF16_ONLY, timed=KERPLE_LONGN)
    fft_op_check(card)
    kerple_longn = train("longn-kerple", "performer_favor_most_general",
                         dict(LONGN, dropout=0.0), {"kernel": kerple_arms["kernel"]}, kerple,
                         {n: 0 if n == "kerple_fused_phi_fwd" else depth for n in kerple},
                         LONGN_STEPS, LONGN_TIMED, card, args.profile)
    longn_kerple_serve(kerple, card)

    # 17. K train steps per CUDA-graph replay (make_multi_step): #1 / #2 at the
    # headline row's shape, the replayed masks, the headline model at K=25
    # and ViT-B at K=5 against eager steps, bit for bit
    head_fwd = check_kernels(mlc, [HEADLINE_SHAPE], BF16_ONLY, timed=[HEADLINE_SHAPE])
    head_fwd = head_fwd[("bfloat16", HEADLINE_SHAPE[0])]
    head_bwd = check_bwd_kernels(mlc, [HEADLINE_SHAPE], BF16_ONLY, timed=HEADLINE_SHAPE)
    check_replayed_masks()
    check_capturable_optimizer()
    head_depth = 3  # mnist_config's
    head_step = {n: 0 if n == "kerple_fused_phi_fwd" else head_depth for n in kerple}
    multi_launches = multistep_check("multistep", HEADLINE, HEADLINE_K, 2, kerple, head_step,
                                     card, args.profile, timed=4)
    vitb_launches = multistep_check("multistep-vitb", ENGINE_VITB, ENGINE_VITB_K, 1, kerple,
                                    {n: 0 if n == "kerple_fused_phi_fwd" else depth
                                     for n in kerple}, card)
    multistep_check("multistep-sgd", dict(HEADLINE, optimizer="sgd"), 5, 1, kerple,
                    head_step, card)

    # 18. the engine: a device-resident synthetic MNIST, one epoch per
    # train_epoch loop, evaluate per batch and gather-fused
    engine_launches = engine_phase(kerple, head_step,
                                   {"masked_linear_coeffs_fwd": head_depth}, card)

    # 19. the entry points: the train CLI, predict from its checkpoint, a
    # resumed run; then the ViT-B MoE with and without remat
    cli_fwd, cli_bwd, cli_launches = entry_points_phase(mlc, kerple, card)
    moe_launches = moe_remat_phase(kerple, card)

    # 20. the benchmark runner: sequential with `shared`, --skip-existing and
    # --ensemble, the ensemble's capture against one model's, then #6 / 7a
    # at the benchmark baseline's shape
    bench_k = {**kerple, **flash_k}
    bench_seq, bench_ens = benchmark_phase(bench_k, card)
    ensemble_capture_check(bench_k, card)
    bench_flash = bench_flash_check(fa, card)

    # 21. serving artifacts: the ViT-B flagship and mnist-width artifacts
    # exported on the card, one exported on the CPU, serve_bench --vitb
    served_launches, served_rows = serve_export_phase(mlc, fa, cr, card)

    # 22. parallelism: one rank on NCCL (bitwise against make_train_step, the
    # K-step graph with its all-reduces, GPipe at pipe=1), two ranks sharing
    # the card over gloo (DP, FSDP, TP, CP, EP, PP against the single-process
    # step), CP at N=4097
    par_world1, par_rows, par_two = parallel_phase(mlc, kerple, card)

    # 23. the rest of Queue A: the ensemble over a mesh, sharded checkpoints,
    # the importer, the 11-variant sweep, feature redraw inside CUDA graphs,
    # then the 8-rank CPU dry run
    qa_launches, import_row, sweep_launches, sweep_rows = qa_phase(mlc, fa, cr, card)

    # 24. the auto dispatch: the rules' arms on each side of each constant,
    # through the launches and bit for bit against the named arms; the dense
    # arms in K-step graphs; the nine dispatch experiments at small settings
    dispatch = dispatch_phase(mlc, fa, cr, ml, card)

    # 25. the JAX package's last experiments, ported: vitbase_bench, the
    # batch sweep, long-N training, the flash and KERPLE tile sweeps; the
    # kernel rows earlier phases timed at their shapes
    kerple_rows = {
        (TRAIN_BATCH, 197): {"masked_linear_coeffs_fwd": kernel[("bfloat16", TRAIN_BATCH)],
                             **kernel_bwd},
        (KERPLE_LONGN[0], LONGN_N): {
            "masked_linear_coeffs_fwd": longn_fwd[("bfloat16", KERPLE_LONGN[0])], **longn_bwd}}
    flash_rows = {
        (TRAIN_BATCH, 197): {name: flash[(name, "baseline_train")]
                             for name in ("flash_fwd", "flash_bwd_fused")},
        (FLASH_LONGN[0], LONGN_N): {name: flash[(name, "baseline_longn_train")]
                                    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
    experiment_rows = experiments_phase(mlc, fa, kerple_rows, flash_rows, card)

    # one row per kernel and main path: its launches in that path's run, its
    # times at that path's shape
    pallas = "efficient_rpe_vit_tpu/ops/pallas"
    src = "efficient_rpe_vit_torch/csrc"
    mlc_tpu = f"{pallas}/masked_linear_coeffs.py"
    fwd = ("masked_linear_coeffs_fwd", f"{src}/masked_linear_coeffs_fwd.cu", f"{mlc_tpu}:140")
    rows = [(*fwd, "serve", kernel[("bfloat16", VITB["batch_size"])],
             serve_launches["masked_linear_coeffs_fwd"]),
            (*fwd, "train", kernel[("bfloat16", TRAIN_BATCH)],
             train_launches["masked_linear_coeffs_fwd"])]
    for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
        rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                     "train", kernel_bwd[name], train_launches[name]))
    flash_fwd = ("flash_fwd", f"{src}/flash_attention_fwd.cu",
                 f"{pallas}/attention_kernels.py:354")
    rows += [(*flash_fwd, "baseline_serve", flash[("flash_fwd", "baseline_serve")],
              base_serve["flash_fwd"]),
             (*flash_fwd, "baseline_train", flash[("flash_fwd", "baseline_train")],
              base_train["flash_fwd"]),
             (*flash_fwd, "baseline_longn_train", flash[("flash_fwd", "baseline_longn_train")],
              base_longn["flash_fwd"])]
    for name, line, path, launches in (
            ("flash_bwd_fused", 197, "baseline_train", base_train),
            ("flash_bwd_dq", 71, "baseline_longn_train", base_longn),
            ("flash_bwd_dkv", 129, "baseline_longn_train", base_longn)):
        rows.append((name, f"{src}/flash_attention_bwd.cu", f"{pallas}/flash_bwd.py:{line}",
                     path, flash[(name, path)], launches[name]))
    rot_src, rot_tpu = f"{src}/circulant_rotate.cu", f"{pallas}/rotation_kernels.py"
    for name, line, path, launches in (
            ("circulant_rotate_fwd", 107, "circulant_serve", circ_serve),
            ("circulant_rotate_fwd", 107, "circulant_train", circ_train),
            ("circulant_rotate_fwd", 107, "circulant_longn_train", circ_longn),
            ("circulant_rotate_bwd", 128, "circulant_train", circ_train),
            ("circulant_rotate_bwd", 128, "circulant_longn_train", circ_longn)):
        rows.append((name, rot_src, f"{rot_tpu}:{line}", path, rotation[(name, path)],
                     launches[name]))
    fused_fwd = ("kerple_fused_phi_fwd", f"{src}/kerple_fused_phi_fwd.cu", f"{mlc_tpu}:520")
    rows += [(*fused_fwd, "fused_serve", fused[("bfloat16", VITB["batch_size"])],
              fused_serve["kerple_fused_phi_fwd"]),
             (*fused_fwd, "fused_train", fused[("bfloat16", TRAIN_BATCH)],
              fused_train["kerple_fused_phi_fwd"])]
    rows.append((*fwd, "kerple_longn_train", longn_fwd[("bfloat16", KERPLE_LONGN[0])],
                 kerple_longn["masked_linear_coeffs_fwd"]))
    for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
        rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                     "kerple_longn_train", longn_bwd[name], kerple_longn[name]))
    # the K-step CUDA graphs (phase 17: the capture's own launches) and the
    # engine's loops (phase 18)
    for path, launches, fwd_row, bwd_rows in (
            ("multistep", multi_launches, head_fwd, head_bwd),
            ("multistep_vitb", vitb_launches, kernel[("bfloat16", TRAIN_BATCH)], kernel_bwd),
            ("engine", engine_launches, head_fwd, head_bwd),
            ("cli_train", cli_launches, cli_fwd, cli_bwd),
            ("moe_remat_train", moe_launches, kernel[("bfloat16", TRAIN_BATCH)], kernel_bwd)):
        rows.append((*fwd, path, fwd_row, launches["masked_linear_coeffs_fwd"]))
        for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
            rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                         path, bwd_rows[name], launches[name]))
    # the benchmark runner's calls (phase 20): #1 / #2 at the CLI's shape
    # (phase 19's rows), #6 / 7a at the baseline's (phase 20 c)
    flash_tpu = {"flash_fwd": ("flash_attention_fwd.cu", "attention_kernels.py:354"),
                 "flash_bwd_fused": ("flash_attention_bwd.cu", "flash_bwd.py:197")}
    for path, launches in (("benchmark_seq", bench_seq), ("benchmark_ensemble", bench_ens)):
        rows.append((*fwd, path, cli_fwd, launches["masked_linear_coeffs_fwd"]))
        for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
            rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                         path, cli_bwd[name], launches[name]))
        for name, (source, replaces) in flash_tpu.items():
            rows.append((name, f"{src}/{source}", f"{pallas}/{replaces}", path,
                         bench_flash[name], launches[name]))
    # the materialised-T kernels on the pallas_ab path, one row per shape
    for shape in pallas_ab.SHAPES:
        for name, source, replaces in (
                ("masked_linear_fwd", "masked_linear_fwd.cu", "attention_kernels.py:181"),
                ("masked_linear_bwd_dq", "masked_linear_bwd.cu", "masked_linear_bwd.py:54"),
                ("masked_linear_bwd_dkv", "masked_linear_bwd.cu", "masked_linear_bwd.py:82"),
                ("masked_linear_bwd_dt", "masked_linear_bwd.cu", "masked_linear_bwd.py:123")):
            rows.append((name, f"{src}/{source}", f"{pallas}/{replaces}", "pallas_ab",
                         dict(materialised[(name, shape)], shape=list(shape)),
                         ab_launches[shape][name]))
    # the served artifacts (phase 21): #1 at phase 3's serving shape (ViT-B)
    # and at the CLI's (mnist widths, the CPU export), #6 of serve_bench
    # --vitb at phase 3c's serving shape, the rest at SERVE_SHAPE
    served_src = {
        "masked_linear_coeffs_fwd": fwd[1:],
        "flash_fwd": flash_fwd[1:],
        "kerple_fused_phi_fwd": fused_fwd[1:],
        "circulant_rotate_fwd": (rot_src, f"{rot_tpu}:107"),
    }
    served_at = {"serve_export_vitb": kernel[("bfloat16", VITB["batch_size"])],
                 "serve_export_cpu": cli_fwd,
                 "serve_bench_vitb": flash[("flash_fwd", "baseline_serve")]}
    for path, (name, launches) in served_launches.items():
        rows.append((name, *served_src[name], path, served_at.get(path, served_rows.get(name)),
                     launches))
    # the parallel paths (phase 22): #1 / #2 at the shape a rank runs them
    train_rows = (kernel[("bfloat16", TRAIN_BATCH)], kernel_bwd)
    par_paths = [(path, launches, par_rows["microbatch"] if path == "pipeline" else train_rows)
                 for path, launches in par_world1.items()]
    par_paths += [(path, par_two[path]["launches"], par_rows[key] if key else train_rows)
                  for path, key in (("parallel_dp2", "half_batch"),
                                    ("parallel_fsdp2", "half_batch"),
                                    ("parallel_tp2", "half_heads"), ("parallel_ep2", None),
                                    ("parallel_pp2", "microbatch"))]
    for path, launches, (fwd_row, bwd_rows) in par_paths:
        rows.append((*fwd, path, fwd_row, launches["masked_linear_coeffs_fwd"]))
        for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
            rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                         path, bwd_rows[name], launches[name]))
    # phase 23's paths: the sharded ensemble at the CLI's shape (phase 19's
    # rows), the redraw graphs at the headline's (phase 17's), the imported
    # model's predict (fp32), the sweep's KERPLE, flash and rotation kernels at
    # its shapes
    for path, fwd_row, bwd_rows in (
            ("ensemble_mesh", cli_fwd, cli_bwd),
            ("parallel_multistep_redraw", head_fwd, head_bwd),
            *((f"redraw_multistep_i{i}", head_fwd, head_bwd) for i in REDRAW_INTERVALS)):
        launches = qa_launches[path]
        rows.append((*fwd, path, fwd_row, launches["masked_linear_coeffs_fwd"]))
        for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
            rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                         path, bwd_rows[name], launches[name]))
    rows.append((*fwd, "import_predict", import_row,
                 qa_launches["import_predict"]["masked_linear_coeffs_fwd"]))
    sweep_fwd, sweep_bwd, sweep_flash, sweep_rot = sweep_rows
    for path, launches in sweep_launches.items():
        rows.append((*fwd, path, sweep_fwd, launches["masked_linear_coeffs_fwd"]))
        for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
            rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                         path, sweep_bwd[name], launches[name]))
        for name, (source, replaces) in flash_tpu.items():
            rows.append((name, f"{src}/{source}", f"{pallas}/{replaces}", path,
                         sweep_flash[name], launches[name]))
        for name, line in (("circulant_rotate_fwd", 107), ("circulant_rotate_bwd", 128)):
            rows.append((name, rot_src, f"{rot_tpu}:{line}", path, sweep_rot[name],
                         launches[name]))
    # phase 24's auto forwards (#1, #6 and #8) and the materialised-T auto
    # backwards (#5): one row per kernel and shape, launches and times there
    origin = {fwd[0]: fwd[1:], flash_fwd[0]: flash_fwd[1:],
              "circulant_rotate_fwd": (rot_src, f"{rot_tpu}:107"),
              **{name: (f"{src}/masked_linear_bwd.cu", f"{pallas}/masked_linear_bwd.py:{line}")
                 for name, line in (("masked_linear_bwd_dq", 54), ("masked_linear_bwd_dkv", 82))}}
    for (name, shape), (n, row) in sorted(dispatch.items()):
        path = ("dispatch_auto_bwd" if name.startswith("masked_linear_bwd") else "dispatch_auto")
        rows.append((name, *origin[name], f"{path}_{'x'.join(map(str, shape))}", row, n))
    # phase 25's experiments: #1 / #2 and #6 / 7a / 7b at each path's shape
    exp_origin = {
        fwd[0]: fwd[1:], flash_fwd[0]: flash_fwd[1:],
        **{name: (f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}")
           for name, line in zip(BWD_KERNELS, (227, 258, 301, 343))},
        **{name: (f"{src}/flash_attention_bwd.cu", f"{pallas}/flash_bwd.py:{line}")
           for name, line in (("flash_bwd_fused", 197), ("flash_bwd_dq", 71),
                              ("flash_bwd_dkv", 129))}}
    for name, path, row, n in experiment_rows:
        rows.append((name, *exp_origin[name], path, row, n))
    # phase 26's phi+ kernels at the flagship cells' shapes; the train step's
    # launches on the first
    for (name, shape), row in sorted(phi_rows.items()):
        rows.append((name, f"{src}/phi_positive.cu", "none (XLA fused it in JAX)",
                     f"phi_{'x'.join(map(str, shape))}", row,
                     phi_step[name] if shape == PHI_SHAPES[0] else 0))
    rows += sam_rows
    log("done", f"all phases passed in {time.perf_counter() - started:.1f} s of command time")
    print_results(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
