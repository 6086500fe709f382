#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It drives ``metaopt_tpu_torch`` (never JAX, never
``metaopt_tpu``) through fourteen phases and exits non-zero if any fails:

1. build: compiles the flash-attention kernels from ``metaopt_tpu_torch/
   csrc``, prints ptxas's registers and spills per kernel (and fails if
   the bf16 K1 ``flash_fwd_kernel_mma`` is missing for a head dim, with or
   without dropout), and prints the card's name and power limit;
2. kernels: holds each kernel (K1 forward, K2 dK/dV, K3 dQ) against its
   plain PyTorch version on the same inputs, at the Transformer's shapes
   (B 32, S 64, H 8, D 64, bf16; padding, causal and cross masks), at
   head dims 32 and 128 (bf16, padding mask), at a ragged multi-tile shape
   (4, 333, 8, 64) in f32 and bf16 with fully masked rows, at a ragged
   cross shape (B 3, Sq 96, Sk 200, H 4, D 64, bf16, broadcast padding
   mask), at the long shape (B 8, S 512, H 8, D 64, bf16, causal) and at
   (B 2, Sq 200, Sk 330, H 4, D 64, bf16) under tril(Sq, Sk), where K1
   skips whole masked K tiles; runs ``flash_attention`` forward and
   backward through autograd at the slice's shape (bf16, causal), so K2
   and K3 take K1's own lse, against the same call on the CPU; then times
   the kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it) at the slice's shape and at
   the long shape, and prints (K2 + K3) / SDPA's backward for both; then
   times the kernels with attention dropout 0.1 at both shapes against
   rate 0 (SDPA with ``dropout_p`` 0.1 as the yardstick);
3. model: the full-width Transformer-base loss on one small batch on the
   card against the same model on the CPU (plain attention);
4. slice: ``build_experiment(...).workon(objective)`` with random search,
   three trials of full-width Transformer-base training, and checks that
   every kernel ran 18 times per forward (K1) and per train step (K2, K3);
5. profile: times five train steps, traces five more, and prints the
   device busy share of the step, device time by kind of kernel, the
   kernels that take the most device time and the flash-attention
   kernels; it fails if the trace holds no ``flash_fwd_kernel_mma``;
6. tpe: ``tpe_suggest_fused`` on the card against the CPU on the same
   inputs and injected draws (n 16 and 4096, d 4 with one categorical
   column, a NaN objective, a liar overlay): fit tensors within 1e-5,
   identical winners; the card's own draws against the CPU generator's by a
   two-sample KS test; then ``build_experiment(algorithm={"tpe": ...})
   .workon`` of BASELINE config 2 (the 4-hparam MLP, full-size trials: 8192
   train and 2048 validation images, batch 256, 3 epochs), 10 random then 6
   EI trials; then the suggest side's times: host ms per EI launch, device
   ms and CUDA kernels per ``tpe_suggest_fused`` and of its scorer alone,
   at n 10-16 and 4096, H2D bytes per suggest, prefetch hits and misses,
   ms per MLP train step and per trial;
7. gp: GP-BO (``examples/gp.yaml``: seed 0, 8 initial points, 60 Adam
   steps per fit) on BASELINE config 2's space and full MLP trial,
   in-process: 16 trials, 8 of them by EI on the card, its buffer, factor
   and hyperparameters on the card. On that run's padded buffer and fitted
   hyperparameters, card against CPU: ``_neg_mll`` (1e-5) and its gradient
   (1e-4, both relative to the largest entry), ``gp_fit_mll`` after 60 steps
   (1e-4), ``gp_chol_full`` (1e-5), a chain of ``gp_chol_append`` against the
   full factor, and EI's winners over a fixed candidate set (identical);
   the same stages with TF32 switched on, against off. Then host ms, device
   ms, CUDA kernels and device syncs per EI launch, cold
   (``incremental=False``) and incremental, and host ms per fit of 15 and
   60 steps;
8. hunt: the port's CLI, ``python -m metaopt_tpu_torch hunt`` in fresh
   processes with subprocess trials on a ``file:`` ledger in a temp dir:
   (a) BASELINE config 1, random search (seed 0) on
   ``metaopt_tpu_torch/examples/rosenbrock.py`` with 4 workers and 100
   trials — all completed, none broken, none run twice, a finite best, and
   ``status --json`` from another fresh process agreeing; (b) BASELINE
   config 2, TPE (``examples/tpe.yaml``'s settings, passed as JSON) on
   ``metaopt_tpu_torch/examples/mlp_mnist.py``, 11 trials (cut from 16 to
   make room for phase 14), each a fresh process on the card — finite, at
   least 1 suggested by EI, in the space,
   each on CUDA — split into process start → first CUDA op, training, and
   the rest of the trial's ledger wall; (c) ``cuda_backend_reachable()``;
9. asha: BASELINE config 3. (a) The full-width ResNet-50 on the card
   against the same weights on the CPU (batch 8, eval and train mode, bf16
   bound); a 3-epoch in-process ``train_and_eval`` at the reference's
   defaults whose mean training loss must fall; 20 timed and 5 traced
   train steps (batch 128): ms per step, images per second, device busy
   share, device ms by kind of kernel, peak memory. (b) ASHA (``asha.json``,
   seed 0, pool 1) on ``metaopt_tpu_torch/examples/resnet_cifar.py`` at
   full width through ``hunt --n-chips 1`` with ``epochs~fidelity(1, 9,
   base=3)`` on 1024 training images (cut from ``fidelity(1, 16, base=4)``
   and 4096 to fit phase 14), 13 trials, each a fresh process pinned to
   the card — all completed and finite, budgets 1, 3 and 9
   reached, promotions on their parents' lineage, every trial on the
   card, the GPU registry empty after, ``status --rungs --json`` from a
   fresh process equal to ASHA replayed over the ledger. (c) Config 3's
   trials per hour and each trial's split: process start → first CUDA op,
   setup, training, eval, the rest.
10. evolution: BASELINE config 5. (a) PPO at full width (64 environments,
   128 steps, hidden 64, 4 full-batch updates) on the card against the CPU
   for two iterations from the same parameters and draws: every parameter
   and the advantages within 1e-4 of the tensor's largest entry, the return
   within 1e-4 relative. (b) ``train({"lr": 3e-4})`` for seed 0 on the
   card (seed 1 dropped to fit phase 14): the negated return above 50 after 2 iterations and below 5
   after 32; ms per iteration; one traced iteration's CUDA kernels, device
   busy share and device ms by kind; peak memory. (c) EvolutionES
   (``evolution.json``: seed 0, population 10, pool 5) on
   ``metaopt_tpu_torch/examples/ppo_atari.py`` through ``hunt --n-chips 1``,
   20 trials (two generations; the example runs 60), each a fresh process
   on the card — all completed and finite, their points equal to the
   port's EvolutionES replayed on the CPU over the ledger's objectives, the
   GPU registry empty after, ``status --json`` from a fresh process
   agreeing; trials per hour and each trial's split: process start → first
   CUDA op, setup, training, the rest. (d) Hyperband (seed 0, one
   repetition; 5 trials) and BOHB (seed 0, three repetitions; 15 trials,
   its TPEs on the card) in-process over PPO with ``epochs~fidelity(2, 4,
   base=2)`` (cut from fidelity(2, 8, base=2), 14 and 28 trials): every
   rung of the bracket table filled and completed, and at least one BOHB
   point suggested by EI on the card.
11. wmt: BASELINE config 4. (a) K1-K3 with attention dropout at rates 0.1
   and 0.3 against their plain versions on the same Philox (seed, offset),
   at the slice's shapes (bf16; padding, causal, cross masks), the ragged
   shape (f32 and bf16, fully masked rows) and the long causal shape;
   ``flash_attention`` forward and backward with dropout through autograd
   against the CPU; the kernel's kept fraction (read from O with v = 1)
   within 4 sigma of 1 - rate; a trace holding each kernel's dropout
   instantiation. (b) The rate-0.1 times against rate 0 are phase 2's. (c) The
   full-width Transformer-base in train mode at dropout 0.1, card against
   CPU on the same weights, attention seeds and injected feed-forward
   masks: the loss and every gradient norm within 3e-2. (d) 20 timed and 5
   traced train steps at dropout 0.1. (e) BOHB (seed 0, one repetition,
   cut from two to fit phase 14) in-process over config 4's priors with
   ``epochs~fidelity(1, 9, base=3)`` at 2 steps per epoch (cut from 50):
   every rung filled, at
   least one point by EI on the card, K1-K3 launched 18 times per train
   step, every launch with dropout. (f) Hyperband (``hyperband.json``) on
   ``metaopt_tpu_torch/examples/transformer_wmt.py --tp 1`` at full width
   through ``hunt --n-chips 1`` with ``epochs~fidelity(1, 3, base=3)`` (cut
   from 1-9: 6 trials instead of 22) at 10 steps per epoch (cut from 50 to
   fit phase 14) — all completed and finite on the
   card, the rung table equal to Hyperband replayed over the ledger and to
   ``status --rungs --json`` from a fresh process, every trial's checkpoint
   published and none half-written, no ``torch._dynamo`` in a trial
   process, the GPU registry empty; trials per hour and each trial's
   split: process start -> first CUDA op, setup, training, checkpoint, the
   rest.
12. pbt: PBT (``examples/pbt.yaml``: population 6, seed 0, min cohort 3,
   exploit quantile 0.25, pool 2) on ``metaopt_tpu_torch/examples/
   transformer_wmt.py --tp 1`` at full width through ``hunt --n-chips 1
   --ckpt-root``, config 4's priors with ``epochs~fidelity(1, 4, base=2)``
   at 10 steps per epoch (cut from 50), stopped at ``PBT_TRIALS`` — all
   completed and finite on the card, every checkpoint published; every
   continuation restored its parent's published state (its AdamW count
   starts at the count in the parent's checkpoint and ends its own steps
   later, as its own checkpoint holds); at least one exploit took another
   member's weights; the ledger's trials and parents equal to the port's
   PBT replayed on the CPU over the ledger's objectives; the GPU registry
   empty; trials per hour and each trial's split;
13. algos: in-process, CMA-ES (``cmaes.yaml``) and grid search (4 x 4) on
   Rosenbrock, DEHB (``dehb.yaml``) on Rosenbrock with a fidelity, gradient
   descent on a gradient-reporting quadratic, MOTPE (``motpe.yaml``: 12
   initial points, 24 trials) on ZDT1 with its EI on the card: finite
   objectives, the trial counts, two CMA-ES generations, a DEHB promotion,
   the lattice exhausted, gradient descent at the bowl, 12 MOTPE points by
   EI.
14. lm: the decoder-only LM at full width (``make_lm``'s defaults: d_model
   512, 8 heads, 6 layers, d_ff 2048, vocab 1000) at seq 512. (a) Card
   against CPU at full width, batch 2, 2 layers (depth cut from 6 to fit
   the time limit), on the same weights, attention seeds and
   feed-forward masks: dense, and MoE with 8 experts at k = 1 and 2
   (capacity 1.25), each at dropout 0 and 0.1: eval-mode logits within 3e-2
   of their scale, the loss within 3e-2 relative, every gradient's norm
   within 3e-2 of its own (the routers' within 5e-2; the key biases', 0 in
   exact arithmetic, within 3e-2 of 1% of the largest norm), and in the
   dense cases every gradient element within 1e-1 of its tensor's largest
   entry. (b) The train step at batch 32 (16,384 tokens), dropout
   0.1, plain and under remat: K1, K2 and K3 launched 6 times each per step
   (K1 12 times under remat), every launch with dropout; 10 timed and 5
   traced steps: ms per step, device busy share, device ms by kind, K1-K3's
   device ms per step, peak memory; remat on against off on one step's loss
   (bit-equal) and gradients (3e-2 of their scale). (c) The MoE LM (k = 1
   and 2) for 5 timed steps: ms per step, dropped fraction and balance loss
   per layer; one in-process ``train_and_eval`` of Transformer-base with 8
   experts. (d) The blocked xent against the materialized one at N 32,768 x
   V 32,768 x D 512 (bf16 in, 4 GiB of f32 logits): values within 1e-3,
   both gradients within 3e-2 of their scale, each path's time and added
   peak memory, TF32 on against off; one LM step at vocab 32,768, batch 64 x
   512, which must take the blocked route. (e) TPE (``tpe.json``) on
   ``metaopt_tpu_torch/examples/lm_causal.py`` at d_model 512, d_ff 2048,
   seq 512 with the example's priors through ``hunt --n-chips 1``, 4
   trials (all random draws: 10 initial points) — finite, on the card,
   checkpoints published, the GPU registry empty; trials per hour and each
   trial's split.

It prints a ``{"kernels": [...]}`` line, a ``{"tpe": {...}}`` line, a
``{"gp": {...}}`` line, a ``{"hunt": {...}}`` line, an ``{"asha": {...}}``
line, an ``{"evolution": {...}}`` line, a ``{"wmt": {...}}`` line, a
``{"pbt": {...}}`` line, an ``{"algos": {...}}`` line, an ``{"lm": {...}}``
line and, last, the ``{"ok": true, "device": {...}}`` line. The
``{"kernels": ...}`` line lists K1-K3 at rate 0 (launches from the [slice]
run) and at rate 0.1 (times from phase 2, launches from the [wmt] BOHB
run; under ``"lm"`` the launches and device ms on the LM's path).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

STEPS = 20             # train steps per trial
TRIALS = 3
ATTN_PER_STEP = 18     # 6 encoder self + 6 decoder self + 6 cross attentions
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16; f32 non-tensor
TOL = {"float32": {"fwd": 1e-5, "grad": 1e-4}, "bfloat16": {"fwd": 3e-2, "grad": 3e-2}}
KERNEL_SOURCE = "metaopt_tpu_torch/csrc/flash_attention.cu"
TPE_SPACE = {  # BASELINE config 2: examples/mlp_mnist.py's docstring
    "lr": "loguniform(1e-4, 1e-1)",
    "width": "uniform(64, 1024, discrete=True)",
    "depth": "uniform(1, 6, discrete=True)",
    "dropout": "uniform(0.0, 0.5)",
}
TPE_TRIALS, TPE_INITIAL = 16, 10
# config 2 through the CLI: cut from 16 trials (10 random, 6 by EI) to 11
# (10 random, 1 by EI) to make room for the [lm] phase; the in-process hunt of
# [tpe] keeps its 16
HUNT_TPE_TRIALS = 11
ROSEN_TRIALS, ROSEN_WORKERS = 100, 4    # BASELINE config 1
ROSEN_SPACE = {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)"}
# a CLI process's deadline: its own start (import torch, ~10 s on the card's
# host; TPE's CUDA context) plus an allowance per trial and worker, ~3x the
# slowest trial measured (config 1 0.41 s, config 2 31 s with torch.optim's
# first Adam, which the MLP no longer builds; PR 5's chip runs)
HUNT_START_S = 120
ROSEN_TRIAL_S, MLP_TRIAL_S = 5, 45
TPE_TOL = 1e-5          # fit tensors, card against CPU
RESNET_SPACE = {  # BASELINE config 3: examples/resnet_cifar.py's docstring
    "lr": "loguniform(1e-3, 1.0)",
    "momentum": "uniform(0.8, 0.99)",
    "weight-decay": "loguniform(1e-6, 1e-2)",
    "epochs": "fidelity(1, 16, base=4)",
}
# config 3 through the CLI, cut to make room for the [lm] phase: epochs
# fidelity(1, 9, base=3) instead of the example's (1, 16, base=4), and 1024
# training images (8 steps per epoch) instead of 4096 (32)
ASHA_FIDELITY, ASHA_BUDGETS, ASHA_N_TRAIN = "fidelity(1, 9, base=3)", (1, 3, 9), 1024
# the fewest trials with which ASHA (one worker, pool 1) reaches budget 9
# whatever the objectives: 9 at 1 epoch, 3 at 3, 1 at 9 (the example runs
# 64; at asha.json's pool of 4 one worker never reaches the top, see
# examples/resnet_cifar.py)
ASHA_TRIALS = 13
RESNET_BATCH, RESNET_TIMED_STEPS, RESNET_TRACED_STEPS = 128, 20, 5
# a config-3 trial's wall-clock timeout, and its share of the CLI's deadline
RESNET_TIMEOUT_S, RESNET_TRIAL_S = 300, 40
RESNET_KINDS = (  # first match wins: cuDNN's batch-norm kernels before its convolutions
    ("batch norm (cuDNN)", ("batchnorm", "batch_norm")),
    ("running-stat reduction (var_mean)", ("WelfordOps",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "sm90")),
    ("convolutions as matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("optimizer (foreach SGD)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("casts and copies", ("copy_kernel",)),
)
PPO_SPACE = {  # BASELINE config 5: examples/ppo_atari.py's docstring
    "lr": "loguniform(1e-5, 1e-2)",
    "clip-eps": "uniform(0.05, 0.4)",
    "ent-coef": "loguniform(1e-4, 1e-1)",
    "gae-lambda": "uniform(0.8, 1.0)",
    "epochs": "fidelity(2, 32, base=2)",
}
# two full generations of evolution.json's population of 10: 10 trials at 2
# iterations, then 10 mutants of the top 5 at 4 (the example runs 60)
EVOLUTION_TRIALS, POPULATION = 20, 10
# a config-5 trial's wall-clock timeout, and its share of the CLI's deadline
PPO_TIMEOUT_S, PPO_TRIAL_S = 120, 30
PPO_TOL = 1e-4          # card against CPU, relative to each tensor's largest entry
PPO_ITERS = 32          # a full-fidelity trial
HB_SPACE = {  # config 5's priors for the in-process Hyperband and BOHB runs
    "lr": "loguniform(1e-5, 1e-2)",
    "clip_eps": "uniform(0.05, 0.4)",
    "ent_coef": "loguniform(1e-4, 1e-1)",
    "epochs": "fidelity(2, 4, base=2)",
}
# Hyperband (seed 0) over fidelity(2, 4, base=2), cut from fidelity(2, 8,
# base=2) (14 trials, 68 iterations per repetition) to make room for phases
# 12 and 13: (bracket, budget, capacity), every rung filled and completed;
# one repetition is 5 trials, BOHB runs three (15 trials, 4 of them by EI)
HB_TABLE = [(0, 2, 2), (0, 4, 1), (1, 4, 2)]
HB_TRIALS, BOHB_REPETITIONS = 5, 3
PPO_KINDS = (
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "splitK")),
    ("optimizer (foreach Adam, clip)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("casts, copies and concatenations", ("copy_kernel", "CatArrayBatched", "cat_")),
)
WMT_PRIORS = {  # BASELINE config 4: examples/transformer_wmt.py's docstring
    "lr": "loguniform(1e-4, 5e-3)",
    "dropout": "uniform(0.0, 0.3)",
    "warmup": "uniform(100, 4000, discrete=True)",
}
# config 4 through the CLI, cut from fidelity(1, 9, base=3) (22 trials) to
# fidelity(1, 3, base=3): bracket 0 runs 3 trials at 1 epoch and promotes 1
# to 3, bracket 1 runs 2 at 3 epochs; (bracket, budget, capacity) below
WMT_CLI_FIDELITY, WMT_CLI_TABLE = "fidelity(1, 3, base=3)", [(0, 1, 3), (0, 3, 1), (1, 3, 2)]
# ... and from 50 steps per epoch to 10, to fit the [lm] phase
WMT_CLI_TRIALS, WMT_STEPS_PER_EPOCH = 6, 10
# a config-4 trial's wall-clock timeout, and its share of the CLI's deadline
WMT_TIMEOUT_S, WMT_TRIAL_S = 300, 60
# BOHB in-process: the example's fidelity, one repetition of 22 trials (cut
# from two to fit the [lm] phase), cut from 50 steps per epoch to 2
WMT_BOHB_FIDELITY, WMT_BOHB_STEPS_PER_EPOCH = "fidelity(1, 9, base=3)", 2
WMT_BOHB_REPETITIONS = 1
WMT_BOHB_TABLE = [(0, 1, 9), (0, 3, 3), (0, 9, 1), (1, 3, 5), (1, 9, 1), (2, 9, 3)]
WMT_RATES = (0.1, 0.3)          # attention dropout checked on the card
WMT_TIMED_RATE = 0.1            # the Transformer-base rate, timed against rate 0
DROPOUT_SEED, DROPOUT_OFFSET = 0x9E3779B97F4A7C15, 12345
GP_YAML = {"seed": 0, "n_initial_points": 8, "fit_iters": 60}  # examples/gp.yaml
GP_FIT_LR, GP_REFIT_ITERS, GP_N_CAND = 0.05, 15, 512  # GPBO's defaults
GP_TRIALS = 16          # 8 random, 8 by EI
# GP-BO's stages, card against CPU: f32 forward, the MLL's gradient (relative
# to its largest entry) and the fitted hyperparameters after 60 Adam steps
GP_TOL = {"fwd": 1e-5, "grad": 1e-4, "fit": 1e-4}
# PBT (examples/pbt.yaml: population 6, seed 0, min_cohort 3, exploit quantile
# 0.25, pool 2) on Transformer-base through the CLI over config 4's priors,
# with the fidelity the smoke runs (1, 2 and 4 epochs) and 10 steps per epoch
# (cut from 50)
PBT_PRIORS = {**WMT_PRIORS, "epochs": "fidelity(1, 4, base=2)"}
PBT_STEPS_PER_EPOCH = 10
# the fewest trials that hold an exploit continuation: 12, found by the port's
# PBT replayed on the CPU over the card's losses of a full 18-trial run (6
# members x 3 rungs; the exploit is the 12th trial). It depends on the
# losses: over random objectives the first exploit falls anywhere from the
# 9th trial to never (8% of 300 streams); the card's losses are fixed by
# the seeds (init, data, dropout) and far apart.
PBT_TRIALS = 12
PBT_TRIAL_S = 60        # a trial's share of the CLI's deadline
MOTPE_YAML = {"seed": 0, "n_objectives": 2, "n_initial_points": 12, "gamma": 0.3}
MOTPE_TRIALS = 24
LM_BATCH, LM_SEQ = 32, 512      # train_lm's batch at the phase's sequence: 16,384 tokens
# card against CPU (the CPU runs the plain attention): full width, batch 2,
# depth cut from 6 to 2 layers to fit the script's time limit
LM_CMP_BATCH, LM_CMP_LAYERS = 2, 2
# the routers' gradient norms, card against CPU: each token's router-logit
# gradient sums to 0 over the experts, so these are sums whose terms cancel,
# and the bf16 attention kernels' differences from the CPU's f32 plain
# versions reach them through an f32 residual (measured worst 2.99e-2, the
# k = 2 router bias at dropout 0.1; NVIDIA H100 80GB HBM3, 700 W)
LM_ROUTER_TOL = 5e-2
# the dense LM's gradients elementwise, card against CPU, relative to each
# tensor's largest entry: the card's K2/K3 multiply bf16-rounded
# probabilities where the CPU's plain versions keep f32, and the first
# layer's feed-forward weights sum that over 1024 tokens (measured worst
# 5.20e-2 and 5.36e-2 at dropout 0 and 0.1, h.0.mlp.wi.weight; NVIDIA H100
# 80GB HBM3, 700 W). With MoE a token near a routing tie goes to another
# expert, so elementwise errors reach ~0.35 there and only the norms are held
LM_DENSE_ELEM_TOL = 1e-1
LM_MOE = [{"n_experts": 8, "router_top_k": 1}, {"n_experts": 8, "router_top_k": 2}]
LM_STEPS, LM_TRACED, LM_MOE_STEPS = 10, 5, 5
LM_XENT = (32768, 32768, 512)   # N tokens x V x D: 4 GiB of f32 logits, the blocked route
LM_BIG_VOCAB = (64, 512, 32768)  # batch x seq x vocab of the LM step on the blocked route
LM_PRIORS = {  # examples/lm_causal.py's docstring
    "lr": "loguniform(1e-4, 1e-1)",
    "dropout": "uniform(0.0, 0.3)",
    "n-layers": "uniform(1, 4, discrete=True)",
}
LM_CLI_TRIALS, LM_TRIAL_S = 4, 60  # with 10 initial points, all four are TPE's random draws
REPLACES = {
    "flash_fwd": "metaopt_tpu/ops/attention.py:77 (_flash_fwd_kernel)",
    "flash_bwd_dkv": "metaopt_tpu/ops/attention.py:181 (_flash_bwd_dkv_kernel)",
    "flash_bwd_dq": "metaopt_tpu/ops/attention.py:238 (_flash_bwd_dq_kernel)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """{"kernel<D, dropout>": registers and spill bytes} from ``nvcc
    -Xptxas=-v`` output: each "Compiling entry function" line names a kernel
    by its mangled name, and the "spill" and "Used N registers" lines after
    it belong to it."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'_Z\w*?\d+(flash_\w+?)I\w*?Li(\d+)ELb([01])E", line)
            cur = (f"{m.group(1)}<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>"
                   if m else None)
            if cur:
                out[cur] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# timing


def events_ms(torch, fn, n: int = 50) -> float:
    """Mean time per call over ``n`` back-to-back calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_rows(prof, calls: int):
    """(name, device ms per call, launches per call) of every kernel in a
    torch.profiler trace. Device-side spans of record_function annotations
    (the optimizer step's) cover kernels that are listed on their own, so
    they are skipped."""
    return [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def device_ms(torch, fn, n: int = 50, match: str = ""):
    """Time per call of ``fn`` on the card: (ms, source, events ms).

    ``ms`` is the device time of the kernels ``fn`` launches whose name
    holds ``match`` (all of them by default), from torch.profiler over
    ``n`` calls. With ``match``, ``fn`` launches one such kernel a call,
    and ``ms`` is the mean over the launches the trace recorded: the
    profiler can drop records, and a sum over n calls would then read
    low; a window whose records were all dropped is traced again, twice at
    most. When the profiler yields no device time it is the CUDA-event
    time, which also counts the host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    ev = events_ms(torch, fn, n)
    total = 0.0
    for _ in range(3):
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            rows = [(ms, cnt) for key, ms, cnt in kernel_rows(prof, n) if match in key]
        except Exception as err:  # the profiler is a measurement aid only
            log(f"  (torch.profiler unavailable: {type(err).__name__}: {err})")
            break
        total = sum(ms for ms, _ in rows)
        seen = round(sum(cnt for _, cnt in rows) * n)
        if match and seen:
            if seen != n:
                log(f"  (the trace recorded {seen} of {n} launches of {match})")
            total *= n / seen
        if total > 0:
            break
        log("  (the trace recorded no device time; tracing again)")
    return (total, "profiler", ev) if total > 0 else (ev, "cuda_events", ev)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def make_case(torch, name, b, sq, sk, h, d, dtype, kind, gen):
    dev = "cuda"
    q = torch.randn(b, sq, h, d, generator=gen, device=dev) / math.sqrt(d)
    k = torch.randn(b, sk, h, d, generator=gen, device=dev)
    v = torch.randn(b, sk, h, d, generator=gen, device=dev)
    g = torch.randn(b, sq, h, d, generator=gen, device=dev)
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    # per-row valid lengths, as padded token batches give them
    klen = torch.randint(sk // 2, sk + 1, (b,), generator=gen, device=dev)
    kpad = torch.arange(sk, device=dev)[None, :] < klen[:, None]       # (b, sk)
    if kind in ("pad", "cross"):
        mask = kpad[:, None, :]                 # (b, 1, sk): read as a broadcast view
    elif kind == "causal":
        causal = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))
        mask = causal[None] & kpad[:, None, :]
    elif kind == "tril":                        # causal, unpadded: a broadcast view, and
        # whole K tiles masked for a Q tile when Sk > Sq or Sq > 64
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))[None]
    elif kind == "causal+empty":
        causal = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))
        mask = (causal[None] & torch.ones(b, 1, 1, dtype=torch.bool, device=dev)).clone()
        mask[:, 5] = False                      # fully masked rows
        mask[1, 100:140] = False
    else:
        raise ValueError(kind)
    m8 = mask.to(torch.int8).expand(b, sq, sk)
    return dict(name=name, q=q, k=k, v=v, g=g, mask=m8, dtype=str(dtype).split(".")[-1])


def close(a, b, tol):
    """(max |a - b|, ok) with the allclose rule |a - b| <= tol + tol * |b|."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= tol + tol * b.abs()).all())


def check_case(torch, att, case, rate: float = 0.0):
    """Each kernel against its plain version on the same inputs; with
    ``rate`` > 0 both draw dropout from the same Philox (seed, offset)."""
    q, k, v, g, m = case["q"], case["k"], case["v"], case["g"], case["mask"]
    tol = TOL[case["dtype"]]
    drop = dict(dropout_rate=rate, seed=DROPOUT_SEED, offset=DROPOUT_OFFSET) if rate else {}
    out_k, lse_k = att.flash_fwd(q, k, v, m, **drop)
    out_p, lse_p = att.flash_fwd_plain(q, k, v, m, **drop)
    delta = att.attention_delta(g, out_p)
    dk_k, dv_k = att.flash_bwd_dkv(q, k, v, g, lse_p, delta, m, **drop)
    dk_p, dv_p = att.flash_bwd_dkv_plain(q, k, v, g, lse_p, delta, m, **drop)
    dq_k = att.flash_bwd_dq(q, k, v, g, lse_p, delta, m, **drop)
    dq_p = att.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, m, **drop)
    torch.cuda.synchronize()

    inf_k, inf_p = torch.isinf(lse_k), torch.isinf(lse_p)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"{case['name']}: lse +inf rows differ")
    fin = ~inf_p
    errs, oks = {}, []
    e, ok = close(out_k, out_p, tol["fwd"])
    e2, ok2 = close(lse_k[fin], lse_p[fin], tol["fwd"])
    errs["flash_fwd"] = max(e, e2)
    oks.append(("flash_fwd", ok and ok2))
    e, ok = close(dk_k, dk_p, tol["grad"])
    e2, ok2 = close(dv_k, dv_p, tol["grad"])
    errs["flash_bwd_dkv"] = max(e, e2)
    oks.append(("flash_bwd_dkv", ok and ok2))
    e, ok = close(dq_k, dq_p, tol["grad"])
    errs["flash_bwd_dq"] = e
    oks.append(("flash_bwd_dq", ok))
    for t in (out_k, dk_k, dv_k, dq_k):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{case['name']}: non-finite kernel output")
    n_inf = int(inf_p.sum())
    log(f"  {case['name']}{f' dropout {rate}' if rate else ''}: fwd {errs['flash_fwd']:.3e}"
        f"  dkv {errs['flash_bwd_dkv']:.3e}"
        f"  dq {errs['flash_bwd_dq']:.3e}  (tol fwd {tol['fwd']}, grad {tol['grad']};"
        f" {n_inf} lse=+inf rows)")
    bad = [k for k, ok in oks if not ok]
    if bad:
        raise AssertionError(f"{case['name']}: {bad} outside tolerance")
    return errs, (lse_p, delta)


def check_autograd(torch, att, case, rate: float = 0.0):
    """``flash_attention`` forward and backward through autograd on the card,
    so K2 and K3 consume K1's own lse (``check_case`` hands them the plain
    one), against the same call on the CPU tensors; with ``rate`` > 0 both
    draw their Philox seed from CPU generators seeded alike. Returns max
    |card - cpu| per output."""
    tol = TOL[case["dtype"]]["grad"]
    res = {}
    saved = dict(att.launches), dict(att.dropout_launches)
    for dev in ("cuda", "cpu"):
        q, k, v = (case[n].to(dev).detach().requires_grad_() for n in "qkv")
        out = att.flash_attention(
            q, k, v, case["mask"].to(dev), dropout_rate=rate,
            philox=att.draw_seed(torch.Generator().manual_seed(DROPOUT_SEED)))
        out.backward(case["g"].to(dev))
        res[dev] = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    torch.cuda.synchronize()
    att.launches.update(saved[0])  # comparison launches do not count
    att.dropout_launches.update(saved[1])
    errs, bad = {}, []
    for name, ref in res["cpu"].items():
        got = res["cuda"][name]
        if not torch.isfinite(got.float()).all():
            bad.append(name)
        errs[name], ok = close(got.cpu(), ref, tol)
        if not ok:
            bad.append(name)
    log(f"  autograd {case['name']}{f' dropout {rate}' if rate else ''}: "
        + "  ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"  (card vs cpu, tol {tol})")
    if bad:
        raise AssertionError(f"autograd {case['name']}: {bad} outside tolerance or non-finite")
    return errs


def time_case(torch, att, case, lse_delta, rate: float = 0.0):
    """Per kernel: its time, its bound, the plain version's and SDPA's (with
    ``dropout_p=rate``). The bound counts the matrix products' operations;
    dropout's Philox rounds are integer work outside it."""
    import torch.nn.functional as F

    q, k, v, g, m = case["q"], case["k"], case["v"], case["g"], case["mask"]
    lse, delta = lse_delta
    drop = dict(dropout_rate=rate, seed=DROPOUT_SEED, offset=DROPOUT_OFFSET) if rate else {}
    b, sq, h, d = q.shape
    sk = k.shape[1]
    esz = q.element_size()
    # the mask is read once per distinct byte: a broadcast view (stride 0
    # over the query axis, as the padding mask is) holds b * sk of them
    mask_b = math.prod(n for n, st in zip(m.shape, m.stride()) if st != 0)
    row_f32 = b * h * sq * 4
    work = {
        "flash_fwd": (
            lambda: att.flash_fwd(q, k, v, m, **drop),
            lambda: att.flash_fwd_plain(q, k, v, m, **drop),
            4 * q.numel() * esz + mask_b + row_f32,           # q k v o, mask, lse
            4.0 * b * h * sq * sk * d),
        "flash_bwd_dkv": (
            lambda: att.flash_bwd_dkv(q, k, v, g, lse, delta, m, **drop),
            lambda: att.flash_bwd_dkv_plain(q, k, v, g, lse, delta, m, **drop),
            6 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dk dv
            8.0 * b * h * sq * sk * d),
        "flash_bwd_dq": (
            lambda: att.flash_bwd_dq(q, k, v, g, lse, delta, m, **drop),
            lambda: att.flash_bwd_dq_plain(q, k, v, g, lse, delta, m, **drop),
            5 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dq
            6.0 * b * h * sq * sk * d),
    }
    # the library yardstick: one SDPA call on the same inputs (never used
    # by the port); its backward computes dq, dk and dv together
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    amask = (m != 0)[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, dropout_p=rate,
                                              scale=1.0)

    out = sdpa()
    gt = g.transpose(1, 2)
    lib_fwd = device_ms(torch, sdpa)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), gt, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dkv": lib_bwd, "flash_bwd_dq": lib_bwd}

    saved = dict(att.launches), dict(att.dropout_launches)
    stats = {}
    for name, (kern, plain, nbytes, flops) in work.items():
        ms, src, ev = device_ms(torch, kern, match=name + "_kernel")
        plain_ms, plain_src, plain_ev = device_ms(torch, plain, n=10)
        lib_ms, lib_src, lib_ev = library[name]
        bnd, by = bound_ms(nbytes, flops, case["dtype"])
        stats[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes, "flops": flops,
            "ms_source": src if src == plain_src == lib_src else "mixed",
            "events_ms": ev, "plain_events_ms": plain_ev, "library_events_ms": lib_ev,
        }
        log(f"  {name}{f' dropout {rate}' if rate else ''}: {ms:.4f} ms, bound {bnd:.4f} ms "
            f"by {by}, plain {plain_ms:.4f} ms, sdpa {'fwd' if name == 'flash_fwd' else 'bwd'}"
            f" {lib_ms:.4f} ms ({src}); by CUDA events {ev:.4f} / {plain_ev:.4f} / "
            f"{lib_ev:.4f} ms")
    att.launches.update(saved[0])  # comparison and timing launches do not count
    att.dropout_launches.update(saved[1])
    return stats


#: kernel-name patterns that sort a train step's device time into kinds
KERNEL_KINDS = (
    ("flash attention (K1-K3)", ("flash_",)),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("casts and copies", ("copy_kernel",)),
)


def trace_steps(torch, step, steps: int, traced: int, kinds):
    """Time ``steps`` calls of ``step`` untraced, then trace ``traced`` more:
    wall ms per step of both, device busy ms per step and its share of the
    untraced wall, device ms per step by kind of kernel (the first kind in
    ``kinds`` whose pattern a kernel's name holds, else "other
    elementwise"), and every kernel's row sorted by device ms. None where
    the profiler yields nothing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                step()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / traced
        rows = kernel_rows(prof, traced)
    except Exception as err:  # the profiler is a measurement aid only
        log(f"[profile] not measured ({type(err).__name__}: {err})")
        return None
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    by_kind = {}
    for key, ms, _ in rows:
        kind = next((k for k, pats in kinds if any(p in key for p in pats)),
                    "other elementwise")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "device_ms_by_kind": by_kind, "rows": rows}


def log_breakdown(tag: str, what: str, st) -> None:
    log(f"[{tag}] {what}: wall {st['wall_ms']:.3f} ms untraced ({st['traced_wall_ms']:.3f} ms "
        f"traced); device busy {st['device_busy_ms']:.3f} ms = "
        f"{100 * st['busy_share']:.1f}% of the untraced wall. Device ms/step by kind:")
    for kind, ms in sorted(st["device_ms_by_kind"].items(), key=lambda kv: -kv[1]):
        log(f"  {ms:8.4f} ms  {kind}")
    log(f"[{tag}] top kernels by device ms/step:")
    for key, ms, n in st["rows"][:12]:
        log(f"  {ms:8.4f} ms  x{n:5.1f}  {key[:90]}")


def profile_train_step(torch, tfm, steps: int = 5):
    """Time ``steps`` full-width train steps untraced, then trace as many:
    device busy share of the untraced wall time, device time by kind of
    kernel, and the kernels that took the most device time."""
    model = tfm.make_model({"dropout": 0.0}).init_like_flax(
        torch.Generator().manual_seed(0)).cuda()
    opt = tfm.trial_setup({"lr": 1e-3, "warmup": 2}, model.parameters(), 100)
    step = tfm.make_train_step(model, opt)
    src, tgt = tfm.synthetic_seq2seq(32, 64, 1000, seed=0, device="cuda")
    for _ in range(3):
        step((src, tgt))
    st = trace_steps(torch, lambda: step((src, tgt)), steps, steps, KERNEL_KINDS)
    if st is None:
        return None
    rows = st.pop("rows")
    log_breakdown("profile", "train step", {**st, "rows": rows})
    flash = [[k[:90], ms, n] for k, ms, n in rows if "flash_" in k]
    log("[profile] flash-attention kernels by device ms/step:")
    for key, ms, n in flash:
        log(f"  {ms:8.4f} ms  x{n:5.1f}  {key}")
    return {**st, "flash": flash, "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}


# ---------------------------------------------------------------------------
# phase 6: TPE on the card


def tpe_case(np, n: int, seed: int):
    """Observation rows (d 4, the last column categorical with 3 choices),
    objectives with a NaN, 3 pending rows for the liar overlay, and the
    injected draws of 2 pools of 8 slots x 24 candidates."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, 4)).astype(np.float32)
    X[:, 3] = ((rng.integers(0, 3, n) + 0.5) / 3).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    y[1] = np.nan
    pend = [rng.random(4).astype(np.float32) for _ in range(3)]
    C = 8 * 24
    draws = [tuple(rng.random((C, 4)).astype(np.float32) if i in (0, 3)
                   else rng.standard_normal((C, 4)).astype(np.float32) for i in range(4))
             for _ in range(2)]
    return list(X), [float(v) for v in y], pend, draws


def tpe_on(torch, np, P, ObservationBuffer, case, dev):
    """(fit, winners, inputs) of ``tpe_suggest_fused`` on ``dev``: the
    buffer synced from the rows, the liar overlay, then the launch."""
    rows, vals, pend, pools = case
    buf = ObservationBuffer(4, dev)
    buf.sync(rows, vals)
    Xa, ya, n_eff = buf.overlay(pend, float(np.nanmean(vals)))
    nch = torch.tensor([1, 1, 1, 3], dtype=torch.int32, device=dev)
    cont = nch <= 1
    g_pad, b_pad = P.split_pads(n_eff, 0.25)
    kw = dict(kmax=3, equal_weight=False, n_good_pad=g_pad, n_bad_pad=b_pad)
    args = (Xa, ya, n_eff, 0, P.stream_seed(0, len(vals)), nch, cont, 0.25, 1.0, 25)
    fit = P._tpe_fit(Xa, ya, n_eff, nch, 0.25, 1.0, 25, **kw)
    injected = [tuple(torch.from_numpy(a).to(dev) for a in pool) for pool in pools]
    win = P.tpe_suggest_fused(*args, n_cand=24, n_out=8, n_pools=2, draws=injected, **kw)
    return fit, win, (args, kw)


def profile_calls(torch, fn, n: int = 10):
    """(host ms per call, device ms per call, CUDA kernels per call) of
    ``fn``: host time around ``n`` synchronized calls untraced, device
    time and kernel count from torch.profiler over ``n`` more."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof, n)
        dev_ms, kernels = sum(r[1] for r in rows), sum(r[2] for r in rows)
    except Exception as err:  # the profiler is a measurement aid only
        log(f"  (torch.profiler unavailable: {type(err).__name__}: {err})")
        dev_ms, kernels = None, None
    return host_ms, dev_ms, kernels


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def tpe_phase(torch, smi: str):
    import numpy as np
    import scipy.stats

    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.algo import ObservationBuffer, make_algorithm
    from metaopt_tpu_torch.ledger.trial import Trial
    from metaopt_tpu_torch.models import mlp
    from metaopt_tpu_torch.ops import tpe_math as P

    out = {"card": smi}
    # -- card against CPU on the same inputs and draws ---------------------
    agree = {}
    for n in (16, 4096):
        case = tpe_case(np, n, seed=n)
        fit_c, win_c, _ = tpe_on(torch, np, P, ObservationBuffer, case, "cuda")
        fit_h, win_h, _ = tpe_on(torch, np, P, ObservationBuffer, case, "cpu")
        errs = {}
        for name, a, b in zip(P.TPEFit._fields, fit_c, fit_h):
            a = a.cpu()
            if not torch.equal(torch.isinf(a), torch.isinf(b)):
                raise AssertionError(f"[tpe] n {n}: {name} -inf pattern differs")
            fin = torch.isfinite(b)
            errs[name] = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
            if not torch.allclose(a[fin], b[fin], rtol=TPE_TOL, atol=TPE_TOL):
                raise AssertionError(f"[tpe] n {n}: {name} off by {errs[name]:.3e}")
        same = torch.equal(win_c.cpu(), win_h)
        agree[n] = {"fit_max_abs_err": max(errs.values()), "winners_identical": same,
                    "winners_max_abs_diff": float((win_c.cpu() - win_h).abs().max())}
        log(f"[tpe] card vs cpu, n {n} (+3 pending): fit max |diff| "
            f"{max(errs.values()):.3e} (tol {TPE_TOL}); winners identical: {same}")
        if not same:
            raise AssertionError(f"[tpe] n {n}: the card's winners differ from the CPU's")
    out["card_vs_cpu"] = agree

    # the card's own draws against the CPU generator's, one fit, 512 winners
    case = tpe_case(np, 64, seed=5)
    _, _, (args, kw) = tpe_on(torch, np, P, ObservationBuffer, case, "cuda")
    wide = dict(kw, n_cand=24, n_out=512)
    card = P.tpe_suggest_fused(*args, **wide).cpu().numpy()
    _, _, (args_h, _) = tpe_on(torch, np, P, ObservationBuffer, case, "cpu")
    host = P.tpe_suggest_fused(*args_h, **wide).numpy()
    ks = [float(scipy.stats.ks_2samp(card[:, j], host[:, j]).pvalue) for j in range(4)]
    log(f"[tpe] card draws vs cpu draws, 512 winners: KS p-values {ks} (bound > 1e-3)")
    if min(ks) <= 1e-3:
        raise AssertionError("[tpe] the card's draws do not follow the CPU's mixture")
    out["ks_pvalues_card_vs_cpu_draws"] = ks

    # -- the config-2 hunt -------------------------------------------------
    exp = build_experiment("tpe-mlp", space=TPE_SPACE, max_trials=TPE_TRIALS,
                           algorithm={"tpe": {"seed": 0, "n_initial_points": TPE_INITIAL}})
    algo = make_algorithm(exp.space, exp.experiment.algorithm)
    launch = []
    ei_launch = algo._launch_ei

    def timed_launch(num):
        t0 = time.perf_counter()
        pts = ei_launch(num)
        launch.append(((time.perf_counter() - t0) * 1e3, len(algo._y)))
        return pts

    algo._launch_ei = timed_launch
    rep, reports = {}, []
    trial_fn = mlp.make_objective(report=rep)

    def objective(params):
        err = trial_fn(params)
        reports.append(dict(rep))
        return err

    t0 = time.perf_counter()
    stats = exp.workon(objective, algorithm=algo)
    algo.drain_suggest_ahead()
    torch.cuda.synchronize()
    hunt_s = time.perf_counter() - t0
    done = exp.fetch_trials("completed")
    tel = algo.telemetry()
    ei_suggests = tel["prefetch_hits"] + tel["prefetch_misses"]
    log(f"[tpe] hunt: {len(done)} completed in {hunt_s:.2f} s; telemetry {tel}; "
        f"producer {stats.producer_timings}")
    for t in done:
        log(f"  {t.params}: val error {t.objective:.4f}")
    if len(done) != TPE_TRIALS or not all(math.isfinite(t.objective) for t in done):
        raise AssertionError(f"[tpe] expected {TPE_TRIALS} finite trials, got "
                             f"{[(t.status, t.objective) for t in exp.fetch_trials()]}")
    if tel["kernel_launches"] < 1 or ei_suggests < TPE_TRIALS - TPE_INITIAL:
        raise AssertionError(f"[tpe] the EI path ran too little: {tel}")
    if not all(t.params in exp.space for t in done):
        raise AssertionError("[tpe] a trial's point lies outside the space")
    if algo._buf.Xdev is None or algo._buf.Xdev.device.type != "cuda":
        raise AssertionError("[tpe] the observation buffer is not on the card")
    step_ms = [r["train_s"] / r["steps"] * 1e3 for r in reports]
    trial_s = [r["trial_s"] for r in reports]
    launch_small = [ms for ms, _ in launch]
    log(f"[tpe] EI launches at n {sorted({n for _, n in launch})}: host ms "
        f"{[round(ms, 3) for ms in launch_small]}; MLP ms/step median "
        f"{median(step_ms):.3f} (first trial {step_ms[0]:.3f}); s/trial median "
        f"{median(trial_s):.3f} (first {trial_s[0]:.3f})")
    out["hunt"] = {
        "trials": len(done), "wall_s": hunt_s, "telemetry": tel,
        "ei_suggests": ei_suggests, "h2d_bytes_per_ei_suggest": tel["h2d_bytes"] / ei_suggests,
        "launch_host_ms": launch_small, "launch_n_obs": [n for _, n in launch],
        "mlp_ms_per_step": step_ms, "mlp_s_per_trial": trial_s,
        "mlp_ms_per_step_median": median(step_ms), "mlp_s_per_trial_median": median(trial_s),
        "producer_timings": stats.producer_timings,
        "best": min(t.objective for t in done),
    }

    # -- suggest-side times at n 16 and 4096 --------------------------------
    sizes = {}
    for n in (16, 4096):
        tpe = make_algorithm(exp.space, {"tpe": {"seed": 1, "n_initial_points": TPE_INITIAL}})
        pts = exp.space.sample(n, seed=n)
        vals = np.random.default_rng(n).random(n)
        trials = []
        for p, v in zip(pts, vals):
            t = Trial(params=p, experiment="timing", status="completed")
            t.attach_results([{"name": "o", "type": "objective", "value": float(v)}])
            trials.append(t)
        tpe._suggest_ahead_async = lambda: None       # launches only when timed
        tpe.observe(trials)
        t0 = time.perf_counter()
        tpe._launch_ei(8)                             # first launch: bulk upload
        first_ms = (time.perf_counter() - t0) * 1e3
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            tpe._launch_ei(8)
            host.append((time.perf_counter() - t0) * 1e3)
        # device syncs of one steady launch: torch flags each one it makes
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tpe._launch_ei(8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        buf = tpe._buf
        g_pad, b_pad = P.split_pads(n, tpe.gamma)
        kw = dict(n_cand=tpe.n_ei_candidates, n_out=8, kmax=tpe._kmax,
                  equal_weight=tpe.equal_weight, n_good_pad=g_pad, n_bad_pad=b_pad)
        args = (buf.Xdev, buf.ydev, n, 0, 0, tpe._n_choices_dev, tpe._cont_mask_dev,
                tpe.gamma, tpe.prior_weight, tpe.full_weight_num)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        P.tpe_suggest_fused(*args, **kw).cpu()
        peak = torch.cuda.max_memory_allocated() - base
        call_host, call_dev, call_kernels = profile_calls(
            torch, lambda: P.tpe_suggest_fused(*args, **kw).cpu())
        fit = P._tpe_fit(*args[:3], args[5], *args[7:], kmax=kw["kmax"],
                         equal_weight=kw["equal_weight"], n_good_pad=g_pad, n_bad_pad=b_pad)
        cand = P._sample_candidates(fit, P.pool_draws(0, 0, 8 * 24, 4, "cuda"), args[5],
                                    args[6], kw["kmax"])
        sc_host, sc_dev, sc_kernels = profile_calls(
            torch, lambda: P._score_candidates(fit, cand, args[5], args[6]))
        row = {
            "launch_host_ms_median": median(host), "launch_host_ms": host,
            "first_launch_host_ms": first_ms, "syncs_per_launch": syncs,
            "fused_host_ms": call_host, "fused_device_ms": call_dev,
            "fused_cuda_kernels": call_kernels, "fused_peak_bytes": peak,
            "scorer_device_ms": sc_dev, "scorer_cuda_kernels": sc_kernels,
            "scorer_share_of_launch": (sc_dev / median(host)) if sc_dev else None,
            "device_share_of_launch": (call_dev / median(host)) if call_dev else None,
            "n_good_pad": g_pad, "n_bad_pad": b_pad,
            "h2d_bytes_first_launch": buf.h2d_bytes,
        }
        sizes[n] = row
        log(f"[tpe] n {n}: _launch_ei host {median(host):.3f} ms median (first "
            f"{first_ms:.3f}), {syncs} device sync(s); tpe_suggest_fused host {call_host:.3f} ms, device "
            f"{call_dev} ms in {call_kernels} CUDA kernels, peak {peak} bytes; "
            f"scorer device {sc_dev} ms in {sc_kernels} kernels; card {smi}")
    out["sizes"] = sizes
    return out


# ---------------------------------------------------------------------------
# phase 7: GP-BO on the card


def gp_stages(torch, G, X, y, n: int, mu: float, sd: float, params, draws):
    """GP-BO's deterministic stages on ``X``'s device: the MLL and its
    gradient at ``params``, ``gp_fit_mll``'s 60 steps from the defaults, the
    full factor, a chain of row extensions from an anchor at n // 2, and EI's
    winners over the given candidate pools."""
    live = (torch.arange(X.shape[0], device=X.device) < n) & torch.isfinite(y)
    mask = live.to(torch.float32)
    ys = torch.where(live, (y - mu) / sd, 0.0)
    theta = G._pack(params).requires_grad_(True)
    mll = G._neg_mll(G._unpack(theta), X, ys, mask)
    (grad,) = torch.autograd.grad(mll, theta)
    fit, drift = G.gp_fit_mll(X, y, n, mu, sd, G._default_params(X.shape[1], X.device),
                              GP_FIT_LR, fit_iters=GP_YAML["fit_iters"])
    full = G.gp_chol_full(X, y, n, params)
    chain = G.gp_chol_full(X, y, n // 2, params)
    for i in range(n // 2, n):
        chain = G.gp_chol_append(chain, X, y, i, params)
    win = G.gp_acquire_fused(X, y, full, n, mu, sd, 0, 0, params, n_cand=GP_N_CAND, n_out=4,
                             n_pools=len(draws), draws=draws)
    return {"mll": mll.detach().reshape(1), "grad": grad, "fit": G._pack(fit),
            "drift": drift.reshape(1), "chol_full": full, "chol_chain": chain, "winners": win}


def gp_phase(torch, smi: str):
    import numpy as np

    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.algo import gp_bo as G
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.models import mlp

    out = {"card": smi}
    part_s, last = {}, [time.perf_counter()]

    def mark(part: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        part_s[part] = now - last[0]
        last[0] = now

    # -- (a) config 2's space and full MLP trial under GP-BO -------------------
    exp = build_experiment("gp-mlp", space=TPE_SPACE, max_trials=GP_TRIALS,
                           algorithm={"gp": dict(GP_YAML)})
    algo = make_algorithm(exp.space, exp.experiment.algorithm)
    launch = []
    ei_launch = algo._launch_ei

    def timed_launch(num):
        t0 = time.perf_counter()
        pts = ei_launch(num)
        launch.append(((time.perf_counter() - t0) * 1e3, len(algo._y)))
        return pts

    algo._launch_ei = timed_launch
    t0 = time.perf_counter()
    stats = exp.workon(mlp.make_objective(), algorithm=algo)
    algo.drain_suggest_ahead()
    torch.cuda.synchronize()
    hunt_s = time.perf_counter() - t0
    done = exp.fetch_trials("completed")
    tel = algo.telemetry()
    ei_suggests = tel["prefetch_hits"] + tel["prefetch_misses"]
    log(f"[gp] hunt: {len(done)} completed in {hunt_s:.2f} s; telemetry {tel}; "
        f"producer {stats.producer_timings}")
    for t in done:
        log(f"  {t.params}: val error {t.objective:.4f}")
    n_ei = GP_TRIALS - GP_YAML["n_initial_points"]
    problems = []
    if len(done) != GP_TRIALS or not all(math.isfinite(t.objective) for t in done):
        problems.append(f"{[(t.status, t.objective) for t in exp.fetch_trials()]}")
    if tel["kernel_launches"] < 1 or ei_suggests < n_ei:
        problems.append(f"the EI path ran too little: {tel}")
    if not all(t.params in exp.space for t in done):
        problems.append("a trial's point lies outside the space")
    on = {str(x.device) for x in (algo._buf.Xdev, algo._factor.L, *algo._params.values())}
    if on != {"cuda:0"}:
        problems.append(f"GP-BO's tensors lie on {on}")
    if problems:
        raise AssertionError(f"[gp] {problems}")
    out["hunt"] = {"trials": len(done), "wall_s": hunt_s, "telemetry": tel,
                   "ei_suggests": ei_suggests, "launch_host_ms": [ms for ms, _ in launch],
                   "launch_n_obs": [n for _, n in launch],
                   "producer_timings": stats.producer_timings,
                   "best": min(t.objective for t in done)}
    log(f"[gp] {len(done)} trials, {ei_suggests} suggested by EI in {tel['kernel_launches']} "
        f"launches on the card (host ms {[round(ms, 2) for ms, _ in launch]} at n "
        f"{[n for _, n in launch]}); factor: {algo._factor.telemetry()}; best val error "
        f"{out['hunt']['best']:.4f}")
    mark("hunt")

    # -- (b) the deterministic stages, card against CPU -----------------------
    n = len(algo._y)
    X, y = algo._buf.Xdev, algo._buf.ydev
    fin = [v for v in algo._y if math.isfinite(v)]
    mu, sd = float(np.mean(fin)), float(np.std(fin) + 1e-8)
    params = {k: v.clone() for k, v in algo._params.items()}
    rng = np.random.default_rng(0)
    d = X.shape[1]
    draws = [(rng.random((GP_N_CAND // 2, d)).astype(np.float32),
              rng.standard_normal((GP_N_CAND - GP_N_CAND // 2, d)).astype(np.float32))
             for _ in range(2)]

    def on_dev(dev):
        return gp_stages(torch, G, X.to(dev), y.to(dev), n, mu, sd,
                         {k: v.to(dev) for k, v in params.items()},
                         [tuple(torch.from_numpy(a).to(dev) for a in pool) for pool in draws])

    card = on_dev("cuda")
    host = on_dev("cpu")
    bounds = {"mll": GP_TOL["fwd"], "grad": GP_TOL["grad"], "fit": GP_TOL["fit"],
              "drift": GP_TOL["fit"], "chol_full": GP_TOL["fwd"], "chol_chain": GP_TOL["fwd"],
              "winners": 0.0}
    errs = {}
    for k, bound in bounds.items():
        a, b = card[k].cpu(), host[k]
        scale = max(1.0, float(b.abs().max())) if k in ("mll", "grad") else 1.0
        errs[k] = float((a - b).abs().max()) / scale
        if not (torch.isfinite(a).all() and errs[k] <= bound):
            raise AssertionError(f"[gp] {k}: card against CPU {errs[k]:.3e} > {bound:g}")
    chain_vs_full = float((card["chol_chain"] - card["chol_full"]).abs().max())
    if chain_vs_full > GP_TOL["fwd"]:
        raise AssertionError(f"[gp] a chain of gp_chol_append is {chain_vs_full:.3e} off the "
                             "full refactorization on the card")
    # the process-wide TF32 switches must not reach the gram or the solves
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = on_dev("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = {k: float((tf32[k] - card[k]).abs().max()) for k in card}
    same_tf32 = {k: bool(torch.equal(tf32[k], card[k])) for k in card}
    if max(tf32_err.values()) > GP_TOL["fwd"] or not torch.equal(tf32["winners"],
                                                               card["winners"]):
        raise AssertionError(f"[gp] TF32 on moves the stages: {tf32_err}")
    out["card_vs_cpu"] = {"max_abs_err": errs, "chain_vs_full_on_card": chain_vs_full,
                          "tf32_on_vs_off_max_abs": tf32_err, "tf32_bitwise_equal": same_tf32,
                          "n": n, "cap": int(X.shape[0])}
    log(f"[gp] card vs cpu on the hunt's buffer (n {n}, cap {X.shape[0]}): max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (mll and grad relative to their largest entry; bounds {GP_TOL}, winners "
        f"identical); chain of gp_chol_append vs full factor {chain_vs_full:.3e}; TF32 on vs "
        f"off: max {max(tf32_err.values()):.3e}, bitwise equal {same_tf32}")
    mark("card_vs_cpu")

    # -- (c) cost per EI launch, cold and incremental -------------------------
    trials = exp.fetch_trials("completed")
    timing = {}
    for label, extra in (("cold", {"incremental": False}), ("incremental", {})):
        gp = make_algorithm(exp.space, {"gp": {**GP_YAML, **extra}})
        gp._suggest_ahead_async = lambda: None         # launches only when timed
        gp.observe(trials[:-1])
        gp._launch_ei(4)                               # anchors the factor
        gp.observe(trials[-1:])
        calls = {}
        if label == "incremental":
            # one new row: the O(n²) extension, then the acquisition
            t0 = time.perf_counter()
            gp._launch_ei(4)
            calls["append_launch_host_ms"] = (time.perf_counter() - t0) * 1e3
        # a cold launch is ~10k kernels: one traced call (the profiler's
        # post-processing, not the launch, is what costs seconds)
        calls["launch"] = profile_calls(torch, lambda: gp._launch_ei(4),
                                        n=1 if label == "cold" else 10)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                gp._launch_ei(4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        host_ms, dev_ms, kernels = calls.pop("launch")
        timing[label] = {"host_ms": host_ms, "device_ms": dev_ms, "cuda_kernels": kernels,
                         "syncs_per_launch": syncs, **calls, "factor": gp._factor.telemetry()}
        log(f"[gp] {label} EI launch at n {len(gp._y)}: host {host_ms:.3f} ms, device "
            f"{dev_ms} ms in {kernels} CUDA kernels, {syncs} device sync(s)"
            + (f"; with one new row {calls['append_launch_host_ms']:.3f} ms"
               if "append_launch_host_ms" in calls else "") + f"; card {smi}")
    # the pieces of a re-anchor, on the host clock: the warm refit's 15
    # steps with its drift read, the full fit's 60
    Xg, yg = gp._buf.Xdev, gp._buf.ydev
    for label, iters in (("warm_refit", GP_REFIT_ITERS), ("full_fit", GP_YAML["fit_iters"])):
        t0 = time.perf_counter()
        for _ in range(3):
            float(G.gp_fit_mll(Xg, yg, n, mu, sd, gp._params, GP_FIT_LR, fit_iters=iters)[1])
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        timing[label] = {"host_ms": host_ms, "iters": iters}
        log(f"[gp] gp_fit_mll, {iters} Adam steps and the drift read: host {host_ms:.3f} ms")
    out["launch"] = timing
    mark("timing")
    out["part_s"] = part_s
    log("[gp] seconds per part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return out


# ---------------------------------------------------------------------------
# phase 8: the hunt CLI with subprocess trials


def run_cli(args, root: Path, env, trials: int = 0, workers: int = 1, trial_s: float = 0.0):
    """``python -m metaopt_tpu_torch ARGS`` in a fresh process: (parsed
    JSON stdout, wall s). Its deadline is ``HUNT_START_S`` plus
    ``trial_s`` for each of the ``trials`` a worker of ``workers`` runs. On
    the deadline the hunt gets SIGINT (it kills its trial's process group
    and marks the trial interrupted), then SIGKILL."""
    deadline_s = HUNT_START_S + trial_s * math.ceil(trials / workers)
    t0 = time.perf_counter()
    with open(root / "cli.out", "w+") as out, open(root / "cli.err", "w+") as err:
        proc = subprocess.Popen([sys.executable, "-m", "metaopt_tpu_torch", *args],
                                stdout=out, stderr=err, env=env, cwd=root)
        try:
            rc = proc.wait(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            rc = None
        wall = time.perf_counter() - t0
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    if rc != 0:
        raise AssertionError(f"[hunt] {' '.join(args[:3])} exited {rc} (deadline "
                             f"{deadline_s:.0f} s); stderr tail:\n"
                             f"{stderr[-3000:]}")
    return json.loads(stdout), wall


def statistics_of(t):
    return {r.name: r.value for r in t.results if r.type == "statistic"}


def hunt_phase(torch, smi: str):
    from metaopt_tpu_torch.ledger import FileLedger
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.utils.procs import cuda_backend_reachable

    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_hunt_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger = f"file:{root / 'ledger'}"
    out = {"card": smi}
    try:
        import yaml  # noqa: F401
        out["pyyaml"] = True
    except ImportError:
        out["pyyaml"] = False
    log(f"[hunt] PyYAML importable: {out['pyyaml']} (the configs below are JSON either way)")
    try:
        # -- (a) BASELINE config 1 -----------------------------------------
        cfg = root / "random.json"
        cfg.write_text(json.dumps({"algorithm": {"random": {"seed": 0}}}))
        summary, wall = run_cli(
            ["hunt", "-n", "rosen", "--ledger", ledger, "--max-trials", str(ROSEN_TRIALS),
             "--n-workers", str(ROSEN_WORKERS), "--config", str(cfg),
             str(examples / "rosenbrock.py")] + [f"-{k}~{v}" for k, v in ROSEN_SPACE.items()],
            root, env, ROSEN_TRIALS, ROSEN_WORKERS, ROSEN_TRIAL_S)
        status, status_wall = run_cli(["status", "-n", "rosen", "--ledger", ledger, "--json"],
                                      root, env)
        trials = FileLedger(str(root / "ledger")).fetch("rosen")
        done = [t for t in trials if t.status == "completed"]
        n_results = {t.id: sum(r.type == "objective" for r in t.results) for t in done}
        best = summary["best"]
        problems = []
        if len(done) < ROSEN_TRIALS:
            problems.append(f"{len(done)} completed")
        if summary["total"].get("broken", 0) or summary["broken_by_worker"]:
            problems.append(f"broken {summary['total'].get('broken', 0)}")
        if len({t.id for t in done}) != len(done) or set(n_results.values()) != {1} \
                or summary["completed_by_worker"] != len(done):
            problems.append(f"a trial ran twice ({summary['completed_by_worker']} pushes for "
                            f"{len(done)} completed, results per id {set(n_results.values())})")
        if best is None or not math.isfinite(best["objective"]):
            problems.append(f"best {best}")
        if status[0]["by_status"] != summary["total"] or status[0]["best"] != best:
            problems.append(f"status disagrees: {status[0]} vs {summary}")
        if problems:
            raise AssertionError(f"[hunt] config 1: {problems}")
        walls = [t.end_time - t.start_time for t in done]
        span = max(t.end_time for t in done) - min(t.start_time for t in done)
        out["config1"] = {
            "trials": len(done), "workers": ROSEN_WORKERS, "hunt_wall_s": wall,
            "trials_per_s": len(done) / wall, "ledger_span_s": span,
            "trials_per_s_in_span": len(done) / span, "median_trial_wall_s": median(walls),
            "status_wall_s": status_wall, "best": best["objective"],
            "producer_timings": summary["producer_timings"],
        }
        log(f"[hunt] config 1: {len(done)} completed, 0 broken, {ROSEN_WORKERS} workers in "
            f"{wall:.2f} s = {len(done) / wall:.2f} trials/s ({len(done) / span:.2f} over the "
            f"ledger's {span:.2f} s span); median trial wall {median(walls):.3f} s; best "
            f"{best['objective']:.6g}; status from a fresh process agrees ({status_wall:.2f} s)")

        # -- (b) BASELINE config 2 -----------------------------------------
        cfg = root / "tpe.json"   # examples/tpe.yaml's settings
        cfg.write_text(json.dumps({"algorithm": {"tpe": {"seed": 0,
                                                         "n_initial_points": TPE_INITIAL}}}))
        summary, wall = run_cli(
            ["hunt", "-n", "mlp", "--ledger", ledger, "--max-trials", str(HUNT_TPE_TRIALS),
             "--config", str(cfg), str(examples / "mlp_mnist.py")]
            + [f"--{k}~{v}" for k, v in TPE_SPACE.items()], root, env, HUNT_TPE_TRIALS, 1,
            MLP_TRIAL_S)
        trials = FileLedger(str(root / "ledger")).fetch("mlp")
        done = sorted((t for t in trials if t.status == "completed"), key=lambda t: t.start_time)
        space = build_space(TPE_SPACE)
        switch = sorted(t.end_time for t in done)[TPE_INITIAL - 1] if len(done) >= TPE_INITIAL \
            else math.inf
        by_ei = [t for t in trials if t.submit_time > switch]
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        problems = []
        if len(done) != HUNT_TPE_TRIALS or not all(math.isfinite(t.objective) for t in done):
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if len(by_ei) < HUNT_TPE_TRIALS - TPE_INITIAL:
            problems.append(f"{len(by_ei)} trials suggested by EI")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        if not all(st.get("device") == name for st in stats):
            problems.append(f"devices {sorted({st.get('device') for st in stats})}")
        if problems:
            raise AssertionError(f"[hunt] config 2: {problems}")
        rows = []
        for t, st in zip(done, stats):
            trial_s = t.end_time - t.start_time
            rows.append({"trial_s": trial_s, "first_cuda_op_s": st["first_device_op_s"],
                         "first_matmul_s": st["first_matmul_s"],
                         "train_s": st["train_s"], "train_ms_per_step": st["train_ms_per_step"],
                         "train_and_eval_s": st["train_and_eval_s"],
                         "rest_s": trial_s - st["first_device_op_s"] - st["train_s"],
                         # the rest, split: the first matrix product
                         # (cuBLAS loading); model, data and optimizer before
                         # the step loop (and the optimizer's construction
                         # alone); eval after it; then everything outside
                         # train_and_eval (spawn, report, exit, the poll)
                         "cublas_s": st["first_matmul_s"] - st["first_device_op_s"],
                         "setup_s": st["setup_s"],
                         "optimizer_init_s": st["optimizer_init_s"],
                         "eval_s": st["train_and_eval_s"] - st["setup_s"] - st["train_s"],
                         "outside_s": trial_s - st["first_matmul_s"]
                         - st["train_and_eval_s"],
                         "val_error": t.objective})
        med = {k: median([r[k] for r in rows]) for k in rows[0]}
        out["config2"] = {
            "trials": len(done), "ei_suggested": len(by_ei), "hunt_wall_s": wall,
            "s_per_trial": wall / len(done), "median": med, "first": rows[0],
            "per_trial": rows, "producer_timings": summary["producer_timings"],
            "best": summary["best"]["objective"], "device": name,
            "in_process_s_per_trial_pr4": [0.185, 0.434],
        }
        log(f"[hunt] config 2: {len(done)} finite trials, {len(by_ei)} suggested by EI, all on "
            f"{name}, in {wall:.2f} s ({wall / len(done):.3f} s/trial); per trial (median, first):"
            f" ledger wall {med['trial_s']:.3f} / {rows[0]['trial_s']:.3f} s = process start -> "
            f"first CUDA op {med['first_cuda_op_s']:.3f} / {rows[0]['first_cuda_op_s']:.3f} + "
            f"training {med['train_s']:.3f} / {rows[0]['train_s']:.3f} + rest "
            f"{med['rest_s']:.3f} / {rows[0]['rest_s']:.3f} (first matmul "
            f"{med['cublas_s']:.3f}, setup {med['setup_s']:.3f} of which the optimizer's "
            f"construction {med['optimizer_init_s']:.3f}, eval {med['eval_s']:.3f}, outside "
            f"the call {med['outside_s']:.3f}); "
            f"{med['train_ms_per_step']:.3f} ms/"
            f"step; best val error {summary['best']['objective']:.4f}; card {smi}")

        # -- (c) the breaker's probe ---------------------------------------
        t0 = time.perf_counter()
        ok = cuda_backend_reachable()
        out["cuda_probe"] = {"reachable": ok, "s": time.perf_counter() - t0}
        log(f"[hunt] cuda_backend_reachable() = {ok} in {out['cuda_probe']['s']:.3f} s")
        if not ok:
            raise AssertionError("[hunt] cuda_backend_reachable() is False on the card")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def log_ledger(path: Path) -> None:
    """Every trial of a failed phase's ledger: status, wall, statistics."""
    from metaopt_tpu_torch.ledger import FileLedger

    if not path.is_dir():
        return
    led = FileLedger(str(path))
    for name in led.list_experiments():
        for t in led.fetch(name):
            wall = (t.end_time - t.start_time) if t.end_time and t.start_time else None
            log(f"  {name} {t.id[:8]} {t.status} exit {t.exit_code} wall {wall} "
                f"objective {t.objective} {statistics_of(t)}")


# ---------------------------------------------------------------------------
# phase 9: BASELINE config 3, ASHA on ResNet-50 through the CLI


def resnet_train_flops(model, hw: int, batch: int) -> float:
    """Operations of one training step: 3x the forward's convolutions and
    dense head (forward, input gradient, weight gradient), 2 per MAC."""
    def conv(c, size):
        out = -(-size // c.stride[0])  # 'SAME': ceil(size / stride)
        return 2 * batch * out * out * c.out_channels * c.in_channels * c.kernel_size[0] ** 2, out

    flops, size = conv(model.stem, hw)
    for b in model.blocks:
        size_in = size
        for c in (b.conv1, b.conv2, getattr(b, "conv3", None)):
            if c is not None:
                f, size = conv(c, size)
                flops += f
        if b.proj is not None:
            flops += conv(b.proj, size_in)[0]
    return 3 * (flops + 2 * batch * model.head.in_features * model.head.out_features)


def randomize_norms(torch, rn, model, gen):
    """Seeded scales, biases and running statistics for every batch norm of
    the port's ResNet: a block's last scale from U(0.1, 0.3), every other
    from U(0.5, 1.5), biases and running means N(0, 0.1), running variances
    U(0.5, 2) (the distributions of tests/test_torch_resnet.py)."""
    with torch.no_grad():
        for norm in model.modules():
            if isinstance(norm, rn.BatchNorm):
                c = norm.weight.shape[0]
                lo, hi = (0.1, 0.3) if norm.zero_scale else (0.5, 1.5)
                norm.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=gen))
                norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
                norm.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                norm.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))


def asha_phase(torch, smi: str):
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.ledger import Experiment, FileLedger
    from metaopt_tpu_torch.models import resnet as rn
    from metaopt_tpu_torch.models.data import synthetic_images
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    # -- (a) the full-width model on the card ------------------------------
    # flax's init zeroes each block's last batch-norm scale, which would leave
    # every residual branch at 0: seeded random norms put all 16 blocks'
    # convolutions and norms into the logits compared
    model_cpu = rn.ResNet().init_like_flax(torch.Generator().manual_seed(4))
    randomize_norms(torch, rn, model_cpu, torch.Generator().manual_seed(5))
    model_gpu = rn.ResNet()
    model_gpu.load_state_dict(model_cpu.state_dict())
    model_gpu.to("cuda", memory_format=torch.channels_last)
    x, _ = synthetic_images(8, hw=32, channels=3, seed=9, device="cpu")
    state = {k: v.clone() for k, v in model_cpu.state_dict().items()}
    fwd, wants = {}, {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            got = model_gpu(x.to("cuda"), train=mode == "train").cpu()
            wants[mode] = want = model_cpu(x, train=mode == "train")
            excess = float(((got - want).abs() - (3e-2 + 3e-2 * want.abs())).max())
            fwd[mode] = {"max_abs_err": float((got - want).abs().max()), "excess": excess,
                         "finite": bool(torch.isfinite(got).all())}
        # the same weights with flax's zero last scales: the bodies' share
        model_cpu.load_state_dict(state)
        for norm in model_cpu.modules():
            if isinstance(norm, rn.BatchNorm) and norm.zero_scale:
                norm.weight.zero_()
        bodies = float((model_cpu(x) - wants["eval"]).abs().max())
    log(f"[asha] ResNet-50 logits on a batch of 8, card against CPU (bf16 convolutions on "
        f"both; random batch norms; bound 3e-2 + 3e-2|cpu|): eval max |diff| "
        f"{fwd['eval']['max_abs_err']:.3e}, train-mode {fwd['train']['max_abs_err']:.3e}; "
        f"the blocks' bodies move the eval logits by {bodies:.3e}")
    if not all(f["finite"] and f["excess"] <= 0 for f in fwd.values()):
        raise AssertionError(f"[asha] ResNet-50 on the card disagrees with the CPU: {fwd}")
    if bodies <= 3e-2 + 3e-2 * float(wants["eval"].abs().max()):
        raise AssertionError(f"[asha] the blocks' bodies do not reach the logits ({bodies})")
    fwd["bodies_move_eval_logits"] = bodies
    out["forward_vs_cpu"] = fwd
    del model_gpu, model_cpu

    rep = {}
    err = rn.train_and_eval({"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}, epochs=3,
                            device="cuda", report=rep)
    log(f"[asha] in-process train_and_eval, 3 epochs (lr 0.1, momentum 0.9, wd 1e-4): mean "
        f"loss per epoch {[round(v, 4) for v in rep['losses']]}, val error {err:.4f}; setup "
        f"{rep['setup_s']:.2f} s, training {rep['train_s']:.2f} s "
        f"({rep['train_s'] / rep['steps'] * 1e3:.2f} ms/step), eval {rep['eval_s']:.2f} s")
    if not (all(math.isfinite(v) for v in rep["losses"]) and rep["losses"][2] < rep["losses"][0]):
        raise AssertionError(f"[asha] the loss did not fall over 3 epochs: {rep['losses']}")
    out["in_process"] = {**rep, "val_error": err}

    model = rn.ResNet().to("cuda", memory_format=torch.channels_last)
    model.init_like_flax(torch.Generator(device="cuda").manual_seed(0))
    opt = rn.SGD(model.parameters(), 0.1, 0.9, 1e-4)
    xs, ys = synthetic_images(4096, hw=32, channels=3, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        rn.train_step(model, opt, xs, ys, gen, RESNET_BATCH)

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    st = trace_steps(torch, step, RESNET_TIMED_STEPS, RESNET_TRACED_STEPS, RESNET_KINDS)
    peak = torch.cuda.max_memory_allocated()
    flops = resnet_train_flops(model, 32, RESNET_BATCH)
    if st is None:
        raise AssertionError("[asha] the profiler traced no ResNet-50 step")
    rows = st.pop("rows")
    log_breakdown("asha", f"ResNet-50 train step (batch {RESNET_BATCH}, 32x32x3)",
                  {**st, "rows": rows})
    log(f"[asha] ResNet-50: {st['wall_ms']:.3f} ms/step untraced = "
        f"{RESNET_BATCH / st['wall_ms'] * 1e3:.0f} images/s; {flops / 1e12:.3f} TFLOP/step "
        f"(bound at the bf16 peak {flops / PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms); peak "
        f"memory {peak / 2**30:.3f} GiB; card {smi}")
    out["step"] = {**st, "images_per_s": RESNET_BATCH / st["wall_ms"] * 1e3,
                   "flops": flops, "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3,
                   "peak_mem_bytes": peak, "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}
    del model, opt, xs, ys
    torch.cuda.empty_cache()

    # -- (b) config 3 through the CLI ----------------------------------------
    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_asha_"))
    # TMPDIR: the hunt's GPU registry file is this phase's own
    env = dict(os.environ, TMPDIR=str(root))
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger = f"file:{root / 'ledger'}"
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "resnet", "--n-chips", "1", "--max-trials", str(ASHA_TRIALS),
             "--pool-size", "1", "--timeout-s", str(RESNET_TIMEOUT_S), "--ledger", ledger,
             "--config", str(examples / "asha.json"), str(examples / "resnet_cifar.py"),
             "--n-train", str(ASHA_N_TRAIN)]
            + [f"--{k}~{v}" for k, v in {**RESNET_SPACE, "epochs": ASHA_FIDELITY}.items()],
            root, env, ASHA_TRIALS, 1, RESNET_TRIAL_S)
        status, status_wall = run_cli(["status", "-n", "resnet", "--rungs", "--json",
                                       "--ledger", ledger], root, env)
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("resnet", led).configure()
        replay = make_algorithm(exp.space, exp.algorithm)
        replay.observe(exp.fetch_completed_trials())
        trials = sorted(led.fetch("resnet"), key=lambda t: t.start_time or 0)
        done = [t for t in trials if t.status == "completed"]
        space = build_space({**RESNET_SPACE, "epochs": ASHA_FIDELITY})
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        registry = json.loads((root / "metaopt_tpu_torch-gpus-1.json").read_text())
        budgets = {t.params["epochs"] for t in done}
        lineages = {(t.lineage, t.params["epochs"]) for t in done}
        problems = []
        if len(done) != ASHA_TRIALS or summary["total"] != {"completed": ASHA_TRIALS}:
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if budgets != set(ASHA_BUDGETS):
            problems.append(f"budgets reached {sorted(budgets)}")
        if not all(t.lineage == space.hash_point(t.params) and (
                t.params["epochs"] == 1 or (t.lineage, t.params["epochs"] // 3) in lineages)
                for t in done):
            problems.append("a promotion without its parent's lineage")
        if not all(st.get("device") == name for st in stats):
            problems.append(f"devices {sorted({str(st.get('device')) for st in stats})}")
        if registry != {"claims": {}}:
            problems.append(f"the GPU registry still holds {registry}")
        if status[0].get("rungs") != replay.rung_table:
            problems.append(f"status --rungs {status[0].get('rungs')} != {replay.rung_table}")
        if problems:
            raise AssertionError(f"[asha] config 3: {problems}")

        # -- (c) trials/hour and the per-trial split ------------------------
        rows = []
        for t, st in zip(done, stats):
            trial_s = t.end_time - t.start_time
            parts = {k: st[k] for k in ("first_device_op_s", "setup_s", "train_s", "eval_s")}
            rows.append({"epochs": t.params["epochs"], "trial_s": trial_s, **parts,
                         "rest_s": trial_s - sum(parts.values()),
                         "train_ms_per_step": st["train_ms_per_step"],
                         "epoch_losses": st["epoch_losses"], "val_error": t.objective})
        keys = ("trial_s", "first_device_op_s", "setup_s", "train_s", "eval_s", "rest_s")
        total = {k: sum(r[k] for r in rows) for k in keys}
        by_budget = {b: {k: median([r[k] for r in rows if r["epochs"] == b])
                         for k in keys + ("train_ms_per_step",)} | {
                         "trials": sum(r["epochs"] == b for r in rows)} for b in ASHA_BUDGETS}
        out["config3"] = {
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "status_wall_s": status_wall, "rungs": status[0]["rungs"], "sum": total,
            "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[asha] config 3: {len(done)} trials completed on {name} ({by_budget[1]['trials']} "
            f"at 1 epoch, {by_budget[3]['trials']} at 3, {by_budget[9]['trials']} at 9), "
            f"none broken, promotions on their parents' lineage, registry empty, status "
            f"--rungs from a fresh process equal to the replay ({status_wall:.2f} s); "
            f"{wall:.2f} s = {len(done) / wall * 3600:.1f} trials/hour; best val error "
            f"{summary['best']['objective']:.4f}")
        log(f"[asha] config 3, summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for b, m in by_budget.items():
            log(f"[asha]   budget {b:2d} (median of {m['trials']}): trial {m['trial_s']:.2f} s ="
                f" start -> first CUDA op {m['first_device_op_s']:.2f} + setup "
                f"{m['setup_s']:.2f} + training {m['train_s']:.2f} "
                f"({m['train_ms_per_step']:.2f} ms/step) + eval {m['eval_s']:.2f} + rest "
                f"{m['rest_s']:.2f}; card {smi}")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: BASELINE config 5, EvolutionES on PPO; Hyperband and BOHB


def ppo_card_vs_cpu(torch, ppo):
    """Two full-width iterations on the card and on the CPU from the same
    initial parameters and the same draws (made on the CPU): the largest
    |card - cpu| of every parameter and of the advantages, each over the
    tensor's largest |cpu| entry, and the return's relative difference."""
    draws = ppo.Draws(7, "cpu")
    reset = draws.reset(64)
    rollouts = [draws.rollout(128, 64) for _ in range(2)]
    params = ppo.ActorCritic(64).init_like_flax(torch.Generator().manual_seed(3)).state_dict()
    runs = {}
    for dev in ("cpu", "cuda"):
        rep = {}
        ret = ppo.train({"lr": 3e-4}, iterations=2, device=dev, params=params,
                        draws=ppo.GivenDraws(reset, rollouts, dev), report=rep)
        runs[dev] = (ret, {k: v.detach().cpu() for k, v in
                           rep["state"].model.state_dict().items()},
                     rep["advantages"].cpu())
    (ret_c, sd_c, adv_c), (ret_g, sd_g, adv_g) = runs["cpu"], runs["cuda"]
    rel = {k: float((sd_g[k] - sd_c[k]).abs().max() / sd_c[k].abs().max()) for k in sd_c}
    rel["advantages"] = float((adv_g - adv_c).abs().max() / adv_c.abs().max())
    rel["return"] = abs(ret_g - ret_c) / abs(ret_c)
    return {"return_cpu": ret_c, "return_card": ret_g, "rel": rel,
            "finite": all(bool(torch.isfinite(v).all()) for v in sd_g.values())}


def evolution_phase(torch, smi: str):
    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.ledger import Experiment, FileLedger
    from metaopt_tpu_torch.models import ppo
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    # -- (a) PPO on the card against the CPU --------------------------------
    cmp = ppo_card_vs_cpu(torch, ppo)
    worst = max(cmp["rel"], key=cmp["rel"].get)
    log(f"[evolution] PPO at full width (64 envs, 128 steps, hidden 64, 4 updates), 2 "
        f"iterations from the same parameters and draws: return card {cmp['return_card']:.6f}, "
        f"cpu {cmp['return_cpu']:.6f}; largest |card - cpu| / max|cpu| {cmp['rel'][worst]:.3e} "
        f"({worst}; advantages {cmp['rel']['advantages']:.3e}, return "
        f"{cmp['rel']['return']:.3e}; bound {PPO_TOL:g})")
    if not (cmp["finite"] and all(v <= PPO_TOL for v in cmp["rel"].values())):
        raise AssertionError(f"[evolution] PPO on the card disagrees with the CPU: {cmp}")
    out["card_vs_cpu"] = cmp

    # -- (b) full-fidelity trials in-process ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    trials = {}
    for seed in (0,):  # seed 1 cut to fit the [lm] phase
        early = ppo.train({"lr": 3e-4}, iterations=2, seed=seed, device="cuda")
        rep = {}
        late = ppo.train({"lr": 3e-4}, iterations=PPO_ITERS, seed=seed, device="cuda",
                         report=rep)
        trials[seed] = {"neg_return_2": early, f"neg_return_{PPO_ITERS}": late,
                        "ms_per_iteration": rep["ms_per_iteration"], "setup_s": rep["setup_s"]}
        log(f"[evolution] seed {seed}: negated return {early:.3f} after 2 iterations, {late:.4f} "
            f"after {PPO_ITERS} ({rep['ms_per_iteration']:.2f} ms/iteration, host clock, "
            f"synchronized; setup {rep['setup_s']:.3f} s)")
        if not (early > 50 and late < 5):
            raise AssertionError(f"[evolution] PPO did not learn (seed {seed}): {early}, {late}")
    peak = torch.cuda.max_memory_allocated()
    st = ppo.setup({"lr": 3e-4}, device="cuda")
    for _ in range(2):
        ppo.iteration(st)
    prof = trace_steps(torch, lambda: ppo.iteration(st), 5, 2, PPO_KINDS)
    if prof is not None:
        rows = prof.pop("rows")
        prof["kernels_per_iteration"] = sum(r[2] for r in rows)
        log_breakdown("evolution", "PPO iteration", {**prof, "rows": rows})
        log(f"[evolution] {prof['kernels_per_iteration']:.0f} CUDA kernels per iteration; "
            f"peak memory {peak / 2**20:.1f} MiB; card {smi}")
        prof["top"] = [[k[:90], ms, n] for k, ms, n in rows[:12]]
    out["in_process"] = {"trials": trials, "profile": prof, "peak_mem_bytes": peak}

    # -- (c) config 5 through the CLI ----------------------------------------
    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_evolution_"))
    # TMPDIR: the hunt's GPU registry file is this phase's own
    env = dict(os.environ, TMPDIR=str(root))
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger = f"file:{root / 'ledger'}"
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "ppo", "--n-chips", "1", "--max-trials", str(EVOLUTION_TRIALS),
             "--timeout-s", str(PPO_TIMEOUT_S), "--ledger", ledger,
             "--config", str(examples / "evolution.json"), str(examples / "ppo_atari.py")]
            + [f"--{k}~{v}" for k, v in PPO_SPACE.items()],
            root, env, EVOLUTION_TRIALS, 1, PPO_TRIAL_S)
        status, status_wall = run_cli(["status", "-n", "ppo", "--json", "--ledger", ledger],
                                      root, env)
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("ppo", led).configure()
        done = sorted((t for t in led.fetch("ppo") if t.status == "completed"),
                      key=lambda t: t.start_time)
        # the port's EvolutionES on the CPU, fed the ledger's objectives
        replay = make_algorithm(exp.space, exp.algorithm)
        issued = replay.suggest(POPULATION)
        replay.observe([t for t in done if t.params["epochs"] == 2])
        issued += replay.suggest(POPULATION)
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        registry = json.loads((root / "metaopt_tpu_torch-gpus-1.json").read_text())
        space = build_space(PPO_SPACE)
        problems = []
        if len(done) != EVOLUTION_TRIALS or summary["total"] != {"completed": EVOLUTION_TRIALS}:
            problems.append(f"{[(t.status, t.objective) for t in led.fetch('ppo')]}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        key = (lambda p: json.dumps(p, sort_keys=True))  # noqa: E731
        if sorted(key(t.params) for t in done) != sorted(key(p) for p in issued):
            problems.append("the ledger's points differ from EvolutionES replayed on the CPU")
        if sorted(t.params["epochs"] for t in done) != [2] * POPULATION + [4] * POPULATION:
            problems.append(f"budgets {sorted(t.params['epochs'] for t in done)}")
        if not all(st.get("device") == name for st in stats):
            problems.append(f"devices {sorted({str(st.get('device')) for st in stats})}")
        if registry != {"claims": {}}:
            problems.append(f"the GPU registry still holds {registry}")
        if status[0]["by_status"] != summary["total"] or status[0]["best"] != summary["best"]:
            problems.append(f"status disagrees: {status[0]} vs {summary}")
        if problems:
            raise AssertionError(f"[evolution] config 5: {problems}")
        rows = []
        for t, st in zip(done, stats):
            trial_s = t.end_time - t.start_time
            parts = {k: st[k] for k in ("first_device_op_s", "setup_s", "train_s")}
            rows.append({"epochs": t.params["epochs"], "trial_s": trial_s, **parts,
                         "rest_s": trial_s - sum(parts.values()),
                         "ms_per_iteration": st["ms_per_iteration"],
                         "neg_return": t.objective})
        keys = ("trial_s", "first_device_op_s", "setup_s", "train_s", "rest_s")
        total = {k: sum(r[k] for r in rows) for k in keys}
        by_budget = {b: {k: median([r[k] for r in rows if r["epochs"] == b])
                         for k in keys + ("ms_per_iteration",)} for b in (2, 4)}
        out["config5"] = {
            "trials": len(done), "hunt_wall_s": wall,
            "trials_per_hour": len(done) / wall * 3600, "status_wall_s": status_wall,
            "sum": total, "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[evolution] config 5: {len(done)} trials completed on {name} (10 at 2 "
            f"iterations, 10 at 4), finite, equal to EvolutionES (seed 0) replayed on the CPU "
            f"over the ledger's objectives, registry empty, status --json from a fresh process "
            f"agreeing ({status_wall:.2f} s); {wall:.2f} s = {len(done) / wall * 3600:.1f} "
            f"trials/hour; best negated return {summary['best']['objective']:.4f}")
        log(f"[evolution] config 5, summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for b, m in by_budget.items():
            log(f"[evolution]   {b} iterations (median of {POPULATION}): trial "
                f"{m['trial_s']:.2f} s = start -> first CUDA op {m['first_device_op_s']:.2f} + "
                f"setup {m['setup_s']:.2f} + training {m['train_s']:.2f} "
                f"({m['ms_per_iteration']:.2f} ms/iteration) + rest {m['rest_s']:.2f}; card {smi}")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- (d) Hyperband and BOHB in-process -----------------------------------
    for tag, algo_cfg, want_trials in (
            ("hyperband", {"hyperband": {"seed": 0, "repetitions": 1}}, HB_TRIALS),
            ("bohb", {"bohb": {"seed": 0, "repetitions": BOHB_REPETITIONS}},
             HB_TRIALS * BOHB_REPETITIONS)):
        client = build_experiment(tag, space=HB_SPACE, algorithm=algo_cfg, max_trials=200,
                                  ledger="memory")
        algo = make_algorithm(client.space, algo_cfg)
        t0 = time.perf_counter()
        client.workon(ppo.make_objective(device="cuda"), algorithm=algo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = client.fetch_trials("completed")
        table = [(r["bracket"], r["budget"], r["capacity"]) for r in algo.rung_table]
        full = all(r["assigned"] == r["capacity"] == r["completed"] for r in algo.rung_table)
        row = {"trials": len(done), "wall_s": wall, "rungs": algo.rung_table,
               "best": min(t.objective for t in done) if done else None}
        problems = []
        if len(done) != want_trials or not algo.is_done:
            problems.append(f"{len(done)} trials completed, is_done {algo.is_done}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if table != HB_TABLE or not full:
            problems.append(f"rung table {algo.rung_table}")
        if tag == "bohb":
            models = algo._models.values()
            row["ei_launches"] = sum(m._launches for m in models)
            row["ei_suggested"] = sum(m.suggest_ahead_telemetry()["prefetch_hits"]
                                      + m.suggest_ahead_telemetry()["prefetch_misses"]
                                      for m in models)
            row["buffers"] = sorted({str(m._buf.Xdev.device) for m in models
                                     if m._buf.Xdev is not None})
            if row["ei_launches"] < 1 or row["ei_suggested"] < 1 or row["buffers"] != ["cuda:0"]:
                problems.append(f"EI on the card: {row}")
        if problems:
            raise AssertionError(f"[evolution] {tag}: {problems}")
        out[tag] = row
        extra = (f"; {row['ei_suggested']} suggested by EI in {row['ei_launches']} launches "
                 f"on {row['buffers'][0]}") if tag == "bohb" else ""
        log(f"[evolution] {tag} in-process: {len(done)} PPO trials in {wall:.2f} s, every rung "
            f"of {table} filled and completed; best negated return {row['best']:.4f}{extra}")
    return out


# ---------------------------------------------------------------------------
# phase 11: BASELINE config 4, Hyperband and BOHB on Transformer-base


def kept_fraction(torch, att, dtype, rate: float):
    """The kernel's kept fraction read from O: with q = 0 every score is 0,
    so with v = 1 each row of O is (kept entries) · scale / Sk, and the
    count is O · Sk · keep_prob rounded (bf16's rounding moves it by at most
    64 · 2⁻⁹). Returns (kernel's fraction, whether every row's count equals
    the plain version's, entries drawn)."""
    b, s, h, d = 32, 64, 8, 64
    q = torch.zeros(b, s, h, d, device="cuda", dtype=dtype)
    ones = torch.ones(b, s, h, d, device="cuda", dtype=dtype)
    drop = dict(dropout_rate=rate, seed=DROPOUT_SEED + 1, offset=DROPOUT_OFFSET)
    kp = att.keep_prob(rate)
    outs = (att.flash_fwd(q, ones, ones, None, **drop)[0],
            att.flash_fwd_plain(q, ones, ones, None, **drop)[0])
    counts = [torch.round(o[..., 0].float() * s * kp) for o in outs]
    return float(counts[0].sum()) / (b * h * s * s), bool(torch.equal(*counts)), b * h * s * s


def dropout_kernels_traced(torch, att, case, rate: float):
    """Names of the dropout instantiations (``<64, true>``) that traced calls
    of each wrapper ran. The profiler can drop a short window's records, so
    up to three windows of ten calls of each wrapper are traced."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, g, m = case["q"], case["k"], case["v"], case["g"], case["mask"]
    drop = dict(dropout_rate=rate, seed=DROPOUT_SEED, offset=DROPOUT_OFFSET)
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                out, lse = att.flash_fwd(q, k, v, m, **drop)
                delta = att.attention_delta(g, out)
                att.flash_bwd_dkv(q, k, v, g, lse, delta, m, **drop)
                att.flash_bwd_dq(q, k, v, g, lse, delta, m, **drop)
            torch.cuda.synchronize()
        names |= {key for key, _, _ in kernel_rows(prof, 1) if ", true>" in key}
        if len(names) >= 3:
            break
    return sorted(names)


def wmt_model_card_vs_cpu(torch, tfm):
    """Full-width Transformer-base in train mode at dropout 0.1 on one (2, 64)
    batch, card against CPU: the same weights, the same attention Philox
    seeds (CPU generators seeded alike) and the same feed-forward masks,
    injected through ``GivenDraws``. Returns the losses and every
    parameter's gradient norm on both."""
    import numpy as np

    model_cpu = tfm.make_model({"dropout": 0.1}).init_like_flax(
        torch.Generator().manual_seed(3))
    model_gpu = tfm.make_model({"dropout": 0.1})
    model_gpu.load_state_dict(model_cpu.state_dict())
    model_gpu.cuda()
    src, tgt = tfm.synthetic_seq2seq(2, 64, 1000, seed=5, device="cpu")
    rng = np.random.default_rng(6)
    masks = [rng.random((2, 64, 2048)) < 0.9 for _ in range(12)]  # 6 encoder + 6 decoder FFNs
    res = {}
    for dev, model in (("cpu", model_cpu), ("cuda", model_gpu)):
        loss = tfm.loss_fn(model, (src.to(dev), tgt.to(dev)),
                           tfm.GivenDraws(masks, attention_seed=8, device=dev))
        loss.backward()
        res[dev] = (float(loss), {n: float(p.grad.float().norm())
                                  for n, p in model.named_parameters()})
    torch.cuda.synchronize()
    return res


def wmt_phase(torch, smi: str):
    """BASELINE config 4. The kernels' dropout times against rate 0 are taken
    in phase 2, where the profiler's device times are known to hold."""
    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.ledger import Experiment, FileLedger
    from metaopt_tpu_torch.models import transformer as tfm
    from metaopt_tpu_torch.models.checkpoint import has_state
    from metaopt_tpu_torch.ops import attention as att
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    part_s, last = {}, [time.perf_counter()]

    def mark(part: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        part_s[part] = now - last[0]
        last[0] = now

    saved = dict(att.launches), dict(att.dropout_launches)
    # -- (a) the kernels' dropout against their plain versions ---------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    cases = [
        make_case(torch, "slice-pad bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "pad", gen),
        make_case(torch, "slice-causal bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "causal", gen),
        make_case(torch, "slice-cross bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "cross", gen),
        make_case(torch, "ragged f32 (4,333,8,64)", 4, 333, 333, 8, 64, torch.float32,
                  "causal+empty", gen),
        make_case(torch, "ragged bf16 (4,333,8,64)", 4, 333, 333, 8, 64, bf16,
                  "causal+empty", gen),
        make_case(torch, "long-causal bf16 (8,512,8,64)", 8, 512, 512, 8, 64, bf16, "causal",
                  gen),
    ]
    log("[wmt] max |kernel - plain| per case with attention dropout (the same Philox seed "
        "and offset):")
    max_err = {n: 0.0 for n in att.launches}
    for rate in WMT_RATES:
        for case in cases:
            for n, e in check_case(torch, att, case, rate)[0].items():
                max_err[n] = max(max_err[n], e)
    out["max_abs_err"] = max_err
    out["autograd_max_abs_err"] = check_autograd(torch, att, cases[1], WMT_TIMED_RATE)
    att.launches.update(saved[0])  # comparison launches do not count
    att.dropout_launches.update(saved[1])
    kept = {}
    for dtype in (torch.float32, bf16):
        for rate in WMT_RATES:
            frac, same, n = kept_fraction(torch, att, dtype, rate)
            sigma = math.sqrt(rate * (1 - rate) / n)
            kept[f"{dtype} {rate}"] = {"kernel": frac, "rows_equal_plain": same, "n": n,
                                       "sigma": sigma}
            log(f"[wmt] kept fraction, {str(dtype).split('.')[-1]}, rate {rate}: kernel "
                f"{frac:.6f}, want {1 - rate} within 4 sigma = {4 * sigma:.2e} ({n} entries); "
                f"every row's count equal to the plain version's: {same}")
            if abs(frac - (1 - rate)) > 4 * sigma or not same:
                raise AssertionError(f"[wmt] kept fraction {frac} (rows equal to plain: "
                                     f"{same}) at rate {rate}, {dtype}")
    out["kept_fraction"] = kept
    traced = dropout_kernels_traced(torch, att, cases[0], WMT_TIMED_RATE)
    log(f"[wmt] a traced dropout call of each wrapper ran {traced}")
    for name in ("flash_fwd_kernel_mma<64, true>", "flash_bwd_dkv_kernel_mma<64, true>",
                 "flash_bwd_dq_kernel_mma<64, true>"):
        if not any(name in key for key in traced):
            raise AssertionError(f"[wmt] the trace holds no {name}")

    mark("kernel_checks")

    # -- (c) the model, card against CPU -------------------------------------
    res = wmt_model_card_vs_cpu(torch, tfm)
    (loss_c, norms_c), (loss_g, norms_g) = res["cpu"], res["cuda"]
    att.launches.update(saved[0])
    att.dropout_launches.update(saved[1])
    biggest = max(norms_c.values())
    # the attention key biases' gradients are 0 in exact arithmetic (softmax
    # is shift-invariant per row): compared only against the largest norm
    rel = {n: abs(norms_g[n] - norms_c[n]) / max(norms_c[n], 1e-3 * biggest) for n in norms_c}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    log(f"[wmt] Transformer-base, train mode at dropout 0.1, (2, 64) batch, card against CPU "
        f"on the same weights, attention seeds and FFN masks: loss {loss_g:.6f} / "
        f"{loss_c:.6f} (rel {loss_rel:.2e}); gradient norms: worst rel diff {rel[worst]:.2e} "
        f"({worst}); bound 3e-2")
    if not (math.isfinite(loss_g) and loss_rel <= 3e-2 and rel[worst] <= 3e-2):
        raise AssertionError(f"[wmt] the model at dropout 0.1 disagrees: {loss_g} {loss_c} "
                             f"{worst} {rel[worst]}")
    out["model_vs_cpu"] = {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel": loss_rel,
                           "worst_grad_norm_rel": rel[worst], "worst_param": worst}
    mark("model_vs_cpu")

    # -- (d) the train step at dropout 0.1 -----------------------------------
    model = tfm.make_model({"dropout": 0.1}).init_like_flax(
        torch.Generator().manual_seed(0)).cuda()
    opt = tfm.trial_setup({"lr": 1e-3, "warmup": 2, "dropout": 0.1}, model.parameters(), 100)
    step_fn = tfm.make_train_step(model, opt)
    src, tgt = tfm.synthetic_seq2seq(32, 64, 1000, seed=0, device="cuda")
    counter = iter(range(10 ** 6))

    def step():
        step_fn((src, tgt), tfm.Draws(0, next(counter), "cuda"))

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    st = trace_steps(torch, step, STEPS, 5, KERNEL_KINDS)
    peak = torch.cuda.max_memory_allocated()
    if st is None:
        raise AssertionError("[wmt] the profiler traced no train step")
    rows = st.pop("rows")
    log_breakdown("wmt", "Transformer-base train step at dropout 0.1 (B 32, S 64)",
                  {**st, "rows": rows})
    log(f"[wmt] train step at dropout 0.1: {st['wall_ms']:.3f} ms untraced, busy "
        f"{100 * st['busy_share']:.1f}%, peak memory {peak / 2**30:.3f} GiB; card {smi}")
    out["step"] = {**st, "peak_mem_bytes": peak,
                   "flash": [[k[:90], ms, n] for k, ms, n in rows if "flash_" in k],
                   "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}
    del model, opt, step_fn
    torch.cuda.empty_cache()
    att.launches.update(saved[0])
    att.dropout_launches.update(saved[1])
    mark("train_step")

    # -- (e) BOHB in-process over config 4's objective ----------------------
    algo_cfg = {"bohb": {"seed": 0, "repetitions": WMT_BOHB_REPETITIONS}}
    client = build_experiment("wmt-bohb", space={**WMT_PRIORS, "epochs": WMT_BOHB_FIDELITY},
                              algorithm=algo_cfg, max_trials=200, ledger="memory")
    algo = make_algorithm(client.space, algo_cfg)
    att.reset_launch_counts()
    t0 = time.perf_counter()
    client.workon(tfm.make_objective(steps_per_epoch=WMT_BOHB_STEPS_PER_EPOCH, device="cuda"),
                  algorithm=algo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, drop_counts = dict(att.launches), dict(att.dropout_launches)
    done = client.fetch_trials("completed")
    steps = sum(int(t.params["epochs"]) * WMT_BOHB_STEPS_PER_EPOCH for t in done)
    table = [(r["bracket"], r["budget"], r["capacity"]) for r in algo.rung_table]
    models = algo._models.values()
    row = {"trials": len(done), "wall_s": wall, "steps": steps, "rungs": algo.rung_table,
           "best": min(t.objective for t in done) if done else None,
           "launches": counts, "dropout_launches": drop_counts,
           "ei_launches": sum(m._launches for m in models),
           "ei_suggested": sum(m.suggest_ahead_telemetry()["prefetch_hits"]
                               + m.suggest_ahead_telemetry()["prefetch_misses"]
                               for m in models),
           "buffers": sorted({str(m._buf.Xdev.device) for m in models
                              if m._buf.Xdev is not None})}
    problems = []
    if len(done) != WMT_BOHB_REPETITIONS * sum(c for _, _, c in WMT_BOHB_TABLE) \
            or not algo.is_done:
        problems.append(f"{len(done)} trials completed, is_done {algo.is_done}")
    if not all(math.isfinite(t.objective) for t in done):
        problems.append("a non-finite objective")
    if table != WMT_BOHB_TABLE or not all(
            r["assigned"] == r["capacity"] == r["completed"] for r in algo.rung_table):
        problems.append(f"rung table {algo.rung_table}")
    if row["ei_launches"] < 1 or row["ei_suggested"] < 1 or row["buffers"] != ["cuda:0"]:
        problems.append(f"EI on the card: {row}")
    want = ATTN_PER_STEP * steps
    if any(c != want for c in list(counts.values()) + list(drop_counts.values())):
        problems.append(f"launches {counts}, with dropout {drop_counts}, want {want} each")
    if problems:
        raise AssertionError(f"[wmt] BOHB: {problems}")
    out["bohb"] = row
    log(f"[wmt] BOHB in-process (seed 0, {WMT_BOHB_REPETITIONS} repetition(s), "
        f"{WMT_BOHB_FIDELITY}, "
        f"{WMT_BOHB_STEPS_PER_EPOCH} steps per epoch): {len(done)} full-width trials, {steps} "
        f"train steps in {wall:.2f} s, every rung of {table} filled and completed; "
        f"{row['ei_suggested']} suggested by EI in {row['ei_launches']} launches on "
        f"{row['buffers'][0]}; launches {counts} = {ATTN_PER_STEP} per forward (K1) and per "
        f"train step (K2, K3), all with dropout; best loss {row['best']:.4f}")
    mark("bohb")

    # -- (f) config 4 through the CLI ----------------------------------------
    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_wmt_"))
    # TMPDIR: the hunt's GPU registry file is this phase's own
    env = dict(os.environ, TMPDIR=str(root))
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger, ckpt = f"file:{root / 'ledger'}", root / "ckpt"
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "wmt", "--n-chips", "1", "--timeout-s", str(WMT_TIMEOUT_S),
             "--ledger", ledger, "--ckpt-root", str(ckpt),
             "--config", str(examples / "hyperband.json"), str(examples / "transformer_wmt.py"),
             "--tp", "1", "--steps-per-epoch", str(WMT_STEPS_PER_EPOCH)]
            + [f"--{k}~{v}" for k, v in {**WMT_PRIORS, "epochs": WMT_CLI_FIDELITY}.items()],
            root, env, WMT_CLI_TRIALS, 1, WMT_TRIAL_S)
        status, status_wall = run_cli(["status", "-n", "wmt", "--rungs", "--json",
                                       "--ledger", ledger], root, env)
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("wmt", led).configure()
        replay = make_algorithm(exp.space, exp.algorithm)
        replay.observe(exp.fetch_completed_trials())
        trials = sorted(led.fetch("wmt"), key=lambda t: t.start_time or 0)
        done = [t for t in trials if t.status == "completed"]
        space = build_space({**WMT_PRIORS, "epochs": WMT_CLI_FIDELITY})
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        registry = json.loads((root / "metaopt_tpu_torch-gpus-1.json").read_text())
        leftovers = sorted(str(p.relative_to(ckpt)) for p in ckpt.rglob("*")
                           if p.is_file() and p.name != tfm.CKPT_FILE)
        published = {t.id: has_state(str(ckpt / t.id / tfm.CKPT_FILE)) for t in done}
        table = [(r["bracket"], r["budget"], r["capacity"]) for r in replay.rung_table]
        problems = []
        if len(done) != WMT_CLI_TRIALS or summary["total"] != {"completed": WMT_CLI_TRIALS}:
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        if table != WMT_CLI_TABLE or not all(
                r["assigned"] == r["capacity"] == r["completed"] for r in replay.rung_table):
            problems.append(f"rung table {replay.rung_table}")
        if status[0].get("rungs") != replay.rung_table:
            problems.append(f"status --rungs {status[0].get('rungs')} != {replay.rung_table}")
        if not all(st.get("device") == name for st in stats):
            problems.append(f"devices {sorted({str(st.get('device')) for st in stats})}")
        if any(st.get("torch_dynamo_imported") is not False for st in stats):
            problems.append("a trial process imported torch._dynamo")
        if not all(published.values()) or leftovers:
            problems.append(f"checkpoints: published {published}, left over {leftovers}")
        if registry != {"claims": {}}:
            problems.append(f"the GPU registry still holds {registry}")
        if problems:
            raise AssertionError(f"[wmt] config 4: {problems}")
        ckpt_bytes = sum(p.stat().st_size for p in ckpt.rglob("*") if p.is_file())
        rows = []
        for t, st in zip(done, stats):
            trial_s = t.end_time - t.start_time
            parts = {k: st[k] for k in ("first_device_op_s", "setup_s", "train_s", "save_s")}
            rows.append({"epochs": t.params["epochs"], "dropout": t.params["dropout"],
                         "trial_s": trial_s, **parts, "rest_s": trial_s - sum(parts.values()),
                         "ms_per_step": st["ms_per_step"], "first_loss": st["first_loss"],
                         "loss": t.objective})
        keys = ("trial_s", "first_device_op_s", "setup_s", "train_s", "save_s", "rest_s")
        total = {k: sum(r[k] for r in rows) for k in keys}
        by_budget = {b: {k: median([r[k] for r in rows if r["epochs"] == b])
                         for k in keys + ("ms_per_step",)} | {
                         "trials": sum(r["epochs"] == b for r in rows)} for b in (1, 3)}
        out["config4"] = {
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "status_wall_s": status_wall, "rungs": status[0]["rungs"], "sum": total,
            "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows, "checkpoint_bytes": ckpt_bytes,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[wmt] config 4: {len(done)} trials completed on {name} "
            f"({by_budget[1]['trials']} at 1 epoch, {by_budget[3]['trials']} at 3), finite, "
            f"rung table {table} equal to Hyperband replayed over the ledger and to status "
            f"--rungs from a fresh process ({status_wall:.2f} s), every checkpoint published "
            f"({ckpt_bytes / 2**30:.2f} GiB), none half-written, no torch._dynamo in a trial, "
            f"registry empty; {wall:.2f} s = {len(done) / wall * 3600:.1f} trials/hour; best "
            f"loss {summary['best']['objective']:.4f}")
        log(f"[wmt] config 4, summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for b, m in by_budget.items():
            log(f"[wmt]   {b} epoch(s) (median of {m['trials']}): trial {m['trial_s']:.2f} s = "
                f"start -> first CUDA op {m['first_device_op_s']:.2f} + setup "
                f"{m['setup_s']:.2f} + training {m['train_s']:.2f} ({m['ms_per_step']:.2f} "
                f"ms/step) + checkpoint {m['save_s']:.2f} + rest {m['rest_s']:.2f}; card {smi}")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("config4_cli")
    out["part_s"] = part_s
    log("[wmt] seconds per part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return out


# ---------------------------------------------------------------------------
# phase 12: PBT on Transformer-base through the CLI, with checkpoint handoff


def ckpt_updates(torch, path: Path) -> int:
    """The AdamW update count a published trial checkpoint holds (its
    ``opt_state`` tree's first leaf), read through a memory map."""
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return int(payload["opt_state/00000"])


def pbt_replay(exp, led_trials):
    """The port's PBT on the CPU, run through ``workon`` as the hunt ran it
    (one worker, the config's pool), each trial's objective read from the
    card's ledger by its point: the ledger's trials it registers."""
    from metaopt_tpu_torch.executor import InProcessExecutor
    from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
    from metaopt_tpu_torch.worker import workon

    key = (lambda p: json.dumps(p, sort_keys=True))  # noqa: E731
    objective = {key(t.params): t.objective for t in led_trials}
    replay = Experiment("pbt", MemoryLedger(), space=exp.space, max_trials=exp.max_trials,
                        pool_size=exp.pool_size, algorithm=exp.algorithm).configure()
    workon(replay, InProcessExecutor(lambda p: objective[key(p)]), "replay")
    return replay.fetch_trials()


def pbt_phase(torch, smi: str):
    from metaopt_tpu_torch.ledger import Experiment, FileLedger
    from metaopt_tpu_torch.models import transformer as tfm
    from metaopt_tpu_torch.models.checkpoint import has_state
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pbt_"))
    # TMPDIR: the hunt's GPU registry file is this phase's own
    env = dict(os.environ, TMPDIR=str(root))
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger, ckpt = f"file:{root / 'ledger'}", root / "ckpt"
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "pbt", "--n-chips", "1", "--max-trials", str(PBT_TRIALS),
             "--timeout-s", str(WMT_TIMEOUT_S), "--ledger", ledger, "--ckpt-root", str(ckpt),
             "--config", str(examples / "pbt.json"), str(examples / "transformer_wmt.py"),
             "--tp", "1", "--steps-per-epoch", str(PBT_STEPS_PER_EPOCH)]
            + [f"--{k}~{v}" for k, v in PBT_PRIORS.items()],
            root, env, PBT_TRIALS, 1, PBT_TRIAL_S)
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("pbt", led).configure()
        trials = sorted(led.fetch("pbt"), key=lambda t: t.submit_time or 0)
        done = [t for t in trials if t.status == "completed"]
        by_id = {t.id: t for t in done}
        name = torch.cuda.get_device_name(0)
        stats = {t.id: statistics_of(t) for t in done}
        space = build_space(PBT_PRIORS)
        registry = json.loads((root / "metaopt_tpu_torch-gpus-1.json").read_text())
        published = {t.id: has_state(str(ckpt / t.id / tfm.CKPT_FILE)) for t in done}
        problems = []
        if len(done) != PBT_TRIALS or summary["total"] != {"completed": PBT_TRIALS}:
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        if not all(st.get("device") == name for st in stats.values()):
            problems.append(f"devices {sorted({str(st.get('device')) for st in stats.values()})}")
        if not all(published.values()):
            problems.append(f"checkpoints published: {published}")
        if registry != {"claims": {}}:
            problems.append(f"the GPU registry still holds {registry}")
        # every continuation restored its parent's published state: its AdamW
        # count starts at the parent's and ends its own steps later
        handoffs = []
        for t in done:
            st = stats[t.id]
            steps = t.params["epochs"] * PBT_STEPS_PER_EPOCH
            own = ckpt_updates(torch, ckpt / t.id / tfm.CKPT_FILE) if published[t.id] else None
            row = {"id": t.id, "epochs": t.params["epochs"], "parent": t.parent,
                   "restored": st.get("restored"), "restored_updates": st.get("restored_updates"),
                   "updates": st.get("updates"), "checkpoint_updates": own,
                   "exploit": bool(t.parent and t.parent in by_id
                                   and by_id[t.parent].lineage != t.lineage)}
            if t.parent is None:
                ok = st.get("restored") is False and st.get("updates") == steps == own
            else:
                parent = by_id.get(t.parent)
                parent_updates = (ckpt_updates(torch, ckpt / t.parent / tfm.CKPT_FILE)
                                  if parent is not None else None)
                row["parent_updates"] = parent_updates
                ok = (st.get("restored") is True
                      and st.get("restored_updates") == parent_updates
                      and st.get("updates") == parent_updates + steps == own)
            row["ok"] = bool(ok)
            handoffs.append(row)
        if not all(r["ok"] for r in handoffs):
            problems.append(f"handoffs {[r for r in handoffs if not r['ok']]}")
        exploits = [r for r in handoffs if r["exploit"]]
        if not exploits:
            problems.append("no continuation took another member's weights")
        # PBT's suggestions against the port's PBT replayed on the CPU
        key = (lambda t: (t.id, json.dumps(t.params, sort_keys=True), t.parent))  # noqa: E731
        replayed = pbt_replay(exp, done)
        if sorted(map(key, replayed)) != sorted(map(key, trials)):
            problems.append("the ledger's trials differ from PBT replayed on the CPU")
        if problems:
            raise AssertionError(f"[pbt] {problems}")
        rows = []
        for t in done:
            st = stats[t.id]
            trial_s = t.end_time - t.start_time
            parts = {k: st[k] for k in ("first_device_op_s", "setup_s", "train_s", "save_s")}
            rows.append({"epochs": t.params["epochs"], "restored": st["restored"],
                         "trial_s": trial_s, **parts, "rest_s": trial_s - sum(parts.values()),
                         "ms_per_step": st["ms_per_step"], "loss": t.objective})
        keys = ("trial_s", "first_device_op_s", "setup_s", "train_s", "save_s", "rest_s")
        total = {k: sum(r[k] for r in rows) for k in keys}
        by_budget = {b: {k: median([r[k] for r in rows if r["epochs"] == b])
                         for k in keys + ("ms_per_step",)} | {
                         "trials": sum(r["epochs"] == b for r in rows)}
                     for b in sorted({r["epochs"] for r in rows})}
        ckpt_bytes = sum(p.stat().st_size for p in ckpt.rglob("*") if p.is_file())
        out.update({
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "continuations": sum(1 for t in done if t.parent), "exploits": len(exploits),
            "handoffs": handoffs, "sum": total,
            "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows, "checkpoint_bytes": ckpt_bytes,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        })
        log(f"[pbt] {len(done)} Transformer-base trials completed on {name} (budgets "
            f"{[t.params['epochs'] for t in done]}), finite; {out['continuations']} "
            f"continuations, each restoring its parent's published state (AdamW counts "
            f"{[(r['restored_updates'], r['updates']) for r in handoffs if r['parent']]}), "
            f"{len(exploits)} exploit(s) taking another member's weights; equal to PBT replayed "
            f"on the CPU; registry empty; {wall:.2f} s = {len(done) / wall * 3600:.1f} "
            f"trials/hour; best loss {summary['best']['objective']:.4f}")
        log(f"[pbt] summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for b, m in by_budget.items():
            log(f"[pbt]   {b} epoch(s) (median of {m['trials']}): trial {m['trial_s']:.2f} s = "
                f"start -> first CUDA op {m['first_device_op_s']:.2f} + setup "
                f"{m['setup_s']:.2f} + training {m['train_s']:.2f} ({m['ms_per_step']:.2f} "
                f"ms/step) + checkpoint {m['save_s']:.2f} + rest {m['rest_s']:.2f}; card {smi}")
        for t in done:
            log(f"  {t.id[:8]} epochs {t.params['epochs']} parent "
                f"{(t.parent or '-')[:8]} lineage {t.lineage[:8]} loss {t.objective:.6f}")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: CMA-ES, DEHB, grid search, gradient descent and MOTPE in-process


def zdt1(p):
    g = 1.0 + 9.0 * p["y"]
    return [{"name": "f1", "type": "objective", "value": p["x"]},
            {"name": "f2", "type": "objective",
             "value": g * (1.0 - math.sqrt(max(p["x"], 0.0) / g))}]


def algos_phase(torch, smi: str):
    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.models.objectives import rosenbrock

    def rosen_budget(p):  # Rosenbrock, noisier at a lower budget
        return rosenbrock(p) * (1.0 + 1.0 / p["epochs"])

    def quadratic(p):  # a gradient-reporting bowl at (1, -0.5)
        gx, gy = 2 * (p["x"] - 1.0), 2 * (p["y"] + 0.5)
        return [{"name": "f", "type": "objective",
                 "value": (p["x"] - 1.0) ** 2 + (p["y"] + 0.5) ** 2},
                {"name": "df", "type": "gradient", "value": [gx, gy]}]

    runs = (
        ("cmaes", {"cmaes": {"seed": 0, "population_size": 8}}, ROSEN_SPACE, rosenbrock, 16),
        ("dehb", {"dehb": {"population_size": 10, "seed": 0, "mutation_factor": 0.5,
                           "crossover_prob": 0.5}},
         {**ROSEN_SPACE, "epochs": "fidelity(1, 9, base=3)"}, rosen_budget, 20),
        ("grid_search", {"grid_search": {"n_values": 4}}, ROSEN_SPACE, rosenbrock, 16),
        ("gradient_descent", {"gradient_descent": {"seed": 4, "learning_rate": 0.2}},
         {"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"}, quadratic, 12),
        ("motpe", {"motpe": dict(MOTPE_YAML)}, {"x": "uniform(0, 1)", "y": "uniform(0, 1)"},
         zdt1, MOTPE_TRIALS),
    )
    out = {"card": smi}
    for tag, cfg, space, fn, want in runs:
        client = build_experiment(f"algos-{tag}", space=space, algorithm=cfg, max_trials=want,
                                  ledger="memory")
        algo = make_algorithm(client.space, cfg)
        t0 = time.perf_counter()
        client.workon(fn, algorithm=algo)
        if hasattr(algo, "drain_suggest_ahead"):
            algo.drain_suggest_ahead()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = client.fetch_trials("completed")
        row = {"trials": len(done), "wall_s": wall,
               "best": min(t.objective for t in done) if done else None}
        problems = []
        if len(done) != want:
            problems.append(f"{len(done)} trials completed, want {want}")
        if not all(math.isfinite(v) for t in done for v in t.objectives):
            problems.append("a non-finite objective")
        if not all(t.params in client.space for t in done):
            problems.append("a point outside the space")
        if tag == "cmaes":
            row["generation"] = algo.generation
            if algo.generation < 2:
                problems.append(f"generation {algo.generation}")
        elif tag == "dehb":
            row["rungs"] = algo.rung_table
            if algo.rung_table[1]["n"] < 1:
                problems.append(f"nothing promoted: {algo.rung_table}")
        elif tag == "grid_search":
            if not algo.is_done:
                problems.append("the 4 x 4 lattice is not exhausted")
        elif tag == "gradient_descent":
            if row["best"] > 0.05:
                problems.append(f"gradient descent ended at {row['best']}")
        else:
            tel = algo.telemetry()
            row["telemetry"] = tel
            row["ei_suggests"] = tel["prefetch_hits"] + tel["prefetch_misses"]
            row["pareto_front"] = len(algo.pareto_front())
            row["buffer"] = str(algo._buf.Xdev.device) if algo._buf.Xdev is not None else None
            if (row["ei_suggests"] < want - MOTPE_YAML["n_initial_points"]
                    or tel["kernel_launches"] < 1 or row["buffer"] != "cuda:0"):
                problems.append(f"EI on the card: {row}")
            if not all(len(t.objectives) == 2 for t in done):
                problems.append("a trial without its two objectives")
        if problems:
            raise AssertionError(f"[algos] {tag}: {problems}")
        out[tag] = row
        log(f"[algos] {tag}: {len(done)} trials in {wall:.2f} s, finite, in the space; best "
            f"{row['best']:.6g}" + "".join(f"; {k} {row[k]}" for k in (
                "generation", "ei_suggests", "pareto_front", "buffer") if k in row))
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 14: the decoder-only LM, MoE feed-forwards, the blocked xent, remat


def rel_to_scale(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def lm_card_vs_cpu(torch, lm, tfm, extra, rate: float):
    """The full-width LM at batch ``LM_CMP_BATCH``, seq ``LM_SEQ`` and
    ``LM_CMP_LAYERS`` layers, card against CPU on the same weights and draws
    (the same attention Philox seeds from CPU generators seeded alike, the
    same feed-forward masks through ``GivenDraws``): eval-mode logits, then
    the train-mode loss and every parameter's gradient. The CPU runs the
    plain attention."""
    import numpy as np

    hp = {"dropout": rate, "n_layers": LM_CMP_LAYERS, **extra}
    model_cpu = lm.make_lm(hp).init_like_flax(torch.Generator().manual_seed(3))
    model_gpu = lm.make_lm(hp)
    model_gpu.load_state_dict(model_cpu.state_dict())
    model_gpu.cuda()
    toks = lm.synthetic_lm(LM_CMP_BATCH, LM_SEQ + 1, 1000, seed=5, device="cpu")
    rng = np.random.default_rng(6)
    masks = [rng.random(shape) < 1.0 - rate for layer in model_cpu.h
             for shape in layer.mlp.mask_shapes(LM_CMP_BATCH, LM_SEQ)]
    res = {}
    for dev, model in (("cpu", model_cpu), ("cuda", model_gpu)):
        with torch.no_grad():
            logits = model(toks[:, :-1].to(dev)).cpu()
        stats = {}
        loss = lm.lm_loss_fn(model, toks.to(dev),
                             tfm.GivenDraws(masks, attention_seed=8, device=dev), stats=stats)
        loss.backward()
        res[dev] = {"logits": logits, "loss": float(loss),
                    "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
                    "dropped": [float(x) for x in stats.get("moe_stats", [])]}
    torch.cuda.synchronize()
    c, g = res["cpu"], res["cuda"]
    norms_c = {n: float(t.norm()) for n, t in c["grads"].items()}
    biggest = max(norms_c.values())
    diff = {n: abs(float(g["grads"][n].norm()) - norms_c[n]) for n in norms_c}
    # each gradient's norm against its own; the key biases' gradients are 0
    # in exact arithmetic (softmax is shift-invariant per row), so theirs is
    # held against 1% of the largest norm instead
    norm_rel = {n: diff[n] / (1e-2 * biggest if n.endswith("k.bias") else norms_c[n])
                for n in norms_c}
    routers = {n for n in norms_c if ".router." in n}
    worst = max((n for n in norms_c if n not in routers), key=norm_rel.get)
    worst_router = max(routers, key=norm_rel.get) if routers else None
    elem = {n: rel_to_scale(g["grads"][n], c["grads"][n]) for n in norms_c
            if not n.endswith("k.bias")}
    worst_elem = max(elem, key=elem.get)
    return {"logits_rel_to_scale": rel_to_scale(g["logits"], c["logits"]),
            "loss_card": g["loss"], "loss_cpu": c["loss"],
            "loss_rel": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            "worst_grad_norm_rel": norm_rel[worst], "worst_grad_norm_param": worst,
            "worst_router_norm_rel": norm_rel[worst_router] if routers else 0.0,
            "worst_router_param": worst_router,
            "worst_grad_elem_rel_to_scale": elem[worst_elem], "worst_grad_elem_param": worst_elem,
            "dropped_card": g["dropped"], "dropped_cpu": c["dropped"]}


def lm_model_and_step(torch, lm, tfm, hp, batch: int = LM_BATCH, seq: int = LM_SEQ,
                      vocab: int = 1000):
    """A full-width LM on the card, its optimizer, a token batch and a train
    step at the next step's ``Draws``; ``stats`` holds the last step's
    ``lm_loss_fn`` statistics."""
    model = lm.make_lm({**hp, "vocab": vocab}).init_like_flax(
        torch.Generator().manual_seed(0)).cuda()
    opt = tfm.trial_setup({"lr": 1e-3, "warmup": 2}, model.parameters(), 100)
    toks = lm.synthetic_lm(batch, seq + 1, vocab, seed=0, device="cuda")
    counter = iter(range(10 ** 6))
    stats = {}

    def step():
        opt.zero_grad()
        stats.clear()
        loss = lm.lm_loss_fn(model, toks, tfm.Draws(0, next(counter), "cuda"), stats=stats)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step, stats


def lm_xent_paths(torch, xent, tfm, smi: str):
    """The blocked xent against the materialized one at ``LM_XENT``: values,
    both gradients (the cotangent a random weight per token), each path's
    forward + backward time and the memory it adds at its peak; then the
    blocked path with TF32 on against off."""
    import torch.nn.functional as F

    n, v, d = LM_XENT
    if not tfm.blocked_xent_enabled(n, 1, v):
        raise AssertionError(f"[lm] {LM_XENT} is not on the blocked route")
    gen = torch.Generator(device="cuda").manual_seed(9)
    y = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    emb = (torch.randn(v, d, generator=gen, device="cuda") * 0.05).bfloat16()
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    w = torch.rand(n, generator=gen, device="cuda")
    block_v = xent.pick_block_v(v)

    def run(blocked: bool):
        yl, el = y.clone().requires_grad_(), emb.clone().requires_grad_()
        if blocked:
            loss = xent.blocked_softmax_xent(yl, el, labels, block_v)
        else:
            loss = F.cross_entropy(yl.float() @ el.float().t(), labels, reduction="none")
        (loss * w).sum().backward()
        return loss.detach(), yl.grad, el.grad

    out = {"shape": {"n": n, "v": v, "d": d, "block_v": block_v},
           "logits_bytes": 4 * n * v, "card": smi}
    results = {}
    for label, blocked in (("blocked", True), ("materialized", False)):
        run(blocked)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[label] = run(blocked)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        for _ in range(3):
            run(blocked)
        torch.cuda.synchronize()
        out[label] = {"ms": (time.perf_counter() - t0) / 3 * 1e3, "peak_added_bytes": peak}
    (lb, dyb, deb), (lm_, dym, dem) = results["blocked"], results["materialized"]
    out["loss_max_abs_diff"] = float((lb - lm_).abs().max())
    out["dy_rel_to_scale"] = rel_to_scale(dyb.float(), dym.float())
    out["demb_rel_to_scale"] = rel_to_scale(deb.float(), dem.float())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lt, dyt, det = run(True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    out["tf32_on_vs_off"] = {"loss_max_abs_diff": float((lt - lb).abs().max()),
                             "dy_rel_to_scale": rel_to_scale(dyt.float(), dyb.float()),
                             "demb_rel_to_scale": rel_to_scale(det.float(), deb.float())}
    return out


def lm_phase(torch, smi: str):
    """The decoder-only LM at full width (``make_lm``'s defaults: d_model
    512, 8 heads, 6 layers, d_ff 2048, vocab 1000), MoE, the blocked xent
    and remat; see the module docstring, phase 14."""
    from metaopt_tpu_torch.ledger import FileLedger
    from metaopt_tpu_torch.models import lm
    from metaopt_tpu_torch.models import transformer as tfm
    from metaopt_tpu_torch.models.checkpoint import has_state
    from metaopt_tpu_torch.ops import attention as att
    from metaopt_tpu_torch.ops import xent
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    part_s, last = {}, [time.perf_counter()]

    def mark(part: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        part_s[part] = now - last[0]
        last[0] = now

    saved = dict(att.launches), dict(att.dropout_launches)

    def restore_counts() -> None:  # comparison launches do not count
        att.launches.update(saved[0])
        att.dropout_launches.update(saved[1])

    # -- (a) the full-width LM, card against CPU -----------------------------
    cmp = {}
    for extra in [{}] + LM_MOE:
        for rate in (0.0, 0.1):
            label = (f"moe k={extra['router_top_k']}" if extra else "dense") + f" rate {rate}"
            r = lm_card_vs_cpu(torch, lm, tfm, extra, rate)
            cmp[label] = r
            log(f"[lm] card against CPU, {label} (batch {LM_CMP_BATCH}, seq {LM_SEQ}, {LM_CMP_LAYERS} layers): logits "
                f"{r['logits_rel_to_scale']:.2e} of their scale; loss {r['loss_card']:.6f} / "
                f"{r['loss_cpu']:.6f} (rel {r['loss_rel']:.2e}); gradient norms worst rel "
                f"{r['worst_grad_norm_rel']:.2e} of its own norm ({r['worst_grad_norm_param']}), "
                f"routers {r['worst_router_norm_rel']:.2e} ({r['worst_router_param']}); "
                f"elementwise worst {r['worst_grad_elem_rel_to_scale']:.2e} of the tensor's "
                f"scale ({r['worst_grad_elem_param']}); dropped card {r['dropped_card']} cpu "
                f"{r['dropped_cpu']}; bounds 3e-2, routers {LM_ROUTER_TOL:g}, elementwise "
                f"(dense) {LM_DENSE_ELEM_TOL:g}")
            if not (math.isfinite(r["loss_card"]) and r["logits_rel_to_scale"] <= 3e-2
                    and r["loss_rel"] <= 3e-2 and r["worst_grad_norm_rel"] <= 3e-2
                    and r["worst_router_norm_rel"] <= LM_ROUTER_TOL
                    and (extra or r["worst_grad_elem_rel_to_scale"] <= LM_DENSE_ELEM_TOL)):
                raise AssertionError(f"[lm] {label}: the card disagrees with the CPU: {r}")
    out["card_vs_cpu"] = cmp
    restore_counts()
    torch.cuda.empty_cache()
    mark("card_vs_cpu")

    # -- (b) the train step, plain and under remat ---------------------------
    steps = {}
    for remat in (False, True):
        model, step, _ = lm_model_and_step(torch, lm, tfm, {"dropout": 0.1, "remat": remat})
        att.reset_launch_counts()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0  # remat's first call imports torch._dynamo
        counts, drop_counts = dict(att.launches), dict(att.dropout_launches)
        n = len(model.h)  # one attention call per layer: 6 at full depth
        want = {"flash_fwd": 2 * n if remat else n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
        if counts != want or drop_counts != want:
            raise AssertionError(f"[lm] remat {remat}: launches per step {counts}, with "
                                 f"dropout {drop_counts}, want {want}")
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        att.reset_launch_counts()  # the LM path's run: its launches are read just after
        st = None
        for _ in range(2):  # a window the profiler dropped is traced again
            st = trace_steps(torch, step, LM_STEPS, LM_TRACED, KERNEL_KINDS)
            if st is not None and any("flash_" in r[0] for r in st["rows"]):
                break
        torch.cuda.synchronize()
        run_counts = dict(att.dropout_launches)
        peak = torch.cuda.max_memory_allocated()
        if st is None:
            raise AssertionError("[lm] the profiler traced no LM train step")
        if min(run_counts.values()) < 1:
            raise AssertionError(f"[lm] a kernel never ran on the LM path: {run_counts}")
        rows = st.pop("rows")
        tag = "remat" if remat else "plain"
        log_breakdown("lm", f"LM train step, {tag} (B {LM_BATCH}, S {LM_SEQ}, dropout 0.1)",
                      {**st, "rows": rows})
        flash = [[k[:90], ms, n] for k, ms, n in rows if "flash_" in k]
        steps[tag] = {**st, "peak_mem_bytes": peak, "first_step_s": first_s,
                      "launches_per_step": counts,
                      "launches": run_counts, "flash": flash,
                      "flash_ms_per_step": sum(ms for _, ms, _ in flash),
                      "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}
        log(f"[lm] {tag} step: {st['wall_ms']:.3f} ms untraced, device busy "
            f"{st['device_busy_ms']:.3f} ms = {100 * st['busy_share']:.1f}%, K1-K3 "
            f"{steps[tag]['flash_ms_per_step']:.3f} ms per step, peak memory "
            f"{peak / 2**30:.3f} GiB, launches per step {counts}, first step {first_s:.2f} s; "
            f"card {smi}")
        for key, ms, n in flash:
            log(f"  {ms:8.4f} ms/step  x{n:4.1f}  = {ms / n:.4f} ms/launch  {key}")
        del model, step
        torch.cuda.empty_cache()
    plain, rem = steps["plain"], steps["remat"]
    log(f"[lm] remat trade: {rem['wall_ms']:.3f} / {plain['wall_ms']:.3f} ms per step = "
        f"{rem['wall_ms'] / plain['wall_ms']:.3f}x, device {rem['device_busy_ms']:.3f} / "
        f"{plain['device_busy_ms']:.3f} ms, peak memory {rem['peak_mem_bytes'] / 2**30:.3f} / "
        f"{plain['peak_mem_bytes'] / 2**30:.3f} GiB = "
        f"{rem['peak_mem_bytes'] / plain['peak_mem_bytes']:.3f}x")
    out["step"] = steps
    # remat on against off: one step's loss and gradients from the same weights
    # and draws at dropout 0.1
    grads = {}
    for remat in (False, True):
        model = lm.make_lm({"dropout": 0.1, "remat": remat}).init_like_flax(
            torch.Generator().manual_seed(0)).cuda()
        toks = lm.synthetic_lm(LM_BATCH, LM_SEQ + 1, 1000, seed=0, device="cuda")
        loss = lm.lm_loss_fn(model, toks, tfm.Draws(0, 0, "cuda"))
        loss.backward()
        grads[remat] = (float(loss), {n: p.grad.detach().clone()
                                      for n, p in model.named_parameters()})
        del model
    rel = {n: rel_to_scale(grads[True][1][n], g) for n, g in grads[False][1].items()}
    same = sum(torch.equal(grads[True][1][n], g) for n, g in grads[False][1].items())
    worst = max(rel, key=rel.get)
    out["remat_vs_plain"] = {"loss_plain": grads[False][0], "loss_remat": grads[True][0],
                             "grads_bit_equal": same, "grads": len(rel),
                             "worst_grad_rel_to_scale": rel[worst], "worst_param": worst}
    log(f"[lm] remat on against off at dropout 0.1: loss {grads[True][0]!r} / "
        f"{grads[False][0]!r}; {same} of {len(rel)} gradients bit-equal, worst "
        f"{rel[worst]:.2e} of its scale ({worst})")
    if grads[True][0] != grads[False][0] or rel[worst] > 3e-2:
        raise AssertionError(f"[lm] remat changes the step: {out['remat_vs_plain']}")
    del grads
    restore_counts()
    torch.cuda.empty_cache()
    mark("train_step")

    # -- (c) MoE steps, and Transformer-base with MoE in-process -------------
    moe = {}
    for extra in LM_MOE:
        model, step, stats = lm_model_and_step(torch, lm, tfm, {"dropout": 0.1, **extra})
        losses = [step() for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        label = f"k={extra['router_top_k']}"
        st = trace_steps(torch, lambda: losses.append(step()), LM_MOE_STEPS, 2, KERNEL_KINDS)
        if st is None:
            raise AssertionError(f"[lm] the profiler traced no MoE {label} step")
        rows = st.pop("rows")
        log_breakdown("lm", f"MoE {label} LM train step", {**st, "rows": rows})
        ms = st["wall_ms"]
        dropped = [float(x) for x in stats["moe_stats"]]
        balance = [float(x) for x in stats["aux_loss"]]
        moe[label] = {**st, "ms_per_step": ms, "over_dense": ms / plain["wall_ms"],
                      "dropped_fraction": dropped, "balance_loss": balance,
                      "loss": float(losses[-1]), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "top": [[k[:90], t, n] for k, t, n in rows[:12]]}
        log(f"[lm] MoE {label} (8 experts, capacity 1.25): {ms:.3f} ms/step = "
            f"{ms / plain['wall_ms']:.3f}x the dense step, device busy "
            f"{100 * st['busy_share']:.1f}%; dropped fraction per layer "
            f"{[round(x, 4) for x in dropped]}, balance loss {[round(x, 4) for x in balance]}; "
            f"loss {float(losses[-1]):.4f}; card {smi}")
        if not all(math.isfinite(float(x)) for x in losses) or len(dropped) != len(model.h):
            raise AssertionError(f"[lm] MoE {label}: {moe[label]}")
        del model, step
        torch.cuda.empty_cache()
    rep = {}
    loss = tfm.train_and_eval({"lr": 1e-3, "warmup": 2, "dropout": 0.1, "n_experts": 8},
                              steps=10, device="cuda", report=rep)
    moe["transformer_base"] = {"loss": loss, "ms_per_step": rep["train_s"] / rep["steps"] * 1e3,
                               "first_loss": rep["losses"][0]}
    log(f"[lm] Transformer-base with 8-expert MoE feed-forwards, in-process train_and_eval, "
        f"10 steps: loss {rep['losses'][0]:.4f} -> {loss:.4f}, "
        f"{moe['transformer_base']['ms_per_step']:.3f} ms/step")
    if not math.isfinite(loss):
        raise AssertionError("[lm] Transformer-base with MoE: a non-finite loss")
    out["moe"] = moe
    restore_counts()
    torch.cuda.empty_cache()
    mark("moe")

    # -- (d) the blocked xent on the card ------------------------------------
    xr = lm_xent_paths(torch, xent, tfm, smi)
    b, m_ = xr["blocked"], xr["materialized"]
    log(f"[lm] blocked xent at N {LM_XENT[0]} x V {LM_XENT[1]} x D {LM_XENT[2]} (bf16 in, "
        f"{xr['logits_bytes'] / 2**30:.1f} GiB of f32 logits, block_v "
        f"{xr['shape']['block_v']}): forward + backward {b['ms']:.2f} ms, +"
        f"{b['peak_added_bytes'] / 2**30:.3f} GiB at its peak; materialized {m_['ms']:.2f} ms, +"
        f"{m_['peak_added_bytes'] / 2**30:.3f} GiB; losses differ by "
        f"{xr['loss_max_abs_diff']:.2e}, dY by {xr['dy_rel_to_scale']:.2e} and dEmb by "
        f"{xr['demb_rel_to_scale']:.2e} of their scale; TF32 on against off: "
        f"{xr['tf32_on_vs_off']}; card {smi}")
    if not (xr["loss_max_abs_diff"] <= 1e-3 and xr["dy_rel_to_scale"] <= 3e-2
            and xr["demb_rel_to_scale"] <= 3e-2):
        raise AssertionError(f"[lm] the blocked xent disagrees with the materialized: {xr}")
    torch.cuda.empty_cache()
    batch, seq, vocab = LM_BIG_VOCAB
    model, step, stats = lm_model_and_step(torch, lm, tfm, {"dropout": 0.1}, batch, seq, vocab)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    xr["lm_step"] = {"batch": batch, "seq": seq, "vocab": vocab, "ms": big_ms,
                     "blocked_route": stats["blocked_xent"],
                     "loss": float(loss), "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[lm] LM step at vocab {vocab}, batch {batch} x {seq}: blocked route "
        f"{stats['blocked_xent']}, {big_ms:.2f} ms, "
        f"peak memory {xr['lm_step']['peak_mem_bytes'] / 2**30:.3f} GiB, loss {float(loss):.4f}")
    if not stats["blocked_xent"] or not math.isfinite(float(loss)):
        raise AssertionError(f"[lm] the vocab-{vocab} step did not take the blocked route: "
                             f"{xr['lm_step']}")
    out["xent"] = xr
    del model, step
    restore_counts()
    torch.cuda.empty_cache()
    mark("xent")

    # -- (e) lm_causal.py through hunt --n-chips 1 ----------------------------
    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    # TMPDIR: the hunt's GPU registry file is this phase's own
    env = dict(os.environ, TMPDIR=str(root))
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    ledger, ckpt = f"file:{root / 'ledger'}", root / "ckpt"
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "lm", "--n-chips", "1", "--max-trials", str(LM_CLI_TRIALS),
             "--ledger", ledger, "--ckpt-root", str(ckpt),
             "--config", str(examples / "tpe.json"), str(examples / "lm_causal.py"),
             "--d-model", "512", "--d-ff", "2048", "--seq-len", str(LM_SEQ)]
            + [f"--{k}~{v}" for k, v in LM_PRIORS.items()],
            root, env, LM_CLI_TRIALS, 1, LM_TRIAL_S)
        trials = sorted(FileLedger(str(root / "ledger")).fetch("lm"),
                        key=lambda t: t.start_time or 0)
        done = [t for t in trials if t.status == "completed"]
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        space = build_space(LM_PRIORS)
        registry = json.loads((root / "metaopt_tpu_torch-gpus-1.json").read_text())
        published = {t.id: has_state(str(ckpt / t.id / tfm.CKPT_FILE)) for t in done}
        problems = []
        if len(done) != LM_CLI_TRIALS or summary["total"] != {"completed": LM_CLI_TRIALS}:
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if not all(math.isfinite(t.objective) for t in done):
            problems.append("a non-finite objective")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        if not all(st.get("device") == name for st in stats):
            problems.append(f"devices {sorted({str(st.get('device')) for st in stats})}")
        if not all(published.values()):
            problems.append(f"checkpoints published: {published}")
        if registry != {"claims": {}}:
            problems.append(f"the GPU registry still holds {registry}")
        if problems:
            raise AssertionError(f"[lm] lm_causal.py through the CLI: {problems}")
        rows = []
        for t, st in zip(done, stats):
            trial_s = t.end_time - t.start_time
            parts = {k: st[k] for k in ("first_device_op_s", "setup_s", "train_s", "save_s")}
            rows.append({"n_layers": t.params["n-layers"], "trial_s": trial_s, **parts,
                         "rest_s": trial_s - sum(parts.values()),
                         "ms_per_step": st["ms_per_step"], "loss": t.objective})
        keys = ("trial_s", "first_device_op_s", "setup_s", "train_s", "save_s", "rest_s")
        total = {k: sum(r[k] for r in rows) for k in keys}
        out["cli"] = {
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "sum": total, "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "per_trial": rows, "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[lm] lm_causal.py through hunt --n-chips 1 (tpe.json: 10 initial points, so all "
            f"{len(done)} trials are TPE's random draws), d_model 512, d_ff 2048, seq {LM_SEQ}, "
            f"80 steps: {len(done)} trials completed on {name}, finite, checkpoints published, "
            f"registry empty; {wall:.2f} s = {len(done) / wall * 3600:.1f} trials/hour; best loss "
            f"{summary['best']['objective']:.4f}")
        log(f"[lm] summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for r in rows:
            log(f"[lm]   {r['n_layers']} layer(s): trial {r['trial_s']:.2f} s = start -> first "
                f"CUDA op {r['first_device_op_s']:.2f} + setup {r['setup_s']:.2f} + training "
                f"{r['train_s']:.2f} ({r['ms_per_step']:.2f} ms/step) + checkpoint "
                f"{r['save_s']:.2f} + rest {r['rest_s']:.2f}; loss {r['loss']:.4f}; card {smi}")
    except BaseException:
        log_ledger(root / "ledger")
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("cli")
    out["part_s"] = part_s
    log("[lm] seconds per part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import metaopt_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})", file=sys.stderr)
        return 2
    from metaopt_tpu_torch import build_experiment
    from metaopt_tpu_torch.models import transformer as tfm
    from metaopt_tpu_torch.ops import attention as att
    from metaopt_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase_s, last = {}, [time.perf_counter()]

    def mark(phase: str) -> None:  # seconds since the previous phase ended
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    att.build()
    build_s = time.perf_counter() - t0
    lib = cuda_build.library_path("flash_attention",
                                  [cuda_build.CSRC_DIR / "flash_attention.cu"])
    log(f"[build] flash_attention built/loaded in {build_s:.2f} s ({lib.name})")
    ptxas_log = lib.with_suffix(".log").read_text()
    for line in ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    ptxas = ptxas_summary(ptxas_log)
    for kern, st in sorted(ptxas.items()):
        log(f"[build] {kern}: {st['registers']} registers, spill stores/loads "
            f"{st['spill_stores']}/{st['spill_loads']} bytes")
    missing = [f"flash_fwd_kernel_mma<{d}, {drop}>" for d in att.SUPPORTED_HEAD_DIMS
               for drop in ("false", "true") if f"flash_fwd_kernel_mma<{d}, {drop}>" not in ptxas]
    if missing:
        raise AssertionError(f"ptxas compiled no {missing}")
    smi = nvidia_smi()
    log(smi)
    mark("build")

    # -- 2. kernels -----------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    cases = [
        make_case(torch, "slice-pad bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "pad", gen),
        make_case(torch, "slice-causal bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "causal", gen),
        make_case(torch, "slice-cross bf16 (32,64,8,64)", 32, 64, 64, 8, 64, bf16, "cross", gen),
        make_case(torch, "ragged f32 (4,333,8,64)", 4, 333, 333, 8, 64, torch.float32,
                  "causal+empty", gen),
        make_case(torch, "ragged bf16 (4,333,8,64)", 4, 333, 333, 8, 64, bf16,
                  "causal+empty", gen),
        make_case(torch, "slice-pad bf16 D32 (32,64,8,32)", 32, 64, 64, 8, 32, bf16, "pad", gen),
        make_case(torch, "slice-pad bf16 D128 (32,64,8,128)", 32, 64, 64, 8, 128, bf16, "pad",
                  gen),
        make_case(torch, "ragged-cross bf16 (3,96x200,4,64)", 3, 96, 200, 4, 64, bf16, "cross",
                  gen),
        make_case(torch, "long-causal bf16 (8,512,8,64)", 8, 512, 512, 8, 64, bf16, "causal",
                  gen),
        make_case(torch, "tile-skip causal bf16 (2,200x330,4,64)", 2, 200, 330, 4, 64, bf16,
                  "tril", gen),
    ]
    log("[kernels] max |kernel - plain| per case:")
    max_err = {n: 0.0 for n in att.launches}
    case_err = {n: {} for n in att.launches}
    lse_delta = []
    for case in cases:
        errs, stats = check_case(torch, att, case)
        for n, e in errs.items():
            max_err[n] = max(max_err[n], e)
            case_err[n][case["name"]] = e
        lse_delta.append(stats)
    at = {c["name"].split(" ")[0]: i for i, c in enumerate(cases)}
    log("[kernels] the slice's shape through autograd, K1's lse feeding K2 and K3:")
    autograd_err = check_autograd(torch, att, cases[at["slice-causal"]])
    log("[kernels] times at the slice's shapes (B 32, S 64, H 8, D 64, bf16, padding mask):")
    timing_stats = time_case(torch, att, cases[0], lse_delta[0])
    log("[kernels] times at the long shape (B 8, S 512, H 8, D 64, bf16, causal mask):")
    long_stats = time_case(torch, att, cases[at["long-causal"]], lse_delta[at["long-causal"]])
    bwd_ratio = {}
    for label, st in (("slice", timing_stats), ("long", long_stats)):
        k2, k3 = st["flash_bwd_dkv"]["ms"], st["flash_bwd_dq"]["ms"]
        bwd_ratio[label] = (k2 + k3) / st["flash_bwd_dkv"]["library_ms"]
        log(f"[kernels] {label}: (K2 + K3) / SDPA backward = ({k2:.4f} + {k3:.4f}) / "
            f"{st['flash_bwd_dkv']['library_ms']:.4f} ms = {bwd_ratio[label]:.2f}")
    # config 4's attention dropout, timed here beside rate 0 (the [wmt] phase
    # holds it against its plain version at more shapes and rates)
    drop_stats = {}
    for label, idx, zero in (("slice", 0, timing_stats),
                             ("long", at["long-causal"], long_stats)):
        case = cases[idx]
        log(f"[kernels] times at the {label} shape with attention dropout {WMT_TIMED_RATE} "
            f"(SDPA with dropout_p the same):")
        ld = check_case(torch, att, case, WMT_TIMED_RATE)[1]
        drop_stats[label] = time_case(torch, att, case, ld, WMT_TIMED_RATE)
        for name in att.launches:
            z, d = zero[name]["ms"], drop_stats[label][name]["ms"]
            log(f"[kernels] {label} {name}: {d:.4f} ms at rate {WMT_TIMED_RATE} / {z:.4f} ms at "
                f"rate 0 = {d / z:.2f}x ({drop_stats[label][name]['ms_source']}); card {smi}")

    mark("kernels")

    # -- 3. full-width model against the CPU ---------------------------------
    hp = {"dropout": 0.0}
    model_gpu = tfm.make_model(hp).init_like_flax(torch.Generator().manual_seed(3))
    model_cpu = tfm.make_model(hp)
    model_cpu.load_state_dict(model_gpu.state_dict())
    model_gpu.cuda()
    src, tgt = tfm.synthetic_seq2seq(2, 64, 1000, seed=5, device="cpu")
    with torch.no_grad():
        saved = dict(att.launches)
        loss_gpu = float(tfm.loss_fn(model_gpu, (src.cuda(), tgt.cuda())))
        att.launches.update(saved)
        loss_cpu = float(tfm.loss_fn(model_cpu, (src, tgt)))
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    log(f"[model] Transformer-base loss on a (2, 64) batch: card {loss_gpu:.6f}, "
        f"cpu {loss_cpu:.6f}, rel diff {rel:.2e} (bound 3e-2)")
    if not (math.isfinite(loss_gpu) and rel <= 3e-2):
        raise AssertionError("full-width model on the card disagrees with the CPU")
    del model_gpu, model_cpu

    mark("model")

    # -- 4. the slice: build_experiment(...).workon -------------------------
    reports = []

    def objective(params):
        rep = {}
        loss = tfm.train_and_eval({**params, "dropout": 0.0}, steps=STEPS,
                                  device="cuda", report=rep)
        reports.append(rep)
        return loss

    exp = build_experiment(
        "smoke",
        space={"lr": "loguniform(1e-4, 3e-3)",
               "warmup": "uniform(1, 8, discrete=True)"},
        algorithm={"random": {"seed": 1}},
        max_trials=TRIALS,
        ledger="memory",
    )
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    t0 = time.perf_counter()
    stats = exp.workon(objective)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(att.launches)
    peak_mem = torch.cuda.max_memory_allocated()

    notes = [e["note"] for e in stats.events if e["note"]]
    done = exp.fetch_trials("completed")
    log(f"[slice] {len(done)} completed trials in {wall_s:.2f} s; notes: {notes}")
    if len(done) != TRIALS or not all(math.isfinite(t.objective) for t in done):
        raise AssertionError(f"expected {TRIALS} completed finite trials, got "
                             f"{[(t.status, t.objective) for t in exp.fetch_trials()]}")
    for t, rep in zip(done, reports):
        ms_step = rep["train_s"] / rep["steps"] * 1e3
        log(f"  trial {t.id[:8]} {t.params}: loss {rep['losses'][0]:.4f} -> "
            f"{rep['losses'][-1]:.4f}; {ms_step:.3f} ms/step, "
            f"{rep['tokens_per_step'] / ms_step * 1e3:.0f} tokens/s")
    if not any(rep["losses"][-1] < rep["losses"][0] for rep in reports):
        raise AssertionError("no trial lowered its loss")
    want = ATTN_PER_STEP * STEPS * TRIALS
    log(f"[slice] launches {counts} (want {want} each: {ATTN_PER_STEP} per forward "
        f"for K1 and per train step for K2 and K3, x {STEPS} steps x {TRIALS} trials)")
    if any(c != want for c in counts.values()):
        raise AssertionError(f"launch counts {counts} != {want}")
    warm = reports[-1]
    ms_step = warm["train_s"] / warm["steps"] * 1e3
    log(f"[slice] last trial: {ms_step:.3f} ms/train step, "
        f"{warm['tokens_per_step'] / ms_step * 1e3:.0f} tokens/s "
        f"(batch 32 x (64 src + 64 tgt) tokens); peak memory "
        f"{peak_mem / 2**30:.3f} GiB; card {smi}")

    mark("slice")

    # -- 5. where a train step's time goes (after the counted run) ----------
    breakdown = profile_train_step(torch, tfm)
    if breakdown is not None and not any("flash_fwd_kernel_mma" in r[0]
                                         for r in breakdown["flash"]):
        raise AssertionError("the train step's trace shows no flash_fwd_kernel_mma")

    mark("profile")

    # -- 6. TPE on the card ---------------------------------------------------
    tpe_stats = tpe_phase(torch, smi)
    mark("tpe")

    # -- 7. GP-BO on the card ---------------------------------------------------
    gp_stats = gp_phase(torch, smi)
    mark("gp")

    # -- 8. the hunt CLI --------------------------------------------------------
    hunt_stats = hunt_phase(torch, smi)
    mark("hunt")

    # -- 9. BASELINE config 3: ASHA on ResNet-50 through the CLI ----------------
    asha_stats = asha_phase(torch, smi)
    mark("asha")

    # -- 10. BASELINE config 5: EvolutionES on PPO; Hyperband and BOHB ---------
    t0 = time.perf_counter()
    evolution_stats = evolution_phase(torch, smi)
    evolution_stats["phase_s"] = time.perf_counter() - t0
    log(f"[evolution] phase took {evolution_stats['phase_s']:.1f} s")
    mark("evolution")

    # -- 11. BASELINE config 4: Hyperband and BOHB on Transformer-base --------
    t0 = time.perf_counter()
    wmt_stats = wmt_phase(torch, smi)
    wmt_stats["phase_s"] = time.perf_counter() - t0
    log(f"[wmt] phase took {wmt_stats['phase_s']:.1f} s")
    mark("wmt")

    # -- 12. PBT on Transformer-base through the CLI ---------------------------
    pbt_stats = pbt_phase(torch, smi)
    mark("pbt")

    # -- 13. CMA-ES, DEHB, grid search, gradient descent, MOTPE ----------------
    algos_stats = algos_phase(torch, smi)
    mark("algos")

    # -- 14. the decoder-only LM, MoE, the blocked xent, remat ------------------
    lm_stats = lm_phase(torch, smi)
    mark("lm")
    log(f"[phases] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; total {sum(phase_s.values()):.1f}; card {smi}")

    # rate 0: the [slice] run's launches; with dropout: the [wmt] BOHB run's
    kernels = []
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        for label, row, long_row, launches, err in (
                (name, timing_stats[name], long_stats[name], counts[name], max_err[name]),
                (f"{name} (dropout {WMT_TIMED_RATE})", drop_stats["slice"][name],
                 drop_stats["long"][name], wmt_stats["bohb"]["dropout_launches"][name],
                 wmt_stats["max_abs_err"][name])):
            row, long_row = dict(row), dict(long_row)
            for r in (row, long_row):
                del r["bytes"], r["flops"]
            kernels.append({
                "name": label, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": err, **row, "long": long_row,
            })
        # the LM path (dropout 0.1): launches of its timed and traced steps,
        # and the traced device ms of each kernel there (B 32, S 512, causal)
        lm_step = lm_stats["step"]["plain"]
        kernels[-1]["lm"] = {
            "launches": lm_step["launches"][name],
            "launches_per_step": lm_step["launches_per_step"][name],
            "remat_launches_per_step": lm_stats["step"]["remat"]["launches_per_step"][name],
            "ms_per_step": sum(ms for key, ms, _ in lm_step["flash"] if f"{name}_kernel" in key),
        }
        kernels[-1]["lm"]["ms_per_launch"] = (kernels[-1]["lm"]["ms_per_step"]
                                              / kernels[-1]["lm"]["launches_per_step"])
        kernels[-2]["max_abs_err_by_case"] = case_err[name]
    print(json.dumps({"kernels": kernels, "bwd_over_sdpa": bwd_ratio, "ptxas": ptxas,
                      "phase_s": phase_s,
                      "autograd_max_abs_err": autograd_err, "slice": {
        "ms_per_step": ms_step, "tokens_per_s": warm["tokens_per_step"] / ms_step * 1e3,
        "peak_mem_bytes": peak_mem, "build_s": build_s, "card": smi,
        "profile": breakdown}}), flush=True)
    print(json.dumps({"tpe": tpe_stats}), flush=True)
    print(json.dumps({"gp": gp_stats}), flush=True)
    print(json.dumps({"hunt": hunt_stats}), flush=True)
    print(json.dumps({"asha": asha_stats}), flush=True)
    print(json.dumps({"evolution": evolution_stats}), flush=True)
    print(json.dumps({"wmt": wmt_stats}), flush=True)
    print(json.dumps({"pbt": pbt_stats}), flush=True)
    print(json.dumps({"algos": algos_stats}), flush=True)
    print(json.dumps({"lm": lm_stats}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.exit(rc)
