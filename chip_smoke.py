#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It drives ``metaopt_tpu_torch`` (never JAX, never
``metaopt_tpu``) through twenty-two phases and exits non-zero if any fails.
Before the first it prints a ``{"provenance": {...}}`` line: the port's
``provenance(backend="cuda", card=...)`` stamp (commit, or "unknown" outside
a git checkout; UTC time; the card's name and power limit from
``nvidia-smi``). Every CLI process a phase starts carries a sweep marker of
its own, and after it ends every process with that marker is killed and
counted (``kill_by_env_marker``; 0 on a clean run):

1. build: compiles the flash-attention kernels and TPE's EI scorer
   (``tpe_ei.cu``) from ``metaopt_tpu_torch/csrc``, one ``nvcc`` for each
   source, started together, prints ptxas's registers and spills per
   kernel (and fails if the bf16 K1 ``flash_fwd_kernel_mma`` is missing
   for a head dim, with or without dropout, or ``tpe_ei_kernel`` for one or
   two candidates a lane), counts each bf16 K2 and K3's HGMMA (wgmma)
   instructions in ``cuobjdump -sass`` (and fails if one has none, or if
   one spills at D 64), and prints the card's name and power limit;
2. kernels: holds each kernel (K1 forward, K2 dK/dV, K3 dQ) against its
   plain PyTorch version on the same inputs, at the Transformer's shapes
   (B 32, S 64, H 8, D 64, bf16; padding, causal and cross masks), at
   head dims 32 and 128 (bf16, padding mask), at a ragged multi-tile shape
   (4, 333, 8, 64) in f32 and bf16 with fully masked rows, at a ragged
   cross shape (B 3, Sq 96, Sk 200, H 4, D 64, bf16, broadcast padding
   mask), at the long shape (B 8, S 512, H 8, D 64, bf16, causal) and at
   (B 2, Sq 200, Sk 330, H 4, D 64, bf16) under tril(Sq, Sk), where K1
   skips whole masked K tiles, and at the LM's (B 32, S 512, H 8, D 64,
   bf16, causal in memory) with dropout 0.1; reads every dropout bit K2
   and K3 drew over a causal S 512 launch back through their outputs
   (``keep_bit_probe``) and fails on one that differs from
   ``philox_keep``; times the host's encoding of a K2 or K3 launch's four
   TMA tensor maps; runs ``flash_attention`` forward and
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
   identical winners but in slots whose two best scores tie within 1e-5;
   the ``tpe_ei`` kernel against its plain version on the card on the
   same launches' inputs (scores within 1e-5, winners equal but in such
   tie slots, which it counts), its time, bound and the plain version's
   time at n 16 and 4096, and the kernel alone the same way at n 50,000
   (pads 16384 and 40960); the bound is the largest of the bytes at the
   memory rate, the f32 operations at 67 TFLOP/s and one SFU exponential
   per live term at 16 a clock per SM at ``nvidia-smi``'s maximum SM
   clock; the card's own draws against the CPU generator's by a
   two-sample KS test; then ``build_experiment(algorithm={"tpe": ...})
   .workon`` of BASELINE config 2 (the 4-hparam MLP, full-size trials: 8192
   train and 2048 validation images, batch 256, 3 epochs), 10 random then 6
   EI trials, every EI launch through ``tpe_ei`` (its launches counted over
   the hunt); then the suggest side's times: host ms per EI launch, device
   ms and CUDA kernels per ``tpe_suggest_fused`` (failing if its trace holds
   no ``tpe_ei`` kernel or an ``ndtr`` one) and of its scorer alone,
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
   ``metaopt_tpu_torch/examples/rosenbrock.py`` with 4 workers and 32
   trials (cut from 100 to 50 to pay for phase 17, to 32 for phase 18) — all completed, none broken, none run twice, a finite best, and
   ``status --json`` from another fresh process agreeing; (b) BASELINE
   config 2, TPE (``examples/tpe.yaml``'s settings, passed as JSON) on
   ``metaopt_tpu_torch/examples/mlp_mnist.py``, 2 trials, 1 of them an
   initial point (cut from 16 and 10 to fit the script's time limit),
   each a fresh process on the card — finite, at least 1 suggested by EI,
   in the space,
   each on CUDA — split into process start → first CUDA op, training, and
   the rest of the trial's ledger wall; (c) ``cuda_backend_reachable()``;
9. asha: BASELINE config 3. (a) The full-width ResNet-50 on the card
   against the same weights on the CPU (batch 8, eval and train mode, bf16
   bound); a 3-epoch in-process ``train_and_eval`` at the reference's
   defaults whose mean training loss must fall; 20 timed and 5 traced
   train steps (batch 128): ms per step, images per second, device busy
   share, device ms by kind of kernel, peak memory. (b) ASHA (``asha.json``,
   seed 0, pool 1) on ``metaopt_tpu_torch/examples/resnet_cifar.py`` at
   full width through ``hunt --n-chips 1`` with ``epochs~fidelity(1, 2,
   base=2)`` on 1024 training images (cut from ``fidelity(1, 16, base=4)``
   and 4096 to fit the script's time limit; ``fidelity(1, 3, base=3)`` and
   4 trials until phase 22), 3 trials, each a fresh
   process pinned to the card — all completed and finite, budgets 1 and 2
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
   (``evolution.json``'s seed 0, with population 2 and pool 2 instead of
   10 and 5 to fit the script's time limit; population 4 until PR 13, 3
   until PR 17) on
   ``metaopt_tpu_torch/examples/ppo_atari.py`` through ``hunt --n-chips 1``,
   3 trials (the first generation and one mutant of the second; two whole
   generations of 4 trials until phase 22; the example runs 60), each a fresh process
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
   ``epochs~fidelity(1, 9, base=3)`` at 1 step per epoch (cut from 50, then 2):
   every rung filled, at
   least one point by EI on the card, K1-K3 launched 18 times per train
   step, every launch with dropout. (f) Hyperband (``hyperband.json``) on
   ``metaopt_tpu_torch/examples/transformer_wmt.py --tp 1`` at full width
   through ``hunt --n-chips 1`` with ``epochs~fidelity(1, 2, base=2)`` (cut
   from 1-9 and base 3: 5 trials instead of 22; ``fidelity(1, 3, base=3)``
   and 6 trials until phase 22) at 2 steps per epoch (cut from 50 to
   10 to fit phase 14, to 5 for phase 18, to 2 for phase 21) — all completed and finite on the
   card, the rung table equal to Hyperband replayed over the ledger and to
   ``status --rungs --json`` from a fresh process, every trial's checkpoint
   published and none half-written, no ``torch._dynamo`` in a trial
   process, the GPU registry empty; trials per hour and each trial's
   split: process start -> first CUDA op, setup, training, checkpoint, the
   rest.
12. pbt: PBT (``examples/pbt.yaml``: seed 0, min cohort 3, exploit
   quantile 0.25, pool 2; population cut from 6 to 4) on
   ``metaopt_tpu_torch/examples/transformer_wmt.py --tp 1`` at full width
   through ``hunt --n-chips 1 --ckpt-root``, config 4's priors with
   ``epochs~fidelity(1, 2, base=2)`` (cut from ``fidelity(1, 4, base=2)``)
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
   against CPU at full width, batch 1, 2 layers (depth cut from 6 to fit
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
   seq 512 with the example's priors through ``hunt --n-chips 1``, 1
   trial (a random draw: 10 initial points; cut from 4 to fit phase 15 and
   to 1 to pay for phase 17) — finite, on the card, checkpoints published, the GPU registry
   empty; trials per hour and each trial's split. (f) At the LM's attention
   shape (B 32, S 512, H 8, D 64, bf16, causal, dropout 0.1): K1-K3's bound
   and SDPA's forward and backward times.
15. batched: the batched hunt. (a) The MLP zoo (``models/objectives.py``:
   width 16, 12 SGD steps on 64 points of dimension 8) through
   ``BatchedExecutor`` on the card at pools of 64, 256 and 1024, against the
   CPU on the same draws (f32, TF32 off; 1e-4 relative on the rows whose
   training stays bounded, diverged rows diverged on both): ms per pool
   (synchronized), split into stacking, the objective's call and the rest
   (cohorts, heartbeats, a result per row), trials/s, CUDA kernels per pool
   and the busy share (profiler); 64 trials one at a time through ``InProcessExecutor`` and
   the pool's speed over theirs. (b) A pool of 64 with one NaN row: that
   trial broken, the 63 others completed, one launch. (c) ``python -m
   metaopt_tpu_torch hunt --algo cmaes`` (seed 0, population 64)
   ``--vector-objective mlp --batch-size auto --max-trials 256`` (512
   until phase 22) in one
   fresh process on a ``file:`` ledger, under a shim that records the
   process age at its first CUDA op and each pool's rows: 256 completed,
   the points and pools equal to the batched hunt replayed on the CPU over
   the ledger's objectives, the objectives equal to the CPU batch form
   (the bound of (a)), no ``torch._dynamo`` in the process; its wall and
   trials/s. (d) ``benchmark --task branin --algos random tpe --max-trials
   30 --repetitions 2`` in-process, TPE's EI on the card: the report's
   curves, winner and seconds;
16. ledger: the ledger at sweep scale, all on the card's host except TPE.
   (a) ``g++`` builds the port's ledgerstore engine into
   ``metaopt_tpu_torch/_build/`` (its seconds printed); a bare ``--ledger
   DIR`` resolves to ``NativeFileLedger`` on that library, and ``db test``
   passes on it. (b) BASELINE config 1 (32 Rosenbrock trials, 4 workers)
   through the CLI on the bare path: 32 completed, none run twice,
   ``status`` agreeing, its trials/s beside ``[hunt]``'s on ``file:``; then
   4 processes racing one experiment through register -> reserve ->
   heartbeat -> complete cycles, on ``native:`` (250 cycles each) and on
   ``file:`` (50 each): µs per cycle. (c) ``db load`` of a parent
   of 15,000 completed Rosenbrock trials (numpy draws from a fixed seed),
   then ``hunt --algo tpe --branch-from parent`` with ``y`` narrowed to
   ``uniform(-5, 5)``, 4 trials, 1 worker, in this process: the child's
   observed count equal to a CPU replay of ``TrialAdapter`` over ``db
   dump``, its document at version 2 with ``metadata.branch``, every EI
   launch on the card, TPE's fit (split, weights, bandwidths) card against
   CPU within 1e-5; the warm start's seconds, and host ms, device ms and
   CUDA kernels per EI launch at n ~10k; ``tpe_ei`` launched in the child
   hunt, and held against its plain version on one EI launch's inputs at
   n ~10k, with its time and bound. (d) Transfer priors
   (``metadata.transfer_from``): ``n_prior`` equal to the adapted count,
   the discounted fit card against CPU within 1e-5. (e) 50,000 completed
   trials in a ``MemoryLedger`` with the archive on and off, each in a
   fresh torch-free process: resident bytes per trial and the seconds of
   ``fetch(..., "completed")``; TPE's columnar ``observe`` of the
   ``CompletedBatch``.
17. coord: the coordinator. (a) ``python -m metaopt_tpu_torch serve --port 0
   --ledger memory --snapshot S --uds U --fuse-suggest`` in a fresh
   process, hosting on the card: the seconds from spawn to its ready line
   and the wire negotiated (JSON where ``msgpack`` is absent). (b) BASELINE
   config 1's Rosenbrock objective with ``tpe.json``'s TPE (10 initial
   points) hosted on the coordinator's card: ``hunt --ledger coord://...
   --producer coord``, 4 workers, 32 trials (cut from 48 for phase 18) — each completed once, each
   objective recomputed from its params, the suggestions from the hosted
   algorithm (the workers' ``RemoteProducer`` timings, the server's
   ``produce`` events, its EI suggest calls); trials/s, produce-RPC ms per
   cycle, RPCs per trial (the server's op count) against the reference's
   1.06, coalesced cycles. (c) Once 14 trials have completed, ``kill -9``
   of ``serve`` and a restart on the same snapshot, port and socket; the
   workers resume through session resumption, and every completion
   acknowledged before the kill is there after, once, with its objective;
   the recovery's seconds and the WAL records replayed. (d) In-process,
   ``CoordServer(device="cuda", fuse_suggest=True)``: 64 hosted TPE
   experiments on config 2's space with 192-252 completed trials each (one
   static key, 2 buckets of 32) and 8 hosted GP-BO experiments at n 64-71:
   the bucket launches against the same members' solo launches (CUDA
   kernels, host ms, device ms per bucket and per member), each fused row
   against the member's solo row (winners equal except at f32 ties of
   1e-5), ``tpe_ei`` against its plain version on the bucket launches'
   inputs, its time and bound at a bucket of 32, then one live fuser tick,
   whose TPE buckets must launch ``tpe_ei``. (e) 4 client threads x 64
   ``worker_cycle`` round trips over TCP and over the socket, WAL
   fsync'd: p50 and p99 microseconds.
18. shards: sharded serving. (a) ``python -m metaopt_tpu_torch -v serve
   --shards 2 --snapshot DIR --event-log DIR --fuse-suggest`` with
   ``coordinator.device: cuda``: the seconds from spawn to the ready line
   of the supervisor and of each shard, each shard's pid and device from
   its own ping; after (b) the card's contexts (``nvidia-smi
   --query-compute-apps``): one for each shard and this script, none for
   the supervisor. (b) Two hosted TPE hunts (config 1's Rosenbrock,
   ``tpe.json``), 24 trials and 2 workers each, ``hunt --producer coord``
   under a shim that counts the client's RPCs by address: A on s0 with the
   port's client (every ``worker_cycle`` straight to its shard), B on s1
   as an old client that never reads the ``shard_map`` cap (every RPC
   through the router); trials/s, RPCs a trial, RPCs by route and op, the
   slowest RPCs, each shard's ``produce`` events. (c) Once 10 of A's
   trials have completed, ``python -m metaopt_tpu_torch rebalance`` moves
   A to s1 while its workers go on: every completion acknowledged before
   the move on s1 once, s0 answering ``WrongShardError`` for A, A's hunt
   finishing its 24, s1's TPE holding every shipped completion at its
   first suggest; the hand-off's prepare / apply / commit ms. (d)
   In-process, ``ShardSupervisor(2, failover=True)`` with its shards on
   the card (booted beside (a)): ``kill -9`` of s0 under 4 worker threads
   once 24 of its experiment's completions are acknowledged; no
   acknowledged completion lost, the survivor answering its own
   experiment's calls during the redistribution, ``failover_times``. (e)
   While (a) and (d) boot, ``simulate --workers 1000 --algos asha
   hyperband tpe --seed 0 --json`` twice (the default faults: two
   coordinator crashes), TPE hosted on the card: certified both times,
   wall seconds, events, recovery seconds per 10k WAL records, the two
   digests side by side (the first diverging event if they differ); then
   a TPE-only simulation that reaches EI on the card.
19. web: the read side over [ledger]'s native directory (config 1's 32
   Rosenbrock trials, the 15,000-trial EVC parent, the TPE child) and two
   experiments written here (32 random ZDT1 trials; 8 Rosenbrock lineages
   at fidelity 1, 3, 9). (a) ``python -m metaopt_tpu_torch web`` in a
   fresh process, the surrogate on the card, booting while (b) and (c)
   run. (b) In-process ``make_server(..., device="cuda")``: every route
   (``/``, ``/healthz``, ``/dashboard``, ``/experiments``, each
   experiment's document, completed trials, regret, parallel and workers,
   ``/lcurves``, ``/pareto``, ``/importance`` and ``/pdp`` at n 32, a 404
   and 400s), each status as expected, ms and bytes per route. (c)
   ``ard_importance`` and ``partial_dependence`` (d 2, 24 grid points, 64
   background rows) card against CPU at n 32 and 512 (importance within
   1e-3, the curves within 5e-3 of the objective's std); host ms, device
   ms, CUDA kernels and peak memory per call at n 32 and 4096. (d) The
   same routes from the ``web`` process, each JSON equal to (b)'s (the
   surrogate's within (c)'s bounds, ``/workers`` but for the ages), and
   ``plot regret|lcurve|parallel|importance|pdp|pareto --json``
   in-process equal to the routes; then the process is stopped.
20. analysis: the checkers on the card's host. (a) ``python -m
   metaopt_tpu_torch analyze`` (lint, race's static check and crashcheck's
   static checks over the port's tree) in a subprocess: exit 0, no finding
   beyond the port's (empty) baselines, its seconds. (b) While it runs, the
   two device legs of ``race``'s coord suite at scale 1 on ``cuda``, each
   under its own race runtime (two batched ``workon`` loops sharing one
   ``BatchedExecutor``; the fuser's bucket launches over four hosted TPEs
   racing the RPC threads): no MTR101/MTR102, the events recorded, more
   than 0 bucket launches, each leg's seconds.
21. mesh: one launch of four ranks sharing ``cuda:0`` (``gloo``; NCCL
   refuses two ranks on one device), started by
   ``metaopt_tpu_torch.parallel.launch.RankPool``, runs five legs against
   one-rank runs on the card: (a) full-width Transformer-base (B 32 x S 64)
   on dp 2 x tp 2, 5 steps at dropout 0 (losses within 2e-3 of one rank's
   from the same seeded weights, the CPU test's bound; K1-K3 counted on every rank, 18 launches
   per step each) and 2 at rate 0.1; (b) one causal attention layer at
   (8, 512, 8, 64) under ring and Ulysses sp 2 (x dp 2), forward and
   backward, f32 and bf16, against one-rank ``flash_attention``; (c) the
   full-width LM (B 4 x S 512) on dp 2 x sp 2, then the MoE LM
   (``LM_MOE[0]``) on dp 2 x ep 2, 2 steps each, with the dropped fractions
   equal; (d) ``make_pp_train_step`` at pp 2 x V 2 (x dp 2) against the
   sequential stack; (e) ``start_pod_coordinator`` across the ranks, each
   rank's ``workon`` against it, and ``run_signaled`` stopping every rank at
   the same step. It prints the backend, the ranks per GPU, the
   collectives copied through the host with their bytes, then times K1-K3
   alone at the ranks' shapes (bound and SDPA beside them). Nothing in it is
   a multi-GPU figure: NCCL across separate GPUs is not exercised on a
   machine with one card.
22. sweep: the deadline sweep. (b) ``python -m metaopt_tpu_torch hunt
   --n-chips 1`` under ``run_swept`` with a 25 s deadline; its trial (a
   script written here) starts a grandchild in a session of its own, and
   each holds 1 GiB on the card. The trial, the grandchild and the hunt are
   in three process groups; killing the trial's group (the kill the hunt
   makes on SIGINT, a timeout or a prune) leaves the grandchild alive and
   its GiB held (``torch.cuda.mem_get_info`` here, and the card's contexts
   from ``nvidia-smi --query-compute-apps``). After ``run_swept`` returns:
   rc None, the hunt's output before the deadline kept, every pid of the
   tree gone, ``kill_by_env_marker`` finding 0, the card's contexts as
   before the hunt and free memory within 64 MiB of its value before it.
   (c) Started with (b), ``run_many_with_deadline`` over two CUDA probes
   that print the card's name and a sleeper past the 20 s shared deadline:
   return codes 0, 0 and None, every teed line under its ``[label] ``, the
   sleeper's tail kept. (b) holds its checks until the probes are gone.

It prints a ``{"kernels": [...]}`` line (K1-K3 and ``tpe_ei``), a ``{"tpe": {...}}`` line, a
``{"gp": {...}}`` line, a ``{"hunt": {...}}`` line, an ``{"asha": {...}}``
line, an ``{"evolution": {...}}`` line, a ``{"wmt": {...}}`` line, a
``{"pbt": {...}}`` line, an ``{"algos": {...}}`` line, an ``{"lm": {...}}``
line, a ``{"batched": {...}}`` line, a ``{"ledger": {...}}`` line, a
``{"coord": {...}}`` line, a ``{"shards": {...}}`` line, a ``{"web":
{...}}`` line, an ``{"analysis": {...}}`` line, a ``{"mesh": {...}}`` line, a
``{"sweep": {...}}`` line and, last,
the ``{"ok": true, "device": {...}}`` line. The
``{"kernels": ...}`` line lists K1-K3 at rate 0 (launches from the [slice]
run) and at rate 0.1 (times from phase 2, launches from the [wmt] BOHB
run; under ``"lm"`` the launches and device ms on the LM's path, with the
bound and SDPA's time at the LM's shape; under ``"mesh"`` the launches of
``[mesh]``'s leg (a) on all ranks and the kernel's time, bound and SDPA's
at the ranks' shapes) and ``tpe_ei``, its launches summed over [tpe]'s
hunt, [ledger]'s child hunt and [coord] (d)'s tick (each counted from 0
just before that run), its times at the [ledger] shape (n ~10k), under
``"shapes"`` at every shape it was timed (with its cluster size and CTAs),
and its ptxas registers and spills.
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
# config 2 through the CLI: cut from 16 trials (10 random, 6 by EI) to 5
# (4 random, 1 by EI), then to 3 (2 random, 1 by EI) to pay for phase 17,
# and to 2 (1 random, 1 by EI) for phase 19; the in-process hunt of [tpe]
# keeps its 16 with tpe.yaml's 10 initial points
HUNT_TPE_TRIALS, HUNT_TPE_INITIAL = 2, 1
# BASELINE config 1 through the CLI ([hunt] on file:, [ledger] on the native
# engine): cut from 100 trials to 50 to pay for phase 17, and to 32 to pay
# for phase 18
ROSEN_TRIALS, ROSEN_WORKERS = 32, 4
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
# config 3 through the CLI, cut to fit the script's time limit: epochs
# fidelity(1, 2, base=2) instead of the example's (1, 16, base=4) (fidelity(1,
# 3, base=3) until phase 22), and 1024 training images (8 steps per epoch)
# instead of 4096 (32)
ASHA_FIDELITY, ASHA_BUDGETS, ASHA_N_TRAIN = "fidelity(1, 2, base=2)", (1, 2), 1024
# the fewest trials with which ASHA (one worker, pool 1) reaches budget 2
# whatever the objectives: 2 at 1 epoch, then 1 promoted to 2 (the example
# runs 64; at asha.json's pool of 4 one worker never reaches the top, see
# examples/resnet_cifar.py)
ASHA_TRIALS = 3
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
# evolution.json's EvolutionES (seed 0) at population 2 and pool 2 (cut from
# 10 and 5 to fit the script's time limit, from population 4 to 3 in PR 13 to
# pay for phase 17, and to 2 to pay for phase 21): 2 trials at 2 iterations,
# then the first mutant of the second generation at 4 (its second mutant cut
# to pay for phase 22; the example runs 60)
EVOLUTION_TRIALS, POPULATION, EVOLUTION_POOL = 3, 2, 2
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
# fidelity(1, 3, base=3) (6 trials), then to fidelity(1, 2, base=2) to pay
# for phase 22: bracket 0 runs 2 trials at 1 epoch and promotes 1 to 2,
# bracket 1 runs 2 at 2 epochs; (bracket, budget, capacity) below
WMT_CLI_FIDELITY, WMT_CLI_TABLE = "fidelity(1, 2, base=2)", [(0, 1, 2), (0, 2, 1), (1, 2, 2)]
WMT_CLI_BUDGETS = (1, 2)
# ... and from 50 steps per epoch to 10, to fit the [lm] phase, then to 5 to
# pay for phase 18, then to 2 to pay for phase 21
WMT_CLI_TRIALS, WMT_STEPS_PER_EPOCH = 5, 2
# a config-4 trial's wall-clock timeout, and its share of the CLI's deadline
WMT_TIMEOUT_S, WMT_TRIAL_S = 300, 60
# BOHB in-process: the example's fidelity, one repetition of 22 trials (cut
# from two to fit the [lm] phase), cut from 50 steps per epoch to 2, and to 1
# to fit the [analysis] phase
WMT_BOHB_FIDELITY, WMT_BOHB_STEPS_PER_EPOCH = "fidelity(1, 9, base=3)", 1
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
# PBT (examples/pbt.yaml: seed 0, min_cohort 3, exploit quantile 0.25, pool 2)
# on Transformer-base through the CLI over config 4's priors, at 10 steps per
# epoch (cut from 50). The population is cut from 6 to 4 and the ladder from
# 1, 2 and 4 epochs to 1 and 2, to pay for phase 22: 8 trials, all of them
# PBT's whole run (4 members x 2 rungs), in place of 12 of 18
PBT_PRIORS = {**WMT_PRIORS, "epochs": "fidelity(1, 2, base=2)"}
PBT_STEPS_PER_EPOCH = 10
PBT_POPULATION = 4
# 8 trials hold an exploit continuation, found by the port's PBT replayed on
# the CPU over the card's losses: the first 4 members are the first 4 points
# the 6-member runs drew (the same seed and sampler), whose 1-epoch losses
# 120.04, 138.75, 122.12 and 143.33 were bit-equal in every run on the card
# (fixed by the seeds of init, data and dropout). The 4th member finishes
# last of its rung and worst of a cohort of 4, so the 8th trial, its
# continuation, takes the best member's weights. Were the 4th not the worst,
# no exploit would come (12 of the 24 orders of those losses hold one).
PBT_TRIALS = 8
PBT_TRIAL_S = 60        # a trial's share of the CLI's deadline
MOTPE_YAML = {"seed": 0, "n_objectives": 2, "n_initial_points": 12, "gamma": 0.3}
MOTPE_TRIALS = 24
LM_BATCH, LM_SEQ = 32, 512      # train_lm's batch at the phase's sequence: 16,384 tokens
# card against CPU (the CPU runs the plain attention): full width, depth
# cut from 6 to 2 layers to fit the script's time limit, batch cut from 2
# to 1 to pay for phase 19 (every bound held at batch 1 on the H100:
# routers 1.03e-2 at worst against 5e-2, gradient norms 1.18e-3)
LM_CMP_BATCH, LM_CMP_LAYERS = 1, 2
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
# with 10 initial points, a random draw of TPE's (cut from 4 to 2 to fit phase
# 15, then to 1 in PR 13 to pay for phase 17)
LM_CLI_TRIALS, LM_TRIAL_S = 1, 60
BATCHED_POOLS = (64, 256, 1024)   # pools of the MLP zoo timed through BatchedExecutor
# the zoo's losses, card against CPU on the same draws (f32, TF32 off), relative,
# on rows whose training stays bounded (CPU loss <= BATCHED_DIVERGED): past
# that, 12 steps at lr near 1 blew the loss up and f32 rounding decides the
# trajectory (the reference's own per-trial and vmapped forms differ by up to
# 41% there); such rows are held to having diverged on the card too (>= 10)
BATCHED_TOL, BATCHED_DIVERGED = 1e-4, 100.0
# 4 CMA-ES generations through the CLI (8 until phase 22)
BATCHED_CLI_TRIALS, BATCHED_POPULATION = 256, 64
# a benchmark study in-process; 30 trials, since TPE's default 20 initial
# points would leave 20 with no EI launch on the card
LEDGER_PROCS = 4        # processes racing one experiment in the engine benchmark
LEDGER_CYCLES = 250     # register -> reserve -> heartbeat -> complete cycles per process
LEDGER_FILE_CYCLES = 50   # the same on file:
LEDGER_CYCLE_TIMEOUT_S = 240
LEDGER_PARENT = 15000   # completed Rosenbrock trials of the EVC parent
LEDGER_SEED = 12
LEDGER_CHILD_TRIALS = 4
ARCHIVE_ROWS = 50_000   # completed trials in the archive's memory check
BENCH_TRIALS = 30
BENCH_ARGS = ["--task", "branin", "--algos", "random", "tpe", "--max-trials",
              str(BENCH_TRIALS), "--repetitions", "2", "--json"]
REPLACES = {
    "flash_fwd": "metaopt_tpu/ops/attention.py:77 (_flash_fwd_kernel)",
    "flash_bwd_dkv": "metaopt_tpu/ops/attention.py:181 (_flash_bwd_dkv_kernel)",
    "flash_bwd_dq": "metaopt_tpu/ops/attention.py:238 (_flash_bwd_dq_kernel)",
    "tpe_ei": "metaopt_tpu/ops/tpe_math.py:67 (_truncnorm_mixture_logpdf_1d, vmapped :86-89, "
              "in ei_scores :94 and the winner pick :342-350; XLA, not Pallas)",
}
TPE_EI_SOURCE = "metaopt_tpu_torch/csrc/tpe_ei.cu"
# f32 operations per (candidate, live component, continuous column) of the
# EI scorer: one exponential and ~10 others (z, z*z/2, four adds, the
# log-sum-exp's compare and add)
TPE_EI_OPS = 11
# the exponentials of those terms run on the SFU: 16 a clock on each SM
SFU_EXP_PER_CLOCK_PER_SM = 16
# kernels per EI launch before the tpe_ei kernel, as PERF.md §6 records
# them: at n 16 and 4096, at n ~10k, per bucket of 32
TPE_EI_KERNELS_BEFORE = {"tpe": "254-273", "ledger": "285", "coord": "~384 a bucket of 32"}
# the EI scorer alone at the 50,000-trial scale (pads 16384 good, 40960 bad)
TPE_EI_BIG_N = 50_000


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flash_kernel_name(line: str):
    """"flash_fwd_kernel_mma<64, true>" from a ptxas "Compiling entry
    function" line of flash_attention.cu, or None."""
    m = re.search(r"'_Z\w*?\d+(flash_\w+?)I\w*?Li(\d+)ELb([01])E", line)
    return (f"{m.group(1)}<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>"
            if m else None)


def tpe_ei_kernel_name(line: str):
    """"tpe_ei_kernel<1>" from a ptxas "Compiling entry function" line of
    tpe_ei.cu, or None."""
    m = re.search(r"tpe_ei_kernelILi(\d+)E", line)
    return f"tpe_ei_kernel<{m.group(1)}>" if m else None


def ptxas_summary(text: str, kernel_name=flash_kernel_name):
    """{kernel: registers and spill bytes} from ``nvcc -Xptxas=-v`` output:
    each "Compiling entry function" line names a kernel by its mangled name
    (``kernel_name`` reads it), and the "spill" and "Used N registers" lines
    after it belong to it."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = kernel_name(line)
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


def sass_hgmma(lib: Path):
    """{kernel: HGMMA instructions in its SASS} of flash_attention.cu's
    library, from ``cuobjdump -sass`` (next to nvcc): the proof that a
    kernel's products run on wgmma."""
    from metaopt_tpu_torch.utils import cuda_build

    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = flash_kernel_name("'" + line.split("Function :")[1].strip())
            if cur:
                out[cur] = 0
        elif cur and "HGMMA" in line:
            out[cur] += 1
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
    elif kind == "lm":                          # the LM's: causal, no pad, (b, q, k) in memory
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))[None].expand(
            b, sq, sk).contiguous()
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


def keep_bit_probe(torch, att, b: int = 2, s: int = 512, h: int = 2,
                   rate: float = WMT_TIMED_RATE):
    """K2's and K3's dropout bits, read back through their outputs over a
    causal (b, s, s) launch and held bit for bit against ``philox_keep``.

    Q = 0 and lse = 0 make p = 1 on every pair the mask keeps. K2 with dO
    one-hot by query row within Q tile t gives dV[key c, i] = keep(64 t + i,
    c) / keep_prob; K3 with dO = V = e_0 (so dP = 1), delta = 0 and K one-hot
    by key within K tile t gives dQ[query r, i] = keep(r, 64 t + i) /
    keep_prob. One launch of each kernel per tile t (D = 64 = the tile).
    Every nonzero output must also be 1 / keep_prob to bf16. Returns wrong
    bits and bits read per kernel; these launches do not count."""
    dev, bf, tile = "cuda", torch.bfloat16, 64
    saved = dict(att.launches), dict(att.dropout_launches)
    drop = dict(dropout_rate=rate, seed=DROPOUT_SEED, offset=DROPOUT_OFFSET)
    gen = torch.Generator(device=dev).manual_seed(23)
    zeros = torch.zeros(b, s, h, tile, dtype=bf, device=dev)
    noise = torch.randn(b, s, h, tile, generator=gen, device=dev).to(bf)
    lse = torch.zeros(b, h, s, device=dev)
    delta = torch.zeros(b, h, s, device=dev)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
    mask = causal.to(torch.int8)[None].expand(b, s, s).contiguous()
    want = att.philox_keep(DROPOUT_SEED, DROPOUT_OFFSET, range(b * h), range(s), range(s),
                           rate, device=dev) & causal
    eye = torch.eye(tile, dtype=bf, device=dev)[None, :, None, :]   # (1, i, 1, d)
    e0 = zeros.clone()
    e0[..., 0] = 1
    scale = torch.tensor(1.0 / att.keep_prob(rate)).to(bf).float().item()
    got = {"flash_bwd_dkv": torch.zeros_like(want), "flash_bwd_dq": torch.zeros_like(want)}
    bad_value = {n: 0 for n in got}
    for t in range(s // tile):
        rows = slice(t * tile, (t + 1) * tile)
        g = zeros.clone()
        g[:, rows] = eye                                 # query 64 t + i -> column i
        _, dv = att.flash_bwd_dkv(zeros, noise, noise, g, lse, delta, mask, **drop)
        kt = zeros.clone()
        kt[:, rows] = eye                                # key 64 t + i -> column i
        dq = att.flash_bwd_dq(zeros, kt, e0, e0, lse, delta, mask, **drop)
        for name, out, view in (
                ("flash_bwd_dkv", dv, lambda o: o.permute(0, 2, 3, 1).reshape(b * h, tile, s)),
                ("flash_bwd_dq", dq, lambda o: o.permute(0, 2, 1, 3).reshape(b * h, s, tile))):
            o = view(out.float())
            nz = o != 0
            bad_value[name] += int((nz & ((o - scale).abs() > 1e-2 * scale)).sum())
            if name == "flash_bwd_dkv":
                got[name][:, rows, :] = nz
            else:
                got[name][:, :, rows] = nz
    torch.cuda.synchronize()
    att.launches.update(saved[0])
    att.dropout_launches.update(saved[1])
    res = {n: {"wrong_bits": int((got[n] != want).sum()), "kept_bits": int(want.sum()),
               "bits_read": b * h * s * (s + 1) // 2, "wrong_values": bad_value[n]}
           for n in got}
    for n, r in res.items():
        log(f"  keep-bit probe {n}: {r['wrong_bits']} wrong of {r['bits_read']} causal bits "
            f"({r['kept_bits']} kept; (b, s, h) = ({b}, {s}, {h}), rate {rate}); "
            f"{r['wrong_values']} kept outputs off 1/keep_prob")
    if any(r["wrong_bits"] or r["wrong_values"] for r in res.values()):
        raise AssertionError(f"keep-bit probe: {res}")
    return res


def time_case(torch, att, case, lse_delta, rate: float = 0.0):
    """Per kernel: its time, its bound, the plain version's and SDPA's
    (with ``dropout_p=rate``). The bound counts the matrix products'
    operations over the pairs the mask keeps; dropout's Philox rounds are
    integer work outside it."""
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
    # the products' work is what this mask needs: its kept (query, key)
    # pairs, per head (a causal mask keeps about half of sq * sk)
    pairs = int((m != 0).sum()) * h
    work = {
        "flash_fwd": (
            lambda: att.flash_fwd(q, k, v, m, **drop),
            lambda: att.flash_fwd_plain(q, k, v, m, **drop),
            4 * q.numel() * esz + mask_b + row_f32,           # q k v o, mask, lse
            4.0 * pairs * d),
        "flash_bwd_dkv": (
            lambda: att.flash_bwd_dkv(q, k, v, g, lse, delta, m, **drop),
            lambda: att.flash_bwd_dkv_plain(q, k, v, g, lse, delta, m, **drop),
            6 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dk dv
            8.0 * pairs * d),
        "flash_bwd_dq": (
            lambda: att.flash_bwd_dq(q, k, v, g, lse, delta, m, **drop),
            lambda: att.flash_bwd_dq_plain(q, k, v, g, lse, delta, m, **drop),
            5 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dq
            6.0 * pairs * d),
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
    for name, (kern, plain_fn, nbytes, flops) in work.items():
        ms, src, ev = device_ms(torch, kern, match=name + "_kernel")
        plain_ms, plain_src, plain_ev = device_ms(torch, plain_fn, n=10)
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


def profile_calls(torch, fn, n: int = 10, names=None):
    """(host ms per call, device ms per call, CUDA kernels per call) of
    ``fn``: host time around ``n`` synchronized calls untraced, device
    time and kernel count from torch.profiler over ``n`` more; the traced
    kernels' names are appended to ``names`` when it is a list."""
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
        if names is not None:
            names.extend(r[0] for r in rows)
    except Exception as err:  # the profiler is a measurement aid only
        log(f"  (torch.profiler unavailable: {type(err).__name__}: {err})")
        dev_ms, kernels = None, None
    return host_ms, dev_ms, kernels


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


# ---------------------------------------------------------------------------
# the tpe_ei kernel (TPE's EI scorer) against its plain version, in the
# phases that already build its shapes: [tpe], [ledger], [coord] (d)


def capture_ei(P, run):
    """(the (args, kwargs) of every ``ei_argmax`` call ``run()`` makes,
    ``run()``'s result)."""
    calls, real = [], P.ei_argmax

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    P.ei_argmax = spy
    try:
        out = run()
    finally:
        P.ei_argmax = real
    return calls, out


def ei_tie_slots(torch, scores, n_out: int, n_cand: int):
    """(B, n_out) bool: slots whose two best scores lie within TPE_TOL of
    each other (rtol and atol), where the winner may go either way."""
    top = scores.reshape(scores.shape[0], n_out, n_cand).topk(min(2, n_cand), dim=2).values
    if n_cand < 2:
        return torch.zeros(top.shape[:2], dtype=torch.bool, device=scores.device)
    return (top[..., 0] - top[..., 1]).abs() <= TPE_TOL + TPE_TOL * top[..., 1].abs()


def ei_check(torch, P, call, tag: str):
    """The kernel against ``ei_argmax_plain`` on the card, on one call's
    inputs: scores within TPE_TOL and the same NaN and -inf pattern, and
    winners equal except in tie slots. These launches are not counted."""
    (fit, cand, nch, cont), kw = call
    saved = P.launches["tpe_ei"]
    ks, kwin = P.ei_argmax(fit, cand, nch, cont, **kw)
    ps, pwin = P.ei_argmax_plain(fit, cand, nch, cont, **kw)
    torch.cuda.synchronize()
    P.launches["tpe_ei"] = saved
    fin = torch.isfinite(ps)
    if not (torch.equal(torch.isnan(ks), torch.isnan(ps))
            and torch.equal(torch.isinf(ks) & (ks < 0), torch.isinf(ps) & (ps < 0))):
        raise AssertionError(f"[{tag}] tpe_ei: the NaN/-inf pattern differs from the plain version")
    err = float((ks[fin] - ps[fin]).abs().max()) if fin.any() else 0.0
    if not torch.allclose(ks[fin], ps[fin], rtol=TPE_TOL, atol=TPE_TOL):
        raise AssertionError(f"[{tag}] tpe_ei: scores off the plain version's by {err:.3e}")
    ties = ei_tie_slots(torch, ps, kw["n_out"], kw["n_cand"])
    differ = kwin != pwin
    untied = int((differ & ~ties).sum())
    if untied:
        raise AssertionError(f"[{tag}] tpe_ei: {untied} slot(s) pick another winner than the "
                             f"plain version without a tie")
    return {"max_abs_err": err, "slots": differ.numel(), "tie_slots": int(ties.sum()),
            "winners_differ_in_ties": int(differ.sum())}


def ei_work(torch, call):
    """(bytes, operations, exponentials) of one ``ei_argmax`` call: each
    input read once and each output written once; the terms these inputs
    need, member by member: candidates x live (finite-weight) components x
    continuous columns, each one exponential and TPE_EI_OPS f32
    operations."""
    (fit, cand, nch, cont), kw = call
    B, C, _ = cand.shape
    nbytes = sum(t.numel() * t.element_size() for t in (cand, *fit, nch, cont))
    nbytes += B * C * 4 + B * kw["n_out"] * 8
    live = (torch.isfinite(fit.g_logw[:, :, 0]).sum(1) + torch.isfinite(fit.b_logw[:, :, 0]).sum(1))
    terms = float((live * cont.sum(1)).sum()) * C
    return nbytes, terms * TPE_EI_OPS, terms


def sfu_exp_per_s(torch) -> tuple:
    """(exponentials a second on the card's SFUs, SM clock MHz): 16 a clock
    per SM at the card's maximum SM clock (``nvidia-smi
    --query-gpu=clocks.max.sm``) on all its SMs."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6, mhz


def ei_times(torch, P, call, label: str):
    """The kernel's device ms (profiler, its own launches), the plain
    version's and the bound, on one call's inputs. Not counted. The bound
    is the largest of the call's bytes at the memory rate, its f32
    operations at 67 TFLOP/s and its exponentials at the SFUs' rate."""
    (fit, cand, nch, cont), kw = call
    saved = P.launches["tpe_ei"]
    ms, src, _ = device_ms(torch, lambda: P.ei_argmax(fit, cand, nch, cont, **kw), n=20,
                           match="tpe_ei")
    plain, _, _ = device_ms(torch, lambda: P.ei_argmax_plain(fit, cand, nch, cont, **kw), n=20)
    P.launches["tpe_ei"] = saved
    nbytes, ops, exps = ei_work(torch, call)
    rate, mhz = sfu_exp_per_s(torch)
    bounds = {"bytes": nbytes / HBM_BYTES_S * 1e3,
              "f32 operations": ops / PEAK_FLOPS["float32"] * 1e3,
              "sfu exponentials": exps / rate * 1e3}
    by = max(bounds, key=bounds.get)
    B, C, d = cand.shape
    shape = P.ei_launch_shape(fit.g_mu.shape[1], fit.b_mu.shape[1], kw["n_cand"])
    return {"shape": f"{label}: B {B}, C {C} ({kw['n_out']} x {kw['n_cand']}), d {d}, "
                     f"Ng {fit.g_mu.shape[1]}, Nb {fit.b_mu.shape[1]}, "
                     f"kmax {fit.g_cat.shape[2]}",
            "ms": ms, "ms_source": src, "plain_ms": plain, "bound_ms": bounds[by],
            "bound_by": "bytes" if by == "bytes" else "operations", "bound_set_by": by,
            "library_ms": None, "bytes": nbytes, "flops": ops, "exponentials": exps,
            "sm_clock_mhz": mhz, "cluster": shape.cluster, "warps": shape.warps,
            "ctas": B * kw["n_out"] * shape.cluster}


def ei_cluster_choice(torch, P, call, label: str, smi: str):
    """The kernel at clusters of 8 (the wrapper's cap) and of 16 on one
    call's inputs: device ms of each (checked against the plain version
    first), and how many clusters of each the card holds at once
    (``cudaOccupancyMaxActiveClusters``). Not counted."""
    (fit, cand, nch, cont), kw = call
    ng, nb, d = fit.g_mu.shape[1], fit.b_mu.shape[1], cand.shape[2]
    lib, cap, row = P.build_kernel(), P._EI_MAX_CLUSTER, {}
    try:
        for cluster in (8, 16):
            P._EI_MAX_CLUSTER = cluster
            shape = P.ei_launch_shape(ng, nb, kw["n_cand"])
            ei_check(torch, P, call, "tpe")
            saved = P.launches["tpe_ei"]
            ms, src, _ = device_ms(torch, lambda: P.ei_argmax(fit, cand, nch, cont, **kw),
                                   n=20, match="tpe_ei")
            P.launches["tpe_ei"] = saved
            row[cluster] = {"ms": ms, "ms_source": src, "warps": shape.warps,
                            "active_clusters": lib.tpe_ei_max_active_clusters(
                                d, ng, nb, shape.cluster, shape.k, shape.warps)}
    finally:
        P._EI_MAX_CLUSTER = cap
    log(f"[tpe] tpe_ei at {label} in clusters of 8: {row[8]['ms']:.4f} ms, "
        f"{row[8]['active_clusters']} clusters resident at once; of 16: "
        f"{row[16]['ms']:.4f} ms, {row[16]['active_clusters']}; card {smi}")
    return row


def log_ei(tag: str, check, times, kernels, host_ms, dev_ms, smi: str) -> None:
    log(f"[{tag}] tpe_ei at {times['shape']}: {times['ms']:.4f} ms ({times['ms_source']}) "
        f"on {times['ctas']} CTAs (clusters of {times['cluster']}) against its bound "
        f"{times['bound_ms']:.3g} ms (set by {times['bound_set_by']}, SM clock "
        f"{times['sm_clock_mhz']:.0f} MHz) and the plain "
        f"version's {times['plain_ms']:.4f} ms; library — (no single PyTorch call); scores "
        f"max |kernel - plain| {check['max_abs_err']:.3e} (tol {TPE_TOL}), {check['tie_slots']} "
        f"tie slot(s) of {check['slots']}, winners differing in them "
        f"{check['winners_differ_in_ties']}; "
        + ("the kernel alone; " if kernels is None else
           f"per EI launch {kernels} CUDA kernels (before the kernel: "
           f"{TPE_EI_KERNELS_BEFORE[tag]}), host {host_ms:.3f} ms, device {dev_ms} ms; ")
        + f"card {smi}")


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
    agree, ei_calls = {}, {}
    for n in (16, 4096):
        case = tpe_case(np, n, seed=n)
        calls_c, (fit_c, win_c, _) = capture_ei(
            P, lambda: tpe_on(torch, np, P, ObservationBuffer, case, "cuda"))
        calls_h, (fit_h, win_h, _) = capture_ei(
            P, lambda: tpe_on(torch, np, P, ObservationBuffer, case, "cpu"))
        ei_calls[n] = calls_c
        errs = {}
        for name, a, b in zip(P.TPEFit._fields, fit_c, fit_h):
            a = a.cpu()
            if not torch.equal(torch.isinf(a), torch.isinf(b)):
                raise AssertionError(f"[tpe] n {n}: {name} -inf pattern differs")
            fin = torch.isfinite(b)
            errs[name] = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
            if not torch.allclose(a[fin], b[fin], rtol=TPE_TOL, atol=TPE_TOL):
                raise AssertionError(f"[tpe] n {n}: {name} off by {errs[name]:.3e}")
        # the card's kernel and the CPU's plain version may split a slot
        # whose two best scores tie within TPE_TOL, and no other
        ties = torch.cat([ei_tie_slots(torch, P.ei_argmax_plain(*a, **k)[0], k["n_out"],
                                       k["n_cand"])[0] for a, k in calls_h])
        rows = (win_c.cpu() != win_h).any(dim=1)
        same = not bool(rows.any())
        agree[n] = {"fit_max_abs_err": max(errs.values()), "winners_identical": same,
                    "winners_differ_in_ties": int(rows.sum()), "tie_slots": int(ties.sum()),
                    "winners_max_abs_diff": float((win_c.cpu() - win_h).abs().max())}
        log(f"[tpe] card vs cpu, n {n} (+3 pending): fit max |diff| "
            f"{max(errs.values()):.3e} (tol {TPE_TOL}); winners identical: {same} "
            f"({int(rows.sum())} differ, in {int(ties.sum())} tie slot(s) of {len(ties)})")
        if bool((rows & ~ties).any()):
            raise AssertionError(f"[tpe] n {n}: the card's winners differ from the CPU's "
                                 f"outside a tie")
    out["card_vs_cpu"] = agree
    # -- the tpe_ei kernel against its plain version on the card -------------
    ei_check_rows = {n: [ei_check(torch, P, c, "tpe") for c in calls] for n, calls in
                     ei_calls.items()}
    ei_time_rows = {n: ei_times(torch, P, calls[0], f"n {n}") for n, calls in ei_calls.items()}
    # the kernel alone at the 50,000-trial scale that [ledger]'s archive
    # holds: one fit's two pools on the card, against the plain version
    big = tpe_case(np, TPE_EI_BIG_N, seed=50)
    calls_big, _ = capture_ei(P, lambda: tpe_on(torch, np, P, ObservationBuffer, big, "cuda"))
    chk_big = [ei_check(torch, P, c, "tpe") for c in calls_big]
    ei_check_rows[TPE_EI_BIG_N] = chk_big
    ei_time_rows[TPE_EI_BIG_N] = ei_times(torch, P, calls_big[0], f"n {TPE_EI_BIG_N} + 3")
    # why the wrapper stops at clusters of 8
    cluster_choice = {n: ei_cluster_choice(torch, P, c, f"n {n}", smi)
                      for n, c in ((4096, ei_calls[4096][0]), (TPE_EI_BIG_N, calls_big[0]))}
    del big, calls_big

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
    P.reset_launch_counts()
    stats = exp.workon(objective, algorithm=algo)
    algo.drain_suggest_ahead()
    torch.cuda.synchronize()
    ei_launches = P.launches["tpe_ei"]
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
    if ei_launches < 1:
        raise AssertionError("[tpe] the hunt's EI launches never ran the tpe_ei kernel")
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
        "best": min(t.objective for t in done), "tpe_ei_launches": ei_launches,
    }
    log(f"[tpe] hunt: tpe_ei launched {ei_launches} times")

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
        names = []
        call_host, call_dev, call_kernels = profile_calls(
            torch, lambda: P.tpe_suggest_fused(*args, **kw).cpu(), names=names)
        if names and (not any("tpe_ei" in k for k in names) or any("ndtr" in k for k in names)):
            raise AssertionError(f"[tpe] n {n}: the EI launch's kernels are not the tpe_ei "
                                 f"kernel's path: {sorted(set(names))}")
        fit = P._batched(P._tpe_fit(*args[:3], args[5], *args[7:], kmax=kw["kmax"],
                                    equal_weight=kw["equal_weight"], n_good_pad=g_pad,
                                    n_bad_pad=b_pad))
        nch, cont = args[5][None], args[6][None]
        cand = P._sample_rows(fit, [t[None] for t in P.pool_draws(0, 0, 8 * kw["n_cand"], 4,
                                                                   "cuda")],
                              nch, cont, kw["kmax"])
        saved = P.launches["tpe_ei"]
        sc_host, sc_dev, sc_kernels = profile_calls(
            torch, lambda: P.ei_argmax(fit, cand, nch, cont, n_out=8, n_cand=kw["n_cand"]))
        P.launches["tpe_ei"] = saved
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
            f"scorer (tpe_ei) device {sc_dev} ms in {sc_kernels} kernels; card {smi}")
    out["sizes"] = sizes
    ei = {"launches": ei_launches}
    for n in (16, 4096, TPE_EI_BIG_N):
        chk = {"max_abs_err": max(c["max_abs_err"] for c in ei_check_rows[n]),
               **{k: sum(c[k] for c in ei_check_rows[n])
                  for k in ("slots", "tie_slots", "winners_differ_in_ties")}}
        if n == TPE_EI_BIG_N:  # the kernel alone: no EI launch timed at this n
            ei[f"n{n}"] = {**ei_time_rows[n], **chk}
            log_ei("tpe", chk, ei_time_rows[n], None, None, None, smi)
            continue
        st = sizes[n]
        ei[f"n{n}"] = {**ei_time_rows[n], **chk, "kernels_per_ei_launch": st["fused_cuda_kernels"],
                       "launch_host_ms": st["launch_host_ms_median"],
                       "launch_device_ms": st["fused_device_ms"]}
        log_ei("tpe", chk, ei_time_rows[n], st["fused_cuda_kernels"],
               st["launch_host_ms_median"], st["fused_device_ms"], smi)
    ei["clusters_8_vs_16"] = cluster_choice
    out["tpe_ei"] = ei
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


#: (command, processes the marker sweep killed) for every run_cli call
CLI_SWEEPS = []


def run_cli(args, root: Path, env, trials: int = 0, workers: int = 1, trial_s: float = 0.0):
    """``python -m metaopt_tpu_torch ARGS`` in a fresh process: (parsed
    JSON stdout, wall s). Its deadline is ``HUNT_START_S`` plus
    ``trial_s`` for each of the ``trials`` a worker of ``workers`` runs. On
    the deadline the hunt gets SIGINT (it kills its trial's process group
    and marks the trial interrupted), then SIGKILL. Then, deadline or not,
    every process that carries the call's own ``MTPU_SWEEP_MARKER`` is
    killed (``kill_by_env_marker``): a trial's children that started a
    session of their own escape both signals and would keep their CUDA
    context into the next phase. The count is logged; on a clean run it
    is 0."""
    from metaopt_tpu_torch.utils.procs import kill_by_env_marker, with_sweep_marker

    deadline_s = HUNT_START_S + trial_s * math.ceil(trials / workers)
    marker = f"chip-smoke-cli-{os.getpid()}-{time.time_ns()}"
    env = with_sweep_marker(env, marker)
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
        swept = kill_by_env_marker(marker)
        wall = time.perf_counter() - t0
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    CLI_SWEEPS.append((" ".join(args[:3]), swept))
    log(f"[cli] {' '.join(args[:3])}: rc {rc}, the marker sweep killed {swept} processes")
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
        cfg = root / "tpe.json"   # examples/tpe.yaml's settings, fewer initial points
        cfg.write_text(json.dumps({"algorithm": {"tpe": {
            "seed": 0, "n_initial_points": HUNT_TPE_INITIAL}}}))
        summary, wall = run_cli(
            ["hunt", "-n", "mlp", "--ledger", ledger, "--max-trials", str(HUNT_TPE_TRIALS),
             "--config", str(cfg), str(examples / "mlp_mnist.py")]
            + [f"--{k}~{v}" for k, v in TPE_SPACE.items()], root, env, HUNT_TPE_TRIALS, 1,
            MLP_TRIAL_S)
        trials = FileLedger(str(root / "ledger")).fetch("mlp")
        done = sorted((t for t in trials if t.status == "completed"), key=lambda t: t.start_time)
        space = build_space(TPE_SPACE)
        switch = sorted(t.end_time for t in done)[HUNT_TPE_INITIAL - 1] \
            if len(done) >= HUNT_TPE_INITIAL else math.inf
        by_ei = [t for t in trials if t.submit_time > switch]
        name = torch.cuda.get_device_name(0)
        stats = [statistics_of(t) for t in done]
        problems = []
        if len(done) != HUNT_TPE_TRIALS or not all(math.isfinite(t.objective) for t in done):
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if len(by_ei) < HUNT_TPE_TRIALS - HUNT_TPE_INITIAL:
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
                t.params["epochs"] == 1 or (t.lineage, t.params["epochs"] // ASHA_BUDGETS[1])
                in lineages)
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
        log(f"[asha] config 3: {len(done)} trials completed on {name} ("
            + ", ".join(f"{by_budget[b]['trials']} at {b} epoch(s)" for b in ASHA_BUDGETS) + "), "
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
    cfg = json.loads((examples / "evolution.json").read_text())
    cfg["algorithm"]["evolution_es"]["population_size"] = POPULATION
    cfg["pool_size"] = EVOLUTION_POOL
    (root / "evolution.json").write_text(json.dumps(cfg))
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "ppo", "--n-chips", "1", "--max-trials", str(EVOLUTION_TRIALS),
             "--timeout-s", str(PPO_TIMEOUT_S), "--ledger", ledger,
             "--config", str(root / "evolution.json"), str(examples / "ppo_atari.py")]
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
        issued = (issued + replay.suggest(POPULATION))[:EVOLUTION_TRIALS]
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
        if sorted(t.params["epochs"] for t in done) != \
                [2] * POPULATION + [4] * (EVOLUTION_TRIALS - POPULATION):
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
        log(f"[evolution] config 5: {len(done)} trials completed on {name} ({POPULATION} at 2 "
            f"iterations, {EVOLUTION_TRIALS - POPULATION} at 4), finite, equal to EvolutionES (seed 0) replayed on the CPU "
            f"over the ledger's objectives, registry empty, status --json from a fresh process "
            f"agreeing ({status_wall:.2f} s); {wall:.2f} s = {len(done) / wall * 3600:.1f} "
            f"trials/hour; best negated return {summary['best']['objective']:.4f}")
        log(f"[evolution] config 5, summed over trials: ledger wall {total['trial_s']:.2f} s = "
            + ", ".join(f"{k[:-2]} {total[k]:.2f} s ({100 * total[k] / total['trial_s']:.1f}%)"
                        for k in keys[1:]))
        for b, m in by_budget.items():
            n_b = POPULATION if b == 2 else EVOLUTION_TRIALS - POPULATION
            log(f"[evolution]   {b} iterations (median of {n_b}): trial "
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
                         "trials": sum(r["epochs"] == b for r in rows)}
                     for b in WMT_CLI_BUDGETS}
        out["config4"] = {
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "status_wall_s": status_wall, "rungs": status[0]["rungs"], "sum": total,
            "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows, "checkpoint_bytes": ckpt_bytes,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[wmt] config 4: {len(done)} trials completed on {name} "
            f"({by_budget[1]['trials']} at 1 epoch, {by_budget[2]['trials']} at 2), finite, "
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
    cfg = json.loads((examples / "pbt.json").read_text())
    cfg["algorithm"]["pbt"]["population_size"] = PBT_POPULATION
    (root / "pbt.json").write_text(json.dumps(cfg))
    try:
        summary, wall = run_cli(
            ["hunt", "-n", "pbt", "--n-chips", "1", "--max-trials", str(PBT_TRIALS),
             "--timeout-s", str(WMT_TIMEOUT_S), "--ledger", ledger, "--ckpt-root", str(ckpt),
             "--config", str(root / "pbt.json"), str(examples / "transformer_wmt.py"),
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


def lm_attention_yardstick(torch):
    """K1-K3's bound and SDPA's time at the LM's attention shape (B 32, S
    512, H 8, D 64, bf16, causal: its tokens hold no pad, dropout 0.1). The
    bound counts the mask as the LM passes it ((b, q, k) int8) and only the
    causal pairs' products, which is what the kernels' inputs need. SDPA is
    called with ``is_causal=True`` and ``dropout_p`` 0.1, one call for the
    forward and one backward for dq, dk and dv together (a yardstick only)."""
    import torch.nn.functional as F

    b, s, h, d = LM_BATCH, LM_SEQ, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
                  .requires_grad_(i < 3) for i in range(4))
    rate = WMT_TIMED_RATE
    pairs = b * h * s * (s + 1) // 2
    numel, mask_b, row_f32 = b * s * h * d, b * s * s, b * h * s * 4
    work = {"flash_fwd": (4 * numel * 2 + mask_b + row_f32, 4.0 * pairs * d),
            "flash_bwd_dkv": (6 * numel * 2 + mask_b + 2 * row_f32, 8.0 * pairs * d),
            "flash_bwd_dq": (5 * numel * 2 + mask_b + 2 * row_f32, 6.0 * pairs * d)}

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, dropout_p=rate, is_causal=True)

    out = sdpa()
    # SDPA launches several kernels a call, so the profiler's sum has no
    # count to correct a dropped record by: the CUDA-event time (host gaps
    # included) stands beside it
    fwd, _, fwd_ev = device_ms(torch, sdpa, n=20)
    bwd, _, bwd_ev = device_ms(
        torch, lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), n=20)
    rows = {}
    for name, (nbytes, flops) in work.items():
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        lib, lib_ev = (fwd, fwd_ev) if name == "flash_fwd" else (bwd, bwd_ev)
        rows[name] = {"bound_ms": bnd, "bound_by": by, "library_ms": lib,
                      "library_events_ms": lib_ev}
        log(f"[lm] at the LM's attention shape (32, 512, 8, 64) causal, dropout {rate}: "
            f"{name} bound {bnd:.4f} ms by {by}; SDPA {'fwd' if name == 'flash_fwd' else 'bwd'} "
            f"{lib:.4f} ms (profiler), {lib_ev:.4f} ms (CUDA events)")
    return rows


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


# ---------------------------------------------------------------------------
# phase 15: the batched hunt — pools of trials in one call on the card

# runs the CLI's ``python -m metaopt_tpu_torch`` in this process with a
# measuring shim around BatchedExecutor's pool evaluation: the process age at
# its first CUDA op (the context and one synchronized kernel, as the example
# scripts measure it) and each pool's rows, written as JSON to argv[1]
BATCHED_CLI_SHIM = r"""
import atexit, json, runpy, sys
from metaopt_tpu_torch.executor import batched
from metaopt_tpu_torch.utils.procs import process_age_s

out_path, seen = sys.argv[1], {"rows": []}
real = batched.BatchedExecutor._pool_eval


def pool_eval(self, cols):
    if "first_cuda_op_s" not in seen:
        import torch

        torch.zeros(1, device=self.device).sum().item()
        seen["first_cuda_op_s"] = process_age_s()
    values = real(self, cols)
    seen["rows"].append(len(values))
    return values


def dump():
    with open(out_path, "w") as f:
        json.dump({**seen, "exit_age_s": process_age_s(),
                   "torch_dynamo": "torch._dynamo" in sys.modules}, f)


batched.BatchedExecutor._pool_eval = pool_eval
atexit.register(dump)
sys.argv = ["metaopt_tpu_torch"] + sys.argv[2:]
runpy.run_module("metaopt_tpu_torch", run_name="__main__")
"""


def batched_replay(torch, exp, led_trials):
    """The experiment's batched hunt replayed on the CPU through ``workon``
    and a ``BatchedExecutor`` as the CLI ran it (``--batch-size auto``),
    each row's objective read from the card's ledger by its point: the
    trials it registers, and the rows of each pool it evaluated."""
    from metaopt_tpu_torch.executor import BatchedExecutor
    from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
    from metaopt_tpu_torch.worker import workon

    names = list(exp.space)
    objective = {tuple(t.params[n] for n in names): t.objective for t in led_trials}
    pools = []

    def lookup(cols):
        rows = list(zip(*(cols[n].tolist() for n in names)))
        pools.append(len(rows))
        return torch.tensor([objective[r] for r in rows], dtype=torch.float64)

    replay = Experiment(exp.name, MemoryLedger(), space=exp.space, max_trials=exp.max_trials,
                        pool_size=exp.pool_size, algorithm=exp.algorithm).configure()
    workon(replay, BatchedExecutor(lookup, exp.space, device="cpu"), "replay",
           batch_size="auto")
    return replay.fetch_trials(), pools


def zoo_check(np, got, want, what: str):
    """The zoo's losses ``got`` against ``want`` (the CPU's): the worst
    relative error over rows that stayed bounded, which must be within
    BATCHED_TOL (a NaN there fails), and every diverged row diverged in
    ``got`` too (or overflowed on both)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    ok = want <= BATCHED_DIVERGED   # false for a non-finite CPU loss too
    rel = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))) if ok.any() else 0.0
    diverged = (got[~ok] >= 10.0) | ~np.isfinite(want[~ok])
    if not (rel <= BATCHED_TOL and np.all(diverged)):
        raise AssertionError(f"[batched] {what}: card against CPU worst relative {rel:.3e} "
                             f"(bound {BATCHED_TOL}) over {int(ok.sum())} bounded rows, "
                             f"diverged rows on the card {got[~ok].tolist()}")
    return rel, int(ok.sum())


def batched_phase(torch, smi: str):
    import contextlib
    import io

    import numpy as np

    from metaopt_tpu_torch.cli import main as cli_main
    from metaopt_tpu_torch.executor import BatchedExecutor, InProcessExecutor
    from metaopt_tpu_torch.ledger import Experiment, FileLedger
    from metaopt_tpu_torch.ledger.trial import Trial
    from metaopt_tpu_torch.models import objectives as zoo
    from metaopt_tpu_torch.space import build_space

    out = {"card": smi}
    space = build_space(zoo.MLP_SPACE)
    # the zoo's four draws, taken once and given to the card and the CPU alike
    draws = zoo.GivenZooDraws(*(t.numpy() for t in zoo.ZooDraws(0).take(64, 8, 16)))
    card_fn = zoo.make_mlp_batch_objective(draws=draws)
    cpu_fn = zoo.make_mlp_batch_objective(draws=draws)

    # -- (a) the zoo through BatchedExecutor at pools of 64, 256 and 1024 ------
    pools = {}
    for b in BATCHED_POOLS:
        trials = [Trial(params=p, experiment="zoo") for p in space.sample(b, seed=b)]
        ex = BatchedExecutor(card_fn, space, device="cuda")
        results = ex.execute_batch(trials)
        if [r.status for r in results].count("completed") < b // 2:
            raise AssertionError(f"[batched] pool {b}: {[r.note for r in results][:4]}")
        got = [r.results[0]["value"] if r.status == "completed" else math.nan for r in results]
        want = cpu_fn(space.stack_points([t.params for t in trials])[0]).numpy()
        rel, bounded = zoo_check(np, got, want, f"pool {b}")
        host_ms, dev_ms, kernels = profile_calls(torch, lambda: ex.execute_batch(trials), 10)
        # the pool's host time split: stacking the params into columns, the
        # objective's call (its values come back in one copy, so it is
        # synchronized), and the rest (cohorts, heartbeats, one
        # ExecutionResult per row), each over 10 calls
        params, cols = [t.params for t in trials], space.stack_points([t.params for t in trials])[0]
        split = {}
        for part, fn in (("stack_ms", lambda: space.stack_points(params)),
                         ("eval_ms", lambda: ex._pool_values(cols))):
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            split[part] = (time.perf_counter() - t0) * 1e2
        split["rest_ms"] = host_ms - split["stack_ms"] - split["eval_ms"]
        pools[b] = {"ms_per_pool": host_ms, "trials_per_s": b / host_ms * 1e3,
                    "device_ms": dev_ms, "kernels_per_pool": kernels,
                    "busy": dev_ms / host_ms if dev_ms else None, **split,
                    "max_rel_err": rel, "bounded_rows": bounded, "telemetry": ex.telemetry()}
        log(f"[batched] zoo pool {b}: {host_ms:.3f} ms a pool (synchronized) = "
            f"{pools[b]['trials_per_s']:.0f} trials/s (stack {split['stack_ms']:.3f}, "
            f"objective {split['eval_ms']:.3f}, the rest {split['rest_ms']:.3f} ms); device "
            f"{dev_ms} ms, {kernels} CUDA kernels a pool, busy {pools[b]['busy']}; card vs CPU "
            f"worst relative {rel:.2e} over {bounded} bounded rows (bound {BATCHED_TOL}); "
            f"card {smi}")
    out["pools"] = pools

    # the same 64 trials one at a time: the per-trial dispatch it replaces
    trials = [Trial(params=p, experiment="zoo") for p in space.sample(64, seed=64)]
    serial = InProcessExecutor(zoo.make_mlp_objective(draws=draws))
    for t in trials[:2]:
        serial.execute(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [serial.execute(t) for t in trials]
    serial_ms = (time.perf_counter() - t0) * 1e3
    got = [r.results[0]["value"] if r.status == "completed" else math.nan for r in rows]
    want = cpu_fn(space.stack_points([t.params for t in trials])[0]).numpy()
    zoo_check(np, got, want, "64 serial trials")
    out["serial_64"] = {"ms": serial_ms, "trials_per_s": 64 / serial_ms * 1e3,
                        "batched_over_serial": serial_ms / pools[64]["ms_per_pool"]}
    log(f"[batched] 64 zoo trials one at a time through InProcessExecutor: {serial_ms:.2f} ms "
        f"= {64 / serial_ms * 1e3:.0f} trials/s; the pool of 64 is "
        f"{out['serial_64']['batched_over_serial']:.1f}x faster; card {smi}")

    # -- (b) a poisoned pool: one NaN row breaks alone -------------------------
    trials = [Trial(params=p, experiment="zoo") for p in space.sample(64, seed=5)]
    trials[17].params["lr"] = float("nan")
    ex = BatchedExecutor(card_fn, space, device="cuda")
    statuses = [r.status for r in ex.execute_batch(trials)]
    if statuses[17] != "broken" or statuses.count("completed") != 63 \
            or ex.telemetry()["kernel_launches"] != 1:
        raise AssertionError(f"[batched] the poisoned pool: {statuses}, {ex.telemetry()}")
    out["poisoned"] = {"broken": statuses.count("broken"), "completed": 63}
    log("[batched] a pool of 64 with one NaN lr: that trial broken, 63 completed, one launch")

    # -- (c) one CLI process: CMA-ES, population 64, through --batch-size auto ---
    repo = Path(__file__).resolve().parent
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_batched_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        (root / "cmaes.json").write_text(json.dumps(
            {"algorithm": {"cmaes": {"seed": 0, "population_size": BATCHED_POPULATION}}}))
        (root / "shim.py").write_text(BATCHED_CLI_SHIM)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(root / "shim.py"), str(root / "shim.json"), "hunt", "-n", "zoo",
             "--algo", "cmaes", "--config", str(root / "cmaes.json"),
             "--vector-objective", "mlp", "--batch-size", "auto",
             "--max-trials", str(BATCHED_CLI_TRIALS), "--ledger", f"file:{root / 'ledger'}"],
            capture_output=True, text=True, env=env, cwd=root, timeout=HUNT_START_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[batched] the CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        summary, shim = json.loads(proc.stdout), json.loads((root / "shim.json").read_text())
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("zoo", led).configure()
        done = [t for t in led.fetch("zoo") if t.status == "completed"]
        replayed, replay_pools = batched_replay(torch, exp, done)
        key = (lambda p: json.dumps(p, sort_keys=True))  # noqa: E731
        problems = []
        if len(done) != BATCHED_CLI_TRIALS or summary["total"] != {
                "completed": BATCHED_CLI_TRIALS}:
            problems.append(f"{summary['total']}")
        if shim["torch_dynamo"]:
            problems.append("the CLI process imported torch._dynamo")
        if shim["rows"] != replay_pools or shim["rows"][0] != BATCHED_POPULATION:
            problems.append(f"pools of {shim['rows']}, replayed {replay_pools}")
        if sorted(key(t.params) for t in done) != sorted(key(t.params) for t in replayed):
            problems.append("the ledger's points differ from CMA-ES replayed on the CPU")
        if not all(t.params in space for t in done):
            problems.append("a point outside the space")
        if problems:
            raise AssertionError(f"[batched] the CLI hunt: {problems}")
        cols = space.stack_points([t.params for t in done])[0]
        rel, bounded = zoo_check(np, [t.objective for t in done], cpu_fn(cols).numpy(),
                                 "the CLI hunt's ledger")
        out["cli"] = {"trials": len(done), "pools": shim["rows"], "wall_s": wall,
                      "trials_per_s": len(done) / wall,
                      "first_cuda_op_s": shim["first_cuda_op_s"],
                      "exit_age_s": shim["exit_age_s"], "max_rel_err": rel,
                      "bounded_rows": bounded, "best": summary["best"]["objective"],
                      "producer_timings": summary["producer_timings"]}
        log(f"[batched] hunt --algo cmaes (population {BATCHED_POPULATION}) --vector-objective "
            f"mlp --batch-size auto: {len(done)} trials in {len(shim['rows'])} pools "
            f"({shim['rows']}, as replayed on the CPU), {wall:.2f} s "
            f"= {len(done) / wall:.1f} trials/s; process start -> first CUDA op "
            f"{shim['first_cuda_op_s']:.2f} s; points equal to CMA-ES replayed on the CPU; "
            f"objectives vs the CPU batch form worst relative {rel:.2e} over {bounded} bounded "
            f"rows; best {summary['best']['objective']:.4f}; card {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- (d) a benchmark study in-process, TPE on the card --------------------
    from metaopt_tpu_torch.algo.tpe import TPE

    ei, real_launch = [], TPE._launch_ei

    def counting_launch(self, num):  # TPE's EI launches, and where they ran
        ei.append(str(self.device))
        return real_launch(self, num)

    buf = io.StringIO()
    TPE._launch_ei = counting_launch
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["benchmark"] + BENCH_ARGS)
        bench_s = time.perf_counter() - t0
    finally:
        TPE._launch_ei = real_launch
    report = json.loads(buf.getvalue())
    curves = report["curves"]
    if rc != 0 or set(curves) != {"random", "tpe"} or report["winner"] not in curves \
            or not all(len(c) == BENCH_TRIALS and all(math.isfinite(v) for v in c)
                       for c in curves.values()) or not ei or set(ei) != {"cuda"}:
        raise AssertionError(f"[batched] benchmark: rc {rc}, EI launches on {ei}, {report}")
    out["benchmark"] = {"seconds": bench_s, "winner": report["winner"],
                        "final_best": report["final_best"], "ei_launches": len(ei)}
    log(f"[batched] benchmark {' '.join(BENCH_ARGS)}: winner {report['winner']}, final best "
        f"{report['final_best']}, {bench_s:.2f} s, {len(ei)} TPE EI launches on the card; "
        f"card {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the ledger at sweep scale — the native engine, EVC, the archive

# one of the engine benchmark's processes: argv spec name rank cycles go-file;
# waits for the go file, then runs ``cycles`` register -> reserve ->
# heartbeat -> complete cycles and prints its start, end and wall as JSON
LEDGER_CYCLE_SCRIPT = r"""
import json, os, sys, time
from metaopt_tpu_torch.ledger.backends import ledger_from_spec
from metaopt_tpu_torch.ledger.trial import Trial
spec, name, rank, n, go = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
led, w = ledger_from_spec(spec), f"p{rank}"
open(go + f".ready{rank}", "w").close()
while not os.path.exists(go):
    time.sleep(0.001)
start = time.time()
t0 = time.perf_counter()
for i in range(n):
    led.register(Trial(params={"x": float(rank * n + i)}, experiment=name))
    t = led.reserve(name, w)
    assert t is not None and led.heartbeat(name, t.id, w)
    t.attach_results([{"name": "objective", "type": "objective", "value": float(i)}])
    t.transition("completed")
    assert led.update_trial(t, expected_status="reserved", expected_worker=w)
wall = time.perf_counter() - t0
print(json.dumps({"start": start, "end": time.time(), "wall_s": wall}))
"""

# the archive's memory in a fresh torch-free process: argv rows on|off;
# prints the resident bytes the ledger added per completed trial and the
# seconds of one fetch(..., "completed")
ARCHIVE_RSS_SCRIPT = r"""
import gc, json, os, sys, time
import numpy as np
from metaopt_tpu_torch.ledger.backends import MemoryLedger
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.models.objectives import rosenbrock
n, on = int(sys.argv[1]), sys.argv[2] == "on"
def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
rng = np.random.default_rng(0)
xy = rng.uniform(-5.0, 10.0, (n, 2)).tolist()
led = MemoryLedger(archive_completed=on)
led.create_experiment({"name": "a"})
gc.collect()
base = rss()
t0 = time.perf_counter()
for i, (x, y) in enumerate(xy):
    p = {"x": x, "y": y}
    led.register(Trial(params=p, experiment="a", status="completed", worker="w0",
                       results=[{"name": "objective", "type": "objective",
                                 "value": rosenbrock(p)}],
                       submit_time=1e9 + i, start_time=1e9 + i + 0.25,
                       end_time=1e9 + i + 0.5))
fill = time.perf_counter() - t0
gc.collect()
grown = rss() - base
t0 = time.perf_counter()
got = led.fetch("a", "completed")
fetch_s = time.perf_counter() - t0
assert len(got) == n, len(got)
print(json.dumps({"rows": n, "archive": on, "rss_bytes": grown, "rss_bytes_per_trial": grown / n,
                  "fill_s": fill, "fetch_completed_s": fetch_s,
                  "stats": led.archive_stats("a")}))
"""


def ledger_cycles(root: Path, env, spec: str, name: str, n_cycles: int):
    """µs per register -> reserve -> heartbeat -> complete cycle with
    ``LEDGER_PROCS`` processes racing one experiment on ``spec``, each
    running ``n_cycles`` cycles."""
    from metaopt_tpu_torch.ledger.backends import ledger_from_spec

    led = ledger_from_spec(spec)
    led.create_experiment({"name": name, "space": {"x": "uniform(0, 1e9)"},
                           "algorithm": {"random": {}}, "max_trials": 10 ** 9, "version": 1})
    go = root / f"{name}.go"
    procs = [subprocess.Popen([sys.executable, "-c", LEDGER_CYCLE_SCRIPT, spec, name, str(r),
                               str(n_cycles), str(go)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=root)
             for r in range(LEDGER_PROCS)]
    try:
        deadline = time.monotonic() + 60
        while not all((root / f"{name}.go.ready{r}").exists() for r in range(LEDGER_PROCS)):
            if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                raise AssertionError(f"[ledger] {spec}: a cycle process did not start")
            time.sleep(0.005)
        go.touch()
        rows = []
        for p in procs:
            out, err = p.communicate(timeout=LEDGER_CYCLE_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"[ledger] {spec}: cycle process exited {p.returncode}:\n"
                                     f"{err[-2000:]}")
            rows.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cycles = LEDGER_PROCS * n_cycles
    span = max(r["end"] for r in rows) - min(r["start"] for r in rows)
    done = led.fetch(name, "completed")
    if len(done) != cycles or len({t.id for t in done}) != cycles:
        raise AssertionError(f"[ledger] {spec}: {len(done)} completed of {cycles}")
    return {"cycles": cycles, "procs": LEDGER_PROCS, "span_s": span,
            "us_per_cycle": span / cycles * 1e6,
            "us_per_cycle_per_proc": [r["wall_s"] / n_cycles * 1e6 for r in rows],
            "backend": type(led).__name__}


def cli_in_process(argv):
    """``python -m metaopt_tpu_torch ARGV`` in this process: (rc, stdout)."""
    import contextlib
    import io

    from metaopt_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def tpe_fit_card_vs_cpu(torch, algo):
    """TPE's split, weights and bandwidths (``_tpe_fit``) from its buffer on
    the card against the same rows in a CPU buffer: max |diff| per field."""
    import numpy as np

    from metaopt_tpu_torch.algo import ObservationBuffer
    from metaopt_tpu_torch.ops import tpe_math as P

    with algo._kernel_lock:
        algo._buf.sync(algo._X, algo._y)   # rows observed since the last launch
    n = len(algo._y)
    host = ObservationBuffer(algo.cube.n_dims, "cpu")
    host.sync(algo._X, algo._y)
    g_pad, b_pad = P.split_pads(n, algo.gamma)
    kw = dict(kmax=algo._kmax, equal_weight=algo.equal_weight, n_good_pad=g_pad,
              n_bad_pad=b_pad)
    nch = torch.as_tensor(np.asarray(algo.cube.n_choices), dtype=torch.int32)
    args = (n, algo.gamma, algo.prior_weight, algo.full_weight_num, algo._n_prior,
            algo.transfer_discount)

    def fit(buf, dev):
        n_, gamma, pw, fwn, n_prior, disc = args
        return P._tpe_fit(buf.Xdev, buf.ydev, n_, nch.to(dev), gamma, pw, fwn, n_prior, disc,
                          **kw)

    card, cpu = fit(algo._buf, algo._buf.device), fit(host, "cpu")
    errs = {}
    for name, a, b in zip(P.TPEFit._fields, card, cpu):
        a = a.cpu()
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError(f"[ledger] TPE fit at n {n}: {name} -inf pattern differs")
        fin = torch.isfinite(b)
        errs[name] = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
        if not torch.allclose(a[fin], b[fin], rtol=TPE_TOL, atol=TPE_TOL):
            raise AssertionError(f"[ledger] TPE fit at n {n}: {name} off by {errs[name]:.3e}")
    return errs, cpu


def ledger_phase(torch, smi: str, hunt_stats, keep_root: bool = False):
    """``keep_root``: on success leave the phase's directory (its native
    ledger) for [web] and return it as ``out["root"]``; the caller
    removes it."""
    import numpy as np

    from metaopt_tpu_torch import native
    from metaopt_tpu_torch.algo import make_algorithm
    from metaopt_tpu_torch.algo.tpe import TPE
    from metaopt_tpu_torch.ledger import Experiment, MemoryLedger, Trial, TrialAdapter
    from metaopt_tpu_torch.ledger.backends import ledger_from_spec
    from metaopt_tpu_torch.ledger.native import NativeFileLedger
    from metaopt_tpu_torch.models.objectives import rosenbrock
    from metaopt_tpu_torch.ops import tpe_math as P
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.utils import cuda_build
    from metaopt_tpu_torch.worker.producer import Producer

    repo = Path(__file__).resolve().parent
    rosen = str(repo / "metaopt_tpu_torch" / "examples" / "rosenbrock.py")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ledger_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = {"card": smi}
    part_s, last = {}, [time.perf_counter()]
    probes = {}

    def mark(part: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        part_s[part] = now - last[0]
        last[0] = now

    try:
        # -- (a) build the engine with g++; a bare path resolves to it ------
        t0 = time.perf_counter()
        so = cuda_build.build_host("ledgerstore", [native.SOURCE])
        build_s = time.perf_counter() - t0
        bare = str(root / "ledger")
        led = ledger_from_spec(bare)
        if not isinstance(led, NativeFileLedger) or native.lib_path != so:
            raise AssertionError(f"[ledger] a bare path resolved to {type(led).__name__} "
                                 f"({native.lib_path}), not the engine built at {so}")
        if so.parent != cuda_build.BUILD_DIR:
            raise AssertionError(f"[ledger] the engine was built outside _build/: {so}")
        rc, text = cli_in_process(["db", "test", "--ledger", bare])
        if rc != 0 or "NativeFileLedger" not in text:
            raise AssertionError(f"[ledger] db test returned {rc}:\n{text[-2000:]}")
        log(f"[ledger] (a) g++ built the ledgerstore engine in {build_s:.2f} s ({so.name}); "
            f"a bare path resolves to NativeFileLedger; db test: {text.strip().splitlines()[-1]}")
        out["build_s"] = build_s
        mark("build")

        # -- (b) config 1 on the engine, then the engine alone ---------------
        cfg = root / "random.json"
        cfg.write_text(json.dumps({"algorithm": {"random": {"seed": 0}}}))
        summary, wall = run_cli(
            ["hunt", "-n", "rosen", "--ledger", bare, "--max-trials", str(ROSEN_TRIALS),
             "--n-workers", str(ROSEN_WORKERS), "--config", str(cfg), rosen]
            + [f"-{k}~{v}" for k, v in ROSEN_SPACE.items()],
            root, env, ROSEN_TRIALS, ROSEN_WORKERS, ROSEN_TRIAL_S)
        rc, text = cli_in_process(["status", "-n", "rosen", "--ledger", bare, "--json"])
        if rc != 0:
            raise AssertionError(f"[ledger] status returned {rc}: {text[-2000:]}")
        status = json.loads(text)
        done = [t for t in ledger_from_spec(bare).fetch("rosen") if t.status == "completed"]
        n_results = {t.id: sum(r.type == "objective" for r in t.results) for t in done}
        problems = []
        if len(done) != ROSEN_TRIALS or len({t.id for t in done}) != len(done):
            problems.append(f"{len(done)} completed")
        if summary["completed_by_worker"] != len(done) or set(n_results.values()) != {1}:
            problems.append(f"a trial ran twice ({summary['completed_by_worker']} pushes)")
        if status[0]["by_status"] != summary["total"] or status[0]["best"] != summary["best"]:
            problems.append(f"status disagrees: {status[0]} vs {summary}")
        if problems:
            raise AssertionError(f"[ledger] config 1 on the native engine: {problems}")
        file_rate = hunt_stats["config1"]["trials_per_s"]
        out["config1"] = {"trials": len(done), "workers": ROSEN_WORKERS, "hunt_wall_s": wall,
                          "trials_per_s": len(done) / wall, "file_trials_per_s": file_rate,
                          "producer_timings": summary["producer_timings"]}
        log(f"[ledger] (b) config 1 on the native engine: {len(done)} completed, each reserved "
            f"once, status agrees; {len(done) / wall:.2f} trials/s ([hunt] on file: "
            f"{file_rate:.2f} trials/s)")
        # file: at fewer cycles (a file cycle costs ~17x an engine cycle);
        # each run is long enough that the 4 processes overlap throughout
        cyc = {f"{kind}_{n}": ledger_cycles(root, env, f"{kind}:{root / f'cyc_{kind}'}", "cyc", n)
               for kind, n in (("native", LEDGER_CYCLES), ("file", LEDGER_FILE_CYCLES))}
        nat, fil = cyc[f"native_{LEDGER_CYCLES}"], cyc[f"file_{LEDGER_FILE_CYCLES}"]
        ratio = fil["us_per_cycle"] / nat["us_per_cycle"]
        out["cycles"] = {**cyc, "file_over_native": ratio}
        for key, row in cyc.items():
            log(f"[ledger] (b) {key}: {LEDGER_PROCS} processes x {row['cycles'] // LEDGER_PROCS} "
                f"register -> reserve -> heartbeat -> complete cycles on one experiment: "
                f"{row['us_per_cycle']:.1f} us/cycle over the {row['span_s']:.2f} s span; per "
                f"process {[round(v, 1) for v in row['us_per_cycle_per_proc']]} us/cycle")
        log(f"[ledger] (b) file ({fil['cycles']} trials) / "
            f"native ({nat['cycles']} trials) = {ratio:.1f}x per cycle; card {smi}")
        mark("native")

        # -- (c) EVC: a 15,000-trial parent, a TPE child on the card ---------
        rng = np.random.default_rng(LEDGER_SEED)
        xy = rng.uniform(-5.0, 10.0, (LEDGER_PARENT, 2)).tolist()
        mem = MemoryLedger()
        Experiment("parent", mem, space=build_space(ROSEN_SPACE), algorithm={"random": {}},
                   max_trials=LEDGER_PARENT,
                   user_args=[rosen] + [f"-{k}~{v}" for k, v in ROSEN_SPACE.items()]).configure()
        docs = []
        for i, (x, y) in enumerate(xy):
            p = {"x": x, "y": y}
            docs.append(Trial(params=p, experiment="parent", status="completed", worker="w0",
                              results=[{"name": "objective", "type": "objective",
                                        "value": rosenbrock(p)}],
                              submit_time=1e9 + i, start_time=1e9 + i + 0.25,
                              end_time=1e9 + i + 0.5).to_dict())
        archive = root / "parent.json"
        archive.write_text(json.dumps({"format": "metaopt-tpu-archive", "version": 1, "experiments": [
            {"document": mem.load_experiment("parent"), "trials": docs}]}))
        t0 = time.perf_counter()
        rc, text = cli_in_process(["db", "load", "--ledger", bare, "--file", str(archive)])
        load_s = time.perf_counter() - t0
        if rc != 0 or f"{LEDGER_PARENT} trial(s)" not in text:
            raise AssertionError(f"[ledger] db load returned {rc}:\n{text[-2000:]}")
        mark("evc_load")
        launches = []
        real_launch = TPE._launch_ei

        def counting_launch(self, num):
            t0 = time.perf_counter()
            pts = real_launch(self, num)
            launches.append((self, (time.perf_counter() - t0) * 1e3, len(self._y),
                             self._buf.Xdev.device.type))
            return pts

        warm = []
        real_adapt = Producer._adapt_foreign

        def timed_adapt(self, fetched, src, branch):
            usable = real_adapt(self, fetched, src, branch)
            warm.append((src, len(fetched), len(usable)))
            return usable

        TPE._launch_ei, Producer._adapt_foreign = counting_launch, timed_adapt
        real_produce, producers = Producer.produce, []

        def recording_produce(self, pool_size=None):
            if self not in producers:
                producers.append(self)
            return real_produce(self, pool_size)

        Producer.produce = recording_produce
        child_space = {"x": "uniform(-5, 10)", "y": "uniform(-5, 5)"}
        t0 = time.perf_counter()
        P.reset_launch_counts()
        try:
            rc, text = cli_in_process(
                ["hunt", "-n", "child", "--branch-from", "parent", "--ledger", bare, "--algo",
                 "tpe", "--max-trials", str(LEDGER_CHILD_TRIALS), rosen]
                + [f"-{k}~{v}" for k, v in child_space.items()])
        finally:
            TPE._launch_ei, Producer._adapt_foreign = real_launch, real_adapt
            Producer.produce = real_produce
        torch.cuda.synchronize()
        ei_launches = P.launches["tpe_ei"]
        child_wall = time.perf_counter() - t0
        summary = json.loads(text)
        if rc != 0 or summary["total"] != {"completed": LEDGER_CHILD_TRIALS}:
            raise AssertionError(f"[ledger] the child hunt: rc {rc}, {summary}")
        # the CPU replay of the adapter over the parent's dump
        dump = root / "dump.json"
        t0 = time.perf_counter()
        rc, text = cli_in_process(["db", "dump", "-n", "parent", "--ledger", bare, "-o",
                                   str(dump)])
        if rc != 0:
            raise AssertionError(f"[ledger] db dump returned {rc}: {text[-2000:]}")
        parent_doc = json.loads(dump.read_text())["experiments"][0]
        adapter = TrialAdapter(build_space(parent_doc["document"]["space"]),
                               build_space(child_space))
        replay = {a.id for a in (adapter.adapt(Trial.from_dict(d)) for d in parent_doc["trials"])
                  if a is not None}
        replay_s = time.perf_counter() - t0
        algos = {id(a): a for a, *_ in launches}
        if len(algos) != 1 or not launches:
            raise AssertionError(f"[ledger] expected one TPE with EI launches, got {len(algos)} "
                                 f"TPEs and {len(launches)} launches")
        algo = launches[0][0]
        first_n = min(n for _, _, n, _ in launches)
        child_doc = ledger_from_spec(bare).load_experiment("child")
        problems = []
        if warm != [("parent", LEDGER_PARENT, len(replay))]:
            problems.append(f"warm start {warm} (replay {len(replay)})")
        if first_n != len(replay) or algo.n_observed != len(replay) + LEDGER_CHILD_TRIALS:
            problems.append(f"observed {first_n} at the first launch, {algo.n_observed} after; "
                            f"replay {len(replay)}")
        if any(dev != "cuda" for *_, dev in launches):
            problems.append("an EI launch ran off the card")
        if ei_launches < 1:
            problems.append("the hunt's EI launches never ran the tpe_ei kernel")
        if (child_doc.get("version") != 2
                or (child_doc.get("metadata") or {}).get("branch", {}).get("parent") != "parent"):
            problems.append(f"child doc version {child_doc.get('version')}, metadata "
                            f"{child_doc.get('metadata')}")
        if problems:
            raise AssertionError(f"[ledger] (c) EVC: {problems}")
        t0 = time.perf_counter()
        errs, _ = tpe_fit_card_vs_cpu(torch, algo)
        fit_s = time.perf_counter() - t0
        algo.drain_suggest_ahead()
        algo._suggest_ahead_async = lambda: None   # launches only when timed
        ei_host, ei_dev, ei_kernels = profile_calls(torch, lambda: algo._launch_ei(8))
        # the tpe_ei kernel on one EI launch's own inputs at n ~10k
        calls, _ = capture_ei(P, lambda: algo._launch_ei(8))
        ei_chk = ei_check(torch, P, calls[0], "ledger")
        ei_t = ei_times(torch, P, calls[0], f"n {len(algo._y)}")
        log_ei("ledger", ei_chk, ei_t, ei_kernels, ei_host, ei_dev, smi)
        warm_s = producers[0].warm_start_s if producers else None
        out["evc"] = {
            "parent_trials": LEDGER_PARENT, "db_load_s": load_s, "adapted": len(replay),
            "child_trials": LEDGER_CHILD_TRIALS, "child_hunt_wall_s": child_wall,
            "warm_start_s": warm_s, "ei_launches_in_hunt": len(launches),
            "ei_launch_host_ms_in_hunt": [ms for _, ms, _, _ in launches],
            "ei_n_obs": [n for _, _, n, _ in launches],
            "fit_max_abs_err": errs, "ei_host_ms": ei_host, "ei_device_ms": ei_dev,
            "ei_cuda_kernels": ei_kernels, "n_obs_timed": len(algo._y),
            "dump_and_replay_s": replay_s, "fit_check_s": fit_s,
            "producer_timings": summary["producer_timings"],
            "tpe_ei": {"launches": ei_launches, **ei_t, **ei_chk,
                       "kernels_per_ei_launch": ei_kernels, "launch_host_ms": ei_host,
                       "launch_device_ms": ei_dev},
        }
        log(f"[ledger] (c) db load of {LEDGER_PARENT} parent trials {load_s:.2f} s; the child "
            f"(y narrowed to uniform(-5, 5)) observed {first_n} adapted trials = the CPU replay "
            f"of TrialAdapter over the dump ({len(replay)}), version 2, branched from parent; "
            f"warm start {warm_s:.3f} s; {len(launches)} EI launches on the card at n "
            f"{sorted({n for _, _, n, _ in launches})}, host ms {[round(ms, 2) for _, ms, _, _ in launches]}; "
            f"TPE fit card vs cpu max |diff| {max(errs.values()):.3e} (tol {TPE_TOL}); at n "
            f"{len(algo._y)}: host {ei_host:.3f} ms, device {ei_dev} ms, {ei_kernels} CUDA "
            f"kernels per EI launch; child hunt {child_wall:.2f} s; card {smi}")
        mark("evc_child")

        # -- (d) transfer priors: n_prior and the discounted weights ----------
        xexp = Experiment("xfer", ledger_from_spec(bare), space=build_space(child_space),
                          algorithm={"tpe": {"seed": 0}}, max_trials=1,
                          metadata={"transfer_from": "parent"}).configure()
        xalgo = make_algorithm(xexp.space, xexp.algorithm)
        xalgo._suggest_ahead_async = lambda: None
        prod = Producer(xexp, xalgo)
        prod.produce()
        if xalgo.n_prior != len(replay) or xalgo.n_observed != len(replay):
            raise AssertionError(f"[ledger] (d) n_prior {xalgo.n_prior}, observed "
                                 f"{xalgo.n_observed}, replay {len(replay)}")
        xerrs, xfit = tpe_fit_card_vs_cpu(torch, xalgo)
        # the discount must reach the fit: without it the weights differ
        prior, xalgo._n_prior = xalgo._n_prior, 0
        _, plain_fit = tpe_fit_card_vs_cpu(torch, xalgo)
        xalgo._n_prior = prior
        moved = float((xfit.g_logw - plain_fit.g_logw).nan_to_num(0.0, 0.0, 0.0).abs().max())
        if not moved > 0:
            raise AssertionError("[ledger] (d) the transfer discount left the weights unchanged")
        out["transfer"] = {"n_prior": xalgo.n_prior, "fit_max_abs_err": xerrs,
                           "discount": xalgo.transfer_discount, "warm_start_s": prod.warm_start_s,
                           "logw_moved_by_discount": moved}
        log(f"[ledger] (d) transfer priors: n_prior {xalgo.n_prior} = the adapted count; "
            f"discounted fit card vs cpu max |diff| {max(xerrs.values()):.3e} (tol {TPE_TOL}); "
            f"the discount {xalgo.transfer_discount} moves log weights by up to {moved:.3f}")
        mark("transfer")

        # -- (e) the archive: memory, fetch, TPE's columnar observe -----------
        # the two memory probes run in their own processes while this one
        # fills the ledger that TPE observes
        probes = {mode: subprocess.Popen([sys.executable, "-c", ARCHIVE_RSS_SCRIPT,
                                          str(ARCHIVE_ROWS), mode], stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True, env=env, cwd=root)
                  for mode in ("on", "off")}
        arch = MemoryLedger()
        arch.create_experiment({"name": "a"})
        for i, (x, y) in enumerate(np.random.default_rng(0).uniform(
                -5.0, 10.0, (ARCHIVE_ROWS, 2)).tolist()):
            p = {"x": x, "y": y}
            arch.register(Trial(params=p, experiment="a", status="completed", worker="w0",
                                results=[{"name": "objective", "type": "objective",
                                          "value": rosenbrock(p)}],
                                submit_time=1e9 + i, start_time=1e9 + i + 0.25,
                                end_time=1e9 + i + 0.5))
        batch, _ = arch.fetch_completed_since("a", None)
        tpe = make_algorithm(build_space(ROSEN_SPACE), {"tpe": {"seed": 0}})
        tpe._suggest_ahead_async = lambda: None
        columnar = []
        real_batch = tpe._observe_batch
        tpe._observe_batch = lambda trials: columnar.append(real_batch(trials)) or columnar[-1]
        t0 = time.perf_counter()
        tpe.observe(batch)
        observe_s = time.perf_counter() - t0
        if columnar != [True] or tpe.n_observed != ARCHIVE_ROWS:
            raise AssertionError(f"[ledger] (e) TPE's observe took the columnar path "
                                 f"{columnar}, observed {tpe.n_observed}")
        rss = {}
        for mode, proc in probes.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"[ledger] archive {mode}: {stderr[-2000:]}")
            rss[mode] = json.loads(stdout)
        out["archive"] = {"rows": ARCHIVE_ROWS, "on": rss["on"], "off": rss["off"],
                          "tpe_columnar_observe_s": observe_s}
        log(f"[ledger] (e) {ARCHIVE_ROWS} completed trials in a MemoryLedger: archive on "
            f"{rss['on']['rss_bytes_per_trial']:.1f} B/trial resident, fetch(completed) "
            f"{rss['on']['fetch_completed_s']:.3f} s; off {rss['off']['rss_bytes_per_trial']:.1f} "
            f"B/trial, {rss['off']['fetch_completed_s']:.3f} s; TPE's columnar observe of the "
            f"CompletedBatch {observe_s:.3f} s")
        mark("archive")
        if keep_root:
            out["root"] = str(root)
    finally:
        for proc in probes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if "root" not in out:
            shutil.rmtree(root, ignore_errors=True)
    out["part_s"] = part_s
    log(f"[ledger] part seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in part_s.items()))
    return out


# (b), (c): cut from 48 trials killed at 20 to pay for phase 18 (the
# kill still after TPE's 10 initial points, 18 trials by EI after it)
COORD_TRIALS, COORD_WORKERS, COORD_KILL_AT = 32, 4, 14
COORD_SERVE_S = 90          # spawn -> ready deadline of one `serve`
COORD_HUNT_S = 240          # the (b) hunt's deadline, the restart included
# (d): 64 hosted TPE experiments on config 2's space, each with 192-252
# completed trials: one padding (buffer 256, good/bad pads 64/256), so one
# static key and 2 full buckets at the default fuse_bucket_max of 32; 8
# hosted GP-BO experiments at n 64-71 (buffer 128)
COORD_FLEET, COORD_FLEET_N = 64, (192, 252)
COORD_GP_FLEET, COORD_GP_N = 8, (64, 71)
COORD_TIE = 1e-5            # ROADMAP B4's rule: winners equal except at f32 ties
COORD_SOLO_TIMED = 8        # members whose solo launches are timed and profiled
# (e), per transport: cut from 250 cycles a thread to 125 to pay for phase
# 18, and to 64 for phase 19
COORD_RPC_THREADS, COORD_RPC_CYCLES = 4, 64


def start_serve(args, root: Path, env, tag: str, group: bool = False):
    """``python -m metaopt_tpu_torch -v serve ARGS`` in a fresh process; a
    thread drains its output for the rest of its life and stamps the
    moment its ready line appears. Returns a handle for ``await_serve``.
    ``group``: the process leads a process group of its own (with its
    shard processes), for ``stop_group``."""
    import threading

    h = {"lines": [], "ready": threading.Event(), "t0": time.perf_counter(), "tag": tag}
    h["proc"] = subprocess.Popen(
        [sys.executable, "-m", "metaopt_tpu_torch", "-v", "serve", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root,
        start_new_session=group)

    def drain():
        for line in h["proc"].stdout:
            h["lines"].append(line)
            if "coordinator ready at coord://" in line:
                h["ready_at"] = time.perf_counter()
                h["ready"].set()

    threading.Thread(target=drain, name=f"serve-{tag}", daemon=True).start()
    return h


def await_serve(h):
    """(proc, spawn -> ready seconds, port, its output lines) of a
    ``start_serve`` handle, under ``COORD_SERVE_S``."""
    if not h["ready"].wait(max(0.0, COORD_SERVE_S - (time.perf_counter() - h["t0"]))):
        h["proc"].kill()
        raise AssertionError(f"[coord] serve ({h['tag']}) not ready in {COORD_SERVE_S} s:\n"
                             + "".join(h["lines"])[-3000:])
    line = next(l for l in h["lines"] if "coordinator ready" in l)
    port = int(re.search(r"coordinator ready at coord://[^:\s]+:(\d+)", line).group(1))
    return h["proc"], h["ready_at"] - h["t0"], port, h["lines"]


def stop_serve(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)   # snapshots, then exits
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def stop_group(proc) -> None:
    """Stop a ``start_serve(..., group=True)`` process as ``stop_serve``
    does, then kill whatever of its group is left (a supervisor killed
    before it stopped its shards leaves them running)."""
    stop_serve(proc)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def tpe_scores(P, s, rows):
    """TPE's EI score of candidate ``rows`` under the snapshot's own fit."""
    a, sk = s.arrays, s.static_key
    fit = P._tpe_fit(a["X"], a["y"], a["n"], a["n_choices"], a["gamma"], a["prior_weight"],
                     a["full_weight_num"], a["n_prior"], a["transfer_discount"],
                     kmax=sk[4], equal_weight=sk[5], n_good_pad=sk[6], n_bad_pad=sk[7])
    return P._score_candidates(fit, rows, a["n_choices"], a["cont_mask"])


def gp_scores(torch, G, s, rows):
    """GP-BO's EI of candidate ``rows`` under the snapshot's factor and
    hyperparameters (``_gp_acquire_body``'s own preparation)."""
    a = s.arrays
    X, y, L = a["X"], a["y"], a["L"]
    live = (torch.arange(X.shape[0], device=X.device) < a["n"]) & torch.isfinite(y)
    mask = live.to(torch.float32)
    ys = torch.where(live, (y - a["mu"]) / a["sd"], 0.0)
    best = torch.min(torch.where(live, ys, torch.inf))
    alpha = torch.cholesky_solve((ys * mask)[:, None], L)[:, 0]
    params = {k: a[k] for k in ("log_ls", "log_amp", "log_noise")}
    return G._expected_improvement(X, mask, L, alpha, best, rows, params)


def fleet_compare(torch, score, snaps, fleet_rows, solo_rows):
    """Fused rows against the members' solo refills on the card: max
    |fused - solo| of the winners and of their scores under the member's
    own surrogate, and the winners that differ without an f32 tie
    (``COORD_TIE``)."""
    err_w = err_s = 0.0
    differ = untied = 0
    for s, f, o in zip(snaps, fleet_rows, solo_rows):
        err_w = max(err_w, float((f - o).abs().max()))
        if torch.equal(f, o):
            continue
        sf, so = score(s, f), score(s, o)
        err_s = max(err_s, float((sf - so).abs().max()))
        rows = (f != o).any(dim=1)
        differ += int(rows.sum())
        gap = (sf - so).abs() > COORD_TIE * torch.clamp(so.abs(), min=1.0)
        untied += int((rows & gap).sum())
    return {"max_abs_winner_diff": err_w, "max_abs_score_diff": err_s,
            "winners_differ": differ, "winners_differ_untied": untied}


def coord_phase(torch, smi: str):
    """[coord]: ``serve`` on the card, a hosted TPE hunt through it with a
    kill -9 and recovery, the fleet-fused plane at full width, the RPC
    plane's latency."""
    import threading

    import numpy as np

    from metaopt_tpu_torch.algo import gp_bo as G
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.coord.wal import read_records
    from metaopt_tpu_torch.ledger.trial import Trial
    from metaopt_tpu_torch.models.objectives import rosenbrock
    from metaopt_tpu_torch.ops import tpe_math as P
    from metaopt_tpu_torch.space import build_space

    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_coord_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["METAOPT_TPU_COORD_RETRY_S"] = "120"   # the workers ride out the restart
    snap, uds, events = root / "snap.json", root / "coord.sock", root / "events.jsonl"
    # the in-memory ledger under the snapshot and its WAL (without --ledger,
    # serve keeps the persistent file ledger under ~/.metaopt_tpu)
    serve_args = ["--ledger", "memory", "--snapshot", str(snap), "--uds", str(uds),
                  "--fuse-suggest",
                  "--event-log", str(events), "--snapshot-interval-s", "3600"]
    out = {"card": smi}
    procs = []
    try:
        # -- (a) serve on the card; (d) runs in this process while it boots -
        h = start_serve(["--port", "0", *serve_args], root, env, "first")
        procs.append(h["proc"])
        t_part = time.perf_counter()
        out["fleet"] = fleet_phase(torch, smi, CoordServer, Trial, P, G, build_space, np)
        fleet_s = time.perf_counter() - t_part
        srv, spawn_s, port, srv_lines = await_serve(h)
        cli = CoordLedgerClient("127.0.0.1", port, io_timeout_s=60.0)
        ping = cli.ping()
        wire = cli._wire_for(cli._seed)
        out["serve"] = {"spawn_to_ready_s": spawn_s, "wire": wire, "caps": ping["caps"],
                        "uds": bool(ping.get("uds_path")), "durable": ping["durable"]}
        log(f"[coord] (a) serve ready in {spawn_s:.2f} s on port {port} (+ uds); wire "
            f"negotiated: {wire} (caps {ping['caps']}); durable {ping['durable']}; card {smi}")

        # -- (b) TPE hosted on the card through the CLI, (c) kill -9 -------
        cfg = root / "tpe.json"   # examples/tpe.json: seed 0, 10 initial points
        cfg.write_text((examples / "tpe.json").read_text())
        part_s = {"fleet_while_serve_boots": fleet_s, "serve_spawn_to_ready": spawn_s}
        t_part = time.perf_counter()
        ops0 = cli.ping()["ops"]
        hunt_out = open(root / "hunt.out", "w+")
        hunt_err = open(root / "hunt.err", "w+")
        t0 = time.perf_counter()
        hunt = subprocess.Popen(
            [sys.executable, "-m", "metaopt_tpu_torch", "hunt", "-n", "rosen-tpe",
             "--ledger", f"coord://127.0.0.1:{port}", "--producer", "coord",
             "--n-workers", str(COORD_WORKERS), "--max-trials", str(COORD_TRIALS),
             "--config", str(cfg), str(examples / "rosenbrock.py")]
            + [f"-{k}~{v}" for k, v in ROSEN_SPACE.items()],
            stdout=hunt_out, stderr=hunt_err, env=env, cwd=root)
        procs.append(hunt)
        # watch the event log, not the server: a polling RPC would count
        # among the hunt's RPCs
        seen, deadline = 0, time.monotonic() + COORD_HUNT_S
        while seen < COORD_KILL_AT:
            if time.monotonic() > deadline or hunt.poll() is not None:
                hunt_err.seek(0)
                raise AssertionError(f"[coord] (b) {seen} completed before the kill point; "
                                     f"hunt rc {hunt.poll()}:\n{hunt_err.read()[-3000:]}")
            seen = sum('"update_trial"' in l and '"completed"' in l
                       for l in events.read_text().splitlines()) if events.exists() else 0
            time.sleep(0.05)
        ops_kill = cli.ping()["ops"]
        acked = cli.fetch("rosen-tpe", "completed")
        # a durable op's reply waits for the WAL's fsync of every record
        # appended before it: all that the fetch read is acknowledged now
        cli.set_signal("rosen-tpe", "durability-barrier", "none")
        kill_t = time.perf_counter() - t0
        before_kill = {t.id: t.objective for t in acked}
        srv.send_signal(signal.SIGKILL)
        srv.wait(timeout=30)
        wal_records = len(read_records(str(snap) + ".wal", truncate_torn=False)[0])
        srv2, recovery_s, port2, srv2_lines = await_serve(start_serve(
            ["--port", str(port), *serve_args], root, env, "restart"))
        procs.append(srv2)
        replayed = [int(m.group(1)) for m in (re.search(r"replayed (\d+) records", l)
                                              for l in srv2_lines) if m]
        out["recovery"] = {"completed_before_kill": len(before_kill), "kill_at_s": kill_t,
                           "recovery_s": recovery_s, "wal_records_on_disk": wal_records,
                           "wal_records_replayed": replayed[0] if replayed else None}
        log(f"[coord] (c) kill -9 at {kill_t:.2f} s with {len(before_kill)} trials completed; "
            f"restart on the same snapshot, port and uds ready in {recovery_s:.2f} s, "
            f"{out['recovery']['wal_records_replayed']} WAL records replayed "
            f"({wal_records} on disk); card {smi}")
        try:
            rc = hunt.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        hunt_wall = time.perf_counter() - t0
        hunt_out.seek(0)
        hunt_err.seek(0)
        stdout, stderr = hunt_out.read(), hunt_err.read()
        if rc != 0:
            raise AssertionError(f"[coord] (b) hunt exited {rc}:\n{stderr[-3000:]}")
        summary = json.loads(stdout)
        cli = CoordLedgerClient("127.0.0.1", port2, io_timeout_s=60.0)
        ops1 = cli.ping()["ops"]
        # the hunt's RPCs as the reference's op counter counts them: the
        # first server's before the kill (less the ping that read it), the
        # restarted server's (less this ping)
        rpcs = (ops_kill - ops0 - 1) + (ops1 - 1)
        done = cli.fetch("rosen-tpe", "completed")
        ev = [json.loads(l) for l in open(events)]
        pushes = {}
        for e in ev:
            if e["op"] == "update_trial" and e.get("status") == "completed":
                pushes[e["trial"]] = pushes.get(e["trial"], 0) + 1
        produce = [e for e in ev if e["op"] == "produce"]
        tele = cli.tenant_stats()["tenants"]["default"]
        ei_calls = tele.get("prefetch_hits", 0) + tele.get("prefetch_misses", 0)
        timings = summary["producer_timings"]
        problems = []
        ids = [t.id for t in done]
        if len(done) != COORD_TRIALS or len(set(ids)) != len(ids):
            problems.append(f"{len(done)} completed ({len(set(ids))} ids) of {COORD_TRIALS}")
        if summary["completed_by_worker"] != len(done) or not set(ids) <= set(pushes):
            problems.append(f"a trial completed twice: {summary['completed_by_worker']} pushes "
                            f"for {len(done)} completed")
        bad = [t.id for t in done if t.objective != rosenbrock(t.params)]
        if bad:
            problems.append(f"objectives that are not their params' rosenbrock: {bad}")
        lost = [i for i, obj in before_kill.items()
                if i not in set(ids) or next(t for t in done if t.id == i).objective != obj]
        if lost:
            problems.append(f"completions acked before the kill lost or changed: {lost}")
        if timings.get("remote") != COORD_WORKERS or not produce \
                or sum(e["registered"] for e in produce) < COORD_TRIALS:
            problems.append(f"suggestions not from the hosted algorithm: {timings}, "
                            f"{len(produce)} produce events")
        if ei_calls < 5:
            problems.append(f"{ei_calls} EI suggest calls on the coordinator's card")
        if problems:
            raise AssertionError(f"[coord] (b)/(c): {problems}")
        part_s["hunt_kill_recovery"] = time.perf_counter() - t_part
        out["hunt"] = {
            "trials": len(done), "workers": COORD_WORKERS, "wall_s": hunt_wall,
            "trials_per_s": len(done) / hunt_wall,
            "trials_per_s_before_kill": len(before_kill) / kill_t,
            "produce_rpc_ms_per_cycle": timings["produce_rpc_s"] / timings["cycles"] * 1e3,
            "cycles": timings["cycles"], "coalesced_cycles": timings.get("coalesced", 0),
            "fused_cycles": timings.get("fused_cycles", 0), "server_ops": rpcs,
            "rpcs_per_trial": rpcs / len(done),
            # the first server alone: the hunt's start and steady state,
            # without the restart's session resumption
            "rpcs_per_trial_before_kill": (ops_kill - ops0 - 1) / len(before_kill),
            "produce_events": len(produce),
            "max_coalesced": max(e["coalesced"] for e in produce),
            "ei_suggest_calls": ei_calls, "prefetch": tele,
            "producer_timings": timings, "reference_rpcs_per_trial": 1.06,
            # completions the event log saw twice: a push the first server
            # ran but never acknowledged, run again after the restart
            "pushes_logged_twice": sum(n > 1 for n in pushes.values()),
        }
        log(f"[coord] (b) {len(done)} completed, each once, objectives recomputed from params; "
            f"{COORD_WORKERS} workers in {hunt_wall:.2f} s = {len(done) / hunt_wall:.2f} "
            f"trials/s with the outage ({len(before_kill) / kill_t:.2f} before the kill); "
            f"produce RPC {out['hunt']['produce_rpc_ms_per_cycle']:.3f} ms/cycle over "
            f"{timings['cycles']} cycles, {timings.get('coalesced', 0)} coalesced; "
            f"{rpcs} server ops = {rpcs / len(done):.3f} RPCs/trial with the restart, "
            f"{out['hunt']['rpcs_per_trial_before_kill']:.3f} before the kill (the "
            f"reference's claim: 1.06); {len(produce)} produce events, {ei_calls} EI suggest calls on the card; "
            f"card {smi}")

        # -- (e) the RPC plane: worker_cycle round-trips, TCP and UDS ------
        t_part = time.perf_counter()
        rpc = {}
        cli.create_experiment({"name": "rpc",
                               "space": build_space({"x": "uniform(0, 1)"}).configuration,
                               "algorithm": {"random": {"seed": 0}}, "max_trials": 10 ** 9,
                               "pool_size": 1, "version": 1})
        for transport in ("tcp", "uds"):
            lat, errs = [[] for _ in range(COORD_RPC_THREADS)], []

            def worker(i, transport=transport, lat=lat, errs=errs):
                try:
                    c = CoordLedgerClient("127.0.0.1", port2, io_timeout_s=60.0)
                    c.ping()
                    if transport == "tcp":
                        with c._caps_lock:
                            c._uds_paths.clear()   # dial TCP, not the advertised socket
                    done_doc = None
                    for _ in range(COORD_RPC_CYCLES):
                        comp = None
                        if done_doc is not None:
                            comp = {"trial": done_doc, "expected_status": "reserved",
                                    "expected_worker": f"w{i}"}
                        t1 = time.perf_counter()
                        r = c.worker_cycle("rpc", f"w{i}", pool_size=1, complete=comp)
                        lat[i].append((time.perf_counter() - t1) * 1e6)
                        t = r["trial"]
                        t.transition("completed")
                        t.attach_results([{"name": "o", "type": "objective", "value": 0.0}])
                        done_doc = t.to_dict()
                except BaseException as err:  # reported below
                    errs.append(f"{type(err).__name__}: {err}")

            ths = [threading.Thread(target=worker, args=(i,)) for i in range(COORD_RPC_THREADS)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=120)
            if errs or any(t.is_alive() for t in ths):
                raise AssertionError(f"[coord] (e) {transport}: {errs or 'a thread hung'}")
            us = sorted(x for xs in lat for x in xs)
            rpc[transport] = {"calls": len(us), "p50_us": us[len(us) // 2],
                              "p99_us": us[int(len(us) * 0.99)], "mean_us": sum(us) / len(us)}
            log(f"[coord] (e) {transport}: {COORD_RPC_THREADS} threads x {COORD_RPC_CYCLES} "
                f"worker_cycle round-trips (complete + produce + reserve, WAL fsync'd): p50 "
                f"{rpc[transport]['p50_us']:.1f} us, p99 {rpc[transport]['p99_us']:.1f} us; "
                f"card {smi}")
        out["rpc"] = rpc
        for p in procs[1:]:
            stop_serve(p)
        part_s["rpc"] = time.perf_counter() - t_part
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)

    out["part_s"] = part_s
    log(f"[coord] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
        + f"; card {smi}")
    return out


def fleet_phase(torch, smi, CoordServer, Trial, P, G, build_space, np):
    """(d): one fuser tick's bucket launches against the same members'
    solo refills on the card, TPE (64 members, 2 buckets of 32) and GP-BO
    (8 members, 1 bucket)."""
    space = build_space(TPE_SPACE)
    rng = np.random.default_rng(13)
    out = {}
    with CoordServer(device="cuda", fuse_suggest=True, fuse_interval_s=3600.0) as srv:
        fuser = srv._fuser
        t0 = time.perf_counter()
        for family, count, (lo, hi), algo in (
                ("tpe", COORD_FLEET, COORD_FLEET_N, {"tpe": {"seed": 0}}),
                ("gp", COORD_GP_FLEET, COORD_GP_N, {"gp": {"seed": 0}})):
            for i in range(count):
                name = f"{family}{i:02d}"
                srv.ledger.create_experiment({"name": name, "space": space.configuration,
                                              "algorithm": algo, "max_trials": 10 ** 6,
                                              "pool_size": 1, "version": 1})
                for p in space.sample(int(rng.integers(lo, hi + 1)), seed=rng):
                    t = Trial(params=p, experiment=name, status="completed", worker="w",
                              results=[{"name": "o", "type": "objective",
                                        "value": float(rng.normal())}])
                    srv.ledger.register(t)
                producer, plock, _ = srv._hosted_producer(name)
                algo_ = producer.algorithm
                algo_._suggest_ahead_ready = lambda: False   # no refill races the tick
                with plock:
                    algo_.observe(srv.ledger.fetch(name, "completed"))
                if family == "gp":
                    algo_.suggest(1)       # the cold fit installs factor + params
                    with algo_._kernel_lock:
                        algo_._prefetch, algo_._prefetch_n_obs = [], len(algo_._y)
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t0
        with srv._producers_guard:
            members = [(n, e[0].algorithm) for n, e in sorted(srv._producers.items())]
        for family in ("tpe", "gp"):
            algos = [(n, a) for n, a in members if n.startswith(family)]
            for _n, a in algos:
                a._launch_lock.acquire()
            try:
                snaps = [a.fuse_snapshot() for _n, a in algos]
                if any(s is None for s in snaps):
                    raise AssertionError(f"[coord] (d) {family}: a member is not fusable")
                keys = {(s.family,) + tuple(s.static_key) for s in snaps}
                chunks = [list(zip([n for n, _ in algos], [a for _, a in algos], snaps))[i:i + 32]
                          for i in range(0, len(snaps), 32)]

                def bucket_launches():
                    return [fuser._launch_bucket(family, c) for c in chunks]

                def solo_launches(members):
                    rows = []
                    for s in members:
                        a = s.arrays
                        if family == "tpe":
                            sk = s.static_key
                            r = P.tpe_suggest_fused(
                                a["X"], a["y"], a["n"], a["count"], a["fit_seed"],
                                a["n_choices"], a["cont_mask"], a["gamma"], a["prior_weight"],
                                a["full_weight_num"], a["n_prior"], a["transfer_discount"],
                                n_cand=sk[2], n_out=sk[3], kmax=sk[4], equal_weight=sk[5],
                                n_good_pad=sk[6], n_bad_pad=sk[7])
                        else:
                            r = G.gp_acquire_fused(
                                a["X"], a["y"], a["L"], a["n"], a["mu"], a["sd"], a["fit_seed"],
                                a["count"], {k: a[k] for k in ("log_ls", "log_amp", "log_noise")},
                                n_cand=s.static_key[2], n_out=s.static_key[3], n_pools=1)
                        rows.append(r.cpu())
                    return rows

                calls, outs = capture_ei(P, bucket_launches)
                fused = [torch.from_numpy(r) for out_ in outs for r in out_]
                solo = solo_launches(snaps)
                b_host, b_dev, b_kern = profile_calls(torch, bucket_launches, n=2)
                # the solo launches timed over the first COORD_SOLO_TIMED
                # members (every member's solo row is compared above)
                s_host, s_dev, s_kern = profile_calls(
                    torch, lambda: solo_launches(snaps[:COORD_SOLO_TIMED]), n=2)
                score = ((lambda s, r: tpe_scores(P, s, r)) if family == "tpe"
                         else (lambda s, r: gp_scores(torch, G, s, r)))
                dev = snaps[0].arrays["X"].device
                cmp = fleet_compare(torch, score, snaps, [f.to(dev) for f in fused],
                                    [o.to(dev) for o in solo])
                bit_equal = all(torch.equal(f, o) for f, o in zip(fused, solo))
                n, m = len(snaps), min(len(snaps), COORD_SOLO_TIMED)
                row = {
                    "members": n, "buckets": len(chunks), "static_keys": len(keys),
                    "bucket_launch": {"host_ms": b_host / len(chunks),
                                      "device_ms": None if b_dev is None else b_dev / len(chunks),
                                      "cuda_kernels": None if b_kern is None
                                      else b_kern / len(chunks)},
                    "per_member_fused": {"host_ms": b_host / n,
                                         "device_ms": None if b_dev is None else b_dev / n,
                                         "cuda_kernels": None if b_kern is None else b_kern / n},
                    "per_member_solo": {"host_ms": s_host / m,
                                        "device_ms": None if s_dev is None else s_dev / m,
                                        "cuda_kernels": None if s_kern is None else s_kern / m},
                    "bit_equal": bit_equal, **cmp,
                }
                out[family] = row
                if len(keys) != 1 or cmp["winners_differ_untied"]:
                    raise AssertionError(f"[coord] (d) {family}: {row}")
                if family == "tpe":
                    # the tpe_ei kernel on the bucket launches' own inputs
                    chks = [ei_check(torch, P, c, "coord") for c in calls]
                    chk = {"max_abs_err": max(c["max_abs_err"] for c in chks),
                           **{k: sum(c[k] for c in chks)
                              for k in ("slots", "tie_slots", "winners_differ_in_ties")}}
                    ei_t = ei_times(torch, P, calls[0], f"a bucket of {len(chunks[0])}")
                    b = row["bucket_launch"]
                    row["tpe_ei"] = {**ei_t, **chk, "kernels_per_ei_launch": b["cuda_kernels"],
                                     "launch_host_ms": b["host_ms"],
                                     "launch_device_ms": b["device_ms"]}
                    log_ei("coord", chk, ei_t, b["cuda_kernels"], b["host_ms"], b["device_ms"],
                           smi)
                log(f"[coord] (d) {family}: {n} members, {len(chunks)} bucket launch(es) of "
                    f"<= 32 at one static key; per bucket launch {b_host / len(chunks):.3f} ms "
                    f"host, {row['bucket_launch']['device_ms']} ms device, "
                    f"{row['bucket_launch']['cuda_kernels']} CUDA kernels; per member fused "
                    f"{b_host / n:.3f} ms host / {row['per_member_fused']['device_ms']} ms device / "
                    f"{row['per_member_fused']['cuda_kernels']} kernels against solo "
                    f"{s_host / m:.3f} / {row['per_member_solo']['device_ms']} / "
                    f"{row['per_member_solo']['cuda_kernels']}; fused == solo bit for bit: "
                    f"{bit_equal}; {cmp}; card {smi}")
                for _n, a, s in (x for c in chunks for x in c):
                    a.fuse_abort(s)
            finally:
                for _n, a in algos:
                    a._launch_lock.release()
        # one live tick: every member demands, the fuser serves them all
        t0 = time.perf_counter()
        P.reset_launch_counts()
        stats = fuser.tick()
        torch.cuda.synchronize()
        ei_launches = P.launches["tpe_ei"]
        out["tick"] = {"host_ms": (time.perf_counter() - t0) * 1e3, **stats,
                       "telemetry": fuser.telemetry(), "tpe_ei_launches": ei_launches}
        if stats["fused"] != COORD_FLEET + COORD_GP_FLEET:
            raise AssertionError(f"[coord] (d) one tick fused {stats}")
        if ei_launches < 1:
            raise AssertionError("[coord] (d) the tick's TPE buckets never ran the tpe_ei kernel")
        log(f"[coord] (d) one fuser tick: {stats['launches']} bucket launches served "
            f"{stats['fused']} members in {out['tick']['host_ms']:.1f} ms, tpe_ei launched "
            f"{ei_launches} times; card {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 18: sharded serving — serve --shards, rebalance, failover, simulate

SHARDS_TRIALS, SHARDS_WORKERS, SHARDS_MOVE_AT = 24, 2, 10   # (b), (c): per hunt
SHARDS_HUNT_S = 240        # each (b) hunt's deadline, the move included
# (d): the dead shard's experiment's budget, and its completions at the kill
# (past TPE's 10 initial points on both shards, so no first EI launch
# coincides with the failover)
FO_TRIALS, FO_KILL_AT = 48, 24
FO_THREADS = 4             # (d): 2 on the dead shard's experiment, 2 on the survivor's
FO_WAIT_S = 60             # (d): kill -9 -> failover done deadline
SIM_ARGS = ["simulate", "--workers", "1000", "--algos", "asha", "hyperband", "tpe",
            "--seed", "0", "--json"]   # (e), with the default fault schedule
# at 1000 workers every experiment registers its 64 trials before TPE has
# its 20 initial points, so TPE never launches EI there (nor in the
# reference); two workers with pools of one carry a TPE past them, 12 of
# its 32 suggestions by EI on the card, through one coordinator crash
SIM_TPE_ARGS = ["simulate", "--workers", "2", "--tenants", "1", "--experiments-per-tenant",
                "1", "--algos", "tpe", "--trials", "32", "--pool-size", "1", "--seed", "0",
                "--faults", "sim_crash_server:1@30", "--json"]

# (c)'s ``python -m metaopt_tpu_torch rebalance`` starts before the move
# point and waits for the trigger file argv[1] (its process start, seconds
# on the card's host, would otherwise land the move after A's last
# suggestion); the rest of argv is the CLI's
REBALANCE_SHIM = r"""
import os, runpy, sys, time
import metaopt_tpu_torch.cli.main  # noqa: F401  (the CLI loaded before the trigger)

trigger = sys.argv[1]
while not os.path.exists(trigger):
    time.sleep(0.005)
sys.argv = ["metaopt_tpu_torch"] + sys.argv[2:]
runpy.run_module("metaopt_tpu_torch", run_name="__main__")
"""

# the (b) hunts run the CLI in a process under this shim: it counts the
# client's RPCs by the address each went to, written as JSON to argv[1], and
# with argv[2] == "old" it plays a client from before the shard map, which
# never reads the ``shard_map`` cap (every RPC goes to the address it was
# given: the router)
SHARDS_CLI_SHIM = r"""
import atexit, collections, json, runpy, sys, time
from metaopt_tpu_torch.coord import client_backend as cb

out_path, mode = sys.argv[1], sys.argv[2]
rpcs, slowest = collections.Counter(), []
real_exchange, real_absorb = cb.CoordLedgerClient._exchange, cb.CoordLedgerClient._absorb_ping


def exchange(self, msg, addr):
    key = "%s:%d %s" % (addr[0], addr[1], msg.get("op"))
    rpcs[key] += 1
    t0 = time.time()
    try:
        return real_exchange(self, msg, addr)
    finally:
        slowest.append(((time.time() - t0) * 1e3, t0, key))
        slowest.sort(reverse=True)
        del slowest[3:]


def absorb_old(self, addr, r):
    r = dict(r)
    r["caps"] = [c for c in r.get("caps") or () if c != "shard_map"]
    r.pop("shard_map", None)
    return real_absorb(self, addr, r)


def dump():
    with open(out_path, "w") as f:
        json.dump({"rpcs": dict(rpcs), "slowest": slowest}, f)


cb.CoordLedgerClient._exchange = exchange
if mode == "old":
    cb.CoordLedgerClient._absorb_ping = absorb_old
atexit.register(dump)
sys.argv = ["metaopt_tpu_torch"] + sys.argv[3:]
runpy.run_module("metaopt_tpu_torch", run_name="__main__")
"""


def compute_apps():
    """(pid, MiB) of every process holding a context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    apps = []
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps.append((int(parts[0]), float(parts[1]) if parts[1].replace(".", "").isdigit()
                         else None))
    return apps


def raw_call(addr, msg):
    import socket

    from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg

    with socket.create_connection(addr, timeout=30) as s:
        send_msg(s, msg)
        return recv_msg(s)


def completions_logged(path: Path, name: str) -> int:
    """Completions of ``name`` in a shard's event log (read from disk: a
    polling RPC would count among the hunts' RPCs)."""
    if not path.exists():
        return 0
    n = 0
    for line in path.read_text().splitlines():
        if '"update_trial"' in line and '"completed"' in line and f'"{name}"' in line:
            n += 1
    return n


def simulate_twice(torch, smi: str, cfg: Path, root: Path):
    """(e): ``simulate`` through the CLI in this process, twice with one seed,
    its coordinator hosting TPE on the card, then once with a TPE that
    reaches EI; each run's report, wall seconds and hosted algorithms (read
    at the end of the run)."""
    import contextlib
    import io
    import logging

    from metaopt_tpu_torch.cli.main import main as cli_main
    from metaopt_tpu_torch.sim import engine

    hosted = []
    real_finalize = engine.Simulation._finalize

    def finalize(self):
        for name, entry in sorted(self.server._producers.items()):
            algo = entry[0].algorithm
            tele = algo.telemetry() if hasattr(algo, "telemetry") else {}
            hosted.append({"experiment": name, "algo": type(algo).__name__,
                           "device": str(getattr(algo, "device", None)),
                           "observed": algo.n_observed,
                           "ei_launches": tele.get("kernel_launches")})
        return real_finalize(self)

    faults_log = logging.getLogger("metaopt_tpu_torch.executor.faults")
    level = faults_log.level
    faults_log.setLevel(logging.ERROR)   # a warning a fired fault: thousands
    engine.Simulation._finalize = finalize
    runs = []
    try:
        for i, args in enumerate((SIM_ARGS, SIM_ARGS, SIM_TPE_ARGS)):
            hosted.clear()
            buf, ev = io.StringIO(), root / f"sim-{i}.jsonl"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(args + ["--event-log", str(ev), "--config", str(cfg)])
            wall = time.perf_counter() - t0
            rep = json.loads(buf.getvalue())
            problems = []
            if rc != 0 or not rep["ok"]:
                problems.append(f"rc {rc}, ok {rep['ok']}")
            for key in ("promotion_violations", "acked_write_losses",
                        "exactly_once_violations"):
                if rep[key]:
                    problems.append(f"{key}: {rep[key][:5]}")
            crashes = 1 if args is SIM_TPE_ARGS else 2
            if rep["crashes"] != crashes or len(rep["recoveries"]) != crashes:
                problems.append(f"{rep['crashes']} coordinator crashes of {crashes}")
            tpes = [h for h in hosted if h["algo"] == "TPE"]
            if not tpes or any(not h["device"].startswith("cuda") for h in tpes):
                problems.append(f"TPE not hosted on the card: {hosted}")
            if args is SIM_TPE_ARGS and not all((h["ei_launches"] or 0) > 0 for h in tpes):
                problems.append(f"no EI launch on the card: {tpes}")
            if problems:
                raise AssertionError(f"[shards] (e) simulate run {i}: {problems}")
            runs.append({"wall_s": wall, "report_wall_s": rep["wall_s"],
                         "events": rep["event_lines"], "digest": rep["event_log_sha256"],
                         "dispatches": rep["dispatches"],
                         "acked_completions": rep["acked_completions"],
                         "virtual_s": rep["virtual_s"], "crashes": rep["crashes"],
                         "recoveries": rep["recoveries"],
                         "recovery_s_per_10k_wal": rep["recovery_s_per_10k_wal"],
                         "hosted": list(hosted)})
    finally:
        engine.Simulation._finalize = real_finalize
        faults_log.setLevel(level)
    first_diff = None
    if runs[0]["digest"] != runs[1]["digest"]:
        a = (root / "sim-0.jsonl").read_text().splitlines()
        b = (root / "sim-1.jsonl").read_text().splitlines()
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        first_diff = {"line": k, "run0": a[k] if k < len(a) else None,
                      "run1": b[k] if k < len(b) else None}
    tpe_run = runs.pop()
    log(f"[shards] (e) simulate, 2 workers, TPE alone, pools of 1, one crash: certified in "
        f"{tpe_run['wall_s']:.2f} s wall; TPE on {tpe_run['hosted'][0]['device']} with "
        f"{tpe_run['hosted'][0]['ei_launches']} EI launches over "
        f"{tpe_run['hosted'][0]['observed']} observations; card {smi}")
    for i, r in enumerate(runs):
        tpe_launches = sum(h["ei_launches"] or 0 for h in r["hosted"] if h["algo"] == "TPE")
        log(f"[shards] (e) simulate run {i}: 1000 workers, asha + hyperband + tpe, default "
            f"faults ({tpe_launches} EI launches on the card): certified in "
            f"{r['wall_s']:.2f} s wall ({r['events']} events, "
            f"{r['dispatches']} dispatches, {r['acked_completions']} acked completions, "
            f"{r['crashes']} crashes, recovery {r['recovery_s_per_10k_wal']} s per 10k WAL "
            f"records); digest {r['digest']}; card {smi}")
    log(f"[shards] (e) same seed, two digests: {runs[0]['digest']} / {runs[1]['digest']} "
        f"({'equal' if first_diff is None else 'DIFFER at ' + json.dumps(first_diff)})")
    return {"runs": runs, "digests_equal": first_diff is None, "first_diff": first_diff,
            "tpe_run": tpe_run}


def shards_phase(torch, smi: str):
    """[shards]: ``serve --shards 2`` on the card, two hosted hunts (a new
    client direct, an old one through the router), a live ``rebalance``,
    failover after ``kill -9`` of a shard, and ``simulate`` twice."""
    import threading

    from metaopt_tpu_torch.coord import CoordLedgerClient, ShardSupervisor
    from metaopt_tpu_torch.coord.shards import RoutingTable, ring_of
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.models.objectives import rosenbrock
    from metaopt_tpu_torch.space import build_space

    repo = Path(__file__).resolve().parent
    examples = repo / "metaopt_tpu_torch" / "examples"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_shards_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    cfg = root / "coord.json"   # the shards' device: the card, said out loud
    cfg.write_text(json.dumps({"coordinator": {"device": "cuda"}}))
    tpe_cfg = root / "tpe.json"   # examples/tpe.json: seed 0, 10 initial points
    tpe_cfg.write_text((examples / "tpe.json").read_text())
    tpe_algo = json.loads(tpe_cfg.read_text())["algorithm"]
    (root / "shim.py").write_text(SHARDS_CLI_SHIM)
    (root / "rebalance.py").write_text(REBALANCE_SHIM)
    snap, events = root / "snap", root / "events"
    snap.mkdir()
    events.mkdir()
    out, part_s, procs = {"card": smi}, {}, []
    sup_d, d_boot = None, {}
    try:
        # -- (a) the deployment; (d)'s boots beside it; (e) runs meanwhile ---
        t_phase = time.perf_counter()
        h = start_serve(["--shards", "2", "--port", "0", "--ledger", "memory", "--snapshot",
                         str(snap), "--event-log", str(events), "--fuse-suggest",
                         "--snapshot-interval-s", "3600", "--config", str(cfg)], root, env,
                        "shards", group=True)
        procs.append(h["proc"])
        sup_d = ShardSupervisor(2, snapshot_dir=str(root / "failover"), failover=True,
                                fuse_suggest=True, device="cuda")

        def boot_d():
            t0 = time.perf_counter()
            try:
                sup_d.start()
                d_boot["s"] = time.perf_counter() - t0
            except BaseException as err:  # raised below
                d_boot["err"] = err

        booting = threading.Thread(target=boot_d, name="shards-failover-boot")
        booting.start()
        out["simulate"] = simulate_twice(torch, smi, cfg, root)
        part_s["simulate_while_shards_boot"] = time.perf_counter() - t_phase
        sup_proc, spawn_s, port, lines = await_serve(h)
        router = ("127.0.0.1", port)
        shard_ready = {int(m.group(1)): float(m.group(2)) for m in (
            re.search(r"shard process (\d+) ready in ([\d.]+) s", l) for l in lines) if m}
        cli = CoordLedgerClient(*router, io_timeout_s=60.0)
        ping = cli.ping()
        smap = ping["shard_map"]
        addrs = {s["id"]: (s["host"], s["port"]) for s in smap["shards"]}
        pings = {sid: CoordLedgerClient(*a, io_timeout_s=60.0).ping() for sid, a in addrs.items()}
        shards = {sid: {"pid": p["pid"], "device": p["device"],
                        "spawn_to_ready_s": shard_ready.get(p["pid"])}
                  for sid, p in pings.items()}
        problems = []
        if ("shard_map" not in ping["caps"] or "shard_id" in ping
                or sorted(addrs) != ["s0", "s1"]):
            problems.append(f"the router's ping: {ping}")
        if any(v["device"] != "cuda" for v in shards.values()):
            problems.append(f"a shard not on the card: {shards}")
        if len({v["pid"] for v in shards.values()} | {sup_proc.pid}) != 3:
            problems.append(f"shard pids {shards} and supervisor {sup_proc.pid}")
        if any(v["spawn_to_ready_s"] is None for v in shards.values()):
            problems.append(f"no ready time for a shard: {shard_ready}")
        if problems:
            raise AssertionError(f"[shards] (a): {problems}")
        out["serve"] = {"spawn_to_ready_s": spawn_s, "supervisor_pid": sup_proc.pid,
                        "shards": shards, "wire": cli._wire_for(cli._seed)}
        log(f"[shards] (a) serve --shards 2 ready in {spawn_s:.2f} s (supervisor pid "
            f"{sup_proc.pid}); " + ", ".join(
                f"{sid} pid {v['pid']} on {v['device']} ready in {v['spawn_to_ready_s']:.2f} s"
                for sid, v in sorted(shards.items())) + f"; card {smi}")

        # -- (b) two hosted TPE hunts, one per shard -----------------------
        t_part = time.perf_counter()
        ring = ring_of(smap)
        names = {}
        for i in range(1000):
            names.setdefault(ring.owner(f"shards-{i}"), f"shards-{i}")
        name_a, name_b = names["s0"], names["s1"]
        hunts = {}
        for tag, nm, mode in (("new", name_a, "new"), ("old", name_b, "old")):
            so, se = open(root / f"{tag}.out", "w+"), open(root / f"{tag}.err", "w+")
            hunts[tag] = {"name": nm, "out": so, "err": se, "rpcs": root / f"rpcs-{tag}.json",
                          "t0": time.perf_counter()}
            hunts[tag]["proc"] = subprocess.Popen(
                [sys.executable, str(root / "shim.py"), str(hunts[tag]["rpcs"]), mode,
                 "hunt", "-n", nm, "--ledger", f"coord://127.0.0.1:{port}", "--producer",
                 "coord", "--n-workers", str(SHARDS_WORKERS), "--max-trials",
                 str(SHARDS_TRIALS), "--config", str(tpe_cfg), str(examples / "rosenbrock.py")]
                + [f"-{k}~{v}" for k, v in ROSEN_SPACE.items()],
                stdout=so, stderr=se, env=env, cwd=root)
            procs.append(hunts[tag]["proc"])

        # -- (c) once 10 of A's trials completed: rebalance A to s1, live --
        trigger = root / "move-now"
        reb = subprocess.Popen(
            [sys.executable, str(root / "rebalance.py"), str(trigger), "-v", "rebalance",
             "--coord", f"127.0.0.1:{port}", "--experiment", name_a, "--dest", "s1",
             "--window-s", "30"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root)
        procs.append(reb)
        deadline = time.monotonic() + SHARDS_HUNT_S
        ev0, ev1 = events / "shard-0.events.jsonl", events / "shard-1.events.jsonl"
        while completions_logged(ev0, name_a) < SHARDS_MOVE_AT:
            if time.monotonic() > deadline or hunts["new"]["proc"].poll() is not None:
                hunts["new"]["err"].seek(0)
                raise AssertionError(f"[shards] (b) A: {completions_logged(ev0, name_a)} "
                                     f"completed before the move point; rc "
                                     f"{hunts['new']['proc'].poll()}:\n"
                                     f"{hunts['new']['err'].read()[-3000:]}")
            time.sleep(0.05)
        a0 = CoordLedgerClient(*addrs["s0"], io_timeout_s=60.0)
        acked = a0.fetch(name_a, "completed")
        # a durable op's reply waits for the WAL's fsync of every record
        # appended before it: all that the fetch read is acknowledged now
        a0.set_signal(name_a, "durability-barrier", "none")
        before = {t.id: t.objective for t in acked}
        t0 = time.perf_counter()
        trigger.touch()
        try:
            reb_out, reb_err = reb.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            reb.kill()
            reb_out, reb_err = reb.communicate()
        reb_wall = time.perf_counter() - t0
        if reb.returncode != 0:
            raise AssertionError(f"[shards] (c) rebalance rc {reb.returncode}:\n"
                                 f"{reb_err[-3000:]}")
        said = re.search(r"s0 -> s1 \((\d+) trials, (\d+) cached replies, map v(\d+)\)",
                         reb_out)
        split = re.search(r"prepare ([\d.]+) ms, apply ([\d.]+) ms, commit ([\d.]+) ms, "
                          r"(\d+) trials shipped", reb_err)
        if not said or not split:
            raise AssertionError(f"[shards] (c) rebalance said:\n{reb_out}\n"
                                 f"{reb_err[-3000:]}")
        handoff = {"completed_at_move": len(before), "shipped_trials": int(said.group(1)),
                   "cached_replies": int(said.group(2)), "map_version": int(said.group(3)),
                   "prepare_ms": float(split.group(1)), "apply_ms": float(split.group(2)),
                   "commit_ms": float(split.group(3)), "trigger_to_exit_s": reb_wall}
        handoff["handoff_ms"] = (handoff["prepare_ms"] + handoff["apply_ms"]
                                 + handoff["commit_ms"])
        log(f"[shards] (c) rebalance of A ({name_a}) s0 -> s1 with {len(before)} completed: "
            f"hand-off {handoff['handoff_ms']:.2f} ms (prepare {handoff['prepare_ms']:.2f}, "
            f"apply {handoff['apply_ms']:.2f}, commit {handoff['commit_ms']:.2f}), "
            f"{handoff['shipped_trials']} trials and {handoff['cached_replies']} cached replies "
            f"shipped, map v{handoff['map_version']}; trigger -> rebalance exit {reb_wall:.2f} s; "
            f"card {smi}")

        hunt_stats = {}
        for tag, hd in hunts.items():
            try:
                rc = hd["proc"].wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            wall = time.perf_counter() - hd["t0"]
            hd["out"].seek(0)
            hd["err"].seek(0)
            if rc != 0:
                raise AssertionError(f"[shards] (b) hunt {tag} rc {rc}:\n"
                                     f"{hd['err'].read()[-3000:]}")
            summary = json.loads(hd["out"].read())
            shim = json.loads(hd["rpcs"].read_text())
            rpcs = shim["rpcs"]
            hunt_stats[tag] = {"experiment": hd["name"], "wall_s": wall,
                               "trials_per_s": SHARDS_TRIALS / wall,
                               "rpcs": sum(rpcs.values()),
                               "rpcs_per_trial": sum(rpcs.values()) / SHARDS_TRIALS,
                               "producer_timings": summary["producer_timings"],
                               # (ms, wall time at its start, "addr op")
                               "slowest_rpcs": shim["slowest"],
                               "rpcs_by_route": {}}
            label = {f"127.0.0.1:{port}": "router",
                     **{f"{a[0]}:{a[1]}": sid for sid, a in addrs.items()}}
            by_op = {}
            for key, n in rpcs.items():
                addr, op = key.split(" ", 1)
                route = label.get(addr, addr)
                hunt_stats[tag]["rpcs_by_route"][route] = (
                    hunt_stats[tag]["rpcs_by_route"].get(route, 0) + n)
                by_op.setdefault(route, {})[op] = n
            hunt_stats[tag]["rpcs_by_route_and_op"] = by_op
        s1 = CoordLedgerClient(*addrs["s1"], io_timeout_s=60.0)
        done_a, done_b = s1.fetch(name_a, "completed"), s1.fetch(name_b, "completed")
        ids_a = [t.id for t in done_a]
        miss = raw_call(addrs["s0"], {"op": "count", "args": {"experiment": name_a}})
        produce_a = [json.loads(l) for l in ev1.read_text().splitlines()
                     if '"produce"' in l and f'"{name_a}"' in l]
        routes_new = hunt_stats["new"]["rpcs_by_route"]
        routes_old = hunt_stats["old"]["rpcs_by_route"]
        if len(done_a) != SHARDS_TRIALS or len(set(ids_a)) != len(ids_a):
            problems.append(f"A: {len(done_a)} completed on s1 ({len(set(ids_a))} ids)")
        lost = [i for i, obj in before.items()
                if ids_a.count(i) != 1 or next(t for t in done_a if t.id == i).objective != obj]
        if lost:
            problems.append(f"completions acked before the move lost or changed: {lost}")
        if len(done_b) != SHARDS_TRIALS:
            problems.append(f"B: {len(done_b)} completed of {SHARDS_TRIALS}")
        bad = [t.id for t in done_a + done_b if t.objective != rosenbrock(t.params)]
        if bad:
            problems.append(f"objectives that are not their params' rosenbrock: {bad}")
        if (miss or {}).get("error") != "WrongShardError":
            problems.append(f"s0 answered {miss} for A after the move")
        if handoff["shipped_trials"] < len(before):
            problems.append(f"shipped {handoff['shipped_trials']} < {len(before)} completed")
        if not produce_a or (produce_a[0].get("observed") or 0) < len(before):
            problems.append(f"s1's first produce for A: {produce_a[:1]} (want >= "
                            f"{len(before)} observations)")
        if set(routes_old) != {"router"}:
            problems.append(f"the old client left the router: {routes_old}")
        # the hot path direct: every worker_cycle to a shard (the hunt's
        # setup ops go through the router until its workers' first ping)
        ops_new = hunt_stats["new"]["rpcs_by_route_and_op"]
        if (ops_new.get("router", {}).get("worker_cycle", 0)
                or sum(ops_new.get(sid, {}).get("worker_cycle", 0)
                       for sid in ("s0", "s1")) < SHARDS_TRIALS):
            problems.append(f"the new client did not go direct: "
                            f"{hunt_stats['new']['rpcs_by_route_and_op']}")
        # one context per shard on the card, none in the supervisor
        apps = compute_apps()
        pids = {p for p, _ in apps}
        shard_pids = {v["pid"] for v in shards.values()}
        if os.getpid() in pids:   # this process' pid namespace is the card's
            if not shard_pids <= pids or sup_proc.pid in pids:
                problems.append(f"contexts {apps}: shards {shard_pids}, supervisor "
                                f"{sup_proc.pid}")
        elif len(apps) != 3:      # this script, s0, s1
            problems.append(f"contexts {apps}: want 3 (this script and two shards)")
        if problems:
            raise AssertionError(f"[shards] (b)/(c): {problems}")
        out["contexts"] = {"apps": apps, "same_pid_namespace": os.getpid() in pids}
        # each shard's produce events (wall time, experiment, observations
        # the fit held, trials registered): the slow RPCs above line up
        # against these
        out["produce_events"] = {
            sid: [(e["ts"], e["experiment"], e.get("observed"), e["registered"])
                  for e in map(json.loads, path.read_text().splitlines())
                  if e["op"] == "produce"]
            for sid, path in (("s0", ev0), ("s1", ev1))}
        out["hunts"] = hunt_stats
        out["handoff"] = {**handoff, "first_produce_on_dest": produce_a[0]}
        for tag, st in hunt_stats.items():
            log(f"[shards] (b) hunt {tag} client ({st['experiment']}): {SHARDS_TRIALS} trials, "
                f"{SHARDS_WORKERS} workers in {st['wall_s']:.2f} s = {st['trials_per_s']:.2f} "
                f"trials/s; {st['rpcs']} RPCs = {st['rpcs_per_trial']:.3f} a trial, by route "
                f"{st['rpcs_by_route']}; slowest RPCs (ms, start, route op) "
                f"{[(round(ms, 1), round(t, 3), k) for ms, t, k in st['slowest_rpcs']]}; "
                f"card {smi}")
        log(f"[shards] (c) every completion acked before the move on s1 once; s0 answers "
            f"WrongShardError for A; s1's TPE held {produce_a[0]['observed']} observations at "
            f"its first suggest (>= {len(before)}); contexts on the card {apps} (supervisor "
            f"pid {sup_proc.pid} holds none); card {smi}")
        stop_group(sup_proc)
        part_s["serve_hunts_rebalance"] = time.perf_counter() - t_part

        # -- (d) failover: kill -9 of a shard under load -------------------
        t_part = time.perf_counter()
        booting.join(timeout=COORD_SERVE_S)
        if "err" in d_boot or "s" not in d_boot:
            raise AssertionError(f"[shards] (d) supervisor start: {d_boot}")
        table = RoutingTable(sup_d.shard_map)
        fo = {}
        for i in range(1000):
            fo.setdefault(table.owner(f"failover-{i}"), f"failover-{i}")
        name_x, name_y = fo["s0"], fo["s1"]
        c = CoordLedgerClient(*sup_d.address, io_timeout_s=60.0, reconnect_window_s=60.0)
        c.ping()
        for nm, budget in ((name_x, FO_TRIALS), (name_y, 10 ** 6)):
            Experiment(nm, c, space=build_space(ROSEN_SPACE), max_trials=budget,
                       pool_size=2, algorithm=tpe_algo).configure()
        acked_fo = {name_x: [], name_y: []}
        y_calls, errors, stop = [], [], threading.Event()
        lock = threading.Lock()

        def worker(nm, wid):
            cw = CoordLedgerClient(*sup_d.address, io_timeout_s=60.0, reconnect_window_s=60.0)
            done = None
            try:
                while not stop.is_set():
                    t1 = time.perf_counter()
                    r = cw.worker_cycle(nm, wid, pool_size=2, complete=done)
                    t2 = time.perf_counter()
                    with lock:
                        if nm == name_y:
                            y_calls.append((t1, t2, len(acked_fo[name_y])))
                        if done is not None and r.get("completed_ok"):
                            acked_fo[nm].append(done["trial"]["id"])
                    done = None
                    t = r["trial"]
                    if t is None:
                        if nm == name_x and r["counts"]["completed"] >= FO_TRIALS:
                            return
                        time.sleep(0.01)
                        continue
                    t.attach_results([{"name": "objective", "type": "objective",
                                       "value": rosenbrock(t.params)}])
                    t.transition("completed")
                    done = {"trial": t.to_dict(), "expected_status": "reserved",
                            "expected_worker": wid}
            except BaseException as err:  # reported below
                errors.append(f"{wid}: {type(err).__name__}: {err}")

        threads = [threading.Thread(target=worker, args=(nm, f"{nm}-w{j}"))
                   for nm in (name_x, name_y) for j in range(FO_THREADS // 2)]
        for t in threads:
            t.start()
        t_dead = time.monotonic() + 120
        while len(acked_fo[name_x]) < FO_KILL_AT and time.monotonic() < t_dead and not errors:
            time.sleep(0.01)
        with lock:
            x_before = list(acked_fo[name_x])
        t_kill = time.perf_counter()
        sup_d.kill_shard(0)
        t_dead = time.monotonic() + FO_WAIT_S
        while not sup_d.failover_times and time.monotonic() < t_dead:
            time.sleep(0.01)
        t_over = time.perf_counter()
        for t in threads[: FO_THREADS // 2]:
            t.join(timeout=120)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        x_docs = {t.id: t for t in c.fetch(name_x, "completed")}
        with lock:
            during = [(a, b) for a, b, _ in y_calls if t_kill <= b <= t_over]
            y_max_ms = max(((b - a) * 1e3 for a, b, _ in y_calls if b >= t_kill and a <= t_over),
                           default=None)
            # Y's slowest call of the whole run: ms, its start from the kill
            # (s), Y's completions acked before it
            a, b, k = max(y_calls, key=lambda c: c[1] - c[0])
            y_slowest = [(b - a) * 1e3, a - t_kill, k]
            x_acked = list(acked_fo[name_x])
        problems = []
        if errors or any(t.is_alive() for t in threads):
            problems.append(f"workers: {errors or 'a thread hung'}")
        if len(x_before) < FO_KILL_AT:
            problems.append(f"{len(x_before)} completions of X before the kill")
        if not sup_d.failover_times:
            problems.append(f"no failover in {FO_WAIT_S} s")
        lost = [i for i in x_acked if i not in x_docs]
        if lost:
            problems.append(f"acked completions of X lost in the failover: {lost}")
        if len(x_docs) != FO_TRIALS:
            problems.append(f"X: {len(x_docs)} completed of {FO_TRIALS}")
        if sup_d.crashes() != 1 or any(s["id"] == "s0" for s in sup_d.shard_map["shards"]):
            problems.append(f"crashes {sup_d.crashes()}, map {sup_d.shard_map}")
        if not during:
            problems.append("the survivor answered no call of its own experiment during "
                            "the redistribution")
        if problems:
            raise AssertionError(f"[shards] (d): {problems}")
        out["failover"] = {"failover_times": list(sup_d.failover_times),
                           "kill_to_done_s": t_over - t_kill, "boot_s": d_boot["s"],
                           "x_acked_before_kill": len(x_before), "x_acked": len(x_acked),
                           "x_completed": len(x_docs),
                           "survivor_calls_during": len(during),
                           "survivor_max_call_ms_during": y_max_ms,
                           "survivor_slowest_call": y_slowest,
                           "y_acked": len(acked_fo[name_y])}
        log(f"[shards] (d) kill -9 of s0 with {len(x_before)} of X's completions acked: "
            f"failover_times {sup_d.failover_times} (kill -> done {t_over - t_kill:.3f} s); "
            f"X {len(x_docs)}/{FO_TRIALS} completed on the survivor, none of {len(x_acked)} "
            f"acked lost; the survivor answered {len(during)} calls of Y during it (slowest "
            f"{y_max_ms if y_max_ms is None else round(y_max_ms, 2)} ms); boot {d_boot['s']:.2f} "
            f"s beside (a); card {smi}")
        sup_d.stop()
        part_s["failover"] = time.perf_counter() - t_part
    finally:
        if procs:
            stop_group(procs[0])   # the supervisor first: it stops its shards
        for p in procs[1:]:
            if p.poll() is None:
                p.kill()
                p.wait()
        if sup_d is not None:
            sup_d.stop()
        shutil.rmtree(root, ignore_errors=True)
    out["part_s"] = part_s
    log(f"[shards] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
        + f"; card {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the read side: `web`, `plot`, GP-BO's analyses on the card

WEB_READY_S = 90            # spawn -> listening deadline of `web`
WEB_N = (32, 512, 4096)     # the surrogate at config 1's n, the CPU check's, the big one
WEB_SEED = 15
WEB_MO_TRIALS = 32          # random ZDT1 trials for /pareto
WEB_FID_LINEAGES = 8        # Rosenbrock lineages at fidelity 1, 3, 9 for /lcurves
# card against CPU: importance absolute, the pdp curves over the
# objective's standard deviation. Wider than the fit bound GP_TOL["fit"]:
# 80 Adam steps of an f32 fit at n 512 carry rounding far, so that moving
# each objective by one f32 ulp moves the reference's own importance by
# 3.4e-4 and its curves by 2.0e-3 sd (on these inputs, on the CPU); the
# card against the CPU measured 1.0e-4 and 4.9e-4 sd there (H100 80GB HBM3)
WEB_TOL = {"importance": 1e-3, "pdp_sd": 5e-3}


def start_web(args, root: Path, env):
    """``python -m metaopt_tpu_torch web ARGS`` in a fresh process; a thread
    drains its output and stamps its listening line."""
    import threading

    h = {"lines": [], "ready": threading.Event(), "t0": time.perf_counter()}
    h["proc"] = subprocess.Popen([sys.executable, "-m", "metaopt_tpu_torch", "web", *args],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 env=env, cwd=root)

    def drain():
        for line in h["proc"].stdout:
            h["lines"].append(line)
            if line.startswith("webapi listening on http://"):
                h["url"] = line.split()[-1]
                h["ready_at"] = time.perf_counter()
                h["ready"].set()

    threading.Thread(target=drain, name="web", daemon=True).start()
    return h


def fetch(url: str):
    """(status, body bytes, ms) of one GET, error statuses included."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as err:
        code, body = err.code, err.read()
    return code, body, (time.perf_counter() - t0) * 1e3


def surrogate_rows(np, n: int, seed: int):
    """n unit-cube rows in 2-d and a smooth objective with noise."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2)).astype(np.float32)
    y = (np.sin(6.0 * X[:, 0]) + 4.0 * (X[:, 1] - 0.3) ** 2
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def surrogate_diff(torch, G, np, X, y):
    """Card against CPU for one input: (importance max |diff|, pdp curves'
    max |diff| over the objective's std)."""
    imp = [G.ard_importance(X, y, device=d) for d in ("cuda", "cpu")]
    pdp = [G.partial_dependence(X, y, device=d)[1] for d in ("cuda", "cpu")]
    fin = y[np.isfinite(y)]
    return (float(np.abs(imp[0] - imp[1]).max()),
            float(np.abs(pdp[0] - pdp[1]).max()) / float(fin.std() + 1e-8))


def surrogate_call(torch, fn, how: str = "both"):
    """(stats, result) of one surrogate call ``fn``, by ``how``:

    - ``both``: host ms and peak memory over one synchronized call, device
      ms and CUDA kernels from torch.profiler (CUDA activity only) over
      one more;
    - ``traced``: one call under the profiler gives all four (host ms then
      includes the profiler's recording, not its post-processing, which
      costs ~5 s at 35k kernels): for a fit at n 4096, whose device time
      dwarfs the recording;
    - ``events``: one call, device ms by CUDA events around it (the busy
      time of a device-bound call), no kernel count.
    """
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() - base,
                start.elapsed_time(end), res)

    t_all = time.perf_counter()
    st = {"how": how, "device_ms": None, "cuda_kernels": None}
    if how != "traced":
        st["host_ms"], st["peak_bytes"], ev_ms, res = timed()
        if how == "events":
            st["device_ms"] = ev_ms
    if how != "events":
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if how == "traced":
                    st["host_ms"], st["peak_bytes"], _, res = timed()
                else:
                    fn()
                    torch.cuda.synchronize()
            rows = kernel_rows(prof, 1)
            st["device_ms"], st["cuda_kernels"] = (sum(r[1] for r in rows),
                                                   sum(r[2] for r in rows))
        except Exception as err:  # the profiler is a measurement aid only
            log(f"  (torch.profiler unavailable: {type(err).__name__}: {err})")
            if "host_ms" not in st:
                st["host_ms"], st["peak_bytes"], _, res = timed()
    st["wall_s"] = time.perf_counter() - t_all
    return st, res


def web_equal(a, b, tol: float = 0.0, path: str = "") -> None:
    """a == b, floats within ``tol``; raises naming the first difference."""
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        for k in a:
            web_equal(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            web_equal(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if not abs(a - b) <= tol:
            raise AssertionError(f"[web] {path}: {a!r} != {b!r} (tol {tol:g})")
    elif a != b:
        raise AssertionError(f"[web] {path}: {str(a)[:200]} != {str(b)[:200]}")


def web_phase(torch, smi: str, ledger_root: Path):
    """``web`` and ``plot`` over [ledger]'s native directory: its config-1
    ``rosen`` (32 trials), the 15,000-trial EVC ``parent`` and the TPE
    ``child``, plus a ZDT1 run and a fidelity run written here."""
    import numpy as np

    from metaopt_tpu_torch.algo import gp_bo as G
    from metaopt_tpu_torch.io import webapi
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.ledger.backends import ledger_from_spec
    from metaopt_tpu_torch.models.objectives import rosenbrock
    from metaopt_tpu_torch.space import build_space

    repo = Path(__file__).resolve().parent
    bare = str(ledger_root / "ledger")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = {"card": smi}
    part_s, last = {}, [time.perf_counter()]

    def mark(part: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        part_s[part] = now - last[0]
        last[0] = now

    # -- (a) `web` on the card, booting while (b) and (c) run here -----------
    h = start_web(["--ledger", bare, "--port", "0"], ledger_root, env)
    server = None
    try:
        led = ledger_from_spec(bare)
        rng = np.random.default_rng(WEB_SEED)
        mo = Experiment("mo", led, space=build_space({"x": "uniform(0, 1)",
                                                      "y": "uniform(0, 1)"}),
                        algorithm={"random": {}}, max_trials=WEB_MO_TRIALS).configure()
        for x, y in rng.random((WEB_MO_TRIALS, 2)).tolist():
            p = {"x": x, "y": y}
            mo.register_trials([mo.make_trial(p)])
            mo.push_results(mo.reserve_trial("w0"), zdt1(p))
        fid = Experiment("fid", led, space=build_space({**ROSEN_SPACE,
                                                        "epochs": "fidelity(1, 9, base=3)"}),
                         algorithm={"random": {}}, max_trials=3 * WEB_FID_LINEAGES).configure()
        for x, y in rng.uniform(-5.0, 10.0, (WEB_FID_LINEAGES, 2)).tolist():
            for e in (1, 3, 9):
                p = {"x": x, "y": y, "epochs": e}
                fid.register_trials([fid.make_trial(p)])
                fid.push_results(fid.reserve_trial("w0"), [
                    {"name": "objective", "type": "objective",
                     "value": rosenbrock(p) * (1.0 + 1.0 / e)}])
        counts = {n: led.count(n, "completed") for n in ("rosen", "parent", "child", "mo", "fid")}
        if counts != {"rosen": ROSEN_TRIALS, "parent": LEDGER_PARENT,
                      "child": LEDGER_CHILD_TRIALS, "mo": WEB_MO_TRIALS,
                      "fid": 3 * WEB_FID_LINEAGES}:
            raise AssertionError(f"[web] the ledger holds {counts} completed trials")
        mark("ledger")

        # -- (b) every route in-process, the surrogate on the card ----------
        server = webapi.make_server(led, device="cuda")
        webapi.start_in_thread(server)
        base = "http://%s:%d" % server.server_address[:2]
        routes = [("", 200), ("healthz", 200), ("dashboard", 200), ("experiments", 200),
                  ("experiments/ghost", 404), ("nope", 404),
                  ("experiments/rosen/trials?status=bogus", 400),
                  ("experiments/rosen/lcurves", 400), ("experiments/rosen/pareto", 400)]
        for name in ("rosen", "child", "mo", "fid"):
            routes += [(f"experiments/{name}{tail}", 200)
                       for tail in ("", "/trials?status=completed", "/regret", "/parallel",
                                    "/workers")]
        # the size a dashboard polls on a long sweep
        routes += [(f"experiments/parent/{tail}", 200)
                   for tail in ("trials?status=completed", "regret", "parallel")]
        routes += [("experiments/fid/lcurves", 200), ("experiments/mo/pareto", 200),
                   ("experiments/rosen/importance", 200), ("experiments/rosen/pdp", 200)]
        answers, per_route = {}, {}
        for path, want in routes:
            code, body, ms = fetch(f"{base}/{path}")
            if code != want:
                raise AssertionError(f"[web] GET /{path}: {code}, expected {want}: "
                                     f"{body[:500]!r}")
            answers[path] = body
            per_route[path] = {"status": code, "ms": ms, "bytes": len(body)}
        for path in ("experiments/rosen/importance", "experiments/rosen/pdp"):
            # the first fit paid the card's first cuSOLVER and autograd calls
            per_route[path]["warm_ms"] = fetch(f"{base}/{path}")[2]
        out["routes"] = per_route
        log("[web] (b) in-process, ms / bytes: " + "; ".join(
            f"/{p} {r['ms']:.1f} / {r['bytes']}" for p, r in per_route.items())
            + f"; card {smi}")
        mark("routes")

        # the `web` process's answers, fetched in a thread as soon as it
        # listens, while (c) runs here
        import threading

        remote = {}

        def fetch_remote():
            if h["ready"].wait(max(0.0, WEB_READY_S - (time.perf_counter() - h["t0"]))):
                for path, _ in routes:
                    remote[path] = fetch(f"{h['url']}/{path}")

        fetcher = threading.Thread(target=fetch_remote, name="web-fetch", daemon=True)
        fetcher.start()

        # -- (c) the surrogate on the card against the CPU, and its cost ----
        (cube, X32, y32), _ = webapi._surrogate_inputs(led, "rosen")
        inputs = {32: (X32, y32)}
        for n in WEB_N[1:]:
            inputs[n] = surrogate_rows(np, n, WEB_SEED + n)
        diffs = {}
        for n in WEB_N[:2]:
            t0 = time.perf_counter()
            imp_err, pdp_err = surrogate_diff(torch, G, np, *inputs[n])
            diffs[n] = {"importance_max_abs": imp_err, "pdp_max_abs_over_sd": pdp_err,
                        "wall_s": time.perf_counter() - t0}
        out["card_vs_cpu"] = diffs
        if any(d["importance_max_abs"] > WEB_TOL["importance"]
               or d["pdp_max_abs_over_sd"] > WEB_TOL["pdp_sd"] for d in diffs.values()):
            raise AssertionError(f"[web] the surrogate, card against CPU: {diffs} "
                                 f"(bounds {WEB_TOL})")
        calls = {}
        # pdp's fit is importance's, plus one Cholesky and d mat-vecs (87
        # kernels at n 32): it is timed by CUDA events only, sparing a trace
        # post-processing of 4-9 s a call
        for n, hows in ((WEB_N[0], ("both", "events")), (WEB_N[-1], ("traced", "events"))):
            X, y = inputs[n]
            for label, fn, how in (
                    ("importance", lambda: G.ard_importance(X, y, device="cuda"), hows[0]),
                    ("pdp", lambda: G.partial_dependence(X, y, device="cuda")[1], hows[1])):
                calls[f"{label}_n{n}"], res = surrogate_call(torch, fn, how)
                if not np.isfinite(res).all():
                    raise AssertionError(f"[web] {label} at n {n} is not finite: {res}")
        out["surrogate"] = calls
        log(f"[web] (c) card vs cpu: {diffs} (bounds {WEB_TOL}); per call: " + "; ".join(
            f"{k} host {v['host_ms']:.1f} ms, device {v['device_ms']} ms, {v['cuda_kernels']} "
            f"kernels, peak {v['peak_bytes'] / 2**20:.1f} MiB" for k, v in calls.items())
            + f"; card {smi}")
        mark("surrogate")

        # -- (d) the `web` process and `plot` give the same JSON ------------
        fetcher.join(WEB_READY_S + 300)
        if not h["ready"].is_set() or len(remote) != len(routes):
            raise AssertionError(f"[web] web not listening in {WEB_READY_S} s, or it answered "
                                 f"{len(remote)} of {len(routes)} routes:\n"
                                 + "".join(h["lines"])[-3000:])
        out["web_ready_s"] = h["ready_at"] - h["t0"]
        out["web_process"] = {}
        for path, want in routes:
            code, body, ms = remote[path]
            if code != want:
                raise AssertionError(f"[web] the web process: GET /{path}: {code}: "
                                     f"{body[:500]!r}")
            out["web_process"][path] = {"ms": ms, "bytes": len(body)}
            if path == "dashboard":
                if body != answers[path]:
                    raise AssertionError("[web] the dashboards differ")
                continue
            a, b = json.loads(body), json.loads(answers[path])
            if path.endswith("/workers"):   # the age at the request's time
                a, b = ([{k: v for k, v in r.items() if k != "last_seen_age_s"} for r in x]
                        for x in (a, b))
            tol = 0.0
            if path.endswith("/importance"):
                tol = WEB_TOL["importance"]
            elif path.endswith("/pdp"):
                tol = WEB_TOL["pdp_sd"] * float(y32.std() + 1e-8)
            web_equal(a, b, tol, path)
        plots = {}
        for kind, name, path in (("regret", "rosen", "regret"), ("lcurve", "fid", "lcurves"),
                                 ("parallel", "rosen", "parallel"),
                                 ("importance", "rosen", "importance"),
                                 ("pdp", "rosen", "pdp"), ("pareto", "mo", "pareto")):
            t0 = time.perf_counter()
            rc, text = cli_in_process(["plot", kind, "-n", name, "--ledger", bare, "--json"])
            plots[kind] = (time.perf_counter() - t0) * 1e3
            if rc != 0:
                raise AssertionError(f"[web] plot {kind} returned {rc}: {text[-2000:]}")
            tol = {"importance": WEB_TOL["importance"],
                   "pdp": WEB_TOL["pdp_sd"] * float(y32.std() + 1e-8)}.get(kind, 0.0)
            web_equal(json.loads(text), json.loads(answers[f"experiments/{name}/{path}"]),
                      tol, f"plot {kind}")
        out["plot_ms"] = plots
        log(f"[web] (d) `web` listening {out['web_ready_s']:.2f} s after spawn; every route's "
            f"JSON equal to in-process (surrogate within {WEB_TOL}), ms (fetched while (c) "
            f"ran): " + "; ".join(f"/{p} {r['ms']:.1f}" for p, r in out["web_process"].items())
            + "; plot --json equal to the routes, ms: "
            + ", ".join(f"{k} {v:.1f}" for k, v in plots.items()))
        mark("web_and_plot")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        proc = h["proc"]
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)   # serve_forever closes and returns
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    out["part_s"] = part_s
    log("[web] part seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in part_s.items()))
    return out


def analysis_phase(torch, smi: str):
    """The checkers on the card's host and the race detector's device legs.

    (a) ``python -m metaopt_tpu_torch analyze`` over the port's tree in a
    subprocess (no torch there), running while (b) does: exit 0, and no
    finding beyond the port's baselines (which are empty).
    (b) The two legs of ``race``'s coord suite that drive device code, at
    scale 1 on ``cuda``, each under its own ``RaceRuntime`` through the
    port's ``instrument()`` (``analysis/runner.py::run_race_leg``, which
    makes the CUDA context first): two batched ``workon`` loops sharing one
    ``BatchedExecutor`` whose objective is a tensor expression on the card,
    and the fuser's bucket launches racing the RPC threads' produce legs
    over four hosted TPEs on the card. No MTR101/MTR102 may appear, and the
    fuser must launch buckets (else the leg is vacuous).
    """
    from metaopt_tpu_torch.analysis import suites
    from metaopt_tpu_torch.analysis.runner import run_race_leg

    repo = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = {"card": smi}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "metaopt_tpu_torch", "analyze",
                             "--format", "json"], cwd=str(repo), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        legs = {}
        for name, leg in (("batched", suites._coord_batched_phase),
                          ("fuser", suites._coord_fuser_phase)):
            t1 = time.perf_counter()
            findings, events, tel = run_race_leg(leg, 1, "cuda")
            legs[name] = {"seconds": time.perf_counter() - t1, "events": events,
                          "findings": [f.render() for f in findings], "telemetry": tel}
            log(f"[analysis] (b) race leg {name} on cuda: {len(findings)} MTR101/MTR102 "
                f"finding(s), {events} events, {legs[name]['seconds']:.2f} s; {tel}; "
                f"card {smi}")
            for f in findings:
                log("  " + f.render().replace("\n", "\n  "))
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    analyze_s = time.perf_counter() - t0
    doc = json.loads(stdout) if proc.returncode in (0, 1) and stdout.strip() else {}
    log(f"[analysis] (a) analyze over metaopt_tpu_torch: exit {proc.returncode}, "
        f"{len(doc.get('findings', []))} finding(s) beyond the baselines "
        f"({doc.get('grandfathered')} grandfathered), lint {doc.get('lint_runtime_s')} s + "
        f"crashcheck {doc.get('crashcheck_runtime_s')} s, {analyze_s:.2f} s wall with (b) "
        f"running beside it; card {smi}")
    if proc.returncode != 0 or doc.get("findings"):
        raise AssertionError(f"analyze failed (exit {proc.returncode}): "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    bad = {k: v["findings"] for k, v in legs.items() if v["findings"]}
    if bad:
        raise AssertionError(f"race findings on the card: {bad}")
    fuser = legs["fuser"]["telemetry"]
    if fuser["bucket_launches"] <= 0 or fuser["launch_errors"]:
        raise AssertionError(f"the fuser leg launched no bucket on the card: {fuser}")
    if legs["batched"]["telemetry"]["rows_evaluated"] != 16:
        raise AssertionError(f"the batched leg: {legs['batched']['telemetry']}")
    out.update(analyze={"exit": proc.returncode, "findings": doc["findings"],
                        "total": doc["total"], "lint_runtime_s": doc["lint_runtime_s"],
                        "crashcheck_runtime_s": doc["crashcheck_runtime_s"],
                        "wall_s": analyze_s},
               race_legs=legs)
    return out


# ---------------------------------------------------------------------------
# phase 21: several ranks sharing the card

MESH_RANKS = 4              # one launch: four ranks on cuda:0 (gloo: NCCL refuses a shared GPU)
MESH_CALL_S = 240           # one leg's deadline inside the ranks
MESH_TFM = dict(n_train=64, batch_size=32, seq_len=64, seed=21)   # (a): config 4's model
MESH_TFM_STEPS, MESH_DROP_STEPS = 5, 2
# (a)'s losses against one rank's, relative: tests/test_torch_mesh_models.py's
# bound for the mesh against one rank (1.6e-4 measured there on the CPU)
MESH_TFM_TOL = 2e-3
MESH_ATT = (8, 512, 8, 64)  # (b): B, S, H, D, causal
MESH_LM = dict(n_train=8, batch_size=4, seq_len=512, steps=2, seed=22)   # (c): [lm]'s model
MESH_PP = dict(d_model=512, n_heads=8, d_ff=2048, vocab=1000)  # (d): pp 2 x V 2, 4 layers
MESH_PP_SHAPE = (8, 64)     # (d): batch x seq, 4 microbatches
MESH_POD_TRIALS = 8


def _mesh_rank():
    """(torch, this rank's device, the attention module), TF32 off as in main."""
    import torch

    from metaopt_tpu_torch.ops import attention as att
    from metaopt_tpu_torch.parallel import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, launch.rank_device(), att


def _mesh_counts(att, coll):
    return {"launches": dict(att.launches), "dropout_launches": dict(att.dropout_launches),
            "host_bytes": dict(coll.host_bytes), "calls": dict(coll.calls)}


def mesh_leg_tfm():
    """(a) Transformer-base at full width on dp 2 x tp 2: MESH_TFM_STEPS steps
    at dropout 0 (the main path, counted), then MESH_DROP_STEPS at 0.1."""
    torch, dev, att = _mesh_rank()
    from metaopt_tpu_torch.models import transformer as tfm
    from metaopt_tpu_torch.parallel import collectives as coll, make_mesh

    mesh = make_mesh([("dp", 2), ("tp", 2)])
    out = {}
    for label, rate, steps in (("rate0", 0.0, MESH_TFM_STEPS), ("rate0.1", 0.1, MESH_DROP_STEPS)):
        att.reset_launch_counts()
        coll.reset_counts()
        rep = {}
        tfm.train_and_eval({"dropout": rate}, mesh=mesh, device=dev, steps=steps, report=rep,
                           **MESH_TFM)
        torch.cuda.synchronize()
        out[label] = {"losses": rep["losses"], "ms_per_step": rep["train_s"] / steps * 1e3,
                      "mesh": rep["mesh"], **_mesh_counts(att, coll)}
    return out


def mesh_leg_attention():
    """(b) one attention layer at MESH_ATT, causal, on dp 2 x sp 2: ring and
    Ulysses forward and backward, f32 and bf16, against the one-rank
    ``flash_attention`` on the same card (its launches are comparisons)."""
    torch, dev, att = _mesh_rank()
    from metaopt_tpu_torch.ops.ring_attention import ring_attention
    from metaopt_tpu_torch.ops.ulysses import ulysses_attention
    from metaopt_tpu_torch.parallel import collectives as coll, make_mesh
    from metaopt_tpu_torch.parallel.sharding import MeshAxes

    mesh = make_mesh([("dp", 2), ("sp", 2)])
    ax = MeshAxes(mesh)
    b, s, h, d = MESH_ATT
    res = {"errors": {}, "ulysses_launches": {}}
    coll.reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(5)
        q = (torch.randn(b, s, h, d, generator=gen, device=dev) / math.sqrt(d)).to(dtype)
        k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype) for _ in "kvg")
        mask = torch.tril(torch.ones(s, s, dtype=torch.int8, device=dev))[None].expand(b, s, s)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        ref = att.flash_attention(qr, kr, vr, mask)
        ref.backward(g)
        want = {"out": ref.detach(), "dq": qr.grad, "dk": kr.grad, "dv": vr.grad}
        tol = TOL[str(dtype).split(".")[-1]]
        for impl in ("ring", "ulysses"):
            ql, kl, vl = (ax.local(t, ("dp", "sp")).detach().requires_grad_() for t in (q, k, v))
            saved = dict(att.launches)
            att.reset_launch_counts()
            if impl == "ring":
                out = ring_attention(ql, kl, vl, ax.local(mask, ("dp", "sp")), mesh=mesh)
            else:
                out = ulysses_attention(ql, kl, vl, ax.local(mask, ("dp",)), mesh=mesh)
            out.backward(ax.local(g, ("dp", "sp")))
            torch.cuda.synchronize()
            if impl == "ulysses" and dtype == torch.bfloat16:
                res["ulysses_launches"] = dict(att.launches)
            att.launches.update(saved)
            got = {"out": out.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad}
            for name, t in got.items():
                ref = ax.local(want[name], ("dp", "sp"))
                if dtype == torch.float32:
                    e, ok = close(t, ref, tol["fwd" if name == "out" else "grad"])
                else:
                    # bf16: the bound relative to the tensor's scale (the ring's
                    # f32 fold and autograd round once; the kernels round P and
                    # dS to bf16 operands)
                    scale = float(ref.float().abs().max())
                    e = float((t.float() - ref.float()).abs().max()) / scale
                    ok = e <= tol["grad"]
                key = f"{impl} {str(dtype).split('.')[-1]} {name}"
                res["errors"][key] = e
                if not (ok and bool(torch.isfinite(t.float()).all())):
                    raise AssertionError(f"[mesh] (b) {key}: {e:.3e} outside "
                                         f"{tol} or non-finite")
    res.update(_mesh_counts(att, coll))
    return res


def mesh_lm_dropped(lm, tfm, hp, mesh, dev):
    """The MoE LM's dropped fraction per layer on MESH_LM's first batch."""
    import torch

    from metaopt_tpu_torch.parallel.mesh import use_mesh
    from metaopt_tpu_torch.parallel.sharding import shard_batch

    model = tfm.mesh_model(lm.make_lm, dict(hp, max_len=MESH_LM["seq_len"]), mesh, dev,
                           MESH_LM["seed"])
    toks = lm.synthetic_lm(MESH_LM["n_train"], MESH_LM["seq_len"] + 1, model.vocab,
                           seed=MESH_LM["seed"], device=dev)[:MESH_LM["batch_size"]]
    if mesh is not None:
        toks = shard_batch(model.axes, toks)
    stats = {}
    with use_mesh(mesh), torch.no_grad():
        lm.lm_loss_fn(model, toks, stats=stats)
    return [float(t) for t in stats["moe_stats"]]


def mesh_leg_lm():
    """(c) the LM at full width on dp 2 x sp 2 (ring attention), then, with
    LM_MOE[0], on dp 2 x ep 2: MESH_LM's steps each, and the MoE's dropped
    fractions."""
    torch, dev, att = _mesh_rank()
    from metaopt_tpu_torch.models import lm, transformer as tfm
    from metaopt_tpu_torch.parallel import collectives as coll, make_mesh

    out = {}
    for label, axes, hp in (("sp2", [("dp", 2), ("sp", 2)], {"dropout": 0.0}),
                            ("ep2", [("dp", 2), ("ep", 2)], {"dropout": 0.0, **LM_MOE[0]})):
        mesh = make_mesh(axes)
        att.reset_launch_counts()
        coll.reset_counts()
        rep = {}
        lm.train_lm(hp, mesh=mesh, device=dev, report=rep, **MESH_LM)
        torch.cuda.synchronize()
        out[label] = {"losses": rep["losses"], **_mesh_counts(att, coll)}
        if "n_experts" in hp:
            out[label]["dropped"] = mesh_lm_dropped(lm, tfm, hp, mesh, dev)
    return out


def mesh_leg_pp():
    """(d) ``make_pp_train_step`` at pp 2 x V 2 (x dp 2): one step against
    the same loss through ``reference_forward``'s sequential stack."""
    torch, dev, att = _mesh_rank()
    import torch.nn.functional as F

    from metaopt_tpu_torch.models import pipeline_lm as plm
    from metaopt_tpu_torch.parallel import collectives as coll, make_mesh
    from metaopt_tpu_torch.parallel.sharding import MeshAxes

    mesh = make_mesh([("pp", 2), ("dp", 2)])
    b, s = MESH_PP_SHAPE
    fns, params = plm.make_pipeline_lm(MESH_PP, 2, 2, seq=s, seed=3, device=dev)
    toks = torch.randint(1, MESH_PP["vocab"], (b, s),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    att.reset_launch_counts()
    coll.reset_counts()
    loss, grads = plm.make_pp_train_step(fns, mesh, n_microbatches=4, virtual_stages=2)(
        params, MeshAxes(mesh).chunk(toks, 0, "dp"))
    torch.cuda.synchronize()
    counts = _mesh_counts(att, coll)
    leaves = [t.detach().clone().requires_grad_() for t in plm.tree_leaves(params)]
    it = iter(leaves)
    tree = plm.tree_map(lambda _: next(it), params)
    logits = plm.reference_forward(fns, tree, toks)
    want = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1))
    want.backward()
    # every gradient against its tensor's scale, but the k projections'
    # biases: zero in exact arithmetic (softmax ignores a shift along the
    # keys), so both hold bf16 noise only
    names = [f"stage.{k}" for k in params[0]] + [f"pre.{k}" for k in params[1]] + \
        [f"post.{k}" for k in params[2]]
    worst = max(float((g - t.grad).abs().max() / t.grad.abs().max().clamp_min(1e-30))
                for name, g, t in zip(names, plm.tree_leaves(grads), leaves)
                if not name.endswith("k.bias"))
    return {"loss": float(loss), "sequential_loss": float(want.detach()), "grad_rel_err": worst,
            **counts}


def mesh_leg_pod():
    """(e) ``start_pod_coordinator`` across the ranks, every rank's
    ``workon`` against it, and ``run_signaled`` with one rank asking to
    stop."""
    torch, dev, att = _mesh_rank()
    import torch.distributed as dist

    from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient
    from metaopt_tpu_torch.coord.pod import start_pod_coordinator
    from metaopt_tpu_torch.executor import InProcessExecutor
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.parallel import collectives as coll, make_mesh, run_signaled
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.worker import workon

    rank = dist.get_rank()
    host, port, server = start_pod_coordinator(stale_timeout_s=60.0, device=dev)
    try:
        ledger = CoordLedgerClient(host=host, port=port, io_timeout_s=30.0)
        if rank == 0:
            exp = Experiment("mesh-pod", ledger, space=build_space({"x": "uniform(-5, 5)"}),
                             max_trials=MESH_POD_TRIALS, pool_size=2,
                             algorithm={"random": {"seed": 0}}).configure()
        coll.any_flag(False)
        if rank != 0:
            exp = Experiment("mesh-pod", ledger).configure()
        stats = workon(exp, InProcessExecutor(lambda p: (p["x"] - 1.0) ** 2),
                       worker_id=f"mesh-w{rank}")
        done = exp.count("completed")
        state = {"n": 0}

        def step(c):
            state["n"] += 1
            return c + torch.ones((), device=dev)

        carry, steps, stopped = run_signaled(
            step, torch.zeros((), device=dev), mesh=make_mesh([("dp", 4)]),
            should_stop=lambda: rank == 1 and state["n"] >= 3, max_steps=100, check_every=2)
        coll.any_flag(False)   # the host outlives every other rank's last call
        return {"server": server is not None, "addr": [host, port], "done": done,
                "events": [e["trial"] for e in stats.events], "steps": steps,
                "stopped": stopped, "carry": float(carry)}
    finally:
        if server is not None:
            server.stop()


def mesh_phase(torch, smi: str):
    """Phase 21: one launch of MESH_RANKS ranks sharing ``cuda:0`` runs legs
    (a)-(e); the one-rank references run in this process first, the kernel
    times at the ranks' shapes after the ranks are gone."""
    from metaopt_tpu_torch.models import lm, transformer as tfm
    from metaopt_tpu_torch.ops import attention as att
    from metaopt_tpu_torch.parallel import collectives as coll
    from metaopt_tpu_torch.parallel.launch import RankPool

    t0 = time.perf_counter()
    saved = dict(att.launches), dict(att.dropout_launches)
    one = {}
    rep = {}
    tfm.train_and_eval({"dropout": 0.0}, device="cuda", steps=MESH_TFM_STEPS, report=rep,
                       **MESH_TFM)
    one["tfm"] = rep["losses"]
    for label, hp in (("sp2", {"dropout": 0.0}), ("ep2", {"dropout": 0.0, **LM_MOE[0]})):
        rep = {}
        lm.train_lm(hp, device="cuda", report=rep, **MESH_LM)
        one[label] = rep["losses"]
    one["dropped"] = mesh_lm_dropped(lm, tfm, {"dropout": 0.0, **LM_MOE[0]}, None,
                                     torch.device("cuda"))
    torch.cuda.synchronize()
    att.launches.update(saved[0])     # the references' launches are comparisons
    att.dropout_launches.update(saved[1])
    ref_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    with RankPool(["cuda:0"] * MESH_RANKS, timeout_s=MESH_CALL_S) as pool:
        start_s = time.perf_counter() - t1
        log(f"[mesh] {MESH_RANKS} ranks on cuda:0 (ranks per GPU {MESH_RANKS}), backend "
            f"{pool.backend}, started in {start_s:.1f} s; the ring hop alone goes through the "
            f"host (gloo's point-to-point refuses CUDA tensors); NCCL across separate GPUs "
            f"was not exercised on this machine (one card)")
        legs, leg_s = {}, {}
        for name, fn in (("tfm", mesh_leg_tfm), ("attention", mesh_leg_attention),
                         ("lm", mesh_leg_lm), ("pp", mesh_leg_pp), ("pod", mesh_leg_pod)):
            tl = time.perf_counter()
            legs[name] = pool.run(fn)
            leg_s[name] = time.perf_counter() - tl
    ranks_s = time.perf_counter() - t1

    # (a) the counted path: every rank, 18 launches per step and kernel
    tf = legs["tfm"]
    want = {n: 18 * MESH_TFM_STEPS for n in att.launches}
    for r, part in enumerate(tf):
        if part["rate0"]["launches"] != want:
            raise AssertionError(f"[mesh] (a) rank {r} launches {part['rate0']['launches']} "
                                 f"!= {want}")
        if part["rate0.1"]["dropout_launches"] != {n: 18 * MESH_DROP_STEPS for n in want}:
            raise AssertionError(f"[mesh] (a) rank {r} dropout launches "
                                 f"{part['rate0.1']['dropout_launches']}")
    tf_err = max(abs(a - b) / abs(b) for a, b in zip(tf[0]["rate0"]["losses"], one["tfm"]))
    drop_ok = all(math.isfinite(x) for x in tf[0]["rate0.1"]["losses"])
    log(f"[mesh] (a) Transformer-base dp 2 x tp 2, B {MESH_TFM['batch_size']} x S "
        f"{MESH_TFM['seq_len']}: losses {tf[0]['rate0']['losses']} against one rank "
        f"{one['tfm']}: max rel {tf_err:.2e} (bound {MESH_TFM_TOL:g}); {tf[0]['rate0']['ms_per_step']:.1f} "
        f"ms/step on rank 0 (4 ranks sharing the card, gloo); launches per rank "
        f"{tf[0]['rate0']['launches']} = 18/step; rate 0.1 losses {tf[0]['rate0.1']['losses']}")
    if not (tf_err <= MESH_TFM_TOL and drop_ok):
        raise AssertionError("[mesh] (a) the mesh run disagrees with one rank")
    # (b)
    at_errs = {k: max(p["errors"][k] for p in legs["attention"])
               for k in legs["attention"][0]["errors"]}
    log("[mesh] (b) ring / Ulysses sp 2 (x dp 2) at (8, 512, 8, 64) causal against one-rank "
        "flash_attention (f32: max abs error, bounds 1e-5 / 1e-4; bf16: max error over the "
        "tensor's scale, bound 3e-2): " + ", ".join(f"{k} {e:.2e}" for k, e in at_errs.items())
        + f"; Ulysses bf16 launches per rank {legs['attention'][0]['ulysses_launches']}")
    # (c)
    lmr = legs["lm"][0]
    lm_err = {k: max(abs(a - b) / abs(b) for a, b in zip(lmr[k]["losses"], one[k]))
              for k in ("sp2", "ep2")}
    drop_diff = max(abs(a - b) for a, b in zip(lmr["ep2"]["dropped"], one["dropped"]))
    item = 1.0 / (MESH_LM["batch_size"] * MESH_LM["seq_len"])   # one item's share
    log(f"[mesh] (c) LM d_model 512 x 6 layers, B {MESH_LM['batch_size']} x S "
        f"{MESH_LM['seq_len']}: sp 2 losses {lmr['sp2']['losses']} vs one rank {one['sp2']} "
        f"(rel {lm_err['sp2']:.2e}); ep 2 {LM_MOE[0]} losses {lmr['ep2']['losses']} vs "
        f"{one['ep2']} (rel {lm_err['ep2']:.2e}); dropped fractions {lmr['ep2']['dropped']} "
        f"vs {one['dropped']} (max diff {drop_diff:.2e}, one item {item:.2e})")
    if not (max(lm_err.values()) <= 3e-2 and drop_diff <= 2 * item):
        raise AssertionError("[mesh] (c) the LM on the mesh disagrees with one rank")
    # (d)
    pp = legs["pp"][0]
    pp_rel = abs(pp["loss"] - pp["sequential_loss"]) / abs(pp["sequential_loss"])
    log(f"[mesh] (d) pp 2 x V 2 (x dp 2) pipeline LM step: loss {pp['loss']:.6f} vs sequential "
        f"{pp['sequential_loss']:.6f} (rel {pp_rel:.2e}); gradients max rel to scale "
        f"{pp['grad_rel_err']:.2e} (bound 3e-2); launches {pp['launches']}")
    if not (pp_rel <= 1e-3 and pp["grad_rel_err"] <= 3e-2):
        raise AssertionError("[mesh] (d) the pipeline step disagrees with the sequential stack")
    # (e)
    pods = legs["pod"]
    executed = [t for p in pods for t in p["events"]]
    log(f"[mesh] (e) pod: rank 0 hosts {pods[0]['addr']}, agreed by all "
        f"{len({tuple(p['addr']) for p in pods}) == 1}; {len(executed)} trials, none twice "
        f"{len(executed) == len(set(executed))}; run_signaled stopped at steps "
        f"{[p['steps'] for p in pods]}")
    if not ([p["server"] for p in pods] == [True, False, False, False]
            and len({tuple(p["addr"]) for p in pods}) == 1
            and len(executed) == len(set(executed))
            and all(p["done"] >= MESH_POD_TRIALS for p in pods)
            and [(p["steps"], p["stopped"]) for p in pods] == [(4, True)] * MESH_RANKS):
        raise AssertionError("[mesh] (e) the pod coordinator or the agreed stop failed")
    staged = {}
    for leg in ("tfm", "attention", "lm", "pp"):
        for part in legs[leg]:
            for sub in ([part] if "host_bytes" in part else part.values()):
                for op, nb in sub.get("host_bytes", {}).items():
                    staged[op] = staged.get(op, 0) + nb
    log(f"[mesh] collectives copied through the host (all ranks, legs a-d): "
        f"{staged or 'none'} bytes; legs' seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in leg_s.items()))

    # K1-K3 at the ranks' shapes, timed alone (the ranks are gone)
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, s, h, d = MESH_ATT
    shard_cases = {
        "tp": make_case(torch, "mesh (a) shard bf16 (16,64,4,64)", MESH_TFM["batch_size"] // 2,
                        MESH_TFM["seq_len"], MESH_TFM["seq_len"], 4, 64, torch.bfloat16,
                        "pad", gen),
        "ulysses": make_case(torch, "mesh (b) Ulysses shard bf16 (4,512,4,64)", b // 2, s, s,
                             h // 2, d, torch.bfloat16, "causal", gen),
    }
    times = {}
    for key, case in shard_cases.items():
        log(f"[mesh] times at {case['name']}:")
        lse_delta = check_case(torch, att, case)[1]
        times[key] = time_case(torch, att, case, lse_delta)
    phase_s = time.perf_counter() - t0
    log(f"[mesh] phase {phase_s:.1f} s (references {ref_s:.1f}, ranks {ranks_s:.1f} of which "
        f"start {start_s:.1f}); card {smi}; nothing here is a multi-GPU figure")
    launches = {n: sum(p["rate0"]["launches"][n] for p in tf) for n in att.launches}
    return {"phase_s": phase_s, "reference_s": ref_s, "ranks_s": ranks_s, "start_s": start_s,
            "leg_s": leg_s, "backend": "gloo", "ranks_per_gpu": MESH_RANKS,
            "host_staged_ops": sorted(staged), "host_bytes": staged,
            "nccl_separate_gpus": "not exercised (one card)",
            "tfm": {"losses": tf[0]["rate0"]["losses"], "one_rank": one["tfm"],
                    "max_rel": tf_err, "ms_per_step": tf[0]["rate0"]["ms_per_step"],
                    "dropout_losses": tf[0]["rate0.1"]["losses"]},
            "attention_errors": at_errs, "lm": {"rel": lm_err, "dropped_diff": drop_diff},
            "pp": pp, "pod_steps": [p["steps"] for p in pods],
            "launches": launches, "launches_per_step": 18, "times": times, "card": smi}


# ---------------------------------------------------------------------------
# phase 22: the deadline sweep — run_swept, kill_by_env_marker, run_many_with_deadline

SWEEP_DEADLINE_S = 25       # the hunt's deadline under run_swept
SWEEP_MANY_DEADLINE_S = 20  # run_many_with_deadline's shared deadline
SWEEP_HOLD_BYTES = 1 << 30  # what the trial and its grandchild each hold on the card
SWEEP_MEM_TOL = 64 << 20    # free memory back to no less than its value before the hunt, less this
SWEEP_SETTLE_S = 15         # how long the card's contexts may take to settle before the phase
SWEEP_TRIAL = r'''
# A trial whose grandchild escapes its process group: the trial starts a
# grandchild in a session of its own, then each holds HOLD bytes on the card,
# writes its pids and sleeps. The hunt's next trial (after the first is
# killed) touches no card.
import os, subprocess, sys, time

t_start = time.time()
out = os.path.join(os.environ["SWEEP_DIR"], "pids")
flag = os.path.join(os.environ["SWEEP_DIR"], "spawned")
role = "grandchild" if "--grandchild" in sys.argv else "trial"
if role == "trial" and os.path.exists(flag):
    role = "retry"
else:
    if role == "trial":
        open(flag, "w").close()
        subprocess.Popen([sys.executable, __file__, "--grandchild"], start_new_session=True)
    import torch
    held = torch.ones(HOLD // 4, device="cuda")
    torch.cuda.synchronize()
with open(out, "a") as f:
    f.write(f"{role} {os.getpid()} {os.getpgid(0)} {os.getppid()} {t_start} {time.time()}\n")
print(role, "pid", os.getpid(), "pgid", os.getpgid(0), flush=True)
time.sleep(600)
'''
SWEEP_PROBE = "import torch; print(torch.cuda.get_device_name(), flush=True)"
SWEEP_SLEEPER = "import time; print('sleeping past the deadline', flush=True); time.sleep(600)"


def pid_alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie awaiting its reaper is dead)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_until(cond, timeout_s: float, poll_s: float = 0.1) -> bool:
    end = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > end:
            return False
        time.sleep(poll_s)
    return True


class TeeOut:
    """stdout that also keeps what was written."""

    def __init__(self, real):
        self.real, self.parts = real, []

    def write(self, text):
        self.parts.append(text)
        return self.real.write(text)

    def flush(self):
        self.real.flush()


def sweep_phase(torch, smi: str):
    """(b) A ``hunt --n-chips 1`` under ``run_swept`` past its deadline,
    its trial's grandchild in a session of its own holding the card; (c)
    ``run_many_with_deadline`` over two CUDA probes and a sleeper, started
    with (b). (b)'s checks wait until the probes are gone, and (b)'s log
    lines wait until (c) has ended, since (c) tees to this process's
    stdout."""
    import contextlib
    import threading

    from metaopt_tpu_torch.utils.procs import (kill_by_env_marker, marked_pids,
                                               run_many_with_deadline, run_swept)

    repo = Path(__file__).resolve().parent
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    trial = root / "trial.py"
    trial.write_text(SWEEP_TRIAL.replace("HOLD", str(SWEEP_HOLD_BYTES)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["SWEEP_DIR"] = str(root)
    env["TMPDIR"] = str(root)  # the hunt's GPU registry file is this phase's own
    env["MTPU_SLICE_CHIPS"] = "1"  # the hunt itself touches no card (no device count)
    marker = f"chip-smoke-sweep-{os.getpid()}-{time.time_ns()}"
    probe_marker = f"chip-smoke-probe-{os.getpid()}-{time.time_ns()}"
    argv = [sys.executable, "-m", "metaopt_tpu_torch", "hunt", "-n", "sweep", "--ledger",
            f"file:{root / 'ledger'}", "--max-trials", "2", "--n-chips", "1", str(trial),
            "-x~uniform(0, 1)"]
    py = sys.executable
    probe_env = dict(env, SWEEP_PROBE=probe_marker)
    jobs = [("probe0", [py, "-c", SWEEP_PROBE], probe_env),
            ("probe1", [py, "-c", SWEEP_PROBE], probe_env),
            ("sleeper", [py, "-c", SWEEP_SLEEPER], env)]
    out = {"card": smi, "deadline_s": SWEEP_DEADLINE_S, "hold_bytes": SWEEP_HOLD_BYTES}
    problems, notes = [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the checks read the whole card, so they assume that nothing else holds
    # it: wait until what an earlier phase started (a rank of [mesh] still
    # exiting) has let go, i.e. two readings a second apart agree
    last = [None]

    def settled():
        now = (torch.cuda.mem_get_info()[0], sorted(compute_apps(), key=repr))
        same, last[0] = now == last[0], now
        return same

    out["settled"] = wait_until(settled, SWEEP_SETTLE_S, 1.0)
    free0, apps0 = last[0][0], last[0][1]
    same_ns = os.getpid() in {p for p, _ in apps0}
    swept, many = {}, {}
    tee = TeeOut(sys.stdout)

    def hunt():
        try:
            swept["result"] = run_swept(argv, SWEEP_DEADLINE_S, env=env, marker=marker,
                                        cwd=str(root))
        except Exception as err:  # read below, on the main thread
            swept["error"] = err

    def labelled():
        try:
            with contextlib.redirect_stdout(tee):
                many["result"] = run_many_with_deadline(jobs, SWEEP_MANY_DEADLINE_S, poll_s=0.2)
        except Exception as err:  # read below, on the main thread
            many["error"] = err

    pids_path = root / "pids"

    def roles():
        found = {}
        if pids_path.exists():
            for line in pids_path.read_text().splitlines():
                role, pid, pgid, ppid, start, ready = line.split()
                found[role] = {"pid": int(pid), "pgid": int(pgid), "ppid": int(ppid),
                               "start_s": float(start) - wall0, "ready_s": float(ready) - wall0}
        return found

    t0, wall0 = time.perf_counter(), time.time()
    th = threading.Thread(target=hunt, daemon=True)
    tc = threading.Thread(target=labelled, daemon=True)
    th.start()
    tc.start()
    tree = {}
    try:
        # -- (b) the trial and its grandchild hold the card, the probes gone
        if not wait_until(lambda: {"trial", "grandchild"} <= set(roles())
                          and not marked_pids(probe_marker),
                          SWEEP_DEADLINE_S - 5 - (time.perf_counter() - t0)):
            th.join(SWEEP_DEADLINE_S + 60)
            tc.join(SWEEP_MANY_DEADLINE_S + 60)
            raise AssertionError(f"[sweep] (b) the trial and its grandchild were not on the card, "
                                 f"or the probes of (c) not gone, {SWEEP_DEADLINE_S - 5} s into "
                                 f"the hunt: {roles()}; the hunt returned {swept}; (c) {many}")
        tree = roles()
        out["ready_s"] = time.perf_counter() - t0
        # the probes' contexts released: this script's, the trial's, the grandchild's
        wait_until(lambda: len(compute_apps()) <= len(apps0) + 2, 5, 0.5)
        hunt_pid = tree["trial"]["ppid"]
        tree["hunt"] = {"pid": hunt_pid, "pgid": os.getpgid(hunt_pid)}
        held_ready = free0 - torch.cuda.mem_get_info()[0]
        apps_ready = compute_apps()
        groups = {r: v["pgid"] for r, v in tree.items()}
        if len(set(groups.values())) != 3:
            problems.append(f"(b) the hunt, the trial and the grandchild share a process "
                            f"group: {groups}")
        if held_ready < 2 * SWEEP_HOLD_BYTES or (not same_ns and len(apps_ready) != len(apps0) + 2):
            problems.append(f"(b) {held_ready} bytes held and contexts {apps_ready} with the "
                            f"trial and its grandchild up")
        # the group kill the hunt itself makes (SIGINT, a timeout, a prune):
        # neither it nor a kill of the hunt's own group reaches the grandchild
        os.killpg(tree["trial"]["pgid"], signal.SIGKILL)
        trial_gone = wait_until(lambda: not pid_alive(tree["trial"]["pid"]), 5)
        wait_until(lambda: free0 - torch.cuda.mem_get_info()[0] < 2 * SWEEP_HOLD_BYTES, 3)
        held_killed = free0 - torch.cuda.mem_get_info()[0]
        apps_killed = compute_apps()
        gc = tree["grandchild"]["pid"]
        if not trial_gone or not pid_alive(gc):
            problems.append(f"(b) after killing the trial's group: trial gone {trial_gone}, "
                            f"grandchild alive {pid_alive(gc)}")
        if held_killed < SWEEP_HOLD_BYTES:
            problems.append(f"(b) after the group kill {held_killed} bytes held (want the "
                            f"grandchild's {SWEEP_HOLD_BYTES} at least)")
        if same_ns and gc not in {p for p, _ in apps_killed}:
            problems.append(f"(b) the grandchild {gc} holds no context: {apps_killed}")
        if not same_ns and len(apps_killed) != len(apps0) + 1:
            problems.append(f"(b) contexts after the group kill {apps_killed}, before the hunt "
                            f"{apps0}: want one more")
        notes.append(
            f"[sweep] (b) trial and detached grandchild on the card, the probes of (c) gone, "
            f"{out['ready_s']:.2f} s into the hunt, {held_ready / 2**30:.3f} GiB held; process "
            f"groups {groups}; after killing the trial's group the grandchild {gc} lives and "
            f"{held_killed / 2**30:.3f} GiB stay held; contexts {apps_killed} (before the hunt "
            f"{apps0}); card {smi}")

        # -- (c) labelled children under one shared deadline -----------------
        tc.join(SWEEP_MANY_DEADLINE_S + 60)
        for note in notes:
            log(note)
        if tc.is_alive() or "error" in many:
            raise AssertionError(f"[sweep] (c) run_many_with_deadline did not return: "
                                 f"{many.get('error')}")
        teed = "".join(tee.parts).splitlines()
        name = torch.cuda.get_device_name(0)
        rcs = {label: many["result"][label][0] for label, _, _ in jobs}
        if rcs != {"probe0": 0, "probe1": 0, "sleeper": None}:
            problems.append(f"(c) return codes {rcs}")
        if not all(any(ln.startswith(f"[{label}] ") for ln in teed) for label in rcs) or \
                not all(ln.startswith(tuple(f"[{label}] " for label in rcs)) for ln in teed):
            problems.append(f"(c) teed lines without their labels: {teed}")
        for label in ("probe0", "probe1"):
            if f"[{label}] {name}" not in teed or name not in many["result"][label][1]:
                problems.append(f"(c) {label} did not print {name!r}: "
                                f"{many['result'][label][1]!r}")
        if "sleeping past the deadline" not in many["result"]["sleeper"][1] or \
                "[sleeper] sleeping past the deadline" not in teed:
            problems.append(f"(c) the sleeper's tail is lost: {many['result']['sleeper'][1]!r}")
        out["many"] = {"deadline_s": SWEEP_MANY_DEADLINE_S, "rcs": rcs, "lines": len(teed)}
        log(f"[sweep] (c) run_many_with_deadline: return codes {rcs} at its "
            f"{SWEEP_MANY_DEADLINE_S} s shared deadline, {len(teed)} labelled lines; card {smi}")
        th.join(SWEEP_DEADLINE_S + 60)
    finally:
        left_behind = kill_by_env_marker(marker)  # whatever happens above, no orphan
        kill_by_env_marker(probe_marker)
        tree.update({r: v for r, v in roles().items() if r not in tree})  # the retry
        shutil.rmtree(root, ignore_errors=True)
    if th.is_alive() or "error" in swept:
        raise AssertionError(f"[sweep] (b) run_swept did not return: {swept.get('error')}")
    rc, stdout, stderr = swept["result"]
    out["wall_s"] = time.perf_counter() - t0
    if rc is not None:
        problems.append(f"(b) run_swept returned rc {rc}, not None (the deadline)")
    if "broken: exit=-9" not in stderr:
        problems.append(f"(b) the hunt's output before the deadline is lost: {stderr[-2000:]!r}")
    if left_behind:
        problems.append(f"(b) kill_by_env_marker found {left_behind} processes after run_swept")
    pids = {r: v["pid"] for r, v in tree.items()}
    gone = wait_until(lambda: not any(pid_alive(p) for p in pids.values()), 10)
    # one-sided: memory that an earlier phase let go of late only adds to it
    freed = wait_until(lambda: torch.cuda.mem_get_info()[0] >= free0 - SWEEP_MEM_TOL, 15)
    free_after = torch.cuda.mem_get_info()[0]
    apps_after = compute_apps()
    if not gone:
        problems.append(f"(b) alive after the sweep: {[p for p in pids.values() if pid_alive(p)]}")
    if not freed:
        problems.append(f"(b) free memory {free_after} after the sweep, {free0} before the hunt")
    if (same_ns and set(pids.values()) & {p for p, _ in apps_after}) or \
            (not same_ns and len(apps_after) > len(apps0)):
        problems.append(f"(b) contexts after the sweep {apps_after}, before the hunt {apps0}")
    out.update({
        "rc": rc, "tree": tree, "same_pid_namespace": same_ns, "free_before": free0,
        "held_ready": held_ready, "held_after_group_kill": held_killed,
        "free_after_sweep_minus_before": free_after - free0, "left_by_sweep": left_behind,
        "contexts": {"before": apps0, "ready": apps_ready, "after_group_kill": apps_killed,
                     "after_sweep": apps_after},
        "stderr_tail": stderr[-500:], "stdout_tail": stdout[-500:], "cli_sweeps": CLI_SWEEPS,
    })
    if problems:
        raise AssertionError(f"[sweep] {problems}")
    log(f"[sweep] (b) run_swept: rc {rc} at its {SWEEP_DEADLINE_S} s deadline, the hunt's "
        f"output kept ({len(stderr)} bytes of stderr), every pid of the tree {pids} gone, "
        f"kill_by_env_marker finds {left_behind} after it, free memory {free_after - free0:+d} "
        f"bytes against before the hunt, contexts {apps_after}; phase wall "
        f"{out['wall_s']:.2f} s; card {smi}")
    log(f"[sweep] run_cli's marker sweeps: {CLI_SWEEPS}")
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
    from metaopt_tpu_torch.ops import tpe_math as P
    from metaopt_tpu_torch.utils import cuda_build
    from metaopt_tpu_torch.utils.provenance import provenance

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = nvidia_smi()
    print(json.dumps({"provenance": provenance(backend="cuda", card=smi)}), flush=True)

    phase_s, last = {}, [time.perf_counter()]

    def mark(phase: str) -> None:  # seconds since the previous phase ended
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now

    # -- 1. build -------------------------------------------------------------
    # one nvcc per source, started together: tpe_ei.cu in a thread while
    # flash_attention.cu builds here
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    ei_src = [cuda_build.CSRC_DIR / "tpe_ei.cu"]
    with ThreadPoolExecutor(1) as pool:
        ei_built = pool.submit(cuda_build.build, "tpe_ei", ei_src)
        att.build()
        ei_built.result()
    P.build_kernel()
    build_s = time.perf_counter() - t0
    lib = cuda_build.library_path("flash_attention",
                                  [cuda_build.CSRC_DIR / "flash_attention.cu"])
    log(f"[build] flash_attention and tpe_ei built/loaded in {build_s:.2f} s ({lib.name}, "
        f"{cuda_build.library_path('tpe_ei', ei_src).name})")
    ei_log = cuda_build.library_path("tpe_ei", ei_src).with_suffix(".log").read_text()
    for line in ei_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas (tpe_ei): " + line.strip())
    ei_ptxas = ptxas_summary(ei_log, tpe_ei_kernel_name)
    for kern, st in sorted(ei_ptxas.items()):
        log(f"[build] {kern}: {st['registers']} registers, spill stores/loads "
            f"{st['spill_stores']}/{st['spill_loads']} bytes")
    if sorted(ei_ptxas) != ["tpe_ei_kernel<1>", "tpe_ei_kernel<2>"]:
        raise AssertionError(f"[build] tpe_ei.cu's kernels are not K = 1 and 2: {sorted(ei_ptxas)}")
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
    # K2 and K3 in bf16 run their products on wgmma: their SASS holds HGMMA
    hgmma = sass_hgmma(lib)
    bwd_mma = [f"flash_bwd_{n}_kernel_mma<{d}, {drop}>" for n in ("dkv", "dq")
               for d in att.SUPPORTED_HEAD_DIMS for drop in ("false", "true")]
    log("[build] HGMMA instructions per kernel (cuobjdump -sass): "
        + ", ".join(f"{k} {hgmma.get(k)}" for k in bwd_mma))
    if not all(hgmma.get(k, 0) > 0 for k in bwd_mma):
        raise AssertionError(f"[build] K2/K3 without HGMMA in their SASS: {hgmma}")
    spills64 = {k: ptxas[k] for k in bwd_mma if "<64," in k
                and (ptxas.get(k, {}).get("spill_stores") or ptxas.get(k, {}).get("spill_loads"))}
    if spills64:
        raise AssertionError(f"[build] K2/K3 spill at D 64: {spills64}")
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
    # the LM's attention: B 32 x S 512, causal in memory, dropout 0.1
    lm_case = make_case(torch, "lm-causal bf16 (32,512,8,64)", LM_BATCH, LM_SEQ, LM_SEQ, 8, 64,
                        bf16, "lm", gen)
    for n, e in check_case(torch, att, lm_case, WMT_TIMED_RATE)[0].items():
        case_err[n][f"{lm_case['name']} dropout {WMT_TIMED_RATE}"] = e
    del lm_case
    log("[kernels] K2's and K3's dropout bits against philox_keep:")
    probe = keep_bit_probe(torch, att)
    lm_q = torch.empty(LM_BATCH, LM_SEQ, 8, 64, dtype=bf16, device="cuda")
    map_ns = att.build().flash_tensor_map_ns(lm_q.data_ptr(), LM_BATCH, LM_SEQ, 8, 64, 10000)
    del lm_q
    log(f"[kernels] host ns to encode a K2 or K3 launch's four TMA tensor maps at the LM's "
        f"shape: {map_ns}")
    if map_ns < 0:
        raise AssertionError(f"cuTensorMapEncodeTiled refused the LM's tensors ({map_ns})")
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
    lm_stats["yardstick"] = lm_attention_yardstick(torch)
    mark("lm")

    # -- 15. the batched hunt: the MLP zoo's pools, one CLI hunt, a benchmark --
    batched_stats = batched_phase(torch, smi)
    mark("batched")

    # -- 16. the ledger at sweep scale: the native engine, EVC, the archive ----
    ledger_stats = ledger_phase(torch, smi, hunt_stats, keep_root=True)
    ledger_root = Path(ledger_stats.pop("root"))
    mark("ledger")
    try:
        # -- 17. the coordinator: serve, kill -9 and recovery, the fleet, RPCs
        coord_stats = coord_phase(torch, smi)
        mark("coord")

        # -- 18. sharded serving: serve --shards, rebalance, failover, simulate
        shards_stats = shards_phase(torch, smi)
        mark("shards")

        # -- 19. the read side: `web`, `plot`, GP-BO's analyses on the card --
        web_stats = web_phase(torch, smi, ledger_root)
        mark("web")
    finally:
        shutil.rmtree(ledger_root, ignore_errors=True)

    # -- 20. the checkers: analyze, and race's device legs on the card --------
    analysis_stats = analysis_phase(torch, smi)
    mark("analysis")

    # -- 21. several ranks sharing the card: the meshes, K1-K3 per shard -------
    mesh_stats = mesh_phase(torch, smi)
    mark("mesh")

    # -- 22. the deadline sweep: run_swept, kill_by_env_marker, run_many ------
    sweep_stats = sweep_phase(torch, smi)
    mark("sweep")
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
        kernels[-1]["lm"].update(lm_stats["yardstick"][name])
        kernels[-2]["max_abs_err_by_case"] = case_err[name]
        # the [mesh] path: launches of leg (a)'s counted steps (all ranks),
        # and the kernel alone at the ranks' shapes
        kernels[-2]["mesh"] = {
            "launches": mesh_stats["launches"][name],
            "launches_per_step_per_rank": mesh_stats["launches_per_step"],
            **{f"{key}_shard": {k: v for k, v in t[name].items() if k not in ("bytes", "flops")}
               for key, t in mesh_stats["times"].items()}}
    # the tpe_ei kernel: launches of the three main-path runs that reach it
    # ([tpe]'s hunt, [ledger]'s EVC child hunt, [coord] (d)'s live tick);
    # times, bound and error at the [ledger] EI launch (n ~10k), the
    # other shapes beside them
    ei_rows = {"tpe_n16": tpe_stats["tpe_ei"]["n16"], "tpe_n4096": tpe_stats["tpe_ei"]["n4096"],
               f"tpe_n{TPE_EI_BIG_N}": tpe_stats["tpe_ei"][f"n{TPE_EI_BIG_N}"],
               "ledger": ledger_stats["evc"]["tpe_ei"],
               "coord_bucket": coord_stats["fleet"]["tpe"]["tpe_ei"]}
    ei_by_phase = {"tpe": tpe_stats["tpe_ei"]["launches"],
                   "ledger": ledger_stats["evc"]["tpe_ei"]["launches"],
                   "coord": coord_stats["fleet"]["tick"]["tpe_ei_launches"]}
    main_row = ei_rows["ledger"]
    kernels.append({
        "name": "tpe_ei", "route": "cuda", "source": TPE_EI_SOURCE,
        "replaces": REPLACES["tpe_ei"], "launches": sum(ei_by_phase.values()),
        "launches_by_phase": ei_by_phase,
        "max_abs_err": max(r["max_abs_err"] for r in ei_rows.values()),
        **{k: main_row[k] for k in ("ms", "ms_source", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "shapes": {label: {k: v for k, v in r.items() if k not in ("launches",)}
                   for label, r in ei_rows.items()},
        "ptxas": ei_ptxas,
    })
    log(f"[tpe_ei] launches by phase {ei_by_phase}; card {smi}")
    print(json.dumps({"kernels": kernels, "bwd_over_sdpa": bwd_ratio, "ptxas": ptxas,
                      "hgmma": hgmma, "keep_bit_probe": probe, "tensor_map_ns": map_ns,
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
    print(json.dumps({"batched": batched_stats}), flush=True)
    print(json.dumps({"ledger": ledger_stats}), flush=True)
    print(json.dumps({"coord": coord_stats}), flush=True)
    print(json.dumps({"shards": shards_stats}), flush=True)
    print(json.dumps({"web": web_stats}), flush=True)
    print(json.dumps({"analysis": analysis_stats}), flush=True)
    mesh_stats.pop("times")
    print(json.dumps({"mesh": mesh_stats}), flush=True)
    print(json.dumps({"sweep": sweep_stats}), flush=True)
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
