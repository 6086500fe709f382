#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It drives ``metaopt_tpu_torch`` (never JAX, never
``metaopt_tpu``) through eight phases and exits non-zero if any fails:

1. build: compiles the flash-attention kernels from ``metaopt_tpu_torch/
   csrc``, prints ptxas's registers and spills per kernel (and fails if
   the bf16 K1 ``flash_fwd_kernel_mma`` is missing for a head dim), and
   prints the card's name and power limit;
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
   the long shape, and prints (K2 + K3) / SDPA's backward for both;
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
7. hunt: the port's CLI, ``python -m metaopt_tpu_torch hunt`` in fresh
   processes with subprocess trials on a ``file:`` ledger in a temp dir:
   (a) BASELINE config 1, random search (seed 0) on
   ``metaopt_tpu_torch/examples/rosenbrock.py`` with 4 workers and 100
   trials — all completed, none broken, none run twice, a finite best, and
   ``status --json`` from another fresh process agreeing; (b) BASELINE
   config 2, TPE (``examples/tpe.yaml``'s settings, passed as JSON) on
   ``metaopt_tpu_torch/examples/mlp_mnist.py``, 16 trials each a fresh
   process on the card — finite, at least 6 suggested by EI, in the space,
   each on CUDA — split into process start → first CUDA op, training, and
   the rest of the trial's ledger wall; (c) ``cuda_backend_reachable()``;
8. asha: BASELINE config 3. (a) The full-width ResNet-50 on the card
   against the same weights on the CPU (batch 8, eval and train mode, bf16
   bound); a 3-epoch in-process ``train_and_eval`` at the reference's
   defaults whose mean training loss must fall; 20 timed and 5 traced
   train steps (batch 128): ms per step, images per second, device busy
   share, device ms by kind of kernel, peak memory. (b) ASHA (``asha.json``,
   seed 0, pool 1) on ``metaopt_tpu_torch/examples/resnet_cifar.py`` at
   full size through ``hunt --n-chips 1``, 21 trials, each a fresh process
   pinned to the card — all completed and finite, budgets 1, 4 and 16
   reached, promotions on their parents' lineage, every trial on the
   card, the GPU registry empty after, ``status --rungs --json`` from a
   fresh process equal to ASHA replayed over the ledger. (c) Config 3's
   trials per hour and each trial's split: process start → first CUDA op,
   setup, training, eval, the rest.

It prints a ``{"kernels": [...]}`` line, a ``{"tpe": {...}}`` line, a
``{"hunt": {...}}`` line, an ``{"asha": {...}}`` line and, last, the
``{"ok": true, "device": {...}}`` line.
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
# the fewest trials with which ASHA (one worker, pool 1) reaches budget 16
# whatever the objectives: 16 at 1 epoch, 4 at 4, 1 at 16 (the example runs
# 64; at asha.json's pool of 4 one worker never reaches 16, see
# examples/resnet_cifar.py)
ASHA_TRIALS = 21
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
    """{"kernel<D>": registers and spill bytes} from ``nvcc -Xptxas=-v``
    output: each "Compiling entry function" line names a kernel by its
    mangled name, and the "spill" and "Used N registers" lines after it
    belong to it."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'_Z\w*?\d+(flash_\w+?)I\w*?Li(\d+)E", line)
            cur = f"{m.group(1)}<{m.group(2)}>" if m else None
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
    low. When the profiler yields no device time it is the CUDA-event
    time, which also counts the host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    ev = events_ms(torch, fn, n)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(ms, cnt) for key, ms, cnt in kernel_rows(prof, n) if match in key]
        total = sum(ms for ms, _ in rows)
        seen = round(sum(cnt for _, cnt in rows) * n)
        if match and seen:
            if seen != n:
                log(f"  (the trace recorded {seen} of {n} launches of {match})")
            total *= n / seen
    except Exception as err:  # the profiler is a measurement aid only
        log(f"  (torch.profiler unavailable: {type(err).__name__}: {err})")
        total = 0.0
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


def check_case(torch, att, case):
    q, k, v, g, m = case["q"], case["k"], case["v"], case["g"], case["mask"]
    tol = TOL[case["dtype"]]
    out_k, lse_k = att.flash_fwd(q, k, v, m)
    out_p, lse_p = att.flash_fwd_plain(q, k, v, m)
    delta = att.attention_delta(g, out_p)
    dk_k, dv_k = att.flash_bwd_dkv(q, k, v, g, lse_p, delta, m)
    dk_p, dv_p = att.flash_bwd_dkv_plain(q, k, v, g, lse_p, delta, m)
    dq_k = att.flash_bwd_dq(q, k, v, g, lse_p, delta, m)
    dq_p = att.flash_bwd_dq_plain(q, k, v, g, lse_p, delta, m)
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
    log(f"  {case['name']}: fwd {errs['flash_fwd']:.3e}  dkv {errs['flash_bwd_dkv']:.3e}"
        f"  dq {errs['flash_bwd_dq']:.3e}  (tol fwd {tol['fwd']}, grad {tol['grad']};"
        f" {n_inf} lse=+inf rows)")
    bad = [k for k, ok in oks if not ok]
    if bad:
        raise AssertionError(f"{case['name']}: {bad} outside tolerance")
    return errs, (lse_p, delta)


def check_autograd(torch, att, case):
    """``flash_attention`` forward and backward through autograd on the card,
    so K2 and K3 consume K1's own lse (``check_case`` hands them the plain
    one), against the same call on the CPU tensors. Returns max |card - cpu|
    per output."""
    tol = TOL[case["dtype"]]["grad"]
    res = {}
    saved = dict(att.launches)
    for dev in ("cuda", "cpu"):
        q, k, v = (case[n].to(dev).detach().requires_grad_() for n in "qkv")
        out = att.flash_attention(q, k, v, case["mask"].to(dev))
        out.backward(case["g"].to(dev))
        res[dev] = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    torch.cuda.synchronize()
    att.launches.update(saved)  # comparison launches do not count
    errs, bad = {}, []
    for name, ref in res["cpu"].items():
        got = res["cuda"][name]
        if not torch.isfinite(got.float()).all():
            bad.append(name)
        errs[name], ok = close(got.cpu(), ref, tol)
        if not ok:
            bad.append(name)
    log(f"  autograd {case['name']}: " + "  ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"  (card vs cpu, tol {tol})")
    if bad:
        raise AssertionError(f"autograd {case['name']}: {bad} outside tolerance or non-finite")
    return errs


def time_case(torch, att, case, lse_delta):
    """Per kernel: its time, its bound, the plain version's and SDPA's."""
    import torch.nn.functional as F

    q, k, v, g, m = case["q"], case["k"], case["v"], case["g"], case["mask"]
    lse, delta = lse_delta
    b, sq, h, d = q.shape
    sk = k.shape[1]
    esz = q.element_size()
    # the mask is read once per distinct byte: a broadcast view (stride 0
    # over the query axis, as the padding mask is) holds b * sk of them
    mask_b = math.prod(n for n, st in zip(m.shape, m.stride()) if st != 0)
    row_f32 = b * h * sq * 4
    work = {
        "flash_fwd": (
            lambda: att.flash_fwd(q, k, v, m),
            lambda: att.flash_fwd_plain(q, k, v, m),
            4 * q.numel() * esz + mask_b + row_f32,           # q k v o, mask, lse
            4.0 * b * h * sq * sk * d),
        "flash_bwd_dkv": (
            lambda: att.flash_bwd_dkv(q, k, v, g, lse, delta, m),
            lambda: att.flash_bwd_dkv_plain(q, k, v, g, lse, delta, m),
            6 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dk dv
            8.0 * b * h * sq * sk * d),
        "flash_bwd_dq": (
            lambda: att.flash_bwd_dq(q, k, v, g, lse, delta, m),
            lambda: att.flash_bwd_dq_plain(q, k, v, g, lse, delta, m),
            5 * q.numel() * esz + mask_b + 2 * row_f32,       # q k v dO dq
            6.0 * b * h * sq * sk * d),
    }
    # the library yardstick: one SDPA call on the same inputs (never used
    # by the port); its backward computes dq, dk and dv together
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    amask = (m != 0)[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, scale=1.0)

    out = sdpa()
    gt = g.transpose(1, 2)
    lib_fwd = device_ms(torch, sdpa)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), gt, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dkv": lib_bwd, "flash_bwd_dq": lib_bwd}

    saved = dict(att.launches)
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
        log(f"  {name}: {ms:.4f} ms, bound {bnd:.4f} ms by {by}, plain {plain_ms:.4f} ms,"
            f" sdpa {'fwd' if name == 'flash_fwd' else 'bwd'} {lib_ms:.4f} ms ({src}); "
            f"by CUDA events {ev:.4f} / {plain_ev:.4f} / {lib_ev:.4f} ms")
    att.launches.update(saved)  # comparison and timing launches do not count
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
# phase 7: the hunt CLI with subprocess trials


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
            ["hunt", "-n", "mlp", "--ledger", ledger, "--max-trials", str(TPE_TRIALS),
             "--config", str(cfg), str(examples / "mlp_mnist.py")]
            + [f"--{k}~{v}" for k, v in TPE_SPACE.items()], root, env, TPE_TRIALS, 1,
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
        if len(done) != TPE_TRIALS or not all(math.isfinite(t.objective) for t in done):
            problems.append(f"{[(t.status, t.objective) for t in trials]}")
        if len(by_ei) < TPE_TRIALS - TPE_INITIAL:
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
# phase 8: BASELINE config 3, ASHA on ResNet-50 through the CLI


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
             "--config", str(examples / "asha.json"), str(examples / "resnet_cifar.py")]
            + [f"--{k}~{v}" for k, v in RESNET_SPACE.items()],
            root, env, ASHA_TRIALS, 1, RESNET_TRIAL_S)
        status, status_wall = run_cli(["status", "-n", "resnet", "--rungs", "--json",
                                       "--ledger", ledger], root, env)
        led = FileLedger(str(root / "ledger"))
        exp = Experiment("resnet", led).configure()
        replay = make_algorithm(exp.space, exp.algorithm)
        replay.observe(exp.fetch_completed_trials())
        trials = sorted(led.fetch("resnet"), key=lambda t: t.start_time or 0)
        done = [t for t in trials if t.status == "completed"]
        space = build_space(RESNET_SPACE)
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
        if budgets != {1, 4, 16}:
            problems.append(f"budgets reached {sorted(budgets)}")
        if not all(t.lineage == space.hash_point(t.params) and (
                t.params["epochs"] == 1 or (t.lineage, t.params["epochs"] // 4) in lineages)
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
                         "trials": sum(r["epochs"] == b for r in rows)} for b in (1, 4, 16)}
        out["config3"] = {
            "trials": len(done), "hunt_wall_s": wall, "trials_per_hour": len(done) / wall * 3600,
            "status_wall_s": status_wall, "rungs": status[0]["rungs"], "sum": total,
            "share": {k: total[k] / total["trial_s"] for k in keys[1:]},
            "median_by_budget": by_budget, "per_trial": rows,
            "best": summary["best"]["objective"], "device": name,
            "producer_timings": summary["producer_timings"],
        }
        log(f"[asha] config 3: {len(done)} trials completed on {name} ({by_budget[1]['trials']} "
            f"at 1 epoch, {by_budget[4]['trials']} at 4, {by_budget[16]['trials']} at 16), "
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
    missing = [f"flash_fwd_kernel_mma<{d}>" for d in att.SUPPORTED_HEAD_DIMS
               if f"flash_fwd_kernel_mma<{d}>" not in ptxas]
    if missing:
        raise AssertionError(f"ptxas compiled no {missing}")
    smi = nvidia_smi()
    log(smi)

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

    # -- 5. where a train step's time goes (after the counted run) ----------
    breakdown = profile_train_step(torch, tfm)
    if breakdown is not None and not any("flash_fwd_kernel_mma" in r[0]
                                         for r in breakdown["flash"]):
        raise AssertionError("the train step's trace shows no flash_fwd_kernel_mma")

    # -- 6. TPE on the card ---------------------------------------------------
    tpe_stats = tpe_phase(torch, smi)

    # -- 7. the hunt CLI --------------------------------------------------------
    hunt_stats = hunt_phase(torch, smi)

    # -- 8. BASELINE config 3: ASHA on ResNet-50 through the CLI ----------------
    asha_stats = asha_phase(torch, smi)

    kernels = []
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        row = dict(timing_stats[name])
        long_row = dict(long_stats[name])
        for r in (row, long_row):
            del r["bytes"], r["flops"]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], **row, "long": long_row,
            "max_abs_err_by_case": case_err[name],
        })
    print(json.dumps({"kernels": kernels, "bwd_over_sdpa": bwd_ratio, "ptxas": ptxas,
                      "autograd_max_abs_err": autograd_err, "slice": {
        "ms_per_step": ms_step, "tokens_per_s": warm["tokens_per_step"] / ms_step * 1e3,
        "peak_mem_bytes": peak_mem, "build_s": build_s, "card": smi,
        "profile": breakdown}}), flush=True)
    print(json.dumps({"tpe": tpe_stats}), flush=True)
    print(json.dumps({"hunt": hunt_stats}), flush=True)
    print(json.dumps({"asha": asha_stats}), flush=True)
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
