#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It drives ``metaopt_tpu_torch`` (never JAX, never
``metaopt_tpu``) through six phases and exits non-zero if any fails:

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
   ms per MLP train step and per trial.

It prints a ``{"kernels": [...]}`` line, a ``{"tpe": {...}}`` line and,
last, the ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import warnings

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
TPE_TOL = 1e-5          # fit tensors, card against CPU
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


def profile_train_step(torch, tfm, steps: int = 5):
    """Time ``steps`` full-width train steps untraced, then trace as many:
    device busy share of the untraced wall time, device time by kind of
    kernel, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    model = tfm.make_model({"dropout": 0.0}).init_like_flax(
        torch.Generator().manual_seed(0)).cuda()
    opt = tfm.trial_setup({"lr": 1e-3, "warmup": 2}, model.parameters(), 100)
    step = tfm.make_train_step(model, opt)
    src, tgt = tfm.synthetic_seq2seq(32, 64, 1000, seed=0, device="cuda")
    for _ in range(3):
        step((src, tgt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step((src, tgt))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step((src, tgt))
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / steps
        rows = kernel_rows(prof, steps)
    except Exception as err:  # the profiler is a measurement aid only
        log(f"[profile] not measured ({type(err).__name__}: {err})")
        return None
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    kinds = {}
    for key, ms, _ in rows:
        kind = next((k for k, pats in KERNEL_KINDS if any(p in key for p in pats)),
                    "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    log(f"[profile] train step: wall {wall_ms:.3f} ms untraced ({traced_ms:.3f} ms "
        f"traced); device busy {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% of "
        f"the untraced wall. Device ms/step by kind:")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:8.4f} ms  {kind}")
    log("[profile] top kernels by device ms/step:")
    for key, ms, n in rows[:12]:
        log(f"  {ms:8.4f} ms  x{n:5.1f}  {key[:90]}")
    flash = [[k[:90], ms, n] for k, ms, n in rows if "flash_" in k]
    log("[profile] flash-attention kernels by device ms/step:")
    for key, ms, n in flash:
        log(f"  {ms:8.4f} ms  x{n:5.1f}  {key}")
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "device_ms_by_kind": kinds, "flash": flash,
            "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}


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
