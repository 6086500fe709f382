#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It drives ``metaopt_tpu_torch`` (never JAX, never
``metaopt_tpu``) through five phases and exits non-zero if any fails:

1. build: compiles the flash-attention kernels from ``metaopt_tpu_torch/
   csrc`` and prints the card's name and power limit;
2. kernels: holds each kernel (K1 forward, K2 dK/dV, K3 dQ) against its
   plain PyTorch version on the same inputs, at the Transformer's shapes
   (B 32, S 64, H 8, D 64, bf16; padding, causal and cross masks) and at a
   ragged multi-tile shape (4, 333, 8, 64) in f32 and bf16, and times the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it);
3. model: the full-width Transformer-base loss on one small batch on the
   card against the same model on the CPU (plain attention);
4. slice: ``build_experiment(...).workon(objective)`` with random search,
   three trials of full-width Transformer-base training, and checks that
   every kernel ran 18 times per forward (K1) and per train step (K2, K3);
5. profile: times five train steps, traces five more, and prints the
   device busy share of the step, device time by kind of kernel and the
   kernels that take the most device time.

It prints a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

STEPS = 20             # train steps per trial
TRIALS = 3
ATTN_PER_STEP = 18     # 6 encoder self + 6 decoder self + 6 cross attentions
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16; f32 non-tensor
TOL = {"float32": {"fwd": 1e-5, "grad": 1e-4}, "bfloat16": {"fwd": 3e-2, "grad": 3e-2}}
KERNEL_SOURCE = "metaopt_tpu_torch/csrc/flash_attention.cu"
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
    ``n`` calls. When the profiler yields no device time it is the CUDA-
    event time, which also counts the host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    ev = events_ms(torch, fn, n)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(ms for key, ms, _ in kernel_rows(prof, n) if match in key)
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
        mask = kpad[:, None, :].expand(b, sq, sk)
    elif kind == "causal":
        causal = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))
        mask = causal[None] & kpad[:, None, :]
    elif kind == "causal+empty":
        causal = torch.tril(torch.ones(sq, sk, dtype=torch.bool, device=dev))
        mask = (causal[None] & torch.ones(b, 1, 1, dtype=torch.bool, device=dev)).clone()
        mask[:, 5] = False                      # fully masked rows
        mask[1, 100:140] = False
    else:
        raise ValueError(kind)
    m8 = mask.to(torch.int8)
    if kind in ("pad", "cross"):
        m8 = kpad[:, None, :].to(torch.int8).expand(b, sq, sk)  # broadcast view
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
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "device_ms_by_kind": kinds,
            "top": [[k[:90], ms, n] for k, ms, n in rows[:12]]}


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
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
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
    ]
    log("[kernels] max |kernel - plain| per case:")
    max_err = {n: 0.0 for n in att.launches}
    lse_delta = []
    for case in cases:
        errs, stats = check_case(torch, att, case)
        for n, e in errs.items():
            max_err[n] = max(max_err[n], e)
        lse_delta.append(stats)
    log("[kernels] times at the slice's shapes (B 32, S 64, H 8, D 64, bf16, padding mask):")
    timing_stats = time_case(torch, att, cases[0], lse_delta[0])

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

    kernels = []
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        row = dict(timing_stats[name])
        del row["bytes"], row["flops"]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], **row,
        })
    print(json.dumps({"kernels": kernels, "slice": {
        "ms_per_step": ms_step, "tokens_per_s": warm["tokens_per_step"] / ms_step * 1e3,
        "peak_mem_bytes": peak_mem, "build_s": build_s, "card": smi,
        "profile": breakdown}}), flush=True)
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
