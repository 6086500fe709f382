"""Lint driver: run all checker families, diff against the baseline
(port of ``metaopt_tpu/analysis/runner.py``, scanning the port).

The baseline (``metaopt_tpu_torch/analysis/baseline.json``) grandfathers
pre-existing findings by *fingerprint* — ``rule::file::symbol::detail``,
deliberately excluding line numbers so unrelated edits don't churn it.
The count per fingerprint is kept: introducing a SECOND instance of a
grandfathered pattern in the same function is still a regression.

Exit codes: 0 clean, 1 new findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from metaopt_tpu_torch.analysis.core import Finding, load_paths
from metaopt_tpu_torch.analysis.durability import check_durability
from metaopt_tpu_torch.analysis.hotpath import check_hotpath
from metaopt_tpu_torch.analysis.locks import LockChecker
from metaopt_tpu_torch.analysis.registry import (CrashConfig, LintConfig,
                                           RaceConfig, default_config,
                                           default_race_config)

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")
DEFAULT_RACE_BASELINE = os.path.join(os.path.dirname(__file__),
                                     "race_baseline.json")
DEFAULT_CRASH_BASELINE = os.path.join(os.path.dirname(__file__),
                                      "crash_baseline.json")
#: fingerprints embed paths relative to the REPO root (the directory
#: holding the metaopt_tpu_torch package), never the caller's cwd — the
#: checked-in baseline must match from anywhere `lint` is invoked
REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sort_key(f: Finding) -> Tuple[str, int, str, str, str]:
    """(path, line, code, detail, symbol): total order, so repeated runs
    and ``--update-baseline`` produce byte-identical output."""
    return (f.file, f.line, f.rule, f.detail, f.symbol)


def run_lint(paths: Sequence[str], cfg: Optional[LintConfig] = None,
             root: Optional[str] = None,
             race_cfg: Optional[RaceConfig] = None) -> List[Finding]:
    """All static families over ONE parse: ``load_paths`` reads+parses
    each file once, and the lock-graph summaries (the expensive pass)
    are built once and shared between the MTL checks and — when a
    ``race_cfg`` is given — the MTR001 shared-attribute check."""
    cfg = cfg or default_config()
    modules = load_paths(paths, root=root)
    checker = LockChecker(modules, cfg)
    findings: List[Finding] = []
    findings += checker.run()
    findings += check_hotpath(modules, cfg)
    findings += check_durability(modules, cfg)
    if race_cfg is not None:
        from metaopt_tpu_torch.analysis.dynrace import check_shared

        findings += check_shared(modules, cfg, race_cfg, checker=checker)
    findings.sort(key=_sort_key)
    return findings


def load_baseline(path: str) -> Counter:
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return Counter()
    return Counter({e["fingerprint"]: int(e.get("count", 1))
                    for e in data.get("findings", [])})


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts = Counter(f.fingerprint() for f in findings)
    lines: Dict[str, int] = {}
    msgs: Dict[str, str] = {}
    for f in findings:
        fp = f.fingerprint()
        lines.setdefault(fp, f.line)
        msgs.setdefault(fp, f.message)
    entries = [{"fingerprint": fp, "count": n,
                "line_at_capture": lines[fp], "message": msgs[fp]}
               for fp, n in sorted(counts.items())]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def diff_baseline(findings: Sequence[Finding], baseline: Counter
                  ) -> List[Finding]:
    """Findings beyond the grandfathered per-fingerprint counts."""
    budget = Counter(baseline)
    new: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
        else:
            new.append(f)
    return new


def lint_main(argv: Optional[Sequence[str]] = None,
              cfg: Optional[LintConfig] = None) -> int:
    """CLI body shared by ``lint`` and the clean-gate test."""
    ap = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch lint",
        description="repo-invariant static analysis (lock discipline, "
                    "host syncs in hot paths, WAL durability contract)")
    ap.add_argument("paths", nargs="*", default=[PKG_DIR],
                    help="files/directories to scan (default: the "
                         "metaopt_tpu_torch package)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="grandfathered-findings file (default: the "
                         "checked-in analysis/baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    try:
        findings = run_lint(args.paths, cfg=cfg, root=REPO_ROOT,
                            race_cfg=default_race_config())
    except (OSError, SyntaxError) as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    runtime_s = time.monotonic() - t0

    if args.update_baseline:
        save_baseline(args.baseline, findings)
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    baseline = Counter() if args.no_baseline else load_baseline(
        args.baseline)
    new = diff_baseline(findings, baseline)
    grandfathered = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "grandfathered": grandfathered,
            "lint_runtime_s": round(runtime_s, 3),
            "total": len(findings),
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        note = (f"{len(new)} new finding(s), "
                f"{grandfathered} grandfathered by baseline")
        print(("FAIL: " if new else "clean: ") + note)
    return 1 if new else 0


def _init_device(device: Optional[str]) -> None:
    """Make the CUDA context before instrumentation starts: the locks and
    threads of torch's lazy init then belong to no suite."""
    if device is not None and str(device).startswith("cuda"):
        import torch

        torch.cuda.init()
        torch.zeros(1, device=device).sum().item()


def run_race_leg(leg: Callable[..., Any], scale: int = 1,
                 device: Optional[str] = None,
                 cfg: Optional[LintConfig] = None,
                 race_cfg: Optional[RaceConfig] = None
                 ) -> Tuple[List[Finding], int, Any]:
    """One workload under its own :class:`~metaopt_tpu_torch.analysis.
    dynrace.RaceRuntime` (so one leg's access history can't alias
    another's recycled object ids). Returns (findings, events, whatever
    the leg returned)."""
    from metaopt_tpu_torch.analysis import dynrace

    monitor = dynrace.monitored_classes(cfg or default_config(),
                                        race_cfg or default_race_config())
    _init_device(device)
    rt = dynrace.RaceRuntime(monitor, root=REPO_ROOT)
    with dynrace.instrument(rt):
        out = leg(scale, device)
    return rt.findings(), rt.events, out


def run_race(suites: Sequence[str], cfg: Optional[LintConfig] = None,
             race_cfg: Optional[RaceConfig] = None,
             scale: int = 1, static: bool = True,
             paths: Optional[Sequence[str]] = None,
             device: Optional[str] = None
             ) -> Tuple[List[Finding], Dict[str, float]]:
    """Static MTR001 + the instrumented dynamic suites.

    Returns (findings, stats). Suites run sequentially, each under its
    own runtime (:func:`run_race_leg`). The coord and sim suites host on
    ``device`` (``cuda`` unless given; without CUDA they raise).
    """
    from metaopt_tpu_torch.analysis import dynrace
    from metaopt_tpu_torch.analysis.suites import SUITES

    cfg = cfg or default_config()
    race_cfg = race_cfg or default_race_config()
    findings: List[Finding] = []
    stats: Dict[str, float] = {}
    t0 = time.monotonic()
    if static:
        modules = load_paths(paths or [PKG_DIR], root=REPO_ROOT)
        checker = LockChecker(modules, cfg)
        findings += dynrace.check_shared(modules, cfg, race_cfg,
                                         checker=checker)
        stats["static_runtime_s"] = round(time.monotonic() - t0, 3)
    events = 0
    for name in suites:
        if name not in SUITES:
            raise ValueError(f"unknown race suite {name!r} "
                             f"(have: {', '.join(sorted(SUITES))})")
        t1 = time.monotonic()
        leg_findings, leg_events, _ = run_race_leg(
            SUITES[name], scale, device, cfg=cfg, race_cfg=race_cfg)
        findings += leg_findings
        events += leg_events
        stats[f"suite_{name}_s"] = round(time.monotonic() - t1, 3)
    stats["events"] = events
    stats["runtime_s"] = round(time.monotonic() - t0, 3)
    findings.sort(key=_sort_key)
    return findings, stats


def race_main(argv: Optional[Sequence[str]] = None,
              cfg: Optional[LintConfig] = None,
              race_cfg: Optional[RaceConfig] = None,
              device: Optional[str] = None) -> int:
    """CLI body shared by ``race`` and the clean-gate test. The coord and
    sim suites run their servers and executors on ``device`` (``cuda``
    unless given; without CUDA they raise)."""
    ap = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch race",
        description="hybrid race detection: static shared-attribute "
                    "check (MTR001) + lockset/vector-clock instrumented "
                    "concurrency suites (MTR101 data races, MTR102 "
                    "lock-order inversions)")
    ap.add_argument("--suite", action="append", default=None,
                    choices=("coord", "algo", "wal", "sim", "all"),
                    help="workload(s) to run instrumented (repeatable; "
                         "default: all)")
    ap.add_argument("--scale", type=int, default=1,
                    help="iteration multiplier (1 = fast CI run)")
    ap.add_argument("--static-only", action="store_true",
                    help="run only the MTR001 static check, no workloads")
    ap.add_argument("--baseline", default=DEFAULT_RACE_BASELINE,
                    help="grandfathered-findings file (default: the "
                         "checked-in analysis/race_baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    suites = args.suite or ["all"]
    if "all" in suites:
        suites = ["coord", "algo", "wal", "sim"]
    if args.static_only:
        suites = []

    try:
        findings, stats = run_race(suites, cfg=cfg, race_cfg=race_cfg,
                                   scale=max(1, args.scale), device=device)
    except (OSError, SyntaxError) as e:
        print(f"race: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        save_baseline(args.baseline, findings)
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    baseline = Counter() if args.no_baseline else load_baseline(
        args.baseline)
    new = diff_baseline(findings, baseline)
    grandfathered = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "grandfathered": grandfathered,
            "stats": stats,
            "suites": suites,
            "total": len(findings),
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        note = (f"{len(new)} new finding(s), "
                f"{grandfathered} grandfathered by baseline "
                f"[suites: {', '.join(suites) or 'none'}; "
                f"{int(stats.get('events', 0))} events in "
                f"{stats.get('runtime_s', 0.0):.1f}s]")
        print(("FAIL: " if new else "clean: ") + note)
    return 1 if new else 0


def run_crashcheck(suites: Sequence[str],
                   cfg: Optional[CrashConfig] = None,
                   static: bool = True,
                   paths: Optional[Sequence[str]] = None,
                   tests_dir: Optional[str] = None
                   ) -> Tuple[List[Finding], Dict[str, float]]:
    """Static persistence-order checks (MTP001-MTP004) + exhaustive
    crash-point enumeration of the durable paths (MTP1xx).

    Returns (findings, stats). Each dynamic suite drives a real durable
    path under the fsjournal seam, enumerates every legal crash state of
    its trace, and certifies real recovery against the acked prefix.
    """
    from metaopt_tpu_torch.analysis import crashcheck
    from metaopt_tpu_torch.analysis.registry import default_crash_config

    cfg = cfg or default_crash_config()
    findings: List[Finding] = []
    stats: Dict[str, float] = {}
    t0 = time.monotonic()
    if static:
        modules = load_paths(paths or [PKG_DIR], root=REPO_ROOT)
        findings += crashcheck.check_crash(
            modules, cfg,
            tests_dir=tests_dir or os.path.join(REPO_ROOT, "tests"))
        stats["static_runtime_s"] = round(time.monotonic() - t0, 3)
    states = 0
    for name in suites:
        if name not in crashcheck.SUITES:
            raise ValueError(
                f"unknown crashcheck suite {name!r} "
                f"(have: {', '.join(crashcheck.SUITES)})")
        suite_findings, suite_stats = crashcheck.run_suite(name)
        findings += suite_findings
        states += int(suite_stats.get("crash_states", 0))
        stats[f"suite_{name}_s"] = suite_stats.get("runtime_s", 0.0)
    stats["crash_states"] = states
    stats["runtime_s"] = round(time.monotonic() - t0, 3)
    findings.sort(key=_sort_key)
    return findings, stats


def crashcheck_main(argv: Optional[Sequence[str]] = None,
                    cfg: Optional[CrashConfig] = None) -> int:
    """CLI body shared by ``crashcheck`` and the clean-gate test."""
    from metaopt_tpu_torch.analysis.crashcheck import SUITES as CRASH_SUITES

    ap = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch crashcheck",
        description="crash-consistency certification: static "
                    "persistence-order analysis (MTP001 publish order, "
                    "MTP002 WAL-before-ack, MTP003 durable sequences, "
                    "MTP004 dead barriers) + exhaustive crash-point "
                    "enumeration of every durable path with real "
                    "recovery (MTP1xx)")
    ap.add_argument("--suite", action="append", default=None,
                    choices=tuple(CRASH_SUITES) + ("all",),
                    help="durable path(s) to enumerate (repeatable; "
                         "default: all)")
    ap.add_argument("--static-only", action="store_true",
                    help="run only the MTP static checks, no enumeration")
    ap.add_argument("--baseline", default=DEFAULT_CRASH_BASELINE,
                    help="grandfathered-findings file (default: the "
                         "checked-in analysis/crash_baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    suites = args.suite or ["all"]
    if "all" in suites:
        suites = list(CRASH_SUITES)
    if args.static_only:
        suites = []

    try:
        findings, stats = run_crashcheck(suites, cfg=cfg)
    except (OSError, SyntaxError) as e:
        print(f"crashcheck: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        # dynamic findings (MTP1xx) are never grandfathered: a
        # reproducible lost acked write is a bug, not a baseline entry
        static_only = [f for f in findings
                       if not f.rule.startswith("MTP1")]
        save_baseline(args.baseline, static_only)
        print(f"baseline updated: {len(static_only)} finding(s) -> "
              f"{args.baseline}")
        return 1 if len(static_only) != len(findings) else 0

    baseline = Counter() if args.no_baseline else load_baseline(
        args.baseline)
    new = diff_baseline(findings, baseline)
    grandfathered = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "grandfathered": grandfathered,
            "stats": stats,
            "suites": suites,
            "total": len(findings),
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        note = (f"{len(new)} new finding(s), "
                f"{grandfathered} grandfathered by baseline "
                f"[suites: {', '.join(suites) or 'none'}; "
                f"{int(stats.get('crash_states', 0))} crash states in "
                f"{stats.get('runtime_s', 0.0):.1f}s]")
        print(("FAIL: " if new else "clean: ") + note)
    return 1 if new else 0


def analyze_main(argv: Optional[Sequence[str]] = None) -> int:
    """``analyze``: every static family in one run — lint (MTL lock
    discipline, MTJ003 host syncs, MTD durability), race MTR001, and
    crashcheck MTP001-MTP004 — diffed against the union of the three
    checked-in baselines, with one combined report."""
    ap = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch analyze",
        description="umbrella static analysis: lint + race --static-only "
                    "+ crashcheck --static-only, one combined report")
    ap.add_argument("paths", nargs="*", default=[PKG_DIR],
                    help="files/directories to scan (default: the "
                         "metaopt_tpu_torch package)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baselines")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    try:
        # one run_lint call covers MTL/MTJ003/MTD and (via race_cfg) MTR001
        # over a single parse; crashcheck reuses its own parse because
        # its effect summaries are package-global
        lint_findings = run_lint(args.paths, root=REPO_ROOT,
                                 race_cfg=default_race_config())
        lint_s = round(time.monotonic() - t0, 3)
        crash_findings, crash_stats = run_crashcheck(
            [], paths=args.paths)
    except (OSError, SyntaxError) as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2

    findings = sorted(lint_findings + crash_findings, key=_sort_key)
    baseline: Counter = Counter()
    if not args.no_baseline:
        for p in (DEFAULT_BASELINE, DEFAULT_RACE_BASELINE,
                  DEFAULT_CRASH_BASELINE):
            baseline += load_baseline(p)
    new = diff_baseline(findings, baseline)
    grandfathered = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "grandfathered": grandfathered,
            "lint_runtime_s": lint_s,
            "crashcheck_runtime_s": crash_stats.get("runtime_s", 0.0),
            "total": len(findings),
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        note = (f"{len(new)} new finding(s), "
                f"{grandfathered} grandfathered across "
                "lint+race+crashcheck baselines")
        print(("FAIL: " if new else "clean: ") + note)
    return 1 if new else 0
