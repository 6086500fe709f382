"""CLI implementation (port of ``metaopt_tpu/cli/main.py``).

parse argv → resolve config → build space from the user command → configure
experiment → workon. Everything after the user script path is the script's
own command line, with ``~priors`` marking searchable arguments:

    python -m metaopt_tpu_torch hunt -n rosen --max-trials 100 \\
        --ledger file:/tmp/ledger \\
        metaopt_tpu_torch/examples/rosenbrock.py \\
        -x~'uniform(-5, 10)' -y~'uniform(-5, 10)'

Ported subcommands: ``hunt``, ``init-only``, ``insert``, ``resume``,
``list``, ``status`` and ``info``. ``hunt --n-chips N`` (or
``executor.n_chips`` in the config file) places each trial on its own block
of N GPUs (:class:`~metaopt_tpu_torch.executor.GPUExecutor`), and ``status
--rungs`` shows a multi-fidelity algorithm's rung occupancy. Flags whose
machinery is not ported yet (EVC branching and warm start, the batched
hunt, the coordinator producer) are accepted by the parser and raise a
clear "not ported yet".
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.executor import GPUExecutor, SubprocessExecutor
from metaopt_tpu_torch.io.resolve_config import DEFAULTS, resolve_config
from metaopt_tpu_torch.ledger import Experiment
from metaopt_tpu_torch.ledger.backends import (
    ledger_from_spec,
    local_ledger,
    make_ledger,
)
from metaopt_tpu_torch.ledger.evc import branch_parent
from metaopt_tpu_torch.space import SpaceBuilder
from metaopt_tpu_torch.worker import workon

log = logging.getLogger(__name__)

LEDGER_HELP = ("ledger spec: 'memory', 'file:<dir>', or a dir path (the file "
               "backend; 'native:' and 'coord://' are not ported yet)")


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what}: not ported yet (see ROADMAP.md)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch",
        description="asynchronous hyperparameter optimization on PyTorch/CUDA",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-n", "--name", help="experiment name")
        sp.add_argument("--config", help="framework config YAML (or JSON)")
        sp.add_argument("--algo", default=None,
                        help="algorithm name with default settings — the "
                             "no-YAML shortcut for `algorithm: {NAME: {}}` "
                             "(e.g. --algo tpe)")
        sp.add_argument("--max-trials", type=int, dest="max_trials")
        sp.add_argument("--pool-size", type=int, dest="pool_size")
        sp.add_argument("--ledger", help=LEDGER_HELP)

    hunt = sub.add_parser("hunt", help="run the optimization loop")
    common(hunt)
    hunt.add_argument("--worker-trials", type=int, dest="worker_trials")
    hunt.add_argument("--worker-id", default=None)
    hunt.add_argument("--n-workers", type=int, dest="n_workers", default=1,
                      help="parallel workers in this process (each runs the "
                           "full produce/reserve/execute loop; trials are "
                           "subprocesses, so N trials run concurrently)")
    hunt.add_argument("--exp-max-broken", type=int, default=None,
                      help="abort after this many broken trials")
    hunt.add_argument("--working-dir")
    hunt.add_argument("--n-chips", type=int, default=None,
                      help="GPUs per trial: each trial runs pinned to its own "
                           "block of GPUs (CUDA_VISIBLE_DEVICES)")
    hunt.add_argument("--timeout-s", type=float, default=None,
                      help="per-trial wall-clock timeout")
    hunt.add_argument("--warm-start", dest="warm_start", default=None,
                      help="observe another experiment's completed trials "
                           "first (EVC; not ported yet)")
    hunt.add_argument("--branch-from", dest="branch_from", default=None,
                      help="EVC: create this experiment as a child of "
                           "another (not ported yet)")
    hunt.add_argument("--on-conflict", dest="on_conflict", default=None,
                      choices=["adopt", "fail", "branch"],
                      help="what to do when the command's ~priors (or "
                           "--algo) differ from the stored experiment: "
                           "adopt = warn and defer to the stored config "
                           "(default); fail = stop; branch = EVC "
                           "auto-resolution (not ported yet)")
    hunt.add_argument("--producer", default=None, choices=["local", "coord"],
                      help="where suggestion runs: 'local' fits the algorithm "
                           "in this worker ('coord' is not ported yet)")
    hunt.add_argument("--profile-dir", default=None,
                      help="capture per-trial torch.profiler traces here "
                           "(scripts opt in with `with client.profiled():`)")
    hunt.add_argument("--ckpt-root", dest="ckpt_root", default=None,
                      help="checkpoint root for PBT weight handoff "
                           "(scripts resolve it via "
                           "client.checkpoint_paths())")
    hunt.add_argument("--batch-size", dest="batch_size", default=None,
                      help="batched hunt (not ported yet)")
    hunt.add_argument("--vector-objective", dest="vector_objective",
                      default=None, help="batched hunt (not ported yet)")
    hunt.add_argument("cmd", nargs=argparse.REMAINDER,
                      help="user script and its args with ~priors")

    init = sub.add_parser("init-only", help="create the experiment and exit")
    common(init)
    init.add_argument("--on-conflict", dest="on_conflict", default=None,
                      choices=["adopt", "fail", "branch"])
    init.add_argument("--branch-from", dest="branch_from", default=None)
    init.add_argument("cmd", nargs=argparse.REMAINDER)

    ins = sub.add_parser("insert", help="manually register a trial")
    common(ins)
    ins.add_argument("--params", required=True,
                     help='JSON dict of param values, e.g. \'{"x": 1.5}\'')

    res = sub.add_parser("resume",
                         help="flip parked trials back to new (reservable)")
    common(res)
    res.add_argument("--trial-id", default=None,
                     help="resume one trial (default: all matching)")
    res.add_argument("--statuses", default="suspended",
                     help="comma list of statuses to revive (from "
                          "suspended/interrupted/broken; default "
                          "suspended). Interrupted trials' params stay "
                          "registered, so deterministic algorithms can't "
                          "re-suggest them — reviving is the only retry "
                          "path.")

    ls = sub.add_parser("list", help="list experiments on the ledger")
    ls.add_argument("--config", help="framework config YAML (or JSON)")
    ls.add_argument("--ledger", help=LEDGER_HELP)
    ls.add_argument("--json", action="store_true", dest="as_json")

    info = sub.add_parser("info", help="full experiment document + stats")
    common(info)
    info.add_argument("--json", action="store_true", dest="as_json")

    st = sub.add_parser("status", help="show experiment state")
    common(st)
    st.add_argument("--json", action="store_true", dest="as_json")
    st.add_argument("--rungs", action="store_true",
                    help="rung occupancy for multi-fidelity algorithms")
    st.add_argument("--workers", action="store_true",
                    help="per-worker liveness derived from trial "
                         "ownership + heartbeats (who holds what, last "
                         "seen when)")
    return p


def _make_ledger_from_spec(spec: Optional[str], cfg: Dict[str, Any]):
    if spec is None:
        lcfg = cfg.get("ledger")
        if not lcfg:
            # no spec and no (or an empty) ledger config section: the
            # persistent local default a bare --ledger PATH gets, never a
            # silent in-memory backend
            return local_ledger(os.path.expanduser("~/.metaopt_tpu/ledger"))
        lcfg = dict(lcfg)
        if lcfg.get("type") == "file" and not lcfg.get("path"):
            lcfg["path"] = os.path.expanduser("~/.metaopt_tpu/ledger")
        return make_ledger(lcfg)
    return ledger_from_spec(spec)


def _strip_remainder(cmd: List[str]) -> List[str]:
    return cmd[1:] if cmd[:1] == ["--"] else cmd


def _family_versions(ledger, name: str):
    """The stored version family of an experiment, plus the free slot.

    Returns ``(members, next_name, next_version)``: ``members`` is the
    ``name`` document followed by the ``name-vN`` siblings that EVC
    auto-resolution created, ordered by version suffix;
    ``next_name``/``next_version`` is one past the HIGHEST occupied slot.
    A ``name-vN`` experiment whose lineage does NOT chain back to the
    family (a user-created name that happens to match the pattern, an
    orphan whose parent version was deleted, or a child created BEFORE its
    claimed parent) is skipped — it blocks its slot but is neither joined
    nor branched from.

    The port does not branch yet (the EVC flags raise), so only a ledger
    the reference's CLI wrote holds a family; ``list``'s tree and
    ``info``'s "branched from" line read the same ones.
    """
    import re

    def created_at(d) -> Optional[str]:
        # UTC isoformat stamped at configure(); lexicographic order is
        # chronological order
        return (d.get("metadata") or {}).get("datetime")

    doc = ledger.load_experiment(name)
    if doc is None:
        return [], name, 1
    out = [(name, doc)]
    family_created = {name: created_at(doc)}
    pat = re.compile(re.escape(name) + r"-v(\d+)$")
    sibs = sorted(
        (int(m.group(1)), n)
        for n in ledger.list_experiments()
        for m in [pat.match(n)] if m
    )
    top = int(doc.get("version", 1))
    for v, n in sibs:
        top = max(top, v)
        cdoc = ledger.load_experiment(n)
        if cdoc is None:
            continue
        parent = branch_parent(cdoc)
        if parent not in family_created:
            continue
        c_at, p_at = created_at(cdoc), family_created[parent]
        if c_at is not None and p_at is not None and c_at < p_at:
            # the child predates the experiment its parent NAME now
            # denotes: a stale orphan of a deleted-and-recreated head
            continue
        out.append((n, cdoc))
        family_created[n] = c_at
    return out, f"{name}-v{top + 1}", top + 1


def _conflict_summary(stored: Dict[str, str], new: Dict[str, str],
                      stored_algo: List[str],
                      requested_algo: Optional[List[str]]) -> str:
    parts = []
    changed = sorted(k for k in stored.keys() & new.keys()
                     if stored[k] != new[k])
    added = sorted(new.keys() - stored.keys())
    removed = sorted(stored.keys() - new.keys())
    for k in changed:
        parts.append(f"{k}: {stored[k]} -> {new[k]}")
    for k in added:
        parts.append(f"+{k}~{new[k]}")
    for k in removed:
        parts.append(f"-{k}~{stored[k]}")
    if requested_algo is not None and stored_algo \
            and requested_algo != stored_algo:
        parts.append(
            f"algorithm: {'/'.join(stored_algo)} -> "
            f"{'/'.join(requested_algo)}"
        )
    return "; ".join(parts)


def _experiment_from_args(args, cfg: Dict[str, Any], need_cmd: bool):
    user_argv = _strip_remainder(getattr(args, "cmd", []) or [])
    name = args.name or cfg.get("name")
    if not name:
        raise SystemExit("an experiment name is required (-n/--name)")
    if getattr(args, "warm_start", None) or cfg.get("warm_start"):
        raise _not_ported("--warm-start (EVC)")
    if getattr(args, "branch_from", None) or cfg.get("branch_from"):
        raise _not_ported("--branch-from (EVC)")
    on_conflict = (getattr(args, "on_conflict", None)
                   or cfg.get("on_conflict") or "adopt")
    if on_conflict == "branch":
        raise _not_ported("--on-conflict branch (EVC)")
    ledger = _make_ledger_from_spec(args.ledger, cfg)

    space = template = None
    if user_argv:
        space, template = SpaceBuilder().build(user_argv)
        if need_cmd and len(space) == 0:
            raise SystemExit(
                "no ~priors found in the command; mark searchable args like "
                "--lr~'loguniform(1e-5, 1e-1)'"
            )
    requested_algo: Optional[List[str]] = None
    if getattr(args, "algo", None):
        requested_algo = [args.algo]
    elif cfg.get("algorithm") not in (None, DEFAULTS["algorithm"]):
        requested_algo = sorted(cfg["algorithm"].keys())

    def _fits(mdoc) -> bool:
        if space is not None \
                and (mdoc.get("space") or {}) != space.configuration:
            return False
        if requested_algo is not None and mdoc.get("algorithm") \
                and sorted(mdoc["algorithm"].keys()) != requested_algo:
            return False
        return True

    if space is not None or requested_algo is not None:
        family, _, _ = _family_versions(ledger, name)
    else:
        family = []
    match = next(((mn, md) for mn, md in family if _fits(md)), None)
    if family and match is None:
        # diff against the experiment configure() would actually join (the
        # named one), not the newest family version
        base_doc = family[0][1]
        stored_space = base_doc.get("space") or {}
        diff = _conflict_summary(
            stored_space,
            space.configuration if space is not None else stored_space,
            sorted((base_doc.get("algorithm") or {}).keys()),
            requested_algo,
        )
        if on_conflict == "fail":
            raise SystemExit(
                f"experiment {name!r} exists with a different "
                f"configuration ({diff}); rerun with --on-conflict adopt "
                f"to defer to the stored config"
            )
        log.warning(
            "experiment %r already exists; your command's configuration "
            "differs (%s) and the STORED config wins — pass --on-conflict "
            "fail to stop instead", name, diff,
        )
    elif match is not None and match[0] != name:
        log.warning(
            "EVC: this configuration matches version %d (%r); joining it",
            match[1].get("version", 1), match[0],
        )
        name = match[0]

    algorithm = cfg.get("algorithm")
    if getattr(args, "algo", None):
        explicit = algorithm not in (None, DEFAULTS["algorithm"])
        if explicit and list(algorithm) != [args.algo]:
            raise SystemExit(
                f"--algo {args.algo} conflicts with config algorithm "
                f"{list(algorithm)[0]!r}; pick one"
            )
        algorithm = algorithm if explicit else {args.algo: {}}
    exp = Experiment(
        name,
        ledger,
        space=space,
        algorithm=algorithm,
        max_trials=cfg.get("max_trials", 100),
        pool_size=cfg.get("pool_size", 1),
        user_args=user_argv,
    ).configure()
    # a joiner (no cmd) reuses the stored user_args to rebuild the template
    if template is None and exp.user_args:
        _, template = SpaceBuilder().build(exp.user_args)
    return exp, template


def _cmd_hunt(args, cfg: Dict[str, Any]) -> int:
    if (getattr(args, "batch_size", None) or cfg.get("batch_size")
            or getattr(args, "vector_objective", None)
            or cfg.get("vector_objective")):
        raise _not_ported("the batched hunt (--batch-size/--vector-objective)")
    exp, template = _experiment_from_args(args, cfg, need_cmd=False)
    if template is None or not exp.user_args:
        raise SystemExit("hunt needs a user command (or an experiment that has one)")

    script = template.argv[0] if template.argv else ""
    interpreter = None
    if script.endswith(".py") and not os.access(script, os.X_OK):
        interpreter = [sys.executable]

    n_chips = args.n_chips if args.n_chips is not None else (
        (cfg.get("executor") or {}).get("n_chips")
    )

    def make_executor(tmpl):
        kwargs = dict(
            working_dir=args.working_dir or cfg.get("working_dir"),
            interpreter=interpreter,
            timeout_s=args.timeout_s,
            profile_dir=args.profile_dir,
            ckpt_root=args.ckpt_root or cfg.get("ckpt_root"),
        )
        if n_chips:
            return GPUExecutor(tmpl, n_chips=int(n_chips), **kwargs)
        return SubprocessExecutor(tmpl, **kwargs)

    workon_kwargs = dict(
        worker_trials=(
            args.worker_trials
            if args.worker_trials is not None
            else cfg.get("worker_trials")
        ),
        max_broken=args.exp_max_broken if args.exp_max_broken is not None else 10,
        heartbeat_timeout_s=cfg.get("heartbeat_s", 30.0) * 2,
        producer_mode=args.producer or cfg.get("producer") or "local",
    )
    worker_id = args.worker_id or f"{os.uname().nodename}-{os.getpid()}"
    n_workers = max(1, int(getattr(args, "n_workers", 1) or 1))
    if n_workers == 1:
        executor = make_executor(template)
        try:
            all_stats = [workon(exp, executor, worker_id=worker_id,
                                **workon_kwargs)]
        finally:
            executor.close()
    else:
        # N full produce/reserve/execute loops in this process: trials are
        # subprocesses, so N run concurrently. Every loop shares the one
        # (thread-safe) ledger — the memory backend especially must not
        # give each thread a private universe — and has its own Experiment
        # handle, algorithm and executor; the ledger's atomic reserve
        # arbitrates exactly as it does between separate worker processes.
        import threading

        results: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        stop = threading.Event()

        def run(i: int) -> None:
            try:
                w_exp = Experiment(exp.name, exp.ledger).configure()
                ex = make_executor(template)
                try:
                    results[i] = workon(
                        w_exp, ex, worker_id=f"{worker_id}-w{i}",
                        stop_event=stop, **workon_kwargs
                    )
                finally:
                    ex.close()
            except BaseException as err:  # a dead worker must be REPORTED
                errors[i] = f"{type(err).__name__}: {err}"

        threads = [
            threading.Thread(target=run, args=(i,), daemon=True)
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()
        try:
            for t in threads:
                while t.is_alive():
                    t.join(timeout=0.5)
        except KeyboardInterrupt:
            # wind down: each loop finishes its in-flight trial, marks
            # state, and closes its executor. The wait is bounded by the
            # trial timeout (or 300s when unbounded); anything still
            # running after that is abandoned to the heartbeat stale sweep.
            stop.set()
            grace = (args.timeout_s + 30) if args.timeout_s else 300
            print(f"interrupt: waiting up to {grace:.0f}s for in-flight "
                  "trials...", file=sys.stderr)
            deadline = time.monotonic() + grace
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            if any(t.is_alive() for t in threads):
                print("some trials still running — their reservations will "
                      "be re-freed by the stale sweep", file=sys.stderr)
        all_stats = [results[i] for i in sorted(results)]
        if not all_stats:
            raise SystemExit(
                "every worker thread failed: "
                + "; ".join(f"w{i}: {e}" for i, e in sorted(errors.items()))
            )
        for i, e in sorted(errors.items()):
            print(f"worker w{i} died: {e}", file=sys.stderr)

    s = exp.stats
    # element-wise aggregate across workers (counters sum; each worker ran
    # its own producer, so summed seconds = total suggest/observe cost)
    timings: Dict[str, Any] = {}
    for st in all_stats:
        for k, v in st.producer_timings.items():
            timings[k] = timings.get(k, 0) + v if isinstance(v, (int, float)) \
                else v
    timings = {k: round(v, 4) if isinstance(v, float) else v
               for k, v in timings.items()}
    failed = len(all_stats) < n_workers
    print(json.dumps({
        "experiment": exp.name,
        "worker": worker_id,
        "n_workers": n_workers,
        "failed_workers": n_workers - len(all_stats),
        "completed_by_worker": sum(st.completed for st in all_stats),
        "broken_by_worker": sum(st.broken for st in all_stats),
        "pruned_by_worker": sum(st.pruned for st in all_stats),
        "requeued_by_worker": sum(st.requeued for st in all_stats),
        "producer_timings": timings,
        "total": s["by_status"],
        "best": s["best"],
    }, indent=2))
    return 0 if (s["best"] is not None and not failed) else 1


def _cmd_init_only(args, cfg: Dict[str, Any]) -> int:
    exp, _ = _experiment_from_args(args, cfg, need_cmd=True)
    print(f"experiment {exp.name!r} ready: space={exp.space!r} "
          f"algorithm={exp.algorithm}")
    return 0


def _cmd_insert(args, cfg: Dict[str, Any]) -> int:
    exp, _ = _experiment_from_args(args, cfg, need_cmd=False)
    params = json.loads(args.params)
    if params not in exp.space:
        raise SystemExit(f"params {params} not inside {exp.space!r}")
    trial = exp.make_trial(params)
    kept = exp.register_trials([trial])
    if not kept:
        raise SystemExit(f"trial already exists: {trial.id}")
    print(f"registered trial {trial.id}")
    return 0


def _cmd_resume(args, cfg: Dict[str, Any]) -> int:
    """Unpark trials: suspended/interrupted/broken → new, reservable again.

    An interrupted or broken trial's params remain registered (dedup), so
    no algorithm can ever re-suggest that point — reviving the trial is
    the retry path (``--statuses interrupted,broken``).
    """
    revivable = ("suspended", "interrupted", "broken")
    statuses = [s.strip() for s in args.statuses.split(",") if s.strip()]
    if not statuses:
        raise SystemExit(
            f"--statuses is empty; name statuses from {revivable}"
        )
    bad = [s for s in statuses if s not in revivable]
    if bad:
        raise SystemExit(
            f"--statuses must name statuses from {revivable}, got {bad}"
        )
    exp, _ = _experiment_from_args(args, cfg, need_cmd=False)
    parked = [t for s in statuses for t in exp.fetch_trials(s)]
    if args.trial_id:
        parked = [t for t in parked if t.id.startswith(args.trial_id)]
        if not parked:
            raise SystemExit(
                f"no {'/'.join(statuses)} trial matching {args.trial_id!r}"
            )
    resumed = 0
    for t in parked:
        was = t.status
        t.reset_to_new()
        if exp.ledger.update_trial(t, expected_status=was):
            resumed += 1
    print(f"resumed {resumed} trial(s)")
    return 0


def _cmd_list(args, cfg: Dict[str, Any]) -> int:
    """Enumerate experiments (``orion list`` in the lineage)."""
    from metaopt_tpu_torch.io.webapi import _experiment_summary

    ledger = _make_ledger_from_spec(args.ledger, cfg)
    rows = [_experiment_summary(ledger, name)
            for name in sorted(ledger.list_experiments())]
    if args.as_json:
        print(json.dumps(rows, indent=2))
        return 0
    if not rows:
        print("no experiments")
        return 0
    # EVC families render as a tree: children indent under the version
    # they branched from
    by_name = {r["name"]: r for r in rows}
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for r in rows:
        p = r.get("parent")
        if p and p in by_name:
            children.setdefault(p, []).append(r)
        else:
            roots.append(r)

    def emit(r: Dict[str, Any], depth: int) -> None:
        flag = " [done]" if r["done"] else ""
        pre = "  " * depth + ("└─ " if depth else "")
        ver = f" (v{r['version']})" if r.get("version", 1) != 1 else ""
        print(f"{pre}{r['name']}{ver}: {r['completed']}/{r['max_trials']} "
              f"completed ({r['trials']} trials, "
              f"{r['algorithm'] or '?'}){flag}")
        for c in sorted(children.get(r["name"], []),
                        key=lambda c: (c.get("version", 1), c["name"])):
            emit(c, depth + 1)

    for r in roots:
        emit(r, 0)
    return 0


def _cmd_status(args, cfg: Dict[str, Any]) -> int:
    ledger = _make_ledger_from_spec(args.ledger, cfg)
    names = [args.name] if args.name else ledger.list_experiments()
    out = []
    for name in names:
        doc = ledger.load_experiment(name)
        if doc is None:
            raise SystemExit(f"no such experiment: {name}")
        exp = Experiment(name, ledger).configure()
        s = exp.stats
        if args.rungs and exp.algorithm and exp.space.fidelity is not None:
            from metaopt_tpu_torch.algo.base import make_algorithm

            algo = make_algorithm(exp.space, exp.algorithm)
            algo.observe(exp.fetch_completed_trials())
            s["rungs"] = getattr(algo, "rung_table", None)
        if args.workers:
            from metaopt_tpu_torch.io.webapi import worker_table

            s["workers"] = worker_table(ledger, name)
        out.append(s)
    if args.as_json:
        print(json.dumps(out, indent=2))
    else:
        for s in out:
            counts = ", ".join(f"{k}:{v}" for k, v in sorted(s["by_status"].items()))
            print(f"{s['name']}: {s['trials']}/{s['max_trials']} trials ({counts})")
            if s["best"]:
                print(f"  best objective {s['best']['objective']:.6g} "
                      f"at {s['best']['params']}")
            for r in s.get("rungs") or []:
                line = (f"  bracket {r['bracket']} budget {r['budget']:>5}: "
                        f"{r['n'] if 'n' in r else r['completed']} completed")
                if "capacity" in r:  # Hyperband's synchronous rungs
                    line += f", {r['assigned']}/{r['capacity']} assigned"
                if "promoted" in r:
                    line += f", {r['promoted']} promoted"
                print(line)
            for w in s.get("workers") or []:
                age = w["last_seen_age_s"]
                seen = f"last seen {age:.0f}s ago" if age is not None \
                    else "never seen"
                hold = (f", holds {', '.join(t[:8] for t in w['current'])}"
                        if w["current"] else "")
                counts = ", ".join(
                    f"{w[k]} {k}" for k in
                    ("completed", "broken", "interrupted", "suspended",
                     "reserved")
                    if w[k]
                ) or "no trials"
                print(f"  worker {w['worker']}: {counts} ({seen}{hold})")
    return 0


def _cmd_info(args, cfg: Dict[str, Any]) -> int:
    """The full experiment document (``orion info`` in the lineage)."""
    ledger = _make_ledger_from_spec(args.ledger, cfg)
    if not args.name:
        raise SystemExit("info needs an experiment name (-n/--name)")
    doc = ledger.load_experiment(args.name)
    if doc is None:
        raise SystemExit(f"no such experiment: {args.name}")
    exp = Experiment(args.name, ledger).configure()
    s = exp.stats
    payload = {
        "name": exp.name,
        "version": doc.get("version", 1),
        "algorithm": exp.algorithm,
        "space": {n: d.get_prior_string() for n, d in exp.space.items()},
        "max_trials": exp.max_trials,
        "pool_size": exp.pool_size,
        "metadata": exp.metadata,
        "user_args": exp.user_args,
        "stats": {"by_status": s["by_status"], "best": s["best"]},
    }
    if args.as_json:
        print(json.dumps(payload, indent=2))
        return 0
    print(f"experiment {exp.name} (version {payload['version']})")
    branch = (exp.metadata or {}).get("branch")
    if branch:
        print(f"  branched from: {branch['parent']}")
    algo_name = next(iter(exp.algorithm), "?")
    print(f"  algorithm: {algo_name} {exp.algorithm.get(algo_name) or {}}")
    print("  space:")
    for n, prior in payload["space"].items():
        print(f"    {n}~{prior}")
    print(f"  max_trials: {exp.max_trials}  pool_size: {exp.pool_size}")
    counts = ", ".join(f"{k}:{v}" for k, v in sorted(s["by_status"].items()))
    print(f"  trials: {counts or 'none'}")
    if s["best"]:
        print(f"  best: {s['best']['objective']:.6g} at {s['best']['params']}")
    if exp.user_args:
        print(f"  command: {' '.join(exp.user_args)}")
    return 0


_COMMANDS = {
    "hunt": _cmd_hunt,
    "init-only": _cmd_init_only,
    "insert": _cmd_insert,
    "info": _cmd_info,
    "list": _cmd_list,
    "resume": _cmd_resume,
    "status": _cmd_status,
}


#: the CLI's lowest config layer: the reference's defaults with
#: ``executor.n_chips`` unset. The reference pins every hunt by its default
#: of 1; a host without a GPU has nothing to pin to, and a CPU objective
#: (config 1) needs none, so only ``--n-chips`` or a config file pins.
CLI_DEFAULTS = {**DEFAULTS, "executor": {**DEFAULTS["executor"], "n_chips": None}}


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, extras = parser.parse_known_args(argv)
    if extras:
        parser.error("unrecognized arguments: %s" % " ".join(extras))
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)]
    logging.basicConfig(
        level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    cfg = resolve_config(
        {
            "name": getattr(args, "name", None),
            "max_trials": getattr(args, "max_trials", None),
            "pool_size": getattr(args, "pool_size", None),
        },
        getattr(args, "config", None),
        defaults=CLI_DEFAULTS,
    )
    try:
        return _COMMANDS[args.command](args, cfg)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except BrokenPipeError:
        # `status | head` closing stdout early is not an error; die quietly
        # the way POSIX tools do (devnull swap: the interpreter would
        # otherwise warn while flushing the dead stdout at exit)
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
