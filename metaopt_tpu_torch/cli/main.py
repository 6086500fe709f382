"""CLI implementation (port of ``metaopt_tpu/cli/main.py``).

parse argv → resolve config → build space from the user command → configure
experiment → workon. Everything after the user script path is the script's
own command line, with ``~priors`` marking searchable arguments:

    python -m metaopt_tpu_torch hunt -n rosen --max-trials 100 \\
        --ledger file:/tmp/ledger \\
        metaopt_tpu_torch/examples/rosenbrock.py \\
        -x~'uniform(-5, 10)' -y~'uniform(-5, 10)'

Ported subcommands: ``hunt``, ``init-only``, ``insert``, ``resume``,
``list``, ``status``, ``info``, ``db`` (``test``, ``rm``, ``compact``,
``dump``, ``load``, ``set``, ``release``), ``benchmark``, ``plot``
(``regret``, ``lcurve``, ``parallel``, ``importance``, ``pdp``,
``pareto``) and ``web`` (the read-only REST API of
:mod:`~metaopt_tpu_torch.io.webapi`). The importance and pdp views fit
their GP surrogate on ``cuda`` unless ``surrogate.device`` in the config
file names another (the CPU tests pass ``"cpu"``). A bare
``--ledger DIR`` resolves as the reference's does: the native ledgerstore
engine, or the file backend where the directory already holds per-trial
JSON documents or ``g++`` cannot build the engine. EVC: ``--warm-start``,
``--branch-from`` (with ``--branch-default`` / ``--branch-rename``) and
``--on-conflict adopt|fail|branch``. ``hunt --n-chips N`` (or
``executor.n_chips`` in the config file) places each trial on its own block
of N GPUs (:class:`~metaopt_tpu_torch.executor.GPUExecutor`), and ``status
--rungs`` shows a multi-fidelity algorithm's rung occupancy.

``hunt --vector-objective NAME [--batch-size K|auto]`` is the batched hunt:
no trial process, pools of trials evaluated in-process by a
:class:`~metaopt_tpu_torch.executor.BatchedExecutor` on ``cuda``, or on the
device that ``executor.device`` in the config file names (the CPU tests
pass ``"cpu"``; the key never enters the stored experiment).

The coordinator: ``serve`` runs a single-process
:class:`~metaopt_tpu_torch.coord.server.CoordServer` that owns the ledger
and hosts each experiment's algorithm on ``cuda`` (or the device that
``coordinator.device`` in the config file names; without CUDA it raises),
printing ``coordinator ready at coord://HOST:PORT``. ``--ledger
coord://HOST:PORT`` points any subcommand at it, ``hunt --producer coord``
delegates suggestion to the hosted algorithm, and ``tenants`` prints its
multi-tenant service stats. ``serve --shards N`` runs N such servers as
shard processes behind a router (each shard resolves the same device in
its own process; the supervisor never touches CUDA), ``rebalance`` moves
one experiment between shards live, and ``simulate`` drives a
coordinator with thousands of simulated workers on a virtual clock,
hosting its algorithms on the same device as ``serve``.

The checkers (:mod:`metaopt_tpu_torch.analysis`) scan the port's own code:
``lint`` (lock discipline, host syncs in hot functions, the WAL durability
contract), ``crashcheck`` (persistence order and every crash state of the
five durable paths), ``race`` (the shared-attribute check and the
instrumented concurrency suites, hosting on ``coordinator.device`` of its
``--config``, ``cuda`` by default) and ``analyze`` (every static family
at once). Their options are the reference's; ``race --config`` is the
port's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.executor import BatchedExecutor, GPUExecutor, SubprocessExecutor
from metaopt_tpu_torch.io.resolve_config import DEFAULTS, resolve_config
from metaopt_tpu_torch.ledger import Experiment, Trial
from metaopt_tpu_torch.ledger.backends import (
    DuplicateExperimentError,
    DuplicateTrialError,
    ledger_from_spec,
    local_ledger,
    make_ledger,
)
from metaopt_tpu_torch.ledger.evc import (
    BranchConflictError,
    TrialAdapter,
    branch_parent,
)
from metaopt_tpu_torch.ledger.trial import STATUSES
from metaopt_tpu_torch.space import SpaceBuilder, build_space
from metaopt_tpu_torch.worker import workon

log = logging.getLogger(__name__)


def fsync_dir(path: str) -> None:
    """fsync the parent directory so a rename/creat is itself durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

LEDGER_HELP = ("ledger spec: 'memory', a dir path (native engine preferred), "
               "'native:<dir>', 'file:<dir>', or 'coord://host:port'")


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
                           "into this experiment's algorithm before "
                           "suggesting (same ledger)")
    hunt.add_argument("--branch-from", dest="branch_from", default=None,
                      help="EVC: create this experiment as a child of "
                           "another; the parent's completed trials are "
                           "adapted into the (possibly changed) space and "
                           "observed before suggesting")
    hunt.add_argument("--on-conflict", dest="on_conflict", default=None,
                      choices=["adopt", "fail", "branch"],
                      help="what to do when the command's ~priors (or "
                           "--algo) differ from the stored experiment: "
                           "adopt = warn and defer to the stored config "
                           "(the reference's joiner semantics, default); "
                           "fail = stop; branch = EVC auto-resolution — "
                           "create NAME-vN branched from the latest "
                           "version (rerunning the same changed command "
                           "joins the branch it already created)")
    hunt.add_argument("--branch-default", dest="branch_default",
                      action="append", metavar="NAME=VALUE",
                      help="value backfilled into parent trials for a "
                           "dimension the child space added (repeatable)")
    hunt.add_argument("--branch-rename", dest="branch_rename",
                      action="append", metavar="OLD=NEW",
                      help="carry parent dimension OLD into child "
                           "dimension NEW (repeatable)")
    hunt.add_argument("--producer", default=None, choices=["local", "coord"],
                      help="where suggestion runs: 'local' fits the algorithm "
                           "in this worker; 'coord' delegates to the "
                           "coordinator's single hosted instance "
                           "(coord:// ledger only)")
    hunt.add_argument("--profile-dir", default=None,
                      help="capture per-trial torch.profiler traces here "
                           "(scripts opt in with `with client.profiled():`)")
    hunt.add_argument("--ckpt-root", dest="ckpt_root", default=None,
                      help="checkpoint root for PBT weight handoff "
                           "(scripts resolve it via "
                           "client.checkpoint_paths())")
    hunt.add_argument("--batch-size", dest="batch_size", default=None,
                      help="evaluate pools of this many trials as ONE call "
                           "of the vectorized objective on the device (needs "
                           "--vector-objective; 'auto' sizes pools from the "
                           "algorithm's population cohort)")
    hunt.add_argument("--vector-objective", dest="vector_objective",
                      default=None,
                      help="named vectorized in-process objective for the "
                           "batched hunt: a benchmark task with a batch() "
                           "form (rosenbrock/branin/sphere/rastrigin) or "
                           "'mlp' (the batched zoo train objective); "
                           "without a user command the space comes from "
                           "the objective")
    hunt.add_argument("cmd", nargs=argparse.REMAINDER,
                      help="user script and its args with ~priors")

    init = sub.add_parser("init-only", help="create the experiment and exit")
    common(init)
    init.add_argument("--on-conflict", dest="on_conflict", default=None,
                      choices=["adopt", "fail", "branch"])
    init.add_argument("--branch-from", dest="branch_from", default=None)
    init.add_argument("--branch-rename", dest="branch_rename",
                      action="append", metavar="OLD=NEW")
    init.add_argument("--branch-default", dest="branch_default",
                      action="append", metavar="NAME=VALUE")
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

    plot = sub.add_parser("plot", help="optimization diagnostics")
    plot.add_argument("kind",
                      choices=["regret", "lcurve", "parallel", "importance",
                               "pdp",
                               "pareto"],
                      help="regret: best-objective-so-far per completed "
                           "trial; lcurve: objective vs fidelity budget per "
                           "lineage (multi-fidelity experiments); parallel: "
                           "parallel-coordinates data (params + objective "
                           "per completed trial, JSON); importance: "
                           "per-parameter importance from a fitted ARD GP "
                           "surrogate (the lineage's LPI role); pdp: 1-D "
                           "partial dependence of each parameter under "
                           "the same surrogate; pareto: "
                           "nondominated front over the trials' objective "
                           "vectors (multi-objective experiments). The "
                           "surrogate is fitted on cuda unless the config "
                           "file's surrogate.device names another")
    common(plot)
    plot.add_argument("--json", action="store_true", dest="as_json")

    st = sub.add_parser("status", help="show experiment state")
    common(st)
    st.add_argument("--json", action="store_true", dest="as_json")
    st.add_argument("--rungs", action="store_true",
                    help="rung occupancy for multi-fidelity algorithms")
    st.add_argument("--workers", action="store_true",
                    help="per-worker liveness derived from trial "
                         "ownership + heartbeats (who holds what, last "
                         "seen when)")

    db = sub.add_parser("db", help="ledger backend utilities")
    db.add_argument("action", choices=["test", "rm", "compact", "dump",
                                       "load", "set", "release"],
                    help="test: drive the full backend contract (create, "
                         "dup-detect, reserve CAS, heartbeat, stale "
                         "release) against the configured ledger; "
                         "rm: delete an experiment and its trials; "
                         "compact: rewrite a native ledger's append-only "
                         "log to its live state (reclaims heartbeat spam), "
                         "or fold a file ledger's index log into its "
                         "snapshot; "
                         "dump: archive experiments + trials to portable "
                         "JSON; load: restore an archive into the "
                         "configured ledger; "
                         "set: edit experiment fields (max_trials=N, "
                         "pool_size=N) or, with --trial, force a trial's "
                         "status; release: free reserved trials back to "
                         "'new' immediately (instead of waiting for the "
                         "stale-heartbeat sweep)")
    db.add_argument("-n", "--name",
                    help="experiment to delete (rm) / archive (dump; "
                         "default all)")
    db.add_argument("--force", action="store_true",
                    help="rm: required to actually delete")
    db.add_argument("-o", "--output",
                    help="dump: write the archive here (default stdout)")
    db.add_argument("--file", help="load: the archive file to restore")
    db.add_argument("--resolve", choices=["fail", "ignore", "overwrite",
                                          "bump"], default="fail",
                    help="load: name-collision policy — fail (default), "
                         "ignore (skip existing), overwrite (replace doc + "
                         "trials), bump (load as NAME-vN with version+1 and "
                         "parent set, the EVC-style sibling)")
    db.add_argument("--trial", dest="trial_id", default=None,
                    help="set/release: act on one trial (id prefix ok)")
    db.add_argument("assignments", nargs="*", metavar="KEY=VALUE",
                    help="set: fields to change")
    db.add_argument("--json", action="store_true", dest="as_json",
                    help="test: emit the check report as JSON")
    db.add_argument("--config", help="framework config YAML (or JSON)")
    db.add_argument("--ledger", help=LEDGER_HELP)

    web = sub.add_parser(
        "web", help="read-only REST API over the ledger (dashboards)"
    )
    web.add_argument("--config", help="framework config YAML (or JSON); its "
                                      "surrogate.device places the "
                                      "importance and pdp routes' GP fits "
                                      "(default cuda)")
    web.add_argument("--ledger", help=LEDGER_HELP)
    web.add_argument("--host", default="127.0.0.1")
    web.add_argument("--port", type=int, default=0,
                     help="0 binds an ephemeral port (printed at startup)")

    tn = sub.add_parser(
        "tenants",
        help="multi-tenant service stats from a coordinator: per-tenant "
             "produce grants/denials and weights, fleet residency "
             "(resident/evicted/hydrations), and optionally per-"
             "experiment status counts — evicted experiments answered "
             "from their stub index, never hydrated",
    )
    tn.add_argument("--config", help="framework config YAML (or JSON)")
    tn.add_argument("--ledger", help="coord://host:port of the deployment")
    tn.add_argument("--experiments", action="store_true",
                    help="include per-experiment status counts")
    tn.add_argument("--json", action="store_true", dest="as_json")

    srv = sub.add_parser(
        "serve", help="run the pod coordinator (single-writer ledger service)"
    )
    srv.add_argument("--config", help="framework config YAML (or JSON); "
                     "coordinator.device places the hosted algorithms")
    srv.add_argument("--host", default=None,
                     help="bind address (default: config coordinator.host)")
    srv.add_argument("--port", type=int, default=None,
                     help="0 binds an ephemeral port (printed at startup)")
    srv.add_argument("--ledger", default=None,
                     help="inner backing store: 'memory' or a directory path")
    srv.add_argument("--snapshot", dest="snapshot_path", default=None,
                     help="snapshot file for crash/resume")
    srv.add_argument("--snapshot-interval-s", type=float, default=30.0)
    srv.add_argument("--snapshot-full", dest="snapshot_full",
                     action="store_true",
                     help="force full (v1) snapshots: every experiment's "
                          "whole doc set reserialized each time, no "
                          "segment files (default: incremental v2 "
                          "manifests — sealed archive segments written "
                          "once under <snapshot>.segments/, only dirty "
                          "experiments re-captured)")
    srv.add_argument("--archive-segment-rows", dest="archive_segment_rows",
                     type=int, default=None, metavar="N",
                     help="completed-trial archive segment size: completed "
                          "trials seal into immutable columnar segments "
                          "of N rows (default 4096) — flat RSS per trial "
                          "and O(dirty) incremental snapshots at "
                          "million-trial scale")
    srv.add_argument("--no-trial-archive", dest="trial_archive",
                     action="store_false", default=True,
                     help="keep completed trials as resident Trial "
                          "objects instead of sealing them into the "
                          "columnar archive (debugging escape hatch; "
                          "RSS grows with every completion)")
    srv.add_argument("--stale-timeout-s", type=float, default=120.0,
                     help="pacemaker: re-free reservations idle this long")
    srv.add_argument("--event-log", dest="event_log_path", default=None,
                     help="JSONL event log path")
    srv.add_argument("--suggest-prefetch-depth", dest="suggest_prefetch_depth",
                     type=int, default=None,
                     help="speculative pools hosted algorithms keep banked "
                          "so produce legs answer from memory (default 1 = "
                          "refill-when-stale)")
    srv.add_argument("--uds", dest="uds_path", default=None, metavar="PATH",
                     help="also listen on a Unix domain socket at PATH — "
                          "the same-host fast path; the ping reply "
                          "advertises it and pod-local clients prefer it "
                          "over TCP automatically")
    srv.add_argument("--shards", type=int, default=None, metavar="N",
                     help="sharded serving: run N coordinator shard "
                          "subprocesses (consistent-hash ownership by "
                          "experiment, one WAL+snapshot each) behind a "
                          "router on the public port; --snapshot then "
                          "names a DIRECTORY (one snapshot+WAL per shard)")
    srv.add_argument("--max-experiments", type=int, default=None,
                     help="admission control: reject register_experiment "
                          "past this fleet-wide count (per shard when "
                          "--shards is set)")
    srv.add_argument("--max-experiments-per-tenant", type=int, default=None,
                     help="admission control: per-tenant experiment quota "
                          "(experiments carry a 'tenant' config key; "
                          "unset = 'default')")
    srv.add_argument("--evict-idle-s", type=float, default=None,
                     help="evict experiments idle this long to crash-"
                          "atomic evict files (stub stays resident: "
                          "status counts served without hydration; first "
                          "touch restores bit-identically)")
    srv.add_argument("--max-resident", type=int, default=None,
                     help="LRU residency budget: keep at most this many "
                          "experiments hydrated (requires --snapshot "
                          "for the evict directory)")
    srv.add_argument("--tenant-weights", default=None, metavar="JSON",
                     help="fair produce scheduling weights, e.g. "
                          '\'{"acme": 3, "batch": 1}\' — deficit '
                          "round-robin shares of produce capacity "
                          "(unlisted tenants weigh 1.0)")
    srv.add_argument("--fuse-suggest", dest="fuse_suggest",
                     action="store_true", default=None,
                     help="fleet-fused suggest plane: batch compatible "
                          "resident experiments' acquisition launches "
                          "into ONE batched launch per shape bucket each "
                          "tick, feeding their prefetch pools off the "
                          "reply path (suggestions stay bit-identical "
                          "to the per-experiment path on the CPU)")
    srv.add_argument("--fuse-bucket-max", dest="fuse_bucket_max",
                     type=int, default=None, metavar="N",
                     help="max experiments fused into one bucket launch "
                          "(rounded down to a power of two; default 32 "
                          "— bounds worst-case launch latency and "
                          "per-bucket device memory)")

    reb = sub.add_parser(
        "rebalance",
        help="live-migrate one experiment to another coordinator shard "
             "(zero acked-write loss; the hand-off protocol of "
             "coord/handoff.py)",
    )
    reb.add_argument("--coord", required=True, metavar="HOST:PORT",
                     help="any address of the sharded deployment (the "
                          "public/router address or any shard) — the "
                          "shard map is learned from its ping")
    reb.add_argument("--experiment", required=True,
                     help="experiment to move")
    reb.add_argument("--dest", required=True, metavar="SHARD_ID",
                     help="destination shard id (e.g. s1)")
    reb.add_argument("--drain-timeout-s", type=float, default=10.0,
                     help="max wait for the experiment's in-flight ops "
                          "to drain on the source")
    reb.add_argument("--window-s", type=float, default=30.0,
                     help="per-step retry window through shard restarts")

    sim = sub.add_parser(
        "simulate",
        help="discrete-event scale certification: drive the real "
             "coordinator (WAL, snapshots, hosted ASHA/hyperband, fair "
             "scheduler) with N simulated workers on a virtual clock and "
             "certify promotion invariants, zero acked-write loss, and "
             "tenant fairness under an injected fault schedule",
    )
    sim.add_argument("--workers", type=int, default=1000,
                     help="simulated worker count (100000 = the pod-scale "
                          "certification run)")
    sim.add_argument("--seed", type=int, default=0,
                     help="master seed: same seed → byte-identical event "
                          "log (the digest is printed for comparison)")
    sim.add_argument("--faults", default=None, metavar="SPEC",
                     help="fault schedule, executor/faults.py syntax: "
                          "deterministic 'kind:times@skip' and seeded "
                          "probabilistic 'kind:p=0.01@seed' rules, comma-"
                          "separated. Kinds: sim_worker_death, "
                          "sim_lost_heartbeat, sim_delay, sim_crash_server. "
                          "Default: light chaos + two coordinator crashes; "
                          "'' (empty) disables faults")
    sim.add_argument("--tenants", type=int, default=4)
    sim.add_argument("--experiments-per-tenant", type=int, default=2)
    sim.add_argument("--algos", nargs="+", default=["asha"],
                     help="algorithms rotated across experiments, e.g. "
                          "--algos asha hyperband tpe")
    sim.add_argument("--task", default="sphere",
                     help="benchmark objective the simulated trials score")
    sim.add_argument("--trials", dest="sim_max_trials", type=int, default=64,
                     help="max_trials per experiment")
    sim.add_argument("--pool-size", dest="sim_pool_size", type=int, default=8)
    sim.add_argument("--stale-timeout-s", dest="sim_stale_timeout_s",
                     type=float, default=45.0,
                     help="coordinator pacemaker for the simulated fleet")
    sim.add_argument("--max-virtual-s", type=float, default=7200.0,
                     help="virtual-time budget before the run is cut off")
    sim.add_argument("--event-log", dest="sim_event_log", default=None,
                     metavar="PATH",
                     help="write the deterministic JSONL event log here")
    sim.add_argument("--json", dest="as_json", action="store_true",
                     help="emit the full report as JSON on stdout")
    sim.add_argument("--config", default=None,
                     help="framework config YAML (or JSON); its "
                          "coordinator.device places the hosted "
                          "algorithms (default cuda)")

    bm = sub.add_parser(
        "benchmark",
        help="compare algorithms on standard tasks (benchmark studies)",
    )
    bm.add_argument("--algos", nargs="+", default=["random", "tpe"],
                    help="algorithm names, e.g. --algos random tpe gp")
    bm.add_argument("--task", default="rosenbrock",
                    help="benchmark task (rosenbrock/branin/sphere/"
                         "rastrigin/zdt1)")
    bm.add_argument("--max-trials", type=int, default=25,
                    help="trial budget per repetition")
    bm.add_argument("--repetitions", type=int, default=3)
    bm.add_argument("--assessment", choices=("result", "rank",
                                             "hypervolume", "parallel"),
                    default="result",
                    help="result = mean best-so-far; rank = mean final "
                         "rank; hypervolume = mean dominated hypervolume "
                         "(multi-objective tasks, e.g. zdt1); parallel = "
                         "same trial budget under 1 vs N racing workers "
                         "(async-suggestion quality cost + wall-clock "
                         "speedup)")
    bm.add_argument("--workers", nargs="+", type=int, default=(1, 4),
                    metavar="N",
                    help="parallel assessment: worker counts to compare")
    bm.add_argument("--json", dest="as_json", action="store_true")

    lint = sub.add_parser(
        "lint",
        help="repo-invariant static analysis (lock discipline, host "
             "syncs in hot paths, WAL durability contract)",
    )
    lint.add_argument("paths", nargs="*", default=[],
                      help="files/directories to scan (default: the "
                           "metaopt_tpu_torch package, from any cwd)")
    lint.add_argument("--baseline", default=None,
                      help="grandfathered-findings file (default: the "
                           "checked-in analysis/baseline.json)")
    lint.add_argument("--update-baseline", action="store_true")
    lint.add_argument("--no-baseline", action="store_true",
                      help="report every finding, ignore the baseline")
    lint.add_argument("--format", choices=("text", "json"),
                      default="text", dest="lint_format")

    race = sub.add_parser(
        "race",
        help="hybrid race detection: static shared-attribute check plus "
             "lockset/vector-clock instrumented concurrency suites",
    )
    race.add_argument("--suite", action="append", default=None,
                      choices=("coord", "algo", "wal", "sim", "all"),
                      help="workload(s) to run instrumented (repeatable; "
                           "default: all)")
    race.add_argument("--scale", type=int, default=1,
                      help="iteration multiplier (1 = fast CI run)")
    race.add_argument("--static-only", action="store_true",
                      help="run only the MTR001 static check, no workloads")
    race.add_argument("--baseline", default=None,
                      help="grandfathered-findings file (default: the "
                           "checked-in analysis/race_baseline.json)")
    race.add_argument("--update-baseline", action="store_true")
    race.add_argument("--no-baseline", action="store_true",
                      help="report every finding, ignore the baseline")
    race.add_argument("--format", choices=("text", "json"),
                      default="text", dest="race_format")
    race.add_argument("--config", default=None,
                      help="framework config YAML (or JSON); its "
                           "coordinator.device places the coord and sim "
                           "suites' servers and executors (default cuda)")

    crash = sub.add_parser(
        "crashcheck",
        help="crash-consistency certification: static persistence-order "
             "analysis plus exhaustive crash-point enumeration of every "
             "durable path with real recovery",
    )
    crash.add_argument("--suite", action="append", default=None,
                       choices=("wal", "snapshot", "archive", "evict",
                                "handoff", "all"),
                       help="durable path(s) to enumerate (repeatable; "
                            "default: all)")
    crash.add_argument("--static-only", action="store_true",
                       help="run only the MTP static checks, no "
                            "enumeration")
    crash.add_argument("--baseline", default=None,
                       help="grandfathered-findings file (default: the "
                            "checked-in analysis/crash_baseline.json)")
    crash.add_argument("--update-baseline", action="store_true")
    crash.add_argument("--no-baseline", action="store_true",
                       help="report every finding, ignore the baseline")
    crash.add_argument("--format", choices=("text", "json"),
                       default="text", dest="crash_format")

    analyze = sub.add_parser(
        "analyze",
        help="umbrella static analysis: lint + race --static-only + "
             "crashcheck --static-only, one combined report",
    )
    analyze.add_argument("paths", nargs="*", default=[],
                         help="files/directories to scan (default: the "
                              "metaopt_tpu_torch package, from any cwd)")
    analyze.add_argument("--no-baseline", action="store_true",
                         help="report every finding, ignore the "
                              "baselines")
    analyze.add_argument("--format", choices=("text", "json"),
                         default="text", dest="analyze_format")

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
    auto-resolution (and ``db load --resolve bump``) created, ordered by
    version suffix; ``next_name``/``next_version`` is one past the HIGHEST
    occupied (or squatted) slot — a gap left by ``db rm`` is never reused,
    so surviving later versions keep their lineage intact.
    A ``name-vN`` experiment whose lineage does NOT chain back to the
    family (a user-created name that happens to match the pattern, an
    orphan whose parent version was deleted, or a child created BEFORE its
    claimed parent) is skipped — it blocks its slot but is neither joined
    nor branched from.
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
    ledger = _make_ledger_from_spec(args.ledger, cfg)

    space = template = None
    if user_argv:
        space, template = SpaceBuilder().build(user_argv)
        if need_cmd and len(space) == 0:
            raise SystemExit(
                "no ~priors found in the command; mark searchable args like "
                "--lr~'loguniform(1e-5, 1e-1)'"
            )
    metadata = {}
    warm = getattr(args, "warm_start", None) or cfg.get("warm_start")
    if warm:
        metadata["warm_start"] = warm
    version = 1
    branch = getattr(args, "branch_from", None) or cfg.get("branch_from")
    on_conflict = (getattr(args, "on_conflict", None)
                   or cfg.get("on_conflict") or "adopt")
    auto_branch_version: Optional[int] = None
    if not branch:
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
            family, free_name, free_version = _family_versions(ledger, name)
        else:
            family, free_name, free_version = [], name, 1
        match = next(((mn, md) for mn, md in family if _fits(md)), None)
        if family and match is None:
            # diff against the experiment configure() would actually join
            # (the named one), not the newest family version
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
                    f"configuration ({diff}); rerun with --on-conflict "
                    f"branch to version it, or adopt to defer to the "
                    f"stored config"
                )
            if on_conflict == "branch":
                # parent = newest FAMILY member; child name = the first
                # free -vN slot (never an unrelated name-squatter)
                branch = family[-1][0]
                name = free_name
                auto_branch_version = free_version
                log.warning(
                    "EVC: configuration changed (%s); branching %r from %r",
                    diff, name, branch,
                )
            else:
                log.warning(
                    "experiment %r already exists; your command's "
                    "configuration differs (%s) and the STORED config "
                    "wins — pass --on-conflict branch to version the "
                    "change, or fail to stop instead",
                    name, diff,
                )
        elif match is not None and match[0] != name:
            log.warning(
                "EVC: this configuration matches version %d (%r); "
                "joining it", match[1].get("version", 1), match[0],
            )
            name = match[0]
    if branch:
        if branch == name:
            raise SystemExit("--branch-from: the child needs its own name")

        parent_doc = ledger.load_experiment(branch)
        if parent_doc is None:
            raise SystemExit(f"--branch-from: no such experiment {branch!r}")
        existing_child = ledger.load_experiment(name)
        if existing_child is not None:
            if branch_parent(existing_child) != branch:
                # configure() adopts stored config, which would silently drop
                # the requested branch — refuse instead
                raise SystemExit(
                    f"experiment {name!r} already exists and was not "
                    f"branched from {branch!r}; pick a new child name"
                )
        parent_space = build_space(parent_doc["space"])
        defaults: Dict[str, Any] = {}
        for kv in getattr(args, "branch_default", None) or []:
            key, sep, raw = kv.partition("=")
            if not sep:
                raise SystemExit(
                    f"--branch-default wants NAME=VALUE, got {kv!r}"
                )
            try:
                defaults[key] = json.loads(raw)
            except json.JSONDecodeError:
                defaults[key] = raw
        renames: Dict[str, str] = {}
        for kv in getattr(args, "branch_rename", None) or []:
            old, sep, new = kv.partition("=")
            if not sep:
                raise SystemExit(f"--branch-rename wants OLD=NEW, got {kv!r}")
            renames[old] = new
        if space is None:  # same space, new version (config/code change)
            space = parent_space
            user_argv = list(parent_doc.get("user_args", []))
        try:  # fail at branch time, not at first produce
            adapter = TrialAdapter(parent_space, space, defaults, renames)
        except BranchConflictError as err:
            raise SystemExit(f"cannot branch from {branch!r}: {err}")
        metadata["branch"] = {
            "parent": branch,
            "defaults": defaults,
            "renames": renames,
            "adapter": adapter.describe(),
        }
        version = parent_doc.get("version", 1) + 1
        if auto_branch_version is not None:
            # the -vN suffix of an auto-branch child must agree with its
            # document even when a name-squatter forced a later slot
            version = max(version, auto_branch_version)
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
        metadata=metadata,
        user_args=user_argv,
        version=version,
    ).configure()
    # a joiner (no cmd) reuses the stored user_args to rebuild the template
    if template is None and exp.user_args:
        _, template = SpaceBuilder().build(exp.user_args)
    return exp, template


def _vector_objective(name: str):
    """Resolve a named vectorized objective to (batch_fn, space DSL)."""
    from metaopt_tpu_torch.models import objectives as zoo

    if name == "mlp":
        return zoo.make_mlp_batch_objective(), dict(zoo.MLP_SPACE)
    from metaopt_tpu_torch.benchmark.tasks import task_registry

    try:
        task = task_registry.get(name)()
    except KeyError:
        raise SystemExit(
            f"unknown vectorized objective {name!r} (benchmark task "
            "with a batch() form, or 'mlp')"
        )
    if not task.vectorized:
        raise SystemExit(f"benchmark task {name!r} has no vectorized form")
    return task.batch, dict(task.space)


def _cmd_hunt(args, cfg: Dict[str, Any]) -> int:
    batch_size = getattr(args, "batch_size", None) or cfg.get("batch_size")
    vector_name = (getattr(args, "vector_objective", None)
                   or cfg.get("vector_objective"))
    if batch_size not in (None, 1, "1") and not vector_name:
        raise SystemExit(
            "--batch-size needs --vector-objective NAME: pools evaluate "
            "in-process as one vmap program, subprocess trials can't batch"
        )
    vector_fn = None
    if vector_name:
        vector_fn, vector_space = _vector_objective(vector_name)
        if not _strip_remainder(getattr(args, "cmd", []) or []):
            # no user command: the objective is in-process anyway, so the
            # space comes from its declaration (~prior tokens, never run)
            args.cmd = [f"batched:{vector_name}"] + [
                f"{k}~{v}" for k, v in vector_space.items()
            ]
    exp, template = _experiment_from_args(args, cfg, need_cmd=False)
    if vector_fn is None and (template is None or not exp.user_args):
        raise SystemExit("hunt needs a user command (or an experiment that has one)")

    script = template.argv[0] if template.argv else ""
    interpreter = None
    if script.endswith(".py") and not os.access(script, os.X_OK):
        interpreter = [sys.executable]

    n_chips = args.n_chips if args.n_chips is not None else (
        (cfg.get("executor") or {}).get("n_chips")
    )

    batched_executor = None
    if vector_fn is not None:
        if exp.space is None:
            raise SystemExit("batched hunt needs a space (none stored or declared)")
        # one executor for every worker thread (its telemetry is locked)
        batched_executor = BatchedExecutor(
            vector_fn, exp.space, device=(cfg.get("executor") or {}).get("device"))

    def make_executor(tmpl):
        if batched_executor is not None:
            return batched_executor
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
    if vector_fn is not None:
        # in-process vectorized objective: default to cohort-sized pools
        workon_kwargs["batch_size"] = (
            "auto" if batch_size in (None, "auto") else int(batch_size)
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
        # give each thread a private universe — except on a coordinator,
        # where each gets its own client; each has its own Experiment
        # handle, algorithm and executor (the batched hunt's threads share
        # its one executor); the ledger's atomic reserve arbitrates exactly
        # as it does between separate worker processes.
        import threading

        from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient

        results: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        stop = threading.Event()
        shared_ledger = not isinstance(exp.ledger, CoordLedgerClient)

        def run(i: int) -> None:
            try:
                if shared_ledger:
                    w_exp = Experiment(exp.name, exp.ledger).configure()
                    w_template = template
                else:
                    # a coordinator worker gets its own client (its own
                    # reservations to re-assert after a restart)
                    w_exp, w_template = _experiment_from_args(
                        args, cfg, need_cmd=False
                    )
                ex = make_executor(w_template)
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
    from metaopt_tpu_torch.io.webapi import _experiment_detail

    detail = _experiment_detail(ledger, args.name)
    if detail is None:
        raise SystemExit(f"no such experiment: {args.name}")
    exp = Experiment(args.name, ledger).configure()
    s = detail["stats"]
    payload = {
        "name": exp.name,
        "version": detail.get("version", 1),
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


def _cmd_plot(args, cfg: Dict[str, Any]) -> int:
    """The lineage's regret/lcurve plots, and the surrogate and Pareto
    views that the web API serves from the same series.

    Emits JSON (--json) or ASCII; no plotting dependency needed. The
    importance and pdp surrogates are fitted on ``cuda`` unless the config
    file's ``surrogate.device`` names another.
    """
    from metaopt_tpu_torch.io.webapi import regret_series

    ledger = _make_ledger_from_spec(args.ledger, cfg)
    if not args.name:
        raise SystemExit("plot needs an experiment name (-n/--name)")
    if ledger.load_experiment(args.name) is None:
        raise SystemExit(f"no such experiment: {args.name}")
    if args.kind == "lcurve":
        return _plot_lcurve(args, ledger)
    if args.kind == "parallel":
        return _plot_parallel(args, ledger)
    device = (cfg.get("surrogate") or {}).get("device")
    if args.kind == "importance":
        return _plot_importance(args, ledger, device)
    if args.kind == "pdp":
        return _plot_pdp(args, ledger, device)
    if args.kind == "pareto":
        return _plot_pareto(args, ledger)
    points = regret_series(ledger, args.name)
    if args.as_json:
        print(json.dumps({"experiment": args.name, "regret": points},
                         indent=2))
        return 0
    if not points:
        print("no completed trials")
        return 0
    bests = [p["best"] for p in points]
    lo, hi = min(bests), max(bests)
    span = (hi - lo) or 1.0
    height = 8
    rows = [[" "] * len(bests) for _ in range(height)]
    for x, b in enumerate(bests):
        # row 0 is printed first and labelled `hi`, so b == hi maps to row 0
        rows[int((hi - b) / span * (height - 1))][x] = "*"
    print(f"regret ({args.name}): best objective over {len(bests)} "
          "completed trials")
    for r, row in enumerate(rows):
        label = hi - (span * r / (height - 1))
        print(f"{label:>12.4g} |{''.join(row)}")
    print(f"{'':>12} +{'-' * len(bests)}")
    print(f"final best: {bests[-1]:.6g}")
    return 0


def _plot_pareto(args, ledger) -> int:
    """Nondominated front of a multi-objective experiment.

    ASCII scatter for the first two objectives (front points ``*``,
    dominated ``.``) or the full front as JSON; the ranking computation is
    shared with GET /experiments/{name}/pareto and the motpe algorithm.
    """
    from metaopt_tpu_torch.io.webapi import pareto_series

    code, payload = pareto_series(ledger, args.name)
    if code != 200:
        print(payload.get("error", "pareto front unavailable"))
        return 1
    if args.as_json:
        print(json.dumps(payload, indent=2))
        return 0
    front = payload["front"]
    # one consistent snapshot: the payload carries the dominated points
    # too, so the scatter needs no second (racy) ledger read
    all_pts = ([(r["objectives"][0], r["objectives"][1], True)
                for r in front]
               + [(o[0], o[1], False) for o in payload["dominated"]])
    xs = [p[0] for p in all_pts]
    ys = [p[1] for p in all_pts]
    lo_x, hi_x = min(xs), max(xs)
    lo_y, hi_y = min(ys), max(ys)
    sx = (hi_x - lo_x) or 1.0
    sy = (hi_y - lo_y) or 1.0
    width, height = 56, 14
    grid = [[" "] * width for _ in range(height)]
    for x, y, on_front in sorted(all_pts, key=lambda p: p[2]):
        c = int((x - lo_x) / sx * (width - 1))
        r = int((hi_y - y) / sy * (height - 1))  # row 0 = objective-2 max
        grid[r][c] = "*" if on_front else "."
    print(f"pareto front ({args.name}): {len(front)} nondominated of "
          f"{payload['trials']} completed trials, "
          f"{payload['n_objectives']} objectives"
          + (" (showing the first two)" if payload["n_objectives"] > 2
             else ""))
    for r, row in enumerate(grid):
        label = hi_y - sy * r / (height - 1)
        print(f"{label:>12.4g} |{''.join(row)}")
    print(f"{'':>12} +{'-' * width}")
    print(f"{'':>12}  {lo_x:<.4g}{'':>{max(1, width - 16)}}{hi_x:>.4g}")
    return 0


def _plot_importance(args, ledger, device) -> int:
    """Per-parameter importance from the ARD GP surrogate's lengthscales.

    ref: the lineage's LPI (local parameter importance) plot — the
    computation is shared with GET /experiments/{name}/importance so the
    two surfaces can never disagree.
    """
    from metaopt_tpu_torch.io.webapi import importance_series

    code, payload = importance_series(ledger, args.name, device)
    if code != 200:
        print(payload.get("error", "importance unavailable"))
        return 1
    if args.as_json:
        print(json.dumps(payload, indent=2))
        return 0
    pairs = sorted(payload["importance"].items(), key=lambda p: -p[1])
    print(f"parameter importance ({args.name}, ARD GP over "
          f"{payload['trials']} completed trials):")
    width = max(len(n) for n, _ in pairs)
    for name, v in pairs:
        bar = "#" * max(1, int(v * 40))
        print(f"  {name:<{width}}  {v:6.1%}  {bar}")
    return 0


def _plot_pdp(args, ledger, device) -> int:
    """1-D partial dependence per parameter (fitted ARD GP surrogate).

    ref: the lineage's ``plot partial_dependencies`` — shared with
    GET /experiments/{name}/pdp. Text mode renders each parameter's mean
    curve as a sparkline (low objective = tall bar = better region) with
    the minimizing x highlighted.
    """
    from metaopt_tpu_torch.io.webapi import pdp_series

    code, payload = pdp_series(ledger, args.name, device)
    if code != 200:
        print(payload.get("error", "partial dependence unavailable"))
        return 1
    if args.as_json:
        print(json.dumps(payload, indent=2))
        return 0
    blocks = "▁▂▃▄▅▆▇█"
    print(f"partial dependence ({args.name}, ARD GP over "
          f"{payload['trials']} completed trials; taller = lower "
          f"objective = better):")
    width = max(len(n) for n in payload["pdp"])
    for pname, curve in payload["pdp"].items():
        ys = curve["mean"]
        lo, hi = min(ys), max(ys)
        span = (hi - lo) or 1.0
        spark = "".join(
            blocks[int((hi - v) / span * (len(blocks) - 1))] for v in ys
        )
        bx = curve["x"][ys.index(lo)]
        bxs = f"{bx:.4g}" if isinstance(bx, float) else str(bx)
        print(f"  {pname:<{width}}  {spark}  min {lo:.4g} at {bxs}")
    return 0


def _plot_parallel(args, ledger) -> int:
    """Parallel-coordinates export: one row per completed trial.

    Always JSON (the natural input for any parallel-coordinates renderer);
    without --json a compact table prints instead.
    """
    from metaopt_tpu_torch.io.webapi import parallel_series

    dims, rows = parallel_series(ledger, args.name)
    if args.as_json:
        print(json.dumps({"experiment": args.name, "dimensions": dims,
                          "trials": rows}, indent=2))
        return 0
    if not rows:
        print("no completed trials")
        return 0
    widths = {d: max(len(d), 10) for d in dims}
    header = "  ".join(d.ljust(widths[d]) for d in dims) + "  objective"
    print(header)
    for r in sorted(rows, key=lambda r: r["objective"])[:40]:
        cells = []
        for d in dims:
            v = r[d]
            s = f"{v:.4g}" if isinstance(v, float) else str(v)
            cells.append(s.ljust(widths[d]))
        print("  ".join(cells) + f"  {r['objective']:.6g}")
    if len(rows) > 40:
        print(f"... {len(rows) - 40} more (use --json for all)")
    return 0


def _plot_lcurve(args, ledger) -> int:
    """Objective vs fidelity budget per lineage (ASHA/Hyperband/PBT/DEHB)."""
    from metaopt_tpu_torch.io.webapi import lcurve_series

    fid_name, curves = lcurve_series(ledger, args.name)
    if fid_name is None:
        raise SystemExit(
            f"{args.name!r} has no fidelity dimension — lcurve needs a "
            "multi-fidelity experiment"
        )
    if args.as_json:
        print(json.dumps({"experiment": args.name, "fidelity": fid_name,
                          "lcurves": curves}, indent=2))
        return 0
    if not curves:
        print("no completed trials")
        return 0
    budgets = sorted({p["budget"] for pts in curves.values() for p in pts})
    header = "lineage".ljust(14) + "".join(f"{b:>12}" for b in budgets)
    print(f"learning curves ({args.name}), objective per {fid_name}:")
    print(header)
    # deepest-then-best first; cap the table at 20 lineages
    ranked = sorted(
        curves.items(),
        key=lambda kv: (-len(kv[1]), kv[1][-1]["objective"]),
    )
    for lineage, pts in ranked[:20]:
        by_budget = {p["budget"]: p["objective"] for p in pts}
        cells = "".join(
            f"{by_budget[b]:>12.4g}" if b in by_budget else " " * 12
            for b in budgets
        )
        print(lineage[:12].ljust(14) + cells)
    if len(ranked) > 20:
        print(f"... {len(ranked) - 20} more lineages (use --json for all)")
    return 0


#: the dump/load interchange format marker: portable JSON, the reference's
#: own, so archives move between ANY two ledger backends of either package
#: and survive version skew legibly
_ARCHIVE_FORMAT = "metaopt-tpu-archive"


def _db_dump(args, ledger) -> int:
    """Archive experiments (document + every trial) as one JSON file."""
    names = [args.name] if args.name else sorted(ledger.list_experiments())
    experiments = []
    for name in names:
        doc = ledger.load_experiment(name)
        if doc is None:
            raise SystemExit(f"no such experiment: {name}")
        experiments.append({
            "document": doc,
            "trials": [t.to_dict() for t in ledger.fetch(name)],
        })
    archive = {"format": _ARCHIVE_FORMAT, "version": 1,
               "experiments": experiments}
    text = json.dumps(archive, indent=2)
    if args.output:
        tmp = args.output + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.output)  # atomic AND durable: never a torn
        fsync_dir(args.output)        # archive, even across power loss
        n_trials = sum(len(e["trials"]) for e in experiments)
        print(f"dumped {len(experiments)} experiment(s), {n_trials} "
              f"trial(s) to {args.output}")
    else:
        print(text)
    return 0


def _db_load(args, ledger) -> int:
    """Restore a dump archive into the configured ledger.

    Collision policy per --resolve: fail | ignore | overwrite | bump
    (bump loads as ``NAME-vN`` with version+1 and ``parent`` set — the
    ledger keys experiments by name, so a version bump is an EVC-style
    sibling, not an in-place rewrite).
    """
    if not args.file:
        raise SystemExit("db load needs --file ARCHIVE")
    with open(args.file) as f:
        archive = json.load(f)
    if archive.get("format") != _ARCHIVE_FORMAT:
        raise SystemExit(
            f"{args.file}: not a {_ARCHIVE_FORMAT} file "
            f"(format={archive.get('format')!r})"
        )
    if archive.get("version") != 1:
        # a future format revision must fail loudly here, not "succeed"
        # with silently-dropped fields
        raise SystemExit(
            f"{args.file}: archive version {archive.get('version')!r} "
            "is not supported by this release (expected 1)"
        )
    for entry in archive.get("experiments", []):
        doc = dict(entry["document"])
        name = doc.get("name")
        if not name:
            raise SystemExit(f"{args.file}: experiment entry without a name")
        existing = ledger.load_experiment(name)
        if existing is not None:
            if args.resolve == "fail":
                raise SystemExit(
                    f"experiment {name!r} already exists; re-run with "
                    "--resolve ignore|overwrite|bump"
                )
            if args.resolve == "ignore":
                print(f"{name}: exists, skipped")
                continue
            if args.resolve == "overwrite":
                if not ledger.delete_experiment(name):
                    raise SystemExit(
                        f"backend {type(ledger).__name__} cannot overwrite "
                        f"{name!r} (no deletion support)"
                    )
            elif args.resolve == "bump":
                version = int(existing.get("version", 1)) + 1
                bumped = f"{name}-v{version}"
                if ledger.load_experiment(bumped) is not None:
                    raise SystemExit(
                        f"bump target {bumped!r} already exists; "
                        "rm it or dump/load under another name"
                    )
                doc.update(name=bumped, version=version, parent=name)
                name = bumped
        ledger.create_experiment(doc)
        loaded = dups = 0
        for tdoc in entry.get("trials", []):
            t = Trial.from_dict({**tdoc, "experiment": name})
            try:
                ledger.register(t)
                loaded += 1
            except DuplicateTrialError:
                dups += 1  # partially-loaded archive re-applied: idempotent
        note = f" ({dups} already present)" if dups else ""
        print(f"{name}: loaded document + {loaded} trial(s){note}")
    return 0


#: experiment-document fields `db set` may edit, with their coercions —
#: mutating anything else (space, algorithm) would invalidate registered
#: trials; that path is EVC branching, not an in-place edit.
_SETTABLE_EXP_FIELDS = {"max_trials": int, "pool_size": int}


def _resolve_trial_prefix(trials, prefix: str, what: str):
    """Exactly one trial whose id starts with ``prefix``, or SystemExit."""
    matches = [t for t in trials if t.id.startswith(prefix)]
    if not matches:
        raise SystemExit(f"no {what} matching {prefix!r}")
    if len(matches) > 1:
        raise SystemExit(
            f"{prefix!r} is ambiguous ({len(matches)} trials); "
            f"use a longer prefix"
        )
    return matches[0]


def _db_set(args, ledger) -> int:
    """Edit experiment fields, or force a trial's status (admin override)."""
    if not args.name:
        raise SystemExit("db set needs an experiment name (-n/--name)")
    if ledger.load_experiment(args.name) is None:
        raise SystemExit(f"no such experiment: {args.name}")
    assignments: Dict[str, str] = {}
    for kv in args.assignments or []:
        key, sep, raw = kv.partition("=")
        if not sep:
            raise SystemExit(f"db set wants KEY=VALUE, got {kv!r}")
        assignments[key] = raw
    if not assignments:
        raise SystemExit("db set: nothing to change (pass KEY=VALUE)")

    if args.trial_id:
        if list(assignments) != ["status"]:
            raise SystemExit(
                "db set --trial supports exactly one assignment: status=…"
            )
        status = assignments["status"]
        if status not in STATUSES:
            raise SystemExit(
                f"unknown status {status!r}; one of {sorted(STATUSES)}"
            )
        t = _resolve_trial_prefix(ledger.fetch(args.name), args.trial_id,
                                  "trial")
        was = t.status
        # admin override: bypass lifecycle legality but keep the
        # bookkeeping consistent with where the trial lands
        if status == "new":
            t.reset_to_new()
        else:
            t.status = status
            now = time.time()
            if status == "reserved":
                # a reservation without a heartbeat would be invisible to
                # the stale sweep (release_stale skips heartbeat=None) —
                # stamp it like transition() would
                t.start_time = t.start_time or now
                t.heartbeat = now
            elif status in ("completed", "broken", "interrupted") \
                    and t.end_time is None:
                t.end_time = now
        if not ledger.update_trial(t, expected_status=was):
            raise SystemExit(
                f"trial {t.id} changed state concurrently; re-run"
            )
        print(f"trial {t.id}: {was} -> {status}")
        return 0

    patch: Dict[str, Any] = {}
    for key, raw in assignments.items():
        coerce = _SETTABLE_EXP_FIELDS.get(key)
        if coerce is None:
            raise SystemExit(
                f"db set: field {key!r} is not editable (only "
                f"{sorted(_SETTABLE_EXP_FIELDS)}; space/algorithm changes "
                f"are EVC branches — see hunt --on-conflict branch)"
            )
        try:
            patch[key] = coerce(raw)
        except ValueError:
            raise SystemExit(f"db set: {key} wants {coerce.__name__}, "
                             f"got {raw!r}")
        if patch[key] < 1:
            # a stored 0 stalls the producer (pool) or instantly finishes
            # the experiment (max_trials) with no error anywhere
            raise SystemExit(f"db set: {key} must be >= 1, got {patch[key]}")
    ledger.update_experiment(args.name, patch)
    print(f"{args.name}: set " +
          ", ".join(f"{k}={v}" for k, v in patch.items()))
    return 0


def _db_release(args, ledger) -> int:
    """Force reserved trials back to 'new' without waiting for staleness.

    The CAS (`expected_status="reserved"` on the write, and the executor's
    `expected_worker` guard on the old owner's next write) keeps a racing
    live worker safe: whichever side loses the CAS abandons its claim.
    """
    if not args.name:
        raise SystemExit("db release needs an experiment name (-n/--name)")
    if ledger.load_experiment(args.name) is None:
        raise SystemExit(f"no such experiment: {args.name}")
    reserved = ledger.fetch(args.name, status="reserved")
    if args.trial_id:
        reserved = [_resolve_trial_prefix(reserved, args.trial_id,
                                          "reserved trial")]
    released = 0
    for t in reserved:
        t.reset_to_new()
        if ledger.update_trial(t, expected_status="reserved"):
            released += 1
    print(f"released {released} trial(s)")
    return 0


def _cmd_db(args, cfg: Dict[str, Any]) -> int:
    """``db test`` validates a live backend end-to-end; the other actions
    are the admin tools (rm, compact, dump, load, set, release).

    Drives the coordination contract against the *configured* ledger (the
    one production would use), with a throwaway experiment name. Exit 0
    iff every check passed.
    """
    import time as _time

    if args.action != "set" and getattr(args, "assignments", None):
        # a stray positional silently ignored is how `db release -n exp
        # TRIALID` (forgot --trial) would release EVERY reservation
        raise SystemExit(
            f"db {args.action} takes no KEY=VALUE arguments, got "
            f"{args.assignments!r}"
        )
    ledger = _make_ledger_from_spec(args.ledger, cfg)
    if args.action == "dump":
        return _db_dump(args, ledger)
    if args.action == "load":
        return _db_load(args, ledger)
    if args.action == "set":
        return _db_set(args, ledger)
    if args.action == "release":
        return _db_release(args, ledger)
    if args.action == "compact":
        if not hasattr(ledger, "compact"):
            raise SystemExit(
                f"backend {type(ledger).__name__} has no compaction "
                "(native and file ledgers keep append-only logs; memory "
                "and coord stores have nothing on disk to fold)"
            )
        names = ([args.name] if args.name
                 else sorted(ledger.list_experiments()))
        total = 0
        for name in names:
            freed = ledger.compact(name)
            total += freed
            print(f"{name}: reclaimed {freed} bytes")
        print(f"total reclaimed: {total} bytes")
        return 0
    if args.action == "rm":
        # destructive, so --force gates
        if not args.name:
            raise SystemExit("db rm needs an experiment name (-n/--name)")
        doc = ledger.load_experiment(args.name)
        if doc is None:
            raise SystemExit(f"no such experiment: {args.name}")
        n = ledger.count(args.name)
        if not args.force:
            raise SystemExit(
                f"would delete experiment {args.name!r} and its {n} "
                "trial(s); re-run with --force"
            )
        if not ledger.delete_experiment(args.name):
            raise SystemExit(
                f"backend {type(ledger).__name__} does not support deletion"
            )
        print(f"deleted experiment {args.name!r} ({n} trials)")
        return 0

    name = f"_dbtest-{os.getpid()}-{int(os.times().elapsed * 1000)}"
    results: List[tuple] = []

    def check(desc, fn):
        try:
            ok = fn()
            results.append((desc, bool(ok), None))
        except Exception as err:  # a failing backend must not stop the scan
            results.append((desc, False, f"{type(err).__name__}: {err}"))

    doc = {"name": name, "space": {"x": "uniform(0, 1)"},
           "algorithm": {"random": {}}, "max_trials": 1, "version": 1}
    check("create experiment", lambda: ledger.create_experiment(doc) or True)

    def dup_exp():
        try:
            ledger.create_experiment(doc)
            return False
        except DuplicateExperimentError:
            return True
    check("duplicate experiment rejected", dup_exp)
    check("load round-trips", lambda: ledger.load_experiment(name)["name"] == name)
    check("listed", lambda: name in ledger.list_experiments())

    trial = Trial(params={"x": 0.5}, experiment=name)
    check("register trial", lambda: ledger.register(trial) or True)

    def dup_trial():
        try:
            ledger.register(Trial(params={"x": 0.5}, experiment=name,
                                  id=trial.id))
            return False
        except DuplicateTrialError:
            return True
    check("duplicate trial rejected", dup_trial)

    got = {}
    def do_reserve():
        got["t"] = ledger.reserve(name, "dbtest-w1")
        return got["t"] is not None and got["t"].id == trial.id
    check("reserve wins", do_reserve)
    check("second reserve starves", lambda: ledger.reserve(name, "w2") is None)
    check("owner heartbeat", lambda: ledger.heartbeat(name, trial.id, "dbtest-w1"))
    check("foreign heartbeat rejected",
          lambda: not ledger.heartbeat(name, trial.id, "intruder"))

    def stale_cycle():
        t = got["t"]
        t.heartbeat = _time.time() - 10_000
        ledger.update_trial(t)
        released = ledger.release_stale(name, 60.0)
        if not any(r.id == t.id for r in released):
            return False
        again = ledger.reserve(name, "dbtest-w2")
        return again is not None and again.id == t.id
    check("stale release + re-reserve", stale_cycle)

    def push():
        t = ledger.get(name, trial.id)
        t.attach_results([{"name": "o", "type": "objective", "value": 0.25}])
        t.transition("completed")
        return ledger.update_trial(
            t, expected_status="reserved", expected_worker="dbtest-w2"
        )
    check("CAS result push", push)
    check("count by status", lambda: ledger.count(name, "completed") == 1)
    check("fetch filter",
          lambda: [t.objective for t in ledger.fetch(name, "completed")] == [0.25])

    try:
        cleaned = ledger.delete_experiment(name)
    except Exception:
        cleaned = False
    failed = [r for r in results if not r[1]]
    if args.as_json:
        print(json.dumps({
            "backend": type(ledger).__name__,
            "passed": len(results) - len(failed),
            "total": len(results),
            "cleaned": bool(cleaned),
            # name the leftover so a JSON consumer can remove it later
            **({} if cleaned else {"scratch": name}),
            "checks": [{"check": d, "ok": ok, **({"error": e} if e else {})}
                       for d, ok, e in results],
        }, indent=2))
        return 0 if not failed else 1
    for desc, ok, err in results:
        mark = "ok " if ok else "FAIL"
        print(f"  [{mark}] {desc}" + (f" — {err}" if err else ""))
    scratch = ("scratch experiment removed" if cleaned
               else f"scratch experiment {name!r} left on ledger "
                    "(backend has no delete)")
    print(f"{len(results) - len(failed)}/{len(results)} checks passed "
          f"({type(ledger).__name__}; {scratch})")
    return 0 if not failed else 1


def _cmd_benchmark(args, cfg) -> int:
    """Run one study (task × assessment) across the requested algorithms."""
    from metaopt_tpu_torch.benchmark import (
        AverageRank, AverageResult, Benchmark, Hypervolume,
        ParallelAssessment, task_registry,
    )

    try:
        task_cls = task_registry.get(args.task)
    except KeyError:
        print(f"unknown task {args.task!r}; have: "
              f"{', '.join(sorted(task_registry))}", file=sys.stderr)
        return 2
    if args.assessment == "parallel":
        try:
            assess = ParallelAssessment(args.repetitions,
                                        worker_counts=args.workers)
        except ValueError as err:
            print(err, file=sys.stderr)
            return 2
    else:
        assess = {"rank": AverageRank, "hypervolume": Hypervolume}.get(
            args.assessment, AverageResult)(args.repetitions)
    task = task_cls(args.max_trials)
    if isinstance(assess, Hypervolume):
        try:  # detectable BEFORE any trial runs — don't waste a study
            assess.resolve_reference(task)
        except ValueError as err:
            print(err, file=sys.stderr)
            return 2
    bench = Benchmark(
        "cli",
        algorithms=list(args.algos),
        targets=[{"assess": [assess], "task": [task]}],
    )
    bench.process()
    (report,) = bench.analysis()
    if args.as_json:
        print(json.dumps(report, indent=2))
        return 0
    print(f"task: {report['task']}  assessment: {report['assessment']}  "
          f"repetitions: {report['repetitions']}")
    def _num(v):  # an algorithm with zero completed trials prints n/a
        return f"{v:.6g}" if v is not None else "n/a"

    if "final_best" in report:
        width = max(len(a) for a in args.algos)
        finals = report["final_best"]
        for algo in sorted(finals,
                           key=lambda a: (finals[a] is None,
                                          finals[a] or 0.0)):
            print(f"  {algo:<{width}}  final best = {_num(finals[algo])}")
    if "ranks" in report:
        width = max(len(a) for a in args.algos)
        for algo in sorted(report["ranks"], key=lambda a: report["ranks"][a]):
            print(f"  {algo:<{width}}  mean rank = {report['ranks'][algo]:.2f}")
    if "final_hypervolume" in report:
        width = max(len(a) for a in args.algos)
        finals = report["final_hypervolume"]
        for algo in sorted(finals, key=lambda a: (finals[a] is None,
                                                  -(finals[a] or 0.0))):
            print(f"  {algo:<{width}}  final hypervolume = "
                  f"{_num(finals[algo])}")
    if "algorithms" in report:  # parallel assessment table
        for algo, rows in sorted(report["algorithms"].items()):
            print(f"  {algo}:")
            for wkey, row in sorted(
                    rows.items(), key=lambda kv: int(kv[0][1:])):
                line = (f"    {wkey:<4} final best = "
                        f"{_num(row['final_best'])}")
                if row.get("mean_wall_s") is not None:
                    line += f", wall {row['mean_wall_s']:.2f}s"
                if "speedup_vs_1w" in row:
                    line += (f", speedup {row['speedup_vs_1w']}x "
                             f"(eff {row['efficiency']})")
                if "regret_penalty_vs_1w" in row:
                    line += (f", regret penalty "
                             f"{_num(row['regret_penalty_vs_1w'])}")
                print(line)
    print(f"winner: {report['winner']}")
    return 0


def _cmd_tenants(args, cfg: Dict[str, Any]) -> int:
    """``tenants``: the coordinator's multi-tenant service stats."""
    ledger = _make_ledger_from_spec(args.ledger, cfg)
    stats_fn = getattr(ledger, "tenant_stats", None)
    if stats_fn is None:
        print("tenants needs a coordinator ledger (coord://host:port)",
              file=sys.stderr)
        return 2
    stats = stats_fn(include_experiments=args.experiments)
    if args.as_json:
        print(json.dumps(stats, indent=2))
        return 0
    print(f"residency: {stats.get('resident', 0)} resident, "
          f"{stats.get('evicted', 0)} evicted "
          f"({stats.get('evictions', 0)} evictions, "
          f"{stats.get('hydrations', 0)} hydrations)")
    tenants = stats.get("tenants") or {}
    fuser = stats.get("fuser")
    if fuser:
        print(f"fused suggest: {fuser.get('bucket_launches', 0)} bucket "
              f"launches, {fuser.get('fused_experiments', 0)} fused / "
              f"{fuser.get('fallback_experiments', 0)} fallback; last tick "
              f"{fuser.get('last_buckets', 0)} buckets, occupancy "
              f"{fuser.get('last_occupancy', 0.0):g}")
    for tenant in sorted(tenants):
        row = tenants[tenant]
        line = (f"  {tenant}: {row.get('experiments', 0)} experiments "
                f"({row.get('evicted', 0)} evicted), weight "
                f"{row.get('weight', 1.0):g}, produce "
                f"{row.get('granted', 0)} granted / "
                f"{row.get('denied', 0)} denied")
        if "suggest_hit_rate" in row:
            line += (f", suggest hit rate {row['suggest_hit_rate']:.0%}"
                     f" (fused {row.get('fused_commits', 0)} / discarded "
                     f"{row.get('fused_discards', 0)})")
        print(line)
    if args.experiments:
        per = stats.get("experiments") or {}
        for name in sorted(per):
            row = per[name]
            counts = ", ".join(f"{k}={v}" for k, v in
                               sorted((row.get("counts") or {}).items()))
            tag = " [evicted]" if row.get("evicted") else ""
            print(f"    {name} ({row.get('tenant', 'default')}){tag}: "
                  f"{counts or 'no trials'}")
    return 0


def _cmd_serve(args, cfg: Dict[str, Any]) -> int:
    from metaopt_tpu_torch.coord.server import CoordServer, serve_forever

    coord_cfg_early = cfg.get("coordinator") or {}
    shards = (args.shards if args.shards is not None
              else coord_cfg_early.get("shards"))
    if shards:
        if getattr(args, "uds_path", None):
            print("--uds applies to single-process serving; sharded "
                  "deployments route by TCP shard map", file=sys.stderr)
            return 2
        return _serve_sharded(args, coord_cfg_early, int(shards))
    # CLI flags > config file (`ledger:`/`coordinator:` sections) > defaults
    inner = None
    inner_spec = args.ledger
    if inner_spec is None:
        lcfg = cfg.get("ledger") or {}
        if lcfg.get("type", "memory") == "file":
            inner_spec = lcfg.get("path") or os.path.expanduser(
                "~/.metaopt_tpu/ledger"
            )
    if inner_spec and inner_spec != "memory":
        from metaopt_tpu_torch.ledger.backends import make_ledger as _ml

        inner = _ml({"type": "file", "path": inner_spec})
    coord_cfg = cfg.get("coordinator") or {}
    server = CoordServer(
        inner=inner,
        host=args.host if args.host is not None
        else coord_cfg.get("host", "127.0.0.1"),
        port=args.port if args.port is not None else coord_cfg.get("port", 0),
        snapshot_path=args.snapshot_path,
        snapshot_interval_s=args.snapshot_interval_s,
        snapshot_incremental=not getattr(args, "snapshot_full", False),
        archive_segment_rows=(
            args.archive_segment_rows
            if getattr(args, "archive_segment_rows", None) is not None
            else coord_cfg.get("archive_segment_rows")),
        archive_completed=getattr(args, "trial_archive", True),
        stale_timeout_s=args.stale_timeout_s,
        event_log_path=args.event_log_path,
        suggest_prefetch_depth=(
            args.suggest_prefetch_depth
            if args.suggest_prefetch_depth is not None
            else coord_cfg.get("suggest_prefetch_depth", 1)),
        uds_path=args.uds_path or coord_cfg.get("uds_path"),
        max_experiments=(args.max_experiments
                         if args.max_experiments is not None
                         else coord_cfg.get("max_experiments")),
        max_experiments_per_tenant=(
            args.max_experiments_per_tenant
            if args.max_experiments_per_tenant is not None
            else coord_cfg.get("max_experiments_per_tenant")),
        evict_idle_s=(args.evict_idle_s if args.evict_idle_s is not None
                      else coord_cfg.get("evict_idle_s")),
        max_resident=(args.max_resident if args.max_resident is not None
                      else coord_cfg.get("max_resident")),
        tenant_weights=_tenant_weights(args, coord_cfg),
        fuse_suggest=(args.fuse_suggest
                      if args.fuse_suggest is not None
                      else bool(coord_cfg.get("fuse_suggest", False))),
        fuse_bucket_max=(args.fuse_bucket_max
                         if args.fuse_bucket_max is not None
                         else coord_cfg.get("fuse_bucket_max", 32)),
        # the hosted algorithms' device: cuda unless the config file's
        # coordinator section names another (never stored with an
        # experiment)
        device=coord_cfg.get("device"),
    )
    serve_forever(server)
    return 0


def _tenant_weights(args, coord_cfg: Dict[str, Any]):
    """--tenant-weights JSON > the config file's coordinator section."""
    if getattr(args, "tenant_weights", None):
        import json as _json

        weights = _json.loads(args.tenant_weights)
        if not isinstance(weights, dict):
            raise SystemExit("--tenant-weights must be a JSON object "
                             "mapping tenant -> weight")
        return {str(k): float(v) for k, v in weights.items()}
    return coord_cfg.get("tenant_weights")



def _serve_sharded(args, coord_cfg: Dict[str, Any], n_shards: int) -> int:
    """``serve --shards N``: supervisor + router until SIGINT/SIGTERM.

    Each shard is a subprocess CoordServer with its own snapshot + WAL
    under the ``--snapshot`` DIRECTORY; the public port serves old
    clients through the router while new clients learn the shard map
    from any ping and route directly. Each shard resolves
    ``coordinator.device`` (``cuda`` by default) in its own process and
    holds its own CUDA context; this process never initializes CUDA.
    """
    import signal
    import threading

    from metaopt_tpu_torch.coord.shards import ShardSupervisor

    if args.ledger and args.ledger != "memory":
        print("--shards serves the in-memory inner ledger only; per-shard "
              "durability comes from the --snapshot directory (one "
              "snapshot+WAL per shard), not a shared file ledger",
              file=sys.stderr)
        return 2
    sup = ShardSupervisor(
        n_shards,
        host=args.host if args.host is not None
        else coord_cfg.get("host", "127.0.0.1"),
        port=args.port if args.port is not None
        else coord_cfg.get("port", 0),
        snapshot_dir=args.snapshot_path,
        snapshot_interval_s=args.snapshot_interval_s,
        stale_timeout_s=args.stale_timeout_s,
        suggest_prefetch_depth=(
            args.suggest_prefetch_depth
            if args.suggest_prefetch_depth is not None
            else coord_cfg.get("suggest_prefetch_depth", 1)),
        event_log_dir=args.event_log_path,
        max_experiments=(args.max_experiments
                         if args.max_experiments is not None
                         else coord_cfg.get("max_experiments")),
        max_experiments_per_tenant=(
            args.max_experiments_per_tenant
            if args.max_experiments_per_tenant is not None
            else coord_cfg.get("max_experiments_per_tenant")),
        evict_idle_s=(args.evict_idle_s if args.evict_idle_s is not None
                      else coord_cfg.get("evict_idle_s")),
        max_resident=(args.max_resident if args.max_resident is not None
                      else coord_cfg.get("max_resident")),
        tenant_weights=_tenant_weights(args, coord_cfg),
        fuse_suggest=(args.fuse_suggest
                      if args.fuse_suggest is not None
                      else bool(coord_cfg.get("fuse_suggest", False))),
        fuse_bucket_max=(args.fuse_bucket_max
                         if args.fuse_bucket_max is not None
                         else coord_cfg.get("fuse_bucket_max")),
        device=coord_cfg.get("device"),
    )
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    sup.start()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        # one context per shard: the supervisor and router relay bytes only
        sup.stop()
        raise RuntimeError("the shard supervisor initialized CUDA")
    host, port = sup.address
    members = ", ".join(f"{sid}=coord://{h}:{p}"
                        for sid, (h, p) in sup.shard_addresses().items())
    print(f"coordinator ready at coord://{host}:{port} "
          f"({n_shards} shards: {members})", flush=True)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        sup.stop()
        signal.signal(signal.SIGTERM, prev)
    return 0


def _cmd_rebalance(args, cfg: Dict[str, Any]) -> int:
    """``rebalance``: live-migrate one experiment between shards.

    Learns the shard map from any address's ping, computes the
    version-bumped map pinning the experiment to ``--dest``, and drives
    the prepare→ship→apply→commit protocol from this process — the same
    primitive supervisor failover uses.
    """
    from metaopt_tpu_torch.coord.handoff import (
        HandoffError, call_admin, migrate_experiment,
    )
    from metaopt_tpu_torch.coord.shards import RoutingTable, with_override

    host, _, port = args.coord.rpartition(":")
    if not host or not port.isdigit():
        print(f"--coord must be HOST:PORT, got {args.coord!r}",
              file=sys.stderr)
        return 2
    seed = (host, int(port))
    try:
        reply = call_admin(seed, "ping", {}, window_s=args.window_s)
    except HandoffError as err:
        print(err, file=sys.stderr)
        return 1
    smap = (reply.get("result") or {}).get("shard_map") \
        if reply.get("ok") else None
    if not smap:
        print(f"{args.coord} does not advertise a shard map — not a "
              "sharded deployment?", file=sys.stderr)
        return 2
    table = RoutingTable(smap)
    if args.dest not in table.addrs:
        print(f"unknown destination shard {args.dest!r}; map has: "
              f"{', '.join(sorted(table.addrs))}", file=sys.stderr)
        return 2
    source = table.owner(args.experiment)
    if source == args.dest:
        print(f"{args.experiment} already lives on {args.dest}; nothing "
              "to do")
        return 0
    new_map = with_override(smap, args.experiment, args.dest)
    try:
        result = migrate_experiment(
            args.experiment, table.addrs[source], table.addrs[args.dest],
            args.dest, new_map,
            other_addrs=[a for sid, a in table.addrs.items()
                         if sid not in (source, args.dest)],
            drain_timeout_s=args.drain_timeout_s, window_s=args.window_s)
    except HandoffError as err:
        print(f"rebalance failed: {err}", file=sys.stderr)
        return 1
    print(f"{args.experiment}: {source} -> {args.dest} "
          f"({result.get('trials', 0)} trials, "
          f"{result.get('replies', 0)} cached replies, "
          f"map v{result.get('map_version')})")
    return 0


def _cmd_simulate(args: argparse.Namespace, cfg: Dict[str, Any]) -> int:
    """``simulate``: run one scale-certification scenario.

    Exit code 0 = certified (no promotion violations, no acked-write
    loss, no exactly-once violations); 1 = certification failed. The
    coordinator hosts its algorithms on ``coordinator.device`` of the
    config file, ``cuda`` by default, as ``serve`` does.
    """
    from metaopt_tpu_torch.sim.engine import (
        DEFAULT_FAULTS, SimConfig, Simulation,
    )

    sim_cfg = SimConfig(
        workers=args.workers,
        tenants=args.tenants,
        experiments_per_tenant=args.experiments_per_tenant,
        algos=tuple(args.algos),
        task=args.task,
        max_trials=args.sim_max_trials,
        pool_size=args.sim_pool_size,
        seed=args.seed,
        faults=DEFAULT_FAULTS if args.faults is None else args.faults,
        stale_timeout_s=args.sim_stale_timeout_s,
        max_virtual_s=args.max_virtual_s,
        event_log=args.sim_event_log,
    )
    coord_cfg = cfg.get("coordinator") or {}
    report = Simulation(sim_cfg, device=coord_cfg.get("device")).run()
    if args.as_json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
        return 0 if report.ok else 1
    r = report
    print(f"simulated {r.config['workers']} workers / {r.experiments} "
          f"experiments / {r.config['tenants']} tenants "
          f"({'+'.join(r.config['algos'])})")
    print(f"  virtual {r.virtual_s:.0f}s in wall {r.wall_s:.1f}s — "
          f"{r.dispatches} coordinator dispatches")
    print(f"  completed {r.acked_completions} trials "
          f"({r.cas_rejected_completions} delayed completions rejected, "
          f"{r.stale_released} stale released, {r.worker_deaths} worker "
          f"deaths, {r.crashes} coordinator crashes)")
    print(f"  fairness: jain={r.jain} over {r.completed_by_tenant}")
    if r.recoveries:
        print(f"  recovery: {r.recovery_s_per_10k_wal}s/10k WAL records "
              f"across {len(r.recoveries)} crash(es)")
    for name in sorted(r.best_by_experiment):
        print(f"  best {name}: {r.best_by_experiment[name]:.6f}")
    print(f"  event log: {r.event_lines} events "
          f"sha256={r.event_log_sha256[:16]}…")
    problems = (r.promotion_violations + r.acked_write_losses
                + r.exactly_once_violations)
    if problems:
        print(f"CERTIFICATION FAILED ({len(problems)} violation(s)):")
        for p in problems:
            print(f"  ✗ {p}")
        return 1
    print("certified: promotion invariants, zero acked-write loss, "
          "exactly-once replies")
    return 0


def _cmd_web(args, cfg: Dict[str, Any]) -> int:
    """``web``: the read-only REST API over the ledger until SIGINT. The
    surrogate routes fit on ``cuda`` unless the config file's
    ``surrogate.device`` names another (never stored with an experiment)."""
    from metaopt_tpu_torch.io.webapi import make_server, serve_forever

    ledger = _make_ledger_from_spec(args.ledger, cfg)
    device = (cfg.get("surrogate") or {}).get("device")
    serve_forever(make_server(ledger, host=args.host, port=args.port, device=device))
    return 0


def _cmd_lint(args: argparse.Namespace, cfg: Dict[str, Any]) -> int:
    from metaopt_tpu_torch.analysis.runner import lint_main

    argv: List[str] = list(args.paths or [])
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.update_baseline:
        argv.append("--update-baseline")
    if args.no_baseline:
        argv.append("--no-baseline")
    argv += ["--format", args.lint_format]
    return lint_main(argv)


def _cmd_race(args: argparse.Namespace, cfg: Dict[str, Any]) -> int:
    """``race``: the static MTR001 check and the instrumented suites. The
    coord and sim suites host on ``coordinator.device`` of the config
    file, ``cuda`` by default (without CUDA they raise), as ``serve``
    does."""
    from metaopt_tpu_torch.analysis.runner import race_main

    argv: List[str] = []
    for s in args.suite or []:
        argv += ["--suite", s]
    if args.scale != 1:
        argv += ["--scale", str(args.scale)]
    if args.static_only:
        argv.append("--static-only")
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.update_baseline:
        argv.append("--update-baseline")
    if args.no_baseline:
        argv.append("--no-baseline")
    argv += ["--format", args.race_format]
    return race_main(argv, device=(cfg.get("coordinator") or {}).get("device"))


def _cmd_crashcheck(args: argparse.Namespace, cfg: Dict[str, Any]) -> int:
    from metaopt_tpu_torch.analysis.runner import crashcheck_main

    argv: List[str] = []
    for s in args.suite or []:
        argv += ["--suite", s]
    if args.static_only:
        argv.append("--static-only")
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.update_baseline:
        argv.append("--update-baseline")
    if args.no_baseline:
        argv.append("--no-baseline")
    argv += ["--format", args.crash_format]
    return crashcheck_main(argv)


def _cmd_analyze(args: argparse.Namespace, cfg: Dict[str, Any]) -> int:
    from metaopt_tpu_torch.analysis.runner import analyze_main

    argv: List[str] = list(args.paths or [])
    if args.no_baseline:
        argv.append("--no-baseline")
    argv += ["--format", args.analyze_format]
    return analyze_main(argv)


_COMMANDS = {
    "hunt": _cmd_hunt,
    "analyze": _cmd_analyze,
    "benchmark": _cmd_benchmark,
    "crashcheck": _cmd_crashcheck,
    "db": _cmd_db,
    "init-only": _cmd_init_only,
    "insert": _cmd_insert,
    "info": _cmd_info,
    "lint": _cmd_lint,
    "list": _cmd_list,
    "plot": _cmd_plot,
    "race": _cmd_race,
    "rebalance": _cmd_rebalance,
    "resume": _cmd_resume,
    "serve": _cmd_serve,
    "simulate": _cmd_simulate,
    "status": _cmd_status,
    "tenants": _cmd_tenants,
    "web": _cmd_web,
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
