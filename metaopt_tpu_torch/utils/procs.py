"""Child processes under a deadline (no torch import here).

Port of ``metaopt_tpu/utils/procs.py``. A child that hangs (in CUDA
runtime or context initialization, in a collective, in user code) must
not hang its parent, so children run Popen + poll + kill — never
``subprocess.run(timeout=...)``, whose post-timeout cleanup waits on the
child — and their output is captured through a temp file, never a PIPE (a
chatty child would deadlock on the ~64KB pipe buffer before exiting).

- :func:`run_with_deadline`: one child, its output optionally captured
  and teed live;
- :func:`run_many_with_deadline`: labelled children under one shared
  deadline, each line teed with its label;
- :func:`run_swept` and :func:`kill_by_env_marker`: a child in its own
  session whose whole tree — trials started with ``start_new_session``
  included — is reaped on the deadline through an environment marker, so
  no orphan keeps its CUDA context and card memory into what runs next
  (:func:`with_sweep_marker` adds a marker to an environment,
  :func:`marked_pids` finds the processes that carry one);
- :func:`cuda_backend_reachable`: the device probe of the subprocess
  executor's circuit breaker (the counterpart of the reference's
  ``tpu_backend_reachable``);
- :func:`process_age_s`, which the example trial scripts report their
  start-up cost with.

The reference's ``setup_xla_cache`` and ``preflight_backend`` have no
counterpart: the port JITs nothing, and "probe, then fall back to the CPU"
is the fallback the port's entry points refuse.
"""

from __future__ import annotations

import codecs
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple


def _drain_fd(fd: int, pos: int) -> Tuple[bytes, int]:
    """Read everything past ``pos`` from a child's capture temp file.

    pread only: the child writes through a dup of this descriptor (one
    shared file offset), so a seek here would relocate the child's next
    write mid-file and corrupt the capture.
    """
    chunks = []
    while True:
        try:
            blk = os.pread(fd, 1 << 16, pos)
        except OSError:
            break
        if not blk:
            break
        chunks.append(blk)
        pos += len(blk)
    return b"".join(chunks), pos


def _kill_and_reap(proc: subprocess.Popen) -> None:
    proc.kill()
    try:  # non-blocking reap; a wedged child may be unwaitable
        proc.wait(timeout=2.0)
    except subprocess.TimeoutExpired:
        pass


def run_with_deadline(
    argv: Sequence[str],
    timeout_s: float,
    env: Optional[dict] = None,
    capture: bool = False,
    poll_s: float = 0.5,
    stream: bool = False,
) -> Tuple[Optional[int], str]:
    """Run ``argv``; return ``(returncode, output)``.

    ``returncode`` is None when the deadline hit and the child was killed
    (possibly unreapably — the non-blocking reap is best-effort). ``output``
    is combined stdout+stderr when ``capture`` or ``stream``, else "" (the
    child's output then goes to /dev/null).

    ``stream=True`` additionally tees the child's output to this process's
    stdout *as it is produced* (each poll tick), so an outer observer that
    kills this process mid-run still sees everything the child printed so
    far — a buffered-until-exit capture shows nothing on such a kill.
    """
    out_f = tempfile.TemporaryFile() if (capture or stream) else None
    streamed = 0  # bytes already teed to stdout
    decoder = codecs.getincrementaldecoder("utf-8")("replace")
    try:
        proc = subprocess.Popen(
            argv, env=env,
            stdout=out_f if out_f is not None else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if out_f is not None else subprocess.DEVNULL,
        )

        def _tee() -> None:
            nonlocal streamed
            if not stream:
                return
            data, streamed = _drain_fd(out_f.fileno(), streamed)
            if data:
                # incremental decode: a multi-byte char split across ticks
                # must not become U+FFFD in the live tail
                sys.stdout.write(decoder.decode(data))
                sys.stdout.flush()

        deadline = time.time() + timeout_s
        rc: Optional[int] = None
        while time.time() < deadline:
            rc = proc.poll()
            _tee()
            if rc is not None:
                break
            time.sleep(poll_s)
        if rc is None:
            rc = proc.poll()  # the child may have exited during the last sleep
        if rc is None:
            _kill_and_reap(proc)
        _tee()  # flush whatever landed after the last tick (or the kill)
        output = ""
        if out_f is not None:
            data, _ = _drain_fd(out_f.fileno(), 0)
            output = data.decode(errors="replace")
        return rc, output
    finally:
        if out_f is not None:
            out_f.close()


class _Job:
    """One labelled child of :func:`run_many_with_deadline`."""

    def __init__(self, label: str, argv: Sequence[str], env: Optional[dict]):
        self.label = label
        self.out_f = tempfile.TemporaryFile()
        self.pos = 0  # bytes already drained
        self.pending = ""  # partial last line awaiting its newline
        self.decoder = codecs.getincrementaldecoder("utf-8")("replace")
        try:
            self.proc = subprocess.Popen(argv, env=env, stdout=self.out_f,
                                         stderr=subprocess.STDOUT)
        except BaseException:
            self.out_f.close()
            raise
        self.rc: Optional[int] = None

    def drain(self, final: bool = False) -> None:
        data, self.pos = _drain_fd(self.out_f.fileno(), self.pos)
        text = self.pending + self.decoder.decode(data)
        *lines, self.pending = text.split("\n")
        for ln in lines:
            sys.stdout.write(f"[{self.label}] {ln}\n")
        if final and self.pending:
            sys.stdout.write(f"[{self.label}] {self.pending}\n")
            self.pending = ""
        sys.stdout.flush()


def run_many_with_deadline(
    jobs: Sequence[Tuple[str, Sequence[str], Optional[dict]]],
    timeout_s: float,
    poll_s: float = 0.5,
) -> dict:
    """Run labelled children concurrently under ONE shared deadline.

    ``jobs`` is ``[(label, argv, env), ...]``. Every child's combined
    stdout+stderr is teed to this process's stdout live, each complete line
    prefixed ``[label] `` — so an outer observer that kills this process
    still sees exactly which jobs were in flight and how far each got
    (``run_with_deadline(stream=True)``, multiplexed).

    Returns ``{label: (returncode_or_None, full_output)}``; a ``None``
    returncode means the shared deadline hit and that child was killed.
    """
    js: list = []
    try:
        # inside the try: a Popen failure for a later job (fork EAGAIN is
        # plausible exactly when several interpreters start at once) must
        # not leak the already-started children unsupervised
        for (label, argv, env) in jobs:
            js.append(_Job(label, argv, env))
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            running = False
            for j in js:
                if j.rc is None:
                    j.rc = j.proc.poll()
                    j.drain()
                    running = running or j.rc is None
            if not running:
                break
            time.sleep(poll_s)
        for j in js:
            if j.rc is None:
                j.rc = j.proc.poll()
            if j.rc is None:
                _kill_and_reap(j.proc)
            j.drain(final=True)
        out = {}
        for j in js:
            data, _ = _drain_fd(j.out_f.fileno(), 0)
            out[j.label] = (j.rc, data.decode(errors="replace"))
        return out
    finally:
        for j in js:
            if j.proc.poll() is None:  # exception paths: no orphans
                _kill_and_reap(j.proc)
            j.out_f.close()


#: the probe child's program: a CUDA context, one kernel, one readback
CUDA_PROBE = "import torch; torch.zeros(1, device='cuda').sum().item()"


def cuda_backend_reachable(timeout_s: float = 90.0) -> bool:
    """Can a fresh interpreter reach a CUDA card right now?

    Probed in a disposable child, so a CUDA runtime or context that hangs costs
    this process ``timeout_s`` at most. False when ``CUDA_VISIBLE_DEVICES``
    is set and empty (no card is meant to be visible).
    """
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return False
    rc, _ = run_with_deadline([sys.executable, "-c", CUDA_PROBE], timeout_s=timeout_s,
                              poll_s=0.2)
    return rc == 0


def marked_pids(marker: str) -> list:
    """Pids of the live processes (this one aside) whose environment
    carries ``marker``; empty on a host without /proc. A zombie's environ
    cannot be read, so a dead process awaiting its reaper never matches."""
    me = os.getpid()
    try:
        pids = os.listdir("/proc")
    except OSError:  # non-Linux host: nothing to sweep, don't sink the run
        return []
    found = []
    for pid_s in pids:
        if not pid_s.isdigit() or int(pid_s) == me:
            continue
        try:
            with open(f"/proc/{pid_s}/environ", "rb") as f:
                if marker.encode() in f.read():
                    found.append(int(pid_s))
        except OSError:
            continue
    return found


def kill_by_env_marker(marker: str) -> int:
    """SIGKILL every process whose environment carries ``marker``.

    Trial trees use ``start_new_session`` at several levels (executor
    trials, their own children), so neither killing a parent nor its
    process group reaches them — but they all inherit the launcher's env.
    Sweeping /proc by a unique marker reaps the whole tree, and with it
    every CUDA context the tree held. Returns the number of processes
    signalled (0 on a host without /proc).
    """
    killed = 0
    for pid in marked_pids(marker):
        try:
            os.kill(pid, signal.SIGKILL)
            killed += 1
        except OSError:
            continue
    return killed


def with_sweep_marker(env: dict, marker: str) -> dict:
    """A copy of ``env`` whose ``MTPU_SWEEP_MARKER`` also carries ``marker``.

    Markers ACCUMULATE across nesting: overwriting would strip the outer
    caller's marker from the whole subtree, leaving its deadline sweep
    nothing to match. Matching is substring-based, so a comma-joined list
    serves every level.
    """
    env = dict(env)
    prev = env.get("MTPU_SWEEP_MARKER")
    env["MTPU_SWEEP_MARKER"] = f"{prev},{marker}" if prev else marker
    return env


def run_swept(
    argv: Sequence[str],
    timeout_s: float,
    env: Optional[dict] = None,
    marker: Optional[str] = None,
    cwd: Optional[str] = None,
) -> Tuple[Optional[int], str, str]:
    """Run ``argv`` in its own session; on deadline, reap its WHOLE tree.

    The child gets a unique ``MTPU_SWEEP_MARKER`` in its env. If the
    deadline fires, the direct kill is followed by :func:`kill_by_env_marker`
    — descendants that ``start_new_session`` (executor trials) escape any
    killpg but inherit the env, and an orphan holding a CUDA context keeps
    its card memory into whatever runs next. Returns
    ``(rc_or_None, stdout, stderr)``; rc None = deadline.
    """
    marker = marker or f"sweep-{os.getpid()}-{time.time_ns()}"
    env = with_sweep_marker(env if env is not None else os.environ, marker)
    # temp files, never PIPE: an orphan that survives the marker sweep
    # keeps a pipe's write end open and communicate() would discard
    # everything the dead child DID print
    with tempfile.TemporaryFile() as out_f, tempfile.TemporaryFile() as err_f:
        proc = subprocess.Popen(
            list(argv), env=env, cwd=cwd,
            stdout=out_f, stderr=err_f, start_new_session=True,
        )
        try:
            rc: Optional[int] = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            kill_by_env_marker(marker)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass  # unreapable; the flushed temp files still read fine
            rc = None

        def _read(f) -> str:
            # pread, never seek: an orphan surviving the sweep still
            # shares the file description, and moving its offset would
            # let its next write corrupt the captured bytes
            data, _ = _drain_fd(f.fileno(), 0)
            return data.decode("utf-8", "replace")

        return rc, _read(out_f), _read(err_f)


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's start stamp
    (``/proc/self/stat`` field 22, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        # the command name (field 2) may hold spaces: split after its ')'
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
