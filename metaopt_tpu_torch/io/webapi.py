"""Read-only REST API over the ledger (port of ``metaopt_tpu/io/webapi.py``).

A thin stdlib HTTP server over the ledger, so dashboards can poll a hunt
without touching the coordinator's write path:

- ``GET /``                               → route list
- ``GET /dashboard``                      → self-contained HTML dashboard
  (experiments table + live regret chart; polls the JSON routes, no
  external assets, dark-mode aware)
- ``GET /experiments``                    → summaries (``list``)
- ``GET /experiments/{name}``             → full document + stats (``info``)
- ``GET /experiments/{name}/trials``      → trial docs (``?status=`` filter)
- ``GET /experiments/{name}/regret``      → best-so-far series (``plot``)
- ``GET /experiments/{name}/lcurves``     → objective per fidelity budget
  per lineage (``plot lcurve``)
- ``GET /experiments/{name}/parallel``    → params + objective per
  completed trial (``plot parallel``)
- ``GET /experiments/{name}/importance``  → per-parameter importance from
  the ARD GP surrogate (``plot importance``)
- ``GET /experiments/{name}/pareto``      → nondominated front over the
  trials' objective vectors (``plot pareto``; multi-objective runs)
- ``GET /experiments/{name}/workers``     → per-worker liveness derived
  from trial ownership + heartbeats (``status --workers``)
- ``GET /experiments/{name}/pdp``         → 1-D partial dependence per
  parameter under the fitted ARD GP (``plot pdp``)
- ``GET /healthz``                        → liveness

Deliberately read-only: every write still flows through the single-writer
coordinator or the flock'd file ledger, so this server can never introduce
a new race surface.

The two surrogate routes fit :mod:`metaopt_tpu_torch.algo.gp_bo`'s ARD GP
on the device :func:`make_server` resolves once (``cuda`` unless the
caller passes another; without CUDA it raises). Importing this module
loads no torch: the GP functions, the space and MOTPE's ranking are
imported inside the routes that use them, so ``list`` and ``status`` stay
torch-free.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from metaopt_tpu_torch.ledger.backends import LedgerBackend
from metaopt_tpu_torch.ledger.evc import branch_parent
from metaopt_tpu_torch.ledger.trial import STATUSES

log = logging.getLogger(__name__)


def _experiment_summary(ledger: LedgerBackend, name: str) -> Dict[str, Any]:
    """One-line experiment status; the backing store for ``list``.

    missing/None ``max_trials`` = unbounded (never done by count alone).
    """
    doc = ledger.load_experiment(name) or {}
    completed = ledger.count(name, "completed")
    max_trials = doc.get("max_trials")
    return {
        "name": name,
        "version": doc.get("version", 1),
        "parent": branch_parent(doc),
        "algorithm": next(iter(doc.get("algorithm", {})), None),
        "trials": ledger.count(name),
        "completed": completed,
        "max_trials": max_trials,
        "done": bool(doc.get("algo_done"))
        or (max_trials is not None and completed >= max_trials),
    }


def _experiment_detail(ledger: LedgerBackend, name: str) -> Optional[Dict[str, Any]]:
    """The stored document plus its stats; backs ``info`` and
    ``GET /experiments/{name}``. None for an unknown experiment."""
    from metaopt_tpu_torch.ledger.experiment import Experiment

    doc = ledger.load_experiment(name)
    if doc is None:
        return None
    s = Experiment(name, ledger).configure().stats
    return {**doc, "stats": {"by_status": s["by_status"], "best": s["best"]}}


def worker_table(ledger: LedgerBackend, name: str) -> List[Dict[str, Any]]:
    """Per-worker liveness derived from trial ownership + heartbeats.

    Every trial records its owning worker, reserved trials carry the
    heartbeat the executor pumps, finished trials keep their end time — so
    no extra registry is needed. Backs ``status --workers``.
    """
    now = time.time()
    workers: Dict[str, Dict[str, Any]] = {}
    for t in ledger.fetch(name):
        w = t.worker
        if not w:
            continue
        rec = workers.setdefault(w, {
            "worker": w, "reserved": 0, "completed": 0, "broken": 0,
            "interrupted": 0, "suspended": 0, "current": [],
            "last_seen": None,
        })
        if t.status in rec:
            rec[t.status] += 1
        if t.status == "reserved":
            rec["current"].append(t.id)
            seen = t.heartbeat or t.start_time
        else:
            seen = t.end_time or t.heartbeat
        if seen and (rec["last_seen"] is None or seen > rec["last_seen"]):
            rec["last_seen"] = seen
    out = sorted(workers.values(),
                 key=lambda r: -(r["last_seen"] or 0.0))
    for r in out:
        r["last_seen_age_s"] = (
            round(now - r["last_seen"], 1)
            if r["last_seen"] is not None else None
        )
    return out


def completed_in_order(ledger: LedgerBackend, name: str):
    """Completed trials sorted by completion time — THE progress order.

    Single source for every progress series (regret, lcurves,
    hypervolume-so-far): if the ordering semantics ever change, every
    surface moves together.
    """
    done = list(ledger.fetch(name, "completed"))
    done.sort(key=lambda t: t.end_time or t.submit_time or 0.0)
    return done


def regret_series(ledger: LedgerBackend, name: str) -> List[Dict[str, Any]]:
    """Best-so-far objective per completed trial (shared with ``plot
    regret`` and the benchmark's assessments)."""
    done = [t for t in completed_in_order(ledger, name)
            if t.objective is not None]
    out, best = [], float("inf")
    for i, t in enumerate(done):
        best = min(best, t.objective)
        out.append({"trial": i, "objective": t.objective, "best": best,
                    "id": t.id})
    return out


def parallel_series(ledger: LedgerBackend, name: str):
    """(dimensions, rows) for parallel-coordinates rendering: the space's
    dimension names, sorted, and one row of params and objective per
    completed trial. Shared by ``plot parallel`` and
    GET /experiments/{name}/parallel."""
    doc = ledger.load_experiment(name) or {}
    dims = sorted((doc.get("space") or {}).keys())
    rows = [
        {**{d: t.params.get(d) for d in dims}, "objective": t.objective}
        for t in ledger.fetch(name, "completed")
        if t.objective is not None
    ]
    return dims, rows


def _surrogate_inputs(ledger: LedgerBackend, name: str):
    """Shared loader for the GP-surrogate analyses (importance, pdp).

    Returns ``((cube, X, y), None)`` or ``(None, (status, payload))``.
    Only FINITE objectives count toward the 4-trial floor — a diverged
    (NaN/inf) trial contributes nothing to either analysis, and letting
    it through would turn a user-data condition into a 500 downstream.
    Column naming comes from ``cube.names`` (fidelity dims excluded,
    shaped dims expanded), the exact layout the fitted surrogate sees —
    ``space.keys()`` would misalign on any multi-fidelity experiment.
    """
    import math

    import numpy as np

    from metaopt_tpu_torch.space import UnitCube, build_space

    doc = ledger.load_experiment(name) or {}
    if not doc.get("space"):
        return None, (400, {"error": f"{name!r} has no stored space"})
    space = build_space(doc["space"])
    done = [t for t in ledger.fetch(name, "completed")
            if t.objective is not None and math.isfinite(t.objective)]
    if len(done) < 4:
        return None, (400, {"error": f"need at least 4 completed trials "
                                     f"with finite objectives, have "
                                     f"{len(done)}"})
    cube = UnitCube(space)
    X = np.stack([cube.transform(t.params) for t in done])
    y = np.asarray([t.objective for t in done], np.float32)
    return (cube, X, y), None


def importance_series(ledger: LedgerBackend, name: str, device=None) -> Tuple[int, Any]:
    """(status, payload) for GET /experiments/{name}/importance.

    Parameter importance from the ARD GP surrogate fitted on ``device``
    (:func:`metaopt_tpu_torch.algo.gp_bo.ard_importance`); shares the
    exact computation with ``plot importance``.
    """
    inputs, err = _surrogate_inputs(ledger, name)
    if err is not None:
        return err
    from metaopt_tpu_torch.algo.gp_bo import ard_importance

    cube, X, y = inputs
    imp = ard_importance(X, y, device=device)
    return 200, {"experiment": name, "trials": len(y),
                 "importance": dict(zip(cube.names, imp.tolist()))}


def pdp_series(ledger: LedgerBackend, name: str, device=None) -> Tuple[int, Any]:
    """(status, payload) for GET /experiments/{name}/pdp.

    1-D partial dependence of each parameter under the ARD GP fitted on
    ``device`` (:func:`metaopt_tpu_torch.algo.gp_bo.partial_dependence`,
    the lineage's ``plot partial_dependencies`` role); shared with ``plot
    pdp``. Grid x-values are reported in each cube column's NATIVE scale
    (fidelity dims excluded, shaped dims one curve per element).
    """
    inputs, err = _surrogate_inputs(ledger, name)
    if err is not None:
        return err
    from metaopt_tpu_torch.algo.gp_bo import partial_dependence

    cube, X, y = inputs
    grid, curves = partial_dependence(X, y, device=device)
    out = {}
    for j, pname in enumerate(cube.names):
        dim = cube.dims[j]
        xs = [cube._bwd_one(dim, float(g)) for g in grid]
        out[pname] = {"x": xs, "mean": curves[j].tolist()}
    return 200, {"experiment": name, "trials": len(y), "pdp": out}


def pareto_series(ledger: LedgerBackend, name: str) -> Tuple[int, Any]:
    """(status, payload) for GET /experiments/{name}/pareto.

    Nondominated front over the completed trials' objective VECTORS
    (multi-objective runs report several objective-typed results; see
    Trial.objectives). Shares the ranking computation with the motpe
    algorithm and ``plot pareto``, so the three surfaces agree.
    """
    import numpy as np

    from metaopt_tpu_torch.algo.motpe import nondominated_ranks

    every = [t for t in ledger.fetch(name, "completed") if t.objectives]
    if not every:
        return 400, {"error": f"{name!r} has no completed trials with "
                              "objectives"}
    # the vector length to rank in: the motpe config's n_objectives when
    # the experiment ran motpe (constructor default 2 when the key is
    # omitted — the algorithm truncates to it, so the surface must too),
    # else the MODAL reported length (ties → longer): one stray long- or
    # short-vector trial must never redefine the run's dimensionality.
    # Trials with fewer (or non-finite) objectives are then EXCLUDED,
    # exactly like motpe._observe_one — truncating everyone to the
    # shortest vector would instead drop points that are nondominated
    # only via the missing dimension.
    doc = ledger.load_experiment(name) or {}
    algo_cfg = doc.get("algorithm") or {}
    if "motpe" in algo_cfg:
        m = int((algo_cfg["motpe"] or {}).get("n_objectives", 2))
    else:
        lengths = [len(t.objectives) for t in every]
        m = max(set(lengths), key=lambda n: (lengths.count(n), n))
    if m < 2:
        return 400, {"error": f"{name!r} trials report a single objective; "
                              "the Pareto front needs at least two "
                              "(see client.report_results)"}
    done = [t for t in every
            if len(t.objectives) >= m
            and np.all(np.isfinite(t.objectives[:m]))]
    if not done:
        return 400, {"error": f"{name!r} has no completed trials with "
                              f"{m} finite objectives"}
    F = np.asarray([t.objectives[:m] for t in done], dtype=np.float64)
    ranks = nondominated_ranks(F)
    front = [
        {"id": done[i].id, "params": done[i].params,
         "objectives": F[i].tolist()}
        for i in np.where(ranks == 0)[0]
    ]
    front.sort(key=lambda r: r["objectives"])
    # dominated points ride along so renderers (the CLI scatter) get one
    # consistent snapshot instead of a second racy ledger read
    dominated = sorted(F[i].tolist() for i in np.where(ranks > 0)[0])
    return 200, {"experiment": name, "n_objectives": m,
                 "trials": len(done), "front": front,
                 "dominated": dominated}


def lcurve_series(ledger: LedgerBackend, name: str):
    """(fidelity_name, {lineage: [{budget, objective}...]}) or (None, {}).

    Shared by ``plot lcurve`` and GET /experiments/{name}/lcurves.
    """
    from metaopt_tpu_torch.space import build_space

    doc = ledger.load_experiment(name)
    if doc is None or not doc.get("space"):
        return None, {}
    space = build_space(doc["space"])
    fid = space.fidelity
    if fid is None:
        return None, {}
    curves: Dict[str, List[Dict[str, Any]]] = {}
    for t in ledger.fetch(name, "completed"):
        if t.objective is None or fid.name not in t.params:
            continue
        lineage = t.lineage or space.hash_point(t.params)
        curves.setdefault(lineage, []).append(
            {"budget": int(t.params[fid.name]), "objective": t.objective}
        )
    for pts in curves.values():
        pts.sort(key=lambda p: p["budget"])
    return fid.name, curves


#: Self-contained HTML dashboard (no external assets — works air-gapped).
#: One accessible hue for the single regret series (the title names it, so
#: no legend); text in ink colors, recessive grid; the trials table is the
#: table view; per-point tooltips via SVG <title>.
_DASHBOARD = """<!doctype html>
<html><head><meta charset="utf-8"><title>metaopt-tpu</title><style>
:root { --ink:#1f2430; --muted:#667085; --grid:#e4e7ec; --accent:#2458c5;
        --bg:#ffffff; --row:#f6f7f9; }
@media (prefers-color-scheme: dark) {
  :root { --ink:#e6e9ef; --muted:#98a2b3; --grid:#363c47; --accent:#7da2e8;
          --bg:#15181e; --row:#1d2129; } }
body { font: 14px/1.5 system-ui, sans-serif; color: var(--ink);
       background: var(--bg); margin: 2rem; }
h1 { font-size: 1.2rem; } h2 { font-size: 1rem; }
table { border-collapse: collapse; min-width: 40rem; }
th, td { text-align: left; padding: .35rem .8rem; }
th { color: var(--muted); font-weight: 500;
     border-bottom: 1px solid var(--grid); }
tbody tr:nth-child(even) { background: var(--row); }
tbody tr { cursor: pointer; }
.done { color: var(--accent); font-weight: 600; }
svg text { fill: var(--muted); font-size: 11px; }
.end-label { fill: var(--ink); font-weight: 600; }
#status { color: var(--muted); margin-left: .6rem; font-size: .85rem; }
</style></head><body>
<h1>metaopt-tpu experiments<span id="status"></span></h1>
<table id="exps"><thead><tr><th>name</th><th>algo</th><th>trials</th>
<th>completed</th><th>max</th><th>state</th></tr></thead>
<tbody></tbody></table>
<h2 id="chart-title" hidden></h2>
<div id="chart"></div>
<h2 id="pareto-title" hidden></h2>
<div id="pareto"></div>
<h2 id="workers-title" hidden></h2>
<table id="workers" hidden><thead><tr><th>worker</th><th>completed</th>
<th>broken</th><th>holds</th><th>last seen</th></tr></thead>
<tbody></tbody></table>
<script>
const W=640, H=220, PAD=42;
async function j(u){ const r=await fetch(u); return r.json(); }
// experiment names are user-controlled strings headed into innerHTML —
// escape or a hostile `-n` becomes stored XSS for anyone watching
function esc(s){ return String(s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c])); }
function fmt(v){ return Math.abs(v)>=100?v.toFixed(0)
                 : Math.abs(v)>=1?v.toFixed(2):v.toPrecision(3); }
function drawRegret(name, series){
  // best-objective-so-far vs trial index: a 2px single-hue line on a
  // recessive grid; the heading names the series (no legend needed)
  document.getElementById('chart-title').hidden=false;
  document.getElementById('chart-title').textContent=
    name+' — best objective so far';
  if(!series.length){
    document.getElementById('chart').textContent='no completed trials yet';
    return;}
  const ys=series.map(p=>p[1]), xs=series.map(p=>p[0]);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const yr=(ymax-ymin)||1, xr=(xs[xs.length-1]-xs[0])||1;
  const X=i=>PAD+(i-xs[0])/xr*(W-2*PAD), Y=v=>H-PAD-(v-ymin)/yr*(H-2*PAD);
  const pts=series.map(p=>X(p[0])+','+Y(p[1])).join(' ');
  let g='';
  for(const t of [ymin, ymin+yr/2, ymax]){
    g+=`<line x1="${PAD}" y1="${Y(t)}" x2="${W-PAD}" y2="${Y(t)}"
         stroke="var(--grid)" stroke-width="1"/>
        <text x="4" y="${Y(t)+4}">${fmt(t)}</text>`;}
  const dots=series.map(p=>
    `<circle cx="${X(p[0])}" cy="${Y(p[1])}" r="8" fill="transparent">
       <title>trial ${p[0]}: ${fmt(p[1])}</title></circle>`).join('');
  const last=series[series.length-1];
  document.getElementById('chart').innerHTML=
   `<svg width="${W}" height="${H}" role="img"
         aria-label="regret curve for ${esc(name)}">
      ${g}
      <polyline points="${pts}" fill="none" stroke="var(--accent)"
                stroke-width="2" stroke-linejoin="round"/>
      <circle cx="${X(last[0])}" cy="${Y(last[1])}" r="3"
              fill="var(--accent)"/>
      <text class="end-label" x="${Math.min(X(last[0])+6, W-38)}"
            y="${Y(last[1])-6}">${fmt(last[1])}</text>
      <text x="${PAD}" y="${H-6}">trial ${xs[0]}</text>
      <text x="${W-PAD-40}" y="${H-6}">trial ${last[0]}</text>
      ${dots}
    </svg>`;
}
let selected=null;
async function refresh(){
  try{
    const exps=await j('/experiments');
    const tb=document.querySelector('#exps tbody'); tb.innerHTML='';
    for(const e of exps){
      const tr=document.createElement('tr');
      tr.innerHTML=`<td>${esc(e.name)}</td><td>${esc(e.algorithm??'?')}</td>
        <td>${esc(e.trials)}</td><td>${esc(e.completed)}</td>
        <td>${esc(e.max_trials??'∞')}</td>
        <td class="${e.done?'done':''}">${e.done?'done':'running'}</td>`;
      tr.onclick=()=>{selected=e.name; show(e.name);};
      tb.appendChild(tr);
    }
    if(selected===null && exps.length){selected=exps[0].name; show(selected);}
    document.getElementById('status').textContent=
      'updated '+new Date().toLocaleTimeString();
  }catch(err){
    document.getElementById('status').textContent='unreachable: '+err;
  }
}
function drawPareto(name, front, dominated){
  // objective-1 vs objective-2 scatter: dominated points recessive,
  // front points in the accent hue joined by a step line
  const t=document.getElementById('pareto-title');
  t.hidden=false;
  t.textContent=name+' — pareto front ('+front.length+' nondominated)';
  const pts=front.map(r=>r.objectives).concat(dominated);
  const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const xr=(xmax-xmin)||1, yr=(ymax-ymin)||1;
  const X=v=>PAD+(v-xmin)/xr*(W-2*PAD), Y=v=>H-PAD-(v-ymin)/yr*(H-2*PAD);
  let g='';
  for(const t2 of [ymin, ymax]){
    g+=`<line x1="${PAD}" y1="${Y(t2)}" x2="${W-PAD}" y2="${Y(t2)}"
         stroke="var(--grid)" stroke-width="1"/>
        <text x="4" y="${Y(t2)+4}">${fmt(t2)}</text>`;}
  const dots=dominated.map(p=>
    `<circle cx="${X(p[0])}" cy="${Y(p[1])}" r="2.5"
       fill="var(--muted)" opacity="0.45"><title>${fmt(p[0])}, ${fmt(p[1])}
       </title></circle>`).join('');
  const fsorted=front.map(r=>r.objectives)
    .slice().sort((a,b)=>a[0]-b[0]);
  const fline=fsorted.map(p=>X(p[0])+','+Y(p[1])).join(' ');
  const fdots=front.map(r=>
    `<circle cx="${X(r.objectives[0])}" cy="${Y(r.objectives[1])}" r="3.5"
       fill="var(--accent)"><title>${esc(JSON.stringify(r.params))} →
       ${r.objectives.map(fmt).join(', ')}</title></circle>`).join('');
  document.getElementById('pareto').innerHTML=
   `<svg width="${W}" height="${H}" role="img"
         aria-label="pareto front for ${esc(name)}">
      ${g}
      <polyline points="${fline}" fill="none" stroke="var(--accent)"
                stroke-width="1.5" stroke-dasharray="4 3"/>
      ${dots}${fdots}
      <text x="${PAD}" y="${H-6}">obj1 ${fmt(xmin)}</text>
      <text x="${W-PAD-52}" y="${H-6}">${fmt(xmax)}</text>
    </svg>`;
}
async function show(name){
  const r=await j('/experiments/'+encodeURIComponent(name)+'/regret');
  if(name!==selected) return;  // a newer click superseded this fetch
  drawRegret(name, (r.regret||[]).map(d=>[d.trial, d.best]));
  drawWorkers(name);
  // multi-objective runs additionally get the front scatter; a 400 from
  // a single-objective run just hides the section
  try{
    const p=await j('/experiments/'+encodeURIComponent(name)+'/pareto');
    if(name!==selected) return;  // stale response: don't draw A under B
    if(p.front){ drawPareto(name, p.front, p.dominated||[]); return; }
  }catch(e){}
  if(name!==selected) return;
  document.getElementById('pareto-title').hidden=true;
  document.getElementById('pareto').innerHTML='';
}
async function drawWorkers(name){
  // per-worker liveness (the status --workers table): reserved holders
  // with a fresh heartbeat read as live; long-silent rows read as gone
  try{
    const rows=await j('/experiments/'+encodeURIComponent(name)+'/workers');
    if(name!==selected) return;
    const title=document.getElementById('workers-title');
    const table=document.getElementById('workers');
    if(!rows.length){ title.hidden=true; table.hidden=true; return; }
    title.hidden=false; table.hidden=false;
    title.textContent=name+' — workers ('+rows.length+')';
    const tb=table.querySelector('tbody'); tb.innerHTML='';
    for(const w of rows){
      const age=w.last_seen_age_s;
      const seen=age==null?'never':
        age<120?fmt(age)+'s ago':fmt(age/60)+'m ago';
      const tr=document.createElement('tr');
      tr.innerHTML=`<td>${esc(w.worker)}</td><td>${esc(w.completed)}</td>
        <td>${esc(w.broken)}</td>
        <td>${esc((w.current||[]).map(t=>t.slice(0,8)).join(' ')||'—')}</td>
        <td>${esc(seen)}</td>`;
      tb.appendChild(tr);
    }
  }catch(e){
    // a failed fetch must not leave the PREVIOUS experiment's rows
    // mislabeled under the new selection
    document.getElementById('workers-title').hidden=true;
    document.getElementById('workers').hidden=true;
  }
}
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    ledger: LedgerBackend  # set by make_server on the class
    device: Any            # the surrogate's device, resolved by make_server

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("webapi: " + fmt, *args)

    def _send(self, code: int, payload: Any) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_html(self, body: str) -> None:
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if parts == ["dashboard"]:
                self._send_html(_DASHBOARD)
                return
            query = parse_qs(url.query)
            code, payload = self._route(parts, query)
        except Exception as err:  # a bad request must not kill the thread
            log.exception("webapi error for %s", self.path)
            code, payload = 500, {"error": str(err)}
        self._send(code, payload)

    def _route(self, parts: List[str], query) -> Tuple[int, Any]:
        ledger = self.ledger
        if not parts:
            return 200, {"routes": [
                "/dashboard",
                "/experiments", "/experiments/{name}",
                "/experiments/{name}/trials", "/experiments/{name}/regret",
                "/experiments/{name}/lcurves",
                "/experiments/{name}/parallel",
                "/experiments/{name}/importance",
                "/experiments/{name}/pareto",
                "/experiments/{name}/pdp",
                "/experiments/{name}/workers", "/healthz",
            ]}
        if parts == ["healthz"]:
            return 200, {"ok": True}
        if parts[0] != "experiments" or len(parts) > 3:
            return 404, {"error": f"unknown route /{'/'.join(parts)}"}
        if len(parts) == 1:
            return 200, [
                _experiment_summary(ledger, n)
                for n in sorted(ledger.list_experiments())
            ]
        name = parts[1]
        if ledger.load_experiment(name) is None:
            return 404, {"error": f"no such experiment: {name}"}
        if len(parts) == 2:
            return 200, _experiment_detail(ledger, name)
        if parts[2] == "trials":
            status = (query.get("status") or [None])[0]
            if status is not None and status not in STATUSES:
                return 400, {"error": f"status must be one of {STATUSES}"}
            return 200, [t.to_dict() for t in ledger.fetch(name, status)]
        if parts[2] == "regret":
            return 200, {"experiment": name,
                         "regret": regret_series(ledger, name)}
        if parts[2] == "lcurves":
            fid_name, curves = lcurve_series(ledger, name)
            if fid_name is None:
                return 400, {"error": f"{name!r} has no fidelity dimension"}
            return 200, {"experiment": name, "fidelity": fid_name,
                         "lcurves": curves}
        if parts[2] == "parallel":
            dims, rows = parallel_series(ledger, name)
            return 200, {"experiment": name, "dimensions": dims,
                         "trials": rows}
        if parts[2] == "importance":
            return importance_series(ledger, name, self.device)
        if parts[2] == "pareto":
            return pareto_series(ledger, name)
        if parts[2] == "workers":
            return 200, worker_table(ledger, name)
        if parts[2] == "pdp":
            return pdp_series(ledger, name, self.device)
        return 404, {"error": f"unknown route /{'/'.join(parts)}"}


def make_server(
    ledger: LedgerBackend, host: str = "127.0.0.1", port: int = 0, device=None,
) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server; port 0 picks an ephemeral one.

    ``device`` places the surrogate routes' GP fits: ``cuda`` unless the
    caller passes another, resolved here, once (without CUDA it raises)."""
    from metaopt_tpu_torch.utils.device import resolve_device

    handler = type("BoundHandler", (_Handler,),
                   {"ledger": ledger, "device": resolve_device(device)})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(server: ThreadingHTTPServer) -> None:
    host, port = server.server_address[:2]
    print(f"webapi listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def start_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
