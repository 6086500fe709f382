"""What the mesh tests run inside their ranks (imports torch and the port
only: the ranks are spawned processes that import this module by name).

Each function takes numpy or plain-Python arguments, builds its mesh with
``make_mesh``, runs one rank's share and returns what the parent test
assembles and compares against the JAX reference.
"""

import torch

from metaopt_tpu_torch.parallel import collectives as coll
from metaopt_tpu_torch.parallel import launch
from metaopt_tpu_torch.parallel.mesh import make_mesh
from metaopt_tpu_torch.parallel.sharding import MeshAxes


def coords(axes):
    m = make_mesh(axes)
    return m, MeshAxes(m)


def local(t, ax, spec):
    return ax.local(torch.as_tensor(t), spec).contiguous()


# ---------------------------------------------------------------------------
# mesh, sharding, control


def mesh_facts(axes):
    m, ax = coords(axes)
    return {"shape": dict(zip(m.mesh_dim_names, m.shape)), "index": ax.index,
            "device_type": m.device_type, "rank": launch.rank()}


def mesh_error(axes):
    try:
        make_mesh(axes)
    except ValueError as err:
        return str(err)
    return None


def batch_rows(axes, x):
    """This rank's ``shard_batch`` rows, ``batch_spec`` and ``replicate``d copy."""
    from metaopt_tpu_torch.parallel import batch_spec, replicate, shard_batch

    m, _ = coords(axes)
    x = torch.as_tensor(x)
    return shard_batch(m, x), batch_spec(m), replicate(m, {"x": x}, "cpu")["x"]


def params_shards(axes, full):
    from metaopt_tpu_torch.parallel import shard_params

    m, _ = coords(axes)
    return shard_params(m, {k: torch.as_tensor(v) for k, v in full.items()})


def agree(axes, flags):
    from metaopt_tpu_torch.parallel import pod_agree

    m, _ = coords(axes)
    return pod_agree(m, flags[launch.rank()])


def signaled(axes, stop_rank, stop_after, max_steps, check_every):
    """run_signaled where only ``stop_rank`` wants to stop, after
    ``stop_after`` steps of its own."""
    from metaopt_tpu_torch.parallel import run_signaled

    m, _ = coords(axes)
    state = {"n": 0}

    def step(c):
        state["n"] += 1
        return c + 1

    def should_stop():
        return launch.rank() == stop_rank and state["n"] >= stop_after

    return run_signaled(step, 0, mesh=m, should_stop=should_stop, max_steps=max_steps,
                        check_every=check_every)


def signaled_bad(axes):
    from metaopt_tpu_torch.parallel import run_signaled

    m, _ = coords(axes)
    try:
        run_signaled(lambda c: c, 0, mesh=m, should_stop=lambda: False, max_steps=1,
                     check_every=0)
    except ValueError as err:
        return str(err)
    return None


def signaled_tensor(axes):
    from metaopt_tpu_torch.parallel import run_signaled

    m, _ = coords(axes)
    carry, steps, stopped = run_signaled(lambda x: x * 2.0, torch.ones(()), mesh=m,
                                         should_stop=lambda: False, max_steps=5,
                                         check_every=2)
    return float(carry), steps, stopped


# ---------------------------------------------------------------------------
# sequence-parallel attention: ranks take (dp rows, sp positions, tp heads)


def sp_attention(axes, impl, q, k, v, mask, grads, dropout=None, keep=None):
    """One rank's ring or Ulysses attention on its slices of the global
    q, k, v (B, S, H, D) and mask (B, Sq, Sk); with ``grads`` also the
    gradients of sum(out²) with respect to its slices of q, k, v."""
    from metaopt_tpu_torch.ops.ring_attention import ring_attention
    from metaopt_tpu_torch.ops.ulysses import ulysses_attention

    m, ax = coords(axes)
    spec = ("dp", "sp", "tp")
    ql, kl, vl = (local(t, ax, spec).requires_grad_(grads) for t in (q, k, v))
    kw = {}
    if dropout is not None:
        kw = {"dropout_rate": dropout[0], "philox": tuple(dropout[1])}
    mk = None
    if impl == "ring":
        if mask is not None:
            mk = local(mask, ax, ("dp", "sp"))
        if keep is not None:
            kw = {"dropout_rate": keep[0], "keep": local(keep[1], ax, ("dp", "tp", "sp"))}
        out = ring_attention(ql, kl, vl, mk, mesh=m, **kw)
    else:
        if mask is not None:
            mk = local(mask, ax, ("dp",))
        out = ulysses_attention(ql, kl, vl, mk, mesh=m, **kw)
    res = {"out": out.detach()}
    if grads:
        (out.float() ** 2).sum().backward()
        res.update(dq=ql.grad, dk=kl.grad, dv=vl.grad)
    return res


def sp_error(axes, impl, q):
    """The error of slicing ``q`` over sp (indivisible lengths) or of
    Ulysses' head check."""
    from metaopt_tpu_torch.ops.ring_attention import shard_seq
    from metaopt_tpu_torch.ops.ulysses import ulysses_attention

    m, _ = coords(axes)
    q = torch.as_tensor(q)
    try:
        if impl == "slice":
            shard_seq(q, m)
        else:
            ulysses_attention(q, q, q, mesh=m)
    except ValueError as err:
        return str(err)
    return None


def sharded_attention(axes, q, k, v, mask, philox):
    """sharded_flash_attention on this rank's (dp rows, tp heads) slab."""
    from metaopt_tpu_torch.ops.attention import sharded_flash_attention

    m, ax = coords(axes)
    ql, kl, vl = (local(t, ax, ("dp", None, "tp")) for t in (q, k, v))
    mk = None if mask is None else local(mask, ax, ("dp",))
    kw = {} if philox is None else {"dropout_rate": 0.3, "philox": tuple(philox)}
    return sharded_flash_attention(m, ql, kl, vl, mk, **kw)


# ---------------------------------------------------------------------------
# models


def model_forward(axes, which, hp, state, src, tgt_in=None, sp_impl=None):
    """The port's Transformer (``which`` "tfm") or LM ("lm") on this rank's
    shard of ``state``; its slice of the logits and the collectives it
    called."""
    import os

    from metaopt_tpu_torch.models import lm, transformer as tt
    from metaopt_tpu_torch.parallel import shard_params
    from metaopt_tpu_torch.parallel.mesh import use_mesh

    if sp_impl:
        os.environ["METAOPT_TPU_SP_IMPL"] = sp_impl
    try:
        m, ax = coords(axes)
        make = tt.make_model if which == "tfm" else lm.make_lm
        model = make(hp, mesh=m)
        model.load_state_dict(shard_params(m, {k: torch.as_tensor(v) for k, v in state.items()}))
        coll.reset_counts()
        with use_mesh(m), torch.no_grad():
            args = [local(src, ax, ("dp",))]
            if tgt_in is not None:
                args.append(local(tgt_in, ax, ("dp",)))
            out = model(*args)
        return {"logits": out, "calls": dict(coll.calls)}
    finally:
        os.environ.pop("METAOPT_TPU_SP_IMPL", None)


def model_steps(axes, which, hp, state, batches, masks=None, attention=None):
    """Train steps of the port's Transformer ("tfm", batches of (src, tgt))
    or LM ("lm", token batches) on this rank's shard of ``state``, with the
    reference's AdamW; the losses, and (``masks``/``attention`` given, one
    list per step) dropout drawn from those whole masks."""
    from metaopt_tpu_torch.models import lm, transformer as tt
    from metaopt_tpu_torch.parallel import shard_params
    from metaopt_tpu_torch.parallel.mesh import use_mesh

    m, ax = coords(axes)
    make = tt.make_model if which == "tfm" else lm.make_lm
    model = make(hp, mesh=m)
    model.load_state_dict(shard_params(m, {k: torch.as_tensor(v) for k, v in state.items()}))
    opt = tt.trial_setup(hp, model.parameters(), 10)
    step = tt.make_train_step(model, opt) if which == "tfm" else lm.make_lm_train_step(model, opt)
    losses, stats = [], []
    with use_mesh(m):
        for i, batch in enumerate(batches):
            draws = None
            if masks is not None:
                draws = tt.GivenDraws(masks[i], 0, "cpu", attention_keep=attention[i])
            if which == "tfm":
                batch = tuple(local(b, ax, ("dp",)) for b in batch)
            else:
                batch = local(batch, ax, ("dp",))
            losses.append(float(step(batch, draws)))
    return losses


def moe_layer(axes, hp, state, x):
    """The port's MoE layer on this rank's (dp, sp) tokens: its output
    slice, balance loss and dropped fraction."""
    from metaopt_tpu_torch.models.moe import MoEFeedForward

    m, ax = coords(axes)
    layer = MoEFeedForward(hp["d_model"], hp["d_ff"], hp["n_experts"], 0.0,
                           hp.get("capacity_factor", 1.25), hp.get("router_top_k", 1), ax)
    full = {k: torch.as_tensor(v) for k, v in state.items()}
    spec = {"wi": ("ep", None, "tp"), "wo": ("ep", "tp", None)}
    layer.load_state_dict({k: ax.local(v, spec.get(k, ())) for k, v in full.items()})
    aux = {}
    y = layer(local(x, ax, ("dp", "sp")), aux=aux)
    return {"y": y.detach(), "balance": float(aux["aux_loss"][0]),
            "dropped": float(aux["moe_stats"][0])}


def xent_routing(axes, batch, seq, vocab):
    from metaopt_tpu_torch.models.transformer import blocked_xent_enabled
    from metaopt_tpu_torch.parallel.mesh import use_mesh

    m, _ = coords(axes)
    with use_mesh(m):
        return (blocked_xent_enabled(batch, seq, vocab),
                blocked_xent_enabled(batch, seq, vocab, shards=1),
                blocked_xent_enabled(batch, seq, vocab, shards=8))


def train_on_mesh(axes, which, hp, kw):
    """``train_and_eval``/``train_lm`` given this rank's mesh."""
    from metaopt_tpu_torch.models import lm, transformer as tt

    m, _ = coords(axes)
    fn = tt.train_and_eval if which == "tfm" else lm.train_lm
    rep = {}
    fn(hp, mesh=m, device="cpu", report=rep, **kw)
    return rep["losses"]


def no_dynamo_steps():
    """A tp train step and a pp train step in fresh ranks: whether either
    imported ``torch._dynamo``."""
    import sys

    from metaopt_tpu_torch.models import pipeline_lm as plm
    from metaopt_tpu_torch.models import transformer as tt

    hp = dict(vocab=32, d_model=64, n_heads=2, n_layers=1, d_ff=64, dropout=0.1,
              max_len=16)
    tt.train_and_eval(hp, mesh=make_mesh([("dp", 2), ("tp", 2)]), device="cpu", n_train=8,
                      batch_size=4, seq_len=8, steps=1)
    mesh = make_mesh([("pp", 2), ("dp", 2)])
    fns, params = plm.make_pipeline_lm(hp, 2, 2, seq=8, device="cpu")
    toks = torch.randint(1, 32, (4, 8), generator=torch.Generator().manual_seed(0))
    plm.make_pp_train_step(fns, mesh, n_microbatches=2, virtual_stages=2)(
        params, MeshAxes(mesh).chunk(toks, 0, "dp"))
    return "torch._dynamo" in sys.modules


# ---------------------------------------------------------------------------
# pipeline


def stage(params, h):
    w, b = params
    return torch.tanh(h @ w + b)


def pipe(axes, w, b, x, grads=False, **kw):
    """pipeline_apply of :func:`stage` on this rank's dp rows; with
    ``grads`` the whole stack's gradients of sum(y²) (summed over pp, dp)."""
    from metaopt_tpu_torch.parallel.mesh import axes_group
    from metaopt_tpu_torch.parallel.pipeline import pipeline_apply

    m, ax = coords(axes)
    params = (torch.as_tensor(w).requires_grad_(grads), torch.as_tensor(b).requires_grad_(grads))
    ends = {}
    for name in ("pre_params", "post_params"):
        if name in kw:
            kw[name] = torch.as_tensor(kw[name]).requires_grad_(grads)
            ends[name] = kw[name]
    if "pre_params" in kw:
        kw["pre_fn"] = lambda p, mb: p[mb]
    if "post_params" in kw:
        kw["post_fn"] = lambda p, h: h @ p
    xl = local(x, ax, ("dp",))
    y = pipeline_apply(stage, params, xl, mesh=m, **kw)
    out = {"y": y.detach()}
    if grads:
        loss = (y ** 2).sum()
        loss.backward()
        group = axes_group(m, ("dp", "pp"))
        leaves = [params[0], params[1], *ends.values()]
        # a rank that did not run an end holds no gradient for it: zeros, so
        # that every rank joins every all-reduce
        out["grads"] = [coll.all_reduce_(torch.zeros_like(p) if p.grad is None
                                         else p.grad.clone(), group) for p in leaves]
    return out


def pipe_error(axes, w, b, x, **kw):
    from metaopt_tpu_torch.parallel.pipeline import pipeline_apply

    m, _ = coords(axes)
    try:
        pipeline_apply(stage, (torch.as_tensor(w), torch.as_tensor(b)), torch.as_tensor(x),
                       mesh=m, **kw)
    except ValueError as err:
        return str(err)
    return None


def pipe_lm(axes, hp, params, toks, n_micro, v_stages, step=False):
    """The pipeline LM on this rank's dp rows: its logits, or with ``step``
    the pp train step's (loss, gradients)."""
    from metaopt_tpu_torch.models import pipeline_lm as plm
    from metaopt_tpu_torch.parallel.pipeline import pipeline_apply

    m, ax = coords(axes)
    fns = plm.stage_fns(hp, "cpu")
    toks = local(toks, ax, ("dp",))
    if step:
        loss, grads = plm.make_pp_train_step(fns, m, n_microbatches=n_micro,
                                             virtual_stages=v_stages)(params, toks)
        return float(loss), grads
    with torch.no_grad():
        return pipeline_apply(fns[0], params[0], toks, mesh=m, n_microbatches=n_micro,
                              virtual_stages=v_stages, pre_fn=fns[1], pre_params=params[1],
                              post_fn=fns[2], post_params=params[2])


# ---------------------------------------------------------------------------
# pod


def pod_workon(name, max_trials):
    """start_pod_coordinator across the ranks, then every rank's ``workon``
    against it; the trials this rank ran and the completed count."""
    import time

    import torch.distributed as dist

    from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient
    from metaopt_tpu_torch.coord.pod import start_pod_coordinator
    from metaopt_tpu_torch.executor import InProcessExecutor
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.worker import workon

    host, port, server = start_pod_coordinator(stale_timeout_s=60.0, device="cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        ledger = CoordLedgerClient(host=host, port=port, io_timeout_s=30.0)
        if rank == 0:
            exp = Experiment(name, ledger, space=build_space({"x": "uniform(-5, 5)"}),
                             max_trials=max_trials, pool_size=3,
                             algorithm={"random": {"seed": 0}}).configure()
        else:
            for _ in range(200):
                if ledger.load_experiment(name) is not None:
                    break
                time.sleep(0.05)
            exp = Experiment(name, ledger).configure()
        coll.any_flag(False)   # every rank has its experiment before any works
        stats = workon(exp, InProcessExecutor(lambda p: (p["x"] - 1.0) ** 2),
                       worker_id=f"pod-w{rank}")
        done = exp.count("completed")
        coll.any_flag(False)   # the host outlives every other rank's last call
        return {"server": server is not None, "host": host, "port": port,
                "completed": stats.completed, "total_done": done,
                "events": [e["trial"] for e in stats.events]}
    finally:
        if server is not None:
            server.stop()


def sleep(seconds):
    import time

    time.sleep(seconds)
