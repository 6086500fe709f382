"""The port's public surface holds the reference's, name for name.

An AST scan of both packages (it reads their source and imports neither):
for every module of ``metaopt_tpu/``, every public top-level function and
class, every public method (``__init__`` included), and every parameter of
those must have a counterpart of the same name in the port's module of the
same path. A method the port's class inherits from another class of the
port counts as its own. Leading-underscore names are out of scope.

Two tables hold the exceptions, each entry with its reason: ``RENAMES``
(the counterpart lives under another module or name) and ``BY_DESIGN``
(no counterpart, on purpose). A name the port drops without an entry
fails the scan, and so does an entry that no longer matches the two trees.
"""

import ast
import copy
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF_ROOT, PORT_ROOT = REPO / "metaopt_tpu", REPO / "metaopt_tpu_torch"
PORT_PKG = "metaopt_tpu_torch"

#: (reference module, name or None for the whole module) ->
#: ((port module, name or None), reason)
RENAMES = {
    ("executor/tpu.py", None): (
        ("executor/gpu.py", None), "the TPU executor becomes the GPU one"),
    ("executor/tpu.py", "TPUExecutor"): (
        ("executor/gpu.py", "GPUExecutor"), "trials are pinned to GPUs, not TPU chips"),
    ("analysis/jax_hygiene.py", None): (
        ("analysis/hotpath.py", None), "MTJ003 (host sync in a hot function) as a PyTorch rule"),
    ("ops/attention.py", "online_softmax_fold"): (
        ("ops/ring_attention.py", "online_softmax_fold"),
        "the fold serves only the ring; K1 folds on the card"),
    ("utils/procs.py", "tpu_backend_reachable"): (
        ("utils/procs.py", "cuda_backend_reachable"), "the breaker's probe reaches a CUDA card"),
}

_PLAIN = "a switch to the plain path, which the port forbids: a wrapper launches its kernel or raises"
_LAYOUT = "a JAX/flax layout device; the port's explicit slicing does its job"
_XLA = "XLA or TPU plumbing; the port JITs nothing"
_DRAWS = "a JAX PRNG key; the port takes explicit draws (philox, draws or a seed)"
_PARAMS = "flax keeps parameters outside the module; a torch module holds its own"
_TX = "an optax transformation; the port passes its optimizer object"
_SHARD = "a JAX sharding; torch tensors carry their own placement"

#: (reference module, qualified name) or (module, qualified name,
#: parameter) -> reason. A class listed here covers its methods.
BY_DESIGN = {
    ("ops/attention.py", "attention_impl"): _PLAIN,
    ("ops/attention.py", "use_flash_attention"): _PLAIN,
    ("ops/attention.py", "shard_map_nocheck"): _LAYOUT,
    ("parallel/sharding.py", "MeshTolerantPartitioned"): _LAYOUT,
    ("parallel/sharding.py", "pin_batch_layout"): _LAYOUT,
    ("parallel/sharding.py", "with_mesh_partitioning"): _LAYOUT,
    ("models/transformer.py", "init_sharded"): _LAYOUT + " (parallel/sharding.py::shard_params)",
    ("models/transformer.py", "sharded_init"): _LAYOUT + " (parallel/sharding.py::shard_params)",
    ("models/lm.py", "init_sharded_lm"): _LAYOUT + " (parallel/sharding.py::shard_params)",
    ("analysis/jax_hygiene.py", "JaxChecker"): "MTJ001/002/004 check jit and donation, which the port has none of",
    ("analysis/jax_hygiene.py", "check_jax"): "MTJ001/002/004 check jit and donation, which the port has none of",
    ("utils/procs.py", "setup_xla_cache"): _XLA,
    ("utils/procs.py", "preflight_backend"): _XLA + "; its fallback to the CPU is what the port refuses",
    ("executor/subproc.py", "SubprocessExecutor.__init__", "jax_cache_dir"): _XLA,
    ("executor/topology.py", "detect_slice_size", "default"):
        "returning a default would stand in for a card that is not there; the port raises",
    ("algo/gp_bo.py", "gp_suggest_fused", "key"): _DRAWS,
    ("algo/gp_bo.py", "gp_acquire_fleet", "fit_key"): _DRAWS,
    ("ops/tpe_math.py", "tpe_suggest_fleet", "base_key"): _DRAWS,
    ("models/data.py", "synthetic_images", "key"): _DRAWS,
    ("models/data.py", "synthetic_seq2seq", "key"): _DRAWS,
    ("models/data.py", "synthetic_lm", "key"): _DRAWS,
    ("models/data.py", "batches", "key"): _DRAWS + " (a torch.Generator)",
    ("models/ppo.py", "env_reset", "key"): _DRAWS,
    ("models/ppo.py", "env_step", "key"): _DRAWS,
    ("models/lm.py", "lm_loss_fn", "dropout_key"): _DRAWS,
    ("models/transformer.py", "loss_fn", "dropout_key"): _DRAWS,
    ("ops/attention.py", "flash_attention", "dropout_key"): _DRAWS,
    ("ops/attention.py", "sharded_flash_attention", "dropout_key"): _DRAWS,
    ("ops/ring_attention.py", "ring_attention", "dropout_key"): _DRAWS,
    ("ops/ulysses.py", "ulysses_attention", "dropout_key"): _DRAWS,
    ("ops/attention.py", "flash_attention", "impl"): _PLAIN,
    ("ops/attention.py", "sharded_flash_attention", "impl"): _PLAIN,
    ("ops/ulysses.py", "ulysses_attention", "impl"): _PLAIN,
    ("ops/attention.py", "flash_attention", "interpret"):
        "Pallas's interpret mode; a CUDA kernel has none, the plain version serves the CPU",
    ("models/lm.py", "lm_loss_fn", "params"): _PARAMS,
    ("models/transformer.py", "loss_fn", "params"): _PARAMS,
    ("models/transformer.py", "readout_xent", "params"): _PARAMS + " (the port takes the table)",
    ("models/transformer.py", "maybe_restore", "params"): _PARAMS + " (the port takes the model)",
    ("models/transformer.py", "maybe_restore", "opt_state"):
        "optax state outside the optimizer; the port restores into its optimizer object",
    ("models/transformer.py", "maybe_restore", "shardings"): _SHARD,
    ("models/checkpoint.py", "restore_state", "shardings"): _SHARD,
    ("models/checkpoint.py", "save_state", "tree"):
        "a pytree; the port saves named flat lists of tensors (trees)",
    ("models/transformer.py", "masked_mean_with_aux", "mutated"):
        "flax's mutated collections; the port passes the auxiliary losses (aux)",
    ("models/lm.py", "make_lm_train_step", "tx"): _TX,
    ("models/transformer.py", "make_train_step", "tx"): _TX,
    ("models/transformer.py", "trial_setup", "mesh"):
        "a JAX Mesh built by the caller; the port builds its DeviceMesh inside the trial's ranks",
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _public(name):
    return not name.startswith("_") or name == "__init__"


def _module_surface(path):
    """{qualified name: parameter list, or None for a class}, and the
    module's classes as {name: (own methods, base expressions)}."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            methods = {sub.name: _params(sub) for sub in node.body
                       if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))}
            classes[node.name] = (methods, node.bases)
            if _public(node.name):
                names[node.name] = None
                for m, ps in methods.items():
                    if _public(m):
                        names[f"{node.name}.{m}"] = ps
    return tree, names, classes


def surface(root):
    """{module path: {qualified name: params or None}} over a package."""
    return {str(p.relative_to(root)): _module_surface(p)[1]
            for p in sorted(root.rglob("*.py")) if "_build" not in p.parts}


def _port_module_of(dotted):
    if not dotted.startswith(PORT_PKG):
        return None
    rel = Path(*dotted.split(".")[1:])
    for cand in (rel.with_suffix(".py"), rel / "__init__.py"):
        if (PORT_ROOT / cand).exists():
            return str(cand)
    return None


def _class_def(mod, name, seen=None):
    """The port class ``name`` as seen from module ``mod``: (its module,
    its own methods, its bases), following ``from metaopt_tpu_torch...``
    imports; None when it is not a class of the port."""
    seen = set() if seen is None else seen
    if (mod, name) in seen or not (PORT_ROOT / mod).exists():
        return None
    seen.add((mod, name))
    tree, _, classes = _module_surface(PORT_ROOT / mod)
    if name in classes:
        return mod, *classes[name]
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    src = _port_module_of(node.module)
                    if src is not None:
                        return _class_def(src, alias.name, seen)
    return None


def port_method(mod, cls, method, inherited_only=False):
    """The parameters of ``cls.method`` in the port's ``mod``, inherited
    from a base class of the port where the class does not define it (or
    always, with ``inherited_only``); None when none has it."""
    found = _class_def(mod, cls)
    if found is None:
        return None
    cmod, methods, bases = found
    if method in methods and not inherited_only:
        return methods[method]
    for base in bases:
        if isinstance(base, ast.Name):
            ps = port_method(cmod, base.id, method)
            if ps is not None:
                return ps
    return None


def _target(mod, qualname, renames):
    """Where a reference name's counterpart must stand: (port module,
    port qualified name)."""
    top, _, rest = qualname.partition(".")
    if (mod, top) in renames:
        pmod, ptop = renames[(mod, top)][0]
    else:
        pmod, ptop = renames.get((mod, None), ((mod, None), ""))[0][0], top
    return pmod, ptop + ("." + rest if rest else "")


def _lookup(port, pmod, pqn):
    """(found, params) of a port name, inherited methods included."""
    names = port.get(pmod)
    if names is None:
        return False, None
    if pqn in names:
        return True, names[pqn]
    cls, _, method = pqn.partition(".")
    params = port_method(pmod, cls, method, inherited_only=True) if method else None
    return (params is not None and cls in names), params


def divergences(ref, port, renames, by_design, modules=None):
    """Every reference name or parameter without a counterpart or an entry,
    and the set of table entries that matched something."""
    out, used = [], set()
    for mod in sorted(modules or ref):
        names = ref[mod]
        pmod_whole = renames.get((mod, None), ((mod, None), ""))[0][0]
        if (mod, None) in renames:
            used.add(("rename", mod, None))
        if pmod_whole not in port:
            out.append(f"{mod}: no port module {pmod_whole}")
            continue
        for qn, params in names.items():
            cls = qn.split(".")[0]
            if (mod, qn) in by_design or (mod, cls) in by_design:
                used.add((mod, qn) if (mod, qn) in by_design else (mod, cls))
                continue
            if (mod, cls) in renames:
                used.add(("rename", mod, cls))
            pmod, pqn = _target(mod, qn, renames)
            found, pparams = _lookup(port, pmod, pqn)
            if not found:
                out.append(f"{mod}::{qn}: no {pmod}::{pqn}")
                continue
            for p in params or ():
                if (mod, qn, p) in by_design:
                    used.add((mod, qn, p))
                elif p not in pparams:
                    out.append(f"{mod}::{qn}({p}): no such parameter of {pmod}::{pqn}")
    return out, used


def stale_entries(ref, port, renames, by_design):
    """Entries that no longer describe the two trees: the reference lacks
    the name, the port has it after all, or a rename's target is missing."""
    _, used = divergences(ref, port, renames, by_design)
    stale = []
    for key in by_design:
        mod, qn, *param = key
        if key not in used:
            stale.append(f"BY_DESIGN {key}: the reference has no such name")
            continue
        pmod, pqn = _target(mod, qn, renames)
        found, pparams = _lookup(port, pmod, pqn)
        if (found and not param) or (param and found and param[0] in pparams):
            stale.append(f"BY_DESIGN {key}: the port has it")
    for (mod, name), ((pmod, pname), _) in renames.items():
        if ("rename", mod, name) not in used:
            stale.append(f"RENAMES {(mod, name)}: the reference has no such name")
        elif pmod not in port or (pname is not None and pname not in port[pmod]):
            stale.append(f"RENAMES {(mod, name)}: the port has no {pmod}::{pname}")
        elif name is None and mod in port:
            stale.append(f"RENAMES {(mod, name)}: the port has {mod} under its own path")
        elif name is not None and name in port.get(mod, {}):
            stale.append(f"RENAMES {(mod, name)}: the port has {mod}::{name} too")
    return stale


REF, PORT = surface(REF_ROOT), surface(PORT_ROOT)


@pytest.mark.parametrize("module", sorted(REF))
def test_every_public_name_of_the_reference_has_its_counterpart(module):
    missing, _ = divergences(REF, PORT, RENAMES, BY_DESIGN, modules=[module])
    assert not missing, "\n".join(missing)


def test_no_table_entry_is_stale():
    stale = stale_entries(REF, PORT, RENAMES, BY_DESIGN)
    assert not stale, "\n".join(stale)


@pytest.mark.parametrize("table", ["RENAMES", "BY_DESIGN"])
def test_every_entry_carries_its_reason(table):
    entries = {k: v[1] for k, v in RENAMES.items()} if table == "RENAMES" else BY_DESIGN
    assert entries and all(isinstance(r, str) and r.strip() for r in entries.values())


@pytest.mark.parametrize("module,qualname,param", [
    ("utils/procs.py", "run_swept", None),
    ("utils/provenance.py", "provenance", None),
    ("executor/topology.py", "BuddyAllocator", None),
    ("executor/topology.py", "BuddyAllocator.free", None),
    ("space/transforms.py", "UnitCube.transform_many", None),
    ("models/data.py", "batches", None),
    ("executor/subproc.py", "SubprocessExecutor.__init__", "extra_env"),
    ("executor/batched.py", "BatchedExecutor.__init__", "result_name"),
    ("utils/procs.py", "run_with_deadline", "stream"),
])
def test_the_scan_fails_when_the_port_drops_a_name(module, qualname, param):
    port = copy.deepcopy(PORT)
    if param is None:
        del port[module][qualname]
        for qn in [q for q in port[module] if q.startswith(qualname + ".")]:
            del port[module][qn]
    else:
        port[module][qualname].remove(param)
    missing, _ = divergences(REF, port, RENAMES, BY_DESIGN)
    want = f"{module}::{qualname}" + (f"({param})" if param else "")
    assert any(m.startswith(want + ":") for m in missing), missing


def test_the_scan_fails_when_the_port_drops_a_module():
    port = {k: v for k, v in PORT.items() if k != "utils/provenance.py"}
    missing, _ = divergences(REF, port, RENAMES, BY_DESIGN)
    assert "utils/provenance.py: no port module utils/provenance.py" in missing


@pytest.mark.parametrize("table,key,value", [
    ("BY_DESIGN", ("utils/procs.py", "run_swept"), "the port has it"),
    ("BY_DESIGN", ("utils/procs.py", "run_with_deadline", "stream"), "the port has it"),
    ("BY_DESIGN", ("utils/procs.py", "no_such_function"), "the reference lacks it"),
    ("RENAMES", ("utils/procs.py", "run_swept"),
     (("utils/procs.py", "run_swept_elsewhere"), "the target is missing")),
    ("RENAMES", ("no/such_module.py", None), (("utils/procs.py", None), "no such source")),
])
def test_the_scan_fails_on_a_stale_entry(table, key, value):
    renames, by_design = dict(RENAMES), dict(BY_DESIGN)
    (renames if table == "RENAMES" else by_design)[key] = value
    stale = stale_entries(REF, PORT, renames, by_design)
    assert any(str(key) in s for s in stale), stale


def test_an_inherited_method_counts_as_the_ports_own():
    # the reference's Random spells out __init__; the port's inherits
    # BaseAlgorithm's, with the same parameters
    assert "Random.__init__" in REF["algo/random_search.py"]
    assert "Random.__init__" not in PORT["algo/random_search.py"]
    assert port_method("algo/random_search.py", "Random", "__init__", inherited_only=True) == \
        REF["algo/random_search.py"]["Random.__init__"]
