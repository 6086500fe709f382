"""metaopt-tpu on PyTorch and CUDA: the port of :mod:`metaopt_tpu`.

A second package beside the JAX one, held against it module by module. It
imports ``torch`` and never JAX nor anything of ``metaopt_tpu``. Device
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
What is ported so far: the ``build_experiment(...).workon(fn)`` path and
the ``python -m metaopt_tpu_torch hunt`` CLI with subprocess trials, random
search or TPE (its EI launches on the device), the in-memory and file
ledgers, the demo MLP and closed-form objectives, and the demo Transformer
with its flash-attention kernels written in CUDA C++ for Hopper
(``csrc/``).
"""

__version__ = "0.1.0"

#: Lazy attribute table (PEP 562): the root import stays cheap and does not
#: load torch.
_LAZY = {
    "Space": ("metaopt_tpu_torch.space", "Space"),
    "Real": ("metaopt_tpu_torch.space", "Real"),
    "Integer": ("metaopt_tpu_torch.space", "Integer"),
    "Categorical": ("metaopt_tpu_torch.space", "Categorical"),
    "Fidelity": ("metaopt_tpu_torch.space", "Fidelity"),
    "Trial": ("metaopt_tpu_torch.ledger.trial", "Trial"),
    "build_experiment": ("metaopt_tpu_torch.client.api", "build_experiment"),
    "ExperimentClient": ("metaopt_tpu_torch.client.api", "ExperimentClient"),
}

__all__ = [*_LAZY, "__version__"]


def __getattr__(name):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
