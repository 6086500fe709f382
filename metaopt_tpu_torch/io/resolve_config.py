"""Layered configuration resolution: defaults < env vars < YAML < argv.

Port of ``metaopt_tpu/io/resolve_config.py``. The precedence order and the
``METAOPT_TPU_`` environment names are the reference's. Also collects
experiment metadata (user, utc datetime, the full user command line) the
way the reference stamps experiments.

The framework config file is read as YAML (a superset of JSON) as the
reference reads it; where PyYAML is not installed, a ``.json`` file is
read with ``json`` and any other raises an error naming the missing
module.
"""

from __future__ import annotations

import copy
import datetime
import getpass
import os
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.io.converters import JSONConverter, YAMLConverter

DEFAULTS: Dict[str, Any] = {
    "name": None,
    "max_trials": 100,
    "pool_size": 1,
    "worker_trials": None,        # cap on trials run by THIS worker (None = unlimited)
    "algorithm": {"random": {"seed": None}},
    "ledger": {"type": "file", "path": None},  # path defaults to ~/.metaopt_tpu/<name>
    "executor": {"type": "subprocess", "n_chips": 1},
    "coordinator": {"host": "127.0.0.1", "port": 0},
    "heartbeat_s": 30.0,
    "working_dir": None,
}

ENV_VARS: Dict[str, str] = {
    "METAOPT_TPU_NAME": "name",
    "METAOPT_TPU_MAX_TRIALS": "max_trials",
    "METAOPT_TPU_POOL_SIZE": "pool_size",
    "METAOPT_TPU_LEDGER_TYPE": "ledger.type",
    "METAOPT_TPU_LEDGER_PATH": "ledger.path",
    "METAOPT_TPU_COORD_HOST": "coordinator.host",
    "METAOPT_TPU_COORD_PORT": "coordinator.port",
}

_INT_KEYS = {"max_trials", "pool_size", "worker_trials", "coordinator.port"}


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    node = cfg
    *parents, leaf = dotted.split(".")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = value


#: keys whose dict value REPLACES the lower layer instead of deep-merging —
#: an algorithm choice is atomic ({"asha": ...} must not union with the
#: default {"random": ...} into a two-key config)
_REPLACE_KEYS = {"algorithm"}


def _merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k in _REPLACE_KEYS and v is not None:
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        elif v is not None:
            out[k] = v
    return out


def fetch_metadata(user_args: Optional[List[str]] = None) -> Dict[str, Any]:
    """Experiment metadata stamped at creation, mirroring the reference."""
    return {
        "user": os.environ.get("METAOPT_TPU_USER") or getpass.getuser(),
        "datetime": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "user_args": list(user_args or []),
        "framework_version": _version(),
    }


def _version() -> str:
    from metaopt_tpu_torch import __version__

    return __version__


def load_config_file(path: str) -> Any:
    """The parsed framework config file (see the module docstring)."""
    if path.lower().endswith(".json"):
        try:
            import yaml  # noqa: F401
        except ImportError:
            return JSONConverter().parse(path)
    return YAMLConverter().parse(path)


def resolve_config(
    cmdargs: Optional[Dict[str, Any]] = None,
    config_path: Optional[str] = None,
    defaults: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Merge defaults < environment < yaml file < explicit command args.

    ``defaults`` replaces :data:`DEFAULTS` as the lowest layer."""
    cfg = copy.deepcopy(DEFAULTS if defaults is None else defaults)

    env_overlay: Dict[str, Any] = {}
    for var, dotted in ENV_VARS.items():
        if var in os.environ:
            raw: Any = os.environ[var]
            if dotted in _INT_KEYS:
                raw = int(raw)
            _set_path(env_overlay, dotted, raw)
    cfg = _merge(cfg, env_overlay)

    if config_path:
        file_cfg = load_config_file(config_path) or {}
        if not isinstance(file_cfg, dict):
            raise ValueError(f"config file {config_path!r} must contain a mapping")
        cfg = _merge(cfg, file_cfg)

    if cmdargs:
        cfg = _merge(cfg, {k: v for k, v in cmdargs.items() if v is not None})

    return cfg
