"""Deterministic hashing of trial points for identity and dedup.

The reference relies on MongoDB unique indexes over trial params for identity
(ref: src/metaopt/core/io/database/mongodb.py). Without a DB, identity is a
content hash of the canonical JSON of the params mapping.
"""

from __future__ import annotations

import hashlib
import json
import math
from collections.abc import Mapping
from typing import Any


def jsonable(value: Any) -> Any:
    """numpy arrays/scalars → plain lists/scalars (for JSON persistence).

    Shaped dimensions sample as ndarrays; trial params must round-trip
    through the JSON ledgers, so arrays become nested lists at the Trial
    boundary (containment/transforms accept lists transparently).
    """
    # exact-type fast path: plain Python scalars/containers (the common
    # case on the trial-registration hot path); numpy types fall through
    t = type(value)
    if t is str or t is float or t is int or t is bool or value is None:
        return value
    if t is list:
        return [jsonable(v) for v in value]
    if t is dict:
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (str, bytes)):
        return value
    if hasattr(value, "tolist"):  # ndarray and numpy scalars alike
        return value.tolist()
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): jsonable(v) for k, v in value.items()}
    return value


def _canon(value: Any) -> Any:
    """Canonicalize values so that e.g. numpy scalars and Python scalars agree."""
    # exact-type fast path for the dominant leaves (plain Python scalars);
    # numpy scalars are NOT exact builtins, so they fall through to the
    # normalization below and canonicalize identically
    t = type(value)
    if t is float:
        if math.isnan(value):
            return "__nan__"
        return repr(value + 0.0)
    if t is str or t is int or t is bool or value is None:
        return value
    if t is list or t is tuple:
        return [_canon(v) for v in value]
    if t is dict:
        return {str(k): _canon(v) for k, v in value.items()}
    if not isinstance(value, (str, bytes)):
        if hasattr(value, "ndim") and getattr(value, "ndim", 0):
            return [_canon(v) for v in value.tolist()]  # ndarray → nested list
        if hasattr(value, "item"):
            try:
                value = value.item()
            except Exception:
                pass
    if isinstance(value, float):
        if math.isnan(value):
            return "__nan__"
        # collapse -0.0 / 0.0 and represent with repr for full precision
        return repr(value + 0.0)
    if isinstance(value, (list, tuple)):
        return [_canon(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): _canon(v) for k, v in value.items()}
    return value


def stable_json(obj: Any) -> str:
    """Canonical JSON: sorted keys, canonicalized scalars."""
    return json.dumps(_canon(obj), sort_keys=True, separators=(",", ":"))


def point_hash(params: Mapping[str, Any], *, ignore: tuple[str, ...] = ()) -> str:
    """Hash a params mapping; ``ignore`` drops axes (e.g. the fidelity dim,

    so that an ASHA promotion at a higher budget hashes to the same trial
    lineage as its parent point).
    """
    if ignore:
        params = {k: v for k, v in params.items() if k not in ignore}
    return hashlib.sha256(stable_json(params).encode()).hexdigest()[:24]
