"""Experiment metadata stamped at creation.

Port of ``metaopt_tpu/io/resolve_config.py``, trimmed to
:func:`fetch_metadata`, the one piece ``Experiment.configure`` calls. The
layered config resolution (defaults < env < YAML < argv) and the
converters of ``io/converters.py`` come with the ``hunt`` CLI.
"""

from __future__ import annotations

import datetime
import getpass
import os
from typing import Any, Dict, List, Optional


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
