"""Native components (port of ``metaopt_tpu/native/``): the ledgerstore engine.

``ledgerstore.cpp`` is the port's own copy of the reference's storage engine
(same record log, same on-disk format) behind
:class:`~metaopt_tpu_torch.ledger.native.NativeFileLedger`. The shared
library is compiled on first use with ``g++ -O2 -shared -fPIC -std=c++17``
into ``metaopt_tpu_torch/_build/``, keyed by a hash of the source
(:func:`metaopt_tpu_torch.utils.cuda_build.build_host`), and published by
one ``os.replace`` of a per-process temporary file, so any number of worker
processes may build it at once. A machine without ``g++`` gets
``load_ledgerstore() -> None`` and the pure-Python backends keep working.
The reference's own ``libledgerstore.so`` is never loaded. Nothing here
imports torch.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import Optional

from metaopt_tpu_torch.utils import cuda_build

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "ledgerstore.cpp"
_BUILD_LOCK = threading.Lock()
_lib = None
_load_failed = False
#: the loaded library's path (under ``metaopt_tpu_torch/_build/``)
lib_path: Optional[Path] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_p = ctypes.c_char_p
    lib.ls_open.restype = ctypes.c_void_p
    lib.ls_open.argtypes = [c_char_p]
    lib.ls_close.argtypes = [ctypes.c_void_p]
    lib.ls_put.restype = ctypes.c_int
    lib.ls_put.argtypes = [
        ctypes.c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_double,
    ]
    lib.ls_cas.restype = ctypes.c_int
    lib.ls_cas.argtypes = (
        [ctypes.c_void_p] + [c_char_p] * 6 + [ctypes.c_double]
    )
    # char* returns are void_p so we can free them (c_char_p auto-converts
    # and leaks the buffer)
    for fn in ("ls_reserve", "ls_get", "ls_fetch", "ls_fetch_since",
               "ls_release_stale"):
        getattr(lib, fn).restype = ctypes.c_void_p
    lib.ls_reserve.argtypes = [ctypes.c_void_p, c_char_p]
    lib.ls_get.argtypes = [ctypes.c_void_p, c_char_p]
    lib.ls_fetch.argtypes = [ctypes.c_void_p, c_char_p]
    lib.ls_fetch_since.argtypes = [
        ctypes.c_void_p, c_char_p, ctypes.c_ulonglong, ctypes.c_ulonglong,
    ]
    lib.ls_release_stale.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.ls_heartbeat.restype = ctypes.c_int
    lib.ls_heartbeat.argtypes = [ctypes.c_void_p, c_char_p, c_char_p]
    lib.ls_count.restype = ctypes.c_long
    lib.ls_count.argtypes = [ctypes.c_void_p, c_char_p]
    lib.ls_compact.restype = ctypes.c_long
    lib.ls_compact.argtypes = [ctypes.c_void_p]
    lib.ls_wipe.restype = ctypes.c_int
    lib.ls_wipe.argtypes = [ctypes.c_void_p]
    lib.ls_free.argtypes = [ctypes.c_void_p]
    return lib


def load_ledgerstore():
    """The bound CDLL, building it if needed; None when unavailable."""
    global _lib, _load_failed, lib_path
    if _lib is not None or _load_failed:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = cuda_build.build_host("ledgerstore", [SOURCE])
            _lib = _bind(ctypes.CDLL(str(path)))
            lib_path = path
        except Exception as e:  # no g++, a failed build, an unloadable file
            log.warning("ledgerstore unavailable: %s", e)
            _load_failed = True
    return _lib
