"""One coordinator per pod, agreed over the process group (port of
``metaopt_tpu/coord/pod.py``).

The rank 0 process starts the :class:`~metaopt_tpu_torch.coord.server.
CoordServer`, and its address is agreed across the ranks with one
broadcast of a fixed 64-byte frame over the ranks' ``torch.distributed``
group — no out-of-band configuration. Workers elsewhere can still be
pointed at ``coord://host:port`` by hand.
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Optional, Tuple

from metaopt_tpu_torch.coord.server import CoordServer

log = logging.getLogger(__name__)

_ADDR_BYTES = 64  # fixed-size frame for the broadcast: 62B host + 2B port


def _encode_addr(host: str, port: int):
    import numpy as np

    raw = host.encode("utf-8")[: _ADDR_BYTES - 2]
    buf = np.zeros(_ADDR_BYTES, dtype=np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    buf[-2] = port >> 8
    buf[-1] = port & 0xFF
    return buf


def _decode_addr(buf) -> Tuple[str, int]:
    import numpy as np

    arr = np.asarray(buf, dtype=np.uint8)
    host = bytes(arr[:-2]).rstrip(b"\x00").decode("utf-8")
    return host, (int(arr[-2]) << 8) | int(arr[-1])


def _local_host_ip() -> str:
    """The address other pod hosts can reach us on (best effort)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packet sent; routes only
            return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())


def _pod_host() -> Tuple[str, str]:
    """(address the other ranks dial, address the server binds). Ranks that
    :mod:`~metaopt_tpu_torch.parallel.launch` started share this host:
    loopback. Otherwise the routed interface's address, as the reference
    picks it."""
    from metaopt_tpu_torch.parallel import launch

    if launch.in_rank():
        return "127.0.0.1", "127.0.0.1"
    return _local_host_ip(), "0.0.0.0"


def start_pod_coordinator(
    snapshot_path: Optional[str] = None,
    stale_timeout_s: Optional[float] = 60.0,
    event_log_path: Optional[str] = None,
    port: int = 0,
    device: Any = None,
) -> Tuple[str, int, Optional[CoordServer]]:
    """Start (on rank 0) or discover (elsewhere) the pod's coordinator.

    Returns ``(host, port, server)`` — ``server`` is non-None only on the
    hosting rank, which must keep it alive and ``stop()`` it at exit. One
    process (no process group, or a group of one) gets a local server, so
    the same call works in tests, on one GPU and on several. ``device`` is
    the server's (``cuda`` unless the caller says otherwise).
    """
    import torch
    import torch.distributed as dist

    kw = dict(port=port, snapshot_path=snapshot_path, stale_timeout_s=stale_timeout_s,
              event_log_path=event_log_path, device=device)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        server = CoordServer(host="127.0.0.1", **kw).start()
        h, p = server.address
        return h, p, server

    from metaopt_tpu_torch.parallel.collectives import broadcast_

    server: Optional[CoordServer] = None
    if dist.get_rank() == 0:
        host, bind = _pod_host()
        server = CoordServer(host=bind, **kw).start()
        addr = _encode_addr(host, server.address[1])
    else:
        addr = _encode_addr("", 0)
    frame = torch.from_numpy(addr.astype("int32"))
    if dist.get_backend() == "nccl":
        frame = frame.cuda()
    broadcast_(frame, 0)
    host, p = _decode_addr(frame.cpu().numpy().astype("uint8"))
    log.info("pod coordinator at coord://%s:%d (rank %d/%d)", host, p,
             dist.get_rank(), dist.get_world_size())
    return host, p, server
