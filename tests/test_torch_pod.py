"""The port's pod coordinator against the JAX package's, on CPU ranks.

Restates ``tests/functional/test_pod.py``'s ``test_pod_coordinator``: one
process (no process group: a local server) and two ranks (rank 0 hosts the
``CoordServer``, its address broadcast to the other rank as the reference's
64-byte frame) run ``workon`` against the agreed coordinator; no trial
runs on two ranks and the experiment completes. The address frame is the
reference's, byte for byte.
"""

import numpy as np
import pytest

import torch_mesh_legs as legs
from metaopt_tpu.coord import pod as jpod
from metaopt_tpu_torch.coord import pod
from metaopt_tpu_torch.parallel.launch import RankPool


@pytest.mark.parametrize("host,port", [("127.0.0.1", 8765), ("10.1.2.3", 1), ("h" * 70, 65535)])
def test_address_frame_is_the_references(host, port):
    mine = pod._encode_addr(host, port)
    np.testing.assert_array_equal(mine, jpod._encode_addr(host, port))
    assert pod._decode_addr(mine) == jpod._decode_addr(mine) == (host[:62], port)


def test_one_process_gets_a_local_server():
    got = legs.pod_workon("pod-solo", 6)
    assert got["server"] and got["host"] == "127.0.0.1"
    assert got["completed"] >= 6 and got["total_done"] >= 6
    assert len(got["events"]) == len(set(got["events"]))


def test_two_ranks_agree_on_one_coordinator():
    with RankPool(["cpu"] * 2, timeout_s=90) as pool:
        got = pool.run(legs.pod_workon, "pod-pair", 12)
    assert [g["server"] for g in got] == [True, False]
    assert len({(g["host"], g["port"]) for g in got}) == 1
    executed = [t for g in got for t in g["events"]]
    assert len(executed) == len(set(executed)), "a trial ran on two ranks"
    assert sum(g["completed"] for g in got) >= 12
    assert all(g["total_done"] >= 12 for g in got)


class _RouteOnly:
    """A UDP socket that records the route lookup and sends nothing."""

    dialed = []

    def __init__(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def connect(self, addr):
        self.dialed.append(addr)

    def getsockname(self):
        return ("10.9.8.7", 40000)


def test_the_pod_host_is_the_references_outside_launched_ranks(monkeypatch):
    import socket

    from metaopt_tpu_torch.parallel import launch

    monkeypatch.setattr(socket, "socket", _RouteOnly)
    monkeypatch.setattr(launch, "_WORLD", None)
    assert pod._local_host_ip() == jpod._local_host_ip() == "10.9.8.7"
    assert _RouteOnly.dialed[0] == _RouteOnly.dialed[1]
    assert pod._pod_host() == ("10.9.8.7", "0.0.0.0")
    monkeypatch.setattr(launch, "_WORLD", {"rank": 0})
    assert pod._pod_host() == ("127.0.0.1", "127.0.0.1")
