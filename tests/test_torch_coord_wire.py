"""The coordinator's wire and WAL against the reference's.

- The reference's own contracts restated against the port
  (``tests/unit/test_wal_close.py``, ``tests/unit/test_wire_v2.py``): the
  WAL's close publishes durability, the v2 codec round-trips, torn frames
  are rejected, a mixed v1/v2 WAL replays, cap negotiation and the UDS
  fast path.
- The bytes equal the reference's: for a seeded message set the port's
  ``encode_msg``, ``encode_request_v2`` and ``encode_reply_v2`` give the
  reference's bytes, a seeded record stream writes the reference's WAL
  bytes (v1 and v2), and each package's ``read_records`` reads the
  other's log, torn tail included.
"""

import json
import os
import random
import socket
import struct
import threading

import pytest

from metaopt_tpu_torch.coord import CoordLedgerClient
from metaopt_tpu_torch.coord import CoordServer as _CoordServer
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.coord import protocol as P
from metaopt_tpu_torch.coord.protocol import (
    HAVE_WIRE_V2, MAX_MSG_BYTES, WIRE_OPCODES, ProtocolError,
    TornFrameError, decode_body, decode_payload, encode_body, encode_msg,
    encode_reply_v2, encode_request_v2, payload_is_v2, recv_payload,
    reply_shard_miss, request_opcode, request_routing_key, send_payload)
from metaopt_tpu_torch.coord.wal import (WriteAheadLog, _frame_v1, _frame_v2,
                                   read_records)
from metaopt_tpu_torch.utils.hashing import stable_json

class CoordServer(_CoordServer):
    """The port's server with its hosted algorithms on the CPU."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


needs_v2 = pytest.mark.skipif(not HAVE_WIRE_V2,
                              reason="msgpack unavailable: wire v2 off")


def _fuzz_doc(rng, depth=0):
    """A random jsonable document covering every ``_canon`` fast-path
    type: str keys, unicode, bools, None, ints across widths, and floats
    including negative zero, subnormals, and non-finite values."""
    leaves = [
        lambda: rng.choice([None, True, False]),
        lambda: rng.randint(-2 ** 53, 2 ** 53),
        lambda: rng.choice([0, -1, 255, 2 ** 31, -2 ** 63 + 1]),
        lambda: rng.uniform(-1e6, 1e6),
        lambda: rng.choice([0.0, -0.0, 1e-310, 1e308, float("inf"),
                            float("-inf"), float("nan"), 0.1, -2.5]),
        lambda: "".join(rng.choice("abc é中\U0001f600\"\\\n\x00")
                        for _ in range(rng.randint(0, 12))),
    ]
    if depth < 3 and rng.random() < 0.6:
        if rng.random() < 0.5:
            return [_fuzz_doc(rng, depth + 1)
                    for _ in range(rng.randint(0, 4))]
        return {f"k{j}_{rng.randint(0, 9)}": _fuzz_doc(rng, depth + 1)
                for j in range(rng.randint(0, 4))}
    return rng.choice(leaves)()


@needs_v2
class TestCodecRoundtrip:
    def test_fuzzed_docs_roundtrip_identically_on_both_stacks(self):
        rng = random.Random(0xB2)
        for i in range(200):
            doc = _fuzz_doc(rng)
            msg = {"op": "update_trial", "args": {"doc": doc},
                   "req": f"r{i}"}
            v2 = encode_request_v2(msg, key=f"exp{i}")
            v1 = encode_msg(msg)
            got2, got1 = decode_payload(v2), decode_payload(v1)
            # NaN breaks ==; stable_json is the canonical comparator the
            # repo itself hashes with, so agreement there is the contract
            assert stable_json(got2) == stable_json(got1) == \
                stable_json(msg)

    def test_reply_roundtrip_ok_and_error(self):
        ok = {"ok": True, "result": {"trial": None, "counts": {"c": 3}}}
        assert decode_payload(encode_reply_v2(ok)) == ok
        err = {"ok": False, "error": "WrongShardError", "msg": "exp x"}
        raw = encode_reply_v2(err)
        assert decode_payload(raw) == err
        assert reply_shard_miss(raw) == "WrongShardError"
        mig = encode_reply_v2({"ok": False, "error": "Migrating",
                               "msg": ""})
        assert reply_shard_miss(mig) == "Migrating"
        assert reply_shard_miss(encode_reply_v2(ok)) is None

    def test_routing_header_reads_without_body_decode(self):
        msg = {"op": "reserve", "args": {"experiment": "e1"}, "req": "r"}
        raw = encode_request_v2(msg, key="e1")
        assert payload_is_v2(raw)
        assert request_routing_key(raw) == "e1"
        assert request_opcode(raw) == WIRE_OPCODES["reserve"]
        # header is fixed-offset: the key must sit right after it
        assert raw[6:6 + len(b"e1")] == b"e1"
        assert request_routing_key(encode_request_v2(msg, key="")) is None
        assert request_routing_key(encode_msg(msg)) is None

    def test_unknown_op_gets_reserved_opcode_zero(self):
        raw = encode_request_v2({"op": "not_a_real_op", "args": {}}, "k")
        assert request_opcode(raw) == 0

    def test_oversize_int_falls_back_per_frame(self):
        # >64-bit ints are unencodable in msgpack: encode_body must
        # refuse (callers then ship that one frame as JSON)
        with pytest.raises(ProtocolError):
            encode_body({"n": 2 ** 70})
        line = _frame_v2({"op": "x", "n": 2 ** 70})
        assert line.endswith(b"\n") and line[:2] != b"W2"  # v1 fallback
        recs, torn = _read_blob(line)
        assert torn == 0 and recs[0]["n"] == 2 ** 70

    def test_json_frames_never_collide_with_magic(self):
        # JSON docs start with '{' (0x7b); v2 starts 0xB2 — the
        # per-frame detector relies on this being unambiguous
        for msg in ({"op": "ping"}, {"ok": True, "result": []}):
            assert not payload_is_v2(encode_msg(msg))


def _read_blob(blob):
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "w.wal")
        with open(p, "wb") as f:
            f.write(blob)
        return read_records(p)


class TestFrameRejection:
    def _serve_bytes(self, blob):
        """Feed raw bytes to a recv_payload caller, then close."""
        a, b = socket.socketpair()
        try:
            a.sendall(blob)
            a.close()
            return recv_payload(b)
        finally:
            b.close()

    def test_clean_eof_is_none_torn_header_raises(self):
        assert self._serve_bytes(b"") is None
        with pytest.raises(TornFrameError):
            self._serve_bytes(b"\x00\x00")  # 2 of 4 header bytes

    @pytest.mark.parametrize("codec", ["v1", "v2"])
    def test_every_truncation_cut_raises_torn(self, codec):
        msg = {"op": "heartbeat", "args": {"experiment": "e"}, "req": "r"}
        if codec == "v2":
            if not HAVE_WIRE_V2:
                pytest.skip("msgpack unavailable")
            payload = encode_request_v2(msg, "e")
        else:
            payload = encode_msg(msg)
        frame = struct.pack(">I", len(payload)) + payload
        for cut in range(1, len(frame)):
            with pytest.raises(TornFrameError):
                self._serve_bytes(frame[:cut])

    def test_oversize_length_header_rejected(self):
        with pytest.raises(ProtocolError):
            self._serve_bytes(struct.pack(">I", MAX_MSG_BYTES + 1) + b"x")

    @needs_v2
    def test_garbage_v2_body_is_protocol_error_not_torn(self):
        # full frame arrived, body doesn't parse: corruption, not a cut
        bad = bytes([P.WIRE_MAGIC, 2, 1, 5, 0, 0]) + b"\xc1\xc1\xc1"
        with pytest.raises(ProtocolError):
            decode_payload(bad)
        with pytest.raises(TornFrameError):
            decode_body(encode_body({"a": [1, 2, 3]})[:-2])


@needs_v2
class TestWalMixedReplay:
    def _recs(self, n=40, seed=7):
        rng = random.Random(seed)
        return [{"seq": i, "op": "put_trial",
                 "trial": {"id": f"t{i}", "params": {"x": rng.random()},
                           "doc": _fuzz_doc(rng)}}
                for i in range(1, n + 1)]

    def test_mixed_tail_replays_bit_identical_to_pure_v1(self):
        recs = self._recs()
        rng = random.Random(3)
        mixed = b"".join(
            (_frame_v2 if rng.random() < 0.5 else _frame_v1)(r)
            for r in recs)
        pure = b"".join(_frame_v1(r) for r in recs)
        got_m, torn_m = _read_blob(mixed)
        got_p, torn_p = _read_blob(pure)
        assert torn_m == torn_p == 0
        assert stable_json(got_m) == stable_json(got_p)

    @pytest.mark.parametrize("tail_codec", ["v1", "v2"])
    def test_torn_tail_truncated_at_last_good_record(self, tail_codec):
        recs = self._recs(6)
        frame = _frame_v1 if tail_codec == "v1" else _frame_v2
        blob = b"".join(_frame_v2(r) for r in recs[:-1])
        blob += frame(recs[-1])[:-3]  # torn mid-record
        got, torn = _read_blob(blob)
        assert torn > 0
        assert [r["seq"] for r in got] == [r["seq"] for r in recs[:-1]]

    def test_crc_flip_stops_replay_at_corruption(self):
        recs = self._recs(4)
        frames = [_frame_v2(r) for r in recs]
        # flip one body byte of record 3 (crc now mismatches)
        f = bytearray(frames[2])
        f[-1] ^= 0xFF
        frames[2] = bytes(f)
        got, torn = _read_blob(b"".join(frames))
        assert [r["seq"] for r in got] == [1, 2]
        assert torn > 0

    def test_live_wal_writes_v2_and_replays_after_reopen(self, tmp_path):
        p = str(tmp_path / "live.wal")
        wal = WriteAheadLog(p).open()
        for i in range(5):
            seq = wal.append({"op": "race", "i": i})
            wal.sync(seq)
        wal.close()
        with open(p, "rb") as f:
            assert f.read(2) == b"W2"
        got, torn = read_records(p)
        assert torn == 0 and [r["i"] for r in got] == list(range(5))

    def test_compaction_migrates_mixed_log_to_v2(self, tmp_path):
        p = str(tmp_path / "mig.wal")
        recs = self._recs(8)
        with open(p, "wb") as f:  # simulated pre-upgrade log: pure v1
            for r in recs:
                f.write(_frame_v1(r))
        wal = WriteAheadLog(p).open(next_seq=9)
        wal.compact(upto_seq=0)  # rewrite retained tail in-place
        wal.close()
        got, torn = read_records(p)
        assert torn == 0
        assert stable_json(got) == stable_json(recs)
        with open(p, "rb") as f:
            assert f.read(2) == b"W2"


class TestNegotiationAndUpgrade:
    def _old_server(self):
        """A pre-v2 coordinator: same ops, but its ping never advertises
        the ``wire_v2`` cap (and it would choke on binary frames)."""
        from metaopt_tpu_torch.coord import server as server_mod

        class OldServer(CoordServer):
            def _dispatch(self, op, a):
                r = super()._dispatch(op, a)
                if op == "ping":
                    r["caps"] = [c for c in server_mod.CAPS
                                 if c != "wire_v2"]
                    r.pop("uds_path", None)
                return r

            def _handle(self, msg, wire="v1"):
                assert wire == "v1", "old server saw a binary frame"
                return super()._handle(msg, wire)

        return OldServer()

    @needs_v2
    def test_new_client_old_server_stays_on_json(self):
        with self._old_server() as s:
            host, port = s.address
            c = CoordLedgerClient(host=host, port=port, wire="auto")
            c.ping()
            c.create_experiment({"name": "e", "max_trials": 1})
            assert c._wire_for((host, port)) == "v1"
            assert c.count("e", None) == 0

    @needs_v2
    def test_old_client_new_server_stays_on_json(self):
        with CoordServer() as s:
            host, port = s.address
            c = CoordLedgerClient(host=host, port=port, wire="v1")
            c.ping()
            c.create_experiment({"name": "e", "max_trials": 1})
            # pinned clients never upgrade, even though the cap is there
            assert c._wire_for((host, port)) == "v1"
            assert "wire_v2" in s._handle({"op": "ping", "args": {}}
                                          )["result"]["caps"]

    @needs_v2
    def test_auto_client_new_server_upgrades_to_v2(self):
        with CoordServer() as s:
            host, port = s.address
            c = CoordLedgerClient(host=host, port=port, wire="auto")
            c.ping()
            assert c._wire_for((host, port)) == "v2"
            c.create_experiment({"name": "e", "max_trials": 2})
            sent0 = c.bytes_sent
            assert c.count("e", None) == 0  # a binary exchange
            assert c.bytes_sent > sent0

    @needs_v2
    def test_three_strikes_pin_v1_and_survive_repings(self):
        # a v2 send that keeps dying after the bytes left (old JSON
        # router relaying to a new shard) must fall back permanently
        with CoordServer() as s:
            host, port = s.address
            addr = (host, port)
            c = CoordLedgerClient(host=host, port=port, wire="auto")
            c.ping()
            assert c._wire_for(addr) == "v2"
            for _ in range(3):
                c._wire_strike(addr)
            assert c._wire_for(addr) == "v1"
            c.ping()  # cap still advertised, but the block is sticky
            assert c._wire_for(addr) == "v1"

    def test_wire_kwarg_validated(self):
        with pytest.raises(ValueError):
            CoordLedgerClient(host="h", port=1, wire="v3")


class TestUdsFastPath:
    def test_client_prefers_advertised_socket(self, tmp_path):
        uds = str(tmp_path / "coord.sock")
        with CoordServer(uds_path=uds) as s:
            host, port = s.address
            assert os.path.exists(uds)
            c = CoordLedgerClient(host=host, port=port)
            c.ping()
            assert c._fast_addr((host, port)) == ("unix", uds)
            c.create_experiment({"name": "u", "max_trials": 1})
            assert c.count("u", None) == 0

    def test_vanished_socket_falls_back_to_tcp(self, tmp_path):
        uds = str(tmp_path / "coord.sock")
        with CoordServer(uds_path=uds) as s:
            host, port = s.address
            c = CoordLedgerClient(host=host, port=port)
            c.ping()
            os.unlink(uds)  # pod restarted without the hostPath mount
            # cached mapping still points at the dead socket: the next
            # call must shed it and complete over TCP
            c.create_experiment({"name": "u2", "max_trials": 1})
            assert c.count("u2", None) == 0
            assert c._fast_addr((host, port)) == (host, port)

    def test_concurrent_mixed_wire_clients_agree(self, tmp_path):
        """One JSON, one binary, one UDS client hammer one counter —
        every codec path lands on the same ledger."""
        uds = str(tmp_path / "coord.sock")
        with CoordServer(uds_path=uds) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port, wire="v1")
            c0.create_experiment({"name": "m", "max_trials": 64,
                                  "pool_size": 64})
            clients = [CoordLedgerClient(host=host, port=port, wire="v1"),
                       CoordLedgerClient(host=host, port=port),
                       CoordLedgerClient(host=host, port=port)]
            clients[2].ping()  # adopts the UDS path (codec-independent)
            errs = []

            def put(c, i):
                try:
                    for n in range(8):
                        c.register(Trial(params={"x": float(i * 8 + n)},
                                         experiment="m"))
                except BaseException as e:  # pragma: no cover
                    errs.append(e)

            ts = [threading.Thread(target=put, args=(c, i))
                  for i, c in enumerate(clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not errs
            assert c0.count("m", None) == 24


# -- WriteAheadLog.close() (tests/unit/test_wal_close.py) --------------

def test_close_flushes_pending_and_publishes_durable(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path).open()
    seqs = [wal.append({"op": "x", "i": i}) for i in range(5)]
    # no sync() before close: the records are only buffered
    assert wal.durable_seq == 0
    wal.close()
    assert wal.durable_seq == wal.appended_seq == seqs[-1]
    records, torn = read_records(path)
    assert torn == 0
    assert [r["i"] for r in records] == list(range(5))
    assert [r["seq"] for r in records] == seqs


def test_sync_waiter_released_by_close(tmp_path):
    """A latecomer blocked in sync() while close() flushes must observe
    the _durable advance close() publishes (under the cv) and return."""
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path).open()
    seq = wal.append({"op": "x"})

    # make the latecomer wait: mark a sync in progress, then run close()
    # on another thread — close() waits for _syncing to clear, publishes
    # the flush under the cv, and notifies
    with wal._cv:
        wal._syncing = True

    released = threading.Event()

    def waiter():
        wal.sync(seq)
        released.set()

    t = threading.Thread(target=waiter)
    t.start()
    closer = threading.Thread(target=wal.close)
    closer.start()
    # hand the leader role back so close() can proceed
    with wal._cv:
        wal._syncing = False
        wal._cv.notify_all()
    closer.join(timeout=5)
    assert released.wait(timeout=5), "sync() waiter stalled across close()"
    t.join(timeout=5)
    assert wal.durable_seq >= seq


def test_close_idempotent_and_append_noop_after(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path).open()
    wal.append({"op": "x"})
    wal.close()
    wal.close()  # second close must not raise or regress _durable
    assert wal.append({"op": "y"}) == 0  # no file: append is a no-op
    records, _ = read_records(path)
    assert len(records) == 1


# -- bytes on the wire and on disk equal the reference's -----------------

from metaopt_tpu.coord import protocol as R  # noqa: E402
from metaopt_tpu.coord import wal as RW  # noqa: E402
from metaopt_tpu_torch.coord import wal as PW  # noqa: E402


def _seeded_messages(seed=7, n=60):
    """Requests and replies shaped like the coordinator's traffic: every
    op of the wire table with fuzzed args, ok and error replies."""
    rng = random.Random(seed)
    ops = sorted(WIRE_OPCODES) + ["not_an_op"]
    msgs = []
    for i in range(n):
        op = ops[i % len(ops)]
        args = {"experiment": f"exp-{rng.randint(0, 9)}", "payload": _fuzz_doc(rng)}
        msgs.append(({"op": op, "args": args, "req": f"{rng.getrandbits(64):016x}"},
                     args["experiment"]))
        msgs.append(({"ok": True, "result": _fuzz_doc(rng)}, None))
        msgs.append(({"ok": False, "error": rng.choice(["KeyError", "Migrating",
                                                        "WrongShardError"]),
                      "msg": "m" * rng.randint(0, 9)}, None))
    return msgs


def test_json_frames_equal_the_reference_bytes():
    for msg, _key in _seeded_messages():
        assert encode_msg(msg) == R.encode_msg(msg)


@needs_v2
def test_v2_frames_equal_the_reference_bytes():
    for msg, key in _seeded_messages(seed=11):
        if "op" in msg:
            got, want = encode_request_v2(msg, key or ""), R.encode_request_v2(msg, key or "")
        else:
            got, want = encode_reply_v2(msg), R.encode_reply_v2(msg)
        assert got == want
        assert decode_payload(want).keys() == R.decode_payload(got).keys()


def _seeded_records(seed=3, n=80):
    rng = random.Random(seed)
    recs = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            recs.append({"op": "put_trial", "trial": {
                "id": f"{rng.getrandbits(96):024x}", "experiment": "e",
                "params": {"x": rng.uniform(-5, 5)}, "status": "completed",
                "results": [{"name": "objective", "type": "objective",
                             "value": rng.uniform(0, 9)}]}})
        elif kind == 1:
            recs.append({"op": "reply", "req": f"{i:08x}", "exp": "e",
                         "reply": {"ok": True, "result": _fuzz_doc(rng)}})
        elif kind == 2:
            recs.append({"op": "set_signal", "experiment": "e",
                         "trial_id": f"{i}", "signal": "stop"})
        else:
            recs.append({"op": "create_experiment",
                         "config": {"name": f"e{i}", "max_trials": 2 ** 70}})
    return recs


def _write_log(mod, path, recs, binary):
    wal = mod.WriteAheadLog(str(path), fsync=False, binary=binary).open()
    for r in recs:
        wal.append(dict(r))
    wal.sync(wal.appended_seq)
    wal.close()
    return path.read_bytes()


@pytest.mark.parametrize("binary", [False, pytest.param(True, marks=needs_v2)])
def test_wal_bytes_equal_the_reference_and_each_reads_the_other(tmp_path, binary):
    recs = _seeded_records()
    mine = _write_log(PW, tmp_path / "port.wal", recs, binary)
    theirs = _write_log(RW, tmp_path / "ref.wal", recs, binary)
    assert mine == theirs
    got, torn = PW.read_records(str(tmp_path / "ref.wal"))
    want, _ = RW.read_records(str(tmp_path / "port.wal"))
    assert torn == 0 and json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [r["seq"] for r in got] == list(range(1, len(recs) + 1))


@pytest.mark.parametrize("binary", [False, pytest.param(True, marks=needs_v2)])
@pytest.mark.parametrize("reader", ["port", "reference"])
def test_each_package_truncates_the_others_torn_tail(tmp_path, binary, reader):
    recs = _seeded_records(seed=5, n=20)
    writer, read = (RW, PW.read_records) if reader == "port" else (PW, RW.read_records)
    data = _write_log(writer, tmp_path / "w.wal", recs, binary)
    whole, _ = read(str(tmp_path / "w.wal"), truncate_torn=False)
    cut = len(data) - 7                     # mid-record: the last one is torn
    (tmp_path / "t.wal").write_bytes(data[:cut])
    got, torn = read(str(tmp_path / "t.wal"))
    assert torn > 0 and len(got) == len(recs) - 1
    assert json.dumps(got, sort_keys=True) == json.dumps(whole[:-1], sort_keys=True)
    # physically truncated at the last good record, as the reference does
    assert (tmp_path / "t.wal").stat().st_size == cut - torn
