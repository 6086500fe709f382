"""Wire framing for the coordinator channel (port of
``metaopt_tpu/coord/protocol.py``; the bytes equal the reference's).

One message = 4-byte big-endian length + UTF-8 JSON. Requests are
``{"op": str, "args": dict}``; responses ``{"ok": true, "result": ...}`` or
``{"ok": false, "error": <exception class name>, "msg": str}``. JSON over a
socket (not pickle) keeps the channel language-neutral and injection-safe;
trial documents already round-trip through dicts for the file ledger, so the
same ``to_dict``/``from_dict`` pair is the marshalling layer here.

The ``produce`` op's reply is ``{"registered": int, "algo_done": bool,
"coalesced": int}``: the server may group-commit concurrent produce requests
into one combined suggestion cycle (``CoordServer(produce_coalesce_ms=…)``),
in which case ``registered`` is the combined cycle's total and ``coalesced``
the number of requests it served — clients must treat ``registered`` as a
progress signal, not as "trials registered on my behalf alone".

The ``worker_cycle`` op fuses one whole worker trial cycle server-side
(stale sweep → produce → reserve → counts) into a single round-trip; a
server advertises it (and the other optional ops) via ``caps`` in the
``ping`` reply so clients can pick the fast path up front, and clients
additionally degrade per-op on an ``unknown op`` error for rolling
upgrades (see ``CoordLedgerClient.worker_cycle``). The produce leg of a
hosted cycle is answered from the algorithm's speculative suggest-ahead
pool when one is banked (``CoordServer(suggest_prefetch_depth=…)`` sets
how many pools the hosted tpe/gp_bo/cmaes instances keep prepared; the
coalescer re-arms the pool off the reply path after every cycle), so the
round-trip cost is the ledger mutation, not the suggestion kernel.

A reply may be served as preencoded bytes (:func:`send_payload`) when the
server's per-commit reply cache hits — the wire format is identical, the
JSON encode is just paid once per ledger mutation instead of once per
observer.

**Wire format v2 (binary)**: the same 4-byte length framing may carry a
binary payload instead of JSON. A v2 payload starts with the magic byte
``0xB2`` — a JSON payload always starts with ``{`` (0x7b) — so every
receiver detects the codec per frame with no prior negotiation state, and
a server always answers in the codec of the request (per-direction
fallback: an old client never sees binary, a new client against an old
server falls back after the ping probe). Layout::

    request  = B2 02 01 <opcode u8> <keylen u16 BE> <key bytes> <body>
    reply    = B2 02 02 <status u8> <errcode u8> <00> <body>

The request header's ``opcode`` (see :data:`WIRE_OPCODES`; 0 = not in the
table) and routing ``key`` (the experiment name, possibly empty) are a
fixed-offset copy of what the body carries, so the shard router routes a
frame without decoding its body (:func:`request_routing_key`). The reply
header's ``status`` (0 ok / 1 error) and ``errcode``
(:data:`ERR_WRONG_SHARD` / :data:`ERR_MIGRATING` / 0 other) let the
router detect a routing miss from two header bytes instead of sniffing
the payload text (:func:`reply_shard_miss`). The body is the full message
dict as msgpack (:func:`encode_body`) — C-accelerated both ways, 2-5x
faster than ``json`` on the worker-cycle message shapes and smaller on
the wire — and round-trips every JSON-able document exactly; the header
fields are routing hints, never the source of truth. When msgpack is not
installed the v2 codec is unavailable and nothing advertises or requests
it — every peer combination degrades to JSON (``HAVE_WIRE_V2``). A frame
msgpack cannot encode (e.g. an int beyond 64 bits) falls back to JSON for
that one frame; receivers auto-detect per frame, so mixed streams are
legal by construction.

**Durability semantics** (WAL-enabled servers — see
:mod:`metaopt_tpu_torch.coord.wal`): once the reply to a mutating op (or to
``worker_cycle``/``produce``) is on the wire, the mutation AND its
request-id reply-cache entry are fsynced — a client that received an ack
can rely on the write surviving a coordinator kill -9, and a retry that
straddles the crash is answered from the journaled reply cache with the
original reply (exactly-once across restarts). The ``ping`` reply carries
``incarnation`` (a per-process-start id) and ``durable`` (whether a WAL is
active): a client that reconnects and observes a changed incarnation knows
it crossed a restart, not just a dropped connection, and runs session
resumption (re-learn caps, re-assert held reservations via heartbeats).
Wire framing is unchanged — both fields are ignored by older clients.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional

_HDR = struct.Struct(">I")
MAX_MSG_BYTES = 64 * 1024 * 1024  # a fetch of ~100k trial docs fits well under

#: Durability-contract registry, enforced statically by ``lint``
#: (metaopt_tpu_torch/analysis/durability.py). Ops listed here mutate ledger or
#: signal state and their ``_dispatch`` branch MUST reach a journal point
#: (a sharded-ledger mutator call or a direct ``wal.append``) before the
#: reply is enqueued; all three sets must stay subsets of the server's
#: ``_DURABLE_OPS`` so the reply actually waits on the fsync barrier.
#: Adding a mutating op without declaring it here fails the lint gate.
JOURNALED_OPS = frozenset({
    "create_experiment", "update_experiment", "delete_experiment",
    "register", "reserve", "update_trial", "release_stale", "set_signal",
})
#: ops journaled via their cached reply record: the journaled reply
#: embeds the resulting docs and doubles as their redo (see
#: ``CoordServer._journal_reply`` / ``_apply_wal_record``)
REPLY_JOURNALED_OPS = frozenset({"worker_cycle"})
#: ops that mutate only through nested ledger calls, each of which
#: journals itself inside the sharded proxy
NESTED_JOURNALED_OPS = frozenset({"produce"})
#
# Deliberately absent: the hand-off admin plane (``handoff_prepare`` /
# ``handoff_apply`` / ``handoff_abort`` / ``shard_map_update``). Those ops
# are handled in ``CoordServer._handle`` (not ``_dispatch``), journal
# inside their own handlers, and are idempotent rather than reply-cached —
# declaring them in JOURNALED_OPS would make MTD001 look for a dispatch
# branch that intentionally does not exist. They ARE members of the
# server's ``_DURABLE_OPS`` (a strict superset of these registries), so
# their replies still wait on the fsync barrier.

#: Ordered-step durable protocols, enforced statically by MTP003
#: (metaopt_tpu_torch/analysis/crashcheck.py). Each entry names a function and
#: the persistence-order steps every execution path through it must
#: respect: a later step may never run on a path where an earlier
#: non-optional step has not run (that is a reorder/skip), while stopping
#: after any PREFIX of the steps is legal — each step is a crash barrier
#: and recovery handles every prefix (that is the whole point of the
#: ordering). Step vocabulary: ``publish:<suffix>`` = an atomic rename
#: whose source is a tmp file matching <suffix>; ``wal.append:<op>`` = a
#: WAL append of a record with that ``op``; ``wal.sync`` = a group-commit
#: fsync; ``call:<name>`` = a call whose dotted tail is <name>.
#: ``optional`` lists step indices that may be skipped (branch-dependent
#: steps); the ORDER of the remaining steps is still enforced. Kept as a
#: plain literal so the checker reads it via ast.literal_eval without
#: importing this module (same doctrine as JOURNALED_OPS above).
DURABLE_SEQUENCES = {
    # evict: capture file durable -> journal record durable -> drop state.
    # The drop is optional in code (disk-backed inners keep their docs);
    # what MTP003 pins is that it can never precede the journaled record.
    "evict": {
        "function": "CoordServer._evict_fenced",
        "steps": ["publish:.tmp", "wal.append:evict", "wal.sync",
                  "call:delete_experiment"],
        "optional": [3],
    },
    # archive seal: every referenced segment file durable -> manifest
    # commit -> GC of unreferenced files. Seal is optional (a snapshot
    # with no new segments commits directly); GC strictly last — until
    # the manifest is durable the old one may still need the old files.
    "archive_seal": {
        "function": "CoordServer._snapshot_v2_locked",
        "steps": ["call:_persist_segment", "call:_snapshot_commit",
                  "call:_gc_segments"],
        "optional": [0],
    },
    # snapshot commit: manifest published crash-atomically BEFORE the WAL
    # is compacted — compaction drops records the manifest now carries,
    # so the reverse order is acked-write loss on the next crash.
    "snapshot_commit": {
        "function": "CoordServer._snapshot_commit",
        "steps": ["publish:.tmp", "call:compact"],
        "optional": [],
    },
}


class ProtocolError(RuntimeError):
    pass


class TornFrameError(ProtocolError):
    """The peer vanished mid-frame (or sent a truncated binary body).

    Distinct from a clean close (``recv_* -> None``): a torn frame means
    bytes were lost in flight, so retry logic must treat the exchange as
    indeterminate (reconnect + replay by request id), and the router must
    drop the relayed connection rather than report EOF upstream.
    """


def encode_msg(msg: Dict[str, Any]) -> bytes:
    """One message as wire payload bytes (sans length header)."""
    payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_MSG_BYTES:
        raise ProtocolError(f"message too large: {len(payload)} bytes")
    return payload


def send_payload(sock: socket.socket, payload: bytes) -> None:
    """Send pre-encoded payload bytes — the preserialized-reply fast path."""
    if len(payload) > MAX_MSG_BYTES:
        raise ProtocolError(f"message too large: {len(payload)} bytes")
    sock.sendall(_HDR.pack(len(payload)) + payload)


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> None:
    send_payload(sock, encode_msg(msg))


def _recv_exact(sock: socket.socket, n: int,
                what: str = "frame") -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf and what == "header":
                return None  # clean close between frames
            raise TornFrameError(
                f"peer closed mid-{what}: got {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def recv_payload(sock: socket.socket) -> Optional[bytes]:
    """Read one framed message's raw payload bytes; None on clean EOF
    before a header, :class:`TornFrameError` on a mid-frame disconnect
    (including a torn length header — a partial header used to be
    indistinguishable from a clean close). The shard router relays replies
    with this — a frame forwarded verbatim needs no decode+re-encode
    round-trip."""
    hdr = _recv_exact(sock, _HDR.size, "header")
    if hdr is None:
        return None
    (length,) = _HDR.unpack(hdr)
    if length > MAX_MSG_BYTES:
        raise ProtocolError(f"frame too large: {length} bytes")
    return _recv_exact(sock, length, "payload")


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Read one framed message (either codec); None on clean EOF before a
    header."""
    payload = recv_payload(sock)
    if payload is None:
        return None
    return decode_payload(payload)


# --------------------------------------------------------------------------
# wire format v2: binary payloads (see module docstring for the layout)

WIRE_MAGIC = 0xB2
WIRE_VERSION = 2
_KIND_REQ = 1
_KIND_REP = 2
# magic, version, kind, opcode, routing-key length (u16 BE)
_REQ_HDR = struct.Struct(">BBBBH")
# magic, version, kind, status, errcode, reserved
_REP_HDR = struct.Struct(">BBBBBB")

#: reply-header error codes the shard router reads at a fixed offset
ERR_WRONG_SHARD = 1
ERR_MIGRATING = 2
_ERRCODES = {"WrongShardError": ERR_WRONG_SHARD, "Migrating": ERR_MIGRATING}

#: Request-header opcode per op — a routing/observability hint only (the
#: body always carries the op name; opcode 0 = "not in the table" and is
#: perfectly valid). Append-only: opcodes are on the wire, so renumbering
#: breaks mixed-version peers.
WIRE_OPCODES: Dict[str, int] = {
    "ping": 1,
    "create_experiment": 2,
    "load_experiment": 3,
    "update_experiment": 4,
    "list_experiments": 5,
    "delete_experiment": 6,
    "register": 7,
    "reserve": 8,
    "update_trial": 9,
    "heartbeat": 10,
    "get": 11,
    "fetch": 12,
    "count": 13,
    "fetch_completed_since": 14,
    "release_stale": 15,
    "set_signal": 16,
    "produce": 17,
    "judge": 18,
    "should_suspend": 19,
    "worker_cycle": 20,
    "snapshot": 21,
    "handoff_prepare": 22,
    "handoff_apply": 23,
    "handoff_abort": 24,
    "shard_map_update": 25,
    # multi-tenant service plane (read-only: per-tenant produce
    # accounting + fleet residency; evicted experiments' status counts
    # come from their stubs, never a hydration)
    "tenant_stats": 26,
}

try:  # C-accelerated body codec; absent → v2 is never negotiated
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - the image bakes msgpack in
    _msgpack = None

#: False ⇒ servers must not advertise the ``wire_v2`` cap, clients must
#: not send binary, and the WAL writes v1 JSON records — the whole v2
#: surface degrades to JSON with no negotiation needed.
HAVE_WIRE_V2 = _msgpack is not None


def encode_body(obj: Any, *, default=None) -> bytes:
    """The v2 frame/WAL-record body: msgpack of a JSON-able value.
    ``default`` mirrors ``json.dumps``'s hook for foreign leaf types (the
    WAL passes ``str``). Raises :class:`ProtocolError` for values msgpack
    cannot carry (e.g. ints beyond 64 bits) — callers fall back to JSON
    for that one frame."""
    if _msgpack is None:
        raise ProtocolError("wire v2 unavailable: msgpack not installed")
    try:
        return _msgpack.packb(obj, use_bin_type=True, default=default)
    except (TypeError, OverflowError, ValueError) as e:
        raise ProtocolError(f"unencodable binary body: {e}") from None


def decode_body(data: bytes, pos: int = 0) -> Any:
    """Decode a body back to its value; trailing bytes are a framing bug
    (:class:`ProtocolError`), truncation is a torn frame
    (:class:`TornFrameError`) so retry logic can tell them apart."""
    if _msgpack is None:
        raise ProtocolError("wire v2 unavailable: msgpack not installed")
    view = memoryview(data)[pos:] if pos else data
    try:
        return _msgpack.unpackb(view, raw=False)
    except _msgpack.exceptions.ExtraData as e:
        raise ProtocolError(
            f"binary body has trailing bytes after offset {pos}: "
            f"{e}") from None
    except _msgpack.exceptions.FormatError as e:
        raise ProtocolError(
            f"malformed binary body at offset {pos}: {e}") from None
    except (_msgpack.exceptions.OutOfData, ValueError) as e:
        # "incomplete input": the frame was cut mid-value
        raise TornFrameError(
            f"truncated binary body (started at offset {pos}, frame is "
            f"{len(data)} bytes): {e}") from None


def _need(data: bytes, pos: int, n: int, what: str) -> int:
    end = pos + n
    if end > len(data):
        raise TornFrameError(
            f"truncated v2 frame: {what} needs {n} bytes at offset "
            f"{pos}, frame has {len(data)}")
    return end


def payload_is_v2(payload: bytes) -> bool:
    """Binary v2 frame? JSON payloads always start with ``{`` (0x7b), so
    the 0xB2 magic is unambiguous."""
    return bool(payload) and payload[0] == WIRE_MAGIC


def _v2_header(payload: bytes):
    """(kind, b3, b4, b5) of a v2 frame, after magic/version checks."""
    if len(payload) < 6:
        raise TornFrameError(
            f"truncated v2 header: {len(payload)}/6 bytes")
    if payload[1] != WIRE_VERSION:
        raise ProtocolError(f"unsupported wire version {payload[1]}")
    return payload[2], payload[3], payload[4], payload[5]


def encode_request_v2(msg: Dict[str, Any], key: str = "",
                      *, default=None) -> bytes:
    """A request message as a v2 binary payload. ``key`` is the routing
    key (experiment name) copied into the fixed-offset header for the
    shard router; the body carries the authoritative copy inside
    ``args``."""
    kb = key.encode("utf-8") if key else b""
    if len(kb) > 0xFFFF:
        raise ProtocolError(f"routing key too long: {len(kb)} bytes")
    opcode = WIRE_OPCODES.get(msg.get("op"), 0)
    payload = (_REQ_HDR.pack(WIRE_MAGIC, WIRE_VERSION, _KIND_REQ,
                             opcode, len(kb))
               + kb + encode_body(msg, default=default))
    if len(payload) > MAX_MSG_BYTES:
        raise ProtocolError(f"message too large: {len(payload)} bytes")
    return payload


def encode_reply_v2(reply: Dict[str, Any], *, default=None) -> bytes:
    """A reply message as a v2 binary payload; status/errcode ride in the
    header so the router detects shard misses without decoding bodies."""
    if reply.get("ok"):
        status, errcode = 0, 0
    else:
        status = 1
        errcode = _ERRCODES.get(reply.get("error"), 0)
    payload = (_REP_HDR.pack(WIRE_MAGIC, WIRE_VERSION, _KIND_REP,
                             status, errcode, 0)
               + encode_body(reply, default=default))
    if len(payload) > MAX_MSG_BYTES:
        raise ProtocolError(f"message too large: {len(payload)} bytes")
    return payload


def decode_payload(payload: bytes) -> Dict[str, Any]:
    """One payload (either codec) back to its message dict."""
    if payload_is_v2(payload):
        kind, _, _, _ = _v2_header(payload)
        if kind == _KIND_REQ:
            # request header: keylen = u16 BE at offsets 4..5
            (keylen,) = struct.unpack_from(">H", payload, 4)
            body_at = _need(payload, 6, keylen, "routing key")
            return decode_body(payload, body_at)
        if kind == _KIND_REP:
            return decode_body(payload, 6)
        raise ProtocolError(f"unknown v2 frame kind {kind}")
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame: {e}") from None


def request_routing_key(payload: bytes) -> Optional[str]:
    """The routing key from a v2 request's fixed-offset header, WITHOUT
    decoding the body — the shard router's zero-parse routing path. None
    when
    the frame is not a v2 request (JSON: route by parsing) or carries an
    empty key."""
    if not payload_is_v2(payload):
        return None
    kind, _, _, _ = _v2_header(payload)
    if kind != _KIND_REQ:
        return None
    (keylen,) = struct.unpack_from(">H", payload, 4)
    if keylen == 0:
        return None
    end = _need(payload, 6, keylen, "routing key")
    return payload[6:end].decode("utf-8")


def request_opcode(payload: bytes) -> int:
    """The opcode hint of a v2 request (0 when absent/unknown)."""
    if not payload_is_v2(payload) or len(payload) < 6:
        return 0
    return payload[3] if payload[2] == _KIND_REQ else 0


def reply_shard_miss(payload: bytes) -> Optional[str]:
    """``"WrongShardError"`` / ``"Migrating"`` when a v2 reply's header
    says the owning shard moved; None for a JSON frame (caller sniffs
    text) or a non-miss reply. Two header bytes — no body decode."""
    if not payload_is_v2(payload) or len(payload) < 6:
        return None
    if payload[2] != _KIND_REP or payload[3] == 0:
        return None
    if payload[4] == ERR_WRONG_SHARD:
        return "WrongShardError"
    if payload[4] == ERR_MIGRATING:
        return "Migrating"
    return None
