"""Fix-reverted MTP002 fixture: a coordinator sender thread that ships
the reply BEFORE syncing the WAL barrier — the exact inversion the live
``_serve_conn._sender`` exists to prevent. A crash between the send and
the sync acks a write that was never durable."""


class CoordServer:
    def _serve_conn(self, conn):
        wal = self._wal
        outbox = self._outbox

        def _sender():
            while True:
                item = outbox.get()
                if item is None:
                    return
                reply, barrier = item
                send_payload(conn, reply)  # BUG: the ack leaves first
                if barrier:
                    wal.sync(barrier)
