"""MTP002 clean fixture: the correct sender — WAL barrier synced before
any reply leaves, mirroring the live ``_serve_conn._sender``."""


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
                if barrier:
                    wal.sync(barrier)
                send_payload(conn, reply)
