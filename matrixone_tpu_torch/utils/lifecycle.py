"""Service thread lifecycle: track, interrupt, join.

The port's copy of `matrixone_tpu/utils/lifecycle.py`.  Every socket
service of the port (the fragment server, the TN) has an accept loop
that spawns one handler thread per connection.  `ServiceThreads` names
and remembers those threads and the live sockets; `shutdown()`
interrupts blocked I/O (a socket `shutdown()` wakes a blocked accept or
recv, where `close()` alone does not) and joins every thread with a
deadline, so a stopped service leaves no thread behind.

Thread names: `<prefix>-accept` for the accept loop, `<prefix>-conn-<n>`
for the per-connection handlers, whose life is the client's pooled
connection.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import List, Optional


class ServiceThreads:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self._mu = threading.Lock()
        self._conns: set = set()
        self._threads: List[threading.Thread] = []
        self._seq = itertools.count(1)
        self._stopped = False

    def spawn_accept(self, target) -> threading.Thread:
        """The accept loop, joined at shutdown.  Re-arms a tracker that
        was shut down, so a service restarted in place serves again."""
        t = threading.Thread(target=target, daemon=True,
                             name=f"{self.prefix}-accept")
        with self._mu:
            self._stopped = False
            self._threads.append(t)
        t.start()
        return t

    def spawn_handler(self, target, conn: socket.socket,
                      args: tuple = ()) -> Optional[threading.Thread]:
        """One per-connection handler; its socket is tracked so
        shutdown() can interrupt a blocked recv.  A connection accepted
        while shutdown() runs is closed instead of served."""
        def run():
            try:
                target(conn, *args)
            finally:
                with self._mu:
                    self._conns.discard(conn)

        t = threading.Thread(target=run, daemon=True,
                             name=f"{self.prefix}-conn-{next(self._seq)}")
        with self._mu:
            if self._stopped:
                try:
                    conn.close()
                except OSError:
                    pass
                return None
            self._conns.add(conn)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return t

    def shutdown(self, listener: Optional[socket.socket] = None,
                 grace: float = 5.0) -> List[str]:
        """Interrupt and join every tracked thread within `grace`
        seconds.  -> the names of the threads still alive at the
        deadline (empty when the service stopped cleanly)."""
        socks = [listener] if listener is not None else []
        with self._mu:
            self._stopped = True
            socks += list(self._conns)
            self._conns = set()
            threads, self._threads = self._threads, []
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        deadline = time.monotonic() + grace
        me = threading.current_thread()
        for t in threads:
            if t is me:
                continue
            t.join(max(0.0, deadline - time.monotonic()))
        return [t.name for t in threads
                if t is not me and t.is_alive()]
