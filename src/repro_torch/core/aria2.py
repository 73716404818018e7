"""Aria2 behavioral model for the simulator.

Aria2 is closed over a different codebase (C++), so we model the behaviors
the paper measured rather than linking the tool:

* a fixed *piece* size (aria2's ``min-split-size``, 20 MiB by default);
* at most ``max_connections`` concurrent segments (aria2 ``-s``, default 5),
  one connection per server (aria2 ``-x1`` per-host default);
* a *feedback* URI selector: when a connection needs a server it probes
  unknown mirrors once (it must measure to rank), then always picks the
  fastest known idle mirror.  With six mirrors and five connections the
  steady-state rotation parks the *slowest* mirror idle — exactly what the
  paper measured (Fig. 5a/5b: 83% utilization, slowest replica unused,
  fastest overloaded).  ``explore_unknown=False`` freezes the initial
  URI-order five instead.

This reproduces aria2's two measured pathologies: it leaves slow-replica
capacity on the table, and its fixed pieces pay one idle RTT per 20 MiB.

This is the port's own copy of ``repro.core.aria2``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

from .simulator import Action, Policy, Request, TransferState

__all__ = ["Aria2Policy"]

MB = 1024 * 1024


class Aria2Policy(Policy):
    name = "aria2"

    def __init__(
        self,
        piece_size: int = 20 * MB,
        max_connections: int = 5,
        explore_unknown: bool = True,
    ):
        self.piece_size = piece_size
        self.max_connections = max_connections
        self.explore_unknown = explore_unknown

    def n_connections(self, n_servers: int) -> int:
        return min(self.max_connections, n_servers)

    def reset(self, n_servers: int, file_size: int) -> None:
        self.n_servers = n_servers
        self.speed = [0.0] * n_servers      # feedback estimates
        self.tried = [False] * n_servers
        self.dead = [False] * n_servers
        self.in_use: set[int] = set()
        self._conn_server: dict[int, int] = {}

    def _pick_server(self, conn: int) -> int | None:
        candidates = [
            s for s in range(self.n_servers)
            if s not in self.in_use and not self.dead[s]
        ]
        if not candidates:
            return None
        known = [s for s in candidates if self.tried[s]]
        unknown = [s for s in candidates if not self.tried[s]]
        if known and (not self.explore_unknown or not unknown):
            # feedback selector: fastest known mirror wins
            return max(known, key=lambda s: self.speed[s])
        if unknown:
            # initial assignment follows URI list order
            return unknown[0]
        return None

    def next_action(self, state: TransferState, conn: int, now: float) -> Action:
        if state.unassigned_bytes() <= 0:
            return None
        server = self._pick_server(conn)
        if server is None:
            return None
        self.tried[server] = True
        self.in_use.add(server)
        self._conn_server[conn] = server
        return Request(server, min(self.piece_size, state.unassigned_bytes()))

    def on_complete(
        self, state: TransferState, conn: int, server: int,
        nbytes: int, elapsed: float, now: float, truncated: bool = False,
    ) -> None:
        self.in_use.discard(server)
        self._conn_server.pop(conn, None)
        if truncated or nbytes == 0:
            self.dead[server] = True
            return
        if elapsed > 0:
            self.speed[server] = nbytes / elapsed
