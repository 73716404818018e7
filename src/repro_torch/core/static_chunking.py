"""Static (uniform) chunking baseline — Rodriguez & Biersack [13].

Identical plumbing to MDTP (one persistent connection per server, global
byte cursor, work-conserving: a free server immediately grabs the next
chunk), but every request is the same fixed size.  This is the paper's
"Static Chunking" comparison implementation (§V): *"It shares the core
features and operational details of MDTP, with the primary difference being
its chunk-sizing strategy."*  Like the paper's version (and unlike the
original Rodriguez scheme) it does **not** re-request in-flight chunks at
the endgame — each byte is requested once.

This is the port's own copy of ``repro.core.static_chunking``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

from typing import Optional

from .simulator import Action, Policy, Request, TransferState

__all__ = ["StaticChunkingPolicy", "default_static_chunk"]

MB = 1024 * 1024


def default_static_chunk(file_size: int) -> int:
    """The paper tuned static chunk sizes per file (§VI-A); these match the
    MDTP large-chunk regime which was competitive in their sweep."""
    return 40 * MB if file_size <= 8 * 1024 * MB else 160 * MB


class StaticChunkingPolicy(Policy):
    name = "static"

    def __init__(self, chunk_size: Optional[int] = None):
        self._chunk_arg = chunk_size

    def reset(self, n_servers: int, file_size: int) -> None:
        self.chunk = self._chunk_arg or default_static_chunk(file_size)
        self._dead = [False] * n_servers

    def next_action(self, state: TransferState, conn: int, now: float) -> Action:
        if self._dead[conn]:
            return None
        remaining = state.unassigned_bytes()
        if remaining <= 0:
            return None
        return Request(conn, min(self.chunk, remaining))

    def on_complete(
        self, state: TransferState, conn: int, server: int,
        nbytes: int, elapsed: float, now: float, truncated: bool = False,
    ) -> None:
        if truncated or nbytes == 0:
            self._dead[server] = True
