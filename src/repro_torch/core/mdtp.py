"""MDTP policy (the paper's Algorithm 1) for the discrete-event simulator.

One persistent connection per server (paper §III-A).  Every time a server
becomes free it asks the bin-packing allocator (``repro_torch.core.chunking``) for
its next range size given the latest throughput estimates of all servers.
A server that breaks a connection mid-chunk is marked dead and its
undelivered bytes are rescheduled onto the surviving replicas — behaviour
the paper does not evaluate but the framework's checkpoint-restore path
requires (fault tolerance beyond the paper; flagged by ``retry_after``).

This is the port's own copy of ``repro.core.mdtp``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

from typing import Optional

from .chunking import ChunkParams, default_chunk_params, next_chunk_size
from .simulator import Action, Policy, Request, TransferState, Wait
from .throughput import make_estimator

__all__ = ["MDTPPolicy"]


class MDTPPolicy(Policy):
    name = "mdtp"

    def __init__(
        self,
        params: Optional[ChunkParams] = None,
        estimator: str = "last",
        ewma_alpha: float = 0.5,
        retry_after: float = 0.0,
    ):
        """Args:
        params: allocator constants; ``None`` picks paper Table II defaults
          from the file size at ``reset``.
        estimator: ``"last"`` (paper) or ``"ewma"``.
        retry_after: if > 0, a failed server is retried after this many
          seconds instead of being abandoned (for flaky-replica scenarios).
        """
        self._params_arg = params
        self._estimator_kind = estimator
        self._ewma_alpha = ewma_alpha
        self._retry_after = retry_after

    def reset(self, n_servers: int, file_size: int) -> None:
        self.params = self._params_arg or default_chunk_params(file_size)
        self.est = [
            make_estimator(self._estimator_kind, self._ewma_alpha)
            for _ in range(n_servers)
        ]
        self._dead = [False] * n_servers
        self._retry_at = [0.0] * n_servers

    def next_action(self, state: TransferState, conn: int, now: float) -> Action:
        server = conn  # one connection per server
        if self._dead[server]:
            if self._retry_after <= 0.0:
                return None
            if now < self._retry_at[server]:
                if state.unassigned_bytes() <= 0:
                    return None
                return Wait(self._retry_at[server])
            # probe again from scratch
            self._dead[server] = False
            self.est[server].reset()
        remaining = state.unassigned_bytes()
        size = next_chunk_size(
            server, [e.value for e in self.est], self.params, remaining
        )
        if size <= 0:
            return None
        return Request(server, size)

    def on_complete(
        self, state: TransferState, conn: int, server: int,
        nbytes: int, elapsed: float, now: float, truncated: bool = False,
    ) -> None:
        if truncated or nbytes == 0:
            self._dead[server] = True
            self._retry_at[server] = now + self._retry_after
            return
        self.est[server].observe(nbytes, elapsed)
