"""BitTorrent behavioral model for the simulator.

The paper ran six always-on seeders with choking disabled and still observed
erratic participation: 2-5 of 6 seeders active at any time (Fig. 2c), ~2x
MDTP's transfer time, and 30x worse run-to-run variance.  We model the
client side as: equal pieces (BitTorrent piece sizes are static per
torrent), one request pipeline per seeder, and seeder availability as an
on/off Markov process (``ServerSpec.avail_up/avail_down``) calibrated to the
2-5 active-seeder band.  A piece interrupted by a seeder flap is resumed
from the byte it stopped at (slightly *favoring* BT versus real piece-hash
semantics, which would discard the partial piece — noted in EXPERIMENTS.md).

Rarest-first and tit-for-tat do not matter in the paper's setting (all
seeders hold the full file; choking was disabled), so they are not modeled.

This is the port's own copy of ``repro.core.bittorrent``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

from .simulator import Action, Policy, Request, TransferState, Wait

__all__ = ["BitTorrentPolicy"]

MB = 1024 * 1024


class BitTorrentPolicy(Policy):
    name = "bittorrent"

    def __init__(self, piece_size: int = 4 * MB, retry_interval: float = 5.0):
        self.piece_size = piece_size
        self.retry_interval = retry_interval

    def reset(self, n_servers: int, file_size: int) -> None:
        self._backoff_until = [0.0] * n_servers

    def next_action(self, state: TransferState, conn: int, now: float) -> Action:
        seeder = conn  # one pipeline per seeder
        if state.unassigned_bytes() <= 0:
            return None
        if now < self._backoff_until[seeder]:
            return Wait(self._backoff_until[seeder])
        return Request(seeder, min(self.piece_size, state.unassigned_bytes()))

    def on_complete(
        self, state: TransferState, conn: int, server: int,
        nbytes: int, elapsed: float, now: float, truncated: bool = False,
    ) -> None:
        if truncated or nbytes == 0:
            # seeder flapped; poll it again after a tracker-ish delay
            self._backoff_until[server] = now + self.retry_interval
