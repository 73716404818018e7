"""Peer mirror: a restoring node that serves what it has so far.

The broadcast building block.  A node restoring a checkpoint owns a
:class:`~repro_torch.transfer.sink.Sink` that is filling up; ``PeerMirror``
mounts that sink's buffer on a :class:`~repro_torch.transfer.server.RangeServer`
as a read-only **partial mirror** — the server advertises the sink's
live ``covered_intervals()`` over the wire (``X-Available-Ranges`` on
HEAD, 416-with-advertisement for uncovered GETs) and serves committed
bytes with the usual Range/CRC machinery.  Other restorers add
``mirror.replica`` to their replica list: the client sees
``Replica.mirror`` set, tracks the peer's coverage, and only packs
chunks the peer actually holds — chain/tree dissemination without any
new wire protocol beyond one header.

The mirrored buffer must follow the sinks' write-once contract
(committed bytes immutable): server threads read committed regions
concurrently with the ongoing restore, unsynchronized by design.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.transfer.client import Replica
from repro_torch.transfer.server import FaultPolicy, RangeServer, Throttle

__all__ = ["PeerMirror"]


class PeerMirror:
    """Serve a filling :class:`Sink`'s covered ranges to peers.

    ``throttle``/``faults``/``checksums`` configure the underlying
    :class:`RangeServer` — a peer's uplink is usually throttled
    (``Throttle(bytes_per_s=..., shared=True)``: one node's egress is a
    shared pipe) and chaos tests inject faults exactly like on an
    origin.  Bind at construction (``PeerMirror(sink)``) or later
    (``restore_checkpoint`` binds once the blob size is known); the
    server starts on first bind and keeps its port across rebinds, so a
    replica handed out early stays valid.
    """

    def __init__(self, sink=None, *, path: str = "/data",
                 total: Optional[int] = None,
                 throttle: Optional[Throttle] = None,
                 faults: Optional[FaultPolicy] = None,
                 checksums: bool = True):
        self.path = path if path.startswith("/") else "/" + path
        self._server = RangeServer(throttle=throttle, faults=faults,
                                   checksums=checksums)
        self._started = False
        self._bound = False
        if sink is not None:
            self.bind(sink, total)

    # -- lifecycle --------------------------------------------------------

    def bind(self, sink, total: Optional[int] = None) -> "PeerMirror":
        """Mount ``sink`` (a :class:`repro_torch.transfer.Sink` whose
        ``writable(0, total)`` exposes the whole destination buffer) and
        start serving its covered ranges.  ``total`` defaults to the
        sink's ``total_bytes`` / ``len()``.  Rebinding replaces any
        previous mount."""
        if getattr(sink, "mirrorable", True) is False:
            raise ValueError(
                f"{type(sink).__name__} cannot back a mirror: its "
                "writable() hands out per-range scratch, not the landed "
                "bytes")
        if total is None:
            total = getattr(sink, "total_bytes", None)
        if total is None:
            try:
                total = len(sink)
            except TypeError:
                raise ValueError(
                    "total= required: sink exposes neither total_bytes "
                    "nor __len__") from None
        total = int(total)
        view = sink.writable(0, total)
        self._server.add_partial(self.path, view, sink.covered_intervals,
                                 total)
        self._bound = True
        if not self._started:
            self.start()
        return self

    def unbind(self) -> None:
        """Stop serving (requests 404) without tearing the server down —
        a restore whose landing buffer is about to die (spool mmap)
        unbinds; the port stays up for a later rebind."""
        self._server.remove_path(self.path)
        self._bound = False

    def start(self) -> "PeerMirror":
        if not self._started:
            self._server.start()
            self._started = True
        return self

    def stop(self) -> None:
        self.unbind()
        if self._started:
            self._server.stop()
            self._started = False

    def __enter__(self) -> "PeerMirror":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection ----------------------------------------------------

    @property
    def bound(self) -> bool:
        return self._bound

    @property
    def server(self) -> RangeServer:
        """The underlying server (tests use it for ``kill_connections``,
        ``set_faults``, witnesses)."""
        return self._server

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def served_bytes(self) -> int:
        """Bytes this peer has served to others — the origin-offload
        witness."""
        return self._server.served_bytes

    @property
    def replica(self) -> Replica:
        """This mirror as a transfer replica (``mirror=True``: clients
        track its coverage and only pack chunks it holds)."""
        return Replica("127.0.0.1", self._server.port, self.path,
                       mirror=True)
