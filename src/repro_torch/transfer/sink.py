"""The transfer layer's destination contract, as an explicit protocol.

Historically ``MDTPClient.fetch(sink=...)`` accepted two duck-typed
shapes — a bare callable ``sink(start, view)`` receiving transient
memoryviews, and an object with ``writable``/``commit`` for the
zero-copy path — and consumers (the client, the fleet manager, the
checkpoint restore) each re-described the contract in prose.  This
module promotes it to one typed :class:`Sink` protocol:

* ``writable(start, length) -> memoryview`` — a view of the
  destination for ``[start, start + length)``; the client reads socket
  bytes straight into it (zero-copy),
* ``commit(start, nbytes)`` — the first ``nbytes`` of that range
  landed and verified; account for them,
* ``covered_intervals() -> [(start, nbytes), ...]`` — the committed
  coverage as sorted disjoint pairs.  This is what makes a sink
  **mirrorable**: a ``PeerMirror`` mounts the sink on a ``RangeServer``
  and advertises exactly these intervals (``X-Available-Ranges``) to
  other restoring nodes.

All three implementations here share one interval-merge implementation
(:func:`repro_torch.transfer.journal.claim_interval`) with the resume journal
and the streaming checkpoint restore, so a mirror's advertisement has a
single source of truth no matter which sink backs it.

``CallableSink`` adapts the legacy callable shape to the protocol: the
wrapped callable still receives transient views (copy if you keep
them), but the adapter buffers each range in scratch so the zero-copy
receive path and the coverage accessor work.  Note the scratch is
per-range and released on commit — a ``CallableSink`` cannot back a
peer mirror (nothing is retained to serve) and cannot be CRC-verified
by the resume replay; use :class:`BufferSink` or the streaming restore
sink for those.
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

from repro_torch.transfer.journal import claim_interval

__all__ = ["Sink", "BufferSink", "CallableSink"]


@runtime_checkable
class Sink(Protocol):
    """Destination contract for :meth:`repro_torch.transfer.MDTPClient.fetch`.

    Ranges may arrive out of order, and deliveries may overlap or
    repeat (retries, speculative re-fetches) — implementations must
    treat ``commit`` as idempotent per byte.  ``covered_intervals``
    must be safe to call from other threads while the transfer is in
    flight: a peer mirror's server threads read it to build the
    ``X-Available-Ranges`` advertisement.
    """

    def writable(self, start: int, length: int) -> memoryview:
        """A writable view of the destination for ``[start, start +
        length)``; socket bytes are received directly into it."""
        ...

    def commit(self, start: int, nbytes: int) -> None:
        """``nbytes`` at ``start`` landed (already written via
        :meth:`writable`); account for them."""
        ...

    def covered_intervals(self) -> list:
        """Committed coverage as sorted disjoint ``(start, nbytes)``
        pairs."""
        ...


class BufferSink:
    """A preallocated in-memory destination implementing :class:`Sink`.

    The swarm-restore building block: each restoring node lands its
    blob here and mounts the same object on a ``PeerMirror`` — committed
    bytes are immutable thereafter, so server threads may read them
    concurrently with the ongoing transfer.
    """

    def __init__(self, size: int):
        self._buf = bytearray(size)
        self._covered: list[tuple[int, int]] = []    # disjoint [s, e)
        #: re-delivered byte count (overlapping/duplicate commits)
        self.duplicate_bytes = 0

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def total_bytes(self) -> int:
        return len(self._buf)

    def writable(self, start: int, length: int) -> memoryview:
        return memoryview(self._buf)[start:start + length]

    def commit(self, start: int, nbytes: int) -> None:
        if nbytes <= 0:
            return
        fresh = claim_interval(self._covered, start, start + nbytes)
        self.duplicate_bytes += nbytes - sum(e - s for s, e in fresh)

    def covered_intervals(self) -> list[tuple[int, int]]:
        return [(s, e - s) for s, e in list(self._covered)]

    def __bytes__(self) -> bytes:
        return bytes(self._buf)

    @property
    def view(self) -> memoryview:
        """Read/write view of the whole buffer (what a mirror serves)."""
        return memoryview(self._buf)


class CallableSink:
    """Adapt a legacy callable ``sink(start, view)`` to :class:`Sink`.

    ``writable`` hands the client a per-range scratch buffer; ``commit``
    forwards the landed bytes to the callable as a transient view (valid
    only during the call, exactly like the legacy direct path) and then
    releases the scratch.  Coverage is tracked so protocol-typed
    consumers can introspect progress, but nothing is retained — see the
    module docstring for what that rules out.
    """

    #: scratch-backed: ``writable(0, total)`` is NOT the landed bytes, so
    #: a :class:`~repro_torch.transfer.mirror.PeerMirror` refuses to mount one
    #: (it would advertise coverage over a zero-filled buffer).
    mirrorable = False

    def __init__(self, fn: Callable[[int, memoryview], None]):
        self._fn = fn
        self._scratch: dict[int, bytearray] = {}
        self._covered: list[tuple[int, int]] = []

    def writable(self, start: int, length: int) -> memoryview:
        buf = bytearray(length)
        self._scratch[start] = buf
        return memoryview(buf)

    def commit(self, start: int, nbytes: int) -> None:
        buf = self._scratch.pop(start, None)
        if buf is None or nbytes <= 0:
            return
        self._fn(start, memoryview(buf)[:nbytes])
        claim_interval(self._covered, start, start + nbytes)

    def covered_intervals(self) -> list[tuple[int, int]]:
        return [(s, e - s) for s, e in list(self._covered)]
