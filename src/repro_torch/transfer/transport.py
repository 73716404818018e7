"""Raw-socket HTTP/1.1 range transport for the MDTP client.

The wire layer of :mod:`repro_torch.transfer.client`, factored out so the
client module is scheduler glue + observation plumbing and THIS module
is everything that touches a socket.  No aiohttp in this environment —
:class:`_Conn` is a persistent pipelined HTTP/1.1 connection on
asyncio's ``loop.sock_*`` primitives with a zero-copy receive path
(bodies are ``sock_recv_into`` memoryview slices of the caller's
buffer).  Each connection is full-duplex: an independent writer
coroutine drains a queue of request writes while reader lanes stream
bodies, so issuing the next pipelined request never waits behind an
in-flight body.  Subclasses adapt it: the data pipeline's virtual-blob
connection translates offsets, the fleet manager's managed connection
caps concurrency and feeds telemetry.

Compressed ranges (``X-Range-Encoding``, see
:mod:`repro_torch.transfer.codec`) decode transparently here: the framed
wire body lands in scratch, inflates off the event loop, and the reply
reports decoded bytes (``nbytes``) and wire bytes (``wire_nbytes``)
separately so telemetry can track the wire rate while coverage commits
decoded bytes.
"""

from __future__ import annotations

import asyncio
import contextlib
import socket
import time
import zlib
from typing import NamedTuple, Optional

from repro_torch.transfer import codec
from repro_torch.transfer.sched import defaults as sched_defaults

__all__ = ["_Conn", "_RangeReply", "_crc32_async"]

#: bodies at or below this size are CRC'd inline on the event loop (the
#: executor round-trip costs more than the hash); larger bodies hash in
#: the thread pool — zlib releases the GIL, so verification overlaps the
#: next body's socket reads instead of stalling them.
_CRC_INLINE_MAX = sched_defaults.CRC_INLINE_MAX


async def _crc32_async(data) -> int:
    """CRC32 of a body, off the event loop for large bodies.

    ``zlib.crc32`` accepts any buffer and releases the GIL, so hashing a
    multi-megabyte range in the default executor runs concurrently with
    the loop's socket reads; small bodies aren't worth the thread hop.
    """
    if len(data) <= _CRC_INLINE_MAX:
        return zlib.crc32(data)
    return await asyncio.get_running_loop().run_in_executor(
        None, zlib.crc32, data)


class _RangeReply(NamedTuple):
    """One completed range request, with the timing metadata the
    observation layer needs to de-bias throughput samples."""

    #: the body: ``memoryview`` of the caller's buffer when ``into`` was
    #: given, freshly-read ``bytes`` otherwise.
    data: object
    #: body length actually served (may be < requested on a clamped tail).
    nbytes: int
    #: seconds attributable to receiving THIS body.
    elapsed: float
    #: True when ``elapsed`` spans the full request round-trip (the pipe
    #: was idle at issue time) — the estimator must strip the RTT.
    rtt_included: bool
    #: server-declared CRC32 of the range (``X-Range-Checksum`` header),
    #: None when the server doesn't checksum.  For encoded bodies the
    #: server checksums the pristine DECODED range, so verification
    #: runs on ``data`` either way.
    crc32: Optional[int] = None
    #: bytes that actually crossed the wire for this reply; None for
    #: identity-encoded bodies (wire == decoded).  Telemetry must use
    #: ``wire_bytes`` — feeding decoded bytes into a bandwidth estimator
    #: over a compressed path would double-count the codec's savings.
    wire_nbytes: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        """Wire bytes received for this body (== ``nbytes`` unless the
        body was transfer-encoded)."""
        return self.nbytes if self.wire_nbytes is None else self.wire_nbytes


class _SendOp:
    """One queued request write (duplex mode).

    Carries the request bytes, the turnstile predecessor (so the writer
    can judge idle-pipe-ness at the moment the request actually hits the
    wire) and the caller's progress list (slot 1 takes the wire-send
    stamp).  ``fut`` resolves once the request is on the wire, or fails
    with ``ConnectionError`` — every queued-but-unsent request fails
    exactly once when the connection dies, which is what lets the lane
    layer re-pool each owed range exactly once (conservation)."""

    __slots__ = ("payload", "prior", "progress", "fut",
                 "t_send", "pipelined")

    def __init__(self, payload: bytes, prior: Optional[asyncio.Event],
                 progress: Optional[list]):
        self.payload = payload
        self.prior = prior
        self.progress = progress
        self.fut: asyncio.Future = \
            asyncio.get_running_loop().create_future()
        self.t_send = 0.0
        self.pipelined = False


class _Conn:
    """One persistent pipelined HTTP/1.1 connection on a raw socket.

    Requests may be issued concurrently by several tasks.  In duplex
    mode (the default) each request is enqueued to an independent writer
    coroutine that drains the queue onto the socket — a request write
    never waits behind an in-flight response body, so the pipe stays at
    depth even when bodies stream for whole RTTs.  Responses are read
    strictly in request order via a FIFO turnstile (each request waits
    on its predecessor's completion event); enqueue order and turnstile
    order are linked atomically, and the single writer preserves that
    order on the wire.  With ``duplex=False`` the legacy half-duplex
    path sends inline under the write lock (kept as a benchmark
    baseline).  Bodies are received with ``sock_recv_into`` directly
    into the caller's buffer — the only copied bytes are the
    header-phase read-ahead (bounded by ``_HEADER_RECV`` per response)
    and encoded bodies' wire scratch.

    Collects per-connection RTT samples: the TCP connect time on session
    establishment, then the request-write → status-line turnaround of
    every request issued on an idle pipe (a queued-behind-a-body
    turnaround measures the predecessor's streaming time, not the path).
    Consumers drain ``take_rtt_samples()`` and min-aggregate.

    Any failure (transport error, malformed response, a read stalled past
    ``read_timeout``, cancellation mid-read) marks the connection
    ``broken``: the stream position is unrecoverable, so every queued
    request fails fast instead of parsing from the middle of a
    predecessor's body.
    """

    #: recv size while parsing status/headers — small so read-ahead into
    #: the copied header buffer steals at most this many body bytes from
    #: the zero-copy path per response.
    _HEADER_RECV = 4096

    def __init__(self, replica, request_latency: float = 0.0,
                 read_timeout: float = 0.0, duplex: bool = True):
        #: the replica this session targets — anything with ``host`` /
        #: ``port`` / ``path`` / ``name`` (duck-typed so this module
        #: doesn't import the client layer).
        self.replica = replica
        #: emulated request-path propagation delay (seconds) — a test and
        #: benchmark knob: loopback has no real RTT, so the dataplane
        #: bench injects one here to reproduce the WAN regime where
        #: pipelining pays off.  Applied before each request send, off
        #: the critical path of already-streaming predecessors.
        self.request_latency = request_latency
        #: per-READ inactivity bound (seconds; 0 disables).  A replica
        #: that stalls without dying would otherwise hang a lane forever
        #: — the timeout converts the stall into a ``ConnectionError`` so
        #: it takes the same re-pool path as a connection death.  Scoped
        #: per socket read, not per request: a huge range streaming
        #: slowly-but-steadily never trips it.
        self.read_timeout = read_timeout
        #: False = legacy half-duplex sends (inline under the write
        #: lock) — the benchmark baseline the duplex win-guard measures
        #: against.
        self.duplex = duplex
        self.broken = False
        self._sock: Optional[socket.socket] = None
        self._rbuf = bytearray()
        self._rtt_samples: list[float] = []
        self._wlock = asyncio.Lock()
        #: completion event of the most recently issued request (the
        #: turnstile tail); None = pipe idle since connect.
        self._tail: Optional[asyncio.Event] = None
        #: duplex writer state: the request queue and the coroutine
        #: draining it (both created lazily on the first duplex send).
        self._sendq: Optional[asyncio.Queue] = None
        self._writer: Optional[asyncio.Task] = None

    def take_rtt_samples(self) -> list[float]:
        samples, self._rtt_samples = self._rtt_samples, []
        return samples

    async def connect(self):
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        t0 = time.monotonic()
        try:
            await loop.sock_connect(
                sock, (self.replica.host, self.replica.port))
        except BaseException:
            sock.close()
            raise
        self._rtt_samples.append(time.monotonic() - t0)
        # pipelined requests are tiny back-to-back writes: without NODELAY
        # Nagle would hold them hostage to the previous response's ACKs
        with contextlib.suppress(OSError):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    async def close(self):
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await writer
        self._fail_queued("connection closed")
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
            self._sock = None

    def abort(self) -> None:
        """Break the connection under a CONCURRENT reader (hedge-win
        cancellation).  ``close()`` would free the fd while a
        ``sock_recv`` future is still registered on it — the selector
        never fires for a closed fd and the loser's read would only die
        at the inactivity timeout.  ``shutdown()`` keeps the fd alive
        and wakes the pending read with EOF immediately; the owning
        worker then closes the socket on its normal unwind path.

        The writer must not deadlock either: queued-but-unsent requests
        fail synchronously here, and a write blocked in ``sock_sendall``
        wakes with an error from the shutdown — either way every lane
        parked on a send future gets its ConnectionError promptly."""
        self.broken = True
        self._fail_queued("connection aborted")
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.shutdown(socket.SHUT_RDWR)

    # -- duplex writer -----------------------------------------------------

    def _fail_queued(self, why: str) -> None:
        """Fail every queued-but-unsent request (sync — callable from
        ``abort``).  Runs on the event loop thread with no await points,
        so it cannot race the writer popping the same op."""
        if self._sendq is None:
            return
        while not self._sendq.empty():
            op = self._sendq.get_nowait()
            if op is not None and not op.fut.done():
                op.fut.set_exception(ConnectionError(why))

    def _ensure_writer(self) -> None:
        if self._writer is None:
            self._sendq = asyncio.Queue()
            self._writer = asyncio.ensure_future(self._drain_sends())

    async def _drain_sends(self) -> None:
        """The writer coroutine: pop queued requests and put them on the
        wire, independent of any lane streaming a body.  A send failure
        breaks the connection and fails that op; already-queued ops then
        fail fast on the broken check — each exactly once."""
        loop = asyncio.get_running_loop()
        try:
            while True:
                op = await self._sendq.get()
                if op is None or op.fut.done():
                    continue
                if self.broken or self._sock is None:
                    op.fut.set_exception(
                        ConnectionError("pipelined connection broken"))
                    continue
                # idle-pipe-ness is judged at the moment the request
                # actually goes on the wire — a queued request whose
                # predecessor completed while it waited is NOT pipelined
                # (its turnaround measures the path, so it may RTT-sample)
                op.pipelined = (op.prior is not None
                                and not op.prior.is_set())
                op.t_send = time.monotonic()
                if op.progress is not None and len(op.progress) > 1:
                    # wire-send stamp for the hedging layer: a range
                    # starts aging only once its request is on the wire
                    op.progress[1] = op.t_send
                try:
                    await loop.sock_sendall(self._sock, op.payload)
                except BaseException as e:
                    self.broken = True
                    if not op.fut.done():
                        op.fut.set_exception(ConnectionError(
                            f"request write failed: {e!r}"))
                    if not isinstance(e, Exception):
                        raise            # propagate cancellation
                    continue
                if not op.fut.done():
                    op.fut.set_result(None)
        finally:
            # writer exiting (cancelled by close, or cancelled mid-send):
            # nothing will drain the queue any more — fail the leftovers
            # so no lane awaits a send that can never happen
            self._fail_queued("writer stopped")

    # -- buffered header reads / zero-copy body reads ----------------------

    async def _timed(self, aw):
        """Bound one socket read by the inactivity timeout."""
        if self.read_timeout <= 0.0:
            return await aw
        try:
            return await asyncio.wait_for(aw, self.read_timeout)
        except asyncio.TimeoutError:
            raise ConnectionError(
                f"read stalled > {self.read_timeout:g}s "
                f"(inactivity timeout)") from None

    def _live_sock(self) -> socket.socket:
        """Snapshot the socket for one read.  A concurrent ``close()``
        (a hedge winner severing the losing lane) nulls ``_sock`` between
        awaits; reading through the snapshot turns that race into the
        ConnectionError every caller already handles instead of an
        AttributeError on ``None``."""
        sock = self._sock
        if sock is None:
            raise ConnectionError("connection closed")
        return sock

    async def _fill(self, hint: int) -> None:
        data = await self._timed(
            asyncio.get_running_loop().sock_recv(self._live_sock(), hint))
        if not data:
            raise ConnectionError("connection closed")
        self._rbuf += data

    async def _readline(self) -> bytes:
        while True:
            idx = self._rbuf.find(b"\n")
            if idx >= 0:
                line = bytes(self._rbuf[:idx + 1])
                del self._rbuf[:idx + 1]
                return line
            if len(self._rbuf) > 65536:
                raise ConnectionError("oversized header line")
            await self._fill(self._HEADER_RECV)

    async def _read_headers(self) -> tuple[int, dict]:
        status = await self._readline()
        parts = status.split()
        if len(parts) < 2 or not parts[1].isdigit():
            raise ConnectionError(f"malformed status line: {status!r}")
        code = int(parts[1])
        headers = {}
        while True:
            line = await self._readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        return code, headers

    async def _read_body(self, n: int, into: Optional[memoryview],
                         progress: Optional[list] = None):
        """Read exactly ``n`` body bytes — into the caller's view when
        given (zero-copy), into fresh ``bytes`` otherwise.  Slot 0 of
        ``progress`` (a list) is kept updated with the byte count landed
        so far — the hedging layer reads it to avoid duplicating ranges
        whose owner has already received most of the body."""
        if into is None:
            scratch = bytearray(n)
            view = memoryview(scratch)
        else:
            if len(into) < n:
                raise ConnectionError(
                    f"response body {n} B overruns the {len(into)} B "
                    f"destination range")
            scratch = None
            view = into
        got = min(len(self._rbuf), n)   # header-phase read-ahead first
        if got:
            view[:got] = self._rbuf[:got]
            del self._rbuf[:got]
        if progress is not None:
            progress[0] = got
        loop = asyncio.get_running_loop()
        try:
            while got < n:
                r = await self._timed(
                    loop.sock_recv_into(self._live_sock(), view[got:n]))
                if r <= 0:
                    raise ConnectionError(
                        f"connection closed mid-body ({got}/{n} B)")
                got += r
                if progress is not None:
                    progress[0] = got
        except ConnectionError as e:
            # how much of the body actually landed before the break —
            # the waste accounting for a hedge-cancelled read charges
            # the bytes genuinely spent, not the whole range
            e.partial_bytes = got
            raise
        return bytes(scratch) if scratch is not None else view[:n]

    # -- requests ----------------------------------------------------------

    def _request_bytes(self, method: str, start=None, end=None) -> bytes:
        rng = (f"Range: bytes={start}-{end}\r\n"
               if start is not None else "")
        return (f"{method} {self.replica.path} HTTP/1.1\r\n"
                f"Host: {self.replica.host}\r\n{rng}"
                f"Connection: keep-alive\r\n\r\n").encode()

    @staticmethod
    def _parse_checksum(headers: dict) -> Optional[int]:
        raw = headers.get("x-range-checksum")
        if raw and raw.startswith("crc32:"):
            try:
                return int(raw[len("crc32:"):], 16)
            except ValueError:
                return None
        return None

    async def fetch_range(self, start: int, end: int,
                          into: Optional[memoryview] = None,
                          progress: Optional[list] = None) -> _RangeReply:
        """GET bytes [start, end] inclusive over the persistent session.

        May be called concurrently: the request goes on the wire
        immediately (pipelined behind any in-flight predecessors) and the
        response is read in FIFO order.  With ``into``, the body is
        received directly into that view and the reply's ``data`` is
        ``into[:nbytes]``; without it, fresh ``bytes`` are returned.
        """
        if self._sock is None:
            # concurrent lanes race to the first request: exactly one may
            # establish the session (an unguarded lazy connect would open
            # one socket per lane and leak all but the last)
            async with self._wlock:
                if self._sock is None and not self.broken:
                    try:
                        await self.connect()
                    except BaseException:
                        self.broken = True
                        raise
        if self.request_latency > 0.0:
            await asyncio.sleep(self.request_latency)
        my_done = asyncio.Event()
        op: Optional[_SendOp] = None
        if self.duplex:
            # no awaits between the broken check and the enqueue: the
            # turnstile link and the queue position are taken atomically,
            # and the single writer preserves that order on the wire
            if self.broken or self._sock is None:
                raise ConnectionError("pipelined connection broken")
            self._ensure_writer()
            op = _SendOp(self._request_bytes("GET", start, end),
                         self._tail, progress)
            prior = op.prior
            self._tail = my_done
            self._sendq.put_nowait(op)
            pipelined, t_send = False, 0.0       # filled in by the writer
        else:
            async with self._wlock:
                if self.broken or self._sock is None:
                    raise ConnectionError("pipelined connection broken")
                prior = self._tail
                self._tail = my_done
                pipelined = prior is not None and not prior.is_set()
                t_send = time.monotonic()
                if progress is not None and len(progress) > 1:
                    # wire-send stamp for the hedging layer: a range
                    # starts aging only once its request is on the wire
                    progress[1] = t_send
                try:
                    await asyncio.get_running_loop().sock_sendall(
                        self._sock, self._request_bytes("GET", start, end))
                except BaseException:
                    self.broken = True
                    my_done.set()
                    raise
        try:
            if op is not None:
                # request on the wire (or the connection died first —
                # every queued-unsent request fails here exactly once)
                await op.fut
                pipelined, t_send = op.pipelined, op.t_send
            if prior is not None:
                await prior.wait()
            if self.broken:
                raise ConnectionError("pipelined predecessor failed")
            t_ready = time.monotonic()
            code, headers = await self._read_headers()
            if not pipelined:
                # idle-pipe turnaround = request RTT + server think time
                self._rtt_samples.append(time.monotonic() - t_send)
            if code not in (200, 206):
                raise ConnectionError(f"HTTP {code}")
            try:
                n = int(headers["content-length"])
            except (KeyError, ValueError):
                raise ConnectionError("missing/invalid Content-Length")
            enc_block = codec.parse_encoding(
                headers.get("x-range-encoding"))
            if enc_block is None:
                body = await self._read_body(n, into, progress)
                t_end = time.monotonic()
                wire_n = None
                ndec = n
            else:
                # encoded body: the framed wire payload lands in scratch
                # (progress tracks WIRE bytes — hedge aging sees real
                # landings), then inflates off the event loop into the
                # caller's buffer.  elapsed is stamped before the decode:
                # it measures the wire, and the decode overlaps other
                # lanes' socket reads in the executor anyway.
                lo, hi = self._decoded_span(headers, start, end)
                ndec = hi - lo + 1
                if into is not None and len(into) < ndec:
                    raise ConnectionError(
                        f"decoded body {ndec} B overruns the "
                        f"{len(into)} B destination range")
                wire = await self._read_body(n, None, progress)
                t_end = time.monotonic()
                wire_n = n
                # the socket is past this response: release the read
                # turnstile BEFORE inflating, so the successor lane's
                # header/body reads overlap this lane's decode (the
                # stream stays aligned either way — decode failures
                # mark the conn broken without desyncing it)
                my_done.set()
                if into is not None:
                    await codec.decode_range_async(wire, lo, hi, out=into)
                    body = into[:ndec]
                else:
                    body = await codec.decode_range_async(wire, lo, hi)
            return _RangeReply(
                data=body, nbytes=ndec,
                elapsed=t_end - (t_ready if pipelined else t_send),
                rtt_included=not pipelined,
                crc32=self._parse_checksum(headers),
                wire_nbytes=wire_n)
        except BaseException:
            self.broken = True
            raise
        finally:
            my_done.set()

    @staticmethod
    def _decoded_span(headers: dict, start: int, end: int) -> tuple[int, int]:
        """Decoded [lo, hi] served for an encoded reply — from
        Content-Range (authoritative: the server clamps tails there, in
        decoded coordinates), falling back to the requested span."""
        cr = headers.get("content-range", "")
        if cr.startswith("bytes "):
            span = cr[len("bytes "):].split("/", 1)[0]
            lo_s, _, hi_s = span.partition("-")
            try:
                return int(lo_s), int(hi_s)
            except ValueError:
                pass
        return start, end

    async def head(self) -> tuple[int, dict]:
        """HEAD the replica's path; returns (status, headers).  Not
        pipelined — used once per transfer for size discovery."""
        if self._sock is None:
            await self.connect()
        await asyncio.get_running_loop().sock_sendall(
            self._sock, self._request_bytes("HEAD"))
        return await self._read_headers()
