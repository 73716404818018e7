"""Threaded HTTP/1.1 range server (no external deps).

Serves files (or in-memory blobs) with:
  * ``Range: bytes=a-b`` support (206 Partial Content) — the substrate MDTP
    requests ride on, served as ``memoryview`` windows over the registered
    blob (no per-range or per-throttle-piece body copies),
  * persistent connections (keep-alive) — the paper's one-session-per-server
    requirement,
  * optional per-connection bandwidth throttling and response latency, so
    integration tests can reproduce heterogeneous replicas on localhost,
  * an ``X-Range-Checksum`` CRC32 trailer-in-header so clients can verify
    every range end-to-end, and
  * an optional :class:`FaultPolicy` that injects bit-flips, truncations,
    stalls, garbage headers and connection resets — the chaos harness the
    robustness tests and benchmarks drive.

This is the replica-store stand-in for the data pipeline and the
checkpoint mirror in tests/examples.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import zlib
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.transfer import codec

__all__ = ["RangeServer", "Throttle", "FaultPolicy"]


@dataclass
class Throttle:
    bytes_per_s: float = 0.0      # 0 = unthrottled
    latency_s: float = 0.0        # added before each response
    chunk: int = 64 * 1024
    #: True = token-bucket pacing on bytes alone: every ``chunk`` written
    #: buys an unconditional ``chunk / bytes_per_s`` sleep, never reduced
    #: by measured elapsed time.  The default (False) compensates for
    #: wall-clock already spent, which keeps the NET rate at the target on
    #: an idle box but lets a loaded box erase the sleeps entirely —
    #: exactly the regime where two mirrors' relative rates invert and
    #: throughput-proportionality tests flake.  Deterministic pacing makes
    #: each mirror's service time >= bytes / rate regardless of load, so
    #: rate *ratios* between mirrors are schedule-independent (host load
    #: can only add the same additive overhead to both sides).
    deterministic: bool = False
    #: True = ``bytes_per_s`` bounds the SERVER's aggregate egress, not
    #: each connection's.  Per-connection pacing (the default) gives N
    #: concurrent clients N× the rate — fine for modelling per-path
    #: bottlenecks, but a broadcast origin's uplink is a shared pipe:
    #: with ``shared=True`` every handler thread reserves its piece's
    #: wire time on one server-wide clock (deterministic token bucket,
    #: implies the ``deterministic`` guarantees), so N clients split the
    #: rate instead of multiplying it.
    shared: bool = False


@dataclass
class FaultPolicy:
    """Probabilistic per-range fault injection for chaos testing.

    Each GET draws independently from a seeded RNG shared by all handler
    threads, so a fixed seed gives a reproducible fault *sequence* for a
    deterministic request order (and a reproducible fault *rate* always).
    At most one fault fires per request; precedence when several rates are
    set: reset > garbage > truncate > stall > corrupt.

    The checksum header is always computed over the pristine bytes, so a
    bit-flipped body is detectable by the client — that is the point.
    """

    corrupt_rate: float = 0.0    #: flip bytes in the body (headers intact)
    truncate_rate: float = 0.0   #: full Content-Length, short body, sever
    stall_rate: float = 0.0      #: sleep ``stall_s`` mid-body
    garbage_rate: float = 0.0    #: malformed status line, then sever
    reset_rate: float = 0.0      #: sever the connection before responding
    stall_s: float = 5.0
    seed: int = 0


def _format_ranges(intervals) -> str:
    """``X-Available-Ranges`` wire form: comma-joined inclusive
    ``lo-hi`` pairs (Range-header syntax), empty when nothing is
    covered yet."""
    return ",".join(f"{s}-{s + n - 1}" for s, n in intervals if n > 0)


def _covers(intervals, lo: int, hi: int) -> bool:
    """True when ``[lo, hi]`` (inclusive) lies inside one covered
    interval — ``intervals`` is sorted disjoint ``(start, nbytes)``."""
    for s, n in intervals:
        if s <= lo and hi < s + n:
            return True
        if s > lo:
            break
    return False


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-range/1.0"

    def log_message(self, *a):   # silence
        pass

    def setup(self):
        super().setup()
        with self.server.gauge_lock:          # type: ignore[attr-defined]
            self.server.open_conns.add(       # type: ignore[attr-defined]
                self.connection)

    def finish(self):
        with self.server.gauge_lock:          # type: ignore[attr-defined]
            self.server.open_conns.discard(   # type: ignore[attr-defined]
                self.connection)
        super().finish()

    def _lookup(self):
        """Resolve the request path: ``(buffer, total, covered_fn)``.
        ``covered_fn`` is None for ordinary (fully-present) blobs; for
        partial mirrors it returns the currently covered ``(start,
        nbytes)`` intervals (the mirrored sink's live accounting)."""
        blob = self.server.blobs.get(self.path)  # type: ignore[attr-defined]
        if blob is not None:
            return blob, len(blob), None
        part = self.server.partials.get(          # type: ignore[attr-defined]
            self.path)
        if part is not None:
            return part
        return None

    def do_HEAD(self):
        centry = self.server.compressed.get(  # type: ignore[attr-defined]
            self.path)
        if centry is not None:
            # size discovery speaks DECODED bytes: the store's framing is
            # a transfer encoding, invisible to coverage planning
            self.send_response(200)
            self.send_header("Content-Length", str(centry[0].total))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()
            return
        entry = self._lookup()
        if entry is None:
            self.send_error(404)
            return
        _buf, total, covered_fn = entry
        self.send_response(200)
        self.send_header("Content-Length", str(total))
        self.send_header("Accept-Ranges", "bytes")
        if covered_fn is not None:
            # the interval query: a HEAD doubles as "what do you have?"
            self.send_header("X-Available-Ranges",
                             _format_ranges(covered_fn()))
        self.end_headers()

    def do_GET(self):
        srv = self.server
        with srv.gauge_lock:                      # type: ignore[attr-defined]
            srv.concurrent += 1                   # type: ignore[attr-defined]
            srv.peak_concurrent = max(            # type: ignore[attr-defined]
                srv.peak_concurrent, srv.concurrent)
        self._gauge_held = True
        try:
            self._serve_get()
        except (BrokenPipeError, ConnectionResetError):
            # the client gave up mid-body (stall timeout, kill) — the
            # handler thread must not die noisily for that
            self.close_connection = True
        finally:
            self._gauge_release()

    def _gauge_release(self) -> None:
        """Close this request's concurrency-gauge window (idempotent).

        Called just BEFORE the final body write, not when the handler
        unwinds: the moment the last byte is handed to the kernel the
        client can read it, release its in-flight slot, and race its
        next request onto the wire — while this thread waits on the GIL
        to run its bookkeeping.  Anything left on this side of that
        write registers as request overlap the client never created.
        The throttle pays service time in sleeps before each write, so
        the gauge window still spans the full paced service (the
        per-replica in-flight cap witness measures SERVICE overlap,
        not handler-thread lifetime)."""
        if getattr(self, "_gauge_held", False):
            self._gauge_held = False
            with self.server.gauge_lock:          # type: ignore[attr-defined]
                self.server.concurrent -= 1       # type: ignore[attr-defined]

    def _draw_fault(self) -> Optional[str]:
        faults: Optional[FaultPolicy] = (
            self.server.faults)                   # type: ignore[attr-defined]
        if faults is None:
            return None
        with self.server.fault_lock:              # type: ignore[attr-defined]
            rng: random.Random = (
                self.server.fault_rng)            # type: ignore[attr-defined]
            for kind, rate in (
                ("reset", faults.reset_rate),
                ("garbage", faults.garbage_rate),
                ("truncate", faults.truncate_rate),
                ("stall", faults.stall_rate),
                ("corrupt", faults.corrupt_rate),
            ):
                if rate > 0.0 and rng.random() < rate:
                    counts = (
                        self.server.fault_counts)  # type: ignore[attr-defined]
                    counts[kind] = counts.get(kind, 0) + 1
                    return kind
        return None

    def _sever(self) -> None:
        """Abruptly cut the TCP stream (the reset/garbage/truncate tail)."""
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _account(self, n: int) -> None:
        with self.server.gauge_lock:              # type: ignore[attr-defined]
            self.server.served_bytes += n         # type: ignore[attr-defined]

    def _refuse_uncovered(self, covered_fn) -> None:
        """416 for a range the mirror does not (yet) hold, advertising
        what it DOES hold so the client can re-plan without a HEAD.  A
        plain keep-alive response — coverage only grows, so the same
        connection is worth retrying on."""
        self.send_response(416)
        self.send_header("Content-Length", "0")
        self.send_header("X-Available-Ranges",
                         _format_ranges(covered_fn()))
        self.end_headers()

    def _serve_get(self):
        centry = self.server.compressed.get(  # type: ignore[attr-defined]
            self.path)
        if centry is not None:
            self._serve_compressed(centry)
            return
        entry = self._lookup()
        if entry is None:
            self.send_error(404)
            return
        blob, total, covered_fn = entry
        throttle: Throttle = self.server.throttle  # type: ignore[attr-defined]
        if throttle.latency_s > 0:
            time.sleep(throttle.latency_s)
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            try:
                lo_s, hi_s = rng[len("bytes="):].split("-", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else total - 1
            except ValueError:
                self.send_error(416)
                return
            hi = min(hi, total - 1)
            if lo > hi:
                self.send_error(416)
                return
            if covered_fn is not None and not _covers(covered_fn(), lo, hi):
                self._refuse_uncovered(covered_fn)
                return
            # memoryview slice: no per-range body copy — ranges (and the
            # throttle pieces below) are windows over the registered blob.
            # For partial mirrors the slice is safe under the concurrent
            # restore: covered bytes are committed-immutable, and the
            # coverage check above pinned this range inside them.
            body = memoryview(blob)[lo:hi + 1]
            status = 206
            content_range = f"bytes {lo}-{hi}/{total}"
        else:
            if covered_fn is not None and not _covers(
                    covered_fn(), 0, total - 1):
                self._refuse_uncovered(covered_fn)
                return
            body = memoryview(blob)[:total]
            status = 200
            content_range = None

        fault = self._draw_fault()
        if fault == "reset":
            self._sever()
            return
        if fault == "garbage":
            try:
                self.wfile.write(b"HTTX/9.9 000 NOT-HTTP\r\n\r\n")
                self.wfile.flush()
            except OSError:
                pass
            self._sever()
            return

        # checksum of the PRISTINE range — computed before any corruption
        # is applied, so a flipped bit downstream is detectable
        crc = (zlib.crc32(body)
               if self.server.checksums else None)  # type: ignore[attr-defined]

        truncate_at = None
        if fault == "truncate":
            # correct headers, short body: the worst kind of short read
            truncate_at = max(1, len(body) // 2)
        stall_at = None
        if fault == "stall":
            stall_at = len(body) // 2
        if fault == "corrupt":
            faults: FaultPolicy = (
                self.server.faults)               # type: ignore[attr-defined]
            corrupted = bytearray(body)
            with self.server.fault_lock:          # type: ignore[attr-defined]
                frng: random.Random = (
                    self.server.fault_rng)        # type: ignore[attr-defined]
                nflips = max(1, len(corrupted) // (256 * 1024))
                for _ in range(nflips):
                    corrupted[frng.randrange(len(corrupted))] ^= 0xFF
            body = memoryview(bytes(corrupted))

        self.send_response(status)
        if content_range is not None:
            self.send_header("Content-Range", content_range)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Accept-Ranges", "bytes")
        if crc is not None:
            self.send_header("X-Range-Checksum", f"crc32:{crc:08x}")
        self.end_headers()

        limit = truncate_at if truncate_at is not None else len(body)
        if throttle.bytes_per_s > 0:
            sent = 0
            t0 = time.monotonic()
            while sent < limit:
                piece = body[sent:min(sent + throttle.chunk, limit)]
                if stall_at is not None and sent >= stall_at:
                    time.sleep(self.server.faults.stall_s)  # type: ignore
                    stall_at = None
                if throttle.shared:
                    # server-wide token bucket: reserve this piece's wire
                    # time on the shared egress clock, then sleep until
                    # the reservation matures.  N concurrent connections
                    # thereby SPLIT ``bytes_per_s`` (each piece queues
                    # behind every previously reserved piece) instead of
                    # each enjoying it — a broadcast origin's fixed
                    # uplink.  Deterministic by construction: total
                    # service time >= bytes / rate regardless of load.
                    srv = self.server
                    with srv.shared_lock:     # type: ignore[attr-defined]
                        now = time.monotonic()
                        due = max(
                            srv.shared_free,  # type: ignore[attr-defined]
                            now) + len(piece) / throttle.bytes_per_s
                        srv.shared_free = due  # type: ignore[attr-defined]
                    wait = due - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                elif throttle.deterministic:
                    # bytes-only token bucket: every piece pays its wire
                    # time up front, unconditionally — host load cannot
                    # erase the pacing.  Sleeping BEFORE the write means
                    # the requester sees the last byte only after the
                    # full paced duration (and the handler exits the
                    # moment it lands, keeping the concurrency gauge
                    # honest).
                    time.sleep(len(piece) / throttle.bytes_per_s)
                if sent + len(piece) >= limit:
                    self._gauge_release()
                self.wfile.write(piece)
                sent += len(piece)
                self._account(len(piece))
                if not (throttle.deterministic or throttle.shared):
                    target = sent / throttle.bytes_per_s
                    sleep = target - (time.monotonic() - t0)
                    if sleep > 0:
                        time.sleep(sleep)
        else:
            if stall_at is not None and stall_at > 0:
                self.wfile.write(body[:stall_at])
                self._account(stall_at)
                time.sleep(self.server.faults.stall_s)  # type: ignore
                self._gauge_release()
                self.wfile.write(body[stall_at:limit])
                self._account(limit - stall_at)
            else:
                if stall_at is not None:
                    time.sleep(self.server.faults.stall_s)  # type: ignore
                self._gauge_release()
                self.wfile.write(body[:limit])
                self._account(limit)
        if truncate_at is not None:
            self._sever()

    def _serve_compressed(self, centry) -> None:
        """Serve a range from a block-compressed store.

        The request and every byte-addressed header (``Range``,
        ``Content-Range``, the checksum) speak DECODED coordinates; the
        body is the framed compressed payload covering the span (whole
        blocks — see :mod:`repro_torch.transfer.codec`) and ``Content-Length``
        is its WIRE length.  The checksum covers the pristine decoded
        range, so the client verifies integrity post-inflate — end to
        end across the codec.  Throttling and the served-bytes gauge
        meter wire bytes: a compressed store on a throttled uplink is
        exactly how compression buys goodput.  The chaos matrix
        (``FaultPolicy``) exercises the identity path; no faults are
        injected here."""
        store, raw = centry
        throttle: Throttle = self.server.throttle  # type: ignore[attr-defined]
        if throttle.latency_s > 0:
            time.sleep(throttle.latency_s)
        total = store.total
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            try:
                lo_s, hi_s = rng[len("bytes="):].split("-", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else total - 1
            except ValueError:
                self.send_error(416)
                return
            hi = min(hi, total - 1)
            if lo > hi:
                self.send_error(416)
                return
            status = 206
            content_range = f"bytes {lo}-{hi}/{total}"
        else:
            lo, hi = 0, total - 1
            status = 200
            content_range = None
        body = memoryview(store.encode_range(lo, hi))
        crc = (zlib.crc32(memoryview(raw)[lo:hi + 1])
               if self.server.checksums else None)  # type: ignore[attr-defined]
        self.send_response(status)
        if content_range is not None:
            self.send_header("Content-Range", content_range)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("X-Range-Encoding",
                         codec.encoding_header(store.block_size))
        if crc is not None:
            self.send_header("X-Range-Checksum", f"crc32:{crc:08x}")
        self.end_headers()
        self._write_paced(body)

    def _write_paced(self, body) -> None:
        """Throttled write of one fault-free body — the same pacing
        modes as the identity path (compensating, deterministic
        token-bucket, shared egress clock), metering wire bytes."""
        throttle: Throttle = self.server.throttle  # type: ignore[attr-defined]
        limit = len(body)
        if throttle.bytes_per_s <= 0:
            self._gauge_release()
            self.wfile.write(body)
            self._account(limit)
            return
        sent = 0
        t0 = time.monotonic()
        while sent < limit:
            piece = body[sent:min(sent + throttle.chunk, limit)]
            if throttle.shared:
                srv = self.server
                with srv.shared_lock:     # type: ignore[attr-defined]
                    now = time.monotonic()
                    due = max(
                        srv.shared_free,  # type: ignore[attr-defined]
                        now) + len(piece) / throttle.bytes_per_s
                    srv.shared_free = due  # type: ignore[attr-defined]
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            elif throttle.deterministic:
                time.sleep(len(piece) / throttle.bytes_per_s)
            if sent + len(piece) >= limit:
                self._gauge_release()
            self.wfile.write(piece)
            sent += len(piece)
            self._account(len(piece))
            if not (throttle.deterministic or throttle.shared):
                target = sent / throttle.bytes_per_s
                sleep = target - (time.monotonic() - t0)
                if sleep > 0:
                    time.sleep(sleep)


class RangeServer:
    """In-process replica server.  Register blobs or files by path."""

    def __init__(
        self,
        throttle: Optional[Throttle] = None,
        faults: Optional[FaultPolicy] = None,
        checksums: bool = True,
    ):
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._srv.blobs = {}                      # type: ignore[attr-defined]
        #: path -> (buffer, total, covered_fn): partial mirrors (see
        #: ``add_partial``)
        self._srv.partials = {}                   # type: ignore[attr-defined]
        #: path -> (BlockStore, raw): block-compressed blobs (see
        #: ``add_compressed_blob``)
        self._srv.compressed = {}                 # type: ignore[attr-defined]
        self._srv.throttle = throttle or Throttle()  # type: ignore[attr-defined]
        self._srv.shared_lock = threading.Lock()  # type: ignore[attr-defined]
        #: shared-egress reservation clock (``Throttle.shared``): the
        #: monotonic instant the server's uplink is next free.
        self._srv.shared_free = 0.0               # type: ignore[attr-defined]
        self._srv.checksums = checksums           # type: ignore[attr-defined]
        self._srv.faults = faults                 # type: ignore[attr-defined]
        self._srv.fault_rng = random.Random(      # type: ignore[attr-defined]
            faults.seed if faults else 0)
        self._srv.fault_lock = threading.Lock()   # type: ignore[attr-defined]
        self._srv.fault_counts = {}               # type: ignore[attr-defined]
        self._srv.gauge_lock = threading.Lock()   # type: ignore[attr-defined]
        self._srv.concurrent = 0                  # type: ignore[attr-defined]
        self._srv.peak_concurrent = 0             # type: ignore[attr-defined]
        self._srv.served_bytes = 0                # type: ignore[attr-defined]
        self._srv.open_conns = set()              # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def peak_concurrent_requests(self) -> int:
        """High-water mark of simultaneously in-flight GETs — the
        server-side witness for per-replica in-flight-cap tests."""
        return self._srv.peak_concurrent          # type: ignore[attr-defined]

    @property
    def served_bytes(self) -> int:
        """Body bytes actually written to clients (post-truncation) —
        the served-byte accounting resume tests rely on."""
        return self._srv.served_bytes             # type: ignore[attr-defined]

    @property
    def fault_counts(self) -> dict:
        """How many faults of each kind have fired (by name)."""
        return dict(self._srv.fault_counts)       # type: ignore[attr-defined]

    @property
    def address(self) -> tuple[str, int]:
        return ("127.0.0.1", self.port)

    def set_faults(self, faults: Optional[FaultPolicy]) -> None:
        """Swap the fault policy at runtime (None disables injection);
        the RNG is reseeded so a fresh policy starts a fresh sequence."""
        self._srv.faults = faults                 # type: ignore[attr-defined]
        self._srv.fault_rng = random.Random(      # type: ignore[attr-defined]
            faults.seed if faults else 0)

    def set_throttle(self, throttle: Optional[Throttle]) -> None:
        """Swap the throttle at runtime (None = unthrottled) — the real-
        socket mirror of ``ServerSpec.degrade_at``: each handler snapshots
        the throttle per request, so an in-flight range finishes at the
        old rate and every SUBSEQUENT range is served at the new one
        (gray degradation, connection never breaks)."""
        self._srv.throttle = throttle or Throttle()  # type: ignore[attr-defined]

    def add_blob(self, path: str, data: bytes) -> None:
        if not path.startswith("/"):
            path = "/" + path
        self._srv.blobs[path] = data              # type: ignore[attr-defined]

    def add_partial(self, path: str, buffer, covered, total=None) -> None:
        """Mount a partially-populated ``buffer`` as a read-only mirror.

        ``covered`` is a zero-arg callable returning the currently
        covered ``(start, nbytes)`` intervals (sorted, disjoint — e.g. a
        the restore sink's ``covered_intervals``).  HEADs
        advertise the live coverage via ``X-Available-Ranges``; a GET
        for bytes outside it is refused with 416 (carrying the same
        header) rather than served short.  The buffer may still be
        filling: committed bytes must be immutable, which is exactly the
        transfer sinks' write-once contract.
        """
        if not path.startswith("/"):
            path = "/" + path
        total = len(buffer) if total is None else int(total)
        self._srv.partials[path] = (              # type: ignore[attr-defined]
            buffer, total, covered)

    def add_compressed_blob(self, path: str, data: bytes,
                            block_size: int = codec.DEFAULT_BLOCK) -> None:
        """Register ``data`` served from a block-compressed store: GETs
        answer decoded-coordinate ranges with framed compressed bodies
        (``X-Range-Encoding``) — fewer wire bytes for the same data.
        The pristine blob is kept alongside for checksums; compression
        happens once, here, not per request."""
        if not path.startswith("/"):
            path = "/" + path
        self._srv.compressed[path] = (            # type: ignore[attr-defined]
            codec.compress_blocks(data, block_size), data)

    def remove_path(self, path: str) -> None:
        """Unregister a blob or partial mirror (subsequent requests
        404).  In-flight handlers finish from their own references."""
        if not path.startswith("/"):
            path = "/" + path
        self._srv.blobs.pop(path, None)           # type: ignore[attr-defined]
        self._srv.partials.pop(path, None)        # type: ignore[attr-defined]
        self._srv.compressed.pop(path, None)      # type: ignore[attr-defined]

    def add_file(self, path: str, filename: str) -> None:
        with open(filename, "rb") as f:
            self.add_blob(path, f.read())

    def add_compressed_file(self, path: str, filename: str,
                            block_size: int = codec.DEFAULT_BLOCK) -> None:
        """``add_file`` into the block-compressed store — how a
        checkpoint mirror serves ``data.bin`` compressed."""
        with open(filename, "rb") as f:
            self.add_compressed_blob(path, f.read(), block_size)

    def start(self) -> "RangeServer":
        self._thread.start()
        return self

    def kill_connections(self) -> None:
        """Forcibly sever every established client connection (the
        streams, not the listener): ``stop()`` only halts the accept
        loop, while handler threads keep serving persistent sessions to
        completion.  Mirror-death tests use this to cut a connection
        with pipelined requests still in flight."""
        with self._srv.gauge_lock:                # type: ignore[attr-defined]
            conns = list(self._srv.open_conns)    # type: ignore[attr-defined]
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
