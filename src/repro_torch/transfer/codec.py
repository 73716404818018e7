"""Block-compressed range framing for the MDTP dataplane.

The compressed-range path moves fewer bytes for the same data: the
server holds a blob as fixed-size DECODED blocks (the last one short),
each deflated independently with zlib, and a range response's body is
the framed sequence of whole blocks covering the requested decoded
span.  Responses carry ``X-Range-Encoding: zblock; block=<B>`` so the
client knows to decode; range semantics stay byte-addressable in
decoded coordinates throughout — ``Range``/``Content-Range``, the
checksum header and the scheduler's coverage accounting all speak
decoded offsets, and only ``Content-Length`` (plus bandwidth
telemetry) is the framed *wire* length.

Frame layout (16-byte big-endian header, one frame per block)::

    +---------------+-------------+----------+------------------+
    | decoded_start | decoded_len | comp_len |  zlib payload    |
    |      u64      |     u32     |   u32    |  comp_len bytes  |
    +---------------+-------------+----------+------------------+

Blocks compress independently, so a client trims the head and tail
frames to the requested span without touching the rest of the blob.

Everything here is synchronous and pure; :func:`decode_range_async` is
the event-loop adapter — small payloads decode inline (the executor
round-trip costs more than the inflate), large ones in the default
executor where zlib releases the GIL, so decode overlaps the next
body's socket reads and the sink's device transfers.
"""

from __future__ import annotations

import asyncio
import struct
import zlib
from typing import Optional

from repro_torch.transfer.sched import defaults as sched_defaults

__all__ = ["BlockStore", "CodecError", "DEFAULT_BLOCK", "ENCODING",
           "compress_blocks", "decode_range", "decode_range_into",
           "decode_range_async", "encoding_header", "parse_encoding"]

#: default decoded block size.  Big enough that zlib's per-call overhead
#: and the 16 B frame header are noise, small enough that a head/tail
#: trim never inflates much more than it needs.
DEFAULT_BLOCK = 256 * 1024

#: codec name carried in ``X-Range-Encoding``.
ENCODING = "zblock"

#: payloads at or below this size inflate inline on the event loop;
#: larger ones go to the executor (same split as the CRC path).
_INLINE_MAX = sched_defaults.CRC_INLINE_MAX

_FRAME = struct.Struct(">QII")


class CodecError(ConnectionError):
    """Malformed or short frame stream.  A ``ConnectionError`` subclass
    on purpose: the transport's failure handling already re-pools the
    range and retires the connection on ConnectionError, and a framing
    error means the stream can't be trusted any more than a torn one."""


def encoding_header(block_size: int) -> str:
    """Value for ``X-Range-Encoding``."""
    return f"{ENCODING}; block={int(block_size)}"


def parse_encoding(value: Optional[str]) -> Optional[int]:
    """Block size from an ``X-Range-Encoding`` value, None when the
    header is absent or names a codec this module doesn't speak."""
    if not value:
        return None
    name, _, rest = value.partition(";")
    if name.strip().lower() != ENCODING:
        return None
    for part in rest.split(";"):
        k, _, v = part.partition("=")
        if k.strip().lower() == "block":
            try:
                return int(v.strip())
            except ValueError:
                return None
    return None


class BlockStore:
    """An immutable block-compressed blob: per-block frames ready to
    concatenate into response bodies (no per-request compression)."""

    __slots__ = ("block_size", "total", "_frames")

    def __init__(self, block_size: int, total: int, frames: list):
        self.block_size = int(block_size)
        self.total = int(total)
        self._frames = frames

    @property
    def wire_total(self) -> int:
        """Framed size of the whole blob (the wire bytes a full GET
        moves) — ``wire_total / total`` is the achieved ratio."""
        return sum(len(f) for f in self._frames)

    def _span(self, lo: int, hi: int) -> tuple[int, int]:
        if not (0 <= lo <= hi < self.total):
            raise ValueError(f"range [{lo}, {hi}] outside blob "
                             f"of {self.total} B")
        return lo // self.block_size, hi // self.block_size

    def encode_range(self, lo: int, hi: int) -> bytes:
        """Framed body covering decoded ``[lo, hi]`` inclusive — whole
        blocks, so the body may decode to a superset of the request."""
        b0, b1 = self._span(lo, hi)
        return b"".join(self._frames[b0:b1 + 1])

    def wire_length(self, lo: int, hi: int) -> int:
        """Length of :meth:`encode_range` without building the body."""
        b0, b1 = self._span(lo, hi)
        return sum(len(f) for f in self._frames[b0:b1 + 1])


def compress_blocks(data, block_size: int = DEFAULT_BLOCK) -> BlockStore:
    """Deflate ``data`` into independent fixed-size blocks."""
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    view = memoryview(data)
    frames = []
    for start in range(0, len(view), block_size):
        raw = view[start:start + block_size]
        comp = zlib.compress(bytes(raw))
        frames.append(_FRAME.pack(start, len(raw), len(comp)) + comp)
    return BlockStore(block_size, len(view), frames)


def _iter_frames(payload):
    view = memoryview(payload)
    off = 0
    while off < len(view):
        if off + _FRAME.size > len(view):
            raise CodecError(f"torn frame header at byte {off}")
        dstart, dlen, clen = _FRAME.unpack_from(view, off)
        off += _FRAME.size
        if off + clen > len(view):
            raise CodecError(f"torn frame payload at byte {off}")
        yield dstart, dlen, view[off:off + clen]
        off += clen


def decode_range_into(payload, lo: int, hi: int, out) -> int:
    """Inflate a framed body into ``out``, keeping only decoded bytes
    ``[lo, hi]`` inclusive (head/tail blocks are trimmed).  Frames must
    arrive in order and cover the span contiguously — a gap or a short
    block raises :class:`CodecError`.  Returns the byte count written
    (``hi - lo + 1``)."""
    need = hi - lo + 1
    if len(out) < need:
        raise CodecError(f"decoded range {need} B overruns the "
                         f"{len(out)} B destination")
    cursor = lo                      # next decoded offset still owed
    for dstart, dlen, comp in _iter_frames(payload):
        try:
            block = zlib.decompress(comp)
        except zlib.error as e:
            raise CodecError(f"inflate failed at decoded offset "
                             f"{dstart}: {e}") from None
        if len(block) != dlen:
            raise CodecError(f"block at {dstart} decoded to "
                             f"{len(block)} B, header said {dlen} B")
        dend = dstart + dlen
        if dstart > cursor:
            raise CodecError(f"frame gap: owed decoded offset {cursor}, "
                             f"next frame starts at {dstart}")
        if dend <= cursor:
            continue
        take_hi = min(dend, hi + 1)
        out[cursor - lo:take_hi - lo] = block[cursor - dstart:
                                              take_hi - dstart]
        cursor = take_hi
        if cursor > hi:
            break
    if cursor <= hi:
        raise CodecError(f"frame stream ended at decoded offset "
                         f"{cursor}, range runs to {hi}")
    return need


def decode_range(payload, lo: int, hi: int) -> bytes:
    """:func:`decode_range_into` with a fresh buffer."""
    out = bytearray(hi - lo + 1)
    decode_range_into(payload, lo, hi, memoryview(out))
    return bytes(out)


async def decode_range_async(payload, lo: int, hi: int,
                             out: Optional[memoryview] = None):
    """Decode off the event loop for large payloads.  With ``out``,
    writes into it and returns the decoded byte count; without, returns
    fresh ``bytes``."""
    if len(payload) <= _INLINE_MAX:
        if out is not None:
            return decode_range_into(payload, lo, hi, out)
        return decode_range(payload, lo, hi)
    loop = asyncio.get_running_loop()
    if out is not None:
        return await loop.run_in_executor(
            None, decode_range_into, payload, lo, hi, out)
    return await loop.run_in_executor(None, decode_range, payload, lo, hi)
