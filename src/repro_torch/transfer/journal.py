"""Append-only resume journal for crash-resumable transfers.

pcircle-style checkpointing adapted to a byte-range transfer: instead of
periodically pickling the whole work queue, every *committed* range appends
one small interval record — ``start nbytes crc32`` — to a plain-text log,
fsync'd every ``sync_interval_bytes`` of payload (the checkpoint interval).
A crashed client replays the journal, re-verifies each journaled range
against the destination (the CRC catches data that never made it to stable
storage even though its record did), and requests only the uncovered
intervals.

File format (one record per line, text, order = commit order)::

    {"magic": "mdtp-journal/1", "total": 8388608, "meta": {...}}
    0 262144 3698431063
    262144 524288 193462913
    ...

The header pins the file size and caller metadata (checkpoint step, path):
a journal whose header does not match the transfer being resumed is
discarded rather than trusted.  A torn tail line (crash mid-append) is
detected by parse failure and truncated away on open.

Records may overlap across crash/retry generations; consumers take the
union of the ranges that verify.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Iterable, Optional

__all__ = [
    "ResumeJournal",
    "claim_interval",
    "merge_intervals",
    "uncovered_intervals",
]

_MAGIC = "mdtp-journal/1"


def merge_intervals(
    intervals: Iterable[tuple[int, int]],
) -> list[tuple[int, int]]:
    """Union of ``(start, length)`` intervals as a sorted disjoint list."""
    spans = sorted((s, s + n) for s, n in intervals if n > 0)
    out: list[tuple[int, int]] = []
    for lo, hi in spans:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return [(lo, hi - lo) for lo, hi in out]


def claim_interval(
    covered: list[tuple[int, int]], start: int, end: int,
) -> list[tuple[int, int]]:
    """Incrementally merge ``[start, end)`` into ``covered`` in place.

    ``covered`` is a sorted disjoint list of ``(start, end)`` half-open
    pairs (NOT ``(start, length)`` — this is the in-memory incremental
    form; :func:`merge_intervals` is the batch form over length pairs).
    Returns the sub-spans of ``[start, end)`` that were *not* already
    covered, i.e. the bytes this claim newly accounts for.  Claiming an
    already-covered span returns ``[]`` and leaves the list unchanged,
    which makes double commits idempotent for every consumer — the
    resume journal, the streaming-restore sink, and the peer-mirror
    advertisement all share this one implementation.
    """
    if end <= start:
        return []
    lo = bisect.bisect_left(covered, (start,)) - 1
    if lo >= 0 and covered[lo][1] >= start:
        first = lo
    else:
        first = lo + 1
    new: list[tuple[int, int]] = []
    pos = start
    last = first
    while last < len(covered) and covered[last][0] <= end:
        s, e = covered[last]
        if s > pos:
            new.append((pos, s))
        pos = max(pos, e)
        last += 1
    if pos < end:
        new.append((pos, end))
    if new:
        merged_s = min(start, covered[first][0]) if first < last else start
        merged_e = max(end, covered[last - 1][1]) if first < last else end
        covered[first:last] = [(merged_s, merged_e)]
    return new


def uncovered_intervals(
    covered: Iterable[tuple[int, int]], total: int,
) -> list[tuple[int, int]]:
    """Complement of ``covered`` (disjoint, sorted) within ``[0, total)``."""
    out: list[tuple[int, int]] = []
    pos = 0
    for s, n in covered:
        if s > pos:
            out.append((pos, s - pos))
        pos = max(pos, s + n)
    if pos < total:
        out.append((pos, total - pos))
    return out


class ResumeJournal:
    """One transfer's append-only interval log.

    Use :meth:`open` — it validates an existing journal's header against
    the transfer's identity (total size + caller metadata) and either
    resumes appending after the last well-formed record or starts fresh.
    """

    def __init__(
        self,
        path: str,
        total_bytes: int,
        meta: Optional[dict] = None,
        sync_interval_bytes: int = 8 * 1024 * 1024,
    ):
        self.path = path
        self.total_bytes = int(total_bytes)
        self.meta = dict(meta or {})
        self.sync_interval_bytes = int(sync_interval_bytes)
        self._records: list[tuple[int, int, Optional[int]]] = []
        self._file = None
        self._unsynced = 0

    # -- construction -----------------------------------------------------

    @classmethod
    def open(
        cls,
        path: str,
        total_bytes: int,
        meta: Optional[dict] = None,
        sync_interval_bytes: int = 8 * 1024 * 1024,
    ) -> "ResumeJournal":
        """Open for append, replaying prior records if the header matches.

        A missing file, a header mismatch (different size / metadata ⇒ a
        different transfer), or an unreadable header all start a fresh
        journal; a torn tail line is truncated off so later appends stay
        parseable.
        """
        jr = cls(path, total_bytes, meta, sync_interval_bytes)
        good_end = jr._load()
        if good_end is None:
            jr._file = open(path, "w", encoding="ascii")
            jr._file.write(json.dumps(
                {"magic": _MAGIC, "total": jr.total_bytes, "meta": jr.meta},
                sort_keys=True) + "\n")
            jr._file.flush()
            os.fsync(jr._file.fileno())
        else:
            f = open(path, "r+", encoding="ascii")
            f.truncate(good_end)
            f.seek(good_end)
            jr._file = f
        return jr

    def _load(self) -> Optional[int]:
        """Parse an existing journal; returns the byte offset just past the
        last well-formed line, or None if the journal is absent/foreign."""
        try:
            with open(self.path, "r", encoding="ascii") as f:
                raw = f.read()
        except (OSError, UnicodeDecodeError):
            return None
        # a record is only committed once its newline hits the file: the
        # final split element is either "" (clean tail) or a torn append
        # — torn lines can PARSE (a number cut short is still a number,
        # a lost CRC field looks like a crc-less record) so termination,
        # not parseability, is the validity test
        lines = raw.split("\n")
        if len(lines) < 2:
            return None
        try:
            header = json.loads(lines[0])
        except (json.JSONDecodeError, ValueError):
            return None
        if (header.get("magic") != _MAGIC
                or header.get("total") != self.total_bytes
                or header.get("meta") != self.meta):
            return None
        good_end = len(lines[0]) + 1
        for line in lines[1:-1]:
            if not line:
                break
            parts = line.split()
            try:
                start, nbytes = int(parts[0]), int(parts[1])
                crc = int(parts[2]) if len(parts) > 2 else None
                if crc is not None and not (0 <= crc < 2 ** 32):
                    break
            except (ValueError, IndexError):
                break
            if start < 0 or nbytes <= 0 or start + nbytes > self.total_bytes:
                break
            self._records.append((start, nbytes, crc))
            good_end += len(line) + 1
        return good_end

    # -- appending --------------------------------------------------------

    def record(self, start: int, nbytes: int, crc: Optional[int] = None) -> None:
        """Append one committed interval; fsyncs every checkpoint interval."""
        if self._file is None:
            raise ValueError("journal is closed")
        if crc is None:
            self._file.write(f"{start} {nbytes}\n")
        else:
            self._file.write(f"{start} {nbytes} {crc}\n")
        self._records.append((start, nbytes, crc))
        self._unsynced += nbytes
        if self._unsynced >= self.sync_interval_bytes:
            self.sync()

    def sync(self) -> None:
        """Flush + fsync pending records (cheap: the log is tiny)."""
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._unsynced = 0

    # -- reading ----------------------------------------------------------

    def records(self) -> list[tuple[int, int, Optional[int]]]:
        """All records (replayed + appended), in append order."""
        return list(self._records)

    def covered(self) -> list[tuple[int, int]]:
        """Union of all journaled intervals (no CRC verification — callers
        with a readable destination should verify per record instead)."""
        return merge_intervals((s, n) for s, n, _ in self._records)

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        if self._file is not None:
            self.sync()
            self._file.close()
            self._file = None

    def complete(self) -> None:
        """The transfer finished: the journal has no future value."""
        self.close()
        try:
            os.remove(self.path)
        except OSError:
            pass

    def __enter__(self) -> "ResumeJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
