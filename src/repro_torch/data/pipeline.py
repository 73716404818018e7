"""Training-data pipeline: deterministic sampling + MDTP multi-source fetch.

Layout: a dataset is a flat token stream packed into ``tokens.bin``
(uint32) plus ``index.json`` ({"n_tokens": N}).  The stream is replicated
on R mirror stores.  Global batch for step ``s`` is rows
``[(s*B + i) * S, ... + S + 1)`` (wrap-around) — a pure function of the
step, so:

* resume-after-failure needs NO pipeline state (checkpoint stores only the
  step counter),
* every host can compute exactly which byte ranges it needs and fetch them
  from all mirrors at once with MDTP adaptive chunking,
* a slow mirror degrades throughput proportionally instead of stalling the
  step (the paper's §VII-D claim, now as an input pipeline property).

``MultiSourcePipeline`` prefetches ``depth`` steps ahead on a background
thread (transfer hides behind compute — straggler mitigation for the input
plane).

This is the port's own copy of ``repro.data.pipeline``: batches are numpy
arrays on the host, as in the reference; moving them onto the card comes
with the port's training step.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.chunking import ChunkParams
from repro_torch.transfer.client import MDTPClient, Replica

__all__ = ["write_token_dataset", "TokenDatasetSpec", "MultiSourcePipeline",
           "synthetic_tokens"]

_TOKENS = "tokens.bin"
_INDEX = "index.json"
_ITEM = 4  # uint32


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=n_tokens, dtype=np.uint32)


def write_token_dataset(path_prefix, tokens: np.ndarray) -> dict:
    """Returns {name: bytes} blobs for RangeServer mirrors (or write to disk
    by passing a directory path)."""
    blob = tokens.astype(np.uint32).tobytes()
    index = json.dumps({"n_tokens": int(tokens.size)}).encode()
    blobs = {_TOKENS: blob, _INDEX: index}
    if path_prefix is not None:
        import os
        os.makedirs(path_prefix, exist_ok=True)
        for name, data in blobs.items():
            with open(os.path.join(path_prefix, name), "wb") as f:
                f.write(data)
    return blobs


@dataclass(frozen=True)
class TokenDatasetSpec:
    n_tokens: int
    seq_len: int
    global_batch: int

    def ranges_for_step(self, step: int, host: int = 0,
                        n_hosts: int = 1) -> list[tuple[int, int]]:
        """Byte ranges (start, length) of this host's rows at ``step``."""
        B, S = self.global_batch, self.seq_len
        assert B % n_hosts == 0
        rows = range(host * (B // n_hosts), (host + 1) * (B // n_hosts))
        out = []
        for i in rows:
            tok_start = ((step * B + i) * S) % max(self.n_tokens - S - 1, 1)
            out.append((tok_start * _ITEM, (S + 1) * _ITEM))
        return out


class MultiSourcePipeline:
    """Prefetching input pipeline over replicated mirrors.

    Each ``get_batch(step)`` returns tokens [B_host, S+1] uint32 (callers
    slice inputs/labels).  Fetches ride MDTP: the per-step ranges are
    coalesced into one logical transfer split across mirrors by observed
    throughput.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        spec: TokenDatasetSpec,
        host: int = 0,
        n_hosts: int = 1,
        depth: int = 2,
        params: Optional[ChunkParams] = None,
    ):
        self.replicas = [Replica(r.host, r.port,
                                 r.path.rstrip("/") + "/" + _TOKENS)
                         for r in replicas]
        self.spec = spec
        self.host = host
        self.n_hosts = n_hosts
        self.params = params
        self.depth = depth
        self._results: dict[int, np.ndarray] = {}
        self._errors: dict[int, Exception] = {}
        self._lock = threading.Condition()
        self._want = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._next_prefetch = 0

    # ------------------------------------------------------------------
    def _fetch_step(self, step: int) -> np.ndarray:
        ranges = self.spec.ranges_for_step(step, self.host, self.n_hosts)
        B_host = len(ranges)
        S1 = self.spec.seq_len + 1
        out = np.empty((B_host, S1), np.uint32)

        async def run():
            # Coalesce the step's rows into one MDTP transfer: a virtual
            # blob of concatenated row-ranges, written through a sink that
            # scatters into the batch array.
            total = sum(l for _, l in ranges)
            row_starts = np.cumsum([0] + [l for _, l in ranges])

            # map virtual offset -> (row, within)
            def sink(voff: int, data: bytes):
                pos = voff
                dview = memoryview(data)
                while dview:
                    row = int(np.searchsorted(row_starts, pos, "right") - 1)
                    within = pos - row_starts[row]
                    take = min(len(dview), int(row_starts[row + 1] - pos))
                    raw = out[row].view(np.uint8)
                    raw[within:within + take] = np.frombuffer(
                        dview[:take], np.uint8)
                    pos += take
                    dview = dview[take:]

            client = _VirtualRangeClient(self.replicas, ranges, self.params)
            await client.fetch(total, sink)

        asyncio.run(run())
        return out

    def _worker(self):
        while not self._stop:
            try:
                step = self._want.get(timeout=0.2)
            except queue.Empty:
                continue
            if step is None:
                return
            try:
                batch = self._fetch_step(step)
                with self._lock:
                    self._results[step] = batch
                    self._lock.notify_all()
            except Exception as e:                       # pragma: no cover
                with self._lock:
                    self._errors[step] = e
                    self._lock.notify_all()

    def get_batch(self, step: int, timeout: float = 120.0) -> np.ndarray:
        # keep the prefetch window ahead of the consumer
        while self._next_prefetch <= step + self.depth:
            self._want.put(self._next_prefetch)
            self._next_prefetch += 1
        with self._lock:
            ok = self._lock.wait_for(
                lambda: step in self._results or step in self._errors,
                timeout=timeout)
            if not ok:
                raise TimeoutError(f"batch for step {step} not ready")
            if step in self._errors:
                raise self._errors.pop(step)
            batch = self._results.pop(step)
        return batch

    def close(self):
        self._stop = True
        self._want.put(None)
        self._thread.join(timeout=2.0)


class _VirtualRangeClient(MDTPClient):
    """MDTPClient over a *virtual* blob made of scattered file ranges.

    The allocator sees one contiguous [0, total) space; fetch_range calls
    are translated to the real file offsets (splitting requests that span
    row boundaries — each piece is still one HTTP range on the same
    persistent session).
    """

    def __init__(self, replicas, ranges, params=None):
        super().__init__(replicas, params=params)
        self._ranges = ranges
        self._starts = np.cumsum([0] + [l for _, l in ranges])

    def _make_conn(self, replica):
        from repro_torch.transfer.client import _Conn, _RangeReply
        outer = self

        class _VConn(_Conn):
            async def fetch_range(conn_self, start, end, into=None,
                                  progress=None):
                parts = []
                nbytes, elapsed, rtt_inc = 0, 0.0, False
                if progress is not None and len(progress) > 1:
                    # wire-send stamp (see _Conn.fetch_range): the first
                    # piece's request goes out immediately below
                    progress[1] = time.monotonic()
                pos = start
                while pos <= end:
                    row = int(np.searchsorted(outer._starts, pos, "right") - 1)
                    row_off = pos - outer._starts[row]
                    real_start = outer._ranges[row][0] + row_off
                    take = min(end - pos + 1,
                               int(outer._starts[row + 1] - pos))
                    sub = (into[nbytes:nbytes + take]
                           if into is not None else None)
                    reply = await _Conn.fetch_range(
                        conn_self, int(real_start),
                        int(real_start + take - 1), into=sub)
                    if into is None:
                        parts.append(reply.data)
                    nbytes += reply.nbytes
                    if progress is not None:
                        # piece-grained: good enough for the hedging
                        # layer's landed-fraction check
                        progress[0] = nbytes
                    elapsed += reply.elapsed
                    rtt_inc = rtt_inc or reply.rtt_included
                    if reply.nbytes < take:
                        break   # short piece: stop — later pieces would
                        # land at the wrong virtual offsets
                    pos += take
                data = (into[:nbytes] if into is not None
                        else b"".join(parts))
                return _RangeReply(data, nbytes, elapsed, rtt_inc)

        return _VConn(replica, request_latency=self.request_latency)
