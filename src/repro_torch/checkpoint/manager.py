"""Checkpoint save and MDTP multi-source restore onto the device (port of
``repro.checkpoint.manager``).

Format 1, byte-compatible with the reference (one directory per step):

    step_00001000/
      data.bin        all leaves packed back-to-back (byte offsets in manifest)
      manifest.json   step, leaf keys/shapes/dtypes/offsets; written LAST via
                      tmp+rename => a directory with a manifest is complete.

Keys are the "/"-joined tree paths (dict keys sorted, as JAX flattens) and
dtypes are numpy's names (``"float32"``, ``"bfloat16"``, ...), so a
checkpoint saved by either package restores in the other.  The port maps
those names to torch dtypes itself and reads leaves as raw bytes, so no
numpy bf16 type is needed on the path.

``restore_checkpoint(..., replicas=...)`` pulls ``data.bin`` from several
mirrors at once with MDTP adaptive byte ranges, received straight into one
host buffer (page-locked when the target is a card); the moment a leaf's
last byte lands, its host-to-device copy is queued on a stream of the
restore's own (``non_blocking``), so the copies overlap the transfer and
never hold up the event loop.  The restore synchronises that stream once,
before it hands the tree back.  A mirror that dies mid-restore returns its
ranges to the pool.  The tail options (``RestoreOptions``) are the
reference's: ``tuner`` re-tunes the chunk geometry while the blob streams
in, ``wave_bytes`` re-tunes between waves, ``manager`` routes the fetches
through a shared ``TransferManager`` fleet, ``resume`` makes the restore
crash-resumable (spool plus journal), ``mirror`` serves landed ranges to
peers, and ``shard_plan`` fetches one host's span.  ``shardings`` (a
tree of ``repro_torch.distributed.Placements``, e.g.
``models.common.sharding_tree`` under an active mesh) lands each leaf as
a ``DTensor`` whose local shard is this rank's block of the restored
bytes; leaves without one land as plain tensors on ``device``.

``CheckpointManager`` saves every N steps from a host snapshot, on a
thread, and keeps the last k steps.

A **sharded state** (each rank holding its blocks, as the sharded train
step does) saves with ``shardings=`` (``train.step.train_state_shardings``
under the active mesh): each leaf is all-gathered, one at a time, over the
group holding its blocks and moved to the host, so the extra memory is
one leaf; process 0 writes the same format and bytes a whole-state save
writes, and a barrier follows the commit, so ``latest_step`` on any rank
sees it.  Every rank calls the save alike; the manager runs the
collectives on the calling thread, in the same order on every rank, and
only the writing on its thread (the barrier then comes at ``wait``).
"""

from __future__ import annotations

import asyncio
import bisect
import contextlib
import gc
import json
import math
import mmap
import os
import shutil
import threading
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.context import process_index
from repro_torch.models.common import tree_leaves
from repro_torch.transfer.client import MDTPClient, NoTelemetryError, Replica
from repro_torch.transfer.journal import ResumeJournal, claim_interval
from repro_torch.transfer.shard import (ShardPlan, manifest_boundaries,
                                        plan_shards)

__all__ = ["CheckpointManager", "RestoreOptions", "save_checkpoint",
           "restore_checkpoint", "latest_step", "DTYPE_NAMES"]

_MANIFEST = "manifest.json"
_DATA = "data.bin"

#: manifest dtype names (numpy's) <-> torch dtypes
DTYPE_NAMES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in DTYPE_NAMES.items()}


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _dtype(name: str) -> torch.dtype:
    try:
        return DTYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch "
                         f"counterpart here") from None


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in row-major order, via a uint8 view on the host."""
    flat = t.detach().contiguous().reshape(-1).cpu()
    return memoryview(flat.view(torch.uint8).numpy())


def save_checkpoint(root: str, step: int, state: Any,
                    shardings: Optional[Any] = None) -> str:
    """Blocking save of a nested dict of tensors.  Returns the committed
    directory.  With ``shardings`` (a tree of ``Placements``; ``None``
    leaves are whole) the state holds this rank's blocks: they are
    gathered (:func:`_gather_to_host`), process 0 writes, and every rank
    waits at a barrier for the commit."""
    if shardings is None:
        return _write(root, step, state)
    host = _gather_to_host(state, shardings)
    d = _write(root, step, host) if process_index() == 0 else \
        _step_dir(root, step)
    dist.barrier()
    return d


def _gather_leaf(t: torch.Tensor, pl: Any) -> Optional[torch.Tensor]:
    """The whole leaf laid out by ``pl`` as a host tensor on process 0
    (``None`` elsewhere): ``t``, this rank's block, all-gathered over the
    group holding the leaf's blocks."""
    t = t.detach()
    mesh = pl.mesh
    entries = [() if e is None else e if isinstance(e, tuple) else (e,)
               for e in pl.spec]
    entries += [()] * (t.dim() - len(entries))
    axes = [a for e in entries for a in e if mesh.shape[a] > 1]
    if not axes:
        return t.to("cpu", copy=True) if process_index() == 0 else None
    shape = [n * math.prod(mesh.shape[a] for a in e)
             for n, e in zip(t.shape, entries)]
    got = C.all_gather_stacked(t, mesh.group(tuple(axes)))
    if process_index() != 0:
        return None
    got = got.cpu()
    full = torch.empty(shape, dtype=t.dtype)
    for coord, blk in zip(mesh.member_coords(axes), got):
        full[mesh.local_slices(pl.spec, shape, coord)] = blk
    return full


def _gather_to_host(state: Any, shardings: Any) -> Any:
    """Every leaf of a state of local blocks (laid out as ``shardings``
    says) whole on the host of process 0, leaf by leaf in key order (a
    collective per split leaf, so every rank calls it alike); ``None``
    leaves on the other processes."""
    flat_s = dict(tree_leaves(shardings))

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in sorted(node.items())}
        if node is None:
            return None
        pl = flat_s.get(prefix)
        if pl is None:
            return (node.detach().to("cpu", copy=True)
                    if process_index() == 0 else None)
        return _gather_leaf(node, pl)

    return walk(state)


def _write(root: str, step: int, state: Any) -> str:
    d = _step_dir(root, step)
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "format": 1, "leaves": []}
    offset = 0
    with open(os.path.join(tmp, _DATA), "wb") as f:
        for key, leaf in tree_leaves(state):
            raw = _raw_bytes(leaf)
            manifest["leaves"].append({
                "key": key, "shape": list(leaf.shape),
                "dtype": _NAME_OF[leaf.dtype], "offset": offset,
                "nbytes": raw.nbytes,
            })
            f.write(raw)
            offset += raw.nbytes
        f.flush()
        os.fsync(f.fileno())
    manifest["total_bytes"] = offset
    mpath = os.path.join(tmp, _MANIFEST)
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(mpath + ".tmp", mpath)     # manifest-last commit inside tmp
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)                    # atomic publish
    return d


def latest_step(root: str) -> Optional[int]:
    """Newest step with a COMPLETE manifest (crashed saves are ignored)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


class _StreamingRestore:
    """Range sink for ``MDTPClient.fetch``: overlap the network with
    host-to-device copies.

    Implements the client's zero-copy sink protocol (``writable(start,
    length) -> memoryview`` + ``commit(start, nbytes)``) and the
    ``repro_torch.transfer.Sink`` accessor ``covered_intervals()``: socket
    bytes land directly in this sink's preallocated host buffer, and the
    moment the last byte of a leaf's range arrives that leaf's copy to the
    device is queued.  The legacy ``sink(start, data)`` callable is kept
    (write-then-commit) for callers that hold their own bytes.

    The landing buffer is a page-locked host tensor when the target is a
    card (so a ``non_blocking`` copy from it is a true DMA, queued on this
    restore's own stream and overlapping the transfer), a plain host
    tensor on the CPU, and a file-backed ``mmap`` when ``spool_path`` is
    given (crash-resumable restores; an existing spool's content is kept,
    the resume path re-verifies journaled CRCs against exactly these
    bytes).  A leaf is copied off the spool into a fresh host tensor
    before its device copy, so nothing handed back, and no copy still in
    flight, reads the map that :meth:`close` unmaps.  A leaf with a
    sharding keeps only this rank's block, cut on the host before its
    device copy, as the local shard of a ``DTensor`` (``landed_bytes``
    counts the bytes copied out into the leaves).  :meth:`finish`
    synchronises the copy stream: no tensor it returns is still in
    flight.

    Deliveries may overlap or repeat: the covered byte intervals are
    tracked and only first-time bytes count down a leaf, so a duplicated
    range can neither materialize a leaf twice nor drive a countdown
    negative (re-delivered bytes are counted in ``duplicate_bytes``).
    """

    def __init__(self, manifest: dict, like: Any, device: torch.device,
                 spool_path: Optional[str] = None,
                 shardings: Optional[Any] = None):
        self._covered: list[tuple[int, int]] = []   # disjoint [s, e), sorted
        self.duplicate_bytes = 0                    # re-delivered byte count
        self.landed_bytes = 0       # bytes copied out into the leaves
        self._like = like
        self._device = device
        self._shardings = dict(tree_leaves(shardings))
        by_key = {e["key"]: e for e in manifest["leaves"]}
        keys = [k for k, _ in tree_leaves(like)]
        missing = [k for k in keys if k not in by_key]
        if missing:
            raise KeyError(f"checkpoint has no leaves {missing[:5]}")
        total = int(manifest["total_bytes"])
        self.total_bytes = total
        self._mmap = None
        self._spool_file = None
        self._host = None
        if spool_path is None or total == 0:
            # page-locked for a card: cudaHostAlloc touches every page, so
            # there is no separate zero-fill; uncovered bytes are never
            # read (leaves materialize only once complete, and a peer
            # mirror serves only covered ranges)
            self._host = torch.empty(total, dtype=torch.uint8,
                                     pin_memory=device.type == "cuda")
            self._buf = memoryview(self._host.numpy())
        else:
            f = open(spool_path, "a+b")
            try:
                f.seek(0, os.SEEK_END)
                if f.tell() != total:
                    f.truncate(total)
                self._mmap = mmap.mmap(f.fileno(), total)
            except BaseException:
                f.close()
                raise
            self._spool_file = f
            self._buf = self._mmap
        self._stream = None
        if device.type == "cuda":
            # the copies queue behind whatever the caller left on its
            # stream (device blocks may come from memory freed there)
            self._stream = torch.cuda.Stream(device=device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
        self._entries = sorted((by_key[k] for k in keys),
                               key=lambda e: int(e["offset"]))
        self._starts = [int(e["offset"]) for e in self._entries]
        self._remaining = [int(e["nbytes"]) for e in self._entries]
        self._out: dict[str, torch.Tensor] = {}
        for j, rem in enumerate(self._remaining):
            if rem == 0:        # empty leaves have nothing on the wire
                self._materialize(j)

    def covered_intervals(self) -> list[tuple[int, int]]:
        """Committed coverage as sorted disjoint ``(start, nbytes)`` pairs,
        what a peer mirror advertises.  Safe to call from server threads
        while the restore streams: the covered list only grows, and each
        commit replaces it with one slice assignment."""
        return [(s, e - s) for s, e in list(self._covered)]

    def writable(self, start: int, length: int) -> memoryview:
        return memoryview(self._buf)[start:start + length]

    def sink(self, start: int, data) -> None:
        """Legacy byte-delivery path: copy ``data`` into place, then
        account for it."""
        end = start + len(data)
        if end <= start:
            return
        memoryview(self._buf)[start:end] = data
        self.commit(start, len(data))

    def commit(self, start: int, nbytes: int) -> None:
        end = start + nbytes
        if end <= start:
            return
        fresh = claim_interval(self._covered, start, end)
        self.duplicate_bytes += (end - start) - sum(e - s for s, e in fresh)
        # counters first (cannot throw), then the device copies: a leaf
        # whose copy raises keeps remaining == 0 and finish() retries it
        completed = []
        for s, e in fresh:
            completed.extend(self._account(s, e))
        for j in completed:
            self._materialize(j)

    def _account(self, start: int, end: int) -> list[int]:
        completed = []
        j = max(bisect.bisect_right(self._starts, start) - 1, 0)
        while j < len(self._entries) and self._starts[j] < end:
            leaf_end = self._starts[j] + int(self._entries[j]["nbytes"])
            overlap = min(end, leaf_end) - max(start, self._starts[j])
            if overlap > 0:
                self._remaining[j] -= overlap
                if self._remaining[j] == 0:
                    completed.append(j)
            j += 1
        return completed

    def _materialize(self, j: int) -> None:
        """Queue leaf ``j``'s copy to the device (a host clone on the
        CPU).  The copy lands in a fresh allocation, so the dtype view is
        aligned whatever the leaf's offset in the blob.  A leaf with a
        sharding copies only this rank's block: where that is not the
        whole leaf, it is cut from the host bytes into a host tensor of
        its own first."""
        e = self._entries[j]
        shape, dtype = e["shape"], _dtype(e["dtype"])
        n, off = int(e["nbytes"]), int(e["offset"])
        pl = self._shardings.get(e["key"])
        cut = False
        if pl is not None:
            block = pl.mesh.local_slices(pl.spec, shape)
            cut = any(b.stop - b.start != m for b, m in zip(block, shape))
            shape = [b.stop - b.start for b in block]
        if n == 0:
            self._out[e["key"]] = self._place(
                torch.empty(shape, dtype=dtype, device=self._device), pl)
            return
        pin = self._stream is not None
        if self._host is not None:
            whole = self._host[off:off + n]
        else:
            whole = torch.frombuffer(self._mmap, dtype=torch.uint8, count=n,
                                     offset=off)
        if cut:
            # bytes stay bytes (no dtype view of an unaligned offset): each
            # element's itemsize bytes are one trailing dim
            isz = dtype.itemsize
            src = torch.empty((*shape, isz), dtype=torch.uint8,
                              pin_memory=pin)
            src.copy_(whole.view(*e["shape"], isz)[block])
            src = src.view(-1)
        elif self._host is not None:
            src = whole if pin else whole.clone()
        else:
            src = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
            src.copy_(whole)
        del whole           # no view of the map outlives this call
        self.landed_bytes += src.numel()
        if pin:
            raw = torch.empty(src.numel(), dtype=torch.uint8,
                              device=self._device)
            with torch.cuda.stream(self._stream):
                raw.copy_(src, non_blocking=True)
        else:
            raw = src
        self._out[e["key"]] = self._place(raw.view(dtype).reshape(shape), pl)

    @staticmethod
    def _place(local: torch.Tensor, pl: Any) -> torch.Tensor:
        """``local`` itself, or as this rank's shard of a ``DTensor``."""
        if pl is None:
            return local
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, pl.device_mesh, tuple(pl),
                                  run_check=False)

    def synchronize(self) -> None:
        """Wait until every queued device copy has landed."""
        if self._stream is not None:
            self._stream.synchronize()

    def finish(self, require_all: bool = True) -> Any:
        """The restored tree, every copy landed.  ``require_all=False`` is
        the sharded-restore contract: leaves this host's span never
        covered come back ``None`` (they belong to other hosts)."""
        missing = [self._entries[j]["key"]
                   for j, r in enumerate(self._remaining) if r != 0]
        if missing and require_all:
            raise IOError(f"restore incomplete, leaves missing bytes: "
                          f"{missing[:5]}")
        # retry any leaf whose earlier copy failed mid-stream (its bytes
        # are complete in the buffer)
        for j, r in enumerate(self._remaining):
            if r == 0 and self._entries[j]["key"] not in self._out:
                self._materialize(j)
        self.synchronize()
        return _tree_from_keys(self._like, {
            e["key"]: self._out.get(e["key"]) for e in self._entries})

    def close(self) -> None:
        """Wait for the copies in flight, then release the spool mmap
        (nothing else for in-memory restores: a peer mirror may keep
        serving their buffer, which its view keeps alive)."""
        self.synchronize()
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # a transient export (a writable() slice pinned by a
                # traceback) is still alive: collect and retry, and if one
                # survives even that, leave the map for process exit (the
                # spool is scratch state)
                gc.collect()
                with contextlib.suppress(BufferError):
                    self._mmap.close()
            self._mmap = None
        if self._spool_file is not None:
            self._spool_file.close()
            self._spool_file = None


def _tree_from_keys(like: Any, flat: dict[str, Optional[torch.Tensor]]
                    ) -> Any:
    """Rebuild ``like``'s nested-dict structure from "/"-joined keys (a
    leaf mapped to ``None`` stays ``None``)."""
    return _build_tree("", like, flat)


def _build_tree(prefix: str, node: Any, flat: dict) -> Any:
    # module-level, as ``models.common.tree_leaves``'s walk: a nested
    # function calling itself is a cycle that would hold ``flat`` (every
    # restored leaf) until the cycle collector runs
    if isinstance(node, dict):
        return {k: _build_tree(f"{prefix}/{k}" if prefix else str(k), v,
                               flat)
                for k, v in node.items() if v is not None}
    return flat[prefix]


def _finish_restore(stream: _StreamingRestore, jr, spool: Optional[str],
                    require_all: bool = True):
    """Assemble the restored tree (every copy landed); for resumable
    restores, retire the scratch state (journal and spool) only then."""
    state = stream.finish(require_all)
    if jr is not None:
        jr.complete()
        stream.close()
        if spool is not None:
            with contextlib.suppress(OSError):
                os.remove(spool)
    return state


@dataclass(frozen=True)
class RestoreOptions:
    """The tail options of :func:`restore_checkpoint`, as one value.

    The bare keywords still work and override the dataclass field by
    field.  ``mirror`` is the peer-assisted broadcast hook: a
    ``repro_torch.transfer.PeerMirror`` bound to the restore's streaming
    sink as soon as the blob size is known, so committed ranges become
    servable to other restoring nodes while this restore is in flight.
    For crash-resumable restores (``resume=``) the mirror is unbound when
    the restore ends (the spool map dies with it); in-memory restores
    keep serving until the caller stops the mirror.
    """

    tuner: Any = None
    wave_bytes: Optional[int] = None
    manager: Any = None
    resume: Optional[str] = None
    mirror: Any = None
    #: sharded restore: ``(host, plan_or_k)``, fetch only this host's span
    #: of the blob.  ``plan_or_k`` is a ``repro_torch.transfer.ShardPlan``
    #: or an int K (the plan is then derived here, snapped to manifest
    #: leaf boundaries so every tensor lands whole).  Leaves outside the
    #: span come back ``None``.
    shard_plan: Any = None


def restore_checkpoint(
    root: str,
    like: Any,
    step: Optional[int] = None,
    replicas: Optional[Sequence[Replica]] = None,
    options: Optional[RestoreOptions] = None,
    *,
    tuner: Any = None,
    wave_bytes: Optional[int] = None,
    manager: Any = None,
    resume: Optional[str] = None,
    mirror: Any = None,
    shard_plan: Any = None,
    device: Optional[Union[str, torch.device]] = None,
    shardings: Optional[Any] = None,
) -> tuple[Any, int]:
    """Restore ``(state, step)`` onto ``device`` (default ``"cuda"``; raises
    without a card).

    ``like`` is a nested dict with the target structure: its leaves name
    the keys to restore (tensors, ``ParamSpec``s or anything else; shapes
    and dtypes come from the manifest).  ``replicas``: mirror list — when
    given, ``data.bin`` is fetched with MDTP multi-source ranges instead of
    read locally (``root`` is then only used to discover the step if not
    given), streamed: each leaf's device copy is queued as soon as its
    byte range completes.

    ``tuner`` (a ``repro_torch.core.online`` policy: ``GridTuner``,
    ``MCGradTuner``, ``BanditTuner``) re-plans (C, L) from live per-mirror
    telemetry; a tuner that fails never fails the restore.  Without
    ``wave_bytes`` it rides the blob fetch's in-transfer hook.

    ``wave_bytes`` splits the blob fetch into sequential waves of that
    many bytes and re-tunes the chunk geometry between waves: with a
    ``tuner``, one update per wave from the wave's report (so a bandit's
    reward stays with the params the wave ran under); without one, the
    client's grid ``retune`` on ``device`` (skipped quietly when a wave
    gave no usable observations).

    ``manager`` (a ``repro_torch.transfer.TransferManager``) routes the
    manifest and blob fetches through a shared fleet: per-replica
    in-flight caps across every transfer it runs, telemetry into its
    fleet model, residual-capacity packing, and the geometry this restore
    adopts warm-starts the manager's next transfer.  A manager that owns a
    tuner adapts through its shared in-fetch hook, and the between-wave
    grid re-tune is skipped; an explicit ``tuner=`` silences the
    manager's hook for this restore.

    ``resume`` (a scratch directory; replica restores only) makes the
    restore crash-resumable: ranges land in ``<resume>/data.spool`` and
    every committed range is journaled with its CRC32
    (``<resume>/journal.log``).  Re-running the same restore replays the
    journal, re-verifies each range against the spool and fetches only
    what is missing.  Both files are deleted once every leaf is on the
    device.

    ``mirror`` (a ``repro_torch.transfer.PeerMirror``) serves this
    restore's landed ranges to other restoring nodes.  Another restore
    lists that mirror's ``replica`` beside its origins: a replica flagged
    ``mirror`` is used as it is (its path names the blob, and it keeps the
    flag, so the client fetches from it only what it advertises), and the
    manifest comes from the full mirrors alone.  The reference rewrites
    every replica's path and drops the flag, so there a peer cannot be
    listed.  ``shard_plan``
    (``(host, plan_or_k)``; replica restores only) fetches only that
    host's span of ``data.bin``; leaves outside it come back ``None``
    (see ``repro_torch.transfer.fetch_sharded`` for K such fetches with
    work stealing).

    ``shardings`` (``like``'s structure, ``repro_torch.distributed.
    Placements`` leaves as ``models.common.sharding_tree`` gives them, or
    ``None``) lands each leaf that has one as a ``DTensor`` on ``device``
    whose local shard is this rank's block of the restored bytes (cut by
    the leaf's spec; no collective runs); leaves without one land whole,
    as plain tensors.  It is a keyword here, where the reference takes it
    fourth.

    ``options`` (a :class:`RestoreOptions`) holds the same tail options;
    bare keywords override it field by field."""
    opts = options if options is not None else RestoreOptions()
    overrides = {k: v for k, v in {
        "tuner": tuner, "wave_bytes": wave_bytes, "manager": manager,
        "resume": resume, "mirror": mirror,
        "shard_plan": shard_plan}.items() if v is not None}
    if overrides:
        opts = _dc_replace(opts, **overrides)
    tuner, wave_bytes, manager = opts.tuner, opts.wave_bytes, opts.manager
    resume, mirror, shard_plan = opts.resume, opts.mirror, opts.shard_plan

    dev = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")

    if not replicas:
        d = _step_dir(root, step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        stream = _StreamingRestore(manifest, like, dev, shardings=shardings)
        try:
            total = stream.total_bytes
            with open(os.path.join(d, _DATA), "rb") as f:
                n = f.readinto(stream.writable(0, total))
            if n != total:
                raise IOError(f"short read of {d}/{_DATA}: {n}/{total} "
                              f"bytes")
            stream.commit(0, total)
            return stream.finish(), step
        finally:
            stream.close()

    def at(r: Replica, name: str) -> Replica:
        # a peer mirror's replica (``PeerMirror.replica``) names the blob
        # itself, keeps its ``mirror`` flag, and holds no manifest
        if r.mirror:
            return r
        return Replica(r.host, r.port,
                       f"{r.path.rstrip('/')}/step_{step:010d}/{name}")

    manifest_reps = [at(r, _MANIFEST) for r in replicas if not r.mirror]
    data_reps = [at(r, _DATA) for r in replicas]

    @contextlib.asynccontextmanager
    async def client_for(reps):
        """A transfer client for this restore: fleet-managed when a
        manager is given, standalone otherwise.  An explicit ``tuner=``
        silences the manager's in-fetch hook so the wave-boundary updates
        are the only feed."""
        if manager is not None:
            kw = {"tuner": None} if tuner is not None else {}
            async with manager.session(replicas=reps, **kw) as c:
                yield c
        else:
            yield MDTPClient(reps)

    # the between-wave grid re-tune runs only when nobody else owns
    # adaptation (no explicit tuner, no manager-shared tuner)
    grid_retune = tuner is None and getattr(manager, "tuner", None) is None

    async def run():
        async with client_for(manifest_reps) as mclient:
            msize = await mclient.blob_size()
            mbuf, _ = await mclient.fetch(msize)
        manifest = json.loads(bytes(mbuf).decode())
        total = int(manifest["total_bytes"])
        lo, hi = 0, total
        if shard_plan is not None:
            # every host derives the same cuts from the same manifest
            host, plan = shard_plan
            if not isinstance(plan, ShardPlan):
                plan = plan_shards(total, int(plan),
                                   manifest_boundaries(manifest))
            lo, hi = plan.span_of(int(host))
        jr = None
        spool = None
        if resume is not None:
            os.makedirs(resume, exist_ok=True)
            spool = os.path.join(resume, "data.spool")
            # bound to (total, step): a scratch dir left by a DIFFERENT
            # restore fails the header check and starts fresh
            jr = ResumeJournal.open(os.path.join(resume, "journal.log"),
                                    total_bytes=total,
                                    meta={"step": int(step)})
        stream = _StreamingRestore(manifest, like, dev, spool_path=spool,
                                   shardings=shardings)
        if mirror is not None:
            mirror.bind(stream, total)
        try:
            return await _restore_waves(stream, jr, spool, lo, hi)
        finally:
            # idempotent after a success; after a failure the journal is
            # released with its records flushed, so a re-run can resume
            if jr is not None:
                jr.close()
            if mirror is not None and spool is not None:
                # stop serving from the spool map before it is unmapped
                # (in-memory restores keep serving; their buffer lives on)
                mirror.unbind()
            stream.close()

    async def _restore_waves(stream, jr, spool, lo, hi):
        # sharded restores fetch only [lo, hi) of the blob; the rest of
        # the tree stays unmaterialized (require_all=False below)
        span = hi - lo
        require_all = shard_plan is None
        async with client_for(data_reps) as dclient:
            if not wave_bytes or wave_bytes >= span:
                if span > 0:
                    await dclient.fetch(span, sink=stream, offset=lo,
                                        tuner=tuner, resume=jr)
                return _finish_restore(stream, jr, spool, require_all)
            pos = lo
            while pos < hi:
                n = min(int(wave_bytes), hi - pos)
                _, report = await dclient.fetch(n, sink=stream, offset=pos,
                                                resume=jr)
                pos += n
                if pos >= hi:
                    break
                next_wave = min(int(wave_bytes), hi - pos)
                if tuner is None:
                    if not grid_retune:
                        continue    # the manager's shared tuner adapts
                    try:
                        dclient.retune(next_wave, device=dev)
                    except NoTelemetryError:
                        pass        # the wave gave no live observations
                else:
                    # one update per wave, fed here only (not through the
                    # in-fetch hook)
                    from repro_torch.core.online import Telemetry

                    try:
                        new = tuner.update(Telemetry.from_report(
                            report, dclient.replicas, next_wave))
                    except Exception:
                        # a failing tuner never fails a restore whose
                        # waves stream fine: keep the current geometry
                        new = None
                    if new is not None:
                        dclient.adopt_params(new)
        return _finish_restore(stream, jr, spool, require_all)

    return asyncio.run(run()), step


def _host_copy(t: Any) -> Any:
    if isinstance(t, dict):
        return {k: _host_copy(v) for k, v in t.items()}
    return None if t is None else t.detach().to("cpu", copy=True)


@dataclass
class CheckpointManager:
    """Save every N steps with an async commit thread and keep-last-k GC.
    ``maybe_save(..., shardings=)`` saves a state of local blocks (see
    the module's docstring): every rank calls it and :meth:`wait` alike."""

    root: str
    every_steps: int = 100
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._barrier = False

    def maybe_save(self, step: int, state: Any,
                   shardings: Optional[Any] = None) -> bool:
        if step % self.every_steps != 0:
            return False
        self.wait()
        if shardings is None:
            # every leaf is copied to the host before the thread starts, so
            # a step that mutates a card tensor in place cannot reach the
            # bytes
            host_state = _host_copy(state)
        else:
            # the collectives here, on the calling thread, in key order
            host_state = _gather_to_host(state, shardings)
            self._barrier = True
            if process_index() != 0:
                if not self.async_save:
                    self.wait()
                return True
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_state), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_state)
            self.wait()
        return True

    def _save_and_gc(self, step: int, state: Any) -> None:
        _write(self.root, step, state)
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.root, n, _MANIFEST)))
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    def wait(self) -> None:
        """Join the commit thread; after a sharded save, then meet every
        rank at a barrier (the commit is visible to all after it)."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._barrier:
            self._barrier = False
            dist.barrier()
