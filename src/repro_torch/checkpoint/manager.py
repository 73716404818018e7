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
those names to torch dtypes itself and reads leaves as raw bytes
(``torch.frombuffer``), so no numpy bf16 type is needed on the path.

``restore_checkpoint(..., replicas=...)`` pulls ``data.bin`` from several
mirrors at once with MDTP adaptive byte ranges, received straight into one
host buffer; each leaf is copied to the device the moment its last byte
lands, overlapping the host-to-device copies with the transfer.  A mirror
that dies mid-restore returns its ranges to the pool.  ``tuner=`` (a
``repro_torch.core.online`` policy) re-tunes the chunk geometry while the
blob streams in.

Left for later slices: the reference's ``wave_bytes`` between-wave
re-tuning, fleet ``manager``, crash ``resume``, peer ``mirror``,
``shard_plan`` and ``CheckpointManager``; until then they are not
keywords, so passing one raises ``TypeError``.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import os
import shutil
from typing import Any, Optional, Sequence, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.transfer.client import MDTPClient, Replica
from repro_torch.transfer.journal import claim_interval

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "DTYPE_NAMES"]

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


def save_checkpoint(root: str, step: int, state: Any) -> str:
    """Blocking save of a nested dict of tensors.  Returns the committed
    directory."""
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


def _leaf_tensor(buf, entry: dict, device: torch.device) -> torch.Tensor:
    """Copy one manifest leaf out of the host buffer onto ``device``."""
    shape = entry["shape"]
    dtype = _dtype(entry["dtype"])
    nbytes = int(entry["nbytes"])
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    raw = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                           offset=int(entry["offset"]))
    # the copy (host clone or host-to-device) starts at offset 0, so the
    # dtype view is aligned whatever the leaf's offset in the blob
    return raw.to(device, copy=True).view(dtype).reshape(shape)


class _StreamingRestore:
    """Range sink for ``MDTPClient.fetch``: overlap the network with
    host-to-device copies.

    Implements the client's zero-copy sink protocol (``writable(start,
    length) -> memoryview`` + ``commit(start, nbytes)``): socket bytes land
    directly in this sink's preallocated host buffer, and the moment the
    last byte of a leaf's range arrives that leaf is copied to the device.
    Deliveries may overlap or repeat: the covered byte intervals are
    tracked and only first-time bytes count down a leaf, so a duplicated
    range can neither materialize a leaf twice nor drive a countdown
    negative.
    """

    def __init__(self, manifest: dict, like: Any, device: torch.device):
        self._covered: list[tuple[int, int]] = []   # disjoint [s, e), sorted
        self._like = like
        self._device = device
        by_key = {e["key"]: e for e in manifest["leaves"]}
        keys = [k for k, _ in tree_leaves(like)]
        missing = [k for k in keys if k not in by_key]
        if missing:
            raise KeyError(f"checkpoint has no leaves {missing[:5]}")
        self.total_bytes = int(manifest["total_bytes"])
        self._buf = bytearray(self.total_bytes)
        self._entries = sorted((by_key[k] for k in keys),
                               key=lambda e: int(e["offset"]))
        self._starts = [int(e["offset"]) for e in self._entries]
        self._remaining = [int(e["nbytes"]) for e in self._entries]
        self._out: dict[str, torch.Tensor] = {}
        for j, rem in enumerate(self._remaining):
            if rem == 0:        # empty leaves have nothing on the wire
                self._materialize(j)

    def writable(self, start: int, length: int) -> memoryview:
        return memoryview(self._buf)[start:start + length]

    def commit(self, start: int, nbytes: int) -> None:
        end = start + nbytes
        if end <= start:
            return
        fresh = claim_interval(self._covered, start, end)
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
        e = self._entries[j]
        self._out[e["key"]] = _leaf_tensor(self._buf, e, self._device)

    def finish(self) -> Any:
        missing = [self._entries[j]["key"]
                   for j, r in enumerate(self._remaining) if r != 0]
        if missing:
            raise IOError(f"restore incomplete, leaves missing bytes: "
                          f"{missing[:5]}")
        for j, e in enumerate(self._entries):
            if e["key"] not in self._out:
                self._materialize(j)
        return _tree_from_keys(self._like, self._out)


def _tree_from_keys(like: Any, flat: dict[str, torch.Tensor]) -> Any:
    """Rebuild ``like``'s nested-dict structure from "/"-joined keys."""
    def build(prefix: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items() if v is not None}
        return flat[prefix]

    return build("", like)


def restore_checkpoint(
    root: str,
    like: Any,
    step: Optional[int] = None,
    replicas: Optional[Sequence[Replica]] = None,
    *,
    tuner: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> tuple[Any, int]:
    """Restore ``(state, step)`` onto ``device`` (default ``"cuda"``; raises
    without a card).

    ``like`` is a nested dict with the target structure: its leaves name
    the keys to restore (tensors, ``ParamSpec``s or anything else; shapes
    and dtypes come from the manifest).  ``replicas``: mirror list — when
    given, ``data.bin`` is fetched with MDTP multi-source ranges instead of
    read locally (``root`` is then only used to discover the step if not
    given), streamed: each leaf goes to the device as soon as its byte
    range completes.

    ``tuner`` (a ``repro_torch.core.online`` policy: ``GridTuner``,
    ``MCGradTuner``, ``BanditTuner``; replica restores only) is passed to
    the blob fetch's in-transfer telemetry hook: it re-plans (C, L) from
    live per-mirror throughput while the restore runs, and the client
    adopts what it returns.  A tuner that fails never fails the
    restore."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")

    if replicas:
        base = [Replica(r.host, r.port,
                        r.path.rstrip("/") + f"/step_{step:010d}")
                for r in replicas]

        async def run():
            mclient = MDTPClient([Replica(r.host, r.port,
                                          r.path + "/" + _MANIFEST)
                                  for r in base])
            msize = await mclient.blob_size()
            mbuf, _ = await mclient.fetch(msize)
            manifest = json.loads(bytes(mbuf).decode())
            stream = _StreamingRestore(manifest, like, dev)
            if stream.total_bytes > 0:
                dclient = MDTPClient([Replica(r.host, r.port,
                                              r.path + "/" + _DATA)
                                      for r in base])
                await dclient.fetch(stream.total_bytes, sink=stream,
                                    tuner=tuner)
            return stream.finish()

        return asyncio.run(run()), step

    d = _step_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    blob = bytearray(os.path.getsize(os.path.join(d, _DATA)))
    with open(os.path.join(d, _DATA), "rb") as f:
        n = f.readinto(blob)
    if n != len(blob):
        raise IOError(f"short read of {d}/{_DATA}: {n}/{len(blob)} bytes")
    by_key = {e["key"]: e for e in manifest["leaves"]}
    flat = {k: _leaf_tensor(blob, by_key[k], dev)
            for k, _ in tree_leaves(like)}
    return _tree_from_keys(like, flat), step
