"""Sharding context: logical-axis rules resolved against a device mesh
(port of ``repro.distributed.context``).

Models are written against *logical* axis names ("batch", "heads", "mlp",
"expert", ...).  ``activate`` binds those names to the axes of a mesh;
``ShardingCtx.spec`` resolves a leaf's logical names to a
:class:`PartitionSpec` (a tuple holding JAX's entries: a mesh axis name, a
tuple of names, or ``None`` per dim), masked where an axis does not divide
the dim, and ``axis_size``/``batch_axes`` let blocks (the MoE all-to-all,
the data-parallel train step) discover the topology.  With no active
context everything degrades to a no-op, so the same model code runs
anywhere.

Decode under a mesh: :meth:`ShardingCtx.kv_block` gives a KV cache
leaf's block (``KV_CACHE_LOGICAL``) under the active rules -- this rank's
batch rows, keys (their first is the block's global key offset) and KV
heads, and the mesh axes each is split over -- and remembers it by the
global batch and the block's local shape, so the decode step, which is
given the whole batch's tokens, finds the layout of the cache
``models.transformer.init_cache`` allocated (:meth:`ShardingCtx.
kv_block_of`).  Two caches that would share that key with different
layouts raise when the second is allocated.  Every other cache leaf (the
recurrent states of Mamba2, mLSTM and sLSTM) has the block
:meth:`ShardingCtx.block` gives it from its logical axes, and the decode
step finds its batch rows from the global batch it is given
(:meth:`ShardingCtx.batch_rows`: the leading ``batch`` dim of every cache
leaf splits alike), never from a local shape.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (ranks exist,
collectives run) or a shape-only :class:`Mesh` (axis names and sizes, the
counterpart of JAX's ``AbstractMesh``: enough to plan specs and restore
spans without ranks).  ``sharding`` turns a spec into DTensor placements,
one per mesh dim; ``Mesh.local_slices`` cuts one rank's block from the
spec itself.  A tuple entry may name its axes out of mesh order
(``("data", "pod")`` on a ``(pod, data, model)`` mesh, the multi-pod
rules' data axes): JAX takes the first axis named as major, and so do
the slices, the process groups (:meth:`Mesh.group`, whose members are
ordered as the axes are named) and the collectives over them.  A DTensor
takes the earlier dim of its ``DeviceMesh`` as major, so ``sharding``
then gives the placements over a ``DeviceMesh`` of the same ranks with
its dims permuted until every entry's axes come in the order it names
them (``Placements.device_mesh``; built from the mesh's own per-dim
groups, so it runs no collective).  A permuted mesh was chosen over
strided shard placements because ``Shard`` on a permuted mesh is public
API whose local block is the slices' by construction, while a strided
placement is private to DTensor and changes between releases.

Unlike the reference's, the active context is process-wide, not
thread-local: under ``remat`` the backward's recompute runs model code on
autograd's device threads, which must see the mesh the forward saw.  One
process drives one rank, so one context per process is its natural scope.

Hillclimbing edits the *rules*, never the models.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

__all__ = [
    "DEFAULT_RULES",
    "FSDP_DIMS",
    "KV_CACHE_LOGICAL",
    "TP_DIMS",
    "KVBlock",
    "Mesh",
    "PartitionSpec",
    "Placements",
    "ShardingRules",
    "ShardingCtx",
    "activate",
    "active_ctx",
    "constrain",
    "logical_to_spec",
    "named_sharding",
    "process_index",
]

#: Baseline logical->mesh rules (megatron-style TP over "model", DP over
#: "pod"+"data").  Values are a mesh axis name, a tuple of axis names, or
#: None (replicated).  Per-arch overrides live in the arch config.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "attn_in": None,        # attention-weight d dims (FSDP lever)
    "attn_out_d": None,
    "qheads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "moe_seq": "model",     # seq resharding at the MoE a2a boundary
    "layers": None,
    "state": None,          # SSM state dim
    "conv": None,
    "cache_seq": None,      # KV-cache sequence dim (seq-sharded for 500k)
    "frames": None,         # audio/vision source positions
    "fsdp": None,           # extra storage-only shard dim; "data" = FSDP
}


#: logical dims a dense leaf may split over ``model``: each rank computes
#: with its block (heads, MLP columns, vocabulary rows)
TP_DIMS = ("qheads", "kv_heads", "mlp", "vocab")
#: logical ``d`` dims a dense leaf may be stored split over data axes
#: (FSDP): gathered whole before use
FSDP_DIMS = ("embed", "attn_in", "attn_out_d")
#: logical dims of a KV cache leaf ``[B, S_max, KV, hd]`` (the reference's
#: ``_block_cache_specs``)
KV_CACHE_LOGICAL = ("batch", "cache_seq", "kv_heads", "head_dim")


def _axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: one entry per leading dim, each
    a mesh axis name, a tuple of names (the first named is major) or
    ``None``; trailing dims are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Placements(tuple):
    """A leaf's DTensor placements, one per dim of ``device_mesh``, with
    the mesh and the spec they came from (``mesh.local_slices(spec,
    shape)`` is this rank's block).  ``axes`` names the axis of each
    placement: the mesh's axis order, or a permutation of it where the
    spec names a tuple's axes out of mesh order."""

    def __new__(cls, placements, mesh: "Mesh", spec: PartitionSpec,
                axes: Optional[tuple] = None):
        obj = super().__new__(cls, placements)
        obj.mesh = mesh
        obj.spec = spec
        obj.axes = mesh.axis_names if axes is None else tuple(axes)
        return obj

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` the placements refer to (``None`` on a
        shape-only mesh)."""
        return self.mesh.permuted(self.axes)


def _cache(dm) -> dict:
    """``dm``'s own cache of the groups over several of its axes and its
    permuted meshes (``new_group`` is collective and not free).  Kept on
    the object: a ``DeviceMesh`` compares equal to another of the same
    layout, and one made under a later process group must not find the
    groups of an earlier, destroyed one."""
    return dm.__dict__.setdefault("_repro_torch_groups", {})


class Mesh:
    """A mesh's axis names and sizes (``shape``: name -> size, as JAX's
    ``Mesh.shape``), and its ``DeviceMesh`` when ranks exist.
    ``Mesh(sizes, names)`` alone is shape-only: it plans, it runs no
    collective."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device_mesh: Any = None):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} vs names "
                             f"{self.axis_names}")
        self.device_mesh = device_mesh

    @classmethod
    def of(cls, mesh: Any) -> "Mesh":
        """``mesh`` itself, or a ``DeviceMesh`` with named dims wrapped."""
        if isinstance(mesh, Mesh):
            return mesh
        names = getattr(mesh, "mesh_dim_names", None)
        if names is None:
            raise ValueError("a DeviceMesh needs mesh_dim_names to take "
                             "logical-axis rules")
        return cls(tuple(mesh.shape), names, device_mesh=mesh)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _ranks(self):
        if self.device_mesh is None:
            raise RuntimeError("a shape-only mesh has no ranks: pass a "
                               "DeviceMesh (launch.mesh.make_local_mesh)")
        return self.device_mesh

    def coordinate(self) -> dict[str, int]:
        """This rank's index along each axis (a shape-only mesh of one
        device has its one coordinate)."""
        if self.device_mesh is None and math.prod(self.axis_sizes) == 1:
            return dict.fromkeys(self.axis_names, 0)
        coord = self._ranks().get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        return dict(zip(self.axis_names, coord))

    def in_order(self, axes: Sequence[str]) -> tuple:
        """``axes`` (those the mesh has) in the mesh's order: the group to
        ask for where the order does not matter (an all-reduce), so that
        every caller shares one group."""
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (those the mesh has), its
        members in the order the axes are named, the first named major:
        position along them, as JAX orders the devices of ``P(axes)``.
        ``None`` for no axes.  Collective for several axes: every rank of
        the mesh asks for the same axes at the same point.

        ``torch.distributed`` ranks a group's members by global rank, the
        mesh's order; where ``axes`` are named otherwise the group is a
        separate one, and ``collectives.set_member_order`` records its
        order for the collectives (:func:`collectives.group_rank` is this
        rank's position)."""
        dm = self._ranks()
        axes = tuple(a for a in axes if a in self.axis_names)
        if not axes:
            return None
        if len(axes) == 1:
            return dm.get_group(axes[0])
        cache = _cache(dm)
        if axes not in cache:
            import torch.distributed as dist

            from repro_torch.distributed.collectives import set_member_order

            dims = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in dims]
            rows = dm.mesh.permute(*rest, *dims).reshape(
                -1, math.prod(self.axis_sizes[i] for i in dims))
            me = dist.get_rank()
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    cache[axes] = g
                    set_member_order(g, row)
        return cache[axes]

    def permuted(self, axes: Sequence[str]):
        """The ``DeviceMesh`` of these ranks with its dims in the order of
        ``axes`` (a permutation of the mesh's), built from the mesh's own
        per-dim groups (no collective); the mesh's own where ``axes`` are
        in its order, ``None`` on a shape-only mesh."""
        dm = self.device_mesh
        axes = tuple(axes)
        if dm is None or axes == self.axis_names:
            return dm
        cache = _cache(dm)
        key = ("permuted", axes)
        if key not in cache:
            from torch.distributed.device_mesh import DeviceMesh

            dims = [self.axis_names.index(a) for a in axes]
            cache[key] = DeviceMesh.from_group(
                [dm.get_group(a) for a in axes], dm.device_type,
                mesh=dm.mesh.permute(*dims).contiguous(),
                mesh_dim_names=axes)
        return cache[key]

    def member_coords(self, axes: Sequence[str]) -> list[dict]:
        """The coordinates of the members of this rank's group over
        ``axes`` (:meth:`group`), in its order: this rank's coordinate
        with ``axes`` run through row-major, the first named major."""
        me = self.coordinate()
        axes = [a for a in axes if a in self.axis_names]
        out = []
        for i in range(math.prod(self.shape[a] for a in axes)):
            c = dict(me)
            for a in reversed(axes):
                i, c[a] = divmod(i, self.shape[a])
            out.append(c)
        return out

    def local_slices(self, spec: Sequence, shape: Sequence[int],
                     coord: Optional[dict] = None) -> tuple:
        """The block of a ``shape`` leaf laid out by ``spec`` that the rank
        at ``coord`` (default: this rank) holds, one ``slice`` per dim.  A
        tuple entry's first axis is major, as in JAX's
        ``devices_indices_map``; every sharded dim must divide evenly."""
        coord = self.coordinate() if coord is None else coord
        out = []
        for dim, n in enumerate(shape):
            entry = spec[dim] if dim < len(spec) else None
            if entry is None:
                out.append(slice(0, n))
                continue
            idx, parts = 0, 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                idx = idx * self.shape[a] + coord[a]
                parts *= self.shape[a]
            if n % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split into {parts} even blocks")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)


@dataclass(frozen=True)
class KVBlock:
    """This rank's block of a KV cache leaf of global ``shape`` ``[B,
    S_max, KV, hd]``: its batch ``rows``, its ``keys`` (``k_off``, the
    first, is the block's global key offset) and its KV ``heads``, and the
    mesh axes (of size > 1, in the spec's order) each dim is split over."""

    shape: tuple
    rows: slice
    keys: slice
    heads: slice
    batch_axes: tuple
    seq_axes: tuple
    head_axes: tuple

    @property
    def k_off(self) -> int:
        return self.keys.start

    @property
    def local_shape(self) -> tuple:
        return (self.rows.stop - self.rows.start,
                self.keys.stop - self.keys.start,
                self.heads.stop - self.heads.start, self.shape[3])


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)

    def resolve_entries(self, logical: Sequence[Optional[str]],
                        axes_present: frozenset) -> list:
        """Raw per-dim entries (mesh axis name / tuple / None), dropping
        mesh axes the active mesh does not have (no "pod" on one pod)."""
        out = []
        for name in logical:
            if name is None:
                out.append(None)
                continue
            target = self.rules.get(name)
            if target is None:
                out.append(None)
            elif isinstance(target, tuple):
                present = tuple(a for a in target if a in axes_present)
                out.append(present if present else None)
            else:
                out.append(target if target in axes_present else None)
        return out

    def resolve(self, logical: Sequence[Optional[str]],
                axes_present: frozenset) -> PartitionSpec:
        out = _dedupe(self.resolve_entries(logical, axes_present))
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)


@dataclass
class ShardingCtx:
    mesh: Mesh
    rules: ShardingRules
    #: what is derived from this context once: each leaf's ``layout``
    #: (asked for every block of every layer), the decode step's rule
    #: check per config
    memo: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.mesh = Mesh.of(self.mesh)

    @property
    def axes(self) -> frozenset:
        return frozenset(self.mesh.axis_names)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        entries = self.rules.resolve_entries(logical, self.axes)
        if shape is not None:
            # Divisibility masking for storage shardings: an axis that
            # doesn't divide the dim drops to replicated (GQA kv=8 heads
            # cannot shard over model=16 -> wk/wv replicate).
            entries = entries + [None] * (len(shape) - len(entries))
            masked = []
            for dim, entry in zip(shape, entries):
                if entry is None:
                    masked.append(None)
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                factor = 1
                for a in axes:
                    factor *= self.mesh.shape[a]
                masked.append(entry if dim % factor == 0 else None)
            entries = masked
        out = _dedupe(entries)
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def sharding(self, logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Placements:
        """The spec's DTensor placements, one per dim of their
        ``device_mesh``.  Where a tuple entry names its axes out of mesh
        order, the dims that entry's axes hold take them in its order
        (``Placements.axes``), so the earlier dim is the first named and
        each rank's local block is ``Mesh.local_slices``' (module
        docstring)."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.spec(logical, shape)
        names = list(self.mesh.axis_names)
        for entry in spec:
            axes = _axes(entry)
            at = sorted(names.index(a) for a in axes)
            for i, a in zip(at, axes):
                names[i] = a
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            for a in _axes(entry):
                out[names.index(a)] = Shard(dim)
        return Placements(out, self.mesh, spec, tuple(names))

    def axis_size(self, name: str) -> int:
        if name not in self.mesh.axis_names:
            return 1
        return self.mesh.shape[name]

    def batch_axes(self) -> tuple[str, ...]:
        """Physical axes the batch is sharded over (for psum in loss)."""
        target = self.rules.rules.get("batch")
        if target is None:
            return ()
        if isinstance(target, str):
            target = (target,)
        return tuple(a for a in target if a in self.mesh.axis_names)

    def fsdp_axes(self) -> tuple[str, ...]:
        """The mesh axes ``expert_mlp`` resolves to, in the rules' order
        (the first named major): an expert leaf's dim 1 is stored split
        over them (FSDP) and the MoE block all-gathers it over
        ``mesh.group`` of them."""
        target = self.rules.rules.get("expert_mlp")
        if isinstance(target, str):
            target = (target,)
        return tuple(a for a in (target or ()) if a in self.mesh.axis_names)

    def expert_split(self, logical: Sequence[Optional[str]]) -> list:
        """Per dim of a leaf with these logical names, the mesh axes (of
        size > 1) each rank holds it split over in the expert-parallel
        layout: an expert leaf's ``expert`` dim over ``model`` and the dim
        after it over :meth:`fsdp_axes`; every other dim, and every leaf
        without an ``expert`` dim, whole."""
        out = [()] * len(logical)
        if "expert" in logical:
            i = logical.index("expert")
            out[i] = tuple(a for a in ("model",) if self.axis_size(a) > 1)
            out[i + 1] = tuple(a for a in self.fsdp_axes()
                               if self.axis_size(a) > 1)
        return out

    def layout(self, logical: Sequence[Optional[str]],
               shape: Sequence[int]) -> list:
        """Per dim of a leaf of this shape and these logical names, the mesh
        axes of size > 1 that its storage spec (divisibility-masked) splits
        it over, each in the spec's order; ``()`` for a whole dim."""
        key = ("layout", tuple(logical), tuple(shape))
        if key not in self.memo:
            spec = self.spec(logical, shape)
            out = [tuple(a for a in _axes(e) if self.axis_size(a) > 1)
                   for e in spec]
            self.memo[key] = out + [()] * (len(shape) - len(out))
        return self.memo[key]

    def block(self, logical: Sequence[Optional[str]],
              shape: Sequence[int]) -> tuple:
        """This rank's block of a leaf of global ``shape`` and these
        logical names under the rules (its spec, divisibility-masked and
        deduped as the reference's), one ``slice`` per dim; a tuple
        entry's first axis is major, as the groups order their members."""
        key = ("block", tuple(logical), tuple(int(n) for n in shape))
        if key not in self.memo:
            self.memo[key] = self.mesh.local_slices(
                self.spec(logical, key[2]), key[2])
        return self.memo[key]

    def batch_rows(self, batch: int) -> tuple[slice, tuple]:
        """(this rank's rows of a global batch of ``batch``, the mesh
        axes of size > 1 they are split over): how the leading ``batch``
        dim of every decode cache leaf splits under the rules."""
        return (self.block(("batch",), (batch,))[0],
                self.layout(("batch",), (batch,))[0])

    def kv_block(self, shape: Sequence[int]) -> KVBlock:
        """This rank's block of a KV cache leaf of global ``shape`` under
        the rules (its spec over ``KV_CACHE_LOGICAL``, divisibility-masked
        and deduped as the reference's), remembered by the global batch
        and its local shape for :meth:`kv_block_of`.  Raises
        ``ValueError`` where another block of the same
        global batch and local shape was made under this context (the
        decode step could not tell the two caches apart)."""
        shape = tuple(int(n) for n in shape)
        key = ("kv_block", shape)
        if key not in self.memo:
            rows, keys, heads, _ = self.block(KV_CACHE_LOGICAL, shape)
            lay = self.layout(KV_CACHE_LOGICAL, shape)
            block = KVBlock(shape, rows, keys, heads, *lay[:3])
            local = ("kv_local", shape[0], block.local_shape)
            other = self.memo.get(local)
            if other is not None and other != block:
                raise ValueError(
                    f"a KV cache of {shape} has blocks of local shape "
                    f"{block.local_shape}, as the cache of {other.shape} "
                    f"already made under this context does, with another "
                    f"layout: decode the two under separate contexts")
            self.memo[key] = block
            self.memo[local] = block
        return self.memo[key]

    def kv_block_of(self, batch: int,
                    local_shape: Sequence[int]) -> KVBlock:
        """The block of a cache of global ``batch`` whose local shape is
        ``local_shape``, as :meth:`kv_block` made it (``init_cache`` under
        this context); on a mesh of one device, the whole leaf."""
        local_shape = tuple(int(n) for n in local_shape)
        block = self.memo.get(("kv_local", int(batch), local_shape))
        if block is not None:
            return block
        if math.prod(self.mesh.axis_sizes) == 1:
            return self.kv_block(local_shape)
        raise ValueError(
            f"no KV cache block of local shape {local_shape} for a batch of "
            f"{batch} was allocated under this context: make the cache "
            f"with models.transformer.init_cache inside it")

    def model_group(self):
        """The process group over ``model`` (``None`` without the axis)."""
        if "model" not in self.mesh.axis_names:
            return None
        return self.mesh.group(("model",))

    def batch_shard(self) -> tuple[int, int]:
        """(this rank's index along the batch axes, their total size): the
        block of a global batch this rank feeds the data-parallel step."""
        coord = self.mesh.coordinate()
        idx, n = 0, 1
        for a in self.batch_axes():
            idx = idx * self.mesh.shape[a] + coord[a]
            n *= self.mesh.shape[a]
        return idx, n


def _dedupe(entries: list) -> list:
    """Drop mesh axes already claimed by an earlier dim (masking can free an
    axis — e.g. batch=1 decode frees 'data' for the cache_seq dim)."""
    seen: set = set()
    out = []
    for entry in entries:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = tuple(a for a in axes if a not in seen)
        seen.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    return out


_active: Optional[ShardingCtx] = None


def active_ctx() -> Optional[ShardingCtx]:
    return _active


@contextmanager
def activate(mesh: Any, rules: Optional[ShardingRules] = None):
    """Bind a mesh (a ``DeviceMesh`` or a shape-only :class:`Mesh`) and
    rules for the duration of the block, in this process."""
    global _active
    prev = _active
    _active = ShardingCtx(mesh=mesh, rules=rules or ShardingRules())
    try:
        yield _active
    finally:
        _active = prev


def logical_to_spec(logical: Sequence[Optional[str]]) -> PartitionSpec:
    ctx = active_ctx()
    if ctx is None:
        return PartitionSpec()
    return ctx.spec(logical)


def named_sharding(logical: Sequence[Optional[str]]) -> Optional[Placements]:
    ctx = active_ctx()
    if ctx is None:
        return None
    return ctx.sharding(logical)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` laid out as its logical dims resolve: a ``DTensor`` is
    redistributed to those placements, a plain tensor (this rank's values)
    returned as it is.  Never changes a value; a no-op without an active
    context."""
    ctx = active_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    pl = ctx.sharding(logical)
    if pl.device_mesh is x.device_mesh:
        return x.redistribute(x.device_mesh, tuple(pl))
    # another dim order of the same ranks: whole, then this rank's block
    local = x.full_tensor()[pl.mesh.local_slices(pl.spec, x.shape)]
    return DTensor.from_local(local.contiguous(), pl.device_mesh, tuple(pl),
                              run_check=False)


def process_index() -> int:
    """This process's rank, 0 without a process group (the counterpart of
    ``jax.process_index``)."""
    import torch.distributed as dist

    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)
