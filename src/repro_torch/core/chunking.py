"""MDTP adaptive chunk-size allocation (paper §IV-B, Algorithm 1).

This module is the single source of truth for the bin-packing allocation
rule.  It is shared by:

* the real asyncio transfer runtime (``repro_torch.transfer.client``),
* in the JAX reference package, the discrete-event simulator
  (``repro.core.simulator``) and the vectorized allocator
  (``repro.core.jax_alloc``), which are cross-checked against this rule.

This is the port's own copy of ``repro.core.chunking``: the port imports
nothing of the reference package.

The rule, faithful to the paper
-------------------------------
Each server is a *bin*.  The bin threshold (shared deadline) is the fastest
server's download time for the "large" chunk::

    T = L / th_max

and server *i*'s next chunk is sized to fill its bin exactly by that
deadline::

    C_i = round(T * th_i)

The paper's prose (§IV-B) sizes *every* server proportionally, with the
fastest server requesting exactly ``L``.  Algorithm 1's pseudocode instead
gives every "fast" server (throughput >= geometric mean) the large chunk
``L``.  Both semantics are implemented; ``mode="proportional"`` (prose,
consistent with Fig. 5c's equal per-replica request counts) is the default
and ``mode="fast_get_large"`` matches the pseudocode.

The geometric mean is kept as the paper's fast/slow classifier.  Note that
``max(th) >= GM`` always holds, so in ``proportional`` mode the GM filter
cannot change the chosen deadline; it only matters in ``fast_get_large``
mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Sequence

__all__ = [
    "DEFAULT_MIN_CHUNK",
    "ChunkParams",
    "default_chunk_params",
    "geometric_mean",
    "fast_server_mask",
    "next_chunk_size",
    "round_chunk_sizes",
]

MB = 1024 * 1024

#: Paper Table II (bold entries): (initial C, large L) per file-size regime.
_SMALL_FILE_LIMIT = 8 * 1024 * MB  # <= 8 GB
_SMALL_PARAMS = (4 * MB, 40 * MB)
_LARGE_PARAMS = (16 * MB, 160 * MB)

#: floor for adaptive sizes, shared by ChunkParams and the autotuner's
#: sweep geometry so the scored and adopted min_chunk cannot diverge.
DEFAULT_MIN_CHUNK = 64 * 1024


@dataclass(frozen=True)
class ChunkParams:
    """Static parameters of the MDTP allocator.

    Attributes:
      initial_chunk: size ``C`` of the uniform probing chunk every server
        downloads first (Algorithm 1 line 1).
      large_chunk: size ``L`` requested by the fastest server each round
        (Algorithm 1 line 2).
      min_chunk: floor for adaptive sizes so a glacial server still makes
        progress and ``round()`` can never emit a zero-byte request.
      mode: ``"proportional"`` (paper prose, default),
        ``"fast_get_large"`` (paper pseudocode), or ``"static"`` (every
        probed server gets exactly ``large_chunk`` — the fixed-chunk
        baseline, used to fold static chunking into the adaptive code
        path via ``C == L == chunk``).
    """

    initial_chunk: int = _SMALL_PARAMS[0]
    large_chunk: int = _SMALL_PARAMS[1]
    min_chunk: int = DEFAULT_MIN_CHUNK
    mode: str = "proportional"

    def __post_init__(self) -> None:
        if self.initial_chunk <= 0 or self.large_chunk <= 0:
            raise ValueError("chunk sizes must be positive")
        if self.min_chunk <= 0:
            raise ValueError("min_chunk must be positive")
        if self.mode not in ("proportional", "fast_get_large", "static"):
            raise ValueError(f"unknown mode: {self.mode!r}")

    def with_mode(self, mode: str) -> "ChunkParams":
        return replace(self, mode=mode)

    def as_triple(self) -> tuple[int, int, int]:
        """The ``(C, L, min_chunk)`` geometry, mode stripped — the data
        half of the allocator, as consumed by the traced JAX path."""
        return (self.initial_chunk, self.large_chunk, self.min_chunk)


def default_chunk_params(file_size: int, mode: str = "proportional") -> ChunkParams:
    """Paper Table II defaults: 4/40 MB up to 8 GB, 16/160 MB above."""
    c, l = _SMALL_PARAMS if file_size <= _SMALL_FILE_LIMIT else _LARGE_PARAMS
    return ChunkParams(initial_chunk=c, large_chunk=l, mode=mode)


def geometric_mean(throughputs: Sequence[float]) -> float:
    """Geometric mean over *positive* observations (paper's classifier).

    Servers with no observation yet (``<= 0``) are excluded; an empty set
    yields ``0.0`` so every server classifies as "fast" until probed.
    """
    logs = [math.log(t) for t in throughputs if t > 0.0]
    if not logs:
        return 0.0
    return math.exp(math.fsum(logs) / len(logs))


def fast_server_mask(throughputs: Sequence[float]) -> list[bool]:
    """Paper: a server is *fast* iff its throughput >= the geometric mean.

    A whisker of relative tolerance absorbs exp(log(x)) round-trip error so
    the maximum-throughput server always classifies fast (GM <= max holds
    mathematically but not always bit-wise).
    """
    gm = geometric_mean(throughputs) * (1.0 - 1e-12)
    return [t >= gm and t > 0.0 for t in throughputs]


def next_chunk_size(
    server: int,
    throughputs: Sequence[float],
    params: ChunkParams,
    remaining: int,
) -> int:
    """Size of the next byte-range request for ``server``.

    Implements the per-iteration body of Algorithm 1 (lines 11-31) for one
    server, given the latest throughput estimates of *all* servers.

    Args:
      server: index of the server that just became free.
      throughputs: latest estimate per server; ``<= 0`` means "not yet
        observed" (that server is still on its initial probing chunk).
      params: allocator constants.
      remaining: unassigned bytes left in the file (global cursor pool).

    Returns:
      Request size in bytes, clamped to ``remaining`` (0 when done).
    """
    if remaining <= 0:
        return 0
    th_i = throughputs[server]
    if th_i <= 0.0:
        # Not yet probed: uniform initial chunk (Algorithm 1 lines 5-10).
        return min(params.initial_chunk, remaining)

    if params.mode == "static":
        # Fixed-chunk baseline: throughput is ignored, every request is L.
        return min(max(params.large_chunk, params.min_chunk), remaining)
    th_max = max(t for t in throughputs if t > 0.0)
    if params.mode == "fast_get_large":
        gm = geometric_mean(throughputs)
        if th_i >= gm:
            return min(params.large_chunk, remaining)
        size = int(round(params.large_chunk * th_i / th_max))
    else:  # proportional (prose semantics)
        if th_i >= th_max:
            size = params.large_chunk
        else:
            # C_i = T_fastest * th_i, T_fastest = L / th_max.
            size = int(round(params.large_chunk * th_i / th_max))
    size = max(size, params.min_chunk)
    return min(size, remaining)


def round_chunk_sizes(
    throughputs: Sequence[float],
    params: ChunkParams,
    remaining: int,
) -> list[int]:
    """Vector form: the chunk each server would get if it asked right now.

    Used by the planners (checkpoint restore splits a whole object across
    replicas in one shot) and mirrored exactly by ``jax_alloc.chunk_sizes``.
    """
    return [
        next_chunk_size(i, throughputs, params, remaining)
        for i in range(len(throughputs))
    ]
