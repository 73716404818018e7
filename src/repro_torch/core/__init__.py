"""MDTP core, the port's copy of ``repro.core``.

* ``chunking``: the adaptive bin-packing chunk allocator (§IV-B, Alg. 1).
* ``throughput``: per-server throughput estimators.
* ``simulator``: discrete-event multi-source transfer simulator (numpy).
* ``mdtp`` / ``static_chunking`` / ``aria2`` / ``bittorrent``: policies.
* ``torch_alloc`` / ``torch_sim``: the allocator and the on-device
  simulators over a lane batch (the counterparts of ``jax_alloc`` and
  ``jax_sim``).  Three loop engines: ``event`` (exact, O(#chunks) steps),
  ``round`` (round-synchronous, O(#rounds) steps) and ``scan`` (fixed trip
  count, differentiable under ``torch.autograd``).
* ``autotune``: chunk-size selection (paper §VIII-A): the grid sweep over
  (scenario × C, L × seed) lanes, ``autotune_batch`` /
  ``sweep_scenarios``, and the gradient polish ``tune_chunk_params_grad``.
* ``online``: online (C, L) tuning from live fleet telemetry, consumed by
  ``MDTPClient.fetch(tuner=...)`` and ``restore_checkpoint(tuner=...)``.
* ``scenarios``: calibrated FABRIC-testbed stand-ins.

Names resolve on first attribute access (PEP 562), so the transfer layer
imports ``chunking`` and ``throughput`` without pulling in the simulators.
"""

from importlib import import_module

#: export name -> defining submodule
_EXPORTS = {
    "ChunkParams": ".chunking", "default_chunk_params": ".chunking",
    "fast_server_mask": ".chunking", "geometric_mean": ".chunking",
    "next_chunk_size": ".chunking", "round_chunk_sizes": ".chunking",
    "Ewma": ".throughput", "LastSample": ".throughput",
    "ThroughputEstimator": ".throughput", "make_estimator": ".throughput",
    "ChunkRecord": ".simulator", "Policy": ".simulator",
    "Request": ".simulator", "ServerSpec": ".simulator",
    "SimResult": ".simulator", "TransferState": ".simulator",
    "Wait": ".simulator", "simulate": ".simulator",
    "MDTPPolicy": ".mdtp",
    "StaticChunkingPolicy": ".static_chunking",
    "default_static_chunk": ".static_chunking",
    "Aria2Policy": ".aria2",
    "BitTorrentPolicy": ".bittorrent",
    "ChunkArrays": ".torch_alloc", "round_allocate": ".torch_alloc",
    "AutotuneResult": ".autotune", "GradTuneResult": ".autotune",
    "autotune_batch": ".autotune", "autotune_chunk_params": ".autotune",
    "default_grid": ".autotune", "sweep_scenarios": ".autotune",
    "tune_chunk_params_grad": ".autotune",
    "BanditTuner": ".online", "GridTuner": ".online",
    "MCGradTuner": ".online", "Telemetry": ".online",
    "rtt_corrected_bandwidth": ".online",
    "tune_chunk_params_mcgrad": ".online",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(target, __name__), name)
    globals()[name] = value          # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
