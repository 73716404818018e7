"""The port's copy of the MDTP allocator core it needs: the adaptive
chunk-size rule (``chunking``) and the per-server throughput estimators
(``throughput``).  Copies of ``repro.core.chunking`` and
``repro.core.throughput``; the simulators and tuners come with a later
slice."""

from .chunking import (ChunkParams, default_chunk_params, fast_server_mask,
                       geometric_mean, next_chunk_size, round_chunk_sizes)
from .throughput import (Ewma, LastSample, ThroughputEstimator,
                         make_estimator, rtt_corrected_bandwidth)

__all__ = ["ChunkParams", "default_chunk_params", "fast_server_mask",
           "geometric_mean", "next_chunk_size", "round_chunk_sizes",
           "Ewma", "LastSample", "ThroughputEstimator", "make_estimator",
           "rtt_corrected_bandwidth"]
