"""Per-server throughput estimation.

The paper re-measures throughput from every completed chunk and uses the
latest sample directly ("after obtaining the throughput of all servers in
each iteration", §IV-B).  ``LastSample`` reproduces that.  ``Ewma`` is the
beyond-paper option used by the framework's data plane, where shard fetches
are small and bursty enough that a single sample is noisy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ThroughputEstimator", "LastSample", "Ewma", "make_estimator",
           "rtt_corrected_bandwidth"]


def rtt_corrected_bandwidth(throughput: float, rtt: float,
                            mean_chunk_bytes: float) -> float:
    """Invert the per-request estimator's RTT bias.

    A client-side estimator observes ``s / (rtt + s / bw)`` per request —
    its elapsed window spans the whole request round-trip, so the reading
    under-states the wire rate, badly for small chunks on high-RTT paths
    (a 40 MB chunk at 70 MB/s behind 0.5 s RTT reads as ~37 MB/s).  With
    the request RTT measured independently (``observed_rtts``) the line
    rate is recoverable: ``bw = s / (s / v - rtt)``.  Tuners fed
    corrected estimates re-plan against the path's actual capacity
    instead of chasing the bias.  Returns ``throughput`` unchanged when
    the correction is impossible (missing RTT/chunk data, or the implied
    on-wire time is non-positive).

    Lives here (not with the online tuners) so the transfer client can
    correct its own telemetry without importing a tuner stack.
    """
    if throughput <= 0.0 or rtt <= 0.0 or mean_chunk_bytes <= 0.0:
        return throughput
    wire_time = mean_chunk_bytes / throughput - rtt
    if wire_time <= 0.0:
        return throughput
    return mean_chunk_bytes / wire_time


class ThroughputEstimator:
    """Tracks one server's observed throughput in bytes/second."""

    def observe(self, nbytes: int, elapsed: float) -> None:
        raise NotImplementedError

    @property
    def value(self) -> float:
        """Current estimate; 0.0 until the first observation."""
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


@dataclass
class LastSample(ThroughputEstimator):
    """The paper's estimator: throughput of the most recent chunk."""

    _value: float = 0.0

    def observe(self, nbytes: int, elapsed: float) -> None:
        if elapsed <= 0.0:
            return
        self._value = nbytes / elapsed

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


@dataclass
class Ewma(ThroughputEstimator):
    """Exponentially-weighted moving average of chunk throughputs.

    ``alpha`` is the weight of the newest sample.  ``alpha=1.0`` degrades to
    ``LastSample``.
    """

    alpha: float = 0.5
    _value: float = field(default=0.0, repr=False)
    _seen: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")

    def observe(self, nbytes: int, elapsed: float) -> None:
        if elapsed <= 0.0:
            return
        sample = nbytes / elapsed
        if not self._seen:
            self._value = sample
            self._seen = True
        else:
            self._value = self.alpha * sample + (1.0 - self.alpha) * self._value

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0
        self._seen = False


def make_estimator(kind: str = "last", alpha: float = 0.5) -> ThroughputEstimator:
    if kind == "last":
        return LastSample()
    if kind == "ewma":
        return Ewma(alpha=alpha)
    raise ValueError(f"unknown estimator kind: {kind!r}")
