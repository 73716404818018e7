"""Quickstart: MDTP in 60 seconds (port of ``examples/quickstart.py``).

1. Simulate the paper's FABRIC testbed and compare MDTP against static
   chunking / Aria2 / BitTorrent on a 4 GB transfer.
2. Do a REAL multi-source transfer over three localhost HTTP mirrors with
   heterogeneous bandwidth and watch the adaptive chunking balance them.

Both run on the host: the simulator is numpy and the transfer sockets.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (Aria2Policy, BitTorrentPolicy, MDTPPolicy,
                              StaticChunkingPolicy, simulate)
from repro_torch.core.chunking import ChunkParams
from repro_torch.core.scenarios import GB, bittorrent_seeders, paper_baseline
from repro_torch.launch.train import start_mirror, stop_mirror
from repro_torch.transfer import Replica, fetch_blob

MB = 1024 * 1024


def simulated_comparison() -> dict:
    """``{policy: simulated total seconds}`` of one 4 GB transfer."""
    print("=== simulated 4 GB transfer, 6 replicas (paper Fig. 2 setup) ===")
    size = 4 * GB
    servers = paper_baseline()
    out = {}
    for policy in (MDTPPolicy(), StaticChunkingPolicy(), Aria2Policy()):
        r = simulate(policy, servers, size, seed=0)
        r.check_integrity()
        out[r.policy] = r.total_time
        print(f"  {r.policy:10s} {r.total_time:7.1f}s  "
              f"replicas used: {r.utilization(0.01) * 100:3.0f}%  "
              f"requests/replica: {r.requests_per_server}")
    r = simulate(BitTorrentPolicy(), bittorrent_seeders(), size, seed=0)
    out[r.policy] = r.total_time
    print(f"  {r.policy:10s} {r.total_time:7.1f}s  (flapping seeders)")
    return out


def real_transfer(mirror=start_mirror) -> dict:
    """A 16 MiB blob fetched over three mirrors paced at 25, 50 and 100
    MiB/s; the bytes and requests each mirror served."""
    print("=== real MDTP transfer over 3 localhost mirrors ===")
    blob = np.random.default_rng(0).integers(
        0, 256, size=16 * MB, dtype=np.uint8).tobytes()
    servers = []
    try:
        for bw in (25 * MB, 50 * MB, 100 * MB):
            servers.append(mirror({"/blob": blob}, bw))
        replicas = [Replica("127.0.0.1", s.port, "/blob") for s in servers]
        data, report = fetch_blob(
            replicas, len(blob),
            params=ChunkParams(initial_chunk=512 * 1024, large_chunk=2 * MB))
        assert bytes(data) == blob
        print(f"  fetched {len(blob) >> 20} MiB in {report.elapsed:.2f}s "
              f"({report.throughput / MB:.0f} MiB/s aggregate)")
        for name, nbytes in report.bytes_per_replica.items():
            reqs = report.requests_per_replica[name]
            print(f"    mirror {name}: {nbytes >> 20:3d} MiB "
                  f"in {reqs} requests")
    finally:
        for s in servers:
            stop_mirror(s)
    return {"bytes": len(blob), "elapsed_s": report.elapsed,
            "bytes_per_replica": dict(report.bytes_per_replica),
            "requests_per_replica": dict(report.requests_per_replica)}


def main(*, mirror=start_mirror) -> dict:
    return {"simulated": simulated_comparison(),
            "transfer": real_transfer(mirror)}


if __name__ == "__main__":
    main()
