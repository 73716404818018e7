"""The port's copy of the MDTP transfer runtime: the asyncio multi-source
client, the range-serving HTTP server (the mirrors of tests and of
``chip_smoke.py``), the resume journal, the block codec, the socket
transport, the sans-I/O scheduler, the fleet manager
(``TransferManager``), the sink protocol, peer mirrors (``PeerMirror``)
and sharded work-stealing restore (``fetch_sharded``).

Copies of the corresponding ``repro.transfer`` modules with imports
rewritten; the client's ``retune`` takes a ``device`` (see
``repro_torch.transfer.client``), and ``shard`` leaves out the
reference's ``plan_for_ctx`` until the port has a sharding context.
"""

from .client import (ClientOptions, MDTPClient, Replica,
                     TransferIncompleteError, TransferReport, fetch_blob)
from .journal import (ResumeJournal, claim_interval, merge_intervals,
                      uncovered_intervals)
from .manager import FleetModel, TransferJob, TransferManager
from .mirror import PeerMirror
from .sched import ChunkScheduler
from .server import FaultPolicy, RangeServer, Throttle
from .shard import (ShardPlan, StealLedger, fetch_sharded, plan_for_mesh,
                    plan_shards)
from .sink import BufferSink, CallableSink, Sink

__all__ = ["BufferSink", "CallableSink", "ChunkScheduler", "ClientOptions",
           "FaultPolicy", "FleetModel", "MDTPClient", "PeerMirror",
           "RangeServer", "Replica", "ResumeJournal", "ShardPlan", "Sink",
           "StealLedger", "Throttle", "TransferIncompleteError",
           "TransferJob", "TransferManager", "TransferReport",
           "claim_interval", "fetch_blob", "fetch_sharded",
           "merge_intervals", "plan_for_mesh", "plan_shards",
           "uncovered_intervals"]
