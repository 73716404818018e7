"""The port's copy of the MDTP transfer runtime: the asyncio multi-source
client, the range-serving HTTP server (the mirrors of tests and of
``chip_smoke.py``), the resume journal, the block codec, the socket
transport and the sans-I/O scheduler.

Copies of the corresponding ``repro.transfer`` modules with imports
rewritten; the client leaves out the tuner couplings (see
``repro_torch.transfer.client``).  The fleet manager, peer mirrors,
sinks and shard planning come with a later slice.
"""

from .client import (ClientOptions, MDTPClient, Replica,
                     TransferIncompleteError, TransferReport, fetch_blob)
from .journal import (ResumeJournal, claim_interval, merge_intervals,
                      uncovered_intervals)
from .sched import ChunkScheduler
from .server import FaultPolicy, RangeServer, Throttle

__all__ = ["ChunkScheduler", "ClientOptions", "FaultPolicy", "MDTPClient",
           "RangeServer", "Replica", "ResumeJournal", "Throttle",
           "TransferIncompleteError", "TransferReport", "claim_interval",
           "fetch_blob", "merge_intervals", "uncovered_intervals"]
