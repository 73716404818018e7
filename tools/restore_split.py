#!/usr/bin/env python3
"""Where a qwen3-1.7b restore onto the card spends its time, for one
checkout of the port.

    python3 tools/restore_split.py --src CHECKOUT/src --ckpt DIR [--label X]

Builds qwen3-1.7b at full width on the card from seed 0, saves it under
``DIR`` (once: a later run finds the complete save there and reuses it),
and restores it over ``chip_smoke.py``'s three throttled loopback mirrors,
the slowest killed mid-restore, checking every leaf bit for bit.  The
restore's sink class (``repro_torch.checkpoint.manager._StreamingRestore``
of the checkout under ``--src``) is timed method by method:

- ``init_s``: its constructor, which allocates the landing buffer (a
  zero-filled ``bytearray``, or page-locked memory);
- ``materialize_s``: its leaf copies, inside the transfer's event loop (a
  synchronous host-to-device copy, or the queueing of an asynchronous
  one);
- ``finish_s``: assembling the tree, with the wait for copies in flight.

The rest of the restore's wall time (``transfer_s``) is the manifest, the
sockets and the client.  Then the whole blob goes to the card once from
pageable and once from page-locked host memory (CUDA events), and a
``bytearray`` of its size is zero-filled, each timed alone.  Prints one
JSON line.  Run it for two checkouts in turns, in one call, to compare
them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch restores")
    ap.add_argument("--ckpt", required=True,
                    help="directory of the saved checkpoint (made if absent)")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("restore_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke
    import repro_torch.checkpoint.manager as manager
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import Decoder

    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-1.7b")
    source = Decoder(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    want = dict(tree_leaves(source.tree()))
    d = os.path.join(args.ckpt, "step_0000000001")
    if not os.path.exists(os.path.join(d, "manifest.json")):
        manager.save_checkpoint(args.ckpt, 1, source.tree())
    del source
    total = os.path.getsize(os.path.join(d, "data.bin"))

    timers = {"init_s": 0.0, "materialize_s": 0.0, "finish_s": 0.0,
              "materialize_calls": 0}
    cls = manager._StreamingRestore

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timers[name] += time.perf_counter() - t0
                if name == "materialize_s":
                    timers["materialize_calls"] += 1
        return wrapper

    cls.__init__ = timed("init_s", cls.__init__)
    cls._materialize = timed("materialize_s", cls._materialize)
    cls.finish = timed("finish_s", cls.finish)

    restored, run = chip_smoke.mirrored_restore(torch, cfg, dev, args.ckpt, d)
    leaves = chip_smoke.check_bit_exact(torch, want, restored, "restore")
    del restored, want
    torch.cuda.empty_cache()
    seconds = run["restore_s"]

    t0 = time.perf_counter()
    zeroed = bytearray(total)
    zero_fill_s = time.perf_counter() - t0
    pageable = torch.frombuffer(zeroed, dtype=torch.uint8)
    t0 = time.perf_counter()
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    pin_alloc_s = time.perf_counter() - t0
    dst = torch.empty(total, dtype=torch.uint8, device=dev)
    h2d = {}
    for name, src in (("pageable", pageable), ("pinned", pinned)):
        dst.copy_(src, non_blocking=True)       # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        h2d[name] = start.elapsed_time(end) / 1e3
    print(json.dumps({
        "phase": "restore_split", "label": args.label,
        "src": os.path.relpath(os.path.abspath(args.src), ROOT),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": chip_smoke.nvidia_smi(), "bytes": total,
        "restore_s": seconds, "gb_per_s": total / seconds / 1e9,
        **timers,
        "transfer_s": seconds - timers["init_s"] - timers["materialize_s"]
        - timers["finish_s"],
        "served_bytes_per_mirror": run["served_bytes_per_mirror"],
        "killed_after_s": run["killed_after_s"], "leaves": leaves,
        "bit_exact": True, "zero_fill_s": zero_fill_s,
        "pin_alloc_after_restore_s": pin_alloc_s,
        "h2d_pageable_s": h2d["pageable"], "h2d_pinned_s": h2d["pinned"]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
