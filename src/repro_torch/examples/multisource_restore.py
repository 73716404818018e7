"""Multi-source checkpoint restore with a mirror failure mid-transfer
(port of ``examples/multisource_restore.py``).

The production scenario this framework exists for: a preempted node (or a
whole re-scaled job) pulls its checkpoint from R replicated stores with
MDTP adaptive chunking, and one store dies while still owing bytes.  The
outstanding range returns to the pool, the surviving mirrors absorb it,
and every byte is still fetched exactly once.  Each leaf lands on
``--device`` as its byte range completes.

Run:  PYTHONPATH=src python -m repro_torch.examples.multisource_restore
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch.train import start_mirror, stop_mirror
from repro_torch.models.common import tree_leaves
from repro_torch.transfer import Replica

MB = 1024 * 1024
STEP = 1234


def make_state() -> dict:
    """The ~64 MB "model" state: eight f32 ``[1024, 2048]`` leaves from a
    seeded generator, and the step."""
    gen = torch.Generator().manual_seed(0)
    return {"params": {f"layer{i}": torch.randn((1024, 2048), generator=gen)
                       for i in range(8)},
            "step": torch.tensor(STEP, dtype=torch.int32)}


def main(argv=None, *, mirror=start_mirror) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    state = make_state()
    with tempfile.TemporaryDirectory() as root:
        d = save_checkpoint(root, STEP, state)
        size = os.path.getsize(os.path.join(d, "data.bin"))
        print(f"checkpoint written: {size >> 20} MiB")

        blobs = {}
        for name in ("manifest.json", "data.bin"):
            with open(os.path.join(d, name), "rb") as f:
                blobs[f"/ckpt/step_{STEP:010d}/{name}"] = f.read()
        mirrors, timer = [], None
        try:
            for bw in (20 * MB, 40 * MB, 80 * MB):
                mirrors.append(mirror(blobs, bw))
            # the slowest mirror dies 200 ms into the restore
            timer = threading.Timer(0.2, stop_mirror, (mirrors[0],))
            timer.start()
            replicas = [Replica("127.0.0.1", s.port, "/ckpt")
                        for s in mirrors]
            restored, step = restore_checkpoint(root, state, step=STEP,
                                                replicas=replicas,
                                                device=dev)
        finally:
            if timer is not None:
                timer.cancel()
                timer.join()
            for s in mirrors:
                stop_mirror(s)
        want, got = dict(tree_leaves(state)), dict(tree_leaves(restored))
        on_device = all(t.device.type == dev.type for t in got.values())
        ok = want.keys() == got.keys() and all(
            torch.equal(want[k], got[k].cpu()) for k in want)
        print(f"restored step {step} onto {dev}; bit-exact: {ok} "
              f"(one mirror was killed mid-transfer)")
        assert ok and on_device and step == STEP
    return {"bytes": size, "step": step, "bit_exact": ok,
            "leaves": len(got), "device": str(dev)}


if __name__ == "__main__":
    main()
