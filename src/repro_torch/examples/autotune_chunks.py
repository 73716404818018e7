"""Automatic chunk-size selection, the paper's §VIII-A future work, live
(port of ``examples/autotune_chunks.py``).

The on-device simulator evaluates the Table-II grid for the currently
observed mirror throughputs, and the framework adopts the winner for
later transfers.  The whole (C, L) x seed sweep is one lane batch on the
device, on the round-synchronous core.  The batched API stacks a
scenario axis on top: the second demo tunes a fleet of drifted mirror
conditions in one call.  The last demo goes finer than any grid: an
autograd polish of the grid winner through the differentiable scan core.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_chunks
      (``--device cpu`` without a card)
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.autotune import (autotune_batch, autotune_chunk_params,
                                       tune_chunk_params_grad)
from repro_torch.core.scenarios import GB, MBPS, paper_baseline

MB = 1024 * 1024


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    servers = paper_baseline()
    bw = [s.bandwidth for s in servers]
    print("observed mirror throughputs (MiB/s):",
          [round(b / MBPS, 1) for b in bw])

    out = {"grid": {}}
    for size_gb in (2, 32):
        res = autotune_chunk_params(bw, rtt=0.03, file_size=size_gb * GB,
                                    device=dev)
        c, l = res.params.initial_chunk, res.params.large_chunk
        worst = max(res.predicted_times)
        print(f"\n--- {size_gb} GB file ---")
        print(res.as_table())
        print(f"best: C={c // MB} MB, L={l // MB} MB "
              f"-> {res.predicted_time:.1f}s "
              f"(worst grid point {worst:.1f}s, "
              f"{(worst - res.predicted_time) / worst * 100:.0f}% saved)")
        out["grid"][size_gb] = (c, l, res.predicted_time)

    # --- batched: tune many drifted scenarios in one device call ---------
    rng = np.random.default_rng(0)
    drift = rng.uniform(0.3, 1.7, size=(8, len(bw)))
    scenarios = np.asarray(bw)[None, :] * drift
    results = autotune_batch(scenarios, rtt=0.03, file_size=2 * GB,
                             device=dev)
    print("\n--- 8 drifted scenarios, one call (2 GB file) ---")
    print("scenario,winner_C(MB),winner_L(MB),predicted_s")
    out["batch"] = []
    for i, r in enumerate(results):
        print(f"{i},{r.params.initial_chunk // MB},"
              f"{r.params.large_chunk // MB},{r.predicted_time:.1f}")
        out["batch"].append((r.params.initial_chunk, r.params.large_chunk,
                             r.predicted_time))

    # --- beyond the grid: an autograd polish on the scan core ------------
    grid_res = autotune_chunk_params(bw, rtt=0.03, file_size=2 * GB,
                                     device=dev)
    polished = tune_chunk_params_grad(
        bw, rtt=0.03, file_size=2 * GB,
        init=(grid_res.params.initial_chunk, grid_res.params.large_chunk),
        steps=40, device=dev)
    print("\n--- gradient polish of the grid winner (2 GB file) ---")
    print(f"grid:     C={grid_res.params.initial_chunk / MB:.1f} MB, "
          f"L={grid_res.params.large_chunk / MB:.1f} MB "
          f"-> {grid_res.predicted_time:.2f}s")
    print(f"polished: C={polished.params.initial_chunk / MB:.1f} MB, "
          f"L={polished.params.large_chunk / MB:.1f} MB "
          f"-> {polished.predicted_time:.2f}s "
          f"({polished.steps} Adam steps, "
          f"dT/dL={polished.final_grad[1]:.2e} s/byte)")
    out["polished"] = (polished.params.initial_chunk,
                       polished.params.large_chunk, polished.predicted_time)
    out["polish_init_s"] = grid_res.predicted_time
    return out


if __name__ == "__main__":
    main()
