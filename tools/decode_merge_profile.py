"""Time and profile decode_attention's partials merge on the card.

At qwen3-1.7b's B 1 x 32768-key cache cut into two blocks (KV 8, G 2, hd
128, bf16, pos 20000), the partials of both blocks are made once, then
``decode_attention_merge`` over them is timed with CUDA events over a CUDA
graph of calls and profiled with ``torch.profiler``: every device kernel
one merge call runs, with its device time.  The partials launch of the
block holding ``pos`` is timed beside it.

    python3 tools/decode_merge_profile.py --src CHECKOUT/src --label NAME

builds that checkout's kernels and prints one JSON line per number, then
the card's name and power limit.  To compare two checkouts, run it for
each in turns (a, b, b, a) in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASE = dict(B=1, KV=8, G=2, hd=128, S=32768, pos=20000, blocks=2)
ITERS = 50
PROFILED = 20


def graph_ms(torch, fn, iters: int = ITERS) -> float:
    """Device ms a call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_merge_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch.kernels as K
    from repro_torch.kernels._build import build

    build()
    dev = torch.device("cuda", 0)
    c = CASE
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn((c["B"], 1, c["KV"] * c["G"], c["hd"]))
    k = randn((c["B"], c["S"], c["KV"], c["hd"]))
    v = randn((c["B"], c["S"], c["KV"], c["hd"]))
    p = torch.tensor(c["pos"], dtype=torch.int32, device=dev)
    per = c["S"] // c["blocks"]
    blocks = [(k[:, i * per:(i + 1) * per].contiguous(),
               v[:, i * per:(i + 1) * per].contiguous(), i * per)
              for i in range(c["blocks"])]
    with torch.inference_mode():
        parts = torch.stack([K.decode_attention_partials(q, kb, vb, p,
                                                         k_off=off)
                             for kb, vb, off in blocks])
        kb, vb, off = blocks[c["pos"] // per]

        def merge():
            return K.decode_attention_merge(parts, q, c["KV"])

        out = {"label": args.label, "case": c,
               "slices": parts.shape[1] // (c["B"] * c["KV"] * c["G"]
                                            * (c["hd"] + 2)) * c["blocks"],
               "merge_ms": graph_ms(torch, merge),
               "partials_ms": graph_ms(
                   torch, lambda: K.decode_attention_partials(
                       q, kb, vb, p, k_off=off))}
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                merge()
            torch.cuda.synchronize()
        kernels = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if str(getattr(e, "device_type", "")).endswith("CUDA") \
                    and dev_us > 0:
                kernels.append({"kernel": e.key[:120],
                                "calls_a_merge": e.count / PROFILED,
                                "device_us_a_merge": dev_us / PROFILED})
        out["profile"] = sorted(kernels, key=lambda r: -r["device_us_a_merge"])
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
