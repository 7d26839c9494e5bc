#!/usr/bin/env python3
"""Where the time of one ring collective goes on a 2x4 grid of rank threads.

    python3 scripts/ring_latency.py

Runs chip_smoke.py's B5 cases (M1's panel broadcast over 'c', 16 MiB, and
the diagonal tile over 'c', 1 MiB) on a 2x4 grid of rank threads on one
card and prints one JSON line per case and setting:

- span_ms, enqueue_ms: chip_smoke.grid_span_ms, the device time per call
  (the caller's stream sleeps on the card first, ``gate_s``, so that every
  rank thread has queued its calls; then the earliest rank's start event
  to the latest rank's end event, over the calls) and the slowest rank
  thread's host time to queue its calls (if it exceeds the gate, the span
  includes host time);
- kernel_ms: the ring kernels' own device durations (torch.profiler), mean
  and max over all ranks' launches, and their count;
- the interpreter's thread switch interval, and the same measurement with
  it set to 0.1 ms.

Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch  # noqa: F401  (before torch touches the card: its CUDA settings)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ring_latency: no CUDA device", flush=True)
        return 2
    import chip_smoke
    from dlaf_tpu_torch.comm import _ranks
    from dlaf_tpu_torch.comm.grid import Grid
    from dlaf_tpu_torch.ops import panel_exchange as px

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    pr, pc = chip_smoke.GRID_M
    grid = Grid.create((pr, pc), device=dev)
    nb, ltr = chip_smoke.NB, chip_smoke.N // chip_smoke.NB // pr
    iters = 20
    gen = torch.Generator(device=dev).manual_seed(0)

    def bcast(xl):
        return px.ring_bcast(xl, _ranks.current().axis("c")[0] == 1, "c")

    def run(x, gate_s):
        return chip_smoke.grid_span_ms(grid, bcast, [x], iters, gate_s)

    for name, shape in (("bcast_c", (ltr, nb, nb)), ("diag_c", (nb, nb))):
        x = torch.randn(pr, pc, *shape, generator=gen, device=dev)
        run(x, 0.05)  # warm-up: the ring state is made here
        for switch in (sys.getswitchinterval(), 1e-4):
            old = sys.getswitchinterval()
            sys.setswitchinterval(switch)
            try:
                for gate_s in (0.1, 1.0):
                    span, enq = run(x, gate_s)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        run(x, gate_s)
                    ks = [e.device_time_total / 1e3 for e in prof.events()
                          if "ring_kernel" in e.name and e.device_time_total > 0]
                    print(json.dumps({
                        "case": name, "payload_shape": list(shape), "ranks": pr * pc,
                        "iters": iters, "switch_interval_s": switch, "gate_s": gate_s,
                        "span_ms": span, "enqueue_ms": enq,
                        "kernel_ms_mean": sum(ks) / len(ks) if ks else None,
                        "kernel_ms_max": max(ks) if ks else None, "kernel_count": len(ks),
                        "card": card}), flush=True)
            finally:
                sys.setswitchinterval(old)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
