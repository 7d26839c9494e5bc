#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 scripts/port_profile.py [PATH ...]   # A B M1 M4 M5 H; all by default

Runs the factorization paths of chip_smoke.py (A: bucketed, panel-TRSM
kernel on; B: lookahead, fused trailing-update tier; M1: A's knobs on a
2x4 grid of rank threads under collectives_impl=pallas; M4 and M5: the
lookahead kernel under the fused tier on that grid, at nb=512 and 192),
on its inputs and its knobs (chip_smoke.N, NB, NB_M5, make_inputs,
PATH_A, PATH_B, GRID_M, PATH_M1, PATH_M4), and its HEEV path H (the
pipeline on 1x1; NH, NBH, SEED_H, PATH_H; the card's activity only), once
as warm-up and once under torch.profiler, then prints one
JSON line per path: wall time, device time summed over kernels, the
union of the kernels' intervals on the card's timeline (on M1 the ranks'
streams overlap, and a ring kernel that spins on a late neighbour counts
as busy), the device's idle share of the wall time (1 - union / wall),
and device time by kernel group (the port's kernels, library GEMMs,
everything else) and by the top kernel names.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (
    ("fused_step", "fused_step_kernel"),
    ("dma_ring_consume", "consume_kernel"),
    ("panel_contract", "panel_contract_kernel"),
    ("panel_contract", "panel_contract_fma_kernel"),
    ("ring_exchange", "pull_kernel"),
    ("ring_exchange", "ring_kernel"),
    ("fused_factor_bcast", "fused_kernel"),
    ("potrf", "potrf_cluster_kernel"),
    ("potrf", "potrf_kernel"),
    ("panel_trsm", "panel_trsm_kernel"),
    ("panel_trsm", "panel_trsm_rows_kernel"),
    ("trailing_update", "trailing_update_kernel"),
    ("trailing_update", "trailing_update_fma_kernel"),
    ("secular_bisect", "secular_bisect_kernel"),
    ("library_gemm", "gemm"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, key in GROUPS:
        if key in low:
            return group
    return "other"


def busy_ms(prof) -> float:
    """Length of the union of the CUDA kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.time_range.end > e.time_range.start)
    total, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> int:
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch as dtt  # before torch touches the card (its CUDA settings)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", flush=True)
        return 2
    import numpy as np

    import chip_smoke
    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.testing import random_hermitian_pd

    card = chip_smoke.card_line()
    n, nb = chip_smoke.N, chip_smoke.NB
    nh, nbh = chip_smoke.NH, chip_smoke.NBH
    a, _ = chip_smoke.make_inputs(torch.device("cuda"))

    paths = (("A", chip_smoke.PATH_A, (1, 1), nb), ("B", chip_smoke.PATH_B, (1, 1), nb),
             ("M1", chip_smoke.PATH_M1, chip_smoke.GRID_M, nb),
             ("M4", chip_smoke.PATH_M4, chip_smoke.GRID_M, nb),
             ("M5", chip_smoke.PATH_M4, chip_smoke.GRID_M, chip_smoke.NB_M5),
             ("H", chip_smoke.PATH_H, (1, 1), nbh))
    wanted = set(sys.argv[1:]) or {p[0] for p in paths}
    a_h = None
    for name, knobs, shape, nb in paths:
        if name not in wanted:
            continue
        tune.initialize(**knobs)
        grid = dtt.Grid.create(shape)
        heev = name == "H"
        if heev and a_h is None:
            a_h = torch.from_numpy(np.tril(random_hermitian_pd(nh, np.float32, seed=chip_smoke.SEED_H)))
            a_h = a_h.cuda()

        def run():
            mat = dtt.DistributedMatrix.from_global(grid, a_h if heev else a, (nb, nb))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if heev:
                dtt.hermitian_eigensolver("L", mat, backend="pipeline")
            else:
                dtt.cholesky_factorization("L", mat, backend="distributed")
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()  # warm-up
        # the HEEV path's host makes hundreds of thousands of eager calls:
        # their CPU events would slow the run and the trace's processing,
        # so only the card's are recorded
        acts = [ProfilerActivity.CUDA] if heev else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            wall = run()
        by_name = {}
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total", 0) or 0
            if t > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
                by_name[evt.key] = by_name.get(evt.key, 0.0) + t / 1e3  # us -> ms
        groups = {}
        for k, ms in by_name.items():
            groups[group_of(k)] = groups.get(group_of(k), 0.0) + ms
        device_ms = sum(by_name.values())
        union_ms = busy_ms(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "path": name, "config": knobs, "grid": list(shape), "n": nh if heev else n, "nb": nb,
            "card": card,
            "wall_ms_profiled": wall * 1e3, "device_ms": device_ms, "busy_union_ms": union_ms,
            "idle_share": (1 - union_ms / (wall * 1e3)) if union_ms else None,
            "groups_ms": groups,
            "top_kernels_ms": [[k[:90], ms] for k, ms in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
