#!/usr/bin/env python3
"""What eight rank threads pay for launching eagerly at the same time.

    python3 scripts/rank_contention.py

On one card, prints one JSON line each for:

- the Cholesky pivot scan (``algorithms/cholesky._pivot_scan``, a few
  thousand small launches) of one nb x nb tile: issued once by one thread,
  eight times in a row by one thread, and once by each of eight threads at
  the same time, each thread on its own stream (the rank runtime's
  layout);
- ``cholesky_factorization`` on chip_smoke.py's 2x4 grid of rank threads at
  N = chip_smoke.N_TIERS, bucketed, under the v2 and the pallas
  collectives tiers: without the info, with it (each diagonal tile's
  owner scans it), and with every rank scanning every diagonal tile where
  the kernel receives it (``_spmd.bcast_diag_tile`` wrapped here), as the
  JAX package's ranks do: wall time, and per rank thread its wall and CPU
  time in the kernel body and its time waiting on the host for other
  ranks (``_ranks.World.wait``).

Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch as dtt  # before torch touches the card (its CUDA settings)
    import torch

    if not torch.cuda.is_available():
        print("rank_contention: no CUDA device", flush=True)
        return 2
    import chip_smoke
    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.algorithms import _spmd, cholesky
    from dlaf_tpu_torch.comm import _ranks

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    n, nb = chip_smoke.N_TIERS, chip_smoke.NB
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    g = torch.randn(n, n, generator=gen, device=dev)
    a = g @ g.T / n
    a.diagonal().add_(1.0)
    del g

    # ---- the pivot scan: one thread against eight at once
    d = a[:nb, :nb].contiguous()
    threads_n = chip_smoke.GRID_M[0] * chip_smoke.GRID_M[1]
    streams = [torch.cuda.Stream() for _ in range(threads_n)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def at_once():
        def one(i):
            with torch.cuda.stream(streams[i]):
                cholesky._pivot_scan(d)
        ts = [threading.Thread(target=one, args=(i,)) for i in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    cholesky._pivot_scan(d)  # warm-up
    print(json.dumps({
        "case": "pivot_scan", "nb": nb, "threads": threads_n,
        "one_scan_s": timed(lambda: cholesky._pivot_scan(d)),
        "scans_in_a_row_one_thread_s": timed(
            lambda: [cholesky._pivot_scan(d) for _ in range(threads_n)]),
        "one_scan_per_thread_at_once_s": timed(at_once),
        "switch_interval_s": sys.getswitchinterval(), "card": card}), flush=True)

    # ---- the factorization with its info, per rank thread
    stats, lock = {}, threading.Lock()
    wait0, kern0 = _ranks.World.wait, cholesky._chol_L_bucketed

    def wait(self, cond, pred, label):
        t0 = time.perf_counter()
        try:
            return wait0(self, cond, pred, label)
        finally:
            with lock:
                st = stats.setdefault(threading.current_thread().name, {"wait_s": 0.0})
                st["wait_s"] += time.perf_counter() - t0

    def kern(x, g_, want_info):
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            return kern0(x, g_, want_info)
        finally:
            with lock:
                st = stats.setdefault(threading.current_thread().name, {"wait_s": 0.0})
                st["body_wall_s"] = time.perf_counter() - t0
                st["body_cpu_s"] = time.thread_time() - c0

    bcast0 = _spmd.bcast_diag_tile

    def bcast_and_scan(*args):
        d_ = bcast0(*args)
        cholesky._pivot_scan(d_)
        return d_

    _ranks.World.wait, cholesky._chol_L_bucketed = wait, kern
    grid = dtt.Grid.create(chip_smoke.GRID_M)

    def factor(tier, info, every_rank=False):
        tune.initialize(collectives_impl=tier, panel_trsm_pallas=True)
        _spmd.bcast_diag_tile = bcast_and_scan if every_rank else bcast0
        mat = dtt.DistributedMatrix.from_global(grid, a, (nb, nb))
        torch.cuda.synchronize()
        stats.clear()
        t0 = time.perf_counter()
        out = dtt.cholesky_factorization("L", mat, backend="distributed", return_info=info)
        got = int(out[1]) if info else None
        torch.cuda.synchronize()
        return time.perf_counter() - t0, got

    for tier in ("v2", "pallas"):
        factor(tier, False)  # warm-up: the ring states are made here
    for tier in ("v2", "pallas"):
        for info, every in ((False, False), (True, False), (False, True)):
            wall, got = factor(tier, info, every)
            print(json.dumps({
                "case": "cholesky_factorization", "n": n, "nb": nb,
                "grid": list(chip_smoke.GRID_M), "tier": tier, "return_info": info,
                "every_rank_scans": every, "info": got, "wall_s": wall,
                "threads": {k: v for k, v in sorted(stats.items())}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
