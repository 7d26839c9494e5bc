"""Tile ops and the hand-written kernels (one module per kernel, each with
its plain PyTorch version and a launch counter)."""
from __future__ import annotations

from dlaf_tpu_torch.ops import panel_trsm, potrf, secular, trailing_update

#: the kernel modules, by the name chip_smoke.py and PERF.md use
KERNELS = {"potrf": potrf, "panel_trsm": panel_trsm, "trailing_update": trailing_update,
           "secular_bisect": secular}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}
