"""Tile ops and the hand-written kernels (one module per kernel, or per
family of kernels, each with its plain PyTorch version and launch
counters)."""
from __future__ import annotations

from dlaf_tpu_torch.ops import panel_exchange, panel_trsm, potrf, secular, trailing_update

#: the kernels, by the name chip_smoke.py and PERF.md use: (module, name of
#: its launch counter)
KERNELS = {
    "potrf": (potrf, "launches"),
    "panel_trsm": (panel_trsm, "launches"),
    "trailing_update": (trailing_update, "launches"),
    "secular_bisect": (secular, "launches"),
    "merge_hop": (panel_exchange, "merge_launches"),
    "ring_exchange": (panel_exchange, "ring_launches"),
    "fused_factor_bcast": (panel_exchange, "fused_launches"),
    "dma_ring_consume": (trailing_update, "consume_launches"),
    "fused_step": (trailing_update, "step_launches"),
    "panel_contract": (trailing_update, "contract_launches"),
}


#: counters beside KERNELS': the cluster kernel's share of B1's launches,
#: and the split-tier body's share of B3's, B9's, B6's and B8's
SUB_COUNTS = {
    "potrf_cluster": (potrf, "cluster_launches"),
    "trailing_update_split": (trailing_update, "split_launches"),
    "panel_contract_split": (trailing_update, "split_contract_launches"),
    "dma_ring_consume_split": (trailing_update, "consume_split_launches"),
    "fused_step_split": (trailing_update, "fused_step_split_launches"),
}


def reset_launch_counts() -> None:
    for mod, attr in (*KERNELS.values(), *SUB_COUNTS.values()):
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def sub_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in SUB_COUNTS.items()}
