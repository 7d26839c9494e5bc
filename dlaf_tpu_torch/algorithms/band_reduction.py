"""Successive band reduction (SBR): band b1 -> band b2 on the device
(counterpart of ``dlaf_tpu/algorithms/band_reduction.py``).

The second reduction stage between ``reduction_to_band`` (dense -> b1) and
the host bulge chase (b2 -> tridiagonal): it shrinks the host chase's
O(N^2 b) cost by b1/b2.  Sweeps over column blocks ``[c, c+b2)``: each
sweep QR-eliminates rows ``[c+b2, c+b1+b2)`` of its block, then chases the
bulge: every chase step QRs the b1 x b1 fill block and applies Q two-sided
inside a sliding dense 3*b1 window of the band, held in compact
``[2*b1, n_pad]`` storage.  A zero block keeps ``Q = I``: the QR of a zero
block may return any orthogonal Q, and mixing rows that still hold band
data would break the band.

The JAX package runs each sweep chunk as one jitted loop with every
sweep's chase length rounded up to a bucket (the extra steps meet zero
blocks and store identity); here each sweep runs eagerly and stops at its
own chase bound, and the slots past it keep the identity they are
initialised with, so the stored Q chunks are the same.  The chunks stay
on the device (the JAX package stages them to the host to spare TPU HBM;
at N=8192 they take about 1 GiB of the card's 80 GB).

``sbr_back_transform`` applies ``E := Q_sbr E`` to the column panels of
the back-transform chain (``matrix/colpanels.py``), once per rank on its
own columns (``coll.spmd``), as each JAX device does: sweeps in reverse,
each as one batched product over its disjoint row windows, skipping the
identity slots (an exact no-op).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.matrix import colpanels as cpan

_CHUNK = 16  # sweeps per chunk
_K_ROUND = 16  # chase-step bucket granularity (the JAX package's compile bound)


@dataclass(frozen=True)
class SbrTransforms:
    """Q blocks of one SBR run in sweep chunks: ``chunks[i] = (s0, q)`` with
    ``q[t, k]`` the b1 x b1 block acting on global rows
    ``(s0+t)*b2 + b2 + k*b1`` .. +b1; slots past a sweep's chase hold
    identity.  ``steps[s]`` is sweep s's chase bound."""

    chunks: List[Tuple[int, torch.Tensor]]
    n: int
    b1: int
    b2: int
    steps: Tuple[int, ...] = ()

    @property
    def n_sweeps(self) -> int:
        return sum(q.shape[0] for _, q in self.chunks)


def _n_sweeps(n: int, b2: int) -> int:
    return max(0, -(-(n - b2 - 1) // b2))


def _chase_bound(n: int, c: int, b1: int, b2: int) -> int:
    """Chase steps (k >= 1) of the sweep at column c, an upper bound: every
    step past it meets a zero block."""
    return max(0, -(-(n - c - b2) // b1))


def _sweep_chunks(n: int, b1: int, b2: int):
    """The JAX package's chunks [(s0, s1, K)]: K is the chase bucket of the
    chunk's first (longest) sweep, rounded up to _K_ROUND."""
    ns = _n_sweeps(n, b2)
    out = []
    s0 = 0
    while s0 < ns:
        s1 = min(ns, s0 + _CHUNK)
        k = _chase_bound(n, s0 * b2, b1, b2)
        k = min(-(-k // _K_ROUND) * _K_ROUND, _chase_bound(n, 0, b1, b2))
        out.append((s0, s1, max(k, 1)))
        s0 = s1
    return out


class _Window:
    """Index tables of the dense 3*b1 window over compact [2*b1, .] storage."""

    def __init__(self, b1: int, device):
        W, S = 3 * b1, 2 * b1
        ii = torch.arange(W, device=device)[:, None]
        jj = torch.arange(W, device=device)[None, :]
        dd = ii - jj
        self.lower = (dd >= 0) & (dd < S)
        self.upper = dd < 0
        self.dl = torch.clamp(dd, 0, S - 1)
        self.du = torch.clamp(-dd, 0, S - 1)
        self.jj = jj.expand(W, W)
        self.ii = ii.expand(W, W)
        sd = torch.arange(S, device=device)[:, None]
        sj = torch.arange(W, device=device)[None, :]
        self.s_valid = sd + sj < W
        self.s_row = torch.clamp(sd + sj, 0, W - 1)
        self.sj = sj.expand(S, W)
        self.W, self.S = W, S

    def densify(self, abw):
        """M[i, j] = A[w0+i, w0+j]: the lower part from abw[i-j, j], the
        upper part by symmetry."""
        low = abw[self.dl, self.jj]
        up = abw[self.du, self.ii].conj()
        zero = torch.zeros((), dtype=abw.dtype, device=abw.device)
        return torch.where(self.lower, low, torch.where(self.upper, up, zero))

    def scatter(self, abw, M):
        return torch.where(self.s_valid, M[self.s_row, self.sj], abw)


def _step(ab, win: _Window, w0: int, row_off: int, col_w: int, b1: int, eye):
    """One QR step on the window at column ``w0``; updates ``ab`` in place
    and returns the block's Q."""
    abw = ab[:, w0:w0 + win.W]
    M = win.densify(abw)
    B = M[row_off:row_off + b1, 0:col_w]
    Q = torch.linalg.qr(B, mode="complete").Q
    Q = torch.where(B.abs().amax() > 0, Q, eye)
    rows = slice(row_off, row_off + b1)
    M[rows, :] = Q.conj().transpose(0, 1) @ M[rows, :]
    M[:, rows] = M[:, rows] @ Q
    ab[:, w0:w0 + win.W] = win.scatter(abw, M)
    return Q


def sbr_reduce(ab_in, b1: int, b2: int, want_q: bool = True):
    """Reduce the compact lower-band matrix ``ab_in`` (``[>= b1+1, n]``,
    ``ab[d, j] = A[j+d, j]``; a tensor, on the device it runs on, or numpy)
    from band b1 to band b2.  Returns ``(ab2, tr)``: ``ab2[b2+2, n]`` host
    numpy storage for the chase (last row zero scratch) and the
    :class:`SbrTransforms` (no chunks when ``want_q`` is False).  Requires
    ``1 <= b2 < b1``."""
    if not isinstance(ab_in, torch.Tensor):
        ab_in = torch.from_numpy(np.ascontiguousarray(ab_in))
    dev, dt = ab_in.device, ab_in.dtype
    n = ab_in.shape[1]
    if not (1 <= b2 < b1):
        raise ValueError(f"sbr_reduce: need 1 <= b2 < b1, got {b1} -> {b2}")
    chunks = _sweep_chunks(n, b1, b2)
    rows_in = min(ab_in.shape[0], b1 + 1)
    np_dt = torch.empty(0, dtype=dt).numpy().dtype
    if not chunks:
        ab2 = np.zeros((b2 + 2, n), np_dt)
        ab2[: min(rows_in, b2 + 1)] = ab_in[: min(rows_in, b2 + 1)].cpu().numpy()
        return ab2, SbrTransforms([], n, b1, b2)
    n_pad = n + 4 * b1 + b2
    ab = torch.zeros((2 * b1, n_pad), dtype=dt, device=dev)
    ab[:rows_in, :n] = ab_in[:rows_in]
    win = _Window(b1, dev)
    eye = torch.eye(b1, dtype=dt, device=dev)
    out_chunks: List[Tuple[int, torch.Tensor]] = []
    steps = []
    for (s0, s1, K) in chunks:
        q = eye.expand(s1 - s0, K + 1, b1, b1).clone() if want_q else None
        for s in range(s0, s1):
            c = s * b2
            Q0 = _step(ab, win, c, b2, b2, b1, eye)
            kmax = min(K, _chase_bound(n, c, b1, b2))
            steps.append(kmax)
            if want_q:
                q[s - s0, 0] = Q0
            for k in range(1, kmax + 1):
                Q = _step(ab, win, c + b2 + (k - 1) * b1, b1, b1, b1, eye)
                if want_q:
                    q[s - s0, k] = Q
        if want_q:
            out_chunks.append((s0, q))
    ab2 = np.zeros((b2 + 2, n), np_dt)
    ab2[: b2 + 1] = ab[: b2 + 1, :n].cpu().numpy()
    return ab2, SbrTransforms(out_chunks, n, b1, b2, tuple(steps))


def sbr_back_transform(tr: SbrTransforms, mat_e, out_cols: bool = False):
    """E := Q_sbr E.  ``mat_e`` is a stacked DistributedMatrix or the
    :class:`ColPanels` of the previous back-transform stage; ``out_cols``
    returns ColPanels for the next stage instead of packing."""
    in_cols = isinstance(mat_e, cpan.ColPanels)
    if tr.n_sweeps == 0:
        if in_cols:
            return mat_e if out_cols else cpan.pack_to_matrix(mat_e)
        return mat_e
    n = mat_e.n if in_cols else mat_e.dist.size.rows
    if n != tr.n:
        raise ValueError(f"sbr_back_transform: E rows {n} != transform n {tr.n}")
    b1, b2 = tr.b1, tr.b2
    # every sweep's [r0, r0 + span) slice must fit without clamping
    n_pad = max(n, max((s0 + q.shape[0] - 1) * b2 + b2 + q.shape[1] * b1 for s0, q in tr.chunks))
    cp = cpan.pad_rows(mat_e, n_pad) if in_cols else cpan.from_matrix(mat_e, n_pad)

    def body(e):
        """Every sweep on this rank's column panel ``e[rows, kloc]``."""
        for s0, q in reversed(tr.chunks):
            for s_loc in range(q.shape[0] - 1, -1, -1):
                s = s0 + s_loc
                nblk = (tr.steps[s] if tr.steps else q.shape[1] - 1) + 1
                r0 = s * b2 + b2
                ew = e[r0:r0 + nblk * b1].view(nblk, b1, e.shape[1])
                ew.copy_(torch.bmm(q[s_loc, :nblk], ew))

    coll.spmd(cp.grid, body, cp.data)
    if out_cols:
        return cp
    out = cpan.pack_to_matrix(cp)
    return out if in_cols else mat_e._inplace(out.data)
