"""Source-rank transparency for the algorithm entry points (counterpart of
``dlaf_tpu/algorithms/_origin.py``).

The distributed kernels assume that global tile (0, 0) lives on rank
(0, 0) (``_spmd.Geometry``).  A matrix of source rank ``(sr, sc)`` is
lifted to that origin by rolling its stacked tensor's two rank axes
(:meth:`DistributedMatrix.to_origin`), the wrapped algorithm runs
unchanged, and its matrix results are rolled back
(:meth:`DistributedMatrix.with_source_rank`).  In-place results land on
the caller's handles, as in the JAX package (``_origin.py:75-84``).

The JAX package relabels its mesh and moves nothing.  Every rank of the
port's grid lies on one device, so each roll is one device copy of the
matrix: one per operand on the way in, and one per operand the algorithm
wrote or returned on the way out.  An operand whose tensor the call did
not write (its version counter unchanged) is not copied back.
"""
from __future__ import annotations

import dataclasses
import functools

from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def _map_result(res, src, back: dict):
    """Matrix results (also inside tuples, lists and result dataclasses)
    under the caller's source rank; ``back`` maps the tensor of a lifted
    operand to the caller's handle that already holds it rolled back."""
    if isinstance(res, DistributedMatrix):
        orig = back.get(id(res.data))
        if orig is not None and orig.dist.size == res.dist.size:
            return DistributedMatrix(orig.dist, orig.grid, orig.data)
        return res.with_source_rank(src)
    if isinstance(res, tuple):
        return tuple(_map_result(v, src, back) for v in res)
    if isinstance(res, list):
        return [_map_result(v, src, back) for v in res]
    if dataclasses.is_dataclass(res) and not isinstance(res, type):
        ups = {f.name: _map_result(getattr(res, f.name), src, back)
               for f in dataclasses.fields(res)
               if isinstance(getattr(res, f.name), (DistributedMatrix, tuple, list))}
        return dataclasses.replace(res, **ups) if ups else res
    return res


def origin_transparent(fn):
    """Decorator of the public entry points: operands of a source rank
    other than (0, 0) are lifted to the origin, results and in-place
    writes are mapped back.  Origin calls pass through untouched.  Operands
    whose source ranks differ raise ``ValueError``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mats = [a for a in list(args) + list(kwargs.values()) if isinstance(a, DistributedMatrix)]
        srcs = {tuple(m.dist.source_rank) for m in mats}
        if not mats or srcs == {(0, 0)}:
            return fn(*args, **kwargs)
        if len(srcs) > 1:
            raise ValueError(f"operands disagree on source rank: {sorted(srcs)}; all "
                             "matrices of one call must share it")
        src = next(iter(srcs))
        views = {}  # id(caller's handle) -> (handle, lifted view, its tensor, version)

        def lift(a):
            if isinstance(a, DistributedMatrix):
                if id(a) not in views:
                    v = a.to_origin()
                    views[id(a)] = (a, v, v.data, v.data._version)
                return views[id(a)][1]
            return a

        out = fn(*[lift(a) for a in args], **{k: lift(v) for k, v in kwargs.items()})
        back = {}
        for orig, view, data, version in views.values():
            if view.data is data and data._version == version:
                continue  # only read: the caller's tensor is still right
            orig._inplace(DistributedMatrix(view.dist, view.grid, view.data)
                          .with_source_rank(src).data)
            back[id(view.data)] = orig
        return _map_result(out, src, back)

    return wrapped
