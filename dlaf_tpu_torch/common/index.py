"""Strong-ish 2D index/size helpers.

A verbatim copy of ``dlaf_tpu/common/index.py``.  Analogue of the reference's ``common::Index2D``/``Size2D``
(reference: include/dlaf/common/index2d.h, include/dlaf/common/range2d.h).
The reference uses tag-parameterized C++ types so Global/Local element/tile
indices can't mix; in Python we keep lightweight named tuples plus an
``iterate_range2d`` generator.  Row-major iteration order matches
``common::iterate_range2d`` (range2d.h).
"""
from __future__ import annotations

from typing import Iterator, NamedTuple


class Index2D(NamedTuple):
    """(row, col) index. ``Coord.Row`` is element 0, ``Coord.Col`` element 1."""

    row: int
    col: int

    def is_in(self, size: "Size2D") -> bool:
        return 0 <= self.row < size.rows and 0 <= self.col < size.cols

    def transposed(self) -> "Index2D":
        return Index2D(self.col, self.row)


class Size2D(NamedTuple):
    rows: int
    cols: int

    def is_empty(self) -> bool:
        return self.rows == 0 or self.cols == 0

    def count(self) -> int:
        return self.rows * self.cols

    def transposed(self) -> "Size2D":
        return Size2D(self.cols, self.rows)


class Coord:
    """Mirror of ``dlaf::common::Coord`` (index2d.h)."""

    Row = 0
    Col = 1


def iterate_range2d(begin_or_size, size=None) -> Iterator[Index2D]:
    """Iterate all Index2D in a 2D range, col-major (like the reference).

    ``iterate_range2d(size)`` iterates ``[0, size)``;
    ``iterate_range2d(begin, end)`` iterates ``[begin, end)``.

    Reference iterates with col as the slow index (range2d.h); we match so
    ported test expectations line up.
    """
    if size is None:
        begin = Index2D(0, 0)
        end = Index2D(begin_or_size[0], begin_or_size[1])
    else:
        begin = Index2D(begin_or_size[0], begin_or_size[1])
        end = Index2D(begin[0] + size[0], begin[1] + size[1])
    for col in range(begin.col, end.col):
        for row in range(begin.row, end.row):
            yield Index2D(row, col)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
