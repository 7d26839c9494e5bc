"""Block-cyclic distribution, stacked layout, and the distributed matrix."""
