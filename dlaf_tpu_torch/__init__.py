"""dlaf_tpu_torch: the PyTorch/CUDA port of dlaf_tpu.

A second package beside the JAX one (``dlaf_tpu/``, the reference it is
held against): the same 2D block-cyclic data model
(``X[Pr, Pc, ltr, ltc, mb, nb]``), the same algorithms, and hand-written
CUDA kernels for Hopper where the JAX package has Pallas kernels.  This
package runs distributed Cholesky (L and U, with shift recovery), the
triangular solves (both sides), POTRS/POSV (with residual refinement,
``refine_to``, and the mixed-precision solver), the triangular inverse and
POTRI, the multiplication family (GEMM, TRMM, HEMM, and the product of
sub-matrix windows, ``MatrixRef``), row and column permutations, the
Hermitian eigensolver pipeline (reduction to band, SBR, the host bulge
chase, the distributed D&C tridiagonal solver with the secular-bisection
kernel, and the three back-transforms; partial spectra and eigenvalues
only), the mixed-precision eigensolver (the pipeline in float32, then
Ogita-Aishima refinement) and the generalized eigensolver (Cholesky of B,
the reduction to standard form, back-substitution) on any ``Pr x Pc`` grid
of ranks on one card, under any split-GEMM tier of
``tune.gemm_precision``, with the potrf, panel-TRSM and trailing-update
kernels, under the 'pallas' collectives tier the ring kernels (hop merge,
ring exchange, fused factor-and-send), and under the 'fused'
trailing-update tier the ring consumers (the consume ring and the
one-launch lookahead step) and the panel contraction.  Kernels live in
``ops/`` with their CUDA sources in ``csrc/``; the host chase's C++ source
is ``csrc/host/band2trid.cpp`` (``native.py``).

Entry points run on the CUDA device unless the caller passes
``Grid.create(device="cpu")``, where every kernel wrapper takes its plain
PyTorch version.  Matrices of any source rank are taken: the entry points
lift them to rank (0, 0) and back (``algorithms/_origin.py``).  The
package imports ``torch``, numpy, scipy and the standard library only; it
never imports JAX or the JAX package.

A ``Pr x Pc`` grid runs its ranks as threads of this process, each on its
own CUDA stream (``comm/_ranks.py``), and the ring kernels of one
collective spin on each other.  Two CUDA defaults can put a spinning
kernel in front of the one it waits for: lazy module loading (the first
launch of a kernel may wait for the running ones) and 8 hardware queues
shared by all streams.  So, unless the environment says otherwise, the
package asks for eager loading and 32 queues at import
(``_ranks.request_cuda_env``); both take effect only if CUDA has not been
initialised yet in the process, and a multi-rank grid on the card raises
``ConfigurationError`` when they did not.
"""
from dlaf_tpu_torch.comm import _ranks as _ranks

_ranks.request_cuda_env()
from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization  # noqa: E402
from dlaf_tpu_torch.algorithms.eig_refine import (
    EigRefineInfo,
    hermitian_eigensolver_mixed,
    refine_eigenpairs,
    refine_partial_eigenpairs,
)
from dlaf_tpu_torch.algorithms.eigensolver import (
    EigResult,
    hermitian_eigensolver,
    hermitian_eigenvalues,
    hermitian_generalized_eigensolver,
)
from dlaf_tpu_torch.algorithms.gen_to_std import generalized_to_standard
from dlaf_tpu_torch.algorithms.inverse import inverse_from_cholesky_factor, triangular_inverse
from dlaf_tpu_torch.algorithms.multiplication import (
    general_multiplication,
    general_sub_multiplication,
    hermitian_multiplication,
    triangular_multiplication,
)
from dlaf_tpu_torch.algorithms.norm import max_norm
from dlaf_tpu_torch.algorithms.permutations import permute
from dlaf_tpu_torch.algorithms.reduction_to_band import reduction_to_band
from dlaf_tpu_torch.algorithms.solver import (
    MixedSolveInfo,
    cholesky_solver,
    positive_definite_solver,
    positive_definite_solver_mixed,
)
from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.matrix.ref import MatrixRef

__all__ = [
    "Grid",
    "DistributedMatrix",
    "MatrixRef",
    "cholesky_factorization",
    "triangular_solver",
    "cholesky_solver",
    "positive_definite_solver",
    "triangular_inverse",
    "inverse_from_cholesky_factor",
    "general_multiplication",
    "general_sub_multiplication",
    "triangular_multiplication",
    "hermitian_multiplication",
    "max_norm",
    "permute",
    "MixedSolveInfo",
    "positive_definite_solver_mixed",
    "hermitian_eigensolver",
    "hermitian_eigenvalues",
    "hermitian_eigensolver_mixed",
    "refine_eigenpairs",
    "refine_partial_eigenpairs",
    "EigRefineInfo",
    "hermitian_generalized_eigensolver",
    "generalized_to_standard",
    "EigResult",
    "reduction_to_band",
]
