"""Hand-optimized kernels for the hot paths (the framework's "native"
layer — counterpart of the reference's ``cuda_kernels.py``, built as
XLA-fused scalar-unrolled programs and a Pallas GPU kernel, with the
backend policy in ``dispatch``).
"""

from .smallinalg import chol_factor_small, chol_solve_small, solve_spd_small

__all__ = ["chol_factor_small", "chol_solve_small", "solve_spd_small"]
