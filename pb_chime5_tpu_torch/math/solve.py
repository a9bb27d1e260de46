"""Batched np.linalg.solve with per-matrix least-squares fallback
(reference: pb_chime5/math/solve.py:20-114).

The device-side jittable counterpart is
pb_chime5_tpu_torch.ops.linalg.stable_solve (pinv fallback); this NumPy version
keeps the reference's exact semantics (lstsq on the singular matrices
only) for host-side code and validation.

The port's copy of ``pb_chime5_tpu/math/solve.py``.
"""

import numpy as np

__all__ = ['stable_solve']


def _lstsq(A, B):
    return np.linalg.lstsq(A, B, rcond=None)[0]


def stable_solve(A, B):
    """Solve A X = B batched; singular batch entries fall back to lstsq.

    >>> A = np.zeros((2, 2)); B = np.ones((2, 2))
    >>> stable_solve(A, B).shape
    (2, 2)
    """
    A = np.asarray(A)
    B = np.asarray(B)
    assert A.shape[:-2] == B.shape[:-2], (A.shape, B.shape)
    assert A.shape[-1] == B.shape[-2], (A.shape, B.shape)
    try:
        return np.linalg.solve(A, B)
    except np.linalg.LinAlgError:
        shape_A, shape_B = A.shape, B.shape
        working_shape_A = (-1, *shape_A[-2:])
        working_shape_B = (-1, *shape_B[-2:])
        A = A.reshape(working_shape_A)
        B = B.reshape(working_shape_B)
        C = np.zeros_like(B)
        for i in range(A.shape[0]):
            try:
                C[i] = np.linalg.solve(A[i], B[i])
            except np.linalg.LinAlgError:
                C[i] = _lstsq(A[i], B[i])
        return C.reshape(*shape_B)
