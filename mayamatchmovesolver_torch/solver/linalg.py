"""Small symmetric eigenproblems for the SfM linear systems.

Port of the part of mayamatchmovesolver_tpu/solver/linalg.py that the
SfM layer calls: the reference builds its eigendecomposition from Jacobi
rotations because XLA:TPU has none in float64; here it is
torch.linalg.eigh.  Both return ascending eigenvalues; eigenvector signs,
and the basis inside a repeated eigenvalue, are arbitrary in either, so
callers use only what does not depend on them.
"""

import torch


def eigh(a):
    """Symmetric eigendecomposition of (..., n, n) matrices: (eigenvalues
    ascending, eigenvectors as columns).

    A matrix with a non-finite entry gives NaN, not an error: padded
    rows of a batch (a frame with no observation) may hold one, and their
    results are masked out by the caller.
    """
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    w, v = torch.linalg.eigh(torch.where(finite[..., None, None], a, eye))
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    return (torch.where(finite[..., None], w, nan),
            torch.where(finite[..., None, None], v, nan))


def smallest_eigenvector(a):
    """Eigenvector of the smallest eigenvalue of symmetric a — the
    workhorse for DLT null spaces (essential matrix, homography,
    triangulation, resection).  Its sign is arbitrary."""
    return eigh(a)[1][..., :, 0]


def svd3_rotation(m):
    """Nearest rotation matrix to a 3x3 m (polar decomposition through
    the eigendecomposition of m^T m), with det forced to +1."""
    w, v = eigh(m.transpose(-1, -2) @ m)
    inv_sqrt = v @ (
        (1.0 / torch.sqrt(torch.clamp(w, min=1e-30)))[..., None, :]
        * v.transpose(-1, -2)
    )
    r = m @ inv_sqrt
    sign = torch.sign(det3(r))[..., None]
    return torch.cat([r[..., :, :2], r[..., :, 2:] * sign[..., None]], dim=-1)


def det3(m):
    """Explicit 3x3 determinant."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )
