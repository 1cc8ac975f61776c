"""Small dense linear algebra helpers used by the rigid-body solver."""

import torch


def polar_rotation(a):
    """Rotation factor R of the polar decomposition A = R S.

    SVD with determinant correction so R is always a proper rotation
    (det +1), as Taichi's rotation-safe svd3d gives (reference
    sph_base.py:212).  For a non-singular A the rotation is unique, so the
    SVD's sign conventions do not matter.  A ~ 0 (sum |A| < 1e-12) yields
    the identity (the reference falls back to identity, sph_base.py:214-215).
    """
    u, _, vh = torch.linalg.svd(a)
    det = torch.linalg.det(u @ vh)
    d = torch.cat([torch.ones(2, dtype=a.dtype, device=a.device),
                   det.reshape(1)])
    r = (u * d[None, :]) @ vh
    degenerate = torch.sum(torch.abs(a)) < 1e-12
    return torch.where(degenerate,
                       torch.eye(3, dtype=a.dtype, device=a.device), r)
