"""Cubic-spline SPH smoothing kernel W, its gradient and dW/dr / r, on
torch tensors.

Counterpart of ``sph_taichi_tpu/ops/kernels.py`` with the same operation
order (reference sph_base.py:23-68): normalization k = 4/3, 40/(7*pi),
8/pi for dim 1/2/3 divided by h**dim; two-branch polynomial in q = r/h
split at q = 0.5.  Constants are Python floats, so each product with a
float32 tensor rounds the constant to float32 first, as JAX's weakly typed
scalars do.  ``csrc/pairs.cu`` repeats these expressions in the same order.
"""

import numpy as np
import torch

from sph_taichi_torch.ops.pairs import div_exact, sqrt32


def norm_const(dim, h):
    if dim == 1:
        k = 4.0 / 3.0
    elif dim == 2:
        k = 40.0 / 7.0 / np.pi
    elif dim == 3:
        k = 8.0 / np.pi
    else:
        raise ValueError(f"dim must be 1/2/3, got {dim}")
    return k / float(h) ** dim


def cubic_kernel(r_norm, h, dim=3):
    """W(r) — reference sph_base.py:24-44. r_norm: any-shape f32 tensor."""
    k = norm_const(dim, h)
    q = r_norm * (1.0 / float(h))
    q2 = q * q
    q3 = q2 * q
    w_near = k * (6.0 * q3 - 6.0 * q2 + 1.0)
    one_m_q = 1.0 - q
    w_far = k * 2.0 * one_m_q * one_m_q * one_m_q
    res = torch.where(q <= 0.5, w_near, w_far)
    return torch.where(q <= 1.0, res, torch.zeros_like(res))


def cubic_kernel_derivative(r, h, dim=3):
    """grad W(r) — reference sph_base.py:46-68. r: (..., dim) f32 vectors.

    The zero vector where |r| <= 1e-5 or q > 1 (the same cutoffs).  The
    JAX function's order of rounding: |r| (the squares summed left to
    right, sqrt rounded once), q = |r| / h, r / (max(|r|, 1e-24) * h), then
    the near and far branches.
    """
    k = 6.0 * norm_const(dim, h)
    sq = r[..., 0] * r[..., 0]
    for c in range(1, r.shape[-1]):
        sq = sq + r[..., c] * r[..., c]
    r_norm = sqrt32(sq)[..., None]
    q = div_exact(r_norm, float(h))
    grad_q = r / (torch.clamp_min(r_norm, 1e-24) * float(h))
    near = (k * q * (3.0 * q - 2.0)) * grad_q
    fac = 1.0 - q
    far = (-k * fac * fac) * grad_q
    res = torch.where(q <= 0.5, near, far)
    valid = (r_norm > 1e-5) & (q <= 1.0)
    return torch.where(valid, res, torch.zeros_like(res))


def cubic_kernel_derivative_scalar(r_norm, h, dim=3, inv_r=None):
    """dW/dr / r: the scalar g with grad W(r) = g * r.

    ``inv_r``: precomputed 1/|r| (the traversal engines pass it as
    ``dots["_inv"]``).  The result is 0 where r <= 1e-5 or q > 1.
    """
    k = 6.0 * norm_const(dim, h)
    inv_h = 1.0 / float(h)
    q = r_norm * inv_h
    if inv_r is None:
        safe = torch.clamp_min(r_norm, 1e-24)
        # a full tensor, not the scalar: torch's scalar / tensor is
        # reciprocal-then-multiply
        inv_rh = torch.full_like(safe, inv_h) / safe
    else:
        inv_rh = inv_r * inv_h
    near = k * q * (3.0 * q - 2.0) * inv_rh
    fac = 1.0 - q
    far = -k * fac * fac * inv_rh
    res = torch.where(q <= 0.5, near, far)
    valid = (r_norm > 1e-5) & (q <= 1.0)
    return torch.where(valid, res, torch.zeros_like(res))
