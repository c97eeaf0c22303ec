"""Batched 2D geometry (twin of ``sicnav_tpu/ops/geometry.py``).

Branchless (``torch.where``) functions on the trailing axes that broadcast
over any leading batch shape. Points are ``(..., 2)`` float32 tensors.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def det2(a, b):
    """2D cross product (determinant) of vectors a, b with shape (..., 2)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def norm2(a):
    """Euclidean norm over the trailing axis."""
    return torch.sqrt(torch.clamp(dot2(a, a), min=0.0))


def normalize(a, eps: float = EPS):
    """Unit vector along ``a``; returns 0 for (near-)zero input."""
    n = norm2(a)[..., None]
    return torch.where(n > eps, a / torch.clamp(n, min=eps),
                       torch.zeros_like(a))


def closest_point_on_segment(p1, p2, q):
    """Closest point to ``q`` on segment ``p1``-``p2``."""
    d = p2 - p1
    dd = torch.clamp(dot2(d, d), min=EPS)
    u = torch.clamp(dot2(q - p1, d) / dd, 0.0, 1.0)
    degen = dot2(d, d)[..., None] <= EPS
    pt = p1 + u[..., None] * d
    return torch.where(degen, p1, pt)


def closest_point_on_line(p1, p2, q):
    """Closest point to ``q`` on the infinite line through p1-p2."""
    d = p2 - p1
    dd = torch.clamp(dot2(d, d), min=EPS)
    u = dot2(q - p1, d) / dd
    degen = dot2(d, d)[..., None] <= EPS
    pt = p1 + u[..., None] * d
    return torch.where(degen, p1, pt)


def point_to_segment_dist(p1, p2, q):
    """Distance from point(s) ``q`` to segment(s) ``p1``-``p2``."""
    return norm2(q - closest_point_on_segment(p1, p2, q))


def line_intersection(a0, adir, b0, b1):
    """Intersection of the line through ``a0`` along ``adir`` with the line
    through ``b0``, ``b1``; (near-)parallel lines return ``a0``."""
    d2 = b1 - b0
    denom = det2(adir, d2)
    t = det2(b0 - a0, d2) / torch.where(denom.abs() > EPS, denom,
                                        torch.full_like(denom, math.inf))
    return a0 + t[..., None] * adir


def seg_seg_closest(a0, a1, b0, b1):
    """Closest points between 2D segments A=(a0,a1) and B=(b0,b1):
    (pA, pB, dist), by the reference's clamped-projection scheme."""
    dA = a1 - a0
    dB = b1 - b0
    r = b0 - a0
    aa = dot2(dA, dA)
    bb = dot2(dB, dB)
    ab = dot2(dA, dB)
    ar = dot2(dA, r)
    br = dot2(dB, r)
    denom = aa * bb - ab * ab

    s = torch.where(denom > EPS * torch.clamp(aa * bb, min=1e-30),
                    (ar * bb - br * ab) / torch.clamp(denom, min=EPS),
                    torch.zeros_like(denom))
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(bb > EPS, (s * ab - br) / torch.clamp(bb, min=EPS),
                    torch.zeros_like(bb))
    t = torch.clamp(t, 0.0, 1.0)
    s2 = torch.where(aa > EPS, (t * ab + ar) / torch.clamp(aa, min=EPS),
                     torch.zeros_like(aa))
    s2 = torch.clamp(s2, 0.0, 1.0)

    pA = a0 + s2[..., None] * dA
    pB = b0 + t[..., None] * dB
    return pA, pB, norm2(pA - pB)


def seg_seg_dist(a0, a1, b0, b1):
    return seg_seg_closest(a0, a1, b0, b1)[2]


def wrap_angle(theta):
    """Wrap angle(s) to (-pi, pi]."""
    wrapped = torch.remainder(theta, 2.0 * math.pi)
    return torch.where(wrapped > math.pi, wrapped - 2.0 * math.pi, wrapped)


def rot_2d(theta, p):
    """Rotate point(s) ``p`` into a frame rotated by ``theta`` (inverse
    rotation, as the reference's rot_2D)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x = c * p[..., 0] + s * p[..., 1]
    y = -s * p[..., 0] + c * p[..., 1]
    return torch.stack([x, y], dim=-1)


def tsf_2d(q, p):
    """Rigid transform of point(s) ``p`` into the frame at pose q=(x,y,theta)."""
    return rot_2d(q[..., 2], p - q[..., 0:2])


def linspace(start, stop, num: int, device=None):
    """``num`` evenly spaced float32 values from ``start`` to ``stop``.

    Port-only helper: computes ``start * (1 - s) + stop * s`` with
    ``s = i / (num - 1)`` and appends ``stop`` exactly, the arithmetic of
    ``jnp.linspace``, so grids built from it round as the reference's do.
    ``start``/``stop`` may be Python floats or 0-d tensors; tensors keep
    their device and nothing waits for the device.
    """
    for x in (start, stop):
        if torch.is_tensor(x):
            device = x.device

    def f32(x):
        if torch.is_tensor(x):
            return x.to(torch.float32)
        return torch.full((), float(x), dtype=torch.float32, device=device)

    start, stop = f32(start), f32(stop)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


# ---------------------------------------------------------------------------
# Port-only helpers: jnp's derivative conventions under torch.func
# ---------------------------------------------------------------------------
# The MPC differentiates its residuals with torch.func where the reference
# differentiates them with JAX. The two agree on values but not on
# derivatives at a few kinks the MPC reaches: slacks and commanded speeds
# are often exactly 0, where jnp.abs has derivative 1 and torch.abs 0;
# jnp.maximum gives a tie half the derivative where torch.clamp passes it
# whole; and jnp.maximum applies its derivative mask by multiplication, so
# an infinite derivative upstream of an inactive branch (sqrt at 0) becomes
# NaN, where torch's masked backward gives 0. The last one decides whether
# the reference's interior-point step is finite (see sicnav_tpu_torch/mpc/
# ipm.py), so the port keeps it. These helpers have jnp's values and jnp's
# derivatives.

def jabs(x):
    """``jnp.abs``: derivative +1 at 0."""
    return torch.where(x >= 0, x, -x)


def jmax(x, c):
    """``jnp.maximum(x, c)`` for a Python float ``c``: derivative 1 where
    x > c, 1/2 at a tie, 0 below, applied by multiplication."""
    m = (x > c).to(x.dtype) + 0.5 * (x == c).to(x.dtype)
    return m * x + (1.0 - m) * c


def jmin(x, c):
    """``jnp.minimum(x, c)`` for a Python float ``c``."""
    m = (x < c).to(x.dtype) + 0.5 * (x == c).to(x.dtype)
    return m * x + (1.0 - m) * c


def jclip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi)."""
    return jmin(jmax(x, lo), hi)
