"""Plane-wise 3-vectors: (H, W) component planes - counterpart of `nrdtpu/vec3.py`.

The spatial filters and the history fix carry their geometry as three planes, as the JAX
package does; the hand kernels then read the planes they need. Matrices are host (4, 4)
numpy arrays whose entries enter the math as Python floats, so no frame constant is ever
copied to the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def of(a):
        """From an (..., 3) tensor."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full_like(ref, vx, vy, vz):
        o = torch.zeros_like(ref)
        return V3(o + vx, o + vy, o + vz)

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def _m(m):
    a = np.asarray(m, np.float32)
    return [[float(a[i, j]) for j in range(a.shape[1])] for i in range(a.shape[0])]


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def normalize(a: V3, eps=1e-15):
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), eps))
    return V3(a.x * inv, a.y * inv, a.z * inv)


def length(a: V3):
    return torch.sqrt(dot(a, a))


def lerp(a: V3, b: V3, t):
    return V3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t, a.z + (b.z - a.z) * t)


def where(cond, a: V3, b: V3):
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def rotate(m, v: V3):
    """(3x3 or 4x4 row-major host matrix) @ v - rotation part only."""
    r = _m(m)
    return V3(r[0][0] * v.x + r[0][1] * v.y + r[0][2] * v.z,
              r[1][0] * v.x + r[1][1] * v.y + r[1][2] * v.z,
              r[2][0] * v.x + r[2][1] * v.y + r[2][2] * v.z)


def rotate_inv(m, v: V3):
    """m^T @ v (the inverse of a pure rotation)."""
    r = _m(m)
    return V3(r[0][0] * v.x + r[1][0] * v.y + r[2][0] * v.z,
              r[0][1] * v.x + r[1][1] * v.y + r[2][1] * v.z,
              r[0][2] * v.x + r[1][2] * v.y + r[2][2] * v.z)


def affine(m, v: V3):
    """(m @ [v, 1]).xyz for a row-major host 4x4."""
    r = rotate(m, v)
    a = _m(m)
    return V3(r.x + a[0][3], r.y + a[1][3], r.z + a[2][3])


def reflect(i: V3, n: V3):
    d = 2.0 * dot(n, i)
    return V3(i.x - d * n.x, i.y - d * n.y, i.z - d * n.z)


def get_basis(n: V3):
    """Geometry::GetBasis, plane-wise (branchless ONB)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    return (V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x),
            V3(b, sign + n.y * n.y * a, -n.y))


def get_screen_uv(m, p: V3):
    """Geometry::GetScreenUv of a world-position V3 -> (u, v) planes; m a host 4x4."""
    r = _m(m)
    cx = r[0][0] * p.x + r[0][1] * p.y + r[0][2] * p.z + r[0][3]
    cy = r[1][0] * p.x + r[1][1] * p.y + r[1][2] * p.z + r[1][3]
    cw = r[3][0] * p.x + r[3][1] * p.y + r[3][2] * p.z + r[3][3]
    inv = 1.0 / torch.where(torch.abs(cw) < 1e-15, 1e-15, cw)
    return cx * inv * 0.5 + 0.5, 0.5 - cy * inv * 0.5


def get_specular_dominant_direction(n: V3, v: V3, roughness, dominant_factor_fn):
    """ImportanceSampling::GetSpecularDominantDirection; returns (V3 direction, factor)."""
    f = dominant_factor_fn(torch.abs(dot(n, v)), roughness)
    return normalize(lerp(n, reflect(-v, n), f)), f


def reconstruct_view_position(u, v, frustum, view_z, ortho_mode=0.0):
    """Geometry::ReconstructViewPosition on uv planes -> view-space V3."""
    f = [float(c) for c in np.asarray(frustum, np.float32)]
    sx = u * f[2] + f[0]
    sy = v * f[3] + f[1]
    scale = view_z + (1.0 - view_z) * abs(float(ortho_mode))
    return V3(sx * scale, sy * scale, view_z)


def decode_oct_raw(px, py):
    """NRD_FrontEnd_UnpackNormalAndRoughness normal decode on planes (octahedral decode
    followed by a normalize that guards a zero vector with 1e-15)."""
    qx = px * 2.0 - 1.0
    qy = py * 2.0 - 1.0
    z = 1.0 - torch.abs(qx) - torch.abs(qy)
    t = torch.clamp(-z, 0.0, 1.0)
    nx = qx - t * torch.where(qx >= 0.0, 1.0, -1.0)
    ny = qy - t * torch.where(qy >= 0.0, 1.0, -1.0)
    inv = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + z * z, 1e-15))
    return V3(nx * inv, ny * inv, z * inv)
