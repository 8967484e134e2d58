"""Row-vector-free 4x4 homogeneous transforms as (4, 4) jnp arrays.

Parity with reference Matrix.cs (translate/scale/rotate/frustum/ortho/
perspective/lookat, point vs direction application, AABB transform,
closed-form inverse) — but matrices are plain arrays so they batch, jit and
differentiate; instance tables store (world, inverse) pairs like
TransformedShape.cs:19-34.

Convention matches the reference: row-major M, column-vector application
p' = M @ [p, 1].
"""

from __future__ import annotations

import jax.numpy as jnp

from ptsharp.core import vec


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def translate(v):
    v = jnp.asarray(v, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(v)


def scale(v):
    v = jnp.asarray(v, jnp.float32)
    return jnp.diag(jnp.concatenate([v, jnp.ones(1, jnp.float32)]))


def rotate(axis, theta):
    """Rotation about (unnormalized ok) axis by theta radians
    (Matrix.cs Rotate semantics)."""
    a = vec.normalize(jnp.asarray(axis, jnp.float32))
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    m = 1.0 - c
    x, y, z = a[0], a[1], a[2]
    return jnp.array(
        [
            [m * x * x + c, m * x * y + z * s, m * z * x - y * s, 0.0],
            [m * x * y - z * s, m * y * y + c, m * y * z + x * s, 0.0],
            [m * z * x + y * s, m * y * z - x * s, m * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        jnp.float32,
    )


def frustum(l, r, b, t, n, f):
    t1, t2, t3, t4 = 2 * n, r - l, t - b, f - n
    return jnp.array(
        [
            [t1 / t2, 0, (r + l) / t2, 0],
            [0, t1 / t3, (t + b) / t3, 0],
            [0, 0, (-f - n) / t4, (-t1 * f) / t4],
            [0, 0, -1, 0],
        ],
        jnp.float32,
    )


def orthographic(l, r, b, t, n, f):
    return jnp.array(
        [
            [2 / (r - l), 0, 0, -(r + l) / (r - l)],
            [0, 2 / (t - b), 0, -(t + b) / (t - b)],
            [0, 0, -2 / (f - n), -(f + n) / (f - n)],
            [0, 0, 0, 1],
        ],
        jnp.float32,
    )


def perspective(fovy_deg, aspect, near, far):
    ymax = near * jnp.tan(jnp.deg2rad(fovy_deg) / 2.0)
    xmax = ymax * aspect
    return frustum(-xmax, xmax, -ymax, ymax, near, far)


def look_at_matrix(eye, center, up):
    """Matrix.LookAtMatrix semantics (camera-to-world for the GL convention)."""
    eye = jnp.asarray(eye, jnp.float32)
    up = vec.normalize(jnp.asarray(up, jnp.float32))
    f = vec.normalize(jnp.asarray(center, jnp.float32) - eye)
    s = vec.normalize(vec.cross(f, up))
    u = vec.normalize(vec.cross(s, f))
    m = jnp.stack(
        [
            jnp.concatenate([s, jnp.zeros(1, jnp.float32)]),
            jnp.concatenate([u, jnp.zeros(1, jnp.float32)]),
            jnp.concatenate([-f, jnp.zeros(1, jnp.float32)]),
            jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
        ],
        axis=1,
    )
    return jnp.matmul(m, translate(-eye))


def mul(a, b):
    return jnp.matmul(a, b)


def mul_position(m, p):
    """Apply to points (..., 3) with translation."""
    return jnp.einsum("ij,...j->...i", m[:3, :3], p) + m[:3, 3]


def mul_direction(m, d):
    """Apply to directions (no translation), renormalized
    (Matrix.MulDirection)."""
    return vec.normalize(jnp.einsum("ij,...j->...i", m[:3, :3], d))


def mul_direction_raw(m, d):
    """Apply linear part without renormalizing (keeps t-scales intact)."""
    return jnp.einsum("ij,...j->...i", m[:3, :3], d)


def mul_box(m, bmin, bmax):
    """Transformed AABB via the Arvo corner-sum trick (Matrix.MulBox)."""
    r = m[:3, :3]
    t = m[:3, 3]
    lo = t + jnp.sum(jnp.minimum(r * bmin[None, :], r * bmax[None, :]), axis=1)
    hi = t + jnp.sum(jnp.maximum(r * bmin[None, :], r * bmax[None, :]), axis=1)
    return lo, hi


def inverse(m):
    return jnp.linalg.inv(m)


def transpose(m):
    return m.T


def determinant(m):
    return jnp.linalg.det(m)
