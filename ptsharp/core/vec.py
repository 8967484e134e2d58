"""SoA 3-vector math over (..., 3) float arrays.

Capability parity with the reference's `Vector` struct
(PTSharpCore/Vector.cs:193-543) but designed for an accelerator: every op
is a batched jnp op over trailing-axis-3 arrays so XLA vectorizes over the ray
wavefront, and nothing here allocates per-element objects. Precision is fp32
(the reference is fp32-backed too, Vector.cs:201).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Matches reference Util.cs:10-11. INF doubles as the "no hit" t sentinel.
INF = 1e9
EPS = 1e-9


def vec3(x, y, z, dtype=jnp.float32):
    """Build a (..., 3) array by stacking components on the last axis."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)], axis=-1
    )


def dot(a, b):
    """Batched dot product -> (...,) (keepdims-free).

    Written out per component rather than as a reduction over the trailing
    axis: on the H100, XLA fused the reduction form (through `normalize`)
    into Triton kernels, and the gradient of a 2,048-ray Cornell trace then
    failed to launch one (CUDA_ERROR_INVALID_VALUE; PERF.md)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vdot(a, b):
    """Batched dot product keeping the trailing axis -> (..., 1)."""
    return dot(a, b)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length_n(a, n):
    """p-norm length (reference Vector.LengthN, used by the SDF supersphere)."""
    n = jnp.asarray(n, a.dtype)
    return jnp.sum(jnp.abs(a) ** n, axis=-1) ** (1.0 / n)


def normalize(a, eps: float = 1e-20):
    """Unit vector; safe at 0 (returns ~0 rather than NaN)."""
    return a * jax.lax.rsqrt(jnp.maximum(dot(a, a), eps))[..., None]


def distance(a, b):
    return length(a - b)


def min_axis(a):
    """Unit axis of the smallest |component| (reference Vector.MinAxis) —
    used to build orthonormal bases robustly."""
    ax = jnp.abs(a)
    x, y, z = ax[..., 0], ax[..., 1], ax[..., 2]
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], a.dtype), a.shape)
    ey = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], a.dtype), a.shape)
    ez = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], a.dtype), a.shape)
    use_x = (x <= y) & (x <= z)
    use_y = (y <= x) & (y <= z)
    return jnp.where(use_x[..., None], ex, jnp.where(use_y[..., None], ey, ez))


def min_component(a):
    return jnp.min(a, axis=-1)


def max_component(a):
    return jnp.max(a, axis=-1)


def reflect(n, i):
    """Mirror reflect incident direction `i` about normal `n`
    (reference Vector.Reflect semantics: n.Reflect(i) = i - 2(n·i)n)."""
    return i - 2.0 * vdot(n, i) * n


def refract(n, i, n1, n2):
    """Snell refraction of incident `i` at normal `n` from IOR n1 into n2.

    Total internal reflection returns the zero vector, matching reference
    Vector.Refract (Vector.cs:500-514); callers mask on TIR separately.
    n1/n2 may be scalars or (...,) arrays.
    """
    n1 = jnp.asarray(n1, i.dtype)
    n2 = jnp.asarray(n2, i.dtype)
    cos_i = -dot(n, i)
    nr = jnp.broadcast_to(n1 / n2, cos_i.shape)
    sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    t = nr[..., None] * i + (nr * cos_i - cos_t)[..., None] * n
    return jnp.where(tir[..., None], jnp.zeros_like(t), t)


def reflectance(n, i, n1, n2):
    """Unpolarized Fresnel reflectance of `i` hitting normal `n` (exact
    parallel/orthogonal average; semantics of Vector.Reflectance,
    Vector.cs:517-536). Returns (...,) in [0, 1]; 1 on total internal
    reflection."""
    n1 = jnp.broadcast_to(jnp.asarray(n1, i.dtype), dot(n, i).shape)
    n2 = jnp.broadcast_to(jnp.asarray(n2, i.dtype), dot(n, i).shape)
    nr2 = (n1 * n1) / (n2 * n2)
    cos_i = -dot(n, i)
    sin_t2 = nr2 * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    a = n1 * cos_i
    b = n2 * cos_t
    r_orth = (a - b) / jnp.maximum(a + b, EPS)
    r_par = (b - a) / jnp.maximum(b + a, EPS)
    r = 0.5 * (r_orth * r_orth + r_par * r_par)
    return jnp.where(tir, jnp.ones_like(r), jnp.clip(r, 0.0, 1.0))


def orthonormal_basis(w):
    """Branch-free ONB (t, b) perpendicular to unit vector w.

    Uses the Duff/Frisvad construction — deterministic, unlike the
    reference's cross-with-random-vector trick (Ray.cs:28-35), which a
    reproducible keyed-PRNG wavefront must avoid for basis construction.
    """
    z = w[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = w[..., 0] * w[..., 1] * a
    t = vec3(
        1.0 + sign * w[..., 0] * w[..., 0] * a,
        sign * b,
        -sign * w[..., 0],
    )
    bb = vec3(b, sign + w[..., 1] * w[..., 1] * a, -w[..., 1])
    return t, bb
