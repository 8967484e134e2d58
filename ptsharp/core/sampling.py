"""Keyed Monte-Carlo sampling primitives over ray wavefronts.

The reference draws from a shared, unseeded `Random.Shared` everywhere
(e.g. Ray.cs:28-35, Sampler.cs:102) which makes renders irreproducible. Here
every draw derives from a `jax.random` threefry key folded per
(pixel, sample, bounce), so a render is a pure deterministic function of
(scene, config, seed) — the deterministic "race detector" (SURVEY.md §5).

All samplers are batched: pass keys of shape (..., 2) or uniforms of shape
(...,) and get (..., 3) directions back.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptsharp.core import vec


def uniform_disc(u1, u2):
    """Concentric-free polar mapping to the unit disc -> (x, y) each (...,).

    Matches the reference's aperture sampling (Camera.cs:110-113): angle
    uniform, radius uniform (NOT sqrt) — reproduced intentionally for
    behavioral parity of depth-of-field bokeh.
    """
    angle = u1 * 2.0 * jnp.pi
    radius = u2
    return jnp.cos(angle) * radius, jnp.sin(angle) * radius


def uniform_disc_area(u1, u2):
    """Area-uniform unit disc point (sqrt radius) — used for NEE light discs
    (replaces the reference's rejection loop, Sampler.cs:238-253, with a
    bounded branch-free mapping)."""
    angle = u1 * 2.0 * jnp.pi
    radius = jnp.sqrt(u2)
    return jnp.cos(angle) * radius, jnp.sin(angle) * radius


def uniform_sphere(u1, u2):
    """Uniform direction on S^2 (replaces Vector.RandomUnitVector)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return vec.vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere direction about unit normal n.

    Same distribution as reference Ray.WeightedBounce (Ray.cs:28-35):
    radius=sqrt(u), theta=2πv, z=sqrt(1-u) — but over a deterministic ONB.
    """
    t, b = vec.orthonormal_basis(n)
    radius = jnp.sqrt(u1)
    theta = 2.0 * jnp.pi * u2
    x = radius * jnp.cos(theta)
    y = radius * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    return t * x[..., None] + b * y[..., None] + n * z[..., None]


def cone(d, theta_max, u1, u2):
    """Perturb unit direction d inside a cone of half-angle theta_max.

    Angle schedule matches reference Util.Cone (Util.cs:17-32):
    theta = theta_max * (1 - 2*acos(u)/π), azimuth = 2πv, over an ONB.
    theta_max may be scalar or (...,). theta_max < EPS returns d unchanged.
    """
    theta_max = jnp.broadcast_to(jnp.asarray(theta_max, d.dtype), u1.shape)
    theta = theta_max * (1.0 - 2.0 * jnp.arccos(jnp.clip(u1, 0.0, 1.0)) / jnp.pi)
    m1 = jnp.sin(theta)
    m2 = jnp.cos(theta)
    a = u2 * 2.0 * jnp.pi
    s, t = vec.orthonormal_basis(d)
    out = (
        s * (m1 * jnp.cos(a))[..., None]
        + t * (m1 * jnp.sin(a))[..., None]
        + d * m2[..., None]
    )
    out = vec.normalize(out)
    return jnp.where((theta_max < vec.EPS)[..., None], d, out)


def stratified_pair(base_u, base_v, n, idx):
    """Map sample index idx in [0, n*n) plus jitter (base_u, base_v) in [0,1)
    to a stratified (u, v) on the n×n grid — the wavefront analogue of the
    reference's first-hit u/v loops (Sampler.cs:96-102)."""
    n = jnp.asarray(n, jnp.int32)
    iu = (idx % n).astype(base_u.dtype)
    iv = (idx // n).astype(base_v.dtype)
    nf = n.astype(base_u.dtype)
    return (iu + base_u) / nf, (iv + base_v) / nf


def uniforms(key, shape_or_num, num=None):
    """Draw float32 uniforms. uniforms(key, 3) -> tuple of 3 (...,)-shaped
    draws for a batch of keys of shape (..., 2); uniforms(key, shape) -> array.
    """
    if num is not None:
        shape = shape_or_num
        return jax.random.uniform(key, shape + (num,))
    n = shape_or_num
    if jnp.ndim(key) > 1:  # batch of keys: vectorize with fold_in-free split
        batch_shape = key.shape[:-1]
        draws = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
            key.reshape(-1, key.shape[-1])
        )
        draws = draws.reshape(batch_shape + (n,))
        return tuple(draws[..., i] for i in range(n))
    draws = jax.random.uniform(key, (n,))
    return tuple(draws[i] for i in range(n))
