"""Heightfield function shape: the region z < f(x, y) inside a box.

Parity with reference Function.cs: inside-test ray march with step 1/32 and
max t = 12 (Function.cs:43-56), finite-difference normals
(Function.cs:74-82). The height function is a host callable specialized at
trace time (like the SDF trees), marching the whole wavefront in one
bounded fori_loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.core import vec

MARCH_STEP = 1.0 / 32.0  # Function.cs:47
MAX_T = 12.0  # Function.cs:48


@dataclass(eq=False)
class Heightfield:
    """f maps (..., ) x, y -> z height; box bounds the shape."""

    f: Callable
    bmin: Any
    bmax: Any

    def inside(self, p):
        """z < f(x, y) (Function.Contains)."""
        return p[..., 2] < self.f(p[..., 0], p[..., 1])


def intersect(hf: Heightfield, org, dirn, t_enter, t_exit):
    """Fixed-step inside-test march (Function.cs:43-56) with a refinement
    pass, bounded iterations. Returns t (R,), INF on miss."""
    org = jax.lax.stop_gradient(org)
    dirn = jax.lax.stop_gradient(dirn)
    r = org.shape[0]
    t0 = jnp.maximum(t_enter, MARCH_STEP)
    t_hi = jnp.minimum(jax.lax.stop_gradient(t_exit), MAX_T)
    n_steps = int(MAX_T / MARCH_STEP) + 1

    def body(i, state):
        cross_t, found = state
        t = t0 + i * MARCH_STEP
        p = org + dirn * t[..., None]
        hit = hf.inside(p) & (t <= t_hi) & ~found
        cross_t = jnp.where(hit, t, cross_t)
        return cross_t, found | hit

    cross_t, found = jax.lax.fori_loop(
        0, n_steps, body, (jnp.full(r, vec.INF), jnp.zeros(r, bool))
    )
    # bisection refinement over the last step interval
    lo = jnp.where(found, cross_t - MARCH_STEP, 0.0)
    hi = jnp.where(found, cross_t, 1.0)

    def refine(i, st):
        lo, hi = st
        mid = 0.5 * (lo + hi)
        p = org + dirn * mid[..., None]
        inside = hf.inside(p)
        return jnp.where(inside, lo, mid), jnp.where(inside, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 16, refine, (lo, hi))
    return jnp.where(found, hi, vec.INF)


def normal_at(hf: Heightfield, p, eps: float = 1e-3):
    """Gradient normal of z - f(x, y) (Function.cs:74-82)."""
    fx = (hf.f(p[..., 0] + eps, p[..., 1]) - hf.f(p[..., 0] - eps, p[..., 1])) / (2 * eps)
    fy = (hf.f(p[..., 0], p[..., 1] + eps) - hf.f(p[..., 0], p[..., 1] - eps)) / (2 * eps)
    return vec.normalize(vec.vec3(-fx, -fy, jnp.ones_like(fx)))
