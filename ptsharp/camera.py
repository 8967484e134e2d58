"""Look-at thin-lens camera with batched ray generation.

Parity with reference Camera.cs: LookAt basis (Camera.cs:23-35), NDC pixel
mapping with aspect + jitter and thin-lens depth of field (CastRay,
Camera.cs:98-119) — but `cast_rays` generates a whole pixel tile of rays in
one batched op instead of one virtual call per ray.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ptsharp.core import vec


class Camera(NamedTuple):
    p: jnp.ndarray  # eye position (3,)
    u: jnp.ndarray  # right (3,)
    v: jnp.ndarray  # up (3,)
    w: jnp.ndarray  # forward (3,)
    m: jnp.ndarray  # 1 / tan(fovy/2)
    focal_distance: jnp.ndarray
    aperture_radius: jnp.ndarray

    @staticmethod
    def look_at(eye, center, up, fovy_deg: float) -> "Camera":
        eye = jnp.asarray(eye, jnp.float32)
        center = jnp.asarray(center, jnp.float32)
        up = jnp.asarray(up, jnp.float32)
        w = vec.normalize(center - eye)
        u = vec.normalize(vec.cross(up, w))
        v = vec.normalize(vec.cross(w, u))
        m = 1.0 / math.tan(fovy_deg * math.pi / 360.0)
        return Camera(
            p=eye,
            u=u,
            v=v,
            w=w,
            m=jnp.float32(m),
            focal_distance=jnp.float32(0.0),
            aperture_radius=jnp.float32(0.0),
        )

    def set_focus(self, focal_point, aperture_radius: float) -> "Camera":
        """Thin-lens: focus at |focal_point - eye| (Camera.SetFocus)."""
        fp = jnp.asarray(focal_point, jnp.float32)
        return self._replace(
            focal_distance=vec.length(fp - self.p),
            aperture_radius=jnp.float32(aperture_radius),
        )

    def cast_rays(self, x, y, width: int, height: int, jitter_u, jitter_v,
                  lens_u=None, lens_v=None):
        """Generate rays for pixel coords x, y (any matching batch shape).

        jitter_u/v in [0,1) perturb within the pixel; lens_u/v in [0,1)
        drive aperture sampling when aperture_radius > 0. Returns
        (origins, directions), each (..., 3).

        Math matches CastRay (Camera.cs:98-119):
          px = ((x + ju - 0.5) / (w-1)) * 2 - 1  (and same for py)
          d  = normalize(-px*aspect*u - py*v + m*w)
        """
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        aspect = width / float(height)
        px = ((x + jitter_u - 0.5) / (width - 1.0)) * 2.0 - 1.0
        py = ((y + jitter_v - 0.5) / (height - 1.0)) * 2.0 - 1.0
        d = (
            self.u * (-px * aspect)[..., None]
            + self.v * (-py)[..., None]
            + self.w * self.m
        )
        d = vec.normalize(d)
        org = jnp.broadcast_to(self.p, d.shape)
        if lens_u is not None:
            # Thin-lens: move origin on the aperture disc, re-aim at the
            # focal point. Angle-uniform + radius-uniform matches the
            # reference's bokeh (Camera.cs:108-116).
            angle = lens_u * 2.0 * jnp.pi
            radius = lens_v * self.aperture_radius
            focal = org + d * self.focal_distance
            offset = (
                self.u * (jnp.cos(angle) * radius)[..., None]
                + self.v * (jnp.sin(angle) * radius)[..., None]
            )
            lens_org = org + offset
            lens_dir = vec.normalize(focal - lens_org)
            use_lens = self.aperture_radius > 0.0
            org = jnp.where(use_lens, lens_org, org)
            d = jnp.where(use_lens, lens_dir, d)
        return org, d
