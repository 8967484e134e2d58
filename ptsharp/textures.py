"""Texture atlas: all scene textures in one padded device array.

The reference loads each texture into its own ColorTexture object with a
global cache (Texture.cs:96-252) and samples bilinearly per ray via virtual
calls. Here every image is linearized (pow 2.2, Texture.cs:163) at load and
stacked into a single (K, maxH, maxW, 3) atlas + (K, 2) size table so a whole
wavefront's texture lookups are one batched bilinear gather, indexable by the
per-ray int32 texture id from the material table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ptsharp.core import color as colorlib


class TextureAtlas(NamedTuple):
    data: jnp.ndarray  # (K, maxH, maxW, 3) linear RGB, zero-padded
    sizes: jnp.ndarray  # (K, 2) int32 (h, w)

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            data=jnp.zeros((1, 1, 1, 3), jnp.float32),
            sizes=jnp.ones((1, 2), jnp.int32),
        )

    @staticmethod
    def build(images: list[np.ndarray]) -> "TextureAtlas":
        """images: list of (H, W, 3) float32 arrays already in linear space."""
        if not images:
            return TextureAtlas.empty()
        mh = max(im.shape[0] for im in images)
        mw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), mh, mw, 3), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            data[i, :h, :w] = im
            sizes[i] = (h, w)
        return TextureAtlas(data=jnp.asarray(data), sizes=jnp.asarray(sizes))

    def sample(self, tex_id, u, v):
        """Bilinear wrap sample -> (..., 3). tex_id (...,) int32; ids < 0
        return black (callers select against a fallback anyway)."""
        tid = jnp.clip(tex_id, 0, self.data.shape[0] - 1)
        h = self.sizes[tid, 0].astype(jnp.float32)
        w = self.sizes[tid, 1].astype(jnp.float32)
        # wrap to [0,1), v flipped like the reference sampler (Texture.cs:195)
        uu = jnp.mod(u, 1.0) * (w - 1.0)
        vv = (1.0 - jnp.mod(v, 1.0)) * (h - 1.0)
        x0 = jnp.floor(uu).astype(jnp.int32)
        y0 = jnp.floor(vv).astype(jnp.int32)
        fx = (uu - x0)[..., None]
        fy = (vv - y0)[..., None]
        wi = self.sizes[tid, 1]
        hi = self.sizes[tid, 0]
        x1 = jnp.where(x0 + 1 >= wi, 0, x0 + 1)
        y1 = jnp.where(y0 + 1 >= hi, 0, y0 + 1)
        c00 = self.data[tid, y0, x0]
        c01 = self.data[tid, y0, x1]
        c10 = self.data[tid, y1, x0]
        c11 = self.data[tid, y1, x1]
        c0 = c00 * (1 - fx) + c01 * fx
        c1 = c10 * (1 - fx) + c11 * fx
        return c0 * (1 - fy) + c1 * fy

    def normal_sample(self, tex_id, u, v):
        """RGB -> [-1,1] tangent-space normal (Texture.cs:231-237)."""
        c = self.sample(tex_id, u, v)
        return c * 2.0 - 1.0

    def bump_sample(self, tex_id, u, v):
        """Central-difference height gradient (Texture.cs:239-251) ->
        (..., 2) (du, dv)."""
        w = self.sizes[jnp.clip(tex_id, 0, self.data.shape[0] - 1), 1].astype(jnp.float32)
        h = self.sizes[jnp.clip(tex_id, 0, self.data.shape[0] - 1), 0].astype(jnp.float32)
        du = 1.0 / jnp.maximum(w, 1.0)
        dv = 1.0 / jnp.maximum(h, 1.0)
        lum = lambda c: jnp.sum(c, axis=-1) / 3.0
        gx = lum(self.sample(tex_id, u + du, v)) - lum(self.sample(tex_id, u - du, v))
        gy = lum(self.sample(tex_id, u, v + dv)) - lum(self.sample(tex_id, u, v - dv))
        return jnp.stack([gx, gy], axis=-1)


def load_texture(path: str) -> np.ndarray:
    """Decode + linearize an image file (host) -> (H, W, 3) float32."""
    from ptsharp.film import read_rgb

    return read_rgb(path)**colorlib.GAMMA


def pow_texture(image: np.ndarray, exponent: float) -> np.ndarray:
    """Per-texel power adjust before registration (ITexture.Pow,
    Texture.cs:170-178 — the reference mutates loaded textures in place;
    here textures are immutable atlas entries, so adjust the host image
    and pass it to SceneBuilder.add_texture)."""
    return np.power(np.asarray(image, np.float32), exponent)


def mul_texture(image: np.ndarray, scalar: float) -> np.ndarray:
    """Per-texel scale (ITexture.MulScalar, Texture.cs:180-186)."""
    return np.asarray(image, np.float32) * scalar
