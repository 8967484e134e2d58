"""Welford film buffer — the device-array replacement for reference Buffer.cs.

The reference accumulates per-pixel running mean/variance with racy in-place
updates on a ConcurrentDictionary (Buffer.cs:33-44,63). Here the film is a
frozen pytree of (H, W, ...) arrays updated by *pure batched* Welford merges:
each render pass produces per-pixel (count, mean, M2) statistics which are
merged with the Chan-parallel formula — deterministic, differentiable, and
psum-able across a device mesh.

AOV channels match Buffer.Channel: Color / Variance / StdDev / Samples plus
Albedo and screen-space Normal used as denoiser guides.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.core import color as colorlib


class Film(NamedTuple):
    """Per-pixel Welford statistics of radiance samples.

    mean: (H, W, 3) running mean radiance
    m2:   (H, W, 3) running sum of squared deviations
    n:    (H, W)    sample count
    albedo: (H, W, 3) running mean first-hit albedo (denoiser guide)
    normal: (H, W, 3) running mean first-hit shading normal (denoiser guide)
    """

    mean: jnp.ndarray
    m2: jnp.ndarray
    n: jnp.ndarray
    albedo: jnp.ndarray
    normal: jnp.ndarray

    @staticmethod
    def zeros(height: int, width: int, dtype=jnp.float32) -> "Film":
        return Film(
            mean=jnp.zeros((height, width, 3), dtype),
            m2=jnp.zeros((height, width, 3), dtype),
            n=jnp.zeros((height, width), dtype),
            albedo=jnp.zeros((height, width, 3), dtype),
            normal=jnp.zeros((height, width, 3), dtype),
        )

    # ---- accumulation ----------------------------------------------------

    def add_batch(
        self,
        radiance: jnp.ndarray,
        weight: jnp.ndarray | None = None,
        albedo: jnp.ndarray | None = None,
        normal: jnp.ndarray | None = None,
    ) -> "Film":
        """Merge a batch of S samples per pixel: radiance (S, H, W, 3).

        weight (S, H, W) optionally masks samples (0 = not taken), enabling
        adaptive/firefly passes where only some pixels receive extra samples.
        """
        s = radiance.shape[0]
        if weight is None:
            weight = jnp.ones(radiance.shape[:-1], radiance.dtype)
        nb = jnp.sum(weight, axis=0)
        wsum = jnp.maximum(nb, 1e-12)[..., None]
        mb = jnp.sum(radiance * weight[..., None], axis=0) / wsum
        m2b = jnp.sum(
            weight[..., None] * (radiance - mb[None]) ** 2, axis=0
        )
        merged = _welford_merge(self.n, self.mean, self.m2, nb, mb, m2b)
        new_albedo, new_normal = self.albedo, self.normal
        if albedo is not None:
            ab = jnp.sum(albedo * weight[..., None], axis=0) / wsum
            new_albedo = _mean_merge(self.n, self.albedo, nb, ab)
        if normal is not None:
            nb_mean = jnp.sum(normal * weight[..., None], axis=0) / wsum
            new_normal = _mean_merge(self.n, self.normal, nb, nb_mean)
        return Film(merged[1], merged[2], merged[0], new_albedo, new_normal)

    def merge(self, other: "Film") -> "Film":
        """Merge two films over the sample axis (e.g. psum-style tree merge
        of per-device films)."""
        n, mean, m2 = _welford_merge(
            self.n, self.mean, self.m2, other.n, other.mean, other.m2
        )
        albedo = _mean_merge(self.n, self.albedo, other.n, other.albedo)
        normal = _mean_merge(self.n, self.normal, other.n, other.normal)
        return Film(mean, m2, n, albedo, normal)

    # ---- AOV extraction (Buffer.Channel parity) --------------------------

    def variance(self):
        """Per-pixel unbiased sample variance (Buffer.cs:48-55)."""
        denom = jnp.maximum(self.n - 1.0, 1.0)[..., None]
        return jnp.where((self.n > 1)[..., None], self.m2 / denom, 0.0)

    def stddev(self):
        return jnp.sqrt(self.variance())

    def color_srgb(self):
        return colorlib.to_srgb(self.mean)

    def samples_image(self):
        mx = jnp.maximum(jnp.max(self.n), 1.0)
        return (self.n / mx)[..., None] * jnp.ones(3, self.n.dtype)

    def albedo_image(self):
        """Albedo normalized by max component (Buffer.CalculateAlbedo)."""
        mx = jnp.maximum(jnp.max(self.albedo, axis=-1, keepdims=True), 1e-6)
        return jnp.clip(self.albedo / mx, 0.0, 1.0)

    def normal_image(self):
        return 0.5 * (self.normal + 1.0)


def _welford_merge(na, ma, m2a, nb, mb, m2b):
    """Chan et al. parallel Welford merge of (count, mean, M2) statistics."""
    n = na + nb
    n_safe = jnp.maximum(n, 1e-12)
    delta = mb - ma
    mean = ma + delta * (nb / n_safe)[..., None]
    m2 = m2a + m2b + delta**2 * (na * nb / n_safe)[..., None]
    zero = n[..., None] <= 0
    return n, jnp.where(zero, 0.0, mean), jnp.where(zero, 0.0, m2)


def _mean_merge(na, ma, nb, mb):
    n = jnp.maximum(na + nb, 1e-12)
    return ma + (mb - ma) * (nb / n)[..., None]


# ---- host-side output ----------------------------------------------------


def png_bytes(rgb8: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as an 8-bit RGB PNG with the
    standard library alone (zlib + struct): filter type 0 on every row."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = rgb8.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def to_rgb8(image01) -> np.ndarray:
    arr = np.asarray(jax.device_get(image01))
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_png(image01, path: str) -> None:
    """Write an (H, W, 3) [0,1] array as PNG (host-side; the reference
    used SkiaSharp, Renderer.cs:58-78)."""
    with open(path, "wb") as f:
        f.write(png_bytes(to_rgb8(image01)))


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in [0, 1]. Decoding
    needs Pillow, which is optional: only reading images needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs Pillow (pip install pillow); writing "
            "PNGs does not") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


def load_png(path: str, linearize: bool = True) -> np.ndarray:
    img = read_rgb(path)
    if linearize:
        img = img**colorlib.GAMMA
    return img
