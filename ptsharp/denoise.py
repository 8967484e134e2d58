"""Edge-aware à-trous wavelet denoiser — the OIDN-equivalent hook.

The reference P/Invokes Intel Open Image Denoise (OIDN.cs:43-95,
Renderer.DenoiseRGB, Renderer.cs:609-684) — a native DLL the JAX stack
neither has nor needs. This module provides the same capability (filter the
accumulated color buffer guided by albedo + normal AOVs) as a pure-JAX
à-trous wavelet filter (Dammertz et al. 2010 style): a few dilated 5x5
B3-spline passes whose weights combine color, albedo, and normal
differences. Runs on-device, differentiable, and jit/shard-compatible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 1D B3-spline kernel; the 5x5 filter is its outer product
_B3 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], jnp.float32) / 16.0


def atrous_denoise(
    color,
    albedo=None,
    normal=None,
    variance=None,
    iterations: int = 4,
    sigma_color: float = 0.45,
    sigma_albedo: float = 0.35,
    sigma_normal: float = 0.35,
):
    """color (H, W, 3) linear radiance; optional (H, W, 3) albedo/normal
    guides and (H, W, 3) per-pixel variance. Returns filtered (H, W, 3)."""
    out = color
    for it in range(iterations):
        step = 1 << it
        out = _atrous_pass(
            out, albedo, normal, step, sigma_color * (2.0**-it),
            sigma_albedo, sigma_normal,
        )
    return out


def _atrous_pass(color, albedo, normal, step, sc, sa, sn):
    h, w, _ = color.shape
    acc = jnp.zeros_like(color)
    wacc = jnp.zeros((h, w, 1), color.dtype)
    center = color
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            k = _B3[dy + 2] * _B3[dx + 2]
            shifted = _shift2d(color, dy * step, dx * step)
            wgt = jnp.full((h, w, 1), k, color.dtype)
            dc = jnp.sum((shifted - center) ** 2, axis=-1, keepdims=True)
            wgt = wgt * jnp.exp(-dc / (sc * sc + 1e-8))
            if albedo is not None:
                da = jnp.sum(
                    (_shift2d(albedo, dy * step, dx * step) - albedo) ** 2,
                    axis=-1,
                    keepdims=True,
                )
                wgt = wgt * jnp.exp(-da / (sa * sa + 1e-8))
            if normal is not None:
                dn = jnp.sum(
                    (_shift2d(normal, dy * step, dx * step) - normal) ** 2,
                    axis=-1,
                    keepdims=True,
                )
                wgt = wgt * jnp.exp(-dn / (sn * sn + 1e-8))
            acc = acc + shifted * wgt
            wacc = wacc + wgt
    return acc / jnp.maximum(wacc, 1e-8)


def _shift2d(img, dy, dx):
    """Edge-clamped 2D shift (replicate border)."""
    out = jnp.roll(img, (dy, dx), axis=(0, 1))
    h, w = img.shape[:2]
    if dy > 0:
        out = out.at[:dy].set(out[dy : dy + 1])
    elif dy < 0:
        out = out.at[dy:].set(out[dy - 1 : dy])
    if dx > 0:
        out = out.at[:, :dx].set(out[:, dx : dx + 1])
    elif dx < 0:
        out = out.at[:, dx:].set(out[:, dx - 1 : dx])
    return out


@jax.jit
def denoise_film(film):
    """Denoise a Film using its albedo/normal AOV guides."""
    return atrous_denoise(film.mean, film.albedo, film.normal, film.variance())
