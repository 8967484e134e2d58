"""Film + render-state checkpointing.

The reference has no resumability beyond per-iteration PNGs — a crash loses
the accumulation buffer (SURVEY.md §5). Here the full render state (Welford
film arrays + iteration counter + base PRNG key) serializes to one .npz;
restoring reproduces the exact continuation because sampling is keyed, not
stateful. Films re-shard trivially on restore (plain arrays).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.film import Film

FORMAT_VERSION = 1


def save_checkpoint(path: str, film: Film, iteration: int, key) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        version=FORMAT_VERSION,
        mean=np.asarray(film.mean),
        m2=np.asarray(film.m2),
        n=np.asarray(film.n),
        albedo=np.asarray(film.albedo),
        normal=np.asarray(film.normal),
        iteration=iteration,
        key=np.asarray(key),
    )
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)


def load_checkpoint(path: str):
    """Returns (film, iteration, key)."""
    with np.load(path) as z:
        assert int(z["version"]) == FORMAT_VERSION
        film = Film(
            mean=jnp.asarray(z["mean"]),
            m2=jnp.asarray(z["m2"]),
            n=jnp.asarray(z["n"]),
            albedo=jnp.asarray(z["albedo"]),
            normal=jnp.asarray(z["normal"]),
        )
        return film, int(z["iteration"]), jnp.asarray(z["key"])
