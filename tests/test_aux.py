"""Aux subsystems: checkpoint/resume, denoiser, film Welford algebra,
textures, volumes."""

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.camera import Camera
from ptsharp.checkpoint import load_checkpoint, save_checkpoint
from ptsharp.denoise import atrous_denoise
from ptsharp.film import Film
from ptsharp.integrator import IntegratorConfig
from ptsharp.materials import diffuse_material, light_material
from ptsharp.renderer import RenderConfig, Renderer
from ptsharp.scene import SceneBuilder
from ptsharp.textures import TextureAtlas


def test_film_welford_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 2, (10, 4, 4, 3)).astype(np.float32)
    film = Film.zeros(4, 4)
    film = film.add_batch(jnp.asarray(x[:6]))
    film = film.add_batch(jnp.asarray(x[6:]))
    np.testing.assert_allclose(np.asarray(film.mean), x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(film.variance()), x.var(0, ddof=1), rtol=1e-4
    )
    np.testing.assert_allclose(np.asarray(film.n), 10.0)


def test_film_merge_order_independent():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (8, 2, 2, 3)).astype(np.float32)
    a = Film.zeros(2, 2).add_batch(jnp.asarray(x[:3]))
    b = Film.zeros(2, 2).add_batch(jnp.asarray(x[3:]))
    ab = a.merge(b)
    ba = b.merge(a)
    np.testing.assert_allclose(np.asarray(ab.mean), np.asarray(ba.mean), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ab.m2), np.asarray(ba.m2), rtol=1e-4, atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    film = Film.zeros(4, 4).add_batch(jnp.ones((2, 4, 4, 3)))
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, film, 7, jax.random.PRNGKey(3))
    film2, it, key = load_checkpoint(p)
    assert it == 7
    np.testing.assert_array_equal(np.asarray(film.mean), np.asarray(film2.mean))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(3)))


def test_iterative_render_resume(tmp_path):
    """Kill-and-resume must produce the same film as an uninterrupted run."""
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.3, 0.2]))
    b.add_sphere([2, 4, -2], 1.0, light_material([1, 1, 1], 8.0))
    scene = b.build()
    cam = Camera.look_at([0, 1, -4], [0, 1, 0], [0, 1, 0], 40.0)
    mk = lambda: Renderer(scene, cam, RenderConfig(width=8, height=8, spp=2),
                          IntegratorConfig(max_bounces=2))
    key = jax.random.PRNGKey(5)

    full = mk().iterative_render(4, key=key)

    p = str(tmp_path / "state.npz")
    mk().iterative_render(2, key=key, checkpoint_path=p, checkpoint_every=1)
    resumed = mk().iterative_render(4, key=key, checkpoint_path=p,
                                    checkpoint_every=1)
    np.testing.assert_allclose(
        np.asarray(full.mean), np.asarray(resumed.mean), rtol=1e-5
    )
    np.testing.assert_allclose(np.asarray(full.n), np.asarray(resumed.n))


def test_denoiser_reduces_noise_preserves_edges():
    rng = np.random.default_rng(2)
    h = w = 32
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = [0.9, 0.2, 0.2]
    clean[:, w // 2 :] = [0.2, 0.2, 0.9]
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    albedo = clean.copy()
    normal = np.zeros_like(clean)
    normal[..., 2] = 1.0
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), jnp.asarray(albedo),
                                    jnp.asarray(normal)))
    noise_before = np.abs(noisy - clean).mean()
    noise_after = np.abs(out - clean).mean()
    assert noise_after < noise_before * 0.5
    # edge preserved: the two halves remain distinct
    assert out[:, : w // 2 - 2, 0].mean() > 0.7
    assert out[:, w // 2 + 2 :, 0].mean() < 0.35


def test_texture_atlas_sampling():
    img = np.zeros((4, 8, 3), np.float32)
    img[:, :4] = [1, 0, 0]
    img[:, 4:] = [0, 1, 0]
    atlas = TextureAtlas.build([img])
    tid = jnp.zeros(2, jnp.int32)
    u = jnp.asarray([0.15, 0.8])
    v = jnp.asarray([0.5, 0.5])
    c = np.asarray(atlas.sample(tid, u, v))
    assert c[0, 0] > 0.8 and c[0, 1] < 0.2  # left half red
    assert c[1, 1] > 0.8 and c[1, 0] < 0.2  # right half green


def test_textured_material_render():
    """Texture id on a material changes the rendered color."""
    img = np.zeros((8, 8, 3), np.float32)
    img[:] = [0.0, 0.8, 0.0]
    b = SceneBuilder()
    tid = b.add_texture(img)
    from ptsharp.materials import Material

    b.add_plane([0, 0, 0], [0, 1, 0], Material(color=(1.0, 0.0, 0.0), texture=tid))
    b.set_environment(color=[1, 1, 1])
    scene = b.build()
    cam = Camera.look_at([0, 3, 0.01], [0, 0, 0], [0, 1, 0], 40.0)
    r = Renderer(scene, cam, RenderConfig(width=6, height=6, spp=8),
                 IntegratorConfig(max_bounces=1, direct_lighting=False))
    film = r.render(key=jax.random.PRNGKey(0))
    mean = np.asarray(film.mean).mean(axis=(0, 1))
    assert mean[1] > 0.5  # textured green, not material red
    assert mean[0] < 0.2


def test_volume_render_smoke():
    from ptsharp.examples import build

    scene, cam, rcfg, icfg = build("volume", width=16, height=16)
    r = Renderer(scene, cam, RenderConfig(width=16, height=16, spp=2), icfg)
    film = r.render(key=jax.random.PRNGKey(0))
    img = np.asarray(film.mean)
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_sdf_example_smoke():
    from ptsharp.examples import build

    scene, cam, rcfg, icfg = build("sdf", width=16, height=12)
    r = Renderer(scene, cam, RenderConfig(width=16, height=12, spp=2), icfg)
    film = r.render(key=jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(film.mean)).all()


def test_renderer_compaction_gating():
    """ADVICE r3 (medium): with compaction=True but a non-RR integrator,
    the renderer must keep the fully-jitted chunk fn (the compacted
    wrapper would fall back to an UN-jitted trace)."""
    import jax

    from ptsharp.camera import Camera
    from ptsharp.integrator import IntegratorConfig
    from ptsharp.materials import diffuse_material, light_material
    from ptsharp.renderer import Renderer, RenderConfig
    from ptsharp.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.4, 0.3]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 6.0))
    scene = b.build()
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    rcfg = RenderConfig(width=8, height=8, spp=2, compaction=True)

    # max_bounces=1: compaction_schedule is empty at every width, so the
    # plain jitted chunk fn must survive (no python wrapper needed)
    r_shallow = Renderer(scene, cam, rcfg, IntegratorConfig(max_bounces=1))
    r_shallow._build_chunk_fn()
    assert not isinstance(r_shallow._chunk_fn, type(lambda: 0)) or \
        hasattr(r_shallow._chunk_fn, "lower"), "shallow config lost the jit"

    # no-RR deep config: the compacted wrapper installs (round 5), but
    # tiny chunk shapes route through the jitted plain fn inside it — a
    # render at this 8x8 size must still work end to end
    r_norr = Renderer(scene, cam, rcfg, IntegratorConfig(max_bounces=4))
    film = r_norr.render(key=jax.random.PRNGKey(0))
    import jax.numpy as jnp
    assert bool(jnp.isfinite(film.mean).all())

    r_rr = Renderer(scene, cam, rcfg,
                    IntegratorConfig(max_bounces=4, russian_roulette=True))
    r_rr._build_chunk_fn()
    # the RR config installs the compacted python wrapper (which calls
    # jitted prefix/tail programs internally)
    assert isinstance(r_rr._chunk_fn, type(lambda: 0))


def test_compaction_schedule_gating():
    """compaction_schedule() returns empty for shapes where compaction
    can't engage — the renderer uses this to keep the jitted plain path
    (review finding: shallow-bounce or tiny-chunk shapes previously fell
    into an un-jitted trace())."""
    from ptsharp.integrator import IntegratorConfig, compaction_schedule

    rr = IntegratorConfig(max_bounces=8, russian_roulette=True,
                          rr_start_depth=2)
    assert compaction_schedule(rr, 1 << 20)          # engages
    assert not compaction_schedule(rr, 1 << 12)      # wavefront <= cap
    shallow = IntegratorConfig(max_bounces=2, russian_roulette=True,
                               rr_start_depth=2)
    assert not compaction_schedule(shallow, 1 << 20)  # d1 > max_bounces
    # no RR: engages with the env-miss/emissive decay schedule (round 5 —
    # dead lanes cost full width in every fixed-width stage regardless of
    # what killed them)
    assert compaction_schedule(IntegratorConfig(max_bounces=8), 1 << 20)
    assert not compaction_schedule(
        IntegratorConfig(max_bounces=1), 1 << 20)     # too shallow
    assert not compaction_schedule(
        IntegratorConfig(max_bounces=8, specular_mode="all"), 1 << 20)
