"""The per-lane traversal kernels (pallas/traverse_gpu.py) against the XLA
wide walk (accel/traverse.py), in interpret mode on the CPU; their CUDA
lowering; the backend guard; and, under the `gpu` marker, the compiled
kernels on the card.

Tolerances: in interpret mode the kernel runs the walk's f32 arithmetic in
the same order, so `slot` must be identical and `t` agree to 1e-6
relative (a few ulp of reassociation inside XLA's fusion), and the
barycentrics u, v within 2e-5 absolute. Compiled on the
GPU, FMA contraction can flip ties on shared edges: `t` within 1e-4
relative and `slot` on >= 99.9% of lanes.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptsharp import platform
from ptsharp.accel import traverse
from ptsharp.geometry.mesh import cube_mesh, sphere_mesh
from ptsharp.intersect import (
    _xform_dir, _xform_point, closest_hit, occlusion_query,
)
from ptsharp.materials import diffuse_material, light_material
from ptsharp.pallas import traverse_gpu
from ptsharp.scene import SceneBuilder

INF = 1e9
GREY = diffuse_material([0.5, 0.5, 0.5])


def _scene(kind):
    b = SceneBuilder()
    if kind == "cube":
        b.add_mesh(cube_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]), GREY)
    elif kind in ("sphere2", "sphere3"):
        b.add_mesh(sphere_mesh([0, 0, 0], 1.0,
                               subdivisions=int(kind[-1])), GREY)
    elif kind == "two_meshes":
        b.add_mesh(sphere_mesh([-0.6, 0, 0], 0.6, subdivisions=2), GREY)
        b.add_mesh(cube_mesh([0.4, -0.4, -0.4], [1.2, 0.4, 0.4]), GREY)
    elif kind == "instance":
        mi = b.add_mesh(sphere_mesh([0, 0, 0], 0.5, subdivisions=2), GREY)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[0.0, -1.3, 0.0], [1.3, 0.0, 0.0], [0.0, 0.0, 0.8]]
        m[:3, 3] = [0.7, 0.2, -0.1]
        b.add_mesh_instance(mi, transform=m)
    return b.build(leaf_size=8, use_tlas=False)


def _rays(n, seed=0, spread=0.8):
    rng = np.random.default_rng(seed)
    org = rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, -3.0]
    tgt = rng.uniform(-spread, spread, (n, 3))
    d = tgt - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _per_instance(scene, org, d):
    """(o, d, base, end) in each instance's object space."""
    for i in range(scene.inst_inv.shape[0]):
        inv = scene.inst_inv[i]
        yield (_xform_point(inv[None], org), _xform_dir(inv[None], d),
               scene.w_inst_base[i], scene.w_inst_end[i])


def _assert_same_hits(ref, got):
    t_r, s_r, u_r, v_r = (np.asarray(x) for x in ref)
    t_g, s_g, u_g, v_g = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(s_g, s_r)
    hit = s_r >= 0
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-6)
    np.testing.assert_array_equal(t_g[~hit], t_r[~hit])
    # barycentrics lie in [0, 1] and divide by det: compare absolutely
    np.testing.assert_allclose(u_g[hit], u_r[hit], rtol=0, atol=2e-5)
    np.testing.assert_allclose(v_g[hit], v_r[hit], rtol=0, atol=2e-5)


@pytest.mark.parametrize(
    "kind", ["cube", "sphere2", "sphere3", "two_meshes", "instance"])
def test_closest_hit_matches_wide_walk(kind):
    scene = _scene(kind)
    org, d = _rays(700, seed=1)
    n_hit = 0
    for o, dd, base, end in _per_instance(scene, org, d):
        args = (scene.w_rows, scene.leaf_rows, o, dd, jnp.float32(INF),
                base, end, scene.max_leaf, scene.wide_k)
        ref = traverse.traverse_wide(*args)
        got = traverse_gpu.closest_hit(*args)
        _assert_same_hits(ref, got)
        n_hit += int((np.asarray(ref[1]) >= 0).sum())
    assert n_hit > 50  # the rays do reach the geometry


@pytest.mark.parametrize("r", [1, 127, 129, 1000])
def test_t_max_bounds_and_padding(r):
    """Per-lane t_max prunes hits beyond it; R that is not a whole number
    of blocks pads with retired lanes and returns exactly R results."""
    scene = _scene("sphere2")
    org, d = _rays(r, seed=r)
    t_max = jnp.asarray(np.random.default_rng(r).uniform(1.0, 4.0, r),
                        jnp.float32)
    args = (scene.w_rows, scene.leaf_rows, org, d, t_max,
            scene.w_inst_base[0], scene.w_inst_end[0], scene.max_leaf,
            scene.wide_k)
    got = traverse_gpu.closest_hit(*args)
    assert all(x.shape == (r,) for x in got)
    _assert_same_hits(traverse.traverse_wide(*args), got)
    t = np.asarray(got[0])
    assert np.all((t < np.asarray(t_max)) | (t >= INF))


@pytest.mark.parametrize("cut", ["scalar", "per_lane", "non_positive"])
def test_any_hit_matches_bounded_closest_hit(cut):
    scene = _scene("two_meshes")
    n = 600
    org, d = _rays(n, seed=5)
    rng = np.random.default_rng(9)
    if cut == "scalar":
        t_cut = jnp.float32(3.0)
    elif cut == "per_lane":
        t_cut = jnp.asarray(rng.uniform(0.5, 5.0, n), jnp.float32)
    else:
        t_cut = jnp.asarray(np.where(rng.random(n) < 0.5, 0.0, -1.0),
                            jnp.float32)
    for o, dd, base, end in _per_instance(scene, org, d):
        args = (scene.w_rows, scene.leaf_rows, o, dd, t_cut, base, end,
                scene.max_leaf, scene.wide_k)
        t_ref = np.asarray(traverse.traverse_wide(*args)[0])
        occ = np.asarray(traverse_gpu.occluded(*args))
        np.testing.assert_array_equal(occ, t_ref < INF)
        if cut == "non_positive":
            assert not occ.any()


def _lit_scene(intersector):
    b = SceneBuilder()
    b.add_plane([0, -1, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_mesh(sphere_mesh([0, 0, 0], 0.8, subdivisions=2),
               diffuse_material([0.6, 0.3, 0.2]))
    b.add_mesh(cube_mesh([1.0, -1.0, -0.3], [1.6, -0.2, 0.3]),
               diffuse_material([0.2, 0.5, 0.7]))
    b.add_sphere([2.0, 4.0, -1.0], 0.8, light_material([1, 1, 1], 12.0))
    return b.build(leaf_size=8, intersector=intersector)


@pytest.mark.parametrize("query", ["closest_hit", "occlusion_query"])
def test_scene_queries_pallas_equal_wide(query):
    wide = _lit_scene("wide")
    pallas = replace(wide, intersector="pallas")
    org, d = _rays(500, seed=3, spread=1.5)
    if query == "closest_hit":
        a, b = closest_hit(wide, org, d), closest_hit(pallas, org, d)
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                       rtol=1e-6)
        assert (np.asarray(a.t) < INF).mean() > 0.3
    else:
        t_cut = jnp.asarray(
            np.random.default_rng(4).uniform(0.5, 5.0, 500), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(occlusion_query(pallas, org, d, t_cut)),
            np.asarray(occlusion_query(wide, org, d, t_cut)))


def test_render_pallas_matches_wide():
    from ptsharp.camera import Camera
    from ptsharp.diff import render_image
    from ptsharp.integrator import IntegratorConfig

    wide = _lit_scene("wide")
    cam = Camera.look_at([0, 1.0, -4.5], [0, 0, 0], [0, 1, 0], 45.0)
    icfg = IntegratorConfig(max_bounces=2)
    key = jax.random.PRNGKey(3)
    img_w = np.asarray(render_image(wide, cam, icfg, key, 16, 12, 2))
    img_p = np.asarray(render_image(replace(wide, intersector="pallas"),
                                    cam, icfg, key, 16, 12, 2))
    assert np.isfinite(img_p).all() and img_p.mean() > 0
    # identical hits and RNG chain: the images agree to f32 rounding
    np.testing.assert_allclose(img_p, img_w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["closest_hit", "occluded"])
def test_kernels_lower_for_cuda(kernel):
    """Both kernels lower through Triton for CUDA without a GPU present
    (catches primitives the Triton lowering does not support)."""
    scene = _scene("sphere2")
    org, d = _rays(300)
    fn = getattr(traverse_gpu, kernel)
    f = jax.jit(lambda rows, leaf, o, dd, t, b, e: fn(
        rows, leaf, o, dd, t, b, e, scene.max_leaf, scene.wide_k,
        interpret=False))
    lowered = f.trace(scene.w_rows, scene.leaf_rows, org, d,
                      jnp.float32(INF), scene.w_inst_base[0],
                      scene.w_inst_end[0]).lower(
                          lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text


@pytest.mark.parametrize("backend, expect", [
    ("cpu", True), ("gpu", False), ("rocm", None), ("metal", None)])
def test_backend_guard(monkeypatch, backend, expect):
    """Interpret only on the CPU, compile on the GPU, raise elsewhere."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="no traversal kernel"):
            traverse_gpu._use_interpreter(None)
    else:
        assert traverse_gpu._use_interpreter(None) is expect
    assert traverse_gpu._use_interpreter(True) is True


@pytest.mark.parametrize("backend, use_tlas, expect", [
    ("cpu", False, "wide"), ("gpu", False, "pallas"), ("gpu", True, "wide"),
])
def test_default_intersector_by_backend(monkeypatch, backend, use_tlas,
                                        expect):
    """scene.build picks the kernel on the GPU for scenes without a TLAS
    (it walks each instance's BLAS), and the XLA walk otherwise."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    b = SceneBuilder()
    b.add_mesh(cube_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]), GREY)
    scene = b.build(leaf_size=8, use_tlas=use_tlas)
    assert scene.use_tlas == use_tlas
    assert scene.intersector == expect


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(platform.CACHE_ENV, str(tmp_path))
            assert platform.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself: the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv(platform.CACHE_ENV, raising=False)
            path = platform.enable_compile_cache()
            assert path == f"{platform.REPO_ROOT}/.jax_cache"
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# --- compiled on the card ---------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere3", "two_meshes", "instance"])
def test_compiled_closest_hit_on_gpu(kind):
    scene = _scene(kind)
    org, d = _rays(20000, seed=2)
    for o, dd, base, end in _per_instance(scene, org, d):
        args = (scene.w_rows, scene.leaf_rows, o, dd, jnp.float32(INF),
                base, end, scene.max_leaf, scene.wide_k)
        t_r, s_r, _u, _v = (np.asarray(x) for x in
                            traverse.traverse_wide(*args))
        t_g, s_g, _u, _v = (np.asarray(x) for x in
                            traverse_gpu.closest_hit(*args))
        assert np.mean(s_g == s_r) >= 0.999
        hit = (s_r >= 0) & (s_g >= 0)
        np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-4)


@pytest.mark.gpu
def test_compiled_any_hit_on_gpu():
    scene = _scene("two_meshes")
    org, d = _rays(20000, seed=6)
    t_cut = jnp.asarray(np.random.default_rng(1).uniform(0.5, 5.0, 20000),
                        jnp.float32)
    for o, dd, base, end in _per_instance(scene, org, d):
        args = (scene.w_rows, scene.leaf_rows, o, dd, t_cut, base, end,
                scene.max_leaf, scene.wide_k)
        t_ref = np.asarray(traverse.traverse_wide(*args)[0])
        occ = np.asarray(traverse_gpu.occluded(*args))
        assert np.mean(occ == (t_ref < INF)) >= 0.999
