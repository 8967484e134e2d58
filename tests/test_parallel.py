"""Multi-device sharding tests on the 8-virtual-CPU mesh (conftest forces
xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptsharp.camera import Camera
from ptsharp.diff import render_image
from ptsharp.integrator import IntegratorConfig
from ptsharp.materials import diffuse_material, light_material
from ptsharp.parallel.mesh import make_mesh
from ptsharp.parallel.shard import make_train_step, render_image_sharded
from ptsharp.scene import SceneBuilder


@pytest.fixture
def eight_devices():
    """Decided per test, never at import (conftest asks for 8 virtual
    CPU devices)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _scene():
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.6, 0.3, 0.2]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 6.0))
    b.set_environment(color=[0.05, 0.05, 0.05])
    return b.build()


SCENE = _scene()
CAM = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
CFG = IntegratorConfig(max_bounces=2)


@pytest.mark.slow
def test_sharded_render_matches_expectation(eight_devices):
    """8-device sharded render must estimate the same image as the
    single-device render (different RNG streams -> compare converged-ish
    means loosely)."""
    mesh = make_mesh(dp=4, sp=2)
    img_sh = render_image_sharded(
        SCENE, CAM, CFG, jax.random.PRNGKey(0), 8, 8, 8, mesh
    )
    img_1 = render_image(SCENE, CAM, CFG, jax.random.PRNGKey(1), 8, 8, 8)
    assert img_sh.shape == (8, 8, 3)
    assert np.isfinite(np.asarray(img_sh)).all()
    np.testing.assert_allclose(
        float(jnp.mean(img_sh)), float(jnp.mean(img_1)), rtol=0.15
    )


@pytest.mark.slow
def test_sharded_output_sharding(eight_devices):
    """Output rows must actually be sharded over dp."""
    mesh = make_mesh(dp=4, sp=2)
    img = render_image_sharded(
        SCENE, CAM, CFG, jax.random.PRNGKey(0), 8, 16, 2, mesh
    )
    shard_rows = {s.index[0].start or 0 for s in img.addressable_shards}
    assert len(shard_rows) == 4  # 4 distinct row blocks


def test_sharded_train_step(eight_devices):
    """Full sharded forward+backward+update step decreases loss toward a
    black target (albedo shrinks)."""
    mesh = make_mesh(dp=4, sp=2)
    step = make_train_step(CAM, CFG, 8, 8, 2, mesh, lr=0.5)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    scene = SCENE
    losses = []
    for i in range(2):
        scene, loss = step(scene, jax.random.PRNGKey(i), target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # moving toward black


def test_graft_entry_single_chip():
    """The driver contract: entry() compiles and runs on one device."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.slow
def test_graft_entry_multichip(eight_devices):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
