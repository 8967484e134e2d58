"""ptsharp — a differentiable wavefront path tracer in JAX, run on a GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of akav/PTSharp
(a recursive CPU path tracer in C#). Nothing here is a
port: rendering runs as a *wavefront* — SoA ray/hit buffers scanned over
bounce depth with `lax.scan`, masked branchless material sampling, batched
next-event estimation, and flattened wide-leaf BVH traversal — sharded over
a `jax.sharding.Mesh` of several cards.

Layer map (mirrors SURVEY.md §7):
  core/        vec math, sampling, color, 4x4 transforms
  film.py      Welford mean/M2/count film + AOVs
  camera.py    look-at pinhole/thin-lens camera, batched ray generation
  materials.py material SoA table + the 7 PTSharp material archetypes
  geometry/    primitive SoA tables, SDF CSG, volumes, meshes, marching cubes
  accel/       host BVH build + on-device flattened traversal
  pallas/      per-lane BVH traversal kernels for the GPU (Triton route)
  scene.py     host scene builder -> frozen device SceneData
  integrator.py  wavefront path integrator (the replacement for the
                 recursive megakernel in reference Sampler.cs)
  renderer.py  progressive/adaptive/firefly render driver
  parallel/    device mesh + shard_map render
  io/          OBJ/MTL, STL, image/texture loaders
  denoise.py   joint-bilateral/à-trous denoiser (OIDN-equivalent hook)
  examples.py  scene catalog (the reference's Example.cs scenes)
"""

from ptsharp.version import __version__

from ptsharp.core import vec, sampling, color, transform
from ptsharp.materials import (
    Material,
    diffuse_material,
    specular_material,
    glossy_material,
    clear_material,
    transparent_material,
    metallic_material,
    light_material,
)
from ptsharp.camera import Camera
from ptsharp.film import Film
from ptsharp.scene import SceneBuilder, SceneData
from ptsharp.integrator import IntegratorConfig
from ptsharp.renderer import Renderer, RenderConfig
from ptsharp.tape import trace_tape_radiance

__all__ = [
    "__version__",
    "vec",
    "sampling",
    "color",
    "transform",
    "Material",
    "diffuse_material",
    "specular_material",
    "glossy_material",
    "clear_material",
    "transparent_material",
    "metallic_material",
    "light_material",
    "Camera",
    "Film",
    "SceneBuilder",
    "SceneData",
    "IntegratorConfig",
    "Renderer",
    "RenderConfig",
    "trace_tape_radiance",
]
