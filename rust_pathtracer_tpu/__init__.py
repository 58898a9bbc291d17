"""rust_pathtracer_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ArcticXWolf/rust-pathtracer (reference mounted at /root/reference):
Ray-Tracing-in-One-Weekend style path tracing — spheres / axis-aligned
rectangles / boxes / triangles / OBJ meshes, lambertian / metal /
dielectric / emissive materials, solid / checker / perlin / image
textures, thin-lens camera, BVH acceleration — rebuilt for an
accelerator (an NVIDIA GPU):

* scalar ``Vec3`` math          -> batched ``(..., 3)`` jnp arrays (vecmath)
* recursive ``Ray::color``      -> iterative wavefront bounce loop (integrator)
* pointer BVH                   -> flattened SoA threaded (skip-link) arrays (bvh)
* rayon pixel parallelism       -> shard_map tile/sample sharding over a Mesh (parallel)
* thread RNG rejection sampling -> counter-based threefry, analytic sampling (sampling)
* plus: end-to-end differentiability w.r.t. albedo / emission / texels /
  camera (grad), which the reference does not have.

Reference behavior citations use ``file.rs:line`` pointing into
/root/reference/src.
"""

from rust_pathtracer_tpu.version import __version__

__all__ = ["__version__"]
