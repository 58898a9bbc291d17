"""Thin-lens camera as a differentiable pytree + batched ray generation.

Reference behavior: ``Camera::new`` (camera.rs:14-44) precomputes the
(u, v, w) basis, focus-distance-scaled viewport vectors and the lower
left corner; ``ray_at(s, t)`` (camera.rs:46-56) samples the aperture
disk and aims at the focal-plane point.  Ray directions are **not**
normalized — intersection ``t`` is measured in units of |direction|,
and the shadow epsilon t_min=0.001 (ray.rs:25) inherits that meaning.
We reproduce that exactly.

Design: the camera is a small pytree of arrays so it jits cleanly,
shards as replicated state, and is differentiable (per-parameter
gradients for lookfrom/fov/... flow through ``make_camera`` into
``camera_rays``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rust_pathtracer_tpu import sampling, vecmath as vm


class Camera(NamedTuple):
    """Precomputed camera frame (all jnp arrays, shape (3,) or ())."""

    origin: jnp.ndarray
    lower_left_corner: jnp.ndarray
    horizontal: jnp.ndarray
    vertical: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    lens_radius: jnp.ndarray


def make_camera(
    lookfrom,
    lookat,
    up,
    vertical_fov_deg,
    aspect_ratio,
    aperture=0.0,
    focus_dist=1.0,
):
    """Build a Camera pytree (camera.rs:14-44)."""
    lookfrom = jnp.asarray(lookfrom, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    vfov = jnp.asarray(vertical_fov_deg, jnp.float32)
    aspect = jnp.asarray(aspect_ratio, jnp.float32)

    h = jnp.tan(jnp.deg2rad(vfov) / 2.0)
    viewport_w = aspect * 2.0 * h
    viewport_h = 2.0 * h

    w = vm.normalize(lookfrom - lookat)
    u = vm.normalize(vm.cross(up, w))
    v = vm.cross(w, u)

    focus_dist = jnp.asarray(focus_dist, jnp.float32)
    horizontal = focus_dist * viewport_w * u
    vertical = focus_dist * viewport_h * v
    lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

    return Camera(
        origin=lookfrom,
        lower_left_corner=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=jnp.asarray(aperture, jnp.float32) / 2.0,
    )


def camera_rays(camera: Camera, s, t, lens_keys):
    """Batched ``ray_at`` (camera.rs:46-56).

    s, t: (R,) viewport coordinates in [0,1]; lens_keys: (R,2) per-lane
    RNG keys for the aperture disk sample.  Returns (origins (R,3),
    directions (R,3)); directions are unnormalized, as in the reference.
    """
    rng = camera.lens_radius * sampling.in_unit_disk_xy(lens_keys)
    blur = camera.u * rng[..., 0:1] + camera.v * rng[..., 1:2]
    origin = camera.origin + blur
    direction = (
        camera.lower_left_corner
        + s[..., None] * camera.horizontal
        + t[..., None] * camera.vertical
        - camera.origin
        - blur
    )
    return origin, direction
