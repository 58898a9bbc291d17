import jax.numpy as jnp
import numpy as np

from rust_pathtracer_tpu import vecmath as vm


def test_basics_reference_vectors():
    # the reference's only unit test (vec3.rs:256-274)
    a = jnp.array([1.0, 0.0, 0.0])
    b = jnp.array([0.0, 1.0, 0.0])
    c = jnp.array([1.0, 1.0, 1.0])
    d = jnp.array([0.0, 10.0, 0.0])
    assert np.allclose(a + b, [1, 1, 0])
    assert np.allclose(a - b, [1, -1, 0])
    assert np.allclose(-c, [-1, -1, -1])
    assert float(vm.dot(a + b, c)) == 2.0
    assert np.allclose(vm.cross(a, b), [0, 0, 1])
    assert np.allclose(vm.normalize(d), [0, 1, 0])


def test_batched_ops():
    v = jnp.array([[3.0, 4.0, 0.0], [0.0, 0.0, 2.0]])
    assert np.allclose(vm.length(v), [5.0, 2.0])
    assert np.allclose(vm.length_squared(v), [25.0, 4.0])
    n = vm.normalize(v)
    assert np.allclose(vm.length(n), [1.0, 1.0], atol=1e-6)


def test_reflect():
    # v - 2(v.n)n (vec3.rs:114-116)
    v = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    assert np.allclose(vm.reflect(v, n), [[1.0, 1.0, 0.0]])


def test_refract_straight_through():
    # normal incidence, eta=1 -> direction preserved
    v = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = vm.refract(v, n, 1.0)
    assert np.allclose(out, v, atol=1e-6)


def test_refract_snell():
    # 45 degrees into eta ratio 0.5: sin_out = 0.5 * sin(45)
    th = np.deg2rad(45.0)
    v = jnp.array([[np.sin(th), -np.cos(th), 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = np.asarray(vm.refract(v, n, 0.5))[0]
    out = out / np.linalg.norm(out)
    assert np.isclose(out[0], 0.5 * np.sin(th), atol=1e-6)
    assert out[1] < 0


def test_near_zero():
    assert bool(vm.near_zero(jnp.array([1e-9, -1e-9, 0.0])))
    assert not bool(vm.near_zero(jnp.array([1e-9, 1e-7, 0.0])))
