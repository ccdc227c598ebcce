"""Parity of the port's exact mesh oracle with the JAX package's, on the
CPU: the same posed configurations against the same obstacle AABBs give
EQUAL booleans, on the link bounding-box meshes (what both packages use
while the Kinova STL meshes are not in the repository), on an STL mesh
written by the test, and with no obstacles at all.  ``box_mesh`` and
``load_stl_triangles`` (binary and ASCII) give equal arrays.  The port
builds its own copy of the C++ source; the JAX package builds
`native/mesh_oracle.cpp`.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest

from armour_tpu.collision import mesh_oracle as jax_mo
from armour_tpu.dynamics.rnea import forward_kinematics as jax_fk
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision import mesh_oracle
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(0)
    q = rng.uniform(-2.5, 2.5, (200, 7))
    Rw, pw = jax_fk(JSPEC, jnp.asarray(q))
    return np.asarray(Rw, np.float64), np.asarray(pw, np.float64)


def _aabbs(rng, n):
    c = rng.uniform(-0.7, 0.7, (n, 3))
    c[:, 2] = np.abs(c[:, 2]) + 0.1
    return np.concatenate([c, rng.uniform(0.02, 0.2, (n, 3))], axis=1)


def test_library_is_built_into_the_ignored_build_directory():
    path = mesh_oracle.build()
    assert path.exists() and path.parent == mesh_oracle.BUILD_DIR
    assert path.name.startswith("mesh_oracle-") and path.suffix == ".so"


def test_serial_build_gives_the_same_verdicts(poses, tmp_path, monkeypatch):
    """Where the compiler has no OpenMP runtime the oracle is built without
    ``-fopenmp``: one core, the same verdicts."""
    monkeypatch.setattr(mesh_oracle, "VARIANTS", ((),))
    monkeypatch.setattr(mesh_oracle, "BUILD_DIR", tmp_path)
    mesh_oracle._lib.cache_clear()
    try:
        assert mesh_oracle.build() == mesh_oracle.library_path(())
        serial = mesh_oracle.oracle_for_spec(SPEC)
    finally:
        mesh_oracle._lib.cache_clear()
    Rw, pw = poses
    aabb = _aabbs(np.random.default_rng(3), 6)
    want = jax_mo.oracle_for_spec(JSPEC).check(Rw, pw, aabb)
    np.testing.assert_array_equal(serial.check(Rw, pw, aabb), want)
    assert 0 < want.sum() < len(Rw)


def test_box_mesh_and_spec_oracle_match_jax(poses):
    for i in range(SPEC.n_joints):
        np.testing.assert_array_equal(
            mesh_oracle.box_mesh(SPEC.link_zono_center[i], SPEC.link_zono_gen[i]),
            jax_mo.box_mesh(JSPEC.link_zono_center[i], JSPEC.link_zono_gen[i]))
    assert SPEC.mesh_paths is None            # the STL meshes are not in the repository
    assert jax_mo.available()
    port, ref = mesh_oracle.oracle_for_spec(SPEC), jax_mo.oracle_for_spec(JSPEC)
    Rw, pw = poses
    rng = np.random.default_rng(1)
    hits = 0
    for n_obs in (1, 4, 12):
        aabb = _aabbs(rng, n_obs)
        want = ref.check(Rw, pw, aabb)
        got = port.check(Rw, pw, aabb)
        np.testing.assert_array_equal(got, want)
        hits += int(want.sum())
    assert 0 < hits < 3 * len(Rw)             # both verdicts exercised
    # no obstacles: nothing collides
    empty = np.zeros((0, 6))
    assert not port.check(Rw, pw, empty).any()
    np.testing.assert_array_equal(port.check(Rw, pw, empty), ref.check(Rw, pw, empty))


def test_small_obstacle_inside_a_link_box_is_no_mesh_hit(poses):
    """The box screen flags an obstacle inside a link's box; the mesh oracle
    tests the link's surface and does not: the refinement the battery
    driver relies on."""
    Rw, pw = poses
    link = 3
    center = Rw[0, link] @ SPEC.link_zono_center[link] + pw[0, link]
    tiny = np.concatenate([center, [0.005, 0.005, 0.005]])[None]
    port = mesh_oracle.oracle_for_spec(SPEC)
    assert not port.check(Rw[:1], pw[:1], tiny)[0]
    assert not jax_mo.oracle_for_spec(JSPEC).check(Rw[:1], pw[:1], tiny)[0]
    big = np.concatenate([center, [0.3, 0.3, 0.3]])[None]
    assert port.check(Rw[:1], pw[:1], big)[0]


def _write_stl(path, tris, binary):
    if binary:
        with open(path, "wb") as f:
            f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
            for t in tris:
                f.write(struct.pack("<3f", 0, 0, 0) + struct.pack("<9f", *t.reshape(-1)) + b"\0\0")
    else:
        lines = ["solid t"]
        for t in tris:
            lines += ["facet normal 0 0 0", "outer loop"]
            lines += [f"vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}" for v in t]
            lines += ["endloop", "endfacet"]
        path.write_text("\n".join(lines + ["endsolid t"]))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_stl_meshes_match_jax(tmp_path, poses, binary):
    # a box-shaped link mesh in float32-representable coordinates
    tris = mesh_oracle.box_mesh([0.0, 0.0, 0.05], [0.04, 0.03, 0.06]).astype(np.float32).astype(float)
    path = tmp_path / "link.stl"
    _write_stl(path, tris, binary)
    got = mesh_oracle.load_stl_triangles(path)
    np.testing.assert_array_equal(got, jax_mo.load_stl_triangles(path))
    np.testing.assert_allclose(got, tris, rtol=0, atol=1e-9)   # the ASCII form prints 9 digits
    (tmp_path / "short.stl").write_bytes(b"\0" * 10)
    assert mesh_oracle.load_stl_triangles(tmp_path / "short.stl") is None
    paths = (str(path),) + (None,) * (SPEC.n_joints - 1)
    port = mesh_oracle.oracle_for_spec(SPEC, paths)
    ref = jax_mo.oracle_for_spec(JSPEC, paths)
    Rw, pw = poses
    aabb = _aabbs(np.random.default_rng(2), 8)
    np.testing.assert_array_equal(port.check(Rw, pw, aabb), ref.check(Rw, pw, aabb))
    with pytest.raises(ValueError, match="poses must be"):
        port.check(Rw[:, :3], pw[:, :3], aabb)
