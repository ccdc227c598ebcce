"""The port's URDF loader against the JAX package's, on a URDF and STL
meshes that the test writes itself.

The arm: a fixed base link, a revolute z joint, a revolute joint about -y,
a continuous x joint and a trailing fixed joint; inertials, limits and
origins on each; link 1's collision mesh is a binary STL, link 2's an ASCII
one, link 3's a file that does not exist (the default box).  Both packages
parse it into equal ``RobotSpec`` fields (the mass-matrix eigenvalue bounds
of ``calibrate_mass_eigs`` to rtol 1e-9, the rest exactly), and the port
plans free space with the robot, as ``tests/test_multirobot.py`` does with
the reference's URDFs.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from armour_tpu.robots import urdf as jurdf
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots import urdf as turdf

URDF = """<?xml version="1.0"?>
<robot name="test_arm">
  <link name="base"/>
  <link name="link1">
    <inertial><origin xyz="0 0 0.1"/><mass value="2.0"/>
      <inertia ixx="0.02" ixy="0.001" ixz="0" iyy="0.02" iyz="0.002" izz="0.01"/></inertial>
    <collision><geometry><mesh filename="meshes/link1.stl"/></geometry></collision>
  </link>
  <link name="link2">
    <inertial><origin xyz="0.15 0 0"/><mass value="1.5"/>
      <inertia ixx="0.005" ixy="0" ixz="0.0005" iyy="0.015" iyz="0" izz="0.015"/></inertial>
    <collision><geometry><mesh filename="meshes/link2.stl"/></geometry></collision>
  </link>
  <link name="link3">
    <inertial><origin xyz="0 0.05 0.02"/><mass value="0.8"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.001"/></inertial>
    <collision><geometry><mesh filename="meshes/missing.stl"/></geometry></collision>
  </link>
  <link name="tool"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="link1"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.5" upper="2.5" velocity="1.5" effort="40"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="link1"/><child link="link2"/>
    <origin xyz="0 0 0.2" rpy="1.5707963267948966 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="-2.0" upper="2.0" velocity="1.2" effort="30"/>
  </joint>
  <joint name="j3" type="continuous">
    <parent link="link2"/><child link="link3"/>
    <origin xyz="0.3 0 0" rpy="0 0.3 -0.2"/><axis xyz="1 0 0"/>
    <limit velocity="2.0" effort="10"/>
  </joint>
  <joint name="tool_joint" type="fixed">
    <parent link="link3"/><child link="tool"/>
    <origin xyz="0 0.1 0"/>
  </joint>
</robot>
"""


def _binary_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"binary stl written by the test".ljust(80, b" "))
        f.write(struct.pack("<I", len(tris)))
        for tri in tris:
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0))
            for v in tri:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


def _ascii_stl(path, tris):
    lines = ["solid part"]
    for tri in tris:
        lines += ["facet normal 0 0 1", " outer loop"]
        lines += [f"  vertex {v[0]} {v[1]} {v[2]}" for v in tri]
        lines += [" endloop", "endfacet"]
    path.write_text("\n".join(lines + ["endsolid part"]))


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("urdf")
    (root / "meshes").mkdir()
    rng = np.random.default_rng(0)
    _binary_stl(root / "meshes" / "link1.stl",
                rng.uniform([-0.05, -0.04, 0.0], [0.05, 0.04, 0.2], (12, 3, 3)).astype(np.float32))
    _ascii_stl(root / "meshes" / "link2.stl", rng.uniform([0.0, -0.03, -0.03], [0.3, 0.03, 0.03], (8, 3, 3)))
    path = root / "test_arm.urdf"
    path.write_text(URDF)
    return path


def test_stl_bounding_boxes_match_jax(urdf_path):
    for name in ("link1.stl", "link2.stl", "missing.stl"):
        mesh = urdf_path.parent / "meshes" / name
        want, got = jurdf._stl_bounding_box(mesh), turdf._stl_bounding_box(mesh)
        if want is None:
            assert got is None
            continue
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


def test_load_urdf_matches_jax(urdf_path):
    want = jurdf.load_urdf(urdf_path)
    got = turdf.load_urdf(urdf_path, device="cpu")
    assert (got.n_joints, got.n_factors) == (4, 3)
    assert list(got.axes) == [3, -2, 1, 0]
    assert got.continuous_joints.tolist() == [False, False, True]
    assert got.mesh_paths[:2] == want.mesh_paths[:2] and got.mesh_paths[2:] == (None, None)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name in ("m_min_eig", "m_max_eig"):
            np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=field.name)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field.name
            np.testing.assert_array_equal(g, w, err_msg=field.name)
        else:
            assert g == w, field.name


def test_calibrate_mass_eigs_matches_jax(urdf_path):
    spec = dataclasses.replace(turdf.load_urdf(urdf_path, device="cpu"),
                               armature=np.full(4, 0.5))
    want = jurdf.calibrate_mass_eigs(spec, n_samples=16, seed=3)
    got = turdf.calibrate_mass_eigs(spec, n_samples=16, seed=3, device="cpu")
    np.testing.assert_allclose([got.m_min_eig, got.m_max_eig], [want.m_min_eig, want.m_max_eig],
                               rtol=1e-9)
    assert got.m_min_eig != spec.m_min_eig


def test_urdf_robot_plans_free_space(urdf_path):
    spec = turdf.load_urdf(urdf_path, device="cpu")
    spec = dataclasses.replace(spec, armature=np.full(spec.n_joints, 5.0),
                               torque_limits=np.maximum(spec.torque_limits, 30.0))
    spec = turdf.calibrate_mass_eigs(spec, n_samples=16, device="cpu")
    cfg = PlannerConfig(num_time_steps=8, max_obstacles=2, nlp_num_starts=2,
                        nlp_outer_iters=6, nlp_inner_iters=6)
    planner = ArmourPlanner(spec, cfg, device="cpu")
    nf = spec.n_factors
    lb = np.where(spec.continuous_joints, -1.5, spec.pos_limits_lb * 0.4)
    ub = np.where(spec.continuous_joints, 1.5, spec.pos_limits_ub * 0.4)
    q0 = 0.5 * (lb + ub)
    far = ObstacleSet.from_boxes([[9.0, 9.0, 9.0]], [[0.1, 0.1, 0.1]], cfg.max_obstacles)
    res = planner.plan(q0, np.zeros(nf), np.zeros(nf), q0 + 0.4 * cfg.k_range, far)
    assert bool(res.feasible), float(res.max_violation)
    assert bool(torch.isfinite(res.k).all())
