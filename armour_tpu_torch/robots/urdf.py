"""URDF -> RobotSpec loader for serial manipulators.

Port of `armour_tpu/robots/urdf.py` (the reference's model layer:
`urdf_utils/load_robot_params.m`, the MATLAB Robotics Toolbox import and
`create_pz_bounding_boxes.m`): parses a URDF with the standard library's
XML parser, walks the serial chain, extracts inertial parameters and joint
frames, and computes link bounding-box zonotopes from the collision STL
meshes when present.  The parsing is numpy and XML only, as in the JAX
package; the mass-matrix calibration runs the port's RNEA.

Constraints inherited from the reference planner core: joint axes must be
axis-aligned in the joint frame (`KinovaWithoutGripperInfo.h:16-17`), and
fixed joints must trail the actuated ones (`Trajectory.cu:247-251`).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from pathlib import Path
from xml.etree import ElementTree

import numpy as np
import torch

from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.dynamics.rnea import mass_matrix
from armour_tpu_torch.robots.spec import RobotSpec


def _parse_vec(s, default="0 0 0"):
    return np.array([float(x) for x in (s or default).split()])


def _stl_bounding_box(path: Path):
    """Axis-aligned bounding box of an STL mesh (binary or ASCII).

    Returns (center, half_extents) or None (the reference computes the same
    boxes with MATLAB's stlread, `create_pz_bounding_boxes.m:1-35`).
    """
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    if len(raw) < 84:
        return None
    # binary STL: 80-byte header + uint32 count + 50-byte triangles
    (n_tri,) = struct.unpack_from("<I", raw, 80)
    if 84 + n_tri * 50 == len(raw):
        pts = np.ndarray(
            (n_tri, 9), dtype="<f4", buffer=raw, offset=84 + 12, strides=(50, 4)
        ).reshape(-1, 3)
    else:  # ASCII
        pts = []
        for line in raw.decode(errors="ignore").splitlines():
            t = line.split()
            if len(t) == 4 and t[0] == "vertex":
                pts.append([float(t[1]), float(t[2]), float(t[3])])
        if not pts:
            return None
        pts = np.asarray(pts)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def load_urdf(
    path,
    base_link: str | None = None,
    armature: np.ndarray | None = None,
    mass_uncertainty: float = 0.03,
    inertia_uncertainty: float = 0.03,
    gravity: float = 9.81,
    default_link_half: float = 0.06,
    device=None,
) -> RobotSpec:
    """Parse a serial-chain URDF into a RobotSpec; the mass-matrix
    eigenvalue bounds come from `calibrate_mass_eigs` on ``device`` (the
    card unless ``device="cpu"``)."""
    path = Path(path)
    tree = ElementTree.parse(path)
    robot = tree.getroot()

    links = {}
    for link in robot.findall("link"):
        inertial = link.find("inertial")
        entry = {"mass": 0.0, "com": np.zeros(3), "inertia": np.zeros((3, 3))}
        if inertial is not None:
            mass_el = inertial.find("mass")
            entry["mass"] = float(mass_el.get("value")) if mass_el is not None else 0.0
            origin = inertial.find("origin")
            if origin is not None:
                entry["com"] = _parse_vec(origin.get("xyz"))
            it = inertial.find("inertia")
            if it is not None:
                g = lambda k: float(it.get(k, "0"))
                entry["inertia"] = np.array(
                    [
                        [g("ixx"), g("ixy"), g("ixz")],
                        [g("ixy"), g("iyy"), g("iyz")],
                        [g("ixz"), g("iyz"), g("izz")],
                    ]
                )
        coll = link.find("collision")
        mesh_file = None
        if coll is not None:
            mesh = coll.find("geometry/mesh")
            if mesh is not None:
                mesh_file = mesh.get("filename")
        entry["mesh"] = mesh_file
        links[link.get("name")] = entry

    joints = []
    children = {}
    child_names = set()
    for joint in robot.findall("joint"):
        j = {
            "name": joint.get("name"),
            "type": joint.get("type"),
            "parent": joint.find("parent").get("link"),
            "child": joint.find("child").get("link"),
            "xyz": np.zeros(3),
            "rpy": np.zeros(3),
            "axis": np.array([0.0, 0.0, 1.0]),
            "lower": -1000.0,
            "upper": 1000.0,
            "velocity": 1e3,
            "effort": 1e6,
        }
        origin = joint.find("origin")
        if origin is not None:
            j["xyz"] = _parse_vec(origin.get("xyz"))
            j["rpy"] = _parse_vec(origin.get("rpy"))
        axis = joint.find("axis")
        if axis is not None:
            j["axis"] = _parse_vec(axis.get("xyz"), "0 0 1")
        limit = joint.find("limit")
        if limit is not None:
            for key in ("lower", "upper", "velocity", "effort"):
                if limit.get(key) is not None:
                    j[key] = float(limit.get(key))
        if j["type"] == "continuous":
            j["lower"], j["upper"] = -1000.0, 1000.0
        joints.append(j)
        children[j["parent"]] = j
        child_names.add(j["child"])

    # root link = a parent that is never a child
    if base_link is None:
        roots = [j["parent"] for j in joints if j["parent"] not in child_names]
        assert roots, "no root link found"
        base_link = roots[0]

    # walk the serial chain
    chain = []
    cur = base_link
    while cur in children:
        j = children[cur]
        chain.append(j)
        cur = j["child"]

    # split actuated prefix / fixed suffix
    n_joints = len(chain)
    axes = np.zeros(n_joints, dtype=np.int64)
    for i, j in enumerate(chain):
        if j["type"] in ("revolute", "continuous"):
            a = j["axis"]
            dim = int(np.argmax(np.abs(a)))
            assert abs(abs(a[dim]) - 1.0) < 1e-6 and np.sum(np.abs(a)) < 1.0 + 1e-6, (
                f"joint {j['name']}: axis must be axis-aligned, got {a}"
            )
            axes[i] = (dim + 1) * (1 if a[dim] > 0 else -1)
        elif j["type"] == "fixed":
            axes[i] = 0
        else:
            raise ValueError(f"unsupported joint type {j['type']}")
    n_factors = int(np.sum(axes != 0))
    assert all(a != 0 for a in axes[:n_factors]), (
        "fixed joints must trail the actuated ones"
    )

    trans = np.zeros((n_joints + 1, 3))
    rots = np.zeros((n_joints, 3))
    mass = np.zeros(n_joints)
    com = np.zeros((n_joints, 3))
    inertia = np.zeros((n_joints, 3, 3))
    zono_c = np.zeros((n_joints, 3))
    zono_g = np.zeros((n_joints, 3))
    mesh_paths: list = [None] * n_joints
    for i, j in enumerate(chain):
        trans[i] = j["xyz"]
        rots[i] = j["rpy"]
        L = links[j["child"]]
        mass[i] = L["mass"]
        com[i] = L["com"]
        inertia[i] = L["inertia"]
        bbox = None
        if L["mesh"]:
            mesh_path = (path.parent / L["mesh"]).resolve()
            bbox = _stl_bounding_box(mesh_path)
            if bbox is not None:
                mesh_paths[i] = str(mesh_path)
            else:
                for cand in path.parent.rglob(Path(L["mesh"]).name):
                    bbox = _stl_bounding_box(cand)
                    if bbox:
                        mesh_paths[i] = str(cand)
                        break
        if bbox is not None:
            zono_c[i], zono_g[i] = bbox
        else:
            # fall back to a box spanning COM with a default margin
            zono_c[i] = L["com"]
            zono_g[i] = np.maximum(np.abs(L["com"]), default_link_half)

    lowers = np.array([chain[i]["lower"] for i in range(n_factors)])
    uppers = np.array([chain[i]["upper"] for i in range(n_factors)])
    speeds = np.array([chain[i]["velocity"] for i in range(n_factors)])
    efforts = np.array([chain[i]["effort"] for i in range(n_factors)])

    if armature is None:
        armature = np.zeros(n_joints)

    spec = RobotSpec(
        name=robot.get("name", path.stem),
        n_joints=n_joints,
        n_factors=n_factors,
        axes=axes,
        trans=trans,
        rots=rots,
        mass=mass,
        com=com,
        inertia=inertia,
        mass_uncertainty=mass_uncertainty,
        com_uncertainty=0.0,
        inertia_uncertainty=inertia_uncertainty,
        friction=np.zeros(n_joints),
        damping=np.zeros(n_joints),
        armature=np.asarray(armature, float),
        pos_limits_lb=lowers,
        pos_limits_ub=uppers,
        speed_limits=speeds,
        torque_limits=efforts,
        gravity=gravity,
        link_zono_center=zono_c,
        link_zono_gen=zono_g,
        mesh_paths=tuple(mesh_paths),
    )
    return calibrate_mass_eigs(spec, device=device)


def calibrate_mass_eigs(spec: RobotSpec, n_samples: int = 64, seed: int = 0,
                        device=None) -> RobotSpec:
    """Estimate the M_min/M_max eigenvalue bounds by sampling configurations
    (the reference hardcodes them per robot,
    `KinovaWithoutGripperInfo.h:105-106`).  The samples come from numpy's
    ``default_rng(seed)``, the JAX package's stream, and go through one
    batched f64 mass-matrix pass on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lb = np.where(spec.continuous_joints, -math.pi, spec.pos_limits_lb)
    ub = np.where(spec.continuous_joints, math.pi, spec.pos_limits_ub)
    q = np.stack([rng.uniform(lb, ub) for _ in range(n_samples)])
    M = mass_matrix(spec, torch.as_tensor(q, dtype=torch.float64, device=dev),
                    include_armature=True).cpu().numpy()
    w = np.linalg.eigvalsh(0.5 * (M + np.swapaxes(M, -1, -2)))
    return dataclasses.replace(spec, m_min_eig=0.95 * float(w.min()),
                               m_max_eig=1.05 * float(w.max()))
