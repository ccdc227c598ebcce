"""Frozen copy of ``armour_tpu_torch/robots/kinova.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Kinova Gen3 7-DOF specification (flagship robot).

Numbers replicate `kinova_planner_realtime/KinovaWithoutGripperInfo.h:9-113`
exactly (which in turn come from `urdfs/kinova_without_gripper.urdf`).
"""

from __future__ import annotations

import math

import numpy as np

from armour_bench.reference.spec import RobotSpec

_PI = math.pi


def kinova_gen3_spec() -> RobotSpec:
    trans = np.array(
        [
            [0.0, 0.0, 0.15643],
            [0.0, 0.005375, -0.12838],
            [0.0, -0.21038, -0.006375],
            [0.0, 0.006375, -0.21038],
            [0.0, -0.20843, -0.006375],
            [0.0, 0.00017505, -0.10593],
            [0.0, -0.10593, -0.00017505],
            [0.0, 0.0, 0.0],
        ]
    )

    rots = np.array(
        [
            [_PI, 0.0, 0.0],
            [_PI * 0.5, 0.0, 0.0],
            [-_PI * 0.5, 0.0, 0.0],
            [_PI * 0.5, 0.0, 0.0],
            [-_PI * 0.5, 0.0, 0.0],
            [_PI * 0.5, 0.0, 0.0],
            [-_PI * 0.5, 0.0, 0.0],
        ]
    )

    mass = np.array([1.3773, 1.1636, 1.1636, 0.9302, 0.6781, 0.6781, 0.5])

    com = np.array(
        [
            [-0.000023, -0.010364, -0.07336],
            [-0.000044, -0.09958, -0.013278],
            [-0.000044, -0.006641, -0.117892],
            [-0.000018, -0.075478, -0.015006],
            [0.000001, -0.009432, -0.063883],
            [0.000001, -0.045483, -0.00965],
            [0.000281, 0.011402, -0.029798],
        ]
    )

    inertia_flat = np.array(
        [
            [0.00457, 0.000001, 0.000002, 0.000001, 0.004831, 0.000448, 0.000002, 0.000448, 0.001409],
            [0.011088, 0.000005, 0.0, 0.000005, 0.001072, -0.000691, 0.0, -0.000691, 0.011255],
            [0.010932, 0.0, -0.000007, 0.0, 0.011127, 0.000606, -0.000007, 0.000606, 0.001043],
            [0.008147, -0.000001, 0.0, -0.000001, 0.000631, -0.0005, 0.0, -0.0005, 0.008316],
            [0.001596, 0.0, 0.0, 0.0, 0.001607, 0.000256, 0.0, 0.000256, 0.000399],
            [0.001641, 0.0, 0.0, 0.0, 0.00041, -0.000278, 0.0, -0.000278, 0.001641],
            [0.000587, 0.000003, 0.000003, 0.000003, 0.000369, -0.000118, 0.000003, -0.000118, 0.000609],
        ]
    )

    armature = np.array(
        [
            8.03,
            11.9962024615303644,
            9.0025427861751517,
            11.5806439316706360,
            8.4665040917914123,
            8.8537069373742430,
            8.8587303664685315,
        ]
    )

    link_zono_center = np.array(
        [
            [0.000000, -0.001297, -0.088375],
            [0.000000, -0.089400, -0.007877],
            [0.000000, -0.001502, -0.129375],
            [0.000000, -0.087450, -0.013648],
            [0.000001, -0.009023, -0.071752],
            [0.000000, -0.041661, -0.009251],
            [0.000000, -0.018585, -0.033462],
        ]
    )

    link_zono_gen = np.array(
        [
            [0.046358, 0.047354, 0.086000],
            [0.046000, 0.135400, 0.047501],
            [0.046000, 0.047501, 0.127000],
            [0.046000, 0.133450, 0.042293],
            [0.034999, 0.044023, 0.069252],
            [0.035000, 0.076739, 0.044076],
            [0.045500, 0.056085, 0.030963],
        ]
    )

    return RobotSpec(
        name="kinova_gen3",
        n_joints=7,
        n_factors=7,
        axes=np.array([3, 3, 3, 3, 3, 3, 3], dtype=np.int64),
        trans=trans,
        rots=rots,
        mass=mass,
        com=com,
        inertia=inertia_flat.reshape(7, 3, 3),
        mass_uncertainty=0.03,
        com_uncertainty=0.0,
        inertia_uncertainty=0.03,
        friction=np.zeros(7),
        damping=np.zeros(7),
        armature=armature,
        pos_limits_lb=np.array([-1000.0, -2.41, -1000.0, -2.66, -1000.0, -2.23, -1000.0]),
        pos_limits_ub=np.array([1000.0, 2.41, 1000.0, 2.66, 1000.0, 2.23, 1000.0]),
        speed_limits=np.array([1.3963, 1.3963, 1.3963, 1.3963, 1.2218, 1.2218, 1.2218]),
        torque_limits=np.array([56.7, 56.7, 56.7, 56.7, 29.4, 29.4, 29.4]),
        gravity=9.81,
        link_zono_center=link_zono_center,
        link_zono_gen=link_zono_gen,
        alpha=10.0,
        v_max=1e-2,
        m_max_eig=15.79635774,
        m_min_eig=5.095620491878957,
        kr=5.0,
    )
