"""Global planner / simulator configuration.

Single typed config replacing the reference's three uncoordinated layers
(compile-time macros in `kinova_planner_realtime/Parameters.h:10-59`, MATLAB
name-value args, and script-level parameter blocks) — see SURVEY.md §5
"Config / flag system".

All values default to the reference's settings so plans are comparable.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """ARMOUR planner configuration.

    Reference values: `kinova_planner_realtime/Parameters.h:10-59`,
    `armour_main.cu:81` (t_plan), `NLPclass.cu:46-54`.
    """

    # trajectory duration in seconds; first half executed, second half is the
    # guaranteed braking segment (Parameters.h:14, Trajectory.h:10-13)
    duration: float = 1.0

    # plan/move horizon: optimize q(t_plan) against the waypoint
    # (armour_main.cu:81)
    t_plan: float = 0.5

    # number of PZ time subintervals over [0, duration]; must be even for the
    # qd_des bounding trick (Parameters.h:17, Trajectory.cu:146-158)
    num_time_steps: int = 128

    # trajectory-parameter range per joint, radians (Parameters.h:21)
    k_range: float = math.pi / 48

    # NOTE: the degree cap for the static k-monomial basis is a COMPILE-TIME
    # constant, `armour_tpu_torch.ops.pz.DEFAULT_MAX_DEGREE` (= 2), mirroring the
    # reference's compile-time Parameters.h.  The reference instead sweeps
    # monomials with coefficient norm < 5e-4 (Parameters.h:10,
    # PZsparse.cu:284-350); with k_range = pi/48 every degree-3 k-monomial
    # coefficient is O(3e-4) so degree<=2 is the static-budget equivalent.

    # obstacle capacity (Parameters.h:26-29)
    max_obstacles: int = 40
    obstacle_generators: int = 3

    # constraint acceptance thresholds (Parameters.h:38-41)
    collision_violation_threshold: float = 1e-4
    torque_violation_threshold: float = 1e-2

    # joint position/velocity extremum acceptance threshold.  The limits
    # used in the NLP are already tightened by the tracking-error padding
    # qe/qde (~2.6e-3 rad), so accepting an extremum 1e-5 past the padded
    # limit is physically negligible and absorbs f32 closed-form roundoff
    # (a 1e-9 threshold spuriously rejected boundary-active plans).
    state_violation_threshold: float = 1e-5

    # cost scale (Parameters.h:44)
    cost_scale: float = 10.0

    # toggle torque constraints (Parameters.h:47)
    input_constraints: bool = True

    # extra radius padding applied to constraint sets to absorb f32
    # accumulation error (reference uses f64 + Boost directed rounding on the
    # C++ side; MATLAB/CORA side is plain f64).  Units: meters for collision,
    # N*m for torque.  Set to 0.0 when running in f64.
    collision_numeric_slack: float = 1e-5
    torque_numeric_slack: float = 1e-3

    # store the hyperplane-bank normals in bfloat16 (f32 runs only; f64
    # runs ignore this).  Sound by construction — the f32 offsets are the
    # support values FOR the quantized normals (see
    # collision/zonotope.py::buffer_obstacles); only marginally more
    # conservative.  Cuts the NLP's dominant HBM term by ~30% at the
    # 40-obstacle worst case (roofline: PERFORMANCE.md).
    collision_bank_bf16: bool = True

    # sound whole-FRS obstacle culling (batched path only): an obstacle
    # provably separated from the interval hull of every link center set
    # over ALL k in [-1,1]^n (plus link-shape radii and numeric slack) is
    # dropped from the hyperplane bank before the solve — the feasible
    # set, iterates, and verification verdicts are unchanged (its
    # constraint block is satisfied for every candidate trajectory), but
    # the bank the solver streams per Gauss-Newton iteration shrinks to
    # the obstacles actually within reach.  TPU analog of the reference's
    # CUDA grid scaling with the live obstacle count
    # (`CollisionChecking.cu:107-125`).  Env override: ARMOUR_CULL=0.
    obstacle_culling: bool = True

    # smooth-collision mode (the role of the reference's optional
    # Borrelli-dual formulation, `uarmtd_planner.m:723-743,810-856`): when
    # > 0, the NLP's collision block uses the everywhere-differentiable,
    # provably-conservative log-sum-exp bound with this temperature
    # (meters; conservatism gap = tau * log(72)).  0 keeps the hard max +
    # argmax-select Jacobian (the default, also the Pallas fast path).
    smooth_collision_tau: float = 0.0

    # batched NLP solver settings (replaces Ipopt: armour_main.cu:254-290)
    nlp_tolerance: float = 1e-4
    nlp_outer_iters: int = 8
    nlp_inner_iters: int = 8
    nlp_num_starts: int = 4

    @property
    def dt(self) -> float:
        return self.duration / self.num_time_steps
