"""Frozen copy of ``armour_tpu_torch/config.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Global planner / simulator configuration.

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


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation-harness configuration.

    Reference values: `kinova_run_100_worlds.m:20-100`,
    `simulator_armtd.m:142-330`, `uarmtd_agent.m:19,292-311`.
    """

    # per-iteration executed horizon (t_move == t_plan)
    t_move: float = 0.5

    # plant integration step for the fixed-step RK4 rollout (the reference
    # uses ode15s with tol 1e-10, uarmtd_agent.m:301; RK4 at 2 kHz reproduces
    # tracking error well below the ultimate bound)
    plant_dt: float = 5e-4

    # post-hoc safety check resolution (uarmtd_agent.m:19)
    check_dt: float = 0.01

    # episode control; the reference allows up to 500 planning iterations
    # per episode (kinova_run_100_worlds.m:63 max_sim_iter)
    max_iterations: int = 150
    stop_threshold: int = 4
    # Stop-rescue (stepped episode loop only): on hitting stop_threshold
    # consecutive infeasible plans the arm is already parked by the
    # guaranteed braking maneuver, so instead of ending the episode the
    # episode loop can force a fresh guidance escalation (both path families
    # dropped, retry counters reset) and reset the fail counter, up to
    # this many times.  Safety is unaffected -- a parked arm re-trying
    # guidance is exactly as safe as a stopped episode; it trades host
    # wall time for goal-reach rate.  The DEFAULT is 0 = the reference
    # protocol (`simulator_armtd.m:187-198` aborts after stop_threshold
    # consecutive stops), so battery numbers are comparable to the
    # reference and across rounds; opt in per run (e.g.
    # run_100_worlds.py --stop-rescue N), and every battery artifact
    # records the setting in its protocol block.
    stop_rescue_attempts: int = 0

    # goal tolerance per joint, radians (kinova_run_100_worlds.m:24)
    goal_radius: float = math.pi / 30

    # inertial uncertainty of the plant's true params
    # (kinova_run_100_worlds.m:40 'uncertain_mass_range')
    uncertain_mass_range: tuple[float, float] = (0.97, 1.03)

    # measurement noise (uarmtd_agent.m:314-325); 0 disables
    measurement_noise_std: float = 0.0

    # ---- HLP escalation ladder (battery episode loops, sim/harness.py) ----
    # The reference swaps HLP classes by hand per scene
    # (`kinova_run_hard_scenarios.m:150`); the episode loops instead escalate
    # per world when goal progress stalls.  Stall = consecutive replans
    # without the best-so-far goal distance improving by progress_epsilon.
    #
    # stall >= stall_clearance: swap the straight-line waypoint for sampled
    # clearance waypoints (in-graph, cheap).
    stall_clearance: int = 3
    # stall >= stall_guidance: plan a host-side guidance path (config-space
    # RRT-connect/RRT*, alternating with the workspace EE-RRT* family on
    # retries); a path no longer making progress (stall >= stall_path_stale)
    # is re-planned from the CURRENT configuration.
    stall_guidance: int = 8
    stall_path_stale: int = 25
    # stall >= stall_ee_replan: an ee_rrt_star-mode world re-plans its
    # workspace path from the current end effector with a fresh seed.
    stall_ee_replan: int = 20
    # retry caps per world (guidance attempts are host wall-time bounded)
    max_guidance_retries: int = 8
    max_ee_retries: int = 10
    # a guidance waypoint within this config-space distance of the current
    # q is considered consumed and the follower advances to the next one
    waypoint_advance_radius: float = 0.35
    # minimum goal-distance improvement per replan that counts as progress
    progress_epsilon: float = 2e-3
    # obstacle inflation (meters, per axis on the AABB radius) used ONLY by
    # the host-side guidance planners, so guidance corridors leave margin
    # for the FRS buffering (`uarmtd_planner.m` buffer_dist role)
    guidance_inflation: float = 0.03


@dataclasses.dataclass(frozen=True)
class GraspConfig:
    """Grasp / waiter-task contact constraints (cf. `grasp_simple.m:23-30`:
    u_s = 0.6, surf_rad = 0.029).

    The reference exposes a `grasp_constraints_flag` but its MATLAB
    constraint block is unimplemented (`uarmtd_planner.m:543-547` is an
    empty TODO); this framework implements the standard contact trio on the
    object carried by the end-effector link:

      separation:  -F_z <= 0                     (object stays in contact)
      slipping:    F_x^2 + F_y^2 <= u_s^2 F_z^2  (friction cone)
      tipping:     N_x^2 + N_y^2 <= r^2 F_z^2    (ZMP within contact patch)

    built as polynomial zonotopes over k from the end-effector acceleration
    reachable sets.
    """

    object_mass: float = 0.5
    object_com: tuple[float, float, float] = (0.0, 0.0, 0.03)
    object_inertia_diag: tuple[float, float, float] = (5e-4, 5e-4, 5e-4)
    u_s: float = 0.6
    surf_rad: float = 0.029
