"""The port's figure family (`armour_tpu_torch/utils/plotting.py`) and
`python -m armour_tpu_torch.make_figures` on the committed recording
``assets/figures/scenario3_recording.npz`` (89 replans at T=128), CPU.

- Each of the nine figure functions writes a non-empty PNG under Agg; the
  figures that rebuild reachable sets take the recording sliced to its
  iterations 0, 1, 44 and 88, at T=16.
- ``constraint_traces`` at the recording's T=128 on those iterations: the
  rebuilt torque radii equal the recorded ones (rtol 1e-5), and every
  feasible iteration's worst collision value is at most the acceptance
  threshold and its worst torque utilization at most 0.
- ``grasp_wrench`` equals a numpy recomputation of the JAX figure's
  numbers from the JAX package's ``ee_pose`` on the same samples (f64, 1e-9).
- ``make_figures --rec`` draws the whole figure set into a temporary
  directory.

Skips where matplotlib is missing.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402

from armour_tpu.dynamics.utility import ee_pose as jax_ee_pose  # noqa: E402
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec  # noqa: E402
from armour_tpu_torch import make_figures  # noqa: E402
from armour_tpu_torch.config import GraspConfig, PlannerConfig  # noqa: E402
from armour_tpu_torch.jrs.bezier import bezier_ref  # noqa: E402
from armour_tpu_torch.robots.kinova import kinova_gen3_spec  # noqa: E402
from armour_tpu_torch.sim.recording import load_recording  # noqa: E402
from armour_tpu_torch.utils import plotting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECORDING = ROOT / "assets" / "figures" / "scenario3_recording.npz"
ITERATIONS = [0, 1, 44, 88]
PER_ITERATION = ("k", "feasible", "q0p", "qd0p", "qdd0p", "torque_radius")
SPEC = kinova_gen3_spec()
GRASP = GraspConfig(object_mass=0.5, u_s=0.6, surf_rad=0.029)
Q_TRAY = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])
K_TRAY = np.array([0.4, 0.3, -0.2, 0.5, 0.1, -0.3, 0.6])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recs():
    rec = load_recording(RECORDING)
    sub = dict(rec, **{k: rec[k][ITERATIONS] for k in PER_ITERATION})
    return rec, sub


def q_fn(t):
    cfg = PlannerConfig()
    z = np.zeros(7)
    return bezier_ref(Q_TRAY, z, z, cfg.k_range * K_TRAY, t, cfg.duration)[0]


FRS = {"cfg": PlannerConfig(num_time_steps=16), "device": "cpu"}
FIGURES = {
    "plot_tracking": lambda rec, sub, out: plotting.plot_tracking(rec, SPEC, out),
    "plot_torques": lambda rec, sub, out: plotting.plot_torques(rec, SPEC, out),
    "plot_world_topdown": lambda rec, sub, out: plotting.plot_world_topdown(rec, SPEC, out,
                                                                            device="cpu"),
    "plot_frs_topdown": lambda rec, sub, out: plotting.plot_frs_topdown(sub, SPEC, out,
                                                                        iteration=2, **FRS),
    "plot_constraint_traces": lambda rec, sub, out: plotting.plot_constraint_traces(sub, SPEC, out,
                                                                                    **FRS),
    "plot_frs_overlay": lambda rec, sub, out: plotting.plot_frs_overlay(sub, SPEC, out, **FRS),
    "plot_joint_limits": lambda rec, sub, out: plotting.plot_joint_limits(rec, SPEC, out),
    "plot_grasp_wrench": lambda rec, sub, out: plotting.plot_grasp_wrench(SPEC, GRASP, q_fn, out,
                                                                          device="cpu"),
    "plot_frs_animation_frames": lambda rec, sub, out: plotting.plot_frs_animation_frames(
        sub, SPEC, out.with_suffix(""), **FRS),
}


def _is_png(path):
    data = Path(path).read_bytes()
    return len(data) > 1000 and data[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_renders_a_png(name, recs, tmp_path):
    out = tmp_path / f"{name}.png"
    got = FIGURES[name](*recs, out)
    if name == "plot_frs_animation_frames":
        assert [Path(p).name for p in got] == [f"frame_{j:03d}.png" for j in range(len(ITERATIONS))]
        assert all(_is_png(p) for p in got)
    else:
        assert got == out and _is_png(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_constraint_traces_on_recorded_iterations(recs, dtype):
    _, sub = recs
    cfg = PlannerConfig()
    col_max, tor_util, feasible, t_rad = plotting.constraint_traces(sub, SPEC, cfg, dtype, "cpu")
    assert col_max.shape == tor_util.shape == feasible.shape == (len(ITERATIONS),)
    np.testing.assert_allclose(t_rad, sub["torque_radius"], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(feasible, sub["feasible"])
    assert feasible.any()
    assert np.all(col_max[feasible] <= cfg.collision_violation_threshold), col_max
    assert np.all(tor_util[feasible] <= 0.0), tor_util
    assert np.all(np.isfinite(col_max)) and np.all(np.isfinite(tor_util))


def _jax_wrench(ts, qs):
    """The JAX figure's numbers (`armour_tpu/utils/plotting.py::plot_grasp_wrench`)
    from the JAX package's ``ee_pose`` on the samples ``qs``."""
    R, p = jax_ee_pose(jax_kinova_gen3_spec(), jnp.asarray(qs, jnp.float64))
    Rs, ps = np.asarray(R, float), np.asarray(p, float)
    dt = ts[1] - ts[0]
    c_obj = np.asarray(GRASP.object_com, float)
    p_com = ps + np.einsum("sij,j->si", Rs, c_obj)
    a_com = np.gradient(np.gradient(p_com, dt, axis=0), dt, axis=0)
    Wx = np.einsum("sij,skj->sik", np.gradient(Rs, dt, axis=0), Rs)
    w_world = np.stack([Wx[:, 2, 1], Wx[:, 0, 2], Wx[:, 1, 0]], axis=1)
    wd_world = np.gradient(w_world, dt, axis=0)
    F = np.einsum("sji,sj->si", Rs, GRASP.object_mass * (a_com - np.array([0.0, 0.0, -9.81])))
    w = np.einsum("sji,sj->si", Rs, w_world)
    wd = np.einsum("sji,sj->si", Rs, wd_world)
    I_o = np.diag(np.asarray(GRASP.object_inertia_diag, float))
    N = (wd @ I_o.T) + np.cross(w, w @ I_o.T) + np.cross(c_obj[None], F)
    Fz = F[:, 2]
    fric = np.sqrt(F[:, 0] ** 2 + F[:, 1] ** 2) / np.maximum(GRASP.u_s * Fz, 1e-9)
    zmp = np.stack([-N[:, 1], N[:, 0]], axis=1) / np.maximum(Fz[:, None], 1e-9)
    return Fz, fric, zmp


def test_grasp_wrench_matches_jax_ee_pose():
    ts, Fz, fric, zmp = plotting.grasp_wrench(SPEC, GRASP, q_fn, duration=1.0, n_samples=200,
                                              device="cpu")
    np.testing.assert_array_equal(ts, np.linspace(0.0, 1.0, 200))
    ref = _jax_wrench(ts, np.stack([q_fn(t) for t in ts]))
    for got, want in zip((Fz, fric, zmp), ref):
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.all(Fz > 0)


def test_make_figures_draws_a_recording(tmp_path):
    out = make_figures.main(["--rec", str(RECORDING), "--device", "cpu", "--out-dir", str(tmp_path),
                             "--time-steps", "8"])
    names = ["tracking", "torques", "world", "frs", "frs_overlay", "constraints", "joint_limits"]
    assert sorted(out["figures"]) == sorted(f"scenario3_recording_{n}.png" for n in names)
    assert all(_is_png(p) for p in out["figures"].values())
    assert len(out["frames"]) == 12 and all(_is_png(p) for p in out["frames"])
