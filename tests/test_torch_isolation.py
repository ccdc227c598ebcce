"""The port stands alone and runs where it is told to.

- Importing every module of ``armour_tpu_torch`` loads neither ``jax`` nor
  any module of ``armour_tpu`` (checked in a fresh interpreter), and no
  source of the port or ``chip_smoke.py`` imports them.
- An entry point called without ``device=`` on a machine without CUDA
  raises instead of running on the CPU.
- The figure modules import where matplotlib is missing, and their figure
  functions then return None.
- A kernel wrapper given CPU tensors runs the plain version and launches
  nothing; given tensors on any other non-CUDA device it raises.
- ``chip_smoke.py`` exits non-zero and prints no result line without CUDA,
  also from a directory that holds nothing else of the repo.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import armour_tpu_torch
from armour_tpu_torch import convert
from armour_tpu_torch.collision import kernels
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.control.ilqr import tvlqr_gain_schedule
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch import run_hard_scenarios, run_worlds
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.planner import hlp
from armour_tpu_torch.sim import harness, recording, scenarios, world
from armour_tpu_torch.sim.agent import TrajParams, TrueParams, rollout, rollout_direct

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(armour_tpu_torch.__file__).resolve().parent
_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|armour_tpu)\b(?!_torch)|from\s+(jax|armour_tpu)\b(?!_torch))",
                        re.MULTILINE)


def _modules():
    return sorted(
        "armour_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
        for p in PKG.rglob("*.py")
    )


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'armour_tpu' or m.startswith('armour_tpu.'))\n"
        "print(len([m for m in sys.modules if m.startswith('armour_tpu_torch')]), bad)\n"
    )
    # -I: ignore PYTHONPATH and user site, so nothing injected at start-up
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_loaded, bad = out.stdout.split(maxsplit=1)
    assert int(n_loaded) >= len(_modules()) - 1
    assert bad.strip() == "[]", bad


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from armour_tpu.ops import pz") and _FORBIDDEN.search("import jax.numpy")
    assert not _FORBIDDEN.search("from armour_tpu_torch.ops import pz")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PlannerConfig(num_time_steps=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArmourPlanner(kinova_gen3_spec(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        problem_set(cfg, 2)
    bank = (np.zeros((36, 3, 1, 1, 2)), np.zeros((36, 1, 1, 2)), np.zeros((36, 1, 1, 2)), [True])
    pz = (np.zeros(3), np.zeros((2, 3)), np.zeros(3), (0, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.bank_from_numpy(*bank)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.packed_pz_from_numpy(*pz)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.problem_from_numpy(pz, None, bank, 0.0, *np.zeros((4, 7)), np.ones((7, 2)))
    # the plan-and-track entry points and their converters
    spec, sim = kinova_gen3_spec(), SimConfig(t_move=0.01, plant_dt=5e-3)
    z = np.zeros(7)
    traj, true = (z, z, z, z, 0.0), (np.ones(7), np.ones(7))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.traj_params_from_numpy(*traj)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.true_params_from_numpy(*true)
    traj_t = convert.traj_params_from_numpy(*traj, device="cpu")
    true_t = convert.true_params_from_numpy(*true, device="cpu")
    assert isinstance(traj_t, TrajParams) and isinstance(true_t, TrueParams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout(spec, sim, z, z, traj_t, true_t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout_direct(spec, sim, z, z, traj_t, true_t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvlqr_gain_schedule(spec, lambda t: (traj_t.q0, traj_t.q0, traj_t.q0), 0.01)
    q_end, _, log = rollout(spec, sim, z, z, traj_t, true_t, device="cpu")
    assert q_end.device == log.q.device == torch.device("cpu") and log.q.shape == (1, 7)
    assert rollout_direct(spec, sim, z, z, traj_t, true_t, device="cpu")[2].u.shape == (1, 7)
    gains, _ = tvlqr_gain_schedule(spec, lambda t: (traj_t.q0, traj_t.q0, traj_t.q0), 0.01, device="cpu")
    assert gains.shape == (1, 7, 14) and gains.device == torch.device("cpu")
    assert convert.bank_from_numpy(*bank, device="cpu").A.device == torch.device("cpu")
    assert ArmourPlanner(kinova_gen3_spec(), cfg, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_episode_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    """The harness, the recorded episode and the scenario loaders default to
    the card too; the host-only parts (the CSV writer, the numpy planners)
    take no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, cfg, sim = kinova_gen3_spec(), PlannerConfig(num_time_steps=8), SimConfig(max_iterations=1)
    csv = tmp_path / "w.csv"
    scenarios.save_world_csv(csv, np.zeros(7), np.ones(7), [[0.5, 0.5, 0.5]], [[0.1, 0.1, 0.1]])
    calls = [
        lambda: harness.EpisodeRunner(spec, cfg, sim),
        lambda: world.random_world(spec, 2, 4, torch.Generator()),
        lambda: scenarios.load_world_csv(csv, 4),
        lambda: scenarios.hard_scenario(2),
        lambda: scenarios.generate_random_world(spec, np.random.default_rng(0), 1, 4),
        lambda: hlp.optimization_waypoint(spec, np.zeros(7), np.ones(7),
                                          ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1] * 3], 4)),
        lambda: hlp.ee_rrt_star_config_waypoints(
            spec, np.zeros(7), np.ones(7), ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1] * 3], 4)),
        lambda: run_worlds.main(["--max-worlds", "1", "--max-iterations", "1"]),
        lambda: run_hard_scenarios.main(["--scenarios", "2", "--max-iterations", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    w = scenarios.load_world_csv(csv, 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recording.run_recorded_episode(spec, cfg, sim, w)
    runner = harness.EpisodeRunner(spec, cfg, sim, device="cpu")
    assert runner.device == runner.planner.device == torch.device("cpu")
    assert world.random_world(spec, 2, 4, torch.Generator(), device="cpu").start.device.type == "cpu"


def test_si_urdf_and_scale_out_need_a_card_unless_asked_for_cpu(monkeypatch):
    """The self-intersection planner, the URDF calibration and the
    scale-out run on the card unless given ``device="cpu"``, or, for the
    mesh and the sharded step, a gloo process group."""
    import socket
    import types

    import torch.distributed as dist

    from armour_tpu_torch.parallel.mesh import make_planner_mesh, sharded_plan_step
    from armour_tpu_torch.parallel.multihost import init_distributed
    from armour_tpu_torch.planner.rotatotope import rotatotope_planner
    from armour_tpu_torch.robots.planar import planar_arm_spec
    from armour_tpu_torch.robots.urdf import calibrate_mass_eigs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, cfg = planar_arm_spec(2), PlannerConfig(num_time_steps=8)
    calls = [
        lambda: rotatotope_planner(spec, cfg),
        lambda: calibrate_mass_eigs(spec, n_samples=2),
        lambda: make_planner_mesh(1),
        lambda: sharded_plan_step(spec, cfg, types.SimpleNamespace(device_type="cuda")),
        lambda: init_distributed("127.0.0.1:1", 1, 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert rotatotope_planner(spec, cfg, device="cpu").device == torch.device("cpu")
    assert calibrate_mass_eigs(spec, n_samples=2, device="cpu").m_min_eig > 0.0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu") == (1, 0)
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_planner_mesh()
        assert mesh.device_type == "cpu" and mesh.mesh.shape == (1, 1)
        assert sharded_plan_step(spec, cfg, mesh).planner.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_export_offline_figures_and_grasp_example_need_a_card_unless_asked_for_cpu(monkeypatch,
                                                                                   tmp_path):
    """The reference-schema export, the offline-set slicing, the figures
    that compute, `make_figures` and the grasp example run on the card
    unless given ``device="cpu"``; none writes anything before it raises."""
    from armour_tpu_torch import export_reference_schema, grasp_example, make_figures
    from armour_tpu_torch.config import GraspConfig
    from armour_tpu_torch.jrs import offline
    from armour_tpu_torch.sim.recording import load_recording
    from armour_tpu_torch.utils import plotting

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, grasp = kinova_gen3_spec(), GraspConfig()
    rec_path = ROOT / "assets" / "figures" / "scenario3_recording.npz"
    rec = load_recording(rec_path)
    Z = np.zeros((6, 3))
    Z[offline.DIM_KV, 1] = Z[offline.DIM_KA, 2] = 1.0
    jrs = offline.OfflineJRS(0.0, 0.5, 1.0, [Z])
    out = tmp_path / "out"
    calls = [
        lambda: export_reference_schema.export(out, time_steps=8, n_samples=1),
        lambda: export_reference_schema.main(["--outdir", str(out)]),
        lambda: offline.zonotope_slice(Z, offline.DIM_KV, 0.0),
        lambda: offline.sliced_cos_sin_intervals(jrs, 0.0, 0.0, 0.0),
        lambda: plotting.sliced_frs(rec, spec, [0]),
        lambda: plotting.constraint_traces(rec, spec),
        lambda: plotting.grasp_wrench(spec, grasp, lambda t: np.zeros(7)),
        lambda: make_figures.main(["--rec", str(rec_path), "--out-dir", str(out)]),
        lambda: grasp_example.main(["--out", str(out / "w.png")]),
    ]
    if plotting.HAVE_MPL:
        calls += [
            lambda: plotting.plot_world_topdown(rec, spec, out / "w.png"),
            lambda: plotting.plot_frs_topdown(rec, spec, out / "f.png"),
            lambda: plotting.plot_constraint_traces(rec, spec, out / "c.png"),
            lambda: plotting.plot_frs_overlay(rec, spec, out / "o.png"),
            lambda: plotting.plot_frs_animation_frames(rec, spec, out / "frames"),
            lambda: plotting.plot_grasp_wrench(spec, grasp, lambda t: np.zeros(7), out / "g.png"),
        ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not out.exists()
    lo, hi, _, _, g_ka = offline.sliced_cos_sin_intervals(jrs, 0.0, 0.0, 0.0, device="cpu")
    assert lo.device == torch.device("cpu") and g_ka == 1.0


def test_figure_modules_import_without_matplotlib():
    """With matplotlib blocked, `utils.plotting`, `make_figures` and the
    grasp example import (as on a card machine without it), and every
    figure function returns None instead of a figure."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "sys.modules['matplotlib'] = None\n"
        "from armour_tpu_torch.utils import plotting\n"
        "from armour_tpu_torch import grasp_example, make_figures\n"
        "assert not plotting.HAVE_MPL\n"
        "names = [n for n in dir(plotting) if n.startswith('plot_')]\n"
        "outs = {n: getattr(plotting, n)(*(['unused'] * (4 if n == 'plot_grasp_wrench' else 3)))\n"
        "        for n in names}\n"
        "print(len(names), sorted(set(map(repr, outs.values()))))\n"
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["9", "['None']"]


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _bank(device, rng):
    B, S, n, P, L, O, T = 2, 3, 7, 36, 2, 3, 5
    A = torch.as_tensor(rng.normal(size=(B, P, 3, L, O, T)), dtype=torch.float32).to(torch.bfloat16)
    dpos, dneg = (torch.as_tensor(rng.normal(size=(B, P, L, O, T)), dtype=torch.float32) for _ in "ab")
    c = torch.as_tensor(rng.normal(size=(B, S, 3, L, T)), dtype=torch.float32)
    dc = torch.as_tensor(rng.normal(size=(B, S, n, 3, L, T)), dtype=torch.float32)
    return tuple(t.to(device) for t in (A, dpos, dneg, c, dc))


def test_kernel_wrappers_take_the_plain_version_on_cpu_only(rng):
    A, dpos, dneg, c, dc = _bank("cpu", rng)
    kernels.reset_launch_counts()
    cases = [
        (kernels.fused_collision_value_jac_multi, (A, dpos, dneg, c, dc)),
        (kernels.fused_collision_values_multi, (A, dpos, dneg, c)),
        (kernels.fused_collision_value_jac, (A, dpos, dneg, c[:, 0], dc[:, 0])),
    ]
    for kern, args in cases:
        got, ref = kern(*args), kernels.PLAIN[kern](*args)
        for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}
    # not the CPU and not CUDA: no silent plain version
    meta = _bank("meta", rng)
    with pytest.raises(ValueError, match="all must be on the CPU or all on one CUDA device"):
        kernels.fused_collision_value_jac_multi(*meta)
    with pytest.raises(ValueError):
        kernels.fused_collision_values_multi(A, dpos, dneg, c.to("meta"))
    with pytest.raises(ValueError, match=r"dpos must be"):
        kernels.fused_collision_values_multi(A, dpos[:, :-1], dneg, c)
    with pytest.raises(TypeError):
        kernels.fused_collision_values_multi(A.double(), dpos, dneg, c)
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}


def test_library_is_built_into_an_ignored_directory():
    path = kernels.library_path()
    assert path.parent == PKG / "build" and path.suffix == ".so"
    assert "armour_tpu_torch/build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    src = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd, script = ROOT, src
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300, cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
