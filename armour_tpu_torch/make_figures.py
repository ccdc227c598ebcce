"""Recorded-episode figure factory (the `post_sim_plotting.m` role)
through the port.

    python -m armour_tpu_torch.make_figures --rec episode.npz [--out-dir DIR]
    python -m armour_tpu_torch.make_figures --device cpu --rec episode.npz --time-steps 16
    python -m armour_tpu_torch.make_figures [--scenario 3] [--max-iterations 150]

Counterpart of `scripts/make_figures.py`.  Without ``--rec`` it records one
episode (a hard scenario by default) through ``run_recorded_episode`` and
saves the .npz checkpoint; with ``--rec`` it only draws.  Then it emits
the full figure set: tracking error, torques vs planned radii, top-down
world view, FRS snapshot, per-iteration FRS overlay, per-iteration
constraint traces, joint limits, and the FRS animation frames.  Figures
are drawn only where matplotlib is installed.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.recording import load_recording, run_recorded_episode
from armour_tpu_torch.sim.scenarios import hard_scenario, load_world_csv
from armour_tpu_torch.utils.plotting import (
    plot_constraint_traces,
    plot_frs_animation_frames,
    plot_frs_overlay,
    plot_frs_topdown,
    plot_joint_limits,
    plot_torques,
    plot_tracking,
    plot_world_topdown,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", type=int, default=3,
                    help="hard scenario index 1-7 (get_kinova_scenario_info.m)")
    ap.add_argument("--world-csv", default="",
                    help="record a CSV world instead of a hard scenario")
    ap.add_argument("--max-iterations", type=int, default=150)
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "armour_tpu_torch_figures"))
    ap.add_argument("--rec", default="", help="reuse an existing .npz recording")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = kinova_gen3_spec()
    pcfg = PlannerConfig(num_time_steps=args.time_steps)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.rec:
        rec = load_recording(args.rec)
        tag = os.path.splitext(os.path.basename(args.rec))[0]
    else:
        scfg = SimConfig(max_iterations=args.max_iterations)
        if args.world_csv:
            world = load_world_csv(args.world_csv, pcfg.max_obstacles, dtype, device=device)
            tag = os.path.splitext(os.path.basename(args.world_csv))[0]
        else:
            world = hard_scenario(args.scenario, pcfg.max_obstacles, dtype, device=device)
            tag = f"scenario{args.scenario}"
        recording = run_recorded_episode(spec, pcfg, scfg, world, dtype=dtype, verbose=True,
                                         device=device)
        print(f"episode: goal={recording.goal_reached} "
              f"collision={recording.collision} stopped={recording.stopped} "
              f"iters={len(recording.records)}")
        npz = os.path.join(args.out_dir, f"{tag}_recording.npz")
        recording.save(npz)
        print(f"saved {npz}")
        rec = load_recording(npz)

    dev_kw = {"device": device}
    frs_kw = {"cfg": pcfg, "dtype": dtype, "device": device}
    figs = [
        (plot_tracking, f"{tag}_tracking.png", {}),
        (plot_torques, f"{tag}_torques.png", {}),
        (plot_world_topdown, f"{tag}_world.png", dev_kw),
        (plot_frs_topdown, f"{tag}_frs.png", frs_kw),
        (plot_frs_overlay, f"{tag}_frs_overlay.png", frs_kw),
        (plot_constraint_traces, f"{tag}_constraints.png", frs_kw),
        (plot_joint_limits, f"{tag}_joint_limits.png", {}),
    ]
    outs = {}
    for fn, name, kw in figs:
        outs[name] = fn(rec, spec, os.path.join(args.out_dir, name), **kw)
        print(f"figure: {outs[name]}")
    frames = plot_frs_animation_frames(rec, spec, os.path.join(args.out_dir, f"{tag}_frs_frames"),
                                       **frs_kw)
    if frames:
        print(f"animation frames: {len(frames)} in {tag}_frs_frames/")
    return {"figures": outs, "frames": frames}


if __name__ == "__main__":
    main()
