"""The rollout kernel (`csrc/rollout.cu`) against ``rollout_plain`` on the card.

Runs only where a CUDA device is present (marker ``cuda``; elsewhere each
test skips).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_rollout_cuda.py -q

``rollout`` on CUDA tensors is one launch of the kernel; ``rollout_plain``
on the same inputs (the same noise tensor, the same iLQR gains) is its
reference.  The kernel contracts products into FMAs and the plain version's
products are library calls, so the bits differ; the tolerances:

- float64: ``q_end`` and ``qd_end`` within 1e-9, every log field within
  1e-8 of the field's largest magnitude;
- float32: ``q`` within 1e-4 rad, ``qd`` within 1e-3 rad/s, ``u`` within
  1e-3 of the field's largest magnitude.

The safety flags of the battery (torque, joint limit, ultimate bound)
computed from the two logs are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.planner.armour import wrap_to_pi
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.robots.planar import planar_arm_spec
from armour_tpu_torch.sim.agent import CONTROLLERS, TrajParams, TrueParams, rollout, rollout_plain
from armour_tpu_torch.sim.harness import _limits
from armour_tpu_torch.sim.rollout_kernel import fused_rollout, instantiation

pytestmark = pytest.mark.cuda

SPEC = kinova_gen3_spec()
CFG = PlannerConfig()
PLANT_DT = SimConfig().plant_dt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_rollout_cuda.py")
    return torch.device("cuda")


def moves(spec, B, steps, seed=0, noise_std=1e-4, dtype=torch.float64, device="cuda"):
    """Random plans from rest-ish states near their start, the true
    parameters within the spec's uncertainty, and a noise tensor."""
    rng = np.random.default_rng(seed)
    nf = spec.n_factors
    q0, qd0 = rng.uniform(-1, 1, (B, nf)), rng.uniform(-0.3, 0.3, (B, nf))
    k_range = CFG.k_range
    traj = TrajParams(q0, qd0, rng.uniform(-0.5, 0.5, (B, nf)), rng.uniform(-1, 1, (B, nf)) * k_range,
                      rng.uniform(0.0, 0.5, B))
    scale = rng.uniform(0.97, 1.03, (B, spec.n_joints))
    sim = dataclasses.replace(SimConfig(), t_move=steps * PLANT_DT)
    noise = None
    if noise_std:
        noise = torch.as_tensor(rng.normal(scale=noise_std, size=(steps, 2, B, nf)),
                                dtype=dtype, device=device)
    return sim, q0, qd0, traj, TrueParams(scale, scale), noise


def flags(spec, log):
    lim = _limits(spec, log.q.dtype, log.q.device)
    tor = (log.u.abs() > lim.tlim + 1e-6).flatten(1).any(-1)
    jl = (((log.q < lim.pos_lb) | (log.q > lim.pos_ub)).flatten(1).any(-1)
          | (log.qd.abs() > lim.spd + 1e-6).flatten(1).any(-1))
    ubv = ((wrap_to_pi(log.q - log.q_ref).abs() > lim.ub_pos + 1e-6).flatten(1).any(-1)
           | ((log.qd - log.qd_ref).abs() > lim.ub_vel + 1e-6).flatten(1).any(-1))
    return torch.stack([tor, jl, ubv])


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check(spec, got, ref, dtype):
    (qk, qdk, lk), (qp, qdp, lp) = got, ref
    assert lk.q.shape == lp.q.shape and qk.shape == qp.shape
    assert torch.equal(lk.t, lp.t)
    for x in (qk, qdk, *lk[1:]):
        assert bool(torch.isfinite(x).all())
    if dtype == torch.float64:
        assert float((qk - qp).abs().max()) <= 1e-9
        assert float((qdk - qdp).abs().max()) <= 1e-9
        for name in ("q", "qd", "q_ref", "qd_ref", "u"):
            assert rel(getattr(lk, name), getattr(lp, name)) <= 1e-8, name
    else:
        for a, b in ((qk, qp), (lk.q, lp.q), (lk.q_ref, lp.q_ref)):
            assert float((a - b).abs().max()) <= 1e-4
        for a, b in ((qdk, qdp), (lk.qd, lp.qd), (lk.qd_ref, lp.qd_ref)):
            assert float((a - b).abs().max()) <= 1e-3
        assert rel(lk.u, lp.u) <= 1e-3
    assert torch.equal(flags(spec, lk), flags(spec, lp))


def run_both(spec, sim, q0, qd0, traj, true, noise, controller, traj_type, dtype, card):
    kw = dict(duration=1.0, noise=noise, controller=controller, traj_type=traj_type, device=card,
              dtype=dtype)
    before = fused_rollout.launches
    got = rollout(spec, sim, q0, qd0, traj, true, **kw)
    torch.cuda.synchronize()
    assert fused_rollout.launches == before + 1
    ref = rollout_plain(spec, sim, q0, qd0, traj, true, **kw)
    torch.cuda.synchronize()
    assert fused_rollout.launches == before + 1
    return got, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("traj_type", ["bernstein", "orig"])
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_kernel_matches_plain(card, controller, traj_type, dtype):
    sim, q0, qd0, traj, true, noise = moves(SPEC, 64, 200, dtype=dtype)
    got, ref = run_both(SPEC, sim, q0, qd0, traj, true, noise, controller, traj_type, dtype, card)
    check(SPEC, got, ref, dtype)


@pytest.mark.parametrize("noise_std", [1e-4, 0.0], ids=["noise", "quiet"])
def test_full_move_at_battery_width(card, noise_std):
    """The battery's move: robust, 1,000 steps, B=128, float32."""
    f32 = torch.float32
    sim, q0, qd0, traj, true, noise = moves(SPEC, 128, 1000, seed=1, noise_std=noise_std, dtype=f32)
    got, ref = run_both(SPEC, sim, q0, qd0, traj, true, noise, "robust", "bernstein", f32, card)
    check(SPEC, got, ref, f32)
    assert got[2].q.shape == (128, 50, 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n_links", [2, 6])
def test_planar_arms(card, n_links, dtype):
    """The planar arms start on their reference (t_offset 0), as a plan
    starts at the current state.  Far from it the 6-link arm's closed loop is
    stiff (mass-matrix eigenvalues 0.008-33, no armature): a start 0-0.5 s
    along the reference amplifies rounding by ~1e11 within 40 steps in the
    plain version itself, so neither version would be a reference there."""
    spec = planar_arm_spec(n_links)
    sim, q0, qd0, traj, true, noise = moves(spec, 32, 200, seed=n_links, dtype=dtype)
    traj = traj._replace(t_offset=np.zeros(32))
    got, ref = run_both(spec, sim, q0, qd0, traj, true, noise, "robust", "bernstein", dtype, card)
    check(spec, got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_more_worlds_than_sms(card, dtype):
    """B = 256: more blocks than the H100's 132 SMs, so blocks share SMs and
    run in more than one wave."""
    sim, q0, qd0, traj, true, noise = moves(SPEC, 256, 200, seed=5, dtype=dtype)
    got, ref = run_both(SPEC, sim, q0, qd0, traj, true, noise, "robust", "bernstein", dtype, card)
    check(SPEC, got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chain_of_the_run_time_instantiation(card, dtype):
    """The planar 4-link arm has no instantiation of its own: the kernel
    with a run-time joint count (started on its reference, as the planar
    arms above)."""
    spec = planar_arm_spec(4)
    assert instantiation(spec) == 0
    sim, q0, qd0, traj, true, noise = moves(spec, 32, 200, seed=4, dtype=dtype)
    traj = traj._replace(t_offset=np.zeros(32))
    got, ref = run_both(spec, sim, q0, qd0, traj, true, noise, "robust", "bernstein", dtype, card)
    check(spec, got, ref, dtype)


def test_generator_noise_equals_given_noise(card):
    """With a generator the kernel path draws the noise as the plain version
    does: the same draws give the same rollout."""
    sim, q0, qd0, traj, true, _ = moves(SPEC, 8, 50)
    sim = dataclasses.replace(sim, measurement_noise_std=1e-3)
    a = rollout(SPEC, sim, q0, qd0, traj, true, generator=torch.Generator(card).manual_seed(3),
                device=card)
    b = rollout_plain(SPEC, sim, q0, qd0, traj, true, generator=torch.Generator(card).manual_seed(3),
                      device=card)
    assert float((a[0] - b[0]).abs().max()) <= 1e-9


def test_repeated_rollouts_hold_no_memory(card):
    sim, q0, qd0, traj, true, noise = moves(SPEC, 128, 100, dtype=torch.float32)

    def once():
        rollout(SPEC, sim, q0, qd0, traj, true, noise=noise, device=card, dtype=torch.float32)
        torch.cuda.synchronize()

    once()
    before = torch.cuda.memory_allocated()
    for _ in range(20):
        once()
    assert torch.cuda.memory_allocated() == before
