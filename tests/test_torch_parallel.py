"""The port's scale-out on ``torch.distributed`` (gloo, CPU, float64).

Ranks are processes started by ``torch.multiprocessing`` (spawn) on a free
local port, each running `tests/torch_parallel_worker.py`; a run that does
not end within ``JOIN_S`` fails instead of hanging the suite.

- dp=2 x cp=2 over 4 ranks and dp=1 x cp=2 over 2: `sharded_plan_step` on
  the inputs of `tests/test_parallel.py` (T=8, 4 obstacle slots, S=2, 4x4
  ALM iterations; here with a second world pose and a second obstacle in
  slot 2, so that both cp shards hold a live obstacle and the dp order
  shows) equals the port's unsharded ``plan_batch`` and the JAX package's
  ``plan_batch`` on the same starts: ``feasible`` equal, k within 2e-6 (the
  JAX scale-out test's own tolerance).
- Every rank draws its starts from its own generator, and still every rank
  of a cp group plans from the starts of the group's first rank.
- In smooth collision mode (tau = 1e-3) the same meshes gather the smooth
  bound on every constraint pass and the verification pool's values once,
  and equal the port's unsharded smooth ``plan_batch`` on the same starts.
- The step is kept per shape (the planner's full-width plan program): its
  plans equal ``step(eager=True)``'s to the bit in every field, default and
  smooth, with as many cp gathers; a later call with other poses and
  starts replays the same program and equals its own eager call.
- `python -m armour_tpu_torch.run_sharded` (the several-card run) holds
  dp=1 x cp=2 against ``plan_batch`` on the CPU at a tiny size.
- `scatter_worlds` / `gather_summary` round-trip the worlds in dp order;
  `init_distributed` without a cluster is a single process; a cp group
  that would span nodes is refused.
"""

import json
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.parallel.multihost import global_planner_mesh, init_distributed
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.utils import PhaseTimer

CFG_KW = dict(num_time_steps=8, max_obstacles=4, nlp_num_starts=2,
              nlp_outer_iters=4, nlp_inner_iters=4)
B = 2
JOIN_S = 300
SMOOTH_TAU = 1e-3
MESHES = {"dp2xcp2": (4, 2), "dp1xcp2": (2, 2)}   # world size, cp size


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    cfg = PlannerConfig(**CFG_KW)
    q0 = np.tile([0.65, -0.09, -0.48, -1.23, -1.57, -1.07, 0.0], (B, 1))
    q0[1] += 0.1
    z = np.zeros((B, 4, 4, 3))
    z[:, 0, 0] = [0.4, 0.2, 0.4]
    z[:, 2, 0] = [0.3, -0.3, 0.6]
    z[:, [0, 2], 1:] = np.eye(3) * 0.05
    m = np.zeros((B, 4), bool)
    m[:, [0, 2]] = True
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    n_rand = max(CFG_KW["nlp_num_starts"] - 2, 1)
    k_rand = np.stack([np.asarray(jax.random.uniform(k, (n_rand, 7), jnp.float64, -0.6, 0.6))
                       for k in keys])
    zero = np.zeros((B, 7))
    rng = np.random.default_rng(1)
    return dict(q0=q0, qd0=zero, qdd0=zero, q_des=q0 + 0.4 * cfg.k_range, zonos=z, masks=m,
                k_rand=k_rand, q0_2=q0 + rng.uniform(-0.05, 0.05, q0.shape),
                k_rand_2=rng.uniform(-0.6, 0.6, k_rand.shape)), keys


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, cp_size, out_dir):
    import torch_parallel_worker

    ctx = mp.start_processes(torch_parallel_worker.run,
                             args=(world, _free_port(), cp_size, str(out_dir), CFG_KW, SMOOTH_TAU),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish within {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, inputs, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(request.param)
    np.savez(out_dir / "inputs.npz", **inputs[0])
    world, cp_size = MESHES[request.param]
    return request.param, _spawn(world, cp_size, out_dir)


@pytest.fixture(scope="module")
def port_planner():
    return ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**CFG_KW), device="cpu")


def _plan(planner, inp, k_rand):
    return planner.plan_batch(*(inp[k] for k in ("q0", "qd0", "qdd0", "q_des", "zonos", "masks")),
                              k_rand=k_rand)


@pytest.fixture(scope="module")
def references(inputs, port_planner):
    inp, keys = inputs
    jp = JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**CFG_KW), jnp.float64)
    res_j = jp.plan_batch(*(jnp.asarray(inp[k]) for k in ("q0", "qd0", "qdd0", "q_des", "zonos", "masks")),
                          keys)
    return res_j, _plan(port_planner, inp, inp["k_rand"])


def _assert_same_plans(feasible, k, ref, atol):
    np.testing.assert_array_equal(feasible, np.asarray(ref.feasible))
    np.testing.assert_allclose(k, np.asarray(ref.k), rtol=0, atol=atol)


def test_sharded_plan_matches_unsharded_and_jax(ranks, references, inputs):
    name, outs = ranks
    res_j, res_u = references
    world, cp = MESHES[name]
    assert bool(res_u.feasible.all())
    for r, out in enumerate(outs):
        assert out["shape"].tolist() == [world // cp, cp]
        assert out["obstacle_shard"].tolist() == [B // (world // cp), 4 // cp]
        # g and its Jacobian, once per constraint pass
        assert int(out["gathers"]) == 2 * (CFG_KW["nlp_outer_iters"] * CFG_KW["nlp_inner_iters"] + 1)
        _assert_same_plans(out["given_feasible"], out["given_k"], res_u, 2e-6)
        _assert_same_plans(out["given_feasible"], out["given_k"], res_j, 2e-6)
        np.testing.assert_allclose(out["given_max_violation"], res_u.max_violation.numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(out["q0_roundtrip"], inputs[0]["q0"])


def test_cp_ranks_plan_from_the_first_ranks_starts(ranks, inputs, port_planner):
    """Each rank's generator is seeded ``100 + rank``.  Every rank of a cp
    group solves from the starts of the group's first rank (not its own
    draws, which differ), and the plans equal the unsharded plan from those
    starts."""
    name, outs = ranks
    world, cp = MESHES[name]
    dp, b = world // cp, B // (world // cp)

    def starts(rank):
        return port_planner.random_starts(b, torch.Generator().manual_seed(100 + rank))

    assert not torch.equal(starts(0), starts(1))
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["own_starts"], starts(r - r % cp).numpy())
    first = _plan(port_planner, inputs[0], torch.cat([starts(d * cp) for d in range(dp)]))
    for out in outs:
        _assert_same_plans(out["own_feasible"], out["own_k"], first, 2e-6)
        np.testing.assert_array_equal(out["own_k"], outs[0]["own_k"])


def test_sharded_smooth_plan_matches_unsharded(ranks, inputs):
    """Smooth collision mode through the cp gathers: the smooth bound and
    its Jacobian on every constraint pass, the explicit verification pool's
    values once; the plans equal the unsharded smooth plan."""
    _, outs = ranks
    smooth = ArmourPlanner(kinova_gen3_spec(),
                           PlannerConfig(**CFG_KW, smooth_collision_tau=SMOOTH_TAU), device="cpu")
    ref = _plan(smooth, inputs[0], inputs[0]["k_rand"])
    assert bool(ref.feasible.all())
    passes = CFG_KW["nlp_outer_iters"] * CFG_KW["nlp_inner_iters"] + 1
    for out in outs:
        assert int(out["smooth_gathers"]) == 2 * passes + 1
        _assert_same_plans(out["smooth_feasible"], out["smooth_k"], ref, 2e-6)
        np.testing.assert_allclose(out["smooth_max_violation"], ref.max_violation.numpy(),
                                   rtol=0, atol=1e-9)


def _bits(a):
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("case", ["given", "second", "smooth"])
def test_kept_step_equals_eager_step(ranks, case):
    """Every rank's plans of the kept step equal those of ``step(eager=True)``
    on the same inputs to the bit, in every field, with as many cp gathers
    (g and its Jacobian per constraint pass; smooth mode adds the pool's)."""
    _, outs = ranks
    passes = CFG_KW["nlp_outer_iters"] * CFG_KW["nlp_inner_iters"] + 1
    for out in outs:
        for f in ("k", "feasible", "cost", "max_violation", "torque_radius"):
            np.testing.assert_array_equal(_bits(out[f"{case}_kept_{f}"]),
                                          _bits(out[f"{case}_eager_{f}"]), err_msg=f"{case} {f}")
        assert int(out[f"{case}_kept_gathers"]) == int(out[f"{case}_eager_gathers"]) == (
            2 * passes + (case == "smooth"))


def test_kept_step_replays_one_program_on_new_inputs(ranks):
    """The given, the generator's and the second call are one program
    (one miss, two hits, no eviction), and the second call, with other
    poses and starts, is not the first call's plan read back."""
    _, outs = ranks
    for out in outs:
        assert out["programs"].tolist() == [1, 2, 0, 1]      # misses, hits, evictions, entries
        assert not np.array_equal(out["second_kept_k"], out["given_kept_k"], equal_nan=True)
        assert not np.array_equal(out["second_kept_cost"], out["given_kept_cost"])


def test_run_sharded_script_on_gloo(capsys):
    from armour_tpu_torch import run_sharded

    rc = run_sharded.main(["--ranks", "2", "--cp", "2", "--batch", "2", "--time-steps", "8",
                           "--dtype", "float64", "--device", "cpu", "--timeout", str(JOIN_S)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    assert out["mesh"] == {"dp": 1, "cp": 2} and out["slots_per_rank"] == 4
    assert out["feasible_equal"] and out["max_abs_k_diff"] <= 2e-6
    assert out["cp_gathers_per_step"] == 2 * 65    # the values and the Jacobian, every pass


def test_init_distributed_without_a_cluster_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == (1, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        init_distributed("127.0.0.1:1", 2)


def test_cp_group_may_not_span_nodes(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="span nodes"):
        global_planner_mesh(cp_size=2, device="cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "6")
    with pytest.raises(ValueError, match="span nodes"):
        global_planner_mesh(cp_size=4, device="cpu")


def test_phase_timer():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("solve"):
            time.sleep(0.002)
    with pytest.raises(RuntimeError):
        with timer.phase("build"):
            raise RuntimeError("a phase that raises is still timed")
    assert timer.counts == {"solve": 3, "build": 1}
    assert timer.totals["solve"] >= 0.006 and timer.totals["build"] >= 0.0
    lines = timer.report().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["build", "solve"]
    assert lines[1].endswith("x3")
