"""The CUDA collision kernels against their plain PyTorch versions, on the card.

Runs only where a CUDA device is present (marker ``cuda``; elsewhere each
test skips).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Random banks cover every (A, offsets) type pair the kernels take, the
obstacle buckets 8, 16 and 40, the shards of a constraint-parallel rank
(O = 4 and 20), the planar arms (L = n = 2 and 6), time axes of 1, 5, 32, 127 and others that
are no multiple of the tile, slabs whose rows are not 16-byte aligned (the
kernel's direct path instead of its staged one), pair counts other than 36
(fewer than the ring has stages, and no multiple of it), 1 to 33 starts
(every instantiated bound, and the start groups beyond 4 with the Jacobian
and 16 without, the latter side by side in one block: still one launch per
call, a start's bits the same at any S), and banks with NaN offsets (a pair with a NaN never
wins; a slot with none usable keeps g = 1e30, J = 0).  Each shape whose
rows allow it also goes through both launch paths, forced (the streaming
one and the small-grid one of the batch-1 and grasp banks), which must give
the same bits; the two shapes whose rows are not 16-byte aligned report the
streaming path when the small-grid one is forced; a tie across the
small-grid path's pair groups keeps the first pair; a fresh process makes
its first small-grid launch inside a CUDA graph capture; and a fresh
process captures a batch-1 plan program while the small-grid path is the
one chosen.  Tolerances: float32 offsets atol 2e-6 and
float64 atol 1e-12 on values of order 1 (the kernel fuses multiply-adds
where the plain version rounds each product); Jacobians on the slots
whose winning piece is unique by more than 1e-5 (elsewhere either piece
is a valid subgradient).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from armour_tpu_torch.collision import kernels

pytestmark = pytest.mark.cuda

TYPES = [(torch.bfloat16, torch.float32), (torch.float32, torch.float32),
         (torch.bfloat16, torch.float64), (torch.float32, torch.float64),
         (torch.float64, torch.float64)]
SHAPES = [  # B, S, n, L, O, T and, where it is not 36, P
    (3, 4, 7, 7, 40, 128),
    (2, 1, 7, 7, 8, 37),
    (1, 8, 3, 2, 3, 200),
    (2, 5, 7, 7, 16, 129),
    (2, 10, 7, 7, 8, 128),
    (1, 16, 7, 7, 16, 37),
    (1, 20, 7, 3, 8, 130),
    (2, 9, 7, 7, 8, 32),         # start groups of 4 + 4 + 1 with the Jacobian
    (1, 12, 7, 7, 8, 127),       # 4 + 4 + 4; an odd T on aligned rows
    (1, 17, 7, 7, 8, 128),       # values only: start groups of 10 + 7
    (2, 26, 7, 7, 8, 128),       # a 12-start plan's pool: values 13 + 13 in one block, Jacobian 7 x 4
    (2, 33, 7, 7, 8, 128),       # values 11 + 11 + 11 in one block (f64: two blocks of 2 groups)
    (2, 4, 7, 7, 3, 5),          # O*T = 15: rows not aligned, the direct path
    (2, 4, 7, 7, 8, 1),
    (1, 4, 7, 7, 16, 64),
    (2, 4, 7, 7, 8, 128, 5),     # P = 5: the generic pair loop
    (1, 10, 2, 5, 3, 33, 3),     # P = 3, fewer pairs than stages; direct path
    (2, 4, 2, 2, 8, 128),        # the planar 2-link arm: L = n = 2
    (2, 4, 6, 6, 8, 128),        # the planar 6-link arm: L = n = 6
    (2, 4, 7, 7, 4, 128),        # a cp = 2 shard of 8 obstacle slots: O = 4
    (1, 4, 7, 7, 20, 128),       # a cp = 2 shard of 40 slots: O = 20, staged (20 % 4 = 0)
    (1, 4, 7, 7, 8, 128),        # the batch-1 plan's bank: the small-grid path
    (1, 4, 7, 7, 8, 64),         # the grasp example's bank
    (1, 4, 7, 7, 16, 128),       # the batch-1 bank at bucket 16
]
# rows of L*O*T elements not 16-byte aligned in any type: the small-grid path
# cannot stage them, and a launch that forces it streams
STREAM_ONLY = [(2, 4, 7, 7, 3, 5), (1, 10, 2, 5, 3, 33, 3)]
SMALL_TOO = [s for s in SHAPES if s not in STREAM_ONLY]
ATOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py")
    return torch.device("cuda")


def _bank(shape, a_dtype, o_dtype, seed, device):
    B, S, n, L, O, T = shape[:6]
    P = shape[6] if len(shape) > 6 else 36
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, P, 3, L, O, T))
    A /= np.linalg.norm(A, axis=2, keepdims=True)
    arrays = (A, rng.normal(size=(B, P, L, O, T)), rng.normal(size=(B, P, L, O, T)),
              rng.normal(size=(B, S, 3, L, T)), rng.normal(size=(B, S, n, 3, L, T)))
    dtypes = (a_dtype, o_dtype, o_dtype, o_dtype, o_dtype)
    return tuple(torch.as_tensor(x, dtype=torch.float64).to(dt).to(device)
                 for x, dt in zip(arrays, dtypes))


def _poison(dpos, dneg, seed):
    """NaN into about 1 % of the offsets, and into every pair of one slot."""
    gen = torch.Generator(device=dpos.device).manual_seed(seed)
    hit = torch.rand(dpos.shape, generator=gen, device=dpos.device) < 0.01
    dpos.masked_fill_(hit, torch.nan)
    dneg[0, :, 0, 0, 0] = torch.nan


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("types", TYPES, ids=lambda t: f"{str(t[0])[6:]}-{str(t[1])[6:]}")
def test_kernels_match_plain(card, shape, types, nan):
    A, dpos, dneg, c, dc = _bank(shape, *types, seed=sum(shape), device=card)
    if nan:
        _poison(dpos, dneg, seed=sum(shape))
    atol = ATOL[types[1]]
    S = shape[1]
    uniq = kernels.tie_mask(A, dpos, dneg, c, tol=1e-5)
    kernels.reset_launch_counts()

    g, J = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    gp, Jp = kernels.value_jac_multi_plain(A, dpos, dneg, c, dc)
    torch.cuda.synchronize()
    assert (g - gp).abs().max().item() <= atol
    assert ((J - Jp).abs() * uniq[:, :, None]).max().item() <= atol
    assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(J).all())

    gv = kernels.fused_collision_values_multi(A, dpos, dneg, c)
    assert (gv - kernels.values_multi_plain(A, dpos, dneg, c)).abs().max().item() <= atol
    assert torch.equal(gv, g)

    c1, dc1 = c[:, 0].contiguous(), dc[:, 0].contiguous()
    g1, J1 = kernels.fused_collision_value_jac(A, dpos, dneg, c1, dc1)
    g1p, J1p = kernels.value_jac_plain(A, dpos, dneg, c1, dc1)
    torch.cuda.synchronize()
    assert (g1 - g1p).abs().max().item() <= atol
    assert ((J1 - J1p).abs() * uniq[:, 0, None]).max().item() <= atol
    assert torch.equal(g1, g[:, 0]) and torch.equal(J1, J[:, 0])
    # the last start's lane (in the last start group) equals its own single-start launch
    g_last, J_last = kernels.fused_collision_value_jac(A, dpos, dneg, c[:, S - 1].contiguous(),
                                                       dc[:, S - 1].contiguous())
    assert torch.equal(g_last, g[:, S - 1]) and torch.equal(J_last, J[:, S - 1])
    assert kernels.launch_counts() == {
        "fused_collision_value_jac_multi": 1,
        "fused_collision_values_multi": 1,
        "fused_collision_value_jac": 2}


@pytest.mark.parametrize("types", [(torch.bfloat16, torch.float32), (torch.float64, torch.float64)],
                         ids=lambda t: f"{str(t[0])[6:]}-{str(t[1])[6:]}")
def test_twelve_starts_equal_launches_of_eight_and_four(card, types):
    """One launch at S=12 (three start groups of 4) gives the same bits as
    launches of the same kernel at the first 8 starts and at the last 4, and
    agrees with the plain version (float64 offsets with a float64 bank too)."""
    A, dpos, dneg, c, dc = _bank((2, 12, 7, 7, 8, 128), *types, seed=12, device=card)
    g, J = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    parts = [kernels.fused_collision_value_jac_multi(A, dpos, dneg, c[:, sl].contiguous(),
                                                     dc[:, sl].contiguous())
             for sl in (slice(0, 8), slice(8, 12))]
    torch.cuda.synchronize()
    assert torch.equal(g, torch.cat([parts[0][0], parts[1][0]], dim=1))
    assert torch.equal(J, torch.cat([parts[0][1], parts[1][1]], dim=1))
    gp, Jp = kernels.value_jac_multi_plain(A, dpos, dneg, c, dc)
    uniq = kernels.tie_mask(A, dpos, dneg, c, tol=1e-5)
    assert (g - gp).abs().max().item() <= ATOL[types[1]]
    assert ((J - Jp).abs() * uniq[:, :, None]).max().item() <= ATOL[types[1]]


@pytest.mark.parametrize("types", [(torch.bfloat16, torch.float32), (torch.float64, torch.float64)],
                         ids=lambda t: f"{str(t[0])[6:]}-{str(t[1])[6:]}")
def test_twenty_six_values_equal_launches_of_sixteen_and_ten(card, types):
    """One values-only launch at S=26 (two groups of 13 side by side in a
    block, on the streaming path at B=8) gives the same bits as launches at
    its first 16 starts and its last 10, and agrees with the plain version."""
    A, dpos, dneg, c, _ = _bank((8, 26, 1, 7, 8, 128), *types, seed=26, device=card)
    _poison(dpos, dneg, seed=26)
    g, ran = kernels._launch_values_multi(A, dpos, dneg, c)
    parts = [kernels._launch_values_multi(A, dpos, dneg, c[:, sl].contiguous())
             for sl in (slice(0, 16), slice(16, 26))]
    torch.cuda.synchronize()
    assert (ran, parts[0][1], parts[1][1]) == ("stream", "stream", "stream")
    assert torch.equal(_bits(g), _bits(torch.cat([parts[0][0], parts[1][0]], dim=1)))
    assert (g - kernels.values_multi_plain(A, dpos, dneg, c)).abs().max().item() <= ATOL[types[1]]


def test_first_maximum_wins_and_nan_never_wins(card):
    """An exact tie keeps the first pair (strict '>'); a piece with a NaN
    offset is skipped, so the slot takes the best of the others."""
    shape = (1, 2, 2, 1, 2, 4)
    A, dpos, dneg, c, dc = _bank(shape, torch.float64, torch.float64, seed=0, device=card)
    A.zero_()
    A[:, 0, 0] = 1.0
    A[:, 1, 1] = 1.0
    dpos.fill_(10.0)
    dneg.fill_(10.0)
    dpos[:, 0] = 0.0
    dpos[:, 1] = 0.0
    c.zero_()
    c[:, :, 0] = 0.5
    c[:, :, 1] = 0.5                        # pairs 0 and 1 tie at v = 0.5
    g, J = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    torch.cuda.synchronize()
    assert torch.all(g == -0.5)
    # pair 0 won on its + branch: signed normal (-1, 0, 0)
    torch.testing.assert_close(J, -dc[:, :, :, 0, :, None, :].expand_as(J), rtol=0, atol=0)

    dpos[:, 0, :, 1, 2] = torch.nan        # (l=0, o=1, t=2): pair 0 unusable there
    g2, J2 = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    torch.cuda.synchronize()
    assert torch.all(g2 == -0.5)
    # there pair 1 won: signed normal (0, -1, 0)
    torch.testing.assert_close(J2[..., 0, 1, 2], -dc[:, :, :, 1, 0, 2], rtol=0, atol=0)
    g2p, J2p = kernels.value_jac_multi_plain(A, dpos, dneg, c, dc)
    assert torch.equal(g2, g2p) and torch.equal(J2, J2p)


def test_wrappers_refuse_what_the_kernel_does_not_take(card):
    A, dpos, dneg, c, dc = _bank((1, 2, 7, 7, 8, 16), torch.bfloat16, torch.float32, 1, card)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_collision_values_multi(A, dpos, dneg, c.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_collision_value_jac_multi(A, dpos, dneg, c[:, :1].expand(1, 9, 3, 7, 16), dc[:, :1].expand(1, 9, 7, 3, 7, 16))
    with pytest.raises(ValueError, match="all must be on the CPU"):
        kernels.fused_collision_values_multi(A, dpos.cpu(), dneg, c)
    with pytest.raises(TypeError):
        kernels.fused_collision_values_multi(A, dpos, dneg, c.double())


def _bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _paths(A, dpos, dneg, c, dc, path):
    """Value + Jacobian, values only and the S = 1 launch through one path:
    the outputs and the paths the three launches report."""
    g, J, p = kernels._launch_value_jac_multi(A, dpos, dneg, c, dc, path=path)
    gv, pv = kernels._launch_values_multi(A, dpos, dneg, c, path=path)
    g1, J1, p1 = kernels._launch_value_jac_multi(A, dpos, dneg, c[:, :1].contiguous(),
                                                 dc[:, :1].contiguous(), path=path)
    torch.cuda.synchronize()
    return (g, J, gv, g1, J1), {p, pv, p1}


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("shape", SMALL_TOO, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("types", TYPES, ids=lambda t: f"{str(t[0])[6:]}-{str(t[1])[6:]}")
def test_paths_equal_to_the_bit(card, shape, types, nan):
    """The streaming and the small-grid path give the same bits for value +
    Jacobian, values only and S = 1, and each is within atol of the plain
    version."""
    A, dpos, dneg, c, dc = _bank(shape, *types, seed=sum(shape) + 1, device=card)
    if nan:
        _poison(dpos, dneg, seed=sum(shape) + 1)
    stream, ran_stream = _paths(A, dpos, dneg, c, dc, "stream")
    small, ran_small = _paths(A, dpos, dneg, c, dc, "small")
    assert (ran_stream, ran_small) == ({"stream"}, {"small"})
    for a, b in zip(stream, small):
        assert torch.equal(_bits(a), _bits(b))
    g, J, gv, g1, _ = small
    gp, Jp = kernels.value_jac_multi_plain(A, dpos, dneg, c, dc)
    uniq = kernels.tie_mask(A, dpos, dneg, c, tol=1e-5)
    atol = ATOL[types[1]]
    assert (g - gp).abs().max().item() <= atol
    assert ((J - Jp).abs() * uniq[:, :, None]).max().item() <= atol
    assert torch.equal(gv, g) and torch.equal(g1, g[:, :1])


@pytest.mark.parametrize("shape", STREAM_ONLY, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("types", TYPES, ids=lambda t: f"{str(t[0])[6:]}-{str(t[1])[6:]}")
def test_forcing_the_small_path_where_rows_are_not_aligned_streams(card, shape, types):
    A, dpos, dneg, c, dc = _bank(shape, *types, seed=sum(shape) + 1, device=card)
    stream, ran_stream = _paths(A, dpos, dneg, c, dc, "stream")
    forced, ran_forced = _paths(A, dpos, dneg, c, dc, "small")
    _, ran_auto = _paths(A, dpos, dneg, c, dc, None)
    assert ran_stream == ran_forced == ran_auto == {"stream"}
    for a, b in zip(stream, forced):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", [
    ((1, 4, 7, 7, 8, 128), "small"), ((1, 4, 7, 7, 8, 64), "small"),
    ((1, 4, 7, 7, 16, 128), "small"), ((128, 4, 7, 7, 8, 128), "stream"),
], ids=lambda c: "x".join(map(str, c[0])))
def test_launch_reports_the_path_it_chose(card, case):
    """The batch-1, grasp and bucket-16 banks choose the small-grid path on
    an H100 (132 SMs), for all three launches; the main path's bank streams."""
    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the crossover is pinned at an H100's 132 SMs")
    shape, path = case
    A, dpos, dneg, c, dc = _bank(shape, torch.bfloat16, torch.float32, seed=5, device=card)
    _, ran = _paths(A, dpos, dneg, c, dc, None)
    assert ran == {path}


@pytest.mark.parametrize("path", ["stream", "small"])
def test_first_maximum_wins_across_pair_groups(card, path):
    """An exact tie between pair 0 and pair 35 (the small-grid path's first
    and last pair groups) keeps pair 0; where pair 0 has a NaN the tie goes
    to pair 35, and where every pair but 20 has one, to pair 20."""
    A, dpos, dneg, c, dc = _bank((1, 2, 3, 2, 4, 64), torch.float64, torch.float64, seed=3,
                                 device=card)
    A.zero_()
    A[:, :, 2] = 1.0                        # every pair: normal (0, 0, 1)
    A[:, 0, 2] = -1.0                       # pair 0: normal (0, 0, -1)
    dpos.fill_(10.0)
    dneg.fill_(10.0)
    dneg[:, 0] = 0.0                        # pair 0: vn = -(-0.5) - 0 = 0.5
    dneg[:, 35] = -1.0                      # pair 35: vn = -0.5 + 1 = 0.5, a tie
    dpos[:, 20] = 0.25                      # pair 20: vp = 0.5 - 0.25 = 0.25
    c.zero_()
    c[:, :, 2] = 0.5
    g, J, ran = kernels._launch_value_jac_multi(A, dpos, dneg, c, dc, path=path)
    torch.cuda.synchronize()
    assert ran == path
    assert torch.all(g == -0.5)
    # pair 0 won on its - branch: signed normal +A = (0, 0, -1)
    torch.testing.assert_close(J, -dc[:, :, :, 2, :, None, :].expand_as(J), rtol=0, atol=0)
    dneg[:, 0, :, 1, 3] = torch.nan         # (o=1, t=3): pair 0 unusable there
    dpos[:, :, 1, 2, 5] = torch.nan         # (l=1, o=2, t=5): every pair unusable but 20
    dpos[:, 20, 1, 2, 5] = 0.25
    dneg[:, :, 1, 2, 5] = torch.where(torch.arange(36, device=card) == 20, 10.0, torch.nan)[None]
    g2, J2, _ = kernels._launch_value_jac_multi(A, dpos, dneg, c, dc, path=path)
    gv2, _ = kernels._launch_values_multi(A, dpos, dneg, c, path=path)
    torch.cuda.synchronize()
    g2p, J2p = kernels.value_jac_multi_plain(A, dpos, dneg, c, dc)
    assert torch.equal(g2, g2p) and torch.equal(J2, J2p) and torch.equal(gv2, g2)
    assert float(g2[0, 0, 1, 2, 5]) == -0.25
    # pair 35 won at (0, 1, 3) on its - branch: signed normal +A = (0, 0, 1)
    torch.testing.assert_close(J2[..., 0, 1, 3], dc[:, :, :, 2, 0, 3], rtol=0, atol=0)


def _fresh_process(script):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok"), proc.stdout


def test_first_small_grid_launch_inside_a_capture_in_a_fresh_process(card):
    """A fresh process whose first launches of the small-grid kernels (and
    so the first raise of their shared-memory limit) are inside a CUDA graph
    capture in global mode: the graph replays to the streaming path's bits."""
    _fresh_process("""
import torch
from armour_tpu_torch.collision import kernels
kernels._lib()                         # built and loaded; no kernel of it launched yet
gen = torch.Generator(device="cuda").manual_seed(0)
def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda")
A = randn(1, 36, 3, 7, 8, 128)
A = (A / A.norm(dim=2, keepdim=True)).to(torch.bfloat16)
dpos, dneg = randn(1, 36, 7, 8, 128), randn(1, 36, 7, 8, 128)
c, dc = randn(1, 4, 3, 7, 128), randn(1, 4, 7, 3, 7, 128)
torch.cuda.synchronize()
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph, capture_error_mode="global"):
    g, J, ran = kernels._launch_value_jac_multi(A, dpos, dneg, c, dc, path="small")
    gv, ran_v = kernels._launch_values_multi(A, dpos, dneg, c, path="small")
assert (ran, ran_v) == ("small", "small"), (ran, ran_v)
graph.replay()
g2, J2, _ = kernels._launch_value_jac_multi(A, dpos, dneg, c, dc, path="stream")
gv2, _ = kernels._launch_values_multi(A, dpos, dneg, c, path="stream")
torch.cuda.synchronize()
assert torch.equal(g, g2) and torch.equal(J, J2) and torch.equal(gv, gv2)
print("ok")
""")


def test_plan_program_captures_the_small_grid_path_in_a_fresh_process(card):
    """A fresh process: a plan program (captured at its first call) replays
    with 65 launches, equal to the eager plan to the bit, and a launch on a
    bank of the plan's shape reports the small-grid path."""
    script = """
import numpy as np, torch
from armour_tpu_torch.collision import kernels
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

cfg = PlannerConfig()
pl = ArmourPlanner(kinova_gen3_spec(), cfg, torch.float32, device="cuda")
probs = problem_set(cfg, 3, n_obs=8, seed=0, device="cuda")
passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
for i in range(3):
    world = (probs.q0[i], probs.qd0[i], probs.qdd0[i], probs.q_des[i],
             ObstacleSet(probs.zonos[i], probs.masks[i]))
    k_rand = pl.random_starts(1, torch.Generator(device="cuda").manual_seed(i))[0]
    # the kept plan first: the process's first launch is its capture's warm-up
    kernels.reset_launch_counts()
    res = pl.plan(*world, k_rand=k_rand)
    torch.cuda.synchronize()
    if i > 0:      # a replay
        assert kernels.launch_counts()["fused_collision_value_jac_multi"] == passes
    ref = pl.plan(*world, k_rand=k_rand, eager=True)
    for f in ("k", "feasible", "max_violation"):
        a, b = getattr(res, f).cpu(), getattr(ref, f).cpu()
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), (i, f)
stats = pl.programs.stats()
assert (stats["misses"], stats["hits"]) == (1, 2), stats
args = pl.plan_args(*world, k_rand=k_rand)[1]
bank = pl.build_fixed(*args[:3], *args[4:6]).hp
S, T = cfg.nlp_num_starts, cfg.num_time_steps
c = torch.zeros((1, S, 3, 7, T), device="cuda")
dc = torch.zeros((1, S, 7, 3, 7, T), device="cuda")
assert kernels._launch_value_jac_multi(bank.A, bank.dpos, bank.dneg, c, dc)[2] == "small"
print("ok", stats)
"""
    _fresh_process(script)
