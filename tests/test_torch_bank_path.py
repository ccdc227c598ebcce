"""The bank pass's launch geometry and choice of path, on the CPU (no card, no JAX).

`csrc/collision_bank_grid.cuh` is the one model of both paths' grids: the
kernels of `csrc/collision_bank.cu` launch on it, and here it is built with
the host compiler (through `csrc/collision_bank_grid.cpp`) and asked.
Values-only launches above 16 starts split them into groups of at most 16
whose sizes differ by at most one, side by side in one block.  At an
H100's 132 SMs the batch-1 plan's bank (B=1, O=8, T=128), the grasp
example's (T=64) and the batch-1 bank at
bucket 16 take the small-grid path at every start count a batch-1 plan
launches; the batched planner's banks (B=100 and 128) stream, and so does a
small bank whose small grid would run in more than 3 waves.  A bank whose
rows are not 16-byte aligned, or whose tile does not fit a block's shared
memory, streams even when the small-grid path is forced.  The card tests
(`tests/test_torch_kernels_cuda.py`) hold the two paths to the same bits and
check the path each launch reports.
"""

import pytest

from armour_tpu_torch.collision import kernels

H100_SMS = 132
BF16, F32, F64 = 2, 4, 8


@pytest.fixture(scope="module")
def grid():
    """`csrc/collision_bank_grid.cpp` built with the host compiler (g++)."""
    return kernels.grid_model()


CASES = [  # B, S, L, O, T, with the Jacobian, path chosen
    (1, 4, 7, 8, 128, True, "small"),       # batch-1 plan: 65 value + Jacobian launches
    (1, 1, 7, 8, 128, True, "small"),       # its check path: value + Jacobian at S=1 ...
    (1, 1, 7, 8, 128, False, "small"),      # ... and values only
    (1, 10, 7, 8, 128, False, "small"),     # a smooth batch-1 plan's verification pool
    (1, 4, 7, 8, 64, True, "small"),        # the grasp example
    (1, 4, 7, 16, 128, True, "small"),      # batch-1 at bucket 16
    (4, 10, 7, 8, 128, False, "small"),     # values only at S=10: 56 streaming blocks, 672 small
    (8, 10, 7, 8, 128, False, "stream"),    # 112 streaming blocks, but 1,344 small: over 3 waves
    (4, 16, 7, 8, 128, False, "stream"),    # 112 and 896
    (4, 4, 7, 8, 128, True, "small"),       # 56 and 224
    (10, 4, 7, 8, 128, True, "stream"),     # 140 blocks: the grid fills the card
    (100, 4, 7, 8, 128, True, "stream"),    # the battery's first bank
    (128, 4, 7, 8, 128, True, "stream"),    # the main path
    (128, 1, 7, 8, 128, True, "stream"),
    (128, 12, 7, 16, 128, True, "stream"),
    (128, 26, 7, 8, 128, False, "stream"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])) + ("-jac" if c[5] else "-values"))
def test_path_choice_at_132_sms(grid, case):
    B, S, L, O, T, jac, path = case
    auto = grid.grid_launch_path(2, B, 36, L, O, T, S, jac, BF16, F32, 1, H100_SMS)
    assert auto == kernels.PATHS[path]
    # a forced path is taken where the bank allows it
    for forced in ("stream", "small"):
        assert grid.grid_launch_path(kernels.PATHS[forced], B, 36, L, O, T, S, jac, BF16, F32, 1,
                                     H100_SMS) == kernels.PATHS[forced]


@pytest.mark.parametrize("case", [
    # P, L, O, T, A size, offsets' size, base pointers aligned: why the small path cannot run
    (36, 7, 3, 5, BF16, F32, 1),    # L*O*T = 105: rows not 16-byte aligned
    (3, 5, 3, 33, F32, F64, 1),     # L*O*T = 495
    (36, 7, 8, 128, BF16, F32, 0),  # a base pointer off 16 bytes
    (48, 7, 8, 128, F64, F64, 1),   # a tile of 48 f64 pairs: 240 KB + the combine, over 227 KB
])
def test_banks_the_small_path_cannot_take_stream_even_when_forced(grid, case):
    P, L, O, T, a_size, o_size, aligned = case
    for path in (1, 2):
        assert grid.grid_launch_path(path, 1, P, L, O, T, 4, 1, a_size, o_size, aligned,
                                     H100_SMS) == kernels.PATHS["stream"]


@pytest.mark.parametrize("case", [
    # S, L, O, T, with the Jacobian, offsets' size, blocks of one world
    (4, 7, 8, 128, True, F32, 14),     # batch-1: 4 obstacles per thread, one start group
    (4, 7, 8, 64, True, F32, 7),       # grasp
    (4, 7, 16, 128, True, F32, 28),    # bucket 16
    (12, 7, 8, 128, True, F32, 42),    # three start groups of 4
    (10, 7, 8, 128, False, F32, 14),   # values only: one group of 10, 4 obstacles per thread
    (26, 7, 8, 128, False, F32, 28),   # two groups of 13 in one block: 2 obstacles per thread
    (4, 7, 8, 128, True, F64, 56),     # f64 offsets: 1 obstacle per thread
])
def test_streaming_grid(grid, case):
    *shape, jac, o_size, blocks = case
    assert grid.grid_stream_blocks(*shape, jac, o_size) == blocks


@pytest.mark.parametrize("case", [
    # S, offsets' size: start groups, how many share a block, starts of each group, obstacles
    # per thread, blocks of one world (B=128, L=7, O=8, T=128), values only
    (17, F32, 2, 2, [9, 8], 4, 14),
    (20, F32, 2, 2, [10, 10], 4, 14),
    (26, F32, 2, 2, [13, 13], 2, 28),      # a 12-start plan's pool: 26 starts computed, not 32
    (32, F32, 2, 2, [16, 16], 1, 56),     # 16 starts x 5 words over the grouped budget: V = 1
    (33, F32, 3, 3, [11, 11, 11], 2, 28),  # 11 starts x 7 words over the grouped budget: V = 2
    (52, F32, 4, 4, [13, 13, 13, 13], 2, 28),
    (26, F64, 2, 2, [13, 13], 1, 56),
    (33, F64, 4, 2, [9, 8, 8, 8], 1, 112),  # 2 groups a block in f64: two blocks a tile
    (52, F64, 4, 2, [13, 13, 13, 13], 1, 112),
    (65, F32, 6, 3, [11, 11, 11, 11, 11, 10], 2, 56),  # over 4 groups: two blocks of 3
], ids=lambda c: f"S{c[0]}-f{8 * c[1]}" if isinstance(c, tuple) else None)
def test_values_start_groups_share_a_block(grid, case):
    """Values only above 16 starts: the groups, the fewest of at most 16
    starts, each compute their own starts and at most one more (the template
    bound is the largest group's size), sit side by side in one block where
    the offsets' type allows, and the launch's block count follows."""
    S, o_size, groups, in_block, starts, v, blocks = case
    got = kernels.stream_grid(S, 7, 8, 128, False, o_size)
    assert (got["groups"], got["block_groups"], got["starts"]) == (groups, in_block, starts)
    assert sum(got["starts"]) == S
    assert all(got["bound"] - s <= 1 for s in got["starts"]) and max(got["starts"]) == got["bound"]
    assert got["obstacles_per_thread"] == v and got["blocks"] == blocks
    assert got["threads"] == 128 * in_block <= 128 * grid.grid_most_block_groups(o_size)
    assert grid.grid_stream_blocks(S, 7, 8, 128, 0, o_size) == blocks
    # the streaming path at the main path's B=128, not the small-grid one
    assert grid.grid_launch_path(2, 128, 36, 7, 8, 128, S, 0, BF16, o_size, 1, H100_SMS) == 0


def test_start_groups_cover_every_start_once(grid):
    """Any S, either kernel, either offsets' type: the groups take the starts
    in order, each at least one and at most the instantiation's bound.  With
    the Jacobian a group holds 4 (the last the rest) and is a block; values
    only above 16 starts the groups fill their blocks (grid_groups x
    block_groups), differ by at most one start and are instantiated exactly
    (9 to 16), so none computes more than one start that it does not store."""
    for jac in (0, 1):
        for o_size in (F32, F64):
            for S in range(1, 300):
                G, bound = grid.grid_stream_groups(S, jac, o_size), grid.grid_stream_bound(S, jac, o_size)
                in_block = grid.grid_block_groups(S, jac, o_size)
                even = in_block > 1
                firsts = [grid.grid_group_start(k, S, G, bound, even) for k in range(G + 1)]
                sizes = [b - a for a, b in zip(firsts, firsts[1:])]
                assert firsts[0] == 0 and firsts[G] == S, (S, jac, o_size, firsts)
                assert min(sizes) >= 1 and max(sizes) <= bound, (S, jac, o_size, sizes, bound)
                assert in_block <= grid.grid_most_block_groups(o_size) and G % in_block == 0
                if jac:
                    assert in_block == 1 and sizes[:-1] == [4] * (G - 1) and bound == (1 if S == 1 else 4)
                elif S <= 16:
                    assert G == 1 and bound == (1 if S == 1 else 4 if S <= 4 else 10 if S <= 10 else 16)
                else:
                    assert even and 9 <= bound <= 16 and bound - min(sizes) <= 1, (S, o_size, sizes)


def test_small_grid_waves_in_f64(grid):
    """One f64 small-grid block fills an SM, so 3 waves are 396 blocks."""
    assert grid.grid_launch_path(2, 2, 36, 7, 8, 128, 4, 1, F64, F64, 1, H100_SMS) == 1  # 112
    assert grid.grid_launch_path(2, 2, 36, 7, 8, 128, 16, 0, F64, F64, 1, H100_SMS) == 0  # 448


def test_small_grid_starts_per_block(grid):
    """1 or 2 starts a block where the grid still leaves a block to each SM."""
    assert grid.grid_small_starts(1, 4, 7, 8, 128, H100_SMS) == 2    # 56 tiles: 112 blocks
    assert grid.grid_small_starts(1, 4, 7, 8, 64, H100_SMS) == 1     # 28 tiles: 112 blocks
    assert grid.grid_small_starts(1, 1, 7, 8, 128, H100_SMS) == 1
    assert grid.grid_small_starts(4, 4, 7, 8, 128, H100_SMS) == 4


def test_ptxas_summary_names_both_paths():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_19bank_passIffLi4ELb0EEEvPKT_PKT0_S7_S7_S7_PS5_S8_iiiiiiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_19bank_passIffLi4ELb0EEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 128 bytes smem, 432 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115bank_pass_smallI13__nv_bfloat16fLi4ELb1EEEvPKT_PKT0_S8_S8_S8_PS6_S9_iiiiiiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 432 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_19bank_passI13__nv_bfloat16fLi13ELb0ELi4EEEvPKT_PKT0_S8_S8_S8_PS6_S9_"
        "iiiiiiiii' for 'sm_90a'",
        "ptxas info    : Used 72 registers, used 1 barriers, 432 bytes cmem[0]",
    ])
    rows = kernels.ptxas_summary(log)
    assert [r["kernel"] for r in rows] == ["bank_pass<f32,f32,S<=4,values>",
                                           "bank_pass_small<bf16,f32,S<=4,value+jac>",
                                           "bank_pass<bf16,f32,S<=13,values,4 groups>"]
    assert (rows[0]["registers"], rows[0]["smem_bytes"], rows[0]["spill_stores"]) == (64, 128, 0)
    assert (rows[1]["registers"], rows[1]["spill_stores"], rows[1]["spill_loads"]) == (40, 8, 8)
