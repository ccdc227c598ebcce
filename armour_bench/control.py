"""The controls of the correctness check: the program one precision below
what the configuration states.

The configurations state float32 with TF32 off (``armour_tpu_torch``
turns it off on import; its numeric slacks were sized for full float32),
so the nearest precision below, and the step that would tempt a later
change, is TF32 for the matrix products (``tf32``).  The hyperplane bank
that the bank pass reads is stated as bfloat16 normals with float32
offsets; one step below is float8 (e4m3) normals, the offsets worked out
for them as the program does for bfloat16 (``fp8_normals``), or bfloat16
offsets (``bf16_offsets``).  On the card ``tf32()`` turns
PyTorch's TF32 switches on.  On the CPU, which has no TF32, it rounds the
float32 operands of ``torch.einsum``, ``torch.matmul``, ``torch.bmm``,
``torch.tensordot`` and ``@`` to TF32's 10-bit mantissa (round to
nearest) and multiplies those in float32: the same loss of precision, for
the CPU test of the control.  The benchmark's own runs never call any.
"""

from __future__ import annotations

import contextlib

import torch

_NAMES = ("einsum", "matmul", "bmm", "tensordot")


def round_tf32(x):
    """A float32 tensor rounded to 10 mantissa bits (ties away from zero);
    anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _rounded(fn):
    def call(*args, **kwargs):
        args = [[round_tf32(a) for a in x] if isinstance(x, (list, tuple)) else round_tf32(x)
                for x in args]
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def tf32(device):
    """TF32 matrix products on ``device`` inside the block."""
    device = torch.device(device)
    if device.type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
        return
    saved = {n: getattr(torch, n) for n in _NAMES}
    saved_mm = torch.Tensor.__matmul__
    try:
        for n in _NAMES:
            setattr(torch, n, _rounded(saved[n]))
        torch.Tensor.__matmul__ = _rounded(saved_mm)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch, n, fn)
        torch.Tensor.__matmul__ = saved_mm


@contextlib.contextmanager
def _bank(make):
    """``ArmourPlanner``'s bank builder replaced by ``make(builder, *args,
    **kwargs)`` inside the block; the planner has to be made inside it, so
    that the kept programs capture the replaced build."""
    from armour_tpu_torch.planner import armour

    builder = armour.buffer_obstacles

    def replaced(*args, **kwargs):
        return make(builder, *args, **kwargs)

    armour.buffer_obstacles = replaced
    try:
        yield
    finally:
        armour.buffer_obstacles = builder


def _fp8_normals(builder, *args, **kwargs):
    """The bank with its normals rounded to float8 e4m3 where the program
    rounds them to bfloat16 (every value of e4m3 is one of bfloat16), the
    offsets worked out for the rounded normals."""
    to = torch.Tensor.to

    def rounded(self, *a, **k):
        if (a and a[0] is torch.bfloat16) or k.get("dtype") is torch.bfloat16:
            return to(to(self, torch.float8_e4m3fn), torch.bfloat16)
        return to(self, *a, **k)

    torch.Tensor.to = rounded
    try:
        return builder(*args, **kwargs)
    finally:
        torch.Tensor.to = to


def _bf16_offsets(builder, *args, **kwargs):
    """The bank with its float32 offsets rounded to bfloat16."""
    hp = builder(*args, **kwargs)
    return hp._replace(dpos=hp.dpos.to(torch.bfloat16).to(hp.dpos.dtype),
                       dneg=hp.dneg.to(torch.bfloat16).to(hp.dneg.dtype))


def fp8_normals():
    return _bank(_fp8_normals)


def bf16_offsets():
    return _bank(_bf16_offsets)


CONTROLS = {"tf32": tf32, "fp8_normals": lambda device: fp8_normals(),
            "bf16_offsets": lambda device: bf16_offsets()}


@contextlib.contextmanager
def state_unchanged():
    """A planted fault: the solver's Gauss-Newton step returns its state
    unchanged (``solve_box_alm_multi`` with no inner iterations), so each
    answer stays at the best of its starts.  Made before the planner."""
    from armour_tpu_torch.planner import armour

    solve = armour.solve_box_alm_multi

    def frozen(*args, **kwargs):
        return solve(*args, **{**kwargs, "inner_iters": 0})

    armour.solve_box_alm_multi = frozen
    try:
        yield
    finally:
        armour.solve_box_alm_multi = solve


def altered_answer(res):
    """The plan with its first world's ``k`` moved by 0.3 (clipped to the
    box) where it is produced, every other answer as planned."""
    k = res.k.clone()
    row = k[0] if k.ndim == 2 else k
    row.copy_(torch.clamp(row + 0.3, -1.0, 1.0))
    return res._replace(k=k)


@contextlib.contextmanager
def answer_altered(entry: str):
    """A planted fault for the check's readings: ``ArmourPlanner.<entry>``
    (``plan_batch`` or ``plan``) returns ``altered_answer`` of its plan."""
    from armour_tpu_torch.planner.armour import ArmourPlanner

    plan = getattr(ArmourPlanner, entry)

    def broken(self, *args, **kwargs):
        return altered_answer(plan(self, *args, **kwargs))

    setattr(ArmourPlanner, entry, broken)
    try:
        yield
    finally:
        setattr(ArmourPlanner, entry, plan)
