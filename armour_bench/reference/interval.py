"""Frozen copy of ``armour_tpu_torch/ops/interval.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Batched interval arithmetic on (lo, hi) tensor pairs.

Port of `armour_tpu/ops/interval.py`: plain f32/f64 tensors with outward
slack applied at the constraint layer instead of per-op directed rounding
(see PlannerConfig.*_numeric_slack).  Every operation broadcasts over
arbitrary leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Interval(NamedTuple):
    lo: torch.Tensor
    hi: torch.Tensor

    @staticmethod
    def point(x) -> "Interval":
        return Interval(x, x)

    @staticmethod
    def from_center_radius(c, r) -> "Interval":
        return Interval(c - r, c + r)

    @property
    def center(self):
        return 0.5 * (self.lo + self.hi)

    @property
    def radius(self):
        return 0.5 * (self.hi - self.lo)

    def __add__(self, o):
        if isinstance(o, Interval):
            return Interval(self.lo + o.lo, self.hi + o.hi)
        return Interval(self.lo + o, self.hi + o)

    __radd__ = __add__

    def __neg__(self):
        return Interval(-self.hi, -self.lo)

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if isinstance(o, Interval):
            p1 = self.lo * o.lo
            p2 = self.lo * o.hi
            p3 = self.hi * o.lo
            p4 = self.hi * o.hi
            return Interval(
                torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
            )
        a = self.lo * o
        b = self.hi * o
        return Interval(torch.minimum(a, b), torch.maximum(a, b))

    __rmul__ = __mul__

    def square(self) -> "Interval":
        """x^2 with the tight [0, ...] lower bound when 0 is inside."""
        lo2 = self.lo * self.lo
        hi2 = self.hi * self.hi
        hi = torch.maximum(lo2, hi2)
        lo = torch.where((self.lo <= 0.0) & (self.hi >= 0.0), 0.0, torch.minimum(lo2, hi2))
        return Interval(lo, hi)

    def abs_sup(self):
        """sup |x| over the interval."""
        return torch.maximum(self.lo.abs(), self.hi.abs())

    def union(self, o: "Interval") -> "Interval":
        return Interval(torch.minimum(self.lo, o.lo), torch.maximum(self.hi, o.hi))

    def contains(self, x, atol=0.0):
        return (self.lo - atol <= x) & (x <= self.hi + atol)


_TWO_PI = 2.0 * math.pi


def icos(x: Interval) -> Interval:
    """Tight range of cos over an interval (handles period wrap)."""
    base = torch.floor(x.lo / _TWO_PI) * _TWO_PI
    a = x.lo - base
    b = x.hi - base
    width_ge_period = (x.hi - x.lo) >= _TWO_PI
    ca, cb = torch.cos(a), torch.cos(b)
    lo = torch.minimum(ca, cb)
    hi = torch.maximum(ca, cb)
    # cos attains +1 at 0, 2pi, 4pi; a in [0, 2pi)
    has_max = (b >= _TWO_PI) | width_ge_period | (a == 0.0)
    # cos attains -1 at pi, 3pi
    has_min = ((a <= math.pi) & (b >= math.pi)) | (b >= 3.0 * math.pi) | width_ge_period
    return Interval(torch.where(has_min, -1.0, lo), torch.where(has_max, 1.0, hi))


def isin(x: Interval) -> Interval:
    """Tight range of sin over an interval."""
    return icos(Interval(x.lo - 0.5 * math.pi, x.hi - 0.5 * math.pi))
