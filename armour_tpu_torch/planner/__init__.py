"""See the matching subpackage of armour_tpu for the reference."""

from armour_tpu_torch.planner.nlp import solve_box_alm
from armour_tpu_torch.planner.armour import ArmourPlanner, PlanResult

__all__ = ["solve_box_alm", "ArmourPlanner", "PlanResult"]
