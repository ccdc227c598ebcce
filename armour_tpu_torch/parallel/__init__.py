"""See the matching subpackage of armour_tpu for the reference."""

from armour_tpu_torch.parallel.mesh import make_planner_mesh, sharded_plan_step

__all__ = ["make_planner_mesh", "sharded_plan_step"]
