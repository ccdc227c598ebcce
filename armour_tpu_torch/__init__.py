"""armour_tpu_torch — the ARMOUR planner, its low-level controllers and the
plant simulation in PyTorch, with the collision bank pass as hand-written
CUDA for Hopper (sm_90a).

A second implementation beside the JAX package ``armour_tpu``, which stays
the numerical reference.  The layout mirrors it module for module; every
tensor carries the world axis B in front (the JAX ``vmap`` axis written out).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.

Importing the package turns TF32 off for float32 matrix products and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``): the PZ einsums run in f32
and the numeric slacks of ``PlannerConfig`` were sized for full f32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from armour_tpu_torch.config import PlannerConfig  # noqa: E402
from armour_tpu_torch.device import resolve_device  # noqa: E402
from armour_tpu_torch.robots.kinova import kinova_gen3_spec  # noqa: E402
from armour_tpu_torch.robots.spec import RobotSpec  # noqa: E402

__all__ = ["PlannerConfig", "RobotSpec", "kinova_gen3_spec", "resolve_device"]
