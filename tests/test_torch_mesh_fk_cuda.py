"""The battery driver's mesh refinement on the card: its kept FK stage
against the same driver run op by op.

Runs only where a CUDA device is present (marker ``cuda``; elsewhere each
test skips).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_fk_cuda.py -q

``run_batch_stepped`` with ``collision_oracle="mesh"`` on the two worlds of
`tests/test_torch_harness.py` (`torch_harness_worlds.py`): world 1 holds a
1 cm box inside a link's bounding box, so the box screen flags its window
every iteration and the mesh oracle, fed by the ``fk`` stage, clears it.
The kept run and ``eager=True`` run the same kernels on the same inputs
from the same seed, so every flag, the trace's ``mesh_flagged`` and
``mesh_confirmed`` and every summary field are held equal to the bit; the
kept run's ``fk`` stage must replay (a hit after its first capture).
"""

import numpy as np
import pytest
import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.sim import harness
from torch_harness_worlds import SPEC, two_worlds

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_mesh_fk_cuda.py")
    return torch.device("cuda")


def _bits(x):
    x = x.contiguous()
    return x.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(x.dtype, x.dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_mesh_refinement_kept_equals_eager(card, dtype):
    starts, goals, zonos, masks = two_worlds()
    runner = harness.EpisodeRunner(SPEC, PlannerConfig(num_time_steps=16),
                                   SimConfig(plant_dt=5e-3, max_iterations=3, stall_clearance=1),
                                   dtype, device=card)
    runs = {}
    for eager in (False, True):
        trace = []
        summary = harness.run_batch_stepped(
            runner, starts, goals, zonos, masks, torch.Generator(device=card).manual_seed(0),
            collision_oracle="mesh", trace=trace, eager=eager)
        torch.cuda.synchronize()
        runs[eager] = summary, trace
    (kept, kept_trace), (eager, eager_trace) = runs[False], runs[True]
    for name in kept._fields:
        a, b = getattr(kept, name), getattr(eager, name)
        assert (a is None and b is None) or torch.equal(_bits(a), _bits(b)), name
    for key in ("mesh_flagged", "mesh_confirmed", "feasible", "clearance_worlds", "bucket"):
        assert [t[key] for t in kept_trace] == [t[key] for t in eager_trace], key
    # what the worlds were built to exercise: world 1's window flagged by the
    # box screen at every iteration and cleared by the meshes
    assert not bool(kept.collision.any())
    assert sum(t["mesh_flagged"] for t in kept_trace) == len(kept_trace) >= 2
    assert sum(t["mesh_confirmed"] for t in kept_trace) == 0
    assert np.asarray(kept.iterations.cpu()).tolist()[1] == len(kept_trace)
    # the kept FK stage ran where it is used: captured once, then replayed
    assert kept_trace[-1]["stage_hits_by_name"].get("fk", 0) >= 1, kept_trace[-1]
