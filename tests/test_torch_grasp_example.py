"""`python -m armour_tpu_torch.grasp_example` on the CPU: the grasp plan
(T=64, f32, one obstacle) is feasible, the tray tilt is reported at five
points along it, the plan without the contact constraints is feasible too,
and the contact-wrench figure goes to ``--out`` where matplotlib is
installed."""

from pathlib import Path

import torch

from armour_tpu_torch import grasp_example
from armour_tpu_torch.utils.plotting import HAVE_MPL


def test_grasp_example_plans_a_feasible_grasp(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = grasp_example.main(["--device", "cpu", "--out", str(tmp_path / "wrench.png")])
    finally:
        torch.set_num_threads(n)
    assert out["grasp_feasible"] and out["free_feasible"]
    assert len(out["tray_tilt_deg"]) == 5 and all(0.0 <= t < 30.0 for t in out["tray_tilt_deg"])
    if HAVE_MPL:
        assert out["figure"] == str(tmp_path / "wrench.png")
        assert Path(out["figure"]).stat().st_size > 1000
    else:
        assert out["figure"] is None
