"""``python -m armour_tpu_torch.simple_example`` on the CPU: one iteration
of the two-box episode at T=16 returns its flags and writes the episode's
``.npz``, the hardware CSV and (where matplotlib is installed) the four
figures; without ``--device cpu`` it needs a card."""

import numpy as np
import pytest
import torch

from armour_tpu_torch import simple_example
from armour_tpu_torch.sim.recording import load_recording
from armour_tpu_torch.utils import plotting


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_iteration_writes_the_episode(tmp_path):
    res = simple_example.main(["--device", "cpu", "--time-steps", "16", "--max-iterations", "1",
                               "--out-dir", str(tmp_path)])
    assert res["iterations"] == 1 and res["n_feasible_plans"] == 1
    assert not res["collision"] and not res["goal_reached"] and not res["stopped"]
    rec = load_recording(res["npz"])
    assert rec["q"].shape == (50, 7) and np.isfinite(rec["q"]).all()
    assert np.allclose(rec["q"][0], simple_example.START) and rec["feasible"].tolist() == [True]
    rows = np.loadtxt(res["csv"], delimiter=",", ndmin=2)
    assert rows.shape == (50, 22) and np.allclose(rows[:, 15:], rec["q"], rtol=0, atol=1e-5)
    names = {"tracking": "tracking.png", "torques": "torques.png", "world": "world.png", "frs": "frs.png"}
    for key, fname in names.items():
        assert res["figures"][key] == (str(tmp_path / fname) if plotting.HAVE_MPL else None), key
        assert (tmp_path / fname).exists() == plotting.HAVE_MPL


def test_needs_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simple_example.main(["--max-iterations", "1", "--out-dir", str(tmp_path / "ex")])
    assert not (tmp_path / "ex").exists()
