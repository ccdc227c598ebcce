"""``python -m armour_tpu_torch.generate_worlds`` writes the suite that
``generate_world_suite`` writes, and runs on the card unless asked for
the CPU."""

import pytest
import torch

from armour_tpu_torch import generate_worlds
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.scenarios import generate_world_suite, load_world_csv


def test_entry_point_writes_the_suite(tmp_path):
    paths = generate_worlds.main(["--n", "2", "--device", "cpu", "--out", str(tmp_path / "cli")])
    want = generate_world_suite(kinova_gen3_spec(), tmp_path / "suite", n_worlds=2, seed=0)
    assert [p.name for p in paths] == [p.name for p in want] == ["scene_010_001.csv", "scene_020_002.csv"]
    for got, ref in zip(paths, want):
        assert got.read_bytes() == ref.read_bytes()
        w = load_world_csv(got, 40, device="cpu")
        assert int(w.obstacles.mask.sum()) == int(got.name[6:9])


def test_entry_point_needs_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_worlds.main(["--n", "1", "--out", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
