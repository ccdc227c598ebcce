"""What a run loads and when it refuses to run."""

import json
import os
import shutil
import subprocess
import sys

from armour_bench import harness

ENV = {**os.environ, "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}


def _python(code, cwd=harness.ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=300)


def test_the_run_path_loads_no_jax_nor_the_jax_package():
    code = ("import sys, json\n"
            "sys.path.insert(0, '.')\n"
            "from armour_bench import harness, gen, calibrate, control, trace, roofline\n"
            "from armour_bench.reference import check\n"
            "import armour_tpu_torch\n"
            "from armour_tpu_torch.planner.armour import ArmourPlanner\n"
            "from armour_tpu_torch.collision.zonotope import ObstacleSet\n"
            "for kind in ('end_to_end', 'metrics'):\n"
            "    for p in sorted((harness.BENCH / kind).glob('*.py')):\n"
            "        harness.load_reader(kind, p.stem)\n"
            "print(json.dumps({'bad': harness.forbidden_modules(),\n"
            "                  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "armour_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "armour_tpu"} & set(got["tops"])


def test_forbidden_names_are_compared_whole():
    code = ("import sys, types\n"
            "sys.path.insert(0, '.')\n"
            "from armour_bench import harness\n"
            "import armour_tpu_torch\n"
            "sys.modules['armour_tpu_torchx'] = types.ModuleType('armour_tpu_torchx')\n"
            "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
            "sys.modules['armour_tpu.ops'] = types.ModuleType('armour_tpu.ops')\n"
            "print(harness.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['armour_tpu', 'jax']"


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "import armour_tpu" not in text and "from armour_tpu" not in text, path


def test_the_command_refuses_without_a_card():
    man = harness.manifest()
    out = subprocess.run([*man["command"], "--workload", "batch128_8obs", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    has no program to run: the command exits non-zero and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "armour_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    env = {**ENV, "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "")}
    out = subprocess.run([*man["command"], "--workload", "realtime_8obs", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
