"""The port's reference-schema export against the committed artifacts.

`armour_tpu_torch.export_reference_schema.export` on the CPU at T=128 and
the artifacts' 20 samples per interval reproduces
``results/reference_schema/`` (f64) and ``results/reference_schema_f32/``
(f32), which the JAX script wrote:

- every number of the four numeric `.out` files and the fixed k of
  ``armour_main.out`` (its last line, the build time, is skipped): f64
  within ``5.5e-10 * |printed| + 1e-15`` (10 printed digits), the
  constraints file within ``5.5e-6 * |printed| + 1e-12`` (6 printed
  digits); f32 within ``1e-5 * |printed| + 1e-12``;
- the layout: the same number of lines and of numbers per line;
- the containment report: 0 torque and 0 link violations, the minimum
  margins to 1e-9 (f64) and 1e-5 (f32).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from armour_tpu_torch.export_reference_schema import OUT_FILES, export

ROOT = Path(__file__).resolve().parents[1]
# committed directory, dtype, (rtol, atol) by file ("" for every other file), margin tolerance
CASES = {
    "f64": ("reference_schema", torch.float64,
            {"": (5.5e-10, 1e-15), "armour_main_constraints.out": (5.5e-6, 1e-12)}, 1e-9),
    "f32": ("reference_schema_f32", torch.float32, {"": (1e-5, 1e-12)}, 1e-5),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One B = 1 pipeline: one intra-op thread runs it as fast as eight and
    leaves the cores to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    return [[float(x) for x in ln.split()] for ln in Path(path).read_text().split("\n") if ln.strip()]


@pytest.fixture(scope="module", params=list(CASES))
def exported(request, tmp_path_factory):
    ref_dir, dtype, tols, margin_tol = CASES[request.param]
    out = tmp_path_factory.mktemp(request.param)
    report = export(out, time_steps=128, n_samples=20, dtype=dtype, device="cpu")
    return out, ROOT / "results" / ref_dir, tols, margin_tol, report


def test_out_files_match_the_committed_artifacts(exported):
    out, ref_dir, tols, _, _ = exported
    for name in OUT_FILES:
        got, ref = _rows(out / name), _rows(ref_dir / name)
        if name == "armour_main.out":          # the last line is the build time
            got, ref = got[:-1], ref[:-1]
        assert [len(r) for r in got] == [len(r) for r in ref], name
        g, r = np.concatenate(got), np.concatenate(ref)
        rtol, atol = tols.get(name, tols[""])
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)
    # the fixed k and the " \n" line ends of the reference's layout
    assert (out / "armour_main.out").read_text().split("\n")[:7] == \
        (ref_dir / "armour_main.out").read_text().split("\n")[:7]
    assert (out / OUT_FILES[1]).read_text().endswith(" \n")


def test_containment_report_matches(exported):
    out, ref_dir, _, margin_tol, report = exported
    ref = json.loads((ref_dir / "containment_report.json").read_text())
    assert json.loads((out / "containment_report.json").read_text()) == report
    assert set(report) == set(ref)
    for key in ("pipeline_dtype", "time_steps", "k_slice", "samples_per_interval"):
        assert report[key] == ref[key], key
    assert report["torque_containment_violations"] == 0
    assert report["link_center_containment_violations"] == 0
    for key in ("torque_min_margin_Nm", "link_min_margin_m"):
        assert report[key] == pytest.approx(ref[key], abs=margin_tol), key
