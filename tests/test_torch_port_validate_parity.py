"""``tools/validate_parity_torch.py``, the port's one-command 0.5% top-1
gate, against the JAX package's ``tools/validate_parity.py``: the same
profiles, the same reference-CSV rows, the same gate lines, and a
dataset-free rehearsal on the CPU.  The JAX tool imports nothing of JAX at
module level, and its ``build_config``, ``load_reference_csv`` and
``check_gate`` need none, so they are called here directly."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import tools.validate_parity as jax_vp  # noqa: E402
import tools.validate_parity_torch as vp  # noqa: E402

from seam_match_rcnn_tpu_torch.config import ViTConfig  # noqa: E402
from torch_port_canvas import Canvas96x128  # noqa: E402

torch.set_num_threads(2)

PROFILES = ("exact", "parity", "serving", "fast")


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("profile", PROFILES)
def test_build_config_equals_the_jax_tool(profile, small):
    """The JAX tool's fields agree; the port's own (the ViTDet backbone and
    the square canvas, which the JAX package lacks) keep their defaults."""
    got = dataclasses.asdict(vp.build_config(profile, small))
    assert got.pop("backbone") == "resnet50_fpn"
    assert got.pop("vit") == dataclasses.asdict(ViTConfig())
    assert got["transform"].pop("square_pad") == 0
    want = dataclasses.asdict(jax_vp.build_config(profile, small))
    assert got == want
    with pytest.raises(SystemExit):
        vp.build_config("bogus", small)


def test_jax_tool_imports_no_jax_at_module_level():
    script = ("import sys\nsys.modules['jax'] = None\nsys.modules['flax'] = None\n"
              "import tools.validate_parity as vp\nvp.build_config('fast', True)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_reference_csv_rows_as_the_jax_tool(tmp_path):
    perf = np.asarray([[10.0, 20, 30, 40],    # single
                       [11.0, 21, 31, 41],    # product max
                       [12.0, 22, 32, 42],    # avg desc
                       [13.0, 23, 33, 43]])   # aggr desc
    path = tmp_path / "r.csv"
    np.savetxt(path, perf, fmt="%02.2f", delimiter="\t")
    got = vp.load_reference_csv(str(path))
    assert got == jax_vp.load_reference_csv(str(path))
    assert got == {"top1_single": 0.1, "top1_avg_desc": 0.12, "top1_aggr_desc": 0.13}


def _res(a, b, c):
    return {"top1_single": a, "top1_avg_desc": b, "top1_aggr_desc": c}


@pytest.mark.parametrize("results,base", [
    ({"exact": _res(0.5, 0.6, 0.7), "serving": _res(0.5, 0.6, 0.7)}, "exact"),
    ({"exact": _res(0.5, 0.6, 0.7), "serving": _res(0.504, 0.61, 0.7),
      "fast": _res(0.49, 0.6, 0.695)}, "exact"),
    ({"reference": _res(0.5, 0.5, 0.5), "exact": _res(0.5, 0.5, 0.506)}, "reference"),
])
def test_check_gate_as_the_jax_tool(results, base):
    got, want = [], []
    verdict = vp.check_gate(results, base, got)
    assert verdict == jax_vp.check_gate(results, base, want)
    assert got == want and len(got) == 3 * (len(results) - 1)
    assert verdict == all("PASS" in line for line in got)


def test_synthetic_rehearsal_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--synthetic --small`` on the CPU (the 96x128 canvas of the port's
    CPU tests patched into the profiles' configs) with a reference CSV in
    the torch layout: a PARITY_JSON line with every profile, the gate
    lines, exit 0 or 1.  No accuracy is asserted: with random weights the
    two profiles' detections differ (see tests/test_validate_parity_tool.py)."""
    real = vp.build_config
    monkeypatch.setattr(vp, "build_config", lambda profile, small: dataclasses.replace(
        real(profile, small), transform=Canvas96x128(min_size=96, max_size=128)))
    ref_csv = tmp_path / "ref.csv"
    np.savetxt(ref_csv, np.full((4, 4), 50.0), fmt="%02.2f", delimiter="\t")
    rc = vp.main(["--synthetic", "--small", "--profiles", "exact", "serving",
                  "--reference_csv", str(ref_csv), "--device", "cpu"])
    out = capsys.readouterr().out
    [line] = [ln for ln in out.splitlines() if ln.startswith("PARITY_JSON ")]
    payload = json.loads(line[len("PARITY_JSON "):])
    assert set(payload) == {"exact", "serving", "reference"}
    for prof in payload.values():
        assert set(prof) == {"top1_single", "top1_avg_desc", "top1_aggr_desc"}
        assert all(0.0 <= v <= 1.0 for v in prof.values())
    assert payload["reference"]["top1_single"] == 0.5
    assert "serving vs exact top1_single: delta" in out
    assert "exact vs reference top1_single: delta" in out
    assert rc in (0, 1)


def test_orbax_directory_raises_with_the_converter(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        vp.main(["--root", str(tmp_path), "--test_annots", str(tmp_path / "t.json"),
                 "--ckpt", str(tmp_path), "--profiles", "exact", "--device", "cpu"])
