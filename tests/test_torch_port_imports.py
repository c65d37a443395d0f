"""The port imports neither jax, cv2 nor anything of the JAX package
(``seam_match_rcnn_tpu``, not even its jax-free modules): every module of
seam_match_rcnn_tpu_torch, and chip_smoke, import in a fresh interpreter in
which all three are blocked."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
sys.modules["seam_match_rcnn_tpu"] = None
import seam_match_rcnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "seam_match_rcnn_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_cv2():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the package was imported


def test_parallel_layer_imports_without_jax_or_cv2():
    """The distributed layer and the modules built on it import with jax, cv2
    and the JAX package blocked, and joining no process group on import."""
    script = _SCRIPT.replace('for name in names + ["chip_smoke"]:', 'for name in ('
                             '"seam_match_rcnn_tpu_torch.parallel.collectives", '
                             '"seam_match_rcnn_tpu_torch.parallel.mesh", '
                             '"seam_match_rcnn_tpu_torch.train.steps", '
                             '"seam_match_rcnn_tpu_torch.cli.train_matchrcnn"):')
    assert script != _SCRIPT
    script += ("import torch.distributed as dist\n"
               "assert not dist.is_initialized()\n"
               "assert 'seam_match_rcnn_tpu_torch.parallel.mesh' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_ablation_and_utils_modules_import_without_jax_cv2_or_matplotlib():
    """``utils.profiling``, ``utils.visualize`` (matplotlib only inside its
    plotting functions), the steps, the engine, the model and chip_smoke
    import with jax, cv2, the JAX package and matplotlib blocked."""
    script = _SCRIPT.replace('sys.modules["cv2"] = None',
                             'sys.modules["cv2"] = None\nsys.modules["matplotlib"] = None')
    script = script.replace('for name in names + ["chip_smoke"]:', 'for name in ('
                            '"seam_match_rcnn_tpu_torch.utils.profiling", '
                            '"seam_match_rcnn_tpu_torch.utils.visualize", '
                            '"seam_match_rcnn_tpu_torch.train.steps", '
                            '"seam_match_rcnn_tpu_torch.train.engine", '
                            '"seam_match_rcnn_tpu_torch.models.matchrcnn", "chip_smoke"):')
    assert script.count("matplotlib") == 1 and "chip_smoke\"):" in script
    script += ("assert not [m for m in sys.modules if m.startswith('matplotlib') "
               "and sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
