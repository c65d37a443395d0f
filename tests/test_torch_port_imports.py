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
