"""SEAM Match R-CNN on PyTorch and CUDA (NVIDIA Hopper).

A port of ``seam_match_rcnn_tpu`` (JAX/Flax/Pallas), which stays the
reference.  The module names mirror the JAX package: ``models/``, ``ops/``,
``losses/``, ``train/``, ``eval/``, ``ckpt/``, ``utils/``, ``config.py`` and
``serving.py``.  The five Pallas kernels of the serving path and of phase-1
training are CUDA C++ kernels under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use (``ops/native.py``); each has a plain PyTorch
version beside its wrapper, which the wrapper runs for CPU tensors.

This package imports ``torch`` and nothing of ``jax``, ``cv2`` or the JAX
package; it keeps its own copies of the JAX package's jax-free modules.
"""

__version__ = "0.1.0"
