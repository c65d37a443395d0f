"""SEAM Match R-CNN on PyTorch and CUDA (NVIDIA Hopper).

A port of ``seam_match_rcnn_tpu`` (JAX/Flax/Pallas), which stays the
reference.  The module names mirror the JAX package: ``models/``, ``ops/``,
``eval/``, ``ckpt/`` and ``serving.py``.  The four Pallas kernels of the
serving path are CUDA C++ kernels under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use (``ops/native.py``); each has a plain PyTorch
version beside its wrapper, which the wrapper runs for CPU tensors.

This package imports ``torch`` and never ``jax`` (nor ``cv2``).
"""

__version__ = "0.1.0"
