"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for NVIDIA Hopper.

The JAX package ``h2o3_tpu`` is the reference; this package grows beside it
one slice at a time and never imports it. Entry points run on the CUDA card
unless the caller asks for the CPU, either per call (``device="cpu"``) or
for the whole process (:func:`set_device`). With no card and no such
request they raise: nothing moves to the CPU quietly.

This slice: binomial and gaussian GBM training and scoring, with the level
histograms of tree growth built by a hand-written CUDA kernel
(``csrc/hist.cu``, wrapped by :mod:`h2o3_tpu_torch.ops.hist`).
"""

from h2o3_tpu_torch.device import resolve_device, set_device

__all__ = ["resolve_device", "set_device"]
