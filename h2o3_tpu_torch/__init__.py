"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for NVIDIA Hopper.

The JAX package ``h2o3_tpu`` is the reference; this package grows beside it
one slice at a time and never imports it. Entry points run on the CUDA card
unless the caller asks for the CPU, either per call (``device="cpu"``) or
for the whole process (:func:`set_device`). With no card and no such
request they raise: nothing moves to the CPU quietly.

So far: GBM (bernoulli, multinomial, gaussian, poisson, gamma, tweedie,
laplace, quantile and huber, with offsets), DRF and XGBoost (gbtree)
training and scoring, with row and column sampling; the level histograms
of tree growth, one call per level for all the class trees of a round, are
built by hand-written CUDA kernels (``csrc/hist.cu``, wrapped by
:mod:`h2o3_tpu_torch.ops.hist`). GLM (:mod:`h2o3_tpu_torch.models.glm`)
trains and scores every family of the JAX package (gaussian, binomial,
poisson, gamma, tweedie, negativebinomial, quasibinomial, multinomial and
ordinal) by IRLS on the dense design of
:class:`~h2o3_tpu_torch.models.data_info.DataInfo`, with elastic net,
lambda search, bounds, p-values and a matrix-free path for sparse frames
(:mod:`h2o3_tpu_torch.models.glm_sparse`); its Gram and Cholesky are
PyTorch calls, at full float32.
"""

from h2o3_tpu_torch.device import resolve_device, set_device

__all__ = ["resolve_device", "set_device"]
