"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for NVIDIA Hopper.

The JAX package ``h2o3_tpu`` is the reference; this package grows beside it
one slice at a time and never imports it. Entry points run on the CUDA card
unless the caller asks for the CPU, either per call (``device="cpu"``) or
for the whole process (:func:`set_device`). With no card and no such
request they raise: nothing moves to the CPU quietly.

So far: GBM (bernoulli, multinomial, gaussian, poisson, gamma, tweedie,
laplace, quantile and huber, with offsets), DRF, XGBoost (gbtree and
DART), the decision tree, uplift DRF and the isolation forests, training
and scoring, with row and column sampling, calibration, varimp and
TreeSHAP contributions (:mod:`h2o3_tpu_torch.genmodel.treeshap`, on the
card); the level histograms
of tree growth, one call per level for all the class trees of a round, are
built by hand-written CUDA kernels (``csrc/hist.cu``, wrapped by
:mod:`h2o3_tpu_torch.ops.hist`). GLM (:mod:`h2o3_tpu_torch.models.glm`)
trains and scores every family of the JAX package (gaussian, binomial,
poisson, gamma, tweedie, negativebinomial, quasibinomial, multinomial and
ordinal) by IRLS on the dense design of
:class:`~h2o3_tpu_torch.models.data_info.DataInfo`, with elastic net,
lambda search, bounds, p-values and a matrix-free path for sparse frames
(:mod:`h2o3_tpu_torch.models.glm_sparse`); its Gram and Cholesky are
PyTorch calls, at full float32. DeepLearning (the MLP and the autoencoder,
:mod:`h2o3_tpu_torch.models.deeplearning`), KMeans, PCA, SVD, GLRM and
NaiveBayes train and score with ordinary torch operations (autograd, the
optimizers' updates written out, matrix products, batched solves and
``index_add_``); eigendecompositions run on the host in float64.
The builders on GBM and GLM (ModelSelection and ANOVAGLM, GAM, RuleFit,
Infogram with ``fairness_metrics``) train the port's GBM, DRF and GLM;
IsotonicRegression, CoxPH, HGLM and PSVM are solvers of their own in
torch operations. Every supervised builder cross-validates (``nfolds``,
``fold_column``). TargetEncoder and Aggregator transform and reduce
frames; :mod:`h2o3_tpu_torch.explanation` explains models (partial
dependence, ICE, SHAP summaries, permutation importance) and
:mod:`h2o3_tpu_torch.sklearn_adapter` wraps the builders for
scikit-learn. The builders of the later slices are exported here.
"""

from h2o3_tpu_torch.device import resolve_device, set_device
from h2o3_tpu_torch.models.aggregator import Aggregator
from h2o3_tpu_torch.models.coxph import CoxPH
from h2o3_tpu_torch.models.gam import GAM
from h2o3_tpu_torch.models.hglm import HGLM
from h2o3_tpu_torch.models.infogram import Infogram, fairness_metrics
from h2o3_tpu_torch.models.isotonic import IsotonicRegression
from h2o3_tpu_torch.models.model_selection import ANOVAGLM, ModelSelection
from h2o3_tpu_torch.models.psvm import PSVM
from h2o3_tpu_torch.models.rulefit import RuleFit
from h2o3_tpu_torch.models.target_encoder import TargetEncoder

__all__ = ["ANOVAGLM", "GAM", "HGLM", "PSVM", "Aggregator", "CoxPH",
           "Infogram", "IsotonicRegression", "ModelSelection", "RuleFit",
           "TargetEncoder", "fairness_metrics", "resolve_device",
           "set_device"]
