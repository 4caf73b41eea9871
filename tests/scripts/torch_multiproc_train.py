"""Worker script of the port's multi-process cloud (tests/test_torch_cloud.py).

Run through ``python -m h2o3_tpu_torch.launch --fork N --device cpu ...``:
each rank joins the cloud, checks the mesh and its row block, runs the
JAX package's tests/scripts/multiproc_train.py scenario in the port (the
munging paths that gather and re-block, a GBM and a GLM trained across the
ranks), checks that operations which are not rank-aware raise by name, and
writes what it computed to ``<outdir>/rank<i>.json``; the parent test
holds the ranks to each other and to a one-rank fit. Floats are written as
JSON numbers, which keep float32 values exactly.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from h2o3_tpu_torch.frame.frame import Frame  # noqa: E402
from h2o3_tpu_torch.models.gbm import DRF, GBM  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM  # noqa: E402
from h2o3_tpu_torch.models.kmeans import KMeans  # noqa: E402
from h2o3_tpu_torch.models.xgboost import XGBoost  # noqa: E402
from h2o3_tpu_torch.ops import hist as H  # noqa: E402
from h2o3_tpu_torch.parallel import distributed as D  # noqa: E402
from h2o3_tpu_torch.parallel import mesh as M  # noqa: E402
from h2o3_tpu_torch.parallel.mesh import MeshUnsupported  # noqa: E402

outdir = sys.argv[1]
nproc = D.process_count()
rank = D.process_index()
assert nproc >= 2, nproc
assert M.num_global_devices() == nproc and M.get_mesh().group is not None

rng = np.random.default_rng(9)
n = 400
cols = {f"x{i}": rng.normal(size=n).astype(np.float32) for i in range(4)}
cols["y"] = np.array(["no", "yes"], dtype=object)[
    (rng.random(n) < 1 / (1 + np.exp(-2 * cols["x0"]))).astype(int)]
fr = Frame.from_arrays(cols)

# the frame really is cut into row blocks: this rank's on its device
lo, hi, total = fr.block
assert total == n == fr.nrows and fr.vec("x0").nrows == hi - lo < n
assert (lo, hi) == M.row_sharding(n)
np.testing.assert_array_equal(fr.vec("x0").data.numpy(), cols["x0"][lo:hi])

# munge paths gather and re-block (split_frame, sort, fetch)
tr, te = fr.split_frame(ratios=[0.75], seed=4)
assert tr.nrows + te.nrows == n and tr.block is not None
srt = fr.sort("x0")
x0s = D.fetch(srt.vec("x0").data)[:n]
assert (np.diff(x0s) >= 0).all()

H.mesh_level_histograms.all_reduces = 0
H.mesh_node_totals.all_reduces = 0
gbm = GBM(ntrees=3, max_depth=3, nbins=16, seed=2).train(
    y="y", training_frame=fr)
hist_reduces = (H.mesh_level_histograms.all_reduces,
                H.mesh_node_totals.all_reduces)
glm = GLM(family="binomial", lambda_=1e-3, seed=2).train(
    y="y", training_frame=fr)
pred = D.fetch(gbm.predict(fr).vec("pyes").data)[:n]
glm_pred = D.fetch(glm.predict(fr).vec("pyes").data)[:n]

# operations this slice has not made rank-aware raise by name
refused = {}
for name, op in (
        ("group_by", lambda: fr.group_by("y")),
        ("vec_arithmetic", lambda: fr.vec("x0") + 1.0),
        ("drf", lambda: DRF(ntrees=2, max_depth=2).train(
            y="y", training_frame=fr)),
        ("kmeans", lambda: KMeans(k=2).train(x=["x0", "x1"],
                                             training_frame=fr)),
        ("gbm_nfolds", lambda: GBM(ntrees=2, nfolds=2).train(
            y="y", training_frame=fr)),
        ("xgboost_dart", lambda: XGBoost(ntrees=2, booster="dart").train(
            y="y", training_frame=fr))):
    try:
        op()
        refused[name] = None
    except MeshUnsupported as e:
        refused[name] = str(e)

# slices: contiguous rank blocks, each with a group of its own
slices = M.slice_meshes(nproc)
assert [s.ranks for s in slices] == [(r,) for r in range(nproc)]
with M.bind_mesh(slices[rank]):
    assert M.num_devices() == 1 and M.num_global_devices() == nproc

trees = [{f: getattr(t, f).tolist() for f in
          ("feat", "thresh_bin", "thresh_val", "na_left", "is_split", "leaf")}
         for t in gbm.output["trees"]]
out = dict(
    rank=rank, world=nproc, backend=D.backend(), block=[lo, hi],
    trees=trees, pred=[float(p) for p in pred],
    gbm_logloss=float(gbm.training_metrics.logloss),
    gbm_auc=float(gbm.training_metrics.auc),
    f0=float(gbm.output["f0"]),
    glm_logloss=float(glm.training_metrics.logloss),
    glm_coef=[float(c) for c in np.asarray(glm.output["coef"])],
    glm_deviance=float(glm.output["residual_deviance"]),
    glm_beta=[float(b) for b in glm.output["beta"].tolist()],
    glm_iterations=int(glm.output["iterations"]),
    glm_pred=[float(p) for p in glm_pred],
    effective_nobs=gbm.output["effective_nobs"],
    hist_reduces=list(hist_reduces), refused=refused,
)
os.makedirs(outdir, exist_ok=True)
# written whole, then renamed into place: the parent reads it once it exists
path = os.path.join(outdir, f"rank{rank}.json")
with open(path + ".tmp", "w") as f:
    json.dump(out, f)
os.replace(path + ".tmp", path)
D.barrier("done")
print(f"rank {rank} OK", flush=True)
