"""REST API (V3 schema surface) + thin Python client — the port of
``h2o3_tpu/api/``.

Reference: ``water/api/RequestServer.java`` (~150 routes), ``water/api/Schema``
+ ``schemas3/`` (126 classes), served by Jetty (``h2o-webserver-iface``).
Here: a stdlib threaded HTTP server (the REST plane is control-only — all data
compute stays on the card behind the estimator API) with the JAX package's
route table, the routes the h2o-py client actually uses.
"""

from h2o3_tpu_torch.api.client import H2OClient
from h2o3_tpu_torch.api.server import H2OServer, start_server

__all__ = ["H2OServer", "start_server", "H2OClient"]
