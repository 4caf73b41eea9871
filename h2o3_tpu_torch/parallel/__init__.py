"""The rank mesh and the multi-process cloud (``parallel/mesh.py``,
``parallel/distributed.py``) — the port of ``h2o3_tpu/parallel``."""

from h2o3_tpu_torch.parallel.mesh import (ROWS, Mesh, bind_mesh, get_mesh,
                                          global_mesh, mesh_context,
                                          num_devices, set_mesh,
                                          slice_meshes)

__all__ = ["ROWS", "Mesh", "bind_mesh", "get_mesh", "global_mesh",
           "mesh_context", "num_devices", "set_mesh", "slice_meshes"]
