"""Rank mesh — the port of ``h2o3_tpu/parallel/mesh.py``, H2O's "cloud".

In the reference every node gossips heartbeats until all agree on the
member list (``water/Paxos.java``) and the cloud is then locked. The JAX
package's cloud is a ``jax.sharding.Mesh`` over ``jax.devices()``; the
port's is a :class:`Mesh`: an ordered tuple of ``torch.distributed`` ranks
(one process a rank, each on its own device) and the process group their
collectives run over, the WORLD group or one made by ``new_group``. A
process that never called :func:`~h2o3_tpu_torch.parallel.distributed.
init_distributed` has a mesh of one rank and no group: every collective is
the identity there.

Frames are cut into row blocks along the mesh's one axis, ``"rows"``: rank
i of a mesh of W ranks holds rows [i·P/W, (i+1)·P/W) of a frame whose
padded length is P (:func:`row_sharding`), as H2O chunks rows across nodes.

Resolution is two-level, as in the JAX package: the process-global mesh
(:func:`global_mesh`) covers every rank and owns frame layout (padded
lengths are taken against it); a context-bound mesh (:func:`bind_mesh`)
scopes :func:`get_mesh` to the current thread or task through a
contextvar, so two builds on two threads each resolve their own mesh.
:func:`slice_meshes` carves the global mesh into disjoint rank blocks, each
with a process group of its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

import torch

# Name of the data-parallel (row) axis: every row-blocked tensor is cut
# along it, and map_reduce's all_reduce runs over it.
ROWS = "rows"


class Mesh:
    """An ordered set of ranks and the process group of their collectives
    (None for a mesh of one process that never joined a cloud, or for a
    mesh described without a live group)."""

    axis_names = (ROWS,)

    def __init__(self, ranks, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        if not self.ranks:
            raise ValueError("a mesh needs at least one rank")
        self.group = group

    @property
    def shape(self) -> dict:
        return {ROWS: len(self.ranks)}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)

    def __repr__(self) -> str:
        return f"Mesh(ranks={self.ranks})"


class MeshUnsupported(NotImplementedError):
    """An operation that is not rank-aware yet, asked for under a mesh of
    more than one rank: computing it on this rank's rows alone would be a
    silently wrong answer, so it raises by name (ROADMAP queue A lists
    each such operation)."""


def refuse_on_mesh(what: str) -> None:
    """Raise :class:`MeshUnsupported` for ``what`` when the global mesh
    holds more than one rank; nothing on one rank."""
    n = num_global_devices()
    if n > 1:
        raise MeshUnsupported(
            f"{what} is not rank-aware yet: under a mesh of {n} ranks it "
            "would compute on this rank's rows alone")


_lock = threading.Lock()
_mesh: Mesh | None = None
#: the group of each rank block made so far: every rank must call
#: ``new_group`` for every block in the same order, ranks outside the block
#: included, so a block's group is made once and reused
_groups: dict[tuple, object] = {}

# Context-bound mesh: set by bind_mesh()/mesh_context(), read by get_mesh().
_bound: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "h2o3_torch_bound_mesh", default=None)

# Set (with the binding) by scheduler leases: the mesh a leased build's
# artifacts are re-homed onto at train() exit; None for a plain binding.
_rehome_to: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "h2o3_torch_rehome_to", default=None)


def _world():
    """(rank count, WORLD group) of the live cloud, or (1, None)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.group.WORLD
    return 1, None


def _default_mesh() -> Mesh:
    n, group = _world()
    return Mesh(range(n), group)


def _check_rows_axis(mesh) -> None:
    if not isinstance(mesh, Mesh) or ROWS not in mesh.axis_names:
        raise ValueError(f"mesh must be a Mesh with a {ROWS!r} axis, "
                         f"got {mesh!r}")


def global_mesh() -> Mesh:
    """The process-global mesh over every rank of the cloud (created
    lazily), ignoring any context-bound mesh. Frame layout resolves
    against this one."""
    global _mesh
    with _lock:
        if _mesh is None:
            _mesh = _default_mesh()
        return _mesh


def get_mesh() -> Mesh:
    """The mesh for the current context: the bound mesh when one is active
    (see :func:`bind_mesh`), else the process-global mesh."""
    bound = _bound.get()
    if bound is not None:
        return bound
    return global_mesh()


def bound_mesh() -> Mesh | None:
    """The context-bound mesh, or None outside any binding."""
    return _bound.get()


def set_mesh(mesh: Mesh | None) -> None:
    """Install a mesh process-globally (``None`` resets to the lazy
    default over the live cloud). For a scoped install use
    :func:`bind_mesh` / :func:`mesh_context`."""
    global _mesh
    if mesh is not None:
        _check_rows_axis(mesh)
    with _lock:
        _mesh = mesh
        if mesh is None:
            _groups.clear()


@contextlib.contextmanager
def bind_mesh(mesh: Mesh, rehome_models: bool = False,
              rehome_to: Mesh | None = None):
    """Bind ``mesh`` as this context's mesh: :func:`get_mesh` (and
    ``row_sharding``, ``map_reduce``, ``num_devices``) resolves to it inside
    the block, in this thread or task only. ``rehome_models=True`` also
    asks builders to move finished models onto ``rehome_to`` (default: the
    global mesh) — :func:`rehome_requested` / :func:`rehome_target`."""
    _check_rows_axis(mesh)
    token = _bound.set(mesh)
    target = (rehome_to if rehome_to is not None else global_mesh()) \
        if rehome_models else None
    token_r = _rehome_to.set(target)
    try:
        yield mesh
    finally:
        _rehome_to.reset(token_r)
        _bound.reset(token)


def rehome_requested() -> bool:
    """True when the active binding came from a scheduler lease."""
    return _rehome_to.get() is not None


def rehome_target() -> Mesh | None:
    """The mesh a leased build's artifacts re-home onto, or None."""
    return _rehome_to.get()


def mesh_context(mesh: Mesh):
    """Temporarily use ``mesh`` as the active mesh: an alias of
    :func:`bind_mesh` (per thread or task, never a global swap)."""
    return bind_mesh(mesh)


def num_devices() -> int:
    """Ranks along the row axis of the active mesh (H2O:
    ``H2O.CLOUD.size()``) — the bound mesh's size inside a binding."""
    return get_mesh().shape[ROWS]


def num_global_devices() -> int:
    """Ranks along the row axis of the process-global mesh, ignoring any
    bound mesh. Frame padding uses this, so a frame's padded length is one
    process-wide invariant."""
    return global_mesh().shape[ROWS]


def _group_of(ranks: tuple):
    """The process group of a rank block of the live cloud (made once, by
    every rank, in the order the blocks are first asked for), or None where
    no cloud is live."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    with _lock:
        if ranks not in _groups:
            _groups[ranks] = dist.new_group(list(ranks))
        return _groups[ranks]


def slice_meshes(k: int, base: Mesh | None = None) -> list[Mesh]:
    """Carve ``base`` (default: the global mesh) into ``k`` disjoint
    meshes of contiguous ranks, each with a process group of its own, so
    the collectives of one slice rendezvous only among its ranks. ``k`` is
    clamped to the largest divisor of the base rank count that is <= k, so
    every slice has the same size; ``k <= 1`` (or a one-rank base) returns
    ``[base]``. Every rank of the cloud must call this with the same
    arguments, since every rank takes part in making each group."""
    g = base if base is not None else global_mesh()
    n = g.size
    k = max(int(k), 1)
    while k > 1 and n % k:
        k -= 1
    if k <= 1 or n <= 1:
        return [g]
    per = n // k
    blocks = [g.ranks[i * per:(i + 1) * per] for i in range(k)]
    return [Mesh(b, _group_of(b)) for b in blocks]


def mesh_device_ids(mesh: Mesh) -> tuple[int, ...]:
    """Stable identity of a mesh's rank set (sorted ranks): cache keys and
    span attribution."""
    return tuple(sorted(mesh.ranks))


def this_rank() -> int:
    """This process's rank in the cloud (0 outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def row_sharding(nrows: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """This rank's [lo, hi) block of a column of ``nrows`` rows on the
    active mesh (or ``mesh``): block i of W equal parts of the padded
    length (:func:`~h2o3_tpu_torch.frame.vec.padded_len`), cut at
    ``nrows``. A mesh of one rank holds every row."""
    from h2o3_tpu_torch.frame.vec import padded_len
    m = mesh if mesh is not None else get_mesh()
    if m.size == 1:
        return 0, nrows
    me = this_rank()
    if me not in m.ranks:
        raise ValueError(f"rank {me} is not in {m!r}")
    per = padded_len(nrows) // m.size
    i = m.ranks.index(me)
    return min(i * per, nrows), min((i + 1) * per, nrows)


def replicated_sharding(nrows: int) -> tuple[int, int]:
    """The whole column, [0, nrows): what every rank holds of a replicated
    tensor."""
    return 0, nrows


def rehome(obj, device: torch.device | None = None, _depth: int = 0,
           _seen: dict | None = None):
    """Move every tensor reachable through ``obj`` onto ``device`` (default:
    this rank's device), in place where possible; returns the (possibly
    replaced) object. A model built under a bound mesh holds tensors on
    the device of that binding; re-homing lets cross-mesh consumers mix
    them. Depth- and cycle-limited; numpy arrays and scalars pass
    through."""
    if device is None:
        from h2o3_tpu_torch.parallel.distributed import local_device
        device = local_device()
    if _depth > 8 or obj is None or isinstance(obj, (str, bytes, int, float,
                                                     bool, type)):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == device else obj.to(device)
    if _seen is None:
        _seen = {}
    if id(obj) in _seen:
        return _seen[id(obj)]
    _seen[id(obj)] = obj
    if isinstance(obj, dict):
        for k, v in list(obj.items()):
            obj[k] = rehome(v, device, _depth + 1, _seen)
        return obj
    if isinstance(obj, list):
        for i, v in enumerate(obj):
            obj[i] = rehome(v, device, _depth + 1, _seen)
        return obj
    if isinstance(obj, tuple):
        new = type(obj)(*(rehome(v, device, _depth + 1, _seen) for v in obj)) \
            if hasattr(obj, "_fields") else \
            type(obj)(rehome(v, device, _depth + 1, _seen) for v in obj)
        _seen[id(obj)] = new
        return new
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        for k, v in list(vars(obj).items()):
            try:
                setattr(obj, k, rehome(v, device, _depth + 1, _seen))
            except AttributeError:   # read-only property or slots
                pass
        return obj
    return obj
