"""Multi-process runtime — the port of ``h2o3_tpu/parallel/distributed.py``.

Reference: a multi-node H2O cloud forms by heartbeat gossip until every
JVM agrees on the member list (``water/H2O.java`` ``waitForCloudSize``).
The port's cloud is a ``torch.distributed`` process group: every process
runs the same program, is one rank on one device, and joins through a
``TCPStore`` at the coordinator's address (blocking until all
``num_processes`` have connected, the reference's ``waitForCloudSize``).
The global mesh (``parallel/mesh.py``) then spans every rank; frames made
afterwards keep each rank's row block on its device, and builders reduce
their partial sums with explicit collectives (``ops/map_reduce.py``).

**The backend, one rule:** ``nccl`` when every rank has a card of its own;
``gloo`` on the CPU and where ranks share a card (NCCL refuses two ranks
on one device). The ranks learn each other's (host, device) through the
store, so they all pick the same backend.

**Gloo and CUDA tensors.** Gloo's all_reduce and broadcast take CUDA
tensors; its all_gather does not. :func:`all_gather_blocks` copies through
pinned host memory under gloo by that rule (``_GLOO_CUDA``), never by
catching an error.
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch

#: the collectives gloo runs on CUDA tensors; the others go through pinned
#: host memory under gloo
_GLOO_CUDA = frozenset({"all_reduce", "broadcast"})

_initialized = False
#: the coordinator arguments the live cloud was joined with: a second
#: init_distributed with other arguments raises instead of silently
#: keeping the first cloud
_init_args: tuple | None = None
_store = None
#: every rank's "host/device", in rank order, as the ranks told the store
_placements: list[str] = []
_device: torch.device | None = None
_backend: str | None = None
#: how long a rank waits for the others to join
_JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def _parse_address(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got "
                         f"{address!r}")
    return host, int(port)


def _rank_device(process_id: int, local_device_ids, device) -> torch.device:
    """This rank's device: ``device`` where the caller names one (``"cpu"``
    for a CPU cloud), else ``cuda:local_device_ids[0]``, else
    ``cuda:process_id % device_count``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to "
            "init_distributed for a CPU cloud")
    if local_device_ids is not None:
        return torch.device("cuda", int(list(local_device_ids)[0]))
    return torch.device("cuda", process_id % torch.cuda.device_count())


def choose_backend(placements: list[str]) -> str:
    """The backend for ranks at ``placements`` ("host/device" each):
    ``nccl`` when every rank has a card of its own, ``gloo`` on the CPU or
    where two ranks share a card."""
    on_cards = all("/cuda" in p for p in placements)
    return "nccl" if on_cards and len(set(placements)) == len(placements) \
        else "gloo"


def _join(address: str, num_processes: int, process_id: int,
          dev: torch.device) -> tuple:
    """Connect to the coordinator's store (rank 0 hosts it), learn every
    rank's (host, device), pick the backend by :func:`choose_backend` and
    form the process group; blocks until every rank has joined. Returns
    (store, backend, placements)."""
    import torch.distributed as dist
    host, port = _parse_address(address)
    store = dist.TCPStore(host, port, num_processes,
                          is_master=process_id == 0, timeout=_JOIN_TIMEOUT)
    meta = dist.PrefixStore("h2o3/placement/", store)
    meta.set(str(process_id), f"{socket.gethostname()}/{dev}")
    places = [meta.get(str(r)).decode() for r in range(num_processes)]
    backend = choose_backend(places)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.PrefixStore("h2o3/pg/", store),
                            rank=process_id, world_size=num_processes,
                            timeout=_JOIN_TIMEOUT)
    return store, backend, places


def _leave() -> None:
    """Destroy the process group."""
    import torch.distributed as dist
    dist.destroy_process_group()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device=None) -> None:
    """Join (or form) a multi-process cloud and install the spanning mesh.

    Mirrors ``h2o.init(...)`` on a multi-node cluster: blocks until all
    ``num_processes`` processes have connected to the coordinator, then
    installs the global mesh over every rank and makes this rank's device
    the process default (:func:`h2o3_tpu_torch.set_device`). With no
    arguments this only resets the mesh. Joining again with the same
    arguments does nothing; other arguments raise, since a process cannot
    leave one cloud for another."""
    global _initialized, _init_args, _store, _device, _backend, _placements
    if coordinator_address is not None:
        args = (coordinator_address, num_processes, process_id,
                tuple(local_device_ids)
                if local_device_ids is not None else None,
                None if device is None else str(torch.device(device)))
        if _initialized:
            if args != _init_args:
                raise RuntimeError(
                    "init_distributed called twice with different "
                    f"coordinator args: already joined {_init_args!r}, "
                    f"requested {args!r}. A process cannot leave one cloud "
                    "for another; call shutdown_distributed() first.")
        else:
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed needs num_processes and "
                                 "process_id with a coordinator address")
            dev = _rank_device(int(process_id), local_device_ids, device)
            store, backend, places = _join(coordinator_address,
                                           int(num_processes),
                                           int(process_id), dev)
            from h2o3_tpu_torch.device import set_device
            set_device(dev)
            _store, _device, _backend = store, dev, backend
            _placements = places
            _initialized = True
            _init_args = args
    # (re)install the default mesh over the now-global rank set
    from h2o3_tpu_torch.parallel.mesh import set_mesh
    set_mesh(None)


def shutdown_distributed() -> None:
    """Leave the cloud. Idempotent: a second call (or a call in a process
    that never joined) does nothing."""
    global _initialized, _init_args, _store, _device, _backend, _placements
    if _initialized:
        _leave()
        _initialized = False
        _init_args = None
        _store = _device = _backend = None
        _placements = []
        from h2o3_tpu_torch.parallel.mesh import set_mesh
        set_mesh(None)


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def placements() -> list[str]:
    """Every rank's "host/device" in rank order (empty outside a cloud)."""
    return list(_placements)


def backend() -> str | None:
    """The live cloud's backend (``"nccl"`` or ``"gloo"``), or None."""
    return _backend


def local_device() -> torch.device:
    """This rank's device (the process default outside a cloud)."""
    if _device is not None:
        return _device
    from h2o3_tpu_torch.device import resolve_device
    return resolve_device()


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: NCCL only takes tensors on this
    rank's card."""
    if _backend == "nccl" and t.device != _device:
        return t.to(_device)
    return t


def _through_host(t: torch.Tensor, collective: str) -> bool:
    """Whether ``collective`` of this CUDA or CPU tensor goes through pinned
    host memory: under gloo, for a CUDA tensor, where gloo does not run the
    collective on the card."""
    return (t.device.type == "cuda" and _backend == "gloo"
            and collective not in _GLOO_CUDA)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (default: the active mesh's) and
    return it; the identity on a mesh of one rank."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    import torch.distributed as dist
    mesh = get_mesh()
    if group is None:
        if mesh.size == 1:
            return t
        group = mesh.group
    if _through_host(t, "all_reduce"):
        host = t.to("cpu").pin_memory()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        return t
    work = _on_backend(t)
    dist.all_reduce(work, group=group)
    if work is not t:
        t.copy_(work)
    return t


def all_gather_blocks(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's row block of ``t`` (blocks of unequal length allowed),
    concatenated in rank order, on ``t``'s device."""
    import torch.distributed as dist
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh.size == 1:
        return t
    group = mesh.group if group is None else group
    dev = t.device
    host = _through_host(t, "all_gather")
    work = t.to("cpu").pin_memory() if host else _on_backend(t)
    n = torch.tensor([work.shape[0]], dtype=torch.int64, device=work.device)
    sizes = [torch.zeros_like(n) for _ in range(mesh.size)]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    padded = torch.zeros((top,) + tuple(work.shape[1:]), dtype=work.dtype,
                         device=work.device)
    padded[:work.shape[0]] = work
    parts = [torch.empty_like(padded) for _ in range(mesh.size)]
    dist.all_gather(parts, padded, group=group)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return out.to(dev)


def all_gather_values(values: list[float]) -> list[list[float]]:
    """Every rank's list of floats (the same length on each), in rank order
    over the active mesh: a small host-side exchange."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh.size == 1:
        return [list(values)]
    t = torch.tensor(values, dtype=torch.float64)
    return all_gather_blocks(t[None]).tolist()


def common_seed(seed) -> int:
    """``seed`` where given (not -1 or None); else one seed drawn on rank 0
    and shared by every rank, so that a random choice made on each rank
    is the same choice."""
    if seed not in (-1, None):
        return int(seed)
    import random
    mine = random.getrandbits(52) if process_index() == 0 else 0
    return int(sum(v[0] for v in all_gather_values([float(mine)])))


def fetch(arr) -> np.ndarray:
    """Gather a row-blocked tensor to every rank as a host array.

    One process: the tensor on the host. A cloud: every rank's block,
    all-gathered under the dispatch retry budget (the reference's
    ``TaskGetKey`` fetch of remote chunks to the caller)."""
    if not isinstance(arr, torch.Tensor):
        return np.asarray(arr)
    if not is_multiprocess():
        return arr.detach().cpu().numpy()
    return _allgather(arr)


def _allgather(arr: torch.Tensor) -> np.ndarray:
    """The cross-rank gather of :func:`fetch`, under the dispatch retry
    budget: the one cross-rank dispatch outside the map_reduce sites. A
    retry re-enters the collective on this rank only, so absorption is
    sound for failures every rank sees and for faults injected before the
    dispatch on this rank."""
    from h2o3_tpu_torch.ops.map_reduce import retrying

    def _attempt():
        return all_gather_blocks(arr.detach()).cpu().numpy()

    return retrying("allgather", _attempt)


def barrier(name: str = "sync") -> None:
    """Cross-process sync point (reference: ``MRTask`` blocking
    ``doAll``)."""
    if is_multiprocess():
        import torch.distributed as dist
        if _backend == "nccl" and _device is not None:
            dist.barrier(device_ids=[_device.index])
        else:
            dist.barrier()
