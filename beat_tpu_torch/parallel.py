"""
Chain and target sharding over ranks (port of ``beat_tpu/parallel.py``).

The JAX package shards inside one process: Markov chains are rows of
device arrays split over a ``chains`` mesh axis, and XLA inserts the
collectives.  The port runs one process per GPU under
``torch.distributed`` (``torchrun --nproc_per_node N``): the ranks are
named by a ``DeviceMesh`` with the axes ``("chains", "targets")``, each
rank holds its block of chains (and of GF targets), and the collectives
are explicit:

* :func:`all_gather` puts the blocks of an axis back together (the
  samplers gather the population after every SMC stage or PT segment);
* :func:`all_reduce_sum` sums partial log-likelihoods over the
  ``targets`` axis (:func:`sharded_gf_logp`, the HBM-budget path for a
  kinematic library larger than one card).

The helpers that JAX spells as shardings — :func:`chain_sharding`,
:func:`target_sharding`, :func:`replicated` — return functions that take
a whole tensor and give this rank's block of it.  Without a mesh
(``mesh=None``) every helper is the identity of a one-process run.

Backends: ``nccl`` for ranks on separate cards, ``gloo`` on the CPU (and
for several ranks sharing one card, which NCCL refuses).  A gloo
collective of CUDA tensors goes through host copies made here: gloo's
CUDA support differs from op to op.
"""

from __future__ import annotations

import logging
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

logger = logging.getLogger("beat_tpu_torch.parallel")

CHAIN_AXIS = "chains"
TARGET_AXIS = "targets"

#: how long a collective waits for a lost rank before it raises
DEFAULT_TIMEOUT = timedelta(minutes=5)


# ---------------------------------------------------------------------------
# the process group (the reference's MPI tier, ``beat/sampler/distributed.py``)
# ---------------------------------------------------------------------------


def _int_env(name: str):
    val = os.environ.get(name)
    return int(val) if val is not None else None


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, local_rank: int | None = None, *,
                     device: str = "cuda", backend: str | None = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> int:
    """
    Join the process group; returns this process's rank.

    Arguments left out come from torchrun's environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and, through ``init_method="env://"``,
    ``MASTER_ADDR``/``MASTER_PORT`` (the counterpart of the JAX package's
    ``JAX_COORDINATOR_ADDRESS`` and the like).  On ``device="cuda"`` the
    rank's card ``cuda:<local_rank>`` becomes the current device before
    any tensor exists, so ``device.resolve("cuda")`` names it; the backend
    is ``nccl`` unless another is given (``gloo`` lets several ranks share
    one card).  On ``device="cpu"`` it is ``gloo``.  A collective that
    waits longer than ``timeout`` for a lost rank raises instead of
    hanging.  Call once per process.
    """
    if dist.is_initialized():
        raise RuntimeError("the process group is initialized already")
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} (cuda or cpu)")
    rank = _int_env("RANK") if rank is None else rank
    world_size = _int_env("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs rank and world_size (or RANK and "
                         "WORLD_SIZE in the environment, as torchrun sets them)")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if dev_type == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU (gloo)")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') but CUDA is not available")
        n_cards = torch.cuda.device_count()
        if local_rank is None:
            local_rank = _int_env("LOCAL_RANK")
        if local_rank is None:
            local_rank = rank % n_cards
        if not 0 <= local_rank < n_cards:
            raise ValueError(f"local rank {local_rank} but only {n_cards} card(s)")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    logger.info("Distributed runtime: rank %i/%i, backend %s%s", rank, world_size, backend,
                f", cuda:{local_rank}" if dev_type == "cuda" else "")
    return rank


def n_ranks() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_io_process() -> bool:
    """True on the process that writes checkpoints and traces: rank 0,
    and any process without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def _mesh(shape: tuple, names: tuple, what: str):
    available = n_ranks()
    if available < math.prod(shape):
        backend = dist.get_backend() if dist.is_initialized() else "none"
        raise ValueError(f"requested a {what} mesh but only {available} device(s) are "
                         f"available (backend={backend})")
    if not dist.is_initialized():
        raise ValueError("no process group: call init_distributed() before building a mesh")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh names the groups; "cpu" keeps DeviceMesh from choosing a
    # card for gloo ranks, which may share one
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_chain_mesh(n_devices: int | None = None):
    """1-D ``chains`` mesh over all ranks (or the first ``n_devices``).
    Raises when fewer ranks exist than requested: a silent one-rank mesh
    would fake a multi-GPU result."""
    n = n_ranks() if n_devices is None else int(n_devices)
    return _mesh((n,), (CHAIN_AXIS,), f"{n}-device")


def make_gf_mesh(n_chain_devices: int, n_target_devices: int):
    """2-D ``(chains, targets)`` mesh: data-parallel chains × model-
    parallel GF targets.  The targets axis is the HBM-budget path: a
    kinematic library larger than one card is split along its targets,
    each rank stacks its block and the partial log-likelihoods are summed
    over the axis (:func:`sharded_gf_logp`)."""
    return _mesh((n_chain_devices, n_target_devices), (CHAIN_AXIS, TARGET_AXIS),
                 f"{n_chain_devices}x{n_target_devices}")


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh or without the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_block(mesh, axis: str, n: int) -> slice:
    """This rank's block of ``n`` items split evenly along ``axis``."""
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} items do not split evenly over {k} ranks of '{axis}'")
    i = axis_index(mesh, axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def chain_block(mesh, n_chains: int) -> slice:
    """The global rows of the chains this rank holds."""
    return axis_block(mesh, CHAIN_AXIS, n_chains)


# ---------------------------------------------------------------------------
# shardings: functions from a whole tensor to this rank's block
# ---------------------------------------------------------------------------


def _take(x, mesh, axis: str, dim: int):
    if hasattr(x, "target_block"):     # a GF library: its targets are its leading axis
        if (axis, dim) != (TARGET_AXIS, 0):
            raise ValueError("a GF library splits along its targets (axis 0) only")
        return x.target_block(axis_block(mesh, axis, x.ntargets))
    block = axis_block(mesh, axis, x.shape[dim])
    return x.narrow(dim, block.start, block.stop - block.start)


def chain_sharding(mesh):
    """Rows (chains) split over the mesh's ``chains`` axis: returns
    ``x ↦ this rank's rows of x``."""
    return lambda x: _take(x, mesh, CHAIN_AXIS, 0)


def target_sharding(mesh, axis: int = 0):
    """Dimension ``axis`` (default the leading one, targets/stations)
    split over the ``targets`` axis: returns ``x ↦ this rank's block``.
    A :class:`~beat_tpu_torch.ffi.gflibrary.SeismicGFLibrary` gives the
    library of its block of targets (``target_block``)."""
    return lambda x: _take(x, mesh, TARGET_AXIS, axis)


def replicated(mesh):
    """Every rank holds the whole tensor: the identity."""
    return lambda x: x


def shard_chain_state(state, mesh):
    """This rank's rows of every leaf of ``state`` (a named tuple such as
    :class:`~beat_tpu_torch.samplers.metropolis.MetropolisState`) that has
    a leading chains axis; scalars and other leaves stay whole."""
    take = chain_sharding(mesh)
    n = state.q.shape[0]
    return type(state)(*[take(leaf) if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1
                         and leaf.shape[0] == n else leaf for leaf in state])


def pad_chains(n_chains: int, n_devices: int) -> int:
    """Round the chain count up to a multiple of the device count."""
    return ((n_chains + n_devices - 1) // n_devices) * n_devices


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, mesh, axis: str = CHAIN_AXIS, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of every rank along ``axis``, concatenated
    along ``dim`` in the axis's order: the whole tensor, on every rank.
    Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    group = mesh.get_group(axis)
    staged = _staged(x, group)
    local = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(local) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, local, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def all_reduce_sum(x: torch.Tensor, mesh, axis: str = TARGET_AXIS) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, on every rank (a new
    tensor).  Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    group = mesh.get_group(axis)
    staged = _staged(x, group)
    out = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def _local_block(x, mesh, spec):
    """``x``'s block under ``spec``: one mesh-axis name (or None) per
    leading dimension, as a ``PartitionSpec``; ``None`` leaves ``x`` as
    it is (already local, or replicated)."""
    if spec is None:
        return x
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _take(x, mesh, axis, dim)
    return x


def sharded_gf_logp(mesh, partial_llk, in_specs=None):
    """
    Wrap a per-target-block partial log-likelihood for the ``(chains,
    targets)`` mesh.

    ``partial_llk(*local_args) -> (local_chains,)`` computes the llk
    contribution of this rank's target block for its chain block; the
    wrapper sums it over the ``targets`` axis, so every rank holds the
    full llk of its chains.  ``in_specs`` gives one spec per argument:
    ``("chains",)`` for chain-batched parameters, ``("targets",)`` or
    ``("chains", "targets")`` for per-target arrays, ``()`` or ``None``
    for what every rank holds whole, or holds as its block already (a
    library cut by :func:`target_sharding`).  Without ``in_specs`` the
    arguments are this rank's blocks as they come.
    """
    def sharded(*args):
        if in_specs is not None:
            args = tuple(_local_block(a, mesh, s) for a, s in zip(args, in_specs))
        return all_reduce_sum(partial_llk(*args), mesh, TARGET_AXIS)

    return sharded
