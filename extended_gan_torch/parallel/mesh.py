"""The data axis (port of the data-parallel half of
``extended_gan_tpu/parallel/mesh.py``).

The JAX package shards each global batch over the ``data`` axis of a
device mesh and lets XLA insert the gradient psum. The port runs one
process a rank in a ``torch.distributed`` process group (NCCL between
cards, gloo on the CPU) and does the same by hand:

- :func:`initialize_distributed` joins the group a launcher (torchrun)
  describes in the environment, as ``jax.distributed.initialize`` does
  (JAX ``mesh.py:33-87``);
- :class:`DataAxis` is the group seen from one rank: its size, its rank,
  this rank's device, the contiguous rows of a global batch this rank
  takes (JAX's ``put_batch`` over a padded batch, ``:224-234``) and the
  collectives the trainer needs; :func:`pad_to_batch_multiple` pads a
  batch as JAX's does (``:297-321``);
- :func:`data_axis_for` resolves a driver's ``data_axis`` against the
  group (the JAX mesh's "needs K devices, have n", ``:108-112``).

Without a group the axis has size 1 and every collective is the identity:
the single-card path runs unchanged.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

# what torchrun sets for every rank; env:// needs the first four
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK")


def _multihost_env_configured(environ=None) -> bool:
    """Any sign that this process is one rank of a multi-process launch:
    torchrun's variables, or a SLURM or Open MPI launch of more than one
    task (JAX ``mesh.py:64-87``). A garbled count counts as a sign, so
    that :func:`initialize_distributed` raises on it."""
    environ = os.environ if environ is None else environ
    if any(environ.get(k) for k in LAUNCHER_VARS):
        return True
    for k in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(environ.get(k, "1")) > 1:
                return True
        except ValueError:
            return True
    return False


def launcher_rank(environ=None) -> tuple[int, int, int]:
    """(rank, world size, local rank) from a launcher's environment;
    raises on a partial or garbled one."""
    environ = os.environ if environ is None else environ
    missing = [k for k in LAUNCHER_VARS[:4] if not environ.get(k)]
    if missing:
        raise RuntimeError(
            f"partial launcher environment: {', '.join(missing)} not set "
            "(torchrun sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT "
            "for every rank)")
    try:
        rank, world = int(environ["RANK"]), int(environ["WORLD_SIZE"])
        local = int(environ.get("LOCAL_RANK", environ["RANK"]))
        int(environ["MASTER_PORT"])
    except ValueError as e:
        raise RuntimeError(f"garbled launcher environment: {e}") from e
    if not 0 <= rank < world or local < 0:
        raise RuntimeError(f"garbled launcher environment: RANK={rank}, "
                           f"WORLD_SIZE={world}, LOCAL_RANK={local}")
    return rank, world, local


def initialize_distributed(require: bool = False, *, device=None) -> bool:
    """Joins the process group the launcher's environment describes: NCCL
    when ``device`` is the card (the default), gloo for ``"cpu"``. Returns
    whether a group is up.

    Graceful only where that is benign: a group already initialised, and
    a bare single-process run when nothing asked for more. ``require=True``
    (the CLI's ``--multihost``) without a launcher environment raises, and
    so does a partial or garbled one whatever ``require`` says: carrying
    on alone would train every process on the whole duplicated stream."""
    if dist.is_initialized():
        return True
    if not _multihost_env_configured():
        if require:
            raise RuntimeError(
                "--multihost needs a launcher environment (torchrun sets "
                "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT); none is set")
        print("[mesh] single-process run (no launcher environment)")
        return False
    rank, world, local = launcher_rank()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = rank_device(local)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=world)
    return True


def rank_device(local_rank: int) -> torch.device:
    """``cuda:{local_rank}``; raises when this host has fewer cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_rank >= have:
        raise ValueError(f"data axis rank {local_rank} needs "
                         f"{local_rank + 1} cards on this host, have {have}")
    return torch.device("cuda", local_rank)


@dataclasses.dataclass
class DataAxis:
    """The data axis seen from one rank. ``group`` None is the axis of
    one, where every collective is the identity."""

    device: torch.device
    group: dist.ProcessGroup | None = None

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def parallel(self) -> bool:
        return self.size > 1

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the run's files."""
        return self.rank == 0

    # ------------------------------------------------------------ batches
    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``: the
        shard JAX's ``put_batch`` gives it of the batch padded to
        :meth:`padded_batch_size`, padding left out (so a rank may get
        none)."""
        per = math.ceil(n / self.size)
        return slice(min(n, self.rank * per), min(n, (self.rank + 1) * per))

    def padded_batch_size(self, batch_size: int) -> int:
        """Smallest multiple of the axis size >= ``batch_size``."""
        d = self.size
        return ((batch_size + d - 1) // d) * d

    # -------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sums ``t`` over the ranks, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """(size, *row.shape): every rank's ``row`` in rank order, the same
        on every rank (an all-reduce of one slot a rank: adding zeros is
        exact, and each rank combines the slots in the same order)."""
        slots = row.new_zeros((self.size,) + tuple(row.shape))
        slots[self.rank] = row
        return self.all_reduce(slots)

    def all_reduce_grads(self, params, extra: torch.Tensor) -> torch.Tensor:
        """Sums the gradients of ``params`` (those that have one: the same
        on every rank, which run the same graph) and ``extra`` over the
        ranks in ONE flat all-reduce, written back in place; returns the
        summed ``extra``."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [extra.reshape(-1).to(grads[0].dtype)
                            if grads else extra.reshape(-1)])
        self.all_reduce(flat)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return flat[at:].view_as(extra).to(extra.dtype)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.all_reduce(t).item() > 0)

    def broadcast_module(self, module: torch.nn.Module):
        """Rank 0's parameters and buffers on every rank, as DDP starts."""
        if self.group is None:
            return
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                dist.broadcast(t, src=src, group=self.group)


def local_batch_size(global_batch: int, axis: DataAxis) -> int:
    """A rank's share of ``global_batch``; raises unless it divides (JAX
    ``mesh.py:370-376``)."""
    if global_batch % axis.size:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {axis.size}")
    return global_batch // axis.size


def cross_replica_mean(t: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """The mean of ``t`` over the ranks (JAX ``mesh.py:365``)."""
    return axis.all_reduce(t.clone()) / axis.size


def pad_to_batch_multiple(*arrays: np.ndarray, batch_size: int):
    """``arrays`` padded on axis 0 with zeros to ``batch_size`` rows, and
    the sample mask (1 a real row, 0 a padded one; JAX
    ``mesh.py:303-321``)."""
    n = arrays[0].shape[0]
    if n > batch_size:
        raise ValueError(f"{n} rows do not fit a batch of {batch_size}")
    mask = np.zeros((batch_size,), np.float32)
    mask[:n] = 1.0
    padded = [a if n == batch_size else np.concatenate(
        [a, np.zeros((batch_size - n,) + a.shape[1:], a.dtype)])
        for a in arrays]
    return (*padded, mask)


def data_axis_for(data_axis: int | None, device=None) -> DataAxis:
    """The driver's ``data_axis`` against the process group: with a group
    up, ``None`` is every rank of it and any other size must equal it;
    without one, ``None`` and 1 are the axis of one and a larger size
    raises (the CLI starts the processes, or torchrun does). Under NCCL a
    rank's device is ``cuda:{LOCAL_RANK}``; ``device`` overrides it (the
    gloo ranks of a test, or two ranks sharing one card)."""
    if data_axis is not None and data_axis < 1:
        raise ValueError(f"data_axis must be >= 1, got {data_axis}")
    if not dist.is_initialized():
        if (data_axis or 1) > 1:
            raise RuntimeError(
                f"data_axis={data_axis} needs {data_axis} processes in a "
                "process group: `python -m extended_gan_torch.gat ... "
                f"--data-axis {data_axis}` starts them, or run under "
                "torchrun with --multihost")
        return DataAxis(resolve_device(device))
    world = dist.get_world_size()
    if data_axis is not None and data_axis != world:
        raise ValueError(f"data_axis={data_axis}, but the process group has "
                         f"{world} ranks")
    if device is None and dist.get_backend() == "nccl":
        dev = rank_device(int(os.environ.get("LOCAL_RANK",
                                             dist.get_rank())))
    else:
        dev = resolve_device(device)
    return DataAxis(dev, dist.group.WORLD if world > 1 else None)
