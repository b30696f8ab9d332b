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
  takes (JAX's ``put_batch`` over a padded batch, ``:224-234``), of a
  K-stacked group and of a resident program, the draws over the global
  batch that every rank makes alike (the channel dropout's masks) and
  the collectives the trainer needs; :func:`pad_to_batch_multiple` pads
  a batch as JAX's does (``:297-321``);
- :func:`data_axis_for` resolves a driver's ``data_axis`` against the
  group (the JAX mesh's "needs K devices, have n", ``:108-112``).

Without a group the axis has size 1 and every collective is the identity:
the single-card path runs unchanged.
"""

from __future__ import annotations

import contextlib
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


# what NCCL needs set before its process group starts for its collectives
# to be captured into CUDA graphs (torch's notes on CUDA graphs with
# DistributedDataParallel): asynchronous error handling off (the older
# name, NCCL_ASYNC_ERROR_HANDLING, only draws a deprecation warning)
NCCL_CAPTURE_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"}


def prepare_nccl_capture():
    """Sets :data:`NCCL_CAPTURE_ENV` in this process, before an NCCL group
    starts (``--megastep`` and ``--resident`` capture its collectives)."""
    os.environ.update(NCCL_CAPTURE_ENV)


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
        prepare_nccl_capture()
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


def _all_gather(out, t, group):
    """Every rank's ``t`` into ``out``, in rank order (expert parallelism's
    exchange, FSDP's gather of the shards)."""
    # torch >= 2.13 names them ``*_single``; older releases ``*_tensor``
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t, group=group)


def _reduce_scatter(out, t, group):
    """The sum over the ranks of ``t``, rank r keeping chunk r in ``out``."""
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, t, group=group)


@dataclasses.dataclass
class DataAxis:
    """The data axis seen from one rank. ``group`` None is the axis of
    one, where every collective is the identity."""

    device: torch.device
    group: dist.ProcessGroup | None = None
    # (rows of the global batch a draw covers, this rank's slices of
    # them), set by :meth:`global_batch` around a train step
    _draw: tuple | None = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

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

    def shard(self, t, dim: int = 0):
        """This rank's rows (:meth:`rows`) of ``t`` along ``dim``: of a
        global batch (dim 0), of a K-stacked group (dim 1) or of a resident
        program's (K, B) starts (dim -1)."""
        if not self.parallel:
            return t
        rows = self.rows(t.shape[dim])
        index = [slice(None)] * t.ndim
        index[dim] = rows
        return t[tuple(index)]

    @contextlib.contextmanager
    def global_batch(self, n: int, copies: int = 1):
        """Within: this rank's tensors are its rows of a global batch of
        ``n`` (``copies`` of them stacked: the discriminators' doubled
        [real; fake] batch), for :meth:`draw_rows`."""
        rows = self.rows(n)
        prev = self._draw
        self._draw = (copies * n, [slice(rows.start + c * n, rows.stop + c * n)
                                   for c in range(copies)])
        try:
            yield
        finally:
            self._draw = prev

    def draw_rows(self, draw):
        """``draw(N)`` is a draw of N rows from a generator that every rank
        seeded alike; returns this rank's rows of the draw over the global
        batch of :meth:`global_batch`, so the ranks together apply the
        masks one process applies to the whole batch, and every rank's
        generator advances alike (a rank with no rows draws too). None on
        an axis of one: the caller draws for its own batch. Outside
        :meth:`global_batch` on a wider axis it raises: a draw of this
        rank's rows alone would differ from one process's."""
        if not self.parallel:
            return None
        if self._draw is None:
            raise RuntimeError("a random draw under a data axis needs "
                               "DataAxis.global_batch around the step")
        n, slices = self._draw
        full = draw(n)
        return full[slices[0]] if len(slices) == 1 else torch.cat(
            [full[s] for s in slices])

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

    def sizes(self, n: int) -> list[int]:
        """Every rank's ``n`` (a count of rows or tokens), in rank order.
        Inside a CUDA graph's capture, where no value can reach the host,
        every rank's is taken as this one's: the graph paths feed every
        rank an equal share (a padded group, a resident batch that divides
        by the axis)."""
        if not self.parallel:
            return [n]
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            return [n] * self.size
        t = torch.tensor([n], dtype=torch.float64, device=self.device)
        return [int(v) for v in self.gather_rows(t).flatten().tolist()]

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

    def check_capturable(self):
        """Raises unless this axis's collectives can be captured into a
        CUDA graph: gloo's run on the host, so a data axis over gloo on the
        card cannot run ``--megastep`` or ``--resident``. NCCL's run on the
        card, and an axis of one has none."""
        if self.parallel and dist.get_backend(self.group) != "nccl":
            raise RuntimeError(
                f"--megastep and --resident on the card capture the data "
                f"axis's collectives into CUDA graphs, which needs NCCL; "
                f"this process group runs {dist.get_backend(self.group)}, "
                "whose collectives run on the host (start one rank a card "
                "over NCCL: --data-axis N without --device cpu, or torchrun)")

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.all_reduce(t).item() > 0)

    def check_in_sync(self, modules=(), optimizers=()) -> int:
        """Raises unless every rank holds the same parameters, buffers and
        optimizer state, bit for bit (two integer checksums of each
        tensor's bits, compared across the ranks in one all-reduce);
        returns how many tensors were compared (0 on an axis of one)."""
        if not self.parallel:
            return 0
        from .expert import expert_shards
        from .fsdp import fsdp_shards, working_weights

        shards = {p: owner for m in modules
                  for p, owner in expert_shards(m).items()}
        self._check_shards(shards)
        leaves = {p: leaf for m in modules
                  for p, leaf in fsdp_shards(m).items()}
        self._check_fsdp_shards(leaves)
        shards.update(leaves)
        # an FSDP net's working weights are the same on every rank
        tensors = [t for m in modules for t in itertools.chain(
            m.parameters(), m.buffers(), working_weights(m))
            if t not in shards] + [
            v for opt in optimizers for p, st in opt.state.items()
            if p not in shards for v in st.values() if torch.is_tensor(v)]
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
        sums = []
        for t in tensors:
            bits = t.detach().reshape(-1).to(self.device).view(
                ints[t.element_size()]).to(torch.int64)
            weight = torch.arange(bits.numel(), device=self.device) % 1021 + 1
            sums.append(torch.stack([bits.sum(), (bits * weight).sum()]))
        slots = self.gather_rows(torch.stack(sums))
        if not all(torch.equal(slots[0], s) for s in slots[1:]):
            raise RuntimeError(
                f"the data axis's ranks diverged: {len(tensors)} tensors "
                "of the train state are not the same on every rank")
        return len(tensors)

    def _check_shards(self, shards: dict):
        """Raises unless every rank holds expert shards of the same sizes,
        each rank its own slice of the experts (``parallel/expert.py``):
        their values differ by rank."""
        if not shards:
            return
        rows = torch.tensor([[p.numel(), p.shape[0], *m.experts,
                              m.num_experts] for p, (m, _) in shards.items()],
                            dtype=torch.float64, device=self.device)
        for r, got in enumerate(self.gather_rows(rows).tolist()):
            for numel, lead, lo, hi, e in got:
                per = e // self.size
                if (lead, lo, hi) != (per, r * per, (r + 1) * per):
                    raise RuntimeError(
                        f"the data axis's expert shards are not in place: "
                        f"rank {r} holds experts {lo:.0f}..{hi:.0f} of "
                        f"{e:.0f} ({lead:.0f} rows)")
            if [row[0] for row in got] != rows[:, 0].tolist():
                raise RuntimeError("the data axis's ranks hold expert "
                                   "shards of different sizes")

    def _check_fsdp_shards(self, leaves: dict):
        """Raises unless every rank holds FSDP shards (``parallel/fsdp.py``)
        of the same sizes, each rank its own block of each leaf: their
        values differ by rank."""
        if not leaves:
            return
        rows = torch.tensor([[leaf.numel, leaf.dim, leaf.per, leaf.block]
                             for leaf in leaves.values()],
                            dtype=torch.float64, device=self.device)
        for r, got in enumerate(self.gather_rows(rows).tolist()):
            for (numel, dim, per, block), leaf in zip(got, leaves.values()):
                if (numel, dim, per, block) != (leaf.numel, leaf.dim,
                                                leaf.per, leaf.block_of(r)):
                    raise RuntimeError(
                        f"the data axis's FSDP shards are not in place: rank "
                        f"{r} holds block {block:.0f} of {leaf.name} "
                        f"(dim {dim:.0f}, {numel:.0f} elements), where "
                        f"block {leaf.block_of(r)} of dim {leaf.dim} "
                        f"({leaf.numel} elements) belongs")

    def broadcast_module(self, module: torch.nn.Module):
        """Rank 0's parameters and buffers on every rank, as DDP starts;
        an expert shard (``parallel/expert.py``) or an FSDP shard
        (``parallel/fsdp.py``) stays this rank's."""
        if self.group is None:
            return
        from .expert import expert_shards
        from .fsdp import fsdp_shards

        shards = {**expert_shards(module), **fsdp_shards(module)}
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                if t not in shards:
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


def data_axis_for(data_axis: int | None, device=None, *,
                  resident_batch: int | None = None) -> DataAxis:
    """The driver's ``data_axis`` against the process group: with a group
    up, ``None`` is every rank of it and any other size must equal it;
    without one, ``None`` and 1 are the axis of one and a larger size
    raises (the CLI starts the processes, or torchrun does). Under NCCL a
    rank's device is ``cuda:{LOCAL_RANK}``; ``device`` overrides it (the
    gloo ranks of a test, or two ranks sharing one card).
    ``resident_batch``: a resident train batch, which must divide by the
    axis (resident programs shard it; JAX's drivers check the same)."""
    if data_axis is not None and data_axis < 1:
        raise ValueError(f"data_axis must be >= 1, got {data_axis}")
    ranks = data_axis or (dist.get_world_size() if dist.is_initialized()
                          else 1)
    if resident_batch is not None and resident_batch % ranks:
        raise ValueError(
            f"train_batch_size {resident_batch} not divisible by the data "
            f"axis {ranks} (resident programs shard the batch over it)")
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
