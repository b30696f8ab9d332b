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
- :class:`ModelAxis` is the model axis of a (data, model) mesh seen from
  one rank: the ranks that share its data index, over which tensor
  parallelism (``parallel/tensor.py``) cuts its leaves and runs its
  collectives;
- :func:`data_axis_for` resolves a driver's ``data_axis`` and
  ``model_axis`` against the group (the JAX mesh's "needs K devices, have
  n", ``:108-112``). The world is D x M ranks laid out as JAX's
  ``MeshContext.create(data, model)`` lays out its devices
  (``reshape(data, model)``, ``:96-116``): rank r sits at data index
  r // M and model index r % M. The data axis is then the ranks that share
  a model index: they see different rows of each batch, and the model
  ranks of one data row see the same rows and draw the same masks.

Without a group both axes have size 1 and every collective is the
identity: the single-card path runs unchanged.
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


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather_rows(row: torch.Tensor, group) -> torch.Tensor:
    """(size, *row.shape): every rank of ``group``'s ``row`` in rank order,
    the same on every rank (an all-reduce of one slot a rank: adding zeros
    is exact, and each rank combines the slots in the same order)."""
    slots = row.new_zeros((_size(group),) + tuple(row.shape))
    slots[_rank(group)] = row
    if group is not None:
        dist.all_reduce(slots, group=group)
    return slots


def _check_nccl(group, what: str):
    """Raises unless ``group``'s collectives can be captured into a CUDA
    graph (NCCL's run on the card, gloo's on the host)."""
    if group is not None and dist.get_backend(group) != "nccl":
        raise RuntimeError(
            f"--megastep and --resident on the card capture the {what}'s "
            f"collectives into CUDA graphs, which needs NCCL; "
            f"this process group runs {dist.get_backend(group)}, "
            "whose collectives run on the host (start one rank a card "
            "over NCCL: --data-axis N without --device cpu, or torchrun)")


@dataclasses.dataclass
class ModelAxis:
    """The model axis seen from one rank: the ranks that share its data
    index. ``group`` None is the axis of one."""

    group: dist.ProcessGroup | None = None

    @property
    def size(self) -> int:
        return _size(self.group)

    @property
    def rank(self) -> int:
        return _rank(self.group)

    @property
    def parallel(self) -> bool:
        return self.size > 1


@dataclasses.dataclass
class DataAxis:
    """The data axis seen from one rank. ``group`` None is the axis of
    one, where every collective is the identity."""

    device: torch.device
    group: dist.ProcessGroup | None = None
    # this rank's model axis (tensor parallelism, ``parallel/tensor.py``)
    model: ModelAxis = dataclasses.field(default_factory=ModelAxis)
    # (rows of the global batch a draw covers, this rank's slices of
    # them), set by :meth:`global_batch` around a train step
    _draw: tuple | None = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

    @property
    def size(self) -> int:
        return _size(self.group)

    @property
    def rank(self) -> int:
        return _rank(self.group)

    @property
    def parallel(self) -> bool:
        return self.size > 1

    @property
    def distributed(self) -> bool:
        """Whether more than one rank runs: a data axis or a model axis
        of more than one."""
        return self.parallel or self.model.parallel

    @property
    def world(self):
        """The group of every rank of the mesh (None on a mesh of one)."""
        if not self.model.parallel:
            return self.group
        return dist.group.WORLD

    @property
    def is_main(self) -> bool:
        """Rank 0 of both axes writes the run's files."""
        return self.rank == 0 and self.model.rank == 0

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
        return _gather_rows(row, self.group)

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
        """Raises unless this axis's collectives, and its model axis's, can
        be captured into a CUDA graph: gloo's run on the host, so an axis
        over gloo on the card cannot run ``--megastep`` or ``--resident``.
        NCCL's run on the card, and an axis of one has none."""
        _check_nccl(self.group, "data axis")
        _check_nccl(self.model.group, "model axis")

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the mesh."""
        world = self.world
        if world is None:
            return bool(flag)
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, group=world)
        return bool(t.item() > 0)

    def check_in_sync(self, modules=(), optimizers=()) -> int:
        """Raises unless every rank holds the same parameters, buffers and
        optimizer state, bit for bit (two integer checksums of each
        tensor's bits, compared across the ranks in one all-reduce): the
        replicated ones across every rank of the mesh, a tensor
        parallelism block (``parallel/tensor.py``) and its moments across
        the data axis only (the model ranks hold different blocks);
        returns how many tensors were compared (0 on a mesh of one)."""
        if not self.distributed:
            return 0
        from .expert import expert_shards
        from .fsdp import fsdp_shards, working_weights
        from .tensor import tp_blocks

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
        blocks = {b for m in modules for b in tp_blocks(m)}
        local = {v for opt in optimizers for p, st in opt.state.items()
                 if p in blocks for v in st.values() if torch.is_tensor(v)}
        local.update(blocks)
        for group, ts, where in (
                (self.world, [t for t in tensors if t not in local],
                 "every rank"),
                (self.group, [t for t in tensors if t in local],
                 "every rank of the data axis")):
            if ts and group is not None:
                self._compare(ts, group, where)
        return len(tensors)

    def _compare(self, tensors, group, where):
        """Raises unless every rank of ``group`` holds ``tensors`` bit for
        bit."""
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
        sums = []
        for t in tensors:
            bits = t.detach().reshape(-1).to(self.device).view(
                ints[t.element_size()]).to(torch.int64)
            weight = torch.arange(bits.numel(), device=self.device) % 1021 + 1
            sums.append(torch.stack([bits.sum(), (bits * weight).sum()]))
        slots = _gather_rows(torch.stack(sums), group)
        if not all(torch.equal(slots[0], s) for s in slots[1:]):
            raise RuntimeError(
                f"the data axis's ranks diverged: {len(tensors)} tensors "
                f"of the train state are not the same on {where}")

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


_MESHES: dict = {}


def _mesh_groups(d: int, m: int) -> tuple:
    """(the data groups by model index, the model groups by data index) of
    a D x M world: every rank makes every group, in one order (what
    ``dist.new_group`` asks), once a process group."""
    world = dist.distributed_c10d._get_default_group()
    held = _MESHES.get((d, m))
    if held is None or held[0] is not world:
        data = [dist.new_group([i * m + j for i in range(d)])
                for j in range(m)]
        model = [dist.new_group([i * m + j for j in range(m)])
                 for i in range(d)]
        _MESHES[d, m] = held = (world, data, model)
    return held[1:]


def data_axis_for(data_axis: int | None, device=None, *,
                  model_axis: int = 1,
                  resident_batch: int | None = None) -> DataAxis:
    """The driver's ``data_axis`` and ``model_axis`` against the process
    group: with a group up, D x M must be its size (``None``: the size over
    M); without one, D x M must be 1 (the CLI starts the processes, or
    torchrun does). Rank r sits at data index r // M and model index r % M
    (JAX ``mesh.py:96-116``); the returned axis is this rank's data axis,
    its ``model`` the model axis. Under NCCL a rank's device is
    ``cuda:{LOCAL_RANK}``; ``device`` overrides it (the gloo ranks of a
    test, or two ranks sharing one card). ``resident_batch``: a resident
    train batch, which must divide by the data axis (resident programs
    shard it; JAX's drivers check the same)."""
    if data_axis is not None and data_axis < 1:
        raise ValueError(f"data_axis must be >= 1, got {data_axis}")
    model_axis = model_axis or 1
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = data_axis or max(1, world // model_axis)
    if resident_batch is not None and resident_batch % ranks:
        raise ValueError(
            f"train_batch_size {resident_batch} not divisible by the data "
            f"axis {ranks} (resident programs shard the batch over it)")
    need = ranks * model_axis
    if not dist.is_initialized():
        if need > 1:
            named = (f"data_axis={data_axis}" if model_axis == 1 else
                     f"data_axis={ranks} x model_axis={model_axis}")
            raise RuntimeError(
                f"{named} needs {need} processes in a process group: "
                f"`python -m extended_gan_torch.gat ... --data-axis {ranks}"
                + (f" --model-axis {model_axis}" if model_axis > 1 else "")
                + "` starts them, or run under torchrun with --multihost")
        return DataAxis(resolve_device(device))
    if need != world:
        raise ValueError(
            f"data_axis={data_axis}" + (f" x model_axis={model_axis}"
                                        if model_axis > 1 else "")
            + f", but the process group has {world} ranks")
    if device is None and dist.get_backend() == "nccl":
        dev = rank_device(int(os.environ.get("LOCAL_RANK",
                                             dist.get_rank())))
    else:
        dev = resolve_device(device)
    if model_axis == 1:
        return DataAxis(dev, dist.group.WORLD if world > 1 else None)
    data, model = _mesh_groups(ranks, model_axis)
    d, m = divmod(dist.get_rank(), model_axis)
    return DataAxis(dev, data[m] if ranks > 1 else None,
                    ModelAxis(model[d]))
