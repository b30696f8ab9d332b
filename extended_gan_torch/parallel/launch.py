"""Mesh ranks started by a CLI: ``--data-axis N`` (and ``--model-axis
M``) without a launcher environment (unset: every visible card over M,
:func:`default_data_axis`) runs the CLI again in N x M processes, one rank
each (a process
group that meets through a file in a temporary directory, so no port is
taken), and waits for them. Each NCCL rank sets what capturing its
collectives into CUDA graphs needs before its group starts
(``mesh.prepare_nccl_capture``)."""

from __future__ import annotations

import contextlib
import importlib
import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import threading

import torch
import torch.distributed as dist

from .mesh import (
    _multihost_env_configured,
    initialize_distributed,
    prepare_nccl_capture,
)


def _rank_main(entry, argv, rank, size, init_method, backend):
    """One rank of :func:`spawn_ranks`: joins the group, runs ``entry``
    with ``argv``; ranks past 0 print nothing."""
    module, name = entry.split(":")
    main = getattr(importlib.import_module(module), name)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        prepare_nccl_capture()
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    try:
        with contextlib.ExitStack() as quiet:
            if rank:
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            main(argv)
    finally:
        dist.destroy_process_group()


def default_data_axis(device=None, model_axis: int = 1) -> int:
    """An unset ``--data-axis``: every visible card over the model axis,
    as JAX's ``MeshContext.create(data=None, model=M)`` is every device
    over M (at least 1); 1 on the CPU or on one named card (``cuda:1``),
    and on a machine without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None \
            or not torch.cuda.is_available():
        return 1
    return max(1, torch.cuda.device_count() // max(1, model_axis))


def start_ranks(entry: str, argv, *, data_axis: int | None,
                multihost: bool, device=None, model_axis: int = 1) -> bool:
    """A CLI's mesh: under a launcher environment (or with ``multihost``,
    which raises without one) this process joins the launcher's group and
    the CLI goes on as its rank (False); a ``data_axis`` x ``model_axis``
    > 1 without one (``data_axis`` None: :func:`default_data_axis`) runs
    the CLI in that many processes (:func:`spawn_ranks`) and returns True
    once they have exited 0, and the CLI returns; otherwise nothing
    (False)."""
    model_axis = model_axis or 1
    if data_axis is None and not dist.is_initialized():
        data_axis = default_data_axis(device, model_axis)
    size = (data_axis or 1) * model_axis
    if multihost or _multihost_env_configured():
        # --multihost is explicit intent: failures raise
        initialize_distributed(require=multihost, device=device)
    elif size > 1 and not dist.is_initialized():
        label = ({"label": f"--data-axis {data_axis} --model-axis "
                           f"{model_axis}"} if model_axis > 1 else {})
        spawn_ranks(entry, sys.argv[1:] if argv is None else argv, size,
                    device, **label)
        return True
    return False


def spawn_ranks(entry: str, argv, size: int, device=None, label=None):
    """Runs the CLI ``entry`` (``"module:function"``, called with
    ``argv``) in ``size`` processes (the mesh's D x M ranks), one rank each
    of a process group that meets through a file: NCCL, one card a rank,
    or gloo with ``device="cpu"``. A SIGTERM to this process goes on to
    every rank; raises unless every rank exits 0. ``label`` names the
    flags in the error when the cards are too few."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < size:
            raise ValueError(f"{label or f'--data-axis {size}'} needs "
                             f"{size} cards, have {have}")
    store = tempfile.mkdtemp(prefix="egt_rendezvous_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        entry, argv, rank, size, "file://" + os.path.join(store, "store"),
        "gloo" if cpu else "nccl")) for rank in range(size)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    main_thread = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, forward) if main_thread else None
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.exitcode is None:
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        raise RuntimeError(f"data-axis ranks failed (rank: exit code): "
                           f"{failed}")
