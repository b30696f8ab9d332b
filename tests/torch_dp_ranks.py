"""Data-axis ranks for the port's data-parallel tests.

:func:`run` starts ``size`` processes (the ``spawn`` method), each a rank
of a gloo process group that meets through a file store in the test's
temporary directory (no TCP port: the tier runs several workers at once),
with one torch thread; each calls one function of this module with its
``DataAxis`` and the payload the test saved, and saves what it returns.
This module imports torch and the port only, never JAX, so the ranks
start quickly.

The models are the tests' narrow ones (:func:`make_model`): a base-8
SmaAt-UNet in the registry's ``unet`` fold (cross-rank BatchNorm) and
GAT3D with the conv mapping (no BatchNorm; K1's plain version on the CPU),
at HW x HW, T frames, V vertices.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np
import torch
import torch.distributed as dist

from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.models.unet_model import UnetModel
from extended_gan_torch.parallel import DataAxis, attach_data_axis
from extended_gan_torch.train import gat_trainer
from extended_gan_torch.train.state import batchnorms

HW, T, V = 16, 4, 3
SGD_LR = 0.01


def make_model(kind: str) -> torch.nn.Module:
    """The narrow UNet (``"unet"``) or GAT3D (``"gat"``) on the CPU."""
    if kind == "unet":
        model = UnetModel(HW, HW, V, time_steps=T)
        model.unet = SmaAt_UNet(n_channels=T, n_classes=T, base=8)
        return model
    return build_model("temporal", image_width=HW, image_height=HW,
                       n_vertices=V, mapping_type="conv", use_pallas=True,
                       device="cpu")


def one_step(case: dict, axis: DataAxis | None,
             dtype: torch.dtype = torch.float32) -> dict:
    """One SGD train step of ``case`` (kind, state_dict, the global batch
    x and y) on ``axis``'s rows (all of them without an axis), in
    ``dtype``: the loss, running_nd, every parameter's gradient (summed
    over the ranks) and the state after the step, as float32.
    ``case["fault"]``: each rank's BatchNorm normalises with its own rows'
    statistics (the planted fault)."""
    model = make_model(case["kind"])
    model.load_state_dict(case["state"])
    model.to(dtype)
    if axis is not None:
        attach_data_axis(model, axis)
        if case.get("fault"):
            for bn in batchnorms(model):
                bn.axis = None
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    step = gat_trainer.make_gat_train_step(model, opt, axis=axis)
    x, y = case["x"], case["y"]
    if axis is not None:
        rows = axis.rows(len(x))
        x, y = x[rows], y[rows]
    loss, nd = step(*(torch.from_numpy(np.asarray(a)).to(dtype)
                      for a in (x, y, np.ones(len(x)))))

    def f32(t):
        return t.detach().float().numpy().copy()

    return {"loss": loss.item(), "nd": f32(nd),
            "grads": {n: f32(p.grad) for n, p in model.named_parameters()},
            "state": {k: f32(v) for k, v in model.state_dict().items()}}


def steps(axis: DataAxis, payload: dict) -> dict:
    """:func:`one_step` of every case of the payload, in order."""
    return {name: one_step(case, axis)
            for name, case in payload["cases"].items()}


def _rank(fn_name, rank, size, store, payload_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)
    try:
        payload = torch.load(payload_path, weights_only=False)
        axis = DataAxis(torch.device("cpu"), dist.group.WORLD)
        out = globals()[fn_name](axis, payload)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(fn_name: str, size: int, tmp, payload: dict, timeout: float = 300):
    """Every rank's result of ``fn_name(axis, payload)``, in rank order;
    raises unless every rank exits 0 within ``timeout`` seconds."""
    tmp = str(tmp)
    payload_path = os.path.join(tmp, "payload.pt")
    torch.save(payload, payload_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(
        fn_name, r, size, os.path.join(tmp, "store"), payload_path, tmp))
        for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"ranks exited {codes} (killed: {len(alive)})")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(size)]


def batch(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A global batch of ``n`` windows, uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, HW, HW, T, V), np.float32),
            rng.random((n, HW, HW, T, V), np.float32))
