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
at HW x HW, T frames, V vertices; and the narrow GANs (:func:`gan_nets`:
the DCGAN's G, FD and TD, the CycleGAN's two generators and two
discriminators, ndf GAN_NDF at GAN_IM x GAN_IM), their channel dropout
drawn from one generator seeded alike on every rank.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os

import numpy as np
import torch
import torch.distributed as dist

from extended_gan_torch.models.dcgan import (
    ConvBlock,
    FrameDiscriminator,
    Generator,
    TemporalDiscriminator,
    _PackedBN,
)
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.models.unet_model import UnetModel
from extended_gan_torch.parallel import (
    BatchNorm2d,
    DataAxis,
    attach_data_axis,
    join_data_axis,
)
from extended_gan_torch.parallel import batch_norm as bn_module
from extended_gan_torch.train import (
    cyclegan_trainer,
    dcgan_trainer,
    gat_trainer,
)
from extended_gan_torch.train.state import batchnorms

_NORMALISE = bn_module._normalise
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


GAN_NC, GAN_NDF, GAN_IM = 4, 8, 64
GAN_SGD_LR = 0.1
GAN_DROP_SEED = 17
CYCLE_LAMBDA = 10.0
# every log of a step, by workload
GAN_LOGS = {"dcgan": ("errFD", "errTD", "errG", "train_mse_nd", "fd_acc_nd",
                      "td_acc_nd"),
            "cyclegan": cyclegan_trainer.LOSS_KEYS + ("train_mse_nd",)}


def gan_nets(kind: str, states, *, dropout: float, packed: bool = False,
             dtype: torch.dtype = torch.float32):
    """The narrow nets of ``kind`` on the CPU with the weights and
    statistics ``states`` (one state_dict a net): ``"dcgan"`` (G, FD, TD)
    or ``"cyclegan"`` (G_xy, G_yx, D_x, D_y); ``packed``: the generators in
    the 2x2 space-to-depth layout."""
    drop = torch.Generator().manual_seed(GAN_DROP_SEED)

    def gen():
        return Generator(GAN_NC, dropout, dropout_generator=drop,
                         packed=packed)

    if kind == "dcgan":
        nets = (gen(), FrameDiscriminator(GAN_NC, GAN_NDF),
                TemporalDiscriminator(GAN_NC, GAN_NDF, dropout,
                                      dropout_generator=drop))
    else:
        nets = (gen(), gen(), FrameDiscriminator(GAN_NC, GAN_NDF),
                FrameDiscriminator(GAN_NC, GAN_NDF))
    for net, state in zip(nets, states):
        net.load_state_dict(state)
    return tuple(net.to(dtype) for net in nets)


def _mean_rounded(d, shift, mean, invstd):
    """Cross-rank BatchNorm's x_hat from its mean rounded to float32 (a
    past fault: every x_hat of a channel shifts alike where the mean is
    large against the spread)."""
    mean32 = mean.to(d.dtype).reshape(1, -1, 1, 1)
    return (d - (mean32 - shift.reshape(1, -1, 1, 1))) \
        * invstd.to(d.dtype).reshape(1, -1, 1, 1)


def plant_fault(fault: str, nets, axis: DataAxis):
    """The planted faults: ``"dropout"`` each rank draws its own rows'
    masks, ``"d_unreduced"`` D's gradients left unreduced (the step's first
    all-reduce sums its losses alone), ``"packed_bn"`` the packed
    generator's BatchNorm with this rank's statistics, ``"bn_mean_f32"``
    cross-rank BatchNorm normalising with its mean rounded to float32.
    Returns the call that takes the fault out again."""
    for net in nets:
        for m in net.modules():
            if (fault == "dropout" and isinstance(m, ConvBlock)) or (
                    fault == "packed_bn" and isinstance(m, _PackedBN)):
                m.axis = None
    if fault == "d_unreduced":
        reduce, calls = axis.all_reduce_grads, []

        def unreduced(params, extra):
            calls.append(1)
            return reduce([] if len(calls) == 1 else params, extra)

        axis.all_reduce_grads = unreduced
    if fault == "bn_mean_f32":
        bn_module._normalise = _mean_rounded

    def undo():
        axis.__dict__.pop("all_reduce_grads", None)
        bn_module._normalise = _NORMALISE

    return undo


@contextlib.contextmanager
def torch_threads(n: int):
    """Within: torch runs ``n`` threads (another reduction order for the
    plain path's roundoff twins)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _f32(t):
    return t.detach().float().numpy().copy()


def gan_step(case: dict, axis: DataAxis | None,
             dtype: torch.dtype = torch.float32) -> dict:
    """One SGD step of ``case`` (``kind``, ``body`` (the DCGAN step's
    options), ``packed``, ``dropout``, ``states``, the global batch ``x``
    and ``y``, ``fault``) on ``axis``'s rows (all of them without an axis),
    in ``dtype``: the step's logs, and each net's parameters, gradients
    (summed over the ranks) and running statistics after it, as
    float32."""
    kind = case["kind"]
    nets = gan_nets(kind, case["states"], dropout=case["dropout"],
                    packed=case.get("packed", False), dtype=dtype)
    x, y = (torch.from_numpy(np.asarray(a)).to(dtype)
            for a in (case["x"], case["y"]))
    n = len(x)
    undo = None
    if axis is not None:
        join_data_axis(axis, *nets)
        if case.get("fault"):
            undo = plant_fault(case["fault"], nets, axis)
        x, y = axis.shard(x), axis.shard(y)
    opts = tuple(torch.optim.SGD(net.parameters(), lr=GAN_SGD_LR)
                 for net in nets)
    if kind == "dcgan":
        step = dcgan_trainer.make_dcgan_train_step(
            *nets, *opts, axis=axis, **case.get("body", {}))
    else:
        step = cyclegan_trainer.make_cyclegan_train_step(
            *nets, *opts, cycle_lambda=CYCLE_LAMBDA, axis=axis)
    logs = step(x, y) if axis is None else step(x, y, None, n)
    if undo is not None:
        undo()
    return {"logs": {k: _f32(logs[k]) for k in GAN_LOGS[kind]},
            "params": [{k: _f32(p) for k, p in net.named_parameters()}
                       for net in nets],
            "grads": [{k: _f32(p.grad) for k, p in net.named_parameters()}
                      for net in nets],
            "stats": [{k: _f32(v) for k, v in net.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
                      for net in nets]}


def bn_layer(case: dict, axis: DataAxis) -> dict:
    """Cross-rank BatchNorm (train mode, momentum 0.1) on this rank's rows of
    ``case``'s global ``x`` (its rows split evenly), with ``weight`` and
    ``bias``, and its backward from those rows of ``dy``; ``fault``: one of
    :func:`plant_fault`'s. Returns every rank's ``y`` and ``dx`` rows in
    rank order, the weight's and bias's gradients summed over the ranks,
    and the running statistics after it."""
    x, dy = (torch.from_numpy(case[k]) for k in ("x", "dy"))
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    bn.axis = axis
    undo = plant_fault(case.get("fault") or "", (), axis)
    try:
        xs = axis.shard(x).clone().requires_grad_(True)
        y = bn(xs)
        y.backward(axis.shard(dy))
    finally:
        undo()
    grads = axis.all_reduce(torch.stack([bn.weight.grad, bn.bias.grad]))
    return {"y": _f32(axis.gather_rows(y.detach()).flatten(0, 1)),
            "dx": _f32(axis.gather_rows(xs.grad).flatten(0, 1)),
            "dw": _f32(grads[0]), "db": _f32(grads[1]),
            "running_mean": _f32(bn.running_mean),
            "running_var": _f32(bn.running_var)}


def gan_steps(axis: DataAxis, payload: dict) -> dict:
    """:func:`gan_step` of every case of the payload, and :func:`bn_layer`
    of every one of its ``"bn"`` cases, in order."""
    out = {name: gan_step(case, axis)
           for name, case in payload["cases"].items()}
    out.update({f"bn {name}": bn_layer(case, axis)
                for name, case in payload.get("bn", {}).items()})
    return out


GRAPH_K = 4  # train steps a megastep group (eager on the CPU)
GRAPH_LR = 0.01  # SGD over several steps: larger rates amplify roundoff
RESIDENT_K, RESIDENT_B = 2, 4  # a resident program's steps and batch


def _graph_nets(kind: str, state, dtype):
    """The narrow model (``"unet"``) or GAN nets of ``kind`` from
    ``state``, dropout on, and an SGD optimizer each."""
    if kind == "unet":
        nets = (make_model("unet"),)
        nets[0].load_state_dict(state[0])
    else:
        nets = gan_nets(kind, state, dropout=0.01)
    nets = tuple(net.to(dtype) for net in nets)
    return nets, tuple(torch.optim.SGD(net.parameters(), lr=GRAPH_LR)
                       for net in nets)


def _after(nets, logs) -> dict:
    return {"logs": [{k: _f32(v) for k, v in g.items()} for g in logs],
            "params": [{k: _f32(p) for k, p in net.named_parameters()}
                       for net in nets],
            "stats": [{k: _f32(v) for k, v in net.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
                      for net in nets]}


def graph_run(case: dict, axis: DataAxis | None,
              dtype: torch.dtype = torch.float32) -> dict:
    """An epoch of ``case`` (``kind``: ``"unet"``, ``"dcgan"`` or
    ``"cyclegan"``; ``path``: ``"megastep"``, K = GRAPH_K steps a group over
    the streamed global ``batches``, or ``"resident"``, programs of
    RESIDENT_K x RESIDENT_B over a store of ``video``; ``state``) on
    ``axis``'s rows (all of them without an axis), in ``dtype``, SGD: every
    group's logs, the weights and statistics after it, and on the resident
    path the eval's results."""
    from extended_gan_torch.data import resident

    kind = case["kind"]
    nets, opts = _graph_nets(kind, case["state"], dtype)
    if axis is not None:
        join_data_axis(axis, *nets)
    cpu = torch.device("cpu")
    out = {}
    if case["path"] == "megastep":
        if kind == "unet":
            mega = gat_trainer.make_gat_megastep(nets[0], opts[0], axis=axis)
            logs = [mega(*(t.to(dtype) for t in staged))
                    for _, _, _, staged in gat_trainer.gat_megafeed(
                        case["batches"], cpu, GRAPH_K, batch_size=len(
                            case["batches"][0][0]), axis=axis)]
        else:
            make = (dcgan_trainer.make_dcgan_megastep if kind == "dcgan"
                    else cyclegan_trainer.make_cyclegan_megastep)
            mega = make(*nets, *opts, axis=axis)
            logs = [mega(*(t.to(dtype) for t in staged))
                    for _, staged in dcgan_trainer._megafeed(
                        case["batches"], cpu, len(case["batches"][0][0]),
                        GRAPH_K, axis=axis)]
        return _after(nets, logs)
    video = torch.from_numpy(case["video"]).to(dtype).numpy()
    window = 2 * T if kind == "unet" else 2 * GAN_NC
    starts = np.concatenate([f + np.arange(len(video) // 2 - window + 1)
                             for f in (0, len(video) // 2)])
    store = resident.ResidentVideos(video, starts, window, cpu,
                                    file_starts=[starts[:len(starts) // 2],
                                                 starts[len(starts) // 2:]])
    store.video = store.video.to(dtype)
    if kind == "unet":
        mega = resident.make_gat_resident_megastep(nets[0], opts[0], store,
                                                   time_steps=T, axis=axis)
        eval_k = resident.make_gat_resident_eval(nets[0], store,
                                                 time_steps=T, axis=axis)
        test = lambda: resident.resident_gat_test(  # noqa: E731
            eval_k, store, k=RESIDENT_K, batch_size=3)
    elif kind == "dcgan":
        mega = resident.make_dcgan_resident_megastep(*nets, *opts, store,
                                                     axis=axis)
        eval_k = resident.make_dcgan_resident_eval(*nets, store)
        test = lambda: resident.resident_dcgan_test(  # noqa: E731
            eval_k, store, k=RESIDENT_K, batch_size=3, axis=axis)
    else:
        mega = resident.make_cyclegan_resident_megastep(*nets, *opts, store,
                                                        axis=axis)
        eval_k = resident.make_cyclegan_resident_eval(*nets[:2], store)
        test = lambda: resident.resident_cyclegan_test(  # noqa: E731
            eval_k, store, k=RESIDENT_K, batch_size=3, axis=axis)
    logs = [g for g, _ in resident.program_logs(
        store, mega, 5, RESIDENT_K, RESIDENT_B, axis=axis)]
    out = _after(nets, logs)
    out["eval"] = test()
    return out


def graph_runs(axis: DataAxis, payload: dict) -> dict:
    """:func:`graph_run` of every case of the payload, in order; and the
    refusal of CUDA graphs over this gloo group on the card (the message,
    or None where none was raised)."""
    out = {name: graph_run(case, axis)
           for name, case in payload["cases"].items()}
    try:
        DataAxis(torch.device("cuda", 0), axis.group).check_capturable()
        out["refusal"] = None
    except RuntimeError as e:
        out["refusal"] = str(e)
    return out


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
