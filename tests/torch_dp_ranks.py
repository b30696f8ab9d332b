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
        fsdp_placed([model], axis, None, case.get("tp"))
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

    grads = tp_full(model, {n: p.grad for n, p in model.named_parameters()})
    return {"loss": loss.item(), "nd": f32(nd),
            "grads": {n: f32(g) for n, g in grads.items()},
            "state": {k: f32(v) for k, v in tp_full(
                model, model.state_dict()).items()}}


def tp_full(model, tensors: dict) -> dict:
    """``tensors`` keyed by ``model``'s state_dict names, each tensor
    parallelism block gathered into its full leaf (every rank calls it)."""
    from extended_gan_torch.parallel import tensor

    return tensor.full_state_dict(model, tensors)


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
        fsdp_placed(nets[1 if kind == "dcgan" else 2:], axis, None,
                    case.get("tp"))
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
            "params": [{k: _f32(p) for k, p in tp_full(
                net, dict(net.named_parameters())).items()} for net in nets],
            "grads": [{k: _f32(p) for k, p in tp_full(net, {
                k: p.grad for k, p in net.named_parameters()}).items()}
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


# ----------------------------------------------------- expert parallelism
# the narrow MoE UNet of test_torch_port_moe.py: base 8 at 32x32, E = 4,
# capacity factor 0.5 (tokens overflow), T = 4, V = 3
MOE_HW, MOE_V, MOE_E, MOE_CF, MOE_AUX_W = 32, 3, 4, 0.5, 0.01
EP_FAULTS = ("local", "reduced", "aux_every_rank")


def make_moe_model(per_vertex: bool, dtype=torch.float32):
    """The narrow MoE UNet on the CPU (the default path or
    ``per_vertex_bn``)."""
    import functools

    from extended_gan_torch.models import unet_model as um

    real = um.SmaAt_UNet
    um.SmaAt_UNet = functools.partial(SmaAt_UNet, base=8,
                                      moe_capacity_factor=MOE_CF)
    try:
        model = um.UnetModel(MOE_HW, MOE_HW, MOE_V, time_steps=T,
                             moe_experts=MOE_E, per_vertex_bn=per_vertex)
    finally:
        um.SmaAt_UNet = real
    return model.to(dtype)


def _local_routing(moe_layer, tokens, axis, dtype=torch.float32):
    """A planted fault: each rank routes its own tokens with its shard's
    capacity (JAX's explicit EP program, per group), its aux the ranks'
    mean."""
    from extended_gan_torch.models.moe import expert_capacity
    from extended_gan_torch.parallel.expert import make_moe_ep_apply

    cap = expert_capacity(tokens.shape[1], moe_layer.num_experts,
                          moe_layer.capacity_factor)
    apply = make_moe_ep_apply(axis, n_experts=moe_layer.num_experts,
                              capacity=cap, dtype=dtype)
    params = {k: getattr(moe_layer, k)
              for k in ("router", "w1", "b1", "w2", "b2")}
    outs, auxes = zip(*(apply(params, t) for t in tokens))
    load = tokens.new_zeros((tokens.shape[0], moe_layer.num_experts))
    return torch.stack(outs), torch.stack(auxes), load


@contextlib.contextmanager
def ep_fault(fault: str | None):
    """Within: one of EP_FAULTS planted (or none): ``"local"`` routing on
    each rank's tokens with a per-rank capacity, ``"reduced"`` the expert
    shards' gradients also summed in the trainer's all-reduce,
    ``"aux_every_rank"`` every rank's loss carrying the global aux through
    a differentiable all-reduce (so the sum over the ranks counts it, and
    its gradient, D times)."""
    from extended_gan_torch.parallel import expert

    real_apply = expert.moe_apply_global
    real_params = gat_trainer.replicated_parameters
    if fault == "local":
        expert.moe_apply_global = _local_routing
    elif fault == "reduced":
        gat_trainer.replicated_parameters = lambda m: list(m.parameters())
    elif fault == "aux_every_rank":
        def global_aux(moe_layer, tokens, axis, dtype=torch.float32):
            out, aux, load = real_apply(moe_layer, tokens, axis, dtype)
            total = axis.all_reduce(aux.detach().clone())
            # an all-reduce's backward sums the D ranks' cotangents
            d = axis.size
            return out, d * aux + (total - d * aux).detach(), load
        expert.moe_apply_global = global_aux
    try:
        yield
    finally:
        expert.moe_apply_global = real_apply
        gat_trainer.replicated_parameters = real_params


def ep_step(case: dict, axis: DataAxis | None) -> dict:
    """One SGD step (lr 0: the gradients) of the narrow MoE UNet from
    ``case["state"]`` on ``axis``'s rows of the global ``x``, ``y`` (all
    of them without an axis), in ``case["dtype"]``, its experts sharded
    over the axis, with ``case["fault"]`` planted (``case["remat"]``: the
    forward recomputed in the backward, the exchange with it): the loss
    and every gradient, the expert shards' gathered (all E), as
    float64."""
    from extended_gan_torch.parallel.expert import (
        gather_experts,
        shard_tree_moe_ep,
    )

    dtype = case.get("dtype", torch.float32)
    model = make_moe_model(case["per_vertex"], dtype)
    model.load_state_dict(case["state"])
    x, y = case["x"], case["y"]
    if axis is not None:
        join_data_axis(axis, model)
        shard_tree_moe_ep(model, axis)
        rows = axis.rows(len(x))
        x, y = x[rows], y[rows]
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    with ep_fault(case.get("fault")):
        step = gat_trainer.make_gat_train_step(
            model, opt, axis=axis, moe_aux_weight=MOE_AUX_W,
            remat=case.get("remat", False))
        loss, _ = step(*(torch.from_numpy(np.asarray(a)).to(dtype)
                         for a in (x, y, np.ones(len(x)))))
    grads = {n: p.grad for n, p in model.named_parameters()}
    if axis is not None:
        grads = gather_experts(grads, model, axis)
    return {"loss": loss.item(),
            "grads": {k: g.detach().double().numpy().copy()
                      for k, g in grads.items()}}


def ep_megastep(case: dict, axis: DataAxis | None) -> dict:
    """``case["k"]`` SGD steps (lr 0.01, float64) of the narrow MoE UNet
    as one megastep group (eager on the CPU) on ``axis``'s rows of the
    global batches ``case["xs"]``, ``case["ys"]``: the state after it,
    all E experts."""
    from extended_gan_torch.parallel.expert import (
        full_state_dict,
        shard_tree_moe_ep,
    )

    model = make_moe_model(case["per_vertex"], torch.float64)
    model.load_state_dict(case["state"])
    xs, ys = (torch.from_numpy(case[k]).double() for k in ("xs", "ys"))
    masks = torch.ones(xs.shape[:2], dtype=torch.float64)
    if axis is not None:
        join_data_axis(axis, model)
        shard_tree_moe_ep(model, axis)
        xs, ys, masks = (axis.shard(t, 1) for t in (xs, ys, masks))
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    mega = gat_trainer.make_gat_megastep(model, opt, axis=axis,
                                         moe_aux_weight=MOE_AUX_W)
    logs = mega(xs, ys, masks)
    state = full_state_dict(model, axis) if axis is not None \
        else model.state_dict()
    return {"loss": logs["loss"].item(),
            "state": {k: v.detach().double().numpy().copy()
                      for k, v in state.items()}}


def ep_apply(payload: dict, axis: DataAxis) -> dict:
    """The explicit EP program (``make_moe_ep_apply``) on this rank's rows
    of ``payload``'s tokens, each rank's E/D experts, per-shard capacity
    N/D: every rank's output rows (rank order) and the aux; the bytes of
    a SwitchMoE's leaves and Adam moments on this rank after sharding and
    one step; what E = 6 over the axis raises."""
    from extended_gan_torch.models.moe import SwitchMoE
    from extended_gan_torch.parallel.expert import (
        EXPERT_LEAVES,
        make_moe_ep_apply,
        shard_moe_params_ep,
        shard_tree_moe_ep,
    )

    params = {k: torch.from_numpy(v) for k, v in payload["params"].items()}
    tokens = torch.from_numpy(payload["tokens"])
    e, n = params["w1"].shape[0], len(tokens)
    apply = make_moe_ep_apply(axis, n_experts=e, capacity=n // axis.size)
    out, aux = apply(shard_moe_params_ep(params, axis, e),
                     axis.shard(tokens))
    moe_layer = SwitchMoE(tokens.shape[1], e)
    moe_layer.axis = axis
    holder = torch.nn.ModuleDict({"moe": moe_layer})
    shard_tree_moe_ep(holder, axis)
    opt = torch.optim.Adam(holder.parameters(), lr=1e-3)
    with torch.no_grad():
        y = moe_layer(axis.shard(torch.from_numpy(payload["x"])))
    for p in holder.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    nbytes = {k: getattr(moe_layer, k).numel() * 4
              for k in EXPERT_LEAVES + ("router",)}
    moments = {k: sum(v.numel() * 4 for v in opt.state[getattr(
        moe_layer, k)].values() if v.dim()) for k in nbytes}
    try:
        make_moe_ep_apply(axis, n_experts=6, capacity=4)
        raised = ""
    except ValueError as err:
        raised = str(err)
    return {"out": _f32(axis.gather_rows(out.detach()).flatten(0, 1)),
            "aux": float(aux), "bytes": nbytes, "moments": moments,
            "forward": tuple(y.shape), "raised": raised}


def ep_cases(axis: DataAxis, payload: dict) -> dict:
    """Everything the expert-parallel tests run on ``axis``:
    :func:`ep_apply` where the payload has ``"apply"``, then
    :func:`ep_step` of each case and :func:`ep_megastep` of each
    megastep case."""
    out = {}
    if "apply" in payload:
        out["apply"] = ep_apply(payload["apply"], axis)
    out.update({name: ep_step(case, axis)
                for name, case in payload.get("steps", {}).items()})
    out.update({name: ep_megastep(case, axis)
                for name, case in payload.get("megasteps", {}).items()})
    return out


def ep_driver(axis: DataAxis, payload: dict) -> dict:
    """The conv-GAT driver with ``moe_experts`` on this process group (the
    CPU), checkpoints on, into ``payload["out"]``: ``"whole"`` trains
    ``epochs`` epochs; ``"cut"`` trains one and then resumes it to
    ``epochs`` (a second ``train`` with ``resume=True``). Returns this
    rank's expert leaves' and Adam moments' sizes after each run, and its
    replicated loss history."""
    from extended_gan_torch.models.moe import moe_layers
    from extended_gan_torch.train.gat_driver import train

    kw = dict(payload["kw"], device="cpu", checkpoint_every=1)
    out, sizes, hist = payload["out"], {}, {}
    for name, runs in (("whole", [kw["epochs"]]),
                       ("cut", [1, kw["epochs"]])):
        for i, epochs in enumerate(runs):
            model, history = train(**{**kw, "epochs": epochs},
                                   output_path=os.path.join(out, name),
                                   resume=i > 0)
        (layer,) = moe_layers(model)
        sizes[name] = {"w1": tuple(layer.w1.shape),
                       "experts": layer.experts}
        hist[name] = history
    return {"sizes": sizes, "history": hist}


def vanilla_steps(axis: DataAxis | None, payload: dict) -> dict:
    """``payload["steps"]`` SGD steps (lr ``payload["lr"]``) of the vanilla
    GAN's step (``fused_prop`` as the payload says) from its ``states``,
    in ``payload["dtype"]``, on ``axis``'s rows of each global batch (all
    of them without an axis), z drawn from one generator seeded alike on
    every rank: each step's losses and G's and D's state after them."""
    from extended_gan_torch.models.vanilla_gan import (
        MLPDiscriminator,
        MLPGenerator,
    )
    from extended_gan_torch.train.adversarial import make_vanilla_gan_step

    dtype = payload.get("dtype", torch.float32)
    shape = payload["img_shape"]
    g = MLPGenerator(shape, payload["latent"])
    d = MLPDiscriminator(shape)
    for net, state in zip((g, d), payload["states"]):
        net.load_state_dict(state)
        net.to(dtype)
    if axis is not None:
        join_data_axis(axis, g, d)
    opts = [torch.optim.SGD(n.parameters(), lr=payload["lr"]) for n in (g, d)]
    z_stream = torch.Generator().manual_seed(3)
    step = make_vanilla_gan_step(g, d, *opts, latent_dim=payload["latent"],
                                 fused_prop=payload["fused_prop"],
                                 generator=z_stream, axis=axis)
    logs = []
    for real in payload["batches"]:
        real = torch.from_numpy(real).to(dtype)
        n = len(real)
        if axis is not None:
            real = axis.shard(real)
        out = step(real, n=n) if axis is not None else step(real)
        logs.append({k: v.item() for k, v in out.items()})
    return {"logs": logs,
            "state": [{k: _f32(v) for k, v in n.state_dict().items()}
                      for n in (g, d)]}


def vanilla_cases(axis: DataAxis, payload: dict) -> dict:
    """:func:`vanilla_steps` of every case of the payload."""
    return {name: vanilla_steps(axis, case)
            for name, case in payload.items()}


def _rank(fn_name, rank, size, store, payload_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)
    try:
        payload = torch.load(payload_path, weights_only=False)
        if "mesh" in payload:  # (data, model): the ranks of both axes
            from extended_gan_torch.parallel import data_axis_for

            d, m = payload["mesh"]
            axis = data_axis_for(d, "cpu", model_axis=m)
        else:
            axis = DataAxis(torch.device("cpu"), dist.group.WORLD)
        out = globals()[fn_name](axis, payload)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(fn_name: str, size: int, tmp, payload: dict, timeout: float = 300):
    """Every rank's result of ``fn_name(axis, payload)``, in rank order;
    raises unless every rank exits 0 within ``timeout`` seconds."""
    return start(fn_name, size, tmp, payload)(timeout)


def start(fn_name: str, size: int, tmp, payload: dict):
    """:func:`run` with the ranks started and not waited for: returns
    ``finish(timeout=300)``, which waits and returns every rank's
    result."""
    tmp = str(tmp)
    payload_path = os.path.join(tmp, "payload.pt")
    torch.save(payload, payload_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(
        fn_name, r, size, os.path.join(tmp, "store"), payload_path, tmp))
        for r in range(size)]
    for p in procs:
        p.start()
    return lambda timeout=300: _finish(procs, tmp, timeout)


def _finish(procs, tmp, timeout):
    size = len(procs)
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


# ------------------------------------------------------------------ FSDP
def fsdp_placed(nets, axis, min_size, tp=None):
    """``nets`` cut over ``axis``'s model axis by tensor parallelism at
    ``tp`` channels (None: not cut), then sharded over ``axis`` by FSDP at
    ``min_size`` (None: left replicated); returns the FSDP placements."""
    from extended_gan_torch.parallel import fsdp, tensor

    if axis is None:
        return []
    if tp is not None:
        for net in nets:
            tensor.shard_module_tp(net, axis, tp)
    if min_size is None:
        return []
    return [fsdp.shard_module_fsdp(net, axis, min_size) for net in nets]


def _full_trees(nets):
    """Each net's parameters and running statistics, full leaves (FSDP's
    blocks gathered, then tensor parallelism's: every rank calls it), as
    float64."""
    from extended_gan_torch.parallel import fsdp, tensor

    out = []
    for net in nets:
        state = tensor.full_state_dict(net, fsdp.full_state_dict(net))
        out.append({k: v.detach().double().numpy().copy()
                    for k, v in state.items()
                    if not k.endswith("num_batches_tracked")})
    return out


def fsdp_gan_run(case: dict, axis: DataAxis | None,
                 dtype: torch.dtype = torch.float32) -> dict:
    """``case["steps"]`` steps of the narrow nets of ``case["kind"]`` from
    ``case["states"]`` on ``axis``'s rows of the global ``x``, ``y`` (all
    of them without an axis), in ``dtype``, FSDP at ``case["fsdp"]`` (a
    min_size; None: the data axis alone), with ``case["opt"]``: ``"sgd"``
    (lr GAN_SGD_LR) or ``"adam"`` (the drivers' lr 2e-4, betas (0.5,
    0.999)). ``case["fault"] == "stale_d"``: FD's and TD's gathers after
    their optimizer's step removed (G then trains against the
    discriminators before their update). Returns the last step's logs, the
    nets' full state after the steps and each rank's persistent bytes."""
    from extended_gan_torch.parallel import fsdp

    kind = case["kind"]
    nets = gan_nets(kind, case["states"], dropout=case["dropout"],
                    dtype=dtype)
    x, y = (torch.from_numpy(np.asarray(a)).to(dtype)
            for a in (case["x"], case["y"]))
    n = len(x)
    if axis is not None:
        join_data_axis(axis, *nets)
        x, y = axis.shard(x), axis.shard(y)
    # TP on the discriminators, as the drivers cut them
    fsdp_placed(nets[1 if kind == "dcgan" else 2:], axis, None,
                case.get("tp"))
    fsdp_placed(nets, axis, case.get("fsdp"))
    undo = tp_fault(case.get("tp_fault"))
    if case.get("opt", "sgd") == "adam":
        opts = tuple(torch.optim.Adam(net.parameters(), lr=2e-4,
                                      betas=(0.5, 0.999), eps=1e-8)
                     for net in nets)
    else:
        opts = tuple(torch.optim.SGD(net.parameters(), lr=GAN_SGD_LR)
                     for net in nets)
    for net, opt in zip(nets, opts):
        fsdp.refresh_after(opt, net)
    if case.get("fault") == "stale_d":
        for net in nets[1:]:
            for hook in fsdp.fsdp_net(net).hooks:
                hook.remove()
    if kind == "dcgan":
        step = dcgan_trainer.make_dcgan_train_step(
            *nets, *opts, axis=axis, **case.get("body", {}))
    else:
        step = cyclegan_trainer.make_cyclegan_train_step(
            *nets, *opts, cycle_lambda=CYCLE_LAMBDA, axis=axis)
    for _ in range(case.get("steps", 1)):
        logs = step(x, y) if axis is None else step(x, y, None, n)
    undo()
    return {"logs": {k: _f32(logs[k]).astype(np.float64)
                     for k in GAN_LOGS[kind]},
            "state": _full_trees(nets),
            "bytes": [fsdp.persistent_bytes(net, opt)
                      for net, opt in zip(nets, opts)],
            # a planted fault of tensor parallelism lets the ranks diverge
            "in_sync": 0 if axis is None or case.get("tp_fault")
            else axis.check_in_sync(nets, opts)}


def fsdp_model_run(case: dict, axis: DataAxis | None,
                   dtype: torch.dtype = torch.float32) -> dict:
    """``case["steps"]`` Adam steps (the conv-GAT optimizer: lr 1e-3, L2
    decay 0.01) of the narrow model ``case["kind"]`` (``"unet"``, ``"gat"``,
    ``"k2"``: GAT3D with K2's fused mapping, or ``"moe"``: the narrow MoE
    UNet, its experts sharded by EP) from ``case["state"]`` on ``axis``'s
    rows of the global ``x``, ``y``, in ``dtype``, FSDP at
    ``case["fsdp"]`` (None: off); ``case["remat"]``: the forward
    recomputed in the backward. Returns the losses and the full state."""
    from extended_gan_torch.models.gat.gat3d import Model
    from extended_gan_torch.parallel import fsdp
    from extended_gan_torch.parallel.expert import (
        full_state_dict,
        shard_tree_moe_ep,
    )
    from extended_gan_torch.train.optim import make_optimizer

    kind = case["kind"]
    if kind == "moe":
        model = make_moe_model(False, dtype)
    elif kind == "k2":
        model = Model(HW, HW, V, attention_type="temporal",
                      mapping_type="conv", use_pallas=True,
                      use_pallas_mapping=True).to(dtype)
    else:
        model = make_model(kind).to(dtype)
    model.load_state_dict(case["state"])
    x, y = case["x"], case["y"]
    if axis is not None:
        join_data_axis(axis, model)
        # TP, then EP, then FSDP, as the conv-GAT driver places them
        fsdp_placed([model], axis, None, case.get("tp"))
        shard_tree_moe_ep(model, axis)
        rows = axis.rows(len(x))
        x, y = x[rows], y[rows]
    fsdp_placed([model], axis, case.get("fsdp"))
    undo = tp_fault(case.get("tp_fault"))
    opt = make_optimizer("adam", model.parameters(), 1e-3, weight_decay=0.01)
    fsdp.refresh_after(opt, model)
    step = gat_trainer.make_gat_train_step(
        model, opt, axis=axis, remat=case.get("remat", False),
        moe_aux_weight=MOE_AUX_W if kind == "moe" else 0.0)
    batch = [torch.from_numpy(np.asarray(a)).to(dtype)
             for a in (x, y, np.ones(len(x)))]
    losses = [step(*batch)[0].item() for _ in range(case.get("steps", 2))]
    undo()
    state = model.state_dict()
    if axis is not None:
        from extended_gan_torch.parallel import tensor

        state = tensor.full_state_dict(model, fsdp.full_state_dict(
            model, full_state_dict(model, axis)))
    return {"losses": losses,
            "state": {k: v.detach().double().numpy().copy()
                      for k, v in state.items()
                      if not k.endswith("num_batches_tracked")},
            "sharded": len(fsdp.fsdp_shards(model)),
            "bytes": fsdp.persistent_bytes(model, opt),
            "in_sync": 0 if axis is None or case.get("tp_fault")
            else axis.check_in_sync([model], [opt])}


def tp_fault(fault: str | None):
    """Tensor parallelism's planted faults: ``"gd"`` the depthwise-separable
    conv's all-reduce of gd over the model axis dropped, ``"dx"`` a cut
    conv's all-reduce of dx dropped. Returns the call that takes it out."""
    from extended_gan_torch.parallel import tensor

    saved = tensor._reduce_gd, tensor._reduce_dx
    if fault == "gd":
        tensor._reduce_gd = lambda t, group: t
    elif fault == "dx":
        tensor._reduce_dx = lambda t, group: t

    def undo():
        tensor._reduce_gd, tensor._reduce_dx = saved

    return undo


def fsdp_resume(axis: DataAxis, payload: dict) -> dict:
    """The DCGAN driver on this process group (the CPU) into
    ``payload["out"]``, checkpoints every epoch: ``"whole"`` trains 2
    epochs with FSDP; ``"cut"`` trains 1 with FSDP and resumes to 2 with
    it; ``"cut_plain"`` resumes the FSDP run's first epoch without FSDP;
    ``"plain_cut"`` trains 1 without and resumes to 2 with FSDP. Returns
    each run's nets' full state after it, the checkpoint's leaves' shapes
    and this rank's shard sizes."""
    from extended_gan_torch.parallel import fsdp
    from extended_gan_torch.train.dcgan_driver import train

    import shutil

    kw = dict(payload["kw"], device="cpu", data_axis=axis.size,
              synthetic=True, fsdp_min_size=1)
    out, res = payload["out"], {}

    def run(name, epochs, on, resume=False):
        nets, _ = train(**kw, epochs=epochs, fsdp=on, resume=resume,
                        out_dir=os.path.join(out, name))
        res[name] = {"state": _full_trees(nets),
                     "shards": [sorted(tuple(p.shape) for p in
                                       fsdp.fsdp_shards(net))
                                for net in nets]}

    run("whole", 2, True)
    run("cut", 1, True)
    run("plain_cut", 1, False)
    if axis.is_main:  # the FSDP run's first epoch, resumed without it
        shutil.copytree(os.path.join(out, "cut"),
                        os.path.join(out, "cut_plain"))
    axis.all_reduce(torch.zeros(1))  # the copy is in place
    run("cut", 2, True, resume=True)
    run("cut_plain", 2, False, resume=True)
    run("plain_cut", 2, True, resume=True)
    return res


def fsdp_per_vertex_bn(case: dict, axis: DataAxis) -> dict:
    """``PerVertexBatchNorm2d`` (C 4, V 3) in train mode on this rank's
    samples of ``case["x"]`` (b-major rows), FSDP at ``case["fsdp"]``
    (None: off; at 1 its (C,) weight and bias are cut in two), its output
    pulled back along ``case["dy"]``, the gradients summed over the ranks
    and one SGD step: every rank's output rows and the full state."""
    from extended_gan_torch.models.unet_model import PerVertexBatchNorm2d
    from extended_gan_torch.parallel import fsdp

    bn = PerVertexBatchNorm2d(4, 3)
    bn.load_state_dict(case["state"])
    bn.axis = axis
    fsdp_placed([bn], axis, case.get("fsdp"))
    opt = torch.optim.SGD(bn.parameters(), lr=0.1)
    fsdp.refresh_after(opt, bn)
    x, dy = (axis.shard(torch.from_numpy(case[k])) for k in ("x", "dy"))
    y = bn(x)
    y.backward(dy)
    fsdp.reduce_grads(axis, fsdp.working(bn.parameters()), torch.zeros(1))
    opt.step()
    return {"y": _f32(axis.gather_rows(y.detach()).flatten(0, 1)),
            "state": _full_trees([bn])}


def tp_resume(axis: DataAxis, payload: dict) -> dict:
    """The DCGAN driver on this (data, model) mesh (the CPU) into
    ``payload["out"]``, checkpoints every epoch, tensor parallelism at
    ``payload["tp"]`` channels or off (``tp_min_channels`` above every
    width: the same mesh, no leaf cut). ``"cut"`` trains 1 epoch with TP,
    ``"plain"`` 1 without; ``"cut_plain"`` loads TP's checkpoint without TP
    and ``"plain_cut"`` the plain one with TP (a resume past the last
    epoch: the state as loaded); then ``"cut"`` resumes to 2 epochs with
    TP beside ``"whole"``, 2 epochs with TP in one run, and ``"cut_plain"``
    and ``"plain_cut"`` resume to 2 epochs crossing. Returns each run's
    nets' full state (``"<name> loaded"`` for the loads) and this rank's
    block shapes."""
    import shutil

    from extended_gan_torch.parallel import tensor
    from extended_gan_torch.train.dcgan_driver import train

    d, m = axis.size, axis.model.size
    kw = dict(payload["kw"], device="cpu", data_axis=d, model_axis=m,
              synthetic=True)
    out, res = payload["out"], {}

    def run(name, epochs, on, resume=False, label=None):
        nets, _ = train(**kw, epochs=epochs, resume=resume,
                        tp_min_channels=payload["tp"] if on else 1 << 30,
                        out_dir=os.path.join(out, name))
        res[label or name] = {
            "state": _full_trees(nets),
            "blocks": [sorted(tuple(p.shape) for p in tensor.tp_blocks(net))
                       for net in nets]}

    run("cut", 1, True, label="cut 1")
    run("plain", 1, False)
    if axis.is_main:
        shutil.copytree(os.path.join(out, "cut"),
                        os.path.join(out, "cut_plain"))
        shutil.copytree(os.path.join(out, "plain"),
                        os.path.join(out, "plain_cut"))
    dist.barrier()  # the copies are in place
    run("cut_plain", 1, False, resume=True, label="cut_plain loaded")
    run("plain_cut", 1, True, resume=True, label="plain_cut loaded")
    run("whole", 2, True)
    run("cut", 2, True, resume=True)
    run("cut_plain", 2, False, resume=True)
    run("plain_cut", 2, True, resume=True)
    return res


def tp_cases(axis: DataAxis, payload: dict) -> dict:
    """Everything the tensor parallelism rank tests run on ``axis``:
    :func:`fsdp_cases` of the payload, :func:`gan_step` of each
    ``"gan_sgd"`` case, :func:`one_step` of each ``"sgd"`` case, then
    :func:`tp_resume` where the payload has ``"tp_resume"``."""
    out = fsdp_cases(axis, payload)
    out.update({name: gan_step(case, axis)
                for name, case in payload.get("gan_sgd", {}).items()})
    out.update({name: one_step(case, axis)
                for name, case in payload.get("sgd", {}).items()})
    if "tp_resume" in payload:
        out["tp_resume"] = tp_resume(axis, payload["tp_resume"])
    return out


def fsdp_cases(axis: DataAxis, payload: dict) -> dict:
    """Everything the FSDP rank tests run on ``axis``: :func:`fsdp_gan_run`
    of each ``"gan"`` case, :func:`fsdp_model_run` of each ``"model"``
    case, :func:`fsdp_per_vertex_bn` of each ``"bn"`` case, then
    :func:`fsdp_resume` where the payload has ``"resume"``."""
    out = {name: fsdp_gan_run(case, axis)
           for name, case in payload.get("gan", {}).items()}
    out.update({name: fsdp_model_run(case, axis)
                for name, case in payload.get("model", {}).items()})
    out.update({name: fsdp_per_vertex_bn(case, axis)
                for name, case in payload.get("bn", {}).items()})
    if "resume" in payload:
        out["resume"] = fsdp_resume(axis, payload["resume"])
    return out
