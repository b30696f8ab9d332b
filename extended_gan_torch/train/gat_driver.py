"""conv-GAT / U-Net training driver (port of the single-device streaming
path of ``extended_gan_tpu/train/gat_driver.py::train``).

Per epoch: fresh loaders seeded ``seed + epoch``, the LR line, the train
steps, the validation pass, the scheduler step on the validation loss,
``history.json`` and, when the validation loss is the best so far, the
model's ``state_dict`` as ``model.pt``. A missing KNMI archive falls back
to the synthetic one. At the end of a run one line reports how many times
each CUDA kernel was launched.

``megastep=K`` (K > 1) runs K train steps a CUDA graph
(``train/megastep.py``); ``resident=True`` copies the decoded train and
validation splits to the device once and gathers each batch there
(``data/resident.py``), K steps a graph (K = ``megastep``, else 8), so an
epoch moves only start indices. On the card both use Adam with its step
count on the device (``capturable``).

The JAX driver's mesh, tensor/sequence/FSDP/pipeline parallelism, MoE,
checkpoints and resume, profiling, bf16 and plots are not ported yet: a
config that sets one of them to anything but its default raises, naming
the ROADMAP item that ports it.
"""

from __future__ import annotations

import json
import os

import torch

from ..core.device import resolve_device
from ..data.resident import (
    ResidentVideos,
    epoch_seed,
    make_gat_resident_eval,
    make_gat_resident_megastep,
    program_logs,
    resident_gat_test,
)
from ..data.streaming import get_loaders
from ..data.synthetic import ensure_synthetic_kmni
from ..models.registry import build_model
from ..ops import launch_counts
from ..utils.history import save_history_json, update_history
from .gat_trainer import (
    gat_megastep_logs,
    gat_step_logs,
    make_gat_eval_step,
    make_gat_megastep,
    make_gat_train_step,
    test,
)
from .optim import current_lr, make_optimizer, make_scheduler, scheduler_step
from .unported import refuse_unported

# experiment-config keys and keywords of JAX driver options the port does
# not have yet: (the value that means "off", the ROADMAP queue 1 item)
_NOT_PORTED = {
    "precision": ("f32", 6), "resume": (False, 6), "checkpoint_every": (0, 6),
    "remat": (False, 6),
    "shuffle_mode": ("batch", 7),
    "data_axis": (None, 9), "model_axis": (1, 9), "tp_min_channels": (256, 9),
    "fsdp": (False, 9), "fsdp_min_size": (4096, 9), "spatial": (False, 9),
    "moe_experts": (0, 9), "moe_aux_weight": (0.01, 9),
    "pipeline_stages": (0, 9), "pp_microbatches": (0, 9),
    "conv_impl": ("auto", 10), "profile": (False, 10),
    "profile_trace_dir": ("", 10),
}


def train_single_epoch(*, epoch, model, train_steps, evaluate, scheduler,
                       history, output_path):
    """One epoch of the reference's loop: ``train_steps`` yields
    (running_nd, samples) a train step or a group of them, ``evaluate()``
    returns the validation metrics, which this returns too."""
    print(f"\nEpoch: {epoch}")
    print(f"LR: {current_lr(scheduler.optimizer)}")
    pending, total = [], 0  # running_nd pairs stay on the card; one fetch
    for nd, n in train_steps:
        pending.append(nd)
        total += n
    running = sum(nd[0] for nd in torch.stack(pending).tolist()) \
        if pending else 0.0
    train_loss = running / max(total, 1)
    print(f"Train loss: {round(float(train_loss), 6)}")
    history["train_loss"].append(float(train_loss))

    result = evaluate()
    scheduler_step(scheduler, result["val_loss"])
    print(json.dumps(result, indent=4))
    update_history(history, result)
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        save_history_json(history, output_path)
        if len(history["val_loss"]) == 1 or \
                result["val_loss"] < min(history["val_loss"][:-1]):
            print("Saving model.")
            torch.save(model.state_dict(),
                       os.path.join(output_path, "model.pt"))
    return result


def train(*, model_type: str = "temporal", optimizer: str = "adam",
          mapping_type: str = "linear", output_path: str = "",
          train_batch_size: int = 32, test_batch_size: int = 64,
          epochs: int = 10, learning_rate: float = 1e-3, lr_step: int = 1,
          gamma: float = 0.95, plot: bool = True, criterion: str = "mse",
          weight_decay: float = 0.01, downsample_size=(256, 256),
          preprocessed_folder: str = "", dataset: str = "kmni",
          test_first: bool = False, reduce_lr_on_plateau: bool = False,
          seed: int = 369, max_batches: int = 0,
          use_pallas: bool | None = None, megastep: int = 0,
          resident: bool = False, device=None, **options):
    """Train on ``device`` (default: the CUDA card). Takes the JAX driver's
    keyword arguments, every field of an experiment config among them;
    ``plot`` is accepted and ignored (plots are not ported). ``use_pallas=None`` runs the fused kernels exactly when
    the model sits on the card. Returns ``(model, history)``."""
    refuse_unported(options, _NOT_PORTED)
    if resident and dataset not in ("kmni", "synthetic", "arai"):
        raise ValueError(f"--resident supports the kmni/synthetic/arai "
                         f"datasets, not {dataset!r}")
    dev = resolve_device(device)
    downsample_size = tuple(downsample_size)
    print(f"Using device: {dev}")
    if dataset == "kmni" and not os.path.isdir(
            os.path.join(preprocessed_folder, "train")):
        print(f"[conv_gat] dataset not found at {preprocessed_folder!r}; "
              "using synthetic")
        dataset, preprocessed_folder = "synthetic", ""

    def loader_factory(train_bs=train_batch_size, test_bs=test_batch_size,
                       epoch=0):
        # seed + epoch: every epoch sees a new order, as the reference's
        # fresh per-epoch loaders do
        return get_loaders(train_bs, test_bs, preprocessed_folder,
                           dataset=dataset, downsample_size=downsample_size,
                           seed=seed + epoch)

    # probe a val batch for (H, W, T, V)
    x, _ = next(loader_factory()[1])
    _, image_width, image_height, steps, n_vertices = x.shape
    model = build_model(model_type, image_width=image_width,
                        image_height=image_height, n_vertices=n_vertices,
                        mapping_type=mapping_type, time_steps=steps,
                        use_pallas=use_pallas, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    graphs = dev.type == "cuda" and (megastep > 1 or resident)
    opt = make_optimizer(optimizer, model.parameters(), learning_rate,
                         weight_decay=weight_decay, capturable=graphs)
    scheduler = make_scheduler(opt, reduce_lr_on_plateau=reduce_lr_on_plateau,
                               lr_step=lr_step, gamma=gamma)
    print(f"Number of parameters: "
          f"{sum(p.numel() for p in model.parameters())}")
    print(f"Using mapping: {model.mapping_type}")
    step = make_gat_train_step(model, opt, criterion=criterion)
    eval_step = make_gat_eval_step(model)
    if resident:
        train_store, val_store = _resident_splits(
            dataset, preprocessed_folder, dev, steps, downsample_size)
        resident_k = megastep if megastep > 1 else 8
        train_k = make_gat_resident_megastep(model, opt, train_store,
                                             time_steps=steps,
                                             criterion=criterion)
        eval_k = make_gat_resident_eval(model, val_store, time_steps=steps)
        mb = (train_store.nbytes + val_store.nbytes) / 1e6
        print(f"[resident] {train_store.n_windows} train + "
              f"{val_store.n_windows} val windows / {mb:.0f} MB live in "
              f"device memory; K={resident_k} steps per CUDA graph, "
              "index-only transfers")
    elif megastep > 1:
        megastep_fn = make_gat_megastep(model, opt, criterion=criterion)
        print(f"[megastep] {megastep} steps per CUDA graph")

    def epoch_feed(epoch):
        """(the epoch's train steps as (running_nd, samples), its
        validation pass)."""
        if resident:
            programs = program_logs(
                train_store, train_k, epoch_seed(seed, epoch), resident_k,
                train_batch_size, max_batches=max_batches)
            return (((logs["running_nd"], n) for logs, n in programs),
                    lambda: resident_gat_test(eval_k, val_store,
                                              k=resident_k,
                                              batch_size=test_batch_size))
        train_loader, val_loader, _ = loader_factory(epoch=epoch)
        if megastep > 1:
            steps_ = gat_megastep_logs(train_loader, megastep_fn, dev,
                                       megastep, train_batch_size,
                                       max_batches=max_batches)
        else:
            steps_ = gat_step_logs(train_loader, step, dev,
                                   max_batches=max_batches)
        return steps_, lambda: test(eval_step, val_loader, dev)

    history: dict = {"train_loss": []}
    if test_first:
        tr_l, _, te_l = loader_factory()
        history["train_loss"].append(test(eval_step, tr_l, dev)["val_loss"])
        result = test(eval_step, te_l, dev)
        print(f"Test loss (without any training): {result['val_loss']:.6f}")
        update_history(history, result)
        print(json.dumps(result, indent=4))
    for epoch in range(1, epochs + 1):
        train_steps, evaluate = epoch_feed(epoch)
        train_single_epoch(epoch=epoch, model=model, train_steps=train_steps,
                           evaluate=evaluate, scheduler=scheduler,
                           history=history, output_path=output_path)
    print(json.dumps({"kernel_launches": launch_counts()}))
    return model, history


def _resident_splits(dataset, folder, device, steps, downsample_size):
    """The (train, validation) splits resident on ``device``: ARAI's
    ``training`` and ``validation``, KNMI's (or the synthetic archive's)
    ``train`` and ``test``."""
    if dataset == "arai":
        return tuple(ResidentVideos.from_arai(
            os.path.join(folder, sub), device, time_steps=steps,
            downsample_size=downsample_size)
            for sub in ("training", "validation"))
    if dataset == "synthetic":
        folder = ensure_synthetic_kmni(folder or None)
    return tuple(ResidentVideos.from_kmni(
        os.path.join(folder, sub), device, time_steps=steps,
        crop=downsample_size[0]) for sub in ("train", "test"))
