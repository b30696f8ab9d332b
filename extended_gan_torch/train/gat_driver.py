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

State and robustness (JAX ``gat_driver.py:565-711``):

- ``precision="bf16"`` builds the model with ``dtype=torch.bfloat16``
  (``core/precision.py``); ``remat=True`` recomputes the forward during
  the backward (``gat_trainer.remat_forward``), in the single step and
  inside the captured graphs;
- with ``output_path`` and ``checkpoint_every`` (or ``resume``), full
  train-state checkpoints go to ``<output_path>/checkpoints`` (the model,
  Adam, the scheduler, the key stream, the epoch), every
  ``checkpoint_every`` epochs (every epoch at 0) and at the last;
- a SIGTERM (``train/preempt.py``) stops the epoch after the current step
  or group of K, and the driver writes a mid-epoch snapshot (its ``mid``:
  loader batches consumed, programs on the resident path, and the partial
  running loss) and returns; ``resume=True`` restores the latest snapshot,
  replays the consumed batches of a cut epoch and continues bit for bit as
  the uninterrupted run would.

Host data, profiling and the mapping's form (JAX ``gat_driver.py:272-357,
556-560``):

- ``shuffle_mode`` goes to the KNMI loaders (``"global"``: a permutation of
  every window of pools of files, ``data/streaming.py``); the loaders build
  their batches in the C++ core of ``data/native.py``;
- ``profile`` (or ``profile_trace_dir``) times each step's dispatch (a
  graph replay under ``megastep``, a resident program) and the epoch
  (``utils/profiling.py``), prints ``Step timing: {...}`` at the epoch's end
  and adds its keys to the history; ``profile_trace_dir`` also traces the
  first epoch with ``torch.profiler`` into that directory;
- ``conv_impl`` picks the conv mapping's form: ``"auto"`` is ``"nhwc"``
  (cuDNN), as in JAX, and ``"chanfirst"`` the positions-on-lanes form.

``moe_experts`` E > 0 builds the model with its Switch-MoE bottleneck
(``models/moe.py``; the ``unet`` family has one, the others print the JAX
registry's note) and ``moe_aux_weight`` weighs its load-balance loss in
every train step (JAX ``gat_driver.py:283-284, 374``); with no experts the
weight is 0.

With ``output_path``, after each epoch the driver draws the prediction
figure ``pred_{epoch}.png`` (the first rainy sample of a batch-2 loader,
predicted by the model on the device) and ``history_{epoch}.png`` (JAX
``gat_driver.py:673-684``; ``utils/viz.py``: without matplotlib each
prints one line and nothing is drawn). ``plot`` is accepted and ignored,
as in JAX, where only ``output_path`` decides.

``data_axis`` N > 1 trains each global batch over the N ranks of a
process group (``parallel/``: started by the CLI, or by torchrun with
``--multihost``): every rank builds the same loaders from the same seed
and takes its contiguous rows of each batch; the train step sums the
gradients over the ranks, BatchNorm's statistics run over the global
batch, the validation sums are added over the ranks, a SIGTERM to any
rank stops every rank after the same step, and rank 0 alone writes
``history.json``, ``model.pt``, checkpoints and figures (every rank
restores on resume). ``megastep`` and ``resident`` run under the axis
too: each rank's K steps are one CUDA graph with the steps' NCCL
collectives captured inside it (``train/megastep.py``); the streamed
groups are padded to a multiple of the axis and each rank takes its
even share, and a resident train batch must divide by the axis, as in
JAX (``:494-497``). ``None`` and 1 are one device without a group: the
path above, unchanged. The JAX driver's ``None`` is every device; the
port keeps one card until the data axis covers the MoE (JAX shards the
experts over the data axis, ``:421-432``), which it refuses, with
tensor, sequence, FSDP and pipeline parallelism: a config that sets one
of them to anything but its default raises, naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import torch
import torch.distributed as dist

from ..core.precision import resolve_dtype
from ..core.prng import KeySeq
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
from ..parallel import data_axis_for, join_data_axis
from ..utils.history import plot_history, save_history_json, update_history
from ..utils.profiling import epoch_profiler, timed
from ..utils.viz import visualize_gat_predictions
from .gat_trainer import (
    gat_megastep_logs,
    gat_step_logs,
    make_gat_eval_step,
    make_gat_megastep,
    make_gat_train_step,
    predict_batch,
    test,
)
from .checkpoint import (
    CheckpointManager,
    ckpt_step,
    describe_resume,
    empty_gat_mid,
)
from .optim import current_lr, make_optimizer, make_scheduler, scheduler_step
from .preempt import GracefulShutdown, any_rank_shutdown
from .state import NetState, param_count, report_in_sync
from .unported import refuse_unported

# experiment-config keys and keywords of JAX driver options the port does
# not have yet: (the value that means "off", the ROADMAP queue 1 item)
_NOT_PORTED = {
    "model_axis": (1, 9), "tp_min_channels": (256, 9),
    "fsdp": (False, 9), "fsdp_min_size": (4096, 9), "spatial": (False, 9),
    "pipeline_stages": (0, 9), "pp_microbatches": (0, 9),
}


def train_single_epoch(*, epoch, model, train_steps, evaluate, scheduler,
                       history, output_path, keys=None, shutdown=None,
                       start_batch=0, init_running=(0.0, 0), profiler=None):
    """One epoch of the reference's loop: ``train_steps`` yields
    (running_nd, samples, loader batches consumed, train steps) a train
    step or a group of them, or (None, 0, 1, 0) for a skipped batch
    (``keys`` draws one seed a train step, as the JAX driver does), and the
    shutdown flag is read after each; ``evaluate()`` returns the
    validation metrics.

    Returns ``(result, None)``, or ``(None, mid)`` when
    ``shutdown.requested`` is seen after a step (a group): ``mid`` holds the
    batches consumed (``start_batch`` of them before this call), the
    partial running-loss numerator and the samples so far, from
    ``init_running`` on (JAX ``gat_driver.py:47-210``). With a
    ``profiler`` (``utils/profiling.EpochProfiler``) the epoch is timed up
    to the fetch of its losses, and its stats join ``history``."""
    print(f"\nEpoch: {epoch}")
    print(f"LR: {current_lr(scheduler.optimizer)}")
    if profiler is not None:
        profiler.start_epoch()
    running, total = float(init_running[0]), int(init_running[1])
    n_done, interrupted = start_batch, False
    pending = []  # running_nd pairs stay on the card; one fetch
    for nd, n, consumed, steps in train_steps:
        if steps and keys is not None:
            keys.split(steps)
        if nd is not None:
            pending.append(nd)
        total += n
        n_done += consumed
        if shutdown is not None and shutdown.requested:
            interrupted = True
            break
    for nd in (torch.stack(pending).tolist() if pending else []):
        running += nd[0]
    if interrupted:
        print(f"[preempt] epoch {epoch} interrupted after {n_done} batches")
        return None, {"batch": torch.tensor(n_done, dtype=torch.int64),
                      "loss": torch.tensor(running, dtype=torch.float64),
                      "total": torch.tensor(total, dtype=torch.int64)}
    if profiler is not None:
        prof_stats = profiler.end_epoch()
        print(f"Step timing: {json.dumps(prof_stats)}")
        for k, v in prof_stats.items():
            history.setdefault(k, []).append(v)
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
    return result, None


def train(*, model_type: str = "temporal", optimizer: str = "adam",
          mapping_type: str = "linear", output_path: str = "",
          train_batch_size: int = 32, test_batch_size: int = 64,
          epochs: int = 10, learning_rate: float = 1e-3, lr_step: int = 1,
          gamma: float = 0.95, plot: bool = True, criterion: str = "mse",
          weight_decay: float = 0.01, downsample_size=(256, 256),
          preprocessed_folder: str = "", dataset: str = "kmni",
          test_first: bool = False, reduce_lr_on_plateau: bool = False,
          precision: str = "f32", seed: int = 369, max_batches: int = 0,
          resume: bool = False, checkpoint_every: int = 0,
          remat: bool = False, use_pallas: bool | None = None,
          megastep: int = 0, resident: bool = False,
          shuffle_mode: str = "batch", conv_impl: str = "auto",
          profile: bool = False, profile_trace_dir: str = "", device=None,
          moe_experts: int = 0, moe_aux_weight: float = 0.01,
          data_axis: int | None = None, **options):
    """Train on ``device`` (default: the CUDA card, ``cuda:{LOCAL_RANK}``
    on a data axis over NCCL). Takes the JAX driver's keyword arguments,
    every field of an experiment config among them; ``plot`` is accepted
    and ignored, as in JAX. ``use_pallas=None`` runs the fused kernels
    exactly when the model sits on the card. Returns ``(model,
    history)``."""
    refuse_unported(options, _NOT_PORTED)
    ranks = data_axis or (dist.get_world_size() if dist.is_initialized()
                          else 1)
    if moe_experts and ranks > 1:
        raise NotImplementedError(
            f"data_axis={ranks} with moe_experts is not ported yet (ROADMAP "
            "queue 1 item 9): JAX shards the experts over the data axis")
    axis = data_axis_for(data_axis, device,
                         resident_batch=train_batch_size if resident else None)
    if conv_impl == "auto":
        # chanfirst becomes the pick only after an A/B on the card shows a
        # win, as in JAX
        conv_impl = "nhwc"
    if resident and dataset not in ("kmni", "synthetic", "arai"):
        raise ValueError(f"--resident supports the kmni/synthetic/arai "
                         f"datasets, not {dataset!r}")
    dev = axis.device
    graphs = dev.type == "cuda" and (megastep > 1 or resident)
    downsample_size = tuple(downsample_size)
    print(f"Using device: {dev}")
    if axis.parallel:
        print(f"Using data axis: {axis.size} ranks (rank {axis.rank})")
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
                           merge_nodes=False, seed=seed + epoch,
                           shuffle_mode=shuffle_mode)

    # probe a val batch for (H, W, T, V)
    x, _ = next(loader_factory()[1])
    _, image_width, image_height, steps, n_vertices = x.shape
    model = build_model(model_type, image_width=image_width,
                        image_height=image_height, n_vertices=n_vertices,
                        mapping_type=mapping_type, time_steps=steps,
                        use_pallas=use_pallas, device=dev,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=resolve_dtype(precision), conv_impl=conv_impl,
                        moe_experts=moe_experts)
    join_data_axis(axis, model)
    keys = KeySeq(seed)
    opt = make_optimizer(optimizer, model.parameters(), learning_rate,
                         weight_decay=weight_decay, capturable=graphs)
    scheduler = make_scheduler(opt, reduce_lr_on_plateau=reduce_lr_on_plateau,
                               lr_step=lr_step, gamma=gamma)
    print(f"Number of parameters: {param_count(model)}")
    print(f"Using mapping: {model.mapping_type}")
    profiler = epoch_profiler(profile, profile_trace_dir)
    aux_w = moe_aux_weight if moe_experts else 0.0
    step = timed(make_gat_train_step(model, opt, criterion=criterion,
                                     remat=remat, moe_aux_weight=aux_w,
                                     axis=axis), profiler)
    eval_step = make_gat_eval_step(model)
    if resident:
        train_store, val_store = _resident_splits(
            dataset, preprocessed_folder, dev, steps, downsample_size)
        resident_k = megastep if megastep > 1 else 8
        train_k = timed(make_gat_resident_megastep(
            model, opt, train_store, time_steps=steps, criterion=criterion,
            remat=remat, moe_aux_weight=aux_w, axis=axis), profiler)
        eval_k = make_gat_resident_eval(model, val_store, time_steps=steps,
                                        axis=axis)
        mb = (train_store.nbytes + val_store.nbytes) / 1e6
        print(f"[resident] {train_store.n_windows} train + "
              f"{val_store.n_windows} val windows / {mb:.0f} MB live in "
              f"device memory; K={resident_k} steps per CUDA graph, "
              "index-only transfers")
    elif megastep > 1:
        megastep_fn = timed(make_gat_megastep(model, opt, criterion=criterion,
                                              remat=remat,
                                              moe_aux_weight=aux_w,
                                              axis=axis), profiler)
        print(f"[megastep] {megastep} steps per CUDA graph")

    def epoch_feed(epoch, skip):
        """(the epoch's train steps as (running_nd, samples, batches
        consumed, steps), its validation pass), from loader batch ``skip``
        on (program ``skip`` on the resident path)."""
        if resident:
            programs = program_logs(
                train_store, train_k, epoch_seed(seed, epoch), resident_k,
                train_batch_size, max_batches=max_batches, start=skip,
                axis=axis)
            return (((logs["running_nd"], n, 1, resident_k)
                     for logs, n in programs),
                    lambda: resident_gat_test(eval_k, val_store,
                                              k=resident_k,
                                              batch_size=test_batch_size))
        train_loader, val_loader, _ = loader_factory(epoch=epoch)
        batches = iter(train_loader)
        if skip:
            # replay the consumed batches: the loader makes the same random
            # draws as the run that was cut, so the rest of the epoch is
            # the same
            print(f"[resume] skipping {skip} consumed batches of epoch "
                  f"{epoch}")
            for _ in range(skip):
                next(batches)
        if max_batches:
            batches = itertools.islice(batches, max(max_batches - skip, 0))
        if megastep > 1:
            steps_ = gat_megastep_logs(batches, megastep_fn, dev, megastep,
                                       train_batch_size, axis=axis)
        else:
            steps_ = gat_step_logs(batches, step, dev, axis=axis)
        return steps_, lambda: test(eval_step, val_loader, dev, axis=axis)

    state = NetState(model, opt, scheduler)

    def snapshot(epoch, mid):
        best = getattr(scheduler, "best", math.inf)
        return {"state": state.state_dict(), "epoch": epoch,
                "lr": current_lr(opt), "best": float(best),
                "key": keys.state, "mid": mid}

    history: dict = {"train_loss": []}
    start_epoch, mid, ckpt_mgr = 1, empty_gat_mid(), None
    if output_path and (resume or checkpoint_every):
        ckpt_mgr = CheckpointManager(
            os.path.join(output_path, "checkpoints"), max_to_keep=2)
        if resume and ckpt_mgr.latest_step() is not None:
            template = snapshot(0, empty_gat_mid())
            if ckpt_mgr.sidecar_version() < 3:
                template.pop("mid")
            restored = ckpt_mgr.restore(template)
            # the model, Adam (with its step count where this run keeps
            # it) and the schedule: a mid-epoch snapshot holds the epoch's
            # schedule, which steps only after the validation pass
            state.load_state_dict(restored["state"])
            keys.state = restored["key"]
            mid = restored.get("mid", empty_gat_mid())
            start_epoch = describe_resume(mid, int(restored["epoch"]))
            hist_path = os.path.join(output_path, "history.json")
            if os.path.exists(hist_path):
                with open(hist_path) as f:
                    history = json.load(f)
    if test_first:
        tr_l, _, te_l = loader_factory()
        history["train_loss"].append(
            test(eval_step, tr_l, dev, axis=axis)["val_loss"])
        result = test(eval_step, te_l, dev, axis=axis)
        print(f"Test loss (without any training): {result['val_loss']:.6f}")
        update_history(history, result)
        print(json.dumps(result, indent=4))
    # rank 0 alone writes the run's files; every rank restored above
    writes = output_path if axis.is_main else ""
    if not axis.is_main:
        ckpt_mgr = None
    with GracefulShutdown() as local_shutdown:
        shutdown = any_rank_shutdown(local_shutdown, axis)
        for epoch in range(start_epoch, epochs + 1):
            skip = int(mid["batch"]) if epoch == start_epoch else 0
            train_steps, evaluate = epoch_feed(epoch, skip)
            _, mid_out = train_single_epoch(
                epoch=epoch, model=model, train_steps=train_steps,
                evaluate=evaluate, scheduler=scheduler, history=history,
                output_path=writes, keys=keys, shutdown=shutdown,
                start_batch=skip,
                init_running=(float(mid["loss"]), int(mid["total"]))
                if skip else (0.0, 0), profiler=profiler)
            if mid_out is not None:
                # step-granular preemption: a snapshot inside the epoch
                if ckpt_mgr is not None:
                    ckpt_mgr.save(ckpt_step(epoch, int(mid_out["batch"])),
                                  snapshot(epoch, mid_out))
                    print(f"[preempt] stopped resumably mid-epoch {epoch} "
                          f"({int(mid_out['batch'])} batches in)")
                elif axis.is_main:
                    print(f"[preempt] stopped mid-epoch {epoch} WITHOUT a "
                          "snapshot: no checkpointing configured (set "
                          "CHECKPOINT_EVERY / checkpoint_every); progress is "
                          "lost")
                break
            mid = empty_gat_mid()
            if writes:
                _, viz_loader, _ = loader_factory(2, 2)
                visualize_gat_predictions(
                    lambda xb: predict_batch(model, xb, dev), viz_loader,
                    epoch=epoch, path=writes,
                    power=float(getattr(viz_loader, "power", 1.0)))
                plot_history(history, title="Training History", save=True,
                             filename=os.path.join(writes,
                                                   f"history_{epoch}.png"))
            # read once: a SIGTERM between "save?" and "stop?" must not
            # stop without the snapshot
            preempted = shutdown.requested
            if ckpt_mgr is not None and (
                    not checkpoint_every or epoch % checkpoint_every == 0
                    or epoch == epochs or preempted):
                # an epoch-boundary snapshot is the start of epoch + 1
                ckpt_mgr.save(ckpt_step(epoch + 1, 0),
                              snapshot(epoch, empty_gat_mid()))
            if preempted:
                print(f"[preempt] stopped after epoch {epoch}"
                      + ("" if ckpt_mgr is not None or not axis.is_main else
                         " WITHOUT a snapshot: no checkpointing configured "
                         "(set CHECKPOINT_EVERY / checkpoint_every)"))
                break
    report_in_sync(axis, [model], [opt])
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
