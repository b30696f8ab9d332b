"""CycleGAN training driver (port of the single-device paths of
``extended_gan_tpu/train/cyclegan_driver.py``): ``python -m
extended_gan_torch.cycle_gan``.

Two DCGAN generators and two FrameDiscriminators (``train/
cyclegan_trainer.py``) on the coastal-sea ``.pt`` frames: seed 369, four
Adam optimizers (lr 2e-4, betas (0.5, 0.999)), loaders made anew each
epoch (seeded ``seed + epoch``) over the archive's ``train`` and ``test``
folders, ``nc`` frames in and ``nc`` out, then per epoch the train steps,
the eval pass (``pred_mse``, ``cycle_l1``), the results printed as JSON and
appended to the history. A missing archive falls back to a synthetic one
(three files of 64 frames at ``imsize``, as JAX's).

Every ``save_epoch`` epochs and at the last, the driver writes a checkpoint
under ``<out_dir>/checkpoints`` (``train/checkpoint.py``, keeping 2: the
four nets with their BatchNorm statistics, the four Adam states, the epoch,
the dropout stream's state and the ``mid`` subtree) and ``history.json``,
and only under ``out_dir``; with no ``out_dir`` it writes nothing (the JAX
driver's default is the repo's own ``cycle_gan/``). A SIGTERM
(``train/preempt.py``) stops the epoch after the current step or group of
K and writes a mid-epoch snapshot; ``resume=True`` restores the latest
checkpoint and continues bit for bit as the uninterrupted run would.
``precision="bf16"`` builds the nets with ``dtype=torch.bfloat16``. With
``out_dir``, each epoch's eval draws its first batch as
``<out_dir>/imgs/pred.png`` (on the resident path, the first eval batch
gathered on the device) and the end of the run the history's plots under
``<out_dir>/training_plots`` (JAX ``cyclegan_trainer.py:224-231``,
``cyclegan_driver.py:412-418, 456``; without matplotlib each prints one
line and nothing is drawn).

``megastep=K`` (K > 1) runs K steps a CUDA graph (``train/megastep.py``);
``resident=True`` copies the train and test splits to the device once
(``ResidentVideos.from_pt_frames``) and gathers each batch there, K steps a
graph (K = ``megastep``, else 8). On the card both use Adam with its step
count on the device (``capturable``) and register the dropout's generator
with the graphs.

``profile`` (or ``profile_trace_dir``) times each step's dispatch (a graph
replay under ``megastep``, a resident program) and the epoch
(``utils/profiling.py``), prints ``Step timing: {...}`` and adds its keys to
the epoch's results; ``profile_trace_dir`` also traces the first epoch with
``torch.profiler`` into that directory (JAX ``cyclegan_driver.py:120-124,
382-384``).

``packed_g`` builds both generators in the 2x2 space-to-depth layout
(``models/dcgan.py``; the same weights and state_dict), off by default as
in JAX (``None`` is off).

``data_axis`` N > 1 trains each global batch over the N ranks of a
process group, as the DCGAN driver does (``train/dcgan_driver.py``; JAX
``cyclegan_driver.py:92-223``): the four nets read the axis, rank 0's
weights go to every rank, each rank takes its rows of every batch, the
step sums the generators' and the discriminators' gradients over the
ranks (``cyclegan_trainer``), the eval sums are added over the ranks, a
SIGTERM to any rank stops every rank after the same step, and rank 0
alone writes; ``megastep`` and ``resident`` run under the axis with the
NCCL collectives inside each rank's CUDA graphs, and a resident train
batch must divide by the axis (JAX ``:165-169``).

The JAX driver's tensor/sequence/FSDP parallelism is not ported yet: a
keyword that sets one of them raises, naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import functools
import itertools
import os

import torch

from ..core.device import resolve_device
from ..core.precision import resolve_dtype
from ..core.prng import KeySeq
from ..data.resident import (
    ResidentVideos,
    draw_first_eval_batch,
    epoch_seed,
    make_cyclegan_resident_eval,
    make_cyclegan_resident_megastep,
    program_logs,
    resident_cyclegan_test,
)
from ..data.streaming import get_coastal_loaders
from ..data.synthetic import ensure_synthetic_coastal
from ..models.dcgan import FrameDiscriminator, Generator
from ..parallel import data_axis_for, join_data_axis
from ..utils.history import TrainingHistory
from ..utils.profiling import epoch_profiler, timed
from .checkpoint import (
    CYCLEGAN_NETS,
    gan_net_states,
    gan_states,
    run_gan_epochs,
    setup_gan_checkpointing,
)
from .cyclegan_trainer import (
    LOSS_LABELS,
    TRAIN_SUMS,
    make_cyclegan_eval_step,
    make_cyclegan_megastep,
    make_cyclegan_train_step,
    test,
)
from .dcgan_trainer import megastep_logs, step_logs
from .dcgan_trainer import train_single_epoch as gan_epoch
from .preempt import GracefulShutdown, any_rank_shutdown
from .state import report_in_sync
from .unported import refuse_unported

DEFAULT_DATA = "./datasets/data"
# an epoch's train metrics: ``train_mse``, and its ``mid`` when preempted
train_single_epoch = functools.partial(gan_epoch, keys=TRAIN_SUMS)

# keywords of JAX driver options the port does not have yet: (the value
# that means "off", the ROADMAP queue 1 item)
_NOT_PORTED = {
    "model_axis": (1, 9), "tp_min_channels": (256, 9),
    "fsdp": (False, 9), "fsdp_min_size": (4096, 9), "spatial": (False, 9),
}


def build_cyclegan(*, nc: int = 4, ndf: int = 64, lr: float = 2e-4,
                   beta1: float = 0.5, precision: str = "f32",
                   seed: int = 369, device=None, dropout: float = 0.01,
                   capturable: bool = False, keys=None,
                   packed_g: bool = False):
    """``((G_xy, G_yx, D_x, D_y), (their Adam optimizers))`` on ``device``
    (default: the CUDA card), computing in ``precision``'s dtype, the
    weights drawn in that order from a generator seeded ``seed``, the
    generators' channel dropout from ``keys`` (a ``core.prng.KeySeq`` on
    the device; default: one seeded ``seed``). ``capturable``: Adam keeps
    its step count on the card, for CUDA graphs. ``packed_g``: both
    generators in the 2x2 space-to-depth layout (JAX
    ``cyclegan_driver.py:47-51``)."""
    dev = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    drop = (keys or KeySeq(seed, device=dev)).generator
    dtype = resolve_dtype(precision)
    nets = tuple(
        Generator(nc, dropout, generator=init, dropout_generator=drop,
                  dtype=dtype, packed=packed_g) for _ in range(2)) + tuple(
        FrameDiscriminator(nc, ndf, generator=init, dtype=dtype)
        for _ in range(2))
    nets = tuple(net.to(dev) for net in nets)
    opts = tuple(torch.optim.Adam(net.parameters(), lr=lr,
                                  betas=(beta1, 0.999), eps=1e-8,
                                  capturable=capturable)
                 for net in nets)
    return nets, opts


def train(*, data_location: str | None = None, epochs: int = 10,
          train_batch_size: int = 32, test_batch_size: int = 64,
          imsize: int = 64, nc: int = 4, ndf: int = 64, lr: float = 2e-4,
          cycle_lambda: float = 10.0, precision: str = "f32",
          seed: int = 369, max_batches: int = 0, synthetic: bool = False,
          out_dir: str | None = None, log_every: int = 50,
          save_epoch: int = 0, resume: bool = False, megastep: int = 0,
          resident: bool = False, packed_g: bool | None = None,
          profile: bool = False, profile_trace_dir: str = "", device=None,
          data_axis: int | None = None, **options):
    """Train on ``device`` (default: the CUDA card, ``cuda:{LOCAL_RANK}``
    on a data axis over NCCL). Takes the JAX driver's keyword arguments.
    Returns ``((G_xy, G_yx, D_x, D_y), history)``."""
    refuse_unported(options, _NOT_PORTED)
    axis = data_axis_for(data_axis, device,
                         resident_batch=train_batch_size if resident else None)
    dev = axis.device
    graphs = dev.type == "cuda" and (megastep > 1 or resident)
    print(f"Using device: {dev}")
    if axis.parallel:
        print(f"Using data axis: {axis.size} ranks (rank {axis.rank})")
    data_location = data_location or DEFAULT_DATA
    if synthetic or not os.path.isdir(data_location):
        print(f"[cycle_gan] data not found at {data_location}; using "
              "synthetic coastal-sea data")
        data_location = ensure_synthetic_coastal(
            None, frames_per_file=64, h=imsize, w=imsize)
    packed_g = bool(packed_g)  # None: off, as in JAX
    if packed_g:
        print("[packed-g] generators in 2x2 space-to-depth layout")
    keys = KeySeq(seed, device=dev)  # the channel dropout's stream
    nets, opts = build_cyclegan(nc=nc, ndf=ndf, lr=lr, precision=precision,
                                seed=seed, device=dev, capturable=graphs,
                                keys=keys, packed_g=packed_g)
    join_data_axis(axis, *nets)
    profiler = epoch_profiler(profile, profile_trace_dir)
    step = timed(make_cyclegan_train_step(*nets, *opts,
                                          cycle_lambda=cycle_lambda,
                                          axis=axis), profiler)
    eval_step = make_cyclegan_eval_step(nets[0], nets[1])
    generators = (keys.generator,)  # registered with each CUDA graph
    if resident:
        train_store, test_store = (ResidentVideos.from_pt_frames(
            os.path.join(data_location, sub), dev, seq_len=nc, crop=imsize)
            for sub in ("train", "test"))
        resident_k = megastep if megastep > 1 else 8
        train_k = timed(make_cyclegan_resident_megastep(
            *nets, *opts, train_store, seq_len=nc, cycle_lambda=cycle_lambda,
            generators=generators, axis=axis), profiler)
        eval_k = make_cyclegan_resident_eval(nets[0], nets[1], test_store,
                                             seq_len=nc)
        mb = (train_store.nbytes + test_store.nbytes) / 1e6
        print(f"[resident] {train_store.n_windows} train + "
              f"{test_store.n_windows} test windows / {mb:.0f} MB live in "
              f"device memory; K={resident_k} steps per CUDA graph, "
              "index-only transfers")
    elif megastep > 1:
        megastep_fn = timed(make_cyclegan_megastep(
            *nets, *opts, cycle_lambda=cycle_lambda, generators=generators,
            axis=axis), profiler)
        print(f"[megastep] {megastep} steps per CUDA graph")

    # the figures go under out_dir only (JAX draws into its default
    # out_dir, the repo's own folder), from rank 0
    img_path = (os.path.join(out_dir, "imgs") if out_dir and axis.is_main
                else None)

    def epoch_feed(epoch, skip):
        """(the epoch's train logs, (a step's or a group's logs, the
        batches it counts) each, from batch ``skip`` on; its eval)."""
        if resident:
            # a resumed epoch starts at program skip // K of its order
            programs = program_logs(
                train_store, train_k, epoch_seed(seed, epoch), resident_k,
                train_batch_size, max_batches=max_batches,
                start=skip // resident_k, axis=axis)
            def evaluate():
                results = resident_cyclegan_test(
                    eval_k, test_store, k=resident_k,
                    batch_size=test_batch_size, axis=axis)
                if img_path is not None:
                    draw_first_eval_batch(
                        eval_step, test_store, in_seq_len=nc, out_seq_len=nc,
                        batch_size=test_batch_size, epoch=epoch,
                        img_path=img_path)
                return results

            return ((logs, resident_k) for logs, _ in programs), evaluate
        train_loader, test_loader = get_coastal_loaders(
            data_location, train_batch_size, test_batch_size, seq_len=nc,
            crop=imsize, seed=seed + epoch)
        batches = iter(train_loader)
        if skip:
            # replay the consumed batches: the same random draws as the run
            # that was cut
            print(f"[resume] skipping {skip} consumed batches of epoch "
                  f"{epoch}")
            for _ in range(skip):
                next(batches)
        if max_batches:
            batches = itertools.islice(batches, max(max_batches - skip, 0))
        if megastep > 1:
            logs = megastep_logs(batches, megastep_fn, dev, megastep,
                                 train_batch_size, axis=axis)
        else:
            logs = step_logs(batches, step, dev, log_every=log_every,
                             labels=LOSS_LABELS,
                             axis=axis if axis.parallel else None)
        return logs, lambda: test(test_loader, eval_step, dev,
                                  img_path=img_path, epoch=epoch, axis=axis)

    # restored before any graph is captured: a graph names the tensors it
    # was captured with
    ckpt_mgr, start_epoch, history, mid = setup_gan_checkpointing(
        out_dir, resume=resume, save_epoch=save_epoch if axis.is_main else 0,
        states=gan_net_states(nets, opts, CYCLEGAN_NETS), keys=keys,
        history=TrainingHistory())
    hist_path = os.path.join(out_dir, "history.json") if out_dir else None

    def snapshot(epoch, mid_tree):
        return {"states": gan_states(nets, opts, CYCLEGAN_NETS),
                "epoch": epoch, "key": keys.state, "mid": mid_tree}

    with GracefulShutdown() as local_shutdown:
        run_gan_epochs(epoch_feed, train_single_epoch,
                       shutdown=any_rank_shutdown(local_shutdown, axis),
                       ckpt_mgr=ckpt_mgr if axis.is_main else None,
                       snapshot=snapshot, history=history,
                       hist_path=hist_path, start_epoch=start_epoch,
                       epochs=epochs, save_epoch=save_epoch, mid=mid,
                       profiler=profiler)
    report_in_sync(axis, nets, opts)
    if out_dir and axis.is_main:
        history.save_path = os.path.join(out_dir, "training_plots")
        history.plot()
    return nets, history
