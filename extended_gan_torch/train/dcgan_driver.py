"""DCGAN training driver (port of the single-device streaming path of
``extended_gan_tpu/train/dcgan_driver.py``): ``python -m
extended_gan_torch.dcgan``.

Seed 369, the reference's params dict, three Adam optimizers (lr 2e-4,
betas (0.5, 0.999)), loaders made anew each epoch (seeded ``seed +
epoch``) over the archive's ``train`` and ``test`` folders, then per epoch
the train steps, the eval pass, the results printed as JSON and appended
to the history. A missing archive falls back to a synthetic one.

Every ``save_epoch`` epochs and at the last, the driver writes a
checkpoint under ``<out_dir>/checkpoints`` (``train/checkpoint.py``,
keeping 2, as the JAX driver does: the three nets with their BatchNorm
statistics, the three Adam states, the epoch, the dropout stream's state)
and ``history.json``, and only under ``out_dir``; with no ``out_dir`` it
writes nothing (the JAX driver's default, the repo's own ``dcgan/``, holds
a committed history). A SIGTERM (``train/preempt.py``) stops the epoch
after the current step or group of K and writes a mid-epoch snapshot;
``resume=True`` restores the latest checkpoint (a cut epoch is redone from
its consumed batches, replayed) and continues bit for bit as the
uninterrupted run would. ``precision="bf16"`` builds the nets with
``dtype=torch.bfloat16`` (``core/precision.py``). With ``out_dir``, each
epoch's eval draws its first batch as ``<out_dir>/imgs/pred.png`` (on the
resident path, the first eval batch gathered on the device) and the end of
the run the history's plots under ``<out_dir>/training_plots`` (JAX
``dcgan_trainer.py:832-842``, ``dcgan_driver.py:389-395, 435``; without
matplotlib each prints one line and nothing is drawn).

``megastep=K`` (K > 1) runs K adversarial steps a CUDA graph
(``train/megastep.py``); ``resident=True`` copies the train and test splits
to the device once and gathers each batch there (``data/resident.py``), K
steps a graph (K = ``megastep``, else 8). On the card both use Adam with
its step count on the device (``capturable``) and register the dropout's
generator with the graphs.

``profile`` (or ``profile_trace_dir``) times each step's dispatch (a graph
replay under ``megastep``, a resident program) and the epoch
(``utils/profiling.py``), prints ``Step timing: {...}`` and adds its keys to
the epoch's results; ``profile_trace_dir`` also traces the first epoch with
``torch.profiler`` into that directory (JAX ``dcgan_driver.py:260-264``).

``fused_disc`` and ``fused_prop`` pick the step body
(``train/dcgan_trainer.py::make_dcgan_train_step``), ``packed_g`` builds the
generator in the 2x2 space-to-depth layout (``models/dcgan.py``), each on
the single-step, megastep and resident paths; all three are off by
default, as in JAX (``packed_g=None`` is off).

``data_axis`` N > 1 trains each global batch over the N ranks of a
process group (``parallel/``: started by the CLI, or by torchrun with
``--multihost``; JAX ``dcgan_driver.py:92-245``): G, FD and TD read the
axis (cross-rank BatchNorm, dropout masks drawn over the global batch),
rank 0's weights go to every rank, every rank builds the same loaders
from the same seed and takes its contiguous rows of each batch, the step
sums D's and G's gradients over the ranks (``dcgan_trainer``), the eval
sums are added over the ranks, a SIGTERM to any rank stops every rank
after the same step, and rank 0 alone writes ``history.json``, the
checkpoints and the figures (every rank restores on resume).
``megastep`` and ``resident`` run under the axis with the steps' NCCL
collectives inside each rank's CUDA graphs; a resident train batch must
divide by the axis, as in JAX (``:216-220``). ``None`` and 1 are one
device without a group.

The JAX driver's tensor/sequence/FSDP parallelism is not ported yet: a
keyword that sets one of them raises, naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import itertools
import os

import torch

from ..core.device import resolve_device
from ..core.precision import resolve_dtype
from ..core.prng import KeySeq
from ..data.resident import (
    ResidentVideos,
    epoch_seed,
    make_dcgan_resident_eval,
    draw_first_eval_batch,
    make_dcgan_resident_megastep,
    program_logs,
    resident_dcgan_test,
)
from ..data.streaming import get_h5_loaders
from ..data.synthetic import ensure_synthetic_h5
from ..models.dcgan import FrameDiscriminator, Generator, TemporalDiscriminator
from ..parallel import data_axis_for, join_data_axis
from ..utils.history import TrainingHistory
from ..utils.profiling import epoch_profiler, timed
from .checkpoint import (
    gan_net_states,
    gan_states,
    run_gan_epochs,
    setup_gan_checkpointing,
)
from .dcgan_trainer import (
    make_dcgan_eval_step,
    make_dcgan_megastep,
    make_dcgan_train_step,
    megastep_logs,
    step_logs,
    test,
    train_single_epoch,
)
from .preempt import GracefulShutdown, any_rank_shutdown
from .state import report_in_sync
from .unported import refuse_unported

DEFAULT_PARAMS = {
    "bsize": 128,       # the reference's batch size (the CLI's is 32)
    "imsize": 64,       # spatial size
    "nc": 4,            # frames in, and frames out
    "nz": 100,          # latent size (unused: G is conditional)
    "ngf": 64,
    "ndf": 64,
    "nepochs": 10,
    "lr": 0.0002,
    "beta1": 0.5,
    "save_epoch": 2,
}
DEFAULT_DATA = "/mnt/tmp/multi_channel_train_test"

# keywords of JAX driver options the port does not have yet: (the value
# that means "off", the ROADMAP queue 1 item)
_NOT_PORTED = {
    "model_axis": (1, 9), "tp_min_channels": (256, 9),
    "fsdp": (False, 9), "fsdp_min_size": (4096, 9), "spatial": (False, 9),
}


def build_dcgan(params: dict, *, seed: int, device=None, dropout=0.01,
                capturable=False, precision: str = "f32", keys=None,
                packed_g: bool = False):
    """``((G, FD, TD), (their Adam optimizers))`` on ``device`` (default:
    the CUDA card), computing in ``precision``'s dtype, the weights drawn
    from a generator seeded ``seed``, the channel dropout from ``keys`` (a
    ``core.prng.KeySeq`` on the device; default: one seeded ``seed``).
    ``capturable``: Adam keeps its step count on the card, for CUDA
    graphs. ``packed_g``: G in the 2x2 space-to-depth layout, with the
    same weights and state_dict (JAX ``dcgan_driver.py:50-76``)."""
    dev = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    drop = (keys or KeySeq(seed, device=dev)).generator
    nc, ndf = params["nc"], params["ndf"]
    dtype = resolve_dtype(precision)
    nets = (
        Generator(nc, dropout, generator=init, dropout_generator=drop,
                  dtype=dtype, packed=packed_g),
        FrameDiscriminator(nc, ndf, generator=init, dtype=dtype),
        TemporalDiscriminator(nc, ndf, dropout, generator=init,
                              dropout_generator=drop, dtype=dtype),
    )
    nets = tuple(net.to(dev) for net in nets)
    opts = tuple(torch.optim.Adam(net.parameters(), lr=params["lr"],
                                  betas=(params["beta1"], 0.999), eps=1e-8,
                                  capturable=capturable)
                 for net in nets)
    return nets, opts


def train(*, data_location: str | None = None, epochs: int | None = None,
          train_batch_size: int = 32, test_batch_size: int = 64,
          seed: int = 369, max_batches: int = 0, synthetic: bool = False,
          out_dir: str | None = None, params: dict | None = None,
          precision: str = "f32", resume: bool = False, megastep: int = 0,
          resident: bool = False, fused_disc: bool = False,
          fused_prop: bool = False, packed_g: bool | None = None,
          profile: bool = False, profile_trace_dir: str = "", device=None,
          data_axis: int | None = None, **options):
    """Train on ``device`` (default: the CUDA card, ``cuda:{LOCAL_RANK}``
    on a data axis over NCCL). Takes the JAX driver's keyword arguments.
    Returns ``((G, FD, TD), history)``."""
    refuse_unported(options, _NOT_PORTED)
    params = {**DEFAULT_PARAMS, **(params or {})}
    if epochs is not None:
        params["nepochs"] = epochs
    axis = data_axis_for(data_axis, device,
                         resident_batch=train_batch_size if resident else None)
    dev = axis.device
    graphs = dev.type == "cuda" and (megastep > 1 or resident)
    print(f"Using device: {dev}")
    if axis.parallel:
        print(f"Using data axis: {axis.size} ranks (rank {axis.rank})")
    data_location = data_location or DEFAULT_DATA
    if synthetic or not os.path.isdir(data_location):
        print(f"[dcgan] data not found at {data_location}; using the "
              "synthetic archive")
        data_location = ensure_synthetic_h5(
            None, frames_train=256, frames_test=64, h=params["imsize"],
            w=params["imsize"])
    print("Random Seed: ", seed)
    packed_g = bool(packed_g)  # None: off, as in JAX
    if packed_g:
        print("[packed-g] generator in 2x2 space-to-depth layout")
    keys = KeySeq(seed, device=dev)  # the channel dropout's stream
    nets, opts = build_dcgan(params, seed=seed, device=dev,
                             capturable=graphs, precision=precision,
                             keys=keys, packed_g=packed_g)
    join_data_axis(axis, *nets)
    if fused_disc:
        print("[fused-disc] doubled-batch discriminator passes "
              "(mixed real+fake BN statistics)")
    if fused_prop:
        print("[fused-prop] shared fake G->D pass, 2-cotangent backward "
              "(G trains against the PRE-update discriminators)")
    body = dict(fused_disc=fused_disc, fused_prop=fused_prop, axis=axis)
    profiler = epoch_profiler(profile, profile_trace_dir)
    step = timed(make_dcgan_train_step(*nets, *opts, **body), profiler)
    eval_step = make_dcgan_eval_step(*nets)
    generators = (keys.generator,)  # registered with each CUDA graph
    if resident:
        train_store, test_store = (ResidentVideos.from_h5(
            os.path.join(data_location, sub), dev, in_seq_len=params["nc"],
            out_seq_len=params["nc"], crop=params["imsize"])
            for sub in ("train", "test"))
        resident_k = megastep if megastep > 1 else 8
        train_k = timed(make_dcgan_resident_megastep(
            *nets, *opts, train_store, in_seq_len=params["nc"],
            out_seq_len=params["nc"], generators=generators, **body),
            profiler)
        eval_k = make_dcgan_resident_eval(*nets, test_store,
                                          in_seq_len=params["nc"],
                                          out_seq_len=params["nc"])
        mb = (train_store.nbytes + test_store.nbytes) / 1e6
        print(f"[resident] {train_store.n_windows} train + "
              f"{test_store.n_windows} test windows / {mb:.0f} MB live in "
              f"device memory; K={resident_k} steps per CUDA graph, "
              "index-only transfers")
    elif megastep > 1:
        megastep_fn = timed(make_dcgan_megastep(*nets, *opts,
                                                generators=generators,
                                                **body),
                            profiler)
        print(f"[megastep] {megastep} steps per CUDA graph")

    # the figures go under out_dir only (JAX draws into its default
    # out_dir, the repo's own folder), from rank 0
    img_path = (os.path.join(out_dir, "imgs") if out_dir and axis.is_main
                else None)

    def epoch_feed(epoch, skip):
        """(the epoch's train logs, (a step's or a group's logs, the
        batches it counts) each, from batch ``skip`` on; its test pass)."""
        if resident:
            # a resumed epoch starts at program skip // K of its order
            programs = program_logs(
                train_store, train_k, epoch_seed(seed, epoch), resident_k,
                train_batch_size, max_batches=max_batches,
                start=skip // resident_k, axis=axis)
            def evaluate():
                results = resident_dcgan_test(eval_k, test_store,
                                              k=resident_k,
                                              batch_size=test_batch_size,
                                              axis=axis)
                if img_path is not None:
                    draw_first_eval_batch(
                        eval_step, test_store, in_seq_len=params["nc"],
                        out_seq_len=params["nc"], batch_size=test_batch_size,
                        epoch=epoch, img_path=img_path)
                return results

            return ((logs, resident_k) for logs, _ in programs), evaluate
        train_loader, test_loader = get_h5_loaders(
            data_location, train_batch_size, test_batch_size,
            crop=params["imsize"], in_seq_len=params["nc"],
            out_seq_len=params["nc"], seed=seed + epoch)
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
            logs = step_logs(batches, step, dev,
                             axis=axis if axis.parallel else None)
        return logs, lambda: test(test_loader, eval_step, dev,
                                  img_path=img_path, epoch=epoch, axis=axis)

    save_epoch = int(params.get("save_epoch") or 0)
    # restored before any graph is captured: a graph names the tensors it
    # was captured with
    ckpt_mgr, start_epoch, history, mid = setup_gan_checkpointing(
        out_dir, resume=resume, save_epoch=save_epoch if axis.is_main else 0,
        states=gan_net_states(nets, opts), keys=keys,
        history=TrainingHistory())
    hist_path = os.path.join(out_dir, "history.json") if out_dir else None

    def snapshot(epoch, mid_tree):
        return {"states": gan_states(nets, opts), "epoch": epoch,
                "key": keys.state, "mid": mid_tree}

    with GracefulShutdown() as local_shutdown:
        run_gan_epochs(epoch_feed, train_single_epoch,
                       shutdown=any_rank_shutdown(local_shutdown, axis),
                       ckpt_mgr=ckpt_mgr if axis.is_main else None,
                       snapshot=snapshot, history=history,
                       hist_path=hist_path, start_epoch=start_epoch,
                       epochs=params["nepochs"], save_epoch=save_epoch,
                       mid=mid, profiler=profiler)
    report_in_sync(axis, nets, opts)
    if out_dir and axis.is_main:
        history.save_path = os.path.join(out_dir, "training_plots")
        history.plot()
    return nets, history
