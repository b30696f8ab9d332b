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
statistics, the three Adam states, the epoch, the dropout generator's
state) and ``history.json``, and only under ``out_dir``; with no
``out_dir`` it writes nothing (the JAX driver's default, the repo's own
``dcgan/``, holds a committed history). Resuming from a checkpoint is not
ported (ROADMAP queue 1 item 6). The figures and plots are not ported.

``megastep=K`` (K > 1) runs K adversarial steps a CUDA graph
(``train/megastep.py``); ``resident=True`` copies the train and test splits
to the device once and gathers each batch there (``data/resident.py``), K
steps a graph (K = ``megastep``, else 8). On the card both use Adam with
its step count on the device (``capturable``) and register the dropout's
generator with the graphs.

The JAX driver's mesh, tensor/sequence/FSDP parallelism, bf16, resume,
profiling and its step variants (fused_disc, fused_prop, packed_g) are not
ported yet: a keyword that sets one of them raises, naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import itertools
import json
import os

import torch

from ..core.device import resolve_device
from ..data.resident import (
    ResidentVideos,
    epoch_seed,
    make_dcgan_resident_eval,
    make_dcgan_resident_megastep,
    program_logs,
    resident_dcgan_test,
)
from ..data.streaming import get_h5_loaders
from ..data.synthetic import ensure_synthetic_h5
from ..models.dcgan import FrameDiscriminator, Generator, TemporalDiscriminator
from ..utils.history import TrainingHistory
from .checkpoint import (
    ckpt_step,
    empty_mid,
    gan_states,
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
    "precision": ("f32", 6), "resume": (False, 6),
    "data_axis": (None, 9), "model_axis": (1, 9), "tp_min_channels": (256, 9),
    "fsdp": (False, 9), "fsdp_min_size": (4096, 9), "spatial": (False, 9),
    "fused_disc": (False, 10), "fused_prop": (False, 10),
    "packed_g": ((None, False), 10), "profile": (False, 10),
    "profile_trace_dir": ("", 10),
}


def build_dcgan(params: dict, *, seed: int, device=None, dropout=0.01,
                capturable=False):
    """``((G, FD, TD), (their Adam optimizers))`` on ``device`` (default:
    the CUDA card), the weights drawn from a generator seeded ``seed``, the
    channel dropout from one on the device, seeded ``seed`` too.
    ``capturable``: Adam keeps its step count on the card, for CUDA
    graphs."""
    dev = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    drop = torch.Generator(device=dev).manual_seed(seed)
    nc, ndf = params["nc"], params["ndf"]
    nets = (
        Generator(nc, dropout, generator=init, dropout_generator=drop),
        FrameDiscriminator(nc, ndf, generator=init),
        TemporalDiscriminator(nc, ndf, dropout, generator=init,
                              dropout_generator=drop),
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
          megastep: int = 0, resident: bool = False, device=None,
          **options):
    """Train on ``device`` (default: the CUDA card). Takes the JAX driver's
    keyword arguments. Returns ``((G, FD, TD), history)``."""
    refuse_unported(options, _NOT_PORTED)
    params = {**DEFAULT_PARAMS, **(params or {})}
    if epochs is not None:
        params["nepochs"] = epochs
    dev = resolve_device(device)
    print(f"Using device: {dev}")
    data_location = data_location or DEFAULT_DATA
    if synthetic or not os.path.isdir(data_location):
        print(f"[dcgan] data not found at {data_location}; using the "
              "synthetic archive")
        data_location = ensure_synthetic_h5(
            None, frames_train=256, frames_test=64, h=params["imsize"],
            w=params["imsize"])
    print("Random Seed: ", seed)
    nets, opts = build_dcgan(params, seed=seed, device=dev,
                             capturable=dev.type == "cuda"
                             and (megastep > 1 or resident))
    step = make_dcgan_train_step(*nets, *opts)
    eval_step = make_dcgan_eval_step(*nets)
    dropout_generator = nets[0].ConvBlock_0.dropout_generator
    generators = (dropout_generator,)  # registered with each CUDA graph
    if resident:
        train_store, test_store = (ResidentVideos.from_h5(
            os.path.join(data_location, sub), dev, in_seq_len=params["nc"],
            out_seq_len=params["nc"], crop=params["imsize"])
            for sub in ("train", "test"))
        resident_k = megastep if megastep > 1 else 8
        train_k = make_dcgan_resident_megastep(
            *nets, *opts, train_store, in_seq_len=params["nc"],
            out_seq_len=params["nc"], generators=generators)
        eval_k = make_dcgan_resident_eval(*nets, test_store,
                                          in_seq_len=params["nc"],
                                          out_seq_len=params["nc"])
        mb = (train_store.nbytes + test_store.nbytes) / 1e6
        print(f"[resident] {train_store.n_windows} train + "
              f"{test_store.n_windows} test windows / {mb:.0f} MB live in "
              f"device memory; K={resident_k} steps per CUDA graph, "
              "index-only transfers")
    elif megastep > 1:
        megastep_fn = make_dcgan_megastep(*nets, *opts, generators=generators)
        print(f"[megastep] {megastep} steps per CUDA graph")

    def epoch_feed(epoch):
        """(the epoch's train logs, a step or a group of them each; its
        test pass)."""
        if resident:
            programs = program_logs(
                train_store, train_k, epoch_seed(seed, epoch), resident_k,
                train_batch_size, max_batches=max_batches)
            return ((logs for logs, _ in programs),
                    lambda: resident_dcgan_test(eval_k, test_store,
                                                k=resident_k,
                                                batch_size=test_batch_size))
        train_loader, test_loader = get_h5_loaders(
            data_location, train_batch_size, test_batch_size,
            crop=params["imsize"], in_seq_len=params["nc"],
            out_seq_len=params["nc"], seed=seed + epoch)
        batches = iter(train_loader)
        if max_batches:
            batches = itertools.islice(batches, max_batches)
        if megastep > 1:
            logs = megastep_logs(batches, megastep_fn, dev, megastep,
                                 train_batch_size)
        else:
            logs = step_logs(batches, step, dev)
        return logs, lambda: test(test_loader, eval_step, dev)

    history = TrainingHistory()
    save_epoch = int(params.get("save_epoch") or 0)
    ckpt_mgr = setup_gan_checkpointing(out_dir, save_epoch=save_epoch)
    for epoch in range(1, params["nepochs"] + 1):
        logs, evaluate = epoch_feed(epoch)
        results = train_single_epoch(logs)
        results |= evaluate()
        print(json.dumps(results, indent=4))
        history.append(results)
        if ckpt_mgr is not None and (epoch % save_epoch == 0
                                     or epoch == params["nepochs"]):
            # an epoch-boundary snapshot is the start of epoch + 1
            ckpt_mgr.save(ckpt_step(epoch + 1, 0), {
                "states": gan_states(nets, opts), "epoch": epoch,
                "key": dropout_generator.get_state(), "mid": empty_mid()})
            history.to_json(os.path.join(out_dir, "history.json"))
    return nets, history
