"""Train the CycleGAN with the PyTorch port.

  python -m extended_gan_torch.cycle_gan --epochs 1 --synthetic \
      --out-dir /tmp/run

The flags and defaults are ``python -m cycle_gan``'s, plus ``--device``
(the CUDA card by default, ``cpu`` on request). The JAX options that are
not ported yet (the model axis, FSDP, SP) are taken and refused by the
driver unless they are off. ``--data-axis N`` trains each global batch
over N ranks: without a launcher environment the CLI starts N processes
itself, one a card over NCCL (N gloo processes with ``--device cpu``);
under torchrun each process is one rank, and ``--multihost`` makes that
explicit (it raises without a launcher environment).
``--packed-g`` computes both generators in the 2x2 space-to-depth layout
(off by default, as in JAX). ``--precision bf16`` computes in bfloat16
with float32 weights; ``--megastep K`` runs K steps a CUDA graph and
``--resident`` keeps the frame archive in device memory; ``--resume``
continues from the latest checkpoint under ``--out-dir``/checkpoints, and
a SIGTERM stops a run resumably after the current step (or group of K)
when checkpoints are on (``--save-epoch``). A missing archive falls back to
a synthetic one. ``history.json`` and the checkpoints (which ``python -m
extended_gan_torch.serve export --workload cyclegan`` reads) go to
``--out-dir`` (default: nowhere). ``--profile`` records each epoch's step
timing into its results; ``--profile-trace-dir`` also writes a
``torch.profiler`` trace of the first epoch there.
"""

from __future__ import annotations

import argparse

from ..parallel.launch import start_ranks
from ..train.cyclegan_driver import train


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.cycle_gan")
    parser.add_argument("--data-location", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--train-batch-size", type=int, default=32)
    parser.add_argument("--test-batch-size", type=int, default=64)
    parser.add_argument("--imsize", type=int, default=64)
    parser.add_argument("--ndf", type=int, default=64)
    parser.add_argument("--cycle-lambda", type=float, default=10.0)
    parser.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    parser.add_argument("--seed", type=int, default=369)
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--out-dir", type=str, default=None,
                        help="where history.json and checkpoints/ go "
                             "(default: nowhere)")
    parser.add_argument("--save-epoch", type=int, default=0,
                        help="checkpoint every N epochs")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--profile", action="store_true",
                        help="record per-epoch step timing into the history")
    parser.add_argument("--profile-trace-dir", type=str, default="",
                        help="capture a torch.profiler trace of the first "
                             "epoch into this directory (implies --profile)")
    parser.add_argument("--data-axis", type=int, default=None,
                        help="N: data parallelism over N ranks, one card "
                             "each (gloo processes with --device cpu); "
                             "default one card")
    parser.add_argument("--model-axis", type=int, default=1,
                        help="mesh tensor-parallel axis size: not ported "
                             "yet, refused unless 1")
    parser.add_argument("--tp-min-channels", type=int, default=256)
    parser.add_argument("--fsdp", action="store_true",
                        help="not ported yet: refused")
    parser.add_argument("--fsdp-min-size", type=int, default=4096)
    parser.add_argument("--spatial", action="store_true",
                        help="not ported yet: refused")
    parser.add_argument("--megastep", type=int, default=0,
                        help="K>1: capture K CycleGAN steps into ONE CUDA "
                             "graph (amortizes per-launch host overhead "
                             "K-ways)")
    parser.add_argument("--resident", action="store_true",
                        help="transfer the decoded archive to device memory "
                             "ONCE and gather windows on-device; epochs "
                             "move only index programs (composes with "
                             "--megastep as the program length K, default "
                             "8)")
    parser.add_argument("--packed-g", dest="packed_g", default=None,
                        action="store_true",
                        help="compute both generators in 2x2 "
                             "space-to-depth layout (identical function "
                             "and state_dict). Opt-in")
    parser.add_argument("--no-packed-g", dest="packed_g",
                        action="store_false")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group the launcher's "
                             "environment describes (torchrun); raises "
                             "without one")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    args = parser.parse_args(argv)
    if start_ranks("extended_gan_torch.cycle_gan.__main__:main", argv,
                   data_axis=args.data_axis, multihost=args.multihost,
                   device=args.device):
        return None
    return train(
        data_location=args.data_location, epochs=args.epochs,
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size, imsize=args.imsize,
        ndf=args.ndf, cycle_lambda=args.cycle_lambda,
        precision=args.precision, seed=args.seed,
        max_batches=args.max_batches, synthetic=args.synthetic,
        out_dir=args.out_dir, save_epoch=args.save_epoch,
        resume=args.resume, resident=args.resident, profile=args.profile,
        profile_trace_dir=args.profile_trace_dir, data_axis=args.data_axis,
        model_axis=args.model_axis, tp_min_channels=args.tp_min_channels,
        fsdp=args.fsdp, fsdp_min_size=args.fsdp_min_size,
        spatial=args.spatial, packed_g=args.packed_g,
        megastep=args.megastep, device=args.device)


if __name__ == "__main__":
    main()
