"""Train the DCGAN frame predictor with the PyTorch port.

  python -m extended_gan_torch.dcgan --epochs 1 --synthetic --out-dir /tmp/run

The flags mirror ``python -m dcgan``'s; that of its option that is not
ported yet (SP) is absent. ``--model-axis M`` adds a model axis (the CLI
starts D x M ranks, D the data axis) over which tensor parallelism cuts
FD's and TD's conv kernels of at least ``--tp-min-channels`` (default 256)
output channels by output channel. ``--fsdp`` shards every leaf
of G, FD and TD of at least ``--fsdp-min-size`` elements and its Adam
moments over the data axis (FSDP / ZeRO-3). ``--data-axis N`` trains
each global batch over N ranks: without a launcher environment the CLI
starts N processes itself, one a card over NCCL (N gloo processes with
``--device cpu``); under torchrun each process is one rank, and
``--multihost`` makes that explicit (it raises without a launcher
environment); unset, it is every visible card (one with ``--device cpu``),
as JAX's default is every device. ``--fused-disc`` and
``--fused-prop`` pick the step body and ``--packed-g`` the generator's 2x2
space-to-depth layout, all off by default, as in JAX.
``--profile`` records each epoch's step timing into its results, and
``--profile-trace-dir`` also writes a ``torch.profiler`` trace of the first
epoch there. ``--precision bf16`` computes in bfloat16 with float32 weights;
``--resume`` continues from the latest checkpoint under
``--out-dir``/checkpoints, and a SIGTERM stops a run resumably after the
current step (or group of K) when ``--out-dir`` is given. ``--megastep K`` runs K adversarial steps a CUDA
graph and ``--resident`` keeps the frame archive in device memory. ``--device`` picks the device:
the CUDA card by default, ``cpu`` on request. A missing archive falls back
to a synthetic one. ``history.json`` and the checkpoints (``checkpoints/``,
which ``python -m extended_gan_torch.serve export --workload dcgan`` reads)
go to ``--out-dir`` (default: nowhere).
"""

from __future__ import annotations

import argparse

from ..parallel.launch import start_ranks
from ..train.dcgan_driver import train


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m extended_gan_torch.dcgan")
    parser.add_argument("--data-location", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--train-batch-size", type=int, default=32)
    parser.add_argument("--test-batch-size", type=int, default=64)
    parser.add_argument("--precision", choices=("f32", "bf16"),
                        default="f32")
    parser.add_argument("--seed", type=int, default=369)
    parser.add_argument("--max-batches", type=int, default=0,
                        help="truncate each epoch (smoke runs)")
    parser.add_argument("--megastep", type=int, default=0,
                        help="K>1: capture K adversarial steps into ONE "
                             "CUDA graph (amortizes per-launch host "
                             "overhead K-ways)")
    parser.add_argument("--resident", action="store_true",
                        help="transfer the decoded training split to "
                             "device memory ONCE and gather windows "
                             "on-device; steady-state epochs move only "
                             "index programs (composes with --megastep as "
                             "the program length K, default 8)")
    parser.add_argument("--fused-disc", action="store_true",
                        help="batch each discriminator's real+fake passes "
                             "into one doubled-batch fwd/bwd (fewer serial "
                             "net passes per step; BN batch statistics mix "
                             "real and fake — a documented deviation)")
    parser.add_argument("--fused-prop", action="store_true",
                        help="FusedProp (arxiv 2004.03335): compute the "
                             "fake G->D chain once and pull the D-fake "
                             "and G gradients back through it before any "
                             "update. G trains against the PRE-update "
                             "discriminators (simultaneous update — a "
                             "documented deviation)")
    parser.add_argument("--packed-g", dest="packed_g", default=None,
                        action="store_true",
                        help="compute the generator in 2x2 space-to-depth "
                             "layout (identical function and state_dict). "
                             "Opt-in")
    parser.add_argument("--no-packed-g", dest="packed_g",
                        action="store_false")
    parser.add_argument("--synthetic", action="store_true",
                        help="force the synthetic dataset")
    parser.add_argument("--out-dir", type=str, default=None,
                        help="where history.json and checkpoints/ go "
                             "(default: nowhere)")
    parser.add_argument("--save-epoch", type=int, default=None,
                        help="checkpoint and write history.json every N "
                             "epochs and at the last (the reference's "
                             "params['save_epoch'] = 2; 0: never)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--profile", action="store_true",
                        help="record per-epoch step timing (steps/sec, "
                             "dispatch latency) into the history")
    parser.add_argument("--profile-trace-dir", type=str, default="",
                        help="capture a torch.profiler trace of the first "
                             "epoch into this directory (implies --profile)")
    parser.add_argument("--data-axis", type=int, default=None,
                        help="N: data parallelism over N ranks, one card "
                             "each (gloo processes with --device cpu); "
                             "default every visible card, one with --device "
                             "cpu")
    parser.add_argument("--model-axis", type=int, default=1,
                        help="mesh tensor-parallel axis size: FD's and TD's "
                             "wide convs cut by output channel over M ranks")
    parser.add_argument("--tp-min-channels", type=int, default=256,
                        help="conv kernels with at least this many output "
                             "channels are cut under --model-axis")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-shard params + Adam moments over the "
                             "data axis (one all-gather of each net's "
                             "shards after its optimizer step, one "
                             "reduce-scatter of its gradients)")
    parser.add_argument("--fsdp-min-size", type=int, default=4096,
                        help="leaves under this many elements stay "
                             "replicated under --fsdp")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group the launcher's "
                             "environment describes (torchrun); raises "
                             "without one")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    args = parser.parse_args(argv)
    if start_ranks("extended_gan_torch.dcgan.__main__:main", argv,
                   data_axis=args.data_axis, multihost=args.multihost,
                   device=args.device, model_axis=args.model_axis):
        return None
    return train(
        data_location=args.data_location, epochs=args.epochs,
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size, precision=args.precision,
        seed=args.seed, max_batches=args.max_batches,
        synthetic=args.synthetic, out_dir=args.out_dir,
        megastep=args.megastep, resident=args.resident, resume=args.resume,
        fused_disc=args.fused_disc, fused_prop=args.fused_prop,
        packed_g=args.packed_g,
        params=({"save_epoch": args.save_epoch}
                if args.save_epoch is not None else None),
        profile=args.profile, profile_trace_dir=args.profile_trace_dir,
        data_axis=args.data_axis, fsdp=args.fsdp,
        fsdp_min_size=args.fsdp_min_size, model_axis=args.model_axis,
        tp_min_channels=args.tp_min_channels, device=args.device)


if __name__ == "__main__":
    main()
