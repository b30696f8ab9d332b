"""Train the DCGAN frame predictor with the PyTorch port.

  python -m extended_gan_torch.dcgan --epochs 1 --synthetic --out-dir /tmp/run

The flags mirror ``python -m dcgan``'s; those of its options that are not
ported yet (mesh, FSDP, SP, resume, bf16, the step variants, profiling,
multi-host) are absent. ``--megastep K`` runs K adversarial steps a CUDA
graph and ``--resident`` keeps the frame archive in device memory. ``--device`` picks the device:
the CUDA card by default, ``cpu`` on request. A missing archive falls back
to a synthetic one. ``history.json`` and the checkpoints (``checkpoints/``,
which ``python -m extended_gan_torch.serve export --workload dcgan`` reads)
go to ``--out-dir`` (default: nowhere).
"""

from __future__ import annotations

import argparse

from ..train.dcgan_driver import train


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m extended_gan_torch.dcgan")
    parser.add_argument("--data-location", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--train-batch-size", type=int, default=32)
    parser.add_argument("--test-batch-size", type=int, default=64)
    parser.add_argument("--precision", choices=("f32",), default="f32",
                        help="bf16 is not ported yet")
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
    parser.add_argument("--synthetic", action="store_true",
                        help="force the synthetic dataset")
    parser.add_argument("--out-dir", type=str, default=None,
                        help="where history.json and checkpoints/ go "
                             "(default: nowhere)")
    parser.add_argument("--save-epoch", type=int, default=None,
                        help="checkpoint and write history.json every N "
                             "epochs and at the last (the reference's "
                             "params['save_epoch'] = 2; 0: never)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    args = parser.parse_args(argv)
    return train(
        data_location=args.data_location, epochs=args.epochs,
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size, precision=args.precision,
        seed=args.seed, max_batches=args.max_batches,
        synthetic=args.synthetic, out_dir=args.out_dir,
        megastep=args.megastep, resident=args.resident,
        params=({"save_epoch": args.save_epoch}
                if args.save_epoch is not None else None),
        device=args.device)


if __name__ == "__main__":
    main()
