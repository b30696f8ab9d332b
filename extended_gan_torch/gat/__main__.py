"""Train the conv-GAT family with the PyTorch port.

  # an experiment of convolutional_gat/experiments/, outputs to --output-path:
  python -m extended_gan_torch.gat generate_experiment \\
      --exp_folder_name final_smaatunet --output-path /tmp/run --epochs 1

  # or the settings given on the command line:
  python -m extended_gan_torch.gat train --model-type temporal \\
      --mapping-type conv --dataset synthetic --output-path /tmp/run

The actions and flags mirror ``python -m convolutional_gat``; the flags of
its options that are not ported yet (mesh, megastep, resident, MoE,
pipeline, profiling, bf16) are absent. ``--device`` picks the device: the
CUDA card by default, ``cpu`` on request. A missing KNMI archive falls back
to a synthetic one.
"""

from __future__ import annotations

import argparse

from ..train.gat_driver import train
from .generate_experiment import generate_experiment


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m extended_gan_torch.gat")
    parser.add_argument("action", choices=("train", "generate_experiment"))
    # None = "not set": generate_experiment keeps the config's value
    parser.add_argument("--train-batch-size", type=int, default=None)
    parser.add_argument("--test-batch-size", type=int, default=None)
    parser.add_argument("--exp_folder_name", type=str, default="")
    parser.add_argument("--model-type", type=str, default="temporal")
    parser.add_argument("--mapping-type", type=str, default="linear")
    parser.add_argument("--dataset", type=str, default="kmni")
    parser.add_argument("--preprocessed-folder", type=str, default="")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--downsample-size", type=int, nargs=2,
                        default=(20, 20))
    parser.add_argument("--output-path", type=str, default="",
                        help="where history.json and model.pt go (default: "
                             "nowhere)")
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--use-pallas", dest="use_pallas", default=None,
                        action="store_true",
                        help="force the fused CUDA kernels on (default: on "
                             "exactly when the model is on the card)")
    parser.add_argument("--no-use-pallas", dest="use_pallas",
                        action="store_false",
                        help="force the plain PyTorch versions")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    args = parser.parse_args(argv)
    if args.action == "train":
        return train(
            model_type=args.model_type, mapping_type=args.mapping_type,
            optimizer="adam", output_path=args.output_path,
            train_batch_size=args.train_batch_size or 32,
            test_batch_size=args.test_batch_size or 64,
            epochs=args.epochs or 10,
            learning_rate=args.learning_rate or 1e-3, lr_step=1, gamma=0.95,
            dataset=args.dataset,
            preprocessed_folder=args.preprocessed_folder,
            downsample_size=tuple(args.downsample_size),
            max_batches=args.max_batches, use_pallas=args.use_pallas,
            device=args.device)
    if not args.exp_folder_name:
        parser.error("generate_experiment needs --exp_folder_name")
    return generate_experiment(
        args.exp_folder_name, output_path=args.output_path,
        device=args.device, train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size, epochs=args.epochs,
        learning_rate=args.learning_rate,
        max_batches=args.max_batches or None, use_pallas=args.use_pallas)


if __name__ == "__main__":
    main()
