"""Train the conv-GAT family with the PyTorch port.

  # an experiment of convolutional_gat/experiments/, outputs to --output-path:
  python -m extended_gan_torch.gat generate_experiment \\
      --exp_folder_name final_smaatunet --output-path /tmp/run --epochs 1

  # or the settings given on the command line:
  python -m extended_gan_torch.gat train --model-type temporal \\
      --mapping-type conv --dataset synthetic --output-path /tmp/run

The actions and flags mirror ``python -m convolutional_gat``; the flags of
its options that are not ported yet (the model axis, FSDP, spatial and
pipeline parallelism) are absent. ``--data-axis N`` (config key
DATA_AXIS) trains each global batch over N ranks: without a launcher
environment the CLI starts N processes itself, one a card over NCCL (N
gloo processes with ``--device cpu``), and passes a SIGTERM on to them;
under torchrun each process is one rank, and ``--multihost`` makes that
explicit (it raises without a launcher environment). The default, one
card without a process group, is the JAX CLI's only where one device is
visible: JAX's default is every device.
``--moe-experts E`` gives the ``unet`` family its Switch-MoE bottleneck of E
experts and ``--moe-aux-weight`` (default 0.01) weighs its load-balance
loss (config keys MOE_EXPERTS and MOE_AUX_WEIGHT).
``--profile`` records each epoch's step timing into history.json,
``--profile-trace-dir`` also writes a ``torch.profiler`` trace of the first
epoch there, and ``--conv-impl chanfirst`` runs the conv mapping in its
positions-on-lanes form (``auto`` is ``nhwc``, cuDNN); the global shuffle
is the config key SHUFFLE_MODE, as in JAX. ``--precision bf16`` computes in
bfloat16 with float32 weights (config key PRECISION). ``--megastep K`` runs K train steps a CUDA graph
and ``--resident`` keeps the decoded archive in device memory. As in the
JAX CLI there is no ``--resume`` flag: ``generate_experiment`` takes the
config keys RESUME, CHECKPOINT_EVERY and REMAT (checkpoints under
``--output-path``), and a SIGTERM stops a run resumably after the current
step when checkpoints are on. ``--device`` picks the device: the
CUDA card by default, ``cpu`` on request. A missing KNMI archive falls back
to a synthetic one.
"""

from __future__ import annotations

import argparse

from ..parallel.launch import start_ranks
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
    parser.add_argument("--precision", choices=("f32", "bf16"),
                        default=None,
                        help="bf16: activations and products in bfloat16, "
                             "weights, optimizer state and BatchNorm in "
                             "float32 (config key PRECISION; default f32)")
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--megastep", type=int, default=0,
                        help="K>1: capture K train steps into ONE CUDA "
                             "graph (amortizes per-launch host overhead "
                             "K-ways — config key MEGASTEP)")
    parser.add_argument("--resident", action="store_true",
                        help="transfer the decoded training split to "
                             "device memory ONCE and gather windows "
                             "on-device; steady-state epochs move only "
                             "index programs (config key RESIDENT; "
                             "composes with --megastep as the program "
                             "length K, default 8)")
    parser.add_argument("--use-pallas", dest="use_pallas", default=None,
                        action="store_true",
                        help="force the fused CUDA kernels on (default: on "
                             "exactly when the model is on the card)")
    parser.add_argument("--no-use-pallas", dest="use_pallas",
                        action="store_false",
                        help="force the plain PyTorch versions")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="E>0: Switch-MoE bottleneck with E experts on "
                             "the unet model family (config key "
                             "MOE_EXPERTS)")
    parser.add_argument("--moe-aux-weight", type=float, default=None,
                        help="load-balance aux-loss weight for "
                             "--moe-experts (config key MOE_AUX_WEIGHT; "
                             "default 0.01)")
    parser.add_argument("--profile", action="store_true",
                        help="record per-epoch step timing (steps/sec, "
                             "dispatch latency) into history.json")
    parser.add_argument("--profile-trace-dir", type=str, default="",
                        help="capture a torch.profiler trace of the first "
                             "epoch into this directory (implies --profile)")
    parser.add_argument("--conv-impl", dest="conv_impl", default="auto",
                        choices=("auto", "nhwc", "chanfirst"),
                        help="conv-mapping form: nhwc = cuDNN convs; "
                             "chanfirst = positions-on-lanes products; auto "
                             "currently = nhwc")
    parser.add_argument("--data-axis", type=int, default=None,
                        help="N: data parallelism over N ranks, one card "
                             "each (gloo processes with --device cpu); "
                             "default one card (config key DATA_AXIS)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group the launcher's "
                             "environment describes (torchrun); raises "
                             "without one")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    args = parser.parse_args(argv)
    if args.action == "generate_experiment" and not args.exp_folder_name:
        parser.error("generate_experiment needs --exp_folder_name")
    if start_ranks("extended_gan_torch.gat.__main__:main", argv,
                   data_axis=args.data_axis, multihost=args.multihost,
                   device=args.device):
        return None
    if args.action == "train":
        return train(
            model_type=args.model_type, mapping_type=args.mapping_type,
            optimizer="adam", output_path=args.output_path,
            train_batch_size=args.train_batch_size or 32,
            test_batch_size=args.test_batch_size or 64,
            epochs=args.epochs or 10,
            learning_rate=args.learning_rate or 1e-3, lr_step=1, gamma=0.95,
            dataset=args.dataset, precision=args.precision or "f32",
            preprocessed_folder=args.preprocessed_folder,
            downsample_size=tuple(args.downsample_size),
            max_batches=args.max_batches, use_pallas=args.use_pallas,
            megastep=args.megastep, resident=args.resident,
            conv_impl=args.conv_impl, profile=args.profile,
            profile_trace_dir=args.profile_trace_dir,
            moe_experts=args.moe_experts,
            moe_aux_weight=0.01 if args.moe_aux_weight is None
            else args.moe_aux_weight, data_axis=args.data_axis,
            device=args.device)
    return generate_experiment(
        args.exp_folder_name, output_path=args.output_path,
        device=args.device, train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size, epochs=args.epochs,
        learning_rate=args.learning_rate, precision=args.precision,
        max_batches=args.max_batches or None, use_pallas=args.use_pallas,
        megastep=args.megastep or None, resident=args.resident or None,
        profile=args.profile or None,
        profile_trace_dir=args.profile_trace_dir or None,
        conv_impl=args.conv_impl, moe_experts=args.moe_experts or None,
        moe_aux_weight=args.moe_aux_weight, data_axis=args.data_axis)


if __name__ == "__main__":
    main()
