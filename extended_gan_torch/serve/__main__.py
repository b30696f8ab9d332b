"""Export and serve a GAT3D model from the command line.

  # export an experiment's model, with weights from the JAX package (a flat
  # .npz of the flax params, keys joined with "/") or drawn from a seed:
  python -m extended_gan_torch.serve export \\
      convolutional_gat/experiments/final_temp_conv --init-seed 0 \\
      --out /tmp/gat.pt

  # serve it over HTTP (GET /healthz, POST /predict with .npy bodies):
  python -m extended_gan_torch.serve serve /tmp/gat.pt --port 8000

``export`` only converts and saves weights, so it runs on the CPU; ``serve``
runs the model on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import torch


def _export(args) -> dict:
    from ..models.convert import load_flax_npz
    from ..models.registry import build_model
    from ..utils.config import load_experiment_config
    from .export import MODEL_KEYS, save_exported

    if args.quantize:
        raise SystemExit("--quantize is not ported yet (ROADMAP: serving "
                         "extras, --quantize and scripts/predict.py)")
    if args.rollout < 1:
        raise SystemExit("--rollout must be >= 1")
    if args.rollout_final and args.rollout == 1:
        raise SystemExit("--rollout-final needs --rollout K with K > 1")
    cfg = load_experiment_config(args.experiment_dir)
    spec = {
        "model_type": cfg.model_type,
        "mapping_type": cfg.mapping_type,
        "image_width": args.width or cfg.downsample_size[0],
        "image_height": args.height or cfg.downsample_size[1],
        "n_vertices": args.vertices,
        "time_steps": args.time_steps,
        "rollout": args.rollout,
        "rollout_final_only": bool(args.rollout_final),
    }
    generator = None
    if args.init_seed is not None:
        generator = torch.Generator().manual_seed(args.init_seed)
    model = build_model(**{k: spec[k] for k in MODEL_KEYS},
                        device="cpu", generator=generator)
    if args.weights:
        model.load_state_dict(load_flax_npz(args.weights))
    meta = {"source": args.experiment_dir,
            "weights": args.weights or f"init-seed {args.init_seed}"}
    info = save_exported(spec, model.state_dict(), args.out, metadata=meta)
    print(json.dumps({"out": args.out, **info}, indent=2))
    return info


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m extended_gan_torch.serve")
    sub = parser.add_subparsers(dest="command", required=True)

    ex = sub.add_parser("export", help="write a serving artifact")
    ex.add_argument("experiment_dir")
    src = ex.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", default="",
                     help="flat .npz of the JAX package's flax params, keys "
                          "joined with '/'")
    src.add_argument("--init-seed", dest="init_seed", type=int, default=None,
                     help="draw the weights from this seed instead")
    ex.add_argument("--out", required=True)
    ex.add_argument("--width", type=int, default=0,
                    help="default: the config's DOWNSAMPLE_SIZE")
    ex.add_argument("--height", type=int, default=0,
                    help="default: the config's DOWNSAMPLE_SIZE")
    ex.add_argument("--time-steps", dest="time_steps", type=int, default=4)
    ex.add_argument("--vertices", type=int, default=6)
    ex.add_argument("--rollout", type=int, default=1,
                    help="K>1: the artifact emits a K-step autoregressive "
                         "horizon (B, K, ...)")
    ex.add_argument("--rollout-final", dest="rollout_final",
                    action="store_true",
                    help="with --rollout K: emit only window K")
    ex.add_argument("--quantize", choices=("w8", "w8a8"), default="",
                    help="not ported yet: refused")

    sv = sub.add_parser("serve", help="serve an artifact over HTTP")
    sv.add_argument("artifact")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to serve on the CPU")
    sv.add_argument("--no-bucket", dest="bucket", action="store_false",
                    help="do not pad batches to powers of two")

    args = parser.parse_args(argv)
    if args.command == "export":
        return _export(args)
    from .server import serve_forever

    serve_forever(args.artifact, host=args.host, port=args.port,
                  device=args.device, bucket_batches=args.bucket)


if __name__ == "__main__":
    main()
