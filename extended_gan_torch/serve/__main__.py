"""Export, serve and batch-predict from the command line.

  # export a conv-GAT experiment's model: its trained model.pt, weights from
  # the JAX package (a flat .npz of the flax params, keys joined with "/")
  # or drawn from a seed; --quantize w8 stores its kernels as int8:
  python -m extended_gan_torch.serve export \\
      convolutional_gat/experiments/final_temp_conv --init-seed 0 \\
      --out /tmp/gat.pt [--quantize w8] [--check]

  # export the DCGAN generator from the latest checkpoint that
  # python -m extended_gan_torch.dcgan --out-dir /tmp/run wrote; int8 with
  # --quantize w8|w8a8 (activation scales from --calib-npz, or from a
  # uniform [0, 1) batch):
  python -m extended_gan_torch.serve export /tmp/run --workload dcgan \\
      --out /tmp/g.pt --quantize w8a8 --check

  # either generator of the CycleGAN's latest checkpoint (python -m
  # extended_gan_torch.cycle_gan --out-dir /tmp/cg --save-epoch 1), in the
  # DCGAN generator's artifact format, which the server serves as it is:
  python -m extended_gan_torch.serve export /tmp/cg --workload cyclegan \\
      --direction yx --out /tmp/g_yx.pt [--quantize w8a8] --check

  # either generator in the 2x2 space-to-depth layout (the same weights;
  # the spec's "layout" is "packed2"):
  python -m extended_gan_torch.serve export /tmp/run --workload dcgan \\
      --packed-g --out /tmp/g_packed.pt --check

  # serve an artifact over HTTP (GET /healthz, POST /predict with .npy
  # bodies):
  python -m extended_gan_torch.serve serve /tmp/g.pt --port 8000

  # run an experiment's model.pt over a dataset split into an .npz:
  python -m extended_gan_torch.serve predict \\
      convolutional_gat/experiments/final_temp_conv --out /tmp/preds.npz

``serve``, ``predict`` and ``export --check`` run on the CUDA card unless
``--device cpu`` is given. ``export`` itself converts, folds, quantises and
calibrates the weights on the CPU, so an artifact does not depend on the
card it was made beside.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _refuse(args):
    """The JAX script's flags that the port does not take, and the
    combinations it refuses."""
    if args.packed_g and args.workload == "gat":
        raise SystemExit("--packed-g applies to the dcgan/cyclegan "
                         "generator workloads only")
    if args.quantize and args.packed_g:
        raise SystemExit("--quantize folds BN into the canonical conv "
                         "layout; combine with --packed-g is unsupported")
    if args.platforms is not None or args.fixed_batch:
        raise SystemExit("--platforms and --fixed-batch shape the JAX "
                         "package's StableHLO artifact; the port's artifact "
                         "takes any batch, on the card or the CPU (serve "
                         "--device)")
    if args.quantize == "w8a8" and args.workload == "gat":
        raise SystemExit("--quantize w8a8 needs the BN-folded conv chain "
                         "of the dcgan/cyclegan generators; the gat/unet "
                         "families support weight-only --quantize w8")
    if args.weights and args.workload != "gat":
        raise SystemExit("--weights reads a conv-GAT flax .npz; the dcgan "
                         "and cyclegan generators export from their "
                         "checkpoints or --init-seed")
    if args.rollout < 1:
        raise SystemExit("--rollout must be >= 1")
    if args.rollout_final and args.rollout == 1:
        raise SystemExit("--rollout-final needs --rollout K with K > 1")


def _export_gat(args, dev):
    """(spec, weights, live forward, meta) of a conv-GAT experiment."""
    from torch.func import functional_call

    from ..models.convert import load_flax_npz
    from ..models.registry import build_model
    from ..train.checkpoint import load_model
    from ..utils.config import load_experiment_config
    from .export import MODEL_KEYS
    from .quantize import make_w8_apply, quantize_state_dict_w8

    cfg = load_experiment_config(args.experiment_dir)
    spec = {
        "workload": "gat",
        "model_type": cfg.model_type,
        "mapping_type": cfg.mapping_type,
        "image_width": args.width or cfg.downsample_size[0],
        "image_height": args.height or cfg.downsample_size[1],
        "n_vertices": args.vertices,
        "time_steps": args.time_steps,
    }
    generator = None
    if args.init_seed is not None:
        generator = torch.Generator().manual_seed(args.init_seed)
    model = build_model(**{k: spec[k] for k in MODEL_KEYS}, device=dev,
                        generator=generator)
    if args.weights:
        source = args.weights
        model.load_state_dict(load_flax_npz(args.weights))
    elif args.init_seed is not None:
        source = f"init-seed {args.init_seed}"
    else:
        source = os.path.join(args.experiment_dir, "model.pt")
        if not os.path.exists(source):
            raise SystemExit(f"no checkpoint at {source}; train the "
                             "experiment first (python -m "
                             "extended_gan_torch.gat generate_experiment) or "
                             "pass --weights or --init-seed")
        model.load_state_dict(load_model(source, model.state_dict()))
    meta = {"source": args.experiment_dir, "weights": source,
            "model_type": cfg.model_type, "mapping_type": cfg.mapping_type}
    weights, live = model.state_dict(), model
    if args.quantize:
        # no foldable conv + BN chain: generic weight-only int8 over the
        # state_dict (serve/quantize.py)
        weights, _ = quantize_state_dict_w8(model.state_dict())
        live, qmeta = make_w8_apply(
            lambda sd, x: functional_call(model, sd, (x,)),
            model.state_dict())
        meta.update(qmeta)
    return spec, weights, live, meta


def _restore(args, names, nets, opts, template_key):
    """The latest checkpoint under ``<experiment_dir>/checkpoints``, read
    into a template of ``nets`` and ``opts`` keyed by ``names``."""
    from ..train.checkpoint import (
        CheckpointManager,
        gan_restore_template,
        gan_states,
    )

    ckpts = os.path.join(args.experiment_dir, "checkpoints")
    mgr = CheckpointManager(ckpts) if os.path.isdir(ckpts) else None
    if mgr is None or mgr.latest_step() is None:
        raise SystemExit(f"no checkpoints under {args.experiment_dir}; "
                         "train with --save-epoch first")
    return mgr.restore(gan_restore_template(
        mgr, gan_states(nets, opts, names), template_key))


def _export_generator(args, g, meta, im, nc, dev):
    """(spec, weights, live forward, meta) of a frame generator (the DCGAN
    ``Generator``: the DCGAN's, or either of the CycleGAN's), quantised
    with ``--quantize``."""
    from .export import nhwc_generator
    from .quantize import generator_apply, quantize_generator

    spec = {"workload": "dcgan_generator", "nc": nc, "imsize": im,
            "layout": meta["layout"]}
    weights, live = g.state_dict(), nhwc_generator(g)
    if args.quantize:
        if args.calib_npz:
            loaded = np.load(args.calib_npz)
            if hasattr(loaded, "files"):  # .npz: the first array
                loaded = loaded[loaded.files[0]]
            calib = np.asarray(loaded, np.float32)
            if calib.shape[1:] != (im, im, nc):
                raise SystemExit(
                    f"--calib-npz batch shape {calib.shape} does not match "
                    f"the model input (*, {(im, im, nc)})")
            meta["calibration"] = args.calib_npz
        else:
            # the generator's input domain: frames normalised to [0, 1]
            calib = np.random.default_rng(0).random((8, im, im, nc),
                                                    np.float32)
            meta["calibration"] = "uniform[0,1) synthetic"
        # reference_apply guards the BN fold against generator drift
        weights, qmeta = quantize_generator(
            g.state_dict(), args.quantize, calib, reference_apply=live)
        live = generator_apply(weights, dev)
        meta.update(qmeta)
    return spec, weights, live, meta


def _layout(args) -> str:
    """The generator's compute layout, as the JAX export names it."""
    return "packed2" if args.packed_g else "default"


def _export_dcgan(args, dev):
    """(spec, weights, live forward, meta) of the DCGAN generator."""
    from ..train.checkpoint import DCGAN_NETS
    from ..train.dcgan_driver import DEFAULT_PARAMS, build_dcgan

    params = dict(DEFAULT_PARAMS)
    if args.imsize:
        params["imsize"] = args.imsize
    if args.ndf:
        # the template's widths, as at training time
        params["ngf"] = params["ndf"] = args.ndf
    # the seed only shapes the template; restore() overwrites every weight
    # packed_g changes the compute layout alone: the state_dict is the same
    nets, opts = build_dcgan(params, device=dev, seed=369 if args.init_seed
                             is None else args.init_seed,
                             packed_g=args.packed_g)
    g = nets[0].eval()
    meta = {"source": args.experiment_dir, "model_type": "dcgan_generator",
            "layout": _layout(args)}
    if args.init_seed is None:
        key = g.ConvBlock_0.dropout_generator.get_state()
        restored = _restore(args, DCGAN_NETS, nets, opts, key)
        g.load_state_dict(restored["states"]["g"]["model"])
        meta["epoch"] = int(restored["epoch"])
    else:
        meta["weights"] = f"init-seed {args.init_seed}"
    return _export_generator(args, g, meta, params["imsize"], params["nc"],
                             dev)


def _export_cyclegan(args, dev):
    """(spec, weights, live forward, meta) of one CycleGAN generator,
    ``--direction xy`` (context -> future) or ``yx``."""
    from ..train.checkpoint import CYCLEGAN_NETS
    from ..train.cyclegan_driver import build_cyclegan

    im, nc = args.imsize or 64, 4
    # the seed only shapes the template; restore() overwrites every weight
    nets, opts = build_cyclegan(nc=nc, ndf=args.ndf or 64, device=dev,
                                seed=369 if args.init_seed is None
                                else args.init_seed, packed_g=args.packed_g)
    name = f"g_{args.direction}"
    g = nets[CYCLEGAN_NETS.index(name)].eval()
    meta = {"source": args.experiment_dir,
            "model_type": f"cyclegan_generator_{args.direction}",
            "layout": _layout(args)}
    if args.init_seed is None:
        key = g.ConvBlock_0.dropout_generator.get_state()
        restored = _restore(args, CYCLEGAN_NETS, nets, opts, key)
        g.load_state_dict(restored["states"][name]["model"])
        meta["epoch"] = int(restored["epoch"])
    else:
        meta["weights"] = f"init-seed {args.init_seed}"
    return _export_generator(args, g, meta, im, nc, dev)


def _check(path, live, args):
    """Reload the artifact on ``--device`` and hold it against the live
    forward on the CPU at two batch sizes, at the JAX export's tolerances
    (exact f32 convolutions on the card: cuDNN would take TF32)."""
    from ..core.device import resolve_device
    from .export import load_exported

    dev = resolve_device(args.device)
    served = load_exported(path, device=dev)
    # a quantised forward rounds to int8 bins, so one flipped bin is
    # allowed; a rollout compounds either through its windows
    if args.quantize:
        tol = 5e-3 * args.rollout
    else:
        tol = 1e-5 if args.rollout == 1 else 2e-5 * args.rollout
    for b in (2, 5):
        x = torch.from_numpy(np.random.default_rng(0).random(
            (b, *served.window_shape), np.float32))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got = served.fn(x.to(dev)).cpu()
        err = float((got - live(x)).abs().max())
        print(f"check b={b}: max|serve - live| = {err:.3e}")
        if not err < tol:
            raise SystemExit(f"exported artifact diverges from the live "
                             f"model: {err:.3e} >= {tol}")
    print("check OK")


def _export(args) -> dict:
    from .export import save_exported
    from .rollout import make_rollout

    _refuse(args)
    with torch.no_grad():
        # the weights' work (conversion, BN fold, int8, calibration) is
        # host work: on the CPU, so an artifact does not depend on the card
        export = {"gat": _export_gat, "dcgan": _export_dcgan,
                  "cyclegan": _export_cyclegan}[args.workload]
        spec, weights, live, meta = export(args, torch.device("cpu"))
        spec.update(quantize=args.quantize, rollout=args.rollout,
                    rollout_final_only=bool(args.rollout_final))
        if args.rollout > 1:
            live = make_rollout(live, args.rollout,
                                final_only=args.rollout_final)
            meta["rollout"] = args.rollout
            meta["rollout_final_only"] = bool(args.rollout_final)
        info = save_exported(spec, weights, args.out, metadata=meta)
        print(json.dumps({"out": args.out, **info}, indent=2))
        if args.check:
            _check(args.out, live, args)
    return info


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m extended_gan_torch.serve")
    sub = parser.add_subparsers(dest="command", required=True)

    ex = sub.add_parser("export", help="write a serving artifact")
    ex.add_argument("experiment_dir",
                    help="a conv-GAT experiment (config.py, and model.pt "
                         "from training) or, with --workload dcgan or "
                         "cyclegan, that driver's --out-dir")
    ex.add_argument("--workload", choices=("gat", "dcgan", "cyclegan"),
                    default="gat")
    ex.add_argument("--direction", choices=("xy", "yx"), default="xy",
                    help="cyclegan: which generator to export (xy: context "
                         "-> future, yx: future -> context)")
    src = ex.add_mutually_exclusive_group()
    src.add_argument("--weights", default="",
                     help="flat .npz of the JAX package's flax params, keys "
                          "joined with '/' (gat)")
    src.add_argument("--init-seed", dest="init_seed", type=int, default=None,
                     help="draw the weights from this seed instead of "
                          "reading the trained ones")
    ex.add_argument("--out", required=True)
    ex.add_argument("--width", type=int, default=0,
                    help="default: the config's DOWNSAMPLE_SIZE")
    ex.add_argument("--height", type=int, default=0,
                    help="default: the config's DOWNSAMPLE_SIZE")
    ex.add_argument("--time-steps", dest="time_steps", type=int, default=4)
    ex.add_argument("--vertices", type=int, default=6)
    ex.add_argument("--imsize", type=int, default=0,
                    help="dcgan, cyclegan: the frame size (default 64)")
    ex.add_argument("--ndf", type=int, default=0,
                    help="dcgan, cyclegan: the discriminators' width at "
                         "training time")
    ex.add_argument("--quantize", choices=("w8", "w8a8"), default="",
                    help="post-training int8: w8 = weight-only int8 (a "
                         "smaller artifact, f32 compute; gat, dcgan and "
                         "cyclegan), w8a8 = int8 convs with int32 "
                         "accumulation (dcgan, cyclegan)")
    ex.add_argument("--calib-npz", dest="calib_npz", type=str, default="",
                    help="with --quantize: .npy/.npz holding a "
                         "representative NHWC input batch for the "
                         "activation scales (default: a uniform [0, 1) "
                         "batch of 8)")
    ex.add_argument("--rollout", type=int, default=1,
                    help="K>1: the artifact emits a K-step autoregressive "
                         "horizon (B, K, ...)")
    ex.add_argument("--rollout-final", dest="rollout_final",
                    action="store_true",
                    help="with --rollout K: emit only window K")
    ex.add_argument("--check", action="store_true",
                    help="reload the artifact and hold it against the live "
                         "model at two batch sizes")
    ex.add_argument("--device", default=None,
                    help="where --check runs the artifact (default: the "
                         "CUDA card; 'cpu')")
    ex.add_argument("--packed-g", dest="packed_g", action="store_true",
                    help="dcgan, cyclegan: export the generator's 2x2 "
                         "space-to-depth compute layout (the same function "
                         "and weights; the spec's layout is 'packed2')")
    ex.add_argument("--platforms", type=str, nargs="*", default=None,
                    help="the JAX artifact's: refused")
    ex.add_argument("--fixed-batch", dest="fixed_batch", type=int, default=0,
                    help="the JAX artifact's: refused")

    sv = sub.add_parser("serve", help="serve an artifact over HTTP")
    sv.add_argument("artifact")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to serve on the CPU")
    sv.add_argument("--no-bucket", dest="bucket", action="store_false",
                    help="do not pad batches to powers of two")

    from .predict import add_arguments

    add_arguments(sub.add_parser(
        "predict", help="run an experiment's model over a dataset split"))

    args = parser.parse_args(argv)
    if args.command == "export":
        return _export(args)
    if args.command == "predict":
        from .predict import predict

        return predict(args)
    from .server import serve_forever

    serve_forever(args.artifact, host=args.host, port=args.port,
                  device=args.device, bucket_batches=args.bucket)


if __name__ == "__main__":
    main()
