"""Train the vanilla MLP GAN on local MNIST or synthetic digits with the
PyTorch port.

  python -m extended_gan_torch.vanilla_gan --n_epochs 1 --max_batches 20 \\
      --data_root "" --out_dir /tmp/vg

The flags and defaults are ``python gan_examples/vanilla_gan.py``'s, plus
``--device`` (the CUDA card by default, ``cpu`` on request). Each batch is
one G then D update (``train/adversarial.py``; ``--fused_prop`` for the
FusedProp step); every ``--sample_interval`` batches the generator's eval
forward of 25 fixed latents is written to ``<out_dir>/<batches>.png`` as a
5x5 grid, min-max normalised over the grid. The JAX script draws the grid
with matplotlib; the port writes the same pixels as an 8-bit grayscale PNG
with the standard library (no figure around them, no gaps between tiles).

The data axis (JAX's script runs on an all-devices mesh,
``gan_examples/vanilla_gan.py:100, 140-144``): ``--data-axis N`` trains
each batch over N ranks (NCCL, one process a card; gloo processes with
``--device cpu``), and unset it is every visible card (one under
``--device cpu``); under torchrun each process is one rank, and
``--multihost`` makes that explicit. Every rank draws the same batches,
a ragged batch is cut to a multiple of N (a batch cut to nothing is
skipped), each rank takes its contiguous rows, the generator's BatchNorm
runs over the global batch (``parallel/batch_norm.py``), G's and D's
gradients are summed over the ranks, and rank 0 writes the grids.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.vanilla_gan")
    parser.add_argument("--n_epochs", type=int, default=200,
                        help="number of epochs of training")
    parser.add_argument("--batch_size", type=int, default=64,
                        help="size of the batches")
    parser.add_argument("--lr", type=float, default=0.0002,
                        help="adam: learning rate")
    parser.add_argument("--b1", type=float, default=0.5,
                        help="adam: decay of first order momentum of gradient")
    parser.add_argument("--b2", type=float, default=0.999,
                        help="adam: decay of second order momentum of "
                             "gradient")
    parser.add_argument("--latent_dim", type=int, default=100,
                        help="dimensionality of the latent space")
    parser.add_argument("--img_size", type=int, default=28,
                        help="size of each image dimension")
    parser.add_argument("--channels", type=int, default=1,
                        help="number of image channels")
    parser.add_argument("--sample_interval", type=int, default=400,
                        help="interval between image samples")
    parser.add_argument("--data_root", type=str, default="data/mnist")
    parser.add_argument("--out_dir", type=str, default="images")
    parser.add_argument("--seed", type=int, default=369)
    parser.add_argument("--precision", choices=("f32", "bf16"),
                        default="f32")
    parser.add_argument("--max_batches", type=int, default=0,
                        help="stop after this many batches (0 = full run)")
    parser.add_argument("--fused_prop", action="store_true",
                        help="FusedProp: one shared fake G->D pass, its two "
                             "cotangents pulled back through it (exact here: "
                             "both losses see the same pre-update D)")
    parser.add_argument("--log_every", type=int, default=1,
                        help="print losses every N batches (each print "
                             "synchronizes with the device)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to train on the "
                             "CPU")
    parser.add_argument("--data-axis", type=int, default=None,
                        help="N: data parallelism over N ranks, one card "
                             "each (gloo processes with --device cpu); "
                             "default every visible card, one with --device "
                             "cpu")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group the launcher's "
                             "environment describes (torchrun); raises "
                             "without one")
    return parser.parse_args(argv)


def write_png(path: str, pixels: np.ndarray):
    """An (H, W) uint8 array as an 8-bit grayscale PNG."""
    h, w = pixels.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + pixels[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 9))
                + chunk(b"IEND", b""))


def image_grid(imgs: np.ndarray, nrow: int = 5) -> np.ndarray:
    """The first nrow x nrow images' first channel, normalised over the
    grid to [0, 1] (the reference's ``save_image(normalize=True)``), tiled
    row by row into one float array; empty tiles are white (1)."""
    imgs = np.asarray(imgs, np.float32)
    lo, hi = imgs.min(), imgs.max()
    imgs = (imgs - lo) / max(hi - lo, 1e-8)
    h, w = imgs.shape[2:]
    grid = np.ones((nrow * h, nrow * w), np.float32)
    for i in range(min(len(imgs), nrow * nrow)):
        r, c = divmod(i, nrow)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = imgs[i, 0]
    return grid


def save_image_grid(imgs: np.ndarray, path: str, nrow: int = 5):
    """:func:`image_grid` written as an 8-bit grayscale PNG."""
    write_png(path, np.rint(image_grid(imgs, nrow) * 255).astype(np.uint8))


def main(argv=None):
    opt = parse_args(argv)

    from ..core.precision import resolve_dtype
    from ..core.prng import KeySeq
    from ..data.mnist import iterate_batches, load_images
    from ..models.vanilla_gan import MLPDiscriminator, MLPGenerator
    from ..parallel import data_axis_for, join_data_axis
    from ..parallel.launch import start_ranks
    from ..train.adversarial import make_sampler, make_vanilla_gan_step

    if start_ranks("extended_gan_torch.vanilla_gan.__main__:main", argv,
                   data_axis=opt.data_axis, multihost=opt.multihost,
                   device=opt.device):
        return None
    print(opt)

    if opt.channels != 1:
        # the image sources are single-channel, as in the JAX script (the
        # reference takes --channels and fails the same way)
        raise SystemExit("--channels must be 1: the digit sources are "
                         "single-channel")
    axis = data_axis_for(opt.data_axis, opt.device)
    dev = axis.device
    print(f"Using device: {dev}")
    if axis.parallel:
        print(f"Using data axis: {axis.size} ranks (rank {axis.rank})")
    if axis.is_main:
        os.makedirs(opt.out_dir, exist_ok=True)
    img_shape = (opt.channels, opt.img_size, opt.img_size)
    dtype = resolve_dtype(opt.precision)
    init = torch.Generator().manual_seed(opt.seed)
    g = MLPGenerator(img_shape, opt.latent_dim, generator=init,
                     dtype=dtype).to(dev)
    d = MLPDiscriminator(img_shape, generator=init, dtype=dtype).to(dev)
    join_data_axis(axis, g, d)
    g_opt, d_opt = (torch.optim.Adam(n.parameters(), lr=opt.lr,
                                     betas=(opt.b1, opt.b2), eps=1e-8)
                    for n in (g, d))
    z_stream = KeySeq(opt.seed, device=dev).generator
    step = make_vanilla_gan_step(g, d, g_opt, d_opt,
                                 latent_dim=opt.latent_dim,
                                 fused_prop=opt.fused_prop,
                                 generator=z_stream, axis=axis)
    sample = make_sampler(g)
    fixed_z = torch.randn(25, opt.latent_dim, device=dev, generator=z_stream)

    x_all = load_images(opt.data_root, img_size=opt.img_size)
    np_rng = np.random.RandomState(opt.seed)
    batches_done = 0
    n_batches = int(np.ceil(len(x_all) / opt.batch_size))
    for epoch in range(opt.n_epochs):
        for i, imgs in enumerate(iterate_batches(x_all, opt.batch_size,
                                                 rng=np_rng)):
            if len(imgs) % axis.size:
                imgs = imgs[:len(imgs) // axis.size * axis.size]
                if not len(imgs):
                    continue
            real = torch.from_numpy(np.ascontiguousarray(
                axis.shard(imgs))).to(dev)
            losses = step(real, n=len(imgs))
            if batches_done % opt.log_every == 0:
                print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f]"
                      % (epoch, opt.n_epochs, i, n_batches,
                         float(losses["d_loss"]), float(losses["g_loss"])))
            if batches_done % opt.sample_interval == 0 and axis.is_main:
                save_image_grid(sample(fixed_z).cpu().numpy(),
                                os.path.join(opt.out_dir,
                                             f"{batches_done}.png"))
            batches_done += 1
            if opt.max_batches and batches_done >= opt.max_batches:
                print("max_batches reached; stopping")
                return g, d
    return g, d


if __name__ == "__main__":
    main()
