"""Coastal-sea temperature -> normalised tensor (port of
``extended_gan_tpu/preprocess/coastal_sea.py``).

Reads the ``thetao`` variable of each input (a netCDF4 file, or a ``.npy``
dump of that variable), slices ``[:, 0, 20:, :65]``, min-max normalises it
over the whole slice (``data/native.py::minmax_normalize``) and saves the
stack, (T, n_inputs, H, W) float32, as a ``.pt`` tensor.

  python -m extended_gan_torch.preprocess.coastal_sea [IN ...] [--out PATH]

netCDF4 is optional: without it a ``.nc`` input raises, as the JAX
package's does.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.io import save_array
from ..data.native import minmax_normalize


def _read_thetao(file_name: str) -> np.ndarray:
    if file_name.endswith(".npy"):
        return np.load(file_name)
    try:
        import netCDF4
    except ImportError as e:
        raise ImportError("netCDF4 is not installed; provide a .npy dump of "
                          "the 'thetao' variable instead") from e
    return np.asarray(netCDF4.Dataset(file_name)["thetao"][...])


def preprocess(file_names=("TEM.nc",),
               out_path: str = "coastal_sea_data_preprocessed.pt"):
    """Normalise each input's slice, stack them on axis 1 and save the
    result to ``out_path``; returns it."""
    acc = [minmax_normalize(_read_thetao(f)[:, 0, 20:, :65])
           for f in file_names]
    result = np.stack(acc, axis=1)
    save_array(out_path, result)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.preprocess.coastal_sea")
    parser.add_argument("file_names", nargs="*", default=["TEM.nc"])
    parser.add_argument("--out", default="coastal_sea_data_preprocessed.pt")
    args = parser.parse_args(argv)
    preprocess(tuple(args.file_names), args.out)


if __name__ == "__main__":
    main()
