"""ARAI/MAI satellite archive -> continuous blocks (port of
``extended_gan_tpu/preprocess/arai.py``).

The archive is ``<in>/<region>/{training,validation}/<day>/<folder>/*.nc``,
one file a 15-minute slot, its time ``HHMM`` in the name (``..._<date>T
<HHMM>00Z.nc``). For each region and selected variable, a day's files
split wherever a slot of the 96-slot grid is missing; runs that end at
midnight join the next day's first run when the days are consecutive; the
n-th runs of every region and variable make block n, which must exist for
each of them (a region missing a time range raises). Each block of at
least ``min_block`` frames is saved as ``<out>/<condition>/<n>.pt``, a
(T, regions, variables, H, W) float32 tensor, and ``<out>/metadata.json``
holds ``n_regions`` and each condition's total ``length``.

``reader(path, var_name)`` reads one frame; the default reads a netCDF4
variable, fills its masked values with half its valid range and scales
by ``valid_range * scale_factor`` less ``add_offset``. netCDF4 is imported
only there: without it the default reader raises, as the JAX package's
does; any other reader (``.npy`` dumps, say) can stand in.

  python -m extended_gan_torch.preprocess.arai --in-path IN --out-path OUT
"""

from __future__ import annotations

import json
import os
import shutil
from argparse import ArgumentParser

import numpy as np

from ..data.io import listdir, mkdir, save_array


def get_time_range() -> tuple[int, ...]:
    """The 96 HHMM stamps of a day on the 15-minute grid."""
    return tuple(int(f"{m // 60}{m % 60 or '00'}") for m in range(0, 1440, 15))


def get_time_from_file_name(file_name: str) -> int:
    return int(file_name.split("_")[-1].split("T")[-1].strip("Z.nc")[:-2])


def get_continuous_splits(directory: str) -> list[list[str]]:
    """A day's files split into runs with no missing 15-minute slot (one
    empty run for a missing directory)."""
    if not os.path.isdir(directory):
        return [[]]
    files = sorted((fp for _, fp in listdir(directory)),
                   key=get_time_from_file_name)
    stamps = tuple(get_time_from_file_name(f) for f in files)
    acc: list[list[str]] = [[]]
    i = 0
    for slot in get_time_range():
        if i < len(stamps) and slot == stamps[i]:
            acc[-1].append(files[i])
            i += 1
        else:
            acc.append([])
    return acc


def merge(files: list, new_files: list):
    """Append a day's runs to ``files``, the first joining the last."""
    if files and new_files:
        files[-1] += new_files[0]
        files += new_files[1:]
    else:
        files += new_files


def merge_days(accumulator: dict) -> dict:
    """{region: {var: {day: runs}}} -> {region: {var: runs}}, runs joined
    across midnight between consecutive days, empty runs dropped."""
    fixed = {}
    for region, var_acc in accumulator.items():
        fixed[region] = {}
        for var, days_acc in var_acc.items():
            days = tuple(sorted(days_acc, key=int))
            merged: list[list[str]] = []
            merge(merged, days_acc[days[0]])
            for prev, day in zip(days, days[1:]):
                if int(day) != int(prev) + 1:
                    merged.append([])
                merge(merged, days_acc[day])
            fixed[region][var] = [m for m in merged if m]
    return fixed


def split_continuous_blocks_at_root(accumulator: dict) -> list[dict]:
    """{region: {var: runs}} -> [{region: {var: run n}} for each n]."""
    counts = {f"{region}/{var}": len(blocks)
              for region, vars_acc in accumulator.items()
              for var, blocks in vars_acc.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"regions/vars disagree on continuous-run counts (a region is "
            f"missing files for some time range): {counts}")
    a_region = next(iter(accumulator))
    a_var = next(iter(accumulator[a_region]))
    return [{region: {var: blocks[i] for var, blocks in vars_acc.items()}
             for region, vars_acc in accumulator.items()}
            for i in range(len(accumulator[a_region][a_var]))]


def read_nc_normalized(file_path: str, var_name: str) -> np.ndarray:
    """One netCDF4 variable, masked values filled with half the valid
    range, scaled by ``valid_range * scale_factor`` less ``add_offset``."""
    import netCDF4

    fc = netCDF4.Dataset(file_path)[var_name]
    valid_range = fc.valid_range
    array = fc[...].filled((np.max(valid_range) - np.min(valid_range)) / 2)
    scale = fc.scale_factor if "scale_factor" in fc.__dict__ else 1
    offset = fc.add_offset if "add_offset" in fc.__dict__ else 0
    return ((array / (np.max(valid_range) * scale)) - offset).astype(
        np.float32)


def block_to_array(block: dict, reader=read_nc_normalized) -> np.ndarray:
    """One block -> (T, regions, variables, H, W)."""
    regions = []
    for var_acc in block.values():
        regions.append(np.stack([
            np.stack([np.squeeze(reader(f, var_name)) for f in files])
            for (_, var_name), files in var_acc.items()]))
    return np.stack(regions).transpose(2, 0, 1, 3, 4)


def preprocess(verbose: bool = True, in_path: str = "~/downloads/mai_dataset",
               out_path: str = "./preprocessed",
               select_variables: tuple[tuple[str, str], ...] = (("CRR",
                                                                 "crr"),),
               reader=read_nc_normalized, min_block: int = 10) -> dict:
    """The archive under ``in_path`` -> blocks under ``out_path`` (emptied
    first); ``select_variables`` lists (folder, variable name) pairs.
    Returns the metadata."""
    if os.path.exists(out_path):
        shutil.rmtree(out_path)
    mkdir(out_path)
    metadata: dict = {"n_regions": len(os.listdir(in_path))}
    for condition in ("training", "validation"):
        metadata[condition] = {"length": 0}
        out_condition = os.path.join(out_path, condition)
        mkdir(out_condition)
        days = sorted((name for name, _ in listdir(
            os.path.join(in_path, "R1", condition))), key=int)
        accumulator: dict = {}
        for day in days:
            for region, region_path in listdir(in_path):
                region_acc = accumulator.setdefault(
                    region, {var: {} for var in select_variables})
                for folder, var_name in select_variables:
                    region_acc[(folder, var_name)][day] = \
                        get_continuous_splits(os.path.join(
                            region_path, condition, day, folder))
        blocks = split_continuous_blocks_at_root(merge_days(accumulator))
        for i, block in enumerate(blocks):
            arr = block_to_array(block, reader=reader)
            if len(arr) >= min_block:
                save_array(os.path.join(out_condition, f"{i}.pt"), arr)
                metadata[condition]["length"] += len(arr)
            elif verbose:
                print(f"Skipped block of length {len(arr)}")
    with open(os.path.join(out_path, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return metadata


def main(argv=None):
    parser = ArgumentParser(
        prog="python -m extended_gan_torch.preprocess.arai")
    parser.add_argument("--in-path", type=str, default="./data")
    parser.add_argument("--out-path", type=str, default="./preprocessed")
    parser.add_argument("--select-variables", type=str,
                        default='[["ASII", "asii_turb_trop_prob"]]',
                        help="JSON list of [folder, variable name] pairs")
    args = parser.parse_args(argv)
    preprocess(in_path=args.in_path, out_path=args.out_path,
               select_variables=tuple((str(a), str(b)) for a, b in
                                      json.loads(args.select_variables)))


if __name__ == "__main__":
    main()
