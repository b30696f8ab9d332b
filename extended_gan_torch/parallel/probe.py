"""The data axis on N cards against one, through the training CLIs.

  python -m extended_gan_torch.parallel.probe [--cards 4] [--turns 2]
      [--megastep K] [--workload unet dcgan] [--epochs 2] [--trace]
      [--check]

Makes a synthetic archive for each workload, then trains it for
``--epochs`` epochs with ``--profile`` at the global batch 32, in turns:
one card, N cards (``--data-axis N``: NCCL, one process a card), N
cards, one card, ...; with ``--megastep K`` every run takes K steps a
CUDA graph, the N-card runs with their NCCL collectives inside the
graphs. The workloads:

- ``unet``: final_smaatunet's model (``--model-type unet --mapping-type
  linear``) through ``python -m extended_gan_torch.gat train`` on a KNMI
  archive of 64 + 2 files of 96 frames of 20x20x6;
- ``dcgan``: the published DCGAN (nc 4, ndf 64, 64x64, dropout 0.01)
  through ``python -m extended_gan_torch.dcgan`` on a frame archive of
  4,096 + 512 frames.

Prints the cards' names and power limits, then one JSON line a run: the
ms a train step of each epoch (the epoch's wall to the fetch of its
losses over its train steps, counted from the same loader), its losses,
the kernels' launches on rank 0 (the conv-GAT CLI prints them) and, on N
cards, the training CLI's check (``DataAxis.check_in_sync``) that every
rank ends with the same train state bit for bit.

``--trace`` (with ``--megastep K``) runs each workload once on one card
and once on N for 4 groups of K steps with ``--profile-trace-dir``, and
reads each rank's ``torch.profiler`` trace: the kernels each graph replay
ran (those whose launch correlates with a ``cudaGraphLaunch``), a train
step's share of them: kernels, busy ms (their summed durations), NCCL's
busy ms, and the replay's span on the device (first kernel's start to
last kernel's end), averaged over the replays.

``--check`` (with ``--megastep K``) holds the N cards' captured replays,
NCCL collectives included, to one card's arithmetic: each workload's
model (dropout 0) takes CHECK_GROUPS groups of K SGD steps (the first
eager, the second captured and replayed, the third replayed), cuDNN
deterministic and TF32 off, on the same global batches of 32, on N cards
(one rank a card, ``make_*_megastep`` with the data axis) and on one card
in float32 and in float64 (the plain versions). The N cards' final state
must lie within 10x the one card's float32-to-float64 distance of the one
card's float32 state (``utils/compare.py``), every rank's the same; one
JSON line a workload.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

from ..data.streaming import get_h5_loaders, get_loaders
from ..data.synthetic import make_h5_dataset, make_kmni_dataset
from .batch_norm import join_data_axis
from .launch import spawn_ranks
from .mesh import DataAxis

SEED = 369
BATCH = 32
CHECK_GROUPS = 3
CHECK_LR = 0.01


def _unet(tmp):
    """(data folder, argv without the axis, the history's loss keys, the
    train batches of an epoch)."""
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=64,
                             n_test_files=2, frames_per_file=96, hw=20)

    def steps(epoch):
        loader = get_loaders(BATCH, 64, knmi, dataset="kmni",
                             downsample_size=(20, 20), merge_nodes=False,
                             seed=SEED + epoch)[0]
        return sum(len(x) > 1 for x, _ in loader)

    argv = [sys.executable, "-m", "extended_gan_torch.gat", "train",
            "--model-type", "unet", "--mapping-type", "linear",
            "--dataset", "kmni", "--preprocessed-folder", knmi,
            "--downsample-size", "20", "20", "--train-batch-size",
            str(BATCH), "--profile"]
    return argv, ("train_loss", "val_loss"), steps, "--output-path"


def _dcgan(tmp):
    data = os.path.join(tmp, "frames")
    make_h5_dataset(data, frames_train=4096, frames_test=512, h=64, w=64)

    def steps(epoch):
        loader = get_h5_loaders(data, BATCH, 64, crop=64, in_seq_len=4,
                                out_seq_len=4, seed=SEED + epoch)[0]
        return sum(1 for _ in loader)

    argv = [sys.executable, "-m", "extended_gan_torch.dcgan",
            "--data-location", data, "--train-batch-size", str(BATCH),
            "--save-epoch", "1", "--profile"]
    return argv, ("train_mse", "pred_mse"), steps, "--out-dir"


WORKLOADS = {"unet": _unet, "dcgan": _dcgan}


def replay_stats(trace_path: str, k: int) -> dict:
    """A train step's share of each graph replay in a Chrome trace: the
    kernels, their busy ms, NCCL's busy ms and the replay's span on the
    device, averaged over the replays; and the whole trace's kernels, busy
    ms and NCCL ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    replays = {e["args"]["correlation"] for e in events
               if e.get("name") == "cudaGraphLaunch"
               and "correlation" in e.get("args", {})}
    by_replay: dict = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and corr in replays:
            by_replay.setdefault(corr, []).append(e)
    rows = []
    for kernels in by_replay.values():
        start = min(e["ts"] for e in kernels)
        end = max(e["ts"] + e["dur"] for e in kernels)
        rows.append((len(kernels), sum(e["dur"] for e in kernels),
                     sum(e["dur"] for e in kernels
                         if "nccl" in e["name"].lower()), end - start))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    whole = {"epoch_kernels": len(kernels),
             "epoch_busy_ms": sum(e["dur"] for e in kernels) / 1e3,
             "epoch_nccl_ms": sum(e["dur"] for e in kernels
                                  if "nccl" in e["name"].lower()) / 1e3}
    if not rows:
        return {"replays": 0, **whole}
    n = len(rows)
    return {**whole, "replays": n,
            "kernels_a_step": sum(r[0] for r in rows) / n / k,
            "busy_ms_a_step": sum(r[1] for r in rows) / n / k / 1e3,
            "nccl_ms_a_step": sum(r[2] for r in rows) / n / k / 1e3,
            "span_ms_a_step": sum(r[3] for r in rows) / n / k / 1e3}


def check_run(workload: str, k: int, axis: DataAxis,
              dtype: torch.dtype = torch.float32) -> dict:
    """``--check``'s run of ``workload`` on ``axis`` (this rank's rows of
    every global batch) in ``dtype``: the train state after it (parameters
    and buffers, on the CPU), each group's logs, and how many tensors the
    ranks found equal (0 on one card)."""
    import numpy as np

    from ..models.registry import build_model
    from ..train import dcgan_trainer, gat_trainer
    from ..train.dcgan_driver import DEFAULT_PARAMS, build_dcgan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = axis.device
    rng = np.random.default_rng(SEED)
    if workload == "unet":
        shape = (BATCH, 20, 20, 4, 6)
        nets = (build_model("unet", image_width=20, image_height=20,
                            n_vertices=6, mapping_type="linear", device=dev,
                            generator=torch.Generator().manual_seed(0),
                            use_pallas=dtype == torch.float32),)
    else:
        shape = (BATCH, 4, 64, 64)
        nets, _ = build_dcgan(DEFAULT_PARAMS, seed=0, device=dev,
                              dropout=0.0)
    nets = tuple(net.to(dtype) for net in nets)
    join_data_axis(axis, *nets)
    opts = tuple(torch.optim.SGD(net.parameters(), lr=CHECK_LR)
                 for net in nets)
    batches = [tuple(rng.random(shape, np.float32) for _ in range(2))
               for _ in range(CHECK_GROUPS * k)]
    if workload == "unet":
        mega = gat_trainer.make_gat_megastep(nets[0], opts[0], axis=axis)
        feed = (staged for *_, staged in gat_trainer.gat_megafeed(
            batches, dev, k, batch_size=BATCH, axis=axis))
    else:
        mega = dcgan_trainer.make_dcgan_megastep(*nets, *opts, axis=axis)
        feed = (staged for _, staged in dcgan_trainer._megafeed(
            batches, dev, BATCH, k, axis=axis))
    logs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for staged in feed:
            out = mega(*(t.to(dtype) for t in staged))
            logs.append({n: v.detach().cpu() for n, v in out.items()})
    state = [t.detach().cpu().clone() for net in nets
             for t in itertools.chain(net.parameters(), net.buffers())]
    return {"state": state, "logs": logs,
            "in_sync": axis.check_in_sync(nets, opts)}


def check_rank(argv):
    """One rank of ``--check`` (``spawn_ranks``'s entry): ``argv`` is the
    workload, K and the file rank 0 saves its :func:`check_run` to."""
    workload, k, out = argv
    axis = DataAxis(torch.device("cuda", torch.cuda.current_device()),
                    dist.group.WORLD)
    res = check_run(workload, int(k), axis)
    if axis.is_main:
        torch.save(res, out)


def _check(workload: str, k: int, cards: int, tmp: str) -> dict:
    """``--check`` of one workload: the JSON line's fields."""
    from ..utils.compare import drift, held_to_reference

    out = os.path.join(tmp, f"{workload}_check.pt")
    spawn_ranks(f"{__name__}:check_rank", [workload, str(k), out], cards)
    many = torch.load(out, weights_only=False)
    one = DataAxis(torch.device("cuda", 0))
    f32 = check_run(workload, k, one)
    f64 = check_run(workload, k, one, torch.float64)
    floor = drift(f32["state"], f64["state"])
    verdict = held_to_reference(many["state"], f32["state"], floor)
    return {"workload": workload, "cards": cards, "megastep": k,
            "groups": CHECK_GROUPS, "ok": verdict["ok"],
            "of_bound": verdict["worst"], "gap": verdict["gap"],
            "floor": floor["whole"], "in_sync": many["in_sync"],
            "last_logs": {n: v.tolist() for n, v in many["logs"][-1].items()},
            "one_card_last_logs": {n: v.tolist()
                                   for n, v in f32["logs"][-1].items()}}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.parallel.probe")
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs: one card then N, N then one")
    parser.add_argument("--megastep", type=int, default=0,
                        help="K > 1: K train steps a CUDA graph")
    parser.add_argument("--workload", nargs="+", choices=sorted(WORKLOADS),
                        default=["unet"])
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--trace", action="store_true",
                        help="one traced short run on 1 card and on N, "
                             "read by replay")
    parser.add_argument("--check", action="store_true",
                        help="hold N cards' replays to one card's "
                             "arithmetic, deterministic SGD")
    args = parser.parse_args(argv)
    if (args.trace or args.check) and args.megastep < 2:
        parser.error("--trace and --check run graph replays: give "
                     "--megastep K")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_probe_") as tmp:
        for workload in args.workload:
            if args.check:
                res = _check(workload, args.megastep, args.cards, tmp)
                print(json.dumps(res), flush=True)
                if not res["ok"] or (args.cards > 1 and not res["in_sync"]):
                    return 1
                continue
            cmd, loss_keys, steps, out_flag = WORKLOADS[workload](tmp)
            if args.trace:
                for axis in (1, args.cards):
                    out = os.path.join(tmp, f"{workload}_trace{axis}")
                    res = subprocess.run(cmd + [
                        "--epochs", "1", "--max-batches",
                        str(4 * args.megastep), out_flag, out,
                        "--data-axis", str(axis), "--megastep",
                        str(args.megastep), "--profile-trace-dir",
                        os.path.join(out, "trace")],
                        capture_output=True, text=True)
                    if res.returncode:
                        sys.stderr.write(res.stdout[-3000:]
                                         + res.stderr[-3000:])
                        return res.returncode
                    traces = sorted(os.listdir(os.path.join(out, "trace")))
                    print(json.dumps({
                        "workload": workload, "cards": axis,
                        "megastep": args.megastep, "trace": [
                            replay_stats(os.path.join(out, "trace", t),
                                         args.megastep)
                            for t in traces]}), flush=True)
                continue
            n_steps = [steps(e) for e in range(1, args.epochs + 1)]
            order = [1, args.cards, args.cards, 1] * args.turns
            for i, axis in enumerate(order[:2 * args.turns]):
                out = os.path.join(tmp, f"{workload}{i}")
                run = cmd + ["--epochs", str(args.epochs), out_flag, out,
                             "--data-axis", str(axis)]
                if args.megastep > 1:
                    run += ["--megastep", str(args.megastep)]
                res = subprocess.run(run, capture_output=True, text=True)
                if res.returncode:
                    sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
                    return res.returncode
                with open(os.path.join(out, "history.json")) as f:
                    h = json.load(f)
                lines = res.stdout.splitlines()
                launches = next((json.loads(ln)["kernel_launches"]
                                 for ln in lines
                                 if ln.startswith('{"kernel_launches"')), {})
                in_sync = next((ln for ln in lines
                                if ln.startswith("[data axis]")), None)
                if axis > 1 and in_sync is None:
                    sys.stderr.write("no in-sync line from the ranks\n")
                    return 1
                print(json.dumps({
                    "workload": workload, "cards": axis,
                    "megastep": args.megastep,
                    "ms_a_step": [1e3 * w / n for w, n in
                                  zip(h["epoch_wall_s"], n_steps)],
                    "steps": n_steps,
                    "dispatches": h["profiled_steps"],
                    **{k: h[k] for k in loss_keys},
                    "launches_rank0": launches,
                    "in_sync": in_sync}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
