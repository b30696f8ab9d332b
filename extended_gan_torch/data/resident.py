"""The training archive resident in device memory (port of
``extended_gan_tpu/data/resident.py``).

Every video is decoded, truncated, cropped and normalised once, and copied
to the card once, as one tensor (:class:`ResidentVideos`). A batch is then
a gather by window start inside the train step, so an epoch moves only a
(K, B) tensor of start indices per K steps, and with a megastep
(``train/megastep.py``) the gather runs inside the captured CUDA graph.

The window universe is the streaming loaders': the same truncation to a
multiple of the window, stride-1 starts that never cross a file boundary,
the same normalisation. The ragged epoch tail is padded with start -1: a
padded row gathers window 0 (its start clamps to 0) and carries a mask of
0, so the masked losses and metrics ignore it, while train-mode BatchNorm
sees it, as in JAX.

Deviation from JAX: the epoch's shuffle is ``torch.randperm`` on a
generator of the store's device seeded from (seed, epoch)
(:func:`epoch_seed`), not ``jax.random.permutation``, so the order of the
windows differs from the JAX package's for the same seed.

``from_pt_frames`` holds the CycleGAN's coastal-sea frames; its train
megastep and eval gather in NCHW with the frames as channels, as the
DCGAN's do.

Under a data axis (``parallel.DataAxis``) the store is whole on every card,
as JAX's ``put_replicated`` puts it, and every rank builds the same
programs (the same seed and the same device kind, so the same
permutation); each rank gathers its contiguous rows of every program
(``DataAxis.shard`` over the batch axis, the shard JAX's ``device_put``
over the data axis gives its device, ``:236-239``). A train program's
batch divides by the axis (the drivers check it, as JAX's do), so each
rank's share is even and each rank captures the same graph; an eval
program's may not, and the evals add their sums over the ranks.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..parallel.mesh import DataAxis
from ..train import cyclegan_trainer
from ..train.dcgan_trainer import (
    draw_batch,
    eval_results,
    make_dcgan_eval_step,
    make_dcgan_train_step,
)
from ..train.gat_trainer import _eval_metrics, make_gat_train_step
from ..train.megastep import Megastep
from .io import load_array
from .windowing import truncate_to_multiple


def _list_video_files(folder: str) -> list[str]:
    files = [os.path.join(folder, fn) for fn in sorted(os.listdir(folder))]
    return [f for f in files if not f.endswith((".json", ".md"))]


def epoch_seed(seed: int, epoch: int) -> int:
    """The shuffle's seed for ``epoch`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


class ResidentVideos:
    """A split resident on ``device``.

    Attributes:
        video: (sum_T, ...) float32 tensor, frames first (per frame
            ``(H, W, V)`` for KNMI and ARAI, ``(H, W)`` for h5).
        starts: (n_windows,) int64 tensor of window starts.
        window: frames a window (in + out).
        file_starts: the starts of each file (numpy, on the host), from
            which :meth:`eval_programs` builds its batches.
    """

    def __init__(self, video: np.ndarray, starts: np.ndarray, window: int,
                 device=None, *, power: float = 1.0,
                 normalizing_max: float = 1.0,
                 file_starts: list[np.ndarray] | None = None):
        device = torch.device("cpu" if device is None else device)
        self.video = torch.from_numpy(
            np.require(video, np.float32, ["C", "W"])).to(device)
        self.starts = torch.from_numpy(
            np.asarray(starts, np.int64)).to(device)
        self.window = int(window)
        self.n_windows = int(len(starts))
        self.power = power
        self.normalizing_max = normalizing_max
        self.file_starts = file_starts or []

    @property
    def nbytes(self) -> int:
        """Bytes the store holds on its device."""
        return (self.video.numel() * self.video.element_size()
                + self.starts.numel() * self.starts.element_size())

    # -------------------------------------------------------- constructors
    @classmethod
    def from_kmni(cls, folder: str, device=None, *, time_steps: int = 4,
                  crop: int | None = None, power: float = 1.0,
                  max_value: float = 254.0):
        """KNMI videos -> one (sum_T, H, W, V) tensor, each file prepared
        as ``KmniLoader`` prepares it."""
        w = 2 * time_steps
        chunks, starts, offset = [], [], 0
        for path in _list_video_files(folder):
            data = truncate_to_multiple(np.asarray(load_array(path)), w)
            if len(data) < w:
                continue
            data = data.astype(np.float32) / max_value
            if power != 1.0:
                data = data**power
            if crop is not None:
                data = data[:, :, :crop, :crop]
            # (T, V, H, W) -> (T, H, W, V): a gather then yields the
            # trainer's (B, H, W, S, V) after one move of the window axis
            chunks.append(np.ascontiguousarray(data.transpose(0, 2, 3, 1)))
            starts.append(offset + np.arange(len(data) - w + 1))
            offset += len(data)
        if not chunks:
            raise ValueError(f"no usable videos under {folder!r}")
        return cls(np.concatenate(chunks), np.concatenate(starts), w, device,
                   power=power, normalizing_max=max_value,
                   file_starts=starts)

    @classmethod
    def from_h5(cls, folder: str, device=None, *, in_seq_len: int = 4,
                out_seq_len: int = 4, crop: int | None = 64):
        """DCGAN frame archives (any format ``load_array`` reads: the
        port's synthetic one is ``.npy``) -> one (sum_T, H, W) tensor, the
        window universe of ``H5SequenceLoader``."""
        w = in_seq_len + out_seq_len
        chunks, starts, offset = [], [], 0
        for path in _list_video_files(folder):
            data = truncate_to_multiple(np.asarray(load_array(path)), w)
            if len(data) < w:
                continue
            if data.ndim == 4:  # (T, 1, H, W)
                data = data.squeeze(1)
            if crop is not None:
                data = data[:, :crop, :crop]
            chunks.append(np.ascontiguousarray(data, np.float32))
            starts.append(offset + np.arange(len(data) - w + 1))
            offset += len(data)
        if not chunks:
            raise ValueError(f"no usable videos under {folder!r}")
        return cls(np.concatenate(chunks), np.concatenate(starts), w, device,
                   file_starts=starts)

    @classmethod
    def from_arai(cls, folder: str, device=None, *, time_steps: int = 4,
                  downsample_size: tuple[int, int] = (256, 256)):
        """ARAI region blocks -> one (sum_T, H, W, R) tensor, the window
        universe of ``AraiLoader``: numeric file names in numeric order, no
        truncation, the top-left crop, values as stored."""
        w = 2 * time_steps
        files = sorted(
            (f for f in os.listdir(folder) if f.split(".")[0].isdigit()),
            key=lambda x: int(x.split(".")[0]))
        chunks, starts, offset = [], [], 0
        for fname in files:
            data = np.asarray(load_array(os.path.join(folder, fname)))
            if data.ndim == 5:  # (T, R, 1, H, W)
                data = data.squeeze(2)
            data = data[:, :, : downsample_size[0], : downsample_size[1]]
            if len(data) < w:
                continue
            chunks.append(np.ascontiguousarray(
                data.transpose(0, 2, 3, 1), np.float32))
            starts.append(offset + np.arange(len(data) - w + 1))
            offset += len(data)
        if not chunks:
            raise ValueError(f"no usable ARAI blocks under {folder!r}")
        return cls(np.concatenate(chunks), np.concatenate(starts), w, device,
                   file_starts=starts)

    @classmethod
    def from_pt_frames(cls, folder: str, device=None, *, seq_len: int = 4,
                       crop: int | None = 64):
        """Coastal-sea frame archives -> one (sum_T, H, W) tensor, the
        window universe of ``CoastalSeaLoader``: no truncation, every
        stride-1 window of 2 * seq_len frames within a file, a file too
        short for one skipped; values as stored."""
        w = 2 * seq_len
        chunks, starts, offset = [], [], 0
        for path in _list_video_files(folder):
            data = np.asarray(load_array(path))
            if len(data) < w:
                continue
            if data.ndim == 4:  # (T, 1, H, W)
                data = data.squeeze(1)
            if crop is not None:
                data = data[:, :crop, :crop]
            chunks.append(np.ascontiguousarray(data, np.float32))
            starts.append(offset + np.arange(len(data) - w + 1))
            offset += len(data)
        if not chunks:
            raise ValueError(f"no usable videos under {folder!r}")
        return cls(np.concatenate(chunks), np.concatenate(starts), w, device,
                   file_starts=starts)

    # ------------------------------------------------------------- epochs
    def epoch_programs(self, seed: int, k: int, batch: int, *,
                       shuffle: bool = True) -> torch.Tensor:
        """Every (K, B) program of start indices of one epoch, as one
        (n_programs, K, B) int64 tensor on the store's device, the tail
        padded with -1. With ``shuffle``, ``torch.randperm`` on a
        generator seeded ``seed`` orders the windows."""
        per = k * batch
        n_prog = max(1, math.ceil(self.n_windows / per))
        dev = self.starts.device
        if shuffle:
            gen = torch.Generator(device=dev).manual_seed(seed)
            order = torch.randperm(self.n_windows, generator=gen, device=dev)
            picked = self.starts[order]
        else:
            picked = self.starts
        pad = n_prog * per - self.n_windows
        if pad:
            picked = torch.cat([picked, picked.new_full((pad,), -1)])
        return picked.reshape(n_prog, k, batch)

    def eval_programs(self, k: int, batch: int, *, min_batch: int = 2):
        """The streaming eval's batches: consecutive windows of one file,
        ``batch`` at a time, the ragged ones -1-padded, those of fewer than
        ``min_batch`` windows dropped (the conv-GAT eval skips batches of
        one; the DCGAN eval keeps every batch: ``min_batch=1``). Returns the
        (n_programs, K, B) int64 tensor on the store's device and the count
        of real windows."""
        rows, total = [], 0
        for fs in self.file_starts:
            for i in range(0, len(fs), batch):
                chunk = fs[i:i + batch]
                if len(chunk) < min_batch:
                    continue
                row = np.full((batch,), -1, np.int64)
                row[: len(chunk)] = chunk
                rows.append(row)
                total += len(chunk)
        if not rows:
            raise ValueError("no eval batches (every file yields <= 1 "
                             "window at this batch size)")
        n_prog = math.ceil(len(rows) / k)
        rows.extend([np.full((batch,), -1, np.int64)]
                    * (n_prog * k - len(rows)))
        programs = torch.from_numpy(np.stack(rows).reshape(n_prog, k, batch))
        return programs.to(self.starts.device), total

    def program_sample_counts(self, n_programs: int, k: int,
                              batch: int) -> list[int]:
        """Real (unpadded) windows of each program, counted on the host."""
        per = k * batch
        return [min(per, self.n_windows - i * per)
                for i in range(n_programs)]


def program_logs(store: ResidentVideos, megastep, seed: int, k: int,
                 batch: int, *, max_batches: int = 0, start: int = 0,
                 axis=None):
    """One train epoch from ``store``: its programs (shuffled with
    ``seed``) from program ``start`` on (a resumed epoch: the order is the
    epoch's, so the programs before ``start`` are the ones already run)
    through ``megastep``, yielding (logs, real windows) a program; with
    ``max_batches`` (counted in train steps) at most ``ceil(max_batches /
    k)`` programs in the epoch. With a data ``axis``, this rank's rows of
    each program (the real windows stay the global count)."""
    progs = store.epoch_programs(seed, k, batch)
    if axis is not None:
        progs = axis.shard(progs, -1)
    counts = store.program_sample_counts(len(progs), k, batch)
    n_prog = len(progs)
    if max_batches:
        n_prog = min(n_prog, math.ceil(max_batches / k))
    for i in range(start, n_prog):
        yield megastep(progs[i]), counts[i]


def _gather_windows(video, st, w, *, frame_axis_to: int):
    """(windows, mask) of the starts ``st`` (B,): a start of -1 gathers
    window 0 with mask 0. The frame axis moves to ``frame_axis_to`` (3 for
    the GAT's (B, H, W, 2S, V); 1 keeps the DCGAN's frames as channels)."""
    mask = (st >= 0).to(video.dtype)
    idx = st.clamp_min(0)[:, None] + torch.arange(w, device=st.device)
    wins = video.index_select(0, idx.reshape(-1))
    wins = wins.reshape(idx.shape + video.shape[1:])
    return wins.movedim(1, frame_axis_to), mask


def make_gat_resident_megastep(model, optimizer, store: ResidentVideos, *,
                               time_steps: int = 4, criterion: str = "mse",
                               remat: bool = False,
                               moe_aux_weight: float = 0.0, axis=None):
    """K conv-GAT train steps a call, their batches gathered from ``store``
    on its device: ``megastep(starts) -> logs`` with ``starts`` a (K, B)
    program of :meth:`ResidentVideos.epoch_programs` (this rank's columns
    of it on a data ``axis``). The update is ``make_gat_megastep``'s; only
    the batch source differs. (JAX passes the video as an argument; here
    the graph reads ``store.video`` at its fixed address, so the store is
    bound when the megastep is made.)"""
    step = make_gat_train_step(model, optimizer, criterion=criterion,
                               remat=remat, moe_aux_weight=moe_aux_weight,
                               axis=axis)
    w = 2 * time_steps

    def body(st):
        wins, mask = _gather_windows(store.video, st, w, frame_axis_to=3)
        loss, running_nd = step(wins[..., :time_steps, :].contiguous(),
                                wins[..., time_steps:, :].contiguous(), mask)
        return {"loss": loss, "running_nd": running_nd}

    return Megastep(body, optimizers=(optimizer,), axis=axis)


def _median_of_uniques(vals):
    """The reference's eval threshold ``unique[int(len(unique) * 0.5)]`` of
    ``np.unique(vals)``, in fixed shapes (``torch.unique`` has a data-
    dependent size, which syncs the host): sort, mark first occurrences,
    and pick the value whose rank among the distinct ones is
    floor(n_unique / 2) + 1."""
    u = torch.sort(vals.reshape(-1)).values
    first = torch.ones_like(u, dtype=torch.int64)
    first[1:] = (u[1:] != u[:-1]).to(torch.int64)
    target = first.sum() // 2 + 1
    ranks = torch.cumsum(first, 0)
    at = torch.argmax((ranks == target).to(torch.int64))
    return u.index_select(0, at.reshape(1)).reshape(())


def make_gat_resident_eval(model, store: ResidentVideos, *,
                           time_steps: int = 4, axis=None):
    """``eval_k(starts) -> (6,)``: the sums [loss_num, denorm_num, acc,
    prec, rec, n] over the K eval batches of a program of
    :meth:`ResidentVideos.eval_programs`, each batch's threshold the median
    of the unique target values of its real rows (padded rows repeat row
    0's values, which changes no set of unique values), an undefined
    precision or recall counted as 0, as the streaming eval drops it.

    With a data ``axis`` (None: the axis of one), ``starts`` is the whole
    program: every rank takes each batch's threshold from the whole
    batch's targets, runs the model on its rows alone, and the batches'
    sums (with tp, fp and fn) are added over the ranks before precision
    and recall are formed, as ``gat_trainer.test`` does; every rank
    returns the same sums."""
    w = 2 * time_steps
    power, norm_max = store.power, store.normalizing_max
    axis = axis or DataAxis(store.video.device)
    keys = ("loss_num", "denorm_num", "acc", "tp", "fp", "fn", "n")

    @torch.no_grad()
    def eval_k(starts):
        model.eval()
        rows = []
        for st in starts:
            wins, mask = _gather_windows(store.video, st, w, frame_axis_to=3)
            thr = _threshold(wins[..., time_steps:, :], mask, power)
            wins, mask = axis.shard(wins), axis.shard(mask)
            out = _eval_metrics(model(wins[..., :time_steps, :].contiguous()),
                                wins[..., time_steps:, :].contiguous(), mask,
                                thr, norm_max, power)
            rows.append(torch.stack([out[k] for k in keys]))
        loss_num, denorm_num, acc, tp, fp, fn, n = axis.all_reduce(
            torch.stack(rows)).unbind(1)
        return torch.stack([
            loss_num, denorm_num, acc,
            torch.nan_to_num(tp / (tp + fp) * n),
            torch.nan_to_num(tp / (tp + fn) * n), n], 1).sum(0)

    return eval_k


def _threshold(y, mask, power):
    """The resident eval's threshold of one batch: the median of the
    unique values of its real rows' targets (``y ** (1 / power)``)."""
    y_p = y ** (1.0 / power) if power != 1.0 else y
    m = mask.reshape((-1,) + (1,) * (y.dim() - 1))
    return _median_of_uniques(torch.where(m > 0, y_p, y_p[0:1]))


def resident_gat_test(eval_k, store: ResidentVideos, *, k: int = 8,
                      batch_size: int = 64, flag: str = "val") -> dict:
    """``gat_trainer.test`` over a resident split: the same keys, the sums
    fetched from the card once."""
    programs, total = store.eval_programs(k, batch_size)
    sums = torch.stack([eval_k(p) for p in programs]).sum(0)
    sums = sums.double().cpu().numpy()
    total = max(total, 1)
    return {
        f"{flag}_loss": float(sums[0]) / total,
        f"{flag}_acc": float(sums[2]) / total,
        f"{flag}_prec": float(sums[3]) / total,
        f"{flag}_rec": float(sums[4]) / total,
        f"{flag}_denorm_mse": float(sums[1]) / total,
    }


def make_dcgan_resident_eval(g, fd, td, store: ResidentVideos, *,
                             in_seq_len: int = 4, out_seq_len: int = 4):
    """``eval_k(starts) -> logs``: ``make_dcgan_eval_step``'s logs summed
    over the K eval batches of a program. A batch of padding only adds
    nothing: the discriminators' accuracies count one a real batch."""
    inner = make_dcgan_eval_step(g, fd, td)
    w = in_seq_len + out_seq_len

    def eval_k(starts):
        total = None
        for st in starts:
            wins, mask = _gather_windows(store.video, st, w, frame_axis_to=1)
            _, logs = inner(wins[:, :in_seq_len].contiguous(),
                            wins[:, in_seq_len:].contiguous(), mask)
            real = (mask.sum() > 0).to(mask.dtype)
            logs = {name: v * real for name, v in logs.items()}
            total = logs if total is None else {
                name: total[name] + v for name, v in logs.items()}
        return total

    return eval_k


def draw_first_eval_batch(eval_step, store: ResidentVideos, *,
                          in_seq_len: int, out_seq_len: int,
                          batch_size: int, epoch: int, img_path: str):
    """The resident eval's figure: the first eval batch of at most 8
    windows gathered on the device, ``eval_step(x, y, mask) -> (fake,
    logs)`` on it, and its real rows drawn (``dcgan_trainer.draw_batch``;
    JAX ``dcgan_driver.py:366-395``, ``cyclegan_driver.py:391-418``)."""
    st0 = store.eval_programs(1, min(8, batch_size), min_batch=1)[0][0, 0]
    wins, mask = _gather_windows(store.video, st0,
                                 in_seq_len + out_seq_len, frame_axis_to=1)
    x = wins[:, :in_seq_len].contiguous()
    y = wins[:, in_seq_len:].contiguous()
    fake, _ = eval_step(x, y, mask)
    n = int((st0 >= 0).sum())
    draw_batch(x[:n], y[:n], fake[:n], epoch, img_path)


def resident_dcgan_test(eval_k, store: ResidentVideos, *, k: int = 8,
                        batch_size: int = 64, axis=None) -> dict:
    """``dcgan_trainer.test`` over a resident split: the same keys. With a
    data ``axis`` each rank evaluates its rows of every program and the
    sums are added over the ranks (``dcgan_trainer.eval_results``)."""
    programs, _ = store.eval_programs(k, batch_size, min_batch=1)
    if axis is not None:
        programs = axis.shard(programs, -1)
    return eval_results([eval_k(p) for p in programs], axis)


def make_dcgan_resident_megastep(g, fd, td, g_opt, fd_opt, td_opt,
                                 store: ResidentVideos, *,
                                 in_seq_len: int = 4, out_seq_len: int = 4,
                                 generators=(), fused_disc=False,
                                 fused_prop=False, axis=None):
    """K adversarial steps a call, their batches gathered from ``store``
    (``from_h5``'s (sum_T, H, W)) on its device: ``megastep(starts) ->
    logs``. The update is ``make_dcgan_megastep``'s, with its
    ``fused_disc``, ``fused_prop`` and data ``axis`` (``starts`` this
    rank's columns of the program; JAX ``data/resident.py:601-617``);
    ``generators`` the dropout's generators on the card."""
    step = make_dcgan_train_step(g, fd, td, g_opt, fd_opt, td_opt,
                                 fused_disc=fused_disc, fused_prop=fused_prop,
                                 axis=axis)
    w = in_seq_len + out_seq_len

    def body(st):
        wins, mask = _gather_windows(store.video, st, w, frame_axis_to=1)
        return step(wins[:, :in_seq_len].contiguous(),
                    wins[:, in_seq_len:].contiguous(), mask)

    return Megastep(body, optimizers=(g_opt, fd_opt, td_opt),
                    generators=generators, axis=axis)


def make_cyclegan_resident_megastep(g_xy, g_yx, d_x, d_y, g_xy_opt, g_yx_opt,
                                    d_x_opt, d_y_opt, store: ResidentVideos,
                                    *, seq_len: int = 4,
                                    cycle_lambda: float = 10.0,
                                    generators=(), axis=None):
    """K CycleGAN steps a call, their batches gathered from ``store``
    (``from_pt_frames``'s (sum_T, H, W)) on its device: ``megastep(starts)
    -> logs``. The update is ``make_cyclegan_megastep``'s, over the data
    ``axis`` (``starts`` this rank's columns of the program);
    ``generators`` the dropout's generators on the card."""
    opts = (g_xy_opt, g_yx_opt, d_x_opt, d_y_opt)
    step = cyclegan_trainer.make_cyclegan_train_step(
        g_xy, g_yx, d_x, d_y, *opts, cycle_lambda=cycle_lambda, axis=axis)
    w = 2 * seq_len

    def body(st):
        wins, mask = _gather_windows(store.video, st, w, frame_axis_to=1)
        return step(wins[:, :seq_len].contiguous(),
                    wins[:, seq_len:].contiguous(), mask)

    return Megastep(body, optimizers=opts, generators=generators, axis=axis)


def make_cyclegan_resident_eval(g_xy, g_yx, store: ResidentVideos, *,
                                seq_len: int = 4):
    """``eval_k(starts) -> logs``: ``make_cyclegan_eval_step``'s (num,
    denom) pairs summed over the K eval batches of a program; a batch of
    padding adds 0 to both."""
    inner = cyclegan_trainer.make_cyclegan_eval_step(g_xy, g_yx)
    w = 2 * seq_len

    def eval_k(starts):
        total = None
        for st in starts:
            wins, mask = _gather_windows(store.video, st, w, frame_axis_to=1)
            _, logs = inner(wins[:, :seq_len].contiguous(),
                            wins[:, seq_len:].contiguous(), mask)
            total = logs if total is None else {
                name: total[name] + v for name, v in logs.items()}
        return total

    return eval_k


def resident_cyclegan_test(eval_k, store: ResidentVideos, *, k: int = 8,
                           batch_size: int = 64, axis=None) -> dict:
    """``cyclegan_trainer.test`` over a resident split: the same keys. Every
    batch counts (``min_batch=1``): the metrics are masked sums, which a
    data ``axis``'s ranks each take over their rows and add up."""
    programs, _ = store.eval_programs(k, batch_size, min_batch=1)
    if axis is not None:
        programs = axis.shard(programs, -1)
    return cyclegan_trainer.eval_results([eval_k(p) for p in programs], axis)
