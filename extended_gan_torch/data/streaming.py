"""File-streaming batch loaders (port of the KNMI and ARAI paths of
``extended_gan_tpu/data/streaming.py``).

- :class:`KmniLoader` is the JAX package's Python path (``use_native=False``,
  ``shuffle_mode="batch"``): file-at-a-time streaming, 8-frame windows split
  into 4 in / 4 out, value/254 then ``** power``, (B, H, W, T, V) batches,
  shuffled only within a batch, from a seeded numpy generator.
- :class:`AraiLoader` streams ARAI region blocks, (frames, R, 1, H, W) a
  file, as stride-1 windows of 2T frames, cropped and laid out (B, H, W, T,
  R), from a background thread; batches do not span files, and the train
  split's file order is shuffled from the seed.

For the same seed each yields the same bytes as the JAX package's loader.
Batches stay numpy; moving them to the card is the trainer's job,
overlapped with compute by :class:`Prefetcher`.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator

import numpy as np

from .io import array_n_frames, load_array
from .windowing import sliding_windows, truncate_to_multiple


class KmniLoader:
    """KNMI radar video streamer -> (B, H, W, T=4, V) batches. Exposes
    ``.power`` and ``.normalizing_max`` for the trainer's eval-time
    de-normalisation."""

    def __init__(self, batch_size: int, folder: str, *, time_steps: int = 4,
                 crop: int | None = None, shuffle: bool = True,
                 power: float = 1.0, seed: int = 369):
        self.batch_size = batch_size
        self.time_steps = time_steps
        self.crop = crop
        self.shuffle = shuffle
        self.power = power
        self.normalizing_max = 254.0
        self._rng = np.random.default_rng(seed)
        files = [os.path.join(folder, fn) for fn in sorted(os.listdir(folder))]
        files = [f for f in files if not f.endswith((".json", ".md"))]
        if shuffle:
            files = [files[i] for i in self._rng.permutation(len(files))]
        self.files = tuple(files)
        self.file_index = 0
        self.remainder = self._segmentify(self._read_next_file())

    def _read_next_file(self) -> np.ndarray:
        if self.file_index == len(self.files):
            raise StopIteration
        data = load_array(self.files[self.file_index])
        self.file_index += 1
        return np.asarray(data)

    def _segmentify(self, data: np.ndarray) -> np.ndarray:
        """(frames, V, H, W) -> (2, n, T, V, H, W) input/target windows."""
        w = 2 * self.time_steps
        data = truncate_to_multiple(data, w)
        data = (data.astype(np.float32) / self.normalizing_max) ** self.power
        segments = sliding_windows(data, w)  # (n, 8, V, H, W)
        if segments.shape[0] == 0:
            return np.empty((2, 0, self.time_steps) + segments.shape[2:],
                            np.float32)
        split = np.stack([segments[:, : self.time_steps],
                          segments[:, self.time_steps:]], axis=1).swapaxes(0, 1)
        if self.crop is not None:
            split = split[:, :, :, :, : self.crop, : self.crop]
        return split

    def __next__(self):
        data = self.remainder
        while data.shape[1] == 0:
            # short files yield zero windows: skip them, don't end the epoch
            data = self._segmentify(self._read_next_file())
        self.remainder = data[:, self.batch_size:]
        result = data[:, : self.batch_size]
        n = result.shape[1]
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        # (2, b, T, V, H, W) -> (2, b, H, W, T, V)
        result = result.transpose(0, 1, 4, 5, 2, 3)
        return (np.ascontiguousarray(result[0][idx]),
                np.ascontiguousarray(result[1][idx]))

    def __iter__(self):
        return self


class AraiLoader:
    """ARAI region-block streamer -> (B, H, W, T, R) batches, prepared by a
    producer thread a bounded queue (depth 2) ahead of the consumer.
    ``len()`` is the exact batch count, from the files' headers."""

    def __init__(self, batch_size: int, folder: str, *, total_length: int,
                 n_regions: int = 5, time_steps: int = 4,
                 downsample_size: tuple[int, int] = (256, 256),
                 shuffle: bool = False, seed: int = 369):
        self.batch_size = batch_size
        self.folder = folder
        self.total_length = total_length
        self.n_regions = n_regions
        self.time_steps = time_steps
        self.downsample_size = downsample_size
        self.power = 1.0
        self.normalizing_max = 1.0
        # numeric block files only, in numeric order
        self.files = sorted(
            (f for f in os.listdir(folder) if f.split(".")[0].isdigit()),
            key=lambda f: int(f.split(".")[0]))
        if shuffle:
            rng = np.random.default_rng(seed)
            self.files = [self.files[i]
                          for i in rng.permutation(len(self.files))]
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def __len__(self):
        if not hasattr(self, "_len"):
            w = 2 * self.time_steps
            self._len = sum(
                -(-max(array_n_frames(os.path.join(self.folder, f)) - w + 1,
                       0) // self.batch_size)
                for f in self.files)
        return self._len

    def _producer(self):
        try:
            h, w = self.downsample_size
            for fname in self.files:
                data = load_array(os.path.join(self.folder, fname))
                windows = sliding_windows(data[:, :, :, :h, :w],
                                          2 * self.time_steps)
                for i in range(0, len(windows), self.batch_size):
                    chunk = windows[i:i + self.batch_size]
                    self._queue.put(
                        (self._layout(chunk[:, :self.time_steps]),
                         self._layout(chunk[:, self.time_steps:])))
        except BaseException as e:  # handed to the consumer, re-raised
            self._queue.put(e)
            return
        finally:
            self._queue.put(None)

    @staticmethod
    def _layout(a: np.ndarray) -> np.ndarray:
        # (b, T, R, 1, H, W) -> (b, H, W, T, R)
        return np.ascontiguousarray(
            a.squeeze(3).transpose(0, 3, 4, 1, 2).astype(np.float32))

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def __iter__(self):
        return self


class Prefetcher:
    """Depth-N background prefetch of any iterator, applying ``transfer`` to
    each item off the training thread, so host IO and the host-to-card copy
    overlap the card's compute.

    With two cores or fewer there is no spare core for the thread, and the
    items are prepared inline. Ordering, errors and ``StopIteration`` behave
    the same either way."""

    def __init__(self, it: Iterator, depth: int = 2, transfer=None):
        threaded = (os.cpu_count() or 1) > 2
        self._transfer = transfer
        self._threaded = threaded
        if not threaded:
            self._it = it
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)

        def run():
            try:
                for item in it:
                    if self._transfer is not None:
                        item = self._transfer(item)
                    self._q.put(item)
            except BaseException as e:  # handed to the consumer, re-raised
                self._q.put(e)
                return
            finally:
                self._q.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if not self._threaded:
            item = next(self._it)  # StopIteration propagates
            return item if self._transfer is None else self._transfer(item)
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def get_kmni_loaders(train_batch_size: int, test_batch_size: int,
                     data_folder: str, *, crop: int | None = None,
                     seed: int = 369):
    """(train, val, test) loaders; val and test both read the test split,
    as the reference does."""
    def mk(bs, sub, s):
        return KmniLoader(bs, os.path.join(data_folder, sub), crop=crop,
                          seed=s)

    return (mk(train_batch_size, "train", seed),
            mk(test_batch_size, "test", seed + 1),
            mk(test_batch_size, "test", seed + 2))


def get_arai_loaders(train_batch_size: int, test_batch_size: int,
                     preprocessed_folder: str, *,
                     downsample_size: tuple[int, int] = (256, 256),
                     shuffle: bool = False, seed: int = 369):
    """(train, val, test) loaders over ``training`` and ``validation`` (val
    and test both), sized by ``metadata.json``; ``shuffle`` shuffles the
    train split's file order."""
    with open(os.path.join(preprocessed_folder, "metadata.json")) as f:
        metadata = json.load(f)

    def mk(bs, sub, sh):
        return AraiLoader(bs, os.path.join(preprocessed_folder, sub),
                          total_length=metadata[sub]["length"],
                          n_regions=metadata["n_regions"],
                          downsample_size=downsample_size, shuffle=sh,
                          seed=seed)

    return (mk(train_batch_size, "training", shuffle),
            mk(test_batch_size, "validation", False),
            mk(test_batch_size, "validation", False))


def get_loaders(train_batch_size: int, test_batch_size: int,
                preprocessed_folder: str, *, dataset: str = "kmni",
                downsample_size: tuple[int, int] = (256, 256),
                seed: int = 369):
    """Dataset dispatcher for ``kmni``, ``arai`` and ``synthetic`` (a
    synthetic KNMI archive, made on first use). The train split is
    shuffled, as the JAX driver asks."""
    if dataset == "arai":
        return get_arai_loaders(train_batch_size, test_batch_size,
                                preprocessed_folder,
                                downsample_size=downsample_size,
                                shuffle=True, seed=seed)
    if dataset == "synthetic":
        from .synthetic import ensure_synthetic_kmni

        preprocessed_folder = ensure_synthetic_kmni(preprocessed_folder or None)
    elif dataset != "kmni":
        raise ValueError(f"unknown dataset {dataset!r}")
    return get_kmni_loaders(train_batch_size, test_batch_size,
                            preprocessed_folder, crop=downsample_size[0],
                            seed=seed)
