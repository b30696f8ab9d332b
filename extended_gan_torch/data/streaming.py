"""File-streaming batch loaders (port of the coastal-sea, KNMI, ARAI and h5
paths of ``extended_gan_tpu/data/streaming.py``).

- :class:`CoastalSeaLoader` streams the CycleGAN's coastal-sea frame files,
  (frames, C, H, W) each: every stride-1 window of 2 * seq_len frames of a
  file (no truncation: the reference's truncation slice is an
  operator-precedence no-op, which JAX keeps), cropped, ``batch_size``
  windows a batch, a file too short for one window skipped. (x, y) come as
  (B, seq_len, C, H, W) each, the window's two halves.
- :class:`H5SequenceLoader` streams the DCGAN's frame files, (frames, C, H,
  W) each: a batch takes the ``batch_size`` windows of in + out frames that
  start at offsets 0..batch_size-1 of the current buffer, then drops
  batch_size frames; a buffer too short for one window is replaced by the
  next file. (x, y) come as (B, in, C, H, W) and (B, out, C, H, W).
- :class:`KmniLoader` streams KNMI videos file at a time: 8-frame windows
  split into 4 in / 4 out, value/254 then ``** power``, (B, H, W, T, V)
  batches (or the 2x3 vertex-pair mosaic), built in the C++ core of
  ``data/native.py`` (``use_native=False``: numpy), shuffled within a batch
  or, with ``shuffle_mode="global"``, over every window of pools of files.
- :class:`AraiLoader` streams ARAI region blocks, (frames, R, 1, H, W) a
  file, as stride-1 windows of 2T frames, cropped and laid out (B, H, W, T,
  R), from a background thread (in the C++ core, or numpy); batches do not
  span files, and the train split's file order is shuffled from the seed.

Each shuffles from a seeded numpy generator, making the JAX package's
draws, so for the same seed and options each yields the same bytes as the
JAX package's loader.
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

from . import native
from .io import array_n_frames, load_array
from .windowing import sliding_windows, truncate_to_multiple


def _list_files(folder: str, rng: np.random.Generator | None):
    files = [os.path.join(folder, fn) for fn in sorted(os.listdir(folder))]
    files = [f for f in files if not f.endswith((".json", ".md"))]
    if rng is not None:
        files = [files[i] for i in rng.permutation(len(files))]
    return tuple(files)


class _FileStream:
    """File-at-a-time streaming from a folder, with the seeded generator
    that shuffles the file order (when ``shuffle``) and each batch."""

    def __init__(self, folder: str, *, shuffle: bool, seed: int):
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.files = _list_files(folder, self._rng if shuffle else None)
        self.file_index = 0

    def read_next_file(self) -> np.ndarray:
        if self.file_index == len(self.files):
            raise StopIteration
        data = load_array(self.files[self.file_index])
        self.file_index += 1
        return np.asarray(data)

    def perm(self, n: int) -> np.ndarray:
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def __iter__(self):
        return self


class CoastalSeaLoader(_FileStream):
    """The CycleGAN's coastal-sea frame streamer (see the module
    docstring)."""

    def __init__(self, folder: str, batch_size: int, *,
                 crop: int | None = 64, shuffle: bool = True,
                 seq_len: int = 4, seed: int = 369):
        super().__init__(folder, shuffle=shuffle, seed=seed)
        self.batch_size = batch_size
        self.crop = crop
        self.seq_len = seq_len
        self.remainder = self._segmentify(self.read_next_file())

    def _segmentify(self, data: np.ndarray) -> np.ndarray:
        # the reference's `data[: (len // 2 * seq_len) * 2 * seq_len]`
        # bound always exceeds len: every window of the file is used
        if self.crop is not None:
            data = data[:, :, : self.crop, : self.crop]
        return sliding_windows(data, 2 * self.seq_len)

    def __next__(self):
        data = self.remainder
        while data.shape[0] == 0:
            # StopIteration comes from read_next_file once the folder is done
            data = self._segmentify(self.read_next_file())
        self.remainder = data[self.batch_size:]
        result = data[: self.batch_size]
        idx = self.perm(result.shape[0])
        x = result[idx, : self.seq_len].astype(np.float32)
        y = result[idx, self.seq_len:].astype(np.float32)
        return x, y


class H5SequenceLoader(_FileStream):
    """The DCGAN's frame streamer (see the module docstring)."""

    def __init__(self, folder: str, batch_size: int, *,
                 crop: int | None = 64, shuffle: bool = True,
                 in_seq_len: int = 4, out_seq_len: int = 4, seed: int = 369):
        super().__init__(folder, shuffle=shuffle, seed=seed)
        self.batch_size = batch_size
        self.crop = crop
        self.in_seq_len = in_seq_len
        self.tot_seq_len = in_seq_len + out_seq_len
        self.remainder = self._segmentify(self.read_next_file())

    def _segmentify(self, data: np.ndarray) -> np.ndarray:
        data = truncate_to_multiple(data, self.tot_seq_len)
        if self.crop is not None:
            data = data[:, :, : self.crop, : self.crop]
        return data

    def __next__(self):
        data = self.remainder
        while True:
            windows = sliding_windows(data, self.tot_seq_len)[
                : self.batch_size]
            if len(windows):
                break
            # StopIteration comes from read_next_file once the folder is done
            data = self._segmentify(self.read_next_file())
        self.remainder = data[self.batch_size:]
        idx = self.perm(windows.shape[0])
        x = windows[idx, : self.in_seq_len].astype(np.float32)
        y = windows[idx, self.in_seq_len:].astype(np.float32)
        return x, y


class KmniLoader(_FileStream):
    """KNMI radar video streamer -> (B, H, W, T=4, V) batches, or the 2x3
    vertex-pair mosaic (B, T, 2H, 3W) with ``merge_nodes``. Exposes
    ``.power`` and ``.normalizing_max`` for the trainer's eval-time
    de-normalisation, and ``file_length`` (twice the first file's windows;
    twice the epoch's windows in global mode).

    ``use_native`` builds each batch in the C++ core (``data/native.py``:
    gather, normalisation, crop and layout in one pass, without the GIL);
    ``use_native=False`` is the numpy path, which divides by 254 where the
    core multiplies by its rounded inverse (within 1e-6 of each other).

    ``shuffle_mode``:

    - ``"batch"`` (the reference's): a batch is consecutive windows of one
      file, shuffled only within the batch;
    - ``"global"``: a permutation of every (file, window) pair, counted from
      the files' headers: the file order shuffled, files grouped into pools
      of ``shuffle_pool`` and windows shuffled freely within a pool, so each
      file decodes once an epoch (a cache holds two pools, at most
      :attr:`MAX_CACHED_VIDEOS` videos); ``shuffle_pool=0`` is one pool, the
      fully random order. ``n_decodes`` counts the decodes. Global mode
      builds its batches in the C++ core.
    """

    # most decoded videos global mode holds at once: shuffle_pool=0 would
    # otherwise cache the whole archive
    MAX_CACHED_VIDEOS = 16

    def __init__(self, batch_size: int, folder: str, *, time_steps: int = 4,
                 crop: int | None = None, shuffle: bool = True,
                 merge_nodes: bool = False, power: float = 1.0,
                 seed: int = 369, use_native: bool = True,
                 shuffle_mode: str = "batch", shuffle_pool: int = 4):
        super().__init__(folder, shuffle=shuffle, seed=seed)
        self.batch_size = batch_size
        self.time_steps = time_steps
        self.crop = crop
        self.merge_nodes = merge_nodes
        self.power = power
        self.normalizing_max = 254.0
        self.shuffle_mode = shuffle_mode
        self.shuffle_pool = shuffle_pool
        if shuffle_mode == "global":
            self._init_global()
            self.use_native = True
            self.file_length = 2 * len(self._order)
            return
        if shuffle_mode != "batch":
            raise ValueError(f"unknown shuffle_mode {shuffle_mode!r}")
        self.use_native = use_native
        if use_native:
            self._advance_file()
            self.file_length = 2 * len(self._starts)
        else:
            self.remainder = self._segmentify(self.read_next_file())
            self.file_length = (self.remainder.shape[0]
                                * self.remainder.shape[1])

    def _advance_file(self):
        """The next file's raw video and its window starts (native path)."""
        w = 2 * self.time_steps
        data = truncate_to_multiple(self.read_next_file(), w)
        self._video = np.ascontiguousarray(data, np.float32)
        self._starts = np.arange(max(len(self._video) - w + 1, 0),
                                 dtype=np.int64)

    def _init_global(self):
        w = 2 * self.time_steps
        # window counts from the headers: no file is decoded here
        counts = [max((array_n_frames(path) // w) * w - w + 1, 0)
                  for path in self.files]
        file_ids = np.arange(len(self.files))
        if self.shuffle:
            file_ids = self._rng.permutation(file_ids)
        pool = max(int(self.shuffle_pool), 0) or len(self.files) or 1
        chunks = []
        for i in range(0, len(file_ids), pool):
            ids = np.asarray(file_ids[i:i + pool], np.int64)
            cnts = np.asarray([counts[fi] for fi in ids], np.int64)
            # (file, start) pairs of the pool, built without a Python tuple
            # a window
            block = np.stack([
                np.repeat(ids, cnts),
                np.concatenate([np.arange(c, dtype=np.int64) for c in cnts])
                if len(cnts) else np.empty(0, np.int64)], axis=1)
            if self.shuffle and len(block):
                block = block[self._rng.permutation(len(block))]
            chunks.append(block)
        self._order = (np.concatenate(chunks) if chunks
                       else np.empty((0, 2), np.int64))
        self._cursor = 0
        self._pool_size = pool
        self._video_cache: dict = {}
        self.n_decodes = 0

    def _load_video(self, fi: int) -> np.ndarray:
        if fi not in self._video_cache:
            # room for two pools: a batch can straddle one pool boundary,
            # so with it each file decodes once an epoch
            cap = min(max(2 * self._pool_size, 2), self.MAX_CACHED_VIDEOS)
            while len(self._video_cache) >= cap:
                self._video_cache.pop(next(iter(self._video_cache)))
            data = truncate_to_multiple(
                np.asarray(load_array(self.files[fi])), 2 * self.time_steps)
            self._video_cache[fi] = np.ascontiguousarray(data, np.float32)
            self.n_decodes += 1
        return self._video_cache[fi]

    def _make(self):
        return (native.kmni_make_batch_merged if self.merge_nodes
                else native.kmni_make_batch)

    def _next_global(self):
        if self._cursor >= len(self._order):
            raise StopIteration
        batch = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += len(batch)
        xs, ys = [], []
        for fi in np.unique(batch[:, 0]):
            x, y = self._make()(
                self._load_video(int(fi)), batch[batch[:, 0] == fi, 1],
                steps=self.time_steps, crop=self.crop,
                max_value=self.normalizing_max, power=self.power)
            xs.append(x)
            ys.append(y)
        return np.concatenate(xs), np.concatenate(ys)

    def _next_native(self):
        while len(self._starts) == 0:
            self._advance_file()  # StopIteration once the folder is done
        batch_starts = self._starts[:self.batch_size]
        self._starts = self._starts[self.batch_size:]
        idx = self.perm(len(batch_starts))
        return self._make()(self._video, batch_starts[idx],
                            steps=self.time_steps, crop=self.crop,
                            max_value=self.normalizing_max, power=self.power)

    def _segmentify(self, data: np.ndarray) -> np.ndarray:
        """(frames, V, H, W) -> (2, n, T, V, H, W) input/target windows, or
        (2, n, T, 2H, 3W) mosaics with ``merge_nodes``."""
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
        if self.merge_nodes:
            # vertex pairs (0, 1), (1, 2), (2, 3) tiled 2 high, 3 wide
            split = np.concatenate(
                [np.concatenate((split[:, :, :, i], split[:, :, :, i + 1]),
                                axis=3) for i in range(3)], axis=4)
        return split

    def __next__(self):
        if self.shuffle_mode == "global":
            return self._next_global()
        if self.use_native:
            return self._next_native()
        data = self.remainder
        while data.shape[1] == 0:
            # short files yield zero windows: skip them, don't end the epoch
            data = self._segmentify(self.read_next_file())
        self.remainder = data[:, self.batch_size:]
        result = data[:, : self.batch_size]
        idx = self.perm(result.shape[1])
        if not self.merge_nodes:
            # (2, b, T, V, H, W) -> (2, b, H, W, T, V)
            result = result.transpose(0, 1, 4, 5, 2, 3)
        return (np.ascontiguousarray(result[0][idx]),
                np.ascontiguousarray(result[1][idx]))


class AraiLoader:
    """ARAI region-block streamer -> (B, H, W, T, R) batches, prepared by a
    producer thread a bounded queue (depth 2) ahead of the consumer, in the
    C++ core (``use_native``, the default) or in numpy: the same bytes.
    ``len()`` is the exact batch count, from the files' headers."""

    def __init__(self, batch_size: int, folder: str, *, total_length: int,
                 n_regions: int = 5, time_steps: int = 4,
                 downsample_size: tuple[int, int] = (256, 256),
                 use_native: bool = True, shuffle: bool = False,
                 seed: int = 369):
        self.batch_size = batch_size
        self.folder = folder
        self.total_length = total_length
        self.n_regions = n_regions
        self.time_steps = time_steps
        self.downsample_size = downsample_size
        self.use_native = use_native
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

    def _produce_native(self, data: np.ndarray):
        """A (N, R, 1, H, W) block's batches through the C++ core: the same
        (frames, regions, H, W) -> (B, H, W, T, R) transform as a KNMI
        batch, with identity normalisation, in this producer thread."""
        video = np.ascontiguousarray(np.asarray(data).squeeze(2), np.float32)
        n_windows = max(len(video) - 2 * self.time_steps + 1, 0)
        for i in range(0, n_windows, self.batch_size):
            starts = np.arange(i, min(i + self.batch_size, n_windows),
                               dtype=np.int64)
            self._queue.put(native.kmni_make_batch(
                video, starts, steps=self.time_steps,
                crop=tuple(self.downsample_size), max_value=1.0, power=1.0))

    def _produce_numpy(self, data: np.ndarray):
        h, w = self.downsample_size
        windows = sliding_windows(data[:, :, :, :h, :w], 2 * self.time_steps)
        for i in range(0, len(windows), self.batch_size):
            chunk = windows[i:i + self.batch_size]
            self._queue.put((self._layout(chunk[:, :self.time_steps]),
                             self._layout(chunk[:, self.time_steps:])))

    def _producer(self):
        try:
            for fname in self.files:
                data = load_array(os.path.join(self.folder, fname))
                if self.use_native:
                    self._produce_native(data)
                else:
                    self._produce_numpy(data)
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
    """Depth-N background prefetch of an iterator, applying ``transfer`` to
    each item off the training thread, so host IO and the host-to-card copy
    overlap the card's compute. Iterate it once.

    With two cores or fewer there is no spare core for the thread, and the
    items are prepared inline. Ordering, errors and the end of the items
    behave the same either way.

    The thread starts with the iteration and stops with it: when the
    consumer stops early (a preempted epoch, an iteration closed or
    dropped), the producer is told to stop and waited for. A producer left
    inside a transfer when the interpreter exits is torn down inside
    torch's C++ code, which aborts the process."""

    def __init__(self, it: Iterator, depth: int = 2, transfer=None):
        self._it, self._depth, self._transfer = it, depth, transfer
        self._threaded = (os.cpu_count() or 1) > 2

    def __iter__(self):
        if not self._threaded:
            for item in self._it:
                yield item if self._transfer is None else self._transfer(item)
            return
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def run():
            try:
                for item in self._it:
                    if stop.is_set():
                        return
                    if self._transfer is not None:
                        item = self._transfer(item)
                    q.put(item)
            except BaseException as e:  # handed to the consumer, re-raised
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not None:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():
                # room in the queue frees a put the producer waits in
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.01)


def get_coastal_loaders(data_location: str, train_batch_size: int,
                        test_batch_size: int, *, seq_len: int = 4,
                        crop: int | None = 64, seed: int = 369):
    """(train, test) coastal-sea loaders over ``train`` and ``test``, seeded
    ``seed`` and ``seed + 1``."""
    def mk(sub, bs, s):
        return CoastalSeaLoader(os.path.join(data_location, sub), bs,
                                crop=crop, seq_len=seq_len, seed=s)

    return mk("train", train_batch_size, seed), mk("test", test_batch_size,
                                                   seed + 1)


def get_h5_loaders(data_location: str, train_batch_size: int,
                   test_batch_size: int, *, crop: int | None = 64,
                   in_seq_len: int = 12, out_seq_len: int = 6,
                   seed: int = 369):
    """(train, test) loaders over ``train`` and ``test``, seeded ``seed``
    and ``seed + 1``."""
    def mk(sub, bs, s):
        return H5SequenceLoader(os.path.join(data_location, sub), bs,
                                crop=crop, in_seq_len=in_seq_len,
                                out_seq_len=out_seq_len, seed=s)

    return mk("train", train_batch_size, seed), mk("test", test_batch_size,
                                                   seed + 1)


def get_kmni_loaders(train_batch_size: int, test_batch_size: int,
                     data_folder: str, *, crop: int | None = None,
                     shuffle: bool = True, merge_nodes: bool = False,
                     seed: int = 369, shuffle_mode: str = "batch"):
    """(train, val, test) loaders; val and test both read the test split,
    as the reference does."""
    def mk(bs, sub, s):
        return KmniLoader(bs, os.path.join(data_folder, sub), crop=crop,
                          shuffle=shuffle, merge_nodes=merge_nodes, seed=s,
                          shuffle_mode=shuffle_mode)

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
                merge_nodes: bool = False, shuffle: bool = True,
                seed: int = 369, shuffle_mode: str = "batch"):
    """Dataset dispatcher for ``kmni``, ``arai`` and ``synthetic`` (a
    synthetic KNMI archive, made on first use). ``shuffle`` (the JAX
    driver's default) shuffles within each batch, and the ARAI train
    split's file order; ``merge_nodes`` and ``shuffle_mode`` go to the KNMI
    loaders."""
    if dataset == "arai":
        return get_arai_loaders(train_batch_size, test_batch_size,
                                preprocessed_folder,
                                downsample_size=downsample_size,
                                shuffle=shuffle, seed=seed)
    if dataset == "synthetic":
        from .synthetic import ensure_synthetic_kmni

        preprocessed_folder = ensure_synthetic_kmni(preprocessed_folder or None)
    elif dataset != "kmni":
        raise ValueError(f"unknown dataset {dataset!r}")
    return get_kmni_loaders(train_batch_size, test_batch_size,
                            preprocessed_folder, crop=downsample_size[0],
                            shuffle=shuffle, merge_nodes=merge_nodes,
                            seed=seed, shuffle_mode=shuffle_mode)
