"""Checkpointing (port of ``extended_gan_tpu/train/checkpoint.py``).

Two tiers, as in the JAX package:

- :func:`save_model` / :func:`load_model`: weights-only snapshots, a
  ``torch.save`` of ``{"schema", "state_dict"}``. A bare state_dict (the
  conv-GAT driver's ``model.pt``) reads as schema v1.
- :class:`CheckpointManager`: the full train state, one ``torch.save`` file
  a step under its directory, the newest ``max_to_keep`` kept, and a
  ``schema.json`` sidecar.

Both carry ``SCHEMA_VERSION`` and refuse a version from the future. The
JAX package writes Orbax directories, which the port cannot read; a GAN
checkpoint here holds the nets' state_dicts (the DCGAN's three, the
CycleGAN's four; BatchNorm running statistics included), their Adam states
(``train/state.py``), ``epoch``, the state of the driver's dropout stream
(``core/prng.py``) and the v3 ``mid`` subtree; a conv-GAT checkpoint holds
the net, its optimizer and its scheduler, ``epoch``, ``lr``, ``best``, the
key stream and the conv-GAT's ``mid`` (:func:`empty_gat_mid`).

Resume (:func:`setup_gan_checkpointing`, and the conv-GAT driver's own
block): the latest step is loaded into the running nets, optimizers and
streams, and ``history.json`` is read back. ``mid["batch"] > 0`` marks a
snapshot taken inside an epoch (a preemption, ``train/preempt.py``): the
driver redoes that epoch from that batch, replaying the consumed batches,
with the partial sums of ``mid``. A restore casts each tensor to the
running template's dtype, so a run resumes under another ``precision``
than it was saved with (the port keeps parameters and optimizer state in
float32 under both).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch

from ..utils.history import TrainingHistory
from .state import NetState

SCHEMA_VERSION = 3
_SIDECAR = "schema.json"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")

# checkpoint step numbering: epoch e, b batches in => e * STRIDE + b. The
# completion of epoch e is the start of epoch e + 1 => (e + 1) * STRIDE,
# which sorts above any mid-epoch snapshot of epoch e.
MID_EPOCH_STRIDE = 100_000


def ckpt_step(epoch: int, batch: int = 0) -> int:
    """Step id of a snapshot taken ``batch`` batches into ``epoch``
    (``batch=0`` is the epoch's start, the previous epoch's end)."""
    if not 0 <= batch < MID_EPOCH_STRIDE:
        raise ValueError(f"batch {batch} outside [0, {MID_EPOCH_STRIDE})")
    return epoch * MID_EPOCH_STRIDE + batch


def empty_mid() -> dict:
    """The v3 ``mid`` subtree, zeroed (an epoch-boundary checkpoint):
    ``batch`` train batches consumed in the epoch being resumed, and the
    epoch's partial (numerator, denominator) metric accumulators."""
    return {
        "batch": torch.tensor(0, dtype=torch.int64),
        "mse": torch.zeros(2, dtype=torch.float64),
        "fd_acc": torch.zeros(2, dtype=torch.float64),
        "td_acc": torch.zeros(2, dtype=torch.float64),
    }


def empty_gat_mid() -> dict:
    """The conv-GAT trainer's v3 ``mid`` subtree, zeroed: ``batch`` loader
    batches consumed in the epoch being resumed (programs on the resident
    path), and its partial running-loss numerator ``loss`` and sample count
    ``total``."""
    return {
        "batch": torch.tensor(0, dtype=torch.int64),
        "loss": torch.tensor(0.0, dtype=torch.float64),
        "total": torch.tensor(0, dtype=torch.int64),
    }


def _cast_like(template: Any, restored: Any) -> Any:
    """Cast restored tensors to the template's dtypes where the template
    has a tensor at the same place (cross-precision restore)."""
    if isinstance(restored, torch.Tensor):
        if isinstance(template, torch.Tensor) and \
                template.dtype != restored.dtype:
            return restored.to(template.dtype)
        return restored
    if isinstance(restored, dict):
        tmpl = template if isinstance(template, dict) else {}
        return {k: _cast_like(tmpl.get(k), v) for k, v in restored.items()}
    if isinstance(restored, (list, tuple)):
        tmpl = template if isinstance(template, (list, tuple)) and \
            len(template) == len(restored) else [None] * len(restored)
        return type(restored)(_cast_like(t, r) for t, r in zip(tmpl,
                                                               restored))
    return restored


def _check_version(version: int, where: str):
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"{where} was written with checkpoint schema v{version}, but "
            f"this build only understands <= v{SCHEMA_VERSION}. Upgrade the "
            "framework to restore it.")


def tree_to_cpu(tree: Any) -> Any:
    """Every tensor of a tree of dicts, lists and tuples as a contiguous CPU
    copy, so ``torch.save`` writes only its own elements."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_cpu(v) for v in tree)
    return tree


# --------------------------------------------------------------- model-only
def save_model(path: str, state_dict: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"schema": SCHEMA_VERSION, "state_dict": tree_to_cpu(state_dict)},
               path)


def load_model(path: str, template_state_dict: dict | None = None) -> dict:
    """The state_dict of a snapshot, cast to the template's dtypes."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if "schema" in raw and "state_dict" in raw:
        version, state = int(raw["schema"]), raw["state_dict"]
    else:  # v1: a bare state_dict
        version, state = 1, raw
    _check_version(version, path)
    return _cast_like(template_state_dict, state)


# ------------------------------------------------------------- full state
class CheckpointManager:
    """Full-train-state checkpoints (``step_{N}.pt``) with keep-N
    rotation."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)
        _check_version(self.sidecar_version(), self._dir)

    def sidecar_version(self) -> int:
        """Schema version the directory was last written with (1 without a
        sidecar)."""
        path = os.path.join(self._dir, _SIDECAR)
        if not os.path.exists(path):
            return 1
        with open(path) as f:
            return int(json.load(f).get("schema_version", 1))

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self._dir))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any):
        tmp = self._path(step) + ".tmp"
        torch.save(tree_to_cpu(state), tmp)
        os.replace(tmp, self._path(step))  # a reader never sees half a file
        with open(os.path.join(self._dir, _SIDECAR), "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION,
                       "format": "torch.save"}, f)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, template: Any, step: int | None = None):
        """Restore ``step`` (default: the latest), its tensors cast to the
        template's dtypes; None when the directory holds no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        _check_version(self.sidecar_version(), self._dir)
        restored = torch.load(self._path(step), map_location="cpu",
                              weights_only=True)
        return _cast_like(template, restored)


class SnapshotOnly:
    """The checkpoint manager of a rank that builds every snapshot (the
    gather of FSDP shards, ``parallel/fsdp.py``, is a collective) and
    writes none: rank 0 writes."""

    def save(self, step: int, state: Any):
        pass


def gan_restore_template(mgr: CheckpointManager, states, key_state):
    """Restore template of a GAN checkpoint directory, matching the schema
    version it was written with (v3 adds ``mid``)."""
    template = {"states": states, "epoch": 0, "key": key_state}
    if mgr.sidecar_version() >= 3:
        template["mid"] = empty_mid()
    return template


# the nets' names in the JAX package's state containers
DCGAN_NETS = ("g", "fd", "td")  # GANStates
CYCLEGAN_NETS = ("g_xy", "g_yx", "d_x", "d_y")  # CycleGANStates


def gan_net_states(nets, opts, names=DCGAN_NETS) -> dict:
    """The nets with their optimizers, keyed by ``names``: the DCGAN's
    ``g``, ``fd``, ``td`` by default, or :data:`CYCLEGAN_NETS`."""
    if not len(nets) == len(opts) == len(names):
        raise ValueError(f"{len(nets)} nets, {len(opts)} optimizers and "
                         f"{len(names)} names")
    return {name: NetState(net, opt)
            for name, net, opt in zip(names, nets, opts)}


def gan_states(nets, opts, names=DCGAN_NETS) -> dict:
    """The state tree of :func:`gan_net_states`: each net's state_dict and
    its optimizer's state."""
    return {name: st.state_dict()
            for name, st in gan_net_states(nets, opts, names).items()}


def describe_resume(mid: dict, epoch: int) -> int:
    """The epoch a resumed run starts at, from a restored ``mid`` and
    ``epoch``, printed as the JAX drivers print it: the same epoch, redone
    from ``mid["batch"]``, after a mid-epoch snapshot; the next one after
    an epoch-boundary one."""
    done = int(mid["batch"])
    if done > 0:
        print(f"[resume] restored mid-epoch snapshot: epoch {epoch}, {done} "
              "batches done; continuing inside the epoch")
        return epoch
    print(f"[resume] restored epoch {epoch}; continuing at {epoch + 1}")
    return epoch + 1


def setup_gan_checkpointing(out_dir: str | None, *, resume: bool = False,
                            save_epoch: int = 0, states: dict | None = None,
                            keys=None, history: TrainingHistory | None = None):
    """The JAX package's shared dcgan/cyclegan block.

    A manager over ``<out_dir>/checkpoints`` keeping 2, when ``out_dir`` is
    set and checkpoints or a resume are asked for; with ``resume`` and a
    step on disk, the latest one is loaded into ``states`` (name ->
    :class:`~.state.NetState`) and ``keys`` (a ``core.prng.KeySeq``), and
    ``<out_dir>/history.json`` into the history. Returns ``(manager or
    None, start_epoch, history, mid)``: with ``mid["batch"] > 0`` the
    driver redoes ``start_epoch`` from that batch."""
    mid = empty_mid()
    if not (out_dir and (resume or save_epoch)):
        return None, 1, history, mid
    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"),
                            max_to_keep=2)
    if not (resume and mgr.latest_step() is not None):
        return mgr, 1, history, mid
    template = gan_restore_template(
        mgr, {n: st.state_dict() for n, st in states.items()}, keys.state)
    restored = mgr.restore(template)
    for name, st in states.items():
        st.load_state_dict(restored["states"][name])
    keys.state = restored["key"]
    mid = restored.get("mid", empty_mid())
    start_epoch = describe_resume(mid, int(restored["epoch"]))
    hist_path = os.path.join(out_dir, "history.json")
    if os.path.exists(hist_path):
        history = TrainingHistory.from_json(hist_path)
    return mgr, start_epoch, history, mid


def run_gan_epochs(epoch_feed, train_epoch, *, shutdown, ckpt_mgr, snapshot,
                   history: TrainingHistory, hist_path: str | None,
                   start_epoch: int, epochs: int, save_epoch: int,
                   mid: dict, profiler=None):
    """The DCGAN and CycleGAN drivers' epochs, from ``start_epoch`` (redone
    from ``mid["batch"]`` when that is > 0) to ``epochs``.

    ``epoch_feed(epoch, skip)`` gives (the epoch's train logs from batch
    ``skip`` on, its eval); ``train_epoch(logs, shutdown=, init_metrics=,
    epoch=, profiler=)`` gives (results, None), or (None, mid) when
    ``shutdown`` was requested inside the epoch (``profiler``, a
    ``utils/profiling.EpochProfiler`` or None, times it);
    ``snapshot(epoch, mid)`` is the checkpoint tree. A snapshot is written
    every ``save_epoch`` epochs, at the last and at a preemption, with
    ``history.json``, when ``ckpt_mgr`` is set. A preemption ends the
    loop."""
    for epoch in range(start_epoch, epochs + 1):
        skip = int(mid["batch"]) if epoch == start_epoch else 0
        logs, evaluate = epoch_feed(epoch, skip)
        results, mid_out = train_epoch(
            logs, shutdown=shutdown, init_metrics=mid if skip else None,
            epoch=epoch, profiler=profiler)
        if mid_out is not None:
            # step-granular preemption: a snapshot inside the epoch
            if ckpt_mgr is not None:
                ckpt_mgr.save(ckpt_step(epoch, int(mid_out["batch"])),
                              snapshot(epoch, mid_out))
                if hist_path:
                    history.to_json(hist_path)
                print(f"[preempt] stopped resumably mid-epoch {epoch} "
                      f"({int(mid_out['batch'])} batches in)")
            else:
                print(f"[preempt] stopped mid-epoch {epoch} WITHOUT a "
                      "snapshot: no checkpointing configured (set "
                      "save_epoch / --save-epoch); progress is lost")
            return
        mid = empty_mid()
        results |= evaluate()
        print(json.dumps(results, indent=4))
        history.append(results)
        # read once: a SIGTERM between "save?" and "stop?" must not stop
        # without the snapshot
        preempted = shutdown.requested
        if ckpt_mgr is not None and (
                (save_epoch and epoch % save_epoch == 0) or epoch == epochs
                or preempted):
            # an epoch-boundary snapshot is the start of epoch + 1
            ckpt_mgr.save(ckpt_step(epoch + 1, 0),
                          snapshot(epoch, empty_mid()))
            if hist_path:
                history.to_json(hist_path)
        if preempted:
            print(f"[preempt] stopped after epoch {epoch}"
                  + ("" if ckpt_mgr is not None else
                     " WITHOUT a snapshot: no checkpointing configured "
                     "(set save_epoch / --save-epoch)"))
            return
