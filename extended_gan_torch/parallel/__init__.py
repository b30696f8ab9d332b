"""Parallelism (port of ``extended_gan_tpu/parallel``): the data axis, its
cross-rank BatchNorm, expert parallelism over it (``expert.py``), FSDP /
ZeRO-3 over it (``fsdp.py``), and tensor parallelism over a model axis
beside it (``tensor.py``). Sequence and pipeline parallelism are not
ported yet (ROADMAP queue 1 item 9)."""

from .batch_norm import BatchNorm2d, attach_data_axis, join_data_axis
from .mesh import (
    DataAxis,
    ModelAxis,
    cross_replica_mean,
    data_axis_for,
    initialize_distributed,
    local_batch_size,
    pad_to_batch_multiple,
)

__all__ = ["BatchNorm2d", "DataAxis", "ModelAxis", "attach_data_axis",
           "cross_replica_mean", "data_axis_for", "initialize_distributed",
           "join_data_axis", "local_batch_size", "pad_to_batch_multiple"]
