"""Parallelism (port of ``extended_gan_tpu/parallel``): the data axis and
its cross-rank BatchNorm. Tensor, sequence, FSDP, pipeline and expert
parallelism are not ported yet (ROADMAP queue 1 item 9)."""

from .batch_norm import BatchNorm2d, attach_data_axis, join_data_axis
from .mesh import (
    DataAxis,
    cross_replica_mean,
    data_axis_for,
    initialize_distributed,
    local_batch_size,
    pad_to_batch_multiple,
)

__all__ = ["BatchNorm2d", "DataAxis", "attach_data_axis",
           "cross_replica_mean", "data_axis_for", "initialize_distributed",
           "join_data_axis", "local_batch_size", "pad_to_batch_multiple"]
