"""Precision policy (port of ``extended_gan_tpu/core/precision.py``).

- ``f32``: everything float32 (the default, and the reference's numerics);
- ``bf16``: activations and the products of the convolutions and dense
  layers run in bfloat16; parameters, optimizer moments, BatchNorm and the
  metrics stay float32.

As in the JAX package the policy is a module ``dtype``: a model built with
``dtype=torch.bfloat16`` casts its inputs and weights to bfloat16 at the
layers the JAX modules cast, and back to float32 where they cast back (the
GAT attention, the sigmoid heads, BatchNorm). The kernels stay float32
inside: their wrappers cast at their boundary.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "f32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name == "bf16" else torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_out(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32)


def resolve_dtype(name: str) -> torch.dtype:
    """"f32" -> torch.float32, "bf16" -> torch.bfloat16."""
    try:
        return {"f32": torch.float32, "bf16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; choose 'f32' or "
                         "'bf16'") from None


F32 = Precision("f32")
BF16 = Precision("bf16")


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a module's compute ``dtype``: cast under bf16; under the
    float32 policy every tensor stays as it is (a float64 twin of a model
    stays float64)."""
    return x if dtype == torch.float32 else x.to(dtype)


def to_float32(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 result back in float32, where the JAX modules cast back;
    any other dtype as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x
