"""Hand-written CUDA kernels (``csrc/``), their nvcc build and wrappers."""

from . import dsconv, gat_attention


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel has been launched in this process."""
    return {"gat_attention_fwd": gat_attention.launch_count,
            "dsconv_fwd": dsconv.launch_count}
