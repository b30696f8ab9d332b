"""Hand-written CUDA kernels (``csrc/``), their nvcc build and wrappers."""

from . import dsconv, gat_attention, gat_mapping


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel has been launched in this process."""
    return {"gat_attention_fwd": gat_attention.launch_count,
            "gat_attention_bwd": gat_attention.bwd_launch_count,
            "dsconv_fwd": dsconv.launch_count,
            "dsconv_bwd": dsconv.bwd_launch_count,
            "gat_mapping_fwd": gat_mapping.fwd_launch_count,
            "gat_mapping_bwd": gat_mapping.bwd_launch_count}
