"""Hand-written CUDA kernels (``csrc/``), their nvcc build and wrappers."""

from . import dsconv, gat_attention, gat_mapping

# each kernel's launch counter: (its wrapper module, the counter's name)
_COUNTERS = {
    "gat_attention_fwd": (gat_attention, "launch_count"),
    "gat_attention_bwd": (gat_attention, "bwd_launch_count"),
    "dsconv_fwd": (dsconv, "launch_count"),
    "dsconv_bwd": (dsconv, "bwd_launch_count"),
    "gat_mapping_fwd": (gat_mapping, "fwd_launch_count"),
    "gat_mapping_bwd": (gat_mapping, "bwd_launch_count"),
}


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel has been launched in this process."""
    return {name: getattr(module, attr)
            for name, (module, attr) in _COUNTERS.items()}


def add_launches(counts: dict[str, int], times: int = 1):
    """Adds ``times`` x ``counts`` to the kernels' launch counters.

    A wrapper counts when its Python code runs, but inside a CUDA graph's
    capture that code only records the launch, and a replay launches the
    recorded kernels without running it. So the graph's runner
    (``train/megastep.py``) takes back what the capture counted
    (``times=-1``) and adds it again at every replay."""
    for name, n in counts.items():
        module, attr = _COUNTERS[name]
        setattr(module, attr, getattr(module, attr) + n * times)
