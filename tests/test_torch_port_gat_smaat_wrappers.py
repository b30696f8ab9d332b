"""The stacked GAT3D wrappers with the smaat_unet mapping against the JAX
package: eval- and train-mode forwards and the updated running
statistics, held as ``test_torch_port_gat_smaat.py`` holds the ``Model``
families. Their gradients are not compared here: a wrapper is the
``Model``'s smaat blocks stacked without the sigmoid, and
X
``test_torch_port_gat_family.py`` holds the stacking's, with the linear
and conv mappings."""

import pytest

from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import check_smaat_case


@pytest.mark.parametrize("model_type", [
    "temporal_1block", "temporal4h", "temporal2l", "spatial_1block",
    "multi_stream_2block"])
def test_smaat_wrapper_matches_jax(model_type):
    check_smaat_case(model_type)
