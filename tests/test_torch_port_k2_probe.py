"""The K2 probe's variants of the kernel source (``python -m
extended_gan_torch.ops.k2_probe``), made without nvcc or a card.

The probe times ``csrc/gat_mapping.cu`` on the GPU by building copies of it
with clock reads after each barrier of a job loop and with one phase's loop
run 0 times. It finds the lines to edit by their text: these tests hold
every such anchor against the committed source, so a kernel edit that
breaks one fails here and not only on the card.
"""

import re

import pytest

from extended_gan_torch.ops import build, k2_probe

SRC = (build.CSRC / "gat_mapping.cu").read_text()
ANCHORS = k2_probe.anchors()


@pytest.mark.parametrize("name", sorted(ANCHORS))
def test_anchor_occurs_once_in_the_kernel_source(name):
    assert SRC.count(ANCHORS[name]) == 1, name


@pytest.mark.parametrize("variant,phases", [
    ("phases", k2_probe.PHASES), ("bwd_phases", k2_probe.BWD_PHASES)])
def test_clocked_variant_has_one_stamp_a_phase(variant, phases):
    text = k2_probe.variant_sources(SRC)[variant]
    stamps = sorted(int(i) for i in re.findall(r"ph\[(\d+)\] \+=", text))
    assert stamps == list(range(len(phases)))


@pytest.mark.parametrize("mode,loops", [
    ("fwd", k2_probe._LAYER_LOOPS), ("bwd", k2_probe._BWD_LOOPS)])
def test_each_loop_variant_changes_one_line(mode, loops):
    sources = k2_probe.variant_sources(SRC, mode)
    prefix = "no_" if mode == "fwd" else "bwd_no_"
    full = SRC.splitlines()
    for loop in loops:
        lines = sources[prefix + loop.replace(" ", "")].splitlines()
        assert len(lines) == len(full)
        assert sum(a != b for a, b in zip(lines, full)) == 1, loop


def test_modes_build_their_own_variants():
    fwd = set(k2_probe.variant_sources(SRC, "fwd"))
    bwd = set(k2_probe.variant_sources(SRC, "bwd"))
    assert fwd & bwd == {"full"}
    assert set(k2_probe.variant_sources(SRC)) == fwd | bwd
    assert all(name.startswith("bwd_") for name in bwd - {"full"})


@pytest.mark.parametrize("need_dx", [False, True])
def test_backward_fmas_a_phase(need_dx):
    fmas = k2_probe.bwd_fmas(need_dx=need_dx)
    assert len(fmas) == len(k2_probe.BWD_PHASES)
    # the tile's 100 pixels: 5 products of 9 Cin F (dW1, dW3 and da2 on
    # the tile; dx with dx), 2 of F F (dW2, da1 on the tile); the recompute
    # of h1 and h2 and, for dx, da2 and da1 on the 12x12 neighbourhood
    f, c = 74, 4
    tile = 100 * (9 * c * f * (3 + need_dx) + 2 * f * f)
    q = 144 * (9 * c * f + f * f)
    if need_dx:
        q += 144 * (9 * c * f + f * f) - 100 * (9 * c * f + f * f)
    assert sum(fmas) == tile + q
