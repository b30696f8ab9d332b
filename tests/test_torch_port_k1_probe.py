"""The K1 probe's variants of the kernel source (``python -m
extended_gan_torch.ops.k1_probe --variants``), made without nvcc or a card.

The probe weighs a phase of the cluster kernels on the GPU by building a
copy of ``csrc/gat_attention.cu`` with that phase left out (or one
setting changed). It finds the
lines to edit by their text: these tests hold every anchor against the
committed source, so a kernel edit that breaks one fails here and not only
on the card.
"""

import pytest

from extended_gan_torch.ops import build, k1_probe

SRC = (build.CSRC / "gat_attention.cu").read_text()


@pytest.mark.parametrize("name", sorted(k1_probe.VARIANTS))
def test_each_anchor_occurs_once_in_the_kernel_source(name):
    for anchor, _ in k1_probe.VARIANTS[name]:
        assert SRC.count(anchor) == 1, anchor


@pytest.mark.parametrize("name", sorted(k1_probe.VARIANTS))
def test_each_variant_edits_only_its_anchors(name):
    text = k1_probe.variant_sources(SRC)[name]
    full, lines = SRC.splitlines(), text.splitlines()
    assert len(lines) == len(full)
    edited = sum(a != b for a, b in zip(lines, full))
    anchored = sum(sum(p != q for p, q in zip(old.splitlines(),
                                              new.splitlines()))
                   for old, new in k1_probe.VARIANTS[name])
    assert 1 <= edited == anchored


def test_a_stale_anchor_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        k1_probe.variant_sources(SRC.replace("cluster_sum(", "sum_cluster("))
