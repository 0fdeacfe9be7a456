"""The input generators repeat for a seed and give the stated shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench_small import small_cell


@pytest.mark.parametrize("cell,role,n", [
    ("upstream-uniform.knn-k16", "points", 12000),
    ("upstream-uniform.render-1024", "particles", 1500),
])
def test_generator_repeats_and_fills_the_box(cell, role, n):
    c = small_cell(cell)
    seed = 2 ** 31 + 12345
    a = c.generator.make(c.config, role, seed, torch.device("cpu"))
    b = c.generator.make(c.config, role, seed, torch.device("cpu"))
    other = c.generator.make(c.config, role, seed + 1, torch.device("cpu"))
    assert a.shape == (n, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert float(a.min()) >= 0.0 and float(a.max()) < c.config["box"]


def test_render_inputs_follow_the_recipe():
    c = small_cell("upstream-uniform.render-1024")
    step = c.step(11, "cpu")
    (pos, w, r), corners = step.sets[0]
    rpx = r * step.ppu
    assert pos.shape == (1500, 3) and (w == 1).all()
    assert rpx.min() >= 0.1 - 1e-6
    spacing = step.grid / 1500 ** (1 / 3)
    assert 0.8 < float(torch.from_numpy(rpx).log().median().exp()) / spacing < 1.25
    assert len(corners) == 38 + step.grid // step.T
    assert all(0 <= v <= step.grid - step.T for c3 in corners for v in c3)


def test_knn_sets_are_the_same_for_every_seed():
    """The seed reorders the k-NN sets: the queries among themselves, the
    other points among themselves, so every seed gives the same work."""
    c = small_cell("upstream-uniform.knn-k16")
    nq = c.traffic["queries"]
    a, b = c.step(2 ** 31 + 1, "cpu"), c.step(2 ** 33 + 7, "cpu")

    def rows(t):
        return t[torch.from_numpy(np.lexsort(t.numpy().T))]

    for s in range(2):
        pa, pb = a.sets[s], b.sets[s]
        assert not torch.equal(pa, pb)
        assert torch.equal(rows(pa[:nq]), rows(pb[:nq]))
        assert torch.equal(rows(pa[nq:]), rows(pb[nq:]))
    assert not torch.equal(rows(a.sets[0]), rows(a.sets[1]))
