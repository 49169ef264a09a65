"""Inputs are determined by the seed: the same seed the same inputs."""

import numpy as np
import torch

from portbench import data

CPU = torch.device("cpu")
BIG = 2**31 + 977


def test_beats_follow_the_seed():
    a = data.beats(64, data.generator(CPU, BIG, 1), CPU)
    b = data.beats(64, data.generator(CPU, BIG, 1), CPU)
    c = data.beats(64, data.generator(CPU, BIG + 1, 1), CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (64, 320) and torch.isfinite(a).all()


def test_weights_follow_the_seed():
    shapes = data.lstm_ae_shapes()
    t1, t2 = (data.uniform_tree(shapes, data.generator(CPU, BIG, 2), CPU) for _ in range(2))
    assert all(torch.equal(t1[k][n], t2[k][n]) for k in t1 for n in t1[k])
    assert float(t1["enc1"]["w_hh"].abs().max()) <= 1 / 128**0.5
    t3 = data.uniform_tree(shapes, data.generator(CPU, BIG + 1, 2), CPU)
    assert not torch.equal(t1["enc1"]["w_hh"], t3["enc1"]["w_hh"])


def test_cohorts_follow_the_seed():
    a, b = (data.cohorts(100, 10, 0.3, 4, data.generator(CPU, BIG, 3), CPU) for _ in range(2))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[1][:, :4].mean() > a[0][:, :4].mean()


def test_case_ids_cover_every_case():
    ids = data.case_ids(235_600, 6_388)
    assert len(np.unique(ids)) == 6_388 and np.all(np.diff(ids) >= 0)
