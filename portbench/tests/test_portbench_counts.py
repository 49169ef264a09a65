"""The frozen counts against hand values."""

import pytest

from portbench.counts import flops, gbt, kernels, peaks
from portbench.reference.gbt import lhs_params
from portbench.tests.small import spec as held_spec

H100 = "NVIDIA H100 80GB HBM3"


def test_training_flops_a_beat():
    spec = held_spec()
    assert flops.train_per_beat(spec.cell("lstm_ae.train").config) == 452_976_000
    assert flops.train_per_beat(spec.cell("conv_ae.train").config) == 2_466_816
    assert flops.fwd_per_beat(spec.cell("lstm_ae.train").config) == 150_992_000


@pytest.mark.parametrize("B, ms", [(64, 0.0722), (128, 0.1445), (256, 0.2889)])
def test_k3_bound(B, ms):
    assert peaks.least_seconds(*kernels.k3_encoder(B), H100) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_k1_k2_bounds_as_phases_3_and_5():
    # phase 5's sweep shape, by bytes: 96 fits x 12,000 rows, half 16
    nbytes, ops = kernels.k1_hist(96, 12000, 10, 64, 16, matched=0)
    assert peaks.least_seconds(nbytes, ops, H100) * 1e3 == pytest.approx(0.006510, abs=2e-6)
    # phase 3's fit level: 96 fits x 12,500 rows x 32 nodes
    assert peaks.least_seconds(*kernels.k2_route(96, 12500, 10, 32, 1, True), H100) * 1e3 == pytest.approx(
        0.003023, abs=2e-6)


def test_grid_search_work():
    params = lhs_params(48, 1)
    assert gbt.grid_search_trees(params, 3) == 39_600
    assert sum(p["max_depth"] <= 6 for p in params) == 27
    one = gbt.candidate_fold_ops(8000, 12000, 10, 64, 1, 1, 1.0)
    assert one == 2 * 10 * 8000 + 12 * 10 * 64 + 3 * 12000
