"""The control: the reference put in the program's place in the precision
below the configuration's fails the check, on the card, at reduced sizes
a test run holds (``portbench.calibrate`` reads it at each cell's own
size).  TF32 exists only on the card, so these are marked ``cuda``."""

import pytest

from portbench.run import Bench
from portbench.tests.small import small_cell
from portbench.trace import Tracer


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lstm_ae.train", "conv_ae.train", "lstm_ae.gbt_search"])
def test_control_fails(name, cuda_device, tmp_path):
    cell = small_cell(name)
    if cell.driver == "train":
        cell.config.update(batch_size=128)
    limits = cell.traffic["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        bench = Bench(cell=cell, seed=seed, seconds=1.0, trace=False, device=cuda_device,
                      tracer=Tracer(False, cuda_device, str(tmp_path)), scratch=str(tmp_path))
        readings = cell.driver_module().control_readings(bench)["control"]
        assert any(readings[k] > limit for k, limit in limits.items()), readings
