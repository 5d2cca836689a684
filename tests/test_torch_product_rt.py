"""`devices 4` (dp 2 x freq 2) and `devices 6` (dp 3 x freq 2): the port's
rt run over CPU shards against its one-device run and against soc_tpu's
`devices N` run; the checks and tolerances of
tests/test_torch_product_runs.py."""

import sys

import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_product_runs import check_devices_rt  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [4, 6])
def test_devices_rt_matches(tmp_path, monkeypatch, n):
    check_devices_rt(tmp_path, monkeypatch, n)
