"""`devices 4` with the constant sources against soc_tpu's `devices 4`
run (tests/test_torch_product_features_jax.py says how and at which
tolerances): point sources (PS_METHOD 4 for the external one) with two
dusts' per-cell abundances (MSF), `simum` and STEP_WEIGHT 2; the weighted
Healpix sky with the ROI save, mirrored low faces, DIR_WEIGHT and
`mmapabs`."""

import pytest

from test_torch_product_features_jax import check_group


@pytest.mark.parametrize("group", ["point sources abundance",
                                   "sky roi mirror mmapabs"])
def test_devices_4_sources_match_soc_tpu(tmp_path, group):
    rt, _ = check_group(tmp_path, group)
    assert all(st["route"] == "mesh" for st in rt.source_passes)
