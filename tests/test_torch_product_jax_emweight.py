"""`devices 4` with EMWEI and SUBITERATIONS against soc_tpu's `devices 4`
run (tests/test_torch_product_features_jax.py says how and at which
tolerances)."""

from test_torch_product_features_jax import check_group


def test_devices_4_emweight_subiterations_match_soc_tpu(tmp_path):
    rt, _ = check_group(tmp_path, "emweight subiterations")
    assert {p["route"] for p in rt.cell_passes} == {"emweight"}
