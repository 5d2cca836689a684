"""The `pipeline` verb: full.run_pipeline, as the CLI calls it, with the
verb's own lane pool: the absorption run, A2E and the map run."""


def run(ini_path, device):
    """(the stages' RunResults, the products the checks judge, the grid)."""
    from soc_tpu_torch.pipeline import driver, full
    res, emitted, res_map = full.run_pipeline(ini_path, device=device,
                                              lanes=driver.DEFAULT_LANES)
    products = dict(absorbed=res.absorbed, emitted=emitted,
                    map=res_map.maps.get(0))
    return [res, res_map], products, res.grid
