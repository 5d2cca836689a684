"""The `rt` verb: driver.run, as the CLI calls it, with the verb's own
lane pool: the transport, the equilibrium solve and the map."""


def run(ini_path, device):
    """(the stages' RunResults, the products the checks judge, the grid)."""
    from soc_tpu_torch.pipeline import driver
    res = driver.run(ini_path, device=device, lanes=driver.DEFAULT_LANES)
    products = dict(absorbed=res.absorbed, emitted=res.emitted,
                    temperature=res.temperature, map=res.maps.get(0))
    return [res], products, res.grid
