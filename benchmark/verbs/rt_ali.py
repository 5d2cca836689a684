"""The `rt` verb with ALI's cell passes kept for the checks: driver.run,
as the CLI calls it, with the verb's own lane pool (the constant
sources, the iterations, the maps), while driver.simulate_cell_emission
is wrapped to keep each cell pass's inputs and outputs as they are (the
emission it was fed, the absorbed and self-absorbed tallies it returned:
references to the device's tensors, no copy and no wait)."""


def run(ini_path, device):
    """(the stages' RunResults, the products the checks judge, the grid)."""
    from soc_tpu_torch.pipeline import driver
    cells = []
    orig = driver.simulate_cell_emission

    def keep(grid, medium, cfg, emitted, *a, **kw):
        out = orig(grid, medium, cfg, emitted, *a, **kw)
        cells.append(dict(emit=emitted, tabs=out[0], xab=out[3]))
        return out
    driver.simulate_cell_emission = keep
    try:
        res = driver.run(ini_path, device=device, lanes=driver.DEFAULT_LANES)
    finally:
        driver.simulate_cell_emission = orig
    ps = [p for p in res.source_passes if p["source"] == "ps"]
    products = dict(ps_tabs=ps[0]["tabs"] if ps else None, cell=cells,
                    temperature=res.temperature, emitted=res.emitted,
                    maps=[res.maps.get(0), res.maps.get(1)])
    return [res], products, res.grid
