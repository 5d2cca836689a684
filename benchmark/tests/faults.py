"""Faults planted under the timed path, for the tests that see `correct`
come out false: each plant(name) patches the program in this process and
returns the function that takes the patch out again."""

import os
import sys
import types

import numpy as np
import torch


def _patch(module, attr, make):
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    return lambda: setattr(module, attr, orig)


def unchanged():
    """A transport pass that returns the tallies as they were."""
    from soc_tpu_torch.pipeline import driver

    def make(orig):
        def f(grid, medium, kind, phase, params, counts, sel, tabs, intf,
              *a, **kw):
            keep_t = tabs.clone()
            keep_i = intf.clone() if torch.is_tensor(intf) else None
            _, intf2, stats = orig(grid, medium, kind, phase, params, counts,
                                   sel, tabs, intf, *a, **kw)
            if keep_i is not None:
                intf2.copy_(keep_i)
            return keep_t, intf2, stats
        return f
    return _patch(driver, "_source_pass", make)


def half():
    """Half of each channel's packets left out of a pass."""
    from soc_tpu_torch.pipeline import driver

    def make(orig):
        def f(grid, medium, kind, phase, params, counts, sel, *a, **kw):
            counts = np.asarray(counts, np.int64) // 2
            return orig(grid, medium, kind, phase, params, counts, sel, *a,
                        **kw)
        return f
    return _patch(driver, "_source_pass", make)


def altered_a2e():
    """Every cell's A2E emission altered by 1% where it is produced."""
    from soc_tpu_torch.solve import stochastic
    return _patch(stochastic, "solve_emission",
                  lambda orig: lambda *a, **kw: orig(*a, **kw) * 1.01)


def altered_temperature():
    """Every cell's temperature altered by 1% where it is solved."""
    from soc_tpu_torch.solve import equilibrium
    return _patch(equilibrium, "solve_temperature",
                  lambda orig: lambda *a, **kw: orig(*a, **kw) * 1.01)


def altered_map():
    """The map altered by 1% where it is rendered."""
    from soc_tpu_torch.render import mapping

    def make(orig):
        def f(*a, **kw):
            phot, tau, colden = orig(*a, **kw)
            return phot * 1.01, tau, colden
        return f
    return _patch(mapping, "render_ortho", make)


def exchange():
    """The exchange between processes left out: another rank's slabs and
    blocks never arrive (zeros in their place)."""
    from soc_tpu_torch.parallel import dist, product
    undo = []

    def make_move(orig):
        def f(self, t, i, dst):
            if not self.multi:
                return t
            me = dist.process_index()
            if me != dst:
                return None
            return t if self.owners[i] == me else torch.zeros(
                tuple(t.shape), dtype=t.dtype)
        return f

    def make_bcast(orig):
        def f(t, src, shape, dtype):
            return t if dist.process_index() == src else torch.zeros(
                tuple(shape), dtype=dtype)
        return f
    undo.append(_patch(product.ProductMesh, "_move", make_move))
    undo.append(_patch(dist, "broadcast", make_bcast))
    return lambda: [u() for u in reversed(undo)]


def forbidden_on_rank1():
    """The JAX package's name in rank 1's sys.modules (a stand-in module,
    left there once the window has closed)."""
    if os.environ.get("SOC_TPU_PROCESS_ID") != "1":
        return lambda: None
    sys.modules["soc_tpu"] = types.ModuleType("soc_tpu")
    return lambda: sys.modules.pop("soc_tpu", None)


def plant(name):
    if name == "none":
        return lambda: None
    return globals()[name]()
