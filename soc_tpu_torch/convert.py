"""Carry soc_tpu's model state across to the port.

The port reads the same files as soc_tpu, so its "weights" are the state
soc_tpu builds from them: the Grid arrays, the Medium tables, the
temperature table and the per-size A2E stacks. The functions here take
that state as NumPy arrays (callers apply ``np.asarray`` to JAX arrays, so
the port never sees a JAX type) and return the port's dataclasses on a
given device, so that both packages can compute on identical inputs:

  grid_from_numpy(nx, ny, nz, dens, lcells, off, par, device)   -> Grid
  medium_from_numpy(abs_gl, sca_gl, csc, dsc, tw, device)       -> Medium
  temperature_table_from_numpy(ttt, emin, ke, ne, device)       -> TemperatureTable
  stacks_from_numpy(w_flat, w_fold, tdown, ea, device, w_unf=None)
                                                                -> A2EStacks
      (soc_tpu's prepare_size_arrays / prepare_size_arrays_fused outputs
      stacked on a size axis; w_flat may be None for kernel-only stacks,
      w_fold None for clamp-kernel stacks, which carry w_unf instead: the
      dense prepare_size_arrays weights [S, NE*NE, NFREQ] again, which
      a2e_kernel.unfold_cols lays out column by column, [S, NE, NE, NFP])
  mlp_from_flax_params(params, hidden, n_out, device)           -> EmissionMLP
  flax_params_from_mlp(mlp)                                      -> params
      (the NN surrogate's weights: soc_tpu's flax layout {"params":
      {"Dense_i": {"kernel": [in, out], "bias"}}} as NumPy arrays, the
      format of its pickled .nn files)
"""

import numpy as np
import torch

from .grid import grid_from_numpy
from .solve.a2e_kernel import stacks_from_numpy
from .solve.equilibrium import TemperatureTable
from .transport.medium import medium_from_numpy

__all__ = ["grid_from_numpy", "medium_from_numpy",
           "temperature_table_from_numpy", "stacks_from_numpy",
           "mlp_from_flax_params", "flax_params_from_mlp"]


def temperature_table_from_numpy(ttt, emin, ke, ne, device):
    """TemperatureTable from soc_tpu TemperatureTable fields."""
    return TemperatureTable(
        ttt=torch.tensor(np.asarray(ttt, np.float32), device=device),
        emin=float(emin), ke=float(ke), ne=int(ne))


def mlp_from_flax_params(params, hidden, n_out, device):
    """EmissionMLP on ``device`` from soc_tpu's flax-layout weights
    ({"params": {"Dense_i": {"kernel": [in, out], "bias": [out]}}}, NumPy
    or anything np.asarray takes): Linear i's weight is kernel i
    transposed."""
    from .solve.nn import EmissionMLP
    dense = params["params"]
    kernels = [np.asarray(dense["Dense_%d" % i]["kernel"], np.float32)
               for i in range(len(hidden) + 1)]
    mlp = EmissionMLP(kernels[0].shape[0], hidden, n_out)
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            layer.weight.copy_(torch.tensor(kernels[i].T))
            layer.bias.copy_(torch.tensor(np.asarray(
                dense["Dense_%d" % i]["bias"], np.float32)))
    return mlp.to(device)


def flax_params_from_mlp(mlp):
    """The inverse of mlp_from_flax_params: soc_tpu's flax-layout weights
    as NumPy float32 arrays."""
    return {"params": {
        "Dense_%d" % i: {
            "kernel": np.ascontiguousarray(
                layer.weight.detach().cpu().numpy().T),
            "bias": layer.bias.detach().cpu().numpy().copy()}
        for i, layer in enumerate(mlp.layers)}}
