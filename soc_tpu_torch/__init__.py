"""soc_tpu_torch: the PyTorch and CUDA port of soc_tpu.

Monte-Carlo dust radiative transfer (packet transport through a cell grid,
equilibrium and stochastically heated dust emission, orthographic,
all-sky, perspective and per-level maps) on an NVIDIA GPU. The package mirrors soc_tpu's layout module for module; the
JAX package stays the reference the port is tested against. This package
imports neither jax nor soc_tpu (it keeps its own copies of soc_tpu's
NumPy host modules: constants, config, io.dust, io.fields, io.fits and
the A2E preparation under solve/): it reads the same ini files and writes the
same reference-format outputs.

Every function takes its device explicitly; nothing here picks one.
"""

__version__ = "0.1.0"
