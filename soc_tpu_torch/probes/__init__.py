"""Gather/scatter probes of the H100: the port's counterparts of
scripts/probe_gather.py, scripts/probe_gather2.py and
scripts/gather_probe.py, with their Pallas kernels as four hand-written
CUDA kernels (``kernels``) beside plain PyTorch versions.

They measure what a march kernel of the transport is bounded by: random
gathers from a density table of the pipeline's 64^3 grid, and scatter-adds
into a tally of the same size. Each runs on the card only:

    python -m soc_tpu_torch.probes.probe_gather
    python -m soc_tpu_torch.probes.probe_gather2
    python -m soc_tpu_torch.probes.gather_probe [plain] [take]
"""
