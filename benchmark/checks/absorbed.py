"""The absorbed tally (the transport, from the isotropic background)
against the reference's Monte Carlo: the photons absorbed in each channel
over the whole model, and in each onion shell of root cells at one
distance from the surface, both relative to the reference's channel
total."""

import numpy as np
import torch

from ..reference.inputs import background_injected, raw_tally
from ..reference.transport import background_tally
from .common import model, stream_seed

NUMBERS = ("absorbed.totals", "absorbed.shells")


def reference(ctx, packets_per_freq, **kw):
    cloud, optics, tree = model(ctx)
    area = 2 * (cloud.nx * cloud.ny + cloud.nx * cloud.nz
                + cloud.ny * cloud.nz)
    injected = background_injected(ctx["workdir"], ctx["ini"], optics.freq,
                                   area)
    return background_tally(tree, optics, injected, packets_per_freq,
                            stream_seed(ctx, 1), ctx["device"], **kw)


def compare(ctx, prog_raw, ref_raw):
    cloud = model(ctx)[0]
    tot_p, tot_r = prog_raw.sum(0), ref_raw.sum(0)
    depth = cloud.depth()
    nd = int(depth.max()) + 1
    sh_p = np.zeros((nd, prog_raw.shape[1]))
    sh_r = np.zeros_like(sh_p)
    np.add.at(sh_p, depth, prog_raw)
    np.add.at(sh_r, depth, ref_raw)
    return {"absorbed.totals": float(np.max(np.abs(tot_p - tot_r) / tot_r)),
            "absorbed.shells": float(np.max(np.abs(sh_p - sh_r)
                                            / tot_r[None, :]))}


def control(ctx):
    """The reference's Monte Carlo at the program's packet count, with
    bfloat16 weights and tallies."""
    low = reference(ctx, int(ctx["program_packets"]), wdtype=torch.bfloat16,
                    tdtype=torch.bfloat16)
    return compare(ctx, low, ctx["reference_raw"])


def run(ctx):
    cloud = model(ctx)[0]
    prog = raw_tally(cloud, ctx["products"]["absorbed"],
                     float(ctx["ini"]["gridlength"]))
    ref = reference(ctx, int(ctx["cfile"]["reference_packets_per_freq"]))
    return compare(ctx, prog, ref)
