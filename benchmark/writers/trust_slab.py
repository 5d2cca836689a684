"""Model writer of the externally lit slab (TRUST I, Gordon et al. 2017,
A&A 603, A114): a uniform slab of dust, one star above its lit face, an
octree refined towards that face.

The model ("model" of the configuration), lengths in pc:
  size_pc [X, Y, Z] the slab; slab_z_pc its [bottom, top] in the
  source's frame, whose x = y = 0 is the slab's axis; gridlength the root
  cell; refine_pc[l] the depth under the lit face (the top, +z) within
  which a cell of level l is refined, one entry a level below the root;
  star_pc the star's (x, y, z), outside the slab; star_teff (K) and
  star_lsun (solar luminosities) its black body; tau_1um the slab's
  extinction optical depth at 1 um along z, which sets the density;
  nfreq, um_range, nsize, dsc_bins the channels and the dust as
  grid_model's; pspackets, psmethod, cellpackets, remit_um, mapping and
  directions the ini's, whose `mapcentre` map_centre() gives. The ini
  asks for the temperatures and the maps, and `noabsorbed`: no
  absorbed.data (nor the per-channel tally it is read from).

The dust is grid_model's synthetic DustEM-format grain model as one
equilibrium population (tmp.dust), its scattering file tmp.dsc; the
star's spectrum star.bin (float32 L_nu, erg/s/Hz, a channel). The
hierarchy file holds 1 in every leaf and, in a refined cell, the negated
bit pattern of its first child's index on the next level (the children of
a parent in the order x + 2 y + 4 z of their octant). The model is the
same for every seed: the seed draws the packets.
"""

import os

import numpy as np

from ..frozen import dust_compiler as dc
from ..frozen.constants import STEFAN_BOLTZMANN, planck_intensity, um2f
from ..frozen.dust_io import write_simple_dust
from .grid_model import GRAIN_LINE, _dustem_files, frequencies, \
    write_hierarchy

L_SUN = 3.828e33            # erg/s (IAU 2015 nominal)


def root_dims(model):
    """(nx, ny, nz) root cells of the slab."""
    gl = float(model["gridlength"])
    return tuple(int(round(float(s) / gl)) for s in model["size_pc"])


def octree(model):
    """(lcells, values) of the hierarchy: per level the cell count and the
    float32 values (1 in a leaf, the link in a refined cell)."""
    nx, ny, nz = root_dims(model)
    gl = float(model["gridlength"])
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    # level 0 in the file's order: x fastest, then y, then z
    lo = np.stack([ix, iy, iz], -1).transpose(2, 1, 0, 3).reshape(-1, 3)
    lo = lo.astype(np.float64)
    h = 1.0
    lcells, values = [], []
    for lvl, depth_pc in enumerate(list(model["refine_pc"]) + [None]):
        vals = np.ones(len(lo), np.float32)
        if depth_pc is None:
            lcells.append(len(lo))
            values.append(vals)
            break
        refine = lo[:, 2] >= nz - float(depth_pc) / gl - 1e-9
        parents = np.nonzero(refine)[0]
        vals[parents] = -np.arange(0, 8 * len(parents), 8,
                                   dtype=np.int32).view(np.float32)
        lcells.append(len(lo))
        values.append(vals)
        if not len(parents):
            break
        h *= 0.5
        sid = np.arange(8)
        bits = np.stack([sid % 2, (sid // 2) % 2, sid // 4], -1)
        lo = (lo[parents][:, None, :] + h * bits[None, :, :]).reshape(-1, 3)
    return lcells, values


def star_position(model):
    """The star in root-cell coordinates of the grid."""
    gl = float(model["gridlength"])
    sx, sy, _ = (float(v) for v in model["size_pc"])
    x, y, z = (float(v) for v in model["star_pc"])
    return ((x + 0.5 * sx) / gl, (y + 0.5 * sy) / gl,
            (z - float(model["slab_z_pc"][0])) / gl)


def map_centre(model):
    """The maps' centre: the model's, moved along y by half the finest
    cell, so that a pixel's ray (at phi = 0 its y is constant) runs along
    no cell face, between two of them."""
    nx, ny, nz = root_dims(model)
    half = 0.5 ** (len(model["refine_pc"]) + 1)
    return 0.5 * nx, 0.5 * ny + half, 0.5 * nz


def star_spectrum(freq, teff, lsun):
    """L_nu (erg/s/Hz) of a black body of temperature teff and luminosity
    lsun: L pi B_nu(T) / (sigma T^4)."""
    return (lsun * L_SUN * np.pi * planck_intensity(freq, teff)
            / (STEFAN_BOLTZMANN * teff ** 4))


def grain_dust(d, model):
    """The compiled synthetic grain model, its DustEM files in d."""
    nfreq = int(model["nfreq"])
    um_lo, um_hi = model["um_range"]
    um = np.logspace(np.log10(um_lo), np.log10(um_hi), nfreq)
    return dc.compile_dust(GRAIN_LINE.format(nsize=int(model["nsize"])),
                           *_dustem_files(d, um))


def extinction_1um(dust, gl):
    """The dust's extinction at 1 um, optical depth per unit density per
    root cell."""
    opt = dc.effective_optics(dust, np.asarray([um2f(1.0)]), gl)
    return float(opt.abs_gl[0] + opt.sca_gl[0])


def write(d, model, dust_kind, seed):
    """Write the slab into directory d (an equilibrium dust: ``dust_kind``
    "eqdust"); returns the model's ini lines as (keyword, value) pairs,
    without `seed`."""
    if dust_kind != "eqdust":
        raise ValueError("the slab takes an equilibrium dust ('eqdust')")
    os.makedirs(d, exist_ok=True)
    nfreq = int(model["nfreq"])
    um_lo, um_hi = model["um_range"]
    gl = float(model["gridlength"])
    freq = frequencies(nfreq, um_lo, um_hi)
    dust = grain_dust(d, model)
    bins = int(model["dsc_bins"])
    dsc, csc = dc.tabulated_scattering_function(dust, freq, bins=bins)
    dc.write_scattering_file(os.path.join(d, "tmp.dsc"), dsc, csc)
    write_simple_dust(os.path.join(d, "tmp.dust"),
                      dc.effective_optics(dust, freq, gl), gl)
    nx, ny, nz = root_dims(model)
    density = float(model["tau_1um"]) / (extinction_1um(dust, gl) * nz)
    lcells, values = octree(model)
    write_hierarchy(os.path.join(d, "tmp.cloud"), nx, ny, nz, lcells,
                    values)
    star_spectrum(freq, float(model["star_teff"]),
                  float(model["star_lsun"])).astype(np.float32).tofile(
        os.path.join(d, "star.bin"))
    x, y, z = star_position(model)
    return [("gridlength", gl), ("cloud", "tmp.cloud"),
            ("density", repr(density)), ("optical", "tmp.dust"),
            ("dsc", ["tmp.dsc", bins]),
            ("pointsource", [repr(x), repr(y), repr(z), "star.bin"]),
            ("psmethod", int(model["psmethod"])),
            ("pspackets", int(model["pspackets"])),
            ("cellpackets", int(model["cellpackets"])), ("ali", 1),
            ("noabsorbed", None),
            ("remit", list(model["remit_um"])),
            ("mapping", model["mapping"]),
            ("mapcentre", [repr(v) for v in map_centre(model)]),
            ("directions", model["directions"]), ("prefix", "tmp"),
            ("temperature", "tmp.T")]
