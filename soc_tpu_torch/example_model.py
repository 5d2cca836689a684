"""Synthetic input models for examples, tests and the GPU smoke run.

Writes a complete model directory from a few parameters: a uniform
density cloud or an octree-refined one (BASELINE config 2's grid), a
dust built from DustEM-format files through the NumPy dust compiler
(solve/dust_compiler.py), its scattering function, an isotropic
background and an ini file; optionally point sources, a Healpix sky, a
diffuse emission field and a second dust with per-cell abundances (each
sized as a share of the background's power, so every source matters),
and the `split`, `simum`, `saveint` and `optishalf` lines; a magnetic
field (Bx.bin, By.bin, Bz.bin for `polmap`) and the `polarisation`
inputs (a per-cell aligned grain size, and for an equilibrium dust its
.rpol table); or, for the ROI coupling's second stage, the sub-model of
a box of root cells. Two dust kinds:

* ``"gset"``: a stochastically heated dust (GSET container), run through
  the ``pipeline`` verb (absorption run -> A2E -> map);
* ``"eqdust"``: the same grains as one equilibrium (simple) dust, run
  through the ``rt`` verb.

The dust follows the power-law grain model of a DustEM GRAIN.DAT line with
a Debye-like heat capacity; the background is a diluted 7500 K black body.
"""

import os

import numpy as np

from .constants import FACTOR, PARSEC, PLANCK, planck_intensity, um2f
from .io.dust import write_simple_dust
from .solve import dust_compiler as dc
from .solve import solver_prep
from .solve.grain_model import write_gset_dust

from .grid import encode_link_np
from .io.cloud import write_hierarchy
from .render import healpix as hp

GRAIN_LINE = "TST {nsize} plaw-ed 0.0065 3.3 1.0e-7 5.0e-5 -3.5 1.0e-5 5e-6 3.0"
# the second dust of `abundance` models: small grains only
GRAIN_LINE2 = "TST {nsize} plaw-ed 0.004 3.3 1.0e-7 1.0e-6 -3.0 1.0e-5 5e-6 3.0"

INI = """\
gridlength      {gl}
cloud           tmp.cloud
mapping         {npix} {npix} {map_dx}
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         {dust}
dsc             tmp.dsc 2500
background      bg.bin
bgpackets       {bgpac}
iterations      {iterations}
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
temperature     tmp.T
{extra}"""


def _dustem_files(d, um):
    """Synthetic DustEM inputs (LAMBDA, Q, G, C files) in directory d."""
    nlam = len(um)
    lam = os.path.join(d, "LAMBDA.DAT")
    with open(lam, "w") as fp:
        fp.write("# lambda\n#\n#\n#\n"
                 + "\n".join("%.6e" % u for u in um) + "\n")
    qsize_um = np.asarray([1e-3, 1e-2, 0.1, 1.0])
    # geometric-optics-flavoured Qabs: Q = x/(1+x) with x = 2 pi a/lambda
    qabs = np.zeros((nlam, 4))
    for j, su in enumerate(qsize_um):
        x = 2 * np.pi * su / um
        qabs[:, j] = x / (1.0 + x)
    qsca = 0.5 * qabs
    qtxt = ["# synthetic Q", "#", "4",
            " ".join("%.4e" % s for s in qsize_um), "# Qabs then Qsca"]
    qtxt += [" ".join("%.6e" % v for v in row) for row in qabs]
    qtxt += [" ".join("%.6e" % v for v in row) for row in qsca]
    qf = os.path.join(d, "Q_TST.DAT")
    with open(qf, "w") as fp:
        fp.write("\n".join(qtxt) + "\n")
    gtxt = ["#"] * 9 + [" ".join("%.4f" % v for v in row)
                        for row in np.full((nlam, 4), 0.4)]
    gf = os.path.join(d, "G_TST.DAT")
    with open(gf, "w") as fp:
        fp.write("\n".join(gtxt) + "\n")
    # heat capacities: Debye-like C ~ T^3 per cm3
    ct = np.logspace(0, 3.3, 40)
    lgc = np.log10(1e4 * ct**3)
    ctxt = ["# synthetic C", "4", " ".join("%.4e" % s for s in qsize_um),
            "40"]
    ctxt += ["%.6e " % np.log10(t) + " ".join("%.6e" % lgc[i]
                                              for _ in range(4))
             for i, t in enumerate(ct)]
    cf = os.path.join(d, "C_TST.DAT")
    with open(cf, "w") as fp:
        fp.write("\n".join(ctxt) + "\n")
    return lam, qf, gf, cf


def frequencies(nfreq):
    """The models' frequency grid [Hz]: nfreq log-spaced over 0.1-3000 um,
    ascending in frequency."""
    return np.sort(um2f(np.logspace(np.log10(0.1), np.log10(3000.0), nfreq)))


def background(freq):
    """Isotropic background intensity: a diluted 7500 K black body."""
    return 1.0e-14 * planck_intensity(freq, 7500.0)


def _compiled_dust(d, nfreq, nsize, line=GRAIN_LINE):
    um = np.logspace(np.log10(0.1), np.log10(3000.0), nfreq)
    lam, qf, gf, cf = _dustem_files(d, um)
    return dc.compile_dust(line.format(nsize=nsize), lam, qf, gf, cf)


def gset_solver(d, nfreq=44, nsize=24, ne=128):
    """(A2E solver data, frequencies) of the models' GSET dust; the DustEM
    files are written into directory d."""
    freq = frequencies(nfreq)
    gset = dc.to_gset(_compiled_dust(d, nfreq, nsize))
    return solver_prep.build_solver(gset, freq, ne=ne), freq


def synthetic_absorbed(rng, solver, freq, cells):
    """[cells, NFREQ] absorbed photons per H like a background-heated
    cloud's: the optically thin rate FACTOR 4 pi I/(h nu) k_abs of the
    models' background, times a per-cell factor 10^U(-2, 1) and a per-cell
    reddening exp(-U(0, 3) (nu/nu_max)^0.5)."""
    base = FACTOR * 4 * np.pi * background(freq) / (PLANCK * freq) \
        * solver.k_abs
    scale = 10.0 ** rng.uniform(-2.0, 1.0, cells)
    tau = rng.uniform(0.0, 3.0, cells)[:, None] \
        * np.sqrt(freq / freq.max())[None, :]
    return (base[None, :] * scale[:, None] * np.exp(-tau)).astype(np.float32)


def negate_one_weight(solver, isize=0):
    """Flip the sign of one heating weight of size ``isize`` (the middle
    entry of its sparse stream), the kind of input that needs the A2E
    clamp path. Call before any A2E preparation: the per-size arrays are
    cached on the solver."""
    iw = solver.sizes[isize].iw
    k = len(iw) // 2
    iw[k] = -abs(iw[k]) if iw[k] != 0 else -1.0
    return solver


def with_negative_entries(rng, absorbed, share=0.2):
    """A copy of ``absorbed`` with a share of its entries times -0.3, as a
    reference-subtracted (delta) field has them."""
    out = np.array(absorbed, np.float32)
    out[rng.random(out.shape) < share] *= -0.3
    return out


def seeded_a2e_stacks(seed, ne, nfreq, device, clamp=False, negate=False):
    """(A2EStacks of one size, absorbed [512, NFREQ] float32 host array)
    from a seed, for shapes where build_solver's host cost (NE^2 NFREQ,
    about 70 s at NE 1856) is too slow. The heating weights are positive
    and, like a grain's, fall off with the jump u - l > 0 (zero for
    u <= l): W[u, l, f] = h_f p_l exp(-((u - l - c_f) / w)^2) with the
    photon's jump c_f = 1 + (NE / 8) f / NFREQ, w = 1 + NE / 32, so no
    entry of the fold's S[j] - S[NE-1] cancels beyond float32's reach. The
    cooling rates are the mean cell's heating out of each level times
    10^U(-0.3, 0.3), so the populations stay within a few decades; the
    emission EA is U(0.5, 1.5). Built on ``device`` in float64: the fold
    W'[j] = sum_{u>=j} W[u] as soc_tpu's host fold, then cast. The stacks
    carry w_flat (the plain twin's) and w_fold, or with ``clamp`` w_unf;
    ``negate`` flips the sign of one weight (the clamp path's input)."""
    import torch
    from .solve import a2e_kernel
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    h = torch.as_tensor(10.0 ** rng.uniform(-1.0, 1.0, nfreq), device=dev)
    p = torch.as_tensor(rng.uniform(0.5, 1.5, ne), device=dev)
    c = 1.0 + (ne / 8.0) * torch.arange(nfreq, device=dev,
                                        dtype=torch.float64) / nfreq
    d = (torch.arange(ne, device=dev, dtype=torch.float64)[:, None]
         - torch.arange(ne, device=dev, dtype=torch.float64)[None, :])
    w = torch.exp(-((d[..., None] - c) / (1.0 + ne / 32.0)) ** 2) \
        * (d > 0)[..., None] * p[None, :, None] * h         # [u, l, f]
    if negate:
        w[ne // 2, ne // 4, nfreq // 2] *= -1.0
    absorbed = (10.0 ** rng.uniform(-1.0, 1.0, (512, 1))
                * rng.uniform(0.5, 1.5, (512, nfreq))).astype(np.float32)
    # cooling: the mean cell's fold, row by row (l < j)
    a = torch.einsum("ulf,f->ul", w, torch.as_tensor(
        absorbed.mean(0), dtype=torch.float64, device=dev))
    s = torch.flip(torch.cumsum(torch.flip(a, [0]), 0), [0])
    b = s - a[ne - 1:ne]
    b[ne - 1] = a[ne - 1]
    tdown = (torch.tril(b, -1).sum(1) * torch.as_tensor(
        10.0 ** rng.uniform(-0.3, 0.3, ne), device=dev)).clamp_min(1e-30)
    nfp = a2e_kernel.padded_nfreq(nfreq)

    def pad(x):
        return torch.nn.functional.pad(x, (0, nfp - nfreq)).float()[None] \
            .contiguous()
    fold = None if clamp else pad(
        torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0]))
    unf = pad(w.transpose(0, 1)) if clamp else None
    stacks = a2e_kernel.A2EStacks(
        w_flat=w.reshape(ne * ne, nfreq).float()[None].contiguous(),
        w_fold=fold, tdown=tdown.float()[None].contiguous(),
        ea=torch.as_tensor(rng.uniform(0.5, 1.5, (1, nfreq, ne)),
                           dtype=torch.float32, device=dev),
        ne=ne, w_unf=unf)
    return stacks, absorbed


def octree_cloud(n, block, cascade, depth=3):
    """(lcells, per-level values) of BASELINE config 2's grid, rebuilt
    from bench.py's recipe: an n^3 root of densities U(0.5, 1.5) whose
    central block^3 cells are refined; on each deeper level 8 children a
    parent with densities 2^level U(0.5, 1.5), of which ``cascade`` evenly
    spaced cells are refined again, down to ``depth`` levels. bench.py's
    grid (n 64, block 8, cascade 64, depth 3: 262,144 + 4,096 + 512 =
    266,752 cells) has these densities times 1000; the ini's `density`
    scales them."""
    rng = np.random.default_rng(3)
    root = rng.uniform(0.5, 1.5, n ** 3).astype(np.float32)
    lo = (n - block) // 2
    r = np.arange(lo, lo + block)
    ii = (r[None, None, :] + n * r[None, :, None]
          + n * n * r[:, None, None]).ravel()
    root[ii] = encode_link_np(np.arange(0, 8 * len(ii), 8, dtype=np.int32))
    values, lcells = [root], [n ** 3]
    m = len(ii)
    for lvl in range(1, depth):
        vals = (2.0 ** lvl * rng.uniform(0.5, 1.5, 8 * m)).astype(np.float32)
        m_next = 0
        if lvl < depth - 1:
            step = 8 * m // cascade
            sub = np.arange(cascade) * step + min(5, step - 1)
            vals[sub] = encode_link_np(np.arange(0, 8 * cascade, 8,
                                                 dtype=np.int32))
            m_next = cascade
        values.append(vals)
        lcells.append(8 * m)
        m = m_next
    return lcells, values


def _write_dust(d, kind, dust, freq, gl_pc, stem, dsc_name):
    """The dust file of kind 'gset' (gs_<STEM>.dust) or 'eqdust'
    (<stem>.dust) and its scattering file; returns the dust file's
    name."""
    dsc, csc = dc.tabulated_scattering_function(dust, freq, bins=2500)
    dc.write_scattering_file(os.path.join(d, dsc_name), dsc, csc)
    if kind == "gset":
        name = "gs_%s.dust" % stem.upper()
        write_gset_dust(os.path.join(d, name), dc.to_gset(dust))
    elif kind == "eqdust":
        name = "%s.dust" % stem
        write_simple_dust(os.path.join(d, name),
                          dc.effective_optics(dust, freq, gl_pc), gl_pc)
    else:
        raise ValueError("kind must be 'gset' or 'eqdust'")
    return name


def _cell_levels(lcells):
    return np.repeat(np.arange(len(lcells)), lcells)


def write_point_sources(d, freq, gl_pc, area, sources, method=None,
                        packets=None):
    """Point-source luminosity files ps_<k>.bin and their ini lines.
    sources: (x, y, z, share) in root-cell coordinates; each radiates the
    background's spectrum at ``share`` of the power the background sends
    into the cloud (pi I_bg over the model's surface of ``area`` cells)."""
    lum = np.pi * background(freq) * area * (gl_pc * PARSEC) ** 2
    lines = []
    for k, (x, y, z, share) in enumerate(sources):
        name = "ps_%d.bin" % k
        (share * lum).astype(np.float32).tofile(os.path.join(d, name))
        lines.append("pointsource     %r %r %r %s\n" % (float(x), float(y),
                                                        float(z), name))
    if packets is not None:
        lines.append("pspackets       %d\n" % packets)
    if method is not None:
        lines.append("psmethod        %d\n" % method)
    return "".join(lines)


def write_sky(d, freq, nside, weighted=False, path="sky.bin"):
    """A Healpix sky [NFREQ, 12 nside^2] (RING order): the background's
    spectrum times exp(2 cos theta) / its mean over the sky, so half the
    sky is several times brighter than the other; returns its ini line,
    `hpbg` or, for weighted pixel selection, `hpbgw` (which names the
    file too: the keywords match by prefix)."""
    theta, _ = hp.pix2ang_ring_np(nside, np.arange(12 * nside * nside))
    pattern = np.exp(2.0 * np.cos(theta.astype(np.float64)))
    pattern /= pattern.mean()
    sky = background(freq)[:, None] * pattern[None, :]
    sky.astype(np.float32).tofile(os.path.join(d, path))
    return "%-15s %s\n" % ("hpbgw" if weighted else "hpbg", path)


def write_diffuse(d, freq, gl_pc, area, lcells, share=0.5, nf=None,
                  packets=None, path="diffuse.bin"):
    """A diffuse emission field [CELLS, NF'] (photons/Hz/cm^3 a cell, the
    highest NF' channels when nf < NFREQ): cells times U(0.5, 1.5), the
    whole field giving ``share`` of the background's photons a channel
    after the driver's 8^-level weighting; returns its ini lines."""
    rng = np.random.default_rng(7)
    cells = int(np.sum(lcells))
    nf = len(freq) if nf is None else nf
    bg = np.pi * area * background(freq) / (PLANCK * freq)
    vol = np.sum(8.0 ** -_cell_levels(lcells))
    per = share * bg / (vol * gl_pc * PARSEC)
    field = rng.uniform(0.5, 1.5, cells)[:, None] * per[None, -nf:]
    with open(os.path.join(d, path), "wb") as fp:
        np.asarray([cells, nf], np.int32).tofile(fp)
        field.astype(np.float32).tofile(fp)
    return "diffuse         %s\n" % path + (
        "diffpackets     %d\n" % packets if packets is not None else "")


def write_emitted(d, freq, gl_pc, area, lcells, values, kdensity=3.0e4,
                  share=0.5, path="emitted.data"):
    """An emitted file [CELLS, NFREQ] for the `sca` verb's cell source:
    cells times U(0.5, 1.5), the leaves emitting ``share`` of the
    background's photons a channel after the scattering run's weighting
    EMITTED 1e-20 GL PARSEC / 8^level DENS (DENS the cloud's values
    times ``kdensity``, the ini's `density`); parents emit nothing."""
    from .io.fields import write_cell_frequency_array
    rng = np.random.default_rng(11)
    dens = np.concatenate(values).astype(np.float64) * kdensity
    weight = np.where(dens > 0, dens * 8.0 ** -_cell_levels(lcells), 0.0)
    bg = np.pi * area * background(freq) / (PLANCK * freq)
    per = share * bg / (1.0e-20 * gl_pc * PARSEC * weight.sum())
    emitted = rng.uniform(0.5, 1.5, len(dens))[:, None] * per[None, :]
    emitted[dens <= 0] = 0.0
    write_cell_frequency_array(os.path.join(d, path),
                               emitted.astype(np.float32))
    return path


def write_roi_load(d, freq, dims, area, nside=2, share=0.5,
                   path="roi.photons"):
    """A ROI photon file for `roiload` on a model of ``dims`` root cells
    (the whole model's surface as the ROI's): every (surface element,
    Healpix direction) pair U(0.5, 1.5), a channel summing to ``share`` of
    the background's photons; returns its ini line (the packets are the
    caller's `roipackets`)."""
    from .transport.roi import roi_nelem, write_roi_file
    rng = np.random.default_rng(13)
    nelem = roi_nelem(*dims)
    npix = 12 * nside * nside
    data = rng.uniform(0.5, 1.5, (len(freq), nelem * npix))
    bg = np.pi * area * background(freq) / (PLANCK * freq)
    data *= (share * bg / data.sum(1))[:, None]
    write_roi_file(os.path.join(d, path), *dims, nside,
                   data.astype(np.float32))
    return "roiload         %s 1.0\n" % path


def write_sca_model(d, n, nfreq=8, emitted=None, roiload=None, intobs=None,
                    outnside=None, ffs=None, fits=False, background=True,
                    extra="", **kw):
    """Write a scattered-light (`sca` verb) model and return its ini path:
    write_model's equilibrium-dust model (its `bgpackets`, point sources
    and `pspackets`, `hpbg` sky, `cellpackets`, `diffuse` field,
    `abundance` second dust with its dsc file (WITH_MSF), `simum` band)
    and the scattered-light lines: ``emitted`` the share of the cell
    source (write_emitted; `cellpackets` then gives its packets),
    ``roiload`` (share, packets) of a ROI load over the model's surface
    (write_roi_load), ``intobs`` the internal observer (`perspective x y
    z`, with `outnside` outnside), `ffs`, `fits 1`; ``background`` False
    leaves out the isotropic background (for the sky alone)."""
    lines = []
    if intobs is not None:
        lines.append("perspective     %r %r %r\n" % tuple(map(float, intobs)))
    if outnside is not None:
        lines.append("outnside        %d\n" % outnside)
    if ffs is not None:
        lines.append("ffs             %d\n" % ffs)
    if fits:
        lines.append("fits            1\n")
    freq = frequencies(nfreq)
    os.makedirs(d, exist_ok=True)
    if roiload is not None:
        lines.append(write_roi_load(d, freq, (n, n, n), 6 * n * n,
                                    share=roiload[0]))
        lines.append("roipackets      %d\n" % roiload[1])
    ini = write_model(d, n, kind="eqdust", nfreq=nfreq,
                      extra="".join(lines) + extra, **kw)
    if emitted is not None:
        lcells, values = ([n ** 3], [np.ones(n ** 3, np.float32)]) \
            if kw.get("octree") is None else octree_cloud(n, *kw["octree"])
        write_emitted(d, freq, kw.get("gl_pc", 0.01), 6 * n * n, lcells,
                      values, share=emitted)
    if not background:
        with open(ini) as fp:
            text = fp.read()
        with open(ini, "w") as fp:
            fp.write("".join(line for line in text.splitlines(True)
                             if not line.startswith("background")))
    return ini


B_MEAN = (0.3, 0.5, 0.2)     # the tangled field's mean part


def write_bfield(d, dims, lcells, field, seed=9, prefix="B"):
    """<prefix>x.bin, <prefix>y.bin, <prefix>z.bin hierarchy files over
    the model's cells (the octree's too); returns their names, for a
    `polmap` line. field: a 3-vector (a uniform field), or "tangled":
    B_MEAN plus a Gaussian tangled part of 0.6 its size a component, from
    ``seed``. Every vector is scaled to |B| <= 1, so `polred` reads |B|
    as a fraction."""
    cells = int(np.sum(lcells))
    if isinstance(field, str):
        if field != "tangled":
            raise ValueError("field: a 3-vector or 'tangled'")
        rng = np.random.default_rng(seed)
        mean = np.asarray(B_MEAN)
        b = mean + rng.normal(0.0, 0.6 * np.linalg.norm(mean), (cells, 3))
    else:
        b = np.broadcast_to(np.asarray(field, np.float64), (cells, 3))
    b = b / np.maximum(1.0, np.linalg.norm(b, axis=1))[:, None]
    bounds = np.cumsum([0] + list(lcells))
    names = tuple(prefix + axis + ".bin" for axis in "xyz")
    for k, name in enumerate(names):
        col = b[:, k].astype(np.float32)
        write_hierarchy(os.path.join(d, name), *dims, lcells,
                        [col[bounds[i]:bounds[i + 1]]
                         for i in range(len(lcells))])
    return names


def write_aalg(d, sizes, cells, seed=13, path="aalg.bin"):
    """The `polarisation` keyword's aligned-grain-size file: one leading
    value (the cell count) and CELLS float32 sizes [cm], log-uniform from
    a third of the smallest grain size to three times the largest (about
    an eighth of the cells below the size grid, an eighth above).
    Returns its name."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log(sizes[0] / 3.0), np.log(3.0 * sizes[-1])
    aalg = np.exp(rng.uniform(lo, hi, cells))
    np.concatenate([[cells], aalg]).astype(np.float32).tofile(
        os.path.join(d, path))
    return path


def write_model(d, n, kind="gset", nfreq=44, nsize=24, npix=None,
                bgpac=None, map_dx=1.0, gl_pc=0.01, extra="", octree=None,
                cellpackets=None, iterations=1, point_sources=None,
                ps_method=None, pspackets=None, hpbg=None,
                hpbg_weighted=False, diffuse=None, dfpackets=None,
                abundance=False, split=None, simum=None, saveint=None,
                optishalf=False, roi_box=None, bfield=None,
                polarisation=False):
    """Write a model into directory d and return the ini path.

    n      : root grid size (n^3 cells)
    kind   : "gset" (stochastic dust, for `pipeline`) or "eqdust" (`rt`)
    nfreq  : frequencies, log-spaced over 0.1-3000 um
    nsize  : grain sizes of the GSET dust
    npix   : map size (default n); bgpac: ini `bgpackets` (default
             8*6*n*n, one packet batch per surface element)
    octree : None for a uniform density of 1, else (block, cascade,
             depth) of octree_cloud (BASELINE config 2: n 64, (8, 64, 3))
    cellpackets, iterations : the ini's `cellpackets` (written when
             given) and `iterations`
    point_sources : (x, y, z, share) tuples (write_point_sources), with
             `psmethod` ps_method and `pspackets` pspackets when given
    hpbg   : a Healpix sky of this nside (write_sky), `hpbgw` with
             hpbg_weighted
    diffuse : the share of a diffuse field (write_diffuse), with
             `diffpackets` dfpackets when given
    abundance : a second dust (small grains) with its own scattering
             file (so MSF is on) and per-cell abundance files of both
             dusts, U(0.5, 1.5) and U(0, 2)
    split, saveint : the `split N` and `saveint N` lines; simum: the
             (um_lo, um_hi) band of `simum`; optishalf: its line
    roi_box : (x0, x1, y0, y1, z0, z1) inclusive root cells: the cloud
             written is the box's root cells of the n^3 cloud (octree
             or not), cell for cell as a regular grid at the same
             `gridlength` (the box must hold no refined cell): the
             sub-model of the ROI coupling (`roiload`)
    bfield : a magnetic field over the cells (write_bfield: a 3-vector or
             "tangled"), in Bx.bin, By.bin, Bz.bin; extra's `polmap
             Bx.bin By.bin Bz.bin` line draws the maps
    polarisation : the `polarisation <dust> aalg.bin` line with its file
             (write_aalg, over the dust's size grid); an equilibrium
             dust also gets its .rpol table (tst.rpol)
    bgpac  : 0 writes `bgpackets 0` (no background run)
    extra  : more ini lines
    """
    os.makedirs(d, exist_ok=True)
    freq = frequencies(nfreq)
    dust = _compiled_dust(d, nfreq, nsize)
    dust_name = _write_dust(d, kind, dust, freq, gl_pc, "tst", "tmp.dsc")
    background(freq).astype(np.float32).tofile(os.path.join(d, "bg.bin"))
    if octree is None:
        lcells, values = [n ** 3], [np.ones(n ** 3, np.float32)]
    else:
        lcells, values = octree_cloud(n, *octree)
    dims = (n, n, n)
    if roi_box is not None:
        x0, x1, y0, y1, z0, z1 = roi_box
        box = values[0].reshape(n, n, n)[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1]
        if (box <= 0.0).any():
            raise ValueError("roi_box holds refined root cells")
        dims = box.shape[::-1]
        lcells, values = [box.size], [np.ascontiguousarray(box).ravel()]
    write_hierarchy(os.path.join(d, "tmp.cloud"), *dims, lcells, values)
    cells = int(np.sum(lcells))
    area = 6 * n * n
    lines = []
    if cellpackets is not None:
        lines.append("cellpackets     %d\n" % cellpackets)
    if point_sources:
        lines.append(write_point_sources(d, freq, gl_pc, area,
                                         point_sources, ps_method,
                                         pspackets))
    if hpbg:
        lines.append(write_sky(d, freq, hpbg, hpbg_weighted))
    if diffuse:
        lines.append(write_diffuse(d, freq, gl_pc, area, lcells, diffuse,
                                   packets=dfpackets))
    if abundance:
        dust2 = _compiled_dust(d, nfreq, nsize, GRAIN_LINE2)
        name2 = _write_dust(d, kind, dust2, freq, gl_pc, "tst2", "tst2.dsc")
        rng = np.random.default_rng(5)
        for k, (lo, hi) in enumerate(((0.5, 1.5), (0.0, 2.0))):
            rng.uniform(lo, hi, cells).astype(np.float32).tofile(
                os.path.join(d, "abu%d.bin" % k))
        lines.append("optical         %s\ndsc             tst2.dsc 2500\n"
                     "abundance       abu0.bin\nabundance       abu1.bin\n"
                     % name2)
    if split is not None:
        lines.append("split           %d\n" % split)
    if simum is not None:
        lines.append("simum           %r %r\n" % tuple(map(float, simum)))
    if saveint is not None:
        lines.append("saveint         %d\n" % saveint)
    if optishalf:
        lines.append("optishalf\n")
    if bfield is not None:
        write_bfield(d, dims, lcells, bfield)
    if polarisation:
        if kind == "eqdust":
            dc.write_polarized_dust_aux(dust, freq,
                                        prefix=os.path.join(d, "tst"))
        lines.append("polarisation    %s %s\n"
                     % (dust_name, write_aalg(d, dust.size_a, cells)))
    ini = os.path.join(d, "run.ini")
    with open(ini, "w") as fp:
        fp.write(INI.format(gl=gl_pc, npix=npix or n, map_dx=map_dx,
                            dust=dust_name,
                            bgpac=8 * 6 * n * n if bgpac is None else bgpac,
                            iterations=iterations,
                            extra="".join(lines) + extra))
    return ini
