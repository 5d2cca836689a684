"""Full pipeline (the ASOC_driver.py workload; port of
soc_tpu.pipeline.full).

Chains: solver-file generation (A2E_pre) for stochastic dusts ->
absorption run (nosolve, per-frequency tallies) -> multi-dust emission
(A2E_MABU, the A2E solve on the card; `CR_HEATING`'s rate in the last
channel; with `polarisation` the aligned grains' emission, <emitted>.P;
or the surrogates: the binned library, the NN of `nnmake` / `nnsolve`;
`absthin` solves every n-th cell) -> map run from the emitted file.
The modes `makelib` (a full solve, then the library built from it) and
`uselib` (only the reference frequencies simulated, the library
answering the emission) are the reference's ASOC_driver.py modes.
Under `devices N` the three stages share the absorption run's devices.
The reference's intermediate files are still written, so any stage can be
re-run or inspected. Under several processes (parallel/dist.py) every
process runs the three stages (the A2E solve of every cell on its own
devices) and process 0 alone writes the files (the solver and simple-dust
files before the others read them, emitted.data, the library and the
surrogates); the map run takes the emission from memory.
"""

import copy
import os
import time

import numpy as np

from ..config import RunConfig
from ..constants import PARSEC, um2f
from ..io.dust import read_simple_dust, write_simple_dust
from ..io.fields import write_cell_frequency_array
from ..parallel import dist
from ..solve import solver_prep
from ..solve.grain_model import gset_effective_optics, read_gset_dust
from ..solve.solver_file import read_solver, write_solver
from ..utils import trace

from . import driver, mabu


def dust_kind(path):
    """First non-comment header token of a dust file: 'eqdust' (simple) or
    'gsetdust' (stochastic GSET container)."""
    with open(path) as fp:
        for line in fp:
            tok = line.split("#")[0].strip()
            if tok:
                return tok.split()[0]
    raise ValueError("empty dust file: %s" % path)


def classify_dusts(cfg):
    """gset dusts (stochastic) vs simple eqdust files."""
    stochastic, simple = [], []
    for path in cfg.file_optical:
        kind = dust_kind(path)
        if kind == "gsetdust":
            stochastic.append(path)
        elif kind == "eqdust":
            simple.append(path)
        else:
            raise ValueError("unknown dust header %r in %s" % (kind, path))
    return stochastic, simple


def prepare_solver_files(cfg, ne=128, force=False):
    """A2E_pre stage: build <dust>.solver for every stochastic dust. An
    existing file is reused only if it matches the frequency grid and the
    enthalpy-bin count."""
    ne = cfg.ne_number or ne      # ini `nenumber` wins for every caller
    solvers = {}
    stoch, _ = classify_dusts(cfg)
    for path in stoch:
        out = os.path.splitext(path)[0] + ".solver"
        sol = None
        if not force and os.path.exists(out):
            sol = read_solver(out)
            stale = (sol.ne != ne or sol.nfreq != len(cfg.freq)
                     or not np.allclose(sol.freq, cfg.freq, rtol=1e-5))
            if stale:
                sol = None
        if sol is None:
            dust = read_gset_dust(path)
            sol = solver_prep.build_solver(dust, cfg.freq, ne=ne)
            write_solver(out, sol)
        solvers[path] = sol
    return solvers


def build_components(cfg, freq, ne=128):
    """DustComponent list (stochastic solvers + simple eqdusts)."""
    stoch, simple = classify_dusts(cfg)
    solvers = prepare_solver_files(cfg, ne=ne) if stoch else {}
    comps = []
    for path in stoch:
        sol = solvers[path]
        comps.append(mabu.DustComponent(
            name=os.path.splitext(os.path.basename(path))[0], kind="gset",
            kabs=sol.k_abs, solver=sol))
    for path in simple:
        opt = read_simple_dust(path, cfg.gl)
        comps.append(mabu.DustComponent(
            name=os.path.splitext(os.path.basename(path))[0], kind="eqdust",
            kabs=np.asarray(opt.abs_gl, np.float64) / (cfg.gl * PARSEC),
            freq=freq))
    return comps


def read_abundances(cfg, cells, ndust):
    """[CELLS, NDUST] abundances for the emission stage (soc_tpu's
    full.read_abundances: a file a dust, '#' keeps 1), or None without
    the `abundance` keyword."""
    if not cfg.file_abundance:
        return None
    abu = np.ones((cells, ndust), np.float32)
    for d, path in enumerate(cfg.file_abundance):
        if path and not path.startswith("#"):
            abu[:, d] = np.fromfile(path, np.float32, cells)
    return abu


def _rpol_factor(name, freq, aalg):
    """R(aalg[cell], freq): the share of the cross section in aligned
    grains a >= aalg, from the <name>.rpol table (A2E_MABU.py:615-637):
    log-frequency interpolation between its columns, then the size
    interpolation at each cell's aalg, zero outside the size grid."""
    tab = np.loadtxt("%s.rpol" % name)
    apol, fpol, rpol = tab[1:, 0], tab[0, 1:], tab[1:, 1:]
    lf = np.log(fpol)
    out = np.zeros((len(aalg), len(freq)), np.float32)
    for k, f in enumerate(np.asarray(freq, np.float64)):
        i = int(np.argmin(np.abs(fpol - f)))
        if fpol[i] > f:
            i = max(i - 1, 0)
        j = min(i + 1, len(fpol) - 1)
        wj = 0.0 if i == j else (np.log(f) - lf[i]) / (lf[j] - lf[i])
        col = (1.0 - wj) * rpol[:, i] + wj * rpol[:, j]
        out[:, k] = np.interp(aalg, apol, col, left=0.0, right=0.0)
    return out


def pol_specs(cfg, comps, freq, cells):
    """The `polarisation` keyword's specs a component (cfg.aalg: the dust
    file's base name without .dust -> its aalg file, one leading value
    then CELLS float32): ("aalg", aalg) for a stochastic dust,
    ("rfactor", R [CELLS, NFREQ]) for an equilibrium one; None without
    the keyword or a matching dust."""
    if not cfg.aalg:
        return None
    pol = {}
    for d, comp in enumerate(comps):
        f_aalg = cfg.aalg.get(comp.name)
        if f_aalg is None:
            continue
        aalg = np.fromfile(f_aalg, np.float32)[1:][:cells]
        if comp.kind == "gset":
            pol[d] = ("aalg", aalg)
        else:
            pol[d] = ("rfactor", _rpol_factor(comp.name, freq, aalg))
    return pol or None


def _simple_dust_substitutes(cfg):
    """The RT and map stages need simple-dust optics: swap every gset dust
    for its <name>_simple.dust ('gs_' prefix dropped), generating the file
    from the gset Q tables if it does not exist yet."""
    stoch_paths, _ = classify_dusts(cfg)
    if not stoch_paths:
        return list(cfg.file_optical)
    rt_optical = []
    for path in cfg.file_optical:
        if path not in stoch_paths:
            rt_optical.append(path)
            continue
        d, b = os.path.split(os.path.splitext(path)[0])
        if b.startswith("gs_"):
            b = b[3:]
        simp = os.path.join(d, b + "_simple.dust")
        if not os.path.exists(simp):
            gset = read_gset_dust(path)
            freq_rt = np.asarray(gset.qfreq)
            for p2 in cfg.file_optical:     # prefer an eqdust grid
                if p2 not in stoch_paths:
                    freq_rt = read_simple_dust(p2, cfg.gl).freq
                    break
            write_simple_dust(
                simp, gset_effective_optics(gset, freq_rt, cfg.gl), cfg.gl)
        rt_optical.append(simp)
    return rt_optical


def absorption_config(cfg):
    """Stage 1's configuration: the absorption run (nosolve, every
    frequency tallied, no map) with simple-dust optics in place of each
    gset dust, whose files it writes where they are missing (paths
    relative to the working directory)."""
    cfg_rt = copy.deepcopy(cfg)
    cfg_rt.nosolve = True
    cfg_rt.noabsorbed = False
    cfg_rt.nomap = True
    cfg_rt.file_optical = _simple_dust_substitutes(cfg)
    return cfg_rt


def _nearest_indices(freq, values_um):
    """Indices of the channels nearest the given wavelengths [um]."""
    return [int(np.argmin(np.abs(np.asarray(freq) - um2f(u))))
            for u in values_um]


def _nn_channels(cfg, nfreq, freq):
    """The surrogates' input and output channels: `nnabs` and `nnemit`,
    each every channel when the ini names none."""
    return tuple(_nearest_indices(freq, um) if um else list(range(nfreq))
                 for um in (cfg.nn_abs, cfg.nn_emit))


def emission_stage(cfg, comps, absorbed, abu, freq, device, dens=None,
                   devices=None, timings=None):
    """The A2E_MABU stage with the library and NN surrogate variants
    (soc_tpu's full.emission_stage; ASOC_driver.py:91-133 nnmake/nnsolve;
    A2E_MABU.py:1017-1068; A2E_LIB solve_with_library_2), on ``device``:

      nnsolve : per-dust surrogates <nnsolve>_<dust>.nn (nn_solve on the
                device) of each dust's share of the absorptions, summed
                with the abundances, filling only the `nnemit` columns
      library : an existing `library` file answers the emission by lookup
                (on the card with a CUDA device)
      else    : the multi-dust solve (mabu.solve_emission_multi: the A2E
                kernels on the card), and with `nnmake` a surrogate trained
                a dust on its (absorbed, emitted) pairs (every `nnthin`-th
                cell), saved as <nnmake>_<dust>.nn

    absorbed : [CELLS, NF_ABS] cleaned payload (parents zeroed); for
    nnsolve / library runs NF_ABS may be the reduced nnabs / FSELECT set.
    ``timings``, a dict if given, receives seconds under 'a2e_<dust>'
    (each dust's solve), 'nn_fit' (with the Adam steps, 'nn_fit_steps'),
    'nn_solve' and 'lookup'.
    Returns (EMITTED [CELLS, NFREQ], PEMITTED or None): PEMITTED is the
    polarised emission when `polarisation` names a dust (the surrogates
    give none).
    """
    from ..solve import library as libmod
    from ..solve import nn as nnmod
    timings = {} if timings is None else timings
    cells = absorbed.shape[0]
    nfreq = len(freq)

    if cfg.nn_solve:
        # each dust's surrogate takes that dust's share of the absorptions
        # (mabu.split_absorbed at the nnabs channels), the input nnmake
        # trained it on; soc_tpu feeds every dust the total, which equals
        # the share only for one dust without abundances
        t0 = time.time()
        emitted = np.zeros((cells, nfreq), np.float32)
        iabs, iemit = _nn_channels(cfg, nfreq, freq)
        x = absorbed[:, iabs] if absorbed.shape[1] == nfreq else absorbed
        if x.shape[1] != len(iabs):
            raise ValueError("nnsolve: absorbed has %d columns; nnabs names "
                             "%d" % (absorbed.shape[1], len(iabs)))
        a = np.ones((cells, len(comps)), np.float32) if abu is None else abu
        rabs = mabu.relative_cross_sections(comps, nfreq)[iabs]
        den = np.einsum("cd,fd->cf", a, rabs)
        for d, comp in enumerate(comps):
            model = nnmod.nn_load("%s_%s.nn" % (cfg.nn_solve, comp.name))
            y = nnmod.nn_solve(
                model, mabu.split_absorbed(x, rabs, a, d, den=den), device)
            emitted[:, iemit] += y * a[:, d][:, None]
        timings["nn_solve"] = time.time() - t0
        return emitted, None

    if cfg.file_library and os.path.exists(cfg.file_library):
        # the library's reference frequencies, or absorbed holds them only
        t0 = time.time()
        lib = libmod.load_library(cfg.file_library)
        nref = len(lib["ref_indices"])
        if absorbed.shape[1] == nfreq:
            absorbed = absorbed[:, lib["ref_indices"]]
        elif absorbed.shape[1] != nref:
            raise ValueError("library expects %d reference freqs, "
                             "absorbed has %d" % (nref, absorbed.shape[1]))
        lib_direct = dict(lib, ref_indices=list(range(absorbed.shape[1])))
        out = libmod.solve_with_library(lib_direct, absorbed, device=device)
        timings["lookup"] = time.time() - t0
        return out, None

    pol = pol_specs(cfg, comps, freq, cells)
    out = mabu.solve_emission_multi(
        comps, absorbed, device, abu=abu, devices=devices,
        cr_mode=int(cfg.cr_heating), dens=dens, pol=pol,
        return_components=True, timings=timings)
    emitted, per_dust = out[:2]
    pemitted = out[2] if pol else None

    if cfg.nn_make:
        t0 = time.time()
        iabs, iemit = _nn_channels(cfg, nfreq, freq)
        thin = max(1, cfg.nn_thin)
        steps = 0
        for comp, (absd, emit_d) in zip(comps, per_dust):
            stats = {}
            model = nnmod.nn_fit(absd[::thin][:, iabs],
                                 emit_d[::thin][:, iemit], device,
                                 hidden=cfg.nn_net, stats=stats)
            steps += stats["steps"]
            if dist.process_index() == 0:
                nnmod.nn_save("%s_%s.nn" % (cfg.nn_make, comp.name), model)
        timings["nn_fit"] = time.time() - t0
        timings["nn_fit_steps"] = steps
    return emitted, pemitted


MODES = (None, "makelib", "uselib")


def run_pipeline(ini_path, device, lanes=driver.DEFAULT_LANES, ne=128,
                 mode=None, devices=None, domains=None):
    """ASOC_driver equivalent: absorptions -> emission -> maps. Returns
    (RunResult of the absorption run, EMITTED [CELLS, NFREQ], RunResult of
    the map run); the emission stage's seconds are in the map run's
    timings under 'a2e' (its parts as emission_stage names them, and
    'library_build'). With `devices N` in the ini, or a ``devices``
    list, all three stages run over the same devices (see driver.run).
    With `domains N`, or a ``domains`` list, the absorption run's
    transport runs over Z-slabs (driver.run); the emission (one A2E
    launch on its assembled tallies) and the maps run on ``device``.
    With `polarisation` the polarised emission is written to
    <emitted>.P and returned as the map run's ``pemitted``.

    mode: None (the plain chain), 'makelib' (a full solve, then the binned
    emission library built from it and saved), or 'uselib' (the absorption
    run simulates only the FSELECT reference frequencies, by default those
    of library.choose_reference_frequencies, and the library answers the
    emission) -- ASOC_driver.py:11-21.
    """
    if mode not in MODES:
        raise ValueError("pipeline mode %r: expected makelib or uselib"
                         % (mode,))
    workdir = os.path.dirname(os.path.abspath(ini_path))
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        with trace.run("pipeline.run"):
            return _run_pipeline_inner(ini_path, device, lanes, ne, mode,
                                       devices, domains)
    finally:
        os.chdir(orig)


def _dust_frequencies(path, gl):
    """The frequency grid of a dust file (simple or GSET)."""
    if dust_kind(path) == "eqdust":
        return read_simple_dust(path, gl).freq
    return np.asarray(read_gset_dust(path).qfreq)


def _run_pipeline_inner(ini_path, device, lanes, ne, mode, devices,
                        domains):
    from ..solve import library as libmod
    cfg = RunConfig(ini_path).validate()
    driver.check_supported(cfg, devices, domains)
    ne = cfg.ne_number or ne
    default_lib = os.path.splitext(cfg.file_optical[0])[0] + ".lib"

    # Stage 1: absorption run (nosolve; all frequencies tallied, or under
    # uselib only the FSELECT ones); the simple-dust files it may write
    # are written by process 0 before the others look for them
    cfg_rt = dist.first(absorption_config, cfg)
    rt_optical = cfg_rt.file_optical
    if mode == "uselib":
        cfg_rt.lib_abs = True
        if not cfg_rt.fselect:
            freq0 = _dust_frequencies(cfg.file_optical[0], cfg.gl)
            idx = libmod.choose_reference_frequencies(freq0)
            cfg_rt.fselect = [float(freq0[i]) for i in idx]
            cfg.fselect = cfg_rt.fselect
    res_rt = driver.run(cfg=cfg_rt, device=device, lanes=lanes, workdir=".",
                        devices=devices, domains=domains)
    absorbed = res_rt.absorbed
    cells = res_rt.grid.cells
    freq = res_rt.freq
    cfg.freq = freq

    # Stage 2: A2E_pre + A2E_MABU emission (or the library / NN variants)
    stage = {}
    with trace.span("a2e.prep", into=stage, key="a2e_prep"):
        comps = dist.first(build_components, cfg, freq, ne=ne)
    # the absorbed payload marks parent cells -1e20: mask them
    with trace.span("a2e.host"):
        valid = absorbed[:, 0] > -1e19
        abs_clean = np.where(valid[:, None], absorbed,
                             0.0).astype(np.float32)
    lib_path = cfg.file_library or default_lib
    if mode == "uselib":
        if not os.path.exists(lib_path):
            raise FileNotFoundError("uselib: no library %s (run the "
                                    "makelib mode first)" % lib_path)
        cfg.file_library = lib_path
    if mode == "makelib":
        cfg.file_library = ""      # makelib must solve for real, not lookup
    # absthin: only every n-th cell is solved (ASOC.py absthin), the rest
    # stay zero
    thin = max(1, cfg.abs_thin)
    abu = read_abundances(cfg, cells, len(comps))
    with trace.span("a2e.stage", into=stage, key="a2e"):
        emitted_part, pemitted_part = emission_stage(
            cfg, comps, abs_clean[::thin],
            None if abu is None else abu[::thin], freq, device,
            dens=res_rt.grid.dens.cpu().numpy()[::thin],
            devices=res_rt.devices, timings=stage)

    def _expand(part):
        with trace.span("a2e.host"):
            if thin > 1:
                out = np.zeros((cells, len(freq)), np.float32)
                out[::thin] = part
            else:
                out = part
            out[~valid] = 0.0
        return out

    emitted = _expand(emitted_part)
    writer = dist.process_index() == 0
    if writer:
        write_cell_frequency_array(cfg.file_emitted, emitted)
    pemitted = None
    if pemitted_part is not None:
        # the aligned dusts' polarised emission (A2E_MABU.py:589, 651-656)
        pemitted = _expand(pemitted_part)
        if writer:
            write_cell_frequency_array(cfg.file_emitted + ".P", pemitted)

    if mode == "makelib":
        # the binned lookup library of this full solve, from the leaf
        # cells: soc_tpu bins the parents' zeroed rows too, and their
        # log10 floor (-33) stretches every axis over 36 dex
        t0 = time.time()
        ref_idx = [int(np.argmin(np.abs(freq - fv))) for fv in cfg.fselect] \
            if cfg.fselect else libmod.choose_reference_frequencies(freq)
        leaf = valid[::thin]
        lib = libmod.build_library(abs_clean[::thin][leaf],
                                   emitted_part[leaf], ref_idx)
        if writer:
            libmod.save_library(lib_path, lib)
        stage["library_build"] = time.time() - t0

    # Stage 3: map run from the emission (the emitted file's, from memory)
    cfg_map = copy.deepcopy(cfg)
    cfg_map.file_optical = rt_optical
    cfg_map.iterations = 0
    cfg_map.nosolve = True
    res_map = driver.run(cfg=cfg_map, device=device, lanes=lanes,
                         workdir=".", devices=devices, emitted=emitted)
    res_map.timings.update(stage)
    res_map.pemitted = pemitted
    return res_rt, emitted, res_map
