"""Full pipeline (the ASOC_driver.py workload; port of
soc_tpu.pipeline.full for the plain chain, mode=None).

Chains: solver-file generation (A2E_pre) for stochastic dusts ->
absorption run (nosolve, per-frequency tallies) -> multi-dust emission
(A2E_MABU, the A2E solve on the card; `CR_HEATING`'s rate in the last
channel; with `polarisation` the aligned grains' emission, <emitted>.P)
-> map run from the emitted file.
Under `devices N` the three stages share the absorption run's devices.
The reference's intermediate files are still written, so any stage can be
re-run or inspected.
"""

import copy
import os
import time

import numpy as np

from ..config import RunConfig
from ..constants import PARSEC
from ..io.dust import read_simple_dust, write_simple_dust
from ..io.fields import write_cell_frequency_array
from ..solve import solver_prep
from ..solve.grain_model import gset_effective_optics, read_gset_dust
from ..solve.solver_file import read_solver, write_solver

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


def run_pipeline(ini_path, device, lanes=driver.DEFAULT_LANES, ne=128,
                 mode=None, devices=None):
    """ASOC_driver equivalent: absorptions -> emission -> maps. Returns
    (RunResult of the absorption run, EMITTED [CELLS, NFREQ], RunResult of
    the map run); the emission stage's seconds are in the map run's
    timings under 'a2e'. With `devices N` in the ini, or a ``devices``
    list, all three stages run over the same devices (see driver.run).
    With `polarisation` the polarised emission is written to
    <emitted>.P and returned as the map run's ``pemitted``."""
    if mode is not None:
        raise NotImplementedError(
            "not supported by soc_tpu_torch yet: pipeline mode %r "
            "(makelib / uselib)" % mode)
    workdir = os.path.dirname(os.path.abspath(ini_path))
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        return _run_pipeline_inner(ini_path, device, lanes, ne, devices)
    finally:
        os.chdir(orig)


def _run_pipeline_inner(ini_path, device, lanes, ne, devices):
    cfg = RunConfig(ini_path).validate()
    driver.check_supported(cfg)
    ne = cfg.ne_number or ne

    # Stage 1: absorption run (nosolve; all frequencies tallied)
    cfg_rt = absorption_config(cfg)
    rt_optical = cfg_rt.file_optical
    res_rt = driver.run(cfg=cfg_rt, device=device, lanes=lanes, workdir=".",
                        devices=devices)
    absorbed = res_rt.absorbed
    freq = res_rt.freq
    cfg.freq = freq

    # Stage 2: A2E_pre + A2E_MABU emission
    t0 = time.time()
    comps = build_components(cfg, freq, ne=ne)
    t_prep = time.time() - t0
    # the absorbed payload marks parent cells -1e20: mask them
    valid = absorbed[:, 0] > -1e19
    abs_clean = np.where(valid[:, None], absorbed, 0.0).astype(np.float32)
    t0 = time.time()
    abu = read_abundances(cfg, absorbed.shape[0], len(comps))
    pol = pol_specs(cfg, comps, freq, absorbed.shape[0])
    out = mabu.solve_emission_multi(
        comps, abs_clean, device, abu=abu, devices=res_rt.devices,
        cr_mode=int(cfg.cr_heating), dens=res_rt.grid.dens.cpu().numpy(),
        pol=pol)
    emitted, pemitted = out if pol else (out, None)
    t_a2e = time.time() - t0
    emitted[~valid] = 0.0
    write_cell_frequency_array(cfg.file_emitted, emitted)
    if pemitted is not None:
        # the aligned dusts' polarised emission (A2E_MABU.py:589, 651-656)
        pemitted[~valid] = 0.0
        write_cell_frequency_array(cfg.file_emitted + ".P", pemitted)

    # Stage 3: map run from the emitted file
    cfg_map = copy.deepcopy(cfg)
    cfg_map.file_optical = rt_optical
    cfg_map.iterations = 0
    cfg_map.nosolve = True
    res_map = driver.run(cfg=cfg_map, device=device, lanes=lanes,
                         workdir=".", devices=res_rt.devices)
    res_map.timings["a2e_prep"] = t_prep
    res_map.timings["a2e"] = t_a2e
    res_map.pemitted = pemitted
    return res_rt, emitted, res_map
