"""Command-line entry points of the port, mirroring soc_tpu's (and the
reference executables').

  python -m soc_tpu_torch rt soc.ini    ~  ASOC.py soc.ini
  python -m soc_tpu_torch sca soc.ini   ~  ASOCS.py soc.ini
  python -m soc_tpu_torch pipeline soc.ini [makelib|uselib]
                                        ~  ASOC_driver.py soc.ini [mode]
  python -m soc_tpu_torch a2e_pre gs.dust freq.dat out.solver [NE]
                                        ~  A2E_pre.py ...
  python -m soc_tpu_torch a2e solver absorbed emitted [GPU [nstoch [IFREQ
                                        [aalg]]]]
                                        ~  A2E.py ... (GPU accepted and
                                           ignored)
  python -m soc_tpu_torch eqsolve dust absorbed emitted [GPU]
                                        ~  EQ_solver.py ...
  python -m soc_tpu_torch a2e_lib solver lib freq.dat lfreq.dat abs emit
                    [makelib] [GPU] [ofreq] [bins-a-b-c]
                                        ~  A2E_LIB.py ...
  python -m soc_tpu_torch mabu soc.ini absorbed emitted [ofreq]
                                        ~  A2E_MABU.py ...
  python -m soc_tpu_torch dust GRAIN.DAT freq.dat [NE [GL]]
                                        ~  DE_to_GSET.jl (DustEM compiler)
  python -m soc_tpu_torch sampleini [file]
                                        ~  WriteSampleIni (ASOC_aux.py:1670)
  python -m soc_tpu_torch bench        ~  python -m soc_tpu bench (bench.py):
                                           one JSON line of the port's
                                           metrics (soc_tpu_torch/bench.py;
                                           its knobs SOC_BENCH_*)

Options, anywhere on the line:
  --device D    a torch device name for the verbs that compute on tensors
                (rt, sca, pipeline, a2e, a2e_lib, mabu, bench); default
                'cuda',
                '--device cpu' runs on the CPU. Without a CUDA device a
                'cuda' run exits 2.
  --lanes N     the packet pool of rt, sca and pipeline
  --profile[=DIR]  the whole command under torch.profiler (CPU activity,
                and CUDA with a CUDA device), its Chrome trace written to
                DIR/trace_<verb>.json (default DIR: soc_profile; under
                several processes DIR/trace_<verb>.rank<k>.json)
                and the program's spans and counters to
                DIR/spans_<verb>[.rank<k>].json

The ini keyword `devices N` runs the product path (for `sca`, each
source's packets split) over N devices (cuda:0 .. cuda:N-1, or the CPU N
times with '--device cpu'); `domains N` (rt and pipeline) runs the
transport over N Z-slabs of the grid on the same devices. `sca` writes
outcoming.socs (or, with `fits 1`, <scattering>.fits).

Several processes, as soc_tpu runs under jax.distributed: start the same
command once a process with soc_tpu's variables SOC_TPU_COORDINATOR
(host:port of process 0's rendezvous), SOC_TPU_NUM_PROCESSES and
SOC_TPU_PROCESS_ID (or SOC_TPU_DISTRIBUTED=auto under torchrun), e.g.

  SOC_TPU_COORDINATOR=127.0.0.1:29511 SOC_TPU_NUM_PROCESSES=2 \
  SOC_TPU_PROCESS_ID=k python -m soc_tpu_torch rt run.ini   (k = 0, 1)

A process's devices are its visible cards (CUDA_VISIBLE_DEVICES; several
processes may share one), or with '--device cpu' CPU shards
(SOC_TPU_LOCAL_DEVICE_IDS=0,1,2,3 gives it four); `devices N` in rt, sca
and the pipeline spans every process's devices, each process steps its
own shards, and every one holds the replicated result; process 0 writes
the files. `bench` runs in every process (its scaling section's mesh
spans them), process 0 printing its line. The host verbs run on process
0 alone; `domains` is refused over several processes (parallel/dist.py).
"""

import os
import sys

import numpy as np

_MIN_ARGS = {"rt": 1, "sca": 1, "pipeline": 1, "a2e_pre": 3, "a2e": 3,
             "eqsolve": 3, "a2e_lib": 6, "mabu": 3, "dust": 2,
             "sampleini": 0, "bench": 0}
_DEVICE_VERBS = ("rt", "sca", "pipeline", "a2e", "a2e_lib", "mabu", "bench")
# the verbs every process of a group runs
_GROUP_VERBS = ("rt", "sca", "pipeline", "bench")


def _usage():
    print(__doc__)
    return 1


def _options(argv):
    """(positional arguments, {'device', 'lanes', 'profile'}) of argv."""
    opts = dict(device="cuda", lanes=None, profile=None)
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--profile":
            opts["profile"] = "soc_profile"
        elif a.startswith("--profile="):
            opts["profile"] = a.split("=", 1)[1]
        elif a in ("--device", "--lanes"):
            val = next(it, None)
            if val is None:
                raise SystemExit("%s needs a value" % a)
            opts[a[2:]] = val
        elif a.startswith("--device=") or a.startswith("--lanes="):
            key, val = a[2:].split("=", 1)
            opts[key] = val
        else:
            rest.append(a)
    if opts["lanes"] is not None:
        opts["lanes"] = int(opts["lanes"])
    return rest, opts


def main(argv=None, results=None):
    """Run one verb; returns the exit code. ``results``, a dict if given,
    receives the verb's RunResult objects ('rt'; 'absorption', 'emitted'
    and 'map' for the pipeline; for `sca` the maps array 'sca' and its
    source passes' stats 'sca_passes'; for `mabu` the emission stage's
    timings 'mabu'; for `bench` its result dict 'bench') for callers that
    check them."""
    argv = sys.argv[1:] if argv is None else list(argv)
    results = {} if results is None else results
    # several processes: the process group from soc_tpu's variables
    # (SOC_TPU_COORDINATOR / SOC_TPU_DISTRIBUTED=auto); no-op otherwise
    from .parallel import dist
    dist.maybe_initialize()
    if not argv or argv[0] in ("-h", "--help"):
        return _usage()
    args, opts = _options(argv)
    verb, args = args[0], args[1:]
    if verb not in _MIN_ARGS:
        return _usage()
    if len(args) < _MIN_ARGS[verb]:
        print("%s: expected at least %d argument(s)\n"
              % (verb, _MIN_ARGS[verb]))
        return _usage()
    device = None
    if verb in _DEVICE_VERBS:
        import torch
        device = torch.device(opts["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            print("soc_tpu_torch: no CUDA device; pass --device cpu to run "
                  "on the CPU", file=sys.stderr)
            return 2
    if dist.process_count() > 1 and verb not in _GROUP_VERBS:
        # a host verb computes and writes its files in one process: the
        # others wait for process 0's exit code
        rc = _run(opts, verb, args, device, results) \
            if dist.process_index() == 0 else None
        return dist.share(rc)
    return _run(opts, verb, args, device, results)


def _run(opts, verb, args, device, results):
    if opts["profile"] is None:
        return _dispatch(verb, args, device, opts["lanes"], results)
    return _profiled(opts["profile"], verb, args, device, opts["lanes"],
                     results)


def _profiled(out_dir, verb, args, device, lanes, results):
    """The verb under torch.profiler and the program's tracer
    (utils/trace.py), its Chrome trace written to
    out_dir/trace_<verb>.json and its spans and counters to
    out_dir/spans_<verb>.json (a process of several: <verb>.rank<k>, so
    processes in one directory keep their own)."""
    import json
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .parallel import dist
    from .utils import trace
    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trace.start()
        try:
            rc = _dispatch(verb, args, device, lanes, results)
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            records = trace.stop()
    os.makedirs(out_dir, exist_ok=True)
    tag = verb if dist.process_count() == 1 \
        else "%s.rank%d" % (verb, dist.process_index())
    path = os.path.join(out_dir, "trace_%s.json" % tag)
    prof.export_chrome_trace(path)
    with open(os.path.join(out_dir, "spans_%s.json" % tag), "w") as fp:
        json.dump(records, fp)
    print("soc_tpu_torch: profile written to %s" % path)
    return rc


def _nearest(freq, values):
    """Indices of the channels of ``freq`` nearest each value [Hz]."""
    return np.asarray([int(np.argmin(np.abs(freq - f0))) for f0 in values])


def _dispatch(verb, args, device, lanes, results):
    if verb == "bench":
        # soc_tpu's verb takes no arguments; its knobs are SOC_BENCH_*
        from . import bench
        results["bench"] = bench.main(device=device)
        return 0

    if verb == "rt":
        from .pipeline import driver
        if len(args) > 1:
            print("rt takes one ini file", file=sys.stderr)
            return 1
        res = results["rt"] = driver.run(
            args[0], device=device, lanes=lanes or driver.DEFAULT_LANES)
        print("soc_tpu_torch rt done: cells=%d timings=%s"
              % (res.grid.cells,
                 {k: round(v, 3) for k, v in res.timings.items()}))
        return 0

    if verb == "sca":
        from .pipeline import scattering
        passes = results["sca_passes"] = []
        out = results["sca"] = scattering.run(
            args[0], device=device,
            lanes=lanes or scattering.DEFAULT_LANES, passes=passes)
        print("soc_tpu_torch sca done: outcoming.socs shape", out.shape)
        return 0

    if verb == "pipeline":
        from .pipeline import driver
        from .pipeline.full import run_pipeline
        mode = args[1] if len(args) > 1 else None
        res_rt, emitted, res_map = run_pipeline(
            args[0], device=device, lanes=lanes or driver.DEFAULT_LANES,
            mode=mode)
        results.update(absorption=res_rt, emitted=emitted, map=res_map)
        print("soc_tpu_torch pipeline done%s: cells=%d absorption=%s "
              "maps=%s" % (" (%s)" % mode if mode else "", res_rt.grid.cells,
                           {k: round(v, 3)
                            for k, v in res_rt.timings.items()},
                           {k: round(v, 3)
                            for k, v in res_map.timings.items()}))
        return 0

    if verb == "sampleini":
        from .config import RunConfig
        path = args[0] if args else "sample.ini"
        RunConfig.write_sample_ini(path)
        print("wrote", path)
        return 0

    if verb == "a2e_pre":
        from .solve import solver_prep
        from .solve.grain_model import read_gset_dust
        from .solve.solver_file import write_solver
        dust = read_gset_dust(args[0])
        freq = np.loadtxt(args[1])
        ne = int(args[3]) if len(args) > 3 else 256
        sol = solver_prep.build_solver(dust, freq, ne=ne)
        write_solver(args[2], sol)
        print("wrote %s: NSIZE=%d NFREQ=%d NE=%d"
              % (args[2], sol.nsize, sol.nfreq, sol.ne))
        return 0

    if verb == "a2e":
        return _a2e(args, device)
    if verb == "a2e_lib":
        return _a2e_lib(args, device)
    if verb == "eqsolve":
        return _eqsolve(args)
    if verb == "mabu":
        return _mabu(args, device, results)
    return _dust(args)


def _a2e(args, device):
    """solver absorbed emitted [GPU [nstoch [IFREQ [aalg]]]] (A2E.py:17-30):
    the streamed A2E solve. GPU selects an OpenCL device in the reference;
    here it is always accepted and ignored (--device places the solve), so
    reference command lines run verbatim; nstoch therefore needs the
    5-argument form `a2e solver absorbed emitted 0 <nstoch>`. IFREQ >= 0
    writes that one column; aalg (an int32 CELLS header + float32[CELLS])
    adds the polarised emission, <emitted>.P."""
    from .solve import stochastic
    from .solve.solver_file import read_solver
    sol = read_solver(args[0])
    nstoch, ifreq, aalg = 999, None, None
    rest = args[3:]
    if len(rest) > 1:
        nstoch = int(rest[1])
    if len(rest) > 2 and int(rest[2]) >= 0:
        ifreq = int(rest[2])
    if len(rest) > 3:
        with open(rest[3], "rb") as fp:
            n = int(np.fromfile(fp, np.int32, 1)[0])
            aalg = np.fromfile(fp, np.float32, n)
        cells_abs = int(np.fromfile(args[1], np.int32, 1)[0])
        if n != cells_abs:
            raise SystemExit("a2e: aalg file has %d entries, absorbed has %d"
                             " rows" % (n, cells_abs))
    rows = stochastic.solve_emission_streaming(
        sol, args[1], args[2], device, nstoch=nstoch, aalg=aalg,
        pemitted_path=(args[2] + ".P") if aalg is not None else None,
        ifreq=ifreq)
    print("wrote %s: (%d, %d)"
          % (args[2], rows, 1 if ifreq is not None else sol.nfreq))
    return 0


def _a2e_lib(args, device):
    """solver lib freq.dat lfreq.dat abs emit [makelib] [GPU] [ofreq]
    [bins-a-b-c] (A2E_LIB.py:13-47). makelib: the full A2E solve, then the
    library of (absorbed at the reference frequencies -> emission);
    otherwise the lookup, from an absorbed file of all NFREQ columns or of
    the 3 reference ones. GPU (or a bare number) is accepted and ignored;
    bins-a-b-c gives the dense grid's bins an axis (the largest of a, b, c:
    one dense level, not the reference's 3-level tree)."""
    from .io.fields import (read_cell_frequency_array,
                            write_cell_frequency_array)
    from .solve import library as libmod
    from .solve import stochastic
    from .solve.solver_file import read_solver
    sol = read_solver(args[0])
    lib_path = args[1]
    freq = np.atleast_1d(np.loadtxt(args[2]))
    lfreq = np.atleast_1d(np.loadtxt(args[3]))
    f_abs, f_emit = args[4], args[5]
    rest = args[6:]
    makelib = "makelib" in rest
    nbins = 64
    ofreq = None

    def _numeric(r):
        try:
            float(r)
            return True
        except ValueError:
            return False

    for r in rest:
        if r in ("makelib", "GPU") or _numeric(r):
            continue
        if r.startswith("bins-"):
            nbins = max(int(x) for x in r.split("-")[1:])
        elif os.path.exists(r):
            ofreq = np.atleast_1d(np.loadtxt(r))
        else:
            raise SystemExit("a2e_lib: ofreq file %r not found" % r)
    if len(lfreq) != 3:
        raise SystemExit("a2e_lib: lfreq.dat must list exactly 3 reference "
                         "frequencies (got %d): the library bins on 3 axes "
                         "like the reference's tree (A2E_LIB.py:535-849)"
                         % len(lfreq))
    absorbed = read_cell_frequency_array(f_abs)
    ref_idx = list(_nearest(freq, lfreq))
    if makelib:
        if absorbed.shape[1] != len(freq):
            raise SystemExit("a2e_lib makelib: absorbed must have all %d "
                             "frequencies" % len(freq))
        emitted = stochastic.solve_emission(sol, absorbed, device)
        lib = libmod.build_library(absorbed, emitted, ref_idx, nbins=nbins)
        libmod.save_library(lib_path, lib)
        print("wrote %s: nbins=%d occupancy=%.3f"
              % (lib_path, lib["nbins"], lib["occupancy"]))
    else:
        lib = libmod.load_library(lib_path)
        if absorbed.shape[1] == len(lfreq):
            # a reduced file: its columns are the reference frequencies
            lib = dict(lib, ref_indices=list(range(len(lfreq))))
        emitted = libmod.solve_with_library(lib, absorbed, device=device)
    if ofreq is not None:
        emitted = np.ascontiguousarray(emitted[:, _nearest(freq, ofreq)])
    write_cell_frequency_array(f_emit, emitted)
    print("wrote %s: (%d, %d)" % (f_emit, *emitted.shape))
    return 0


def _eqsolve(args):
    """dust absorbed emitted [GPU] (EQ_solver.py:10-17): the equilibrium
    solve of one simple dust (host NumPy), writing emitted and the
    raw-float32 temperatures <dust>.T (EQ_solver.py:180)."""
    from .constants import PARSEC
    from .io.dust import read_simple_dust
    from .io.fields import (read_cell_frequency_array,
                            write_cell_frequency_array)
    from .pipeline.mabu import solve_equilibrium_eqdust
    opt = read_simple_dust(args[0], 1.0)
    kabs = np.asarray(opt.abs_gl, np.float64) / PARSEC   # per unit density
    absorbed = read_cell_frequency_array(args[1])
    if absorbed.shape[1] != len(opt.freq):
        raise SystemExit("eqsolve: absorbed has %d freqs, dust %d"
                         % (absorbed.shape[1], len(opt.freq)))
    emitted, t = solve_equilibrium_eqdust(kabs, opt.freq, absorbed)
    write_cell_frequency_array(args[2], emitted)
    np.asarray(t, np.float32).tofile(args[0] + ".T")
    print("wrote %s: (%d, %d); T percentiles %.2f %.2f %.2f"
          % (args[2], emitted.shape[0], emitted.shape[1],
             *np.percentile(t, (10, 50, 90))))
    return 0


def _mabu(args, device, results):
    """soc.ini absorbed emitted [ofreq] (A2E_MABU.py): the emission stage
    (full.emission_stage: the multi-dust solve, or the ini's surrogates)
    on an absorbed file. The output columns: the ofreq.dat list, else the
    ini's `mapum`, else its `remit` band; with `polarisation` the
    polarised emission goes to <emitted>.P; CR_HEATING 3 reads the
    cloud's density. results['mabu'] receives the stage's timings."""
    from .config import RunConfig
    from .io.dust import read_simple_dust
    from .io.fields import (read_cell_frequency_array,
                            write_cell_frequency_array)
    from .pipeline.driver import remit_mask_of
    from .pipeline.full import (build_components, classify_dusts,
                                emission_stage, read_abundances)
    from .solve.grain_model import read_gset_dust
    cfg = RunConfig(args[0]).validate()
    absorbed = read_cell_frequency_array(args[1])
    cells = absorbed.shape[0]
    stoch, simple = classify_dusts(cfg)
    freq = read_simple_dust(simple[0], cfg.gl).freq if simple \
        else np.asarray(read_gset_dust(stoch[0]).qfreq)
    cfg.freq = freq
    comps = build_components(cfg, freq)
    abu = read_abundances(cfg, cells, len(comps))
    valid = absorbed[:, 0] > -1e19
    clean = np.where(valid[:, None], absorbed, 0.0).astype(np.float32)
    dens = None
    if cfg.cr_heating >= 3:
        # CR_HEATING 3 couples to the gas density (A2E_MABU.py:99-107)
        from .io.cloud import read_cloud
        dens = read_cloud(cfg.file_cloud, "cpu", cfg.kdensity,
                          cfg.max_levels).dens.numpy()
    timings = results["mabu"] = {}
    emitted, pemitted = emission_stage(cfg, comps, clean, abu, freq, device,
                                       dens=dens, timings=timings)
    emitted[~valid] = 0.0
    # the output frequencies (A2E_MABU.py:316-323 NOFREQ)
    sel = None
    if len(args) > 3:
        sel = _nearest(freq, np.atleast_1d(np.loadtxt(args[3])))
    elif cfg.single_map_freq:
        sel = _nearest(freq, cfg.single_map_freq)
    elif cfg.remit_f[0] > 0.0 or cfg.remit_f[1] < 1e30:
        sel = np.nonzero(remit_mask_of(cfg, freq))[0]
    narrow = sel is not None and len(sel) < len(freq)
    if narrow:
        emitted = np.ascontiguousarray(emitted[:, sel])
    write_cell_frequency_array(args[2], emitted)
    print("wrote %s: %s" % (args[2], emitted.shape))
    if pemitted is not None:
        # the polarised emission (A2E_MABU.py:589, 651-656)
        pemitted[~valid] = 0.0
        if narrow:
            pemitted = np.ascontiguousarray(pemitted[:, sel])
        write_cell_frequency_array(args[2] + ".P", pemitted)
    return 0


def _dust(args):
    """GRAIN.DAT freq.dat [NE [GL_pc]] (the DE_to_GSET.jl workflow): a
    DustEM model compiled into, per species, <name>_simple.dust,
    <name>.dsc and, with heat capacities, gs_<name>.dust (the GSET
    container and its .opt/.ent/.size) and <name>.solver; plus the
    combined tmp.dust / tmp.dsc for the RT stage. Host NumPy."""
    from .io.dust import write_simple_dust
    from .solve import dust_compiler as dc
    from .solve import solver_prep
    from .solve.grain_model import write_gset_dust
    from .solve.solver_file import write_solver
    ne = int(args[2]) if len(args) > 2 else 128
    gl = float(args[3]) if len(args) > 3 else 1.0
    freq = np.sort(np.atleast_1d(np.loadtxt(args[1])))
    dusts = dc.compile_dustem_model(args[0])
    per_opt = []
    for d in dusts:
        opt = dc.effective_optics(d, freq, gl)
        per_opt.append(opt)
        write_simple_dust("%s_simple.dust" % d.name, opt, gl)
        dsc, csc = dc.tabulated_scattering_function(d, freq)
        dc.write_scattering_file("%s.dsc" % d.name, dsc, csc)
        if d.c_cap is not None:
            gset = dc.to_gset(d)
            write_gset_dust("gs_%s.dust" % d.name, gset, ne=ne)
            sol = solver_prep.build_solver(gset, freq, ne=ne)
            write_solver("%s.solver" % d.name, sol)
        print("compiled %s: nsize=%d%s" % (
            d.name, d.nsize,
            "" if d.c_cap is not None else " (no C data: eq-only)"))
    write_simple_dust("tmp.dust", dc.combine_optics(per_opt), gl)
    dsc, csc = dc.combined_scattering_function(dusts, freq)
    dc.write_scattering_file("tmp.dsc", dsc, csc)
    print("wrote combined tmp.dust / tmp.dsc (%d species, %d freqs)"
          % (len(dusts), len(freq)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
