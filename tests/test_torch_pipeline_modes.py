"""The pipeline modes and the surrogate keywords through both packages on
the same example_model inputs: `makelib` then `uselib`, `nnmake` then
`nnsolve`, `absthin`, `libabs` (alone and under `devices 2` on CPU
shards) and `libmaps`.

Tolerances: packets follow the same paths in both packages except for the
rare packet that XLA's own exp/log/cos/sin send elsewhere, so files are
held as in tests/test_torch_product_runs.py: per-frequency totals at
2e-3, 99% of the per-cell entries at 1e-4 (close_fields). The library's
bin transform is held at 1e-4 (its lo and span come from those fields).
The two packages train their surrogates from different random
initialisations, so each package's `nnsolve` is held to its own full solve
with soc_tpu's bound (tests/test_pipeline_modes.py:90-94, median < 0.1),
and each package's `nnsolve` of the other's `.nn` files to the other's
emission at 1e-4 relative (two float32 forward passes).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from soc_tpu.pipeline import driver as jdriver
from soc_tpu.pipeline import full as jfull

from soc_tpu_torch.constants import um2f
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.io.fields import read_cell_frequency_array, \
    write_cell_frequency_array
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull
from soc_tpu_torch.solve import library as tlib

sys.path.insert(0, "tests")
from test_torch_product_runs import close_fields, read_fields  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 4096
NFREQ = 12
FSELECT = "0.55 2.2 25.0"


def _pair(tmp_path, n=6, extra=""):
    kw = dict(kind="eqdust", nfreq=NFREQ, extra=extra)
    return (write_model(str(tmp_path / "t"), n, **kw),
            write_model(str(tmp_path / "j"), n, **kw))


def _nearest(freq, um):
    return [int(np.argmin(np.abs(freq - um2f(u)))) for u in um]


def test_makelib_then_uselib_matches_soc_tpu(tmp_path):
    ini_t, ini_j = _pair(tmp_path)
    _, e_full, _ = tfull.run_pipeline(ini_t, CPU, lanes=LANES,
                                      mode="makelib")
    jfull.run_pipeline(ini_j, lanes=LANES, mode="makelib")
    names = ("absorbed.data", "emitted.data")
    ft, fj = read_fields(tmp_path / "t", names), \
        read_fields(tmp_path / "j", names)
    for n in names:
        close_fields(ft[n], fj[n], n, NFREQ)
    lt = tlib.load_library(tmp_path / "t" / "tst.lib")
    lj = tlib.load_library(tmp_path / "j" / "tst.lib")
    assert lt["ref_indices"] == lj["ref_indices"] and lt["nbins"] == 64
    np.testing.assert_allclose(lt["lo"], lj["lo"], rtol=1e-4)
    np.testing.assert_allclose(lt["span"], lj["span"], rtol=1e-4)
    assert 0.0 < lt["occupancy"] <= 1.0

    rt, e_lib, rm = tfull.run_pipeline(ini_t, CPU, lanes=LANES,
                                       mode="uselib")
    jfull.run_pipeline(ini_j, lanes=LANES, mode="uselib")
    names = ("absorbed.data", "emitted.data", "map_dir_00.bin")
    ft, fj = read_fields(tmp_path / "t", names), \
        read_fields(tmp_path / "j", names)
    for n, ncol in zip(names, (3, NFREQ, 36)):
        close_fields(ft[n], fj[n], n, ncol)
    # only the 3 reference channels were simulated
    assert np.count_nonzero(rt.injected) == 3
    assert rt.absorbed.shape == (216, NFREQ)
    # in-sample lookup against the full solve (soc_tpu's bound for a
    # single-phase model)
    sel = e_full > e_full.max() * 1e-6
    rel = np.abs(e_lib[sel] - e_full[sel]) / e_full[sel]
    assert np.median(rel) < 0.05
    assert np.isfinite(rm.maps[0]).all() and rm.maps[0].shape == (NFREQ, 6, 6)


def test_makelib_bins_the_leaf_cells(tmp_path):
    """On an octree makelib builds the library from the leaf cells only
    (soc_tpu bins the parents' zeroed rows too, whose floor of -33 spans
    every axis over 36 dex): the library is build_library of the leaves'
    rows bit for bit, its floors are the leaves', and its in-sample
    lookup beats the one with the parents' rows."""
    ini = write_model(str(tmp_path), 8, kind="eqdust", nfreq=NFREQ,
                      octree=(2, 8, 3), bgpac=9999)
    rt, e_full, _ = tfull.run_pipeline(ini, CPU, lanes=LANES,
                                       mode="makelib")
    leaf = rt.absorbed[:, 0] > -1e19
    clean = np.where(leaf[:, None], rt.absorbed, 0.0).astype(np.float32)
    assert (~leaf).sum() > 0 and (clean[leaf] > 0).all()
    lib = tlib.load_library(tmp_path / "tst.lib")
    refs = tlib.choose_reference_frequencies(rt.freq)
    want = tlib.build_library(clean[leaf], e_full[leaf], refs)
    for k in ("lo", "span", "mean", "lookup"):
        np.testing.assert_array_equal(lib[k], want[k])
    assert (lib["lo"] > -33.0).all()
    every = tlib.build_library(clean, e_full, refs)
    assert (every["lo"] == -33.0).all()
    t = e_full[leaf]
    m = t > 1e-3 * t.max()
    errs = [np.median(np.abs(tlib.lookup_numpy(lb, clean[leaf])[m] / t[m]
                             - 1.0)) for lb in (lib, every)]
    assert errs[0] < errs[1], errs


def test_uselib_without_a_library_raises(tmp_path):
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6)
    with pytest.raises(FileNotFoundError, match="makelib"):
        tfull.run_pipeline(ini, CPU, lanes=LANES, mode="uselib")
    with pytest.raises(ValueError, match="mode"):
        tfull.run_pipeline(ini, CPU, lanes=LANES, mode="libmake")


def test_nnmake_then_nnsolve_matches_soc_tpu(tmp_path):
    nn_lines = "nnabs  0.55 2.2 25.0 250.0\nnnemit  100.0 250.0 500.0\n"
    ini_t, ini_j = _pair(tmp_path, n=10, extra="nnmake  surro\n" + nn_lines)
    _, e_full_t, _ = tfull.run_pipeline(ini_t, CPU, lanes=LANES)
    _, e_full_j, _ = jfull.run_pipeline(ini_j, lanes=LANES)
    for d in ("t", "j"):
        assert (tmp_path / d / "surro_tst.nn").exists()
        ini = tmp_path / d / "run.ini"
        ini.write_text(ini.read_text().replace("nnmake", "nnsolve"))
    _, e_nn_t, _ = tfull.run_pipeline(ini_t, CPU, lanes=LANES)
    _, e_nn_j, _ = jfull.run_pipeline(ini_j, lanes=LANES)
    freq = tdriver.read_simple_dust(str(tmp_path / "t" / "tst.dust"),
                                    0.01).freq
    idx = _nearest(freq, (100.0, 250.0, 500.0))
    other = np.ones(NFREQ, bool)
    other[idx] = False
    for e_nn, e_full in ((e_nn_t, e_full_t), (e_nn_j, e_full_j)):
        a, b = e_nn[:, idx], e_full[:, idx]
        pos = b > 0
        assert np.median(np.abs(a[pos] - b[pos]) / b[pos]) < 0.1
        assert np.abs(e_nn[:, other]).max() == 0.0
    # each package's nnsolve on the other's surrogate
    shutil.copy(tmp_path / "j" / "surro_tst.nn",
                tmp_path / "t" / "surro_tst.nn")
    _, e_tj, _ = tfull.run_pipeline(ini_t, CPU, lanes=LANES)
    np.testing.assert_allclose(e_tj[:, idx], e_nn_j[:, idx], rtol=1e-4,
                               atol=1e-6 * e_nn_j.max())


def test_nnsolve_two_dusts_with_abundances(tmp_path):
    """Two dusts with per-cell abundances: each dust's surrogate takes its
    share of the absorptions, the input nnmake trained it on. soc_tpu's
    nnsolve feeds every dust the total absorptions, which equal a dust's
    share only for one dust without abundances (that case is held to
    soc_tpu in test_nnmake_then_nnsolve_matches_soc_tpu). Bounds: two
    surrogates' errors add, so the median is held at 0.15, one and a half
    times soc_tpu's one-dust bound (0.10 read on the CPU); the same nets
    fed the totals miss by more than 100% (2.09 read)."""
    from soc_tpu_torch.solve import nn as tnn
    nn_lines = "nnabs  0.55 2.2 25.0 250.0\nnnemit  100.0 250.0 500.0\n"
    ini = write_model(str(tmp_path), 10, kind="eqdust", nfreq=NFREQ,
                      abundance=True, extra="nnmake  surro\n" + nn_lines)
    _, e_full, _ = tfull.run_pipeline(ini, CPU, lanes=LANES)
    with open(ini) as fp:
        text = fp.read()
    with open(ini, "w") as fp:
        fp.write(text.replace("nnmake", "nnsolve"))
    _, e_nn, rm = tfull.run_pipeline(ini, CPU, lanes=LANES)
    assert rm.timings["nn_solve"] > 0
    freq = tdriver.read_simple_dust(str(tmp_path / "tst.dust"), 0.01).freq
    idx = _nearest(freq, (100.0, 250.0, 500.0))
    iabs = _nearest(freq, (0.55, 2.2, 25.0, 250.0))
    absorbed = read_cell_frequency_array(tmp_path / "absorbed.data")
    totals = np.zeros_like(e_nn)
    for k, name in enumerate(("tst", "tst2")):
        abu = np.fromfile(tmp_path / ("abu%d.bin" % k), np.float32)
        model = tnn.nn_load(tmp_path / ("surro_%s.nn" % name))
        totals[:, idx] += tnn.nn_solve(model, absorbed[:, iabs], CPU) \
            * abu[:, None]
    b = e_full[:, idx]
    pos = b > 0
    for e, lo, hi in ((e_nn, 0.0, 0.15), (totals, 1.0, np.inf)):
        med = np.median(np.abs(e[:, idx][pos] - b[pos]) / b[pos])
        assert lo < med < hi, med


@pytest.mark.parametrize("thin", [2, 3])
def test_absthin_matches_soc_tpu(tmp_path, thin):
    ini_t, ini_j = _pair(tmp_path, extra="absthin %d\n" % thin)
    _, e_t, _ = tfull.run_pipeline(ini_t, CPU, lanes=LANES)
    _, e_j, _ = jfull.run_pipeline(ini_j, lanes=LANES)
    names = ("absorbed.data", "emitted.data")
    ft, fj = read_fields(tmp_path / "t", names), \
        read_fields(tmp_path / "j", names)
    for n in names:
        close_fields(ft[n], fj[n], n, NFREQ)
    solved = np.zeros(len(e_t), bool)
    solved[::thin] = True
    assert (e_t[~solved] == 0).all() and (e_t[solved].max(1) > 0).all()


def test_libabs_writes_the_fselect_columns(tmp_path):
    """`libabs` simulates only the FSELECT channels and stops: the file holds
    exactly those columns, soc_tpu's within close_fields, and each equals
    the column of a full run (the same packets) at 1e-4."""
    ini_t, ini_j = _pair(tmp_path, extra="libabs %s\n" % FSELECT)
    rt = tdriver.run(ini_t, device=CPU, lanes=LANES)
    jdriver.run(ini_j, lanes=LANES)
    ft, fj = read_fields(tmp_path / "t", ["absorbed.data"]), \
        read_fields(tmp_path / "j", ["absorbed.data"])
    close_fields(ft["absorbed.data"], fj["absorbed.data"], "absorbed.data",
                 3)
    sel = sorted(_nearest(rt.freq, (0.55, 2.2, 25.0)))
    assert np.count_nonzero(rt.injected) == 3
    assert rt.temperature is None and not rt.maps
    full = tdriver.run(write_model(str(tmp_path / "full"), 6, kind="eqdust",
                                   nfreq=NFREQ), device=CPU, lanes=LANES)
    got = read_cell_frequency_array(tmp_path / "t" / "absorbed.data")
    np.testing.assert_allclose(got, full.absorbed[:, sel], rtol=1e-4,
                               atol=1e-7 * full.absorbed[:, sel].max())


def test_libabs_devices_2_matches_one_device(tmp_path):
    """`libabs` under `devices 2` (two CPU shards, the mesh's tally reduced
    first) against the one-device run: the same packets, another order of
    the adds (chip_smoke.py's devices bound: 1e-4 relative or 1e-6 of the
    maximum)."""
    one = write_model(str(tmp_path / "one"), 6, kind="eqdust", nfreq=NFREQ,
                      extra="libabs %s\n" % FSELECT)
    two = write_model(str(tmp_path / "two"), 6, kind="eqdust", nfreq=NFREQ,
                      extra="libabs %s\ndevices 2\n" % FSELECT)
    r1 = tdriver.run(one, device=CPU, lanes=LANES)
    r2 = tdriver.run(two, device=CPU, lanes=LANES)
    assert r2.devices is not None and len(r2.devices) == 2
    a1 = read_cell_frequency_array(tmp_path / "one" / "absorbed.data")
    a2 = read_cell_frequency_array(tmp_path / "two" / "absorbed.data")
    assert a1.shape == a2.shape == (216, 3)
    np.testing.assert_allclose(a2, a1, rtol=1e-4, atol=1e-6 * a1.max())
    np.testing.assert_array_equal(r2.injected, r1.injected)
    np.testing.assert_allclose(r2.escaped, r1.escaped, rtol=1e-4)


def test_libmaps_embeds_a_narrow_emitted_file(tmp_path):
    """A map-only run (`iterations 0`) with `libmaps` reads an emitted file
    of the FSELECT columns only, embeds it and renders the FSELECT
    channels, as soc_tpu does."""
    rng = np.random.default_rng(3)
    narrow = rng.uniform(0.5, 2.0, (216, 3)).astype(np.float32)
    extra = "libmaps %s\n" % FSELECT
    ini_t = write_model(str(tmp_path / "t"), 6, kind="eqdust", nfreq=NFREQ,
                        iterations=0, extra=extra)
    ini_j = write_model(str(tmp_path / "j"), 6, kind="eqdust", nfreq=NFREQ,
                        iterations=0, extra=extra)
    for d in ("t", "j"):
        write_cell_frequency_array(tmp_path / d / "emitted.data", narrow)
    rt = tdriver.run(ini_t, device=CPU, lanes=LANES)
    jdriver.run(ini_j, lanes=LANES)
    sel = sorted(_nearest(rt.freq, (0.55, 2.2, 25.0)))
    np.testing.assert_array_equal(rt.emitted[:, sel], narrow)
    assert not np.delete(rt.emitted, sel, axis=1).any()
    assert tdriver.map_freq_mask(tdriver.RunConfig(ini_t),
                                 rt.freq).sum() == 3
    names = ("map_dir_00.bin",)
    ft, fj = read_fields(tmp_path / "t", names), \
        read_fields(tmp_path / "j", names)
    close_fields(ft[names[0]], fj[names[0]], names[0], 36)
