"""The binned emission library (solve/library.py) against soc_tpu's on the
same inputs: equilibrium-dust spectra over cells of varying field strength
and spectral shape, made from a numpy seed.

Tolerances: build_library and the NumPy lookup are copies of soc_tpu's
host code, held bit for bit. The torch lookup forms the bins in float32,
as soc_tpu's jitted device path does, so a cell within float32 epsilon of
a bin edge may take the neighbouring bin: it must pick the same bin as the
twin, and as soc_tpu's device path, in at least 99.9% of the cells
(soc_tpu's own bound, tests/test_pipeline_modes.py:204-229).
"""

import numpy as np
import pytest
import torch

from soc_tpu.pipeline import mabu as jmabu
from soc_tpu.solve import library as jlib

from soc_tpu_torch.solve import library as tlib

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    freq = np.logspace(11.5, 15, 24)
    kabs = 1e-21 * (freq / 1e12) ** 1.7
    rng = np.random.default_rng(4)
    strength = 10.0 ** rng.uniform(1, 5, 4000)
    hard = 10.0 ** rng.uniform(-0.3, 0.3, 4000)
    base = (freq / freq.max()) ** -1
    absorbed = (strength[:, None]
                * base[None, :] ** hard[:, None]).astype(np.float32)
    emitted, _ = jmabu.solve_equilibrium_eqdust(kabs, freq, absorbed)
    return freq, absorbed, emitted


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_reference_frequencies_match(data):
    freq = data[0]
    for um in ((0.55, 2.2, 25.0), (0.35, 1.1, 50.0)):
        assert tlib.choose_reference_frequencies(freq, um) == \
            jlib.choose_reference_frequencies(freq, um)


@pytest.mark.parametrize("ncells,nbins", [(3000, 48), (200, 32), (500, 16),
                                          (4000, 64)])
def test_build_library_bit_equal(data, ncells, nbins):
    freq, absorbed, emitted = data
    refs = jlib.choose_reference_frequencies(freq)
    _same(tlib.build_library(absorbed[:ncells], emitted[:ncells], refs,
                             nbins=nbins),
          jlib.build_library(absorbed[:ncells], emitted[:ncells], refs,
                             nbins=nbins))


@pytest.mark.parametrize("nbins", [16, 48])
def test_numpy_lookup_bit_equal(data, nbins):
    """The port's NumPy twin (and solve_with_library on the CPU, which runs
    it) equals soc_tpu's host path bit for bit, on held-out cells."""
    freq, absorbed, emitted = data
    refs = jlib.choose_reference_frequencies(freq)
    lib = tlib.build_library(absorbed[:3000], emitted[:3000], refs,
                             nbins=nbins)
    want = jlib.solve_with_library(dict(lib), absorbed[3000:], device=False)
    np.testing.assert_array_equal(tlib.lookup_numpy(lib, absorbed[3000:]),
                                  want)
    np.testing.assert_array_equal(
        tlib.solve_with_library(lib, absorbed[3000:], device=CPU), want)
    # soc_tpu's argument order (eps before device)
    np.testing.assert_array_equal(
        tlib.solve_with_library(lib, absorbed[3000:], 1e-33, CPU), want)
    # without a device the lookup goes to the card, never to the twin:
    # here, with no card, it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlib.solve_with_library(lib, absorbed[3000:])


@pytest.mark.parametrize("seed", [7, 8])
def test_torch_lookup_picks_the_same_bins(seed):
    """The torch lookup on CPU tensors against the NumPy twin and against
    soc_tpu's jitted device path: the same bin in >= 99.9% of the cells;
    the table is cached under a "_" key that save_library leaves out."""
    rng = np.random.default_rng(seed)
    nf, cells = 16, 4096
    absorbed = rng.lognormal(0.0, 2.0, (cells, nf)).astype(np.float32)
    emitted = rng.random((cells, nf)).astype(np.float32)
    lib = tlib.build_library(absorbed, emitted, [1, 5, 9], nbins=16)
    table, lo, span = tlib.device_table(lib, CPU)
    got = tlib.lookup_torch(table, lo, span,
                            torch.as_tensor(absorbed[:, [1, 5, 9]]),
                            lib["nbins"]).numpy()
    twin = tlib.lookup_numpy(lib, absorbed)
    jdev = np.asarray(jlib.solve_with_library(
        jlib.build_library(absorbed, emitted, [1, 5, 9], nbins=16),
        absorbed, device=True))
    assert np.all(got == twin, axis=1).mean() > 0.999
    assert np.all(got == jdev, axis=1).mean() > 0.999
    assert tlib.device_table(lib, CPU)[0] is table      # cached
    assert "_tables" in lib


def test_lib_files_cross_read(tmp_path, data):
    """A .lib written by either package (after its lookup filled its
    device cache) is read by the other and answers the same."""
    freq, absorbed, emitted = data
    refs = jlib.choose_reference_frequencies(freq)
    tl = tlib.build_library(absorbed[:500], emitted[:500], refs, nbins=16)
    jl = jlib.build_library(absorbed[:500], emitted[:500], refs, nbins=16)
    tlib.device_table(tl, CPU)
    jlib.solve_with_library(jl, absorbed[:50], device=True)
    tlib.save_library(tmp_path / "t.lib", tl)
    jlib.save_library(tmp_path / "j.lib", jl)
    from_t = jlib.load_library(tmp_path / "t.lib")
    from_j = tlib.load_library(tmp_path / "j.lib")
    assert not any(k.startswith("_") for k in list(from_t) + list(from_j))
    _same(from_t, from_j)
    want = jlib.solve_with_library(from_t, absorbed[:50], device=False)
    np.testing.assert_array_equal(
        tlib.solve_with_library(from_j, absorbed[:50], device=CPU), want)


def test_library_lookup_accuracy(data):
    """soc_tpu's held-out accuracy bounds (tests/test_library.py:24-35) on
    the port: median relative error < 5%, 90th percentile < 30%."""
    freq, absorbed, emitted = data
    refs = tlib.choose_reference_frequencies(freq)
    lib = tlib.build_library(absorbed[:3000], emitted[:3000], refs, nbins=48)
    assert 0.0 < lib["occupancy"] <= 1.0
    pred = tlib.solve_with_library(lib, absorbed[3000:], device=CPU)
    truth = emitted[3000:]
    m = truth > truth.max() * 1e-8
    rel = np.abs(pred[m] / truth[m] - 1.0)
    assert np.median(rel) < 0.05, np.median(rel)
    assert np.percentile(rel, 90) < 0.3


def test_empty_bins_filled(data):
    freq, absorbed, emitted = data
    refs = tlib.choose_reference_frequencies(freq)
    lib = tlib.build_library(absorbed[:200], emitted[:200], refs, nbins=32)
    assert lib["occupancy"] < 0.5
    table, lo, span = tlib.device_table(lib, CPU)
    pred = tlib.lookup_torch(table, lo, span,
                             torch.as_tensor(absorbed[:, refs]), 32).numpy()
    assert np.all(np.isfinite(pred)) and np.all(pred.sum(axis=1) > 0)
