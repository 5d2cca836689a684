"""The port's own copies of soc_tpu's host modules (constants, config,
io.dust, io.fields, io.fits, solve.solver_file, solve.grain_model,
solve.solver_prep, solve.dust_compiler, solve.ali) against their originals
on the same inputs.

Tolerance: none. The copies are the same NumPy code, so every result is
held bit for bit (NaNs compared as equal) and every file byte for byte.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from soc_tpu import config as jconfig
from soc_tpu import constants as jconst
from soc_tpu.io import dust as jdust
from soc_tpu.io import fields as jfields
from soc_tpu.io import fits as jfits
from soc_tpu.solve import ali as jali
from soc_tpu.solve import dust_compiler as jdc
from soc_tpu.solve import grain_model as jgm
from soc_tpu.solve import solver_file as jsf
from soc_tpu.solve import solver_prep as jsp

from soc_tpu_torch import config as tconfig
from soc_tpu_torch import constants as tconst
from soc_tpu_torch import example_model
from soc_tpu_torch.io import dust as tdust
from soc_tpu_torch.io import fields as tfields
from soc_tpu_torch.io import fits as tfits
from soc_tpu_torch.solve import ali as tali
from soc_tpu_torch.solve import dust_compiler as tdc
from soc_tpu_torch.solve import grain_model as tgm
from soc_tpu_torch.solve import solver_file as tsf
from soc_tpu_torch.solve import solver_prep as tsp

HERE = os.path.dirname(os.path.abspath(__file__))
NFREQ = 12
GRAIN = example_model.GRAIN_LINE.format(nsize=5)


def assert_same(a, b, path="value"):
    """Deep equality: dataclasses field by field, containers item by
    item, arrays with their dtypes and bits (NaN equal to NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        "%s.%s" % (path, f.name))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], "%s[%r]" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _wiring_inis():
    """Every ini of tests/test_ini_wiring.py: its base ini alone and with
    each extra ini text the file adds (string literals with a newline)."""
    with open(os.path.join(HERE, "test_ini_wiring.py")) as fp:
        tree = ast.parse(fp.read())
    texts = sorted({n.value for n in ast.walk(tree)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and "\n" in n.value and "%" not in n.value})
    base = next(t for t in texts if "{bgpac}" in t)
    extras = [t for t in texts if "{" not in t]
    return [base.format(bgpac=6912)] \
        + [base.format(bgpac=6912) + e for e in extras]


def _config_pair(**kw):
    out = []
    for mod in (jconfig, tconfig):
        try:
            out.append(("ok", vars(mod.RunConfig(**kw))))
        except Exception as e:          # both must raise alike
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("i", range(len(_wiring_inis())))
def test_runconfig_on_the_ini_wiring_inis(i):
    a, b = _config_pair(text=_wiring_inis()[i])
    assert a[0] == b[0]
    assert_same(a[1], b[1])


@pytest.mark.parametrize("kind", ["gset", "eqdust"])
def test_runconfig_on_the_example_model(tmp_path, kind):
    ini = example_model.write_model(str(tmp_path), 4, kind=kind, nfreq=8,
                                    nsize=3, extra="devices 4\n")
    a, b = _config_pair(ini_path=ini)
    assert a[0] == b[0] == "ok"
    assert_same(a[1], b[1])


def test_constants_are_the_same():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert_same(getattr(jconst, n), getattr(tconst, n), n)
    f = np.geomspace(1e11, 3e15, 9)
    assert_same(jconst.planck_intensity(f, 17.5),
                tconst.planck_intensity(f, 17.5))
    assert_same(jconst.um2f(np.asarray([0.55, 250.0])),
                tconst.um2f(np.asarray([0.55, 250.0])))


@pytest.fixture(scope="module")
def dustem(tmp_path_factory):
    d = tmp_path_factory.mktemp("dustem")
    um = np.logspace(np.log10(0.1), np.log10(3000.0), NFREQ)
    return example_model._dustem_files(str(d), um)


@pytest.fixture(scope="module")
def compiled(dustem):
    return (jdc.compile_dust(GRAIN, *dustem), tdc.compile_dust(GRAIN, *dustem))


def test_dust_compiler_bit_equal(compiled):
    jd, td = compiled
    assert_same(jd, td)
    freq = example_model.frequencies(NFREQ)
    assert_same(jdc.to_gset(jd), tdc.to_gset(td))
    assert_same(jdc.effective_optics(jd, freq, 0.01),
                tdc.effective_optics(td, freq, 0.01))
    assert_same(jdc.tabulated_scattering_function(jd, freq, bins=300),
                tdc.tabulated_scattering_function(td, freq, bins=300))


def test_build_solver_bit_equal(compiled, tmp_path):
    """build_solver on the synthetic GSET dust, and its .solver file
    written byte for byte and read back equal."""
    freq = example_model.frequencies(NFREQ)
    js = jsp.build_solver(jdc.to_gset(compiled[0]), freq, ne=24)
    ts = tsp.build_solver(tdc.to_gset(compiled[1]), freq, ne=24)
    assert_same(js, ts)
    jsf.write_solver(str(tmp_path / "j.solver"), js)
    tsf.write_solver(str(tmp_path / "t.solver"), ts)
    assert (tmp_path / "j.solver").read_bytes() \
        == (tmp_path / "t.solver").read_bytes()
    assert_same(jsf.read_solver(str(tmp_path / "j.solver")),
                tsf.read_solver(str(tmp_path / "t.solver")))
    assert_same(jsf.densify_weights(js.sizes[1], js.ne, js.nfreq),
                tsf.densify_weights(ts.sizes[1], ts.ne, ts.nfreq))


def _write_both(tmp_path, name, jwrite, twrite, *args):
    """Writes ``name`` with both packages, each into a directory of its
    own; every file they write (side files included) must be byte-equal."""
    jd, td = tmp_path / name / "j", tmp_path / name / "t"
    jd.mkdir(parents=True)
    td.mkdir(parents=True)
    jwrite(str(jd / name), *args)
    twrite(str(td / name), *args)
    written = sorted(p.name for p in jd.iterdir())
    assert written == sorted(p.name for p in td.iterdir())
    for f in written:
        assert (jd / f).read_bytes() == (td / f).read_bytes(), f
    return str(jd / name), str(td / name)


def test_dust_files_byte_equal(compiled, tmp_path):
    freq = example_model.frequencies(NFREQ)
    jd = compiled[0]
    gset = jdc.to_gset(jd)
    jp, tp = _write_both(tmp_path, "gset.dust", jgm.write_gset_dust,
                         tgm.write_gset_dust, gset)
    assert_same(jgm.read_gset_dust(jp), tgm.read_gset_dust(tp))
    assert_same(jgm.gset_effective_optics(gset, freq, 0.01),
                tgm.gset_effective_optics(gset, freq, 0.01))
    opt = jdc.effective_optics(jd, freq, 0.01)
    jp, tp = _write_both(tmp_path, "simple.dust", jdust.write_simple_dust,
                         tdust.write_simple_dust, opt, 0.01)
    assert_same(jdust.read_simple_dust(jp, 0.01),
                tdust.read_simple_dust(tp, 0.01))
    dsc, csc = jdc.tabulated_scattering_function(jd, freq, bins=300)
    jp, tp = _write_both(tmp_path, "tmp.dsc", jdc.write_scattering_file,
                         tdc.write_scattering_file, dsc, csc)
    assert_same(jdust.read_scattering_function(jp, NFREQ, 300),
                tdust.read_scattering_function(tp, NFREQ, 300))
    assert_same(jdust.hg_scattering_function(np.linspace(0, 0.8, 5), 64),
                tdust.hg_scattering_function(np.linspace(0, 0.8, 5), 64))


def test_runconfig_on_the_source_models(tmp_path):
    """The keywords of point sources, the Healpix sky, the diffuse field,
    abundances, split, simum, saveint and optishalf."""
    ini = example_model.write_model(
        str(tmp_path), 4, kind="eqdust", nfreq=8,
        point_sources=[(2.0, 2.1, 1.9, 0.5), (2.0, 2.0, 9.0, 1.0)],
        ps_method=3, pspackets=100, hpbg=2, hpbg_weighted=True,
        diffuse=0.5, dfpackets=128, abundance=True, split=6,
        simum=(1.0, 100.0), saveint=2, optishalf=True)
    a, b = _config_pair(ini_path=ini)
    assert a[0] == b[0] == "ok"
    assert_same(a[1], b[1])


def test_source_input_readers_bit_equal(tmp_path):
    """The diffuse field and the abundances, as the drivers read them."""
    from soc_tpu.pipeline import driver as jdriver
    from soc_tpu.pipeline import full as jfull
    from soc_tpu_torch.pipeline import driver as tdriver
    from soc_tpu_torch.pipeline import full as tfull
    ini = example_model.write_model(str(tmp_path), 4, kind="eqdust",
                                    nfreq=8, diffuse=0.5, abundance=True)
    path = str(tmp_path / "diffuse.bin")
    assert_same(jdriver.read_diffuse_field(path, 64),
                tdriver.read_diffuse_field(path, 64))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = tconfig.RunConfig(ini)
        assert_same(jfull.read_abundances(cfg, 64, 2),
                    tfull.read_abundances(cfg, 64, 2))
        assert_same(jfull.read_abundances(cfg, 64, 2),
                    tdriver.read_abundances(cfg, 64, 2))
    finally:
        os.chdir(cwd)


def test_field_files_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    cells = rng.random((50, NFREQ), np.float32)
    jp, tp = _write_both(tmp_path, "absorbed.data",
                         jfields.write_cell_frequency_array,
                         tfields.write_cell_frequency_array, cells)
    assert_same(jfields.read_cell_frequency_array(jp),
                tfields.read_cell_frequency_array(tp))
    maps = rng.random((NFREQ, 6, 7), np.float32)
    jp, tp = _write_both(tmp_path, "map_dir_00.bin", jfields.write_map_file,
                         tfields.write_map_file, maps)
    assert_same(jfields.read_map_file(jp, NFREQ),
                tfields.read_map_file(tp, NFREQ))
    bg = tmp_path / "bg.bin"
    rng.random(NFREQ, np.float32).tofile(bg)
    assert_same(jfields.read_background_intensity(str(bg), NFREQ),
                tfields.read_background_intensity(str(bg), NFREQ))


def test_ali_bit_equal():
    """The ALI escape-probability table, its lookup and the beta
    refinement on the models' frequencies and absorption curve."""
    rng = np.random.default_rng(9)
    freq = example_model.frequencies(NFREQ)
    kabs = np.geomspace(1e-3, 2.0, NFREQ)[::-1].astype(np.float32)
    tau = rng.uniform(0.0, 150.0, 200)
    assert_same(jali.escape_probability(tau), tali.escape_probability(tau))
    jt, tt = jali.beta_table(freq, kabs), tali.beta_table(freq, kabs)
    assert_same(jt, tt)
    temp = rng.uniform(3.0, 2000.0, 200).astype(np.float32)
    assert_same(jali.beta_lookup(jt, temp, tau),
                tali.beta_lookup(tt, temp, tau))
    beta0 = rng.uniform(0.0, 1.2, 200).astype(np.float32)
    dens = rng.uniform(-1.0, 80.0, 200).astype(np.float32)
    told = (temp * rng.uniform(0.8, 1.2, 200)).astype(np.float32)
    for t_old in (None, told):
        assert_same(jali.refine_beta(beta0, temp, freq, kabs, dens, t_old),
                    tali.refine_beta(beta0, temp, freq, kabs, dens, t_old))


@pytest.mark.parametrize("shape,kw", [
    ((6, 7), {}), ((3, 6, 7), dict(pix_deg=0.0125, ra_deg=12.5)),
    ((1, 5, 4), dict(de_deg=-30.0, pix_deg=1e-3, bunit="cm-2"))])
def test_fits_files_byte_equal(tmp_path, shape, kw):
    """FITS images (a 2-D map, a cube, a one-plane cube with a unit) and
    the Healpix table, written byte for byte and read back equal."""
    rng = np.random.default_rng(len(shape))
    data = rng.random(shape, np.float32)
    jp, tp = _write_both(tmp_path, "m.fits",
                         lambda p, d: jfits.write_fits_image(p, d, **kw),
                         lambda p, d: tfits.write_fits_image(p, d, **kw),
                         data)
    assert_same(jfits.read_fits_image(str(jp)),
                tfits.read_fits_image(str(tp)))
    maps = rng.random((4, 12 * 4 * 4), np.float32)
    jp, tp = _write_both(tmp_path, "hp.fits", jfits.write_healpix_map,
                         tfits.write_healpix_map, maps, 4)
    assert_same(jfits.read_healpix_map(str(jp)),
                tfits.read_healpix_map(str(tp)))
