"""`rt` with the diffuse emission (`diffuse`, with and without
`emweight`), `simum`, `saveint 1|2` and `dustem`, and two dusts with
per-cell abundances (`abundance`: WITH_ABU, and MSF with one scattering
function a dust), with and without `optishalf`: the port against soc_tpu
on the same 6^3 model (6 channels), as tests/test_torch_sources_rt.py.

Tolerances as there: per-frequency totals at 2e-3, 99% of the per-cell
entries at 1e-4, temperatures at 1e-4 (a rare packet takes another path
where XLA's exp/log/cos/sin differ from torch's by ulps); the intensity
file the same way after its int32 header, which is bit for bit. The
per-cell cross sections are formed as soc_tpu forms them (a float32
matmul; bfloat16 under optishalf) and are held bit for bit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu_torch.config import RunConfig
from soc_tpu_torch.example_model import frequencies, write_diffuse, \
    write_model
from soc_tpu_torch.io.dust import read_scattering_function, \
    read_simple_dust
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_phase2 import NAMES
from test_torch_sources_rt import CPU, N, NFREQ, SOURCES, compare_runs

torch.set_num_threads(2)


def _diffuse_line(tmp_path, share=0.5, nf=NFREQ - 2):
    """A diffuse field of nf < NFREQ channels (the highest ones) in both
    run directories; returns its ini lines."""
    for side in ("t", "j"):
        os.makedirs(tmp_path / side, exist_ok=True)
        line = write_diffuse(str(tmp_path / side), frequencies(NFREQ), 0.01,
                             6 * N * N, [N ** 3], share, nf=nf,
                             packets=4 * N ** 3)
    return line


@pytest.mark.parametrize("emweight", [False, True])
def test_rt_diffuse_matches_soc_tpu(tmp_path, emweight):
    """The diffuse field on its 4 highest channels (the alignment of a
    shorter field), plain and with EMWEI's phase-1 allocation (which
    needs cell packets; iterations 1 runs no cell pass)."""
    extra = _diffuse_line(tmp_path)
    if emweight:
        extra += "emweight 1\n"
    rt, rj = compare_runs(tmp_path, extra=extra,
                          cellpackets=2 * N ** 3 if emweight else None)
    dif = [st for st in rt.source_passes if st["source"] == "diffuse"][0]
    assert (dif["launched"][:2] == 0).all() and (dif["launched"][2:] > 0
                                                 ).all()
    assert dif["route"] == ("emweight" if emweight else "mixed")


def test_rt_simum_matches_soc_tpu(tmp_path):
    """`simum` over channels 2-4 of 6 with every source kind: the masked
    channels run no packet and absorb nothing."""
    freq = frequencies(NFREQ)
    um = 2.997924580e14 / freq
    extra = _diffuse_line(tmp_path)
    rt, rj = compare_runs(
        tmp_path, extra=extra, point_sources=SOURCES, pspackets=2000,
        hpbg=2, simum=(um[4] * 0.999, um[2] * 1.001))
    sel = np.zeros(NFREQ, bool)
    sel[2:5] = True
    assert (rt.launched[~sel] == 0).all() and (rt.launched[sel] > 0).all()
    assert (rt.absorbed_photons[~sel] == 0).all()
    assert (rt.injected[~sel] == 0).all()
    assert len(rt.source_passes) == 4


@pytest.mark.parametrize("mode", ["saveint 1", "saveint 2", "dustem"])
def test_rt_intensity_file_matches_soc_tpu(tmp_path, mode):
    """The intensity file (ISRF.DAT) of `saveint 1`, `saveint 2` (the
    (I, Ix, Iy, Iz) tally, int32 [CELLS, NFREQ, 4] header) and `dustem`
    (mode 1, no absorbed file); with point sources, so packets cross the
    cloud in every direction."""
    comps = 4 if mode == "saveint 2" else 1
    names = ("ISRF.DAT", "tmp.T", "map_dir_00.bin")
    if mode != "dustem":
        names += ("absorbed.data",)
    rt, _ = compare_runs(tmp_path, names=names,
                         ncols={"ISRF.DAT": NFREQ * comps},
                         heads={"ISRF.DAT": 3 if comps == 4 else 2},
                         point_sources=SOURCES, pspackets=2000,
                         extra=mode + "\n")
    head = np.fromfile(tmp_path / "t" / "ISRF.DAT", np.int32,
                       3 if comps == 4 else 2)
    assert list(head) == [N ** 3, NFREQ] + ([4] if comps == 4 else [])
    assert os.path.exists(tmp_path / "t" / "absorbed.data") \
        == (mode != "dustem")
    if comps == 4:
        # the absorbed file is the I component's scaling
        assert rt.intensity.shape == (N ** 3, NFREQ, 4)
        assert np.abs(rt.intensity[:, :, 1:]).max() <= 1.0 + 1e-5


@pytest.mark.parametrize("half", [False, True])
def test_rt_abundance_matches_soc_tpu(tmp_path, monkeypatch, half):
    """Two dusts with per-cell abundances and a scattering function each
    (MSF), background and point sources, with and without optishalf:
    the files as above, and the cross-section tables bit for bit."""
    rt, _ = compare_runs(tmp_path, abundance=True, optishalf=half,
                         point_sources=SOURCES, pspackets=2000)
    cfg = RunConfig(str(tmp_path / "t" / "run.ini"))
    monkeypatch.chdir(tmp_path / "t")
    optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
    scaf = [read_scattering_function(f, NFREQ, 2500)
            for f in cfg.file_scafunc]
    abu = tdriver.read_abundances(cfg, N ** 3, 2)
    extra = tdriver.abundance_physics(cfg, optics, scaf, abu, CPU)
    abs_d = np.stack([np.asarray(o.abs_gl) for o in optics])
    for f in range(NFREQ):
        ref = jnp.asarray(abu) @ jnp.asarray(abs_d[:, f])
        if half:
            ref = ref.astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(
            extra["opt_abs"][:, f].float().numpy(), np.asarray(ref))
    assert extra["opt_abs"].dtype == (torch.bfloat16 if half
                                      else torch.float32)
    assert extra["msf_csc"].shape == (2, NFREQ, 2500)


@pytest.mark.parametrize("kw,name", [
    (dict(split=4), "split"),
    (dict(point_sources=SOURCES, pspackets=100), "pointsource"),
    (dict(hpbg=2), "hpbg"), (dict(hpbg=2, hpbg_weighted=True), "hpbg"),
    (dict(diffuse=0.5), "diffuse"), (dict(abundance=True), "abundance"),
    (dict(optishalf=True), "optishalf"), (dict(saveint=2), "saveint"),
    (dict(extra="dustem\n"), "dustem"), (dict(simum=(1.0, 100.0)), "simum")])
def test_devices_run_each_keyword(tmp_path, kw, name):
    """Every keyword of this slice runs under `devices 4` (dp 2 x freq 2,
    4^3 cells, 6 channels) and matches the one-device run
    (test_torch_product_features.mesh_vs_one: 1e-5 relative, 1e-6 of the
    maximum)."""
    from test_torch_product_features import mesh_vs_one
    one, mesh = mesh_vs_one(tmp_path, devices=4, **kw)
    assert mesh.source_passes and one.source_passes
