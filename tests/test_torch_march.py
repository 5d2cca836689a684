"""The fused march block (csrc/march.cu, transport/march_kernel.py) where
no card is needed: StepKit's decision by configuration, the block
counters of an eager run, the wrapper's refusal of a CPU pool, the
kernel source's constants against the Python ones, and the
`transport.fused_pct` reader. The kernel itself runs in
tests/test_torch_gpu.py."""

import os
import re

import numpy as np
import pytest
import torch

from soc_tpu_torch import constants, rng
from soc_tpu_torch.example_model import octree_cloud
from soc_tpu_torch.grid import grid_from_arrays, uniform_grid
from soc_tpu_torch.transport import march_kernel, propagate
from soc_tpu_torch.utils import trace

NFREQ = 4
SOURCE = os.path.join(os.path.dirname(propagate.__file__), os.pardir,
                      "csrc", "march.cu")


@pytest.fixture
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def _physics(extra=()):
    phys = dict(kabs=torch.full((NFREQ,), 0.1), ksca=torch.full((NFREQ,), 0.2),
                tw=torch.ones(NFREQ),
                csc=torch.linspace(-0.9, 0.9, 16).repeat(NFREQ, 1))
    cells = 8 ** 3
    for key in extra:
        if key == "opt":
            phys.update(opt_abs=torch.full((cells, NFREQ), 0.1),
                        opt_sca=torch.full((cells, NFREQ), 0.2))
        elif key == "msf":
            phys.update(msf_csc=torch.zeros((2, NFREQ, 16)),
                        msf_abu=torch.ones((cells, 2)),
                        msf_sca=torch.ones((NFREQ, 2)))
        elif key == "dw_a":
            phys.update(dw_a=0.4, dsc=torch.ones((NFREQ, 16)))
        else:
            phys[key] = 1.3
    return phys


def _kit(grid="root", phys=(), **kw):
    if grid == "root":
        g = uniform_grid(8, 8, 8, "cpu")
    else:
        lcells, values = octree_cloud(8, 4, 8)
        g = grid_from_arrays(8, 8, 8, lcells, values, "cpu")
    return propagate.StepKit(g, _physics(phys), 5, kw.pop("tally", False),
                             **kw)


ROI = dict(mask=torch.zeros(8 ** 3, dtype=torch.bool), box=(1, 6, 1, 6, 1, 6),
           dim=(5, 5, 5, 1), nside=1)
DOMAIN = dict(rank=0, n_slabs=2, nz_local=8, gidx=torch.arange(8 ** 3))

# (device the decision is asked for, expected, the kit's configuration)
DECISIONS = {
    "plain": ("cuda", True, {}),
    "ali": ("cuda:1", True, dict(tally=True, with_ali=True)),
    "col0": ("cuda", True, dict(tally=True, ncol=2, col0=1)),
    "cpu": ("cpu", False, {}),
    "octree": ("cuda", False, dict(grid="octree")),
    "split": ("cuda", False, dict(grid="octree", split_max=4)),
    "mirror": ("cuda", False, dict(mirror_mask=1 | 8)),
    "roi": ("cuda", False, dict(roi=ROI)),
    "domain": ("cuda", False, dict(domain=DOMAIN)),
    "with_abu": ("cuda", False, dict(phys=("opt",))),
    "msf": ("cuda", False, dict(phys=("msf",))),
    "sw_a": ("cuda", False, dict(phys=("sw_a",))),
    "sw_b": ("cuda", False, dict(phys=("sw_a", "sw_b"))),
    "dw_a": ("cuda", False, dict(phys=("dw_a",))),
    "ncomp4": ("cuda", False, dict(tally=True, ncomp=4)),
}


@pytest.mark.parametrize("name", list(DECISIONS))
def test_stepkit_fuses_by_configuration(name):
    """StepKit's one decision: a root-grid pool on a CUDA device, plain,
    with ALI or a tally block, runs the kernel; the CPU, an octree, split,
    mirrors, the ROI save, a Z slab, WITH_ABU, MSF, STEP_WEIGHT,
    DIR_WEIGHT and saveint 2 run the eager block. Every kit built here
    lies on the CPU, so none of them is fused."""
    device, expected, kw = DECISIONS[name]
    kit = _kit(**dict(kw))
    assert kit.fused is False
    assert kit.fuses_on(torch.device(device)) is expected
    assert kit.fuses_on(device) is expected


def test_cpu_run_counts_only_eager_blocks(tracer_off, monkeypatch):
    """An eager transport_run on the CPU, traced, counts one
    `transport.blocks_eager` a body and no fused block; untraced it
    counts nothing."""
    bodies = []
    body = propagate.PoolRun.body

    def counted(self, *args):
        bodies.append(1)
        return body(self, *args)
    monkeypatch.setattr(propagate.PoolRun, "body", counted)
    grid = uniform_grid(8, 8, 8, "cpu")
    params = dict(photons=torch.ones(NFREQ), per_freq=1024, hi_base=0)

    def run():
        return propagate.transport_run(
            grid, _physics(), params, NFREQ * 1024, torch.zeros(grid.cells),
            torch.zeros((grid.cells, NFREQ)), 9, nlanes=1024,
            per_freq_tally=True, with_ali=True)
    trace.start()
    out = run()
    rec = trace.stop()
    assert len(bodies) > 1 and float(out[0].sum()) > 0
    assert rec["counters"] == {"transport.blocks_eager": len(bodies)}
    del bodies[:]
    run()
    assert trace.stop()["counters"] == {} and bodies


def test_run_block_refuses_a_cpu_pool():
    """The wrapper launches for a fused kit's CUDA pool or raises: a CPU
    pool is refused before any build."""
    kit = _kit()
    st = propagate.new_pool(1024, kit.grid, torch.zeros(kit.grid.cells),
                            torch.zeros((1, 1)))
    with pytest.raises(ValueError, match="CUDA device"):
        march_kernel.run_block(kit, st, 1, propagate.REFILL_PERIOD)


def _float_constants(text):
    return {m.group(1): float(eval(m.group(2), {}))
            for m in re.finditer(r"constexpr float (\w+) = "
                                 r"static_cast<float>\(([^;]*)\);", text)}


def test_kernel_constants_are_the_python_ones():
    """csrc/march.cu's constants, rounds and rotations are the ones the
    eager block uses: PEPS, DEPS, TAULIM, PHOTON_LIMIT, MAX_SCATTERINGS,
    2 pi, 2^-21 (ops/traverse.py), Threefry's parity and its 13 rounds'
    rotations (rng.py)."""
    from soc_tpu_torch.ops import traverse
    with open(SOURCE) as fp:
        text = fp.read()
    got = _float_constants(text)
    want = dict(PEPS=constants.PEPS, TWO_PEPS=2.0 * constants.PEPS,
                DEPS=constants.DEPS, TAULIM=constants.TAULIM,
                PHOTON_LIMIT=constants.PHOTON_LIMIT,
                EPS_SCALE=traverse._EPS_SCALE, TWO_PI=2.0 * np.pi,
                INV_2_32=1.0 / 4294967296.0, INV_2_16=1.0 / 65536.0)
    for key, value in want.items():
        assert np.float32(got[key]) == np.float32(value), key
    ints = dict(re.findall(r"constexpr (?:int|uint32_t) (\w+) = (\w+);",
                           text))
    assert int(ints["PARITY"].rstrip("u"), 16) == rng._PARITY
    assert int(ints["MAX_SCATTERINGS"]) == constants.MAX_SCATTERINGS
    rots = [int(d) for d in re.findall(r"TF_ROUND\((\d+)\)",
                                       text.split("#define TF_ROUND")[1])]
    want_rots = [d for r in range(4) for d in rng._ROTATIONS[r % 2]][:13]
    assert rots == want_rots


def _reader():
    from benchmark import harness
    return harness.bench_module("metrics", "transport.fused_pct")


@pytest.mark.parametrize("counters,value", [
    ({"transport.blocks_fused": 30}, 100.0),
    ({"transport.blocks_fused": 3, "transport.blocks_eager": 1}, 75.0),
    ({"transport.blocks_eager": 12}, 0.0),
    ({"dist.collectives": 7}, None),
    ({}, None)])
def test_fused_pct_reader(counters, value):
    """transport.fused_pct: 100 fused / (fused + eager) of the profiled
    run's counters; nothing where the program counts neither block, or
    where the run had no device trace."""
    program = dict(spans=[], counters=counters, ranks={})
    view = dict(profile=dict(busy_ns=1, window_ns=10 ** 9, program=program))
    assert _reader().read(view) == value
    view["profile"]["busy_ns"] = 0
    assert _reader().read(view) is None
