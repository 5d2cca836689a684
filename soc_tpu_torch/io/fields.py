"""Codecs for per-cell field files and map files.

The port's own copy of ``soc_tpu.io.fields``, the same code but for the
spans: the port imports nothing of soc_tpu.

absorbed.data / emitted.data (ASOC.py:619-638, 3972-3977): int32 header
[CELLS, NFREQ] followed by float32 [CELLS, NFREQ].

map_dir_%02d.bin (ASOC.py:3000-3005, plot_results.py): int32 [NPIX_X, NPIX_Y]
header followed by float32 [NFREQ, NY, NX] surface brightness in Jy/sr.

background intensity: bare float32 [NFREQ] (ASOC_aux.py:1081).
point-source luminosities: float32 [NFREQ] per source file (ASOC_aux.py:1107).

Each write is the span `io.write` (utils/trace.py), attr ``bytes``.
"""

import numpy as np

from ..utils import trace


def read_cell_frequency_array(path):
    """Read [CELLS, NFREQ] float32 with int32 [CELLS, NFREQ] header."""
    with open(path, "rb") as fp:
        cells, nfreq = np.fromfile(fp, np.int32, 2)
        data = np.fromfile(fp, np.float32).reshape(int(cells), int(nfreq))
    return data


def write_cell_frequency_array(path, data):
    data = np.asarray(data, np.float32)
    with trace.span("io.write", bytes=8 + data.nbytes), \
            open(path, "wb") as fp:
        np.asarray(data.shape, np.int32).tofile(fp)
        data.tofile(fp)


def read_background_intensity(path, nfreq):
    ibg = np.fromfile(path, np.float32)
    if len(ibg) != nfreq:
        raise ValueError(f"{path}: {len(ibg)} values != NFREQ {nfreq}")
    return ibg


def write_map_file(path, maps):
    """Write maps[NFREQ, NY, NX] (float32, Jy/sr) with int32 [NX, NY] header."""
    maps = np.asarray(maps, np.float32)
    if maps.ndim == 2:
        maps = maps[None]
    nf, ny, nx = maps.shape
    with trace.span("io.write", bytes=8 + maps.nbytes), \
            open(path, "wb") as fp:
        np.asarray([nx, ny], np.int32).tofile(fp)
        maps.tofile(fp)


def read_map_file(path, nfreq):
    with open(path, "rb") as fp:
        nx, ny = np.fromfile(fp, np.int32, 2)
        data = np.fromfile(fp, np.float32).reshape(nfreq, int(ny), int(nx))
    return data
