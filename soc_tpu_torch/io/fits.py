"""Minimal FITS writers and readers (a copy of soc_tpu.io.fits, NumPy
only, held to it byte for byte: tests/test_torch_host_modules.py).

Covers the reference's MakeFits usage (ASOC_aux.py:1723): float32 image HDUs
with a gnomonic (RA---TAN / DEC--TAN) WCS, used for the FITS / savetau /
colden outputs, and the HEALPix binary-table writer. Standard-conforming
single-HDU files: 80-char cards in 2880-byte header blocks, big-endian
float32 data padded to 2880. The ORIGIN card stays "soc_tpu", so the two
packages write the same bytes.
"""

import numpy as np

from ..utils import trace


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        txt = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        txt = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        txt = f"{key:<8}= {value:>20.12E}"
    else:
        txt = f"{key:<8}= '{str(value):<8}'"
    if comment:
        txt += f" / {comment}"
    return txt[:80].ljust(80)


def write_fits_image(path, data, ra_deg=0.0, de_deg=0.0, pix_deg=None,
                     bunit="Jy/sr"):
    """Write a float32 FITS image (2-D [NY,NX] or 3-D cube [NF,NY,NX])."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[None]
    nf, ny, nx = data.shape
    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", -32),
        _card("NAXIS", 3 if nf > 1 else 2),
        _card("NAXIS1", nx),
        _card("NAXIS2", ny),
    ]
    if nf > 1:
        cards.append(_card("NAXIS3", nf))
    cards += [
        _card("CRPIX1", 0.5 * (nx + 1)),
        _card("CRPIX2", 0.5 * (ny + 1)),
        _card("CRVAL1", float(ra_deg)),
        _card("CRVAL2", float(de_deg)),
        _card("CTYPE1", "RA---TAN"),
        _card("CTYPE2", "DEC--TAN"),
        _card("BUNIT", bunit),
        _card("ORIGIN", "soc_tpu"),
    ]
    if pix_deg is not None:
        cards.insert(7, _card("CDELT1", -float(pix_deg)))
        cards.insert(8, _card("CDELT2", float(pix_deg)))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * ((2880 - len(header) % 2880) % 2880)
    payload = (data[0] if nf == 1 else data).astype(">f4").tobytes()
    payload += b"\0" * ((2880 - len(payload) % 2880) % 2880)
    with trace.span("io.write", bytes=len(header) + len(payload)), \
            open(path, "wb") as fp:
        fp.write(header.encode("ascii"))
        fp.write(payload)


def write_healpix_map(path, maps, nside, column_names=None, coord="G"):
    """Write HEALPix maps as a FITS binary table, matching the conventions
    of the reference's `healpy.write_map('pol_healpix.fits.%d', (I,Q,U,N),
    fits_IDL=False, coord='G', ...)` output (ASOC.py:3948-3958): an empty
    primary HDU plus one BINTABLE extension with one float32 column per
    map, PIXTYPE=HEALPIX, ORDERING=RING, and the NSIDE/FIRSTPIX/LASTPIX
    keywords -- readable by astropy.io.fits / healpy.read_map."""
    maps = [np.asarray(m, np.float32).ravel() for m in maps]
    npix = 12 * nside * nside
    for m in maps:
        if m.size != npix:
            raise ValueError("map size %d != 12*NSIDE^2 = %d"
                             % (m.size, npix))
    if column_names is None:
        column_names = ["I_STOKES", "Q_STOKES", "U_STOKES", "N"][:len(maps)]
    primary = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", 8),
        _card("NAXIS", 0),
        _card("EXTEND", True),
        "END".ljust(80),
    ]
    ncol = len(maps)
    ext = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", 4 * ncol, "bytes per row"),
        _card("NAXIS2", npix, "rows = healpix pixels"),
        _card("PCOUNT", 0),
        _card("GCOUNT", 1),
        _card("TFIELDS", ncol),
    ]
    for i, name in enumerate(column_names):
        ext.append(_card("TTYPE%d" % (i + 1), name))
        ext.append(_card("TFORM%d" % (i + 1), "1E"))
    ext += [
        _card("PIXTYPE", "HEALPIX", "HEALPIX pixelisation"),
        _card("ORDERING", "RING", "ring pixel ordering"),
        _card("COORDSYS", coord),
        _card("NSIDE", int(nside)),
        _card("FIRSTPIX", 0),
        _card("LASTPIX", npix - 1),
        _card("INDXSCHM", "IMPLICIT"),
        _card("ORIGIN", "soc_tpu"),
        "END".ljust(80),
    ]

    def _pad_hdr(cards):
        h = "".join(cards)
        return h + " " * ((2880 - len(h) % 2880) % 2880)

    table = np.stack(maps, axis=1).astype(">f4").tobytes()
    table += b"\0" * ((2880 - len(table) % 2880) % 2880)
    with open(path, "wb") as fp:
        fp.write(_pad_hdr(primary).encode("ascii"))
        fp.write(_pad_hdr(ext).encode("ascii"))
        fp.write(table)


def read_healpix_map(path):
    """Round-trip reader for write_healpix_map: returns (maps [ncol, npix],
    header dict of the BINTABLE extension)."""
    with open(path, "rb") as fp:
        raw = fp.read()

    def _read_header(pos):
        hdr = {}
        while True:
            block = raw[pos:pos + 2880].decode("ascii")
            pos += 2880
            for i in range(0, 2880, 80):
                card = block[i:i + 80]
                key = card[:8].strip()
                if key == "END":
                    return hdr, pos
                if "=" in card:
                    val = card.split("=", 1)[1].split("/")[0].strip()
                    hdr[key] = val.strip("' ")

    hdr0, pos = _read_header(0)
    if int(hdr0.get("NAXIS", 0)) != 0:
        raise ValueError("expected empty primary HDU")
    hdr, pos = _read_header(pos)
    npix = int(hdr["NAXIS2"])
    ncol = int(hdr["TFIELDS"])
    data = np.frombuffer(raw[pos:pos + 4 * npix * ncol], dtype=">f4")
    return np.asarray(data.reshape(npix, ncol).T, np.float32), hdr


def read_fits_image(path):
    """Minimal reader (for round-trip tests): returns (data, header dict)."""
    with open(path, "rb") as fp:
        raw = fp.read()
    hdr = {}
    pos = 0
    while True:
        block = raw[pos:pos + 2880].decode("ascii")
        pos += 2880
        done = False
        for i in range(0, 2880, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" in card:
                val = card.split("=", 1)[1].split("/")[0].strip()
                hdr[key] = val.strip("' ")
        if done:
            break
    shape = [int(hdr[f"NAXIS{i}"])
             for i in range(int(hdr["NAXIS"]), 0, -1)]
    n = int(np.prod(shape))
    data = np.frombuffer(raw[pos:pos + 4 * n], dtype=">f4").reshape(shape)
    return np.asarray(data, np.float32), hdr
