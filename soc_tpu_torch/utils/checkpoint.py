"""Mid-run checkpoint/resume of the transport phases (port of
soc_tpu.utils.checkpoint).

Every packet's random stream is a pure function of its identity (phase |
iteration | channel, index within the channel), so no RNG state is saved:
a checkpoint holds the tallies and the list of completed transport units,
and a resumed run re-runs only the units that are missing. On the CPU,
where index_add_ adds in a fixed order, the resumed run equals the
uninterrupted one bit for bit; on a card the atomics reorder additions on
every run, as a same-seed rerun does.

A unit is one source or cell pass as the port runs it (one mixed pool
over the pass's channels; under `mmapabs` one block of channels; under
`devices` one sharded pass), or an iteration boundary ("iter%d", the
phase-2 state). Each unit
carries per-channel float64 vectors (a source pass its escaped, launched
and born-outside weights; a cell pass its escaped, absorbed and injected
weights, signed and absolute; soc_tpu keeps one escaped scalar a
channel), so that a resumed run reports and closes the same energy
balance as an uninterrupted one.

It differs from soc_tpu's on purpose in two more points:
  * snapshots, not references: the port's tallies are added to in place
    (index_add_, the HostTally memmap), so a unit held between flushes
    (`every` > 1) is copied to the host when it is recorded; a reference
    would be flushed later with the deposits of units not in ``done``,
    and those would be counted twice on resume;
  * the file carries a fingerprint of its own (FORMAT plus the hash of the
    ini's keywords and the run's layout): soc_tpu's files, whose unit is
    one channel of one source, and the port's, whose unit is a mixed
    pool, are each refused by the other package, which starts fresh.

File: an .npz with the unit keys ('done'), their vectors ('units',
[NU, 6, NFREQ] float64), the fingerprint and the named arrays; written to
a temporary file and made visible only by os.replace, so a process killed
while writing leaves the previous checkpoint whole. Enabled by the ini's
`checkpoint <file> [every_n_units]`. Under several processes every rank
keeps the same units and snapshots (the tallies are replicated) and reads
the file; process 0 alone writes it (``write``).
"""

import hashlib
import os
import sys
import time

import numpy as np
import torch

FORMAT = "soc_tpu_torch-ckpt-1"
VECTORS = ("escaped", "launched", "missed", "absorbed", "injected",
           "injected_abs")


def fingerprint_of(cfg, layout=""):
    """The run's fingerprint: FORMAT, soc_tpu's hash of every ini keyword
    except `checkpoint*` and `verbose*` (driver.py:1392-1399 there), the
    settings a caller may change without the ini (the pipeline's
    absorption stage: nosolve, libabs, FSELECT, the dust files) and
    ``layout`` (the mesh, the mmapabs block width)."""
    items = sorted((k, tuple(map(tuple, v))) for k, v in cfg.keys.items()
                   if not k.startswith(("checkpoint", "verbose")))
    h = hashlib.sha256(repr(items).encode()).hexdigest()[:16]
    mode = repr((bool(cfg.nosolve), bool(cfg.lib_abs),
                 tuple(cfg.fselect or ()), tuple(cfg.file_optical),
                 bool(cfg.noabsorbed), int(cfg.save_intensity), layout))
    return "%s:%s:%s" % (FORMAT, h,
                         hashlib.sha256(mode.encode()).hexdigest()[:16])


def host_copy(value):
    """A host array that no later in-place update can change: a tensor
    copied off its device (a CPU tensor copied too, as .numpy() would
    share its memory), an array (the HostTally memmap) copied."""
    if torch.is_tensor(value):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value, copy=True)


class RunCheckpoint:
    def __init__(self, path, every=1, fingerprint="", nfreq=0, log=True,
                 write=True):
        """path: the .npz file (read when it exists and its fingerprint
        matches, else ignored and later overwritten); every: flush every N
        recorded units; nfreq: the length of a unit's vectors; write:
        False for a process that holds the units but leaves the file to
        another (process 0 of several)."""
        self.path = path
        self.write = write
        self.every = max(1, int(every))
        self.fingerprint = str(fingerprint)
        self.nfreq = int(nfreq)
        self.log = log
        self.done = []
        self.units = {}             # key -> [6, NFREQ] float64
        self.arrays = None          # name -> host array
        self.flushes = []           # (seconds, bytes) of each flush
        self._since_save = 0
        if not (path and os.path.exists(path)):
            return
        with np.load(path, allow_pickle=False) as z:
            saved = str(z["fingerprint"]) if "fingerprint" in z.files \
                else ""
            if saved != self.fingerprint:
                print("checkpoint %s: configuration changed since it was "
                      "written -- starting fresh" % path, file=sys.stderr)
                return
            self.done = [str(k) for k in z["done"]]
            vecs = np.asarray(z["units"], np.float64)
            self.units = {k: vecs[i] for i, k in enumerate(self.done)}
            self.arrays = {k: z[k] for k in z.files
                           if k not in ("done", "units", "fingerprint")}
        if self.log:
            print("checkpoint %s: resuming after %d units (%s)"
                  % (path, len(self.done), ", ".join(self.done)),
                  file=sys.stderr)

    @property
    def pending(self):
        """Units recorded since the last flush."""
        return self._since_save > 0

    def completed(self, key):
        return key in self.units

    def vectors(self, key):
        """The unit's vectors as a dict name -> [NFREQ] float64."""
        return dict(zip(VECTORS, self.units[key]))

    def skipped(self, key):
        """A completed unit the resumed run skips: its vectors, and its
        name on stderr."""
        if self.log:
            print("checkpoint %s: skipping completed unit %s"
                  % (self.path, key), file=sys.stderr)
        return self.vectors(key)

    def restore(self, tabs, intf):
        """The initial tallies: the saved TABS and per-frequency tally
        (host arrays) when resuming, else the given ones."""
        if self.saved("tabs") is None:
            return tabs, intf
        return self.saved("tabs"), self.saved("intf")

    def restore_roi(self, tally):
        """The ROI save's crossing tally: the saved one (a host array) when
        resuming, else the given one (completed units' crossings live only
        in it)."""
        saved = self.saved("roi")
        return tally if saved is None else saved

    def saved(self, name):
        """The saved array under ``name``, or None."""
        if self.arrays is None:
            return None
        return self.arrays.get(name)

    def record(self, key, vectors=None, **arrays):
        """Mark one unit complete with its per-channel vectors (a dict
        over VECTORS; missing ones are zero) and the named snapshots that
        hold its deposits; flush every ``every`` units."""
        self.record_many([key], [vectors], **arrays)

    def record_many(self, keys, vectors, **arrays):
        """Mark a group of units complete under one snapshot that holds
        all of their deposits (so the file gains every key of the group
        together or none)."""
        for key, vec in zip(keys, vectors):
            row = np.zeros((len(VECTORS), self.nfreq))
            for i, name in enumerate(VECTORS):
                if vec is not None and vec.get(name) is not None:
                    row[i] = np.asarray(vec[name], np.float64)
            self.done.append(key)
            self.units[key] = row
        self._since_save += len(keys)
        if self._since_save >= self.every:
            self.flush(**arrays)
        else:
            self._hold(arrays)

    def _hold(self, arrays):
        # a copy now: the caller goes on adding into these tallies
        if self.arrays is None:
            self.arrays = {}
        for name, value in arrays.items():
            if value is not None:
                self.arrays[name] = host_copy(value)

    def flush(self, **arrays):
        """Write every unit recorded so far with the held snapshots (and
        ``arrays``, the newest) to the file, atomically."""
        self._hold(arrays)
        self._since_save = 0
        if not (self.path and self.write):
            return
        t0 = time.time()
        tmp = self.path + ".tmp.npz"
        units = np.stack([self.units[k] for k in self.done]) if self.done \
            else np.zeros((0, len(VECTORS), self.nfreq))
        with open(tmp, "wb") as fp:
            np.savez(fp, done=np.asarray(self.done, dtype="U64"),
                     units=units, fingerprint=np.asarray(self.fingerprint),
                     **(self.arrays or {}))
        os.replace(tmp, self.path)
        size = os.path.getsize(self.path)
        self.flushes.append((time.time() - t0, size))
        if self.log:
            print("checkpoint %s: flushed %d units, %d bytes in %.3f s"
                  % (self.path, len(self.done), size,
                     self.flushes[-1][0]), file=sys.stderr)
