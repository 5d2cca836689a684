"""Build and load the package's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``_build/`` next to
this file (listed in .gitignore), named by the hash of the source, the
headers of ``csrc/`` it includes and the flags: a changed source or header
builds anew, an unchanged one loads at once.
Nothing is built when the module is imported: a kernel's first launch
builds its own source only. Several threads may build different sources
at once.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# no --use_fast_math: the probes' gathers are held to their plain versions
# bit for bit, and the A2E solve divides and clamps near float32's limits
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)
_lock = threading.Lock()
_loaded = {}
build_log = {}      # source name -> (seconds, nvcc output) of this process


def _nvcc():
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        path = os.path.join(root, "bin", "nvcc") if root else ""
        if path and os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _digest(src):
    """Hash of ``src``, of the headers of csrc/ it includes (#include
    "...", followed through the headers), and of the flags."""
    h = hashlib.sha256()
    todo, seen = [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as fp:
            text = fp.read()
        h.update(text)
        for m in _INCLUDE.findall(text):
            header = os.path.join(CSRC, m.decode())
            if os.path.exists(header):      # else a system header
                todo.append(header)
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library(name):
    """ctypes handle of csrc/<name>.cu, compiled on first use (only this
    source is built)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
    src = os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, _digest(src)))
    if not os.path.exists(out):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.time()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on %s:\n%s" % (src, log))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_log[name] = (time.time() - t0, log)
    with _lock:
        return _loaded.setdefault(name, ctypes.CDLL(out))
