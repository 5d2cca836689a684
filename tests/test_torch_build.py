"""soc_tpu_torch._build without a CUDA toolkit: a stand-in nvcc (a Python
script that logs each source it compiles and copies the C maths library to
its -o path) shows that a first use builds only its own source, that
libraries are cached by the hash of their own source, and that a failed
build raises and leaves no temp file.
"""

import ctypes.util
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from soc_tpu_torch import _build

FAKE_NVCC = """#!{python}
import shutil, sys
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
if "FAIL" in open(src).read():
    print("error: cannot compile " + src)
    sys.exit(1)
shutil.copy({lib!r}, out)
with open({log!r}, "a") as fp:
    fp.write(src + "\\n")
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    lib = ctypes.util.find_library("m")
    path = None
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
              "/usr/lib64", "/lib", "/usr/lib"):
        if lib and os.path.exists(os.path.join(d, lib)):
            path = os.path.join(d, lib)
            break
    assert path, "no C maths library found"
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     lib=path))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_log", {})
    for name in ("a", "b", "c"):
        (csrc / (name + ".cu")).write_text("// kernel %s\n" % name)

    def built():
        lines = log.read_text().splitlines() if log.exists() else []
        return [os.path.basename(s)[:-3] for s in lines]
    return csrc, build, built


def test_first_use_builds_its_own_source_only(fake):
    csrc, build, built = fake
    lib = _build.library("a")
    assert lib.cos is not None
    assert built() == ["a"]
    assert list(_build.build_log) == ["a"]
    assert _build.library("a") is lib
    _build._loaded.clear()
    _build.library("a")                 # cached on disk: no second nvcc
    assert built() == ["a"]
    assert [f for f in os.listdir(build) if f.startswith("liba_")]


def test_sources_build_from_threads_and_rebuild_on_change(fake):
    csrc, build, built = fake
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.library, ["b", "c"]))
    assert all(lib.cos is not None for lib in libs)
    assert sorted(built()) == ["b", "c"]
    assert sorted(_build.build_log) == ["b", "c"]
    before = set(os.listdir(build))
    (csrc / "b.cu").write_text("// kernel b, changed\n")
    _build._loaded.clear()
    _build.library("b")
    _build.library("c")
    new = set(os.listdir(build)) - before
    assert len(new) == 1 and new.pop().startswith("libb_")
    assert sorted(built()) == ["b", "b", "c"]


def test_failed_build_raises_and_leaves_no_temp_file(fake):
    csrc, build, built = fake
    (csrc / "bad.cu").write_text("FAIL\n")
    _build.library("a")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build.library("bad")
    assert "bad" not in _build._loaded and "bad" not in _build.build_log
    assert os.listdir(build) == [f for f in os.listdir(build)
                                 if f.startswith("liba_")]
    assert len(os.listdir(build)) == 1


def test_changed_header_rebuilds_the_sources_that_include_it(fake):
    """A source's library is named by the hash of the source and of the
    csrc/ headers it includes, through other headers: a changed header
    rebuilds the sources that include it and no other."""
    csrc, build, built = fake
    (csrc / "common.cuh").write_text("// shared\n")
    (csrc / "inner.cuh").write_text('#include "common.cuh"\n')
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "inner.cuh"\n// kernel a\n')
    for name in ("a", "b"):
        _build.library(name)
    assert sorted(built()) == ["a", "b"]
    (csrc / "common.cuh").write_text("// shared, changed\n")
    _build._loaded.clear()
    for name in ("a", "b"):
        _build.library(name)
    assert sorted(built()) == ["a", "a", "b"]
