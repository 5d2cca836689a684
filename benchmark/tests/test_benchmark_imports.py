"""No module the harness loads is jax, jaxlib, flax or the JAX package
(compared by top-level name, whole: soc_tpu_torch is not soc_tpu), in the
process that prints the result and in every rank of a cell over several
processes."""

import os
import subprocess
import sys

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(
        ["soc_tpu_torch", "soc_tpu_torch.pipeline.driver", "numpy"]) == []
    assert harness.forbidden_modules(
        ["soc_tpu.solve", "jaxlib.xla_client", "flax", "jax"]) == [
            "flax", "jax", "jaxlib", "soc_tpu"]


def test_verdict():
    assert harness.verdict("0", [0, 0, 0], ["soc_tpu_torch", "numpy"]) == 0
    assert harness.verdict("1", [], ["soc_tpu.solve", "numpy"]) == 4
    # a rank's 4 (or any failure) is rank 0's 5, and rank 0 prints nothing
    assert harness.verdict("0", [0, 4, 0], ["numpy"]) == 5


def test_a_rank_that_loads_one_fails_the_run():
    """soc_example.rt-4card's path on four CPU processes, the JAX
    package's name left in rank 1's modules once the window has closed."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(HERE, "ranks.py"),
                          "soc_example.rt-4card", "forbidden_on_rank1"],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 4, out.stderr[-3000:]
    assert "rank 1 loaded soc_tpu" in out.stderr


def test_a_run_loads_none():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "from benchmark.tests import tiny; from benchmark import harness; "
            "out = tiny.run('soc_example.pipeline', trace=1); "
            "print(json.dumps(dict(correct=out['correct'], "
            "bad=harness.forbidden_modules())))"
            % os.path.dirname(os.path.dirname(HERE)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert '"bad": []' in line and '"correct": true' in line, line
