"""No JAX in a run, and nothing of the program in the reference: checked
in fresh interpreters by top-level module name."""

import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "animnerf_tpu"}


def _top_level(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}]\n" + code
         + "\nprint(' '.join(sorted({m.split('.')[0] "
           "for m in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_run_loads_no_jax():
    # a whole tiny run on the CPU, program included
    code = ("import tempfile, time\n"
            "sys.path.insert(0, " + repr(os.path.join(BENCH_DIR, "tests"))
            + ")\n"
            "from conftest import make_tiny\n"
            "from harness.runner import run_cell\n"
            "import run\n"
            "root = make_tiny(tempfile.mkdtemp())\n"
            "run_cell(root, 'tiny.view', 3, 0.2, True, 'cpu', "
            "time.perf_counter())\n")
    mods = _top_level(code)
    assert "animnerf_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("import reference.body, reference.field, "
                      "reference.render, reference.train")
    assert not mods & (FORBIDDEN | {"animnerf_tpu_torch"})


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "smpl.view.turntable512", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
