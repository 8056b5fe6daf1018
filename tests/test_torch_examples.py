"""The four examples of the PyTorch port (``examples/torch_*.py``) run on
the CPU (``--device cpu``: the kernels' plain versions; the simulation
has no device) in subprocesses, as the JAX package's CI runs its
examples: exit code 0, the SLO and loss lines printed, and neither
``jax`` nor the JAX package imported. The simulation prints what the JAX
package's ``examples/edge_serving_sim.py`` prints."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs the example as __main__, then prints the JAX modules it imported
_RUN = ("import runpy, sys\n"
        "path = sys.argv[1]\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_path(path, run_name='__main__')\n"
        "print('LEAKED', sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.'))))\n")


def _run(name, *args):
    # one intra-op thread: the engines' real-clock l(b) probes run on a
    # CPU shared with other test workers (as tests/test_torch_serving.py)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cp = subprocess.run(
        [sys.executable, "-c", _RUN, os.path.join(REPO, "examples", name),
         *args], env=env, capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert "LEAKED []" in cp.stdout, cp.stdout[-2000:]
    return cp.stdout


def test_torch_quickstart():
    out = _run("torch_quickstart.py", "--device", "cpu")
    assert "engine: smollm-360m-smoke" in out
    assert re.search(r"measured l\(b\): \{1: [\d.]+, 2: ", out)
    assert len(re.findall(r"^(control|voice|qa) ", out, re.M)) == 4
    m = re.search(r"SLO attainment: (\d+)%  \((\d+) decode iterations, "
                  r"4 prefills\)", out)
    assert m and int(m.group(2)) > 0, out[-1500:]
    assert "kernel launches: none" in out


def test_torch_multi_slo_serving():
    out = _run("torch_multi_slo_serving.py", "--device", "cpu")
    assert "engine: mamba2-780m-smoke (family=ssm)" in out
    # a class whose tasks SLICE dropped (a loaded CPU's real-clock l(b)
    # can make them infeasible) prints "-" for its TPOT and rate
    rows = re.findall(r"^(strict|medium|lax) +(\d+) +([\d.]+) +([\d.]+|-) ",
                      out, re.M)
    assert sorted(r[0] for r in rows) == ["lax", "medium", "strict"]
    assert sum(int(r[1]) for r in rows) == 7
    assert any(r[3] != "-" for r in rows), out[-1500:]
    assert "SLICE delivered DIFFERENT decode rates per class" in out


def test_torch_train_tiny(tmp_path):
    ckpt = str(tmp_path / "tiny.npz")
    out = _run("torch_train_tiny.py", "--device", "cpu", "--steps", "40",
               "--d-model", "64", "--layers", "2", "--batch", "4", "--seq",
               "32", "--ckpt", ckpt)
    assert "step   39 loss=" in out
    m = re.search(r"loss ([\d.]+) -> ([\d.]+) \(improved\)", out)
    assert m and float(m.group(2)) < float(m.group(1)), out[-1500:]
    assert f"checkpoint round-trip OK -> {ckpt}" in out
    assert os.path.exists(ckpt)


def test_torch_edge_serving_sim():
    out = _run("torch_edge_serving_sim.py", "--duration", "20")
    rows = re.findall(r"^(SLICE|Orca|FastServe) +([\d.]+)% +([\d.]+)% ", out,
                      re.M)
    assert [r[0] for r in rows] == ["SLICE", "Orca", "FastServe"]
    assert all(0 <= float(r[1]) <= 100 for r in rows)
    # a copy of the JAX example but for its imports: the same printout
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, os.path.join(
        REPO, "examples", "edge_serving_sim.py"), "--duration", "20"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert out.rpartition("LEAKED")[0] == cp.stdout
