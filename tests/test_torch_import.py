"""The port imports torch and never jax, and chip_smoke.py refuses to run
without a CUDA device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import openifem_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if importlib.util.find_spec(m.name).origin.endswith('.py'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'openifem_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'openifem_tpu_torch.fsi.fsi' in sys.modules\n"
        "for m in ('solvers.fluid.supg', 'solvers.fluid.scnsex',\n"
        "          'cases.acoustic_duct', 'cases.fluid_cylinder',\n"
        "          'fsi.mpi_fsi', 'solvers.solid.linear',\n"
        "          'solvers.solid.shared', 'solvers.solid.hypo',\n"
        "          'cases.fsi_wall_3d', 'cases.mpi_block',\n"
        "          'solvers.turbulence.spalart_allmaras', 'fsi.cv_fsi',\n"
        "          'cases.vocal_fold', 'io.checkpoint', 'fe.kelly',\n"
        "          'fe.transfer', 'solvers.solid.shell',\n"
        "          'cases.shell_plate', 'parallel.shard', 'entry'):\n"
        "    assert 'openifem_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    r = _run(code)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no CUDA device" in r.stderr
    assert "jax" not in r.stderr
