"""`python -m openifem_tpu_torch.cases.fsi_leaflet`, the port's twin of the
JAX package's examples/fsi_leaflet.py: one step of the coarse leaflet
(h = 0.1) on the CPU through its main(), with the VTU/PVD output of the
last state in the working directory (tests/conftest.py runs each test in
its own temporary directory)."""

import os

import torch

from openifem_tpu_torch.cases import fsi_leaflet


def test_main_one_step_writes_output(monkeypatch, capsys):
    monkeypatch.setenv("OPENIFEM_DEVICE", "cpu")
    torch.set_num_threads(1)
    fsi_leaflet.main(["--steps", "1", "--h", "0.1"])
    out = capsys.readouterr().out
    assert "leaflet tip deflection" in out
    for name in ("fluid.pvd", "solid.pvd", "fluid-000001.vtu",
                 "solid-000001.vtu"):
        assert os.path.getsize(name) > 0
