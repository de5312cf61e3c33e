"""The adaptive leaflet's inner A-solve counts in the port against the JAX
package's, per step, on the CPU: path A's configuration
(cases/fsi_leaflet.py "fsi_leaflet", the dense condensed preconditioner)
at h = 0.1 with one global refinement, interface refinement twice before
the first step and after every 2 steps, 10 steps.

The JAX package counts nothing per step inside its compiled solves, so
its inner FGMRES (the A-solve, the one fgmres call of
openifem_tpu/solvers/fluid/insim.py) is wrapped here, in the test, with a
jax.debug.callback that records each solve's iterations; the JAX package
itself is unchanged.

Recorded: per step, in f64 the JAX package takes 862, 761, 821, 752, 846,
1035, 947, 774, 1095, 1253 inner iterations and the port the same but
for steps 3 and 10 (one and two more: an inner solve's stopping test
sits on its threshold); with the bench knobs (bf16 A block, f32 solves,
whose products the two packages round in different orders) the JAX
package takes 256, 217, 238, 242, 217, 265, 269, 219, 263, 322 and the
port 270, 232, 237, 242, 231, 267, 286, 237, 280, 334.  The test holds
the port to these differences exactly, and holds the JAX package's own
counts to their growth over the 10 steps: the inner A-solve counts grow
in the JAX package's own solve at this size, and the port follows them.
"""

import jax
import pytest

from openifem_tpu.solvers.fluid import insim as jax_insim
from torch_parity import leaflet_fsi

N_STEPS = 10
# port minus JAX package, inner A-solve iterations per step
RECORDED_DIFFERENCE = {False: [0, 0, 1, 0, 0, 0, 0, 0, 0, 2],
                       True: [14, 15, -1, 0, 14, 2, 17, 18, 17, 12]}


def _jax_inner_counts(monkeypatch):
    """Wrap the JAX package's inner FGMRES: returns the list its solves'
    iterations are appended to."""
    calls, real = [], jax_insim.fgmres

    def counting(*args, **kw):
        res = real(*args, **kw)
        jax.debug.callback(lambda it: calls.append(int(it)), res.iters)
        return res
    monkeypatch.setattr(jax_insim, "fgmres", counting)
    return calls


def _per_step_marks(fsi, calls):
    """len(calls) after each step of fsi.run (the callbacks flushed)."""
    marks = []

    def marked(step):
        def run(*args, **kw):
            out = step(*args, **kw)
            jax.effects_barrier()
            marks.append(len(calls))
            return out
        return run
    fsi._run_fluid_step = marked(fsi._run_fluid_step)
    fsi.run_one_coupled_step = marked(fsi.run_one_coupled_step)
    return marks


@pytest.mark.parametrize("bench_precision", [False, True],
                         ids=["f64", "bench_knobs"])
def test_adaptive_leaflet_inner_a_counts(bench_precision, monkeypatch,
                                         tmp_path):
    monkeypatch.chdir(tmp_path)
    kw = dict(n_steps=N_STEPS, config="fsi_leaflet", refine_every=2,
              bench_precision=bench_precision)
    calls = _jax_inner_counts(monkeypatch)
    jfsi = leaflet_fsi(False, **kw)
    marks = _per_step_marks(jfsi, calls)
    jfsi.run(verbose=False)
    bounds = [0] + marks
    jax_counts = [sum(calls[a:b]) for a, b in zip(bounds, bounds[1:])]
    pfsi = leaflet_fsi(True, **kw)
    pfsi.run(verbose=False)
    port_counts = [s["krylov"]["a"] for s in pfsi.step_log]
    assert len(port_counts) == len(jax_counts) == N_STEPS
    assert pfsi.fluid.mesh.n_cells == jfsi.fluid.mesh.n_cells
    assert [p - j for p, j in zip(port_counts, jax_counts)] == \
        RECORDED_DIFFERENCE[bench_precision], (port_counts, jax_counts)
    assert jax_counts[-1] > 1.3 * jax_counts[1], jax_counts
