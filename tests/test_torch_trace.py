"""The port's tracer (utils/timer.py span, count, host_read, recording) on
the cylinder stepper at refine 1 with the bench knobs of the "r3" path
(the Schur CG preconditioned by the pressure V-cycle) and the "r4" path
(one V-cycle as Sm^-1), on the CPU: tracing changes no bit and no count,
records nothing while off, nests its spans, counts one "newton" span per
Newton iteration and one "inner_*" span of each kind per preconditioner
apply, and puts a "sync" span and counter on every host read of the
stepper (count_host_syncs, counting every tensor, sees no other).  An
MPIFSI without a step_span hook records the parts of its steps as tracer
spans."""

import os

import pytest
import torch

from openifem_tpu_torch.cases import fluid_cylinder as fc
from openifem_tpu_torch.cases.fsi_leaflet import port_package
from openifem_tpu_torch.utils import timer
from openifem_tpu_torch.utils.timer import count_host_syncs

os.environ.setdefault("OPENIFEM_DEVICE", "cpu")

STEPS = 2
CHILDREN = {"newton": "step", "assemble": "newton",
            "precond_build": "newton", "outer_fgmres": "newton",
            "inner_mp": "outer_fgmres", "inner_sm": "outer_fgmres",
            "inner_a": "outer_fgmres"}


def _window(fl, x0):
    """STEPS stepper steps from x0, one per call: (state, per-step Newton
    counts, Krylov counts)."""
    stepper, k0 = fl.make_on_device_stepper(), dict(fl.krylov_iters)
    x, newton = x0, []
    for _ in range(STEPS):
        x, _, its = stepper(x, 1)
        newton.append(its)
    return x, newton, {k: v - k0[k] for k, v in fl.krylov_iters.items()}


@pytest.fixture(scope="module", params=["r3", "r4"])
def runs(request):
    """The case built and its host first step taken under the tracer, then
    the same window from the same state untraced and traced (the traced
    one also under count_host_syncs counting every tensor)."""
    with timer.recording() as setup:
        fl = fc.cylinder_case(port_package(), request.param, refine=1,
                              n_steps=10, device="cpu")
        fl.run_one_step(True, verbose=False)
    x0 = fl.present_solution.clone()
    off = _window(fl, x0)
    with count_host_syncs(lambda t: True) as reads:
        with timer.recording() as rec:
            on = _window(fl, x0)
    return dict(setup=setup, rec=rec, off=off, on=on, reads=reads["syncs"])


def test_tracing_changes_no_bit_and_no_count(runs):
    (x_off, newton_off, k_off), (x_on, newton_on, k_on) = \
        runs["off"], runs["on"]
    assert torch.equal(x_off, x_on)
    assert newton_off == newton_on and k_off == k_on
    assert k_on["applies"] > 0


def test_nothing_is_recorded_while_off(runs):
    rec = runs["rec"]
    n_spans, counts = len(rec.spans), dict(rec.counts)
    assert timer._REC is None
    assert timer.span("step") is timer.span("sync") is \
        timer.host_read("cg_test")
    fl = fc.cylinder_case(port_package(), "r1", refine=1, n_steps=2,
                          device="cpu")
    fl.run_one_step(True, verbose=False)
    fl.make_on_device_stepper()(fl.present_solution, 1)
    assert len(rec.spans) == n_spans and dict(rec.counts) == counts


def test_spans_nest(runs):
    spans = runs["rec"].spans
    assert [s.name for s in spans if s.parent < 0] == ["step"] * STEPS
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.step == p.step
        if s.name in CHILDREN:
            assert spans[s.parent].name == CHILDREN[s.name], s
        if s.name == "sync":
            assert spans[s.parent].name in (
                "assemble", "outer_fgmres", "inner_mp", "inner_sm",
                "inner_a"), s
    assert sorted({s.step for s in spans}) == list(range(STEPS))


def test_setup_spans(runs):
    """mesh, setup, pressure_mg and first_step are the top-level spans of
    building the case and its host first step; the first step holds the
    Newton iterations, before the first stepper step."""
    spans = runs["setup"].spans
    top = [s.name for s in spans if s.parent < 0]
    assert top == ["mesh", "mesh", "setup", "pressure_mg", "first_step"]
    assert all(s.step == -1 for s in spans)
    newton = [s for s in spans if s.name == "newton"]
    assert newton and all(spans[s.parent].name == "first_step"
                          for s in newton)


def test_one_newton_span_per_newton_iteration(runs):
    spans = runs["rec"].spans
    _, newton, _ = runs["on"]
    for k in range(STEPS):
        assert sum(s.name == "newton" and s.step == k
                   for s in spans) == newton[k]


@pytest.mark.parametrize("name", ["inner_mp", "inner_sm", "inner_a"])
def test_one_inner_span_per_preconditioner_apply(runs, name):
    _, _, krylov = runs["on"]
    assert sum(s.name == name for s in runs["rec"].spans) == \
        krylov["applies"]


def test_sync_counters_cover_every_host_read(runs):
    rec = runs["rec"]
    syncs = {k: v for k, v in rec.counts.items() if k.startswith("sync.")}
    assert sum(syncs.values()) == runs["reads"]
    assert sum(s.name == "sync" for s in rec.spans) == runs["reads"]
    _, _, krylov = runs["on"]
    # one loop test per CG iteration and per solve; one Hessenberg column
    # per FGMRES iteration
    assert syncs["sync.cg_test"] >= krylov["mp"] + krylov["sm"]
    assert syncs["sync.fgmres_hcol"] == krylov["outer"] + krylov["a"]
    assert syncs["sync.newton_res"] == sum(runs["on"][1])


def test_totals_count_a_name_nested_in_itself_once():
    with timer.recording() as rec:
        with timer.span("a"):
            with timer.span("a"):
                with timer.span("b"):
                    pass
            timer.count("n", 2)
    (outer, inner, b) = rec.spans
    assert (outer.parent, inner.parent, b.parent) == (-1, 0, 1)
    totals = rec.totals()
    n, inclusive, own = totals["a"]
    assert n == 2 and inclusive == outer.end_ns - outer.start_ns
    assert own == inclusive - (b.end_ns - b.start_ns)
    assert rec.counts == {"n": 2}
    with pytest.raises(RuntimeError):
        with timer.recording():
            with timer.recording():
                pass
    assert timer._REC is None


def test_coupler_step_spans_go_to_the_tracer():
    """An MPIFSI without a step_span hook records the parts of its
    per-phase steps as tracer spans, with the fluid's own spans inside
    "fluid Newton"."""
    from openifem_tpu_torch.cases.mpi_block import block_case
    fsi = block_case(port_package(), "body_force", n_steps=2, device="cpu")
    with timer.recording() as rec:
        fsi.run(verbose=False)
    spans = rec.spans
    top = [s.name for s in spans if s.parent < 0 and s.name != "mesh"]
    assert top == ["coupling", "solid", "coupling", "coupling",
                   "fluid Newton"] * 2
    assert all(spans[s.parent].name == "fluid Newton"
               for s in spans if s.name == "outer_fgmres")
