"""The program's spans (``pita_torch/utils/tracing.py``): the gate, the
tree the sampler and the trainer record, the same numbers with spans on and
off, and the benchmark's reading of them against a device trace
(``perfbench/spans.py``). The tests marked ``cuda`` need a card and skip
without one; this file imports neither JAX nor pita_tpu, so on the card it
runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import spans as S
from pita_torch.configs import build_trainer, compose
from pita_torch.nets import EGNNBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.sampler import IntegratorConfig, integrate_sde
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import LJ13
from pita_torch.utils import tracing
from pita_torch.utils.tracing import span
from torch_threads import one_intra_op_thread  # noqa: F401

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def test_off_spans_record_nothing_and_share_one_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = span("a", step=1), span("b")
    assert a is b
    with a, span("c"):
        pass
    assert tracing.spans() == []


def test_on_spans_nest_with_parents_and_request_ids():
    with profile(activities=CPU):
        with span("root", k=1):
            with span("child"):
                with span("leaf"):
                    pass
            with span("child"):
                pass
        with span("root", k=2):
            pass
    r = tracing.spans()
    assert [(s.name, s.parent, s.request) for s in r] == [
        ("root", None, 0), ("child", 0, 0), ("leaf", 1, 0), ("child", 0, 0), ("root", None, 1)]
    assert r[0].attrs == {"k": 1} and r[4].attrs == {"k": 2}
    for s in r:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = r[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # outside the session nothing more is recorded
    with span("late"):
        pass
    assert len(tracing.spans()) == 5


def test_spans_lie_on_the_profilers_clock():
    """A profiler range opened inside a span starts and ends inside it: both
    are unix ns."""
    with profile(activities=CPU) as prof:
        with span("outer"):
            with record_function("inner_range"):
                torch.ones(8).sum()
    (s,) = tracing.spans()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range"]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def _nets(seed):
    torch.manual_seed(seed)
    return (ScoreWrapper(EGNNBackbone(13, hidden_nf=8, n_layers=1)),
            EnergyWrapper(EGNNBackbone(13, hidden_nf=8, n_layers=1)))


CFG = IntegratorConfig(num_integration_steps=6, end_resampling_step=5, resampling_interval=2,
                       divergence_mode="hutchinson", hutchinson_probes=2,
                       divergence_update_interval=3, ess_resampling_threshold=0.5)


def _integrate(traced, seed=0):
    score, energy = _nets(seed)
    x1 = torch.randn((8, 39), generator=torch.Generator().manual_seed(seed)) * 2.0
    args = (x1, score, energy, ElucidatingNoiseSchedule(sigma_min=0.05, sigma_max=10.0, rho=7.0),
            ConstantAnnealingSchedule(annealing_factor=1.2), LJ13(temperature=2.0), 1.0, CFG)
    if not traced:
        return integrate_sde(*args, seed=seed + 1, device="cpu")
    with profile(activities=CPU):
        return integrate_sde(*args, seed=seed + 1, device="cpu")


def test_integrate_sde_records_one_step_span_a_step_with_its_children():
    _integrate(traced=True)
    r = tracing.spans()
    root = r[0]
    assert (root.name, root.parent, root.attrs) == ("sampler.integrate", None,
                                                     {"chains": 8, "steps": 6})
    assert {s.request for s in r} == {0}
    steps = [i for i, s in enumerate(r) if s.name == "sampler.step"]
    assert [r[i].attrs for i in steps] == [
        {"step": i, "rediv": i % 3 == 0, "resample": i < 5 and i % 2 == 1} for i in range(6)]
    assert all(r[i].parent == 0 for i in steps)
    for i in steps:
        kids = [s.name for s in r if s.parent == i]
        assert all(s.parent in steps for s in r if s.parent == i)
        want = {"sampler.energy_grad": 1, "sampler.score": 1, "sampler.weights": 2,
                "sampler.update": 3, "sampler.divergence": int(r[i].attrs["rediv"]),
                "sampler.resample": int(r[i].attrs["resample"])}
        assert {k: kids.count(k) for k in want} == want and len(kids) == sum(want.values())
    (div,) = [s for s in r if s.name == "sampler.divergence"][:1]
    assert div.attrs == {"mode": "hutchinson"}
    # nothing below a step's children
    assert not [s for s in r if s.parent is not None and r[s.parent].name not in
                ("sampler.integrate", "sampler.step")]


def test_integrate_sde_gives_the_same_numbers_with_spans_on_and_off():
    off, on = _integrate(traced=False), _integrate(traced=True)
    assert tracing.spans()
    for a, b in zip(off, on):
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert torch.equal(a, b)


def _trainer(tmp_path, name):
    ov = {"trainer.temperatures": (4.0, 3.0), "trainer.num_epochs_per_temp": (2,),
          "trainer.buffer_capacity": 512, "net.hidden_nf": 8, "net.n_layers": 1,
          "trainer.init_from_prior": True, "trainer.num_init_samples": 64,
          "out_dir": str(tmp_path / name)}
    tr = build_trainer(compose("lj13", debug="short", overrides=ov), device="cpu")
    tr.populate_initial_buffer()
    return tr


def test_train_step_records_its_tree_and_the_same_parameters(tmp_path):
    off, on = _trainer(tmp_path, "off"), _trainer(tmp_path, "on")
    off.train_step(0)
    with profile(activities=CPU):
        on.train_step(0)
    for p, q in zip(off.params, on.params):
        assert torch.equal(p, q)
    for p, q in zip(off.ema_score.module.parameters(), on.ema_score.module.parameters()):
        assert torch.equal(p, q)
    r = tracing.spans()
    assert (r[0].name, r[0].parent, r[0].attrs) == ("train.step", None, {"rung": 0})
    assert [(s.name, s.parent) for s in r[1:]] == [
        (n, 0) for n in ("train.batch", "train.losses", "train.backward", "train.optimizer",
                         "train.ema")]


def _rec(name, parent, t0, t1, request=0):
    return tracing.Span(name, parent, request, int(t0 * 1e3), int(t1 * 1e3), {})


def test_the_benchmark_splits_each_idle_gap_by_its_overlap_with_the_spans():
    """Kernels busy [0, 10], [12, 20], [30, 31], [31, 40]: gaps (10, 12) and
    (20, 30) µs. Two steps, each with children a and b."""
    kernels = [("k", 0.0, 10.0), ("k", 12.0, 20.0), ("k", 30.0, 31.0), ("k", 31.0, 40.0)]
    recs = [_rec("step", None, 5, 25), _rec("a", 0, 5, 11), _rec("b", 0, 11, 21),
            _rec("step", None, 25, 35, 1), _rec("a", 3, 25, 28, 1), _rec("b", 3, 29, 35, 1)]
    out = S.summarise(recs, kernels)
    assert out["gaps"] == [(10.0, 12.0), (20.0, 30.0)]
    assert out["idle"] == {"step": 2 + 10, "a": 1 + 3, "b": 1 + 1 + 1}
    assert out["idle_children"] == {"step": 7} and out["kids"] == {"step": ["a", "b"]}
    assert out["idle_any"] == 12
    assert out["ms"]["step"] == [0.02, 0.01]
    ctx = {"program_spans": out}
    assert S.idle_ms(ctx, "a", "step") == pytest.approx(4 / 1e3 / 2)
    assert S.idle_ms(ctx, "c", "step") is None
    assert S.step_ms(ctx, "step") == pytest.approx(0.015)


def test_the_benchmark_reads_nothing_without_spans(capsys):
    ctx = {"reading": {"kernels": [("k", 0.0, 1.0), ("k", 2.0, 3.0)]}}
    assert S.idle_ms(ctx, "sampler.score", "sampler.step") is None
    assert S.step_ms(ctx, "sampler.step", q=95) is None
    assert "no spans" in capsys.readouterr().err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_record_under_a_cuda_only_profiler(cuda):
    with profile(activities=[ProfilerActivity.CUDA]):
        with span("sampler.step"):
            torch.ones(4, device=cuda).sum()
    assert [s.name for s in tracing.spans()] == ["sampler.step"]


@pytest.mark.cuda
def test_a_kernel_synchronised_inside_a_span_lies_inside_it_on_the_trace(cuda):
    """A spin kernel launched and waited for inside a span: its device
    interval on the trace's clock lies within the span's, within 20 µs."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with span("wait"):
                torch.cuda._sleep(200_000)
                torch.cuda.synchronize()
            time.sleep(0.001)
    got = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA and "spin" in e.name())
    recs = tracing.spans()
    assert len(got) == len(recs) == 5
    for (k0, k1), s in zip(got, recs):
        print(f"kernel starts {(k0 - s.start_ns) / 1e3:.1f} µs after the span, "
              f"ends {(s.end_ns - k1) / 1e3:.1f} µs before its end")
        assert k0 >= s.start_ns - 20_000 and k1 <= s.end_ns + 20_000
