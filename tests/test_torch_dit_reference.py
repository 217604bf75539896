"""The port's DiT3D against the benchmark's plain reference
(``perfbench/reference/dit.py``) on seeded random weights with every layer
drawn non-zero: the forward, the preconditioned score and the energy's
gradient, the generic exact trace, and a short ``integrate_sde`` run read by
the exact-trace cell's check (``perfbench/checks_exact.py``), which a
planted fault must fail. Also the spans the trace and the net record, and
the frozen product count of the aldp cell's ``mfu_pct.aldp``.

On the CPU at a small size (2 blocks, hidden 32, 4 heads, 6 atoms, float32);
one case on the card at the published widths."""

import contextlib
import json
import math
import types
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import checks as C
from perfbench import controls_exact, port
from perfbench.checks_exact import check_exact_integration
from perfbench.drivers import sample_exact
from perfbench.frozen import dit_counts
from perfbench.reference import dit as RD
from perfbench.reference import egnn as R
from pita_torch.nets import DiT3DBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.ops.divergence import exact_divergence, exact_divergence_replicated
from pita_torch.sampler import IntegratorConfig, integrate_sde
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.utils import tracing
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N = 6
SMALL = dict(hidden=32, cond=32, n_blocks=2)
HEADS = 4
SIGMA = dict(sigma_min=0.01, sigma_max=80.0, rho=7.0)
GAMMA = 1200.0 / 755.95
LIMITS = {"x_gap": 0.05, "a_gap": 0.05}


def _port(weights, dtype=torch.float32, n=N, heads=HEADS, device="cpu"):
    bb = DiT3DBackbone(n_particles=n, hidden_size=weights["embed.weight"].shape[0],
                       cond_dim=weights["sigma_map.mlp1.weight"].shape[0], n_heads=heads,
                       n_blocks=sum(k.endswith(".qkv.weight") for k in weights),
                       compute_dtype=dtype).to(device)
    port.load(bb, {k: v.to(device) for k, v in weights.items()})
    return bb


def _ref(weights, precision="f32", n=N, heads=HEADS, device="cpu"):
    return RD.DiT3D({k: v.to(device) for k, v in weights.items()}, n, heads,
                    sum(k.endswith(".qkv.weight") for k in weights), precision)


def _inputs(B=8, seed=0, n=N, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((B, n * 3), generator=g)
    t = torch.rand(B, generator=g) * 0.9 + 0.05
    return x.to(device), t.to(device), torch.tensor(1.0, device=device)


def _close(a, b, rel):
    a, b = a.detach(), b.detach()
    assert float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) <= rel


def _pair_readings(kind, bb, ref, x, t, beta, sched):
    ht = sched.h(t)
    if kind == "forward":
        return bb(0.125 * torch.log(ht), x, beta), ref(0.125 * torch.log(ht), x, beta)
    if kind == "score":
        with torch.no_grad():
            return ScoreWrapper(bb).score(ht, x, beta), R.score(ref, ht, x, beta)
    grads = []
    for energy in (lambda xx: EnergyWrapper(bb).energy(ht, xx, beta),
                   lambda xx: R.energy(ref, ht, xx, beta)):
        xx = x.detach().requires_grad_(True)
        grads.append(torch.autograd.grad(energy(xx).sum(), xx)[0])
    return grads


@pytest.mark.parametrize("kind", ["forward", "score", "energy_grad"])
def test_port_dit_matches_the_reference(kind):
    w = RD.draw_weights(11, **SMALL)
    x, t, beta = _inputs()
    sched = R.Elucidating(**SIGMA)
    with R.strict_f32():
        got, want = _pair_readings(kind, _port(w), _ref(w), x, t, beta, sched)
    assert want.abs().max() > 1e-3  # every layer drawn non-zero: the net's part is not 0
    _close(got, want, 2e-5)


def test_exact_divergence_on_the_dit_matches_the_reference_trace():
    w = RD.draw_weights(12, **SMALL)
    x, t, beta = _inputs(B=5, seed=1)
    sched = ElucidatingNoiseSchedule(**SIGMA)
    score = ScoreWrapper(_port(w))
    with R.strict_f32():
        got = exact_divergence(lambda tq, xq: score.score(sched.h(tq), xq, beta), t, x)
        want = RD.exact_div(_ref(w), R.Elucidating(**SIGMA), x, t, beta, block=2)
    closed = -x.shape[1] / (1 + sched.h(t))  # the preconditioning's part of the trace
    assert (want - closed).abs().max() > 1e-2
    _close(got, want, 2e-5)


def test_the_exact_trace_and_the_dit_record_their_spans():
    """Two passes of 16 and 2 one-hot rows at D = 18, each a
    `divergence.exact_pass` (one batched backward), after one `dit.forward`
    of the B chains, which lies outside the passes and inside the caller's
    span; with the chains in chunks, one forward and two passes a chunk;
    none without a profiler."""
    w = RD.draw_weights(13, **SMALL)
    x, t, beta = _inputs(B=3, seed=2)
    score = ScoreWrapper(_port(w))
    f = lambda tq, xq: score.score(tq + 1.0, xq, beta)
    tracing.clear()
    exact_divergence(f, t, x)
    assert tracing.spans() == []
    for chunk, chains in ((None, [3]), (2, [2, 1])):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("sampler.divergence"):
                exact_divergence(f, t, x, chunk_size=chunk)
        r = tracing.spans()
        tracing.clear()
        passes = [s for s in r if s.name == "divergence.exact_pass"]
        assert [s.attrs for s in passes] == [{"rows": n * b, "chains": b}
                                             for b in chains for n in (16, 2)]
        dits = [s for s in r if s.name == "dit.forward"]
        assert [s.attrs for s in dits] == [{"rows": b} for b in chains]
        assert [r[s.parent].name for s in dits + passes] == ["sampler.divergence"] * 3 * len(chains)
        for k, d in enumerate(dits):  # the chunk's forward ends before its passes start
            assert d.end_ns <= passes[2 * k].start_ns


def _integration(seed=5, B=16, n_steps=4, end=3):
    """One short run of the sampler on the small DiT pair, observed as the
    exact-trace cell's driver observes it, and the check's readings."""
    ws = [RD.draw_weights(seed * 2 + k, **SMALL) for k in (1, 2)]
    rec = port.Recorder()
    score = ScoreWrapper(_port(ws[0]))
    energy = port.observed_energy(_port(ws[1]), rec)
    sched = ElucidatingNoiseSchedule(**SIGMA)
    cfg = IntegratorConfig(num_integration_steps=n_steps, end_resampling_step=end,
                           resampling_interval=1, should_mean_free=True,
                           divergence_mode="exact", post_mcmc_steps=0)
    target = types.SimpleNamespace(is_molecule=True, n_particles=N, n_spatial_dim=3)
    gen = torch.Generator().manual_seed(seed)
    x1 = R.remove_mean(torch.randn((B, N * 3), generator=gen)
                       * math.sqrt(float(sched.h(torch.tensor(1.0))) / GAMMA), N)
    log = dict(port.new_log(), resampled_on=[])
    with sample_exact.recording_resamples(log):
        rec.on = True
        res = integrate_sde(x1, score, energy, sched, ConstantAnnealingSchedule(GAMMA), target,
                            1.0, cfg, draws=port.recording_draws(gen, log), device="cpu")
    it = dict(states=rec.take(), x1=x1, samples=res.samples, logweights=res.logweights,
              log=log, n_steps=n_steps, end_resampling=end)
    out = C.Readings()
    with R.strict_f32():
        check_exact_integration(it, [_ref(w, "f32") for w in ws], R.Elucidating(**SIGMA), GAMMA,
                                torch.tensor(1.0), LIMITS, out, N, block=8)
    return out


@pytest.mark.parametrize("fault", [None] + sorted(controls_exact.FAULTS))
def test_the_exact_trace_check_passes_a_sound_run_and_fails_a_planted_fault(fault):
    if fault is None:
        out = _integration()
    else:
        with controls_exact.FAULTS[fault]():
            out = _integration()
    ok = out.x_gap <= LIMITS["x_gap"] and out.a_gap <= LIMITS["a_gap"] and out.misses == 0
    assert ok == (fault is None), (out.x_gap, out.a_gap, out.misses, out.notes)
    if fault is None:
        assert out.counts["steps"] == 4 and out.counts["a_rows"] == 3 * 16


def test_the_frozen_dit_count_gives_the_recorded_reading():
    assert dit_counts.dit_forward_macs() == 27_433_472
    assert dit_counts.dit_forward_macs(n_blocks=1) - dit_counts.dit_forward_macs(n_blocks=0) \
        == 22 * 196_608 + 123_904 + 98_304
    assert dit_counts.dit_forward_macs(n_blocks=0) == 147_968
    assert dit_counts.forwards_per_chain_step(66) == 135
    cfg = json.loads((ROOT / "perfbench/configs/aldp_dit3d_bf16.json").read_text())
    assert dit_counts.flops_per_chain_step(cfg) == 135 * 2 * 27_433_472


@pytest.mark.cuda
def test_port_dit_on_the_card_matches_the_reference_at_the_published_widths():
    """bf16 block products on the card, 64 chains, 22 atoms: the score, the
    energy's gradient and the exact trace against the reference with the
    products' inputs rounded to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    w = RD.draw_weights(21)
    x, t, beta = _inputs(B=64, seed=3, n=22, device="cuda")
    sched = R.Elucidating(**SIGMA)
    bb = _port(w, torch.bfloat16, n=22, heads=8, device="cuda")
    ref = _ref(w, "bf16", n=22, heads=8, device="cuda")
    with R.strict_f32():
        for kind in ("score", "energy_grad"):
            got, want = _pair_readings(kind, bb, ref, x, t, beta, sched)
            _close(got, want, 2e-2)
        score = ScoreWrapper(bb)
        got = exact_divergence(lambda tq, xq: score.score(sched.h(tq), xq, beta), t, x)
        want = RD.exact_div(ref, sched, x, t, beta, block=16)
    _close(got, want, 2e-2)


@contextlib.contextmanager
def no_batching_fallback():
    """A vmap that falls back to its loop over the batch, for want of an op's
    batching rule, raises: PyTorch warns of it ("... not yet implemented the
    batching rule for ...") only with its fallback warnings on, which are off
    by default, in torch.func's vmap and in the older one behind
    ``autograd.grad(is_grads_batched=True)``."""
    legacy = torch._C._debug_only_are_vmap_fallback_warnings_enabled()
    torch._C._debug_only_display_vmap_fallback_warnings(True)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        torch._C._debug_only_display_vmap_fallback_warnings(legacy)


@pytest.mark.cuda
def test_both_exact_trace_forms_agree_on_the_card_at_the_cells_size():
    """The aldp cell's DiT3D (published widths, bf16 block products) at its
    1,024 chains: the one-forward trace against the replicated one, with no
    batching-rule fallback on the card; each form's peak memory printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    w = RD.draw_weights(22)
    x, t, beta = _inputs(B=1024, seed=4, n=22, device="cuda")
    sched = R.Elucidating(**SIGMA)
    score = ScoreWrapper(_port(w, torch.bfloat16, n=22, heads=8, device="cuda"))
    f = lambda tq, xq: score.score(sched.h(tq), xq, beta)
    got = {}
    for form in (exact_divergence, exact_divergence_replicated):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with no_batching_fallback():
            got[form.__name__] = form(f, t, x)
        torch.cuda.synchronize()
        print(f"{form.__name__}: peak {torch.cuda.max_memory_allocated() - held} bytes "
              f"above the {held} held")
    new, rep = got["exact_divergence"], got["exact_divergence_replicated"]
    print(f"largest gap {float((new - rep).abs().max())} of {float(rep.abs().max())}")
    _close(new, rep, 2e-3)
