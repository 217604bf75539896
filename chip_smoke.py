#!/usr/bin/env python3
"""Drive the PyTorch port's LJ55 sampling and training paths, its alanine-peptide
path, its GMM, DW4 and other presets, its sharded and data-parallel paths and
FAB on one NVIDIA GPU (H100).

Usage, from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing lines, each failing the run on disagreement:
  1. build the CUDA kernels of pita_torch/csrc/ with nvcc (sm_90a), one
     nvcc per source, all started together;
  2. K1 (LJ log_prob + force) against its plain version, LJ55 with the
     spline and LJ13 without, 2048 configurations, the first K1 too, the new
     one launched twice for a bitwise-equal result; then the new K1 and the
     first one timed in turns at LJ55's 256, 512 and 2048 chains and LJ13's
     512: device time alone (torch.profiler), CUDA-event time a launch and
     the wrapper's host time a call (1,000 calls, no synchronization), and
     the new K1's device time at every lane count beside the rule's pick;
  3. K2 (EGCL forward) against layer_step and K3 (EGCL VJP) against autograd
     through layer_step: bench weights, each of the 3 layers, 2048 chains,
     N=55, in f32 (the 3xTF32 K2 and K3) and bf16 (the tensor-core K2 and
     K3); the tensor-core kernels also on first-step inputs (prior samples
     at t = 1), at the Hutchinson launch's 4096 chains and at LJ13's N = 13;
     the f32 K2 at the fill's 256 chains, the DEM refill's 2,000 and 2,048,
     and the f32 K3 at the fill's 256 and 2,048, the 3xTF32 kernel and the
     scalar yardstick each against the plain version, the 3xTF32 one
     launched twice for a bitwise-equal result and both timed in turns; the
     3xTF32 K3 also on first-step inputs and at LJ13's N = 13; every K2 and
     K3 timed, the scalar K2 also in bf16 beside the tensor-core one;
  4. the first main path, timed: bench_lj55.npz through the port's decoder,
     the hutch_ess_k10 configuration of bench.py at 2048 chains x 100 steps
     after one warm-up; it must launch the tensor-core K2 (630 times) and K3,
     and the scalar K2 and K3 never;
  5. its quality run: 512 chains x 400 steps, final resample, 30 adaptive
     MALA steps; energy W2 against the ground-truth samples and against the
     exact-divergence population of bench_lj55_exact_energies.npy; the K1
     counter must move, the first K1's not; fails on non-finite samples or
     W2 > 2 sigma_GT;
  6. K5 (G-operator contraction, the tensor-core kernel) against its plain
     version (materialized G, bf16-rounded, f32 einsum): primals of layers 1
     and 2 of the bench score net at t = 0.5 on perturbed ground-truth samples
     and on first-step inputs (prior samples at t = 1), 64 chains x 165
     tangents, and near-integer inputs exactly; then at the main path's
     launch, a chunk of 256 chains x 165 tangents: compared (the scalar K5
     too), launched twice for a bitwise-equal result, and timed in turns with
     the scalar K5 beside a torch.bmm yardstick;
  7. K4 (EGCL layer tangent) against its plain version: each layer in f32
     (the 3xTF32 K4) and bf16 (the tensor-core K4) on the tangents the trace
     gives it, 64 chains x 64 tangents; then the whole forward-mode trace
     against the edge-operator trace; then the tensor-core K4 compared at the
     main path's launches, 256 chains x a super-chunk of 64 tangents and x
     the ragged last one of 37, launched twice for a bitwise-equal result at
     the first and timed there in turns with the scalar K4 in bf16; the f32
     K4 at the fill's 64 chains and at 256, x 64 tangents: the 3xTF32 kernel
     and the scalar yardstick against the plain version, the 3xTF32 one
     launched twice for a bitwise-equal result, both timed in turns, the
     recounted bound with its terms;
  8. end-to-end wiring of the exact divergence: 64 chains x 8 steps with the
     weights accumulating in every step and resampling never firing, same
     draws: the K5 route and the K4 route each against the materialized-G
     route; samples identical, final log-weights within tolerance, with the
     bf16 and with an f32 backbone (whose runs must launch the 3xTF32 K2
     and K3 and, on the K4 route, the 3xTF32 K4, and the scalar K2, K3 and
     K4 never; the bf16 runs no scalar kernel; no run the scalar K5);
     then the trace by the three routes on a full-width backbone with
     random weights, where the G-operator term is not as small as on the
     trained ones; the bf16 runs of the K4 route must launch the tensor-core
     K4 alone, the f32 runs the 3xTF32 K4 alone;
  9. the second main path, timed: quadrature_k10 of bench.py (exact
     divergence every 10th step, resampling every step, chain chunks of 256)
     at 2048 chains x 100 steps once per route, each after a 10-step warm-up,
     the tensor-core K2 and K4/K5 counters must move, the K5 route must
     launch the tensor-core K5 once per evaluation and chain chunk (80 times)
     and the scalar K5 never, the K4 route the tensor-core K4 nine times per
     evaluation and chain chunk (720 times) and the scalar K4 never; then
     exact (every step) at 256 chains x 100 steps per kernel route;
 10. the exact-divergence quality run: quadrature_k10 on the faster kernel
     route, 512 chains x 400 steps, final resample, 30 MALA steps; both arms
     of the gate of phase 5 must pass;
 11. the LJ55 training ladder through pita_torch.configs.build_trainer (the
     lj55 preset: N = 55, hidden 32, 3 layers, f32): the rung-0 train set by
     generate_lj_dataset (512 chains, 12,000 warmup steps; K1 must launch,
     the first K1 never), then the same generator timed by each K1 in turns,
     2 epochs x 25 batches of 256 on the autograd route (finite losses, no
     kernel launched, one step on the card against the same step on the CPU
     at batch 64, and the EMA's kernel buffers repacked), one rung
     transition's fill by evaluate through the K4 route (256 chains x 100
     steps; K1 and the 3xTF32 K2, K3 and K4 must launch, no scalar K2, K3
     or K4 and no bf16 kernel; finite weights and energies; the
     rung-1 buffer filled; no escalated retry), K1 and the f32 K2/K3/K4
     compared and timed at those launches (K1's device time also by
     torch.profiler, which must find it; the 3xTF32 kernels in turns with
     the scalar ones), a fill step timed by each route and by the K4 route
     with the scalar f32 kernels (before), the f32 K4's launches over 10
     steps counted by torch.profiler against the counter, and a
     checkpoint saved, restored into a fresh trainer and compared bitwise,
     saved over, and a save interrupted before its rename;
 12. the training tools: DEM pretraining on the lj55 preset with the iDEM
     target through fit (2 epochs x 10 steps of 512 chains x 1,000 probes:
     K1 once a step at 512,000 configurations; one plain-SDE refill of
     buffer 0, 2,000 chains x 1,000 steps: the 3xTF32 K2 3,000 times and no
     K3, K4, scalar K2 or bf16 kernel; finite losses and val/dem metrics), a
     DEM step profiled, the iDEM target by K1 against its plain version on
     the first 8 chains, K1 at that launch and the f32 K2 at the refill's
     2,000 chains against their plain versions and timed (the 3xTF32 K2 in
     turns with the scalar one), a force-based pretraining loss on the card
     against the CPU, the refill's sampling timed in turns with the scalar
     f32 K2 (before) and the 3xTF32 one (after); 100 HMC steps of 10
     leapfrogs at T = 1 (K1 1,201 times, the first K1 never); the ten-run
     protocol of scripts/make_ground_truth.py for LJ55_temp_1.0_val (R-hat
     < 1.05, within that script's tolerance of the committed diagnostics);
     eval_cli on phase 11's checkpoint (256 chains x 100 steps, the K4
     route, one ladder pair), train_cli -m over two seeds and train_cli with
     a YAML overlay (geometric schedule, score only), LJ13 debug=short cut
     to 2 epochs without the test phase;
 13. the alanine-peptide path (no kernel of the port's; the force field, MD
     and the DiT3D are plain PyTorch, as pita_tpu runs them in XLA): the
     force field's energies and forces on the card against the CPU (the 800
     frames of aldp_md_T300.npz, and aldp, al3, al4 minimized under 1e-3 nm
     noise, 2,048 each; tol 1e-5) and against the committed MD energies
     (5e-3 kcal/mol), timed at 2,048; generate_md_cli at 1,200 K (32
     replicas, 500 steps) and 100 BAOAB steps, card against CPU, from the
     same normals (1e-4 nm); the aldp ladder through build_trainer and fit
     at the preset's full DiT3D width on train/val/test sets written by the
     port's MD (2 epochs x 10 batches of 2,048, one transition 1,200 ->
     755.95 K filled at 512 chains x 100 steps with the exact trace by D
     VJPs and 5 MALA steps): finite losses and val/rama, val/tica, val/ic
     metrics and chirality rates, the rung-1 buffer filled, none of the
     five kernels launched; a float32 step on the card against the CPU at
     batch 64 (1e-4), the checkpoint restored bitwise; a training step and
     a fill step profiled; train_cli experiment=al3 and
     alp_diffusion_baseline, debug=short, one epoch, no test phase.
 14. the GMM oracle and the presets, modes and nets of pita_tpu that run no
     kernel (pita_tpu computes them in XLA; no kernel may launch but K2/K3
     in the hutchpp run and K1 in the TorchMD-ET run's energies): the five
     runs of tests/test_annealing_oracle.py (GMM-40 annealed to the exact
     p², 2,048 chains x 1,000 steps; exact, hutchinson + 30 MALA,
     hutchinson with ESS 0.5, hutch_ess_k10, hutchpp) held to that test's
     bounds against exact draws of p², then hutch_ess_k10 over 8 more seeds
     with the count of far-off samples; on the LJ55 bench pair Hutch++ at
     rank 165 against the edge-operator trace, a hutchpp run (rank 16, 256
     chains x 20 steps; K2 and K3 launch, K4 and K5 not), the score-free
     exact Laplacian card against CPU and a 64 x 8 score-free run, a
     pinned run through the final resample; train_cli with no experiment
     (gmm: 2 epochs x 10 batches of 512, a transition filled at 2,048
     chains x 1,000 steps) and experiment=dw4 (MALA sets, a fill at 512 x
     1,000 through the 2-D edge operators), a step of each card against
     CPU; TorchMD-ET's forward at 2,048 LJ55 configurations and train_cli
     experiment=lj13 net.kind=torchmd_et; cnf_nll on a Gaussian against the
     closed form and on the GMM oracle card against CPU.
 15. pita_torch.parallel over NCCL at world size 1 (the one card; 2 and 4
     ranks are held against one process under gloo in the CPU tests) and
     FAB: sharded_integrate on the bench pair against integrate_sde with the
     same seed, hutch_ess_k10 at 2,048 chains x 100 steps timed in turns and
     512 x 100 with the final resample and 30 MALA steps, each pair bitwise
     equal with equal launches (K2, K3 and K1; no scalar, yardstick or
     exact-divergence kernel), and what one NCCL collective costs; one
     make_dp_train_step of the lj55 preset at batch 256 against the
     trainer's train_step on the same draws (1e-6 of the largest weight
     change) and both timed; ShardedBufferOps against the plain buffer at
     the preset's capacity; AIS to a normalized Gaussian at 2,048 chains
     (|log Z| < 0.1); FAB at pita_tpu's defaults on ManyWell-32: an inner
     step card against CPU, AIS calls and inner steps timed, 50 outer
     iterations of train_fab_with_prioritised_buffer, and AIS's log Z from
     the trained flow beside the exact one by quadrature.

Then one JSON line with every kernel's launches, error, times and bound,
and last {"ok": true, "device": {...}}. Any failure exits non-zero. TF32 is
off for matmuls and convolutions, so float32 stays float32.

Options for measurement runs: --kernels-only runs phases 1-3, 6 and 7 only;
--training-only runs phases 1 and 11 only; --tools-only runs phases 1 and
12 only (eval_cli then restores the DEM trainer's checkpoint);
--peptides-only runs phases 1 and 13 only; --oracle-only runs phases 1
and 14 only; --parallel-fab-only runs phases 1 and 15 only; --outlier-seed
S follows phase 5's quality run at seed S through the final resample and
MALA, K1 against the plain float64 energy at every state, and stops;
--profile adds a torch.profiler breakdown of each timed main path (for the
K5 route also its five largest PyTorch kernels) and of 5 training steps;
--quality-seeds K repeats phase 5 over seeds 0..K-1 (the gate holds seed 0).
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# an f32 product in 3xTF32 is three TF32 products (hi hi, hi lo, lo hi): the
# f32 EGCL kernels' products at a third of the TF32 dense peak
PEAK_3XTF32 = PEAK_TF32 / 3
# special-function units (exponential, reciprocal, tanh): 16 results per
# clock per SM, 132 SMs, at the H100 SXM's 1.98 GHz boost clock
PEAK_SFU = 132 * 16 * 1.98e9
# FP32 pipes: 128 lanes per SM, one operation (an FMA counts as one) a clock
PEAK_FP32_OPS = 132 * 128 * 1.98e9

# max |kernel − plain| / max |plain| allowed, per output tensor
TOL_LJ = 2e-4  # f32 sums over 54 neighbours in another order; autograd vs closed-form force
TOL_F32 = 2e-4  # EGCL f32: reassociated sums over 55 edges and 32 features
TOL_BF16 = 3e-2  # EGCL bf16: a value one f32 ulp apart can round to a neighbouring bf16
TOL_GOP = 2e-2  # K5: G and Bv rounded to bf16 in both, G from f32 values an ulp apart
# a trace or a run's log-weights with bf16-rounded tangents (K4) or G (K5)
# against the f32 algebra: one rounded tangent is off by up to 4e-3, the sum
# over 165 of them averages that out (H100 readings 9e-8 to 3.3e-5); a band
# of percents would let a dropped derivative term through
TOL_TRACE_BF16 = 1e-3
TOL_TRACE_F32 = 2e-3  # forward mode against edge operators, both f32: reassociation over 165 tangents


def fail(msg):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)), float((a - b).abs().max())


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(n_bytes, n_ops, peak_ops, sfu_ops=0, fp32_ops=0):
    """The least time (ms) and what sets it: bytes over the memory rate, or
    operations over their peak, the SFU operations (sigmoids, tanhs) and the
    elementwise f32 operations around the products over theirs."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = max(n_ops / peak_ops, sfu_ops / PEAK_SFU, fp32_ops / PEAK_FP32_OPS) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def products_name(peak_ops):
    return {PEAK_BF16: "bf16 tensor cores", PEAK_3XTF32: "TF32 tensor cores in 3xTF32 "
            "(a third of 495 TFLOP/s)", PEAK_F32: "the f32 pipes"}[peak_ops]


def egcl_bound(label, n_bytes, n_ops, peak_ops, n_edges, F, phase=3):
    """bound_ms of an EGCL kernel, its three terms printed: the function
    needs sigma(z1), sigma(z2), sigma(cz) (F each), the attention sigmoid and
    a tanh per edge, each at least one SFU operation (tanh.approx.f32 gives
    a logistic in one; an exponential and a reciprocal take two). f32
    products count on TF32 tensor cores in 3xTF32 (PEAK_3XTF32)."""
    sfu = (3 * F + 2) * n_edges
    bnd = bound_ms(n_bytes, n_ops, peak_ops, sfu)
    print(f"[phase {phase}] bound of {label}: bytes {n_bytes / PEAK_BYTES * 1e3:.4f} ms, "
          f"products {n_ops / peak_ops * 1e3:.4f} ms on {products_name(peak_ops)} "
          f"({n_ops:.3e} operations), SFU {sfu / PEAK_SFU * 1e3:.4f} ms "
          f"({sfu:.3e} sigmoids and tanhs, one SFU operation each at 16/clk/SM, 1.98 GHz) "
          f"-> {bnd[0]:.4f} ms ({bnd[1]})")
    return bnd


@contextlib.contextmanager
def scalar_f32_kernels():
    """The f32 K2, K3 and K4 on their scalar yardsticks for one timing: the
    rule egnn_layer.tf32_takes answers False in both dispatching modules
    (egnn_layer for K2 and K3, egnn_tangent for K4) while the block runs
    (the port has no switch for it)."""
    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    saved = el.tf32_takes, et.tf32_takes
    el.tf32_takes = et.tf32_takes = lambda N, F: False
    try:
        yield
    finally:
        el.tf32_takes, et.tf32_takes = saved


def in_turns(old, new, ms=cuda_ms, **kw):
    """Times of two callables in turns (old, new, new, old) and the means of
    each: (turns, new_ms, old_ms)."""
    turns = [ms(f, **kw) for f in (old, new, new, old)]
    return turns, (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


# K1's least work, counted per unordered pair (the pair energy and the pair
# force are symmetric, so a pair need be computed once): f32 instructions
# (an FMA is one) for the difference (3), r^2 (3), s^3 and s^6 from
# s = (rm/r)^2 (3), the energy (2), e'(r^2) (2) and the force on both ends
# (6); with the spline a compare and two selects (3) per pair and, for each
# pair below r_min in the data, r, dx and the cubic and its derivative (8).
# SFU: one reciprocal per pair and one square root per pair below r_min.
# Per particle: the centre of mass, the oscillator and the force's scaling.
LJ_F32_PER_PAIR = 19
LJ_F32_SPLINE_SELECT = 3
LJ_F32_PER_CLOSE_PAIR = 8
LJ_F32_PER_PARTICLE = 15


def lj_kwargs(target):
    return dict(eps=target.eps, rm=target.rm, oscillator_scale=target._osc,
                energy_factor=target.energy_factor, temperature=target.temperature,
                spline=target.spline)


def lj_bound(x, target, label, phase):
    """K1's bound at the input x: the largest of its bytes (x read once,
    log_prob and force written once), its f32 instructions and its SFU
    operations, each term printed and the largest named."""
    N, B = target.n_particles, x.shape[0]
    pairs = B * N * (N - 1) // 2
    f32 = LJ_F32_PER_PAIR * pairs + LJ_F32_PER_PARTICLE * B * N
    sfu = pairs
    close = 0
    if target.spline is not None:
        for i in range(0, B, 8192):  # (chunk, N, N) distances at a time
            xr = x[i:i + 8192].reshape(-1, N, 3)
            d2 = ((xr[:, :, None] - xr[:, None]) ** 2).sum(-1)
            d2.diagonal(dim1=1, dim2=2).fill_(float("inf"))
            close += int((d2 < target.spline[4] ** 2).sum()) // 2
        f32 += LJ_F32_SPLINE_SELECT * pairs + LJ_F32_PER_CLOSE_PAIR * close
        sfu += close
    n_bytes = 4 * (2 * B * N * 3 + B)
    terms = {"bytes": n_bytes / PEAK_BYTES * 1e3, "f32 instructions": f32 / PEAK_FP32_OPS * 1e3,
             "SFU": sfu / PEAK_SFU * 1e3}
    name = max(terms, key=terms.get)
    bnd, by = bound_ms(n_bytes, 0, PEAK_F32, sfu, f32)
    print(f"[phase {phase}] bound of K1 at {label} (B={B}, N={N}): {pairs} unordered pairs, "
          f"{close} below r_min; " + ", ".join(f"{k} {v:.5f} ms" for k, v in terms.items())
          + f" -> {bnd:.5f} ms ({name})")
    return bnd, by


def host_us(fn, n=1000):
    """Host microseconds per call over n calls with no synchronization."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def phase_lj(data):
    """Phase 2: the new K1 and the first one against the plain version at
    2048 chains (LJ55 with the spline, LJ13), the new one twice for a
    bitwise-equal result; then both timed in turns (new, first, first, new)
    at LJ55's 256, 512 and 2048 chains and LJ13's 512: device time alone
    (torch.profiler), CUDA-event time a launch, the wrapper's host time; and
    the new one's device time at every lane count the kernel takes."""
    import torch

    from pita_torch.ops import lj as ljop
    from pita_torch.targets import LJ13, LJ55

    gen = torch.Generator("cuda").manual_seed(1)
    base = torch.as_tensor(data, device="cuda").repeat(2, 1)  # (2048, 165)
    x55 = (base + 0.01 * torch.randn(base.shape, generator=gen, device="cuda")).contiguous()
    x13 = x55[:, :39].contiguous()
    t55, t13 = LJ55(smooth=True, temperature=2.0 / 1.2), LJ13()
    errs = {}
    for name, tgt, x in (("lj55_spline", t55, x55), ("lj13", t13, x13)):
        N, kw = tgt.n_particles, lj_kwargs(tgt)
        lp_p, f_p = ljop.lj_log_prob_and_force_plain(x, N, **kw)
        for which, fn in (("new", ljop.lj_log_prob_and_force), ("first", ljop._lj_scalar)):
            lp_k, f_k = fn(x, N, **kw)
            torch.cuda.synchronize()
            (r_lp, a_lp), (r_f, a_f) = rel_err(lp_k, lp_p), rel_err(f_k, f_p)
            print(f"[phase 2] K1 ({which}) {name} B={x.shape[0]}: logp max abs {a_lp:.3e} rel "
                  f"{r_lp:.3e}; force max abs {a_f:.3e} rel {r_f:.3e} (tol rel {TOL_LJ})")
            if not (r_lp <= TOL_LJ and r_f <= TOL_LJ):
                fail(f"K1 ({which}) {name} disagrees with its plain version")
            errs[which] = max(errs.get(which, 0.0), a_lp, a_f)
        once, again = (ljop.lj_log_prob_and_force(x, N, **kw) for _ in range(2))
        same = all(torch.equal(a, b) for a, b in zip(once, again))
        print(f"[phase 2] K1 {name}: two launches bitwise equal: {same}")
        if not same:
            fail(f"K1 {name}: two launches on the same input differ")

    out, rule = {}, ljop.lanes_per_particle
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for name, tgt, xs, B in (("lj55_spline", t55, x55, 256), ("lj55_spline", t55, x55, 512),
                             ("lj55_spline", t55, x55, 2048), ("lj13", t13, x13, 512)):
        N, kw, x = tgt.n_particles, lj_kwargs(tgt), xs[:B].contiguous()
        runs = {"new": (lambda: ljop.lj_log_prob_and_force(x, N, **kw), "lj_pairs_kernel"),
                "first": (lambda: ljop._lj_scalar(x, N, **kw), "lj_scalar_kernel")}
        dev, ev, host = ({k: [] for k in runs} for _ in range(3))
        for which in ("new", "first", "first", "new"):
            fn, key = runs[which]
            dev[which].append(profiled_ms(fn, key))
            ev[which].append(cuda_ms(fn, reps=200, warmup=10))
            host[which].append(host_us(fn))
        # the new K1's device time at each lane count, beside the rule's pick
        pick, by_lanes = ljop.lanes_per_particle(N, B, torch.cuda.get_device_properties(0)
                                                 .multi_processor_count), {}
        try:
            for lanes in (1, 2, 4, 8):
                ljop.lanes_per_particle = lambda n, b, sms, lanes=lanes: lanes
                by_lanes[lanes] = profiled_ms(runs["new"][0], "lj_pairs_kernel")
        finally:
            ljop.lanes_per_particle = rule
        print(f"[phase 2] K1 {name} B={B}: device time alone by lanes per particle "
              + ", ".join(f"L={k} {fmt(v)}" for k, v in by_lanes.items())
              + f" ms; the rule picks L={pick}")
        plain = cuda_ms(lambda: ljop.lj_log_prob_and_force_plain(x, N, **kw), reps=5)
        bnd, by = lj_bound(x, tgt, f"{name} {B} chains", 2)
        print(f"[phase 2] K1 {name} B={B} (new / first, in turns): device time alone "
              + " / ".join(",".join(fmt(v) for v in dev[k]) for k in runs)
              + " ms; CUDA events " + " / ".join(",".join(f"{v:.4f}" for v in ev[k]) for k in runs)
              + " ms a launch; wrapper host " + " / ".join(",".join(f"{v:.2f}" for v in host[k])
                                                          for k in runs)
              + f" us a call; plain {plain:.4f} ms; bound {bnd:.5f} ms ({by})")
        if None in dev["new"]:
            fail(f"K1 {name} B={B}: no lj_pairs_kernel row in the profile")
        if name == "lj55_spline" and B == 2048:
            mean = lambda v: sum(v) / len(v)
            out = {which: dict(max_abs_err=errs[which], ms=mean(ev[which]), plain_ms=plain,
                               bound_ms=bnd, bound_by=by) for which in runs}
    return out["new"], out["first"]


def phase_egcl(wl, data):
    import torch

    from pita_torch.ops import egnn_layer as el
    from pita_torch.nets.precondition import coeffs

    res = {}
    gen = torch.Generator("cuda").manual_seed(2)
    base = torch.as_tensor(data, device="cuda").repeat(2, 1)
    B, N, F = base.shape[0], 55, 32
    x_flat = base + 0.01 * torch.randn(base.shape, generator=gen, device="cuda")
    ht = wl.noise.h(torch.full((B,), 0.5, device="cuda"))
    _, c_in, _, c_noise = coeffs(ht)
    bb = wl.energy.backbone
    xs = (c_in[:, None] * x_flat).reshape(B, N, 3).contiguous()
    feats = torch.stack([c_noise, torch.ones_like(c_noise)], -1)[:, None, :].expand(B, N, 2)
    h0 = (feats @ bb.w_emb + bb.b_emb).contiguous()
    ea = ((xs[:, :, None] - xs[:, None]) ** 2).sum(-1).contiguous()
    for cd_name, cd, tol in (("f32", torch.float32, TOL_F32), ("bf16", torch.bfloat16, TOL_BF16)):
        h, x = h0, xs
        worst_f = worst_b = 0.0
        for li, layer in enumerate(bb.layers):
            cfg = dict(layer.cfg, cd=cd)
            w = layer.weights()
            packed = el.pack_weights(w, cd).cuda()
            # the tensor-core kernels' matrices: bf16 (K2, K3), TF32 hi + lo (f32 K2, K3)
            ptc = (el.pack_weights_tc(w) if cd == torch.bfloat16 else el.pack_weights_tf32(w)).cuda()
            gh = torch.randn(h.shape, generator=gen, device="cuda")
            gx = torch.randn(x.shape, generator=gen, device="cuda")
            # the bf16 K2 hands its aggregate to the bf16 K3
            ho_k, xo_k, *agg = el.egnn_layer_forward(h, x, ea, w, packed=packed, packed_tc=ptc,
                                                     with_agg=cd == torch.bfloat16, **cfg)
            with torch.no_grad():
                ho_p, xo_p = el.layer_step(h, x, ea, w, **cfg)
            d_k = el.egnn_layer_backward(h, x, ea, gh, gx, w, packed=packed, packed_tc=ptc,
                                         agg=agg[0] if agg else None, **cfg)
            d_p = el.layer_vjp(h, x, ea, gh, gx, w, **cfg)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip((ho_k, xo_k, *d_k), (ho_p, xo_p, *d_p))]
            worst_rel = max(e[0] for e in errs)
            worst_f = max([worst_f] + [e[1] for e in errs[:2]])
            worst_b = max([worst_b] + [e[1] for e in errs[2:]])
            names = ("h_out", "x_out", "dh", "dx", "dea")
            print(f"[phase 3] K2/K3 {cd_name} layer {li}: rel err "
                  + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(names, errs))
                  + f" (tol {tol})")
            if not worst_rel <= tol:  # NaN fails too
                fail(f"EGCL kernels disagree with the plain version ({cd_name}, layer {li})")
            if li == 0:
                res.update(egcl_layer0(wl, el, cd_name, cfg, w, packed, ptc, h, x, ea, gh, gx,
                                       gen, *agg))
            with torch.no_grad():
                h, x = ho_p, xo_p
        res[cd_name] = (worst_f, worst_b)
    return res


def first_step_inputs(wl, B, N, gen):
    """Layer 0's h, x and edge_attr on the inputs of the first EM step (prior
    samples at t = 1), where many activations are far from 0."""
    import torch

    from pita_torch.nets.precondition import coeffs

    bb = wl.energy.backbone
    _, c_in1, _, c_noise1 = coeffs(wl.noise.h(torch.ones(B, device="cuda")))
    xp = torch.randn(B, N, 3, generator=gen, device="cuda") * wl.prior_scale
    xp = (xp * c_in1[:, None, None]).contiguous()
    f1 = torch.stack([c_noise1, torch.ones_like(c_noise1)], -1)[:, None, :]
    hp = (f1.expand(B, N, 2) @ bb.w_emb + bb.b_emb).contiguous()
    eap = ((xp[:, :, None] - xp[:, None]) ** 2).sum(-1).contiguous()
    return hp, xp, eap


def egcl_layer0(wl, el, cd_name, cfg, w, packed, ptc, h, x, ea, gh, gx, gen, agg=None):
    """Layer 0 at the main path's shapes: times and bounds of K2 and K3 (f32:
    egcl_layer0_f32). For bf16 (``agg`` the tensor-core K2's aggregate,
    which K3 reads) also the tensor-core K2 timed with and without storing
    its aggregate, the scalar K2 timed beside it, and the tensor-core K2
    (its aggregate too) and K3 against the plain versions on first-step
    inputs, at the Hutchinson launch's 4096 chains and at LJ13's N = 13.
    Returns the JSON fields by kernel."""
    import torch

    B, N, F = h.shape
    if cd_name == "f32":
        return egcl_layer0_f32(wl, el, cfg, w, packed, ptc, h, x, ea, gh, gx)
    fwd = lambda *a, **k: el.egnn_layer_forward(*a, w, packed=packed, packed_tc=ptc, **k, **cfg)
    bwd = lambda *a, agg: el.egnn_layer_backward(*a, w, packed=packed, packed_tc=ptc, agg=agg,
                                                 **cfg)
    ms_b = cuda_ms(lambda: bwd(h, x, ea, gh, gx, agg=agg), reps=10)
    pl_b = cuda_ms(lambda: el.layer_vjp(h, x, ea, gh, gx, w, **cfg), reps=3)
    E = B * N * (N - 1)
    node_ops = B * N * 10 * F * F  # src, dst and the node MLP
    wbytes = 4 * packed.numel()
    io_f = 4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N) + wbytes
    io_b = 4 * (4 * B * N * F + 3 * B * N * 3 + 2 * B * N * N) + wbytes  # with K2's agg
    # edge products: 2 F x F matmuls forward; the VJP rebuilds them and runs
    # their 2 transposes; bf16 inputs on tensor cores
    bb_ = egcl_bound(f"K3 {cd_name} B={B}", io_b, E * 8 * F * F + 2 * node_ops, PEAK_BF16, E, F)
    ms_f = cuda_ms(lambda: fwd(h, x, ea))
    with torch.no_grad():
        pl_f = cuda_ms(lambda: el.layer_step(h, x, ea, w, **cfg), reps=5)
    bf = egcl_bound(f"K2 {cd_name} B={B}", io_f, E * 4 * F * F + node_ops, PEAK_BF16, E, F)
    # the scalar K2 in bf16, past the dispatch for this timing only; in turns
    # with the tensor-core K2 (scalar, tensor cores, tensor cores, scalar)
    scalar = lambda *a: el._forward_scalar(*a, w, packed, **cfg)
    turns = [cuda_ms(lambda: f(h, x, ea)) for f in (scalar, fwd, fwd, scalar)]
    # the tensor-core K2 storing its aggregate (a forward that records a
    # backward) in turns with it storing none (without, with, with, without)
    agg_turns, ms_fa, ms_fn = in_turns(lambda: fwd(h, x, ea),
                                       lambda: fwd(h, x, ea, with_agg=True))
    print(f"[phase 3] bf16 B={B} layer 0: tensor-core K2 {ms_f:.4f} ms, in turns with the "
          f"scalar K2 {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, tc, tc, scalar; "
          f"plain {pl_f:.3f}); tensor-core K2 without / with its aggregate stored, in turns "
          f"{' / '.join(f'{v:.4f}' for v in agg_turns)} ms (means {ms_fn:.4f} / {ms_fa:.4f}); "
          f"tensor-core K3 on K2's aggregate {ms_b:.4f} ms (plain {pl_b:.3f})")
    hp, xp, eap = first_step_inputs(wl, B, N, gen)
    ms_f1 = cuda_ms(lambda: fwd(hp, xp, eap))
    ms_fs1 = cuda_ms(lambda: scalar(hp, xp, eap))
    agg1 = fwd(hp, xp, eap, with_agg=True)[2]
    ms_b1 = cuda_ms(lambda: bwd(hp, xp, eap, gh, gx, agg=agg1), reps=10)
    worst_f = worst_b = 0.0
    counts = lambda: (el.egnn_layer_forward.launches, el.egnn_layer_forward_tc.launches,
                      el.egnn_layer_backward_tc.launches)
    for name, args in (("first-step inputs (t=1)", (hp, xp, eap, gh, gx)),
                       ("4096 chains (the Hutchinson launch: t=0.5 and t=1 inputs)",
                        (torch.cat([h, hp]), torch.cat([x, xp]), torch.cat([ea, eap]),
                         torch.randn(2 * B, N, F, generator=gen, device="cuda"),
                         torch.randn(2 * B, N, 3, generator=gen, device="cuda"))),
                       ("LJ13's N=13 (the first 13 particles, t=0.5)",
                        tuple(t.contiguous() for t in (h[:, :13], x[:, :13], ea[:, :13, :13],
                                                       gh[:, :13], gx[:, :13])))):
        before = counts()
        got_f = fwd(*args[:3], with_agg=True)
        got_b = bwd(*args, agg=got_f[2])
        if counts() != (before[0], before[1] + 1, before[2] + 1):
            fail("the bf16 layer did not launch the tensor-core K2 and K3 (and only them)")
        # the plain versions in chunks of 1024 chains: their edge tensors are 0.4 GB each
        chunks = range(0, args[0].shape[0], 1024)
        with torch.no_grad():
            ref_f = [torch.cat(p) for p in zip(*(
                (lambda o: (*o[:2], el._aggregate(o[2])))(el.layer_step(
                    *(t[c0:c0 + 1024] for t in args[:3]), w, with_acts=True, **cfg))
                for c0 in chunks))]
        ref_b = plain_vjp(el, args, w, cfg)
        torch.cuda.synchronize()
        errs_f = [rel_err(a, b) for a, b in zip(got_f, ref_f)]
        errs_b = [rel_err(a, b) for a, b in zip(got_b, ref_b)]
        worst_f = max([worst_f] + [e[1] for e in errs_f])
        worst_b = max([worst_b] + [e[1] for e in errs_b])
        print(f"[phase 3] tensor-core K2/K3 bf16 layer 0, {name}: rel err "
              + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(
                  ("h_out", "x_out", "agg", "dh", "dx", "dea"), errs_f + errs_b))
              + f" (tol {TOL_BF16})")
        if not max(e[0] for e in errs_f + errs_b) <= TOL_BF16:
            fail(f"the tensor-core K2/K3 disagree with the plain versions on {name}")
        if args[0].shape[0] == 2 * B:
            h4, x4, ea4, gh4, gx4 = args
            agg4 = got_f[2]
        del got_f, got_b, ref_f, ref_b
    ms_f4 = cuda_ms(lambda: fwd(h4, x4, ea4))
    ms_b4 = cuda_ms(lambda: bwd(h4, x4, ea4, gh4, gx4, agg=agg4), reps=10)
    print(f"[phase 3] bf16 layer 0 on first-step inputs (B={B}): tensor-core K2 {ms_f1:.4f} ms, "
          f"scalar K2 {ms_fs1:.4f} ms, tensor-core K3 {ms_b1:.4f} ms; at B={2 * B}: "
          f"tensor-core K2 {ms_f4:.4f} ms, tensor-core K3 {ms_b4:.4f} ms")
    return {"fwd": dict(ms=ms_f, ms_with_agg=ms_fa, plain_ms=pl_f, bound_ms=bf[0],
                        bound_by=bf[1]),
            "bwd": dict(ms=ms_b, plain_ms=pl_b, bound_ms=bb_[0], bound_by=bb_[1]),
            "fwd_extra_err": worst_f, "bwd_extra_err": worst_b}


def k2_f32_bound(h, packed, phase):
    """The f32 K2's bound at h (B, N, F), its terms printed: h, x and
    edge_attr read, h and x written, the weights read; the edge and node
    products in 3xTF32; the SFU terms."""
    B, N, F = h.shape
    E = B * N * (N - 1)
    return egcl_bound(f"K2 f32 B={B}", 4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N)
                      + 4 * packed.numel(), E * 4 * F * F + B * N * 10 * F * F, PEAK_3XTF32, E,
                      F, phase=phase)


def k2_f32_in_turns(el, h, x, ea, w, cfg, packed, ptc, label, phase):
    """The f32 K2 at one launch: the 3xTF32 kernel (the dispatch's pick, which
    must launch it alone) and the scalar yardstick against layer_step, the
    3xTF32 one launched twice for a bitwise-equal result, both timed in turns
    (scalar, 3xTF32, 3xTF32, scalar). Returns (fields of the 3xTF32 kernel,
    fields of the scalar one) for the kernels line."""
    import torch

    tf32 = lambda: el.egnn_layer_forward(h, x, ea, w, packed=packed, packed_tc=ptc, **cfg)
    scalar = lambda: el._forward_scalar(h, x, ea, w, packed, **cfg)
    before = (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches)
    got, again = tf32(), tf32()
    if (el.egnn_layer_forward.launches, el.egnn_layer_forward_tf32.launches) != (
            before[0], before[1] + 2):
        fail(f"the f32 layer forward at {label} did not launch the 3xTF32 K2 alone")
    got_s = scalar()
    with torch.no_grad():
        ref = [torch.cat(p) for p in zip(*(el.layer_step(h[c0:c0 + 1024], x[c0:c0 + 1024],
                                                         ea[c0:c0 + 1024], w, **cfg)
                                           for c0 in range(0, h.shape[0], 1024)))]
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    errs_s = [rel_err(a, b) for a, b in zip(got_s, ref)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, got_s, ref
    turns, ms, ms_s = in_turns(scalar, tf32)
    with torch.no_grad():
        pl = cuda_ms(lambda: el.layer_step(h, x, ea, w, **cfg), reps=3, warmup=1)
    bnd = k2_f32_bound(h, packed, phase)
    print(f"[phase {phase}] f32 K2 at {label} (B={h.shape[0]}): 3xTF32 kernel rel err h_out "
          f"{errs[0][0]:.2e}, x_out {errs[1][0]:.2e}, scalar h_out {errs_s[0][0]:.2e}, x_out "
          f"{errs_s[1][0]:.2e} (tol {TOL_F32}); a second launch "
          f"{'bitwise equal' if same else 'DIFFERENT'}; 3xTF32 {ms:.4f} ms, scalar {ms_s:.4f} ms, "
          f"in turns {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, 3xTF32, 3xTF32, "
          f"scalar); plain {pl:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
    if not max(e[0] for e in errs + errs_s) <= TOL_F32:
        fail(f"an f32 K2 disagrees with its plain version at {label}")
    if not same:
        fail(f"two launches of the 3xTF32 K2 at {label} differ")
    common = dict(plain_ms=pl, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    return (dict(max_abs_err=max(e[1] for e in errs), ms=ms, **common),
            dict(max_abs_err=max(e[1] for e in errs_s), ms=ms_s, **common))


def k3_f32_bound(h, packed, phase):
    """The f32 K3's bound at h (B, N, F), its terms printed: h, x, edge_attr,
    gh and gx read, dh, dx and dea written, the weights read; the forward's
    two edge products and their two transposes, the node products and their
    transposes, in 3xTF32; the SFU terms."""
    B, N, F = h.shape
    E = B * N * (N - 1)
    return egcl_bound(f"K3 f32 B={B}", 4 * (3 * B * N * F + 3 * B * N * 3 + 2 * B * N * N)
                      + 4 * packed.numel(), E * 8 * F * F + 2 * B * N * 10 * F * F, PEAK_3XTF32,
                      E, F, phase=phase)


def plain_vjp(el, args, w, cfg, chunk=1024):
    """layer_vjp on (h, x, edge_attr, gh, gx) in chunks of chains: its edge
    tensors are 0.4 GB a tensor at 1,024 chains."""
    import torch

    return [torch.cat(p) for p in zip(*(
        el.layer_vjp(*(t[c0:c0 + chunk] for t in args), w, **cfg)
        for c0 in range(0, args[0].shape[0], chunk)))]


def k3_f32_in_turns(el, args, w, cfg, packed, ptc, label, phase):
    """The f32 K3 at one launch on args = (h, x, edge_attr, gh, gx): the
    3xTF32 kernel (the dispatch's pick, which must launch it alone) and the
    scalar yardstick against layer_vjp, the 3xTF32 one launched twice for a
    bitwise-equal result, both timed in turns (scalar, 3xTF32, 3xTF32,
    scalar). Returns (fields of the 3xTF32 kernel, fields of the scalar one)
    for the kernels line."""
    import torch

    tf32 = lambda: el.egnn_layer_backward(*args, w, packed=packed, packed_tc=ptc, **cfg)
    scalar = lambda: el._backward_scalar(*args, w, packed, **cfg)
    counts = lambda: (el.egnn_layer_backward.launches, el.egnn_layer_backward_tf32.launches)
    before = counts()
    got, again = tf32(), tf32()
    if counts() != (before[0], before[1] + 2):
        fail(f"the f32 layer VJP at {label} did not launch the 3xTF32 K3 alone")
    got_s = scalar()
    ref = plain_vjp(el, args, w, cfg)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    errs_s = [rel_err(a, b) for a, b in zip(got_s, ref)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, got_s, ref
    turns, ms, ms_s = in_turns(scalar, tf32, reps=10)
    pl = cuda_ms(lambda: el.layer_vjp(*args, w, **cfg), reps=3, warmup=1)
    bnd = k3_f32_bound(args[0], packed, phase)
    names = ("dh", "dx", "dea")
    print(f"[phase {phase}] f32 K3 at {label} (B={args[0].shape[0]}): 3xTF32 kernel rel err "
          + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(names, errs)) + ", scalar "
          + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(names, errs_s))
          + f" (tol {TOL_F32}); a second launch {'bitwise equal' if same else 'DIFFERENT'}; "
          f"3xTF32 {ms:.4f} ms, scalar {ms_s:.4f} ms, in turns "
          f"{' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, 3xTF32, 3xTF32, scalar); plain "
          f"{pl:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
    if not max(e[0] for e in errs + errs_s) <= TOL_F32:
        fail(f"an f32 K3 disagrees with its plain version at {label}")
    if not same:
        fail(f"two launches of the 3xTF32 K3 at {label} differ")
    common = dict(plain_ms=pl, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    return (dict(max_abs_err=max(e[1] for e in errs), ms=ms, **common),
            dict(max_abs_err=max(e[1] for e in errs_s), ms=ms_s, **common))


def egcl_layer0_f32(wl, el, cfg, w, packed, ptc, h, x, ea, gh, gx):
    """The f32 K2 and K3 on phase 3's inputs at the main paths' chain counts:
    K2 at the fill's 256, the DEM refill's 2,000 and at 2,048; K3 at the
    fill's 256 and at 2,048, each in turns with its scalar yardstick; then
    the 3xTF32 K3 alone against layer_vjp on first-step inputs (t = 1) and
    at LJ13's N = 13, 2,048 chains each. Returns the JSON fields by kernel:
    K2 of the 2,000-chain launch, K3 of the fill's 256."""
    import torch

    out = {}
    for n in (256, 2000, h.shape[0]):
        out[n] = k2_f32_in_turns(el, h[:n], x[:n], ea[:n], w, cfg, packed, ptc,
                                 f"layer 0, t = 0.5, {n} chains", 3)
    worst = max(max(r[0]["max_abs_err"], r[1]["max_abs_err"]) for r in out.values())
    k3 = {n: k3_f32_in_turns(el, tuple(t[:n] for t in (h, x, ea, gh, gx)), w, cfg, packed, ptc,
                             f"layer 0, t = 0.5, {n} chains", 3) for n in (256, h.shape[0])}
    worst_k3 = max(r[0]["max_abs_err"] for r in k3.values())
    # its own generator: the draws of the phase's other checks stay as they were
    gen = torch.Generator("cuda").manual_seed(31)
    B, N, F = h.shape
    hp, xp, eap = first_step_inputs(wl, B, N, gen)
    for name, args in (("first-step inputs (t=1)", (hp, xp, eap, gh, gx)),
                       ("LJ13's N=13 (the first 13 particles, t=0.5)",
                        tuple(t.contiguous() for t in (h[:, :13], x[:, :13], ea[:, :13, :13],
                                                       gh[:, :13], gx[:, :13])))):
        before = (el.egnn_layer_backward.launches, el.egnn_layer_backward_tf32.launches)
        got = el.egnn_layer_backward(*args, w, packed=packed, packed_tc=ptc, **cfg)
        if (el.egnn_layer_backward.launches, el.egnn_layer_backward_tf32.launches) != (
                before[0], before[1] + 1):
            fail(f"the f32 layer VJP on {name} did not launch the 3xTF32 K3 alone")
        ref = plain_vjp(el, args, w, cfg)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        worst_k3 = max([worst_k3] + [e[1] for e in errs])
        print(f"[phase 3] 3xTF32 K3 f32 layer 0, {name} (B={B}): rel err "
              + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(("dh", "dx", "dea"), errs))
              + f" (tol {TOL_F32})")
        if not max(e[0] for e in errs) <= TOL_F32:
            fail(f"the 3xTF32 K3 disagrees with layer_vjp on {name}")
        del got, ref
    return {"fwd_f32": dict(out[2000][0], max_abs_err=worst),
            "fwd_f32_scalar": dict(out[2000][1], max_abs_err=worst),
            "bwd_f32": dict(k3[256][0], max_abs_err=worst_k3),
            "bwd_f32_scalar": dict(k3[256][1],
                                   max_abs_err=max(r[1]["max_abs_err"] for r in k3.values()))}


def score_inputs(wl, x_flat, t_val):
    """(c_noise, c_in * x) of the score network for chains x_flat at time t_val."""
    import torch

    from pita_torch.nets.precondition import coeffs

    ht = wl.noise.h(torch.full((x_flat.shape[0],), t_val, device="cuda"))
    _, c_in, _, c_noise = coeffs(ht)
    return c_noise, c_in[:, None] * x_flat


def g_op_args(wl, x_flat, t_val, layers=(1, 2)):
    """K5's primal arguments for the given layers of the bench score net."""
    from pita_torch.nets import egnn_fast as ef
    from pita_torch.ops.egnn_layer import rounded_weights

    bb = wl.score.backbone
    c_noise, x_in = score_inputs(wl, x_flat, t_val)
    _, (_, _, mask, _, weights, acts, _) = ef.egnn_apply(bb, c_noise, x_in, 1.0, with_acts=True)
    out = []
    for li in layers:
        cfg = bb.layers[li].cfg
        gp = ef.g_operator_args(rounded_weights(weights[li], cfg["cd"]), acts[li], mask,
                                cfg["attention"])
        out.append(tuple(gp[k] for k in ("sp1", "sp2", "att_mask", "satq", "m_pre", "w2")))
    return out


def phase_g_op(wl, data):
    import torch

    from pita_torch.ops import g_op

    gen = torch.Generator("cuda").manual_seed(6)
    N, F, T = 55, 32, 165
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    base = torch.as_tensor(data, device="cuda")
    worst_abs = 0.0
    inputs = (("t=0.5 data", base[:64] + 0.01 * randn(64, 165), 0.5),
              ("t=1 prior", randn(64, 165) * wl.prior_scale, 1.0))
    for name, x_flat, t_val in inputs:
        bv = randn(T, 64, N, F) * 0.1
        for li, prim in zip((1, 2), g_op_args(wl, x_flat, t_val)):
            got = g_op.g_operator_contract(*prim, bv)
            ref = g_op.g_operator_contract_plain(*prim, bv)
            torch.cuda.synchronize()
            rel, ab = rel_err(got, ref)
            worst_abs = max(worst_abs, ab)
            print(f"[phase 6] K5 {name} layer {li} B=64 T={T}: max |t2| "
                  f"{float(ref.abs().max()):.3e}, max abs err {ab:.3e} rel {rel:.3e} "
                  f"(tol rel {TOL_GOP})")
            if not rel <= TOL_GOP:
                fail(f"K5 disagrees with its plain version ({name}, layer {li})")
    # near-integer inputs are exact in bf16 and in the f32 sums: indexing only
    ri = lambda *shape: torch.round(randn(*shape) * 2)
    mask = 1.0 - torch.eye(N, device="cuda")
    prim = (ri(4, N, N, F), ri(4, N, N, F), ri(4, N, N) * mask, ri(4, N, N, F) * mask[:, :, None],
            ri(4, N, N, F), ri(F, F))
    bv = ri(T, 4, N, F)
    exact = torch.equal(g_op.g_operator_contract(*prim, bv),
                        g_op.g_operator_contract_plain(*prim, bv))
    print(f"[phase 6] K5 near-integer inputs B=4 T={T}: {'identical' if exact else 'DIFFERENT'}")
    if not exact:
        fail("K5 differs from its plain version on near-integer inputs (indexing)")

    # the main path's shape: its chain chunk of 256 and all 165 tangents,
    # compared (the scalar K5 too), repeated bitwise, and timed
    B = 256
    x_flat = base[:B] + 0.01 * randn(B, 165)
    prim = g_op_args(wl, x_flat, 0.5, layers=(1,))[0]
    bv = randn(T, B, N, F) * 0.1
    got = g_op.g_operator_contract(*prim, bv)
    again = g_op.g_operator_contract(*prim, bv)
    ref = g_op.g_operator_contract_plain(*prim, bv)
    got_s = g_op._contract_scalar(*prim, bv)
    torch.cuda.synchronize()
    rel, ab = rel_err(got, ref)
    rel_s, ab_s = rel_err(got_s, ref)
    worst_abs = max(worst_abs, ab)
    same = torch.equal(got, again)
    print(f"[phase 6] K5 t=0.5 data layer 1 B={B} T={T} (the main path's launch): max |t2| "
          f"{float(ref.abs().max()):.3e}, max abs err {ab:.3e} rel {rel:.3e}; scalar K5 "
          f"{ab_s:.3e} rel {rel_s:.3e} (tol rel {TOL_GOP}); a second launch "
          f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not (rel <= TOL_GOP and rel_s <= TOL_GOP):
        fail("K5 disagrees with its plain version at the main path's shape")
    if not same:
        fail("two launches of the tensor-core K5 on the same inputs differ")
    del got, again, ref, got_s
    # in turns: scalar, tensor cores, tensor cores, scalar
    turns = [cuda_ms(lambda: f(*prim, bv), reps=5, warmup=1)
             for f in (g_op._contract_scalar, g_op.g_operator_contract,
                       g_op.g_operator_contract, g_op._contract_scalar)]
    ms, ms_s = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain = cuda_ms(lambda: g_op.g_operator_contract_plain(*prim, bv), reps=2, warmup=1)
    sp1, sp2, att_mask, satq, m_pre, w2 = prim
    G = (att_mask[..., None, None] * (sp1[..., :, None] * w2 * sp2[..., None, :])
         + satq[..., :, None] * m_pre[..., None, :])
    G2 = G.permute(0, 1, 4, 2, 3).reshape(B, N * F, N * F).to(torch.bfloat16)  # [b, (n g), (m f)]
    del G
    panel = bv.permute(1, 2, 3, 0).reshape(B, N * F, T).to(torch.bfloat16)
    lib = cuda_ms(lambda: torch.bmm(G2, panel), reps=5, warmup=1)
    del G2, panel
    # every input read once, the output written once; 2 F^2 operations per
    # unmasked edge and tangent, on bf16 operands
    n_bytes = 4 * (4 * B * N * N * F + B * N * N + F * F + 2 * T * B * N * F)
    bnd, by = bound_ms(n_bytes, 2 * F * F * N * (N - 1) * T * B, PEAK_BF16)
    print(f"[phase 6] K5 B={B} T={T}: tensor-core kernel {ms:.4f} ms, in turns with the scalar "
          f"K5 {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, tc, tc, scalar); plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by}), one torch.bmm of a pre-materialized "
          f"bf16 G (excludes building G) {lib:.3f} ms")
    common = dict(plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
    return (dict(max_abs_err=worst_abs, ms=ms, **common),
            dict(max_abs_err=ab_s, ms=ms_s, **common))


def tangent_fp32_ops(n_edge_tangents, F):
    """The f32 operations of the tangent map around its products, per the
    formula of ops/egnn_tangent.py:layer_tangent, an FMA counting as one and
    every per-edge factor taken once per edge, from the primal: per edge,
    tangent and feature dz1 (dsrc + ddst + c w_r + e w_e: 3), the sp1 scale
    (1), dm = y (sp2 att) + m_pre datt (2) and the dl row sum y (sp2 w_att)
    (1), with y = R(sp1 dz1) W_e2, the dcm row sum (1, sp_cz w_c2 a factor)
    and dagg (1); per edge and tangent c and e (6 each), datt (1), da and dw
    (3) and the dx sums (sum_j dw_ij, sum_j dw_ij x_j + w_ij dx_j: 7)."""
    return n_edge_tangents * (9 * F + 23)


def k4_f32_bound(B, Tc, N, F, n_weights, phase):
    """The f32 K4's bound for B chains x Tc tangents, its terms printed:
    tangents in and out, the primal state and the weights read once; per
    edge and tangent one F x F product (R(sp1 dz1) W_e2; the coordinate
    MLP's tangent is the dot product dm . W_c1 (silu'(cz) w_c2), an f32
    reassociation), per edge the primal's three (W_e2, W_c1, W_c1^T), per
    node and tangent the node products, all in 3xTF32; the f32 work around
    them (tangent_fp32_ops); the primal's sigmoids once per edge on the
    SFUs."""
    E = B * N * (N - 1)
    ops = Tc * E * 2 * F * F + E * 6 * F * F + (Tc + 1) * B * N * 10 * F * F
    ew, sfu = tangent_fp32_ops(Tc * E, F), (3 * F + 2) * E
    n_bytes = 4 * (2 * B * Tc * N * (F + 3) + B * N * (F + 6) + B * N * N + Tc * N * 3
                   + n_weights)
    bnd = bound_ms(n_bytes, ops, PEAK_3XTF32, sfu_ops=sfu, fp32_ops=ew)
    print(f"[phase {phase}] bound of K4 f32 B={B} Tc={Tc}: bytes "
          f"{n_bytes / PEAK_BYTES * 1e3:.4f} ms, products {ops / PEAK_3XTF32 * 1e3:.4f} ms on "
          f"{products_name(PEAK_3XTF32)} ({ops:.3e} operations; at the f32 pipes' 67 TFLOP/s "
          f"{ops / PEAK_F32 * 1e3:.4f} ms), f32 elementwise {ew / PEAK_FP32_OPS * 1e3:.4f} ms "
          f"({ew:.3e} operations at 128/clk/SM, 1.98 GHz), SFU {sfu / PEAK_SFU * 1e3:.4f} ms "
          f"-> {bnd[0]:.4f} ms ({bnd[1]})")
    return bnd


def tangent_f32_in_turns(et, args, w, cfg, packed, ptc, plain_fn=None, phase=7, label=None):
    """The f32 K4 at one launch (args: h, x, ea, xs0, basis, dh, dx): the
    3xTF32 kernel (the dispatch's pick, which must launch it alone) and the
    scalar yardstick at the route's 16 tangents a block against the plain
    version (``plain_fn(basis, dh, dx, cfg)``, else layer_tangent at once),
    the 3xTF32 one launched twice for a bitwise-equal result, both timed in
    turns (scalar, 3xTF32, 3xTF32, scalar). Returns (fields of the 3xTF32
    kernel, fields of the scalar one) for the kernels line."""
    import torch

    B, Tc, N, F = args[5].shape
    label = label or f"B={B} Tc={Tc}"
    run = lambda: et.egnn_layer_tangent(*args, w, packed=packed, packed_tc=ptc, **cfg)
    scalar = lambda: et._tangent_scalar(*args, w, packed, tangent_chunk=16, **cfg)
    before = (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches)
    got, again = run(), run()
    if (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tf32.launches) != (
            before[0], before[1] + 2):
        fail(f"the f32 layer tangent at {label} did not launch the 3xTF32 K4 alone")
    got_s = scalar()
    plain = (lambda: plain_fn(*args[4:], cfg)) if plain_fn else (
        lambda: et.layer_tangent(*args, w, **cfg))
    with torch.no_grad():
        ref = plain()
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    errs_s = [rel_err(a, b) for a, b in zip(got_s, ref)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, got_s, ref
    turns, ms, ms_s = in_turns(scalar, run, reps=5, warmup=1)
    with torch.no_grad():
        pl = cuda_ms(plain, reps=1, warmup=1)
    bnd = k4_f32_bound(B, Tc, N, F, packed.numel(), phase)
    print(f"[phase {phase}] f32 K4 at {label}: 3xTF32 kernel rel err dh_out {errs[0][0]:.2e}, "
          f"dx_out {errs[1][0]:.2e}, scalar dh_out {errs_s[0][0]:.2e}, dx_out {errs_s[1][0]:.2e} "
          f"(tol {TOL_F32}); a second launch {'bitwise equal' if same else 'DIFFERENT'}; 3xTF32 "
          f"{ms:.4f} ms, scalar {ms_s:.4f} ms, in turns {' / '.join(f'{v:.4f}' for v in turns)} "
          f"ms (scalar, 3xTF32, 3xTF32, scalar); plain {pl:.3f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}); 3xTF32 at {ms / bnd[0]:.2f}x the bound, scalar at {ms_s / bnd[0]:.2f}x")
    if not max(e[0] for e in errs + errs_s) <= TOL_F32:
        fail(f"an f32 K4 disagrees with its plain version at {label}")
    if not same:
        fail(f"two launches of the 3xTF32 K4 at {label} differ")
    common = dict(plain_ms=pl, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    return (dict(max_abs_err=max(e[1] for e in errs), ms=ms, **common),
            dict(max_abs_err=max(e[1] for e in errs_s), ms=ms_s, **common))


def phase_tangent(wl, wl32, data):
    import torch

    from pita_torch.nets import egnn_fast as ef
    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    gen = torch.Generator("cuda").manual_seed(7)
    N, F, Tc = 55, 32, 64
    bb = wl.score.backbone
    base = torch.as_tensor(data, device="cuda")
    counts = lambda: (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches,
                      et.egnn_layer_tangent_tf32.launches)

    def states(B):
        x_flat = base[:B] + 0.01 * torch.randn(B, 165, generator=gen, device="cuda")
        c_noise, x_in = score_inputs(wl, x_flat, 0.5)
        xs = x_in.reshape(B, N, 3).contiguous()
        h = bb.embed(c_noise, x_in, 1.0).contiguous()
        ea = ((xs[:, :, None] - xs[:, None]) ** 2).sum(-1).contiguous()
        basis = torch.eye(165, device="cuda")[:Tc].reshape(Tc, N, 3).contiguous()
        return c_noise, x_in, h, xs, ea, basis

    c_noise, x_in, h0, xs, ea, basis = states(64)
    worst = {"f32": 0.0, "bf16": 0.0}
    timed = {}
    for cd_name, cd, tol in (("f32", torch.float32, TOL_F32), ("bf16", torch.bfloat16, TOL_BF16)):
        h, x = h0, xs
        dh = torch.zeros(64, Tc, N, F, device="cuda")
        dx = basis[None].expand(64, -1, -1, -1).contiguous()
        tc = cd == torch.bfloat16
        for li, layer in enumerate(bb.layers):
            cfg = dict(layer.cfg, cd=cd)
            w = layer.weights()
            packed = el.pack_weights(w, cd).cuda()
            ptc = (el.pack_weights_tc(w) if tc else el.pack_weights_tf32(w)).cuda()
            before = counts()
            got = et.egnn_layer_tangent(h, x, ea, xs, basis, dh, dx, w, packed=packed,
                                        packed_tc=ptc, **cfg)
            if counts() != (before[0], before[1] + tc, before[2] + (not tc)):
                fail(f"the {cd_name} layer tangent did not launch the "
                     f"{'tensor-core' if tc else '3xTF32'} K4 alone")
            with torch.no_grad():
                ref = et.layer_tangent(h, x, ea, xs, basis, dh, dx, w, **cfg)
                h_next, x_next = el.layer_step(h, x, ea, w, **cfg)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            worst[cd_name] = max([worst[cd_name]] + [e[1] for e in errs])
            print(f"[phase 7] {'tensor-core' if tc else '3xTF32'} K4 {cd_name} layer {li} B=64 "
                  f"Tc={Tc}: rel err dh_out {errs[0][0]:.2e}, dx_out {errs[1][0]:.2e} (tol {tol})")
            if not max(e[0] for e in errs) <= tol:
                fail(f"K4 disagrees with its plain version ({cd_name}, layer {li})")
            if li == 1:
                timed[cd_name] = (cfg, w, packed, ptc)
            h, x, (dh, dx) = h_next, x_next, ref

    # the whole trace: forward mode through K2 + K4 against the edge operators
    for name, load, tol in (("bf16", wl, TOL_TRACE_BF16), ("f32", wl32, TOL_TRACE_F32)):
        tr_k = et.egnn_jacobian_trace_fused(load.score.backbone, c_noise, x_in, 1.0)
        _, tr_m = ef.egnn_jacobian_trace(load.score.backbone, c_noise, x_in, 1.0)
        torch.cuda.synchronize()
        rel, ab = rel_err(tr_k, tr_m)
        print(f"[phase 7] trace, {name} backbone, 64 chains: K2+K4 forward mode against the "
              f"materialized edge operators: max abs {ab:.3e} rel {rel:.3e} (tol {tol})")
        if not rel <= tol:
            fail(f"the forward-mode trace disagrees with the edge-operator trace ({name})")

    # the main path's launches: 256 chains, layer 1 with the tangents the trace
    # gives it (layer 0's output), for a full super-chunk of 64 tangents and
    # for the ragged last one of 37; compared, and the full one repeated and timed
    B = 256
    _, _, h0, xs, ea, _ = states(B)
    cfg, w, packed, ptc = timed["bf16"]
    cfg32, _, packed32, ptc32 = timed["f32"]
    l0 = bb.layers[0]
    dev = h0.device
    h, x = el.egnn_layer_forward(h0, xs, ea, l0.weights(), packed=l0.packed(dev),
                                 packed_tc=l0.packed(dev, tc=True), **l0.cfg)
    eye = torch.eye(165, device="cuda").reshape(165, N, 3)

    def plain_all(basis, dh, dx, cfg):  # 64 chains at a time: it materializes (B,Tc,N,N,F)
        with torch.no_grad():
            outs = [et.layer_tangent(h[s0:s0 + 64], x[s0:s0 + 64], ea[s0:s0 + 64],
                                     xs[s0:s0 + 64], basis, dh[s0:s0 + 64], dx[s0:s0 + 64],
                                     w, **cfg) for s0 in range(0, B, 64)]
        return [torch.cat(o) for o in zip(*outs)]

    for basis in (eye[:Tc].contiguous(), eye[2 * Tc:].contiguous()):
        n_t = basis.shape[0]
        dh = torch.zeros(B, n_t, N, F, device="cuda")
        dx = basis[None].expand(B, -1, -1, -1).contiguous()
        dh, dx = et.egnn_layer_tangent(h0, xs, ea, xs, basis, dh, dx, l0.weights(),
                                       packed=l0.packed(dev), packed_tc=l0.packed(dev, tc=True),
                                       **l0.cfg)
        run = lambda: et.egnn_layer_tangent(h, x, ea, xs, basis, dh, dx, w, packed=packed,
                                            packed_tc=ptc, **cfg)
        before = counts()
        got, ref = run(), plain_all(basis, dh, dx, cfg)
        torch.cuda.synchronize()
        if counts() != (before[0], before[1] + 1, before[2]):
            fail("the bf16 layer tangent did not launch the tensor-core K4 alone")
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        worst["bf16"] = max([worst["bf16"]] + [e[1] for e in errs])
        print(f"[phase 7] tensor-core K4 bf16 layer 1 B={B} Tc={n_t} (the main path's launch): "
              f"rel err dh_out {errs[0][0]:.2e}, dx_out {errs[1][0]:.2e} (tol {TOL_BF16})")
        if not max(e[0] for e in errs) <= TOL_BF16:
            fail(f"K4 disagrees with its plain version at the main path's shape (Tc={n_t})")
        del ref
        if n_t != Tc:
            continue
        again = run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[phase 7] tensor-core K4 B={B} Tc={Tc}: a second launch "
              f"{'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            fail("two launches of the tensor-core K4 on the same inputs differ")
        del got, again
        # in turns: scalar, tensor cores, tensor cores, scalar (both in bf16;
        # the scalar K4 at the 8 tangents a block it ran the route with before)
        scalar = lambda: et._tangent_scalar(h, x, ea, xs, basis, dh, dx, w, packed,
                                            tangent_chunk=8, **cfg)
        turns = [cuda_ms(f, reps=5, warmup=1) for f in (scalar, run, run, scalar)]
        ms, ms_s = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        plain = cuda_ms(lambda: plain_all(basis, dh, dx, cfg), reps=1, warmup=1)
        # the f32 K4 on the same inputs: the 3xTF32 kernel at the fill's
        # launch (64 chains) and at 256, each against the plain version, in
        # turns with the scalar K4 at the route's 16 tangents a block
        f32 = {n: tangent_f32_in_turns(et, (h[:n], x[:n], ea[:n], xs[:n], basis, dh[:n],
                                            dx[:n]), w, cfg32, packed32, ptc32,
                                       plain_all if n == B else None)
               for n in (64, B)}
    E = B * N * (N - 1)
    # the two edge products per tangent, the primal's once, and the node
    # products (src, dst, node MLP) per tangent; the f32 work around them
    ops = Tc * E * 4 * F * F + E * 4 * F * F + (Tc + 1) * B * N * 10 * F * F
    ew = tangent_fp32_ops(Tc * E, F)
    n_bytes = 4 * (2 * B * Tc * N * (F + 3) + B * N * (F + 6) + B * N * N + Tc * N * 3
                   + packed.numel())
    bnd, by = bound_ms(n_bytes, ops, PEAK_BF16, fp32_ops=ew)
    print(f"[phase 7] bound of K4 bf16 B={B} Tc={Tc}: bytes {n_bytes / PEAK_BYTES * 1e3:.4f} ms, "
          f"products {ops / PEAK_BF16 * 1e3:.4f} ms on bf16 tensor cores, f32 elementwise "
          f"{ew / PEAK_FP32_OPS * 1e3:.4f} ms ({ew:.3e} operations at 128/clk/SM, 1.98 GHz) "
          f"-> {bnd:.4f} ms ({by})")
    print(f"[phase 7] K4 bf16 B={B} Tc={Tc} layer 1: tensor-core kernel {ms:.4f} ms, in turns with "
          f"the scalar K4 {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, tc, tc, scalar); "
          f"plain {plain:.3f} ms")
    if not ms < ms_s:
        fail("the tensor-core K4 is not faster than the scalar K4 at the main path's launch")
    k4_32, k4_32s = f32[B]
    err32 = max(worst["f32"], k4_32["max_abs_err"], f32[64][0]["max_abs_err"])
    return (dict(max_abs_err=worst["bf16"], ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                 library_ms=None),
            dict(k4_32, max_abs_err=err32), k4_32s)


def phase_routes_random_weights(wl, data):
    """The three routes of the trace on a full-width backbone with seeded
    random weights, and the size of the G-operator term in it.

    The term t2 reaches the trace only through the next layer's node
    features, so it is a small part of it (on the bench's trained score net
    phase 6 shows t2 itself is tiny). The trace is therefore also taken with
    t2 dropped: the K5 route must agree with the materialized route to a
    twentieth of what dropping the term changes, or the check is blind.
    """
    import torch

    from pita_torch.nets import EGNNBackbone
    from pita_torch.nets import egnn_fast as ef
    from pita_torch.ops import g_op
    from pita_torch.ops.egnn_tangent import egnn_jacobian_trace_fused

    gen = torch.Generator().manual_seed(11)
    bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
    for name, prm in bb.named_parameters():
        # unit-variance layers, a small last coordinate layer (as flax initializes it)
        scale = 0.1 if prm.dim() == 1 else 0.002 if name.endswith("w_c2") else prm.shape[0] ** -0.5
        prm.data = torch.randn(prm.shape, generator=gen) * scale
    bb = bb.cuda()
    x_in = torch.as_tensor(data[:16], device="cuda") * 0.6
    t_in = torch.full((16,), -0.1, device="cuda")
    _, tr_m = ef.egnn_jacobian_trace(bb, t_in, x_in, 1.0)
    _, tr_g = ef.egnn_jacobian_trace(bb, t_in, x_in, 1.0, g_kernel=True)
    tr_f = egnn_jacobian_trace_fused(bb, t_in, x_in, 1.0)
    real = g_op.g_operator_contract
    g_op.g_operator_contract = lambda *args: torch.zeros_like(args[-1])  # t2 dropped
    try:
        _, tr_0 = ef.egnn_jacobian_trace(bb, t_in, x_in, 1.0, g_kernel=True)
    finally:
        g_op.g_operator_contract = real
    torch.cuda.synchronize()
    (rel_g, _), (rel_f, _), (share, _) = (rel_err(tr_g, tr_m), rel_err(tr_f, tr_m),
                                          rel_err(tr_0, tr_m))
    print(f"[phase 8] trace on random weights (N=55, F=32, 3 layers, f32), 16 chains, max "
          f"|trace| {float(tr_m.abs().max()):.3e}: dropping the G-operator term moves it by rel "
          f"{share:.3e}; K5 route against materialized rel {rel_g:.3e} (tol {share / 20:.3e}), "
          f"K2+K4 route rel {rel_f:.3e} (tol {TOL_TRACE_F32})")
    if not share >= 1e-4:
        fail("the G-operator term does not count on the random weights: the check is blind")
    if not (rel_g <= share / 20 and rel_f <= TOL_TRACE_F32):
        fail("the trace routes disagree on random weights")


ROUTES = {  # the three routes of divergence_mode="exact"
    "materialized": dict(),
    "g_kernel": dict(divergence_g_kernel=True),
    "tangent_kernel": dict(divergence_tangent_kernel=True),
}


def exact_cfg(**kw):
    from pita_torch.sampler import IntegratorConfig

    # bench.py:222-228 and :241-242: quadrature_k10 with
    # divergence_update_interval=10, exact with 1
    return IntegratorConfig(
        end_resampling_step=10 ** 9, resampling_interval=1, resample_at_end=False,
        should_mean_free=True, divergence_mode="exact", divergence_chunk_size=256,
    ).replace(**kw)


def phase_wiring(wl, wl32, data, kernels):
    """The exact divergence reaches the weights the same way by every route:
    the check that pita_tpu's G-operator kernel never passed on hardware."""
    import torch

    from pita_torch.sampler import integrate_sde

    # the last 8 steps of a 100-step schedule, from ground-truth samples noised
    # to the level of their start time
    n, t0 = 8, 0.08
    gen = torch.Generator("cuda").manual_seed(8)
    x1 = torch.as_tensor(data[:64], device="cuda")
    x1 = x1 + math.sqrt(wl.noise.h(t0)) * torch.randn(x1.shape, generator=gen, device="cuda")
    base = exact_cfg(num_integration_steps=n, end_resampling_step=n, time_range=t0,
                     ess_resampling_threshold=0.0, divergence_chunk_size=64)
    scalar = {"bf16": [0, 0, 0], "f32": [0, 0, 0]}  # of the scalar K2, K3 and K4 by backbone
    tf32 = [0, 0, 0]  # of the 3xTF32 K2, K3 and K4, f32 backbone
    for name, load in (("bf16", wl), ("f32", wl32)):
        res = {}
        for route, kw in ROUTES.items():
            reset_counts(kernels)
            res[route] = integrate_sde(x1, load.score, load.energy, load.noise, load.anneal,
                                       load.target, 1.0, base.replace(**kw), seed=9,
                                       device="cuda")
            torch.cuda.synchronize()
            counts = {f.__name__: f.launches for f in kernels}
            scalar[name][0] += counts["egnn_layer_forward"]
            scalar[name][1] += counts["egnn_layer_backward"]
            scalar[name][2] += counts["egnn_layer_tangent"]
            if name == "f32":
                tf32[0] += counts["egnn_layer_forward_tf32"]
                tf32[1] += counts["egnn_layer_backward_tf32"]
                tf32[2] += counts["egnn_layer_tangent_tf32"]
            # the K4 route: the tensor-core K4 with the bf16 backbone, the 3xTF32 with the f32
            k4, others = (("egnn_layer_tangent_tc", ("egnn_layer_tangent_tf32",))
                          if name == "bf16" else
                          ("egnn_layer_tangent_tf32", ("egnn_layer_tangent_tc",)))
            want = {"g_kernel": "g_operator_contract", "tangent_kernel": k4}
            if route in want and counts[want[route]] == 0:
                fail(f"the {route} route did not launch {want[route]}")
            if (any(counts[k] for k in others + ("egnn_layer_tangent",))
                    or (route != "tangent_kernel" and counts[k4])):
                fail(f"the {route} route ({name} backbone) launched a K4 it should not")
            if name == "f32" and 0 in (counts["egnn_layer_forward_tf32"],
                                       counts["egnn_layer_backward_tf32"]):
                fail(f"the {route} route (f32 backbone) did not launch the 3xTF32 K2 and K3")
            if counts["_contract_scalar"]:
                fail(f"the {route} route ({name} backbone) launched the scalar K5")
        ref = res["materialized"]
        if not torch.isfinite(ref.logweights).all():
            fail("wiring run produced non-finite log-weights")
        if int((ref.num_unique < 64).sum()) != 0:
            fail("resampling fired in the wiring run")
        lw_ref = ref.logweights[-1]
        for route in ("g_kernel", "tangent_kernel"):
            same = torch.equal(res[route].samples, ref.samples)
            rel, ab = rel_err(res[route].logweights[-1], lw_ref)
            # f32 forward mode is exact; G is bf16 in K5 whatever the backbone
            tol = TOL_TRACE_F32 if (name, route) == ("f32", "tangent_kernel") else TOL_TRACE_BF16
            print(f"[phase 8] wiring, {name} backbone, 64 chains x {n} steps, {route} against "
                  f"materialized: samples {'identical' if same else 'DIFFERENT'}; final "
                  f"log-weights max abs {ab:.3e} of max {float(lw_ref.abs().max()):.3e} "
                  f"= rel {rel:.3e} (tol {tol})")
            if not same:
                fail(f"the {route} route changed the samples ({name})")
            if not rel <= tol:
                fail(f"the {route} route's log-weights disagree with the materialized "
                     f"route's ({name})")
    print(f"[phase 8] launches of the scalar K2, K3, K4: f32 backbone's runs {scalar['f32']}, "
          f"bf16 backbone's runs {scalar['bf16']}; of the 3xTF32 K2, K3, K4: f32 backbone's "
          f"runs {tf32}")
    if 0 in tf32:
        fail("the f32 wiring runs did not launch the 3xTF32 K2, K3 and K4")
    if scalar["f32"] != [0, 0, 0]:
        fail("the f32 wiring runs (N = 55) launched the scalar K2, K3 or K4")
    if scalar["bf16"] != [0, 0, 0]:
        fail("the bf16 wiring runs launched a scalar EGCL kernel")
    return scalar["f32"], tf32


def timed_exact_run(wl, x1, cfg, label, kernels, profile):
    """One warm-up of 10 steps, then the timed run; returns (rate, counts)."""
    import torch

    from pita_torch.sampler import integrate_sde

    run = lambda c, seed: integrate_sde(x1, wl.score, wl.energy, wl.noise, wl.anneal,
                                        wl.target, 1.0, c, seed=seed, device="cuda")
    run(cfg.replace(num_integration_steps=10, end_resampling_step=10), 1)
    torch.cuda.synchronize()
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(cfg, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {f.__name__: f.launches for f in kernels}
    if not torch.isfinite(res.samples).all():
        fail(f"{label} produced non-finite samples")
    n_chains, n_steps = x1.shape[0], cfg.num_integration_steps
    rate = n_chains * n_steps / wall
    print(f"[phase 9] {label} {n_chains} chains x {n_steps} steps: {wall:.3f} s, "
          f"{rate:.1f} chain*steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {counts}; "
          f"unique ancestors after the last step {int(res.num_unique[-1])}")
    if (counts["egnn_layer_forward_tc"] == 0 or counts["egnn_layer_forward"]
            or counts["egnn_layer_forward_tf32"]):
        fail(f"{label} did not run the tensor-core EGCL forward kernel alone")
    if (counts["_contract_scalar"] or counts["egnn_layer_tangent"]
            or counts["egnn_layer_tangent_tf32"]):
        fail(f"{label} launched the scalar K5 or an f32 K4")
    if cfg.divergence_tangent_kernel:
        # the tensor-core K4 per divergence evaluation and chain chunk: 3
        # layers x 3 super-chunks of tangents (64, 64, 37)
        want = (9 * len(range(0, n_steps, cfg.divergence_update_interval))
                * -(-n_chains // cfg.divergence_chunk_size))
        print(f"[phase 9] {label}: tensor-core K4 launched {counts['egnn_layer_tangent_tc']} "
              f"times ({want} expected), the scalar K4 {counts['egnn_layer_tangent']}")
        if counts["egnn_layer_tangent_tc"] != want:
            fail(f"{label} did not launch the tensor-core K4 nine times per evaluation and chunk")
    elif counts["egnn_layer_tangent_tc"]:
        fail(f"{label} launched K4 off the K4 route")
    if cfg.divergence_g_kernel:
        # one tensor-core K5 per divergence evaluation and chain chunk
        want = (len(range(0, n_steps, cfg.divergence_update_interval))
                * -(-n_chains // cfg.divergence_chunk_size))
        print(f"[phase 9] {label}: tensor-core K5 launched {counts['g_operator_contract']} "
              f"times ({want} expected), the scalar K5 {counts['_contract_scalar']}")
        if counts["g_operator_contract"] != want:
            fail(f"{label} did not launch the tensor-core K5 once per evaluation and chunk")
    if profile:
        profile_main_path(wl, x1, cfg, label, plain_top=cfg.divergence_g_kernel)
    return rate, counts


def hutch_cfg(**kw):
    from pita_torch.sampler import IntegratorConfig

    # bench.py:222-235, mode hutch_ess_k10
    return IntegratorConfig(
        end_resampling_step=10 ** 9, resampling_interval=1, resample_at_end=False,
        should_mean_free=True, divergence_mode="hutchinson", hutchinson_probes=2,
        ess_resampling_threshold=0.5, divergence_update_interval=10,
    ).replace(**kw)


def reset_counts(ops):
    for f in ops:
        f.launches = 0


# the port's own kernels, by their names in a profile
OWN_KERNELS = ("egcl_fwd_kernel", "egcl_bwd_kernel", "egcl_fwd_tc_kernel", "egcl_bwd_tc_kernel",
               "egcl_fwd_f32tc_kernel", "egcl_tan_kernel", "egcl_tan_tc_kernel",
               "egcl_tan_f32tc_kernel", "g_op_kernel", "g_op_tc_kernel",
               "pack_panel_kernel", "lj_pairs_kernel", "lj_scalar_kernel")


def profile_main_path(wl, x1, cfg, label, plain_top=False):
    """torch.profiler over one run of a timed configuration: device time by
    kernel, and the device's busy share of the wall time. With ``plain_top``
    also the five largest PyTorch kernels (none of the port's own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pita_torch.sampler import integrate_sde

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        integrate_sde(x1, wl.score, wl.energy, wl.noise, wl.anneal, wl.target, 1.0, cfg,
                      seed=3, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3  # ms
    # kernel and memcpy rows only: an operator row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows)
    print(f"[profile] {label}, {cfg.num_integration_steps} steps x {x1.shape[0]} chains: wall "
          f"{wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms = "
          f"{100 * busy / wall_ms:.1f} %")
    own = lambda e: any(k in e.key for k in OWN_KERNELS)
    # the 14 largest rows, then the port's own kernels below them
    for i, e in enumerate(rows):
        if i < 14 or own(e):
            print(f"[profile] {dev(e):9.2f} ms  {100 * dev(e) / busy:5.1f} %  x{e.count:<5d} "
                  f"{e.key[:90]}")
    if plain_top:
        plain = [e for e in rows if not own(e)]
        print(f"[profile] {label}: PyTorch kernels {sum(dev(e) for e in plain):.1f} ms in all; "
              f"the five largest:")
        for e in plain[:5]:
            print(f"[profile]   {dev(e):9.2f} ms  x{e.count:<5d} {e.key[:160]}")


def quality(wl, data, seed, make_cfg=None, phase=5, label="hutch_ess_k10"):
    """bench.py's quality run (bench.py:303-345, 505-519): 512 chains x 400
    steps of the mode ``make_cfg`` builds (hutch_ess_k10 by default), final
    resample at step 360, 30 adaptive MALA steps; returns (energy W2 against
    ground truth, sigma_GT, whether the two arms of the gate pass)."""
    import numpy as np
    import torch

    from pita_torch.io.bench_asset import EXACT_ENERGIES_ASSET
    from pita_torch.metrics import emd_1d_unequal
    from pita_torch.sampler import integrate_sde

    nq, sq = 512, 400
    gen = torch.Generator("cuda").manual_seed(100 + seed)
    x1q = torch.randn(nq, 165, generator=gen, device="cuda") * wl.prior_scale
    cfg_q = (make_cfg or hutch_cfg)(
        num_integration_steps=sq, end_resampling_step=int(sq * 0.9), resample_at_end=True,
        post_mcmc_steps=30, adaptive_mcmc=True, dt_negative_time=5e-5)
    t0 = time.perf_counter()
    rq = integrate_sde(x1q, wl.score, wl.energy, wl.noise, wl.anneal, wl.target, 1.0,
                       cfg_q, seed=seed, device="cuda")
    torch.cuda.synchronize()
    wall_q = time.perf_counter() - t0
    if not torch.isfinite(rq.samples).all():
        fail("quality run produced non-finite samples")
    e = wl.target.log_prob(rq.samples).double().cpu().numpy()
    e_data = wl.target.log_prob(torch.as_tensor(data, device="cuda")).double().cpu().numpy()
    spread = float(np.std(e_data)) + 1e-9
    w2 = lambda a, b: math.sqrt(emd_1d_unequal(a, b, p=2))
    w2_gt = w2(e, e_data)
    e_exact = np.load(EXACT_ENERGIES_ASSET)
    w2_ex = w2(e_exact, e)
    exact_gt = w2(e_exact, e_data)
    gt_bound = min(2 * spread, exact_gt + 0.5 * spread)
    acc = rq.acceptance_rates.cpu().numpy()
    nu = rq.num_unique.cpu().numpy()
    print(f"[phase {phase}] quality {label} seed {seed}, {nq} chains x {sq} steps + 30 MALA: "
          f"{wall_q:.2f} s; "
          f"energy W2 vs ground truth {w2_gt:.4f}, vs exact population {w2_ex:.4f}, "
          f"exact vs ground truth {exact_gt:.4f}, sigma_GT {spread:.4f}, "
          f"bench gate bound {gt_bound:.4f} (GT arm {'pass' if w2_gt < gt_bound else 'miss'}, "
          f"exact arm {'pass' if w2_ex < 0.5 * spread else 'miss'}); "
          f"resampling fired {int((nu[:-1] < nq).sum())} times, unique ancestors at the end "
          f"{int(nu[-1])}; MALA acceptance first/last {acc[0]:.3f}/{acc[-1]:.3f}; "
          f"lowest log-prob {e.min():.1f} (ground truth {e_data.min():.1f}), "
          f"{int((e < e_data.min()).sum())} samples below the ground truth's lowest")
    return w2_gt, spread, (w2_gt < gt_bound, w2_ex < 0.5 * spread)


def trace_outlier(wl, data, seed, n_low=5):
    """Phase 5's quality run at one seed, split at the end of the SDE, so that
    the final resample and the 30 MALA steps can be followed chain by chain
    with the same draws: the log-prob by K1 and by the plain ``lj_energy`` in
    float64 at the end of the SDE, after the final resample, after each MALA
    step and at each accepted proposal, for the lowest final sample and the
    ``n_low`` lowest. Checks that the split run ends where the whole one
    does. Returns the largest relative gap between K1 and the plain energy
    over every configuration it saw."""
    import numpy as np
    import torch

    from pita_torch.ops.lj import lj_energy
    from pita_torch.ops.resampling import systematic_resample
    from pita_torch.sampler import integrate_sde
    from pita_torch.sampler.integrator import GeneratorDraws
    from pita_torch.utils.mean_free import remove_mean

    tgt = wl.target
    N, T = tgt.n_particles, tgt.temperature
    nq, sq = 512, 400
    gen = torch.Generator("cuda").manual_seed(100 + seed)
    x1q = torch.randn(nq, 165, generator=gen, device="cuda") * wl.prior_scale
    cfg_q = hutch_cfg(num_integration_steps=sq, end_resampling_step=int(sq * 0.9),
                      resample_at_end=True, post_mcmc_steps=30, adaptive_mcmc=True,
                      dt_negative_time=5e-5)
    whole = integrate_sde(x1q, wl.score, wl.energy, wl.noise, wl.anneal, tgt, 1.0, cfg_q,
                          seed=seed, device="cuda")
    draws = GeneratorDraws(torch.Generator("cuda").manual_seed(seed))
    sde = integrate_sde(x1q, wl.score, wl.energy, wl.noise, wl.anneal, tgt, 1.0,
                        cfg_q.replace(resample_at_end=False, post_mcmc_steps=0), draws=draws,
                        device="cuda")

    def both(x):  # (K1 log-prob, plain float64 log-prob), on the host
        lp_k1, _ = tgt.log_prob_and_force(x)
        lp64 = -lj_energy(x.double(), N, tgt.eps, tgt.rm, tgt._osc, tgt.energy_factor,
                          tgt.spline) / T
        return lp_k1.double().cpu().numpy(), lp64.cpu().numpy()

    points = {}
    x = sde.samples
    points["sde_end"] = both(x)
    times = torch.linspace(1.0, 0.0, sq + 1, device="cuda")[:-1]
    t_end = times[min(cfg_q.end_resampling_step, sq - 1)].expand(nq)
    with torch.no_grad():
        model_energy = wl.energy.energy(wl.noise.h(t_end), x, 1.0)
    logq0 = -model_energy * wl.anneal.gamma(t_end)
    a_end = tgt.log_prob(x) - logq0 + sde.logweights[-1]
    a_end = torch.minimum(a_end, torch.quantile(a_end, 0.9))
    choice = systematic_resample(a_end, draws.end_u0())
    x = x[choice]
    points["resampled"] = both(x)

    # integrator.mala, step for step, with each state's two log-probs kept
    lp, force = tgt.log_prob_and_force(x)
    valid = torch.isfinite(lp)
    n_valid = torch.clamp(valid.sum(), min=1)
    dt = torch.full((), cfg_q.dt_negative_time, device="cuda")
    accepted = []  # per step: (chain indices, K1 and plain log-prob of the proposals)
    for k in range(cfg_q.post_mcmc_steps):
        noise = draws.mala_noise(k, x.shape)
        u = draws.mala_uniform(k, lp.shape)
        prop = x + 0.5 * dt * force + torch.sqrt(dt) * noise
        lp_prop, force_prop = tgt.log_prob_and_force(prop)
        log_q_fwd = -((prop - (x + 0.5 * dt * force)) ** 2).sum(-1) / (2 * dt)
        log_q_bwd = -((x - (prop + 0.5 * dt * force_prop)) ** 2).sum(-1) / (2 * dt)
        accept = (torch.log(u) < (lp_prop - lp) + (log_q_bwd - log_q_fwd)) & valid
        acc_rate = accept.sum() / n_valid
        idx = accept.nonzero()[:, 0]
        accepted.append((idx.cpu().numpy(), *both(prop[idx])))
        x_new = torch.where(accept[:, None], prop, x)
        x = torch.where(valid[:, None], remove_mean(x_new, N, 3), x_new)
        lp = torch.where(accept, lp_prop, lp)
        force = torch.where(accept[:, None], force_prop, force)
        dt = torch.where(acc_rate > 0.55, dt * 1.1, dt / 1.1)
        points[f"mala_{k}"] = both(x)
    same = float((x - whole.samples).abs().max())
    print(f"[outlier] seed {seed}: the split run ends {same:.3e} from the whole run "
          f"(max |x| difference)")

    # the tolerance's measure: max |K1 - plain| / max |plain| over each batch
    rel = lambda a, b: np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    worst = max(float(rel(*v)) for v in points.values())
    worst = max([worst] + [float(rel(a, b)) for _, a, b in accepted if len(a)])
    abs_worst = max(float(np.abs(a - b).max()) for a, b in points.values())
    e_data = tgt.log_prob(torch.as_tensor(data, device="cuda")).double().cpu().numpy()
    fin64 = points[f"mala_{cfg_q.post_mcmc_steps - 1}"][1]
    low = np.argsort(fin64)[:n_low]
    choice_np = choice.cpu().numpy()
    print(f"[outlier] K1 against the plain float64 energy over every state and accepted "
          f"proposal: worst relative gap {worst:.3e} (K1's tolerance {TOL_LJ:.0e}), worst "
          f"absolute {abs_worst:.4f}; ground truth's lowest log-prob {e_data.min():.2f}; "
          f"final samples below it {int((fin64 < e_data.min()).sum())}")
    sde64 = points["sde_end"][1]
    print(f"[outlier] at the end of the SDE {int((sde64 < e_data.min()).sum())} of {nq} "
          f"chains lie below the ground truth's lowest (lowest {sde64.min():.2f}); the final "
          f"resample kept {len(np.unique(choice_np))} ancestors")
    for rank, c in enumerate(low):
        anc = int(choice_np[c])
        k1_sde, p_sde = points["sde_end"][0][anc], points["sde_end"][1][anc]
        k1_res, p_res = points["resampled"][0][c], points["resampled"][1][c]
        mala = [(points[f"mala_{k}"][0][c], points[f"mala_{k}"][1][c])
                for k in range(cfg_q.post_mcmc_steps)]
        acc = [(k, a[list(i).index(c)], b[list(i).index(c)])
               for k, (i, a, b) in enumerate(accepted) if c in i]
        print(f"[outlier] #{rank} chain {c} (ancestor {anc}, its SDE weight {float(a_end[anc]):.2f}"
              f", {int((choice_np == anc).sum())} copies): SDE end K1 {k1_sde:.3f} plain "
              f"{p_sde:.3f}; resampled K1 {k1_res:.3f} plain {p_res:.3f}; MALA K1/plain "
              + " ".join(f"{a:.2f}/{b:.2f}" for a, b in mala)
              + f"; {len(acc)} accepted proposals: "
              + " ".join(f"s{k}:{a:.2f}/{b:.2f}" for k, a, b in acc))
    return worst


# ---------------------------------------------------------------- phase 11

# one training step on the card against the same step on the CPU, same state
# and draws: f32 sums in other orders through a second derivative (the CPU
# port and pita_tpu agree within 2e-5 on the losses, tests/test_torch_train.py)
TOL_STEP = 1e-4
STEP_CPU_BATCH = 64  # the compared step's batch: the CPU's time, not the card's


def lj55_train_cfg(tmp):
    """The lj55 preset (N = 55, hidden 32, 3 layers, f32), cut for this
    script: 2 epochs of 25 batches of 256, a 256-chain, 100-step transition
    fill through the K4 route with no escalated retry."""
    from pita_torch.configs import compose

    return compose("lj55", overrides={
        "out_dir": tmp, "energy.data_dir": os.path.join(tmp, "data"),
        "trainer.n_train_batches_per_epoch": 25,
        "trainer.num_temp_annealed_samples": 256,
        "trainer.transition_fill_max_retries": 0,
        "integrator.num_integration_steps": 100,
        "integrator.end_resampling_step": 90,
        "integrator.pallas_divergence": True,
        "logger": ("csv",),
    })


def profiled_ms(run, key, n=50, tries=2):
    """Device time alone per launch of the kernels whose name holds ``key``
    over ``n`` calls of ``run`` (torch.profiler); None when ``tries``
    profiles in a row hold no such row (now and then one profile of a
    series comes back without the kernels' rows, so a miss is taken again)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / sum(e.count for e in rows)
    return None


def k1_entry(target, x, label, launches, phase=11, n_ref=None):
    """K1 against its plain version at the shape x (on its first ``n_ref``
    rows when given: the plain version holds (B, N, N) tensors, 6 GB each at
    512,000 rows), its CUDA-event and profiled time per launch, the plain
    version's time (in chunks of ``n_ref``) and its bound (lj_bound, as
    phase 2 counts it). Returns the kernels-line entry and the device time."""
    import torch

    from pita_torch.ops import lj as ljop

    N, B = target.n_particles, x.shape[0]
    n_ref = n_ref or B
    kw = lj_kwargs(target)
    plain = lambda y: ljop.lj_log_prob_and_force_plain(y, N, **kw)
    lp_k, f_k = ljop.lj_log_prob_and_force(x, N, **kw)
    lp_p, f_p = plain(x[:n_ref])
    torch.cuda.synchronize()
    (r_lp, a_lp), (r_f, a_f) = rel_err(lp_k[:n_ref], lp_p), rel_err(f_k[:n_ref], f_p)
    if not (r_lp <= TOL_LJ and r_f <= TOL_LJ):
        fail(f"K1 disagrees with its plain version at {label}")
    run = lambda: ljop.lj_log_prob_and_force(x, N, **kw)
    ms = cuda_ms(run, reps=50)
    dev_ms = profiled_ms(run, "lj_pairs_kernel")
    # the floor of a launch on the device: a one-element PyTorch add
    one = torch.zeros(1, device=x.device)
    floor_ms = profiled_ms(lambda: one.add_(1.0), "elementwise")
    plain_ms = cuda_ms(lambda: [plain(x[i:i + n_ref]) for i in range(0, B, n_ref)], reps=5)
    bnd, by = lj_bound(x, target, label, phase)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ms_or = lambda v: "not measured (no kernel row)" if v is None else f"{v:.4f} ms"
    dev, floor = ms_or(dev_ms), ms_or(floor_ms)
    print(f"[phase {phase}] K1 at {label} (B={B}, {ljop.lanes_per_particle(N, B, sms)} lanes a "
          f"particle on {sms} SMs): rel err on the first {n_ref} logp {r_lp:.2e} force "
          f"{r_f:.2e} (tol {TOL_LJ}); {ms:.4f} ms a launch by CUDA events, device time alone "
          f"{dev} (torch.profiler; a one-element add's {floor}), plain {plain_ms:.4f} ms (in "
          f"chunks of {n_ref}), bound {bnd:.5f} ms ({by}); {launches} launches")
    if dev_ms is None:
        fail(f"K1's device time at {label} was not measured (no lj_pairs_kernel row)")
    return dict(name=f"lj_log_prob_and_force ({label})", route="cuda",
                source="pita_torch/csrc/lj.cu", replaces="pita_tpu/ops/pallas/lj.py:108",
                launches=launches, max_abs_err=max(a_lp, a_f), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None), dev_ms


class _FirstK1:
    """A target whose log_prob_and_force runs the first K1 (the yardstick)."""

    def __init__(self, target):
        self.target = target

    def __getattr__(self, name):
        return getattr(self.target, name)

    def log_prob_and_force(self, x):
        from pita_torch.ops import lj as ljop

        return ljop._lj_scalar(x, self.target.n_particles, **lj_kwargs(self.target))


def train_set_in_turns(target):
    """The rung-0 train set's generator (seed 101, 10,000 samples, 512
    chains) by each K1 in turns, first, new, new, first: seconds and
    launches. The MALA step's host time around K1 sets its pace."""
    import torch

    from pita_torch.baselines.mcmc import generate_lj_dataset
    from pita_torch.ops import lj as ljop

    secs = {"first": [], "new": []}
    for which in ("first", "new", "new", "first"):
        before = (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_lj_dataset(_FirstK1(target) if which == "first" else target, 10000, seed=101,
                            device="cuda")
        torch.cuda.synchronize()
        secs[which].append(time.perf_counter() - t0)
        n = (ljop.lj_log_prob_and_force.launches - before[0], ljop._lj_scalar.launches - before[1])
        if n != ((0, 18027) if which == "first" else (18027, 0)):
            fail(f"the train set by the {which} K1 launched (new, first) = {n} K1s")
    print("[phase 11] train set by each K1 in turns (first, new, new, first; 18,027 launches "
          "each): " + ", ".join(f"{w} {' / '.join(f'{v:.2f}' for v in secs[w])} s"
                                for w in secs))


def layer0_inputs(tr, x_flat):
    """The EMA score net's layer 0 at t = 0.5 on the chains x_flat: its
    inputs h, x, edge_attr, its weights, config, packed weights and the
    3xTF32 kernels' matrices."""
    import torch

    from pita_torch.nets.precondition import coeffs

    bb = tr.ema_score.module
    layer = bb.layers[0]
    B, N = x_flat.shape[0], tr.n_particles
    ht = tr.noise_schedule.h(torch.full((B,), 0.5, device=x_flat.device))
    _, c_in, _, c_noise = coeffs(ht)
    x_in = c_in[:, None] * x_flat
    xs = x_in.reshape(B, N, 3).contiguous()
    h = bb.embed(c_noise, x_in, 1.0).contiguous()
    ea = ((xs[:, :, None] - xs[:, None]) ** 2).sum(-1).contiguous()
    dev = x_flat.device
    return h, xs, ea, layer.weights(), layer.cfg, layer.packed(dev), layer.packed(dev, tc=True)


def fill_layer_entries(tr, x_flat, counts):
    """The f32 K2, K3 and K4 at the fill's launches (256 chains for the
    drift's networks; 64-chain chunks of 64 tangents for the K4 route), on
    the EMA score net's layer 0: the 3xTF32 K2, K3 and K4 against their
    plain versions and timed in turns with their scalar yardsticks."""
    import torch

    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    h, xs, ea, w, cfg, packed, ptc = layer0_inputs(tr, x_flat)
    (_, N, F), dev = h.shape, h.device
    gen = torch.Generator(dev).manual_seed(11)
    gh = torch.randn(h.shape, generator=gen, device=dev)
    gx = torch.randn(xs.shape, generator=gen, device=dev)
    k3, _ = k3_f32_in_turns(el, (h, xs, ea, gh, gx), w, cfg, packed, ptc,
                            "the fill's launch, trained EMA weights", 11)
    k2, _ = k2_f32_in_turns(el, h, xs, ea, w, cfg, packed, ptc,
                            "the fill's launch, trained EMA weights", 11)
    Tc, Bc = 64, 64
    basis = torch.eye(N * 3, device=dev)[:Tc].reshape(Tc, N, 3).contiguous()
    dh = torch.zeros(Bc, Tc, N, F, device=dev)
    dx = basis[None].expand(Bc, -1, -1, -1).contiguous()
    targs = (h[:Bc], xs[:Bc], ea[:Bc], xs[:Bc], basis, dh, dx)
    k4, _ = tangent_f32_in_turns(et, targs, w, cfg, packed, ptc, phase=11,
                                 label=f"the fill's launch (B={Bc}, Tc={Tc}), trained EMA weights")
    src = "pita_torch/csrc/"
    mk = lambda name, file, rep, launches, fields: dict(
        name=f"{name} (phase 11 fill)", route="cuda", source=src + file,
        replaces=f"pita_tpu/ops/pallas/egnn_fwd.py:{rep}", launches=launches, **fields)
    return [
        mk("egcl_forward_tf32", "egnn_layer_f32tc.cu", 318, counts["egnn_layer_forward_tf32"], k2),
        mk("egcl_backward_tf32", "egnn_layer_bwd_f32tc.cu", 342,
           counts["egnn_layer_backward_tf32"], k3),
        mk("egcl_tangent_tf32", "egnn_tangent_f32tc.cu", 365, counts["egnn_layer_tangent_tf32"],
           k4),
    ]


def same_state(a, b):
    """Whether two trainer states are equal, every tensor bitwise."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def profile_steps(label, step, n, top=12):
    """torch.profiler over ``n`` calls of ``step``: wall and device-busy ms a
    call, printed with the largest kernels a call. Returns (wall ms, busy
    ms, kernel rows, the rows' device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host's operator events add nothing to the
    # device time and multiply the trace's processing (on an H100, 3 aldp
    # training steps: 33 s with them, 15 s without)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = lambda e: e.self_device_time_total / 1e3
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows) / n
    print(f"[profile] {label}, {n} calls: {wall_ms:.1f} ms a call (profiled), device busy "
          f"{busy:.1f} ms = {100 * busy / wall_ms:.1f} %, {sum(e.count for e in rows) // n} "
          f"kernels a call; {time.perf_counter() - t0:.1f} s with the profile's processing")
    for e in rows[:top]:
        print(f"[profile] {dev(e) / n:9.3f} ms a call  {100 * dev(e) / n / busy:5.1f} %  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    return wall_ms, busy, rows, dev


def profile_training(tr, n=5):
    """torch.profiler over ``n`` training steps."""
    return profile_steps(f"training, steps of {tr.cfg.training_batch_size}",
                         lambda: tr.train_step(0), n)


def phase_training(kernels, tmp, profile=False):
    """Phase 11: the LJ55 training ladder on the card through
    pita_torch.configs.build_trainer, its data sets and checkpoint under
    ``tmp``. Returns the kernels-line entries and the checkpoint's path;
    with ``profile`` also a torch.profiler breakdown of training steps."""
    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.io import checkpoint
    from pita_torch.sampler import integrate_sde
    from pita_torch.train.losses import LossDraws
    from pita_torch.train.trainer import StepDraws

    counts = lambda: {f.__name__: f.launches for f in kernels}
    cfg = lj55_train_cfg(tmp)
    tr = build_trainer(cfg, device="cuda")
    print(f"[phase 11] lj55: N={tr.n_particles}, hidden {cfg.net['hidden_nf']}, "
          f"{cfg.net['n_layers']} layers, batch {cfg.trainer.training_batch_size}, ladder "
          f"{tuple(cfg.trainer.temperatures)}, f32, route {tr.score_net.route}")

    # 1. the rung-0 train set (512 chains, 2000 Adam steps, 12,000 MALA
    # warmup steps, 20 rounds of 200), then the buffer's energies and forces
    reset_counts(kernels)
    t0 = time.perf_counter()
    tr.populate_initial_buffer()
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t0
    k1_set = counts()["lj_log_prob_and_force"]
    data = tr.targets[0]._train_set
    e_set = -tr.targets[0].temperature * tr.buffers.energy[0, :int(tr.buffers.size[0])]
    print(f"[phase 11] train set at T={tr.temperatures[0]}: {data.shape[0]} samples and "
          f"the rung-0 buffer in {t_set:.2f} s, K1 launched {k1_set} times (the last for "
          f"the buffer's {int(tr.buffers.size[0])} rows); buffer energy mean "
          f"{float(e_set.mean()):.4f}, std {float(e_set.std()):.4f}, min "
          f"{float(e_set.min()):.4f}, max {float(e_set.max()):.4f}")
    if k1_set == 0 or not bool(torch.isfinite(e_set).all()) or float(e_set.max()) > 1e3:
        fail("the train set did not run through K1 or has non-finite or unhealthy energies")
    if counts()["_lj_scalar"]:
        fail("the train set launched the first K1")
    train_set_in_turns(tr.targets[0])

    # 2. training: 2 epochs x 25 batches of 256, autograd route
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epochs = [tr.train_one_epoch() for _ in range(2)]
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    n_steps = 2 * cfg.trainer.n_train_batches_per_epoch
    print(f"[phase 11] training: {n_steps} steps in {t_train:.3f} s, "
          f"{1e3 * t_train / n_steps:.2f} ms a step; losses by epoch "
          + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in e.items()) for e in epochs)
          + f"; kernel launches {counts()}")
    if not all(math.isfinite(v) for e in epochs for v in e.values()):
        fail("a training loss is not finite")
    if any(counts().values()):
        fail("the autograd training route launched a kernel")
    if profile:
        profile_training(tr)
    # the same step on the card and on the CPU, same state and draws
    state = tr.state_dict()
    state.pop("generator")
    d = tr.draw_step(0)
    nb = STEP_CPU_BATCH
    d = StepDraws(d.idx[:nb], d.rot_normal[:nb], None,
                  LossDraws(d.loss.ln_sigma_draw[:nb], d.loss.noise[:nb]))
    cpu_tr = build_trainer(cfg, device="cpu")
    cpu_tr.load_state_dict(state)
    cpu_d = StepDraws(*(None if v is None else v.cpu() for v in d[:3]),
                      LossDraws(*(v.cpu() for v in d.loss[:2])))
    packed_before = tr.ema_score.module.layers[0].packed(torch.device("cuda")).clone()
    aux_c, gn_c = tr.train_step(0, draws=d)
    t0 = time.perf_counter()
    aux_h, gn_h = cpu_tr.train_step(0, draws=cpu_d)
    t_cpu = time.perf_counter() - t0
    worst = 0.0
    for k in aux_h:
        a, b = float(aux_c[k]), float(aux_h[k])
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    g_rel = abs(float(gn_c) - float(gn_h)) / float(gn_h)
    print(f"[phase 11] one step at batch {nb}, card against CPU ({t_cpu:.2f} s there): "
          f"losses max rel err {worst:.2e}, global gradient norm {float(gn_c):.6g} / "
          f"{float(gn_h):.6g} rel err {g_rel:.2e} (tol {TOL_STEP})")
    if not (worst <= TOL_STEP and g_rel <= TOL_STEP):
        fail("a training step on the card disagrees with the same step on the CPU")
    del cpu_tr
    # the sampler's kernels see the updated EMA weights
    if torch.equal(packed_before, tr.ema_score.module.layers[0].packed(torch.device("cuda"))):
        fail("the EMA update did not repack the layer's kernel weights")

    # 3. one rung transition: the val set of rung 1 first (its own K1
    # launches), then evaluate at the first transition epoch
    t0 = time.perf_counter()
    tr.targets[1].sample_val_set(1, tr.generator)
    torch.cuda.synchronize()
    print(f"[phase 11] val set at T={tr.temperatures[1]}: {time.perf_counter() - t0:.2f} s")
    x_fill = tr.targets[0].sample_train_set(256, tr.generator)
    tr.epoch = int(tr.update_temp_epoch[0]) - 1
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = tr.evaluate("val")
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    fill_counts = counts()
    buf1 = int(tr.buffers.size[1])
    print(f"[phase 11] transition fill T={tr.temperatures[0]} -> {tr.temperatures[1]} "
          f"(K4 route, 256 chains x 100 steps + the 256-chain no-resampling pass): "
          f"{t_fill:.2f} s; launches {fill_counts}; rung-1 buffer {buf1} rows; "
          + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    for k in ("lj_log_prob_and_force", "egnn_layer_forward_tf32", "egnn_layer_backward_tf32",
              "egnn_layer_tangent_tf32"):
        if fill_counts[k] == 0:
            fail(f"the f32 fill did not launch {k}")
    for k in ("egnn_layer_forward", "egnn_layer_backward", "egnn_layer_tangent",
              "egnn_layer_forward_tc",
              "egnn_layer_backward_tc", "egnn_layer_tangent_tc", "g_operator_contract",
              "_contract_scalar", "_lj_scalar"):
        if fill_counts[k]:
            fail(f"the f32 fill launched {k}")
    if buf1 == 0 or not math.isfinite(m["val/ess"]) or not math.isfinite(
            m["val/energy_mean"]):
        fail("the fill left the rung-1 buffer empty or its weights or energies not finite")
    if not bool(torch.isfinite(tr.buffers.energy[1, :buf1]).all()):
        fail("the filled buffer holds non-finite energies")
    layer_rows = fill_layer_entries(tr, x_fill, fill_counts)
    rows = [k1_entry(tr.targets[0], torch.as_tensor(data[:512], device="cuda"),
                     "train-set MCMC, 512 chains", k1_set)[0],
            k1_entry(tr.targets[1], x_fill, "fill, 256 chains",
                     fill_counts["lj_log_prob_and_force"])[0]] + layer_rows
    # what one step of the fill costs by route, 256 chains, the EMA nets
    nets = tr._eval_wrappers()
    anneal = tr.make_annealing(float(tr.inverse_temperatures[1] / tr.inverse_temperatures[0]))
    x1 = tr._prior(1.0).sample(256, generator=tr.generator, device="cuda")
    # (before: the K4 route with the scalar f32 K2, K3 and K4, the rule
    # patched off in this script for that run)
    route_s = {}
    for route, kw in (("K4, scalar f32 K2, K3 and K4 (before)",
                       dict(divergence_tangent_kernel=True)),
                      ("K4", dict(divergence_tangent_kernel=True)),
                      ("K5", dict(divergence_tangent_kernel=False, divergence_g_kernel=True)),
                      ("materialized", dict(divergence_tangent_kernel=False))):
        c10 = cfg.integrator.replace(num_integration_steps=10, end_resampling_step=9,
                                     resample_at_end=False, **kw)
        with scalar_f32_kernels() if "before" in route else contextlib.nullcontext():
            integrate_sde(x1, *nets, tr.noise_schedule, anneal, tr.targets[1], 1.0,
                          c10.replace(num_integration_steps=1, end_resampling_step=1),
                          seed=1, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            integrate_sde(x1, *nets, tr.noise_schedule, anneal, tr.targets[1], 1.0, c10,
                          seed=2, device="cuda")
            torch.cuda.synchronize()
            route_s[route] = (time.perf_counter() - t0) / 10
    print("[phase 11] one f32 fill step, 256 chains (10 steps timed): "
          + ", ".join(f"{r} route {1e3 * s:.1f} ms" for r, s in route_s.items()))
    # the f32 K4's launches a step, by torch.profiler over the K4 route's 10
    # steps, beside the wrapper's counter
    from torch.profiler import ProfilerActivity, profile

    c10 = cfg.integrator.replace(num_integration_steps=10, end_resampling_step=9,
                                 resample_at_end=False, divergence_tangent_kernel=True)
    reset_counts(kernels)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        integrate_sde(x1, *nets, tr.noise_schedule, anneal, tr.targets[1], 1.0, c10, seed=2,
                      device="cuda")
        torch.cuda.synchronize()
    n_prof = sum(e.count for e in prof.key_averages() if "egcl_tan_f32tc_kernel" in e.key)
    n_count = counts()["egnn_layer_tangent_tf32"]
    print(f"[phase 11] f32 K4 launches over 10 steps of the K4 route at 256 chains: "
          f"{n_prof} by torch.profiler (egcl_tan_f32tc_kernel), {n_count} by the counter; the "
          f"fill above launched it {fill_counts['egnn_layer_tangent_tf32']} times")
    if n_prof != n_count:
        fail("the profiler and the counter disagree on the f32 K4's launches")

    # 4. checkpoint: save, restore into a fresh trainer, compare; save over
    # it; an interrupted save leaves the previous one readable
    path = os.path.join(tmp, "ckpt", "lj55.pt")
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(tr, path)
    t_save = time.perf_counter() - t0
    fresh = build_trainer(cfg, device="cuda")
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(fresh, path)
    t_load = time.perf_counter() - t0
    if not same_state(fresh.state_dict(), tr.state_dict()):
        fail("a restored checkpoint differs from the saved state")
    tr.train_step(1)
    checkpoint.save_checkpoint(tr, path)
    second = tr.state_dict()
    tr.train_step(1)
    write = checkpoint._write

    def torn(state, p):
        with open(p, "wb") as f:
            f.write(b"torn")
        raise OSError("simulated failure before the rename")

    checkpoint._write = torn
    try:
        checkpoint.save_checkpoint(tr, path)
        fail("the simulated interrupted save did not raise")
    except OSError:
        pass
    finally:
        checkpoint._write = write
    checkpoint.restore_checkpoint(fresh, path)
    if not same_state(fresh.state_dict(), second):
        fail("an interrupted save did not leave the previous checkpoint whole")
    print(f"[phase 11] checkpoint {os.path.getsize(path) / 2 ** 20:.1f} MiB: saved in "
          f"{t_save:.2f} s, restored in {t_load:.2f} s into a fresh trainer, every tensor "
          f"equal; saved over, then an interrupted save left the previous one whole "
          f"({sorted(os.listdir(os.path.dirname(path)))})")
    del fresh
    return rows, path


# ---------------------------------------------------------------- phase 12

# the iDEM target by K1 against the plain version on the first chains'
# probes: its softmax weights magnify K1's log p error (<= TOL_LJ)
TOL_IDEM = 1e-3
IDEM_REF_CHAINS = 8  # the plain version's slice: 8 chains x 1,000 probes


def lj55_dem_cfg(tmp, data_dir):
    """The lj55 preset for the DEM phase, cut in count only: 10 DEM steps an
    epoch (the preset: 250); the refill's 2,000 chains in one integrate call
    (max_chains_per_integrate 2048 for the preset's 1024)."""
    from pita_torch.configs import compose

    return compose("lj55", overrides={
        "out_dir": os.path.join(tmp, "dem"), "energy.data_dir": data_dir,
        "trainer.n_train_batches_per_epoch": 10,
        "trainer.max_chains_per_integrate": 2048,
        "logger": ("csv",),
    })


def idem_inputs(tr):
    """One DEM step's noised batch xt (512 chains), its noise levels and its
    1,000 probes a chain, as pretrain_loss builds them; also the noise added
    to the mean-free batch, and the draws."""
    import torch

    from pita_torch.train.augment import rotate_augment
    from pita_torch.train.buffer import buffer_sample, buffer_view
    from pita_torch.utils.mean_free import remove_mean

    dem = tr.dem_cfg
    d = tr.dem_draw_step()
    x0, _, f0, _ = buffer_sample(buffer_view(tr.buffers, 0), dem.training_batch_size, idx=d.idx)
    x0, _ = rotate_augment(x0, f0, 55, 3, normal=d.rot_normal)
    ht = torch.exp(2 * dem.noise_schedule.sample_ln_sigma(x0.shape[0], d.loss.ln_sigma_draw))
    noise = remove_mean(d.loss.noise, 55, 3) * torch.sqrt(ht)[:, None]
    return remove_mean(x0, 55, 3) + noise, ht, d.loss.mc_eps, noise, d


def refill_k2_entry(tr, x_flat, launches):
    """The f32 K2 at the refill's launch (2,000 chains) on the EMA score
    net's layer 0 at t = 0.5: the 3xTF32 kernel and the scalar yardstick
    against layer_step, timed in turns, the bound."""
    from pita_torch.ops import egnn_layer as el

    h, xs, ea, w, cfg, packed, ptc = layer0_inputs(tr, x_flat)
    k2, _ = k2_f32_in_turns(el, h, xs, ea, w, cfg, packed, ptc,
                            f"the refill's launch ({h.shape[0]} chains, EMA score net)", 12)
    print(f"[phase 12] the 3xTF32 K2 launched {launches} times in the refill")
    return dict(name=f"egcl_forward_tf32 (phase 12 DEM refill, {h.shape[0]} chains)", route="cuda",
                source="pita_torch/csrc/egnn_layer_f32tc.cu",
                replaces="pita_tpu/ops/pallas/egnn_fwd.py:318", launches=launches, **k2)


def profile_dem_steps(tr, n=3):
    """torch.profiler over ``n`` DEM steps: wall and device busy time a step,
    K1's device time a step and its share of each."""
    wall_ms, busy, rows, dev = profile_steps("DEM steps", tr.dem_train_step, n, top=8)
    k1 = sum(dev(e) for e in rows if "lj_pairs_kernel" in e.key) / n
    print(f"[phase 12] profile of {n} DEM steps: {wall_ms:.1f} ms a step (profiled), device busy "
          f"{busy:.1f} ms = {100 * busy / wall_ms:.1f} %; K1 {k1:.4f} ms a step = "
          f"{100 * k1 / busy:.3f} % of busy, {100 * k1 / wall_ms:.3f} % of the step")
    return wall_ms


def phase_dem(kernels, tmp, data_dir):
    """Phase 12, DEM: 2 epochs of iDEM pretraining on the lj55 preset through
    fit, with one refill of buffer 0; then the iDEM target and the
    force-based loss held against their plain and CPU versions. Returns the
    kernels-line entries and the trainer."""
    import csv

    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.ops import lj as ljop
    from pita_torch.train.dem import DEMConfig, DEMDraws, pretrain_loss
    from pita_torch.train.dem_estimator import estimate_grad_Rt
    from pita_torch.utils.mean_free import remove_mean

    counts = lambda: {f.__name__: f.launches for f in kernels}
    cfg = lj55_dem_cfg(tmp, data_dir)
    dem = DEMConfig(num_training_epochs=2, use_mc_target=True, check_val_every_n_epochs=1)
    tr = build_trainer(cfg, dem_cfg=dem, device="cuda")
    target0 = tr.targets[0]
    print(f"[phase 12] lj55 + DEM: N={tr.n_particles}, hidden {cfg.net['hidden_nf']}, "
          f"{cfg.net['n_layers']} layers, f32; {dem}; n_train_batches_per_epoch "
          f"{cfg.trainer.n_train_batches_per_epoch} (the preset: 250), max_chains_per_integrate "
          f"{cfg.trainer.max_chains_per_integrate} (the preset: 1024)")
    t0 = time.perf_counter()
    target0.sample_val_set(1, tr.generator)  # read by the refill's metrics
    torch.cuda.synchronize()
    print(f"[phase 12] val set at T={target0.temperature}: {time.perf_counter() - t0:.2f} s")

    # every K1 launch of fit goes through target 0: record its batch sizes
    sizes, lpf = [], target0.log_prob_and_force

    def recorded(x):
        sizes.append(x.shape[0])
        return lpf(x)

    target0.log_prob_and_force = recorded
    refill_s, refill = [], tr.eval_epoch_end_dem

    def timed_refill(*a, **k):
        t = time.perf_counter()
        out = refill(*a, **k)
        torch.cuda.synchronize()
        refill_s.append(time.perf_counter() - t)
        return out

    tr.eval_epoch_end_dem = timed_refill
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = tr.fit(max_epochs=2, log_every=1)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fit_counts = counts()
    del target0.log_prob_and_force, tr.eval_epoch_end_dem
    with open(os.path.join(tr.out_dir, "metrics.csv"), newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train/pretrain_target_score_loss")]
    losses = [float(r["train/pretrain_target_score_loss"]) for r in rows]
    epoch_s = [float(r["train/epoch_s"]) for r in rows]
    n_b = cfg.trainer.n_train_batches_per_epoch
    B, K = dem.training_batch_size, dem.num_mc_samples
    n_init, size0 = cfg.trainer.num_init_samples, int(tr.buffers.size[0])
    n_refill = dem.num_samples_to_generate_per_epoch
    dem_m = [m for m in history if any(k.startswith("val/dem/") for k in m)]
    print(f"[phase 12] fit, 2 DEM epochs x {n_b} steps of {B} (iDEM, {K} probes a chain) and one "
          f"refill ({n_refill} chains x {dem.num_integration_steps} plain-SDE steps): "
          f"{t_fit:.2f} s; epochs "
          + ", ".join(f"{s:.3f} s = {1e3 * s / n_b:.1f} ms a step" for s in epoch_s)
          + f"; the refill {', '.join(f'{v:.2f}' for v in refill_s)} s"
          + f"; losses {losses}; launches {fit_counts}; K1 batch sizes {sorted(set(sizes))} "
          f"({len(sizes)} calls); buffer 0 {size0} rows; "
          + ", ".join(f"{k} {v:.4g}" for m in dem_m for k, v in m.items()))
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        fail("a DEM loss is not finite")
    if (sizes != [n_init] + [B * K] * (2 * n_b) + [n_refill]
            or fit_counts["lj_log_prob_and_force"] != len(sizes)):
        fail(f"K1 did not launch once per DEM step at {B * K} configurations")
    if size0 != n_init + n_refill:
        fail(f"the refill did not add {n_refill} rows to buffer 0")
    if fit_counts["egnn_layer_forward_tf32"] != 3 * dem.num_integration_steps:
        fail(f"the refill launched the 3xTF32 K2 {fit_counts['egnn_layer_forward_tf32']} times, "
             f"not {3 * dem.num_integration_steps}")
    for k in ("egnn_layer_forward", "egnn_layer_backward", "egnn_layer_backward_tf32",
              "egnn_layer_tangent", "egnn_layer_tangent_tf32", "egnn_layer_forward_tc",
              "egnn_layer_backward_tc", "egnn_layer_tangent_tc", "g_operator_contract",
              "_contract_scalar", "_lj_scalar"):
        if fit_counts[k]:
            fail(f"the DEM phase launched {k}")
    if len(dem_m) != 1 or not all(math.isfinite(v) for v in dem_m[0].values()):
        fail("the refill's val/dem metrics are missing or not finite")

    # a DEM step's time and K1's share of it (torch.profiler); the MC target
    # alone by CUDA events at the step's shape
    step_ms = profile_dem_steps(tr)
    xt, ht, eps, noise, d = idem_inputs(tr)
    mc_ms = cuda_ms(lambda: estimate_grad_Rt(ht, xt, target0.log_prob_and_force, eps), reps=5)
    print(f"[phase 12] the iDEM target (estimate_grad_Rt, {B} x {K} probes) {mc_ms:.3f} ms by "
          f"CUDA events = {100 * mc_ms / step_ms:.2f} % of the profiled step")

    # the iDEM target by K1 against the plain version on the first chains:
    # on this step's batch (buffer 0: prior samples and the refill's) and on
    # val-set configurations (T = 2) noised the same way
    n = IDEM_REF_CHAINS
    plain = lambda y: ljop.lj_log_prob_and_force_plain(y, 55, **lj_kwargs(target0))
    x_val = target0.sample_val_set(B, tr.generator)
    xt_val = remove_mean(x_val, 55, 3) + noise
    err = {}
    for label, xb in (("the step's batch", xt), ("val-set configurations", xt_val)):
        got = estimate_grad_Rt(ht, xb, target0.log_prob_and_force, eps)
        ref = estimate_grad_Rt(ht[:n], xb[:n], plain, eps[:n])
        torch.cuda.synchronize()
        err[label] = rel_err(got[:n], ref)
        if not (err[label][0] <= TOL_IDEM and bool(torch.isfinite(got).all())):
            fail(f"the iDEM target by K1 disagrees with its plain version on {label}")
    print(f"[phase 12] iDEM target, card (one K1 launch of {B * K}) against plain on the first "
          f"{n} chains' {n * K} probes: max abs err / max abs value "
          + ", ".join(f"{r:.2e} on {k} (max abs err {a:.3e})" for k, (r, a) in err.items())
          + f"; tol {TOL_IDEM}")
    probes = (xt[:, None, :] + eps * torch.sqrt(ht)[:, None, None]).reshape(-1, xt.shape[1])
    k1_row, k1_dev = k1_entry(target0, probes, f"the iDEM target, {B * K} configurations",
                              sizes.count(B * K), phase=12, n_ref=n * K)
    print(f"[phase 12] K1's device time at the iDEM launch {k1_dev:.4f} ms = "
          f"{100 * k1_dev / step_ms:.3f} % of a DEM step")
    del probes

    # one force-based pretraining loss on the card against the CPU, same
    # draws, on val-set configurations and their forces
    nb = STEP_CPU_BATCH
    force = dem.replace(use_mc_target=False)
    draws = DEMDraws(d.loss.ln_sigma_draw[:nb], d.loss.noise[:nb])
    kw = dict(n_particles=55, n_spatial_dim=3, mean_free=True)
    beta0 = float(tr.inverse_temperatures[0])
    x0, f0 = x_val[:nb], target0.log_prob_and_force(x_val[:nb])[1]
    card = pretrain_loss(tr.score, force, x0, f0, beta0, draws=draws, **kw).detach()
    state = tr.state_dict()
    state.pop("generator")
    cpu_tr = build_trainer(cfg, device="cpu")
    cpu_tr.load_state_dict(state)
    host = pretrain_loss(cpu_tr.score, force, x0.cpu(), f0.cpu(), beta0,
                         draws=DEMDraws(*(v.cpu() for v in draws[:2])), **kw).detach()
    r_loss = abs(float(card) - float(host)) / abs(float(host))
    print(f"[phase 12] force-based pretrain_loss at batch {nb}, card against CPU: "
          f"{float(card):.6g} / {float(host):.6g}, rel err {r_loss:.2e} (tol {TOL_STEP})")
    if not r_loss <= TOL_STEP:
        fail("the force-based pretraining loss on the card disagrees with the CPU")
    del cpu_tr
    k2_row = refill_k2_entry(tr, tr.buffers.x[0, n_init:size0],
                             fit_counts["egnn_layer_forward_tf32"])
    # the refill's sampling before (the scalar f32 K2, the rule patched off in
    # this script for that run) and after (the 3xTF32 K2): the same
    # integration as eval_epoch_end_dem's, buffers untouched
    cfg_dem = tr.integrator_cfg.replace(
        num_integration_steps=dem.num_integration_steps, debias_inference=False,
        resampling_interval=-1, resample_at_end=False, start_resampling_step=0,
        end_resampling_step=dem.num_integration_steps)
    beta0 = float(tr.inverse_temperatures[0])

    def refill_s_by(kernel):
        reset_counts(kernels)
        with scalar_f32_kernels() if kernel == "scalar" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.generate_samples(target0, n_refill, inverse_temp=beta0, annealing_factor=1.0,
                                integrator_cfg=cfg_dem)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        c = counts()
        want = "egnn_layer_forward" if kernel == "scalar" else "egnn_layer_forward_tf32"
        if c[want] != 3 * dem.num_integration_steps:
            fail(f"the {kernel} refill did not launch {want} {3 * dem.num_integration_steps} "
                 f"times")
        return t

    turns = [refill_s_by(k) for k in ("scalar", "3xTF32", "3xTF32", "scalar")]
    print(f"[phase 12] the refill's sampling ({n_refill} chains x {dem.num_integration_steps} "
          f"steps), in turns: scalar f32 K2 (before) {turns[0]:.2f}, {turns[3]:.2f} s; 3xTF32 "
          f"K2 (after) {turns[1]:.2f}, {turns[2]:.2f} s; the fit's refill above "
          f"{', '.join(f'{v:.2f}' for v in refill_s)} s with its metrics")
    return [k1_row, k2_row], tr


def phase_mcmc(kernels):
    """Phase 12, MCMC: 100 adaptive HMC steps of 10 leapfrogs on LJ55 at
    T = 1 from 512 ground-truth configurations, then the gated ten-run
    protocol for LJ55_temp_1.0_val (protocol_gate)."""
    import numpy as np
    import torch

    from pita_torch.baselines.mcmc import hmc_chain
    from pita_torch.io.bench_asset import BENCH_ASSET
    from pita_torch.targets import LennardJones

    counts = lambda: {f.__name__: f.launches for f in kernels}
    target = LennardJones(55, smooth=True, temperature=1.0)
    x0 = torch.as_tensor(np.load(BENCH_ASSET)["data_T_low"][:512], device="cuda")
    S, L = 100, 10
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, accs, eps = hmc_chain(target.log_prob_and_force, x0, S, n_leapfrog=L,
                             generator=torch.Generator("cuda").manual_seed(12))
    torch.cuda.synchronize()
    t_hmc = time.perf_counter() - t0
    c = counts()
    a = accs.cpu().numpy()
    print(f"[phase 12] HMC, 512 chains x {S} steps of {L} leapfrogs at T=1: {t_hmc:.3f} s = "
          f"{1e3 * t_hmc / S:.2f} ms a step; acceptance first/mean/last {a[0]:.3f}/"
          f"{a.mean():.3f}/{a[-1]:.3f}, final step size {float(eps):.3e}, mean log p "
          f"{float(target.log_prob(x).mean()):.3f}; K1 {c['lj_log_prob_and_force']} launches "
          f"({1 + S * (L + 2)} expected), the first K1 {c['_lj_scalar']}")
    if c["lj_log_prob_and_force"] != 1 + S * (L + 2) or c["_lj_scalar"]:
        fail("HMC did not launch K1 1 + S(L+2) times, or launched the first K1")
    if not (np.isfinite(a).all() and math.isfinite(float(eps))
            and bool(torch.isfinite(x).all())):
        fail("HMC's acceptance, step size or positions are not finite")

    protocol_gate(kernels)


def protocol_gate(kernels):
    """The gated ten-run protocol at the settings scripts/make_ground_truth.py
    uses for LJ55_temp_1.0_val (seed 50 + int(7 T), warmup 10,000), held to
    the committed diagnostics by that script's cross-backend tolerance
    (scripts/make_ground_truth.py:133-141): R-hat < 1.05, the R-hat gap
    within 0.02, and the run energy means within max(0.05 x mean committed
    spread, 3.5 x std of the committed run means) of the committed ones.

    The script pairs run r with the committed run r, which shares its seed
    on the same backend. Seeded chains on another backend are fresh draws
    (the script says so), so that pairing is arbitrary here: the gate pairs
    the runs by rank (the r-th lowest mean with the committed r-th lowest)
    and prints the gap by index beside it. tests/protocol_seeds.py measures
    both pairings over shifted seeds for this port and for pita_tpu."""
    import numpy as np
    import torch

    from pita_torch.baselines.mcmc import generate_lj_dataset_reference_protocol
    from pita_torch.targets import LennardJones

    name, T = "LJ55_temp_1.0_val", 1.0
    seed = 50 + int(T * 7)
    with open(os.path.join(REPO, "data", f"{name}.rhat.json")) as f:
        committed = json.load(f)
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, diag = generate_lj_dataset_reference_protocol(
        LennardJones(55, smooth=True, temperature=T), num_samples=committed["num_samples"],
        n_runs=committed["n_runs"], seed=seed, warmup=committed["warmup"], device="cuda")
    torch.cuda.synchronize()
    t_proto = time.perf_counter() - t0
    old = np.asarray(committed["per_run_energy_mean"])
    new = np.asarray(diag["per_run_energy_mean"])
    index_gap = float(np.max(np.abs(old - new)))
    rank_gap = float(np.max(np.abs(np.sort(old) - np.sort(new))))
    rhat_gap = abs(diag["rhat_energy"] - committed["rhat_energy"])
    tol = max(0.05 * float(np.mean(committed["per_run_energy_std"])), 3.5 * float(np.std(old)))
    c = {f.__name__: f.launches for f in kernels}
    print(f"[phase 12] protocol {name} ({committed['num_samples']} samples, "
          f"{committed['n_runs']} runs, warmup {committed['warmup']}, seed {seed}): "
          f"{t_proto:.2f} s, K1 {c['lj_log_prob_and_force']} launches; R-hat "
          f"{diag['rhat_energy']:.5f} (committed {committed['rhat_energy']:.5f}, gap "
          f"{rhat_gap:.5f}, tol 0.02); per-run energy means "
          f"{[round(float(v), 3) for v in new]} (committed {[round(float(v), 3) for v in old]}), "
          f"std of the means {float(np.std(new)):.4f} (committed {float(np.std(old)):.4f}), "
          f"per-run spreads {[round(float(v), 2) for v in diag['per_run_energy_std']]}; largest "
          f"gap to the committed by rank {rank_gap:.4f}, by index {index_gap:.4f} "
          f"({'within' if index_gap <= tol else 'beyond'} tol), tol {tol:.4f}")
    if c["_lj_scalar"] or not c["lj_log_prob_and_force"]:
        fail("the protocol did not run on K1, or launched the first K1")
    if not (diag["converged"] and diag["rhat_energy"] < 1.05 and rank_gap <= tol
            and rhat_gap <= 0.02):
        fail("the protocol's diagnostics diverge from the committed ones")


def phase_clis(kernels, tmp, ckpt, data_dir):
    """Phase 12, entry points: eval_cli on an lj55 checkpoint with the test
    cut like phase 11's fill; train_cli -m over two seeds and train_cli with
    a YAML overlay, LJ13 debug=short cut to 2 epochs without the test phase."""
    import csv

    import yaml

    from pita_torch import eval_cli, train_cli
    from pita_torch.configs.registry import DEBUG_OVERLAYS

    counts = lambda: {f.__name__: f.launches for f in kernels}
    args = ["experiment=lj55", f"ckpt_path={ckpt}", "device=cuda",
            f"out_dir={os.path.join(tmp, 'eval')}", f"energy.data_dir={data_dir}",
            "trainer.num_samples_to_save=256", "trainer.test_batch_size=256",
            "integrator.num_integration_steps=100", "integrator.end_resampling_step=90",
            "integrator.pallas_divergence=true", "trainer.temps_to_anneal_test=((2.0,1.5),)",
            "logger=csv,"]
    reset_counts(kernels)
    t0 = time.perf_counter()
    metrics = eval_cli.main(args)
    t_eval = time.perf_counter() - t0
    c = counts()
    shown = " ".join(a for a in args if not a.startswith(("ckpt_path", "out_dir", "energy")))
    print(f"[phase 12] eval_cli {shown} on {os.path.basename(ckpt)}: {t_eval:.2f} s with the "
          f"test set at T=1.5; launches {c}")
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail("eval_cli's test metrics are missing or not finite")
    for k in ("egnn_layer_forward_tf32", "egnn_layer_backward_tf32", "egnn_layer_tangent_tf32"):
        if not c[k]:
            fail(f"eval_cli's test did not launch {k}")
    if any(c[k] for k in ("egnn_layer_forward", "egnn_layer_backward", "egnn_layer_tangent",
                          "egnn_layer_forward_tc", "egnn_layer_backward_tc",
                          "egnn_layer_tangent_tc", "_lj_scalar")):
        fail("eval_cli's f32 test launched a scalar K2, K3 or K4, a bf16 tensor-core kernel or "
             "the first K1")

    lj13 = ["experiment=lj13", "debug=short", "device=cuda", "test=false",
            f"energy.data_dir={os.path.join(tmp, 'data13')}"]
    mdir = os.path.join(tmp, "multirun")
    t0 = time.perf_counter()
    res = train_cli.main(["-m", "seed=1,2", "trainer.max_epochs=2", f"out_dir={mdir}"] + lj13)
    t_m = time.perf_counter() - t0
    runs = sorted(os.listdir(mdir))
    print(f"[phase 12] train_cli -m experiment=lj13 debug=short seed=1,2 test=false "
          f"trainer.max_epochs=2: {t_m:.2f} s with the LJ13 train and val sets; run "
          f"directories {runs}, results {res}")
    if runs != ["lj13_seed-1", "lj13_seed-2"] or not all(
            os.path.exists(os.path.join(mdir, r, "metrics.csv")) for r in runs):
        fail("train_cli -m did not produce its two run directories")

    path = os.path.join(tmp, "geometric_score_only.yaml")
    overlay = {"noise_schedule": {"kind": "geometric", "sigma_min": 0.05, "sigma_max": 80.0},
               "trainer.max_epochs": 2, **DEBUG_OVERLAYS["score_only"]}
    with open(path, "w") as f:
        yaml.safe_dump(overlay, f)
    ydir = os.path.join(tmp, "yaml")
    t0 = time.perf_counter()
    train_cli.main([f"config={path}", f"out_dir={ydir}"] + lj13)
    t_y = time.perf_counter() - t0
    with open(os.path.join(ydir, "lj13", "metrics.csv"), newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train/score_loss")]
    score = [float(r["train/score_loss"]) for r in rows]
    energy = [float(r["train/energy_score_loss"]) for r in rows]
    print(f"[phase 12] train_cli experiment=lj13 debug=short config=<{overlay}> test=false: "
          f"{t_y:.2f} s; score losses {score}, energy-score losses {energy}")
    if not score or not all(math.isfinite(v) for v in score) or any(energy):
        fail("the YAML-configured geometric score-only run did not train the score alone")


def phase_tools(kernels, tmp, ckpt=None):
    """Phase 12: the training tools on the card. ``ckpt``: phase 11's
    checkpoint for eval_cli; without one, the DEM trainer's."""
    from pita_torch.io import checkpoint

    data_dir = os.path.join(tmp, "data")
    rows, tr = phase_dem(kernels, tmp, data_dir)
    if ckpt is None:
        ckpt = os.path.join(tmp, "ckpt", "lj55_dem.pt")
        checkpoint.save_checkpoint(tr, ckpt)
    del tr
    phase_mcmc(kernels)
    phase_clis(kernels, tmp, ckpt, data_dir)
    return rows


# ---------------------------------------------------------------- phase 13

TOL_FF = 1e-5  # energies and forces, card against CPU, of the largest: f32 sums in another order
TOL_FF_COMMITTED = 5e-3  # kcal/mol against aldp_md_T300.npz's energies (pita_tpu: 1.45e-3)
TOL_MD = 1e-4  # nm after 100 BAOAB steps from the same draws, card against CPU


def phase_forcefield():
    """Phase 13.1: energies and forces of the 800 frames of aldp_md_T300.npz
    and of the minimized aldp, al3 and al4 under 1e-3 nm noise (2,048 each)
    on the card against the CPU; the committed MD energies; one
    energy-and-force call at 2,048 configurations of aldp, timed."""
    import numpy as np
    import torch

    from pita_torch.targets import ALPEnergy

    z = np.load(os.path.join(REPO, "aldp_md_T300.npz"))
    sets = [("aldp_md_T300.npz", "aldp", z["positions"].reshape(-1, 66))]
    for seed, pep in enumerate(("aldp", "al3", "al4")):
        x0 = ALPEnergy(pep).initial_structure()
        rng = np.random.default_rng(seed)
        sets.append((f"{pep} minimized + 1e-3 nm", pep,
                     x0[None] + 1e-3 * rng.standard_normal((2048, x0.size))))
    worst = 0.0
    for label, pep, x in sets:
        t = ALPEnergy(pep)
        xh = torch.as_tensor(x, dtype=torch.float32)
        e_c, f_c = t.energy_kcal(xh.cuda()), t.log_prob_and_force(xh.cuda())[1]
        e_h, f_h = t.energy_kcal(xh), t.log_prob_and_force(xh)[1]
        err = max(rel_err(e_c.cpu(), e_h)[0], rel_err(f_c.cpu(), f_h)[0])
        worst = max(worst, err)
        print(f"[phase 13] force field, {label} ({xh.shape[0]} x {t.n_particles} atoms): energy "
              f"and force, card against CPU, max rel err {err:.2e} (tol {TOL_FF}); energy "
              f"{float(e_c.min()):.3f} to {float(e_c.max()):.3f} kcal/mol")
        if not err <= TOL_FF:
            fail(f"the force field on the card disagrees with the CPU on {label}")
    t = ALPEnergy("aldp")
    e = t.energy_kcal(torch.as_tensor(sets[0][2], dtype=torch.float32, device="cuda"))
    gap = float((e.cpu().double() - torch.as_tensor(z["energies"]).reshape(-1)).abs().max())
    print(f"[phase 13] aldp_md_T300.npz on the card against its committed energies: max abs "
          f"gap {gap:.3e} kcal/mol (tol {TOL_FF_COMMITTED}; pita_tpu 1.45e-3)")
    if not gap <= TOL_FF_COMMITTED:
        fail("the force field misses the committed MD energies")
    x = torch.as_tensor(sets[1][2], dtype=torch.float32, device="cuda")
    ms = cuda_ms(lambda: t.log_prob_and_force(x))
    print(f"[phase 13] aldp energy and force at {x.shape[0]} configurations: {ms:.3f} ms a call "
          f"(CUDA events, plain PyTorch as pita_tpu's XLA program; autograd force)")
    return dict(ff_err=worst, ff_committed_gap=gap, ff_ms_2048=ms)


def phase_md(tmp):
    """Phase 13.2: generate_md_cli on the card (aldp at 1,200 K, 32
    replicas, 500 steps), then 100 BAOAB steps on the card and on the CPU
    from the same injected normals."""
    import numpy as np
    import torch

    from pita_torch import generate_md_cli
    from pita_torch.baselines.md import MDConfig, langevin_md
    from pita_torch.targets import ALPEnergy

    n_steps, R = 500, 32
    out = os.path.join(tmp, "aldp_md_T1200.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_md_cli.main(["peptide=aldp", "temperature=1200", f"n_steps={n_steps}",
                          f"n_replicas={R}", "seed=0", f"out={out}"])
    wall = time.perf_counter() - t0
    z = np.load(out)
    ok = (z["positions"].shape == (n_steps // 100, R, 66) and np.isfinite(z["positions"]).all()
          and np.isfinite(z["energies"]).all())
    step_ms = 1e3 * wall / n_steps
    print(f"[phase 13] generate_md_cli peptide=aldp temperature=1200 n_replicas={R} "
          f"n_steps={n_steps}: {wall:.2f} s = {step_ms:.3f} ms a BAOAB step (with the file); "
          f"frames {z['positions'].shape}, energies {float(z['energies'].min()):.2f} to "
          f"{float(z['energies'].max()):.2f} kcal/mol")
    if not ok:
        fail("MD on the card gave frames of the wrong shape or non-finite values")
    t = ALPEnergy("aldp", temperature=1200.0)
    g = torch.Generator().manual_seed(5)
    x0 = torch.as_tensor(t.initial_structure(), dtype=torch.float32)[None].repeat(R, 1)
    x0 = x0 + 1e-3 * torch.randn(x0.shape, generator=g)
    cfg = MDConfig(temperature=1200.0, n_steps=100, report_interval=10)
    draws = [torch.randn((R, 66), generator=g) for _ in range(cfg.n_steps + 1)]

    def run(dev):
        it = iter(d.to(dev) for d in draws)
        return langevin_md(t, x0.to(dev), cfg, normal=lambda shape: next(it))

    gap = float((run("cuda").positions.cpu() - run("cpu").positions).abs().max())
    print(f"[phase 13] 100 BAOAB steps at 1,200 K from the same draws, card against CPU: max "
          f"position gap {gap:.3e} nm (tol {TOL_MD})")
    if not gap <= TOL_MD:
        fail("MD on the card departs from the same steps on the CPU")
    return dict(md_ms_per_step=step_ms, md_gap_nm=gap)


def write_md_sets(peptide, temps, data_dir, n_steps, n_replicas, seed=0):
    """The cached train, val and test sets of ``peptide`` at each temperature
    by the port's MD on the card: the warmup half of the frames dropped,
    half the replicas to train, a quarter each to val and test."""
    import numpy as np

    from pita_torch.baselines.md import generate_md_dataset
    from pita_torch.targets import ALPEnergy

    os.makedirs(data_dir, exist_ok=True)
    for i, T in enumerate(temps):
        t = ALPEnergy(peptide, temperature=T)
        out = os.path.join(data_dir, f"md_{peptide}_{T:.2f}.npz")
        generate_md_dataset(t, out, n_steps=n_steps, n_replicas=n_replicas, seed=seed + i,
                            device="cuda")
        frames = np.load(out)["positions"]
        frames = frames[frames.shape[0] // 2:]
        R = frames.shape[1]
        for which, part in (("train", frames[:, :R // 2]), ("val", frames[:, R // 2:3 * R // 4]),
                            ("test", frames[:, 3 * R // 4:])):
            np.save(os.path.join(data_dir, f"{peptide}_temp_{T:.2f}_{which}.npy"),
                    part.reshape(-1, t.dim).astype(np.float32))


def aldp_train_cfg(tmp, data_dir, **kw):
    """The aldp preset at its full width (DiT3D hidden 128, cond 128, 8
    heads, 6 blocks, bf16 block stack), cut in count only: 2 epochs of 10
    batches of 2,048, then one rung transition 1,200 -> 755.95 K filled at
    512 chains x 100 steps (the preset's exact mode: D VJPs for the DiT;
    resampling to step 80 of 100 as 800 of 1,000) with its 5 adaptive MALA
    steps and no escalated retry."""
    from pita_torch.configs import compose

    return compose("aldp", overrides={
        "out_dir": tmp, "energy.data_dir": data_dir,
        "trainer.n_train_batches_per_epoch": 10,
        "trainer.num_epochs_per_temp": (2, 200, 200),
        "trainer.num_temp_annealed_samples": 512,
        "trainer.transition_fill_max_retries": 0,
        "integrator.num_integration_steps": 100,
        "integrator.end_resampling_step": 80,
        "logger": ("csv",), **kw})


def phase_peptide_ladder(kernels, tmp, data_dir):
    """Phase 13.3: the aldp ladder through build_trainer and fit on the card
    (aldp_train_cfg); the metrics, the filled rung-1 buffer, no kernel
    launched; a float32 training step on the card against the CPU; a fill
    step timed and profiled; a checkpoint round trip."""
    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.io import checkpoint
    from pita_torch.ops.divergence import exact_divergence
    from pita_torch.sampler import integrate_sde
    from pita_torch.train.losses import LossDraws
    from pita_torch.train.trainer import StepDraws

    cfg = aldp_train_cfg(tmp, data_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_md_sets("aldp", cfg.trainer.temperatures[:2], data_dir, n_steps=800, n_replicas=256)
    t_sets = time.perf_counter() - t0
    tr = build_trainer(cfg, device="cuda")
    net = tr.score_net
    print(f"[phase 13] aldp: N={tr.n_particles}, DiT3D hidden {cfg.net['hidden_size']}, cond "
          f"{cfg.net['cond_dim']}, {cfg.net['n_heads']} heads, {len(net.blocks)} blocks, "
          f"{net.compute_dtype}, {sum(p.numel() for p in net.parameters())} weights a net; "
          f"batch {cfg.trainer.training_batch_size}; train/val/test sets at "
          f"{cfg.trainer.temperatures[:2]} K by MD (256 replicas x 800 steps each) in "
          f"{t_sets:.2f} s")

    times = {"train": [], "evaluate": [], "hook": []}
    losses = []

    def timed(name, fn, keep=None):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            if keep is not None:
                keep.append(out)
            return out
        return wrapped

    tr.train_one_epoch = timed("train", tr.train_one_epoch, losses)
    tr.evaluate = timed("evaluate", tr.evaluate)
    for target in tr.targets:
        target.log_on_epoch_end = timed("hook", target.log_on_epoch_end)
    ckpt = os.path.join(tmp, "ckpt", "aldp.pt")
    reset_counts(kernels)
    t0 = time.perf_counter()
    tr.fit(max_epochs=2, ckpt_path=ckpt)
    t_fit = time.perf_counter() - t0
    counts = {f.__name__: f.launches for f in kernels}
    m = tr.metrics_history[-1]
    n_steps = 2 * cfg.trainer.n_train_batches_per_epoch
    step_ms = 1e3 * sum(times["train"]) / n_steps
    t_hook = sum(times["hook"])
    t_fill = sum(times["evaluate"]) - t_hook
    n_fill = 2 * cfg.integrator.num_integration_steps
    buf1 = int(tr.buffers.size[1])
    print(f"[phase 13] fit, 2 epochs x {cfg.trainer.n_train_batches_per_epoch} steps and the "
          f"transition fill: {t_fit:.2f} s; training {step_ms:.1f} ms a step (the first epoch "
          f"{1e3 * times['train'][0] / (n_steps // 2):.1f}); fill {t_fill:.2f} s (512 chains x "
          f"100 steps and the 512-chain pass without resampling, {1e3 * t_fill / n_fill:.1f} ms "
          f"a step with MALA and the energies); eval hook {t_hook:.2f} s; rung-1 buffer {buf1} "
          f"rows; kernel launches {counts}")
    print("[phase 13] losses by epoch " + "; ".join(
        ", ".join(f"{k} {v:.4g}" for k, v in e.items()) for e in losses))
    print("[phase 13] val metrics " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    if not all(math.isfinite(v) for e in losses for v in e.values()):
        fail("a peptide training loss is not finite")
    if any(counts.values()):
        fail("the peptide path launched one of the port's kernels")
    for group in ("val/rama/resampled/", "val/rama/not_resampled/", "val/tica/", "val/ic/"):
        vals = [v for k, v in m.items() if k.startswith(group)]
        if not vals or not all(math.isfinite(v) for v in vals):
            fail(f"the peptide evaluation gave no or non-finite {group}* metrics")
    for k in ("val/correct_symmetry_rate", "val/uncorrectable_symmetry_rate"):
        if not math.isfinite(m.get(k, math.nan)):
            fail(f"the peptide evaluation gave no {k}")
    if buf1 == 0 or not bool(torch.isfinite(tr.buffers.energy[1, :buf1]).all()):
        fail("the fill left the rung-1 buffer empty or non-finite")

    # the busy share of 3 training steps, then a fill step timed and profiled
    wall_t, busy_t, _, _ = profile_steps("aldp training, steps of 2048", lambda: tr.train_step(0), 3)
    nets = tr._eval_wrappers()
    anneal = tr.make_annealing(float(tr.inverse_temperatures[1] / tr.inverse_temperatures[0]))
    x1 = tr._prior(1.0).sample(512, generator=tr.generator, device="cuda")
    fill_step = lambda n: integrate_sde(
        x1, *nets, tr.noise_schedule, anneal, tr.targets[1], 1.0,
        cfg.integrator.replace(num_integration_steps=n, end_resampling_step=n,
                               post_mcmc_steps=0), seed=2, device="cuda")
    fill_step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fill_step(5)
    torch.cuda.synchronize()
    fill_step_ms = 1e3 * (time.perf_counter() - t0) / 5
    wall_f, busy_f, _, _ = profile_steps("aldp fill step, 512 chains, exact trace by 66 VJPs",
                                         lambda: fill_step(1), 1)
    # the exact trace alone (compute_sde_terms' call): D = 66 VJPs, 16 rows a pass
    score_fn = lambda tq, xq: nets[0].score(tr.noise_schedule.h(tq), xq, 1.0)
    t_mid = torch.full((x1.shape[0],), 0.5, device="cuda")
    trace_ms = cuda_ms(lambda: exact_divergence(score_fn, t_mid, x1), reps=3, warmup=1)
    print(f"[phase 13] one fill step, 512 chains (5 steps timed): {fill_step_ms:.1f} ms; the "
          f"exact trace alone (66 VJPs in 5 passes of up to 8,192 rows) {trace_ms:.1f} ms = "
          f"{100 * trace_ms / fill_step_ms:.1f} % of it")

    # one float32 step on the card against the same step on the CPU
    cfg32 = aldp_train_cfg(tmp, data_dir, **{"net.compute_dtype": "float32"})
    state = tr.state_dict()
    state.pop("generator")
    g32 = build_trainer(cfg32, device="cuda")
    g32.load_state_dict(state)
    h32 = build_trainer(cfg32, device="cpu")
    h32.load_state_dict(state)
    d = g32.draw_step(0)
    nb = STEP_CPU_BATCH
    d = StepDraws(d.idx[:nb], d.rot_normal[:nb], None,
                  LossDraws(d.loss.ln_sigma_draw[:nb], d.loss.noise[:nb]))
    hd = StepDraws(*(None if v is None else v.cpu() for v in d[:3]),
                   LossDraws(*(v.cpu() for v in d.loss[:2])))
    aux_c, gn_c = g32.train_step(0, draws=d)
    t0 = time.perf_counter()
    aux_h, gn_h = h32.train_step(0, draws=hd)
    t_cpu = time.perf_counter() - t0
    worst = max(abs(float(aux_c[k]) - float(aux_h[k])) / max(abs(float(aux_h[k])), 1e-30)
                for k in aux_h)
    g_rel = abs(float(gn_c) - float(gn_h)) / float(gn_h)
    print(f"[phase 13] one float32 step at batch {nb}, card against CPU ({t_cpu:.2f} s there): "
          f"losses max rel err {worst:.2e}, global gradient norm {float(gn_c):.6g} / "
          f"{float(gn_h):.6g} rel err {g_rel:.2e} (tol {TOL_STEP}); "
          + ", ".join(f"{k} {float(aux_h[k]):.4g}" for k in aux_h))
    if not (worst <= TOL_STEP and g_rel <= TOL_STEP):
        fail("an aldp training step on the card disagrees with the same step on the CPU")
    del g32, h32

    # the checkpoint fit saved, restored into a fresh trainer
    fresh = build_trainer(cfg, device="cuda")
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(fresh, ckpt)
    t_load = time.perf_counter() - t0
    saved = torch.load(ckpt, map_location="cuda", weights_only=True)
    if not same_state(fresh.state_dict(), saved):
        fail("a restored aldp checkpoint differs from the saved state")
    print(f"[phase 13] checkpoint {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB saved by fit, "
          f"restored in {t_load:.2f} s into a fresh trainer, every tensor equal")
    return dict(train_step_ms=step_ms, train_busy_pct=100 * busy_t / wall_t, fill_s=t_fill,
        fill_step_ms=fill_step_ms, trace_ms=trace_ms,
        fill_step_busy_pct=100 * busy_f / wall_f, eval_hook_s=t_hook, sets_s=t_sets,
        buffer1_rows=buf1, kernel_launches=sum(counts.values()),
        step_cpu_rel_err=max(worst, g_rel))


def phase_peptide_clis(tmp, data_dir):
    """Phase 13.4: train_cli experiment=al3 and alp_diffusion_baseline,
    debug=short, one epoch, no test phase, on sets the port's MD writes."""
    import csv

    from pita_torch import train_cli

    t0 = time.perf_counter()
    write_md_sets("al3", (1200.0,), data_dir, n_steps=300, n_replicas=64)
    write_md_sets("aldp", (300.0,), data_dir, n_steps=300, n_replicas=64)
    print(f"[phase 13] al3 at 1,200 K and aldp at 300 K sets by MD (64 replicas x 300 steps): "
          f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for exp in ("al3", "alp_diffusion_baseline"):
        t0 = time.perf_counter()
        train_cli.main([f"experiment={exp}", "debug=short", f"out_dir={tmp}",
                        f"energy.data_dir={data_dir}", "trainer.max_epochs=1", "test=false"])
        out[exp] = time.perf_counter() - t0
        with open(os.path.join(tmp, exp, "metrics.csv"), newline="") as f:
            cols = [c for c in next(csv.reader(f)) if c.startswith("val/rama/")]
        print(f"[phase 13] train_cli experiment={exp} debug=short trainer.max_epochs=1 "
              f"test=false: {out[exp]:.2f} s, {len(cols)} val/rama columns")
        if not cols:
            fail(f"train_cli experiment={exp} logged no peptide metrics")
    return out


def phase_peptides(kernels, tmp):
    """Phase 13: the alanine-peptide path on the card."""
    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "peptide_data")
    out, parts = {}, {}
    for name, run in (
            ("force field", phase_forcefield),
            ("MD", lambda: phase_md(tmp)),
            ("aldp ladder", lambda: phase_peptide_ladder(kernels, os.path.join(tmp, "peptide"),
                                                         data_dir)),
            ("CLIs", lambda: {f"cli_{k}_s": v for k, v in phase_peptide_clis(
                os.path.join(tmp, "peptide_cli"), data_dir).items()})):
        t1 = time.perf_counter()
        out.update(run())
        parts[name] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    print(f"[phase 13] the peptide path: {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


# ---------------------------------------------------------------- phase 14

# tests/test_annealing_oracle.py's five runs: the integrator keys of each and
# its bound on the within-mode variance (rtol against exact samples of p²)
ORACLE_MODES = {
    "exact": (dict(divergence_mode="exact"), 0.13),
    "hutchinson_mala": (dict(divergence_mode="hutchinson", post_mcmc_steps=30), 0.1),
    "hutchinson_ess": (dict(divergence_mode="hutchinson", hutchinson_probes=2,
                            ess_resampling_threshold=0.5, post_mcmc_steps=30), 0.1),
    "hutch_ess_k10": (dict(divergence_mode="hutchinson", hutchinson_probes=2,
                           ess_resampling_threshold=0.5, divergence_update_interval=10,
                           post_mcmc_steps=30), 0.1),
    "hutchpp": (dict(divergence_mode="hutchpp", hutchinson_probes=2,
                     ess_resampling_threshold=0.5, post_mcmc_steps=30), 0.1),
}
TOL_CARD_CPU = 1e-4  # a second derivative in f32, summed in another order on each device


def oracle_run(mode_kw, seed, n_chains=2048):
    """One run of the oracle test: GMM-40 annealed to p² (factor 2) by the
    exact noised-GMM score and energy, 2,048 chains x 1,000 steps, resampling
    to step 930, the final resample, dt_negative_time 1e-2. Returns (the
    run's statistics, its wall seconds)."""
    import numpy as np
    import torch

    from pita_torch.metrics.distances import wasserstein2_exact
    from pita_torch.sampler import IntegratorConfig, integrate_sde
    from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
    from pita_torch.targets import GMM40, gmm_power
    from pita_torch.targets.gmm import GMMEnergyOracle, GMMScoreOracle

    base = GMM40()
    target = gmm_power(base, 2)
    sched = ElucidatingNoiseSchedule(sigma_min=0.01, sigma_max=80.0, rho=7.0)
    cfg = IntegratorConfig(num_integration_steps=1000, end_resampling_step=930,
                           resampling_interval=1, resample_at_end=True, should_mean_free=False,
                           adaptive_mcmc=True, dt_negative_time=1e-2, **mode_kw)
    scale = math.sqrt(float(sched.h(torch.tensor(1.0))) / 2.0)
    x1 = torch.randn(n_chains, 2, generator=torch.Generator("cuda").manual_seed(seed),
                     device="cuda") * scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = integrate_sde(x1, GMMScoreOracle(base), GMMEnergyOracle(base), sched,
                        ConstantAnnealingSchedule(annealing_factor=2.0), target, 1.0, cfg,
                        seed=seed + 1000, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(res.samples).all():
        fail(f"an oracle run ({mode_kw}) produced non-finite samples")
    ref = target.sample(n_chains, torch.Generator("cuda").manual_seed(seed + 2000))
    s, r = res.samples.cpu().numpy(), ref.cpu().numpy()
    locs = base.locs.numpy()

    def stats(v):  # tests/test_annealing_oracle.py:53-61
        m = ((v[:, None, :] - locs[None]) ** 2).sum(-1).argmin(1)
        return ((v - locs[m]) ** 2).mean(), np.bincount(m, minlength=len(locs)) / len(v)

    var_g, occ_g = stats(s)
    var_r, occ_r = stats(r)
    lp, lp_ref = target.log_prob(res.samples), target.log_prob(ref)
    return dict(var=float(var_g), var_ref=float(var_r),
                tv=float(0.5 * np.abs(occ_g - occ_r).sum()),
                w2=wasserstein2_exact(s[:1024], r[:1024]),
                far=int((lp < lp_ref.min()).sum()), lowest=float(lp.min()),
                lowest_ref=float(lp_ref.min())), wall


def phase_oracle_runs(kernels):
    """Phase 14.1: the five oracle runs held to the test's bounds, then
    hutch_ess_k10 over 8 seeds: the W2 range and the count of far-off
    samples (log-density under p² below the lowest of 2,048 exact draws).
    No kernel may launch."""
    out = {}
    reset_counts(kernels)
    for name, (kw, rtol) in ORACLE_MODES.items():
        st, wall = oracle_run(kw, seed=0)
        ok = (abs(st["var"] - st["var_ref"]) <= rtol * st["var_ref"] and st["tv"] < 0.3
              and st["w2"] < 12.0 and (name != "exact" or abs(st["var"] - 2 * st["var_ref"]) > 0.5))
        print(f"[phase 14] oracle {name}: {wall:.2f} s ({1e3 * wall / 1000:.2f} ms a step); "
              f"within-mode variance {st['var']:.4f} vs exact {st['var_ref']:.4f} (rtol {rtol}), "
              f"occupancy TV {st['tv']:.4f} (< 0.3), W2 {st['w2']:.3f} (< 12); far-off samples "
              f"{st['far']} (lowest log p² {st['lowest']:.2f}, exact draws' "
              f"{st['lowest_ref']:.2f})"
              f" -> {'pass' if ok else 'MISS'}")
        if not ok:
            fail(f"the oracle run {name} misses the bounds of tests/test_annealing_oracle.py")
        out[f"{name}_s"] = wall
        out[f"{name}_w2"] = st["w2"]
    w2s, far = [], []
    for seed in range(1, 9):
        st, _ = oracle_run(ORACLE_MODES["hutch_ess_k10"][0], seed=seed)
        w2s.append(st["w2"])
        far.append(st["far"])
    print(f"[phase 14] hutch_ess_k10 over seeds 1-8: W2 {min(w2s):.3f} to {max(w2s):.3f} "
          f"({', '.join(f'{w:.2f}' for w in w2s)}); far-off samples by seed {far}, "
          f"{sum(far)} of {8 * 2048}")
    counts = {f.__name__: f.launches for f in kernels}
    if any(counts.values()):
        fail(f"the oracle runs launched a kernel: {counts}")
    out.update(k10_w2_min=min(w2s), k10_w2_max=max(w2s), k10_far=sum(far))
    return out


def phase_lj_sampler_modes(kernels, wl, wl32):
    """Phase 14.2 and 14.3 on the LJ55 bench pair: Hutch++ at rank 165 = D
    against the edge-operator trace (f32 pair, 64 chains); a hutchpp wiring
    run (bf16 pair, rank 16, 2 probes, 256 chains x 20 steps: K2 and K3 must
    launch, K4 and K5 not); the score-free path's exact Laplacian at the
    first step, card against CPU (f32 pair; the CPU takes the first of the
    64 chains: 165 double-backward rows take ~13 s there), then 64 x 8
    steps; a pinned run through the final resample."""
    import torch

    from pita_torch.io.bench_asset import load_lj55_bench
    from pita_torch.nets.egnn_fast import score_divergence_fast
    from pita_torch.ops.divergence import hutchpp_divergence
    from pita_torch.sampler import integrate_sde
    from pita_torch.sampler.terms import compute_sde_terms

    out = {}
    gen = torch.Generator("cuda").manual_seed(14)
    x = torch.randn(64, 165, generator=gen, device="cuda") * wl32.prior_scale * 0.05
    x = x + torch.as_tensor(wl32.data_T_low[:64], device="cuda")
    t = torch.full((64,), 0.3, device="cuda")
    ht = wl32.noise.h(t)
    twin = wl32.score.on_autograd_route()
    fn = lambda tq, xq: twin.score(wl32.noise.h(tq), xq, 1.0)
    S = torch.randint(0, 2, (165, 64, 165), generator=gen, device="cuda").float() * 2 - 1
    G = torch.randint(0, 2, (2, 64, 165), generator=gen, device="cuda").float() * 2 - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hpp = hutchpp_divergence(fn, t, x, S, G)
    torch.cuda.synchronize()
    t_hpp = time.perf_counter() - t0
    ref = score_divergence_fast(wl32.score, ht, x, 1.0, chain_chunk=64)
    err = float((hpp - ref).abs().max() / ref.abs().max())
    print(f"[phase 14] Hutch++ at rank 165 = D against the edge-operator trace, f32 bench pair, "
          f"64 chains at t = 0.3: max err {err:.2e} of the largest |trace| "
          f"{float(ref.abs().max()):.1f} (tol 1e-3); {t_hpp:.2f} s (332 forward-mode passes of "
          f"a chain each, 16 a pass)")
    if not err <= 1e-3:
        fail("Hutch++ at full rank disagrees with the exact trace")
    out["hutchpp_full_rank_err"] = err

    x1 = torch.randn(256, 165, generator=gen, device="cuda") * wl.prior_scale
    cfg = hutch_cfg(divergence_mode="hutchpp", hutchpp_rank=16, num_integration_steps=20,
                    end_resampling_step=20, divergence_update_interval=1)
    run = lambda n: integrate_sde(x1, wl.score, wl.energy, wl.noise, wl.anneal, wl.target, 1.0,
                                  cfg.replace(num_integration_steps=n, end_resampling_step=n),
                                  seed=5, device="cuda")
    run(1)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    res = run(20)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    c = {f.__name__: f.launches for f in kernels}
    print(f"[phase 14] hutchpp (rank 16, 2 probes) on the bf16 bench pair, 256 chains x 20 "
          f"steps: {ms:.1f} ms a step; launches {c}")
    if not torch.isfinite(res.samples).all() or not torch.isfinite(res.logweights).all():
        fail("the hutchpp run gave non-finite samples or weights")
    if not (c["egnn_layer_forward_tc"] and c["egnn_layer_backward_tc"]):
        fail("the hutchpp run did not launch the tensor-core K2 and K3")
    if any(c[k] for k in ("egnn_layer_tangent", "egnn_layer_tangent_tc",
                          "egnn_layer_tangent_tf32", "g_operator_contract", "_contract_scalar")):
        fail("the hutchpp run launched K4 or K5")
    out["hutchpp_step_ms"] = ms

    # the score-free path: div(b_t) = −ΔU·g²/2 from the energy net's autograd copy,
    # at the first step (t = 1, prior samples: there the network's share of
    # ΔU is ~1e-7, the preconditioner's quadratic term the rest) and at
    # t = 0.3 on the near-ground-truth configurations above, where the
    # network's term leads; the card's 64 chains, the CPU's first chain
    x1 = torch.randn(64, 165, generator=gen, device="cuda") * wl32.prior_scale
    host = load_lj55_bench(device="cpu", compute_dtype=torch.float32)
    terms_on = lambda w, tt, xx: compute_sde_terms(None, w.energy, w.noise, w.anneal, tt, xx, 1.0)
    errs = []
    for label, tt, xx in (("t = 1, the first step", torch.ones(64, device="cuda"), x1),
                          ("t = 0.3", t, x)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = terms_on(wl32, tt, xx).divergence
        torch.cuda.synchronize()
        t_lap = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = terms_on(host, tt[:1].cpu(), xx[:1].cpu()).divergence
        t_lap_cpu = time.perf_counter() - t0
        errs.append(float((card[:1].cpu() - cpu).abs().max() / cpu.abs().max()))
        print(f"[phase 14] score-free exact Laplacian ({label}), f32 bench pair: 64 chains on "
              f"the card {t_lap:.2f} s (165 rows, reverse over reverse), the first on the CPU "
              f"{t_lap_cpu:.2f} s: div(b_t) {float(cpu[0]):.6g}, rel err {errs[-1]:.2e} "
              f"(tol {TOL_CARD_CPU})")
    err = max(errs)
    if not err <= TOL_CARD_CPU:
        fail("the score-free Laplacian on the card disagrees with the CPU")
    out["laplacian_rel_err"] = err
    reset_counts(kernels)
    for name, score, pin in (("score-free", None, False), ("pinned", wl.score, True)):
        cfg = hutch_cfg(num_integration_steps=8, end_resampling_step=7, resample_at_end=True,
                        divergence_update_interval=1, pin_energy=pin)
        t0 = time.perf_counter()
        res = integrate_sde(x1, score, wl.energy, wl.noise, wl.anneal, wl.target, 1.0, cfg,
                            seed=6, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fin = bool(torch.isfinite(res.samples).all() and torch.isfinite(res.logweights).all())
        print(f"[phase 14] {name} run, bf16 bench pair, 64 chains x 8 steps with the final "
              f"resample: {wall:.2f} s; samples and weights finite: {fin}; final weight std "
              f"{float(res.logweights[-1].std()):.3f}")
        if not fin:
            fail(f"the {name} run gave non-finite samples or weights")
        out[f"{name.replace('-', '_')}_s"] = wall
    return out


def card_vs_cpu_step(cfg, tr, label):
    """One training step at batch STEP_CPU_BATCH on the card against the same
    step on the CPU, from ``tr``'s state, with the card's draws."""
    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.train.losses import LossDraws
    from pita_torch.train.trainer import StepDraws

    state = tr.state_dict()
    state.pop("generator")
    g, h = build_trainer(cfg, device="cuda"), build_trainer(cfg, device="cpu")
    g.load_state_dict(state)
    h.load_state_dict(state)
    d = g.draw_step(0)
    nb = STEP_CPU_BATCH
    cut = lambda v: None if v is None else v[:nb]
    d = StepDraws(d.idx[:nb], cut(d.rot_normal), cut(d.com_normal),
                  LossDraws(d.loss.ln_sigma_draw[:nb], d.loss.noise[:nb]))
    hd = StepDraws(*(None if v is None else v.cpu() for v in d[:3]),
                   LossDraws(*(v.cpu() for v in d.loss[:2])))
    aux_c, gn_c = g.train_step(0, draws=d)
    aux_h, gn_h = h.train_step(0, draws=hd)
    worst = max(abs(float(aux_c[k]) - float(aux_h[k])) / max(abs(float(aux_h[k])), 1e-30)
                for k in aux_h)
    g_rel = abs(float(gn_c) - float(gn_h)) / float(gn_h)
    print(f"[phase 14] {label}: one step at batch {nb}, card against CPU: losses max rel err "
          f"{worst:.2e}, global gradient norm rel err {g_rel:.2e} (tol {TOL_STEP})")
    if not (worst <= TOL_STEP and g_rel <= TOL_STEP):
        fail(f"a {label} training step on the card disagrees with the same step on the CPU")
    return max(worst, g_rel)


def fit_cli(kernels, args, exp, tmp):
    """train_cli.main(args) with fit and evaluate timed and the trainer kept;
    returns (trainer, fit seconds, evaluate seconds, the kernels' launches)."""
    import importlib.util

    import torch

    from pita_torch import train_cli
    from pita_torch.train.trainer import EnergyTempTrainer

    kept, times = [], {"fit": 0.0, "evaluate": 0.0}
    orig_fit, orig_eval = EnergyTempTrainer.fit, EnergyTempTrainer.evaluate

    def fit(self, *a, **k):
        kept.append(self)
        t0 = time.perf_counter()
        out = orig_fit(self, *a, **k)
        torch.cuda.synchronize()
        times["fit"] += time.perf_counter() - t0
        return out

    def evaluate(self, *a, **k):
        t0 = time.perf_counter()
        out = orig_eval(self, *a, **k)
        torch.cuda.synchronize()
        times["evaluate"] += time.perf_counter() - t0
        return out

    EnergyTempTrainer.fit, EnergyTempTrainer.evaluate = fit, evaluate
    reset_counts(kernels)
    try:
        train_cli.main(args + [f"out_dir={tmp}", "test=false"]
                       + (["trainer.make_plots=true"]
                          if importlib.util.find_spec("matplotlib") else []))
    finally:
        EnergyTempTrainer.fit, EnergyTempTrainer.evaluate = orig_fit, orig_eval
    return kept[0], times["fit"], times["evaluate"], {f.__name__: f.launches for f in kernels}


def check_preset_run(tr, exp, tmp, counts, losses_ok=True):
    import importlib.util

    import torch

    m = tr.metrics_history[-1]
    buf1 = int(tr.buffers.size[1])
    finite = all(math.isfinite(v) for v in m.values() if isinstance(v, float))
    print(f"[phase 14] {exp}: val metrics " + ", ".join(
        f"{k} {v:.4g}" for k, v in m.items() if k.startswith("val/") and isinstance(v, float)))
    if not finite:
        fail(f"the {exp} run logged a non-finite metric")
    if buf1 == 0 or not bool(torch.isfinite(tr.buffers.energy[1, :buf1]).all()):
        fail(f"the {exp} fill left the rung-1 buffer empty or non-finite")
    if any(counts.values()):
        fail(f"the {exp} run launched one of the port's kernels: {counts}")
    if importlib.util.find_spec("matplotlib"):
        fig = os.path.join(tmp, exp, "plots", "epoch_1", "gmm_samples.png")
        if exp == "gmm" and not os.path.exists(fig):
            fail("the gmm run wrote no GMM figure")
    else:
        print(f"[phase 14] {exp}: no matplotlib on this machine, so no figures (the CPU test "
              f"tests/test_torch_mlp.py writes the GMM figure)")
    return buf1


def phase_presets(kernels, tmp):
    """Phase 14.4-14.6: the gmm preset by train_cli with no experiment, the
    dw4 preset, TorchMD-ET behind the lj13 preset."""
    import numpy as np
    import torch

    from pita_torch.baselines.mcmc import jittered_lattice
    from pita_torch.configs import compose, parse_overrides
    from pita_torch.nets import TorchMDETBackbone

    out = {}
    cut = ["trainer.num_epochs_per_temp=2,100", "trainer.max_epochs=2",
           "trainer.n_train_batches_per_epoch=10", "trainer.training_batch_size=512",
           "trainer.num_temp_annealed_samples=2048"]
    args = ["device=cuda"] + cut
    tr, t_fit, t_eval, counts = fit_cli(kernels, args, "gmm", os.path.join(tmp, "gmm"))
    buf1 = check_preset_run(tr, "gmm", os.path.join(tmp, "gmm"), counts)
    print(f"[phase 14] train_cli with no experiment (gmm: MLP 128 x 3, emb 128), 2 epochs x 10 "
          f"batches of 512 and the transition fill at 2,048 chains x 1,000 steps (2 islands) "
          f"and the 512-chain pass without resampling: fit {t_fit:.2f} s, of which the fill "
          f"{t_eval:.2f} s; rung-1 buffer {buf1} rows; launches {counts}")
    cfg = compose("gmm", overrides=dict(parse_overrides(cut),
                                        out_dir=os.path.join(tmp, "gmm_step")))
    out.update(gmm_fit_s=t_fit, gmm_fill_s=t_eval,
               gmm_step_rel_err=card_vs_cpu_step(cfg, tr, "gmm"))

    dw4_cut = ["experiment=dw4", "energy.n_warmup_steps=200", "energy.n_block_steps=20",
               "trainer.num_epochs_per_temp=2,150,200", "trainer.max_epochs=2",
               "trainer.n_train_batches_per_epoch=10", "trainer.training_batch_size=512",
               "trainer.num_temp_annealed_samples=512", "trainer.num_eval_samples=512"]
    tr, t_fit, t_eval, counts = fit_cli(kernels, ["device=cuda"] + dw4_cut, "dw4",
                                        os.path.join(tmp, "dw4"))
    buf1 = check_preset_run(tr, "dw4", os.path.join(tmp, "dw4"), counts)
    print(f"[phase 14] train_cli experiment=dw4 (2-D EGNN 32 x 3 on the autograd route), MALA "
          f"sets (256 chains, 200 + 20-step blocks), 2 epochs x 10 batches of 512 and the fill "
          f"at 512 chains x 1,000 steps with the exact trace by the 2-D edge operators, and "
          f"its pass without resampling: fit {t_fit:.2f} s, of which the fill {t_eval:.2f} s; "
          f"rung-1 buffer {buf1} rows; launches {counts}")
    cfg = compose("dw4", overrides=dict(parse_overrides(dw4_cut[1:]),
                                        out_dir=os.path.join(tmp, "dw4_step")))
    out.update(dw4_fit_s=t_fit, dw4_fill_s=t_eval,
               dw4_step_rel_err=card_vs_cpu_step(cfg, tr, "dw4"))

    # TorchMD-ET at its defaults on LJ55 configurations, card against CPU
    net = TorchMDETBackbone(55).reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    base = jittered_lattice(55, 2048, gen) + 0.1 * torch.randn(2048, 165, generator=gen)
    tt = torch.rand(2048, generator=gen) * 3 - 2
    cnet = net.with_route("autograd").cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = cnet(tt.cuda(), base.cuda(), 1.0)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        n_cpu = 64
        t0 = time.perf_counter()
        yh = net(tt[:n_cpu], base[:n_cpu], 1.0)
        t_cpu = time.perf_counter() - t0
    err = float((y[:n_cpu].cpu() - yh).abs().max() / yh.abs().max())
    print(f"[phase 14] TorchMD-ET (hidden 32, 6 layers, 1 head, 32 RBF) forward on 2,048 LJ55 "
          f"configurations: {t_card:.3f} s on the card; the first {n_cpu} on the CPU "
          f"{t_cpu:.2f} s: max err {err:.2e} of the largest (tol 1e-5)")
    if not (err <= 1e-5 and bool(torch.isfinite(y).all())):
        fail("TorchMD-ET on the card disagrees with the CPU")
    data13 = os.path.join(tmp, "data13_et")
    os.makedirs(data13, exist_ok=True)
    for which in ("train", "val", "test"):
        np.save(os.path.join(data13, f"LJ13_temp_4.0_{which}.npy"),
                jittered_lattice(13, 512, gen).numpy())
    reset_counts(kernels)
    t0 = time.perf_counter()
    from pita_torch import train_cli

    train_cli.main(["experiment=lj13", "net.kind=torchmd_et", "debug=short", "device=cuda",
                    "trainer.max_epochs=1", "test=false", f"energy.data_dir={data13}",
                    f"out_dir={os.path.join(tmp, 'lj13_et')}"])
    t_et = time.perf_counter() - t0
    c = {f.__name__: f.launches for f in kernels}
    print(f"[phase 14] train_cli experiment=lj13 net.kind=torchmd_et debug=short "
          f"trainer.max_epochs=1 test=false: {t_et:.2f} s; launches of the port's kernels "
          f"other than K1 {sum(v for k, v in c.items() if 'lj' not in k)}")
    if any(v for k, v in c.items() if "lj" not in k):
        fail("the TorchMD-ET run launched an EGNN kernel")
    out.update(torchmd_err=err, torchmd_fwd_s=t_card, torchmd_cli_s=t_et)
    return out


def phase_cnf():
    """Phase 14.7: cnf_nll on the card: the analytic Gaussian score
    (tests/test_cnf.py, 64 samples, 200 RK4 steps, exact divergence) against
    the closed-form NLL; the GMM oracle score on 1,024 GMM-40 samples, card
    against CPU, with the gap to the exact −log p beside it."""
    import torch

    from pita_torch.sampler import cnf_nll
    from pita_torch.schedules import ElucidatingNoiseSchedule
    from pita_torch.targets import GMM40
    from pita_torch.targets.gmm import GMMScoreOracle

    class Gaussian:
        def score(self, ht, xt, beta):
            return -xt / (1.0 + torch.as_tensor(ht, dtype=xt.dtype).reshape(-1, 1))

    sched = ElucidatingNoiseSchedule(sigma_min=0.01, sigma_max=10.0, rho=7.0)
    x0 = torch.randn(64, 2, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    t0 = time.perf_counter()
    res = cnf_nll(x0, Gaussian(), sched, num_steps=200, exact=True)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    true = 0.5 * (x0 ** 2).sum(-1) + math.log(2 * math.pi)
    gap = (res.nll - true).abs()
    ok = bool((gap <= 0.05 + 0.05 * true.abs()).all())
    print(f"[phase 14] cnf_nll, analytic Gaussian score, 64 samples x 200 RK4 steps, exact "
          f"divergence: {t_g:.2f} s; max |NLL - closed form| {float(gap.max()):.2e} (rtol 0.05, "
          f"atol 0.05) -> {'pass' if ok else 'MISS'}")
    if not ok:
        fail("cnf_nll misses the closed-form Gaussian NLL")
    gmm = GMM40()
    sched80 = ElucidatingNoiseSchedule(sigma_min=0.01, sigma_max=80.0, rho=7.0)
    xg = gmm.sample(1024, torch.Generator("cuda").manual_seed(1))
    t0 = time.perf_counter()
    card = cnf_nll(xg, GMMScoreOracle(gmm), sched80, num_steps=100, exact=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = cnf_nll(xg.cpu(), GMMScoreOracle(gmm), sched80, num_steps=100, exact=True)
    t_cpu = time.perf_counter() - t0
    err = float((card.nll.cpu() - cpu.nll).abs().max() / cpu.nll.abs().max())
    exact_gap = float((card.nll + gmm.log_prob(xg)).mean())
    print(f"[phase 14] cnf_nll, GMM oracle score, 1,024 GMM-40 samples x 100 RK4 steps: card "
          f"{t_card:.2f} s, CPU {t_cpu:.2f} s, max rel err {err:.2e} (tol {TOL_CARD_CPU}); "
          f"mean NLL - exact -log p {exact_gap:.4f} (the prior at t = 1 is N(0, h(1)), not the "
          f"noised GMM: a number, not a gate)")
    if not err <= TOL_CARD_CPU:
        fail("cnf_nll on the card disagrees with the CPU")
    return dict(cnf_gauss_max_gap=float(gap.max()), cnf_gmm_rel_err=err,
                cnf_gmm_exact_gap=exact_gap)


def phase_oracle(kernels, tmp, wl=None, wl32=None):
    """Phase 14: the analytic GMM oracle, Hutch++, the Laplacian and
    pinning, the gmm and dw4 presets, TorchMD-ET and the CNF on the card."""
    import torch

    from pita_torch.io.bench_asset import load_lj55_bench

    wl = wl or load_lj55_bench(device="cuda", compute_dtype=torch.bfloat16)
    wl32 = wl32 or load_lj55_bench(device="cuda", compute_dtype=torch.float32)
    t0 = time.perf_counter()
    out, parts = {}, {}
    for name, run in (("oracle", lambda: phase_oracle_runs(kernels)),
                      ("LJ55 sampler modes", lambda: phase_lj_sampler_modes(kernels, wl, wl32)),
                      ("presets", lambda: phase_presets(kernels, tmp)),
                      ("CNF", phase_cnf)):
        t1 = time.perf_counter()
        out.update(run())
        parts[name] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    print(f"[phase 14] the oracle and the new presets: {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


# FAB's inner step, card against CPU: the loss, the weight gradients (of
# the largest) and the buffer's adjusted weights, f32 flows of 8 couplings
# summed in another order
TOL_FAB_STEP = 1e-4
# the weights after that step, in units of the learning rate: the update
# differs by less than that, and a weight below 0.5 rounds to 6e-8 (6e-4 lr)
TOL_FAB_WEIGHTS_LR = 1e-3
TOL_DP = 1e-6  # the data-parallel step against the trainer's, of the largest weight change


def nccl_group(tmp):
    """World size 1 over NCCL, joined through a file store under ``tmp``."""
    from pita_torch.parallel import make_group

    return make_group(f"file://{os.path.join(tmp, 'nccl_store')}", 1, 0)


def same_result(a, b):
    """Two IntegrateResults bitwise equal (samples, log-weights, ancestor
    counts, MALA acceptance, term diagnostics)."""
    import torch

    pairs = [(a.samples, b.samples), (a.logweights, b.logweights),
             (a.num_unique, b.num_unique), (a.acceptance_rates, b.acceptance_rates)]
    pairs += [(a.term_stats[k], b.term_stats[k]) for k in a.term_stats]
    return all(torch.equal(x, y) for x, y in pairs)


def phase_sharded_sampling(kernels, wl, group):
    """Phase 15a: sharded_integrate at world size 1 over NCCL against
    integrate_sde with the same seed, on the bench pair: hutch_ess_k10 at
    2,048 chains x 100 steps, timed in turns (unsharded, sharded, sharded,
    unsharded), and a 512-chain run with the final resample and 30 MALA
    steps (K1). Each pair must agree bitwise and launch the same kernels."""
    import torch

    from pita_torch.parallel import sharded_integrate
    from pita_torch.sampler import integrate_sde

    counts = lambda: {f.__name__: f.launches for f in kernels}
    gen = torch.Generator("cuda").manual_seed(15)
    x1 = torch.randn(2048, 165, generator=gen, device="cuda") * wl.prior_scale
    x1q = torch.randn(512, 165, generator=gen, device="cuda") * wl.prior_scale
    args = (wl.score, wl.energy, wl.noise, wl.anneal, wl.target, 1.0)
    runs = {
        "unsharded": lambda x, c: integrate_sde(x, *args, c, seed=2, device="cuda"),
        "sharded": lambda x, c: sharded_integrate(group, x, *args, c, seed=2),
    }
    cfg = hutch_cfg(num_integration_steps=100, end_resampling_step=100)
    cfg_q = hutch_cfg(num_integration_steps=100, end_resampling_step=90, resample_at_end=True,
                      post_mcmc_steps=30, adaptive_mcmc=True, dt_negative_time=5e-5)
    for run in runs.values():  # warm-up
        run(x1[:256], cfg.replace(num_integration_steps=10, end_resampling_step=10))
    torch.cuda.synchronize()
    out = {}
    for label, x, c, order in (("hutch_ess_k10 2048 x 100", x1, cfg,
                                ("unsharded", "sharded", "sharded", "unsharded")),
                               ("512 x 100 + final resample + 30 MALA", x1q, cfg_q,
                                ("unsharded", "sharded"))):
        res, walls, launches = {}, {k: [] for k in runs}, {}
        for name in order:
            reset_counts(kernels)
            t0 = time.perf_counter()
            r = runs[name](x, c)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            launches.setdefault(name, counts())
            res.setdefault(name, r)
            if launches[name] != counts():
                fail(f"phase 15: the {name} run's launches changed between its repeats")
            if not same_result(res[name], r):
                fail(f"phase 15: the {name} run is not bitwise repeatable")
        bitwise = same_result(res["unsharded"], res["sharded"])
        rates = {k: x.shape[0] * c.num_integration_steps / min(v) for k, v in walls.items()}
        print(f"[phase 15] {label}: unsharded {', '.join(f'{w:.3f}' for w in walls['unsharded'])}"
              f" s, sharded (NCCL, world 1) {', '.join(f'{w:.3f}' for w in walls['sharded'])} s;"
              f" best {rates['unsharded']:.1f} / {rates['sharded']:.1f} chain*steps/s "
              f"(sharding overhead {100 * (rates['unsharded'] / rates['sharded'] - 1):+.2f} %); "
              f"bitwise equal: {bitwise}; launches unsharded {launches['unsharded']}, sharded "
              f"{launches['sharded']}")
        if not bitwise:
            fail(f"phase 15: the sharded {label} run differs from the unsharded one")
        if launches["unsharded"] != launches["sharded"]:
            fail(f"phase 15: the sharded {label} run launches other kernels than the unsharded")
        ln = launches["sharded"]
        if not (ln["egnn_layer_forward_tc"] and ln["egnn_layer_backward_tc"]):
            fail(f"phase 15: the sharded {label} run did not launch K2 and K3 (tensor cores)")
        if any(ln[k] for k in ("egnn_layer_forward", "egnn_layer_backward", "_contract_scalar",
                               "_lj_scalar", "egnn_layer_tangent", "egnn_layer_tangent_tc",
                               "egnn_layer_forward_tf32", "egnn_layer_backward_tf32",
                               "egnn_layer_tangent_tf32", "g_operator_contract")):
            fail(f"phase 15: the sharded {label} run launched a scalar, yardstick or "
                 f"exact-divergence kernel")
        if c.post_mcmc_steps and not ln["lj_log_prob_and_force"]:
            fail("phase 15: MALA in the sharded run did not launch K1")
        key = "hutch" if c is cfg else "mala"
        out[f"{key}_rate_unsharded"] = rates["unsharded"]
        out[f"{key}_rate_sharded"] = rates["sharded"]
        out[f"{key}_launches"] = ln
    # what a collective costs: a resampling step of the sharded sampler makes
    # 4 gathers (the clamp's, the weights', the state's with the carried
    # divergence as one more column, the three diagnostics' stacked), another
    # step 2, a MALA step 1 all-reduce
    v, xs = torch.randn(2048, device="cuda"), torch.randn(2048, 166, device="cuda")
    one = torch.ones((), dtype=torch.int64, device="cuda")
    for key, label, fn in (
            ("gather_weights", "all_gather of 2,048 floats", lambda: group.gather_rows(v)),
            ("gather_state", "all_gather of 2,048 x 166 floats", lambda: group.gather_rows(xs)),
            ("sum", "all_reduce of one integer", lambda: group.sum(one))):
        us, ev = host_us(fn, n=500), cuda_ms(fn, reps=200) * 1e3
        print(f"[phase 15] NCCL at world 1, {label}: {us:.1f} us of host time a call (no "
              f"synchronization), {ev:.1f} us a call by CUDA events")
        out[f"nccl_{key}_host_us"], out[f"nccl_{key}_event_us"] = us, ev
    return out


def phase_dp_and_buffer(group, tmp, wl):
    """Phase 15b: one make_dp_train_step of the lj55 preset (batch 256) at
    world size 1 against the trainer's train_step with the same draws, then
    each timed in turns over 5 steps; ShardedBufferOps against the plain
    buffer at the preset's capacity (adds with masks, the three sampling
    modes)."""
    import numpy as np
    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.parallel import ShardedBufferOps, make_dp_train_step
    from pita_torch.train.augment import com_augment, rotate_augment
    from pita_torch.train.buffer import (buffer_add, buffer_init, buffer_sample, buffer_set,
                                         buffer_view)

    cfg = lj55_train_cfg(tmp)
    tr = build_trainer(cfg, device="cuda")
    x = torch.as_tensor(wl.data_T_low, device="cuda")
    e, f = tr.targets[0].log_prob_and_force(x)
    tr.buffers = buffer_set(tr.buffers, 0, buffer_add(buffer_view(tr.buffers, 0), x, e, f))
    state = tr.state_dict()
    state.pop("generator")
    tr2 = build_trainer(cfg, device="cuda")
    tr2.load_state_dict(state)
    B, n_p, n_d = cfg.trainer.training_batch_size, tr.n_particles, tr.n_spatial_dim
    step = make_dp_train_step(group, tr2.score, tr2.energy, tr2.noise_schedule, tr2.loss_cfg,
                              tr2.lr_at, grad_clip=tr2.cfg.grad_clip, n_particles=n_p,
                              n_spatial_dim=n_d, mean_free=tr2.mean_free, target=tr2.targets[0])
    beta = float(tr2.inverse_temperatures[0])

    def dp_step(d):
        x0, e0, f0, _ = buffer_sample(buffer_view(tr2.buffers, 0), B, idx=d.idx)
        x0, f0 = rotate_augment(x0, f0, n_p, n_d, normal=d.rot_normal)
        if not tr2.mean_free:
            x0 = com_augment(x0, n_p, n_d, normal=d.com_normal)
        tr2.opt_state, scalars, g_norm = step(tr2.opt_state, x0, e0, f0, beta, d.loss)
        return scalars, g_norm

    before = [p.detach().clone() for p in tr.params]
    d = tr.draw_step(0)
    aux, gn = tr.train_step(0, draws=d)
    aux2, gn2 = dp_step(d)
    change = max(float((p.detach() - b).abs().max()) for p, b in zip(tr.params, before))
    err = max(float((p.detach() - q.detach()).abs().max()) for p, q in zip(tr.params, tr2.params))
    loss_err = max(abs(float(aux[k]) - float(aux2[k])) / max(abs(float(aux[k])), 1e-30)
                   for k in aux)
    gn_err = abs(float(gn) - float(gn2)) / float(gn)
    walls = {"trainer": [], "dp": []}
    for name in ("trainer", "dp", "dp", "trainer"):
        ms = []
        for _ in range(5):
            d = tr.draw_step(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(0, draws=d) if name == "trainer" else dp_step(d)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        walls[name] += ms
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[phase 15] lj55 make_dp_train_step (NCCL, world 1) against the trainer's "
          f"train_step, batch {B}, same draws: largest weight change {change:.3e}, max weight "
          f"gap {err:.3e} = {err / change:.2e} of it (tol {TOL_DP}); losses max rel err "
          f"{loss_err:.2e}, gradient norm rel err {gn_err:.2e}; a step: trainer median "
          f"{med['trainer']:.2f} ms, DP {med['dp']:.2f} ms (10 each, in turns)")
    if not err <= TOL_DP * change:
        fail("phase 15: the data-parallel step disagrees with the trainer's step")

    cap, dim = tr.cfg.buffer_capacity, tr.dim
    ops = ShardedBufferOps(group)
    ref, shb = buffer_init(cap, dim, "cuda"), ops.place(buffer_init(cap, dim, "cuda"))
    g = torch.Generator("cuda").manual_seed(3)
    for _ in range(3):
        xs = torch.randn(4096, dim, generator=g, device="cuda")
        es = torch.randn(4096, generator=g, device="cuda")
        fs = torch.randn(4096, dim, generator=g, device="cuda")
        ref = buffer_add(ref, xs, es, fs, mask=es < 1.0)
        shb = ops.add(shb, xs, es, fs, mask=es < 1.0)
    same = (torch.equal(ref.x, shb.x) and torch.equal(ref.energy, shb.energy)
            and torch.equal(ref.force, shb.force) and (ref.pos, ref.size) == (shb.pos, shb.size))
    for prioritize, replacement in ((False, True), (False, False), (True, False)):
        a = buffer_sample(ref, B, prioritize, replacement,
                          generator=torch.Generator("cuda").manual_seed(4))
        b = ops.sample(shb, B, prioritize, replacement,
                       generator=torch.Generator("cuda").manual_seed(4))
        same = same and all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"[phase 15] ShardedBufferOps (world 1, {ops.rows_per_rank(shb)} rows a rank) against "
          f"the plain buffer, capacity {cap} x {dim}, 3 masked adds of 4,096, {B} rows in each "
          f"sampling mode: bitwise equal {same}")
    if not same:
        fail("phase 15: the sharded buffer disagrees with the plain buffer")
    return dict(dp_weight_gap=err / change, dp_step_ms=med["dp"], trainer_step_ms=med["trainer"])


def many_well_log_Z(dim=32):
    """ManyWell's exact log Z at T = 1: dim/2 x (log of the 1-D well's
    integral by the trapezoid rule on [-6, 6], 200,001 points) + dim/2 x
    1/2 log 2 pi."""
    import numpy as np

    x = np.linspace(-6.0, 6.0, 200001)
    y = np.exp(-(-0.5 * x - 6.0 * x ** 2 + x ** 4))
    z1 = float((y[1:] + y[:-1]).sum() * (x[1] - x[0]) / 2)
    return dim // 2 * (math.log(z1) + 0.5 * math.log(2 * math.pi))


def phase_fab():
    """Phase 15c: FAB at pita_tpu's defaults on the card: AIS to a normalized
    Gaussian (|log Z| < 0.1), one prioritised-buffer inner step card against
    CPU, AIS calls and inner steps timed, 50 outer iterations on ManyWell-32,
    and AIS's log Z of ManyWell-32 from the trained flow beside the exact one."""
    import copy

    import numpy as np
    import torch

    from pita_torch.fab import (AISConfig, FABConfig, FabDraws, FlowDistribution,
                                GaussianTarget, ManyWell, annealed_importance_sampling,
                                train_fab_with_prioritised_buffer)
    from pita_torch.fab.fab_model import (_ais_cfg, flow_ais, prioritised_loss,
                                          prioritised_step)
    from pita_torch.train.buffer import PrioritisedBuffer, prioritised_add, prioritised_init
    from pita_torch.train.optim import adam_init

    gen = lambda s: torch.Generator("cuda").manual_seed(s)
    base = GaussianTarget(np.zeros(2), np.full(2, 2.0), device="cuda")
    target = GaussianTarget(np.ones(2), np.ones(2), device="cuda")
    t0 = time.perf_counter()
    res = annealed_importance_sampling(
        lambda n, d: base.sample_and_log_prob(n, eps=d.base((n, 2))), base.log_prob,
        target.log_prob, 2048, AISConfig(n_intermediate_distributions=16, n_inner_steps=3),
        FabDraws(gen(0)))
    torch.cuda.synchronize()
    gauss_log_Z = float(res.log_Z)
    print(f"[phase 15] AIS N(0, 4I) -> N(1, I), 2,048 chains, 16 intermediate distributions x 3 "
          f"HMC sweeps: {time.perf_counter() - t0:.2f} s, log Z {float(res.log_Z):+.4f} "
          f"(|log Z| < 0.1), ESS {float(res.ess_base):.4f} -> {float(res.ess_ais):.4f}")
    if not abs(float(res.log_Z)) < 0.1:
        fail("phase 15: AIS misses log Z of a normalized Gaussian")

    mw, cfg = ManyWell(dim=32), FABConfig()
    ais_cfg = _ais_cfg(cfg, min_is_target=True)
    flow = FlowDistribution(32, device="cuda", generator=gen(1))
    draws = FabDraws(gen(2))
    buf = prioritised_init(cfg.buffer_capacity, 32, device="cuda")
    ais_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = flow_ais(flow, mw.log_prob, cfg.batch_size, ais_cfg, draws)
        with torch.no_grad():
            buf = prioritised_add(buf, r.samples, r.log_w, flow.log_prob(r.samples))
        torch.cuda.synchronize()
        ais_ms.append((time.perf_counter() - t0) * 1e3)
    cpu = FlowDistribution(32, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in flow.module.state_dict().items()})
    buf_cpu = PrioritisedBuffer(buf.x.cpu(), buf.log_w.cpu(), buf.log_q.cpu(), buf.pos, buf.size)
    gumbel = draws.gumbel((cfg.buffer_capacity,))
    card = copy.deepcopy(flow)
    grads = [torch.autograd.grad(prioritised_loss(f, b, cfg, g)[0], f.parameters())
             for f, b, g in ((card, buf, gumbel), (cpu, buf_cpu, gumbel.cpu()))]
    g_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(*grads)) / max(
        float(b.abs().max()) for b in grads[1])
    _, buf_c, loss_c, ok_c = prioritised_step(card, copy.deepcopy(buf),
                                              adam_init(card.parameters()), cfg, gumbel)
    _, buf_h, loss_h, ok_h = prioritised_step(cpu, buf_cpu, adam_init(cpu.parameters()), cfg,
                                              gumbel.cpu())
    w_err = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(card.parameters(), cpu.parameters())) / cfg.lr
    l_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    b_err = max(rel_err(buf_c.log_w.cpu()[:buf.size], buf_h.log_w[:buf.size])[0],
                rel_err(buf_c.log_q.cpu()[:buf.size], buf_h.log_q[:buf.size])[0])
    print(f"[phase 15] FAB inner step on ManyWell-32 (flow 8 x 64, batch {cfg.batch_size}, "
          f"from 5 AIS calls), card against CPU: loss rel err {l_err:.2e}, gradients {g_err:.2e} "
          f"of the largest, buffer log w / log q rel err {b_err:.2e} (tol {TOL_FAB_STEP}); "
          f"weights after the step {w_err:.2e} lr apart (tol {TOL_FAB_WEIGHTS_LR}); applied "
          f"{ok_c} / {ok_h}")
    if not (ok_c and ok_h and max(l_err, g_err, b_err) <= TOL_FAB_STEP
            and w_err <= TOL_FAB_WEIGHTS_LR):
        fail("phase 15: FAB's inner step on the card disagrees with the CPU")
    state = adam_init(card.parameters())
    step_ms = []
    for _ in range(10):
        g = draws.gumbel((cfg.buffer_capacity,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, buf_c, _, _ = prioritised_step(card, buf_c, state, cfg, g)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    n_iter = 50
    trained = FlowDistribution(32, device="cuda", generator=gen(1))
    t0 = time.perf_counter()
    fbuf, hist = train_fab_with_prioritised_buffer(trained, mw.log_prob, cfg, n_iter, seed=3)
    torch.cuda.synchronize()
    t_fab = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    ess = [h["ess_ais"] for h in hist]
    want_size = min(n_iter * cfg.batch_size, cfg.buffer_capacity)
    res = flow_ais(trained, mw.log_prob, 2048, _ais_cfg(cfg, min_is_target=False), FabDraws(gen(4)))
    exact = many_well_log_Z(32)
    print(f"[phase 15] FAB with the prioritised buffer, ManyWell-32, FABConfig() (batch "
          f"{cfg.batch_size}, {cfg.n_intermediate_distributions} intermediate distributions, "
          f"HMC): {n_iter} outer iterations in {t_fab:.2f} s ({len(hist)} that trained, "
          f"{cfg.n_batches_buffer_sampling} inner steps each); an AIS call median "
          f"{np.median(ais_ms):.1f} ms, an inner step median {np.median(step_ms):.2f} ms; "
          f"ESS of the alpha-target AIS first {ess[0]:.4f}, last {ess[-1]:.4f}; loss first "
          f"{losses[0]:.4f}, last {losses[-1]:.4f}; buffer {fbuf.size} rows ({want_size} "
          f"expected)")
    print(f"[phase 15] AIS to ManyWell-32 from the trained flow, 2,048 chains: log Z "
          f"{float(res.log_Z):.4f}, exact {exact:.4f} (16 x log of the 1-D well's integral by "
          f"quadrature + 16 x 1/2 log 2 pi), ESS {float(res.ess_base):.4f} -> "
          f"{float(res.ess_ais):.4f}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(ess)) and fbuf.size == want_size
            and np.isfinite(float(res.log_Z))):
        fail("phase 15: FAB on ManyWell-32 gave a non-finite loss, ESS or log Z, or a short "
             "buffer")
    return dict(fab_ais_ms=float(np.median(ais_ms)), fab_inner_step_ms=float(np.median(step_ms)),
                fab_step_card_cpu=max(l_err, g_err, b_err), fab_s=t_fab, fab_ess_last=ess[-1],
                manywell_log_Z=float(res.log_Z), manywell_log_Z_exact=exact,
                gauss_log_Z=gauss_log_Z)


def phase_parallel_fab(kernels, tmp, wl=None):
    """Phase 15: sharded sampling and data-parallel training over NCCL at
    world size 1 (the one card), FAB with the prioritised buffer."""
    import torch
    import torch.distributed as dist

    from pita_torch.io.bench_asset import load_lj55_bench

    wl = wl or load_lj55_bench(device="cuda", compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    group = nccl_group(tmp)
    try:
        out, parts = {}, {}
        for name, run in (("sharded sampling", lambda: phase_sharded_sampling(kernels, wl, group)),
                          ("DP and buffer", lambda: phase_dp_and_buffer(group, tmp, wl)),
                          ("FAB", phase_fab)):
            t1 = time.perf_counter()
            out.update(run())
            parts[name] = time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    print(f"[phase 15] multi-GPU at world size 1 and FAB: {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "pita_torch")):
        fail("run from a checkout of the repository (pita_torch/ is missing)")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)

    from pita_torch.io.bench_asset import load_lj55_bench
    from pita_torch.ops import _build
    from pita_torch.ops.egnn_layer import (egnn_layer_backward, egnn_layer_backward_tc,
                                           egnn_layer_backward_tf32, egnn_layer_forward,
                                           egnn_layer_forward_tc, egnn_layer_forward_tf32)
    from pita_torch.ops.egnn_tangent import (egnn_layer_tangent, egnn_layer_tangent_tc,
                                             egnn_layer_tangent_tf32)
    from pita_torch.ops.g_op import _contract_scalar, g_operator_contract
    from pita_torch.ops.lj import _lj_scalar, lj_log_prob_and_force
    from pita_torch.sampler import integrate_sde

    # phase 1
    secs = _build.build_all()
    print(f"[phase 1] built {', '.join(_build.SOURCES)} in {secs:.1f} s")
    for name in _build.SOURCES:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln or "Function properties" in ln:
                print(f"[phase 1] {name}: {ln.strip()}")

    kernels = (lj_log_prob_and_force, egnn_layer_forward, egnn_layer_forward_tc,
               egnn_layer_forward_tf32, egnn_layer_backward, egnn_layer_backward_tc,
               egnn_layer_backward_tf32, egnn_layer_tangent, egnn_layer_tangent_tc,
               egnn_layer_tangent_tf32,
               g_operator_contract, _contract_scalar, _lj_scalar)
    if "--training-only" in sys.argv[1:]:  # quick check of the training path
        with tempfile.TemporaryDirectory() as tmp:
            phase_training(kernels, tmp, "--profile" in sys.argv[1:])
        return 0
    if "--tools-only" in sys.argv[1:]:  # quick check of the training tools
        with tempfile.TemporaryDirectory() as tmp:
            phase_tools(kernels, tmp)
        return 0
    if "--peptides-only" in sys.argv[1:]:  # quick check of the peptide path
        with tempfile.TemporaryDirectory() as tmp:
            phase_peptides(kernels, tmp)
        return 0
    if "--oracle-only" in sys.argv[1:]:  # quick check of the oracle and the new presets
        with tempfile.TemporaryDirectory() as tmp:
            phase_oracle(kernels, tmp)
        return 0
    if "--parallel-fab-only" in sys.argv[1:]:  # quick check of phase 15
        with tempfile.TemporaryDirectory() as tmp:
            phase_parallel_fab(kernels, tmp)
        return 0

    wl = load_lj55_bench(device="cuda", compute_dtype=torch.bfloat16)
    wl32 = load_lj55_bench(device="cuda", compute_dtype=torch.float32)
    data = wl.data_T_low
    profile = "--profile" in sys.argv[1:]
    if "--outlier-seed" in sys.argv[1:]:  # follow phase 5's lowest samples at one seed
        trace_outlier(wl, data, int(sys.argv[sys.argv.index("--outlier-seed") + 1]))
        return 0

    # phases 2, 3, 6, 7: every kernel against its plain version
    k1, k1_scalar = phase_lj(data)
    eg = phase_egcl(wl, data)
    k5, k5_scalar = phase_g_op(wl, data)
    k4, k4_f32, k4_f32_scalar = phase_tangent(wl, wl32, data)
    if "--kernels-only" in sys.argv[1:]:  # quick check of a kernel change
        return 0

    # phase 4: the first main path, timed
    gen = torch.Generator("cuda").manual_seed(0)
    n_chains, n_steps = 2048, 100
    x1 = torch.randn(n_chains, 165, generator=gen, device="cuda") * wl.prior_scale
    cfg = hutch_cfg(num_integration_steps=n_steps, end_resampling_step=n_steps)
    run = lambda seed: integrate_sde(x1, wl.score, wl.energy, wl.noise, wl.anneal,
                                     wl.target, 1.0, cfg, seed=seed, device="cuda")
    run(1)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    res = run(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = {f.__name__: f.launches for f in kernels}
    if not torch.isfinite(res.samples).all():
        fail("main path produced non-finite samples")
    rate = n_chains * n_steps / wall
    n_res = int((res.num_unique < n_chains).sum())
    print(f"[phase 4] hutch_ess_k10 {n_chains} chains x {n_steps} steps: {wall:.3f} s, "
          f"{rate:.1f} chain*steps/s; launches {main_counts}; resampling fired "
          f"{n_res} times")
    # 3 layers: the score and the energy net every step, the Hutchinson VJP's
    # forward every 10th (its one launch at twice the chains)
    want_k2 = 3 * (2 * n_steps + n_steps // 10)
    print(f"[phase 4] tensor-core K2 launched {main_counts['egnn_layer_forward_tc']} times "
          f"({want_k2} expected), the scalar K2 {main_counts['egnn_layer_forward']}, the scalar "
          f"K3 {main_counts['egnn_layer_backward']}")
    if main_counts["egnn_layer_forward_tc"] != want_k2 or main_counts["egnn_layer_backward_tc"] == 0:
        fail("the main path did not launch the tensor-core EGCL kernels (K2 and K3)")
    if any(main_counts[k] for k in ("egnn_layer_forward", "egnn_layer_backward",
                                    "egnn_layer_forward_tf32", "egnn_layer_backward_tf32")):
        fail("the main path launched a scalar or an f32 EGCL kernel")
    if profile:  # where the device time of the main path goes
        profile_main_path(wl, x1, cfg, "hutch_ess_k10")

    # phase 5: quality run with MALA
    n_seeds = 1
    if "--quality-seeds" in sys.argv[1:]:  # the gate's spread over seeds
        n_seeds = int(sys.argv[sys.argv.index("--quality-seeds") + 1])
    for seed in range(n_seeds):
        reset_counts(kernels)
        w2_gt, spread, _ = quality(wl, data, seed)
        q_counts = {f.__name__: f.launches for f in kernels}
        print(f"[phase 5] launches {q_counts}")
        if q_counts["lj_log_prob_and_force"] == 0 or q_counts["_lj_scalar"]:
            fail("MALA did not launch the LJ kernel, or launched the first one")
        if seed == 0 and w2_gt > 2 * spread:
            fail(f"energy W2 against ground truth {w2_gt:.3f} > 2 sigma_GT {2 * spread:.3f}")

    # phase 8: every route of the exact divergence gives the same weights
    (k2_scalar_launches, k3_scalar_launches, k4_scalar_launches), (
        k2_tf32_launches, k3_tf32_launches, k4_tf32_launches) = phase_wiring(wl, wl32, data,
                                                                            kernels)
    phase_routes_random_weights(wl, data)

    # phase 9: the second main path, timed, once per route
    q10 = exact_cfg(num_integration_steps=n_steps, end_resampling_step=n_steps,
                    divergence_update_interval=10)
    rates, ex_counts = {}, {}
    for route, kw in ROUTES.items():
        rates[route], ex_counts[route] = timed_exact_run(
            wl, x1, q10.replace(**kw), f"quadrature_k10 ({route})", kernels, profile)
    x1s = x1[:256]
    for route in ("g_kernel", "tangent_kernel"):
        _, c = timed_exact_run(wl, x1s, q10.replace(divergence_update_interval=1,
                                                    **ROUTES[route]),
                               f"exact ({route})", kernels, False)
        if c["g_operator_contract" if route == "g_kernel" else "egnn_layer_tangent_tc"] == 0:
            fail(f"exact ({route}) did not launch its kernel")
    k5_launches = ex_counts["g_kernel"]["g_operator_contract"]
    k4_launches = ex_counts["tangent_kernel"]["egnn_layer_tangent_tc"]
    if k5_launches == 0 or k4_launches == 0:
        fail("the exact-divergence main path did not launch K4/K5")
    if any(ex_counts["materialized"][k] for k in ("g_operator_contract", "egnn_layer_tangent",
                                                  "egnn_layer_tangent_tc",
                                                  "egnn_layer_tangent_tf32")):
        fail("the materialized route launched a divergence kernel")

    # phase 10: quality of the exact-divergence population, on the faster kernel route
    fast = max(("g_kernel", "tangent_kernel"), key=rates.get)
    reset_counts(kernels)
    w2_ex, spread, arms = quality(wl, data, 0, phase=10, label=f"quadrature_k10 ({fast})",
                                  make_cfg=lambda **kw: exact_cfg(divergence_update_interval=10,
                                                                  **ROUTES[fast], **kw))
    print(f"[phase 10] launches { {f.__name__: f.launches for f in kernels} }")
    if w2_ex > 2 * spread:
        fail(f"exact-divergence energy W2 against ground truth {w2_ex:.3f} > 2 sigma_GT "
             f"{2 * spread:.3f}")
    if not all(arms):
        fail(f"the exact-divergence quality run misses an arm of the gate (ground truth, exact "
             f"population: {arms})")

    with tempfile.TemporaryDirectory() as tmp:
        # phase 11: the LJ55 training ladder (train set, training, a rung
        # transition's fill, checkpoints), the f32 kernels its main route
        training_rows, ckpt = phase_training(kernels, tmp, profile)
        # phase 12: DEM pretraining, HMC, the gated protocol, the entry points
        tools_rows = phase_tools(kernels, tmp, ckpt)
        # phase 13: the alanine-peptide path (force field, MD, the aldp ladder)
        peptide = phase_peptides(kernels, tmp)
        # phase 14: the GMM oracle, the rest of the sampler, gmm, dw4, TorchMD-ET
        oracle = phase_oracle(kernels, tmp, wl, wl32)
        # phase 15: sharded sampling and DP training over NCCL at world size 1, FAB
        parallel_fab = phase_parallel_fab(kernels, tmp, wl)

    src = "pita_torch/csrc/"
    line = {"kernels": [
        dict(name="lj_log_prob_and_force", route="cuda", source=src + "lj.cu",
             replaces="pita_tpu/ops/pallas/lj.py:108",
             launches=q_counts["lj_log_prob_and_force"], library_ms=None, **k1),
        # the first K1, timed as the yardstick; phases 5 and 11 require that
        # no path launches it
        dict(name="lj_log_prob_and_force_scalar", route="cuda", source=src + "lj.cu",
             replaces="pita_tpu/ops/pallas/lj.py:108", launches=q_counts["_lj_scalar"],
             library_ms=None, **k1_scalar),
        dict(name="egcl_forward_tc", route="cuda", source=src + "egnn_layer_tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:318",
             launches=main_counts["egnn_layer_forward_tc"],
             max_abs_err=max(eg["bf16"][0], eg["fwd_extra_err"]), library_ms=None, **eg["fwd"]),
        # the f32 K2 at the DEM refill's 2,000 chains: launches from the f32
        # backbone's runs of phase 8; the scalar K2, timed as the yardstick
        # (phases 8, 11 and 12 require that no f32 path at N = 55 launches it)
        dict(name="egcl_forward_tf32", route="cuda", source=src + "egnn_layer_f32tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:318", launches=k2_tf32_launches,
             **dict(eg["fwd_f32"], max_abs_err=max(eg["f32"][0],
                                                   eg["fwd_f32"]["max_abs_err"]))),
        dict(name="egcl_forward_scalar", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:318", launches=k2_scalar_launches,
             **eg["fwd_f32_scalar"]),
        dict(name="egcl_backward_tc", route="cuda", source=src + "egnn_layer_tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342",
             launches=main_counts["egnn_layer_backward_tc"],
             max_abs_err=max(eg["bf16"][1], eg["bwd_extra_err"]), library_ms=None, **eg["bwd"]),
        # the f32 K3 at the fill's 256 chains: launches from the f32
        # backbone's runs of phase 8; the scalar K3, timed as the yardstick
        # (phases 8, 11 and 12 require that no f32 path at N = 55 launches it)
        dict(name="egcl_backward_tf32", route="cuda", source=src + "egnn_layer_bwd_f32tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342", launches=k3_tf32_launches,
             **dict(eg["bwd_f32"], max_abs_err=max(eg["f32"][1],
                                                   eg["bwd_f32"]["max_abs_err"]))),
        dict(name="egcl_backward", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342", launches=k3_scalar_launches,
             **eg["bwd_f32_scalar"]),
        dict(name="egcl_tangent_tc", route="cuda", source=src + "egnn_tangent_tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_launches, **k4),
        # the f32 K4 at 256 chains x 64 tangents: launches from the f32
        # backbone's runs of phase 8; the scalar K4, timed as the yardstick
        # (phases 8 and 11 require that no f32 path at N = 55 launches it)
        dict(name="egcl_tangent_tf32", route="cuda", source=src + "egnn_tangent_f32tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_tf32_launches,
             **k4_f32),
        dict(name="egcl_tangent_scalar", route="cuda", source=src + "egnn_tangent.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_scalar_launches,
             **k4_f32_scalar),
        dict(name="g_operator_contract_tc", route="cuda", source=src + "g_op.cu",
             replaces="pita_tpu/ops/pallas/g_op.py:133", launches=k5_launches, **k5),
        # the scalar K5, timed as the yardstick; phases 8 and 9 require that
        # no route launches it
        dict(name="g_operator_contract_scalar", route="cuda", source=src + "g_op.cu",
             replaces="pita_tpu/ops/pallas/g_op.py:133",
             launches=ex_counts["g_kernel"]["_contract_scalar"], **k5_scalar),
        *training_rows,
        *tools_rows,
    ], "peptide": peptide, "oracle": oracle, "parallel_fab": parallel_fab}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
