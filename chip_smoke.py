#!/usr/bin/env python3
"""Drive the PyTorch port's LJ55 sampling and training paths on one NVIDIA GPU (H100).

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
     N=55, in f32 (the scalar K2 and K3) and bf16 (the tensor-core K2 and
     K3); the tensor-core kernels also on first-step inputs (prior samples at
     t = 1), at the Hutchinson launch's 4096 chains and at LJ13's N = 13;
     every K2 and K3 timed, the scalar K2 also in bf16 beside the
     tensor-core one;
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
     (the scalar K4) and bf16 (the tensor-core K4) on the tangents the trace
     gives it, 64 chains x 64 tangents; then the whole forward-mode trace
     against the edge-operator trace; then the tensor-core K4 compared at the
     main path's launches, 256 chains x a super-chunk of 64 tangents and x
     the ragged last one of 37, launched twice for a bitwise-equal result at
     the first and timed there in turns with the scalar K4 in bf16, the
     scalar K4 also timed in f32;
  8. end-to-end wiring of the exact divergence: 64 chains x 8 steps with the
     weights accumulating in every step and resampling never firing, same
     draws: the K5 route and the K4 route each against the materialized-G
     route; samples identical, final log-weights within tolerance, with the
     bf16 and with an f32 backbone (whose runs must launch the scalar f32
     K2 and K3, and the bf16 runs the scalar K2 never; no run the scalar
     K5); then the trace by the three routes on a full-width backbone with
     random weights, where the G-operator term is not as small as on the
     trained ones; the bf16 runs of the K4 route must launch the tensor-core
     K4 alone, the f32 runs the scalar K4 alone;
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
     steps; the f32 K1, K2, K3 and K4 must launch and no tensor-core kernel;
     finite weights and energies; the rung-1 buffer filled; no escalated
     retry), K1 and the f32 K2/K3/K4 compared and timed at those launches
     (K1's device time also by torch.profiler, which must find it), a fill
     step timed by each route, and a
     checkpoint saved, restored into a fresh trainer and compared bitwise,
     saved over, and a save interrupted before its rename.

Then one JSON line with every kernel's launches, error, times and bound,
and last {"ok": true, "device": {...}}. Any failure exits non-zero. TF32 is
off for matmuls and convolutions, so float32 stays float32.

Options for measurement runs: --kernels-only runs phases 1-3, 6 and 7 only;
--training-only runs phases 1 and 11 only;
--profile adds a torch.profiler breakdown of each timed main path (for the
K5 route also its five largest PyTorch kernels) and of 5 training steps;
--quality-seeds K repeats phase 5 over seeds 0..K-1 (the gate holds seed 0).
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
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


def egcl_bound(label, n_bytes, n_ops, peak_ops, n_edges, F):
    """bound_ms of an EGCL kernel, its three terms printed: the function
    needs sigma(z1), sigma(z2), sigma(cz) (F each), the attention sigmoid and
    a tanh per edge, each at least one SFU operation (tanh.approx.f32 gives
    a logistic in one; an exponential and a reciprocal take two)."""
    sfu = (3 * F + 2) * n_edges
    bnd = bound_ms(n_bytes, n_ops, peak_ops, sfu)
    print(f"[phase 3] bound of {label}: bytes {n_bytes / PEAK_BYTES * 1e3:.4f} ms, products "
          f"{n_ops / peak_ops * 1e3:.4f} ms, SFU {sfu / PEAK_SFU * 1e3:.4f} ms "
          f"({sfu:.3e} sigmoids and tanhs, one SFU operation each at 16/clk/SM, 1.98 GHz) "
          f"-> {bnd[0]:.4f} ms")
    return bnd


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
    import torch

    N, B = target.n_particles, x.shape[0]
    pairs = B * N * (N - 1) // 2
    f32 = LJ_F32_PER_PAIR * pairs + LJ_F32_PER_PARTICLE * B * N
    sfu = pairs
    close = 0
    if target.spline is not None:
        xr = x.reshape(B, N, 3)
        d2 = ((xr[:, :, None] - xr[:, None]) ** 2).sum(-1)
        d2.diagonal(dim1=1, dim2=2).fill_(float("inf"))
        close = int((d2 < target.spline[4] ** 2).sum()) // 2
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
            # the tensor-core K2's and K3's bf16 matrices
            ptc = el.pack_weights_tc(w).cuda() if cd == torch.bfloat16 else None
            gh = torch.randn(h.shape, generator=gen, device="cuda")
            gx = torch.randn(x.shape, generator=gen, device="cuda")
            ho_k, xo_k = el.egnn_layer_forward(h, x, ea, w, packed=packed, packed_tc=ptc, **cfg)
            with torch.no_grad():
                ho_p, xo_p = el.layer_step(h, x, ea, w, **cfg)
            d_k = el.egnn_layer_backward(h, x, ea, gh, gx, w, packed=packed, packed_tc=ptc, **cfg)
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
                                       gen))
            with torch.no_grad():
                h, x = ho_p, xo_p
        res[cd_name] = (worst_f, worst_b)
    return res


def egcl_layer0(wl, el, cd_name, cfg, w, packed, ptc, h, x, ea, gh, gx, gen):
    """Layer 0 at the main path's shapes: times and bounds of K2 and K3. For
    bf16 also the scalar K2 timed beside the tensor-core one, and the
    tensor-core K2 and K3 against the plain versions on first-step inputs,
    at the Hutchinson launch's 4096 chains and at LJ13's N = 13. Returns the
    JSON fields by kernel."""
    import torch

    from pita_torch.nets.precondition import coeffs

    B, N, F = h.shape
    fwd = lambda *a: el.egnn_layer_forward(*a, w, packed=packed, packed_tc=ptc, **cfg)
    bwd = lambda *a: el.egnn_layer_backward(*a, w, packed=packed, packed_tc=ptc, **cfg)
    ms_b = cuda_ms(lambda: bwd(h, x, ea, gh, gx), reps=10)
    pl_b = cuda_ms(lambda: el.layer_vjp(h, x, ea, gh, gx, w, **cfg), reps=3)
    ms_f = cuda_ms(lambda: fwd(h, x, ea))
    with torch.no_grad():
        pl_f = cuda_ms(lambda: el.layer_step(h, x, ea, w, **cfg), reps=5)
    E = B * N * (N - 1)
    node_ops = B * N * 10 * F * F  # src, dst and the node MLP
    wbytes = 4 * packed.numel()
    io_f = 4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N) + wbytes
    io_b = 4 * (3 * B * N * F + 3 * B * N * 3 + 2 * B * N * N) + wbytes
    # edge products: 2 F x F matmuls forward; the VJP rebuilds them and runs
    # their 2 transposes; bf16 inputs on tensor cores, f32 on the scalar units
    peak = PEAK_BF16 if cd_name == "bf16" else PEAK_F32
    bf = egcl_bound(f"K2 {cd_name} B={B}", io_f, E * 4 * F * F + node_ops, peak, E, F)
    bb_ = egcl_bound(f"K3 {cd_name} B={B}", io_b, E * 8 * F * F + 2 * node_ops, peak, E, F)
    if cd_name == "f32":
        print(f"[phase 3] f32 B={B} layer 0: scalar K2 {ms_f:.4f} ms (plain {pl_f:.3f}); "
              f"scalar K3 {ms_b:.4f} ms (plain {pl_b:.3f})")
        return {"fwd_f32": dict(ms=ms_f, plain_ms=pl_f, bound_ms=bf[0], bound_by=bf[1]),
                "bwd_f32": dict(ms=ms_b, plain_ms=pl_b, bound_ms=bb_[0], bound_by=bb_[1])}
    # the scalar K2 in bf16, past the dispatch for this timing only; in turns
    # with the tensor-core K2 (scalar, tensor cores, tensor cores, scalar)
    scalar = lambda *a: el._forward_scalar(*a, w, packed, **cfg)
    turns = [cuda_ms(lambda: f(h, x, ea)) for f in (scalar, fwd, fwd, scalar)]
    print(f"[phase 3] bf16 B={B} layer 0: tensor-core K2 {ms_f:.4f} ms, in turns with the "
          f"scalar K2 {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, tc, tc, scalar; "
          f"plain {pl_f:.3f}); tensor-core K3 {ms_b:.4f} ms (plain {pl_b:.3f})")
    # the same layer on the inputs of the first EM step (prior samples at
    # t=1), where many activations are far from 0
    bb = wl.energy.backbone
    _, c_in1, _, c_noise1 = coeffs(wl.noise.h(torch.ones(B, device="cuda")))
    xp = torch.randn(B, N, 3, generator=gen, device="cuda") * wl.prior_scale
    xp = (xp * c_in1[:, None, None]).contiguous()
    f1 = torch.stack([c_noise1, torch.ones_like(c_noise1)], -1)[:, None, :]
    hp = (f1.expand(B, N, 2) @ bb.w_emb + bb.b_emb).contiguous()
    eap = ((xp[:, :, None] - xp[:, None]) ** 2).sum(-1).contiguous()
    ms_f1 = cuda_ms(lambda: fwd(hp, xp, eap))
    ms_fs1 = cuda_ms(lambda: scalar(hp, xp, eap))
    ms_b1 = cuda_ms(lambda: bwd(hp, xp, eap, gh, gx), reps=10)
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
        got_f, got_b = fwd(*args[:3]), bwd(*args)
        if counts() != (before[0], before[1] + 1, before[2] + 1):
            fail("the bf16 layer did not launch the tensor-core K2 and K3 (and only them)")
        # the plain versions in chunks of 1024 chains: their edge tensors are 0.4 GB each
        chunks = range(0, args[0].shape[0], 1024)
        with torch.no_grad():
            ref_f = [torch.cat(p) for p in zip(*(
                el.layer_step(*(t[c0:c0 + 1024] for t in args[:3]), w, **cfg) for c0 in chunks))]
        ref_b = [torch.cat(p) for p in zip(*(
            el.layer_vjp(*(t[c0:c0 + 1024] for t in args), w, **cfg) for c0 in chunks))]
        torch.cuda.synchronize()
        errs_f = [rel_err(a, b) for a, b in zip(got_f, ref_f)]
        errs_b = [rel_err(a, b) for a, b in zip(got_b, ref_b)]
        worst_f = max([worst_f] + [e[1] for e in errs_f])
        worst_b = max([worst_b] + [e[1] for e in errs_b])
        print(f"[phase 3] tensor-core K2/K3 bf16 layer 0, {name}: rel err "
              + ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(
                  ("h_out", "x_out", "dh", "dx", "dea"), errs_f + errs_b))
              + f" (tol {TOL_BF16})")
        if not max(e[0] for e in errs_f + errs_b) <= TOL_BF16:
            fail(f"the tensor-core K2/K3 disagree with the plain versions on {name}")
        if args[0].shape[0] == 2 * B:
            h4, x4, ea4, gh4, gx4 = args
        del got_f, got_b, ref_f, ref_b
    ms_f4 = cuda_ms(lambda: fwd(h4, x4, ea4))
    ms_b4 = cuda_ms(lambda: bwd(h4, x4, ea4, gh4, gx4), reps=10)
    print(f"[phase 3] bf16 layer 0 on first-step inputs (B={B}): tensor-core K2 {ms_f1:.4f} ms, "
          f"scalar K2 {ms_fs1:.4f} ms, tensor-core K3 {ms_b1:.4f} ms; at B={2 * B}: "
          f"tensor-core K2 {ms_f4:.4f} ms, tensor-core K3 {ms_b4:.4f} ms")
    return {"fwd": dict(ms=ms_f, plain_ms=pl_f, bound_ms=bf[0], bound_by=bf[1]),
            "bwd": dict(ms=ms_b, plain_ms=pl_b, bound_ms=bb_[0], bound_by=bb_[1]),
            "fwd_extra_err": worst_f, "bwd_extra_err": worst_b}


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


def phase_tangent(wl, wl32, data):
    import torch

    from pita_torch.nets import egnn_fast as ef
    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    gen = torch.Generator("cuda").manual_seed(7)
    N, F, Tc = 55, 32, 64
    bb = wl.score.backbone
    base = torch.as_tensor(data, device="cuda")
    counts = lambda: (et.egnn_layer_tangent.launches, et.egnn_layer_tangent_tc.launches)

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
            ptc = el.pack_weights_tc(w).cuda() if tc else None
            before = counts()
            got = et.egnn_layer_tangent(h, x, ea, xs, basis, dh, dx, w, packed=packed,
                                        packed_tc=ptc, **cfg)
            if counts() != (before[0] + (not tc), before[1] + tc):
                fail(f"the {cd_name} layer tangent did not launch the "
                     f"{'tensor-core' if tc else 'scalar'} K4 alone")
            with torch.no_grad():
                ref = et.layer_tangent(h, x, ea, xs, basis, dh, dx, w, **cfg)
                h_next, x_next = el.layer_step(h, x, ea, w, **cfg)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            worst[cd_name] = max([worst[cd_name]] + [e[1] for e in errs])
            print(f"[phase 7] {'tensor-core' if tc else 'scalar'} K4 {cd_name} layer {li} B=64 "
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
    cfg32, _, packed32, _ = timed["f32"]
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
        if counts() != (before[0], before[1] + 1):
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
        # the scalar K4 in f32, its dtype of record, on the same inputs: in
        # turns at 8 and at 16 (the route's) tangents a block
        scalar32 = lambda chunk: lambda: et.egnn_layer_tangent(
            h, x, ea, xs, basis, dh, dx, w, packed=packed32, tangent_chunk=chunk, **cfg32)
        turns32 = [cuda_ms(scalar32(c), reps=5, warmup=1) for c in (8, 16, 16, 8)]
        ms32, ms32_8 = (turns32[1] + turns32[2]) / 2, (turns32[0] + turns32[3]) / 2
        plain32 = cuda_ms(lambda: plain_all(basis, dh, dx, cfg32), reps=1, warmup=1)
    E = B * N * (N - 1)
    # the two edge products per tangent, the primal's once, and the node
    # products (src, dst, node MLP) per tangent; the f32 work around them
    ops = Tc * E * 4 * F * F + E * 4 * F * F + (Tc + 1) * B * N * 10 * F * F
    ew = tangent_fp32_ops(Tc * E, F)
    n_bytes = 4 * (2 * B * Tc * N * (F + 3) + B * N * (F + 6) + B * N * N + Tc * N * 3
                   + packed.numel())
    bnd, by = bound_ms(n_bytes, ops, PEAK_BF16, fp32_ops=ew)
    bnd32, by32 = bound_ms(n_bytes, ops, PEAK_F32, fp32_ops=ew)
    print(f"[phase 7] bound of K4 B={B} Tc={Tc}: bytes {n_bytes / PEAK_BYTES * 1e3:.4f} ms, "
          f"products {ops / PEAK_BF16 * 1e3:.4f} ms on bf16 tensor cores "
          f"({ops / PEAK_F32 * 1e3:.4f} ms at the f32 rate), f32 elementwise "
          f"{ew / PEAK_FP32_OPS * 1e3:.4f} ms ({ew:.3e} operations at 128/clk/SM, 1.98 GHz) "
          f"-> bf16 {bnd:.4f} ms ({by}), f32 {bnd32:.4f} ms ({by32})")
    print(f"[phase 7] K4 bf16 B={B} Tc={Tc} layer 1: tensor-core kernel {ms:.4f} ms, in turns with "
          f"the scalar K4 {' / '.join(f'{v:.4f}' for v in turns)} ms (scalar, tc, tc, scalar); "
          f"plain {plain:.3f} ms; the scalar K4 in f32 at 16 tangents a block {ms32:.4f} ms, "
          f"at 8 {ms32_8:.4f} ms, in turns {' / '.join(f'{v:.4f}' for v in turns32)} ms "
          f"(8, 16, 16, 8; plain {plain32:.3f})")
    if not ms < ms_s:
        fail("the tensor-core K4 is not faster than the scalar K4 at the main path's launch")
    return (dict(max_abs_err=worst["bf16"], ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                 library_ms=None),
            dict(max_abs_err=worst["f32"], ms=ms32, plain_ms=plain32, bound_ms=bnd32,
                 bound_by=by32, library_ms=None))


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
            # the K4 route: the tensor-core K4 with the bf16 backbone, the scalar with the f32
            k4, other = (("egnn_layer_tangent_tc", "egnn_layer_tangent") if name == "bf16" else
                         ("egnn_layer_tangent", "egnn_layer_tangent_tc"))
            want = {"g_kernel": "g_operator_contract", "tangent_kernel": k4}
            if route in want and counts[want[route]] == 0:
                fail(f"the {route} route did not launch {want[route]}")
            if counts[other] or (route != "tangent_kernel" and counts[k4]):
                fail(f"the {route} route ({name} backbone) launched a K4 it should not")
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
          f"bf16 backbone's runs {scalar['bf16']}")
    if 0 in scalar["f32"]:
        fail("the f32 wiring runs did not launch the scalar K2, K3 and K4")
    if scalar["bf16"] != [0, 0, 0]:
        fail("the bf16 wiring runs launched a scalar EGCL kernel")
    return scalar["f32"]


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
    if counts["egnn_layer_forward_tc"] == 0 or counts["egnn_layer_forward"] != 0:
        fail(f"{label} did not run the tensor-core EGCL forward kernel alone")
    if counts["_contract_scalar"] or counts["egnn_layer_tangent"]:
        fail(f"{label} launched the scalar K5 or the scalar K4")
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
               "egcl_tan_kernel", "egcl_tan_tc_kernel", "g_op_kernel", "g_op_tc_kernel",
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


def profiled_ms(run, key, n=50):
    """Device time alone per launch of the kernels whose name holds ``key``
    over ``n`` calls of ``run`` (torch.profiler); None without such a row."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key]
    if not rows:
        return None
    return sum(e.self_device_time_total for e in rows) / 1e3 / sum(e.count for e in rows)


def k1_entry(target, x, label, launches):
    """K1 against its plain version at the shape x, its CUDA-event and
    profiled time per launch, and its bound (lj_bound, as phase 2 counts it)."""
    import torch

    from pita_torch.ops import lj as ljop

    N, B = target.n_particles, x.shape[0]
    kw = lj_kwargs(target)
    lp_k, f_k = ljop.lj_log_prob_and_force(x, N, **kw)
    lp_p, f_p = ljop.lj_log_prob_and_force_plain(x, N, **kw)
    torch.cuda.synchronize()
    (r_lp, a_lp), (r_f, a_f) = rel_err(lp_k, lp_p), rel_err(f_k, f_p)
    if not (r_lp <= TOL_LJ and r_f <= TOL_LJ):
        fail(f"K1 disagrees with its plain version at {label}")
    run = lambda: ljop.lj_log_prob_and_force(x, N, **kw)
    ms = cuda_ms(run, reps=50)
    dev_ms = profiled_ms(run, "lj_pairs_kernel")
    # the floor of a launch on the device: a one-element PyTorch add
    one = torch.zeros(1, device=x.device)
    floor_ms = profiled_ms(lambda: one.add_(1.0), "elementwise")
    plain = cuda_ms(lambda: ljop.lj_log_prob_and_force_plain(x, N, **kw), reps=5)
    bnd, by = lj_bound(x, target, label, 11)
    ms_or = lambda v: "not measured (no kernel row)" if v is None else f"{v:.4f} ms"
    dev, floor = ms_or(dev_ms), ms_or(floor_ms)
    print(f"[phase 11] K1 at {label} (B={B}): rel err logp {r_lp:.2e} force {r_f:.2e} "
          f"(tol {TOL_LJ}); {ms:.4f} ms a launch by CUDA events, device time alone {dev} "
          f"(torch.profiler; a one-element add's {floor}), plain {plain:.4f} ms, bound "
          f"{bnd:.5f} ms ({by}); "
          f"{launches} launches")
    if dev_ms is None:
        fail(f"K1's device time at {label} was not measured (no lj_pairs_kernel row)")
    return dict(name=f"lj_log_prob_and_force ({label})", route="cuda",
                source="pita_torch/csrc/lj.cu", replaces="pita_tpu/ops/pallas/lj.py:108",
                launches=launches, max_abs_err=max(a_lp, a_f), ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None)


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


def fill_layer_entries(tr, x_flat, counts):
    """The f32 scalar K2, K3 and K4 at the fill's launches (256 chains for
    the drift's networks; 64-chain chunks of 64 tangents for the K4 route),
    on the EMA score net's layer 0: against their plain versions, timed."""
    import torch

    from pita_torch.nets.precondition import coeffs
    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    bb = tr.ema_score.module
    layer = bb.layers[0]
    dev = x_flat.device
    B, N, F = x_flat.shape[0], tr.n_particles, bb.hidden_nf
    ht = tr.noise_schedule.h(torch.full((B,), 0.5, device=dev))
    _, c_in, _, c_noise = coeffs(ht)
    x_in = c_in[:, None] * x_flat
    xs = x_in.reshape(B, N, 3).contiguous()
    h = bb.embed(c_noise, x_in, 1.0).contiguous()
    ea = ((xs[:, :, None] - xs[:, None]) ** 2).sum(-1).contiguous()
    gen = torch.Generator(dev).manual_seed(11)
    gh = torch.randn(h.shape, generator=gen, device=dev)
    gx = torch.randn(xs.shape, generator=gen, device=dev)
    w, cfg, packed = layer.weights(), layer.cfg, layer.packed(dev)
    fwd = lambda: el.egnn_layer_forward(h, xs, ea, w, packed=packed, **cfg)
    bwd = lambda: el.egnn_layer_backward(h, xs, ea, gh, gx, w, packed=packed, **cfg)
    got = (*fwd(), *bwd())
    with torch.no_grad():
        ref_f = el.layer_step(h, xs, ea, w, **cfg)
    ref = (*ref_f, *el.layer_vjp(h, xs, ea, gh, gx, w, **cfg))
    Tc, Bc = 64, 64
    basis = torch.eye(N * 3, device=dev)[:Tc].reshape(Tc, N, 3).contiguous()
    dh = torch.zeros(Bc, Tc, N, F, device=dev)
    dx = basis[None].expand(Bc, -1, -1, -1).contiguous()
    targs = (h[:Bc], xs[:Bc], ea[:Bc], xs[:Bc], basis, dh, dx)
    tan = lambda: et.egnn_layer_tangent(*targs, w, packed=packed, **cfg)
    got_t = tan()
    with torch.no_grad():
        ref_t = et.layer_tangent(*targs, w, **cfg)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip((*got, *got_t), (*ref, *ref_t))]
    print(f"[phase 11] f32 scalar K2/K3 (B={B}) and K4 (B={Bc}, Tc={Tc}) on the trained EMA "
          f"weights, layer 0: rel err " + ", ".join(
              f"{n} {e[0]:.2e}" for n, e in zip(("h_out", "x_out", "dh", "dx", "dea",
                                                 "dh_tan", "dx_tan"), errs))
          + f" (tol {TOL_F32})")
    if not max(e[0] for e in errs) <= TOL_F32:
        fail("an f32 EGCL kernel disagrees with its plain version on the trained weights")
    ms_f, ms_b, ms_t = cuda_ms(fwd), cuda_ms(bwd, reps=10), cuda_ms(tan, reps=5, warmup=1)
    with torch.no_grad():
        pl_f = cuda_ms(lambda: el.layer_step(h, xs, ea, w, **cfg), reps=5)
        pl_t = cuda_ms(lambda: et.layer_tangent(*targs, w, **cfg), reps=2, warmup=1)
    pl_b = cuda_ms(lambda: el.layer_vjp(h, xs, ea, gh, gx, w, **cfg), reps=3)
    E, Et = B * N * (N - 1), Bc * N * (N - 1)
    node_ops = B * N * 10 * F * F
    wbytes = 4 * packed.numel()
    sfu = lambda e: (3 * F + 2) * e
    bf = bound_ms(4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N) + wbytes,
                  E * 4 * F * F + node_ops, PEAK_F32, sfu(E))
    bb_ = bound_ms(4 * (3 * B * N * F + 3 * B * N * 3 + 2 * B * N * N) + wbytes,
                   E * 8 * F * F + 2 * node_ops, PEAK_F32, sfu(E))
    bt = bound_ms(4 * (2 * Bc * Tc * N * (F + 3) + Bc * N * (F + 6) + Bc * N * N + Tc * N * 3)
                  + wbytes, Tc * Et * 4 * F * F + Et * 4 * F * F
                  + (Tc + 1) * Bc * N * 10 * F * F, PEAK_F32,
                  fp32_ops=tangent_fp32_ops(Tc * Et, F))
    print(f"[phase 11] f32 at the fill's launches: scalar K2 {ms_f:.4f} ms (plain {pl_f:.3f}, "
          f"bound {bf[0]:.4f} {bf[1]}), scalar K3 {ms_b:.4f} ms (plain {pl_b:.3f}, bound "
          f"{bb_[0]:.4f} {bb_[1]}), scalar K4 {ms_t:.4f} ms (plain {pl_t:.3f}, bound "
          f"{bt[0]:.4f} {bt[1]})")
    src = "pita_torch/csrc/"
    mk = lambda name, file, rep, launches, err, ms, pl, bnd: dict(
        name=f"{name} (phase 11 fill)", route="cuda", source=src + file,
        replaces=f"pita_tpu/ops/pallas/egnn_fwd.py:{rep}", launches=launches,
        max_abs_err=err, ms=ms, plain_ms=pl, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    return [
        mk("egcl_forward", "egnn_layer.cu", 318, counts["egnn_layer_forward"],
           max(e[1] for e in errs[:2]), ms_f, pl_f, bf),
        mk("egcl_backward", "egnn_layer.cu", 342, counts["egnn_layer_backward"],
           max(e[1] for e in errs[2:5]), ms_b, pl_b, bb_),
        mk("egcl_tangent", "egnn_tangent.cu", 365, counts["egnn_layer_tangent"],
           max(e[1] for e in errs[5:]), ms_t, pl_t, bt),
    ]


def same_state(a, b):
    """Whether two trainer states are equal, every tensor bitwise."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def profile_training(tr, n=5):
    """torch.profiler over ``n`` training steps: device busy share of the
    wall time and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows)
    print(f"[profile] training, {n} steps of {tr.cfg.training_batch_size}: wall {wall_ms:.1f} ms "
          f"(profiled), device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f} %, "
          f"{sum(e.count for e in rows)} kernels")
    for e in rows[:12]:
        print(f"[profile] {dev(e):9.2f} ms  {100 * dev(e) / busy:5.1f} %  x{e.count:<5d} "
              f"{e.key[:100]}")


def phase_training(kernels, profile=False):
    """Phase 11: the LJ55 training ladder on the card through
    pita_torch.configs.build_trainer. Returns the kernels-line entries;
    with ``profile`` also a torch.profiler breakdown of training steps."""
    import tempfile

    import numpy as np
    import torch

    from pita_torch.configs import build_trainer
    from pita_torch.io import checkpoint
    from pita_torch.sampler import integrate_sde
    from pita_torch.train.losses import LossDraws
    from pita_torch.train.trainer import StepDraws

    counts = lambda: {f.__name__: f.launches for f in kernels}
    with tempfile.TemporaryDirectory() as tmp:
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
                      LossDraws(d.loss.ln_sigma_normal[:nb], d.loss.noise[:nb]))
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
        for k in ("lj_log_prob_and_force", "egnn_layer_forward", "egnn_layer_backward",
                  "egnn_layer_tangent"):
            if fill_counts[k] == 0:
                fail(f"the f32 fill did not launch {k}")
        for k in ("egnn_layer_forward_tc", "egnn_layer_backward_tc", "egnn_layer_tangent_tc",
                  "g_operator_contract", "_contract_scalar", "_lj_scalar"):
            if fill_counts[k]:
                fail(f"the f32 fill launched {k}")
        if buf1 == 0 or not math.isfinite(m["val/ess"]) or not math.isfinite(
                m["val/energy_mean"]):
            fail("the fill left the rung-1 buffer empty or its weights or energies not finite")
        if not bool(torch.isfinite(tr.buffers.energy[1, :buf1]).all()):
            fail("the filled buffer holds non-finite energies")
        layer_rows = fill_layer_entries(tr, x_fill, fill_counts)
        rows = [k1_entry(tr.targets[0], torch.as_tensor(data[:512], device="cuda"),
                         "train-set MCMC, 512 chains", k1_set),
                k1_entry(tr.targets[1], x_fill, "fill, 256 chains",
                         fill_counts["lj_log_prob_and_force"])] + layer_rows
        # what one step of the fill costs by route, 256 chains, the EMA nets
        nets = tr._eval_wrappers()
        anneal = tr.make_annealing(float(tr.inverse_temperatures[1] / tr.inverse_temperatures[0]))
        x1 = tr._prior(1.0).sample(256, generator=tr.generator, device="cuda")
        route_s = {}
        for route, kw in (("K4", dict(divergence_tangent_kernel=True)),
                          ("K5", dict(divergence_tangent_kernel=False, divergence_g_kernel=True)),
                          ("materialized", dict(divergence_tangent_kernel=False))):
            c10 = cfg.integrator.replace(num_integration_steps=10, end_resampling_step=9,
                                         resample_at_end=False, **kw)
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
    return rows


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
                                           egnn_layer_forward, egnn_layer_forward_tc)
    from pita_torch.ops.egnn_tangent import egnn_layer_tangent, egnn_layer_tangent_tc
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
               egnn_layer_backward, egnn_layer_backward_tc, egnn_layer_tangent,
               egnn_layer_tangent_tc, g_operator_contract, _contract_scalar, _lj_scalar)
    if "--training-only" in sys.argv[1:]:  # quick check of the training path
        phase_training(kernels, "--profile" in sys.argv[1:])
        return 0

    wl = load_lj55_bench(device="cuda", compute_dtype=torch.bfloat16)
    wl32 = load_lj55_bench(device="cuda", compute_dtype=torch.float32)
    data = wl.data_T_low
    profile = "--profile" in sys.argv[1:]

    # phases 2, 3, 6, 7: every kernel against its plain version
    k1, k1_scalar = phase_lj(data)
    eg = phase_egcl(wl, data)
    k5, k5_scalar = phase_g_op(wl, data)
    k4, k4_scalar = phase_tangent(wl, wl32, data)
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
    if main_counts["egnn_layer_forward"] or main_counts["egnn_layer_backward"]:
        fail("the main path launched a scalar EGCL kernel")
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
    k2_f32_launches, k3_f32_launches, k4_f32_launches = phase_wiring(wl, wl32, data, kernels)
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
                                                  "egnn_layer_tangent_tc")):
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

    # phase 11: the LJ55 training ladder (train set, training, a rung
    # transition's fill, checkpoints), the f32 kernels its main route
    training_rows = phase_training(kernels, profile)

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
        # the f32 K2: launches from the f32 backbone's runs of phase 8
        dict(name="egcl_forward", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:318", launches=k2_f32_launches,
             max_abs_err=eg["f32"][0], library_ms=None, **eg["fwd_f32"]),
        dict(name="egcl_backward_tc", route="cuda", source=src + "egnn_layer_tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342",
             launches=main_counts["egnn_layer_backward_tc"],
             max_abs_err=max(eg["bf16"][1], eg["bwd_extra_err"]), library_ms=None, **eg["bwd"]),
        # the f32 K3: launches from the f32 backbone's runs of phase 8
        dict(name="egcl_backward", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342", launches=k3_f32_launches,
             max_abs_err=eg["f32"][1], library_ms=None, **eg["bwd_f32"]),
        dict(name="egcl_tangent_tc", route="cuda", source=src + "egnn_tangent_tc.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_launches, **k4),
        # the f32 K4: launches from the f32 backbone's runs of phase 8
        dict(name="egcl_tangent", route="cuda", source=src + "egnn_tangent.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_f32_launches,
             **k4_scalar),
        dict(name="g_operator_contract_tc", route="cuda", source=src + "g_op.cu",
             replaces="pita_tpu/ops/pallas/g_op.py:133", launches=k5_launches, **k5),
        # the scalar K5, timed as the yardstick; phases 8 and 9 require that
        # no route launches it
        dict(name="g_operator_contract_scalar", route="cuda", source=src + "g_op.cu",
             replaces="pita_tpu/ops/pallas/g_op.py:133",
             launches=ex_counts["g_kernel"]["_contract_scalar"], **k5_scalar),
        *training_rows,
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
