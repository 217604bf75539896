#!/usr/bin/env python3
"""Drive the PyTorch port's LJ55 sampling paths on one NVIDIA GPU (H100).

Usage, from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing lines, each failing the run on disagreement:
  1. build the CUDA kernels of pita_torch/csrc/ with nvcc (sm_90a), one
     nvcc per source, all started together;
  2. K1 (LJ log_prob + force) against its plain version, LJ55 with the
     spline and LJ13 without, 2048 configurations;
  3. K2 (EGCL forward) against layer_step and K3 (EGCL VJP) against autograd
     through layer_step: bench weights, each of the 3 layers, 2048 chains,
     N=55, in f32 and bf16;
  4. the first main path, timed: bench_lj55.npz through the port's decoder,
     the hutch_ess_k10 configuration of bench.py at 2048 chains x 100 steps
     after one warm-up; the K2 and K3 launch counters must move;
  5. its quality run: 512 chains x 400 steps, final resample, 30 adaptive
     MALA steps; energy W2 against the ground-truth samples and against the
     exact-divergence population of bench_lj55_exact_energies.npy; the K1
     counter must move; fails on non-finite samples or W2 > 2 sigma_GT;
  6. K5 (G-operator contraction) against its plain version (materialized G,
     bf16-rounded, f32 einsum): primals of layers 1 and 2 of the bench score
     net at t = 0.5 on perturbed ground-truth samples and on first-step inputs
     (prior samples at t = 1), 64 chains x 165 tangents, and near-integer
     inputs exactly; then compared and timed at the main path's launch, a
     chunk of 256 chains x 165 tangents;
  7. K4 (EGCL layer tangent) against its plain version: each layer in f32 and
     bf16 on the tangents the trace gives it, 64 chains x 64 tangents; then
     the whole forward-mode trace against the edge-operator trace; then
     compared at the main path's launches, 256 chains x a super-chunk of 64
     tangents and x the ragged last one of 37, and timed at the first;
  8. end-to-end wiring of the exact divergence: 64 chains x 8 steps with the
     weights accumulating in every step and resampling never firing, same
     draws: the K5 route and the K4 route each against the materialized-G
     route; samples identical, final log-weights within tolerance, with the
     bf16 and with an f32 backbone; then the trace by the three routes on a
     full-width backbone with random weights, where the G-operator term is
     not as small as on the trained ones;
  9. the second main path, timed: quadrature_k10 of bench.py (exact
     divergence every 10th step, resampling every step, chain chunks of 256)
     at 2048 chains x 100 steps once per route, each after a 10-step warm-up,
     the K2 and K4/K5 counters must move; then exact (every step) at 256
     chains x 100 steps per kernel route;
 10. the exact-divergence quality run: quadrature_k10 on the faster kernel
     route, 512 chains x 400 steps, final resample, 30 MALA steps, both arms
     of the gate as in phase 5.

Then one JSON line with every kernel's launches, error, times and bound,
and last {"ok": true, "device": {...}}. Any failure exits non-zero. TF32 is
off for matmuls and convolutions, so float32 stays float32.

Options for measurement runs: --kernels-only runs phases 1-3, 6 and 7 only;
--profile adds a torch.profiler breakdown of each timed main path;
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


def bound_ms(n_bytes, n_ops, peak_ops):
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def phase_lj(data):
    import torch

    from pita_torch.ops import lj as ljop
    from pita_torch.targets import LJ13, LJ55

    out = {}
    gen = torch.Generator("cuda").manual_seed(1)
    base = torch.as_tensor(data, device="cuda").repeat(2, 1)  # (2048, 165)
    x55 = (base + 0.01 * torch.randn(base.shape, generator=gen, device="cuda")).contiguous()
    x13 = x55[:, :39].contiguous()
    for name, tgt, x in (("lj55_spline", LJ55(smooth=True, temperature=2.0 / 1.2), x55),
                         ("lj13", LJ13(), x13)):
        kw = dict(eps=tgt.eps, rm=tgt.rm, oscillator_scale=tgt._osc,
                  energy_factor=tgt.energy_factor, temperature=tgt.temperature,
                  spline=tgt.spline)
        lp_k, f_k = ljop.lj_log_prob_and_force(x, tgt.n_particles, **kw)
        lp_p, f_p = ljop.lj_log_prob_and_force_plain(x, tgt.n_particles, **kw)
        torch.cuda.synchronize()
        (r_lp, a_lp), (r_f, a_f) = rel_err(lp_k, lp_p), rel_err(f_k, f_p)
        print(f"[phase 2] K1 {name} B={x.shape[0]}: logp max abs {a_lp:.3e} rel {r_lp:.3e}; "
              f"force max abs {a_f:.3e} rel {r_f:.3e} (tol rel {TOL_LJ})")
        if not (r_lp <= TOL_LJ and r_f <= TOL_LJ):
            fail(f"K1 {name} disagrees with its plain version")
        if name == "lj55_spline":
            B, N = x.shape[0], tgt.n_particles
            ms = cuda_ms(lambda: ljop.lj_log_prob_and_force(x, N, **kw))
            plain = cuda_ms(lambda: ljop.lj_log_prob_and_force_plain(x, N, **kw), reps=5)
            # 26 f32 operations per ordered pair (distance, powers, energy,
            # force accumulation), x read once, logp and force written once
            bnd, by = bound_ms(4 * (2 * B * N * 3 + B), 26 * B * N * (N - 1), PEAK_F32)
            out = dict(max_abs_err=max(a_lp, a_f), ms=ms, plain_ms=plain, bound_ms=bnd,
                       bound_by=by)
            print(f"[phase 2] K1 lj55 B={B}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bnd:.4f} ms ({by})")
    return out


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
            gh = torch.randn(h.shape, generator=gen, device="cuda")
            gx = torch.randn(x.shape, generator=gen, device="cuda")
            ho_k, xo_k = el.egnn_layer_forward(h, x, ea, w, packed=packed, **cfg)
            with torch.no_grad():
                ho_p, xo_p = el.layer_step(h, x, ea, w, **cfg)
            d_k = el.egnn_layer_backward(h, x, ea, gh, gx, w, packed=packed, **cfg)
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
            if cd_name == "bf16" and li == 0:
                fwd = lambda: el.egnn_layer_forward(h, x, ea, w, packed=packed, **cfg)
                bwd = lambda: el.egnn_layer_backward(h, x, ea, gh, gx, w, packed=packed, **cfg)
                ms_f, ms_b = cuda_ms(fwd), cuda_ms(bwd, reps=10)
                with torch.no_grad():
                    pl_f = cuda_ms(lambda: el.layer_step(h, x, ea, w, **cfg), reps=5)
                pl_b = cuda_ms(lambda: el.layer_vjp(h, x, ea, gh, gx, w, **cfg), reps=3)
                E = B * N * (N - 1)
                node_ops = B * N * 10 * F * F  # src, dst and the node MLP
                wbytes = 4 * packed.numel()
                io_f = 4 * (2 * B * N * F + 2 * B * N * 3 + B * N * N) + wbytes
                io_b = 4 * (3 * B * N * F + 3 * B * N * 3 + 2 * B * N * N) + wbytes
                # edge products: 2 F x F matmuls forward; the VJP rebuilds them
                # and runs their 2 transposes (bf16 inputs: tensor-core peak)
                bf = bound_ms(io_f, E * 4 * F * F + node_ops, PEAK_BF16)
                bb_ = bound_ms(io_b, E * 8 * F * F + 2 * node_ops, PEAK_BF16)
                res["fwd"] = dict(ms=ms_f, plain_ms=pl_f, bound_ms=bf[0], bound_by=bf[1])
                res["bwd"] = dict(ms=ms_b, plain_ms=pl_b, bound_ms=bb_[0], bound_by=bb_[1])
                print(f"[phase 3] bf16 B={B} layer 0: K2 {ms_f:.4f} ms (plain {pl_f:.3f}, "
                      f"bound {bf[0]:.4f} {bf[1]}); K3 {ms_b:.4f} ms (plain {pl_b:.3f}, "
                      f"bound {bb_[0]:.4f} {bb_[1]}); f32-scalar bound K2 "
                      f"{(E * 4 * F * F + node_ops) / PEAK_F32 * 1e3:.4f} ms")
                # the same layer on the inputs of the first EM step (prior
                # samples at t=1), where many activations are far from 0
                _, c_in1, _, c_noise1 = coeffs(wl.noise.h(torch.ones(B, device="cuda")))
                xp = torch.randn(B, N, 3, generator=gen, device="cuda") * wl.prior_scale
                xp = (xp * c_in1[:, None, None]).contiguous()
                f1 = torch.stack([c_noise1, torch.ones_like(c_noise1)], -1)[:, None, :]
                hp = (f1.expand(B, N, 2) @ bb.w_emb + bb.b_emb).contiguous()
                eap = ((xp[:, :, None] - xp[:, None]) ** 2).sum(-1).contiguous()
                ms_f1 = cuda_ms(lambda: el.egnn_layer_forward(hp, xp, eap, w, packed=packed,
                                                              **cfg))
                ms_b1 = cuda_ms(lambda: el.egnn_layer_backward(hp, xp, eap, gh, gx, w,
                                                               packed=packed, **cfg), reps=10)
                print(f"[phase 3] bf16 B={B} layer 0 on first-step inputs (t=1): "
                      f"K2 {ms_f1:.4f} ms, K3 {ms_b1:.4f} ms")
            with torch.no_grad():
                h, x = ho_p, xo_p
        res[cd_name] = (worst_f, worst_b)
    return res


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
    # compared and timed
    B = 256
    x_flat = base[:B] + 0.01 * randn(B, 165)
    prim = g_op_args(wl, x_flat, 0.5, layers=(1,))[0]
    bv = randn(T, B, N, F) * 0.1
    got = g_op.g_operator_contract(*prim, bv)
    ref = g_op.g_operator_contract_plain(*prim, bv)
    torch.cuda.synchronize()
    rel, ab = rel_err(got, ref)
    worst_abs = max(worst_abs, ab)
    print(f"[phase 6] K5 t=0.5 data layer 1 B={B} T={T} (the main path's launch): max |t2| "
          f"{float(ref.abs().max()):.3e}, max abs err {ab:.3e} rel {rel:.3e} (tol rel {TOL_GOP})")
    if not rel <= TOL_GOP:
        fail("K5 disagrees with its plain version at the main path's shape")
    del got, ref
    ms = cuda_ms(lambda: g_op.g_operator_contract(*prim, bv), reps=5, warmup=1)
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
    print(f"[phase 6] K5 B={B} T={T}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
          f"{bnd:.4f} ms ({by}), one torch.bmm of a pre-materialized bf16 G (excludes "
          f"building G) {lib:.3f} ms")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib)


def phase_tangent(wl, wl32, data):
    import torch

    from pita_torch.nets import egnn_fast as ef
    from pita_torch.ops import egnn_layer as el
    from pita_torch.ops import egnn_tangent as et

    gen = torch.Generator("cuda").manual_seed(7)
    N, F, Tc = 55, 32, 64
    bb = wl.score.backbone
    base = torch.as_tensor(data, device="cuda")

    def states(B):
        x_flat = base[:B] + 0.01 * torch.randn(B, 165, generator=gen, device="cuda")
        c_noise, x_in = score_inputs(wl, x_flat, 0.5)
        xs = x_in.reshape(B, N, 3).contiguous()
        h = bb.embed(c_noise, x_in, 1.0).contiguous()
        ea = ((xs[:, :, None] - xs[:, None]) ** 2).sum(-1).contiguous()
        basis = torch.eye(165, device="cuda")[:Tc].reshape(Tc, N, 3).contiguous()
        return c_noise, x_in, h, xs, ea, basis

    c_noise, x_in, h0, xs, ea, basis = states(64)
    worst_abs = 0.0
    timed = None
    for cd_name, cd, tol in (("f32", torch.float32, TOL_F32), ("bf16", torch.bfloat16, TOL_BF16)):
        h, x = h0, xs
        dh = torch.zeros(64, Tc, N, F, device="cuda")
        dx = basis[None].expand(64, -1, -1, -1).contiguous()
        for li, layer in enumerate(bb.layers):
            cfg = dict(layer.cfg, cd=cd)
            w = layer.weights()
            packed = el.pack_weights(w, cd).cuda()
            got = et.egnn_layer_tangent(h, x, ea, xs, basis, dh, dx, w, packed=packed, **cfg)
            with torch.no_grad():
                ref = et.layer_tangent(h, x, ea, xs, basis, dh, dx, w, **cfg)
                h_next, x_next = el.layer_step(h, x, ea, w, **cfg)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            if cd_name == "bf16":
                worst_abs = max([worst_abs] + [e[1] for e in errs])
            print(f"[phase 7] K4 {cd_name} layer {li} B=64 Tc={Tc}: rel err dh_out "
                  f"{errs[0][0]:.2e}, dx_out {errs[1][0]:.2e} (tol {tol})")
            if not max(e[0] for e in errs) <= tol:
                fail(f"K4 disagrees with its plain version ({cd_name}, layer {li})")
            if cd_name == "bf16" and li == 1:
                timed = (cfg, w, packed)
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
    # for the ragged last one of 37; compared, and the full one timed
    B = 256
    _, _, h0, xs, ea, _ = states(B)
    cfg, w, packed = timed
    l0 = bb.layers[0]
    h, x = el.egnn_layer_forward(h0, xs, ea, l0.weights(), packed=l0.packed(h0.device), **l0.cfg)
    eye = torch.eye(165, device="cuda").reshape(165, N, 3)

    def plain_all(basis, dh, dx):  # 64 chains at a time: it materializes (B,Tc,N,N,F)
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
                                       packed=l0.packed(h0.device), **l0.cfg)
        run = lambda: et.egnn_layer_tangent(h, x, ea, xs, basis, dh, dx, w, packed=packed, **cfg)
        got, ref = run(), plain_all(basis, dh, dx)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        worst_abs = max([worst_abs] + [e[1] for e in errs])
        print(f"[phase 7] K4 bf16 layer 1 B={B} Tc={n_t} (the main path's launch): rel err "
              f"dh_out {errs[0][0]:.2e}, dx_out {errs[1][0]:.2e} (tol {TOL_BF16})")
        if not max(e[0] for e in errs) <= TOL_BF16:
            fail(f"K4 disagrees with its plain version at the main path's shape (Tc={n_t})")
        del got, ref
        if n_t == Tc:
            ms = cuda_ms(run, reps=5, warmup=1)
            plain = cuda_ms(lambda: plain_all(basis, dh, dx), reps=1, warmup=1)
    E = B * N * (N - 1)
    # the two edge products per tangent, the primal's once, and the node
    # products (src, dst, node MLP) per tangent, on bf16 operands
    ops = Tc * E * 4 * F * F + E * 4 * F * F + (Tc + 1) * B * N * 10 * F * F
    n_bytes = 4 * (2 * B * Tc * N * (F + 3) + B * N * (F + 6) + B * N * N + Tc * N * 3
                   + packed.numel())
    bnd, by = bound_ms(n_bytes, ops, PEAK_BF16)
    print(f"[phase 7] K4 bf16 B={B} Tc={Tc} layer 1: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
          f"bound {bnd:.4f} ms ({by}); f32-scalar bound {ops / PEAK_F32 * 1e3:.3f} ms")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None)


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
    for name, load in (("bf16", wl), ("f32", wl32)):
        res = {}
        for route, kw in ROUTES.items():
            reset_counts(kernels)
            res[route] = integrate_sde(x1, load.score, load.energy, load.noise, load.anneal,
                                       load.target, 1.0, base.replace(**kw), seed=9,
                                       device="cuda")
            torch.cuda.synchronize()
            counts = {f.__name__: f.launches for f in kernels}
            want = {"g_kernel": "g_operator_contract", "tangent_kernel": "egnn_layer_tangent"}
            if route in want and counts[want[route]] == 0:
                fail(f"the {route} route did not launch {want[route]}")
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
    if counts["egnn_layer_forward"] == 0:
        fail(f"{label} did not launch the EGCL forward kernel")
    if profile:
        profile_main_path(wl, x1, cfg, label)
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


def profile_main_path(wl, x1, cfg, label):
    """torch.profiler over one run of a timed configuration: device time by
    kernel, and the device's busy share of the wall time."""
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
    for e in rows[:14]:
        print(f"[profile] {dev(e):9.2f} ms  {100 * dev(e) / busy:5.1f} %  x{e.count:<5d} "
              f"{e.key[:90]}")


def quality(wl, data, seed, make_cfg=None, phase=5, label="hutch_ess_k10"):
    """bench.py's quality run (bench.py:303-345, 505-519): 512 chains x 400
    steps of the mode ``make_cfg`` builds (hutch_ess_k10 by default), final
    resample at step 360, 30 adaptive MALA steps; returns (energy W2 against
    ground truth, sigma_GT)."""
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
    return w2_gt, spread


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
    from pita_torch.ops.egnn_layer import egnn_layer_backward, egnn_layer_forward
    from pita_torch.ops.egnn_tangent import egnn_layer_tangent
    from pita_torch.ops.g_op import g_operator_contract
    from pita_torch.ops.lj import lj_log_prob_and_force
    from pita_torch.sampler import integrate_sde

    # phase 1
    secs = _build.build_all()
    print(f"[phase 1] built {', '.join(_build.SOURCES)} in {secs:.1f} s")
    for name in _build.SOURCES:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[phase 1] {name}: {ln.strip()}")

    wl = load_lj55_bench(device="cuda", compute_dtype=torch.bfloat16)
    wl32 = load_lj55_bench(device="cuda", compute_dtype=torch.float32)
    data = wl.data_T_low
    profile = "--profile" in sys.argv[1:]

    # phases 2, 3, 6, 7: every kernel against its plain version
    k1 = phase_lj(data)
    eg = phase_egcl(wl, data)
    k5 = phase_g_op(wl, data)
    k4 = phase_tangent(wl, wl32, data)
    if "--kernels-only" in sys.argv[1:]:  # quick check of a kernel change
        return 0

    # phase 4: the first main path, timed
    kernels = (lj_log_prob_and_force, egnn_layer_forward, egnn_layer_backward,
               egnn_layer_tangent, g_operator_contract)
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
    if main_counts["egnn_layer_forward"] == 0 or main_counts["egnn_layer_backward"] == 0:
        fail("the main path did not launch the EGCL kernels")
    if profile:  # where the device time of the main path goes
        profile_main_path(wl, x1, cfg, "hutch_ess_k10")

    # phase 5: quality run with MALA
    n_seeds = 1
    if "--quality-seeds" in sys.argv[1:]:  # the gate's spread over seeds
        n_seeds = int(sys.argv[sys.argv.index("--quality-seeds") + 1])
    for seed in range(n_seeds):
        reset_counts(kernels)
        w2_gt, spread = quality(wl, data, seed)
        q_counts = {f.__name__: f.launches for f in kernels}
        print(f"[phase 5] launches {q_counts}")
        if q_counts["lj_log_prob_and_force"] == 0:
            fail("MALA did not launch the LJ kernel")
        if seed == 0 and w2_gt > 2 * spread:
            fail(f"energy W2 against ground truth {w2_gt:.3f} > 2 sigma_GT {2 * spread:.3f}")

    # phase 8: every route of the exact divergence gives the same weights
    phase_wiring(wl, wl32, data, kernels)
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
        if c["g_operator_contract" if route == "g_kernel" else "egnn_layer_tangent"] == 0:
            fail(f"exact ({route}) did not launch its kernel")
    k5_launches = ex_counts["g_kernel"]["g_operator_contract"]
    k4_launches = ex_counts["tangent_kernel"]["egnn_layer_tangent"]
    if k5_launches == 0 or k4_launches == 0:
        fail("the exact-divergence main path did not launch K4/K5")
    if ex_counts["materialized"]["g_operator_contract"] or \
            ex_counts["materialized"]["egnn_layer_tangent"]:
        fail("the materialized route launched a divergence kernel")

    # phase 10: quality of the exact-divergence population, on the faster kernel route
    fast = max(("g_kernel", "tangent_kernel"), key=rates.get)
    reset_counts(kernels)
    w2_ex, spread = quality(wl, data, 0, phase=10, label=f"quadrature_k10 ({fast})",
                            make_cfg=lambda **kw: exact_cfg(divergence_update_interval=10,
                                                            **ROUTES[fast], **kw))
    print(f"[phase 10] launches { {f.__name__: f.launches for f in kernels} }")
    if w2_ex > 2 * spread:
        fail(f"exact-divergence energy W2 against ground truth {w2_ex:.3f} > 2 sigma_GT "
             f"{2 * spread:.3f}")

    src = "pita_torch/csrc/"
    line = {"kernels": [
        dict(name="lj_log_prob_and_force", route="cuda", source=src + "lj.cu",
             replaces="pita_tpu/ops/pallas/lj.py:108",
             launches=q_counts["lj_log_prob_and_force"], library_ms=None, **k1),
        dict(name="egcl_forward", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:318",
             launches=main_counts["egnn_layer_forward"],
             max_abs_err=eg["bf16"][0], library_ms=None, **eg["fwd"]),
        dict(name="egcl_backward", route="cuda", source=src + "egnn_layer.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:342",
             launches=main_counts["egnn_layer_backward"],
             max_abs_err=eg["bf16"][1], library_ms=None, **eg["bwd"]),
        dict(name="egcl_tangent", route="cuda", source=src + "egnn_tangent.cu",
             replaces="pita_tpu/ops/pallas/egnn_fwd.py:365", launches=k4_launches, **k4),
        dict(name="g_operator_contract", route="cuda", source=src + "g_op.cu",
             replaces="pita_tpu/ops/pallas/g_op.py:133", launches=k5_launches, **k5),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
