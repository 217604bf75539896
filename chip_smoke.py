#!/usr/bin/env python3
"""Drive the PyTorch port's LJ55 sampling path on one NVIDIA GPU (H100).

Usage, from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one line:
  1. build the CUDA kernels of pita_torch/csrc/ with nvcc (sm_90a);
  2. K1 (LJ log_prob + force) against its plain version, LJ55 with the
     spline and LJ13 without, 2048 configurations;
  3. K2 (EGCL forward) against layer_step and K3 (EGCL VJP) against autograd
     through layer_step: bench weights, each of the 3 layers, 2048 chains,
     N=55, in f32 and bf16;
  4. the main path, timed: bench_lj55.npz through the port's decoder, the
     hutch_ess_k10 configuration of bench.py at 2048 chains x 100 steps
     after one warm-up; the K2 and K3 launch counters must move;
  5. the quality run: 512 chains x 400 steps, final resample, 30 adaptive
     MALA steps; energy W2 against the ground-truth samples and against the
     exact-divergence population of bench_lj55_exact_energies.npy; the K1
     counter must move; fails on non-finite samples or W2 > 2 sigma_GT.

Then one JSON line with every kernel's launches, error, times and bound,
and last {"ok": true, "device": {...}}. Any failure exits non-zero. TF32 is
off for matmuls and convolutions, so float32 stays float32.

Options for measurement runs: --kernels-only stops after phase 3;
--profile adds a torch.profiler breakdown of the main path after
phase 4; --quality-seeds K repeats phase 5 over seeds 0..K-1 (the gate
holds seed 0).
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


def profile_main_path(wl, x1):
    """torch.profiler over the timed configuration (2048 chains x 100 steps):
    device time by kernel, and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pita_torch.sampler import integrate_sde

    cfg = hutch_cfg(num_integration_steps=100, end_resampling_step=100)
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
    print(f"[profile] 100 steps x {x1.shape[0]} chains: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy:.1f} ms = {100 * busy / wall_ms:.1f} %")
    for e in rows[:12]:
        print(f"[profile] {dev(e):9.2f} ms  {100 * dev(e) / busy:5.1f} %  x{e.count:<5d} "
              f"{e.key[:90]}")


def quality(wl, data, seed):
    """bench.py's quality run (bench.py:303-345, 505-519) for hutch_ess_k10:
    512 chains x 400 steps, final resample at step 360, 30 adaptive MALA
    steps; returns (energy W2 against ground truth, sigma_GT)."""
    import numpy as np
    import torch

    from pita_torch.io.bench_asset import EXACT_ENERGIES_ASSET
    from pita_torch.metrics import emd_1d_unequal
    from pita_torch.sampler import integrate_sde

    nq, sq = 512, 400
    gen = torch.Generator("cuda").manual_seed(100 + seed)
    x1q = torch.randn(nq, 165, generator=gen, device="cuda") * wl.prior_scale
    cfg_q = hutch_cfg(num_integration_steps=sq, end_resampling_step=int(sq * 0.9),
                      resample_at_end=True, post_mcmc_steps=30, adaptive_mcmc=True,
                      dt_negative_time=5e-5)
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
    print(f"[phase 5] quality seed {seed}, {nq} chains x {sq} steps + 30 MALA: {wall_q:.2f} s; "
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
    data = wl.data_T_low

    # phase 2, 3
    k1 = phase_lj(data)
    eg = phase_egcl(wl, data)
    if "--kernels-only" in sys.argv[1:]:  # quick check of a kernel change
        return 0

    # phase 4: the main path, timed
    kernels = (lj_log_prob_and_force, egnn_layer_forward, egnn_layer_backward)
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
    if "--profile" in sys.argv[1:]:  # where the device time of the main path goes
        profile_main_path(wl, x1)

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
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
