"""Variants of the f32 tensor-core kernels (3xTF32 K2, K3 and K4) timed in
turns on one card, against the sources as committed (variant A).

    python tests/f32tc_variants.py

needs a CUDA card and nvcc and imports neither JAX nor pita_tpu. Each variant
is the committed csrc/ with a text edit, built by nvcc into a temporary
directory and loaded in place of the wrapper's library: B splits each
3xTF32 product's accumulator in two (the cross terms, hi hi); C does that,
runs K2 at 3 blocks an SM (168 registers) and unrolls K4's tangent loop by
two; D runs K2 at 3 blocks an SM and K3 at 2 (214 registers, no spill; the
committed K3 runs at 3). Prints each variant's
registers and spills, its error against the plain versions and its times
(A B C D D C B A): K2 at 2,000 chains, K3 at 256 and 2,000 chains, K4 at 64
and 256 chains x 64 tangents, N = 55, F = 32, the bench's layer 1.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pita_torch.io.bench_asset import BENCH_ASSET  # noqa: E402
from pita_torch.io.flax_params import load_egnn_params  # noqa: E402
from pita_torch.nets import EGNNBackbone  # noqa: E402
from pita_torch.ops import _build  # noqa: E402
from pita_torch.ops import egnn_layer as el  # noqa: E402
from pita_torch.ops import egnn_tangent as et  # noqa: E402

SPLIT_OLD = """    float d[4] = {acc[0][2 * nt], acc[0][2 * nt + 1], acc[1][2 * nt], acc[1][2 * nt + 1]};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const float4 b = mf[(nt * (K / 8) + ks) * 32 + lane];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      mma1688(d, lo[ks], bh0, bh1);
      mma1688(d, hi[ks], __float_as_uint(b.z), __float_as_uint(b.w));
      mma1688(d, hi[ks], bh0, bh1);
    }
    acc[0][2 * nt] = d[0];
    acc[0][2 * nt + 1] = d[1];
    acc[1][2 * nt] = d[2];
    acc[1][2 * nt + 1] = d[3];"""
SPLIT_NEW = """    float d[4] = {acc[0][2 * nt], acc[0][2 * nt + 1], acc[1][2 * nt], acc[1][2 * nt + 1]};
    float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const float4 b = mf[(nt * (K / 8) + ks) * 32 + lane];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      mma1688(e, lo[ks], bh0, bh1);
      mma1688(e, hi[ks], __float_as_uint(b.z), __float_as_uint(b.w));
      mma1688(d, hi[ks], bh0, bh1);
    }
    acc[0][2 * nt] = d[0] + e[0];
    acc[0][2 * nt + 1] = d[1] + e[1];
    acc[1][2 * nt] = d[2] + e[2];
    acc[1][2 * nt + 1] = d[3] + e[3];"""
# name: (split accumulators, K2's blocks an SM, K4's tangent loop unrolled by 2,
# K3's blocks an SM)
VARIANTS = {"A": (False, 4, False, 3), "B": (True, 4, False, 3), "C": (True, 3, True, 3),
            "D": (False, 3, False, 2)}
SOURCES = ("egnn_layer_f32tc", "egnn_layer_bwd_f32tc", "egnn_tangent_f32tc")
TANGENT_LOOP = "      for (int u = 0; u < nt; ++u) {\n        const float4 dxi"


def edit(path, old, new):
    text = open(path).read()
    if old not in text:
        raise RuntimeError(f"{path}: the text to edit is not there")
    open(path, "w").write(text.replace(old, new))


def build_variants(root):
    """Each variant's two libraries, built by nvcc in parallel, with ctypes
    signatures as the wrappers set them; prints registers and spills."""
    nvcc, jobs = _build.nvcc_path(), []
    for v, (split, blocks, unroll, k3_blocks) in VARIANTS.items():
        d = os.path.join(root, v)
        shutil.copytree(_build.CSRC, d)
        if split:
            edit(os.path.join(d, "mma_tf32.cuh"), SPLIT_OLD, SPLIT_NEW)
        edit(os.path.join(d, "egnn_layer_f32tc.cu"), "constexpr int kF32MinBlocks = 4;",
             f"constexpr int kF32MinBlocks = {blocks};")
        edit(os.path.join(d, "egnn_layer_bwd_f32tc.cu"), "constexpr int kB32MinBlocks = 3;",
             f"constexpr int kB32MinBlocks = {k3_blocks};")
        if unroll:
            edit(os.path.join(d, "egnn_tangent_f32tc.cu"), TANGENT_LOOP,
                 "#pragma unroll 2\n" + TANGENT_LOOP)
        for name in SOURCES:
            out = os.path.join(d, f"lib{name}.so")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", out, os.path.join(d, f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            jobs.append((v, name, out, proc))
    libs = {}
    for v, name, out, proc in jobs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {v}, {name}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(v, name, ln.strip())
        lib = ctypes.CDLL(out)
        if name == "egnn_layer_f32tc":
            lib.pita_egcl_tf32_weights_len.argtypes = [ctypes.c_int]
            lib.pita_egcl_tf32_weights_len.restype = ctypes.c_int
            lib.pita_egcl_forward_tf32.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
            lib.pita_egcl_forward_tf32.restype = ctypes.c_int
        elif name == "egnn_layer_bwd_f32tc":
            lib.pita_egcl_backward_tf32.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
            lib.pita_egcl_backward_tf32.restype = ctypes.c_int
        else:
            lib.pita_egcl_tangent_tf32.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
            lib.pita_egcl_tangent_tf32.restype = ctypes.c_int
        libs[v, name] = lib
    return libs


def cuda_ms(fn, reps, warmup=2):
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


def rel_err(got, ref):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))


def main():
    with tempfile.TemporaryDirectory() as root:
        libs = build_variants(root)

        def use(v):  # the wrappers' libraries, swapped for the variant's
            el._lib_tf32 = lambda: libs[v, "egnn_layer_f32tc"]
            el._lib_bwd_tf32 = lambda: libs[v, "egnn_layer_bwd_f32tc"]
            et._lib_tf32 = lambda: libs[v, "egnn_tangent_f32tc"]

        dev = torch.device("cuda")
        bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
        bb.load_state_dict(load_egnn_params(np.load(BENCH_ASSET)["energy_params"], 3))
        w = {f: t.to(dev) for f, t in bb.layers[1].weights().items()}
        cfg = dict(attention=True, tanh=True, coords_range=5.0, cd=torch.float32)
        packed, ptc = el.pack_weights(w).to(dev), el.pack_weights_tf32(w).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        B, N, F, Tc = 2000, 55, 32, 64
        x = torch.randn(B, N, 3, generator=g, device=dev) * 0.6
        h = torch.randn(B, N, F, generator=g, device=dev)
        ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
        with torch.no_grad():
            ref2 = [torch.cat(p) for p in zip(*(
                el.layer_step(h[c:c + 500], x[c:c + 500], ea[c:c + 500], w, **cfg)
                for c in range(0, B, 500)))]
        gh, gx = torch.randn_like(h), torch.randn_like(x)
        ref3 = el.layer_vjp(h[:256], x[:256], ea[:256], gh[:256], gx[:256], w, **cfg)
        basis = torch.eye(3 * N, device=dev)[:Tc].reshape(Tc, N, 3).contiguous()

        def tangent_args(n):
            dh = torch.randn(n, Tc, N, F, generator=g, device=dev) * 0.1
            dx = basis[None].expand(n, -1, -1, -1).contiguous()
            return h[:n], x[:n], ea[:n], x[:n], basis, dh, dx

        t64, t256 = tangent_args(64), tangent_args(256)
        with torch.no_grad():
            ref4 = et.layer_tangent(*t64, w, **cfg)
        k2 = lambda: el.egnn_layer_forward_tf32(h, x, ea, w, packed=packed, packed_tc=ptc, **cfg)
        k3 = lambda n: lambda: el.egnn_layer_backward_tf32(h[:n], x[:n], ea[:n], gh[:n], gx[:n],
                                                           w, packed=packed, packed_tc=ptc,
                                                           **cfg)
        k4 = lambda a: lambda: et.egnn_layer_tangent_tf32(*a, w, packed=packed, packed_tc=ptc,
                                                          **cfg)
        for v in VARIANTS:
            use(v)
            got2, got3, got4 = k2(), k3(256)(), k4(t64)()
            torch.cuda.synchronize()
            print(f"variant {v} {VARIANTS[v]}: K2 rel err {rel_err(got2, ref2):.2e}, "
                  f"K3 rel err {rel_err(got3, ref3):.2e}, K4 rel err {rel_err(got4, ref4):.2e}")
        times = {v: {"k2": [], "k3_256": [], "k3_2000": [], "k4_64": [], "k4_256": []}
                 for v in VARIANTS}
        for v in list(VARIANTS) + list(VARIANTS)[::-1]:
            use(v)
            times[v]["k2"].append(cuda_ms(k2, 20))
            times[v]["k3_256"].append(cuda_ms(k3(256), 20))
            times[v]["k3_2000"].append(cuda_ms(k3(B), 10))
            times[v]["k4_64"].append(cuda_ms(k4(t64), 10))
            times[v]["k4_256"].append(cuda_ms(k4(t256), 5))
        for v, row in times.items():
            print(f"variant {v} {VARIANTS[v]}: " + ", ".join(
                f"{k} {' / '.join(f'{t:.4f}' for t in ts)} ms" for k, ts in row.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
