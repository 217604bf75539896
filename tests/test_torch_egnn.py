"""The EGCL layer, the EGNN backbone, the energy gradients and the Hutchinson
estimate of pita_torch against pita_tpu (CPU, plain versions). Kernels K2/K3
are held against their plain versions in test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import EnergyWrapper as JaxEnergy
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.nets.egnn_fast import egnn_apply, extract_params
from pita_tpu.ops.divergence import hutchinson_divergence as jax_hutchinson
from pita_tpu.ops.pallas.egnn_fwd import _W_FIELDS, _layer_step, egnn_forward_pallas
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.ops import egnn_layer as el
from pita_torch.ops.divergence import hutchinson_divergence
from pita_torch.schedules import ElucidatingNoiseSchedule

ASSET = "pita_tpu/assets/bench_lj55.npz"
CFG = dict(attention=True, tanh=True, coords_range=5.0)


def _jax_model(n, hidden, layers, seed=0, cd=jnp.float32, **kw):
    mod = JaxEGNN(n_particles=n, hidden_nf=hidden, n_layers=layers, compute_dtype=cd, **kw)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, 3 * n)), 1.0)
    return mod, params


def _port_model(mod, params, cd=torch.float32):
    bb = EGNNBackbone(mod.n_particles, hidden_nf=mod.hidden_nf, n_layers=mod.n_layers,
                      attention=mod.attention, tanh=mod.tanh, compute_dtype=cd)
    bb.load_state_dict(load_egnn_params(serialization.to_bytes(params), mod.n_layers,
                                        mod.attention))
    return bb


def _layer_inputs(B, N, F, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, F)).astype(np.float32)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    ea = ((x[:, :, None] - x[:, None]) ** 2).sum(-1).astype(np.float32)
    return h, x, ea


def _one_layer(seed=1, hidden=16):
    mod, params = _jax_model(7, hidden, 1, seed=seed)
    lp = extract_params(params, 1, True)[2][0]
    jw = {f: getattr(lp, f) for f in _W_FIELDS}
    tw = {f: torch.as_tensor(np.array(v)) for f, v in jw.items()}
    return jw, tw


def _jax_layer(h, x, ea, jw, cd=jnp.float32):
    """pita_tpu's _layer_step in the port's (B, N, 3) coordinate layout."""
    N = x.shape[1]
    mask = 1.0 - jnp.eye(N, dtype=jnp.float32)
    ho, xo = _layer_step(h, jnp.swapaxes(x, 1, 2), ea, mask, jw, cd=cd, **CFG)
    return ho, jnp.swapaxes(xo, 1, 2)


def test_layer_step_matches_jax():
    jw, tw = _one_layer()
    h, x, ea = _layer_inputs(5, 7, 16)
    ho_j, xo_j = _jax_layer(jnp.asarray(h), jnp.asarray(x), jnp.asarray(ea), jw)
    ho_t, xo_t = el.egnn_layer_forward(torch.as_tensor(h), torch.as_tensor(x),
                                       torch.as_tensor(ea), tw, **CFG)
    # f32, the same ops; sums over 7 edges / 16 features reassociated
    np.testing.assert_allclose(ho_t.numpy(), np.asarray(ho_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(xo_j), rtol=1e-5, atol=1e-5)


def test_layer_vjp_matches_jax():
    jw, tw = _one_layer(seed=2)
    h, x, ea = _layer_inputs(4, 7, 16, seed=3)
    rng = np.random.default_rng(4)
    gh = rng.normal(size=h.shape).astype(np.float32)
    gx = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: _jax_layer(a, b, c, jw),
                     jnp.asarray(h), jnp.asarray(x), jnp.asarray(ea))
    ref = vjp((jnp.asarray(gh), jnp.asarray(gx)))
    got = el.egnn_layer_backward(*(torch.as_tensor(a) for a in (h, x, ea, gh, gx)), tw, **CFG)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        # f32 reverse mode in two frameworks: reassociated sums
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max())


def test_egcl_function_backward_is_layer_vjp():
    mod, params = _jax_model(7, 16, 1, seed=5)
    layer = _port_model(mod, params).layers[0]
    h, x, ea = (torch.as_tensor(a).requires_grad_(True) for a in _layer_inputs(3, 7, 16, 6))
    gh, gx = torch.randn(3, 7, 16), torch.randn(3, 7, 3)
    ho, xo = layer(h, x, ea)
    got = torch.autograd.grad((ho, xo), (h, x, ea), (gh, gx))
    ref = el.layer_vjp(h.detach(), x.detach(), ea.detach(), gh, gx, layer.weights(),
                       **layer.cfg)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)  # the same plain computation


def test_egcl_function_refuses_trainable_weights():
    mod, params = _jax_model(5, 8, 1)
    layer = _port_model(mod, params).layers[0]
    layer.w_e2.requires_grad_(True)
    h, x, ea = (torch.as_tensor(a) for a in _layer_inputs(2, 5, 8))
    with pytest.raises(RuntimeError, match="inference-only"):
        layer(h, x, ea)


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_backbone_matches_egnn_apply(attention, tanh):
    mod, params = _jax_model(9, 16, 2, seed=7, attention=attention, tanh=tanh)
    bb = _port_model(mod, params)
    rng = np.random.default_rng(8)
    t = rng.uniform(-1, 1, size=5).astype(np.float32)
    x = rng.normal(size=(5, 27)).astype(np.float32)
    ref = egnn_apply(params, mod, jnp.asarray(t), jnp.asarray(x), jnp.asarray(1.3))
    got = bb(torch.as_tensor(t), torch.as_tensor(x), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_backbone_bench_weights_lj55():
    a = np.load(ASSET)
    mod = JaxEGNN(n_particles=55, hidden_nf=32, n_layers=3)
    params = serialization.msgpack_restore(a["energy_params"].tobytes())
    bb = EGNNBackbone(55, hidden_nf=32, n_layers=3)
    bb.load_state_dict(load_egnn_params(a["energy_params"], 3))
    x = a["data_T_low"][:2] * 0.3
    t = np.array([0.1, -0.4], np.float32)
    ref = np.asarray(egnn_apply(params, mod, jnp.asarray(t), jnp.asarray(x), jnp.asarray(1.0)))
    got = bb(torch.as_tensor(t), torch.as_tensor(x), 1.0).numpy()
    # f32, 3 layers of 55x55 edges: reassociation only
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_backbone_bf16_matches_pallas_interpret():
    """bf16 semantics of the Pallas layer (bf16 matmul inputs, f32 elsewhere)."""
    mod, params = _jax_model(6, 8, 2, seed=9, cd=jnp.bfloat16)
    bb = _port_model(mod, params, cd=torch.bfloat16)
    rng = np.random.default_rng(10)
    t = rng.uniform(-1, 1, size=3).astype(np.float32)
    x = rng.normal(size=(3, 18)).astype(np.float32)
    ref = np.asarray(egnn_forward_pallas(params, mod, jnp.asarray(t), jnp.asarray(x),
                                         jnp.asarray(1.0), block_b=2, interpret=True))
    got = bb(torch.as_tensor(t), torch.as_tensor(x), 1.0).numpy()
    # both round the same matmul inputs to bf16; an f32 value one ulp apart can
    # round to a neighbouring bf16 (relative step 2^-8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def _wrappers(seed=11):
    mod, params = _jax_model(7, 16, 2, seed=seed)
    return mod, params, _port_model(mod, params)


def test_energy_grads_match_jax_value_and_grad():
    """∇ₓU and ∂U/∂t as sampler/terms.py:127-133 forms them."""
    mod, params, bb = _wrappers()
    js, ts = JaxSched(sigma_min=0.05, sigma_max=10.0), ElucidatingNoiseSchedule(
        sigma_min=0.05, sigma_max=10.0)
    jw, tw = JaxEnergy(mod), EnergyWrapper(bb)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 21)).astype(np.float32) * 2
    t = np.full(4, 0.6, np.float32)

    def u_sum(xx, tt):
        U = jw.energy(params, js.h(tt), xx, 1.0)
        return jnp.sum(U), U

    (_, U_j), (gx_j, gt_j) = jax.value_and_grad(u_sum, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(t))
    xx = torch.as_tensor(x).requires_grad_(True)
    tt = torch.as_tensor(t).requires_grad_(True)
    U_t = tw.energy(ts.h(tt), xx, 1.0)
    gx_t, gt_t = torch.autograd.grad(U_t.sum(), (xx, tt))
    np.testing.assert_allclose(U_t.detach().numpy(), np.asarray(U_j), rtol=1e-4)
    for g, r in ((gx_t, gx_j), (gt_t, gt_j)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max())


def test_hutchinson_matches_jax_with_same_probes():
    mod, params, bb = _wrappers(seed=13)
    js, ts = JaxSched(sigma_min=0.05, sigma_max=10.0), ElucidatingNoiseSchedule(
        sigma_min=0.05, sigma_max=10.0)
    jsw, tsw = JaxScore(mod), ScoreWrapper(bb)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(5, 21)).astype(np.float32) * 2
    t = np.full(5, 0.4, np.float32)
    key = jax.random.PRNGKey(15)
    ref = jax_hutchinson(lambda tt, xx: jsw.score(params, js.h(tt), xx, 1.0),
                         jnp.asarray(t), jnp.asarray(x), key, 2)
    probes = np.stack([np.asarray(jax.random.rademacher(k, x.shape, dtype=jnp.float32))
                       for k in jax.random.split(key, 2)])
    got = hutchinson_divergence(lambda tt, xx: tsw.score(ts.h(tt), xx, 1.0),
                                torch.as_tensor(t), torch.as_tensor(x), torch.as_tensor(probes))
    ref = np.asarray(ref)
    # εᵀ(Jε) by JVP vs (Jᵀε)·ε by VJP: the same scalar, reassociated
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_pack_weights_layout():
    """The packed buffer of csrc/egnn_layer.cu: the 15 arrays in _W_FIELDS
    order, each padded to 4 floats, matmul weights rounded to bf16."""
    _, tw = _one_layer(hidden=16)
    F = 16
    sizes = dict(w_src=F * F, b_src=F, w_dst=F * F, w_scal=2 * F, w_e2=F * F, b_e2=F,
                 w_att=F, b_att=1, w_c1=F * F, b_c1=F, w_c2=F, w_n1=2 * F * F, b_n1=F,
                 w_n2=F * F, b_n2=F)
    for cd in (torch.float32, torch.bfloat16):
        packed = el.pack_weights(tw, cd)
        off = 0
        for f in _W_FIELDS:
            want = tw[f].reshape(-1)
            if cd == torch.bfloat16 and f in ("w_src", "w_dst", "w_e2", "w_c1", "w_n1", "w_n2"):
                want = want.to(cd).float()
            torch.testing.assert_close(packed[off:off + sizes[f]], want, rtol=0, atol=0)
            off += -(-sizes[f] // 4) * 4
        assert packed.numel() == off == 7 * F * F + 7 * F + 2 * F + 4


@pytest.mark.parametrize("hidden", [16, 32])
def test_pack_weights_tc_layout(hidden):
    """The bf16 buffer of csrc/egnn_layer_tc.cu (tcoff): for each product
    Y = A M the transpose of M, rows padded by 8 zeros, equal to the weights
    as the matmuls see them (rounded_weights in bf16). The last matrix is the
    forward's node output product (M = W_n2)."""
    _, tw = _one_layer(seed=3, hidden=hidden)
    F = hidden
    rw = el.rounded_weights(tw, torch.bfloat16)
    e2, c1, ws, wd, n1, n2 = (rw[f] for f in ("w_e2", "w_c1", "w_src", "w_dst", "w_n1", "w_n2"))
    want = [e2.T, c1.T, e2, c1, torch.cat([ws.T, wd.T]), n1.T, n2, n1,
            torch.cat([ws, wd], 1), n2.T]
    buf = el.pack_weights_tc(tw)
    assert buf.dtype == torch.bfloat16 and buf.is_contiguous()
    off = 0
    for m in want:
        rows, cols = m.shape
        block = buf[off:off + rows * (cols + 8)].reshape(rows, cols + 8).float()
        torch.testing.assert_close(block[:, :cols], m, rtol=0, atol=0)
        assert not block[:, cols:].any()
        off += rows * (cols + 8)
    # tcoff(F).total
    assert buf.numel() == off == 10 * F * (F + 8) + 2 * F * (2 * F + 8)


def test_egcl_backward_dispatches_by_compute_dtype():
    """bf16 goes to the tensor-core wrapper, which takes the forward's
    aggregate, f32 to the scalar one; on the CPU both run layer_vjp, and
    neither counts a launch. The tensor-core wrapper refuses f32. The layer
    caches its bf16 buffer."""
    mod, params = _jax_model(7, 16, 1, seed=8)
    layer = _port_model(mod, params, cd=torch.bfloat16).layers[0]
    h, x, ea = (torch.as_tensor(a) for a in _layer_inputs(3, 7, 16, 9))
    gh, gx = torch.randn(3, 7, 16), torch.randn(3, 7, 3)
    w = layer.weights()
    agg = el.egnn_layer_forward(h, x, ea, w, with_agg=True, **dict(CFG, cd=torch.bfloat16))[2]
    before = (el.egnn_layer_backward.launches, el.egnn_layer_backward_tc.launches)
    for cd in (torch.bfloat16, torch.float32):
        cfg = dict(CFG, cd=cd)
        got = el.egnn_layer_backward(h, x, ea, gh, gx, w,
                                     agg=agg if cd == torch.bfloat16 else None, **cfg)
        ref = el.layer_vjp(h, x, ea, gh, gx, w, **cfg)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    cfg = dict(CFG, cd=torch.bfloat16)
    got = el.egnn_layer_backward_tc(h, x, ea, gh, gx, w, agg=agg, **cfg)
    for a, b in zip(got, el.layer_vjp(h, x, ea, gh, gx, w, **cfg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (el.egnn_layer_backward.launches, el.egnn_layer_backward_tc.launches) == before
    with pytest.raises(ValueError, match="bf16 only"):
        el.egnn_layer_backward_tc(h, x, ea, gh, gx, w, agg=agg, **dict(CFG, cd=torch.float32))
    buf = layer.packed(torch.device("cpu"), tc=True)
    assert buf is layer.packed(torch.device("cpu"), tc=True)
    torch.testing.assert_close(buf, el.pack_weights_tc(w), rtol=0, atol=0)
    assert layer.packed(torch.device("cpu")).dtype == torch.float32


def test_egcl_forward_dispatches_by_compute_dtype():
    """The forward as the VJP above: bf16 goes to the tensor-core wrapper,
    f32 to the scalar one; on the CPU both give layer_step exactly and
    neither counts a launch. The tensor-core wrapper refuses f32, and the
    layer's forward (EGCLFunction) is layer_step in either dtype."""
    mod, params = _jax_model(7, 16, 1, seed=10)
    layer = _port_model(mod, params, cd=torch.bfloat16).layers[0]
    h, x, ea = (torch.as_tensor(a) for a in _layer_inputs(3, 7, 16, 11))
    w = layer.weights()
    counts = lambda: (el.egnn_layer_forward.launches, el.egnn_layer_forward_tc.launches)
    before = counts()
    for cd in (torch.bfloat16, torch.float32):
        cfg = dict(CFG, cd=cd)
        ref = el.layer_step(h, x, ea, w, **cfg)
        for got in (el.egnn_layer_forward(h, x, ea, w, **cfg),
                    el.egnn_layer_forward(h, x, ea, w, packed_tc=layer.packed(h.device, tc=True),
                                          **cfg)):
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    cfg = dict(CFG, cd=torch.bfloat16)
    got = el.egnn_layer_forward_tc(h, x, ea, w, **cfg)
    for a, b in zip(got, el.layer_step(h, x, ea, w, **cfg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(layer(h, x, ea), el.layer_step(h, x, ea, w, **layer.cfg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counts() == before
    with pytest.raises(ValueError, match="bf16 only"):
        el.egnn_layer_forward_tc(h, x, ea, w, **dict(CFG, cd=torch.float32))


def _bf16_layer_and_inputs(seed):
    mod, params = _jax_model(7, 16, 1, seed=seed)
    layer = _port_model(mod, params, cd=torch.bfloat16).layers[0]
    h, x, ea = (torch.as_tensor(a) for a in _layer_inputs(3, 7, 16, seed + 1))
    return layer, h, x, ea


def test_egcl_forward_hands_over_the_aggregate():
    """The bf16 forward's aggregate (the plain version on the CPU) is the
    sum over senders j != i of layer_step's messages m_ij, and the node MLP
    on it gives layer_step's h_out exactly; the f32 routes refuse to hand one
    over or to take one."""
    layer, h, x, ea = _bf16_layer_and_inputs(14)
    w = layer.weights()
    h_out, x_out, agg = el.egnn_layer_forward(h, x, ea, w, with_agg=True, **layer.cfg)
    ref_h, ref_x, acts = el.layer_step(h, x, ea, w, with_acts=True, **layer.cfg)
    torch.testing.assert_close(h_out, ref_h, rtol=0, atol=0)
    torch.testing.assert_close(x_out, ref_x, rtol=0, atol=0)
    N = h.shape[1]
    m = acts.m_pre * acts.att[..., None]
    want = torch.stack([sum(m[:, i, j] for j in range(N) if j != i) for i in range(N)], 1)
    torch.testing.assert_close(agg, want, rtol=1e-6, atol=1e-6)
    cd = torch.bfloat16
    nz = el._mm(torch.cat([h, agg], -1), w["w_n1"], cd) + w["b_n1"]
    torch.testing.assert_close(h + el._mm(el._silu(nz), w["w_n2"], cd) + w["b_n2"], ref_h,
                               rtol=0, atol=0)
    cfg = dict(layer.cfg, cd=torch.float32)
    with pytest.raises(ValueError, match="only the bf16"):
        el.egnn_layer_forward(h, x, ea, w, with_agg=True, **cfg)
    with pytest.raises(ValueError, match="only the bf16"):
        el.egnn_layer_backward(h, x, ea, h, x, w, agg=agg, **cfg)


@pytest.mark.parametrize("bad", ["missing", "shape", "dtype", "device"])
@pytest.mark.parametrize("wrapper", ["egnn_layer_backward", "egnn_layer_backward_tc"])
def test_egcl_bf16_backward_refuses_a_bad_aggregate(bad, wrapper):
    """The bf16 VJP raises on a missing aggregate, or on one of another
    shape, dtype or device, rather than rebuild it; on the CPU as on CUDA."""
    layer, h, x, ea = _bf16_layer_and_inputs(16)
    agg = dict(missing=None, shape=torch.zeros(3, 7, 15), dtype=torch.zeros(3, 7, 16).double(),
               device=torch.zeros(3, 7, 16, device="meta"))[bad]
    with pytest.raises(ValueError, match="agg"):
        getattr(el, wrapper)(h, x, ea, h, x, layer.weights(), agg=agg, **layer.cfg)


def test_egcl_function_bf16_backward_is_layer_vjp():
    """EGCLFunction in bf16: a forward that records a graph saves the
    forward's aggregate and its backward equals layer_vjp (the plain version
    on the CPU); a forward under no_grad, or on inputs that require no grad,
    records nothing and saves no aggregate."""
    layer, h, x, ea = _bf16_layer_and_inputs(18)
    gh, gx = torch.randn(3, 7, 16), torch.randn(3, 7, 3)
    hr, xr, ear = (a.clone().requires_grad_(True) for a in (h, x, ea))
    ho, xo = layer(hr, xr, ear)
    saved = ho.grad_fn.saved_tensors
    assert len(saved) == 4
    agg = el.egnn_layer_forward(h, x, ea, layer.weights(), with_agg=True, **layer.cfg)[2]
    torch.testing.assert_close(saved[3], agg, rtol=0, atol=0)
    got = torch.autograd.grad((ho, xo), (hr, xr, ear), (gh, gx))
    ref = el.layer_vjp(h, x, ea, gh, gx, layer.weights(), **layer.cfg)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)  # the same plain computation
    with torch.no_grad():
        assert layer(hr, xr, ear)[0].grad_fn is None
    assert layer(h, x, ea)[0].grad_fn is None


def test_layer_forward_bf16_matches_jax():
    """The bf16 forward of the port (the tensor-core wrapper's plain version
    on the CPU) against pita_tpu's _layer_step in bf16 compute."""
    jw, tw = _one_layer(seed=12)
    h, x, ea = _layer_inputs(4, 7, 16, seed=13)
    ho_j, xo_j = _jax_layer(jnp.asarray(h), jnp.asarray(x), jnp.asarray(ea), jw, cd=jnp.bfloat16)
    ho_t, xo_t = el.egnn_layer_forward_tc(torch.as_tensor(h), torch.as_tensor(x),
                                          torch.as_tensor(ea), tw, cd=torch.bfloat16, **CFG)
    # both round the same matmul inputs to bf16; an f32 value one ulp apart can
    # round to a neighbouring bf16 (relative step 2^-8)
    for got, ref in ((ho_t, ho_j), (xo_t, xo_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())
