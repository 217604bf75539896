"""Exact score divergence for the EGNN backbone by edge-operator factorization.

Counterpart of ``pita_tpu/nets/egnn_fast.py``. Per layer the tangent map of
the edge MLP chain is linear in the per-edge pre-activation tangent ``d_z1``
and its composition is a per-edge F×F operator built from primal activations
only:

    d_m_ij  = G_ij · d_z1_ij,   G[f,g] = att·mask·sp1[f]·W2[f,g]·sp2[g] + mask·satq[f]·m_pre[g]
    d_z1_ij = A_i + B_j + c_ij·w_r + e_ij·w_e
    (A = dh·W_src, B = dh·W_dst, c = d‖x_i−x_j‖², e = d(edge_attr))

so the whole D = N·3 tangent basis runs through node-sized tensors and dense
products; the dominant one is ``t2[t,b,n,g] = Σ_{m,f} G[b,n,m,f,g]·B[t,b,m,f]``.
Three routes compute the trace ``tr dF/dx``:

- ``egnn_jacobian_trace`` with G materialized as a (B, N, N, F, F) tensor and
  ``torch.einsum`` for ``t2`` (the default, and the plain version that kernel
  K5 is held against);
- ``egnn_jacobian_trace(..., g_kernel=True)``: G is never formed, ``t2`` comes
  from ``pita_torch.ops.g_op.g_operator_contract`` (CUDA kernel K5);
- ``pita_torch.ops.egnn_tangent.egnn_jacobian_trace_fused``: forward mode
  through the per-layer tangent kernel K4, no operators at all.

The weights are those of ``pita_torch.nets.egnn.EGNNBackbone``
(``EGCL.weights()``); there is no ``params`` tree. Numerics: the primal pass
is ``layer_step``'s (matmul inputs rounded to the layer's compute dtype, f32
accumulation, f32 elementwise), so it equals the backbone's own forward. The
operator algebra runs in f32 on the weights as the layers use them (rounded to
the compute dtype where they enter a matmul): the rounding of activations
counts as the identity in the tangents, as in the layer VJP. JAX's padding of
ragged chunks (static shapes) is not carried over: the loops take a short
last chunk. Everything here is inference: it runs under ``torch.no_grad``.
"""

import torch

from pita_torch.nets.precondition import bcast, coeffs
from pita_torch.ops.egnn_layer import LayerActs, layer_step, rounded_weights


@torch.no_grad()
def egnn_apply(backbone, t, x_flat, beta, with_acts: bool = False):
    """Forward of ``EGNNBackbone`` in plain torch, optionally returning what
    the tangent operators need: (edge_attr, diff0, mask, coords_range,
    layer weights, layer activations, xs)."""
    B = x_flat.shape[0]
    N, D = backbone.n_particles, backbone.n_spatial_dim
    xs = x_flat.reshape(B, N, D)
    h = backbone.embed(t, x_flat, beta)
    diff0 = xs[:, :, None, :] - xs[:, None, :, :]
    edge_attr = (diff0 * diff0).sum(-1)
    mask = 1.0 - torch.eye(N, dtype=torch.float32, device=x_flat.device)

    xc = xs
    weights, all_acts = [], []
    coords_range = None
    for layer in backbone.layers:
        cfg = layer.cfg
        coords_range = cfg["coords_range"]
        w = layer.weights()
        h, xc, *acts = layer_step(h, xc, edge_attr, w, **cfg, with_acts=with_acts)
        weights.append(w)
        all_acts.extend(acts)

    vel = xc - xs
    vel = vel - vel.mean(dim=1, keepdim=True)
    out = vel.reshape(B, N * D)
    if with_acts:
        return out, (edge_attr, diff0, mask, coords_range, weights, all_acts, xs)
    return out


def g_operator_args(w, acts: LayerActs, mask, attention):
    """The arguments of ``g_operator_contract`` (kernel K5) for one layer: G
    in its rank structure, never formed,

        G[f,g] = att_mask·sp1[f]·W2[f,g]·sp2[g] + satq[f]·m_pre[g],

    with the edge mask folded into ``att_mask`` and ``satq``."""
    w2 = w["w_e2"]
    if attention:
        s_att = acts.att * (1 - acts.att)
        # q[f] = sp1[f] · (W2 @ (sp2 ⊙ w_att))[f]
        q = acts.sp1 * ((acts.sp2 * w["w_att"][:, 0]) @ w2.T)
        att_eff = acts.att
        satq = s_att[..., None] * q
    else:
        att_eff = torch.ones_like(acts.norm)
        satq = torch.zeros_like(acts.sp1)
    return dict(sp1=acts.sp1, sp2=acts.sp2, att_mask=att_eff * mask,
                satq=satq * mask[:, :, None], m_pre=acts.m_pre, w2=w2)


def _layer_tangent_ops(w, acts: LayerActs, diff0, mask, coords_range, attention, tanh,
                       materialize_g: bool = True):
    """Tangent-independent per-edge operators of one layer.

    Beyond the edge operators

        G: (B,N,N,F,F)  d_m = G·d_z1      (mask folded in)
        r: (B,N,N,F)    d_a = r·d_z1      (tanh'·mask folded in)

    every tangent contraction the layer needs is pre-contracted against the
    primal geometry:

      d_agg  = P·A + G·B + [UD·dxc − UD2·dxc] + [VD·dxs − VD2·dxs]
      row_dw = RS·A + ř·B + [QC1·dxc − QCD·dxc] + [QE1·dxs − QED·dxs]
      y=d_w@x= RX·A + RX2·B + [QCX1·dxc − QCXD·dxc] + [QEX1·dxs − QEXD·dxs]

    with c = 2·diff·(dxc_i − dxc_j), e = 2·diff0·(dxs_i − dxs_j),
    d_w = (d_a − w·d_norm)/denom and d_norm = c/(2·norm), folded into the
    c-operators through q_c = r·w_r/denom − w/(2·norm·denom).

    ``w``: the weights as the matmuls see them (``rounded_weights``). With
    ``materialize_g=False`` the entry ``G`` is the dict of K5's arguments and
    every contraction of G with a fixed vector goes through its rank structure.
    """
    w2 = w["w_e2"]
    w_att = w["w_att"][:, 0]
    w_r, w_e = w["w_scal"][0], w["w_scal"][1]
    chat = (acts.sp_cz * w["w_c2"][:, 0]) @ w["w_c1"].T  # W_c1 (sp_cz ⊙ w_c2)
    if materialize_g:
        # K[f,g] = sp1[f]·W2[f,g]·sp2[g]
        K = acts.sp1[..., :, None] * w2 * acts.sp2[..., None, :]  # (B,N,N,F,F)
        if attention:
            # d_m = att·d_m_pre + m_pre ⊗ (s_att · w_attᵀ d_m_pre)
            s_att = acts.att * (1 - acts.att)
            q = K @ w_att  # (B,N,N,F)
            G = acts.att[..., None, None] * K + (
                (q * s_att[..., None])[..., :, None] * acts.m_pre[..., None, :])
        else:
            G = K
        G = G * mask[:, :, None, None]
        r = torch.einsum("bnmfg,bnmg->bnmf", G, chat)
    else:
        G = g_operator_args(w, acts, mask, attention)
        att_mask, satq_m = G["att_mask"], G["satq"]
        # r[f] = Σ_g G[f,g]·chat[g]
        r = (att_mask[..., None] * acts.sp1 * ((acts.sp2 * chat) @ w2.T)
             + satq_m * (acts.m_pre * chat).sum(-1, keepdim=True))
    dtanh = (1.0 - torch.tanh(acts.cm) ** 2) * coords_range if tanh else torch.ones_like(acts.cm)
    r = r * (dtanh * mask)[..., None]

    norm = acts.norm
    denom = norm + 1.0
    x = acts.x_in
    diff = acts.diff

    if materialize_g:
        P = G.sum(2)  # (B,N,F,F)
        u = torch.einsum("bnmfg,f->bnmg", G, w_r)
        v = torch.einsum("bnmfg,f->bnmg", G, w_e)
    else:
        asp1 = att_mask[..., None] * acts.sp1

        def g_dot_left(vec):  # Σ_f G[f,g]·vec[f] per edge
            return (att_mask[..., None] * acts.sp2 * ((acts.sp1 * vec) @ w2)
                    + (satq_m @ vec)[..., None] * acts.m_pre)

        u = g_dot_left(w_r)
        v = g_dot_left(w_e)
        P = (w2 * torch.einsum("bnmf,bnmg->bnfg", asp1, acts.sp2)
             + torch.einsum("bnmf,bnmg->bnfg", satq_m, acts.m_pre))
    UD = torch.einsum("bnmg,bnmd->bngd", u, diff)
    UD2 = u[..., None] * diff[..., None, :]  # (B,N,N,F,3)
    VD = torch.einsum("bnmg,bnmd->bngd", v, diff0)
    VD2 = v[..., None] * diff0[..., None, :]

    # q_c and q_e fold the d_a and −w·d_norm pieces of d_w (both ∝ c)
    rc = r @ w_r
    re = r @ w_e
    q_c = rc / denom - acts.w / (2 * norm * denom)
    q_e = re / denom
    rdiv = r / denom[..., None]

    RS = rdiv.sum(2)  # (B,N,F)
    RX = torch.einsum("bnmf,bmd->bnfd", rdiv, x)
    RX2 = rdiv[..., None] * x[:, None, :, None, :]  # (B,N,N,F,3)
    QC1 = torch.einsum("bnm,bnmd->bnd", q_c, diff)
    QCD = q_c[..., None] * diff  # (B,N,N,3)
    QE1 = torch.einsum("bnm,bnmd->bnd", q_e, diff0)
    QED = q_e[..., None] * diff0
    QCX1 = torch.einsum("bnmd,bmq->bndq", QCD, x)
    QCXD = QCD[..., None] * x[:, None, :, None, :]  # (B,N,N,3,3)
    QEX1 = torch.einsum("bnmd,bmq->bndq", QED, x)
    QEXD = QED[..., None] * x[:, None, :, None, :]
    return dict(
        G=G, P=P, RS=RS, rdiv=rdiv, RX=RX, RX2=RX2,
        UD=UD, UD2=UD2, VD=VD, VD2=VD2,
        QC1=QC1, QCD=QCD, QE1=QE1, QED=QED,
        QCX1=QCX1, QCXD=QCXD, QEX1=QEX1, QEXD=QEXD,
    )


@torch.no_grad()
def egnn_jacobian_trace(backbone, t, x_flat, beta, tangent_chunk: int = None,
                        g_kernel: bool = False):
    """(F(x), tr dF/dx) for the EGNN backbone: exact, edge-operator method.

    The full coordinate basis runs through per-edge linear operators built
    from one primal pass. The input-basis contractions are gathers: the basis
    is one-hot, so contracting an operator with it indexes the operator at
    (particle, component) = divmod(tangent index, 3). ``tangent_chunk``
    bounds the tangents in flight; ``g_kernel`` takes ``t2`` from
    ``g_operator_contract`` (kernel K5 on CUDA) instead of materializing G.
    """
    from pita_torch.ops.g_op import g_operator_contract

    B = x_flat.shape[0]
    N, D = backbone.n_particles, backbone.n_spatial_dim
    dim = N * D
    dev = x_flat.device
    F = backbone.hidden_nf

    out, (edge_attr, diff0, mask, coords_range, weights, all_acts, xs) = egnn_apply(
        backbone, t, x_flat, beta, with_acts=True)
    weights = [rounded_weights(w, layer.cfg["cd"])
               for w, layer in zip(weights, backbone.layers)]
    ops = [
        _layer_tangent_ops(w, acts, diff0, mask, coords_range, layer.cfg["attention"],
                           layer.cfg["tanh"], materialize_g=not g_kernel)
        for w, acts, layer in zip(weights, all_acts, backbone.layers)
    ]
    node_ids = torch.arange(N, device=dev)

    def run_chunk(tangent_idx):
        """tangent_idx: (Tc,) flat coordinate indices; returns the (Tc, B)
        diagonal entries."""
        Tc = tangent_idx.shape[0]
        p_idx = tangent_idx // D  # particle of each basis tangent
        e_idx = tangent_idx % D  # spatial component

        def gather_edge(op):
            """op[b,n,m,...,d] contracted with the one-hot dxs over (m, d):
            op[b,n,p_t,...,e_t] with the tangent axis first, (Tc,B,N,...).
            (numpy's ``op[:, :, p_idx, ..., e_idx]`` does this; torch treats
            an empty Ellipsis as no separator and leaves the axis in place,
            so both indexed axes are moved to the front here.)"""
            return op.movedim(2, 0).movedim(-1, 1)[p_idx, e_idx]

        def gather_node(op):
            """op[b,n,...,d] contracted with dxs over d at n == p_t."""
            g = op[..., e_idx].movedim(-1, 0)  # (Tc,B,N,...)
            node_mask = (node_ids[None] == p_idx[:, None]).to(g.dtype)
            return g * node_mask.reshape(Tc, 1, N, *([1] * (g.dim() - 3)))

        def dq(op):
            """The y-operators are [..., d, q] with d the basis component and q
            the output coordinate: swapped, so that the gathers, which index
            the last axis, contract d and keep q. (pita_tpu gathers them
            unswapped, which transposes each 3×3 block of this term: its trace
            is off by up to ~0.2 % on networks with large weights.)"""
            return op.transpose(-1, -2)

        dh = torch.zeros(Tc, B, N, F, device=dev)
        basis = torch.nn.functional.one_hot(tangent_idx, dim).to(torch.float32)
        dxs = basis.reshape(Tc, 1, N, D).expand(Tc, B, N, D)
        dxc = dxs

        for li, (w, acts, op) in enumerate(zip(weights, all_acts, ops)):
            A = dh @ w["w_src"]  # (T,B,N,F)
            Bv = dh @ w["w_dst"]
            first = li == 0  # dxc == dxs: the c-terms are gathers too

            # coordinate tangent: row_dw and y = d_w @ x in operator form
            row_dw = (torch.einsum("bnf,tbnf->tbn", op["RS"], A)
                      + torch.einsum("bnmf,tbmf->tbn", op["rdiv"], Bv)
                      + 2 * (gather_node(op["QE1"]) - gather_edge(op["QED"])))
            y = (torch.einsum("bnfd,tbnf->tbnd", op["RX"], A)
                 + torch.einsum("bnmfd,tbmf->tbnd", op["RX2"], Bv)
                 + 2 * (gather_node(dq(op["QEX1"])) - gather_edge(dq(op["QEXD"]))))
            if first:
                row_dw = row_dw + 2 * (gather_node(op["QC1"]) - gather_edge(op["QCD"]))
                y = y + 2 * (gather_node(dq(op["QCX1"])) - gather_edge(dq(op["QCXD"])))
            else:
                row_dw = row_dw + 2 * (torch.einsum("bnd,tbnd->tbn", op["QC1"], dxc)
                                       - torch.einsum("bnmd,tbmd->tbn", op["QCD"], dxc))
                y = y + 2 * (torch.einsum("bndq,tbnd->tbnq", op["QCX1"], dxc)
                             - torch.einsum("bnmdq,tbmd->tbnq", op["QCXD"], dxc))
            row_w = acts.w.sum(2)  # (B,N)
            dxc_out = (dxc + dxc * row_w[None, ..., None] + acts.x_in[None] * row_dw[..., None]
                       - y - torch.einsum("bnm,tbmd->tbnd", acts.w, dxc))

            if li == len(ops) - 1:
                dxc = dxc_out
                break  # only dxc reaches the trace: the last node update is dead work

            # d_agg = P·A + G·B + c-terms + e-terms
            t1 = torch.einsum("bnfg,tbnf->tbng", op["P"], A)
            if first:
                # dh is zero at the first layer: A = Bv = 0, so t2 ≡ 0
                t2 = torch.zeros_like(t1)
            elif g_kernel:
                gp = op["G"]
                t2 = g_operator_contract(gp["sp1"], gp["sp2"], gp["att_mask"], gp["satq"],
                                         gp["m_pre"], gp["w2"], Bv)
            else:
                # the dominant contraction: (N·F, N·F) @ (N·F, T) per chain
                t2 = torch.einsum("bnmfg,tbmf->tbng", op["G"], Bv)
            if first:
                t3 = 2 * (gather_node(op["UD"]) - gather_edge(op["UD2"]))
            else:
                t3 = 2 * (torch.einsum("bngd,tbnd->tbng", op["UD"], dxc)
                          - torch.einsum("bnmgd,tbmd->tbng", op["UD2"], dxc))
            t4 = 2 * (gather_node(op["VD"]) - gather_edge(op["VD2"]))
            d_agg = t1 + t2 + t3 + t4  # (T,B,N,F)

            # node update tangent
            d_nz = torch.cat([dh, d_agg], dim=-1) @ w["w_n1"]
            dh = dh + (acts.sp_n[None] * d_nz) @ w["w_n2"]
            dxc = dxc_out

        d_vel = dxc - dxs
        d_vel = d_vel - d_vel.mean(dim=2, keepdim=True)
        d_flat = d_vel.reshape(Tc, B, dim)
        # component tangent_idx[t] of tangent t's output
        return d_flat.gather(2, tangent_idx[:, None, None].expand(Tc, B, 1))[..., 0]

    chunk = tangent_chunk or dim
    trace = torch.zeros(B, device=dev)
    for start in range(0, dim, chunk):
        idx = torch.arange(start, min(start + chunk, dim), device=dev)
        trace = trace + run_chunk(idx).sum(0)
    return out, trace


def supports_fast_divergence(backbone) -> bool:
    from pita_torch.nets.egnn import EGNNBackbone

    return isinstance(backbone, EGNNBackbone)


@torch.no_grad()
def score_divergence_fast(score_wrapper, ht, x, beta, tangent_chunk: int = None,
                          chain_chunk: int = None, tangent_kernel: bool = False,
                          kernel_tangent_chunk: int = 16, g_kernel: bool = False):
    """div_x score(x) for an EGNN-backed ScoreWrapper, exact.

    Chain rule through the EDM preconditioning (precondition.py):
      score = ((c_s−1)/h)·x + (c_out/h)·F(c_noise, c_in·x, β)
      div   = dim·(c_s−1)/h + (c_out·c_in/h)·tr J_F      (×β if β-precond).

    ``chain_chunk`` bounds memory: the chains are processed in serial blocks
    (the materialized operators G are (B, N, N, F, F)). ``tangent_kernel``
    takes the trace from ``egnn_jacobian_trace_fused`` (kernel K4 on CUDA),
    ``g_kernel`` from the operator route with kernel K5; with both off it is
    the materialized-G route. The two kernel routes take 3-D coordinates
    only (no kernel exists for 2-D in either package) and raise on another D;
    the materialized-G route takes any D.
    """
    B, dim = x.shape
    if (tangent_kernel or g_kernel) and score_wrapper.backbone.n_spatial_dim != 3:
        raise ValueError("the K4 and K5 routes of the exact trace take 3-D coordinates; "
                         "take the materialized-G route (both switches off) for "
                         f"{score_wrapper.backbone.n_spatial_dim}-D")
    ht = bcast(ht, B, x)
    c_s, c_in, c_out, c_noise = coeffs(ht)
    backbone = score_wrapper.backbone
    bb = bcast(beta, B, x)

    if tangent_kernel:
        from pita_torch.ops.egnn_tangent import egnn_jacobian_trace_fused

        def trace_of(cn, xin, b):
            return egnn_jacobian_trace_fused(backbone, cn, xin, b,
                                             tangent_chunk=kernel_tangent_chunk)
    else:
        def trace_of(cn, xin, b):
            return egnn_jacobian_trace(backbone, cn, xin, b, tangent_chunk=tangent_chunk,
                                       g_kernel=g_kernel)[1]

    x_in = c_in[:, None] * x
    step = chain_chunk or B
    trJ = torch.cat([trace_of(c_noise[s:s + step], x_in[s:s + step], bb[s:s + step])
                     for s in range(0, B, step)])

    div = dim * (c_s - 1.0) / ht + (c_out * c_in / ht) * trJ
    if score_wrapper.precondition_beta:
        div = div * bb
    return div
