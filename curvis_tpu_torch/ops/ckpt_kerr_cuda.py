"""Checkpointed-recompute adjoint of the Boyer-Lindquist marches on the GPU:
wrapper of the CUDA kernels ``csrc/ckpt_kerr.cu`` (the Kerr RK4 family)
and ``csrc/ckpt_kerr_rk45.cu`` (the Kerr DP5(4) family), the Kerr variants
of ``curvis_tpu/ops/ckpt_adjoint_pallas.py``'s ``_ckpt_gen_kernel`` (#9)
and ``_ckpt_bwd_kernel`` (#10), and their plain PyTorch versions.

The families, both with theta = (M, a, q^2, E, L), the metric slots of
the march kernel's row and each ray's conserved E = -p_t and L = p_phi:

  * ``'rk4'``: one RK4 step of kernel #7 (``csrc/kerr_step.cuh:
    kerr_rk4_step``), the map of ``curvis_tpu/integrate/kerr_adjoint.py:
    _step5_theta``, on y = (r, theta, phi, p_r, p_theta) with #7's bare row
    (``ops/kerr_cuda.py:kerr_scalars``: dt, R, M, a, q^2, r_cap, r_in,
    r_out, axis_u0, far_r0); ray i takes ``counts[i]`` steps from its spawn
    state, in segments of 32;
  * ``'rk45'``: one bare DP5(4) iteration of kernel #8 (``kerr_step.cuh:
    kerr_rk45_iter``), the map of ``curvis_tpu/integrate/rk45_adjoint.py:
    _rk45_iter``, on y = (r, theta, phi, p_r, p_theta, dt) with #8's bare
    row (``ops/kerr_rk45_cuda.py:kerr_rk45_scalars``: dt0, R, M, a, q^2,
    r_cap, r_in, r_out, rtol, atol, dt_max, dt_min); ray i takes
    ``counts[i]`` iterations (its live iterations in the forward march,
    accepted and rejected) from (its spawn state, dt0), in segments of 16.
    ``freeze`` drops the cotangent of each iteration's next dt (the JAX
    package's ``freeze_controller``).

``ckpt_kerr_backward_cuda`` pulls a cotangent of the final state back to
the spawn state and theta: kernels #9 / #10 for CUDA tensors, the plain
pair for CPU tensors, never a fallback from the one to the other.  The
checkpoint buffer is compacted: ray i owns ceil(counts[i] / seg) rows from
the exclusive prefix sum of those counts (``ops/ckpt_adjoint_cuda.py:
segment_offsets``).

The plain versions run vectorised over rays with masks, on any device, in
the kernels' arithmetic:

  * ``kerr_step5_plain`` and ``kerr_rk45_iter_plain`` are the steps, with
    the RHS of ``ops/kerr_cuda.py:kerr_rhs_plain`` and the forms of
    ``march_kerr_plain`` / ``march_kerr_rk45_plain``;
  * ``kerr_step5_vjp_plain`` and ``kerr_rk45_iter_vjp_plain`` transcribe
    the kernels' hand-written VJPs (``csrc/kerr_vjp.cuh``) line by line and
    add the theta terms in the kernels' order: RK4 with the partials of the
    unguarded RHS, DP5(4) with the forward recomputed unguarded and the RHS
    partials guarded (r, p_r, p_theta clipped to +-1e4, sigma >= 1e-3, 1 /
    Delta as sign(Delta) / max(|Delta|, 1e-6)); off the guards each equals
    ``torch.func.vjp`` of its step.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.integrate.rk45 import DP_A, DP_B4, DP_B5, _comb
from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import segment_offsets
from curvis_tpu_torch.ops.ckpt_rk45_cuda import (_clip_share, _ginv,
                                                 _max_share, masked)
from curvis_tpu_torch.ops.kerr_cuda import kerr_rhs_plain

FAMILIES = ("rk4", "rk45")
SEG = {"rk4": 32, "rk45": 16}    # the JAX package's _PALLAS_SEG of each
MAX_SEG = 32                     # longest segment the backward kernels hold
N_STATE = {"rk4": 5, "rk45": 6}
N_ROW = {"rk4": 10, "rk45": 12}  # kernel #7's / #8's bare row
RHS_IN = (0, 1, 3, 4)            # the state components the RHS reads

launches = {"kerr_gen": 0, "kerr_bwd": 0, "kerr_rk45_gen": 0,
            "kerr_rk45_bwd": 0}   # since the last reset


def row_tensor(scal, like):
    """A march kernel's scalar row as a tensor of ``like``'s dtype and
    device."""
    return torch.tensor(scal, dtype=like.dtype, device=like.device)


# ------------------------------------------------------- the RHS's VJP

def kerr_rhs_vjp_plain(guard, M, a, q2, E, L, r_in, th, pr_in, pth_in, g):
    """csrc/kerr_vjp.cuh:kerr_rhs_vjp: cotangents (g_r, g_theta, g_pr,
    g_pth, (g_M, g_a, g_q2, g_E, g_L)) of one RHS evaluation for the
    cotangents ``g`` (5) of its outputs; ``guard`` takes the partials of the
    guarded forms."""
    if guard:
        r = torch.clamp(r_in, -1e4, 1e4)
        p_r = torch.clamp(pr_in, -1e4, 1e4)
        p_th = torch.clamp(pth_in, -1e4, 1e4)
    else:
        r, p_r, p_th = r_in, pr_in, pth_in
    sn = torch.sin(th)
    cs = torch.cos(th)
    ss = sn * sn
    u = torch.clamp(ss, min=1e-12)
    invu = 1.0 / u
    ac = a * cs
    sigma = r * r + ac * ac
    inv_sigma = 1.0 / (torch.clamp(sigma, min=1e-3) if guard else sigma)
    delta = r * (r - 2.0 * M) + a * a + q2
    inv_delta = _ginv(delta, 1e-6) if guard else 1.0 / delta
    P = (r * r + a * a) * E - a * L
    G = L - a * E * u
    W = (delta * p_r * p_r + p_th * p_th + G * G * invu
         - P * P * inv_delta)
    dDelta = 2.0 * r - 2.0 * M
    dWdr = (dDelta * p_r * p_r - 4.0 * r * E * P * inv_delta
            + P * P * dDelta * inv_delta * inv_delta)
    sin2t = 2.0 * sn * cs
    aE = a * E
    q = aE * aE - L * L * invu * invu
    dWdth = q * sin2t
    half = 0.5 * inv_sigma
    aas = a * a * sin2t
    t2 = G * invu + a * P * inv_delta
    t3 = -dWdr + W * (2.0 * r) * inv_sigma
    t4 = -dWdth - W * aas * inv_sigma
    g_t2 = g[2] * inv_sigma
    g_t3 = g[3] * half
    g_t4 = g[4] * half
    g_is = (g[0] * delta * p_r + g[1] * p_th + g[2] * t2
            + 0.5 * (g[3] * t3 + g[4] * t4) + g_t3 * W * (2.0 * r)
            - g_t4 * W * aas)
    g_W = g_t3 * (2.0 * r) * inv_sigma - g_t4 * aas * inv_sigma
    g_dWdr = -g_t3
    g_q = -g_t4 * sin2t
    g_rr = g_t3 * W * 2.0 * inv_sigma
    g_delta = g[0] * p_r * inv_sigma
    g_prr = g[0] * delta * inv_sigma
    g_pthh = g[1] * inv_sigma
    g_G = g_t2 * invu
    g_invu = g_t2 * G
    g_P = g_t2 * a * inv_delta
    g_id = g_t2 * a * P
    g_aas = -g_t4 * W * inv_sigma
    g_a = g_t2 * P * inv_delta + g_aas * 2.0 * a * sin2t
    g_sin2t = g_aas * a * a - g_t4 * q
    g_aE = g_q * 2.0 * aE
    g_L = -g_q * 2.0 * L * invu * invu
    g_invu = g_invu + -g_q * L * L * 2.0 * invu
    g_a = g_a + g_aE * E
    g_E = g_aE * a
    g_dD = g_dWdr * (p_r * p_r + P * P * inv_delta * inv_delta)
    g_prr = g_prr + g_dWdr * dDelta * 2.0 * p_r
    g_rr = g_rr + -g_dWdr * 4.0 * E * P * inv_delta
    g_E = g_E + -g_dWdr * 4.0 * r * P * inv_delta
    g_P = g_P + g_dWdr * (-4.0 * r * E * inv_delta
                          + 2.0 * P * dDelta * inv_delta * inv_delta)
    g_id = g_id + g_dWdr * (-4.0 * r * E * P
                            + 2.0 * P * P * dDelta * inv_delta)
    g_rr = g_rr + 2.0 * g_dD
    g_M = -2.0 * g_dD
    g_delta = g_delta + g_W * p_r * p_r
    g_prr = g_prr + g_W * 2.0 * delta * p_r
    g_pthh = g_pthh + g_W * 2.0 * p_th
    g_G = g_G + g_W * 2.0 * G * invu
    g_invu = g_invu + g_W * G * G
    g_P = g_P + -g_W * 2.0 * P * inv_delta
    g_id = g_id + -g_W * P * P
    g_L = g_L + g_G
    g_a = g_a + -g_G * E * u
    g_E = g_E + -g_G * a * u
    g_u = -g_G * a * E
    g_rr = g_rr + g_P * 2.0 * r * E
    g_a = g_a + g_P * (2.0 * a * E - L)
    g_E = g_E + g_P * (r * r + a * a)
    g_L = g_L + -g_P * a
    g_dinv = -g_id * inv_delta * inv_delta
    if guard:
        g_dinv = g_dinv * _max_share(torch.abs(delta), 1e-6)
    g_delta = g_delta + g_dinv
    g_rr = g_rr + g_delta * (2.0 * r - 2.0 * M)
    g_M = g_M + -g_delta * 2.0 * r
    g_a = g_a + g_delta * 2.0 * a
    g_sig = -g_is * inv_sigma * inv_sigma
    if guard:
        g_sig = g_sig * _max_share(sigma, 1e-3)
    g_rr = g_rr + g_sig * 2.0 * r
    g_ac = g_sig * 2.0 * ac
    g_a = g_a + g_ac * cs
    g_c = g_ac * a
    g_u = g_u + -g_invu * invu * invu
    g_s = g_u * _max_share(ss, 1e-12) * 2.0 * sn + g_sin2t * 2.0 * cs
    g_c = g_c + g_sin2t * 2.0 * sn
    g_th = g_s * cs - g_c * sn
    if guard:
        g_rr = g_rr * _clip_share(r_in, -1e4, 1e4)
        g_prr = g_prr * _clip_share(pr_in, -1e4, 1e4)
        g_pthh = g_pthh * _clip_share(pth_in, -1e4, 1e4)
    return g_rr, g_th, g_prr, g_pthh, (g_M, g_a, g_delta, g_E, g_L)


def _add_theta(g, terms, act):
    """The running per-ray sums ``g`` with one RHS VJP's theta terms added
    (where ``act``), as the kernels add them."""
    return [ga + masked(act, gb) for ga, gb in zip(g, terms)]


# ------------------------------------------------------- RK4 (#7)

def kerr_dte_plain(row, r, th):
    """The step of kernel #7 at (r, theta): dt times the axis and far-field
    scales."""
    dt, ax_u0, far_r0 = row[0], row[8], row[9]
    s_ax = torch.sin(th)
    scale = torch.clamp((s_ax * s_ax + 1e-12)
                        / torch.clamp(ax_u0, min=1e-12), 1.0 / 16.0, 1.0)
    fscale = torch.clamp(r / torch.clamp(far_r0, min=1e-12), 1.0, 8.0)
    return dt * scale * fscale


def kerr_rk4_stages_plain(row, E, L, y):
    """csrc/kerr_step.cuh:kerr_rk4_stages -> (dte, hd, stage inputs (4 x
    (r, theta, p_r, p_theta)), slopes (4 x 5))."""
    dte = kerr_dte_plain(row, y[0], y[1])
    hd = 0.5 * dte
    yi, k = [], []
    for i in range(4):
        if i == 0:
            inp = [y[c] for c in RHS_IN]
        else:
            h = dte if i == 3 else hd
            inp = [y[c] + h * k[i - 1][c] for c in RHS_IN]
        yi.append(inp)
        k.append(kerr_rhs_plain(row, E, L, *inp))
    return dte, hd, yi, k


def kerr_step5_plain(row, E, L, y):
    """One RK4 step of kernel #7 on every ray: ``row`` its scalar row
    tensor, y = (r, theta, phi, p_r, p_theta) -> the state after it."""
    dte, _, _, k = kerr_rk4_stages_plain(row, E, L, y)
    w = dte * (1.0 / 6.0)
    return tuple(y[c] + w * (k[0][c] + 2.0 * (k[1][c] + k[2][c]) + k[3][c])
                 for c in range(5))


def kerr_step5_vjp_plain(row, E, L, y, lam, g=None, act=None, *,
                         guard=False, g_dte_in=None):
    """csrc/kerr_vjp.cuh:kerr_rk4_vjp: ``lam`` (5) is the cotangent of the
    state after the step at ``y`` -> (that of the state before it (5), the
    per-ray sums ``g`` of (g_M, g_a, g_q2, g_E, g_L) with this step's terms
    added (from zeros when None; ``act`` masks them)).  ``guard`` takes the
    guarded RHS partials; ``g_dte_in`` is a cotangent of the step's dte
    from elsewhere (the kernels' DTE_IN)."""
    M, a, q2 = row[2], row[3], row[4]
    dte, hd, yi, k = kerr_rk4_stages_plain(row, E, L, y)
    w = dte * (1.0 / 6.0)
    zero = torch.zeros_like(y[0])
    g = [zero] * 5 if g is None else list(g)
    g_w = zero
    gk = [[None] * 5 for _ in range(4)]
    for c in range(5):
        total = k[0][c] + 2.0 * (k[1][c] + k[2][c]) + k[3][c]
        g_w = g_w + lam[c] * total
        g_sum = lam[c] * w
        gk[0][c] = g_sum
        gk[1][c] = 2.0 * g_sum
        gk[2][c] = 2.0 * g_sum
        gk[3][c] = g_sum
    lam = list(lam)
    g_dte = g_w * (1.0 / 6.0)
    if g_dte_in is not None:
        g_dte = g_dte + g_dte_in
    g_hd = zero
    for i in range(3, -1, -1):
        *gi, terms = kerr_rhs_vjp_plain(guard, M, a, q2, E, L, *yi[i],
                                        gk[i])
        g = _add_theta(g, terms, act)
        for q, c in enumerate(RHS_IN):
            lam[c] = lam[c] + gi[q]
        if i > 0:
            h = dte if i == 3 else hd
            g_h = zero
            for q, c in enumerate(RHS_IN):
                gk[i - 1][c] = gk[i - 1][c] + h * gi[q]
                g_h = g_h + gi[q] * k[i - 1][c]
            if i == 3:
                g_dte = g_dte + g_h
            else:
                g_hd = g_hd + g_h
    g_dte = g_dte + 0.5 * g_hd
    s_ax = torch.sin(y[1])
    u0 = torch.clamp(row[8], min=1e-12)
    x_ax = (s_ax * s_ax + 1e-12) / u0
    scale = torch.clamp(x_ax, 1.0 / 16.0, 1.0)
    f0 = torch.clamp(row[9], min=1e-12)
    x_far = y[0] / f0
    fscale = torch.clamp(x_far, 1.0, 8.0)
    g_scale = g_dte * fscale * row[0]
    g_fscale = g_dte * row[0] * scale
    lam[1] = lam[1] + (g_scale * _clip_share(x_ax, 1.0 / 16.0, 1.0) * 2.0
                       * s_ax * torch.cos(y[1]) / u0)
    lam[0] = lam[0] + g_fscale * _clip_share(x_far, 1.0, 8.0) / f0
    return tuple(lam), tuple(g)


# ------------------------------------------------------- DP5(4) (#8)

def kerr_rk45_trial_plain(row, E, L, y, dt):
    """csrc/kerr_step.cuh:kerr_rk45_trial on every ray -> a dict of its
    record (stage inputs ``yi``, slopes ``k``, ``d5``, ``e``, ``y1``, the
    scaled errors ``ec`` and their ``den``, ``err``, ``accept``, ``esc``,
    ``over``, ``frac``, ``den_r``, ``small``)."""
    R, rtol, atol = row[1], row[8], row[9]
    one = torch.ones_like(y[0])
    yi, ks = [], []
    for i in range(7):
        inp = [y[c] for c in RHS_IN]
        for j, aa in enumerate(DP_A[i]):
            inp = [v + dt * aa * ks[j][c] for v, c in zip(inp, RHS_IN)]
        yi.append(inp)
        ks.append(kerr_rhs_plain(row, E, L, *inp))
    d5 = [_comb(DP_B5, ks, c, y[0]) for c in range(5)]
    e = [d5[c] - _comb(DP_B4, ks, c, y[0]) for c in RHS_IN]
    y1 = [y[c] + dt * d5[c] for c in range(5)]
    den = [atol + rtol * torch.maximum(torch.abs(y[c]), torch.abs(y1[c]))
           for c in RHS_IN]
    ec = [torch.abs(dt * eq) / dq for eq, dq in zip(e, den)]
    # torch.maximum propagates NaN, as the kernel's max_nan
    err = torch.maximum(torch.maximum(ec[0], ec[1]),
                        torch.maximum(ec[2], ec[3]))
    accept = err <= 1.0
    esc = accept & (y1[0] > R)
    den_r = y1[0] - y[0]
    small = torch.abs(den_r) < 1e-30
    den_r = torch.where(small, one, den_r)
    frac = (R - y[0]) / den_r
    over = esc & (frac < 0.9) & (y1[0] > R * (1.0 + 1e-3))
    return dict(yi=yi, k=ks, y=list(y), y1=y1, d5=d5, e=e, ec=ec, den=den,
                dt=dt, err=err, accept=accept & ~over, esc=esc & ~over,
                over=over, frac=frac, den_r=den_r, small=small)


def rk45_bounds(row):
    """(dt_max, dt_min) of kernel #8's row: at 10 in the bare and disk row
    (12 floats), at 18 in the volumetric one (20 or 47)."""
    b = 10 if row.numel() == N_ROW["rk45"] else 18
    return row[b], row[b + 1]


def kerr_rk45_terminal_plain(row, t):
    """csrc/kerr_vjp.cuh:kerr_rk45_terminal: where kernel #8 keeps dt."""
    m_chk = sum(torch.abs(v) for v in t["y1"])
    ok = m_chk <= 1e8
    stop = ~ok | t["esc"] | (t["y1"][0] < row[5])
    return torch.where(t["accept"], stop,
                       t["dt"] <= rk45_bounds(row)[1] * 1.01)


def kerr_rk45_next_dt_plain(row, t):
    """csrc/kerr_step.cuh:kerr_rk45_next_dt."""
    dt_max, dt_min = rk45_bounds(row)
    dt, err = t["dt"], t["err"]
    err_s = torch.clamp(err, min=1e-10)
    factor = torch.clamp(0.9 * torch.exp(-0.2 * torch.log(err_s)), 0.2, 5.0)
    factor = torch.where(factor > 0.0, factor, 0.2)
    return torch.where(t["over"],
                       torch.clamp(dt * t["frac"] * 1.05, dt_min, dt_max),
                       torch.clamp(dt * factor, dt_min, dt_max))


def kerr_rk45_iter_plain(row, E, L, y, freeze=False):
    """One bare iteration of kernel #8 on every ray: y = (r, theta, phi,
    p_r, p_theta, dt) -> the state after it.  ``freeze`` detaches the next
    dt."""
    t = kerr_rk45_trial_plain(row, E, L, y[:5], y[5])
    out = [torch.where(t["accept"], b, a) for a, b in zip(y[:5], t["y1"])]
    dtn = torch.where(kerr_rk45_terminal_plain(row, t), y[5],
                      kerr_rk45_next_dt_plain(row, t))
    return (*out, dtn.detach() if freeze else dtn)


def kerr_rk45_next_vjp_plain(row, t, terminal, g_next, g_y, g_y1):
    """csrc/kerr_vjp.cuh:kerr_rk45_next_vjp: the cotangent ``g_next`` of
    trial ``t``'s next dt (dt itself where ``terminal``) -> (g_y, g_y1
    with the escape fraction's terms added, g_dt, g_err)."""
    dt_max, dt_min = rk45_bounds(row)
    dt = t["dt"]
    zero = torch.zeros_like(dt)
    g_y, g_y1 = list(g_y), list(g_y1)
    over = t["over"] & ~terminal
    ctrl = ~terminal & ~t["over"]
    # the over-reject: next = clip(dt frac 1.05)
    x = dt * t["frac"] * 1.05
    g_x = g_next * _clip_share(x, dt_min, dt_max)
    g_frac = g_x * dt * 1.05
    g_y[0] = g_y[0] + torch.where(over, -g_frac / t["den_r"], zero)
    g_den = torch.where(over & ~t["small"], -g_frac * t["frac"] / t["den_r"],
                        zero)
    g_y1[0] = g_y1[0] + g_den
    g_y[0] = g_y[0] - g_den
    # the controller: next = clip(dt factor(err))
    err = t["err"]
    err_s = torch.clamp(err, min=1e-10)
    f_raw = 0.9 * torch.exp(-0.2 * torch.log(err_s))
    f_c = torch.clamp(f_raw, 0.2, 5.0)
    pos = f_c > 0.0
    factor = torch.where(pos, f_c, 0.2)
    xc = dt * factor
    g_xc = g_next * _clip_share(xc, dt_min, dt_max)
    g_fc = torch.where(pos, g_xc * dt, zero)
    g_fraw = g_fc * _clip_share(f_raw, 0.2, 5.0)
    g_err = torch.where(ctrl & (g_fraw != 0.0), g_fraw * (-0.2)
                        * f_raw / err_s * _max_share(err, 1e-10), zero)
    g_dt = torch.where(terminal, g_next,
                       torch.where(over, g_x * t["frac"] * 1.05,
                                   torch.where(ctrl, g_xc * factor, zero)))
    return g_y, g_y1, g_dt, g_err


def kerr_rk45_trial_vjp_plain(row, E, L, t, g_err, g_y, g_y1, g_dt, g=None,
                              act=None):
    """csrc/kerr_vjp.cuh:kerr_rk45_trial_vjp: the cotangents ``g_y1`` of
    trial ``t``'s y1 and ``g_err`` of its error norm, with those gathered
    for its start (``g_y``, ``g_dt``) -> (the cotangent of (y, dt) (6),
    the per-ray sums ``g`` of (g_M, g_a, g_q2, g_E, g_L) with the trial's
    terms added (from zeros when None; ``act`` masks them))."""
    M, a, q2 = row[2], row[3], row[4]
    rtol = row[8]
    dt = t["dt"]
    zero = torch.zeros_like(dt)
    g = [zero] * 5 if g is None else list(g)
    g_y, g_y1 = list(g_y), list(g_y1)
    on = g_err != 0.0
    ec = t["ec"]
    s01 = _max_share(torch.maximum(ec[0], ec[1]), torch.maximum(ec[2], ec[3]))
    s0 = _max_share(ec[0], ec[1])
    s2 = _max_share(ec[2], ec[3])
    g_ec = (g_err * s01 * s0, g_err * s01 * (1.0 - s0),
            g_err * (1.0 - s01) * s2, g_err * (1.0 - s01) * (1.0 - s2))
    g_e = []
    for q, c in enumerate(RHS_IN):
        # added only where the error norm has a cotangent, as in the kernel
        x = dt * t["e"][q]
        g_x = g_ec[q] / t["den"][q] * torch.sign(x)
        g_dt = g_dt + torch.where(on, g_x * t["e"][q], zero)
        g_e.append(torch.where(on, g_x * dt, zero))
        g_mx = -g_ec[q] * ec[q] / t["den"][q] * rtol
        sh = _max_share(torch.abs(t["y"][c]), torch.abs(t["y1"][c]))
        g_y[c] = g_y[c] + torch.where(on, g_mx * sh * torch.sign(t["y"][c]),
                                      zero)
        g_y1[c] = g_y1[c] + torch.where(
            on, g_mx * (1.0 - sh) * torch.sign(t["y1"][c]), zero)
    # a rejected trial whose error norm has no cotangent passes none to y1
    # or its stages (kernel: those terms are not formed)
    reach = t["accept"] | t["over"] | on
    gk = [[None] * 5 for _ in range(7)]
    for c in range(5):
        ge = zero if c == 2 else g_e[c if c < 2 else c - 1]
        g_y[c] = g_y[c] + torch.where(reach, g_y1[c], zero)
        g_dt = g_dt + torch.where(reach, g_y1[c] * t["d5"][c], zero)
        g_d5 = g_y1[c] * dt + ge
        for i in range(7):
            gk[i][c] = DP_B5[i] * g_d5 - DP_B4[i] * ge
    live = reach if act is None else reach & act
    for i in range(6, -1, -1):
        *gi, terms = kerr_rhs_vjp_plain(True, M, a, q2, E, L, *t["yi"][i],
                                        gk[i])
        g = _add_theta(g, terms, live)
        for q, c in enumerate(RHS_IN):
            g_y[c] = g_y[c] + torch.where(reach, gi[q], zero)
        for j, a_ij in enumerate(DP_A[i]):
            if a_ij != 0.0:
                coef = dt * a_ij
                g_a = zero
                for q, c in enumerate(RHS_IN):
                    gk[j][c] = gk[j][c] + coef * gi[q]
                    g_a = g_a + t["k"][j][c] * gi[q]
                g_dt = g_dt + torch.where(reach, a_ij * g_a, zero)
    return (*g_y, g_dt), tuple(g)


def kerr_rk45_iter_vjp_plain(row, E, L, y, lam, freeze=False, g=None,
                             act=None):
    """csrc/kerr_vjp.cuh:kerr_rk45_vjp: ``lam`` (6) is the cotangent of
    the state after the iteration at ``y`` (6) -> (that of the state before
    it (6), the per-ray sums ``g`` of (g_M, g_a, g_q2, g_E, g_L) with this
    iteration's terms added (from zeros when None; ``act`` masks them))."""
    t = kerr_rk45_trial_plain(row, E, L, y[:5], y[5])
    zero = torch.zeros_like(t["dt"])
    acc = t["accept"]
    g_y1 = [torch.where(acc, lam[c], zero) for c in range(5)]
    g_y = [torch.where(acc, zero, lam[c]) for c in range(5)]
    g_dt, g_err = zero, zero
    if not freeze:
        g_y, g_y1, g_dt, g_err = kerr_rk45_next_vjp_plain(
            row, t, kerr_rk45_terminal_plain(row, t), lam[5], g_y, g_y1)
    return kerr_rk45_trial_vjp_plain(row, E, L, t, g_err, g_y, g_y1, g_dt, g,
                                     act)


# ------------------------------------------------------- plain kernel pair

def _plain_step(family, row, E, L):
    if family == "rk4":
        return lambda y: kerr_step5_plain(row, E, L, y)
    return lambda y: kerr_rk45_iter_plain(row, E, L, y)


def _start(family, row, y0):
    """The replay's start: the spawn state, with dt0 for DP5(4)."""
    y0 = tuple(y0)
    if family == "rk45":
        y0 = y0 + (torch.ones_like(y0[0]) * row[0],)
    return y0


def ckpt_kerr_gen_plain(family, scal, y0, E, L, counts, *, seg, offsets,
                        total):
    """Plain version of kernel #9's Kerr variant of ``family``: the masked
    march of ``counts[i]`` steps (iterations) from the spawn state ``y0``
    (5), writing each ray's segment starts into the compacted (total,
    n_state) buffer -> (ckpt, final state (n_state, n))."""
    row = row_tensor(scal, E)
    step = _plain_step(family, row, E, L)
    y = _start(family, row, y0)
    ckpt = torch.zeros((total, N_STATE[family]), dtype=E.dtype,
                       device=E.device)
    n_seg = -(-int(counts.max()) // seg) if counts.numel() else 0
    for s in range(n_seg):
        has = s * seg < counts
        ckpt[offsets[has] + s] = torch.stack(y, 1)[has]
        for k in range(seg):
            act = s * seg + k < counts
            y1 = step(y)
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return ckpt, torch.stack(y)


def ckpt_kerr_bwd_plain(family, scal, ckpt, E, L, counts, cot, *, seg,
                        offsets, freeze=False):
    """Plain version of kernel #10's Kerr variant of ``family``: each
    segment, last to first, re-marched from its checkpoint and pulled back
    through its steps with the plain VJP -> (per-ray theta cotangents (5,
    n), lam (n_state, n)).  A step at or past a ray's count is the
    identity."""
    row = row_tensor(scal, E)
    step = _plain_step(family, row, E, L)
    ns = N_STATE[family]
    lam = tuple(cot)
    g = [torch.zeros_like(E) for _ in range(5)]
    n_seg = -(-int(counts.max()) // seg) if counts.numel() else 0
    for s in range(n_seg - 1, -1, -1):
        has = s * seg < counts
        rows = ckpt[torch.where(has, offsets + s, 0)]
        y = tuple(rows[:, c] for c in range(ns))
        starts = []
        for _ in range(seg):
            starts.append(y)
            y = step(y)
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < counts
            if family == "rk4":
                new, g = kerr_step5_vjp_plain(row, E, L, starts[k], lam, g,
                                              act)
            else:
                new, g = kerr_rk45_iter_vjp_plain(row, E, L, starts[k], lam,
                                                  freeze, g, act)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
    return torch.stack(g), torch.stack(lam)


# ------------------------------------------------------------ the kernels

def _check_rays(n, *arrays):
    for t in arrays:
        if t.dtype != torch.float32:
            raise TypeError(f"Kerr checkpoint kernels take float32, got "
                            f"{t.dtype}")
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError("Kerr checkpoint kernels take contiguous (n,) "
                             f"rays, got {tuple(t.shape)}")


def _check_family(family, scal):
    if family not in FAMILIES:
        raise ValueError(f"unknown Kerr family {family!r}: one of "
                         f"{FAMILIES}")
    if len(scal) != N_ROW[family]:
        raise ValueError(f"the {family} family takes a {N_ROW[family]}-float"
                         f" row, got {len(scal)}")


def launch_gen(family, scal, y0, E, L, counts, *, seg, offsets, total):
    """Kernel #9's Kerr variant of ``family`` on flat contiguous CUDA
    tensors of one device (float32 rays, int32 counts, int64 offsets) ->
    (the (total, n_state) checkpoint buffer, the final state (n_state,
    n))."""
    _check_family(family, scal)
    n = E.numel()
    _check_rays(n, *y0, E, L)
    if counts.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("counts must be int32 and offsets int64")
    ns = N_STATE[family]
    dev = E.device
    ckpt = torch.empty((max(total, 1), ns), dtype=torch.float32, device=dev)
    final = torch.empty((ns, n), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn, key = ((lib.curvis_ckpt_kerr_gen, "kerr_gen") if family == "rk4"
               else (lib.curvis_ckpt_kerr_rk45_gen, "kerr_rk45_gen"))
    err = fn(row, len(scal), *(t.data_ptr() for t in y0), E.data_ptr(),
             L.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
             ckpt.data_ptr(), final.data_ptr(), n, seg, dev.index, stream)
    _build.check(lib, err, f"ckpt_{key}_kernel")
    launches[key] += 1
    return ckpt, final


def launch_bwd(family, scal, ckpt, E, L, counts, cot, *, seg, offsets,
               freeze=False):
    """Kernel #10's Kerr variant of ``family`` on the buffer of
    ``launch_gen`` and the (n_state, n) cotangent ``cot`` -> (per-ray theta
    cotangents (5, n), lam (n_state, n))."""
    _check_family(family, scal)
    n = E.numel()
    _check_rays(n, E, L)
    ns = N_STATE[family]
    dev = E.device
    if cot.dtype != torch.float32 or cot.shape != (ns, n) \
            or not cot.is_contiguous():
        raise ValueError(f"bad cotangent {tuple(cot.shape)}")
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (ns,) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    lam = torch.empty((ns, n), dtype=torch.float32, device=dev)
    g = torch.empty((5, n), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (ckpt.data_ptr(), E.data_ptr(), L.data_ptr(), counts.data_ptr(),
            offsets.data_ptr(), cot.data_ptr(), lam.data_ptr(), g.data_ptr(),
            n, seg, dev.index, stream)
    if family == "rk4":
        key = "kerr_bwd"
        err = lib.curvis_ckpt_kerr_bwd(row, len(scal), *ptrs)
    else:
        key = "kerr_rk45_bwd"
        err = lib.curvis_ckpt_kerr_rk45_bwd(row, len(scal),
                                            int(bool(freeze)), *ptrs)
    _build.check(lib, err, f"ckpt_{key}_kernel")
    launches[key] += 1
    return g, lam


def ckpt_kerr_backward_cuda(family, scal, y0, E, L, counts, cot, *,
                            freeze=False, seg=None):
    """Exact pullback of the masked march of ``family`` with the march
    kernel's bare row ``scal``: ray i takes ``counts[i]`` steps (RK4) or
    iterations (DP5(4)) from its spawn state ``y0`` (5) (and dt0); ``cot``
    is the (n_state, n) cotangent of the final state -> ``(g_theta (5, n),
    lam (n_state, n))``, lam the cotangent of the start.  CUDA tensors run
    kernels #9 / #10, CPU tensors their plain versions."""
    _check_family(family, scal)
    seg = SEG[family] if seg is None else int(seg)
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"segment {seg} outside [1, {MAX_SEG}]")
    if scal[0] <= 0.0:
        raise ValueError("dt must be positive")
    offsets, total = segment_offsets(counts, seg)
    dev = E.device
    if total == 0:
        return (torch.zeros((5, E.numel()), dtype=E.dtype, device=dev),
                cot.clone())
    if dev.type == "cpu":
        ckpt, _ = ckpt_kerr_gen_plain(family, scal, y0, E, L, counts,
                                      seg=seg, offsets=offsets, total=total)
        return ckpt_kerr_bwd_plain(family, scal, ckpt, E, L, counts, cot,
                                   seg=seg, offsets=offsets, freeze=freeze)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_kerr_backward_cuda: unsupported device {dev}")
    ckpt, _ = launch_gen(family, scal, y0, E, L, counts, seg=seg,
                         offsets=offsets, total=total)
    return launch_bwd(family, scal, ckpt, E, L, counts, cot, seg=seg,
                      offsets=offsets, freeze=freeze)
