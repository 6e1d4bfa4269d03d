"""Checkpointed-recompute adjoint of the Boyer-Lindquist surface marches on
the GPU: wrapper of the CUDA kernels ``csrc/ckpt_kerr_surface.cu`` (the
RK4 families) and ``csrc/ckpt_kerr_surface_rk45.cu`` (the DP5(4)
families), the Kerr surface variants of
``curvis_tpu/ops/ckpt_adjoint_pallas.py``'s ``_ckpt_gen_kernel`` (#9) and
``_ckpt_bwd_kernel`` (#10), and their plain PyTorch versions.

A family is a stepper (``'rk4'``: kernel #7's step; ``'rk45'``: kernel
#8's iteration) and a surface, ``flags``: None for the thin disk, a
(blackbody, beaming, scatter) tuple for the volumetric gas.  The states
per ray:

  * rk4 disk (12): (r, theta, phi, p_r, p_theta, ct_prev, h1, h1_phi,
    h1_side, h2, h2_phi, h2_side), from (the spawn state, cos theta0, 0...);
  * rk4 gas (9): (r, theta, phi, p_r, p_theta, tau, em_r, em_g, em_b);
  * rk45 disk (13) and gas (10): dt after the five, from dt0;

and theta: (M, a, q2, E, L) for the disk (the band is a gate: its
cotangent is zero), then for the gas the emission row's (r_in, r_out, the
8 slots of ``VOL_SLOT_NAMES``) and, with scatter, the 27 block scalars.
The scalar row is the march kernel's (``ops/kerr_cuda.py:kerr_scalars``,
``ops/kerr_rk45_cuda.py:kerr_rk45_scalars``, with ``disk=`` or
``vol_disk=`` / ``vol_row=``), so the replay reads the values the forward
read.  Ray i takes ``counts[i]`` steps (iterations) from its start.

``ckpt_kerr_surface_backward_cuda`` pulls a cotangent of the final state
back to the start and theta: kernels #9 / #10 for CUDA tensors, the plain
pair for CPU tensors, never a fallback from the one to the other.  The
checkpoint buffer is compacted by the prefix sum of each ray's segments
(``ops/ckpt_adjoint_cuda.py:segment_offsets``); segments are 32 steps
(RK4) and 16 iterations (DP5(4)), the JAX package's.

The plain versions run vectorised over rays with masks, in the kernels'
arithmetic:

  * ``kerr_rk4_surface_step_plain`` and ``kerr_rk45_surface_iter_plain``
    are the steps (csrc/kerr_step.cuh: kerr_rk4_surface_step,
    kerr_rk45_surface_iter) on ``ops/ckpt_kerr_cuda.py``'s bare step and
    trial, with ``track_hit_plain``, the emission of
    ``ops/kerr_cuda.py:kerr_vol_emission_plain`` and #8's clamps;
  * the ``*_vjp_plain`` functions transcribe csrc/kerr_surface_vjp.cuh
    line by line, on ``ops/ckpt_kerr_cuda.py``'s transcriptions of
    csrc/kerr_vjp.cuh, and add the theta terms to the per-ray running sums
    in the kernels' order.  The RHS partials are the guarded ones; at a
    clamp the cotangent passes on the closed interval and a max of two
    equal values splits it in halves, as torch's autograd does, so off the
    guards each equals ``torch.func.vjp`` of its step.
"""
from __future__ import annotations

import torch

from curvis_tpu_torch.ops import _build
from curvis_tpu_torch.ops import ckpt_kerr_cuda as ck
from curvis_tpu_torch.ops.ckpt_adjoint_cuda import segment_offsets
from curvis_tpu_torch.ops.ckpt_rk45_cuda import _max_share
from curvis_tpu_torch.ops.ckpt_surface_cuda import (_clamp_pass,
                                                    crossing_frac,
                                                    crossing_frac_vjp,
                                                    take_hit_cotangent)
from curvis_tpu_torch.ops.disk_vol_cuda import (_BB_K, _BB_L5, SCATTER_BLOCK,
                                                SCATTER_DEG)
from curvis_tpu_torch.ops.kerr_cuda import (KERR_SCATTER_OFF, VOL_BLOCK_KERR,
                                            kerr_vol_emission_plain)

FAMILIES = ("rk4", "rk45")
SEG = {"rk4": 32, "rk45": 16}    # the JAX package's _PALLAS_SEG of each
N_THETA_DISK = 5                 # M, a, q2, E, L
N_THETA_VOL = 15                 # + r_in, r_out, the 8 slots
TH_RIN, TH_ROUT, TH_SLOTS, TH_BLOCK = 5, 6, 7, 15   # the gas's theta rows
FLAG_BITS = {"blackbody": 1, "beaming": 2, "scatter": 4}
TAU_MAX = VOL_BLOCK_KERR + 3     # the tau_max slot of the gas row

launches = {"kerr_surface_gen": 0, "kerr_surface_bwd": 0,
            "kerr_surface_rk45_gen": 0, "kerr_surface_rk45_bwd": 0}


def n_state(family, flags):
    """State size of a family (module docstring)."""
    return (12 if flags is None else 9) + (family == "rk45")


def n_theta(flags):
    if flags is None:
        return N_THETA_DISK
    return N_THETA_VOL + (SCATTER_BLOCK if flags[2] else 0)


def flag_mask(flags):
    """The kernels' bitmask of a gas family (0 for the disk)."""
    if flags is None:
        return 0
    return sum(bit for bit, on in zip(FLAG_BITS.values(), flags) if on)


def row_length(family, flags):
    """Length of the march kernel's row of a family."""
    if flags is None:
        return ck.N_ROW[family]
    return KERR_SCATTER_OFF + (SCATTER_BLOCK if flags[2] else 0)


class _Sums:
    """Per-ray running sums of theta cotangents: each term is added where
    ``act`` (and a further mask, if given) holds, in the order the kernels
    add them (``g[k] += term``)."""

    def __init__(self, g, act):
        self.g = list(g)
        self.act = act

    def add(self, k, term, mask=None):
        m = self.act if mask is None else (
            mask if self.act is None else mask & self.act)
        if m is not None:
            term = torch.where(m, term, torch.zeros_like(term))
        self.g[k] = self.g[k] + term


# ------------------------------------------------------- the steps

def track_hit_plain(r_in, r_out, r, ph, y1, ct_prev, ct, hits, gate=None):
    """csrc/kerr_step.cuh:kerr_track_hit on every ray (where ``gate``) ->
    (the six hit values, new1, new2: which slot was filled)."""
    one = torch.ones_like(r)
    crossed = ct_prev * ct < 0.0
    if gate is not None:
        crossed = crossed & gate
    den = torch.abs(ct_prev) + torch.abs(ct)
    frac = torch.abs(ct_prev) / torch.clamp(den, min=1e-30)
    r_hit = r + frac * (y1[0] - r)
    ph_hit = ph + frac * (y1[2] - ph)
    side = torch.where(ct_prev > 0.0, one, -one)
    in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
    new1 = in_disk & (hits[0] == 0.0)
    new2 = in_disk & (hits[0] != 0.0) & (hits[3] == 0.0)
    vals = (r_hit, ph_hit, side)
    out = [torch.where(new1, vals[k], hits[k]) for k in range(3)] \
        + [torch.where(new2, vals[k], hits[3 + k]) for k in range(3)]
    return out, new1, new2


def _finite(y):
    """kerr_step.cuh:kerr_finite: |r| + |theta| + |phi| + |p_r| +
    |p_theta| <= 1e8 (False for NaN)."""
    return (torch.abs(y[0]) + torch.abs(y[1]) + torch.abs(y[2])
            + torch.abs(y[3]) + torch.abs(y[4])) <= 1e8


def _rk4_y1(row, E, L, y5):
    """(dte, the state after kernel #7's RK4 step at y5)."""
    dte, _, _, k = ck.kerr_rk4_stages_plain(row, E, L, y5)
    w = dte * (1.0 / 6.0)
    return dte, [y5[c] + w * (k[0][c] + 2.0 * (k[1][c] + k[2][c]) + k[3][c])
                 for c in range(5)]


def kerr_rk4_surface_step_plain(flags, row, E, L, b_ph, y):
    """csrc/kerr_step.cuh:kerr_rk4_surface_step on every ray: ``y`` the
    family's state -> (the state after the step, new1, new2 (disk; None
    for the gas))."""
    dte, y1 = _rk4_y1(row, E, L, y[:5])
    if flags is None:
        ct = torch.cos(y1[1])
        hits, new1, new2 = track_hit_plain(row[6], row[7], y[0], y[2], y1,
                                           y[5], ct, y[6:12])
        return (*y1, ct, *hits), new1, new2
    ok = _finite(y1)
    tau = y[5]
    dtau, dem = kerr_vol_emission_plain(row, flags, y1[0], y1[1], b_ph, tau)
    em = [torch.where(ok, e + dte * d, e) for e, d in zip(y[6:9], dem)]
    return (*y1, torch.where(ok, tau + dte * dtau, tau), *em), None, None


def gas_dt_plain(row, r, th):
    """csrc/kerr_step.cuh:kerr_gas_dt: #8's gas-slab step bound."""
    s_th = torch.abs(torch.sin(th))
    r_cyl = r * s_th
    gap_r = r_cyl - (row[7] + 2.0 * row[2])
    h_rel5 = 5.0 * torch.sqrt(row[VOL_BLOCK_KERR])
    gap_z = r * torch.abs(torch.cos(th)) - h_rel5 * r_cyl
    return torch.maximum(row[0], 0.5 * torch.maximum(gap_r, gap_z))


def kerr_rk45_surface_iter_plain(flags, row, E, L, b_ph, y, freeze=False):
    """csrc/kerr_step.cuh:kerr_rk45_surface_iter on every ray, each taken
    live: ``y`` the family's state -> (the state after the iteration,
    new1, new2 (disk; None for the gas)).  ``freeze`` detaches the next
    dt (the map that the VJP's ``freeze`` differentiates)."""
    y5, dt = list(y[:5]), y[5]
    t = ck.kerr_rk45_trial_plain(row, E, L, y5, dt)
    acc = t["accept"]
    new1 = new2 = None
    ex = list(y[6:])
    if flags is None:
        ct = torch.cos(t["y1"][1])
        hits, new1, new2 = track_hit_plain(row[6], row[7], y5[0], y5[2],
                                           t["y1"], ex[0], ct, ex[1:7],
                                           gate=acc)
        ex = [torch.where(acc, ct, ex[0])] + hits
    out = [torch.where(acc, b, a) for a, b in zip(y5, t["y1"])]
    terminal = ck.kerr_rk45_terminal_plain(row, t)
    if flags is not None:
        gate = acc & _finite(out)
        tau = ex[0]
        dtau, dem = kerr_vol_emission_plain(row, flags, out[0], out[1], b_ph,
                                            tau)
        em = [torch.where(gate, e + dt * d, e) for e, d in zip(ex[1:4], dem)]
        tau = torch.where(gate, tau + dt * dtau, tau)
        ex = [tau] + em
        terminal = terminal | (tau > row[TAU_MAX])
        nxt = torch.minimum(ck.kerr_rk45_next_dt_plain(row, t),
                            gas_dt_plain(row, out[0], out[1]))
    else:
        nxt = ck.kerr_rk45_next_dt_plain(row, t)
        near = out[0] < row[7] + 2.0 * row[2]
        nxt = torch.where(near, torch.minimum(nxt, row[0]), nxt)
    dtn = torch.where(terminal, dt, nxt)
    return (*out, dtn.detach() if freeze else dtn, *ex), new1, new2


# ------------------------------------------------------- the VJPs

def vol_color_vjp_plain(blackbody, scatter, slots, r_in, r_out, rr, r_cyl,
                        g_shift, tb, blk, g_dem, add):
    """csrc/surface_vjp.cuh:vol_color_vjp -> (g_tb, g_g, g_rr, g_rcyl);
    ``add(k, term)`` adds a theta term in the kernel's order, k a row of the
    gas family's theta."""
    _, _, _, _, t_peak, emis_q, _, t_scale = slots
    zero = torch.zeros_like(rr)
    g_tb, g_g, g_rr, g_rcyl = zero, zero, zero, zero
    if blackbody:
        sq = torch.sqrt(r_in / rr)
        ln_r = torch.log(rr)
        om_raw = 1.0 - sq
        om = torch.clamp(om_raw, min=1e-20)
        f = torch.exp(-0.75 * ln_r + 0.25 * torch.log(om))
        t_obs = g_shift * t_scale * f
        rel_sq = t_obs / t_peak
        rel = rel_sq * rel_sq
        rel = rel * rel
        inv_T = 1.0 / torch.clamp(t_obs, min=1.0)
        es, qs, lg = [], [], []
        for k_c, l5 in zip(_BB_K, _BB_L5):
            x = k_c * inv_T
            es.append(torch.exp(-x))
            qs.append(1.0 - es[-1])
            lg.append(l5 - (x + torch.log(torch.clamp(qs[-1], min=1e-30))))
        m12 = torch.maximum(lg[1], lg[2])
        mx = torch.maximum(lg[0], m12)
        w = tb * rel
        g_w, g_m = zero, zero
        g_lg = []
        for c in range(3):
            ex = torch.exp(lg[c] - mx)
            g_w = g_w + g_dem[c] * ex
            g_lg.append(g_dem[c] * w * ex)
            g_m = g_m - g_lg[c]
        s0 = _max_share(lg[0], m12)
        s1 = _max_share(lg[1], lg[2])
        g_lg[0] = g_lg[0] + g_m * s0
        g_lg[1] = g_lg[1] + g_m * (1.0 - s0) * s1
        g_lg[2] = g_lg[2] + g_m * (1.0 - s0) * (1.0 - s1)
        g_tb = g_tb + g_w * rel
        g_rel = g_w * tb
        g_relsq = g_rel * 4.0 * rel_sq * rel_sq * rel_sq
        g_tobs = g_relsq / t_peak
        add(TH_SLOTS + 4, -g_relsq * rel_sq / t_peak)          # t_peak
        g_invT = zero
        for c in range(3):
            qc = torch.clamp(qs[c], min=1e-30)
            g_x = -g_lg[c] - g_lg[c] * es[c] / qc * _clamp_pass(qs[c], 1e-30)
            g_invT = g_invT + g_x * _BB_K[c]
        g_tobs = g_tobs - g_invT * inv_T * inv_T * _clamp_pass(t_obs, 1.0)
        g_g = g_g + g_tobs * t_scale * f
        add(TH_SLOTS + 7, g_tobs * g_shift * f)                # t_scale
        g_f = g_tobs * g_shift * t_scale
        g_arg = g_f * f
        g_lnr = -0.75 * g_arg
        g_om = 0.25 * g_arg / om
        g_sq = -g_om * _clamp_pass(om_raw, 1e-20)
        g_ratio = g_sq * 0.5 / sq
        add(TH_RIN, g_ratio / rr)
        g_rr = g_rr + (-g_ratio * (r_in / rr) / rr + g_lnr / rr)
    else:
        ratio = r_in / rr
        Lg = torch.log(ratio)
        emis = torch.exp(emis_q * Lg)
        cg = torch.clamp(g_shift, 0.0, 4.0)
        cg3 = cg * cg * cg
        w = tb * emis * cg3
        if scatter:
            g_w = g_dem[0] * blk[0] + g_dem[1] * blk[1] + g_dem[2] * blk[2]
            for c in range(3):
                add(TH_BLOCK + c, g_dem[c] * w)
        else:
            g_w = g_dem[0] + g_dem[1] + g_dem[2]
        g_tb = g_tb + g_w * emis * cg3
        g_emis = g_w * tb * cg3
        g_cg3 = g_w * tb * emis
        g_g = g_g + g_cg3 * 3.0 * cg * cg * _clamp_pass(g_shift, 0.0, 4.0)
        add(TH_SLOTS + 5, g_emis * emis * Lg)                  # emis_q
        g_ratio = g_emis * emis * emis_q / ratio
        add(TH_RIN, g_ratio / rr)
        g_rr = g_rr + -g_ratio * ratio / rr
    if scatter:
        # scat_c = tb max(acc_c, 0), acc_c a Horner sum in t
        W = r_out - r_in
        t_raw = 2.0 * (r_cyl - r_in) / W - 1.0
        t = torch.clamp(t_raw, -1.0, 1.0)
        g_t = zero
        for c in range(3):
            c0 = 3 + c * (SCATTER_DEG + 1)
            accs = [blk[c0 + SCATTER_DEG]]
            for j in range(1, SCATTER_DEG + 1):
                accs.append(accs[j - 1] * t + blk[c0 + SCATTER_DEG - j])
            acc = accs[SCATTER_DEG]
            g_tb = g_tb + g_dem[c] * torch.clamp(acc, min=0.0)
            G = g_dem[c] * tb * _clamp_pass(acc, 0.0)
            for j in range(SCATTER_DEG, 0, -1):
                add(TH_BLOCK + c0 + SCATTER_DEG - j, G)
                g_t = g_t + G * accs[j - 1]
                G = G * t
            add(TH_BLOCK + c0 + SCATTER_DEG, G)
        g_a = g_t * _clamp_pass(t_raw, -1.0, 1.0) * 2.0 / W
        g_rcyl = g_rcyl + g_a
        g_W = -g_a * (r_cyl - r_in) / W
        add(TH_RIN, -g_a - g_W)
        add(TH_ROUT, g_W)
    return g_tb, g_g, g_rr, g_rcyl


def kerr_vol_emission_vjp_plain(flags, row, r, th, b_ph, tau, g_dtau, g_dem,
                                add):
    """csrc/kerr_surface_vjp.cuh:kerr_vol_emission_vjp: the VJP of
    ``kerr_vol_emission_plain`` at (r, theta, b_ph, tau) for the
    cotangents of (dtau, dem) -> (g_r, g_th, g_bph, g_tau); ``add(k,
    term)`` adds the theta terms (rows of the gas family's theta) in the
    kernel's order."""
    blackbody, beaming, scatter = flags
    M, a, q2, r_in, r_out = row[2], row[3], row[4], row[6], row[7]
    slots = row[VOL_BLOCK_KERR:VOL_BLOCK_KERR + 8]
    h2, inv_norm, kappa = slots[0], slots[1], slots[2]
    blk = row[KERR_SCATTER_OFF:]
    # ---- forward, as kerr_vol_emission
    ct = torch.cos(th)
    zq2 = ct * ct
    s2_raw = 1.0 - zq2
    s2 = torch.clamp(s2_raw, 1e-12, 1.0)
    sq_s2 = torch.sqrt(s2)
    r_cyl = r * sq_s2
    dn = 2.0 * h2 * s2
    Ex = torch.exp(-zq2 / dn)
    P = inv_norm / r_cyl
    dens = Ex * P
    w_edge = r_out - r_in
    ein_raw = (r_cyl - r_in) / (0.1 * w_edge)
    edge_in = torch.clamp(ein_raw, 0.0, 1.0)
    eout_raw = (r_out - r_cyl) / (0.3 * w_edge)
    edge_out = torch.clamp(eout_raw, 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = torch.maximum(r_cyl, r_in)
    g_shift = torch.ones_like(rr)
    if beaming:
        sp = slots[6]
        qin = M * rr - q2
        sq = torch.sqrt(torch.clamp(qin, min=1e-12))
        rr2 = rr * rr
        Dn = rr2 + sp * a * sq
        omega = sp * sq / Dn
        u_raw = (1.0 - (3.0 * M - 2.0 * q2 / rr) / rr
                 + 2.0 * sp * a * sq / rr2)
        S = torch.sqrt(torch.clamp(u_raw, min=1e-3))
        x = 1.0 - omega * b_ph
        cl = torch.clamp(x, 0.2, 5.0)
        g_shift = S / cl
    trans = torch.exp(-tau)
    tb = trans * base
    # ---- reverse
    g_base = kappa * g_dtau
    add(TH_SLOTS + 2, base * g_dtau)                          # kappa
    g_tb, g_g, g_rr, g_rcyl = vol_color_vjp_plain(
        blackbody, scatter, slots, r_in, r_out, rr, r_cyl, g_shift, tb, blk,
        g_dem, add)
    g_trans = g_tb * base
    g_base = g_base + g_tb * trans
    g_tau = -g_trans * trans
    g_bph = torch.zeros_like(r)
    if beaming:
        g_S = g_g / cl
        g_cl = -g_g * g_shift / cl
        g_x = g_cl * _clamp_pass(x, 0.2, 5.0)
        g_om = -g_x * b_ph
        g_bph = g_bph + -g_x * omega
        g_u = g_S * 0.5 / S * _clamp_pass(u_raw, 1e-3)
        A1 = 3.0 * M - 2.0 * q2 / rr
        g_A1 = -g_u / rr
        g_rr = g_rr + g_u * A1 / (rr * rr)
        g_M = 3.0 * g_A1
        g_q2 = -2.0 * g_A1 / rr
        g_rr = g_rr + g_A1 * 2.0 * q2 / (rr * rr)
        T = 2.0 * sp * a * sq
        g_T = g_u / rr2
        g_rr2 = -g_u * T / (rr2 * rr2)
        g_sp = g_T * 2.0 * a * sq
        g_a = g_T * 2.0 * sp * sq
        g_sq = g_T * 2.0 * sp * a
        g_N = g_om / Dn
        g_Dn = -g_om * omega / Dn
        g_sp = g_sp + (g_N * sq + g_Dn * a * sq)
        g_sq = g_sq + (g_N * sp + g_Dn * sp * a)
        g_a = g_a + g_Dn * sp * sq
        g_rr2 = g_rr2 + g_Dn
        g_rr = g_rr + 2.0 * rr * g_rr2
        g_in = g_sq * 0.5 / sq * _clamp_pass(qin, 1e-12)
        g_M = g_M + g_in * rr
        g_rr = g_rr + g_in * M
        g_q2 = g_q2 + -g_in
        add(0, g_M)
        add(1, g_a)
        add(2, g_q2)
        add(TH_SLOTS + 6, g_sp)                               # spin_sign
    # rr = max(r_cyl, r_in)
    s_cyl = _max_share(r_cyl, r_in)
    g_rcyl = g_rcyl + g_rr * s_cyl
    add(TH_RIN, g_rr * (1.0 - s_cyl))
    # base = dens edge_in edge_out
    g_dens = g_base * edge_in * edge_out
    g_ein = g_base * dens * edge_out * _clamp_pass(ein_raw, 0.0, 1.0)
    g_eout = g_base * dens * edge_in * _clamp_pass(eout_raw, 0.0, 1.0)
    g_we = -(g_ein * ein_raw + g_eout * eout_raw) / w_edge
    g_rcyl = g_rcyl + (g_ein / (0.1 * w_edge) - g_eout / (0.3 * w_edge))
    add(TH_RIN, -g_ein / (0.1 * w_edge) - g_we)
    add(TH_ROUT, g_eout / (0.3 * w_edge) + g_we)
    # dens = Ex P, Ex = exp(-zq2 / dn), P = inv_norm / r_cyl
    g_E = g_dens * P
    g_P = g_dens * Ex
    add(TH_SLOTS + 1, g_P / r_cyl)                            # inv_norm
    g_rcyl = g_rcyl + -g_P * P / r_cyl
    g_arg = g_E * Ex
    g_zq2 = -g_arg / dn
    g_dn = g_arg * zq2 / (dn * dn)
    add(TH_SLOTS, g_dn * 2.0 * s2)                            # h2
    g_s2 = g_dn * 2.0 * h2
    # r_cyl = r sqrt(s2), s2 = clip(1 - zq2), zq = cos theta
    g_r = g_rcyl * sq_s2
    g_s2 = g_s2 + g_rcyl * r * 0.5 / sq_s2
    g_zq2 = g_zq2 + -g_s2 * _clamp_pass(s2_raw, 1e-12, 1.0)
    g_th = 2.0 * ct * g_zq2 * (-torch.sin(th))
    return g_r, g_th, g_bph, g_tau


def kerr_hit_vjp_plain(new1, new2, y, y1, ct_prev, ct, lam_h, g_y, g_y1,
                       g_ctp, g_ct):
    """csrc/kerr_surface_vjp.cuh:kerr_hit_vjp where a slot was filled ->
    (the six hit cotangents with the filled slot's zeroed, g_y, g_y1,
    g_ctp, g_ct)."""
    (g_rh, g_phh, _), hits = take_hit_cotangent(new1, new2, lam_h)
    new = new1 | new2
    zero = torch.zeros_like(ct)
    g_y, g_y1 = list(g_y), list(g_y1)
    cf = crossing_frac(ct_prev, ct)
    frac = cf[4]
    g_frac = g_rh * (y1[0] - y[0]) + g_phh * (y1[2] - y[2])
    g_y1[0] = g_y1[0] + torch.where(new, frac * g_rh, zero)
    g_y1[2] = g_y1[2] + torch.where(new, frac * g_phh, zero)
    g_y[0] = g_y[0] + torch.where(new, (1.0 - frac) * g_rh, zero)
    g_y[2] = g_y[2] + torch.where(new, (1.0 - frac) * g_phh, zero)
    gz0, gz1 = crossing_frac_vjp(cf, ct_prev, ct, g_frac)
    return (hits, g_y, g_y1, g_ctp + torch.where(new, gz0, zero),
            g_ct + torch.where(new, gz1, zero))


def kerr_rk4_disk_vjp_plain(row, E, L, y5, ct_prev, new1, new2, lam, g=None,
                            act=None):
    """csrc/kerr_surface_vjp.cuh:kerr_rk4_disk_vjp: ``lam`` (12) is the
    cotangent of the state after the step at (y5, ct_prev), which filled
    the slots ``new1`` / ``new2`` -> (that before it (12), the per-ray sums
    ``g`` (5) with this step's terms added)."""
    zero = torch.zeros_like(y5[0])
    g = [zero] * N_THETA_DISK if g is None else list(g)
    _, y1 = _rk4_y1(row, E, L, y5)
    g_y1 = list(lam[:5])
    g_y = [zero] * 5
    hits, g_y, g_y1, g_ctp, g_ct = kerr_hit_vjp_plain(
        new1, new2, y5, y1, ct_prev, torch.cos(y1[1]), lam[6:12], g_y, g_y1,
        zero, lam[5])
    g_y1[1] = g_y1[1] + g_ct * (-torch.sin(y1[1]))
    lam5, g = ck.kerr_step5_vjp_plain(row, E, L, y5, g_y1, g, act,
                                      guard=True)
    return (*(a + b for a, b in zip(lam5, g_y)), g_ctp, *hits), list(g)


def kerr_rk4_vol_vjp_plain(flags, row, E, L, b_ph, y5, tau, lam, g=None,
                           act=None):
    """csrc/kerr_surface_vjp.cuh:kerr_rk4_vol_vjp: ``lam`` (9) is the
    cotangent of the state after the step at (y5, tau) -> (that before it
    (9), the per-ray sums ``g`` (n_theta) with this step's terms added)."""
    zero = torch.zeros_like(y5[0])
    sums = _Sums([zero] * n_theta(flags) if g is None else g, act)
    dte, y1 = _rk4_y1(row, E, L, y5)
    ok = _finite(y1)
    g5 = list(lam[:5])
    g_tau = lam[5]
    dtau, dem = kerr_vol_emission_plain(row, flags, y1[0], y1[1], b_ph, tau)
    g_dte = torch.where(ok, lam[5] * dtau + lam[6] * dem[0]
                        + lam[7] * dem[1] + lam[8] * dem[2], zero)
    g_dem = [dte * lam[6], dte * lam[7], dte * lam[8]]

    def add(k, term):
        sums.add(k, term, ok)

    g_r, g_th, g_bph, g_te = kerr_vol_emission_vjp_plain(
        flags, row, y1[0], y1[1], b_ph, tau, dte * lam[5], g_dem, add)
    g5[0] = g5[0] + torch.where(ok, g_r, zero)
    g5[1] = g5[1] + torch.where(ok, g_th, zero)
    g_tau = g_tau + torch.where(ok, g_te, zero)
    add(4, g_bph / E)
    add(3, -g_bph * b_ph / E)
    lam5, g5sum = ck.kerr_step5_vjp_plain(row, E, L, y5, g5, sums.g[:5], act,
                                          guard=True, g_dte_in=g_dte)
    sums.g[:5] = list(g5sum)
    return (*lam5, g_tau, *lam[6:9]), sums.g


def _write_back(t, lam):
    """The write-back's cotangents: (those of the trial y1, of the start
    y) from those of the written-back state."""
    acc = t["accept"]
    zero = torch.zeros_like(t["dt"])
    return ([torch.where(acc, lam[c], zero) for c in range(5)],
            [torch.where(acc, zero, lam[c]) for c in range(5)])


def kerr_rk45_disk_vjp_plain(row, E, L, y5, dt, ct_prev, new1, new2, lam,
                             freeze=False, g=None, act=None):
    """csrc/kerr_surface_vjp.cuh:kerr_rk45_disk_vjp: ``lam`` (13) is the
    cotangent of the state after the iteration at (y5, dt, ct_prev), which
    filled the slots ``new1`` / ``new2`` -> (that before it (13), the
    per-ray sums ``g`` (5) with this iteration's terms added)."""
    t = ck.kerr_rk45_trial_plain(row, E, L, list(y5), dt)
    acc = t["accept"]
    zero = torch.zeros_like(dt)
    g = [zero] * N_THETA_DISK if g is None else list(g)
    g_y1, g_y = _write_back(t, lam)
    g_ct = torch.where(acc, lam[6], zero)
    g_ctp = torch.where(acc, zero, lam[6])
    g_dt, g_err = zero, zero
    if not freeze:
        term = ck.kerr_rk45_terminal_plain(row, t)
        g_next = lam[5]
        rn = torch.where(acc, t["y1"][0], y5[0])
        near = ~term & (rn < row[7] + 2.0 * row[2])
        g_next = torch.where(near, g_next * _max_share(
            row[0], ck.kerr_rk45_next_dt_plain(row, t)), g_next)
        g_y, g_y1, g_dt, g_err = ck.kerr_rk45_next_vjp_plain(
            row, t, term, g_next, g_y, g_y1)
    hits, g_y, g_y1, g_ctp, g_ct = kerr_hit_vjp_plain(
        new1, new2, y5, t["y1"], ct_prev, torch.cos(t["y1"][1]), lam[7:13],
        g_y, g_y1, g_ctp, g_ct)
    g_y1[1] = g_y1[1] + torch.where(acc, g_ct * (-torch.sin(t["y1"][1])),
                                    zero)
    lam6, g = ck.kerr_rk45_trial_vjp_plain(row, E, L, t, g_err, g_y, g_y1,
                                           g_dt, g, act)
    return (*lam6, g_ctp, *hits), list(g)


def kerr_rk45_vol_vjp_plain(flags, row, E, L, b_ph, y5, dt, tau, lam,
                            freeze=False, g=None, act=None):
    """csrc/kerr_surface_vjp.cuh:kerr_rk45_vol_vjp: ``lam`` (10) is the
    cotangent of the state after the iteration at (y5, dt, tau) -> (that
    before it (10), the per-ray sums ``g`` (n_theta) with this iteration's
    terms added)."""
    t = ck.kerr_rk45_trial_plain(row, E, L, list(y5), dt)
    acc = t["accept"]
    zero = torch.zeros_like(dt)
    sums = _Sums([zero] * n_theta(flags) if g is None else g, act)
    g_y1, g_y = _write_back(t, lam)
    gate = acc & _finite(t["y1"])
    dtau, dem = kerr_vol_emission_plain(row, flags, t["y1"][0], t["y1"][1],
                                        b_ph, tau)
    tau1 = torch.where(gate, tau + dt * dtau, tau)
    g_dt, g_err, g_tau = zero, zero, lam[6]
    if not freeze:
        term = ck.kerr_rk45_terminal_plain(row, t) | (tau1 > row[TAU_MAX])
        live = ~term
        g_next = lam[5]
        rn = torch.where(acc, t["y1"][0], y5[0])
        thn = torch.where(acc, t["y1"][1], y5[1])
        nxt = ck.kerr_rk45_next_dt_plain(row, t)
        sn, cn = torch.sin(thn), torch.cos(thn)
        s_th = torch.abs(sn)
        r_cyl = rn * s_th
        gap_r = r_cyl - (row[7] + 2.0 * row[2])
        sh2 = torch.sqrt(row[VOL_BLOCK_KERR])
        h_rel5 = 5.0 * sh2
        gap_z = rn * torch.abs(cn) - h_rel5 * r_cyl
        lim_raw = 0.5 * torch.maximum(gap_r, gap_z)
        lim = torch.maximum(row[0], lim_raw)
        g_lim = g_next * _max_share(nxt, lim)
        g_next = torch.where(live, g_next * _max_share(lim, nxt), g_next)
        g_gap = 0.5 * (g_lim * _max_share(lim_raw, row[0]))
        s_r = _max_share(gap_r, gap_z)
        g_gr, g_gz = g_gap * s_r, g_gap * (1.0 - s_r)
        g_rcyl = g_gr
        sums.add(TH_ROUT, -g_gr, live)
        sums.add(0, -2.0 * g_gr, live)
        g_rn = g_gz * torch.abs(cn)
        g_thn = g_gz * rn * torch.sign(cn) * (-sn)
        g_rcyl = g_rcyl + -g_gz * h_rel5
        sums.add(TH_SLOTS, -g_gz * r_cyl * 5.0 * 0.5 / sh2, live)
        g_rn = g_rn + g_rcyl * s_th
        g_thn = g_thn + g_rcyl * rn * torch.sign(sn) * cn
        on1, on0 = live & acc, live & ~acc
        g_y1[0] = g_y1[0] + torch.where(on1, g_rn, zero)
        g_y1[1] = g_y1[1] + torch.where(on1, g_thn, zero)
        g_y[0] = g_y[0] + torch.where(on0, g_rn, zero)
        g_y[1] = g_y[1] + torch.where(on0, g_thn, zero)
        g_y, g_y1, g_dt, g_err = ck.kerr_rk45_next_vjp_plain(
            row, t, term, g_next, g_y, g_y1)
    g_dt = g_dt + torch.where(gate, lam[6] * dtau + lam[7] * dem[0]
                              + lam[8] * dem[1] + lam[9] * dem[2], zero)
    g_dem = [dt * lam[7], dt * lam[8], dt * lam[9]]

    def add(k, term_):
        sums.add(k, term_, gate)

    g_r, g_th, g_bph, g_te = kerr_vol_emission_vjp_plain(
        flags, row, t["y1"][0], t["y1"][1], b_ph, tau, dt * lam[6], g_dem,
        add)
    g_y1[0] = g_y1[0] + torch.where(gate, g_r, zero)
    g_y1[1] = g_y1[1] + torch.where(gate, g_th, zero)
    g_tau = g_tau + torch.where(gate, g_te, zero)
    add(4, g_bph / E)
    add(3, -g_bph * b_ph / E)
    lam6, g5 = ck.kerr_rk45_trial_vjp_plain(row, E, L, t, g_err, g_y, g_y1,
                                            g_dt, sums.g[:5], act)
    sums.g[:5] = list(g5)
    return (*lam6, g_tau, *lam[7:10]), sums.g


# ------------------------------------------------------- plain kernel pair

def _check(family, flags, scal):
    if family not in FAMILIES:
        raise ValueError(f"unknown Kerr family {family!r}: one of "
                         f"{FAMILIES}")
    if flags is not None and len(flags) != 3:
        raise ValueError("flags: None (thin disk) or (blackbody, beaming, "
                         "scatter)")
    want = row_length(family, flags)
    if len(scal) != want:
        raise ValueError(f"the {family} {'disk' if flags is None else 'gas'}"
                         f" family takes a {want}-float row, got {len(scal)}")


def start_state(family, flags, scal, y0):
    """The replay's start: the spawn state (5), then dt0 (DP5(4)), then
    (cos theta0, 0 x 6) (disk) or zeros (gas)."""
    r = y0[0]
    zero = torch.zeros_like(r)
    y = list(y0)
    if family == "rk45":
        y.append(torch.ones_like(r) * torch.tensor(
            scal[0], dtype=r.dtype, device=r.device))
    if flags is None:
        y += [torch.cos(y0[1])] + [zero] * 6
    else:
        y += [zero] * 4
    return tuple(y)


def _stepper(family, flags, row, E, L, b_ph):
    if family == "rk4":
        return lambda y: kerr_rk4_surface_step_plain(flags, row, E, L, b_ph,
                                                     y)
    return lambda y: kerr_rk45_surface_iter_plain(flags, row, E, L, b_ph, y)


def ckpt_kerr_surface_gen_plain(family, flags, scal, y0, E, L, counts, *,
                                seg, offsets, total):
    """Plain version of kernel #9's Kerr surface variant: the masked march
    of ``counts[i]`` steps (iterations) from ``start_state`` writing each
    ray's segment starts into the compacted (total, n_state) buffer ->
    (ckpt, final state (n_state, n))."""
    row = ck.row_tensor(scal, E)
    step = _stepper(family, flags, row, E, L, L / E)
    y = start_state(family, flags, scal, y0)
    ckpt = torch.zeros((total, n_state(family, flags)), dtype=E.dtype,
                       device=E.device)
    n_seg = -(-int(counts.max()) // seg) if counts.numel() else 0
    for s in range(n_seg):
        has = s * seg < counts
        ckpt[offsets[has] + s] = torch.stack(y, 1)[has]
        for k in range(seg):
            act = s * seg + k < counts
            y1 = step(y)[0]
            y = tuple(torch.where(act, a1, a0) for a0, a1 in zip(y, y1))
    return ckpt, torch.stack(y)


def ckpt_kerr_surface_bwd_plain(family, flags, scal, ckpt, E, L, counts, cot,
                                *, seg, offsets, freeze=False):
    """Plain version of kernel #10's Kerr surface variant: each segment,
    last to first, re-marched from its checkpoint and pulled back through
    its steps with the plain VJPs -> (per-ray theta cotangents (n_theta,
    n), lam (n_state, n)).  A step at or past a ray's count is the
    identity."""
    row = ck.row_tensor(scal, E)
    b_ph = L / E
    step = _stepper(family, flags, row, E, L, b_ph)
    ns = n_state(family, flags)
    lam = tuple(cot)
    g = [torch.zeros_like(E) for _ in range(n_theta(flags))]
    n_seg = -(-int(counts.max()) // seg) if counts.numel() else 0
    for s in range(n_seg - 1, -1, -1):
        has = s * seg < counts
        rows = ckpt[torch.where(has, offsets + s, 0)]
        y = tuple(rows[:, c] for c in range(ns))
        starts = []
        for _ in range(seg):
            y1, new1, new2 = step(y)
            starts.append((y, new1, new2))
            y = y1
        for k in range(seg - 1, -1, -1):
            act = s * seg + k < counts
            yk, new1, new2 = starts[k]
            y5 = yk[:5]
            if family == "rk4" and flags is None:
                new, g = kerr_rk4_disk_vjp_plain(row, E, L, y5, yk[5], new1,
                                                 new2, lam, g, act)
            elif family == "rk4":
                new, g = kerr_rk4_vol_vjp_plain(flags, row, E, L, b_ph, y5,
                                                yk[5], lam, g, act)
            elif flags is None:
                new, g = kerr_rk45_disk_vjp_plain(row, E, L, y5, yk[5],
                                                  yk[6], new1, new2, lam,
                                                  freeze, g, act)
            else:
                new, g = kerr_rk45_vol_vjp_plain(flags, row, E, L, b_ph, y5,
                                                 yk[5], yk[6], lam, freeze,
                                                 g, act)
            lam = tuple(torch.where(act, a1, a0) for a0, a1 in zip(lam, new))
    return torch.stack(g), torch.stack(lam)


# ------------------------------------------------------------ the kernels

def _key(family, kind):
    return f"kerr_surface{'_rk45' if family == 'rk45' else ''}_{kind}"


def launch_gen(family, flags, scal, y0, E, L, counts, *, seg, offsets,
               total):
    """Kernel #9's Kerr surface variant on flat contiguous CUDA tensors of
    one device (float32 rays, int32 counts, int64 offsets) -> (the (total,
    n_state) checkpoint buffer, the final state (n_state, n))."""
    _check(family, flags, scal)
    n = E.numel()
    ck._check_rays(n, *y0, E, L)
    if counts.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError("counts must be int32 and offsets int64")
    ns = n_state(family, flags)
    dev = E.device
    ckpt = torch.empty((max(total, 1), ns), dtype=torch.float32, device=dev)
    final = torch.empty((ns, n), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = (lib.curvis_ckpt_kerr_surface_gen if family == "rk4"
          else lib.curvis_ckpt_kerr_surface_rk45_gen)
    err = fn(int(flags is not None), flag_mask(flags), row, len(scal),
             *(t.data_ptr() for t in y0), E.data_ptr(), L.data_ptr(),
             counts.data_ptr(), offsets.data_ptr(), ckpt.data_ptr(),
             final.data_ptr(), n, seg, dev.index, stream)
    key = _key(family, "gen")
    _build.check(lib, err, f"ckpt_{key}_kernel")
    launches[key] += 1
    return ckpt, final


def launch_bwd(family, flags, scal, ckpt, E, L, counts, cot, *, seg,
               offsets, freeze=False):
    """Kernel #10's Kerr surface variant on the buffer of ``launch_gen``
    and the (n_state, n) cotangent ``cot`` -> (per-ray theta cotangents
    (n_theta, n), lam (n_state, n))."""
    _check(family, flags, scal)
    n = E.numel()
    ck._check_rays(n, E, L)
    ns, nt = n_state(family, flags), n_theta(flags)
    dev = E.device
    if cot.dtype != torch.float32 or cot.shape != (ns, n) \
            or not cot.is_contiguous():
        raise ValueError(f"bad cotangent {tuple(cot.shape)}")
    if ckpt.dtype != torch.float32 or ckpt.shape[1:] != (ns,) \
            or not ckpt.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ckpt.shape)}")
    lam = torch.empty((ns, n), dtype=torch.float32, device=dev)
    g = torch.empty((nt, n), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    row = _build.host_floats(scal)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (ckpt.data_ptr(), E.data_ptr(), L.data_ptr(), counts.data_ptr(),
            offsets.data_ptr(), cot.data_ptr(), lam.data_ptr(), g.data_ptr(),
            n, seg, dev.index, stream)
    head = (int(flags is not None), flag_mask(flags), row, len(scal))
    if family == "rk4":
        err = lib.curvis_ckpt_kerr_surface_bwd(*head, *ptrs)
    else:
        err = lib.curvis_ckpt_kerr_surface_rk45_bwd(*head, int(bool(freeze)),
                                                    *ptrs)
    key = _key(family, "bwd")
    _build.check(lib, err, f"ckpt_{key}_kernel")
    launches[key] += 1
    return g, lam


def ckpt_kerr_surface_backward_cuda(family, flags, scal, y0, E, L, counts,
                                    cot, *, freeze=False):
    """Exact pullback of the masked surface march of ``family`` / ``flags``
    with the march kernel's row ``scal``: ray i takes ``counts[i]`` steps
    (RK4) or iterations (DP5(4)) from ``start_state`` of its spawn state
    ``y0`` (5); ``cot`` is the (n_state, n) cotangent of the final state ->
    ``(g_theta (n_theta, n), lam (n_state, n))``, lam the cotangent of the
    start.  CUDA tensors run kernels #9 / #10, CPU tensors their plain
    versions."""
    _check(family, flags, scal)
    seg = SEG[family]
    if scal[0] <= 0.0:
        raise ValueError("dt must be positive")
    offsets, total = segment_offsets(counts, seg)
    dev = E.device
    if total == 0:
        return (torch.zeros((n_theta(flags), E.numel()), dtype=E.dtype,
                            device=dev), cot.clone())
    if dev.type == "cpu":
        ckpt, _ = ckpt_kerr_surface_gen_plain(family, flags, scal, y0, E, L,
                                              counts, seg=seg,
                                              offsets=offsets, total=total)
        return ckpt_kerr_surface_bwd_plain(family, flags, scal, ckpt, E, L,
                                           counts, cot, seg=seg,
                                           offsets=offsets, freeze=freeze)
    if dev.type != "cuda":
        raise ValueError(f"ckpt_kerr_surface_backward_cuda: unsupported "
                         f"device {dev}")
    ckpt, _ = launch_gen(family, flags, scal, y0, E, L, counts, seg=seg,
                         offsets=offsets, total=total)
    return launch_bwd(family, flags, scal, ckpt, E, L, counts, cot, seg=seg,
                      offsets=offsets, freeze=freeze)
