"""The traced emission row of the volumetric disk (PyTorch).

Counterpart of ``build_vol_row`` in
``curvis_tpu/integrate/kerr_surface_adjoint.py``, the one piece of that
module the planar disk adjoints use.  The differentiable Kerr surfaces
themselves (the rest of it) are ROADMAP Queue 1 item 3.
"""
from __future__ import annotations

import math

import torch

from curvis_tpu_torch.ops.disk_vol_cuda import VOL_SLOT_NAMES

# the DiskParams fields that enter the volumetric march's row; the other
# differentiable keys (brightness, opacity, tint, albedo,
# starlight_scatter) act in the shading after the march
_ROW_KEYS = ("r_inner", "r_outer", "h_rel", "kappa", "t_peak",
             "emissivity_index", "spin_sign")


def build_vol_row(disk, disk_theta=None, *, dtype=torch.float32,
                  device=None):
    """The (10,) emission row [r_in, r_out, h2, inv_norm, kappa, tau_max,
    t_peak, emis_q, spin_sign, t_scale] of the volumetric marches (the
    order of ``ops/disk_vol_cuda.py:vol_param_slots`` after r_in, r_out),
    with torch ops, so that a tensor in ``disk_theta`` (overrides keyed by
    DiskParams field names) stays in the graph through the composite
    slots inv_norm and t_scale.  The row is built once per march, so the
    forward kernel's scalars and the backward's replay see the same
    values.  It is computed in float64 on the CPU, as ``vol_param_slots``
    computes it in Python floats, and then cast to ``dtype`` on
    ``device``: without overrides the two rows are equal."""
    from curvis_tpu_torch.render.disk import DIFF_DISK_KEYS
    over = disk_theta or {}
    unknown = set(over) - DIFF_DISK_KEYS
    if unknown:
        raise ValueError(f"disk_theta: non-differentiable or unknown keys "
                         f"{sorted(unknown)}")

    def get(name):
        v = over[name] if name in _ROW_KEYS and name in over \
            else getattr(disk, name)
        if torch.is_tensor(v):
            return v.to(device="cpu", dtype=torch.float64).reshape(())
        return torch.tensor(float(v), dtype=torch.float64)

    r_in, r_out = get("r_inner"), get("r_outer")
    h_rel = get("h_rel")
    t_peak = get("t_peak")
    rp = (49.0 / 36.0) * r_in                  # Shakura-Sunyaev peak radius
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    slots = dict(h2=h_rel * h_rel,
                 inv_norm=1.0 / (math.sqrt(2.0 * math.pi) * h_rel),
                 kappa=get("kappa"), tau_max=get("tau_max"), t_peak=t_peak,
                 emis_q=get("emissivity_index"), spin_sign=get("spin_sign"),
                 t_scale=t_peak / f_peak)
    # layout: the slot order of ops/disk_vol_cuda.py:vol_param_slots
    assert VOL_SLOT_NAMES == ("h2", "inv_norm", "kappa", "tau_max", "t_peak",
                              "emis_q", "spin_sign", "t_scale")
    row = torch.stack([r_in, r_out] + [slots[k] for k in VOL_SLOT_NAMES])
    return row.to(device=device, dtype=dtype)
