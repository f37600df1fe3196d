"""Measured-BSDF evaluation / sampling / pdf on device (JAX, batched).

Port of the reference's MBSDF device runtime
(``df_bsdf_measurement_evaluate/sample/pdf/albedos``,
``nrc/shaders/texture_lookup.h:887-1253``): the CUDA 3D texture with
normalized coords + linear filtering becomes an explicit trilinear
gather+lerp over the stacked scene tables; the per-thread binary CDF
searches become vectorized compare-and-sum over the [R]/[P] rows elementwise.

Angle convention (matches the reference): directions as (theta, phi) in the
local shading frame, theta in [0, pi/2] measured from the surface normal of
the part's hemisphere, phi in [-pi, pi]. Isotropy: only
``phi_delta = phi_out - phi_in`` folded into [0, pi] enters the data
(``bsdf_compute_uvw``, texture_lookup.h:925-944).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.math import build_onb, dot, normalize

M_PI = float(np.pi)

PART_REFLECTION = 0
PART_TRANSMISSION = 1


class MBSDFTables(NamedTuple):
    """Stacked device tables of all measurements in a scene
    (``scene/mbsdf.MBSDFTableHost`` uploaded)."""

    eval_data: jnp.ndarray   # [M, 2, R(th_in), R(th_out), P(phi), 3]
    cdf_theta: jnp.ndarray   # [M, 2, R, R]
    cdf_phi: jnp.ndarray     # [M, 2, R, R, P]
    albedo: jnp.ndarray      # [M, 2, R]
    max_albedo: jnp.ndarray  # [M, 2]
    has_part: jnp.ndarray    # [M, 2] f32

    @property
    def res_theta(self) -> int:
        return self.eval_data.shape[2]

    @property
    def res_phi(self) -> int:
        return self.eval_data.shape[4]


def _fold_phi_delta(phi_out: jnp.ndarray, phi_in: jnp.ndarray) -> jnp.ndarray:
    """phi_out - phi_in folded into [0, pi] -> u in [0, 1]
    (``bsdf_compute_uvw``, texture_lookup.h:925-944)."""
    u = phi_out - phi_in
    u = jnp.where(u < 0.0, u + 2.0 * M_PI, u)
    u = jnp.where(u > M_PI, 2.0 * M_PI - u, u)
    return u / M_PI


def _axis_lerp(c: jnp.ndarray, size: int):
    """CUDA normalized-coordinate linear filtering: texel centers at
    (i + 0.5)/size, clamp addressing."""
    x = c * size - 0.5
    i0 = jnp.floor(x)
    f = x - i0
    i0 = jnp.clip(i0.astype(jnp.int32), 0, size - 1)
    i1 = jnp.clip(i0 + 1, 0, size - 1)
    return i0, i1, f


def mbsdf_evaluate(
    tables: MBSDFTables,
    idx: jnp.ndarray,         # [N] i32 measurement index
    part: jnp.ndarray,        # [N] i32 0/1
    theta_phi_in: jnp.ndarray,   # [N, 2]
    theta_phi_out: jnp.ndarray,  # [N, 2]
) -> jnp.ndarray:
    """Trilinear lookup of the symmetrized eval volume -> [N, 3]
    (``df_bsdf_measurement_evaluate``, texture_lookup.h:959-995)."""
    r, p = tables.res_theta, tables.res_phi
    u = _fold_phi_delta(theta_phi_out[..., 1], theta_phi_in[..., 1])
    v = theta_phi_out[..., 0] * (2.0 / M_PI)
    w = theta_phi_in[..., 0] * (2.0 / M_PI)
    ui0, ui1, uf = _axis_lerp(u, p)
    vi0, vi1, vf = _axis_lerp(v, r)
    wi0, wi1, wf = _axis_lerp(w, r)

    def tex(wi_, vi_, ui_):
        return tables.eval_data[idx, part, wi_, vi_, ui_]

    c00 = tex(wi0, vi0, ui0) * (1 - uf[..., None]) + tex(wi0, vi0, ui1) * uf[..., None]
    c01 = tex(wi0, vi1, ui0) * (1 - uf[..., None]) + tex(wi0, vi1, ui1) * uf[..., None]
    c10 = tex(wi1, vi0, ui0) * (1 - uf[..., None]) + tex(wi1, vi0, ui1) * uf[..., None]
    c11 = tex(wi1, vi1, ui0) * (1 - uf[..., None]) + tex(wi1, vi1, ui1) * uf[..., None]
    c0 = c00 * (1 - vf[..., None]) + c01 * vf[..., None]
    c1 = c10 * (1 - vf[..., None]) + c11 * vf[..., None]
    out = c0 * (1 - wf[..., None]) + c1 * wf[..., None]
    ok = tables.has_part[idx, part] > 0.0
    return jnp.where(ok[..., None], out, 0.0)


def _sample_cdf(rows: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Vectorized ``sample_cdf`` (texture_lookup.h:634-658): smallest index
    m with xi < cdf[m]; equals count of entries <= xi, clamped."""
    n = rows.shape[-1]
    return jnp.clip(
        jnp.sum((rows <= xi[..., None]).astype(jnp.int32), axis=-1), 0, n - 1
    )


def mbsdf_sample(
    tables: MBSDFTables,
    idx: jnp.ndarray,            # [N]
    part: jnp.ndarray,           # [N]
    theta_phi_out: jnp.ndarray,  # [N, 2] outgoing (toward camera)
    xi: jnp.ndarray,             # [N, 2] uniforms
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-stage CDF inversion -> (theta [N], phi [N], pdf [N])
    (``df_bsdf_measurement_sample``, texture_lookup.h:998-1106). A negative
    theta means absorption (missing part)."""
    r, p = tables.res_theta, tables.res_phi
    inv_r, inv_p = 1.0 / r, 1.0 / p
    s_theta = (M_PI / 2) * inv_r
    s_phi = M_PI * inv_p

    # theta_in bin from the outgoing direction (BSDF symmetry)
    i_tin = jnp.clip(
        (theta_phi_out[..., 0] * (2.0 / M_PI) * r).astype(jnp.int32), 0, r - 1
    )

    # stage 1: theta_out
    xi0 = xi[..., 0]
    cdf_t = tables.cdf_theta[idx, part, i_tin]        # [N, R]
    i_tout = _sample_cdf(cdf_t, xi0)
    above = jnp.take_along_axis(cdf_t, i_tout[..., None], -1)[..., 0]
    below = jnp.where(
        i_tout > 0,
        jnp.take_along_axis(
            cdf_t, jnp.maximum(i_tout - 1, 0)[..., None], -1
        )[..., 0],
        0.0,
    )
    prob_theta = above - below
    xi0 = (xi0 - below) / jnp.maximum(prob_theta, 1e-12)

    # stage 2: phi (half circle, mirrored with probability 0.5)
    xi1 = xi[..., 1]
    flip = xi1 > 0.5
    xi1 = jnp.where(flip, 1.0 - xi1, xi1) * 2.0
    cdf_p = tables.cdf_phi[idx, part, i_tin, i_tout]  # [N, P]
    i_phi = _sample_cdf(cdf_p, xi1)
    above_p = jnp.take_along_axis(cdf_p, i_phi[..., None], -1)[..., 0]
    below_p = jnp.where(
        i_phi > 0,
        jnp.take_along_axis(
            cdf_p, jnp.maximum(i_phi - 1, 0)[..., None], -1
        )[..., 0],
        0.0,
    )
    prob_phi = above_p - below_p
    xi1 = (xi1 - below_p) / jnp.maximum(prob_phi, 1e-12)

    # continuous positions: cos-interpolated theta within its bin, the
    # rescaled leftovers cross-reused exactly as the reference does
    # (texture_lookup.h:1077-1086)
    cos0 = jnp.cos(i_tout.astype(jnp.float32) * s_theta)
    cos1 = jnp.cos((i_tout + 1).astype(jnp.float32) * s_theta)
    cos_theta = cos0 * (1.0 - xi1) + cos1 * xi1
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    phi = (i_phi.astype(jnp.float32) + xi0) * s_phi
    phi = jnp.where(flip, 2.0 * M_PI - phi, phi)

    # align to the outgoing phi (texture_lookup.h:1092-1101)
    phi_out = theta_phi_out[..., 1]
    phi = phi + jnp.where(phi_out > 0.0, phi_out, 2.0 * M_PI + phi_out)
    phi = jnp.where(phi > 2.0 * M_PI, phi - 2.0 * M_PI, phi)
    phi = jnp.where(phi > M_PI, phi - 2.0 * M_PI, phi)  # -> [-pi, pi]

    pdf = prob_theta * prob_phi * 0.5 / jnp.maximum(
        s_phi * (cos0 - cos1), 1e-12
    )
    ok = tables.has_part[idx, part] > 0.0
    return (
        jnp.where(ok, theta, -1.0),
        jnp.where(ok, phi, -1.0),
        jnp.where(ok, pdf, 0.0),
    )


def mbsdf_pdf(
    tables: MBSDFTables,
    idx: jnp.ndarray,
    part: jnp.ndarray,
    theta_phi_in: jnp.ndarray,
    theta_phi_out: jnp.ndarray,
) -> jnp.ndarray:
    """Sampling pdf of direction ``theta_phi_in`` (the sampled one) given
    ``theta_phi_out`` (the known one) — the quantity ``mbsdf_sample``
    reports (``df_bsdf_measurement_pdf``, texture_lookup.h:1109-1177; the
    reference names its arguments the other way around but conditions its
    CDF rows on the known direction exactly as here)."""
    r, p = tables.res_theta, tables.res_phi
    s_theta = (M_PI / 2) / r
    s_phi = M_PI / p
    u = _fold_phi_delta(theta_phi_out[..., 1], theta_phi_in[..., 1])
    i_tin = jnp.clip(
        (theta_phi_in[..., 0] * (2.0 / M_PI) * r).astype(jnp.int32), 0, r - 1
    )
    i_tout = jnp.clip(
        (theta_phi_out[..., 0] * (2.0 / M_PI) * r).astype(jnp.int32), 0, r - 1
    )
    i_phi = jnp.clip((u * p).astype(jnp.int32), 0, p - 1)

    cdf_t = tables.cdf_theta[idx, part, i_tout]  # conditioned on the out dir
    above = jnp.take_along_axis(cdf_t, i_tin[..., None], -1)[..., 0]
    below = jnp.where(
        i_tin > 0,
        jnp.take_along_axis(
            cdf_t, jnp.maximum(i_tin - 1, 0)[..., None], -1
        )[..., 0],
        0.0,
    )
    prob_theta = above - below

    cdf_p = tables.cdf_phi[idx, part, i_tout, i_tin]
    above_p = jnp.take_along_axis(cdf_p, i_phi[..., None], -1)[..., 0]
    below_p = jnp.where(
        i_phi > 0,
        jnp.take_along_axis(
            cdf_p, jnp.maximum(i_phi - 1, 0)[..., None], -1
        )[..., 0],
        0.0,
    )
    prob_phi = above_p - below_p

    cos0 = jnp.cos(i_tin.astype(jnp.float32) * s_theta)
    cos1 = jnp.cos((i_tin + 1).astype(jnp.float32) * s_theta)
    pdf = prob_theta * prob_phi * 0.5 / jnp.maximum(
        s_phi * (cos0 - cos1), 1e-12
    )
    ok = tables.has_part[idx, part] > 0.0
    return jnp.where(ok, pdf, 0.0)


def mbsdf_albedos(
    tables: MBSDFTables, idx: jnp.ndarray, theta_phi: jnp.ndarray
) -> jnp.ndarray:
    """[N, 4]: (albedo_refl(theta), max_refl, albedo_trans(theta), max_trans)
    (``df_bsdf_measurement_albedos``, texture_lookup.h:1211-1253)."""
    r = tables.res_theta
    i_t = jnp.clip(
        (theta_phi[..., 0] * (2.0 / M_PI) * r).astype(jnp.int32), 0, r - 1
    )
    a_r = tables.albedo[idx, PART_REFLECTION, i_t] * tables.has_part[idx, 0]
    a_t = tables.albedo[idx, PART_TRANSMISSION, i_t] * tables.has_part[idx, 1]
    m_r = tables.max_albedo[idx, PART_REFLECTION] * tables.has_part[idx, 0]
    m_t = tables.max_albedo[idx, PART_TRANSMISSION] * tables.has_part[idx, 1]
    return jnp.stack([a_r, m_r, a_t, m_t], axis=-1)


# ---------------------------------------------------------------------------
# Archetype-level wrappers (the role MDL's libbsdf measured_bsdf plays in the
# generated sample/evaluate direct callables)
# ---------------------------------------------------------------------------

def _local_angles(w: jnp.ndarray, t, b, n) -> jnp.ndarray:
    """World direction -> (theta from |n|, phi) in the (t, b, n) frame,
    theta folded to [0, pi/2] (parts live on separate hemispheres)."""
    z = dot(w, n)
    x = dot(w, t)
    y = dot(w, b)
    theta = jnp.arccos(jnp.clip(jnp.abs(z), 0.0, 1.0))
    phi = jnp.arctan2(y, x)
    return jnp.stack([theta, phi], axis=-1)


def measured_sample(
    tables: MBSDFTables,
    idx: jnp.ndarray,         # [N] measurement index (>=0)
    multiplier: jnp.ndarray,  # [N]
    wo: jnp.ndarray,          # [N, 3] toward camera
    nf: jnp.ndarray,          # [N, 3] normal oriented to the wo side
    xi: jnp.ndarray,          # [N, 3] uniforms
):
    """Sample the measured BSDF: choose part by directional albedo, invert
    the two-stage CDF, evaluate the volume. Returns
    (wi, bsdf_over_pdf, pdf, is_transmission, ok)."""
    t, b = build_onb(nf)
    tpo = _local_angles(wo, t, b, nf)

    alb = mbsdf_albedos(tables, idx, tpo)
    a_r, a_t = alb[..., 0], alb[..., 2]
    total = a_r + a_t
    p_refl = jnp.where(total > 0.0, a_r / jnp.maximum(total, 1e-30), 1.0)
    choose_trans = xi[..., 2] >= p_refl
    part = jnp.where(choose_trans, PART_TRANSMISSION, PART_REFLECTION)
    p_part = jnp.where(choose_trans, 1.0 - p_refl, p_refl)

    theta, phi, pdf = mbsdf_sample(tables, idx, part, tpo, xi[..., :2])
    ok = (theta >= 0.0) & (pdf > 0.0) & (total > 0.0)
    pdf = pdf * p_part

    st = jnp.sin(theta)
    z = jnp.cos(theta)
    local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), z], axis=-1)
    hemi = jnp.where(choose_trans, -1.0, 1.0)
    wi = normalize(
        local[..., 0:1] * t + local[..., 1:2] * b
        + (local[..., 2:3] * hemi[..., None]) * nf
    )

    tpi = jnp.stack([theta, phi], axis=-1)
    f = mbsdf_evaluate(tables, idx, part, tpi, tpo) * multiplier[..., None]
    cos_i = jnp.clip(z, 0.0, 1.0)
    w = f * (cos_i / jnp.maximum(pdf, 1e-12))[..., None]
    w = jnp.where(ok[..., None], w, 0.0)
    pdf = jnp.where(ok, pdf, 0.0)
    return wi, w, pdf, choose_trans, ok


def measured_aux(
    tables: MBSDFTables,
    idx: jnp.ndarray,
    multiplier: jnp.ndarray,
    wo: jnp.ndarray,
    nf: jnp.ndarray,
) -> jnp.ndarray:
    """Approximate directional albedo [N, 3] for the radiance-query
    features (the role of MDL's auxiliary albedo output): the sampling
    albedo table accumulates f(i,o)+f(o,i) over the hemisphere, so half of
    it estimates the max-channel directional albedo."""
    t, b = build_onb(nf)
    tpo = _local_angles(wo, t, b, nf)
    alb = mbsdf_albedos(tables, idx, tpo)
    a = 0.5 * (alb[..., 0] + alb[..., 2]) * multiplier
    return jnp.clip(a, 0.0, 1.0)[..., None] * jnp.ones((3,), a.dtype)


def measured_eval(
    tables: MBSDFTables,
    idx: jnp.ndarray,
    multiplier: jnp.ndarray,
    wo: jnp.ndarray,
    wi: jnp.ndarray,
    nf: jnp.ndarray,
):
    """Evaluate f*|cos_i| and the sample pdf for NEE/MIS. Part selected by
    the hemisphere of wi relative to the oriented normal."""
    t, b = build_onb(nf)
    tpo = _local_angles(wo, t, b, nf)
    tpi = _local_angles(wi, t, b, nf)
    cos_i = dot(wi, nf)
    is_trans = cos_i < 0.0
    part = jnp.where(is_trans, PART_TRANSMISSION, PART_REFLECTION)

    f = mbsdf_evaluate(tables, idx, part, tpi, tpo) * multiplier[..., None]
    pdf = mbsdf_pdf(tables, idx, part, tpi, tpo)

    alb = mbsdf_albedos(tables, idx, tpo)
    a_r, a_t = alb[..., 0], alb[..., 2]
    total = a_r + a_t
    p_refl = jnp.where(total > 0.0, a_r / jnp.maximum(total, 1e-30), 1.0)
    p_part = jnp.where(is_trans, 1.0 - p_refl, p_refl)
    pdf = pdf * p_part

    fcos = f * jnp.abs(cos_i)[..., None]
    ok = total > 0.0
    return jnp.where(ok[..., None], fcos, 0.0), jnp.where(ok, pdf, 0.0)
