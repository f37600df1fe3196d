"""Chiang-style hair BSDF (R / TT / TRT + residual), fully batched.

Equivalent of MDL's ``df::chiang_hair_bsdf`` used by the
reference's hair materials (``data/mdl/bsdf_hair.mdl``; fiber shading state
built in ``__closesthit__curves``, ``hit.cu:1665-2046``). The model follows
"A Practical and Controllable Hair and Fur Model for Production Path
Tracing" (Chiang et al. 2016): longitudinal scattering with per-lobe
variance, trimmed-logistic azimuthal scattering, dielectric Fresnel at the
cuticle with tilt, and Beer-Lambert absorption along internal path lengths.

Conventions: the fiber frame has the tangent as the longitudinal axis;
``h`` in [-1, 1] is the normalized azimuthal offset of the incoming ray
across the fiber (derived from the hit geometry in the integrator).
Directions passed in are world-space; callers provide the fiber tangent and
the azimuthal frame vectors.

An optional diffuse lobe is linearly mixed in, matching MDL's
``diffuse_reflection_weight/tint`` parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..utils.math import safe_div

M_PI = float(np.pi)
P_MAX = 3  # R, TT, TRT + residual lobe
SQRT_PI_OVER_8 = float(np.sqrt(np.pi / 8.0))


class HairParams(NamedTuple):
    """Per-ray hair material parameters (gathered rows)."""

    sigma_a: jnp.ndarray        # [N, 3] fiber interior absorption
    ior: jnp.ndarray            # [N]
    beta_m: jnp.ndarray         # [N, 3] longitudinal roughness per lobe R/TT/TRT
    beta_n: jnp.ndarray         # [N, 3] azimuthal roughness per lobe
    cuticle_angle: jnp.ndarray  # [N] radians (alpha)
    diffuse_weight: jnp.ndarray  # [N]
    diffuse_tint: jnp.ndarray    # [N, 3]


def _i0(x):
    """Modified Bessel I0 (series, |x| moderate) — used via logI0 only."""
    val = jnp.ones_like(x)
    x2 = x * x
    term = jnp.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    """log I0(x), asymptotic for large x (PBRT-style robust form)."""
    ax = jnp.abs(x)
    large = ax > 12.0
    big = ax + 0.5 * (-jnp.log(2.0 * M_PI) + jnp.log(1.0 / jnp.maximum(ax, 1e-9))
                      + 1.0 / jnp.maximum(8.0 * ax, 1e-9))
    small = jnp.log(_i0(jnp.where(large, 0.0, x)))
    return jnp.where(large, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering Mp (Chiang Eq. 7, numerically robust)."""
    v = jnp.maximum(v, 1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = v <= 0.1
    mp_small = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + jnp.log(1.0 / (2.0 * v)))
    mp_big = safe_div(
        jnp.exp(-b) * _i0(a), 2.0 * v * jnp.sinh(1.0 / v)
    )
    return jnp.where(small_v, mp_small, mp_big)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / jnp.maximum(
        _logistic_cdf(b, s) - _logistic_cdf(a, s), 1e-9
    )


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * jnp.log(
        1.0 / jnp.maximum(u * k + _logistic_cdf(a, s), 1e-9) - 1.0
    )
    return jnp.clip(x, a, b)


def _phi(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * M_PI


def _wrap_phi(phi):
    """Wrap to [-pi, pi]."""
    return jnp.arctan2(jnp.sin(phi), jnp.cos(phi))


def _beta_to_v(beta_m):
    """Longitudinal roughness -> variance (Chiang Eq. to match beta intuition)."""
    t = 0.726 * beta_m + 0.812 * beta_m**2 + 3.7 * beta_m**20
    return t * t


def _beta_to_s(beta_n):
    """Azimuthal roughness -> logistic scale."""
    return SQRT_PI_OVER_8 * (
        0.265 * beta_n + 1.194 * beta_n**2 + 5.372 * beta_n**22
    )


class _Geom(NamedTuple):
    sin_to: jnp.ndarray
    cos_to: jnp.ndarray
    phi_o: jnp.ndarray
    gamma_o: jnp.ndarray
    sin_tt: jnp.ndarray   # refracted longitudinal
    cos_tt: jnp.ndarray
    gamma_t: jnp.ndarray
    transmittance: jnp.ndarray  # [N, 3] single full internal path
    f0: jnp.ndarray       # Fresnel at entry


def _fresnel(cos_i, eta):
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / jnp.maximum(eta * eta, 1e-9)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    rs = safe_div(cos_i - eta * cos_t, cos_i + eta * cos_t)
    rp = safe_div(eta * cos_i - cos_t, eta * cos_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


def _geometry(wo_l, h, params: HairParams) -> _Geom:
    """Shared longitudinal/azimuthal geometry. ``wo_l``: [N, 3] direction in
    the fiber frame (x = tangent, (y, z) = normal plane)."""
    sin_to = jnp.clip(wo_l[..., 0], -1.0, 1.0)
    cos_to = jnp.sqrt(jnp.maximum(1.0 - sin_to * sin_to, 0.0))
    phi_o = jnp.arctan2(wo_l[..., 2], wo_l[..., 1])
    gamma_o = jnp.arcsin(jnp.clip(h, -1.0, 1.0))

    eta = params.ior
    # refraction into the fiber (longitudinal)
    sin_tt = sin_to / eta
    cos_tt = jnp.sqrt(jnp.maximum(1.0 - sin_tt * sin_tt, 0.0))
    # modified azimuthal refraction (Chiang Eq. 6)
    etap = jnp.sqrt(jnp.maximum(eta * eta - sin_to * sin_to, 0.0)) / jnp.maximum(
        cos_to, 1e-9
    )
    sin_gt = jnp.clip(h / jnp.maximum(etap, 1e-9), -1.0, 1.0)
    cos_gt = jnp.sqrt(jnp.maximum(1.0 - sin_gt * sin_gt, 0.0))
    gamma_t = jnp.arcsin(sin_gt)

    # absorption along one internal crossing (Chiang Eq. 5)
    l_path = safe_div(2.0 * cos_gt, jnp.maximum(cos_tt, 1e-5))
    transmittance = jnp.exp(-params.sigma_a * l_path[..., None])

    f0 = _fresnel(cos_to * jnp.sqrt(jnp.maximum(1.0 - h * h, 0.0)), eta)
    return _Geom(sin_to, cos_to, phi_o, gamma_o, sin_tt, cos_tt, gamma_t,
                 transmittance, f0)


def _attenuations(g: _Geom):
    """Ap for p = 0..P_MAX (R, TT, TRT, residual). Returns [N, P_MAX+1, 3]."""
    f = g.f0[..., None]
    t = g.transmittance
    a0 = jnp.broadcast_to(f, t.shape)[:, None, :] * jnp.ones((1, 1, 1))
    a1 = ((1.0 - f) ** 2 * t)[:, None, :]
    a2 = ((1.0 - f) ** 2 * f * t * t)[:, None, :]
    # residual: geometric series remainder a2 * (f t)^k summed
    ft = f * t
    a3 = safe_div(a2[:, 0] * ft, jnp.maximum(1.0 - ft, 1e-5))[:, None, :]
    return jnp.concatenate([a0, a1, a2, a3], axis=1)


def _lobe_angles(g: _Geom, params: HairParams):
    """Cuticle-tilted (sin, cos) theta_o per lobe [N, 3lobes]; residual untilted."""
    alpha = params.cuticle_angle
    sin_a, cos_a = jnp.sin(alpha), jnp.cos(alpha)
    # 2^p-style tilts: R by -2a, TT by a, TRT by 4a (PBRT/Chiang convention)
    sin2a = 2.0 * sin_a * cos_a
    cos2a = cos_a * cos_a - sin_a * sin_a
    sin4a = 2.0 * sin2a * cos2a
    cos4a = cos2a * cos2a - sin2a * sin2a

    def rot(sin_to, cos_to, s, c):
        return sin_to * c + cos_to * s, cos_to * c - sin_to * s

    s0, c0 = rot(g.sin_to, g.cos_to, -sin2a, cos2a)   # R
    s1, c1 = rot(g.sin_to, g.cos_to, sin_a, cos_a)    # TT
    s2, c2 = rot(g.sin_to, g.cos_to, sin4a, cos4a)    # TRT
    sin_top = jnp.stack([s0, s1, s2, g.sin_to], axis=-1)
    cos_top = jnp.abs(jnp.stack([c0, c1, c2, g.cos_to], axis=-1))
    return sin_top, cos_top


def _variances(params: HairParams):
    v = _beta_to_v(params.beta_m)                      # [N, 3]
    v = jnp.concatenate([v, v[..., 2:3]], axis=-1)     # residual uses TRT's
    s = _beta_to_s(params.beta_n)
    s = jnp.concatenate([s, s[..., 2:3]], axis=-1)
    return v, s


def hair_eval(params: HairParams, wo_l, wi_l, h):
    """f * |cos_wi| and pdf for MIS. Directions in the fiber frame."""
    g = _geometry(wo_l, h, params)
    sin_ti = jnp.clip(wi_l[..., 0], -1.0, 1.0)
    cos_ti = jnp.sqrt(jnp.maximum(1.0 - sin_ti * sin_ti, 0.0))
    phi_i = jnp.arctan2(wi_l[..., 2], wi_l[..., 1])
    phi = phi_i - g.phi_o

    ap = _attenuations(g)                              # [N, 4, 3]
    sin_top, cos_top = _lobe_angles(g, params)         # [N, 4]
    v, s = _variances(params)                          # [N, 4]

    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top, v)  # [N,4]
    p_idx = jnp.arange(P_MAX, dtype=jnp.float32)
    dphi = _wrap_phi(
        phi[..., None] - _phi(p_idx, g.gamma_o[..., None], g.gamma_t[..., None])
    )
    np_az = _trimmed_logistic(dphi, s[..., :P_MAX], -M_PI, M_PI)  # [N, 3]
    np_all = jnp.concatenate(
        [np_az, jnp.full_like(np_az[..., :1], 1.0 / (2.0 * M_PI))], axis=-1
    )

    f_spec = jnp.sum(mp[..., None] * ap * np_all[..., None], axis=1)  # [N, 3]

    # lobe selection pdf by attenuation luminance
    ap_lum = jnp.mean(ap, axis=-1)
    ap_pdf = safe_div(ap_lum, jnp.maximum(jnp.sum(ap_lum, -1, keepdims=True), 1e-9))
    pdf_spec = jnp.sum(mp * np_all * ap_pdf, axis=-1)

    # optional diffuse lobe around the fiber normal plane (MDL mix)
    w = params.diffuse_weight[..., None]
    # diffuse over the full sphere, tinted; cos term vs the fiber normal at h
    f_diff = params.diffuse_tint / (4.0 * M_PI)
    f = (1.0 - w) * f_spec + w * f_diff
    pdf = (
        (1.0 - params.diffuse_weight) * pdf_spec
        + params.diffuse_weight * (1.0 / (4.0 * M_PI))
    )
    return f, pdf


def hair_sample(params: HairParams, wo_l, h, xi):
    """Importance-sample the hair BSDF. ``xi``: [N, 4] uniforms.

    Returns (wi_l [N, 3] in the fiber frame, bsdf_over_pdf [N, 3], pdf [N]).
    """
    g = _geometry(wo_l, h, params)
    ap = _attenuations(g)
    ap_lum = jnp.mean(ap, axis=-1)
    ap_pdf = safe_div(ap_lum, jnp.maximum(jnp.sum(ap_lum, -1, keepdims=True), 1e-9))
    cdf = jnp.cumsum(ap_pdf, axis=-1)

    # stratify xi[0]: the [1-w, 1] tail picks the diffuse lobe, the rest is
    # rescaled for specular lobe selection (keeps all four uniforms usable)
    w_mix = params.diffuse_weight
    take_diff = xi[:, 0] >= (1.0 - w_mix)
    u0 = jnp.clip(safe_div(xi[:, 0], jnp.maximum(1.0 - w_mix, 1e-6)), 0.0, 1.0)
    p = jnp.sum((u0[..., None] > cdf).astype(jnp.int32), axis=-1)
    p = jnp.clip(p, 0, P_MAX)

    sin_top, cos_top = _lobe_angles(g, params)
    v_all, s_all = _variances(params)
    rows = jnp.arange(wo_l.shape[0])
    v = v_all[rows, p]
    s = s_all[rows, p]
    sin_tp = sin_top[rows, p]
    cos_tp = cos_top[rows, p]

    # longitudinal sampling (Chiang / PBRT inversion)
    u1 = jnp.maximum(xi[:, 1], 1e-5)
    cos_theta = 1.0 + v * jnp.log(u1 + (1.0 - u1) * jnp.exp(-2.0 / v))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta**2, 0.0))
    cos_phi_l = jnp.cos(2.0 * M_PI * xi[:, 2])
    sin_ti = -cos_theta * sin_tp + sin_theta * cos_phi_l * cos_tp
    cos_ti = jnp.sqrt(jnp.maximum(1.0 - sin_ti * sin_ti, 0.0))

    # azimuthal sampling
    is_resid = p >= P_MAX
    dphi_spec = _phi(
        p.astype(jnp.float32), g.gamma_o, g.gamma_t
    ) + _sample_trimmed_logistic(xi[:, 3], s, -M_PI, M_PI)
    dphi = jnp.where(is_resid, 2.0 * M_PI * xi[:, 3], dphi_spec)
    phi_i = g.phi_o + dphi

    wi_l = jnp.stack(
        [sin_ti, cos_ti * jnp.cos(phi_i), cos_ti * jnp.sin(phi_i)], axis=-1
    )

    # diffuse direction: uniform sphere from xi[1], xi[2]
    z = 1.0 - 2.0 * xi[:, 1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    ph = 2.0 * M_PI * xi[:, 2]
    wi_diff = jnp.stack([z, r * jnp.cos(ph), r * jnp.sin(ph)], axis=-1)
    wi_l = jnp.where(take_diff[..., None], wi_diff, wi_l)
    f, pdf = hair_eval(params, wo_l, wi_l, h)

    bsdf_over_pdf = safe_div(f, jnp.maximum(pdf, 1e-9)[..., None])
    ok = pdf > 1e-9
    return wi_l, jnp.where(ok[..., None], bsdf_over_pdf, 0.0), jnp.where(ok, pdf, 0.0)
