"""Two-lobe layered/mixed/modified BSDFs, fully batched.

Replacement for MDL's BSDF *combinators* — the node graphs the
reference JIT-compiles per material (``df::weighted_layer``,
``color_weighted_layer``, ``fresnel_layer``, ``measured_curve_layer``,
``normalized/clamped/unbounded_mix`` and their color variants, and the
modifiers ``directional_factor``, ``fresnel_factor``, ``thin_film``,
``measured_curve_factor``; sample materials ``data/mdl/layer_*.mdl``,
``mixer_*.mdl``, ``modifier_*.mdl``). Instead of runtime codegen, every
material is normalized at load time into at most TWO archetype lobes plus a
*blend descriptor* (how the lobes are weighted as a function of the view
angle) and a *modifier descriptor* (an angular color factor on the result).
All of it evaluates as masked vector code over the wavefront — one compiled
program for every material graph in the scene.

Mixture sampling follows the standard estimator: pick lobe 1 with
probability p1 (luminance-weighted), sample it, then

- non-dirac event: weight = (w1*f1 + w2*f2) / (p1*pdf1 + (1-p1)*pdf2) —
  both lobes evaluated at the sampled direction (full MIS-quality mixture);
- dirac event: weight = w * f/pdf of the chosen lobe / p_choice (the smooth
  lobe's density at a dirac direction has measure zero).

``df::tint`` needs no runtime support: all lobes scale linearly in their
tint, so the parser folds it into the lobe albedos.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..utils.math import dot, safe_div
from . import bsdf as B

M_PI = float(np.pi)

# blend modes (how lobe weights depend on the view angle)
BLEND_NONE = 0      # single lobe (lobe 1 only)
BLEND_FIXED = 1     # constant color weights (weighted_layer / mixes)
BLEND_FRESNEL = 2   # w1 = weight * F_dielectric(ior, cos)  (fresnel_layer)
BLEND_CURVE = 3     # w1 = weight * curve(theta)  (measured_curve_layer)

# modifier modes (angular color factor on the combined BSDF)
MOD_NONE = 0
MOD_DIRECTIONAL = 1   # normal_tint + (grazing - normal) * (1-cos)^exponent
MOD_FRESNEL_COND = 2  # per-channel conductor Fresnel (ior + extinction)
MOD_THIN_FILM = 3     # Airy interference factor (thickness nm, film ior)
MOD_CURVE = 4         # measured_curve_factor: curve(theta) color

CURVE_RES = 16  # resampled measured-curve resolution (host side)


class BlendParams(NamedTuple):
    """Per-ray gathered blend + modifier descriptor rows."""

    blend_mode: jnp.ndarray   # [N] i32
    w1: jnp.ndarray           # [N, 3] layer weight (color)
    w2: jnp.ndarray           # [N, 3] base weight (color)
    blend_ior: jnp.ndarray    # [N] fresnel_layer ior
    curve: jnp.ndarray        # [N, CURVE_RES, 3] measured curve (gathered row)
    mod_mode: jnp.ndarray     # [N] i32
    mod_a: jnp.ndarray        # [N, 3] normal_tint | conductor ior | film ior
    mod_b: jnp.ndarray        # [N, 3] grazing_tint | extinction | unused
    mod_exp: jnp.ndarray      # [N] exponent | unused | thickness (nm)


def _luminance(c: jnp.ndarray) -> jnp.ndarray:
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def _curve_lookup(curve: jnp.ndarray, cos_t: jnp.ndarray) -> jnp.ndarray:
    """curve [N, K, 3] indexed by incidence angle theta in [0, pi/2]."""
    k = curve.shape[-2]
    theta = jnp.arccos(jnp.clip(jnp.abs(cos_t), 0.0, 1.0))
    x = theta / (0.5 * M_PI) * (k - 1)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, k - 1)
    i1 = jnp.minimum(i0 + 1, k - 1)
    f = (x - i0.astype(jnp.float32))[..., None]
    # one-hot picks, not per-lane gathers (utils.math.pick1): K is small
    from ..utils.math import pick1

    return pick1(curve, i0) * (1.0 - f) + pick1(curve, i1) * f


def fresnel_conductor(cos_i: jnp.ndarray, n: jnp.ndarray, k: jnp.ndarray):
    """Per-channel unpolarized conductor Fresnel (exact, PBRT form).

    cos_i [N] >= 0; n, k [N, 3]. Returns [N, 3]."""
    c = jnp.clip(cos_i, 0.0, 1.0)[..., None]
    c2 = c * c
    sin2 = 1.0 - c2
    eta2 = n * n
    etak2 = k * k
    t0 = eta2 - etak2 - sin2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * etak2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * c
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = c2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return jnp.clip(0.5 * (rs + rp), 0.0, 1.0)


def _thin_film_factor(cos_i: jnp.ndarray, film_ior: jnp.ndarray,
                      thickness_nm: jnp.ndarray) -> jnp.ndarray:
    """Airy reflectance of a single dielectric film (equal-interface
    approximation of MDL ``df::thin_film``): R(lambda) =
    2F(1-cos dphi) / (1 + F^2 - 2F cos dphi), dphi = 4 pi n d cos_t / lambda."""
    lam = jnp.asarray([650.0, 510.0, 440.0], jnp.float32)  # rgb wavelengths
    n = jnp.maximum(film_ior, 1.0)[..., None]
    c = jnp.clip(cos_i, 0.0, 1.0)[..., None]
    sin2_t = (1.0 - c * c) / (n * n)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    dphi = 4.0 * M_PI * n * thickness_nm[..., None] * cos_t / lam
    f = B.fresnel_dielectric(cos_i, film_ior)[..., None]
    num = 2.0 * f * (1.0 - jnp.cos(dphi))
    den = 1.0 + f * f - 2.0 * f * jnp.cos(dphi)
    return jnp.clip(safe_div(num, den), 0.0, 1.0)


def blend_weights(bp: BlendParams, cos_o: jnp.ndarray):
    """Angular lobe weights (w1, w2 color) + lobe-1 pick probability p1."""
    mode = bp.blend_mode
    w1 = bp.w1
    w2 = bp.w2
    # fresnel_layer: w1 = weight * F(ior, cos), base keeps 1 - w1
    f = B.fresnel_dielectric(cos_o, jnp.maximum(bp.blend_ior, 1e-3))
    w1_f = bp.w1 * f[..., None]
    # measured_curve_layer: w1 = weight * curve(theta)
    w1_c = bp.w1 * _curve_lookup(bp.curve, cos_o)
    is_f = (mode == BLEND_FRESNEL)[..., None]
    is_c = (mode == BLEND_CURVE)[..., None]
    w1 = jnp.where(is_f, w1_f, jnp.where(is_c, w1_c, w1))
    w2 = jnp.where(is_f | is_c, 1.0 - w1, w2)
    single = (mode == BLEND_NONE)
    w1 = jnp.where(single[..., None], 1.0, w1)
    w2 = jnp.where(single[..., None], 0.0, w2)

    l1 = _luminance(w1)
    l2 = _luminance(w2)
    p1 = safe_div(l1, l1 + l2)
    # keep both lobes reachable when both carry weight (defensive MIS)
    both = (l1 > 0.0) & (l2 > 0.0)
    p1 = jnp.where(both, jnp.clip(p1, 0.05, 0.95), p1)
    p1 = jnp.where(single, 1.0, p1)
    return w1, w2, p1


def modifier_factor(bp: BlendParams, cos_o: jnp.ndarray) -> jnp.ndarray:
    """Angular color factor of the modifier node (identity when MOD_NONE)."""
    mode = bp.mod_mode
    out = jnp.ones_like(bp.mod_a)
    c = jnp.clip(jnp.abs(cos_o), 0.0, 1.0)
    # directional_factor
    g = (1.0 - c)[..., None] ** jnp.maximum(bp.mod_exp, 1e-3)[..., None]
    dir_f = bp.mod_a + (bp.mod_b - bp.mod_a) * g
    out = jnp.where((mode == MOD_DIRECTIONAL)[..., None], dir_f, out)
    # fresnel_factor (conductor)
    cond = fresnel_conductor(c, bp.mod_a, bp.mod_b)
    out = jnp.where((mode == MOD_FRESNEL_COND)[..., None], cond, out)
    # thin_film
    film = _thin_film_factor(c, bp.mod_a[..., 0], bp.mod_exp)
    out = jnp.where((mode == MOD_THIN_FILM)[..., None], film, out)
    # measured_curve_factor
    crv = _curve_lookup(bp.curve, c)
    out = jnp.where((mode == MOD_CURVE)[..., None], crv, out)
    return out


def _select_params(sel: jnp.ndarray, a: B.MaterialParams, b: B.MaterialParams):
    s1 = sel[..., None]
    return B.MaterialParams(
        archetype=jnp.where(sel, a.archetype, b.archetype),
        albedo=jnp.where(s1, a.albedo, b.albedo),
        roughness=jnp.where(s1, a.roughness, b.roughness),
        ior=jnp.where(sel, a.ior, b.ior),
        thin_walled=jnp.where(sel, a.thin_walled, b.thin_walled),
    )


def layered_sample(
    p1: B.MaterialParams,
    p2: B.MaterialParams,
    bp: BlendParams,
    wo: jnp.ndarray,
    ns: jnp.ndarray,
    ng: jnp.ndarray,
    xi: jnp.ndarray,        # [N, 5] (xi[4] picks the lobe)
    eta_i: jnp.ndarray,
    eta_t: jnp.ndarray,
    families=None,          # static archetype set (both lobes)
) -> B.BSDFSample:
    sgn = jnp.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    cos_o = dot(wo, ns * sgn[..., None])
    w1, w2, p_1 = blend_weights(bp, cos_o)
    pick1 = xi[..., 4] < p_1
    sel = _select_params(pick1, p1, p2)
    smp = B.bsdf_sample(sel, wo, ns, ng, xi[..., :4], eta_i, eta_t,
                        families=families)

    single = bp.blend_mode == BLEND_NONE
    dirac = (smp.event & B.BSDF_EVENT_SPECULAR) != 0
    ok = smp.event != B.BSDF_EVENT_ABSORB

    # dirac: scale the chosen lobe by its color weight / pick probability
    w_pick = jnp.where(pick1[..., None], w1, w2)
    p_pick = jnp.where(pick1, p_1, 1.0 - p_1)
    w_dirac = smp.bsdf_over_pdf * safe_div(w_pick, p_pick[..., None])

    # non-dirac: full mixture f / mixture pdf at the sampled direction
    e1 = B.bsdf_eval(p1, wo, smp.wi, ns, eta_i, eta_t, families=families)
    e2 = B.bsdf_eval(p2, wo, smp.wi, ns, eta_i, eta_t, families=families)
    f_mix = w1 * e1.bsdf + w2 * e2.bsdf
    pdf_mix = p_1 * e1.pdf + (1.0 - p_1) * e2.pdf
    # transmission lobes aren't covered by bsdf_eval (reflection-only NEE
    # eval); fall back to the single-lobe estimate for those events
    transmit = (smp.event & B.BSDF_EVENT_TRANSMISSION) != 0
    use_mix = ok & ~dirac & ~transmit & ~single
    w_mixture = safe_div(f_mix, pdf_mix[..., None])
    weight = jnp.where(
        use_mix[..., None],
        w_mixture,
        jnp.where(single[..., None], smp.bsdf_over_pdf, w_dirac),
    )
    pdf = jnp.where(use_mix, pdf_mix, smp.pdf)

    # modifier factor (applied to the final weight; angular in wo)
    mf = modifier_factor(bp, cos_o)
    weight = weight * mf

    failed = ok & use_mix & (pdf_mix <= 0.0)
    event = jnp.where(failed, np.int32(B.BSDF_EVENT_ABSORB), smp.event)
    weight = jnp.where(failed[..., None], 0.0, weight)
    pdf = jnp.where(failed, 0.0, pdf)
    return B.BSDFSample(wi=smp.wi, bsdf_over_pdf=weight, pdf=pdf, event=event)


def layered_eval(
    p1: B.MaterialParams,
    p2: B.MaterialParams,
    bp: BlendParams,
    wo: jnp.ndarray,
    wi: jnp.ndarray,
    ns: jnp.ndarray,
    eta_i: jnp.ndarray,
    eta_t: jnp.ndarray,
    families=None,          # static archetype set (both lobes)
) -> B.BSDFEval:
    sgn = jnp.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    cos_o = dot(wo, ns * sgn[..., None])
    w1, w2, p_1 = blend_weights(bp, cos_o)
    e1 = B.bsdf_eval(p1, wo, wi, ns, eta_i, eta_t, families=families)
    single = (bp.blend_mode == BLEND_NONE)
    e2 = B.bsdf_eval(p2, wo, wi, ns, eta_i, eta_t, families=families)
    f = jnp.where(
        single[..., None], e1.bsdf, w1 * e1.bsdf + w2 * e2.bsdf
    ) * modifier_factor(bp, cos_o)
    pdf = jnp.where(single, e1.pdf, p_1 * e1.pdf + (1.0 - p_1) * e2.pdf)
    return B.BSDFEval(bsdf=f, pdf=pdf)


def layered_aux(
    p1: B.MaterialParams, p2: B.MaterialParams, bp: BlendParams,
    wo: jnp.ndarray, ns: jnp.ndarray,
) -> B.BSDFAux:
    """Blended auxiliary outputs for the radiance-query features."""
    sgn = jnp.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    cos_o = dot(wo, ns * sgn[..., None])
    w1, w2, _ = blend_weights(bp, cos_o)
    a1 = B.bsdf_aux(p1)
    a2 = B.bsdf_aux(p2)
    single = (bp.blend_mode == BLEND_NONE)[..., None]
    mf = modifier_factor(bp, cos_o)
    diff = jnp.where(
        single, a1.albedo_diffuse, w1 * a1.albedo_diffuse + w2 * a2.albedo_diffuse
    ) * mf
    glos = jnp.where(
        single, a1.albedo_glossy, w1 * a1.albedo_glossy + w2 * a2.albedo_glossy
    ) * mf
    l1 = _luminance(w1)[..., None]
    l2 = _luminance(w2)[..., None]
    rough = jnp.where(
        single,
        a1.roughness,
        safe_div(l1 * a1.roughness + l2 * a2.roughness, l1 + l2),
    )
    return B.BSDFAux(albedo_diffuse=diff, albedo_glossy=glos, roughness=rough)
