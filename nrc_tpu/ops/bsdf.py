"""BSDF archetype family: sample / evaluate / auxiliary, fully batched.

The replacement for MDL's JIT-generated per-material direct
callables (``optixDirectCall`` of scattering sample/eval/aux in
``nrc/shaders/hit.cu:306-486``). Instead of function pointers, the material
archetype id selects between three vectorized lobe families (diffuse,
GGX microfacet, ideal specular) with reflect/transmit mode flags — every
branch is a masked select over the whole wavefront, which XLA fuses into
one pass.

Conventions (match the reference's MDL usage):
- ``wo``: direction toward the observer (= -ray dir), unit.
- ``ns``/``ng``: shading/geometric normals as stored (front side).
- sample returns ``bsdf_over_pdf`` (throughput weight), ``pdf`` (solid-angle;
  0 for dirac events, matching ``hit.cu:866-867``) and an MDL-style event
  bitmask.
- eval returns bsdf x |cos| ("contains the cosine factor", ``hit.cu:387-389``)
  and the sample pdf for MIS.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..scene.materials import Archetype
from ..utils.math import (
    align_vector,
    build_onb,
    dot,
    normalize,
    reflect,
    safe_div,
    to_world,
)

M_PI = float(jnp.pi)

# MDL event bitmask (mi::neuraylib::Bsdf_event_type)
BSDF_EVENT_ABSORB = 0
BSDF_EVENT_DIFFUSE = 1
BSDF_EVENT_GLOSSY = 2
BSDF_EVENT_SPECULAR = 4
BSDF_EVENT_REFLECTION = 8
BSDF_EVENT_TRANSMISSION = 16
BSDF_EVENT_DIFFUSE_REFLECTION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_REFLECTION
BSDF_EVENT_DIFFUSE_TRANSMISSION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_GLOSSY_REFLECTION = BSDF_EVENT_GLOSSY | BSDF_EVENT_REFLECTION
BSDF_EVENT_GLOSSY_TRANSMISSION = BSDF_EVENT_GLOSSY | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_SPECULAR_REFLECTION = BSDF_EVENT_SPECULAR | BSDF_EVENT_REFLECTION
BSDF_EVENT_SPECULAR_TRANSMISSION = BSDF_EVENT_SPECULAR | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_NON_DIRAC = BSDF_EVENT_DIFFUSE | BSDF_EVENT_GLOSSY


class MaterialParams(NamedTuple):
    """Per-ray gathered material parameters (rows of MaterialTable)."""

    archetype: jnp.ndarray  # [N] i32
    albedo: jnp.ndarray     # [N, 3]
    roughness: jnp.ndarray  # [N, 2]
    ior: jnp.ndarray        # [N]
    thin_walled: jnp.ndarray  # [N] i32


class BSDFSample(NamedTuple):
    wi: jnp.ndarray             # [N, 3]
    bsdf_over_pdf: jnp.ndarray  # [N, 3]
    pdf: jnp.ndarray            # [N] (0 for dirac)
    event: jnp.ndarray          # [N] i32 bitmask


class BSDFEval(NamedTuple):
    bsdf: jnp.ndarray  # [N, 3] f*|cos| (diffuse+glossy lobes)
    pdf: jnp.ndarray   # [N]


class BSDFAux(NamedTuple):
    albedo_diffuse: jnp.ndarray  # [N, 3]
    albedo_glossy: jnp.ndarray   # [N, 3]
    roughness: jnp.ndarray       # [N, 2] ((1,1) for diffuse — hit.cu:480-483)


def _is(arch, *types):
    m = arch == int(types[0])
    for t in types[1:]:
        m = m | (arch == int(t))
    return m


def _family_flags(families):
    """Static per-family presence flags from a scene's archetype set."""
    if families is None:
        return True, True, True, True, True, True
    fams = {int(f) for f in families}
    has_dr = int(Archetype.DIFFUSE_REFLECTION) in fams
    has_dt = int(Archetype.DIFFUSE_TRANSMISSION) in fams
    has_grt = int(Archetype.GGX_REFLECT_TRANSMIT) in fams
    has_ggx = has_grt or bool(
        fams & {int(Archetype.GGX_REFLECT), int(Archetype.GGX_TRANSMIT)}
    )
    has_st = int(Archetype.SPECULAR_TRANSMIT) in fams
    has_spec = has_st or bool(
        fams & {
            int(Archetype.SPECULAR_REFLECT),
            int(Archetype.SPECULAR_REFLECT_TRANSMIT),
        }
    )
    return has_dr, has_dt, has_ggx, has_spec, has_grt, has_st


def fresnel_dielectric(cos_i: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Unpolarized dielectric Fresnel. ``eta`` = n_transmitted / n_incident.

    ``cos_i`` >= 0 (against the oriented normal). Returns reflectance in
    [0, 1]; 1 on total internal reflection.
    """
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / jnp.maximum(eta * eta, 1e-12)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    rs = safe_div(cos_i - eta * cos_t, cos_i + eta * cos_t)
    rp = safe_div(eta * cos_i - cos_t, eta * cos_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


def refract_dir(wo: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Refract -wo through oriented normal n; eta = n_t/n_i.

    Returns (wt, tir_mask). ``n`` must satisfy dot(wo, n) >= 0.
    """
    inv_eta = 1.0 / jnp.maximum(eta, 1e-12)
    cos_i = dot(wo, n)
    sin2_t = inv_eta * inv_eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = -inv_eta[..., None] * wo + (inv_eta * cos_i - cos_t)[..., None] * n
    return normalize(wt), tir


# ---------------------------------------------------------------------------
# GGX microfacet helpers (isotropic; alpha = roughness, MDL convention)
# ---------------------------------------------------------------------------

def _ggx_alpha(roughness: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(jnp.sqrt(roughness[..., 0] * roughness[..., 1]), 1e-3, 1.0)


def ggx_d(cos_h: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return jnp.where(cos_h > 0.0, a2 / jnp.maximum(M_PI * d * d, 1e-12), 0.0)


def ggx_g1(cos_v: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    a2 = alpha * alpha
    c = jnp.abs(cos_v)
    return 2.0 * c / jnp.maximum(c + jnp.sqrt(a2 + (1.0 - a2) * c * c), 1e-12)


def _sample_ggx_h(n: jnp.ndarray, alpha: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Sample a GGX half-vector about unit normal n (NDF sampling)."""
    a2 = alpha * alpha
    cos_h = jnp.sqrt(jnp.clip((1.0 - xi[..., 0]) / (1.0 + (a2 - 1.0) * xi[..., 0]), 0.0, 1.0))
    sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 0.0))
    phi = 2.0 * M_PI * xi[..., 1]
    local = jnp.stack([sin_h * jnp.cos(phi), sin_h * jnp.sin(phi), cos_h], axis=-1)
    t, b = build_onb(n)
    return to_world(t, b, n, local)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def bsdf_sample(
    params: MaterialParams,
    wo: jnp.ndarray,
    ns: jnp.ndarray,
    ng: jnp.ndarray,
    xi: jnp.ndarray,        # [N, 4]
    eta_i: jnp.ndarray,     # [N] incident-medium ior (stack top)
    eta_t: jnp.ndarray,     # [N] transmitted-side ior
    families=None,          # static frozenset of Archetype ints, or None=all
) -> BSDFSample:
    """Importance-sample the per-ray archetype BSDF (``hit.cu:306-337``).

    ``families`` statically specializes the compiled program to the
    archetypes actually present in the scene — the analog of the
    reference JIT-compiling only the MDL materials a scene declares
    (``Raytracer::initMaterialsMDL``): absent lobe families cost nothing.
    """
    arch = params.archetype
    tint = params.albedo
    has_dr, has_dt, has_ggx, has_spec, has_grt, has_st = _family_flags(families)
    front = dot(wo, ng) >= 0.0
    # normal oriented to the wo side for sampling
    sgn = jnp.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    eta = jnp.maximum(eta_t, 1e-6) / jnp.maximum(eta_i, 1e-6)
    z1 = jnp.zeros_like(eta)
    z3 = jnp.zeros_like(wo)
    f0 = jnp.zeros_like(arch)

    # --- diffuse family -------------------------------------------------
    is_dr = _is(arch, Archetype.DIFFUSE_REFLECTION)
    is_dt = _is(arch, Archetype.DIFFUSE_TRANSMISSION)
    if has_dr or has_dt:
        phi_d = 2.0 * M_PI * xi[..., 0]
        r = jnp.sqrt(jnp.clip(xi[..., 1], 0.0, 1.0))
        local = jnp.stack(
            [
                r * jnp.cos(phi_d),
                r * jnp.sin(phi_d),
                jnp.sqrt(jnp.maximum(1.0 - r * r, 0.0)),
            ],
            axis=-1,
        )
        wi_dr = align_vector(nf, local) if has_dr else z3
        wi_dt = align_vector(-nf, local) if has_dt else z3
        pdf_diffuse = jnp.maximum(local[..., 2], 0.0) / M_PI
    else:
        wi_dr = wi_dt = z3
        pdf_diffuse = z1

    # --- GGX family -----------------------------------------------------
    is_gr = _is(arch, Archetype.GGX_REFLECT)
    is_gt = _is(arch, Archetype.GGX_TRANSMIT)
    is_grt = _is(arch, Archetype.GGX_REFLECT_TRANSMIT)
    if has_ggx:
        alpha = _ggx_alpha(params.roughness)
        h = _sample_ggx_h(nf, alpha, xi[..., 2:4])
        woh = dot(wo, h)
        h_ok = woh > 1e-6
        wi_gr = normalize(2.0 * woh[..., None] * h - wo)
        cos_hn = dot(h, nf)
        d_term = ggx_d(cos_hn, alpha)
        pdf_gr = safe_div(
            d_term * jnp.maximum(cos_hn, 0.0), 4.0 * jnp.maximum(woh, 1e-12)
        )
        cos_o = jnp.abs(dot(wo, nf))
        cos_i_gr = dot(wi_gr, nf)
        g_gr = ggx_g1(cos_o, alpha) * ggx_g1(cos_i_gr, alpha)
        # weight = f*cos/pdf = G * woh / (cos_o * cos_hn)
        w_gr = safe_div(g_gr * woh, cos_o * jnp.maximum(cos_hn, 1e-12))
        gr_ok = h_ok & (cos_i_gr > 1e-6)

        # GGX transmission through h
        wi_gt, tir_g = refract_dir(wo, h, eta)
        cos_i_gt = dot(wi_gt, nf)
        gt_ok = h_ok & (cos_i_gt < -1e-6) & ~tir_g
        g_gt = ggx_g1(cos_o, alpha) * ggx_g1(cos_i_gt, alpha)
        w_gt = safe_div(g_gt * woh, cos_o * jnp.maximum(cos_hn, 1e-12))
        # approximate transmission pdf via the half-vector pdf
        pdf_gt = pdf_gr

        # Fresnel lobe choice for reflect_transmit modes
        f_g = fresnel_dielectric(woh, eta) if has_grt else z1
        choose_reflect_g = xi[..., 0] < f_g  # xi0: independent of h sample
        ggx_reflect = is_gr | (is_grt & choose_reflect_g) | (is_grt & tir_g)
        wi_ggx = jnp.where(ggx_reflect[..., None], wi_gr, wi_gt)
        ok_ggx = jnp.where(ggx_reflect, gr_ok, gt_ok)
        w_ggx = jnp.where(ggx_reflect, w_gr, w_gt)
        pdf_ggx = jnp.where(ggx_reflect, pdf_gr, pdf_gt)
        # lobe-choice probability folds out of weight
        pdf_ggx = jnp.where(
            is_grt, pdf_ggx * jnp.where(ggx_reflect, f_g, 1.0 - f_g), pdf_ggx
        )
        ev_ggx = jnp.where(
            ggx_reflect,
            np.int32(BSDF_EVENT_GLOSSY_REFLECTION),
            np.int32(BSDF_EVENT_GLOSSY_TRANSMISSION),
        )
    else:
        wi_ggx, ok_ggx, w_ggx, pdf_ggx = z3, is_gr, z1, z1
        ev_ggx = f0

    # --- specular family ------------------------------------------------
    is_sr = _is(arch, Archetype.SPECULAR_REFLECT)
    is_st = _is(arch, Archetype.SPECULAR_TRANSMIT)
    is_srt = _is(arch, Archetype.SPECULAR_REFLECT_TRANSMIT)
    if has_spec:
        wi_sr = reflect(-wo, nf)
        wi_st, tir_s = refract_dir(wo, nf, eta)
        f_s = fresnel_dielectric(dot(wo, nf), eta)
        choose_reflect_s = xi[..., 0] < f_s
        spec_reflect = is_sr | (is_srt & (choose_reflect_s | tir_s))
        wi_spec = jnp.where(spec_reflect[..., None], wi_sr, wi_st)
        # ideal dirac: reflect_transmit weight = tint (Fresnel cancels
        # against the lobe-choice probability); pure transmit loses the
        # Fresnel-reflected fraction (1-F) and is absorbed on TIR
        w_spec = (
            jnp.where(is_st, (1.0 - f_s), jnp.ones_like(f_s))
            if has_st else jnp.ones_like(f_s)
        )
        ok_spec = ~(is_st & tir_s)
        ev_spec = jnp.where(
            spec_reflect,
            np.int32(BSDF_EVENT_SPECULAR_REFLECTION),
            np.int32(BSDF_EVENT_SPECULAR_TRANSMISSION),
        )
    else:
        wi_spec, w_spec, ok_spec = z3, z1, is_sr
        ev_spec = f0

    # --- combine --------------------------------------------------------
    is_diffuse_f = is_dr | is_dt
    is_ggx_f = is_gr | is_gt | is_grt
    is_spec_f = is_sr | is_st | is_srt

    wi = jnp.where(
        is_diffuse_f[..., None],
        jnp.where(is_dr[..., None], wi_dr, wi_dt),
        jnp.where(is_ggx_f[..., None], wi_ggx, wi_spec),
    )
    weight = jnp.where(
        is_diffuse_f[..., None],
        tint,
        jnp.where(
            is_ggx_f[..., None],
            tint * w_ggx[..., None],
            tint * w_spec[..., None],
        ),
    )
    pdf = jnp.where(
        is_diffuse_f, pdf_diffuse, jnp.where(is_ggx_f, pdf_ggx, 0.0)
    )
    event = jnp.where(
        is_dr,
        np.int32(BSDF_EVENT_DIFFUSE_REFLECTION),
        jnp.where(
            is_dt,
            np.int32(BSDF_EVENT_DIFFUSE_TRANSMISSION),
            jnp.where(is_ggx_f, ev_ggx, ev_spec),
        ),
    )

    ok = jnp.where(
        is_diffuse_f,
        pdf_diffuse > 0.0,
        jnp.where(is_ggx_f, ok_ggx, ok_spec),
    )
    # NULL_BSDF or failed sample -> absorb (hit.cu:871-875). MEASURED is
    # handled by the integrator's ops/mbsdf.py merge; absorb here so an
    # unmerged measured lane can never leak a bogus analytic sample.
    ok = ok & ~_is(arch, Archetype.NULL_BSDF, Archetype.MEASURED)
    event = jnp.where(ok, event, np.int32(BSDF_EVENT_ABSORB))
    weight = jnp.where(ok[..., None], weight, 0.0)
    pdf = jnp.where(ok, pdf, 0.0)
    return BSDFSample(wi=wi, bsdf_over_pdf=weight, pdf=pdf, event=event)


# ---------------------------------------------------------------------------
# Evaluation (for NEE / MIS) — dirac lobes evaluate to zero
# ---------------------------------------------------------------------------

def bsdf_eval(
    params: MaterialParams,
    wo: jnp.ndarray,
    wi: jnp.ndarray,
    ns: jnp.ndarray,
    eta_i: jnp.ndarray,
    eta_t: jnp.ndarray,
    families=None,          # static frozenset of Archetype ints, or None=all
) -> BSDFEval:
    arch = params.archetype
    tint = params.albedo
    has_dr, has_dt, has_ggx, _, has_grt, _ = _family_flags(families)
    sgn = jnp.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    cos_i = dot(wi, nf)
    z1 = jnp.zeros_like(cos_i)
    z3 = jnp.zeros_like(wo)

    # diffuse reflection
    if has_dr:
        f_dr = tint / M_PI * jnp.maximum(cos_i, 0.0)[..., None]
        pdf_dr = jnp.maximum(cos_i, 0.0) / M_PI
    else:
        f_dr, pdf_dr = z3, z1
    # diffuse transmission (opposite hemisphere)
    if has_dt:
        f_dt = tint / M_PI * jnp.maximum(-cos_i, 0.0)[..., None]
        pdf_dt = jnp.maximum(-cos_i, 0.0) / M_PI
    else:
        f_dt, pdf_dt = z3, z1

    # GGX reflection lobe
    if has_ggx:
        eta = jnp.maximum(eta_t, 1e-6) / jnp.maximum(eta_i, 1e-6)
        alpha = _ggx_alpha(params.roughness)
        h = normalize(wo + wi)
        cos_hn = dot(h, nf)
        woh = jnp.maximum(dot(wo, h), 1e-12)
        d_term = ggx_d(cos_hn, alpha)
        cos_o = jnp.abs(dot(wo, nf))
        g = ggx_g1(cos_o, alpha) * ggx_g1(cos_i, alpha)
        refl_ok = (cos_i > 1e-6) & (cos_o > 1e-6)
        f_ggx_scalar = jnp.where(
            refl_ok, safe_div(d_term * g, 4.0 * cos_o), 0.0
        )  # f * cos_i already folded: D*G/(4 cosO cosI) * cosI
        pdf_ggx = jnp.where(
            refl_ok, safe_div(d_term * jnp.maximum(cos_hn, 0.0), 4.0 * woh), 0.0
        )
        is_grt = _is(arch, Archetype.GGX_REFLECT_TRANSMIT)
        if has_grt:
            f_grt = fresnel_dielectric(woh, eta)
            f_ggx = tint * jnp.where(
                is_grt, f_ggx_scalar * f_grt, f_ggx_scalar
            )[..., None]
            pdf_ggx = jnp.where(is_grt, pdf_ggx * f_grt, pdf_ggx)
        else:
            f_ggx = tint * f_ggx_scalar[..., None]
    else:
        is_grt = _is(arch, Archetype.GGX_REFLECT_TRANSMIT)
        f_ggx, pdf_ggx = z3, z1

    is_gr = _is(arch, Archetype.GGX_REFLECT)
    is_dr = _is(arch, Archetype.DIFFUSE_REFLECTION)
    is_dt = _is(arch, Archetype.DIFFUSE_TRANSMISSION)
    is_ggx = is_gr | is_grt | _is(arch, Archetype.GGX_TRANSMIT)

    f = jnp.where(
        is_dr[..., None],
        f_dr,
        jnp.where(is_dt[..., None], f_dt, jnp.where(is_ggx[..., None], f_ggx, 0.0)),
    )
    pdf = jnp.where(is_dr, pdf_dr, jnp.where(is_dt, pdf_dt, jnp.where(is_ggx, pdf_ggx, 0.0)))
    # GGX_TRANSMIT has no reflection lobe to light-sample
    is_gt_only = _is(arch, Archetype.GGX_TRANSMIT)
    f = jnp.where(is_gt_only[..., None], 0.0, f)
    pdf = jnp.where(is_gt_only, 0.0, pdf)
    return BSDFEval(bsdf=f, pdf=pdf)


# ---------------------------------------------------------------------------
# Auxiliary data (albedos + roughness for radiance queries)
# ---------------------------------------------------------------------------

def bsdf_aux(params: MaterialParams) -> BSDFAux:
    arch = params.archetype
    tint = params.albedo
    is_diffuse = _is(arch, Archetype.DIFFUSE_REFLECTION, Archetype.DIFFUSE_TRANSMISSION)
    is_glossy = _is(
        arch,
        Archetype.GGX_REFLECT,
        Archetype.GGX_TRANSMIT,
        Archetype.GGX_REFLECT_TRANSMIT,
        Archetype.SPECULAR_REFLECT,
        Archetype.SPECULAR_TRANSMIT,
        Archetype.SPECULAR_REFLECT_TRANSMIT,
    )
    zero = jnp.zeros_like(tint)
    albedo_diffuse = jnp.where(is_diffuse[..., None], tint, zero)
    albedo_glossy = jnp.where(is_glossy[..., None], tint, zero)
    # diffuse events report roughness (1,1) — hit.cu:480-483
    ones = jnp.ones_like(params.roughness)
    is_spec = _is(
        arch,
        Archetype.SPECULAR_REFLECT,
        Archetype.SPECULAR_TRANSMIT,
        Archetype.SPECULAR_REFLECT_TRANSMIT,
    )
    roughness = jnp.where(
        is_diffuse[..., None],
        ones,
        jnp.where(is_spec[..., None], jnp.zeros_like(ones), params.roughness),
    )
    return BSDFAux(
        albedo_diffuse=albedo_diffuse, albedo_glossy=albedo_glossy, roughness=roughness
    )
