"""Wavefront path-tracing integrator with NRC training-data emission.

The Redesign of the reference's OptiX megakernel
(``__raygen__nrc_path_tracer`` + ``nrcIntegrator`` loop,
``nrc/shaders/raygeneration.cu:139-289``, and ``__closesthit__radiance``,
``nrc/shaders/hit.cu:672-1064``): instead of per-thread divergent control
flow, a ``lax.scan`` over bounce depth advances the whole SoA ray batch,
with every branch a masked select. Everything compiles into one XLA program.

Two wavefronts replace the reference's in-kernel render/suffix state machine:

- the *render* wavefront covers all pixels: emission with MIS, NEE, BSDF
  sampling, area-spread truncation into the cache (Eq. 2-4 of the paper,
  ``hit.cu:527-585``), producing per-pixel radiance + the cache query at the
  truncation vertex + ``lastRenderThroughput`` (``raygeneration.cu:364-366``).
- the *training* wavefront covers one ray per screen tile
  (``isTrainingRay``, ``raygeneration.cu:123-136``): the same transport, but
  every non-specular vertex appends a training record. The reference's
  global atomicAdd record allocator + propTo linked lists
  (``hit.cu:975-1028``) become a static per-tile strided layout
  ``[num_tiles, max_records]`` — records of a tile are consecutive, so
  radiance propagation is a dense reverse scan and no mid-frame host
  readback of ``numTrainingRecords`` is needed (``Device.cpp:2487-2491``
  becomes an on-device count).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrameConfig, RenderMode
from ..ops import bsdf as B
from ..scene.materials import Archetype
from ..ops.intersect import RT_MAX, make_anyhit_prim, make_intersectors
from ..ops.light_sampling import env_radiance, sample_lights
from ..utils.math import (
    add1,
    balance_heuristic,
    cartesian_to_spherical_unit,
    dot,
    normalize,
    pick1,
    put1,
    safe_div,
)
from ..utils import rng as R
from .scene_device import DeviceScene

QUERY_DIMS = 15  # pos3 + dir2 + normal2 + rough2 + diffuse3 + specular3


def make_query(pos, wo, normal, aux: B.BSDFAux, position_scale: float):
    """Assemble the compact radiance query (``nrc::addQuery``, hit.cu:589-617)."""
    sph_d = cartesian_to_spherical_unit(wo)
    sph_n = cartesian_to_spherical_unit(normal)
    return jnp.concatenate(
        [
            pos * position_scale,
            sph_d,
            sph_n,
            aux.roughness,
            aux.albedo_diffuse,
            aux.albedo_glossy,
        ],
        axis=-1,
    )


class WavefrontOut(NamedTuple):
    """Per-wavefront outputs (N = #rays)."""

    radiance: jnp.ndarray                 # [N, 3] path-traced radiance
    bounce_count: jnp.ndarray             # [N] i32 (time-view AOV)
    traced_count: jnp.ndarray             # [N] i32 rays actually cast
    #   (closest-hit segments with a live lane + shadow rays with a valid
    #   light sample) — the honest Mrays/s numerator; "potential" rays =
    #   N x (max_depth+1) x 2 assume every lane traces every segment
    render_query: jnp.ndarray             # [N, 13] query at truncation vertex
    last_render_throughput: jnp.ndarray   # [N, 3] (0 -> query unused)
    cache_vis_query: jnp.ndarray          # [N, 13] first non-specular vertex
    # training outputs (zero-sized slots in the render wavefront)
    rec_query: jnp.ndarray                # [N, D, 13]
    rec_ltp: jnp.ndarray                  # [N, D, 3] localThroughput
    rec_target: jnp.ndarray               # [N, D, 3]
    rec_count: jnp.ndarray                # [N] i32
    end_query: jnp.ndarray                # [N, 13] training-suffix end vertex
    end_mask: jnp.ndarray                 # [N] 1 self-train / 0 unbiased


class _State(NamedTuple):
    pos: jnp.ndarray
    wi: jnp.ndarray
    seed: jnp.ndarray
    throughput: jnp.ndarray
    radiance: jnp.ndarray
    pdf: jnp.ndarray            # pdf of previous BSDF event (0 = dirac)
    event: jnp.ndarray          # previous event bitmask
    alive: jnp.ndarray
    hit_before: jnp.ndarray     # apply scene epsilon (raygeneration.cu:175)
    area_spread: jnp.ndarray
    area_threshold: jnp.ndarray
    recorded_first: jnp.ndarray
    render_done: jnp.ndarray    # render part of the path has terminated
    suffix: jnp.ndarray         # in training suffix
    unbiased: jnp.ndarray
    full: jnp.ndarray           # per-tile record slots exhausted
    rec_count: jnp.ndarray
    ior_stack: jnp.ndarray      # [N, 4] nested-medium IORs (per_ray_data.h:81)
    sigma_a_stack: jnp.ndarray  # [N, 4, 3] absorption per stack level
    sigma_s_stack: jnp.ndarray  # [N, 4, 3] scattering per stack level
    bias_stack: jnp.ndarray     # [N, 4] HG anisotropy per level
    walk: jnp.ndarray           # [N] volume random-walk steps taken
    stack_idx: jnp.ndarray      # [N]
    pass_dist: jnp.ndarray      # [N] distance through cutout passthroughs
    bounces: jnp.ndarray        # [N] i32 work events (time-view AOV)
    traced: jnp.ndarray         # [N] i32 rays actually cast (see WavefrontOut)
    last_render_throughput: jnp.ndarray
    render_query: jnp.ndarray
    cache_vis_query: jnp.ndarray
    rec_query: jnp.ndarray
    rec_ltp: jnp.ndarray
    rec_target: jnp.ndarray
    end_query: jnp.ndarray
    end_mask: jnp.ndarray


def trace_wavefront(
    scene: DeviceScene,
    org: jnp.ndarray,        # [N, 3] primary ray origins
    direction: jnp.ndarray,  # [N, 3]
    seeds: jnp.ndarray,      # [N] u32 (after lens-jitter consumption)
    cfg: FrameConfig,
    train: bool,
    unbiased: Optional[jnp.ndarray] = None,  # [N] bool (train wavefront)
    queue_band: Optional[int] = None,  # compacted-queue band (see below)
    queue_mode: str = "every",  # "every" = per-depth compaction, "once"
    primary_hit=None,  # Optional[Hit]: precomputed depth-0 visibility
                       # (ops/raster_primary.py) — replaces the first
                       # closest_hit; identical winners by construction
) -> WavefrontOut:
    n = org.shape[0]
    d_rec = cfg.max_train_records_per_ray if train else 1
    import os as _os2

    closest_hit, any_hit = make_intersectors(scene.tris, scene.bvh)
    # Opt-in (a net loss on a cutout-heavy scene on an earlier accelerator:
    # its shadow rays mostly DO find a cutout prim, so the pre-pass rarely
    # resolves and its walk is pure overhead):
    anyhit_prim = (
        make_anyhit_prim(scene.tris, scene.bvh)
        if cfg.has_cutout
        and _os2.environ.get("NRC_CUTOUT_FAST", "0") == "1"
        else None
    )
    num_lights = scene.lights.num

    # curve primitives (hair): second intersection stream + chiang BSDF
    # (static branch — compiled in only when the scene has strands)
    has_curves = scene.curves is not None
    if has_curves:
        from ..ops import curve_intersect as IC
        from ..ops import hair_bsdf as H

    truncate = train or cfg.render_mode != RenderMode.NO_CACHE
    direct_lighting = cfg.direct_lighting and num_lights > 0
    eps = cfg.scene_epsilon

    # ---- merged per-material row fetch ---------------------------------
    # Every material field rides ONE row (``scene.mat_row``), fetched by a
    # plain gather: exact, and on the GPU faster than the one-hot matmul
    # it replaced.
    from .scene_device import mat_row_layout

    _mat_offs, _ = mat_row_layout(scene.mat_curve.shape[1])

    def fetch_mat_row(mid):
        return scene.mat_row[mid]

    def mcol(row, nm):
        a, b = _mat_offs[nm]
        return row[..., a] if b == a + 1 else row[..., a:b]

    def micol(row, nm):
        return mcol(row, nm).astype(jnp.int32)

    # Texture sampling + stochastic cutout transparency compile in only for
    # scenes that bind textures / declare cutout opacity (config static flags;
    # reference: MDL texture runtime + __anyhit__radiance_cutout,
    # hit.cu:1400-1423).
    has_tex = cfg.has_textures
    has_cutout = cfg.has_cutout
    if has_tex or has_cutout:
        from ..ops.texture import apply_uv_transform, sample_bilinear

    # MDL combinator materials (layers/mixes/modifiers) switch the shading
    # calls to the two-lobe blended family (ops/layered.py) — static branch,
    # zero cost for single-lobe scenes like Cornell.
    has_layered = cfg.has_layered
    if has_layered:
        from ..ops import layered as LY
    # measured BSDFs (df::measured_bsdf): data-driven lobes over the scene's
    # stacked measurement tables (ops/mbsdf.py; Device.cpp:3347-3663)
    has_measured = cfg.has_measured
    if has_measured:
        from ..ops import mbsdf as MB

    def cutout_opacity_at(prim, bu, bv):
        """cutout_opacity (scalar x texture mono average) at a hit — one
        tri_shade row gather + one material row fetch (shadow-hop path)."""
        tsr2 = scene.tri_shade[prim]
        uvp2 = tsr2[..., 18:24]
        m2 = jax.lax.bitcast_convert_type(tsr2[..., 24:26], jnp.int32)[..., 0]
        row2 = fetch_mat_row(m2)
        wb = 1.0 - bu - bv
        uv = (
            wb[..., None] * uvp2[..., 0:2]
            + bu[..., None] * uvp2[..., 2:4]
            + bv[..., None] * uvp2[..., 4:6]
        )
        uv = apply_uv_transform(uv, mcol(row2, "uv_xf"))
        rgba = sample_bilinear(scene.atlas, micol(row2, "cutout_tex"), uv)
        return mcol(row2, "cutout_opacity") * jnp.mean(rgba[..., :3], axis=-1)

    # textured mesh-light EDFs sampled by NEE (hit.cu:1545-1651)
    nee_tex_ctx = None
    if has_tex and num_lights:
        l_mid = jnp.maximum(scene.lights.material_id, 0)
        l_tex = jnp.where(
            scene.lights.material_id >= 0, scene.mat_emission_tex[l_mid], -1
        )
        # ONE [L, 7] row (tex id as f32 | uv transform) — the sampler pays
        # a single gather for the textured-EDF context
        nee_tex_ctx = (
            scene.atlas,
            jnp.concatenate(
                [l_tex.astype(jnp.float32)[:, None], scene.mat_uv_xf[l_mid]],
                axis=-1,
            ),
        )

    if unbiased is None:
        unbiased = jnp.zeros((n,), bool)

    sqrt_c = cfg.area_spread_sqrt  # sqrt(c), paper Eq. 4; default c = 0.01

    # Volume transport compiles in only when some material declares volume
    # coefficients (homogeneous media; raygeneration.cu:184-213, miss.cu:62-79).
    # Static: set from the host material table at scene build (FrameConfig).
    has_volumes = cfg.has_volumes

    def zero3():
        return jnp.zeros((n, 3), jnp.float32)

    state = _State(
        pos=org,
        wi=direction,
        seed=seeds,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=zero3(),
        pdf=jnp.zeros((n,), jnp.float32),
        event=jnp.full((n,), B.BSDF_EVENT_ABSORB, jnp.int32),
        alive=jnp.ones((n,), bool),
        hit_before=jnp.zeros((n,), bool),
        area_spread=jnp.zeros((n,), jnp.float32),
        area_threshold=jnp.full((n,), jnp.inf, jnp.float32),
        recorded_first=jnp.zeros((n,), bool),
        render_done=jnp.zeros((n,), bool),
        suffix=jnp.zeros((n,), bool),
        unbiased=unbiased if train else jnp.zeros((n,), bool),
        full=jnp.zeros((n,), bool),
        rec_count=jnp.zeros((n,), jnp.int32),
        ior_stack=jnp.ones((n, 4), jnp.float32),
        sigma_a_stack=jnp.zeros((n, 4, 3), jnp.float32),
        sigma_s_stack=jnp.zeros((n, 4, 3), jnp.float32),
        bias_stack=jnp.zeros((n, 4), jnp.float32),
        walk=jnp.zeros((n,), jnp.int32),
        stack_idx=jnp.zeros((n,), jnp.int32),
        pass_dist=jnp.zeros((n,), jnp.float32),
        bounces=jnp.zeros((n,), jnp.int32),
        traced=jnp.zeros((n,), jnp.int32),
        last_render_throughput=zero3(),
        render_query=jnp.zeros((n, QUERY_DIMS), jnp.float32),
        cache_vis_query=jnp.zeros((n, QUERY_DIMS), jnp.float32),
        rec_query=jnp.zeros((n, d_rec, QUERY_DIMS), jnp.float32),
        rec_ltp=jnp.zeros((n, d_rec, 3), jnp.float32),
        rec_target=jnp.zeros((n, d_rec, 3), jnp.float32),
        end_query=jnp.zeros((n, QUERY_DIMS), jnp.float32),
        end_mask=jnp.zeros((n,), jnp.float32),
    )

    def add_to_last_record(s: _State, amount, mask):
        """targets[lastTrainRecordIndex] += amount (miss.cu:144-147, hit.cu:817)."""
        if not train:
            return s
        rows = jnp.arange(s.rec_count.shape[0])
        has_rec = s.rec_count > 0
        slot = jnp.maximum(s.rec_count - 1, 0)
        m = mask & has_rec & ~s.full
        return s._replace(rec_target=add1(s.rec_target, slot, amount, m))

    def bounce(s: _State, first: bool, depth_val):
        """One wavefront bounce. ``first`` is static (threshold vs spread
        branch); ``depth_val`` is a traced scalar (RR min-depth check).

        Shape-polymorphic over the lane count: the queued driver below
        applies this body to compacted bands narrower than the wavefront."""
        n = s.pos.shape[0]
        rows = jnp.arange(n)
        active = s.alive
        wo = -s.wi
        tmin = jnp.where(s.hit_before, eps, 0.0)
        # inactive lanes trace a degenerate ray (t range empty)
        tmax = jnp.where(active, RT_MAX, 0.0)
        seed = s.seed

        # ---- volume random walk: sample scatter distance ---------------
        # (raygeneration.cu:184-213: inside a scattering medium, cap tmax by
        # a channel-importance-sampled free-flight distance)
        in_walk = jnp.zeros((n,), bool)
        if has_volumes:
            top_sa = pick1(s.sigma_a_stack, s.stack_idx)
            top_ss = pick1(s.sigma_s_stack, s.stack_idx)
            sigma_t = top_sa + top_ss
            scattering = (s.stack_idx > 0) & (jnp.max(top_ss, axis=-1) > 0.0)
            in_walk = scattering & active
            can_step = in_walk & (s.walk < cfg.walk_length)
            seed, xi_w = R.rng2(seed)
            albedo = safe_div(top_ss, sigma_t)
            wgt = s.throughput * albedo
            wsum = jnp.sum(wgt, axis=-1)
            pdf_volume = jnp.where(
                (wsum > 0.0)[..., None], wgt / jnp.maximum(wsum, 1e-20)[..., None],
                jnp.full_like(wgt, 1.0 / 3.0),
            )
            cdf0 = pdf_volume[:, 0]
            cdf1 = cdf0 + pdf_volume[:, 1]
            s_chan = jnp.where(
                xi_w[:, 0] < cdf0, sigma_t[:, 0],
                jnp.where(xi_w[:, 0] < cdf1, sigma_t[:, 1], sigma_t[:, 2]),
            )
            dist_sample = -jnp.log(jnp.maximum(1.0 - xi_w[:, 1], 1e-12)) / jnp.maximum(
                s_chan, 1e-12
            )
            tmax = jnp.where(can_step, jnp.minimum(tmax, dist_sample), tmax)

        # depth 0 of the render wavefront may arrive pre-resolved by the
        # tiled raster (tmin/tmax are exactly 0/RT_MAX there: no medium
        # distance sampling before the first hit — stack_idx starts 0)
        if first and primary_hit is not None:
            hit = primary_hit
        else:
            hit = closest_hit(s.pos, s.wi, tmin, tmax)
        is_curve = jnp.zeros((n,), bool)
        if has_curves:
            c_hit = IC.intersect_curves_bvh(
                s.pos, s.wi, scene.curve_bvh, scene.curves, tmin, tmax
            )
            tri_t = jnp.where(hit.valid, hit.t, RT_MAX)
            cur_t = jnp.where(c_hit.valid, c_hit.t, RT_MAX)
            is_curve = c_hit.valid & (cur_t < tri_t)
            hit = hit._replace(t=jnp.where(is_curve, c_hit.t, hit.t))
            any_valid = hit.valid | is_curve
        else:
            any_valid = hit.valid
        hit_valid = any_valid & active

        tri = jnp.maximum(hit.prim, 0)
        w_bary = 1.0 - hit.u - hit.v
        p_hit = s.pos + hit.t[..., None] * s.wi
        # ONE tri_shade row gather for ALL the hit's triangle-side inputs
        # (geometry edges, shading normals, texcoords, meta) instead of 3-4
        # same-index gathers
        tsr = scene.tri_shade[tri]                       # [N, 26]
        e1 = tsr[..., 3:6]
        e2 = tsr[..., 6:9]
        ng = normalize(jnp.cross(e1, e2))
        tsh = tsr[..., 9:18]
        ns = normalize(
            w_bary[..., None] * tsh[..., 0:3]
            + hit.u[..., None] * tsh[..., 3:6]
            + hit.v[..., None] * tsh[..., 6:9]
        )
        uvp_hit = tsr[..., 18:24]                        # uv0 | uv1 | uv2
        tmeta = jax.lax.bitcast_convert_type(
            tsr[..., 24:26], jnp.int32
        )                                                # [N, 2] i32
        mid = tmeta[..., 0]
        tri_light_id = tmeta[..., 1]
        if has_curves:
            cprim = jnp.maximum(c_hit.prim, 0)
            cframe = IC.curve_shading_frame(scene.curves, cprim, p_hit)
            ng = jnp.where(is_curve[..., None], cframe.normal, ng)
            ns = jnp.where(is_curve[..., None], cframe.normal, ns)
            mid = jnp.where(is_curve, scene.curves.material_id[cprim], mid)

        # ---- textures + stochastic cutout (hit.cu:1400-1423) ----------
        # A cutout surface passes the ray through with probability
        # 1 - opacity: the lane keeps its direction/throughput/MIS state and
        # re-traces from the hit point next bounce (the wavefront equivalent
        # of optixIgnoreIntersection in the anyhit program).
        mrow = fetch_mat_row(mid)                        # [N, W] ONE fetch
        albedo = mcol(mrow, "albedo")
        albedo2_val = mcol(mrow, "albedo2") if has_layered else None
        if cfg.has_noise:
            # procedural noise tint at the WORLD hit position
            # (base::perlin/flow/worley_noise_texture driving the diffuse
            # tint — noise_*_glossy.mdl; ops/noise.py, shade-time elementwise math
            # math); noise_target routes it to the lobe whose diffuse the
            # MDL graph tinted (the shipped materials: base of a
            # fresnel/weighted layer = lobe 2)
            from ..ops import noise as NZ

            nz_mode = micol(mrow, "noise_mode")
            nz_tgt = micol(mrow, "noise_target")
            nz_tint = NZ.noise_tint(
                nz_mode, p_hit,
                mcol(mrow, "noise_color1"), mcol(mrow, "noise_color2"),
                mcol(mrow, "noise_scale"), cfg.noise_levels_static,
                micol(mrow, "noise_absolute"),
                mcol(mrow, "noise_thr")[..., 0],
                mcol(mrow, "noise_thr")[..., 1],
                micol(mrow, "noise_marble"),
            )
            albedo = jnp.where(
                ((nz_mode > 0) & (nz_tgt == 0))[..., None], nz_tint, albedo
            )
            if albedo2_val is not None:
                albedo2_val = jnp.where(
                    ((nz_mode > 0) & (nz_tgt == 1))[..., None],
                    nz_tint, albedo2_val,
                )
            if cfg.has_noise_bump:
                # *_noise_bump_texture: shading-normal perturbation by the
                # noise field's tangential gradient (forward differences)
                ns = NZ.noise_bump_normal(
                    nz_mode, p_hit, ns,
                    mcol(mrow, "noise_scale"), cfg.noise_levels_static,
                    micol(mrow, "noise_absolute"),
                    mcol(mrow, "noise_thr")[..., 0],
                    mcol(mrow, "noise_thr")[..., 1],
                    micol(mrow, "noise_marble"),
                    jnp.where(
                        nz_mode > 0, mcol(mrow, "noise_bump_factor"), 0.0
                    ),
                )
        passthrough = jnp.zeros((n,), bool)
        if has_tex or has_cutout:
            # texcoord from the already-gathered tri_shade row + the
            # material row's uv transform (no extra gathers)
            uv_raw = (
                w_bary[..., None] * uvp_hit[..., 0:2]
                + hit.u[..., None] * uvp_hit[..., 2:4]
                + hit.v[..., None] * uvp_hit[..., 4:6]
            )
            uv_hit = apply_uv_transform(uv_raw, mcol(mrow, "uv_xf"))
        if has_tex:
            tex_rgb = sample_bilinear(
                scene.atlas, micol(mrow, "albedo_tex"), uv_hit
            )[..., :3]
            albedo = albedo * jnp.where(is_curve[..., None], 1.0, tex_rgb)
        if has_cutout:
            rgba_cut = sample_bilinear(
                scene.atlas, micol(mrow, "cutout_tex"), uv_hit
            )
            opacity = mcol(mrow, "cutout_opacity") * jnp.mean(
                rgba_cut[..., :3], axis=-1
            )
            seed, u_cut = R.rng(seed)
            passthrough = hit_valid & ~is_curve & (u_cut >= opacity)
            hit_valid = hit_valid & ~passthrough
        # cumulative distance across passthrough segments: the reference's
        # single optixTrace accumulates t across ignored anyhits, so the
        # area-spread distances must include it (hit.cu:536,569)
        t_eff = hit.t + s.pass_dist if has_cutout else hit.t

        ior_m = mcol(mrow, "ior")
        thin_m = micol(mrow, "thin_walled")
        params = B.MaterialParams(
            archetype=micol(mrow, "archetype"),
            albedo=albedo,
            roughness=mcol(mrow, "roughness"),
            ior=ior_m,
            thin_walled=thin_m,
        )
        if has_layered:
            params2 = B.MaterialParams(
                archetype=micol(mrow, "archetype2"),
                albedo=albedo2_val,
                roughness=mcol(mrow, "roughness2"),
                ior=ior_m,
                thin_walled=thin_m,
            )
            k_curve = scene.mat_curve.shape[1]
            bp = LY.BlendParams(
                blend_mode=micol(mrow, "blend_mode"),
                w1=mcol(mrow, "blend_w1"),
                w2=mcol(mrow, "blend_w2"),
                blend_ior=mcol(mrow, "blend_ior"),
                curve=mcol(mrow, "curve").reshape(n, k_curve, 3),
                mod_mode=micol(mrow, "mod_mode"),
                mod_a=mcol(mrow, "mod_a"),
                mod_b=mcol(mrow, "mod_b"),
                mod_exp=mcol(mrow, "mod_exp"),
            )
        front = dot(wo, ng) >= 0.0
        flip = ~front
        ns_q = jnp.where(flip[..., None], -ns, ns)  # query normal (hit.cu:600)

        prev_non_dirac = (s.event & B.BSDF_EVENT_NON_DIRAC) != 0

        # ---- volume interactions ---------------------------------------
        throughput0 = s.throughput
        walk = s.walk
        pos_volume = s.pos
        wi_volume = s.wi
        hit_before = s.hit_before
        scatter_miss = jnp.zeros((n,), bool)
        if has_volumes:
            # transmittance along the segment inside a medium (hit.cu:688-697).
            # When free-flight distance sampling is active, a surface hit at t
            # already implies survival of the sampled distance — probability
            # P(d>t) = sum_c p_c exp(-sigma_tc t) — so the estimator weight is
            # trans/P(d>t) (the reference multiplies bare trans at hit.cu:692,
            # double-attenuating scattering media; we use the unbiased weight,
            # which reduces to the reference's for absorption-only media).
            in_medium = (s.stack_idx > 0) & (hit_valid | passthrough)
            trans_hit = jnp.exp(-sigma_t * hit.t[..., None])
            p_surv = jnp.sum(pdf_volume * trans_hit, axis=-1)
            w_hit = jnp.where(
                can_step[..., None],
                trans_hit / jnp.maximum(p_surv, 1e-20)[..., None],
                trans_hit,
            )
            throughput0 = jnp.where(
                in_medium[..., None], throughput0 * w_hit, throughput0
            )
            walk = walk + in_medium.astype(jnp.int32)
            # scatter-miss: the free-flight ray ended inside the medium
            # (miss.cu stepVolume:62-79): advance, reweight, new HG direction
            scatter_miss = can_step & ~any_valid
            pos_volume = jnp.where(
                scatter_miss[..., None],
                s.pos + s.wi * dist_sample[..., None],
                s.pos,
            )
            trans_m = jnp.exp(-sigma_t * dist_sample[..., None])
            pdf_m = jnp.sum(pdf_volume * sigma_t * trans_m, axis=-1)
            tp_m = top_ss * trans_m / jnp.maximum(pdf_m, 1e-20)[..., None]
            throughput0 = jnp.where(
                scatter_miss[..., None], throughput0 * tp_m, throughput0
            )
            walk = walk + scatter_miss.astype(jnp.int32)
            # Henyey-Greenstein direction about the current direction
            # (raygeneration.cu:74-104)
            seed, xi_hg = R.rng2(seed)
            g = pick1(s.bias_stack, s.stack_idx)
            iso = jnp.abs(g) < 1e-3
            sq = (1.0 - g * g) / jnp.maximum(1.0 - g + 2.0 * g * xi_hg[:, 0], 1e-12)
            g_safe = jnp.where(iso, 1.0, g)
            cos_hg = jnp.where(
                iso,
                1.0 - 2.0 * xi_hg[:, 0],
                (1.0 + g * g - sq * sq) / (2.0 * g_safe),
            )
            sin_hg = jnp.sqrt(jnp.maximum(1.0 - cos_hg * cos_hg, 0.0))
            phi_hg = 2.0 * jnp.pi * xi_hg[:, 1]
            local = jnp.stack(
                [jnp.cos(phi_hg) * sin_hg, jnp.sin(phi_hg) * sin_hg, cos_hg], -1
            )
            from ..utils.math import build_onb, to_world

            tb, bb = build_onb(s.wi)
            hg_dir = to_world(tb, bb, s.wi, local)
            wi_volume = jnp.where(scatter_miss[..., None], hg_dir, s.wi)
            # a volume step is not a surface hit: next segment starts at the
            # scatter point with tmin 0 (no FLAG_HIT -> no epsilon offset)
            hit_before = jnp.where(scatter_miss, False, hit_before)
        s = s._replace(throughput=throughput0)

        # ---- miss: environment ---------------------------------------
        miss = active & ~any_valid & ~scatter_miss
        radiance = s.radiance
        env_em, env_pdf, has_env = env_radiance(scene.lights, s.wi)
        if has_env:
            w_mis = jnp.where(
                direct_lighting & prev_non_dirac,
                balance_heuristic(s.pdf, env_pdf),
                1.0,
            )
            contrib = s.throughput * env_em * w_mis[..., None]
            add_pixel = miss & ~s.suffix
            radiance = radiance + jnp.where(add_pixel[..., None], contrib, 0.0)
            s = add_to_last_record(s, contrib, miss)
        # miss terminates: render query unused (lastRenderThroughput = 0,
        # miss.cu:97-104), train suffix ends unbiased (mask stays 0)
        lrt = jnp.where(
            (miss & ~s.render_done)[..., None], 0.0, s.last_render_throughput
        )
        alive = s.alive & ~miss

        # ---- emission of hit surface (mesh lights, hit.cu:738-821) ----
        em_rad = mcol(mrow, "emission_radiance")
        if has_tex:
            em_rad = em_rad * sample_bilinear(
                scene.atlas, micol(mrow, "emission_tex"), uv_hit
            )[..., :3]
        light_idx = tri_light_id
        area = scene.lights.area[jnp.maximum(light_idx, 0)] if num_lights else jnp.ones_like(hit.t)
        cos_e = dot(ns, wo)
        emissive = hit_valid & front & (jnp.max(em_rad, axis=-1) > 0.0) & (cos_e > 0.0)
        if num_lights:
            pdf_hit = safe_div(hit.t * hit.t, area * cos_e)
            w_mis_e = jnp.where(
                direct_lighting & prev_non_dirac,
                balance_heuristic(s.pdf, pdf_hit),
                1.0,
            )
            emission = s.throughput * em_rad * w_mis_e[..., None]
            add_pixel = emissive & ~s.suffix
            radiance = radiance + jnp.where(add_pixel[..., None], emission, 0.0)
            s = add_to_last_record(s, emission, emissive)

        # ---- area-spread termination decision (hit.cu:527-585) --------
        abs_cos = jnp.abs(dot(wo, ns))
        if first:
            threshold = sqrt_c * safe_div(
                t_eff, jnp.sqrt(4.0 * jnp.pi * jnp.maximum(abs_cos, 1e-12))
            )
            area_threshold = jnp.where(hit_valid, threshold, s.area_threshold)
            area_spread = s.area_spread
            terminate = jnp.zeros((n,), bool)
        else:
            area_threshold = s.area_threshold
            if has_cutout:
                # first REAL hit came after a cutout passthrough: the camera
                # threshold (depth-0 formula) is still unset — set it now
                need_thr = hit_valid & jnp.isinf(s.area_threshold)
                thr0 = sqrt_c * safe_div(
                    t_eff, jnp.sqrt(4.0 * jnp.pi * jnp.maximum(abs_cos, 1e-12))
                )
                area_threshold = jnp.where(need_thr, thr0, area_threshold)
            not_unbiased_suffix = ~(s.unbiased & s.suffix)
            prev_specular = (s.event & B.BSDF_EVENT_SPECULAR) != 0
            pdf_prev = jnp.where(s.pdf == 0.0, jnp.inf, s.pdf)
            delta = safe_div(t_eff, jnp.sqrt(pdf_prev * jnp.maximum(abs_cos, 1e-12)))
            accum = hit_valid & not_unbiased_suffix & ~prev_specular
            area_spread = s.area_spread + jnp.where(accum, delta, 0.0)
            terminate = accum & (area_spread > area_threshold)
        if not truncate:
            terminate = jnp.zeros((n,), bool)

        # ---- BSDF sample ---------------------------------------------
        seed, xi = R.rng4(seed)
        top = pick1(s.ior_stack, s.stack_idx)
        below = pick1(s.ior_stack, jnp.maximum(s.stack_idx - 1, 0))
        thin = params.thin_walled != 0
        eta_i = jnp.where(front | thin, top, params.ior)
        eta_t = jnp.where(front | thin, params.ior, below)
        if has_layered:
            seed, xi_lobe = R.rng(seed)
            sample = LY.layered_sample(
                params, params2, bp, wo, ns, ng,
                jnp.concatenate([xi, xi_lobe[..., None]], axis=-1),
                eta_i, eta_t, families=cfg.archetype_set,
            )
        else:
            sample = B.bsdf_sample(
                params, wo, ns, ng, xi, eta_i, eta_t,
                families=cfg.archetype_set,
            )
        if has_measured:
            is_measured = params.archetype == int(Archetype.MEASURED)
            nf_m = jnp.where(dot(wo, ns)[..., None] >= 0.0, ns, -ns)
            mb_idx = jnp.maximum(micol(mrow, "mbsdf_index"), 0)
            mb_mult = mcol(mrow, "mbsdf_multiplier")
            wi_m, w_m, pdf_m, trans_m, ok_m = MB.measured_sample(
                scene.mbsdf, mb_idx, mb_mult, wo, nf_m, xi[..., :3]
            )
            ev_m = jnp.where(
                ok_m,
                jnp.where(
                    trans_m,
                    np.int32(B.BSDF_EVENT_GLOSSY_TRANSMISSION),
                    np.int32(B.BSDF_EVENT_GLOSSY_REFLECTION),
                ),
                np.int32(B.BSDF_EVENT_ABSORB),
            )
            sample = B.BSDFSample(
                wi=jnp.where(is_measured[..., None], wi_m, sample.wi),
                bsdf_over_pdf=jnp.where(
                    is_measured[..., None], w_m, sample.bsdf_over_pdf
                ),
                pdf=jnp.where(is_measured, pdf_m, sample.pdf),
                event=jnp.where(is_measured, ev_m, sample.event),
            )
        if has_curves:
            # chiang hair BSDF on curve hits, in the fiber frame
            # (bsdf_hair.mdl; frame = tangent + per-strand azimuthal basis)
            hair_r = mcol(mrow, "hair_roughness").reshape(n, 3, 2)
            hpar = H.HairParams(
                sigma_a=mcol(mrow, "hair_absorption"),
                ior=ior_m,
                beta_m=hair_r[..., 0],
                beta_n=hair_r[..., 1],
                cuticle_angle=mcol(mrow, "hair_cuticle"),
                diffuse_weight=mcol(mrow, "hair_diffuse_weight"),
                diffuse_tint=mcol(mrow, "albedo") * cframe.color,
            )
            ct, cb1, cb2 = cframe.tangent, cframe.b1, cframe.b2

            def to_fiber(v):
                return jnp.stack(
                    [dot(v, ct), dot(v, cb1), dot(v, cb2)], axis=-1
                )

            def from_fiber(v):
                return (
                    v[..., 0:1] * ct + v[..., 1:2] * cb1 + v[..., 2:3] * cb2
                )

            # h: normalized azimuthal offset of the ray across the fiber
            b_view = jnp.cross(s.wi, ct)
            b_view = b_view / jnp.maximum(
                jnp.linalg.norm(b_view, axis=-1, keepdims=True), 1e-9
            )
            h_fib = jnp.clip(dot(cframe.normal, b_view), -1.0, 1.0)
            wo_l = to_fiber(wo)
            wi_l, w_over_h, pdf_h = H.hair_sample(hpar, wo_l, h_fib, xi)
            is_hair = is_curve & (params.archetype == int(Archetype.HAIR))
            sample = B.BSDFSample(
                wi=jnp.where(is_hair[..., None], from_fiber(wi_l), sample.wi),
                bsdf_over_pdf=jnp.where(
                    is_hair[..., None], w_over_h, sample.bsdf_over_pdf
                ),
                pdf=jnp.where(is_hair, pdf_h, sample.pdf),
                event=jnp.where(
                    is_hair & (pdf_h > 0.0),
                    np.int32(B.BSDF_EVENT_GLOSSY_REFLECTION),
                    jnp.where(is_hair, np.int32(B.BSDF_EVENT_ABSORB), sample.event),
                ),
            )
        # volume scatter steps and cutout passthroughs keep the previous
        # surface event/pdf for MIS (stepVolume miss.cu:62-79; ignored anyhit)
        event = jnp.where(
            hit_valid,
            sample.event,
            jnp.where(
                scatter_miss | passthrough, s.event, np.int32(B.BSDF_EVENT_ABSORB)
            ),
        )
        event_non_dirac = (event & B.BSDF_EVENT_NON_DIRAC) != 0
        event_specular = (event & B.BSDF_EVENT_SPECULAR) != 0

        # ---- aux + cache-vis query (hit.cu:888-898) -------------------
        aux = (
            LY.layered_aux(params, params2, bp, wo, ns)
            if has_layered else B.bsdf_aux(params)
        )
        if has_measured:
            alb_g = MB.measured_aux(scene.mbsdf, mb_idx, mb_mult, wo, nf_m)
            aux = B.BSDFAux(
                albedo_diffuse=jnp.where(
                    is_measured[..., None], 0.0, aux.albedo_diffuse
                ),
                albedo_glossy=jnp.where(
                    is_measured[..., None], alb_g, aux.albedo_glossy
                ),
                roughness=jnp.where(is_measured[..., None], 1.0, aux.roughness),
            )
        if has_curves:
            hair_rough = mcol(mrow, "hair_roughness")[..., 0:2]
            aux = B.BSDFAux(
                albedo_diffuse=jnp.where(
                    is_hair[..., None], hpar.diffuse_tint, aux.albedo_diffuse
                ),
                albedo_glossy=jnp.where(
                    is_hair[..., None],
                    jnp.exp(-hpar.sigma_a) * cframe.color,
                    aux.albedo_glossy,
                ),
                roughness=jnp.where(is_hair[..., None], hair_rough, aux.roughness),
            )
        query_here = make_query(p_hit, wo, ns_q, aux, cfg.position_scale)
        first_ns = hit_valid & ~s.recorded_first & ~event_specular
        cache_vis_query = jnp.where(
            first_ns[..., None], query_here, s.cache_vis_query
        )
        recorded_first = s.recorded_first | first_ns

        # ---- early absorb (hit.cu:900-920) ----------------------------
        absorbed = hit_valid & (event == B.BSDF_EVENT_ABSORB)
        lrt = jnp.where(
            (absorbed & ~s.suffix & ~s.render_done)[..., None], 0.0, lrt
        )
        alive = alive & ~absorbed

        # ---- area-spread termination handling (hit.cu:924-971) --------
        term = hit_valid & terminate & ~absorbed & alive
        render_query = s.render_query
        end_query = s.end_query
        end_mask = s.end_mask
        suffix = s.suffix
        area_spread2 = area_spread
        render_done = s.render_done

        if not train:
            # pure render ray: query + lastRenderThroughput, then stop
            render_query = jnp.where(term[..., None], query_here, render_query)
            lrt = jnp.where(term[..., None], s.throughput, lrt)
            alive = alive & ~term
            render_done = render_done | term
        else:
            # suffix end -> self-train terminal vertex (hit.cu:933-940)
            end_self = term & suffix
            end_query = jnp.where(end_self[..., None], query_here, end_query)
            end_mask = jnp.where(end_self, 1.0, end_mask)
            alive = alive & ~end_self
            # render-path end -> switch into suffix (hit.cu:941-959);
            # if records already overflowed, stop (hit.cu:950-953)
            to_suffix = term & ~suffix
            alive = alive & ~(to_suffix & s.full)
            suffix = suffix | to_suffix
            area_spread2 = jnp.where(to_suffix, 0.0, area_spread)
            render_done = render_done | to_suffix

        # ---- allocate training record (hit.cu:975-1028) ---------------
        rec_query, rec_ltp, rec_target = s.rec_query, s.rec_ltp, s.rec_target
        rec_count, full = s.rec_count, s.full
        allocated = jnp.zeros((n,), bool)
        if train:
            want = alive & hit_valid & event_non_dirac & ~full
            slot = rec_count
            overflow = want & (slot >= d_rec)
            do_alloc = want & (slot < d_rec)
            slot_c = jnp.minimum(slot, d_rec - 1)
            rec_query = put1(rec_query, slot_c, query_here, do_alloc)
            rec_ltp = put1(rec_ltp, slot_c, sample.bsdf_over_pdf, do_alloc)
            rec_count = rec_count + do_alloc.astype(jnp.int32)
            allocated = do_alloc
            # overflow: forced self-train end at this vertex (hit.cu:1009-1027)
            end_query = jnp.where(overflow[..., None], query_here, end_query)
            end_mask = jnp.where(overflow, 1.0, end_mask)
            full = full | overflow
            alive = alive & ~overflow  # wavefront B has nothing left to do

        # ---- NEE / direct lighting (hit.cu:343-443, 1030-1056) --------
        shadow_traced = jnp.zeros((n,), jnp.int32)
        if direct_lighting:
            seed, xi_l = R.rng4(seed)
            ls = sample_lights(scene.lights, p_hit, xi_l, tex_ctx=nee_tex_ctx)
            ev = (
                LY.layered_eval(
                    params, params2, bp, wo, ls.direction, ns, eta_i, eta_t,
                    families=cfg.archetype_set,
                )
                if has_layered
                else B.bsdf_eval(
                    params, wo, ls.direction, ns, eta_i, eta_t,
                    families=cfg.archetype_set,
                )
            )
            if has_measured:
                fcos_m, pdf_em = MB.measured_eval(
                    scene.mbsdf, mb_idx, mb_mult, wo, ls.direction, nf_m
                )
                ev = B.BSDFEval(
                    bsdf=jnp.where(is_measured[..., None], fcos_m, ev.bsdf),
                    pdf=jnp.where(is_measured, pdf_em, ev.pdf),
                )
            if has_curves:
                f_h, pdf_eh = H.hair_eval(hpar, wo_l, to_fiber(ls.direction), h_fib)
                ev = B.BSDFEval(
                    bsdf=jnp.where(is_hair[..., None], f_h, ev.bsdf),
                    pdf=jnp.where(is_hair, pdf_eh, ev.pdf),
                )
            do_nee = alive & hit_valid & event_non_dirac
            valid_ls = (ls.pdf > 0.0) & (jnp.max(ev.bsdf, axis=-1) > 0.0) & (ev.pdf > 0.0)
            # MIS weight + unoccluded contribution BEFORE the shadow trace
            # (they do not depend on occlusion) so the shadow-ray RR below
            # can see what the ray would contribute.
            w_mis_l = jnp.where(
                ls.is_singular, 1.0, balance_heuristic(ls.pdf, ev.pdf)
            )
            direct = (
                ev.bsdf
                * ls.radiance_over_pdf
                * (float(num_lights) * w_mis_l)[..., None]
            )
            if cfg.nee_rr_tau > 0.0:
                # Shadow-ray Russian roulette (see FrameConfig.nee_rr_tau):
                # survive with p = lum(unoccluded contribution)/tau, scale
                # by 1/p — unbiased. Pixel rays weight by path throughput
                # (what the pixel would receive); training rays use the raw
                # record target. The uniform is ONE LCG step of the
                # xor-perturbed seed — a side stream — so per-lane main
                # sample streams are bit-identical with the feature on/off.
                ref_rgb = direct if train else s.throughput * direct
                lum_sh = (
                    0.3 * ref_rgb[..., 0] + 0.59 * ref_rgb[..., 1]
                    + 0.11 * ref_rgb[..., 2]
                )
                p_sh = jnp.clip(lum_sh * (1.0 / cfg.nee_rr_tau), 0.05, 1.0)
                _, u_sh_rr = R.rng(seed ^ np.uint32(0x9E3779B9))
                valid_ls = valid_ls & (u_sh_rr < p_sh)
                direct = direct * (1.0 / p_sh)[..., None]
            shadow_tmax = jnp.where(
                do_nee & valid_ls, ls.distance - eps, 0.0
            )
            if has_cutout:
                # stochastic transparency along the shadow ray: a cutout
                # surface blocks with probability = opacity, else the ray
                # re-traces beyond it (__anyhit__shadow_cutout semantics,
                # hit.cu:1447-1468). 3 hops cover stacked cutouts; the tail
                # is treated as visible (transparent hits never occlude).
                # The hops run under a while_loop that exits as soon as
                # every lane's shadow ray resolved (almost always hop 1) —
                # the unrolled version paid 3 full traversal rounds per NEE
                # and compiled 3 traversal instances. The per-hop uniforms
                # are PRE-drawn so the per-lane RNG stream is bit-identical
                # to the unrolled form regardless of the exit hop.
                u_sh_hops = []
                for _ in range(3):
                    seed, u_h = R.rng(seed)
                    u_sh_hops.append(u_h)
                u_sh_hops = jnp.stack(u_sh_hops)             # [3, N]

                # Fast path: ONE any-hit pre-pass resolves the
                # two common cases without any closest-hit hop round —
                # no primitive on the ray (visible) or an arbitrary found
                # primitive whose material cannot be cut out (occluded:
                # a solid blocker occludes regardless of any cutouts in
                # front of it). Only lanes whose found prim IS
                # cutout-capable enter the stochastic hop loop; the rest
                # arrive there sh_done and pool into dead traversal
                # chunks. Hop results are unchanged in distribution: the
                # reference's anyhit visits primitives in arbitrary order
                # too (__anyhit__shadow_cutout, hit.cu:1447-1468).
                pre_occluded = jnp.zeros((n,), bool)
                pre_resolved = jnp.zeros((n,), bool)
                if anyhit_prim is not None:
                    pre_prim = anyhit_prim(
                        p_hit, ls.direction, jnp.full((n,), eps), shadow_tmax
                    )
                    shadow_traced = shadow_traced + (
                        shadow_tmax > 0.0
                    ).astype(jnp.int32)
                    tsr_s = scene.tri_shade[jnp.maximum(pre_prim, 0)]
                    m_s = jax.lax.bitcast_convert_type(
                        tsr_s[..., 24:26], jnp.int32
                    )[..., 0]
                    row_s = fetch_mat_row(m_s)
                    can_cut = (micol(row_s, "cutout_tex") >= 0) | (
                        mcol(row_s, "cutout_opacity") < 1.0
                    )
                    found = pre_prim >= 0
                    pre_occluded = found & ~can_cut
                    pre_resolved = ~found | pre_occluded

                def sh_body(c):
                    occluded, sh_tmin, sh_done, shadow_traced, hop = c
                    shadow_traced = shadow_traced + (~sh_done).astype(jnp.int32)
                    sh = closest_hit(
                        p_hit, ls.direction, sh_tmin,
                        jnp.where(sh_done, 0.0, shadow_tmax),
                    )
                    sh_prim = jnp.maximum(sh.prim, 0)
                    op = cutout_opacity_at(sh_prim, sh.u, sh.v)
                    u_sh = jax.lax.dynamic_index_in_dim(
                        u_sh_hops, hop, keepdims=False
                    )
                    blocked = sh.valid & (u_sh < op) & ~sh_done
                    occluded = occluded | blocked
                    cont = sh.valid & ~blocked & ~sh_done
                    sh_tmin = jnp.where(cont, sh.t + eps, sh_tmin)
                    sh_done = sh_done | ~cont
                    return occluded, sh_tmin, sh_done, shadow_traced, hop + 1

                occluded, _, _, shadow_traced, _ = jax.lax.while_loop(
                    lambda c: (c[4] < 3) & ~jnp.all(c[2]),
                    sh_body,
                    (
                        pre_occluded,
                        jnp.full((n,), eps),
                        (shadow_tmax <= 0.0) | pre_resolved,
                        shadow_traced,
                        jnp.int32(0),
                    ),
                )
            else:
                occluded = any_hit(
                    p_hit, ls.direction, jnp.full((n,), eps), shadow_tmax
                )
                shadow_traced = (shadow_tmax > 0.0).astype(jnp.int32)
            if has_curves:
                occluded = occluded | IC.occluded_curves_bvh(
                    p_hit, ls.direction, scene.curve_bvh, scene.curves,
                    jnp.full((n,), eps), shadow_tmax,
                )
            ok = do_nee & valid_ls & ~occluded
            direct = jnp.where(ok[..., None], direct, 0.0)
            if train:
                slot_c = jnp.minimum(jnp.maximum(rec_count - 1, 0), d_rec - 1)
                rec_target = add1(rec_target, slot_c, direct, allocated)
            add_pixel = ok & ~suffix
            radiance = radiance + jnp.where(
                add_pixel[..., None], s.throughput * direct, 0.0
            )

        # ---- advance the path ----------------------------------------
        throughput = jnp.where(
            hit_valid[..., None], s.throughput * sample.bsdf_over_pdf, s.throughput
        )
        # nested-medium stack on transmission through a boundary
        # (hit.cu:488-524, IOR only — volume coefficients in a later pass)
        transmit = (
            hit_valid
            & ((event & B.BSDF_EVENT_TRANSMISSION) != 0)
            & ~thin
        )
        push = transmit & front
        pop = transmit & ~front
        new_idx = jnp.clip(
            s.stack_idx + push.astype(jnp.int32) - pop.astype(jnp.int32), 0, 3
        )
        ior_stack = put1(s.ior_stack, new_idx, params.ior, push)
        sigma_a_stack = s.sigma_a_stack
        sigma_s_stack = s.sigma_s_stack
        bias_stack = s.bias_stack
        if has_volumes:
            mat_sa = mcol(mrow, "sigma_a")
            mat_ss = mcol(mrow, "sigma_s")
            mat_bias = mcol(mrow, "volume_bias")
            sigma_a_stack = put1(sigma_a_stack, new_idx, mat_sa, push)
            sigma_s_stack = put1(sigma_s_stack, new_idx, mat_ss, push)
            bias_stack = put1(bias_stack, new_idx, mat_bias, push)
            # crossing any boundary resets the walk counter (hit.cu:523)
            walk = jnp.where(transmit, 0, walk)

        # ---- unbiased-suffix Russian roulette (raygeneration.cu:245-262)
        if train:
            seed, u_rr = R.rng(seed)
            do_rr = (
                alive
                & s.unbiased
                & suffix
                & (depth_val >= cfg.min_depth_rr)
            )
            prob = jnp.maximum(jnp.max(throughput, axis=-1), 0.005)
            kill = do_rr & (prob < u_rr)
            throughput = jnp.where(
                (do_rr & ~kill)[..., None], throughput / prob[..., None], throughput
            )
            alive = alive & ~kill  # unbiased end: mask stays 0

        return _State(
            pos=jnp.where((hit_valid | passthrough)[..., None], p_hit, pos_volume),
            wi=jnp.where(hit_valid[..., None], sample.wi, wi_volume),
            seed=seed,
            throughput=throughput,
            radiance=radiance,
            pdf=jnp.where(hit_valid, sample.pdf, s.pdf),
            event=event,
            alive=alive,
            hit_before=hit_before | hit_valid | passthrough,
            area_spread=area_spread2,
            area_threshold=area_threshold,
            recorded_first=recorded_first,
            render_done=render_done,
            suffix=suffix,
            unbiased=s.unbiased,
            full=full,
            rec_count=rec_count,
            ior_stack=ior_stack,
            sigma_a_stack=sigma_a_stack,
            sigma_s_stack=sigma_s_stack,
            bias_stack=bias_stack,
            walk=walk,
            stack_idx=new_idx,
            pass_dist=(
                jnp.where(passthrough, s.pass_dist + hit.t,
                          jnp.where(hit_valid, 0.0, s.pass_dist))
                if has_cutout else s.pass_dist
            ),
            # work events this bounce: surface hits, cutout passthroughs,
            # volume scatter steps (the analog of USE_TIME_VIEW clocks)
            bounces=s.bounces
            + (hit_valid | passthrough | scatter_miss).astype(jnp.int32),
            traced=s.traced + active.astype(jnp.int32) + shadow_traced,
            last_render_throughput=lrt,
            render_query=render_query,
            cache_vis_query=cache_vis_query,
            rec_query=rec_query,
            rec_ltp=rec_ltp,
            rec_target=rec_target,
            end_query=end_query,
            end_mask=end_mask,
        )

    # Depth 0 computes the area threshold (structurally different), so it is
    # unrolled; all later bounces are one traced body compiled once into a
    # while_loop that exits as soon as every lane has terminated. In FULL
    # mode the area-spread heuristic truncates most paths into the cache
    # within 1-2 bounces, so the loop typically runs far fewer than
    # ``max_depth`` iterations — the analog of the megakernel simply
    # having no threads left. The bounce body contains no collectives, so
    # per-shard divergent trip counts are safe under shard_map.
    state = bounce(state, True, np.int32(0))
    if cfg.max_depth >= 1 and queue_band is not None and n > queue_band:
        # ---- compacted ray queue (large wavefronts) ---------------------
        # Bounce cost is width-proportional regardless of activity,
        # so after the coherent primary bounce the surviving rays are
        # PARTITION-COMPACTED to the front (stable: preserves spatial
        # order -> traversal-chunk coherence) and only the first
        # ceil(alive / queue_band) bands are advanced, via a while_loop
        # with a data-dependent band count. Per-depth work is then
        # proportional to the number of LIVE paths instead of the full
        # wavefront — the wavefront analog of the megakernel's dead
        # threads costing nothing (optixTrace divergence model). A lane's
        # transport depends only on its own state (seeds are per-lane), so
        # results match the banded layout to fp32 rounding.
        if queue_mode == "once":
            state = _queued_once_depth_loop(state, bounce, cfg, queue_band)
        elif queue_mode == "once2":
            state = _queued_once_depth_loop(
                state, bounce, cfg, queue_band, recompact_depth=4
            )
        else:
            state = _queued_depth_loop(state, bounce, cfg, queue_band)
    elif cfg.max_depth >= 1:
        import os

        if os.environ.get("NRC_BOUNCE_SCAN", "0") == "1":
            def scan_body(s, depth_val):
                return bounce(s, False, depth_val), None

            state, _ = jax.lax.scan(
                scan_body, state,
                jnp.arange(1, cfg.max_depth + 1, dtype=jnp.int32),
            )
        else:
            def loop_cond(carry):
                s, depth = carry
                return (depth <= cfg.max_depth) & jnp.any(s.alive)

            def loop_body(carry):
                s, depth = carry
                return bounce(s, False, depth), depth + 1

            state, _ = jax.lax.while_loop(
                loop_cond, loop_body, (state, jnp.int32(1))
            )

    # max-depth cleanup (raygeneration.cu:274-284): surviving render rays
    # contribute no cache radiance; surviving train rays end unbiased.
    still = state.alive & ~state.render_done
    lrt = jnp.where(still[..., None], 0.0, state.last_render_throughput)

    return WavefrontOut(
        radiance=state.radiance,
        bounce_count=state.bounces,
        traced_count=state.traced,
        render_query=state.render_query,
        last_render_throughput=lrt,
        cache_vis_query=state.cache_vis_query,
        rec_query=state.rec_query,
        rec_ltp=state.rec_ltp,
        rec_target=state.rec_target,
        rec_count=state.rec_count,
        end_query=state.end_query,
        end_mask=state.end_mask,
    )


def _queued_once_depth_loop(state: _State, bounce, cfg: FrameConfig,
                            band: int, recompact_depth: int = 0):
    """COMPACT-ONCE variant of the queued depth loop: depth 1 runs full
    width (every lane bounces at least once), then ONE stable partition
    moves the surviving ~quarter of lanes to the front and depths >= 2 run
    over that frozen prefix only — paying the full-state permute a single
    time where ``_queued_depth_loop`` pays it every depth (the cost that
    made per-depth compaction a net loss in an earlier A/B).
    Alive lanes only ever die, so the prefix stays valid.

    ``recompact_depth`` > 0 adds ONE more partition when the loop reaches
    that depth (alive decays ~23% -> ~3% between depths 2 and 4 on the
    demo scene, so a second squeeze shrinks the frozen prefix again)."""
    n = state.pos.shape[0]
    assert n % band == 0, "queued wavefront must be padded to the band size"
    ids0 = jnp.arange(n, dtype=jnp.int32)

    state = bounce(state, False, jnp.int32(1))
    if cfg.max_depth < 2:
        return state

    def compact(st, ids):
        alive = st.alive
        count = jnp.sum(alive.astype(jnp.int32))
        dest = jnp.where(
            alive,
            jnp.cumsum(alive.astype(jnp.int32)) - 1,
            count + jnp.cumsum((~alive).astype(jnp.int32)) - 1,
        )
        perm = jnp.zeros((n,), jnp.int32).at[dest].set(ids0)
        st = jax.tree.map(lambda x: x[perm], st)
        n_active = (count + band - 1) // band
        return st, ids[perm], n_active

    state, ids, n_active = compact(state, ids0)

    def cond(carry):
        st, ids, n_active, depth = carry
        return (depth <= cfg.max_depth) & jnp.any(st.alive)

    def body(carry):
        st, ids, n_active, depth = carry
        if recompact_depth > 1:
            st, ids, n_active = jax.lax.cond(
                depth == recompact_depth,
                lambda a: compact(a[0], a[1]),
                lambda a: a,
                (st, ids, n_active),
            )

        def band_cond(c):
            _, b = c
            return b < n_active

        def band_body(c):
            st2, b = c
            off = b * band
            sl = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, off, band, 0), st2
            )
            sl = bounce(sl, False, depth)
            st2 = jax.tree.map(
                lambda x, y: jax.lax.dynamic_update_slice_in_dim(x, y, off, 0),
                st2, sl,
            )
            return st2, b + 1

        st, _ = jax.lax.while_loop(band_cond, band_body, (st, jnp.int32(0)))
        return st, ids, n_active, depth + 1

    state, ids, _, _ = jax.lax.while_loop(
        cond, body, (state, ids, n_active, jnp.int32(2))
    )
    # restore input lane order (ids[i] = original index of lane i)
    inv = jnp.zeros((n,), jnp.int32).at[ids].set(ids0)
    return jax.tree.map(lambda x: x[inv], state)


def _queued_depth_loop(state: _State, bounce, cfg: FrameConfig, band: int):
    """Depth loop with inter-bounce ray compaction (see trace_wavefront).

    Carries a lane->origin permutation so every leaf of the state can be
    restored to input order with one gather at the end. The lane count must
    be a multiple of ``band`` (the chunked wrapper pads)."""
    n = state.pos.shape[0]
    assert n % band == 0, "queued wavefront must be padded to the band size"
    ids0 = jnp.arange(n, dtype=jnp.int32)

    def cond(carry):
        st, ids, depth = carry
        return (depth <= cfg.max_depth) & jnp.any(st.alive)

    def body(carry):
        st, ids, depth = carry
        alive = st.alive
        count = jnp.sum(alive.astype(jnp.int32))
        # stable partition: live lanes to the front, original order kept on
        # both sides (prefix-sum destinations; scatter an iota to get the
        # gather permutation)
        dest = jnp.where(
            alive,
            jnp.cumsum(alive.astype(jnp.int32)) - 1,
            count + jnp.cumsum((~alive).astype(jnp.int32)) - 1,
        )
        perm = jnp.zeros((n,), jnp.int32).at[dest].set(ids0)
        st = jax.tree.map(lambda x: x[perm], st)
        ids = ids[perm]
        n_active = (count + band - 1) // band  # data-dependent trip count

        def band_cond(c):
            _, b = c
            return b < n_active

        def band_body(c):
            st2, b = c
            off = b * band
            sl = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, off, band, 0), st2
            )
            sl = bounce(sl, False, depth)
            st2 = jax.tree.map(
                lambda x, y: jax.lax.dynamic_update_slice_in_dim(x, y, off, 0),
                st2, sl,
            )
            return st2, b + 1

        st, _ = jax.lax.while_loop(band_cond, band_body, (st, jnp.int32(0)))
        return st, ids, depth + 1

    state, ids, _ = jax.lax.while_loop(
        cond, body, (state, ids0, jnp.int32(1))
    )
    # restore input lane order (ids[i] = original index of lane i)
    inv = jnp.zeros((n,), jnp.int32).at[ids].set(ids0)
    return jax.tree.map(lambda x: x[inv], state)


# A masked lockstep bounce loop costs the same whatever its activity: every
# masked-select op
# processes every lane, and the while_loop runs until the LAST path in the
# whole wavefront terminates — a 320x320 FULL-mode frame runs ~6 full-width
# iterations even though the area-spread heuristic truncates most paths
# into the cache within 1-2 bounces. Splitting the wavefront into chunks
# (contiguous pixel bands: spatially coherent, no sort needed) and running
# one bounce loop per chunk under lax.map lets each band exit at ITS
# deepest path. Per-ray results match to fp32 rounding (no cross-ray ops
# inside a wavefront; seeds are per-ray inputs; the mapped body compiles
# separately so fusion/FMA choices differ at the last bit).
#
# Wavefront layout choices for large wavefronts, all parity-pinned by
# TestChunkedWavefront. They were chosen by A/B on an earlier accelerator
# and are not yet re-measured on the GPU, nor is WAVEFRONT_CHUNK:
#
# - BANDED (lax.map over contiguous pixel-band chunks; each chunk's bounce
#   while_loop exits at ITS deepest path): the small-scene default; a
#   per-depth compacted queue lost to it there.
# - COMPACT-ONCE (the default for wide-BVH scenes): depths 0-1 run full
#   width (every lane bounces at least once), then ONE stable partition
#   moves the surviving lanes to the front and depths >= 2 advance a frozen
#   ceil(alive/band) prefix. One permute buys the queue's dead-lane savings
#   without its per-depth permute tax. Small scenes' cheap bounces gained
#   nothing from it, so they keep the banded layout.
#
# NRC_WAVEFRONT_QUEUE: auto (default) | 0 = banded | 1 = per-depth queue
# | once = compact-once everywhere.
import os as _os

WAVEFRONT_CHUNK = int(_os.environ.get("NRC_WAVEFRONT_CHUNK", "8192"))
WAVEFRONT_QUEUE = _os.environ.get("NRC_WAVEFRONT_QUEUE", "auto")


def _queue_mode_auto(scene: DeviceScene):
    """Layout choice -> None (banded) | "every" | "once" (see above)."""
    if WAVEFRONT_QUEUE == "0":
        return None
    if WAVEFRONT_QUEUE == "1":
        return "every"
    if WAVEFRONT_QUEUE in ("once", "once2"):
        return WAVEFRONT_QUEUE
    return "once" if getattr(scene, "bvh", None) is not None else None


def trace_wavefront_chunked(
    scene: DeviceScene,
    org: jnp.ndarray,
    direction: jnp.ndarray,
    seeds: jnp.ndarray,
    cfg: FrameConfig,
    train: bool,
    unbiased: Optional[jnp.ndarray] = None,
    chunk: Optional[int] = None,
    queue: Optional[bool] = None,
    primary_hit=None,
) -> WavefrontOut:
    """Chunked wrapper around ``trace_wavefront`` (same signature + chunk)."""
    if chunk is None:
        chunk = WAVEFRONT_CHUNK  # late-bound: patchable in tests
    if queue is None:
        queue = _queue_mode_auto(scene)
    elif queue is True:
        queue = "every"
    elif queue is False:
        queue = None
    n = org.shape[0]
    if chunk <= 0 or n < 2 * chunk:
        return trace_wavefront(
            scene, org, direction, seeds, cfg, train, unbiased,
            primary_hit=primary_hit,
        )
    pad = (-n) % chunk
    if unbiased is None:
        unbiased = jnp.zeros((n,), bool)
    if pad:
        # padded lanes trace a throwaway ray (up, unit seed); outputs sliced off
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        direction = jnp.concatenate(
            [direction,
             jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], direction.dtype), (pad, 1))]
        )
        seeds = jnp.concatenate([seeds, jnp.ones((pad,), seeds.dtype)])
        unbiased = jnp.concatenate([unbiased, jnp.zeros((pad,), bool)])
    c = (n + pad) // chunk
    if primary_hit is not None and pad:
        from ..ops.intersect import Hit as _Hit

        primary_hit = _Hit(
            t=jnp.concatenate([primary_hit.t, jnp.full((pad,), RT_MAX)]),
            prim=jnp.concatenate(
                [primary_hit.prim, jnp.full((pad,), -1, jnp.int32)]
            ),
            u=jnp.concatenate([primary_hit.u, jnp.zeros((pad,))]),
            v=jnp.concatenate([primary_hit.v, jnp.zeros((pad,))]),
        )

    if queue:
        # compacted-queue layout: one call over the whole (padded) wavefront
        out = trace_wavefront(
            scene, org, direction, seeds, cfg, train, unbiased,
            queue_band=chunk, queue_mode=queue, primary_hit=primary_hit,
        )
        return jax.tree.map(lambda x: x[:n], out)

    if primary_hit is not None:
        def one_ph(args):
            o, d, s, u, ph = args
            return trace_wavefront(
                scene, o, d, s, cfg, train, u, primary_hit=ph
            )

        out = jax.lax.map(
            one_ph,
            (
                org.reshape(c, chunk, 3),
                direction.reshape(c, chunk, 3),
                seeds.reshape(c, chunk),
                unbiased.reshape(c, chunk),
                jax.tree.map(
                    lambda x: x.reshape((c, chunk) + x.shape[1:]),
                    primary_hit,
                ),
            ),
        )
        return jax.tree.map(
            lambda x: x.reshape((c * chunk,) + x.shape[2:])[:n], out
        )

    def one(args):
        o, d, s, u = args
        return trace_wavefront(scene, o, d, s, cfg, train, u)

    out = jax.lax.map(
        one,
        (
            org.reshape(c, chunk, 3),
            direction.reshape(c, chunk, 3),
            seeds.reshape(c, chunk),
            unbiased.reshape(c, chunk),
        ),
    )
    return jax.tree.map(
        lambda x: x.reshape((c * chunk,) + x.shape[2:])[:n], out
    )
