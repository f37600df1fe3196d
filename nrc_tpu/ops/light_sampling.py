"""Device light sampling, fully batched over the ray wavefront.

Port of the reference's light direct callables
(``nrc/shaders/light_sample.cu`` + ``__direct_callable__light_mesh`` in
``hit.cu:1473-1662``): env constant / env sphere / mesh / point / spot / IES.
Function-pointer dispatch becomes masked selects over per-ray light type;
the reference's binary-searched CDFs become Walker alias tables (O(1) gather
per sample — fixes the memory-traffic FIXME at ``light_sample.cu:71``).

Also hosts the env-map *miss* radiance evaluation used by the wavefront
integrator (``__miss__env_constant/sphere``, ``miss.cu:114-230``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax

import jax.numpy as jnp
import numpy as np

from ..scene.lights import (
    TYPE_LIGHT_ENV_CONST,
    TYPE_LIGHT_ENV_SPHERE,
    TYPE_LIGHT_IES,
    TYPE_LIGHT_MESH,
    TYPE_LIGHT_POINT,
    TYPE_LIGHT_SPOT,
    LightTable,
    build_alias_table,
)
from ..utils.math import HIGHEST, dot, normalize, safe_div

M_PI = float(jnp.pi)
RT_MAX = np.float32(3.0e38)
DENOM_EPS = 1.0e-6

# merged per-light row layout: every field ``sample_lights``
# needs rides ONE row gather by the chosen light index; ints stored as f32
# (values << 2^24, exact round trip). ori/ori_inv are row-major 3x3.
_LIGHT_ROW = [
    ("type", 1), ("position", 3), ("emission", 3), ("ori", 9),
    ("ori_inv", 9), ("spot_cos_half", 1), ("spot_angle_half", 1),
    ("spot_exponent", 1), ("area", 1), ("emission_radiance", 3),
    ("ies_index", 1), ("tri_count", 1), ("tri_start", 1),
]
_light_row_cols = {}
_o = 0
for _nm, _w in _LIGHT_ROW:
    _light_row_cols[_nm] = (_o, _o + _w)
    _o += _w
LIGHT_ROW_W = _o
del _nm, _w, _o


@partial(
    jax.tree_util.register_dataclass,
    meta_fields=("types_static", "env_is_cube"),
    data_fields=(
        "type", "position", "ori", "ori_inv", "emission", "area",
        "inv_integral", "spot_cos_half", "spot_angle_half", "spot_exponent",
        "material_id", "emission_radiance", "tri_start", "tri_count",
        "mesh_p0", "mesh_p1", "mesh_p2", "mesh_n0", "mesh_n1", "mesh_n2",
        "mesh_uv0", "mesh_uv1", "mesh_uv2", "mesh_row", "light_row",
        "env_alias_pack", "env_eval_pack",
        "mesh_prob", "mesh_alias", "env_texture", "env_prob", "env_alias",
        "env_pdf", "env_cube", "ies_texture", "ies_index",
    ),
)
@dataclasses.dataclass(frozen=True)
class DeviceLights:
    """Device-resident light table (pytree of jnp arrays).

    ``types_static`` mirrors ``type`` as static Python metadata so the
    integrator can specialize the compiled program to the light types
    actually present (the reference's equivalent is per-light-type direct
    callables baked into the pipeline).
    """

    type: jnp.ndarray           # [L] i32
    position: jnp.ndarray       # [L, 3]
    ori: jnp.ndarray            # [L, 3, 3] object->world rotation
    ori_inv: jnp.ndarray        # [L, 3, 3]
    emission: jnp.ndarray       # [L, 3]
    area: jnp.ndarray           # [L]
    inv_integral: jnp.ndarray   # [L]
    spot_cos_half: jnp.ndarray  # [L]
    spot_angle_half: jnp.ndarray  # [L]
    spot_exponent: jnp.ndarray  # [L]
    material_id: jnp.ndarray    # [L]
    emission_radiance: jnp.ndarray  # [L, 3] mesh-light radiance (EDF eval'd)
    tri_start: jnp.ndarray      # [L]
    tri_count: jnp.ndarray      # [L]
    # flat mesh-light triangle pool
    mesh_p0: jnp.ndarray        # [T, 3]
    mesh_p1: jnp.ndarray
    mesh_p2: jnp.ndarray
    mesh_n0: jnp.ndarray
    mesh_n1: jnp.ndarray
    mesh_n2: jnp.ndarray
    # per-light padded alias tables over triangles [L, Tmax]
    mesh_uv0: jnp.ndarray       # [T, 2] texcoords (textured mesh-light EDFs)
    mesh_uv1: jnp.ndarray
    mesh_uv2: jnp.ndarray
    # merged pool row p0|p1|p2|uv0|uv1|uv2 — the sampled triangle's whole
    # fetch is ONE row gather
    mesh_row: jnp.ndarray       # [T, 15]
    light_row: jnp.ndarray      # [L, LIGHT_ROW_W] merged per-light row
    # merged env tables: alias pick = ONE row gather (prob |
    # alias bits), radiance+pdf eval = ONE row gather (rgb | pdf)
    env_alias_pack: jnp.ndarray  # [NT, 2] f32: prob | alias(raw i32 bits)
    env_eval_pack: jnp.ndarray   # [H, W, 4] f32: rgb | pdf (equirect only)
    mesh_prob: jnp.ndarray
    mesh_alias: jnp.ndarray
    # environment (dummy 1x1 when absent)
    env_texture: jnp.ndarray    # [H, W, 3]
    env_prob: jnp.ndarray       # [H*W] (cube: [6*Hc*Wc])
    env_alias: jnp.ndarray      # [H*W] i32 (cube: [6*Hc*Wc])
    env_pdf: jnp.ndarray        # [H, W] solid-angle pdf per texel
    #                             (cube: [6, Hc, Wc] over the actual faces)
    # cube environment faces (dummy [1,1,1,3] when absent; env_texture is
    # then only an equirect display proxy — importance tables and MIS pdfs
    # come from the faces themselves)
    env_cube: jnp.ndarray = None     # [6 or 1, Hc, Wc, 3]
    # IES goniometric candela textures (dummy [1,1,1] when absent)
    ies_texture: jnp.ndarray = None  # [NI, H, W]
    ies_index: jnp.ndarray = None    # [L] i32, -1 = no profile
    types_static: tuple = ()
    env_is_cube: bool = False

    @property
    def num(self) -> int:
        return len(self.types_static)


def upload_lights(lt: LightTable, emission_radiance: Optional[np.ndarray] = None) -> DeviceLights:
    """Host LightTable -> DeviceLights, building alias tables.

    ``emission_radiance``: [L, 3] radiance of each mesh light's EDF
    (intensity * 1/pi for diffuse EDF, radiant-exitance mode).
    """
    n = lt.num_lights
    if emission_radiance is None:
        emission_radiance = np.zeros((max(n, 1), 3), np.float32)

    # per-light padded triangle alias tables
    tmax = max(int(lt.tri_count.max()) if n else 0, 1)
    mesh_prob = np.ones((max(n, 1), tmax), np.float32)
    mesh_alias = np.zeros((max(n, 1), tmax), np.int32)
    for i in range(n):
        c = int(lt.tri_count[i])
        if c > 0:
            s = int(lt.tri_start[i])
            areas = 0.5 * np.linalg.norm(
                np.cross(
                    lt.mesh_p1[s : s + c] - lt.mesh_p0[s : s + c],
                    lt.mesh_p2[s : s + c] - lt.mesh_p0[s : s + c],
                ),
                axis=-1,
            )
            prob, alias = build_alias_table(areas)
            mesh_prob[i, :c] = prob
            mesh_alias[i, :c] = alias

    if getattr(lt, "env_cube", None) is not None:
        # cube env: importance tables over the ACTUAL 6xHcxWc face texels
        # (intensity x exact texel solid angle — ``build_cube_env_weights``;
        # previously a resampled equirect proxy stood in, PARITY "Known
        # gaps"). env_pdf is [6, Hc, Wc]; env_texture stays the equirect
        # proxy for display only.
        from ..scene.lights import build_cube_env_weights

        env_idx = np.argmax(lt.type == TYPE_LIGHT_ENV_SPHERE)
        weights, _ = build_cube_env_weights(lt.env_cube)
        env_prob, env_alias = build_alias_table(weights)
        env_pdf = (
            lt.env_cube.mean(axis=-1) * float(lt.inv_integral[env_idx])
        ).astype(np.float32)
        env_texture = lt.env_texture
    elif lt.env_texture is not None:
        h, w, _ = lt.env_texture.shape
        intensity = lt.env_texture.mean(axis=-1)
        theta = (np.arange(h) + 0.5) / h * np.pi
        weights = intensity * np.sin(theta)[:, None]
        env_prob, env_alias = build_alias_table(weights)
        # MIS pdf per texel (reference pretends perfect importance sampling of
        # the unfiltered map: pdf = intensity * invIntegral, miss.cu:195-198)
        env_idx = np.argmax(lt.type == TYPE_LIGHT_ENV_SPHERE)
        env_pdf = intensity * float(lt.inv_integral[env_idx])
        env_texture = lt.env_texture
    else:
        env_texture = np.zeros((1, 1, 3), np.float32)
        env_prob = np.ones((1,), np.float32)
        env_alias = np.zeros((1,), np.int32)
        env_pdf = np.full((1, 1), 0.25 / np.pi, np.float32)
    env_is_cube = getattr(lt, "env_cube", None) is not None
    env_cube = (
        lt.env_cube if env_is_cube else np.zeros((1, 1, 1, 3), np.float32)
    )


    # alias indices ride as their raw i32 BITS (f32-bitcast) — exact for
    # any table size (a value cast would corrupt indices >= 2^24, e.g.
    # 8k equirect maps)
    env_alias_pack = np.stack(
        [env_prob.ravel().astype(np.float32),
         np.ascontiguousarray(
             env_alias.ravel().astype(np.int32)).view(np.float32)],
        axis=-1,
    )
    if not env_is_cube and env_texture.ndim == 3:
        env_eval_pack = np.concatenate(
            [np.asarray(env_texture, np.float32),
             np.asarray(env_pdf, np.float32)[..., None]], axis=-1
        )
    else:
        env_eval_pack = np.zeros((1, 1, 4), np.float32)

    if lt.ies_texture is not None:
        ies_texture = lt.ies_texture
        ies_index = lt.ies_index
    else:
        ies_texture = np.ones((1, 1, 1), np.float32)
        ies_index = np.full((max(n, 1),), -1, np.int32)

    def j(x, dt=np.float32):
        # host numpy, not device: the DeviceLights pytree is uploaded with
        # the rest of the DeviceScene in one ``device_put_packed`` call
        return np.ascontiguousarray(np.asarray(x, dt))

    if n == 0:
        z = np.zeros
        return DeviceLights(
            type=j(z(0), jnp.int32), position=j(z((0, 3))),
            ori=j(z((0, 3, 3))), ori_inv=j(z((0, 3, 3))),
            emission=j(z((0, 3))), area=j(z(0)), inv_integral=j(z(0)),
            spot_cos_half=j(z(0)), spot_angle_half=j(z(0)), spot_exponent=j(z(0)),
            material_id=j(z(0), jnp.int32),
            emission_radiance=j(z((1, 3))),
            tri_start=j(z(1), jnp.int32), tri_count=j(z(1), jnp.int32),
            mesh_p0=j(z((1, 3))), mesh_p1=j(z((1, 3))), mesh_p2=j(z((1, 3))),
            mesh_n0=j(z((1, 3))), mesh_n1=j(z((1, 3))), mesh_n2=j(z((1, 3))),
            mesh_uv0=j(z((1, 2))), mesh_uv1=j(z((1, 2))), mesh_uv2=j(z((1, 2))),
            mesh_row=j(z((1, 15))),
            light_row=j(z((1, LIGHT_ROW_W))),
            mesh_prob=j(mesh_prob), mesh_alias=j(mesh_alias, jnp.int32),
            env_texture=j(env_texture), env_prob=j(env_prob),
            env_alias=j(env_alias, jnp.int32), env_pdf=j(env_pdf),
            env_alias_pack=j(env_alias_pack),
            env_eval_pack=j(env_eval_pack),
            env_cube=j(env_cube),
            ies_texture=j(ies_texture), ies_index=j(ies_index, jnp.int32),
            types_static=(),
            env_is_cube=env_is_cube,
        )

    def pad1(x):
        return x if x.shape[0] > 0 else np.zeros((1,) + x.shape[1:], x.dtype)

    return DeviceLights(
        type=j(lt.type, jnp.int32),
        position=j(lt.matrix[:, :3, 3]),
        ori=j(lt.matrix[:, :3, :3]),
        ori_inv=j(lt.matrix_inv[:, :3, :3]),
        emission=j(lt.emission),
        area=j(lt.area),
        inv_integral=j(lt.inv_integral),
        spot_cos_half=j(np.cos(lt.spot_angle_half)),
        spot_angle_half=j(lt.spot_angle_half),
        spot_exponent=j(lt.spot_exponent),
        material_id=j(lt.material_id, jnp.int32),
        emission_radiance=j(emission_radiance),
        tri_start=j(lt.tri_start, jnp.int32),
        tri_count=j(np.maximum(lt.tri_count, 1), jnp.int32),
        mesh_p0=j(pad1(lt.mesh_p0)), mesh_p1=j(pad1(lt.mesh_p1)), mesh_p2=j(pad1(lt.mesh_p2)),
        mesh_n0=j(pad1(lt.mesh_n0)), mesh_n1=j(pad1(lt.mesh_n1)), mesh_n2=j(pad1(lt.mesh_n2)),
        mesh_uv0=j(pad1(lt.mesh_uv0 if lt.mesh_uv0 is not None else np.zeros((0, 2), np.float32))),
        mesh_uv1=j(pad1(lt.mesh_uv1 if lt.mesh_uv1 is not None else np.zeros((0, 2), np.float32))),
        mesh_uv2=j(pad1(lt.mesh_uv2 if lt.mesh_uv2 is not None else np.zeros((0, 2), np.float32))),
        light_row=np.concatenate(
            [
                j(lt.type).reshape(n, 1),
                j(lt.matrix[:, :3, 3]),
                j(lt.emission),
                j(lt.matrix[:, :3, :3]).reshape(n, 9),
                j(lt.matrix_inv[:, :3, :3]).reshape(n, 9),
                j(np.cos(lt.spot_angle_half)).reshape(n, 1),
                j(lt.spot_angle_half).reshape(n, 1),
                j(lt.spot_exponent).reshape(n, 1),
                j(lt.area).reshape(n, 1),
                j(emission_radiance),
                j(lt.ies_index if lt.ies_index is not None
                  else np.full(n, -1)).reshape(n, 1),
                j(np.maximum(lt.tri_count, 1)).reshape(n, 1),
                j(lt.tri_start).reshape(n, 1),
            ],
            axis=-1,
        ),
        mesh_row=np.concatenate(
            [
                j(pad1(lt.mesh_p0)), j(pad1(lt.mesh_p1)), j(pad1(lt.mesh_p2)),
                j(pad1(lt.mesh_uv0 if lt.mesh_uv0 is not None
                       else np.zeros((0, 2), np.float32))),
                j(pad1(lt.mesh_uv1 if lt.mesh_uv1 is not None
                       else np.zeros((0, 2), np.float32))),
                j(pad1(lt.mesh_uv2 if lt.mesh_uv2 is not None
                       else np.zeros((0, 2), np.float32))),
            ],
            axis=-1,
        ),
        mesh_prob=j(mesh_prob),
        mesh_alias=j(mesh_alias, jnp.int32),
        env_texture=j(env_texture),
        env_prob=j(env_prob),
        env_alias=j(env_alias, jnp.int32),
        env_pdf=j(env_pdf),
        env_alias_pack=j(env_alias_pack),
        env_eval_pack=j(env_eval_pack),
        env_cube=j(env_cube),
        ies_texture=j(ies_texture),
        ies_index=j(ies_index, jnp.int32),
        env_is_cube=env_is_cube,
        types_static=tuple(int(t) for t in lt.type),
    )


class LightSample(NamedTuple):
    direction: jnp.ndarray         # [N, 3] surface -> light
    distance: jnp.ndarray          # [N]
    radiance_over_pdf: jnp.ndarray  # [N, 3]
    pdf: jnp.ndarray               # [N] solid-angle (1 for singular), 0 invalid
    is_singular: jnp.ndarray       # [N] bool (skip MIS, light_sample.cu)


def sample_lights(
    lights: DeviceLights,
    pos: jnp.ndarray,       # [N, 3] surface positions
    xi: jnp.ndarray,        # [N, 4] uniforms (light choice + position)
    tex_ctx=None,           # (atlas, [L] emission_tex ids, [L, 6] uv_xf)
) -> LightSample:
    """Pick one of L lights uniformly and sample it (``hit.cu:350-362``).

    The 1/L selection probability is compensated by the caller multiplying
    by numLights (``hit.cu:424-426``). ``tex_ctx`` enables textured
    mesh-light EDFs: the sampled point's texcoord modulates the radiance
    (the reference interpolates attributes + evaluates the full MDL EDF in
    ``__direct_callable__light_mesh``, hit.cu:1545-1651).
    """
    n = pos.shape[0]
    num = lights.num
    if num == 0:
        z = jnp.zeros((n,))
        return LightSample(
            direction=jnp.zeros((n, 3)), distance=z,
            radiance_over_pdf=jnp.zeros((n, 3)), pdf=z, is_singular=z > 1,
        )

    idx = jnp.minimum((xi[:, 0] * num).astype(jnp.int32), num - 1)
    # ONE merged light-row gather replaces ~15 per-field [N]-index gathers
    lrow = lights.light_row[idx]                  # [N, 35]
    _L = _light_row_cols

    def pf(name):
        a, b = _L[name]
        v = lrow[..., a:b]
        if b - a == 1:
            return v[..., 0]
        if b - a == 9:
            return v.reshape(v.shape[:-1] + (3, 3))
        return v

    def pi(name):
        return pf(name).astype(jnp.int32)

    ltype = pi("type")
    emission = pf("emission")

    # defaults
    direction = jnp.zeros((n, 3))
    distance = jnp.zeros((n,))
    rad_over_pdf = jnp.zeros((n, 3))
    pdf = jnp.zeros((n,))

    present = set(lights.types_static)

    # --- singular lights (point / spot / ies) ---------------------------
    singular_types = {TYPE_LIGHT_POINT, TYPE_LIGHT_SPOT, TYPE_LIGHT_IES}
    if present & singular_types:
        lpos = pf("position")
        d = lpos - pos
        d2 = dot(d, d)
        valid = d2 > DENOM_EPS
        dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
        dirn = d / dist[..., None]
        emis = emission * safe_div(1.0, d2)[..., None]

        if TYPE_LIGHT_SPOT in present:
            # spot cone falloff (light_sample.cu:188-210): angle between the
            # light->surface direction and the light's local +z axis
            z_axis = normalize(pf("ori")[..., :, 2])  # local +z in world
            cos_theta = dot(-dirn, z_axis)
            inside = cos_theta >= pf("spot_cos_half")
            ang_half = jnp.maximum(pf("spot_angle_half"), 1e-6)
            cos_hemi = jnp.cos(
                (M_PI / 2.0) * jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0)) / ang_half
            )
            falloff = jnp.power(jnp.maximum(cos_hemi, 0.0), pf("spot_exponent"))
            is_spot = ltype == TYPE_LIGHT_SPOT
            emis = jnp.where(is_spot[..., None], emis * falloff[..., None], emis)
            valid = valid & jnp.where(is_spot, inside, True)

        if TYPE_LIGHT_IES in present:
            # goniometric candela texture modulation in the light's local
            # frame (light_sample.cu:186-199): u azimuth with wrap, v polar
            # from the nadir; bilinear filtered
            r = -dirn  # light -> surface, world
            rl = jnp.einsum(
                "nij,nj->ni", pf("ori_inv"), r, precision=HIGHEST
            )
            u = (jnp.arctan2(-rl[..., 0], rl[..., 2]) + M_PI) * 0.5 / M_PI
            v = jnp.arccos(jnp.clip(-rl[..., 1], -1.0, 1.0)) / M_PI
            ni, th, tw = lights.ies_texture.shape
            prof = jnp.maximum(pi("ies_index"), 0)
            fx = u * tw - 0.5
            fy = v * th - 0.5
            x0 = jnp.floor(fx).astype(jnp.int32)
            y0 = jnp.floor(fy).astype(jnp.int32)
            wx = fx - x0.astype(jnp.float32)
            wy = fy - y0.astype(jnp.float32)
            x0w, x1w = jnp.mod(x0, tw), jnp.mod(x0 + 1, tw)
            y0c, y1c = jnp.clip(y0, 0, th - 1), jnp.clip(y0 + 1, 0, th - 1)
            t00 = lights.ies_texture[prof, y0c, x0w]
            t10 = lights.ies_texture[prof, y0c, x1w]
            t01 = lights.ies_texture[prof, y1c, x0w]
            t11 = lights.ies_texture[prof, y1c, x1w]
            candela = (
                (1 - wy) * ((1 - wx) * t00 + wx * t10)
                + wy * ((1 - wx) * t01 + wx * t11)
            )
            has_prof = (ltype == TYPE_LIGHT_IES) & (pi("ies_index") >= 0)
            emis = jnp.where(has_prof[..., None], emis * candela[..., None], emis)

        is_sing = (
            (ltype == TYPE_LIGHT_POINT)
            | (ltype == TYPE_LIGHT_SPOT)
            | (ltype == TYPE_LIGHT_IES)
        )
        sel = is_sing & valid
        direction = jnp.where(sel[..., None], dirn, direction)
        distance = jnp.where(sel, dist, distance)
        rad_over_pdf = jnp.where(sel[..., None], emis, rad_over_pdf)
        pdf = jnp.where(sel, 1.0, pdf)

    # --- mesh lights ------------------------------------------------------
    if TYPE_LIGHT_MESH in present:
        count = pi("tri_count")
        k = jnp.minimum((xi[:, 3] * count.astype(jnp.float32)).astype(jnp.int32), count - 1)
        frac = xi[:, 3] * count.astype(jnp.float32) - k.astype(jnp.float32)
        prob = lights.mesh_prob[idx, k]
        alias = lights.mesh_alias[idx, k]
        tri = jnp.where(frac < prob, k, alias)
        flat = pi("tri_start") + tri

        # uniform point on triangle (hit.cu:1488-1492)
        su = jnp.sqrt(jnp.clip(xi[:, 1], 0.0, 1.0))
        a = 1.0 - su
        b = xi[:, 2] * su
        g = 1.0 - a - b
        mr = lights.mesh_row[flat]            # ONE pool-row gather
        mp0, mp1, mp2 = mr[..., 0:3], mr[..., 3:6], mr[..., 6:9]
        p = a[..., None] * mp0 + b[..., None] * mp1 + g[..., None] * mp2
        d = p - pos
        dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-20))
        dirn = d / dist[..., None]
        ng = jnp.cross(mp1 - mp0, mp2 - mp0)
        ng = normalize(ng)
        cos_l = dot(-dirn, ng)  # EDF cos: outgoing dir at light = -dirn
        area = pf("area")
        # pdf = d^2 / (area * cos) solid-angle (hit.cu:1652-1655)
        denom = jnp.maximum(area * cos_l, DENOM_EPS)
        pdf_m = dist * dist / denom
        # diffuse EDF: radiance = emission_radiance (frontface only)
        radiance = pf("emission_radiance")
        if tex_ctx is not None:
            from .texture import apply_uv_transform, sample_bilinear

            atlas, l_row = tex_ctx
            lr_tex = l_row[idx]                     # ONE [N, 7] gather
            uv_s = (
                a[..., None] * mr[..., 9:11]
                + b[..., None] * mr[..., 11:13]
                + g[..., None] * mr[..., 13:15]
            )
            uv_s = apply_uv_transform(uv_s, lr_tex[..., 1:7])
            radiance = radiance * sample_bilinear(
                atlas, lr_tex[..., 0].astype(jnp.int32), uv_s
            )[..., :3]
        valid = (cos_l > DENOM_EPS) & (dist > DENOM_EPS) & (pdf_m > DENOM_EPS)
        rop = safe_div(radiance, pdf_m[..., None])

        is_mesh = ltype == TYPE_LIGHT_MESH
        sel = is_mesh & valid
        direction = jnp.where(sel[..., None], dirn, direction)
        distance = jnp.where(sel, dist, distance)
        rad_over_pdf = jnp.where(sel[..., None], rop, rad_over_pdf)
        pdf = jnp.where(sel, pdf_m, pdf)

    # --- env constant -----------------------------------------------------
    if TYPE_LIGHT_ENV_CONST in present:
        # uniform sphere (light_sample.cu __direct_callable__light_env_constant)
        z = 1.0 - 2.0 * xi[:, 1]
        r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi = xi[:, 2] * 2.0 * M_PI
        dirn = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
        pdf_e = jnp.full((n,), 0.25 / M_PI)
        is_env = ltype == TYPE_LIGHT_ENV_CONST
        direction = jnp.where(is_env[..., None], dirn, direction)
        distance = jnp.where(is_env, RT_MAX, distance)
        rad_over_pdf = jnp.where(
            is_env[..., None], emission / pdf_e[..., None], rad_over_pdf
        )
        pdf = jnp.where(is_env, pdf_e, pdf)

    # --- env sphere (textured, alias-sampled) -----------------------------
    if TYPE_LIGHT_ENV_SPHERE in present:
        if lights.env_is_cube:
            # alias table over the ACTUAL cube texels (6*Hc*Wc, weight =
            # intensity x exact texel solid angle); the sampled texel maps
            # back to a direction through the face-uv inverse
            from .texture import cube_dir_from_face_uv, sample_cube_env

            _, ch, cw, _ = lights.env_cube.shape
            nt = 6 * ch * cw
            k = jnp.minimum((xi[:, 1] * nt).astype(jnp.int32), nt - 1)
            frac = xi[:, 1] * nt - k.astype(jnp.float32)
            ap = lights.env_alias_pack[k]          # ONE row: prob | alias
            texel = jnp.where(
                frac < ap[..., 0],
                jnp.asarray(k),
                jax.lax.bitcast_convert_type(ap[..., 1], jnp.int32),
            )
            face = texel // (ch * cw)
            rem = texel - face * (ch * cw)
            ty = rem // cw
            tx = rem - ty * cw
            u = (tx.astype(jnp.float32) + xi[:, 2]) / cw
            v = (ty.astype(jnp.float32) + xi[:, 3]) / ch
            d_obj = cube_dir_from_face_uv(face, u, v)
            emis = sample_cube_env(lights.env_cube, d_obj)
            pdf_e = lights.env_pdf[face, ty, tx]
        else:
            h, w, _ = lights.env_texture.shape
            nt = h * w
            k = jnp.minimum((xi[:, 1] * nt).astype(jnp.int32), nt - 1)
            frac = xi[:, 1] * nt - k.astype(jnp.float32)
            ap = lights.env_alias_pack[k]          # ONE row: prob | alias
            texel = jnp.where(
                frac < ap[..., 0],
                k,
                jax.lax.bitcast_convert_type(ap[..., 1], jnp.int32),
            )
            ty = texel // w
            tx = texel % w
            # jitter inside the texel
            u = (tx.astype(jnp.float32) + xi[:, 2]) / w
            v = (ty.astype(jnp.float32) + xi[:, 3]) / h
            phi = u * 2.0 * M_PI
            theta = v * M_PI
            st = jnp.sin(theta)
            # object-space: u=0 seam on -z, v=0 south pole
            # (light_sample.cu:95-106)
            d_obj = jnp.stack(
                [jnp.sin(phi) * st, -jnp.cos(theta), -jnp.cos(phi) * st], -1
            )
            ev = lights.env_eval_pack[ty, tx]      # ONE row: rgb | pdf
            emis = ev[..., 0:3]
            pdf_e = ev[..., 3]
        dirn = jnp.einsum(
            "nij,nj->ni", pf("ori"), d_obj, precision=HIGHEST
        )
        valid = pdf_e > DENOM_EPS
        rop = safe_div(emission * emis, pdf_e[..., None])
        is_env = ltype == TYPE_LIGHT_ENV_SPHERE
        sel = is_env & valid
        direction = jnp.where(sel[..., None], dirn, direction)
        distance = jnp.where(sel, RT_MAX, distance)
        rad_over_pdf = jnp.where(sel[..., None], rop, rad_over_pdf)
        pdf = jnp.where(sel, pdf_e, pdf)

    is_singular = ltype >= TYPE_LIGHT_POINT
    return LightSample(
        direction=direction,
        distance=distance,
        radiance_over_pdf=rad_over_pdf,
        pdf=pdf,
        is_singular=is_singular,
    )


def env_radiance(lights: DeviceLights, direction: jnp.ndarray):
    """Env emission + MIS pdf for rays escaping the scene.

    Port of ``__miss__env_constant`` / ``__miss__env_sphere``
    (``miss.cu:114-230``). Returns (emission [N,3], pdf_light [N], has_env).
    """
    n = direction.shape[0]
    if lights.num == 0:
        return jnp.zeros((n, 3)), jnp.zeros((n,)), False

    t0 = lights.types_static[0]
    if t0 == TYPE_LIGHT_ENV_CONST:
        emission = jnp.broadcast_to(lights.emission[0], (n, 3))
        pdf = jnp.full((n,), 0.25 / M_PI)
        return emission, pdf, True
    if t0 == TYPE_LIGHT_ENV_SPHERE:
        r = jnp.einsum(
            "ij,nj->ni", lights.ori_inv[0], direction, precision=HIGHEST
        )
        if lights.env_is_cube:
            # true cube lookup for the radiance (Device.cpp:3014-3283 cube
            # CUarrays) AND for the MIS pdf: env_pdf is the [6, Hc, Wc]
            # intensity * invIntegral grid over the ACTUAL face texels —
            # the same grid NEE samples from, so MIS stays consistent
            from .texture import cube_face_uv, sample_cube_env

            _, ch, cw, _ = lights.env_cube.shape
            face, u, v = cube_face_uv(r)
            tx = jnp.clip((u * cw).astype(jnp.int32), 0, cw - 1)
            ty = jnp.clip((v * ch).astype(jnp.int32), 0, ch - 1)
            rad = sample_cube_env(lights.env_cube, r)
            pdf = lights.env_pdf[face, ty, tx]
        else:
            h, w, _ = lights.env_texture.shape
            u = (jnp.arctan2(-r[..., 0], r[..., 2]) + M_PI) * 0.5 / M_PI
            v = jnp.arccos(jnp.clip(-r[..., 1], -1.0, 1.0)) / M_PI
            tx = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
            ty = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
            ev = lights.env_eval_pack[ty, tx]      # ONE row: rgb | pdf
            rad = ev[..., 0:3]
            # pdf = intensity(tex) * invIntegral (miss.cu:195-198)
            pdf = ev[..., 3]
        emission = rad * lights.emission[0]
        return emission, pdf, True
    return jnp.zeros((n, 3)), jnp.zeros((n,)), False
