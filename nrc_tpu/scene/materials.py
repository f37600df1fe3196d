"""Parametric material system — the Replacement for MDL JIT codegen.

The reference JIT-compiles MDL materials to per-material PTX direct callables
(``nrc/src/Raytracer.cpp:1674-2536``, ``nrc/src/Device.cpp:2833-3012``). A
jitted JAX program has no function pointers, so MDL's *capabilities* become a fixed family of
BSDF archetypes dispatched with ``lax.switch`` over a SoA parameter table:
one row per material, all branches compiled once.

Archetype coverage maps the reference's ``data/mdl/*.mdl`` material set
(diffuse/glossy/specular x reflect/transmit, thin-walled, cutout, emission,
volume absorption/scattering); hair/measured/layered land in later passes.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import numpy as np


class Archetype(enum.IntEnum):
    """BSDF archetypes. Order is the ``lax.switch`` branch index."""

    DIFFUSE_REFLECTION = 0     # df::diffuse_reflection_bsdf
    GGX_REFLECT = 1            # df::microfacet_ggx_* / simple_glossy, scatter_reflect
    GGX_TRANSMIT = 2           # ... scatter_transmit
    GGX_REFLECT_TRANSMIT = 3   # ... scatter_reflect_transmit
    SPECULAR_REFLECT = 4       # df::specular_bsdf, scatter_reflect
    SPECULAR_TRANSMIT = 5      # ... scatter_transmit
    SPECULAR_REFLECT_TRANSMIT = 6  # ... scatter_reflect_transmit (glass)
    DIFFUSE_TRANSMISSION = 7   # df::diffuse_transmission_bsdf
    NULL_BSDF = 8              # emission-only materials (black bsdf ends path)
    HAIR = 9                   # df::chiang_hair_bsdf (curve primitives)
    MEASURED = 10              # df::measured_bsdf (data-driven, ops/mbsdf.py)

NUM_ARCHETYPES = len(Archetype)


class EmissionMode(enum.IntEnum):
    NONE = 0
    RADIANT_EXITANCE = 1  # intensity_radiant_exitance: radiance = I / pi
    POWER = 2             # intensity_power: divide by surface area


@dataclasses.dataclass
class Material:
    """One material row. Mirrors the knobs MDL exposes in the sample set."""

    name: str = "default"
    archetype: Archetype = Archetype.DIFFUSE_REFLECTION
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)   # tint
    roughness: Tuple[float, float] = (0.0, 0.0)            # (u, v)
    ior: float = 1.5
    thin_walled: bool = False
    emission_intensity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_mode: EmissionMode = EmissionMode.NONE
    # homogeneous volume coefficients (entered on transmission)
    sigma_a: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sigma_s: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    volume_bias: float = 0.0   # HG phase anisotropy g
    cutout_opacity: float = 1.0
    # chiang hair BSDF parameters (data/mdl/bsdf_hair.mdl); albedo doubles
    # as the diffuse reflection tint
    hair_roughness: Tuple[Tuple[float, float], ...] = (
        (0.1, 0.1), (0.2, 0.2), (0.3, 0.3),
    )  # (longitudinal, azimuthal) per lobe R / TT / TRT
    hair_absorption: Tuple[float, float, float] = (0.02, 0.3, 0.6)
    hair_cuticle_angle: float = 0.0524  # radians (3 deg default)
    hair_diffuse_weight: float = 0.0
    # measured BSDF (df::measured_bsdf) — path to an .npz container or a
    # MERL .binary measurement; loaded and CDF-built by scene/mbsdf.py
    mbsdf_path: str = ""
    mbsdf_multiplier: float = 1.0
    # 2D textures (MDL base::file_texture usages in the sample materials:
    # bsdf_diffuse_reflection_tex.mdl, bsdf_diffuse_reflection_cutout.mdl,
    # edf_diffuse_tex.mdl). Empty path = untextured. Paths are absolute
    # after MDL parsing.
    albedo_tex_path: str = ""
    albedo_tex_srgb: bool = True
    cutout_tex_path: str = ""     # mono average of RGB, linear gamma
    emission_tex_path: str = ""
    emission_tex_srgb: bool = True
    # base::rotation_translation_scale on the uv coordinate (rotation about
    # w only — the part exercisable through texture_2d placement params)
    uv_scale: Tuple[float, float] = (1.0, 1.0)
    uv_translation: Tuple[float, float] = (0.0, 0.0)
    uv_rotation_z: float = 0.0  # radians
    # ---- second lobe + blend/modifier descriptor (MDL combinators:
    # weighted/fresnel/measured_curve layers, normalized/clamped/unbounded
    # mixes, directional/fresnel/thin_film/measured_curve factors —
    # data/mdl/layer_*.mdl, mixer_*.mdl, modifier_*.mdl). Lobe 1 = "layer",
    # lobe 2 = "base"; archetype2 = NULL_BSDF means single-lobe.
    archetype2: Archetype = Archetype.NULL_BSDF
    albedo2: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness2: Tuple[float, float] = (0.0, 0.0)
    blend_mode: int = 0                                   # ops.layered.BLEND_*
    blend_w1: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    blend_w2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    blend_ior: float = 1.5
    curve_values: Tuple[Tuple[float, float, float], ...] = ()
    mod_mode: int = 0                                     # ops.layered.MOD_*
    mod_a: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mod_b: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mod_exp: float = 1.0
    # procedural noise tint (MDL base::perlin/flow/worley_noise_texture
    # driving a diffuse tint, data/mdl/noise_*_glossy.mdl): evaluated at
    # shade time in world space (ops/noise.py). 0 = none.
    noise_mode: int = 0              # ops.noise.NOISE_*
    noise_color1: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    noise_color2: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    noise_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    noise_levels: int = 3
    noise_absolute: bool = False
    noise_thr_low: float = 0.0
    noise_thr_high: float = 1.0
    noise_marble: bool = False
    noise_target: int = 0            # 0 = lobe-1 albedo, 1 = lobe-2 (base)
    noise_bump_factor: float = 0.0   # *_noise_bump_texture factor (0 = off)

    @property
    def is_emissive(self) -> bool:
        return self.emission_mode != EmissionMode.NONE and any(
            c > 0.0 for c in self.emission_intensity
        )


@dataclasses.dataclass
class MaterialTable:
    """SoA device-ready material parameter table (float32/int32 arrays)."""

    archetype: np.ndarray           # [M] int32
    albedo: np.ndarray              # [M, 3] f32
    roughness: np.ndarray           # [M, 2] f32
    ior: np.ndarray                 # [M] f32
    thin_walled: np.ndarray         # [M] int32
    emission_intensity: np.ndarray  # [M, 3] f32
    emission_mode: np.ndarray       # [M] int32
    sigma_a: np.ndarray             # [M, 3] f32
    sigma_s: np.ndarray             # [M, 3] f32
    volume_bias: np.ndarray         # [M] f32
    cutout_opacity: np.ndarray      # [M] f32
    hair_roughness: np.ndarray      # [M, 3, 2] f32
    hair_absorption: np.ndarray     # [M, 3] f32
    hair_cuticle_angle: np.ndarray  # [M] f32
    hair_diffuse_weight: np.ndarray  # [M] f32
    # texture bindings (-1 = untextured) + uv placement transform
    albedo_tex: np.ndarray = None   # [M] int32
    cutout_tex: np.ndarray = None   # [M] int32
    emission_tex: np.ndarray = None  # [M] int32
    uv_xf: np.ndarray = None        # [M, 6] f32: su, sv, tu, tv, cos_rz, sin_rz
    atlas: object = None            # scene.texture.TextureAtlas
    # second lobe + blend/modifier descriptor
    archetype2: np.ndarray = None   # [M] int32
    albedo2: np.ndarray = None      # [M, 3]
    roughness2: np.ndarray = None   # [M, 2]
    blend_mode: np.ndarray = None   # [M] int32
    blend_w1: np.ndarray = None     # [M, 3]
    blend_w2: np.ndarray = None     # [M, 3]
    blend_ior: np.ndarray = None    # [M]
    curve: np.ndarray = None        # [M, CURVE_RES, 3] resampled curves
    mod_mode: np.ndarray = None     # [M] int32
    mod_a: np.ndarray = None        # [M, 3]
    mod_b: np.ndarray = None        # [M, 3]
    mod_exp: np.ndarray = None      # [M]
    # measured BSDFs (df::measured_bsdf; Device.cpp:3347-3663)
    mbsdf_index: np.ndarray = None       # [M] int32 (-1 = none)
    mbsdf_multiplier: np.ndarray = None  # [M] f32
    mbsdf: object = None                 # scene.mbsdf.MBSDFTableHost
    # procedural noise tint rows (ops/noise.py)
    noise_mode: np.ndarray = None        # [M] int32
    noise_color1: np.ndarray = None      # [M, 3]
    noise_color2: np.ndarray = None      # [M, 3]
    noise_scale: np.ndarray = None       # [M, 3]
    noise_levels: np.ndarray = None      # [M] int32
    noise_absolute: np.ndarray = None    # [M] int32
    noise_thr: np.ndarray = None         # [M, 2] low/high
    noise_marble: np.ndarray = None      # [M] int32
    noise_target: np.ndarray = None      # [M] int32
    noise_bump_factor: np.ndarray = None  # [M] f32

    @staticmethod
    def build(materials: list[Material], atlas=None) -> "MaterialTable":
        """``atlas``: pass an existing TextureAtlas to reuse its decoded
        textures (its (path, gamma) dedup makes the re-adds free) — used by
        live material edits so a parameter tweak never re-decodes images."""
        if not materials:
            materials = [Material()]
        from .texture import TextureAtlas

        if atlas is None:
            atlas = TextureAtlas.empty()

        def tex(path: str, srgb: bool) -> int:
            return atlas.add(path, srgb) if path else -1

        albedo_tex = np.asarray(
            [tex(m.albedo_tex_path, m.albedo_tex_srgb) for m in materials], np.int32
        )
        cutout_tex = np.asarray(
            [tex(m.cutout_tex_path, False) for m in materials], np.int32
        )
        emission_tex = np.asarray(
            [tex(m.emission_tex_path, m.emission_tex_srgb) for m in materials],
            np.int32,
        )
        uv_xf = np.asarray(
            [
                [
                    m.uv_scale[0], m.uv_scale[1],
                    m.uv_translation[0], m.uv_translation[1],
                    math.cos(m.uv_rotation_z), math.sin(m.uv_rotation_z),
                ]
                for m in materials
            ],
            np.float32,
        )
        # measured curves resampled to a fixed grid over theta in [0, pi/2]
        from ..ops.layered import CURVE_RES

        curve = np.ones((len(materials), CURVE_RES, 3), np.float32)
        for i, m in enumerate(materials):
            cv = np.asarray(m.curve_values, np.float32)
            if cv.size:
                x_src = np.linspace(0.0, 1.0, cv.shape[0])
                x_dst = np.linspace(0.0, 1.0, CURVE_RES)
                for c in range(3):
                    curve[i, :, c] = np.interp(x_dst, x_src, cv[:, c])

        # measured BSDFs: dedup by path, stack into one table set
        from .mbsdf import MBSDFTableHost, load_measurement

        mbsdf_paths: list[str] = []
        mbsdf_index = np.full(len(materials), -1, np.int32)
        for i, m in enumerate(materials):
            if m.mbsdf_path:
                if m.mbsdf_path not in mbsdf_paths:
                    mbsdf_paths.append(m.mbsdf_path)
                mbsdf_index[i] = mbsdf_paths.index(m.mbsdf_path)
        mbsdf = MBSDFTableHost.build(
            [load_measurement(p) for p in mbsdf_paths]
        )

        return MaterialTable(
            noise_mode=np.asarray([m.noise_mode for m in materials], np.int32),
            noise_color1=np.asarray([m.noise_color1 for m in materials], np.float32),
            noise_color2=np.asarray([m.noise_color2 for m in materials], np.float32),
            noise_scale=np.asarray([m.noise_scale for m in materials], np.float32),
            noise_levels=np.asarray([m.noise_levels for m in materials], np.int32),
            noise_absolute=np.asarray([int(m.noise_absolute) for m in materials], np.int32),
            noise_thr=np.asarray(
                [(m.noise_thr_low, m.noise_thr_high) for m in materials], np.float32
            ),
            noise_marble=np.asarray([int(m.noise_marble) for m in materials], np.int32),
            noise_target=np.asarray([m.noise_target for m in materials], np.int32),
            noise_bump_factor=np.asarray(
                [m.noise_bump_factor for m in materials], np.float32
            ),
            mbsdf_index=mbsdf_index,
            mbsdf_multiplier=np.asarray(
                [m.mbsdf_multiplier for m in materials], np.float32
            ),
            mbsdf=mbsdf,
            albedo_tex=albedo_tex,
            cutout_tex=cutout_tex,
            emission_tex=emission_tex,
            uv_xf=uv_xf,
            atlas=atlas,
            archetype2=np.asarray([int(m.archetype2) for m in materials], np.int32),
            albedo2=np.asarray([m.albedo2 for m in materials], np.float32),
            roughness2=np.asarray([m.roughness2 for m in materials], np.float32),
            blend_mode=np.asarray([m.blend_mode for m in materials], np.int32),
            blend_w1=np.asarray([m.blend_w1 for m in materials], np.float32),
            blend_w2=np.asarray([m.blend_w2 for m in materials], np.float32),
            blend_ior=np.asarray([m.blend_ior for m in materials], np.float32),
            curve=curve,
            mod_mode=np.asarray([m.mod_mode for m in materials], np.int32),
            mod_a=np.asarray([m.mod_a for m in materials], np.float32),
            mod_b=np.asarray([m.mod_b for m in materials], np.float32),
            mod_exp=np.asarray([m.mod_exp for m in materials], np.float32),
            archetype=np.asarray([int(m.archetype) for m in materials], np.int32),
            albedo=np.asarray([m.albedo for m in materials], np.float32),
            roughness=np.asarray([m.roughness for m in materials], np.float32),
            ior=np.asarray([m.ior for m in materials], np.float32),
            thin_walled=np.asarray([int(m.thin_walled) for m in materials], np.int32),
            emission_intensity=np.asarray(
                [m.emission_intensity for m in materials], np.float32
            ),
            emission_mode=np.asarray([int(m.emission_mode) for m in materials], np.int32),
            sigma_a=np.asarray([m.sigma_a for m in materials], np.float32),
            sigma_s=np.asarray([m.sigma_s for m in materials], np.float32),
            volume_bias=np.asarray([m.volume_bias for m in materials], np.float32),
            cutout_opacity=np.asarray([m.cutout_opacity for m in materials], np.float32),
            hair_roughness=np.asarray(
                [m.hair_roughness for m in materials], np.float32
            ),
            hair_absorption=np.asarray(
                [m.hair_absorption for m in materials], np.float32
            ),
            hair_cuticle_angle=np.asarray(
                [m.hair_cuticle_angle for m in materials], np.float32
            ),
            hair_diffuse_weight=np.asarray(
                [m.hair_diffuse_weight for m in materials], np.float32
            ),
        )

    @property
    def num_materials(self) -> int:
        return int(self.archetype.shape[0])
