"""The quality gate: FULL-mode renders vs a 4096-spp NO_CACHE ground truth
at tonemapped PSNR/SSIM.

The ground truth (``tests/data/cornell_gt_128.npz``) is the repository's
Cornell box rendered on an NVIDIA H100 by ``tools/make_ground_truth.py``.
Thresholds sit ~2 dB (and ~0.02 SSIM) under the values measured at this
exact config, so regressions in transport, training dynamics, or the
encodings trip it:

measured (CPU, fixed seed, 128x128, 128 frames):
  FULL hash:      33.15 dB / 0.9685 SSIM
  FULL frequency: 34.04 dB / 0.9640 SSIM
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from nrc_tpu.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu.render.renderer import Renderer
from nrc_tpu.scene.scene_builder import load_scene
from nrc_tpu.utils.metrics import psnr, ssim
from nrc_tpu.utils.tonemap import tonemap_to_u8

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)

GT_PATH = os.path.join(os.path.dirname(__file__), "data", "cornell_gt_128.npz")


def _render_full(encoding, frames):
    scene, system = load_scene(
        f"{CORNELL}/system_mdl_cornell.txt",
        f"{CORNELL}/scene_mdl_cornell.txt",
    )
    system.resolution = (128, 128)
    scene.camera.aspect = 1.0
    system.tile_size = (4, 4)
    r = Renderer(
        scene, system,
        net_cfg=NetworkConfig(encoding=encoding),
        render_mode=RenderMode.FULL, train=True, adaptive_tiles=False,
    )
    for _ in range(frames):
        r.render_frame()
    tm = system.tonemapper
    img = np.asarray(
        tonemap_to_u8(jnp.asarray(r.image_hdr()), tm), np.float32
    ) / 255.0
    gt = np.load(GT_PATH)["hdr"]
    gt_t = np.asarray(tonemap_to_u8(jnp.asarray(gt), tm), np.float32) / 255.0
    return psnr(img, gt_t), ssim(img, gt_t)


@pytest.mark.parametrize(
    "encoding,frames,min_psnr,min_ssim",
    [
        (InputEncoding.HASH, 128, 31.0, 0.95),
        (InputEncoding.FREQUENCY, 128, 32.0, 0.945),
    ],
    ids=["hash", "frequency"],
)
def test_full_mode_quality_vs_4096spp_gt(encoding, frames, min_psnr, min_ssim):
    p, s = _render_full(encoding, frames)
    assert p >= min_psnr, f"PSNR {p:.2f} dB < {min_psnr}"
    assert s >= min_ssim, f"SSIM {s:.4f} < {min_ssim}"
