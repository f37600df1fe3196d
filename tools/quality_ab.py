"""Frequency-encoding quality A/B at the shipped Cornell config.

VERDICT r2 #5: the reference's DEFAULT encoding is frequency
(NRCNetworkConfigs.h:120-127) but the out-of-the-box config measured
25.2 dB at 320^2 x 256 spp vs the >=28 dB gate (hash passes at 30.8).
This tool renders the shipped config under controlled variants and
reports tonemapped PSNR/SSIM vs the cached 1024-spp NO_CACHE GT, one
JSON line per variant:

    python tools/quality_ab.py [--variants base,domain32,...] [--res 320]

Variants:
  base       r2 behavior: freq_domain_scale=1, lr 1e-3 flat, EMA 0.99
  domain32   freq_domain_scale=32 (octaves cover the scene like the
             reference's 0.005-scaled positions; now the default)
  domain8    freq_domain_scale=8
  warmup     domain32 + linear lr warmup 0 -> 1e-3 over 32 frames
  lr3e3      domain32 + lr 3e-3 flat
  ema95      domain32 + EMA decay 0.95
  hash       hash encoding reference point
"""

import argparse
import os as _os
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "cornell",
)


def run_variant(name, res):
    import numpy as np
    import jax.numpy as jnp

    from nrc_tpu.config import InputEncoding, NetworkConfig, RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene
    from nrc_tpu.utils.metrics import psnr, ssim
    from nrc_tpu.utils.tonemap import tonemap_to_u8

    scene, system = load_scene(
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell.txt"),
    )
    system.resolution = (res, res)
    scene.camera.aspect = 1.0
    system.tile_size = (4, 4)
    spp = system.samples_sqrt ** 2

    enc = InputEncoding.HASH if name == "hash" else InputEncoding.FREQUENCY
    kw = {}
    relfact = False
    # reset experiment knobs (variants share the process)
    for k in ("NRC_TRAIN_OUTPUT_RELU", "NRC_OUTPUT_LEAKY",
              "NRC_GRAD_SCALE", "NRC_WOUT_POS_INIT"):
        os.environ.pop(k, None)
    if name == "base":
        kw["freq_domain_scale"] = 1.0
    elif name == "relu_out":
        os.environ["NRC_TRAIN_OUTPUT_RELU"] = "1"
    elif name == "ref_literals":
        kw["ema_decay"] = 0.99
    elif name == "ref_literals_relu":
        kw["ema_decay"] = 0.99
        os.environ["NRC_TRAIN_OUTPUT_RELU"] = "1"
    elif name.startswith("relu_"):
        # Output-ReLU mechanism experiments (VERDICT r4 next #5): all run
        # the reference-EXACT literals (lr 1e-3, EMA 0.99) and train
        # through the output ReLU, each adding ONE candidate rescue:
        #   relu_leaky001 / relu_leaky01 — leaky output slope 0.001 / 0.01
        #   relu_posinit — positive-mean w_out init (first preds > 0)
        #   relu_gs128 — tcnn-style loss scale 128 around bf16 adjoints
        kw["ema_decay"] = 0.99
        os.environ["NRC_TRAIN_OUTPUT_RELU"] = "1"
        if name == "relu_leaky001":
            os.environ["NRC_OUTPUT_LEAKY"] = "0.001"
        elif name == "relu_leaky01":
            os.environ["NRC_OUTPUT_LEAKY"] = "0.01"
        elif name == "relu_posinit":
            os.environ["NRC_WOUT_POS_INIT"] = "1"
        elif name == "relu_gs128":
            os.environ["NRC_GRAD_SCALE"] = "128"
        else:
            raise SystemExit(f"unknown relu_ variant {name}")
    elif name in ("domain32", "warmup", "lr3e3", "ema95", "ema95lr3", "relfact_ema95lr3"):
        kw["freq_domain_scale"] = 32.0
    elif name == "domain8":
        kw["freq_domain_scale"] = 8.0
    if name == "s1_ema95lr3":
        kw["freq_domain_scale"] = 1.0
    if name in ("ema95", "ema95lr3", "relfact_ema95lr3", "s1_ema95lr3"):
        kw["ema_decay"] = 0.95
    if name == "ema90":
        kw["ema_decay"] = 0.90
    if name.startswith("relfact"):
        relfact = True
    net_cfg = NetworkConfig(encoding=enc, **kw)

    r = Renderer(
        scene, system, net_cfg=net_cfg,
        render_mode=RenderMode.FULL, train=True, adaptive_tiles=False,
        reflectance_factoring=relfact,
    )
    base_lr = (
        1e-3 if name in ("ref_literals", "ref_literals_relu")
        or (name.startswith("relu_") and name != "relu_out")
        else 3e-3 if name in ("lr3e3", "ema95lr3", "relfact_ema95lr3", "s1_ema95lr3")
        else net_cfg.learning_rate
    )
    t0 = time.perf_counter()
    for i in range(spp):
        if name == "warmup":
            r.hyper = dataclasses.replace(
                r.hyper, learning_rate=base_lr * min((i + 1) / 32.0, 1.0)
            )
        elif name in ("lr3e3", "ema95lr3", "relfact_ema95lr3", "s1_ema95lr3",
                      "ref_literals", "ref_literals_relu") \
                or (name.startswith("relu_") and name != "relu_out"):
            r.hyper = dataclasses.replace(r.hyper, learning_rate=base_lr)
        r.render_frame()
    tm = system.tonemapper
    img = np.asarray(
        tonemap_to_u8(jnp.asarray(r.image_hdr()), tm), np.float32
    ) / 255.0
    dt = time.perf_counter() - t0

    gt_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", f"cornell_gt_{res}.npz",
    )
    gt = np.load(gt_path)["hdr"]
    gt_t = np.asarray(tonemap_to_u8(jnp.asarray(gt), tm), np.float32) / 255.0
    print(json.dumps({
        "variant": name, "encoding": enc.name.lower(), "res": res,
        "reflectance_factoring": relfact,
        "spp": spp, "psnr_db": round(float(psnr(img, gt_t)), 2),
        "ssim": round(float(ssim(img, gt_t)), 4),
        "seconds": round(dt, 1),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--variants",
        default="base,domain8,domain32,warmup,lr3e3,ema95,hash",
    )
    ap.add_argument("--res", type=int, default=320)
    args = ap.parse_args()
    for v in args.variants.split(","):
        run_variant(v.strip(), args.res)


if __name__ == "__main__":
    main()
