"""Extended benchmark suite: one JSON line per config (the headline stays
``bench.py``): the Cornell frame loop with each encoding, the generated
big Cornell scene, the standalone cache train/infer throughput and the
shipped-config quality against the stored ground truth.

Usage: python bench_suite.py [--spp N] [--only cornell,hash,...]

Every line names the device it ran on; a case that fails makes the run
exit non-zero.
"""

import argparse
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "data", "cornell")
SYSTEM = os.path.join(CORNELL, "system_mdl_cornell.txt")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _emit(row):
    import jax

    dev = jax.devices()[0]
    row["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(row), flush=True)


def _bench_frames(r, spp):
    """Timed frame loop -> (fps, traced_mrays_per_s).

    Mrays/s counts rays actually cast (closest-hit segments of live lanes
    + valid shadow rays, summed on device per frame) — the same numerator
    as bench.py's headline."""
    import jax

    for _ in range(3):
        r.render_frame()
    jax.block_until_ready((r.image, r.net_state))
    stats = []
    t0 = time.perf_counter()
    for _ in range(spp):
        stats.append(r.render_frame())
    jax.block_until_ready((r.image, r.net_state))
    dt = time.perf_counter() - t0
    traced = sum(int(s.traced_rays) for s in stats)  # after the barrier
    return spp / dt, traced / dt / 1e6


def _frame_case(name, scnf, spp, res=None, tile=(4, 4), encoding=None):
    from nrc_tpu.config import RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    scene, system = load_scene(SYSTEM, os.path.join(CORNELL, scnf))
    if res is not None:
        system.resolution = res
        scene.camera.aspect = res[0] / res[1]
    system.tile_size = tile
    kw = {}
    if encoding is not None:
        from nrc_tpu.config import InputEncoding, NetworkConfig

        kw["net_cfg"] = NetworkConfig(
            encoding=InputEncoding.HASH
            if encoding == "hash" else InputEncoding.FREQUENCY
        )
    r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                 adaptive_tiles=False, **kw)
    fps, mrays = _bench_frames(r, spp)
    _emit({
        "case": name, "metric": "mrays_per_s", "value": mrays,
        "fps": fps, "ms_per_frame": 1000.0 / fps,
        "unit": "Mrays/s traced",
    })


def case_cornell(spp):
    _frame_case("cornell_320_freq", "scene_mdl_cornell.txt", spp)


def case_hash(spp):
    _frame_case("cornell_320_hash", "scene_mdl_cornell.txt", spp,
                encoding="hash")


def case_big(spp):
    """Cornell + a 32k-triangle sphere: the wide BVH walk, the compact-once
    wavefront and the tiled primary raster."""
    _frame_case("cornell_big_320_freq", "scene_mdl_cornell_big.txt",
                max(spp // 4, 4))


def case_mlp(spp):
    """Standalone cache train+infer samples/s (tcnn-equivalent measure)."""
    import jax
    import jax.numpy as jnp

    from nrc_tpu.config import NetworkConfig
    from nrc_tpu.models import network as N

    cfg = NetworkConfig()
    ns = N.init_network(jax.random.PRNGKey(0), cfg)
    B = 16384
    q = jax.random.uniform(jax.random.PRNGKey(1), (B, 15))
    t = jax.random.uniform(jax.random.PRNGKey(2), (B, 3))

    step = jax.jit(lambda ns, q, t: N.train_step(ns, q, t, cfg))
    ns2, _ = step(ns, q, t)
    jax.block_until_ready(ns2)
    t0 = time.perf_counter()
    R = 50
    for _ in range(R):
        ns2, _ = step(ns2, q, t)
    jax.block_until_ready(ns2)
    dt = time.perf_counter() - t0
    _emit({
        "case": "mlp_train_16384", "metric": "samples_per_s",
        "value": R * B / dt / 1e6, "unit": "Msamples/s",
    })

    inf = jax.jit(lambda ns, q: N.infer(ns, q, cfg))
    r = jax.block_until_ready(inf(ns2, q))
    t0 = time.perf_counter()
    for _ in range(R):
        r = inf(ns2, q)
    jax.block_until_ready(r)
    dt = time.perf_counter() - t0
    _emit({
        "case": "mlp_infer_16384", "metric": "samples_per_s",
        "value": R * B / dt / 1e6, "unit": "Msamples/s",
    })


def case_quality(spp):
    """Shipped-config quality: render the Cornell config (320x320, 256
    spp) in FULL mode with online training for BOTH encodings and report
    tonemapped PSNR/SSIM vs the stored 4096-spp NO_CACHE ground truth
    (tests/data/cornell_gt_320.npz, tools/make_ground_truth.py).
    ``--spp`` is ignored: the config IS the shipped one."""
    del spp
    import numpy as np
    import jax.numpy as jnp

    from nrc_tpu.config import InputEncoding, NetworkConfig, RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene
    from nrc_tpu.utils.metrics import psnr, ssim
    from nrc_tpu.utils.tonemap import tonemap_to_u8

    gt_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "tests", "data", "cornell_gt_320.npz",
    )
    gt = np.load(gt_path)["hdr"]

    for enc in (InputEncoding.HASH, InputEncoding.FREQUENCY):
        scene, system = load_scene(
            SYSTEM, os.path.join(CORNELL, "scene_mdl_cornell.txt")
        )
        system.tile_size = (4, 4)
        shipped_spp = system.samples_sqrt ** 2  # 256 at the shipped config
        r = Renderer(
            scene, system, net_cfg=NetworkConfig(encoding=enc),
            render_mode=RenderMode.FULL, train=True, adaptive_tiles=False,
        )
        t0 = time.perf_counter()
        for _ in range(shipped_spp):
            r.render_frame()
        tm = system.tonemapper
        img = np.asarray(
            tonemap_to_u8(jnp.asarray(r.image_hdr()), tm), np.float32
        ) / 255.0
        dt = time.perf_counter() - t0
        gt_t = np.asarray(
            tonemap_to_u8(jnp.asarray(gt), tm), np.float32
        ) / 255.0
        _emit({
            "case": f"quality_cornell320_{enc.name.lower()}",
            "metric": "psnr_db",
            "value": float(psnr(img, gt_t)),
            "ssim": float(ssim(img, gt_t)),
            "spp": shipped_spp, "seconds": dt,
            "unit": "dB vs 4096-spp NO_CACHE GT (tonemapped)",
        })


CASES = {
    "cornell": case_cornell,
    "hash": case_hash,
    "big": case_big,
    "mlp": case_mlp,
    "quality": case_quality,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    import jax

    if jax.devices()[0].platform != "gpu":
        log(f"bench_suite needs a GPU; found {jax.devices()[0].platform}")
        return 1
    names = args.only.split(",") if args.only else list(CASES)
    failed = []
    for n in names:
        log(f"=== {n} ===")
        try:
            CASES[n](args.spp)
        except Exception as e:  # keep going; report the failure at the end
            log(f"case {n} failed: {type(e).__name__}: {e}")
            failed.append(n)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
