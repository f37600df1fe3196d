"""Render high-spp NO_CACHE ground truths of the repository's Cornell box
and store them as npz artifacts under tests/data/ for the quality gates.

The reference's implicit oracle is Full vs NoCache at high spp
(SURVEY.md §4); BASELINE.md's gate asks for PSNR vs a >=1024-spp ground
truth. The artifacts are rendered on the GPU (the CPU would take hours at
4096 spp); the file's ``meta`` names the device that made it.

Usage: python tools/make_ground_truth.py [--spp 4096] [--res 128 320]
       [--out-dir tests/data]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

CORNELL = os.path.join(ROOT, "data", "cornell")


def render_ground_truth(res: int, spp: int):
    import jax

    from nrc_tpu.config import RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    scene, system = load_scene(
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell.txt"),
    )
    system.resolution = (res, res)
    scene.camera.aspect = 1.0
    r = Renderer(
        scene, system, render_mode=RenderMode.NO_CACHE, train=False,
        adaptive_tiles=False,
    )
    t0 = time.perf_counter()
    for i in range(spp):
        r.render_frame()
        if (i + 1) % 512 == 0:
            jax.block_until_ready(r.image)
            el = time.perf_counter() - t0
            print(f"[{res}: {i + 1}/{spp}] {(i + 1) / el:.1f} fps",
                  file=sys.stderr, flush=True)
    jax.block_until_ready(r.image)
    return r.image_hdr().astype(np.float32), system


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--res", type=int, nargs="+", default=[128, 320])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "tests", "data"))
    args = ap.parse_args()

    import jax

    kind = jax.devices()[0].device_kind
    for res in args.res:
        hdr, system = render_ground_truth(res, args.spp)
        out = os.path.join(args.out_dir, f"cornell_gt_{res}.npz")
        np.savez_compressed(
            out,
            hdr=hdr,
            spp=np.int32(args.spp),
            meta=np.bytes_(
                f"NO_CACHE Cornell {res}x{res}, {args.spp} spp, "
                f"pathLengths {system.path_lengths}, generated on {kind}"
                .encode()
            ),
        )
        print(f"wrote {out}: mean {hdr.mean(axis=(0, 1))}, "
              f"max {hdr.max():.3f}", flush=True)


if __name__ == "__main__":
    main()
