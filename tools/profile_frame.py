"""Per-stage frame-time profiler: one JSON line per measurement.

Produces a frame budget table: wall-clock per frame at
a given config, optionally with stages truncated (NRC_PROFILE_SKIP) or the
wide walk's leaf tests stubbed (NRC_WIDE_SKIP_LEAF) to isolate stage cost.
Each stage knob changes the traced program, so each measurement is one
process invocation:

    python tools/profile_frame.py --case cornell_big --res 640x640 --spp 4
    NRC_PROFILE_SKIP=all python tools/profile_frame.py --case cornell ...

Also reports the bounce-count histogram of the render wavefront (the alive
decay that sizes inter-bounce ray compaction).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "cornell",
)
CASES = {
    "cornell": (
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell.txt"),
    ),
    "cornell_big": (
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell_big.txt"),
    ),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="cornell", choices=sorted(CASES))
    ap.add_argument("--res", default=None, help="WxH")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--mode", default="FULL")
    ap.add_argument("--train", type=int, default=1)
    ap.add_argument("--hist", action="store_true",
                    help="also dump the bounce-count histogram")
    ap.add_argument("--xprof", action="store_true",
                    help="capture a jax.profiler trace of ONE warm frame "
                         "and report device-time by HLO category")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nrc_tpu.config import RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    sysf, scnf = CASES[args.case]
    t0 = time.perf_counter()
    scene, system = load_scene(sysf, scnf)
    t_load = time.perf_counter() - t0
    if args.res:
        w, h = (int(x) for x in args.res.lower().split("x"))
        system.resolution = (w, h)
        scene.camera.aspect = w / h
    system.tile_size = (args.tile, args.tile)

    t0 = time.perf_counter()
    r = Renderer(
        scene, system, render_mode=RenderMode[args.mode],
        train=bool(args.train), adaptive_tiles=False,
    )
    t_upload = time.perf_counter() - t0
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}; "
        f"load {t_load:.1f}s upload {t_upload:.1f}s")

    t0 = time.perf_counter()
    r.render_frame()
    jax.block_until_ready(r.image)
    t_compile = time.perf_counter() - t0

    # warm frames
    stats = []
    t0 = time.perf_counter()
    for _ in range(args.spp):
        stats.append(r.render_frame())
    jax.block_until_ready((r.image, r.net_state))
    dt = time.perf_counter() - t0
    traced = sum(int(s.traced_rays) for s in stats)

    xprof_table = None
    if args.xprof:
        # one traced warm frame; aggregate the perfetto dump's device
        # slices by HLO category (no TensorBoard needed — parse the json)
        import glob
        import gzip
        import json as _json
        import tempfile

        tdir = tempfile.mkdtemp(prefix="nrc_xprof_")
        with jax.profiler.trace(tdir, create_perfetto_trace=True):
            r.render_frame()
            jax.block_until_ready(r.image)
        agg = {}
        for path in glob.glob(
            f"{tdir}/**/*.trace.json.gz", recursive=True
        ):
            with gzip.open(path, "rt") as f:
                tr = _json.load(f)
            # device events carry an hlo_category argument
            for ev in tr.get("traceEvents", []):
                if ev.get("ph") != "X":
                    continue
                a = ev.get("args") or {}
                cat = a.get("hlo_category")
                if cat is None:
                    continue
                agg[cat] = agg.get(cat, 0.0) + ev.get("dur", 0.0)
        xprof_table = {
            k: round(v / 1e3, 1)  # us -> ms
            for k, v in sorted(agg.items(), key=lambda kv: -kv[1])
        }

    payload = {
        "label": args.label or args.case,
        "case": args.case,
        "res": list(r.system.resolution),
        "mode": args.mode,
        "train": bool(args.train),
        "skip": os.environ.get("NRC_PROFILE_SKIP", ""),
        "skip_leaf": os.environ.get("NRC_WIDE_SKIP_LEAF", "0"),
        "chunk": os.environ.get("NRC_WAVEFRONT_CHUNK", "default"),
        "ms_per_frame": round(1000.0 * dt / args.spp, 1),
        "fps": round(args.spp / dt, 4),
        "mrays_traced": round(traced / dt / 1e6, 3),
        "load_s": round(t_load, 1),
        "upload_s": round(t_upload, 1),
        "compile_s": round(t_compile, 1),
    }

    if args.hist:
        # render-wavefront bounce histogram at this camera (alive decay)
        from nrc_tpu.render.frame import _pixel_grid
        from nrc_tpu.render.integrator import trace_wavefront_chunked
        from nrc_tpu.scene.camera import generate_primary_rays
        from nrc_tpu.utils import rng as R

        cam = r._camera_arrays()
        pix, pidx = _pixel_grid(r.cfg)
        seeds = R.tea(pidx, jnp.uint32(7))
        seeds, jitter = R.rng2(seeds)
        org, dirn = generate_primary_rays(
            pix, jitter, (r.cfg.width, r.cfg.height),
            cam.p, cam.u, cam.v, cam.w, lens=r.cfg.lens_shader,
        )
        out = trace_wavefront_chunked(
            r.device_scene, org, dirn, seeds, r.cfg, train=False
        )
        bc = np.asarray(out.bounce_count)
        hist = np.bincount(bc, minlength=r.cfg.max_depth + 2)
        payload["bounce_hist"] = hist.tolist()
        # fraction of lanes still doing work at depth >= d
        alive = [int(hist[d:].sum()) for d in range(len(hist))]
        payload["alive_at_depth"] = [
            round(a / max(bc.size, 1), 4) for a in alive
        ]

    if xprof_table is not None:
        payload["hlo_ms"] = xprof_table
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
