"""Benchmark: Cornell NRC frame loop on one GPU -> one JSON line.

Mirrors the reference's benchmark mode (``Application::benchmark``,
``nrc/src/Application.cpp:496-540``: async frame loop, sync, fps print) on
the repository's Cornell scene at its shipped 320x320 resolution, FULL
render mode with online training enabled — the complete per-frame NRC
pipeline (render + train wavefronts, cache inference, propagation,
shuffle, 4 Adam steps).

Prints exactly one JSON line naming the device it ran on:
  {"metric": "mrays_per_s", "value": N, "unit": "Mrays/s",
   "device": {"platform": "gpu", "kind": "...", "count": 1}, ...}

A run that finds no GPU, or fails, exits non-zero and prints no result.

Usage: python bench.py   (BENCH_SPP frames per rep, BENCH_REPS reps)
"""

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "data", "cornell")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench needs a GPU; found {dev.platform} ({dev.device_kind})")
        return 1

    from nrc_tpu.config import RenderMode
    from nrc_tpu.render.frame import frame_step
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    scene, system = load_scene(
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell.txt"),
    )
    # shipped Cornell config: 320x320, pathLengths 2..6
    system.tile_size = (4, 4)  # steady-state adapted size (~80% record fill)
    r = Renderer(
        scene, system, render_mode=RenderMode.FULL, train=True,
        adaptive_tiles=False,
    )
    log(f"bench device: {dev.platform} {dev.device_kind}")

    spp = int(os.environ.get("BENCH_SPP", "32"))
    reps = int(os.environ.get("BENCH_REPS", "5"))

    # The whole spp-frame loop runs as ONE jitted lax.scan, so the timing
    # holds device work and no per-frame host dispatch.
    step = functools.partial(
        frame_step,
        cfg=r.cfg,
        net_cfg=r.net_cfg,
        train_unbiased_ratio=r.cfg.train_unbiased_ratio,
    )

    def loop(scene, state, image, cam, it0, sub0, lr):
        def body(carry, _):
            image, state, it, sub = carry
            image, state, stats = step(
                scene, state, image, cam, it, sub, learning_rate=lr
            )
            carry = (image, state, it + jnp.int32(1), sub + jnp.uint32(1))
            return carry, (stats.traced_rays, stats.loss,
                           stats.num_train_records)

        return jax.lax.scan(body, (image, state, it0, sub0), None, length=spp)

    jloop = jax.jit(loop)
    cam = r._camera_arrays()
    lr = jnp.float32(r.hyper.learning_rate)

    def run_rep(image, state, it, sub):
        carry, outs = jloop(
            r.device_scene, state, image, cam, jnp.int32(it),
            jnp.uint32(sub), lr
        )
        jax.block_until_ready((carry, outs))
        return carry[0], carry[1], outs

    # compile + steady-state warm rep (uncounted)
    t0 = time.perf_counter()
    image, state, outs = run_rep(r.image, r.net_state, r.iteration,
                                 r.total_subframe)
    log(f"compile + warm rep: {time.perf_counter() - t0:.1f} s")
    it = r.iteration + spp
    sub = r.total_subframe + spp
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        image, state, outs = run_rep(image, state, it, sub)
        runs.append((time.perf_counter() - t0, outs))
        it += spp
        sub += spp
    runs.sort(key=lambda x: x[0])
    dt, outs = runs[len(runs) // 2]  # median rep: its time AND its rays
    log("rep times (s): " + ", ".join(f"{t:.4f}" for t, _ in runs))

    fps = spp / dt
    # rays actually cast: closest-hit segments of live lanes + shadow rays
    # with a valid light sample, counted on device per frame
    traced = int(jnp.sum(outs[0]))
    mrays = traced / dt / 1e6
    log(
        f"{spp} spp in {dt:.4f}s (median of {reps} one-dispatch reps) -> "
        f"{fps:.2f} fps, {mrays:.3f} Mrays/s traced, "
        f"loss {float(outs[1][-1]):.4f}, records {int(outs[2][-1])}"
    )
    print(json.dumps({
        "metric": "mrays_per_s",
        "value": mrays,
        "unit": "Mrays/s",
        "ms_per_frame": 1e3 / fps,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "timing": f"in-program {spp}-frame scan, median of {reps} reps",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
