"""Command-line application: the reference's app shell without the GUI.

Option parity with ``nrc/src/Options.cpp:45-157``:
  -w/--width, -h/--height  override render resolution
  -m/--mode 0|1            0 = progressive render loop, 1 = benchmark
  -s/--system              system description file
  -d/--scene               scene description file
  -o/--optimize            accepted (graph optimization is automatic here)

plus extensions: --spp, --render-mode, --encoding, --devices (multi-GPU),
--checkpoint/--resume, --stats-log.

Usage:
  python -m nrc_tpu.app.cli -s data/system.txt -d data/scene.txt -m 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..config import InputEncoding, NetworkConfig, RenderMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nrc_tpu", add_help=False,
        description="neural radiance caching renderer",
    )
    p.add_argument("--help", action="help")
    p.add_argument("-w", "--width", type=int, default=None)
    p.add_argument("-h", "--height", type=int, default=None)
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1))
    p.add_argument("-s", "--system", required=True)
    p.add_argument("-d", "--scene", required=True)
    p.add_argument("-o", "--optimize", action="store_true")
    p.add_argument("--spp", type=int, default=None,
                   help="total samples (default samplesSqrt^2 from system file)")
    p.add_argument("--render-mode", default="full",
                   choices=[m.name.lower() for m in RenderMode])
    p.add_argument("--encoding", default="frequency", choices=("frequency", "hash"))
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--lr", type=float, default=None,
                   help="Adam learning rate (default per encoding: 1e-3 "
                        "frequency / 1e-2 hash)")
    p.add_argument("--unbiased-ratio", type=float, default=None,
                   help="fraction of training rays traced unbiased "
                        "(default 1/16)")
    p.add_argument("--reflectance-factoring", action="store_true",
                   help="train the cache on radiance/reflectance and scale "
                        "predictions by the query albedo (the paper's "
                        "reflectance factorization; USE_REFLECTANCE_FACTORING)")
    p.add_argument("--area-spread", type=float, default=None,
                   help="area-spread truncation constant c (default 0.01)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the frame over N devices (shard_map data mesh)")
    p.add_argument("--checkpoint", default=None,
                   help="save the full render state here when done")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=("npz", "orbax"),
                   help="checkpoint container: portable single-file npz or "
                        "an orbax PyTree directory")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N frames (atomic; crash/"
                        "preemption recovery)")
    p.add_argument("--resume", default=None,
                   help="restore a checkpoint first (full render state, or "
                        "a network-weights-only file)")
    p.add_argument("--output", default=None, help="screenshot path prefix")
    p.add_argument("--hdr", action="store_true", help="also write linear .hdr")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render loop")
    p.add_argument("--save-system", default=None, metavar="PATH",
                   help="write the current system description (Key S parity)")
    p.add_argument("--stats-log", default=None,
                   help="write per-frame JSONL stats (loss, records, tile "
                        "size, seconds since the loop started)")
    p.add_argument("--present", action="store_true",
                   help="interactive mode: serve a live HTTP viewer with "
                        "orbit/pan/dolly/zoom (also enabled by 'present 1' "
                        "in the system file)")
    p.add_argument("--port", type=int, default=8000,
                   help="viewer port for --present (0 = ephemeral)")
    return p


def _print_material_report(scene) -> None:
    """Per-material load summary; LOUD about every fallback-to-diffuse.

    The reference relays MDL compile errors through its message callback
    (``Raytracer.cpp:1655-1669``) instead of silently substituting — this
    is the equivalent for the mini-MDL subset: each unresolved or
    unparseable declaration prints with its reason, plus a count."""
    report = getattr(scene, "material_report", None) or []
    warnings = [e for e in report if e["status"] != "ok"]
    n_ok = len(report) - len(warnings)
    print(
        f"materials: {n_ok}/{len(report)} resolved"
        + (f", {len(warnings)} degraded to gray diffuse" if warnings else "")
    )
    shown = 0
    for e in warnings:
        if shown >= 20:
            print(f"  ... and {len(warnings) - shown} more (see /params "
                  "material_report in the viewer for the full list)")
            break
        print(f"  WARNING material '{e['reference']}' ({e['path']}): "
              f"{e['status']} -> {e.get('fallback', 'fallback')}")
        shown += 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..render.renderer import Renderer
    from ..scene.scene_builder import load_scene

    scene, system = load_scene(args.system, args.scene)
    _print_material_report(scene)
    if args.width:
        system.resolution = (args.width, system.resolution[1])
    if args.height:
        system.resolution = (system.resolution[0], args.height)
    scene.camera.aspect = system.resolution[0] / max(system.resolution[1], 1)

    render_mode = RenderMode[args.render_mode.upper()]
    net_cfg = NetworkConfig(
        encoding=InputEncoding.HASH if args.encoding == "hash" else InputEncoding.FREQUENCY
    )
    r = Renderer(
        scene, system, net_cfg=net_cfg, render_mode=render_mode,
        train=not args.no_train,
        reflectance_factoring=args.reflectance_factoring,
    )
    if args.lr or args.unbiased_ratio or args.area_spread:
        r.set_hyper_params(
            learning_rate=args.lr,
            train_unbiased_ratio=args.unbiased_ratio,
            area_spread_factor=args.area_spread,
        )
    driver = r
    if args.devices > 1:
        from ..parallel.shard import ParallelRenderer, make_mesh

        driver = ParallelRenderer(r, make_mesh(args.devices))

    if args.resume:
        from ..models.checkpoint import (
            is_render_state,
            load_checkpoint,
            load_render_state,
        )

        if is_render_state(args.resume):
            load_render_state(args.resume, r)
            print(
                f"resumed render state from {args.resume} "
                f"(iteration {r.iteration})"
            )
        else:
            r.net_state = load_checkpoint(args.resume, r.net_cfg)
            print(f"resumed network from {args.resume}")

    spp = args.spp if args.spp is not None else system.samples_sqrt ** 2
    stats_f = open(args.stats_log, "w") if args.stats_log else None

    import contextlib

    import jax

    profile_ctx = (
        jax.profiler.trace(args.profile) if args.profile
        else contextlib.nullcontext()
    )

    traced_scalars = []
    t0 = time.perf_counter()
    with profile_ctx:
        if args.mode == 0 and (args.present or system.present):
            _present_loop(args, driver, r, spp, t0)
        else:
            traced_scalars = _render_loop(args, driver, r, spp, stats_f, t0)
    jax.block_until_ready(r.image)
    dt = time.perf_counter() - t0
    # throughput report (the reference prints only fps,
    # Application.cpp:522-527; Mrays/s + cache queries/s added on top).
    # Primary Mrays/s counts rays actually cast (on-device counter, read
    # after the barrier); "potential" assumes every path traces every
    # closest-hit + shadow segment, which the area-spread truncation makes
    # a severalfold overstatement.
    segs = r.cfg.max_depth + 1
    n_tiles = r.cfg.num_tiles if r.cfg.train else 0
    potential = (r.cfg.num_pixels + n_tiles) * segs * 2 * spp
    traced = sum(int(t) for t in traced_scalars)
    from ..config import RenderMode as _RM

    uses_cache = r.cfg.render_mode != _RM.NO_CACHE
    n_queries = ((r.cfg.num_pixels if uses_cache else 0) + n_tiles) * spp
    print(
        f"{spp} spp in {dt:.2f}s -> {spp / dt:.2f} fps, "
        f"{traced / dt / 1e6:.2f} Mrays/s traced "
        f"({potential / dt / 1e6:.2f} potential), "
        f"{n_queries / dt / 1e6:.2f} M cache queries/s"
    )
    driver.flush_stats() if hasattr(driver, "flush_stats") else None
    if r.loss_history:
        h = list(r.loss_history)
        print(
            f"loss: last {h[-1]:.4f}, min {min(h):.4f}, "
            f"mean(last 16) {sum(h[-16:]) / len(h[-16:]):.4f}"
        )
    if stats_f is not None:
        stats_f.close()

    prefix = args.output or system.prefix_screenshot
    path = r.screenshot(prefix + f"_{spp}spp", tonemap=True)
    print(path)
    if args.hdr:
        print(r.screenshot(prefix + f"_{spp}spp", tonemap=False))

    if args.save_system:
        print(r.save_system_description(args.save_system))

    if args.checkpoint:
        from ..models.checkpoint import save_render_state

        save_render_state(args.checkpoint, r, format=args.checkpoint_format)
        print(f"saved render state to {args.checkpoint}")
    return 0


def _present_loop(args, driver, r, spp, t0):
    """Interactive presentation (reference interactive mode,
    ``Application::render`` + ``guiEventHandler``): renders continuously,
    publishes a tonemapped frame ~1 Hz to the HTTP viewer, applies queued
    camera verbs between frames (restarting accumulation), and keeps
    serving after ``spp`` is reached until interrupted."""
    import io

    import numpy as np
    from PIL import Image

    from ..utils.tonemap import tonemap_to_u8
    from .viewer import Viewer

    viewer = Viewer(port=args.port)
    viewer.params_provider = lambda: _gui_params(r)
    print(f"presenting at {viewer.url} (ctrl-c to stop)")
    last_pub = 0.0
    i = 0
    try:
        while True:
            if viewer.apply_events(r.scene.camera):
                r.restart_accumulation()
            for s in viewer.drain_settings():
                _apply_setting(r, s)
            for act in viewer.drain_actions():
                prefix = args.output or r.system.prefix_screenshot or "frame"
                tag = f"{prefix}_{int(r.iteration)}spp"
                if act == "screenshot_png":
                    print(r.screenshot(tag, tonemap=True), flush=True)
                elif act == "screenshot_hdr":
                    print(r.screenshot(tag, tonemap=False), flush=True)
                elif act == "save_system":
                    out = args.save_system or (prefix + "_system.txt")
                    print(r.save_system_description(out), flush=True)
                elif act == "reset_cache":
                    r.reset_cache()
                    r.restart_accumulation()
            if r.iteration < spp:
                stats = driver.render_frame()
                i += 1
            else:
                time.sleep(0.05)
            now = time.perf_counter()
            if now - last_pub >= 1.0:  # ~1 Hz presentation (App.cpp:457-491)
                import jax.numpy as jnp

                ldr = np.asarray(
                    tonemap_to_u8(jnp.asarray(r.image_hdr()),
                                  r.system.tonemapper)
                )
                buf = io.BytesIO()
                Image.fromarray(ldr).save(buf, format="PNG")
                loss = (
                    r.loss_history[-1] if r.loss_history else 0.0
                )
                viewer.publish(
                    buf.getvalue(), r.iteration, i / max(now - t0, 1e-9),
                    loss, loss_history=list(r.loss_history),
                )
                last_pub = now
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()


def _gui_params(r):
    """Current GUI-editable state for the viewer control panel — the
    reference's System window (render-mode radio, encoding combo,
    tonemapper), Stats window (lr / unbiased-ratio / area-spread sliders),
    and per-material Param_info editors (``Application.cpp:650-1068``,
    ``inc/MaterialMDL.h:62-295``)."""
    from ..config import RenderMode

    tm = r.system.tonemapper
    return {
        "render_mode": r.cfg.render_mode.name,
        "render_modes": [m.name for m in RenderMode],
        "encoding": r.net_cfg.encoding.name.lower(),
        "learning_rate": float(r.hyper.learning_rate),
        "train_unbiased_ratio": float(r.hyper.train_unbiased_ratio),
        "area_spread_factor": float(r.hyper.area_spread_factor),
        "tonemapper": {
            "gamma": tm.gamma, "white": tm.white_point,
            "burn": tm.burn_highlights, "crush": tm.crush_blacks,
            "sat": tm.saturation, "bright": tm.brightness,
        },
        "materials": [
            {
                "index": i,
                "name": m.name,
                "albedo": list(m.albedo),
                "roughness": list(m.roughness),
                "ior": float(m.ior),
                "thin_walled": bool(m.thin_walled),
                "emission_intensity": list(m.emission_intensity),
            }
            for i, m in enumerate(r.scene.material_rows)
        ],
        # per-material load report incl. fallback-to-diffuse reasons
        # (mdl.load_material; the MDL-message-relay equivalent)
        "material_report": getattr(r.scene, "material_report", None) or [],
    }


def _apply_setting(r, s):
    """Apply one queued control-panel edit to the renderer.

    HTTP-supplied values are untrusted: a malformed ``/set`` request must
    not raise inside the present loop and kill the render session, so every
    conversion is guarded — bad edits are logged and dropped."""
    try:
        _apply_setting_unchecked(r, s)
    except (KeyError, ValueError, IndexError, TypeError) as e:
        print(f"ignoring bad setting {s!r}: {type(e).__name__}: {e}",
              flush=True)


def _apply_setting_unchecked(r, s):
    import dataclasses as _dc

    from ..config import RenderMode

    key, raw = s["key"], s["value"]

    def vec(txt, n):
        parts = [float(x) for x in txt.split(",")]
        return tuple((parts + parts[-1:] * n)[:n])

    if s.get("material") is not None:
        idx = int(s["material"])
        if not 0 <= idx < len(r.scene.material_rows):
            raise IndexError(f"material index {idx} out of range")
        if key in ("albedo", "emission_intensity"):
            r.update_material(idx, **{key: vec(raw, 3)})
        elif key == "roughness":
            r.update_material(idx, roughness=vec(raw, 2))
        elif key == "ior":
            r.update_material(idx, ior=float(raw))
        elif key == "thin_walled":
            r.update_material(idx, thin_walled=bool(int(raw)))
        return
    if key == "render_mode":
        r.set_render_mode(RenderMode[raw])
    elif key == "encoding":
        r.set_encoding(raw)
    elif key == "learning_rate":
        r.set_hyper_params(learning_rate=float(raw))
    elif key == "train_unbiased_ratio":
        r.set_hyper_params(train_unbiased_ratio=float(raw))
    elif key == "area_spread_factor":
        r.set_hyper_params(area_spread_factor=float(raw))
        r.restart_accumulation()
    elif key.startswith("tm_"):
        field = {
            "tm_gamma": "gamma", "tm_white": "white_point",
            "tm_burn": "burn_highlights", "tm_crush": "crush_blacks",
            "tm_sat": "saturation", "tm_bright": "brightness",
        }[key]
        r.system.tonemapper = _dc.replace(
            r.system.tonemapper, **{field: float(raw)}
        )


def _render_loop(args, driver, r, spp, stats_f, t0):
    # device scalars collected without readback; summed after the end-of-run
    # barrier so the async frame pipeline never blocks on a stats round trip
    traced_scalars = []
    for i in range(spp):
        stats = driver.render_frame()
        traced_scalars.append(stats.traced_rays)
        if (
            args.checkpoint
            and args.checkpoint_every
            and (i + 1) % args.checkpoint_every == 0
        ):
            from ..models.checkpoint import save_render_state

            save_render_state(args.checkpoint, r, format=args.checkpoint_format)
        if stats_f is not None:
            stats_f.write(
                json.dumps(
                    {
                        "frame": i,
                        "loss": float(stats.loss),
                        "num_train_records": int(stats.num_train_records),
                        "traced_rays": int(stats.traced_rays),
                        "tile_size": list(r.cfg.tile_size),
                        # the loss read above waits for this frame, so
                        # this is the frame's completion time
                        "seconds": time.perf_counter() - t0,
                    }
                )
                + "\n"
            )
        if args.mode == 0 and (i + 1) % 16 == 0:
            el = time.perf_counter() - t0
            print(f"[{i + 1}/{spp}] {(i + 1) / el:.2f} fps, loss {float(stats.loss):.4f}")
    return traced_scalars


if __name__ == "__main__":
    sys.exit(main())
