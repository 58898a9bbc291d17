"""Command-line driver.

The reference has no CLI despite declaring clap (SURVEY §5): the scene
is a source edit at main.rs:20, frames go to ./output/image_NNNN.png.
This driver covers that surface and the gaps: named scenes or scene
JSON, setting overrides, animation + GIF assembly, checkpoint/resume,
device-mesh sharding, metrics and profiling.

    python -m rust_pathtracer_tpu.cli --scene CornellBox \
        --width 256 --height 256 --spp 128 --output-dir ./output
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_pathtracer_tpu",
        description="Differentiable wavefront path tracer (JAX)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="named scene (see --list-scenes)")
    src.add_argument("--scene-json", help="scene JSON file")
    src.add_argument("--list-scenes", action="store_true")
    p.add_argument("--obj-path", default="./model.obj", help="OBJ for ModelTest")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int, help="samples per pixel override")
    p.add_argument("--max-bounces", type=int)
    p.add_argument("--spp-chunk", type=int, help="samples per device pass")
    p.add_argument("--frames", type=int, help="animation frame count override")
    p.add_argument("--frame-start", type=int, default=0, help="resume animation here")
    p.add_argument("--seed", type=int, default=0, help="RNG key seed")
    p.add_argument("--bvh", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--leaf-size", type=int, default=4)
    p.add_argument(
        "--russian-roulette", type=int, default=None, metavar="START_BOUNCE",
        help="enable RR from this bounce (off by default: reference semantics)",
    )
    p.add_argument("--gif", action="store_true", help="assemble animation GIF")
    p.add_argument("--checkpoint", help="accumulation checkpoint file (exact resume)")
    p.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="CHUNKS",
        help="persist every N sample chunks (each save costs a "
             "device sync + a disk write; animations want ~32)",
    )
    p.add_argument(
        "--mesh", default=None, metavar="TILESxSAMPLES",
        help="shard over a device mesh, e.g. 4x2 (default: single device)",
    )
    p.add_argument("--profile-dir", help="write a jax.profiler trace here")
    p.add_argument(
        "--timing-log", metavar="PATH",
        help="append one JSON line per frame: {frame, seconds, segments}"
        " (the animation artifact's p50/p95 source)",
    )
    p.add_argument(
        "--cascade", default=None, metavar="SCHEDULE", nargs="?",
        const="dynamic",
        help="compact the wavefront once occupancy collapses "
             "(estimator-exact).  Bare --cascade uses the dynamic "
             "host-synced boundaries; pass a static schedule like "
             "5:8,9:64 (boundary:shrink,...; shrink may be a rational "
             "like 16/11 to hug a fractional occupancy) for the one-jit "
             "no-sync "
             "cascade (best for shallow-depth big scenes, e.g. "
             "SphereField; see docs/DESIGN.md §11)",
    )
    p.add_argument(
        "--regen", action="store_true",
        help="regeneration wavefront: terminated lanes refill from the "
             "sample queue (best for deep-bounce scenes, e.g. LightTest)",
    )
    p.add_argument(
        "--lanes", type=int, default=None,
        help="lane-pool size for --regen (default min(total, 2^20))",
    )
    p.add_argument(
        "--rebuild-bvh", action="store_true",
        help="rebuild the acceleration structure every animation frame "
             "(BASELINE SphereField config; the reference builds once)",
    )
    p.add_argument(
        "--debug-nans", action="store_true",
        help="enable jax NaN checking (the framework's race/sanitizer slot)",
    )
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from rust_pathtracer_tpu.models import SCENES, get_scene

    if args.list_scenes:
        for name in sorted(SCENES):
            print(name)
        return 0

    import dataclasses

    from rust_pathtracer_tpu.utils import compcache

    compcache.enable()

    import jax

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    from rust_pathtracer_tpu.render import (
        CascadeOverflowError,
        derive_cascade_schedule,
        render_radiance,
    )
    from rust_pathtracer_tpu.utils.image import frame_path, to_rgb8, write_gif, write_png
    from rust_pathtracer_tpu.utils.metrics import (
        ProgressBar,
        RenderMetrics,
        StageTimer,
        profiler_trace,
    )

    timer = StageTimer()
    if args.scene_json:
        from rust_pathtracer_tpu.scene.json_io import load_scene_json

        sd = load_scene_json(args.scene_json)
    else:
        kwargs = {"obj_path": args.obj_path} if args.scene == "ModelTest" else {}
        sd = get_scene(args.scene, **kwargs)

    settings = sd.output.image
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_bounces:
        overrides["max_bounces"] = args.max_bounces
    if args.spp_chunk:
        overrides["spp_chunk"] = args.spp_chunk
    if args.russian_roulette is not None:
        overrides["russian_roulette_start"] = args.russian_roulette
    if args.regen and args.mesh:
        # render_one's branch order would silently pick the sharded
        # path and ignore --regen; fail loudly instead
        build_parser().error("--mesh and --regen are mutually exclusive "
                             "renderer modes (the regeneration wavefront "
                             "is single-chip)")
    if args.cascade is not None:
        if args.regen:
            p = build_parser()
            p.error("--cascade and --regen are mutually exclusive "
                    "renderer modes")
        overrides["cascade"] = True
        if args.cascade not in ("dynamic", "auto"):
            from rust_pathtracer_tpu.render import parse_cascade_schedule

            try:
                parse_cascade_schedule(args.cascade)
            except ValueError as e:
                build_parser().error(str(e))
            overrides["cascade_schedule"] = args.cascade
        elif args.cascade == "auto":
            overrides["cascade_schedule"] = "auto"
    if overrides:
        settings = dataclasses.replace(settings, **overrides)

    use_bvh = {"auto": "auto", "on": True, "off": False}[args.bvh]
    with timer.stage("scene build"):
        if args.scene_json:
            scene = sd.build(use_bvh=use_bvh)
        else:
            scene = sd.build()

    frames = args.frames if args.frames else sd.output.num_frames
    key = jax.random.PRNGKey(args.seed)

    # animation + "auto": derive the cascade schedule ONCE (probe at
    # the first frame's camera) and pin it — a per-frame re-derivation
    # that wobbles one width would recompile the cascade graph.  The
    # renderer still guards every frame; CascadeOverflowError below
    # re-derives at a doubled margin.  Mesh renders keep per-frame calibration
    # (worst-shard occupancy needs the sharded chunk-0 run).
    sticky_auto = (
        settings.cascade_schedule == "auto"
        and frames - args.frame_start > 1
        and args.mesh is None
    )
    auto_margin = None
    if sticky_auto:
        from rust_pathtracer_tpu import render as render_mod
        from rust_pathtracer_tpu.render import derive_cascade_schedule_multi

        # Multi-pose probe: sample the camera across the WHOLE
        # animation range and derive from the max-occupancy envelope
        # (render.derive_cascade_schedule_multi) — a frame-0-only
        # derivation can go stale mid-orbit.  The envelope
        # already covers the orbit, so only a small slack (1.15x) is
        # kept for poses between probes; all probes share one
        # compiled graph.
        auto_margin = render_mod.AUTO_MARGIN * 1.15
        n_probe = min(8, frames - args.frame_start)
        span = frames - args.frame_start
        probe_frames = sorted({
            args.frame_start + (i * (span - 1)) // max(1, n_probe - 1)
            for i in range(n_probe)
        })
        with timer.stage("schedule probe"):
            sched = derive_cascade_schedule_multi(
                scene, [sd.camera_at(f / frames) for f in probe_frames],
                settings, key, margin=auto_margin,
            )
        settings = dataclasses.replace(
            settings, cascade_schedule=sched, cascade=sched is not None
        )
        if not args.quiet:
            print(f"auto cascade schedule: {sched}", file=sys.stderr)

    mesh = None
    if args.mesh:
        from rust_pathtracer_tpu.parallel import make_mesh

        tiles, samples = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(tiles=tiles, samples=samples)

    metrics = RenderMetrics(
        width=settings.width, height=settings.height,
        spp=settings.samples_per_pixel,
    )
    bar = None if args.quiet else ProgressBar(frames, prefix="frames")
    rendered = []

    with profiler_trace(args.profile_dir):
        for frame in range(args.frame_start, frames):
            t = frame / frames  # main.rs:52: t = frame / total (not total-1)
            cam = sd.camera_at(t)
            if args.rebuild_bvh and frame > args.frame_start:
                with timer.stage("bvh rebuild"):
                    scene = (
                        sd.build(use_bvh=use_bvh) if args.scene_json else sd.build()
                    )
            # per-frame checkpoint file for animations: a crash resumes
            # at the interrupted frame's completed chunks (the reference
            # restarts the whole frame; partial frames lose everything,
            # main.rs panics on any error)
            ckpt_path = args.checkpoint
            if ckpt_path and frames > 1:
                ckpt_path = f"{ckpt_path}.frame{frame:04d}"
            def render_one(settings):
                if mesh is not None and ckpt_path:
                    from rust_pathtracer_tpu.utils.checkpoint import (
                        render_radiance_sharded_checkpointed,
                    )

                    return render_radiance_sharded_checkpointed(
                        scene, cam, settings, key, mesh, ckpt_path,
                        checkpoint_every=args.checkpoint_every,
                    )
                elif mesh is not None:
                    from rust_pathtracer_tpu.parallel import render_radiance_sharded

                    return render_radiance_sharded(
                        scene, cam, settings, key, mesh
                    )
                elif args.regen:
                    from rust_pathtracer_tpu.wavefront import render_radiance_regen

                    return render_radiance_regen(
                        scene, cam, settings, key, lanes=args.lanes
                    )
                elif ckpt_path:
                    from rust_pathtracer_tpu.utils.checkpoint import (
                        render_radiance_checkpointed,
                    )

                    return render_radiance_checkpointed(
                        scene, cam, settings, key, ckpt_path,
                        checkpoint_every=args.checkpoint_every,
                    )
                return render_radiance(scene, cam, settings, key)

            t0 = time.perf_counter()
            with timer.stage("render"):
                while True:
                    try:
                        img, stats = render_one(settings)
                        break
                    except CascadeOverflowError as e:
                        # a pinned auto schedule went stale (the
                        # camera moved): re-derive at a doubled margin
                        # and retry the frame; explicit schedules fail
                        # loudly (never a silently darkened image)
                        if not sticky_auto:
                            raise
                        auto_margin *= 2.0
                        print(
                            f"frame {frame}: {e}\nre-deriving at "
                            f"margin {auto_margin:g}",
                            file=sys.stderr,
                        )
                        sched = derive_cascade_schedule(
                            scene, cam, settings, key, margin=auto_margin
                        )
                        settings = dataclasses.replace(
                            settings, cascade_schedule=sched,
                            cascade=sched is not None,
                        )
                img.block_until_ready()
            frame_s = time.perf_counter() - t0
            metrics.wall_seconds += frame_s
            metrics.segments += float(stats.segments)
            metrics.add_occupancy(stats.occupancy)
            metrics.frames += 1
            if args.timing_log:
                import json

                os.makedirs(
                    os.path.dirname(os.path.abspath(args.timing_log)),
                    exist_ok=True,
                )
                with open(args.timing_log, "a") as f:
                    f.write(json.dumps({
                        "frame": frame,
                        "seconds": round(frame_s, 3),
                        "segments": float(stats.segments),
                    }) + "\n")

            rgb = to_rgb8(img)
            with timer.stage("io"):
                write_png(frame_path(args.output_dir, frame), rgb)
            if args.gif:
                rendered.append(rgb)
            if bar:
                bar.tick()

    if bar:
        bar.finish()
    if args.gif and rendered:
        gif_path = os.path.join(args.output_dir, "animation.gif")
        write_gif(gif_path, rendered, fps=sd.output.fps or 30.0)
        print(f"wrote {gif_path}", file=sys.stderr)

    if not args.quiet:
        metrics.report()
        timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
