#!/usr/bin/env python3
"""Benchmark harness for the five BASELINE.json configs.

Prints one JSON line per config (and runs them all by default):
  1. single 640x480 ARUCO frame, one marker — detect+pose latency
  2. batched 64x VGA frames, 1-4 markers each, randomized pose/noise
  3. 1080p stream, ARUCO_MIP_36H12, 8 markers/frame (== bench.py headline)
  4. 4K frames, APRILTAG_36H11, dense ChArUco-style grid (64+ quads)
  5. 4x concurrent 1080p@60fps streams, mixed dictionaries, via the
     native StreamPipeline (device-side prefetch + pose)

The divan harness in the reference (benches/detect_markers.rs) measures
single-frame latency on random noise; config 2/3 include the same
random-noise variant via --noise.

Usage: python benches/bench_configs.py [1 2 3 4 5]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import json
import time

import numpy as np


def _setup(dict_name, h, w, max_candidates=32):
    import jax

    from aruco3_tpu import ARDictionary, Detector, DetectorConfig

    cfg = DetectorConfig(max_candidates=max_candidates)
    dictionary = ARDictionary.new_from_named_dict(dict_name)
    det = Detector(cfg, dictionary)
    return jax.jit(det.markers_pipeline(h, w, with_pose=True)), dictionary


def _time(step, frames, iters=10):
    """Mean seconds per step over ``iters`` back-to-back steps after one
    warm-up, waiting for the last step's full outputs; returns
    (seconds, warm-up outputs)."""
    import jax

    out = jax.block_until_ready(step(frames))
    t0 = time.perf_counter()
    for _ in range(iters):
        last = step(frames)
    jax.block_until_ready(last)
    return (time.perf_counter() - t0) / iters, out


def _emit(name, fps, extra=None):
    from bench import device_info

    rec = {
        "metric": name,
        "value": round(fps, 2),
        "unit": "frames/s",
        "device": device_info(),
    }
    rec.update(extra or {})
    print(json.dumps(rec))


def config1():
    import jax.numpy as jnp

    from aruco3_tpu.render import random_marker_scene

    import jax

    step, d = _setup("ARUCO_DEFAULT", 480, 640)
    rng = np.random.default_rng(0)
    img, _, _ = random_marker_scene(d, 5, (640, 480), rng=rng)
    frames = jnp.asarray(img[None])
    dt, out = _time(step, frames, iters=20)
    # True single-frame latency: synchronize every step.
    lat_t0 = time.perf_counter()
    for _ in range(10):
        jax.block_until_ready(step(frames))
    latency = (time.perf_counter() - lat_t0) / 10
    found = int(np.asarray(out["marker_valid"]).sum())
    _emit(
        "vga_single_frame_detect_pose",
        1.0 / dt,
        {"latency_ms": round(latency * 1000, 3), "markers_found": found},
    )


def config2(noise=False):
    import jax.numpy as jnp

    from aruco3_tpu.render import random_marker_scene, render_marker

    step, d = _setup("ARUCO_DEFAULT", 480, 640)
    rng = np.random.default_rng(1)
    frames = []
    n_true = 0
    for _ in range(64):
        if noise:
            frames.append(
                rng.integers(0, 256, size=(480, 640), dtype=np.uint8)
            )
            continue
        img = np.full((480, 640), 255, dtype=np.uint8)
        k = int(rng.integers(1, 5))
        for j in range(k):
            mid = int(rng.integers(0, len(d)))
            sub, _, _ = random_marker_scene(
                d, mid, (320, 240), rng=rng, min_scale=0.4, max_scale=0.7
            )
            y0 = (j // 2) * 240
            x0 = (j % 2) * 320
            img[y0 : y0 + 240, x0 : x0 + 320] = np.minimum(
                img[y0 : y0 + 240, x0 : x0 + 320], sub
            )
            n_true += 1
        frames.append(img)
    frames = jnp.asarray(np.stack(frames))
    dt, out = _time(step, frames)
    found = int(np.asarray(out["marker_valid"]).sum())
    name = "vga_batch64_noise" if noise else "vga_batch64_detect_pose"
    _emit(
        name,
        64.0 / dt,
        {"markers_found": found, "markers_true": n_true},
    )


def grid_frame(d, h, w, cell, rng, n_cols=10, n_rows=7):
    """ChArUco-style dense grid of markers (each rendered on its own tile)."""
    from aruco3_tpu.render import render_marker

    img = np.full((h, w), 255, dtype=np.uint8)
    count = 0
    side = int(cell * 0.8)
    quad = np.array(
        [[2.0, 2.0], [2.0 + side, 2.0], [2.0 + side, 2.0 + side], [2.0, 2.0 + side]]
    )
    tile = side + 4
    for r in range(n_rows):
        for c in range(n_cols):
            mid = (r * n_cols + c) % len(d)
            x0 = 40 + c * cell
            y0 = 40 + r * cell
            if x0 + tile >= w or y0 + tile >= h:
                continue
            sub = render_marker(d, mid, (tile, tile), quad, noise_sigma=0.0)
            img[y0 : y0 + tile, x0 : x0 + tile] = np.minimum(
                img[y0 : y0 + tile, x0 : x0 + tile], sub
            )
            count += 1
    img = np.clip(
        img.astype(np.float64) + rng.normal(0, 2.0, img.shape), 0, 255
    ).astype(np.uint8)
    return img, count


def config3():
    """The headline program (bench.py) at its default batch."""
    import bench

    bench.main([])


def config4():
    import jax
    import jax.numpy as jnp

    from aruco3_tpu import ARDictionary, Detector, DetectorConfig

    h, w = 2160, 3840
    d = ARDictionary.new_from_named_dict("APRILTAG_36H11")
    # Dense grids need more candidate lanes and smaller min-edge and
    # corner-separation factors (the defaults are for large single
    # markers).
    cfg = DetectorConfig(
        max_candidates=96,
        min_side_length_factor=0.02,
        min_corner_separation_factor=0.002,
    )
    step = jax.jit(Detector(cfg, d).markers_pipeline(h, w))
    rng = np.random.default_rng(2)
    img, n_true = grid_frame(d, h, w, cell=330, rng=rng)
    batch = 32
    frames = jnp.asarray(np.stack([img] * batch))
    dt, out = _time(step, frames, iters=10)
    found = int(np.asarray(out["marker_valid"])[0].sum())
    _emit(
        "uhd4k_dense_grid_detect",
        float(batch) / dt,
        {"markers_true": n_true, "markers_found_frame0": found},
    )


def config5():
    import jax

    from aruco3_tpu import ARDictionary, Detector, DetectorConfig
    from aruco3_tpu.render import random_marker_scene
    from aruco3_tpu.runtime.stream import StreamPipeline

    h, w = 1080, 1920
    # Mixed dictionaries: one pipeline per dictionary (2 streams each).
    dicts = ["ARUCO_MIP_36H12", "APRILTAG_36H11"]
    pipes = []
    for seed, name in enumerate(dicts):
        d = ARDictionary.new_from_named_dict(name)
        det = Detector(DetectorConfig(), d)
        pipe = StreamPipeline(det, (h, w), n_streams=2, batch=8)
        rng = np.random.default_rng(seed)
        frame, _, _ = random_marker_scene(
            d,
            3,
            (w, h),
            rng=rng,
            min_scale=0.3,
            max_scale=0.5,
        )
        pipe._bench_frame = frame
        # Warm up (compile) the batch program before the timed window.
        jax.block_until_ready(
            det.detect_batch(np.stack([frame] * pipe.batch))
        )
        pipes.append(pipe)

    seconds = 8.0
    for pipe in pipes:
        pipe.start()
    t_end = time.time() + seconds
    pushed = 0
    while time.time() < t_end:
        for pipe in pipes:
            for s in range(2):
                pipe.push(s, pipe._bench_frame)
                pushed += 1
        time.sleep(1 / 60)  # 60 fps per camera x 4 streams
    done = 0
    for pipe in pipes:
        pipe.stop()
        done += pipe.stats.frames
    fps = done / seconds
    _emit(
        "four_stream_1080p_mixed_dicts",
        fps,
        {
            "streams": 4,
            "pushed": pushed,
            "processed": done,
            "realtime_x": round(fps / 240.0, 2),
        },
    )
    config5_device()


def config5_device():
    """Sustained 4x1080p-stream detect+pose with DEVICE-RESIDENT frames.

    The counterpart of config5 without the host upload: each tick
    synthesizes the four streams' frames ON DEVICE inside the jitted
    program (per-tick lane shift +
    brightness jitter of an uploaded base scene — a fresh program input
    every tick, no host transfer in the loop) and runs the full
    detect+pose per dictionary batch (2 streams each, mixed dicts).
    Counterpart of the reference's webcam loop throughput
    (reference examples/webcam_kamera.rs:28-77) with the camera upload
    out of the way.
    """
    import jax
    import jax.numpy as jnp

    from aruco3_tpu.render import random_marker_scene

    h, w = 1080, 1920
    ticks = []
    for seed, name in enumerate(("ARUCO_MIP_36H12", "APRILTAG_36H11")):
        step, d = _setup(name, h, w)
        rng = np.random.default_rng(seed)
        frame, _, _ = random_marker_scene(
            d, 3, (w, h), rng=rng, min_scale=0.3, max_scale=0.5
        )
        base = jnp.asarray(np.stack([np.asarray(frame)] * 2))

        def synth(i, base=base):
            # Per-tick perturbation: 0-31 px lane roll + 0-4 grey-level
            # brightness shift — enough that every tick is a distinct
            # input (no constant-folding), cheap enough to not distort
            # the detect+pose measurement.
            f = jnp.roll(base, (i * 7) % 32, axis=2)
            return jnp.clip(
                f.astype(jnp.int32) + (i * 3) % 5, 0, 255
            ).astype(jnp.uint8)

        def make(step=step, synth=synth):
            @jax.jit
            def tick(i):
                return step(synth(i))

            return tick

        ticks.append(make())

    # Sanity (untimed): markers must be detected in the synthesized
    # frames of both dictionaries at two distinct ticks.
    found = 0
    for tick in ticks:
        for i in (0, 11):
            out = tick(jnp.asarray(i, jnp.int32))
            found += int(np.asarray(out["marker_valid"]).sum())

    iters = 60
    t0 = time.perf_counter()
    outs = []
    for k in range(iters):
        ik = jnp.asarray(k, jnp.int32)
        outs = [tick(ik) for tick in ticks]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    fps = 4 * iters / dt
    _emit(
        "four_stream_1080p_device_synth",
        fps,
        {
            "streams": 4,
            "per_stream_fps": round(iters / dt, 2),
            "markers_found_sanity": found,
            "realtime_x": round(fps / 240.0, 2),
            "note": "frames synthesized on device each tick; no host "
            "upload in the timed loop",
        },
    )


def main() -> None:
    from aruco3_tpu.runtime.cache import enable_compilation_cache
    from bench import device_info

    if device_info()["platform"] == "cpu":
        sys.exit("bench_configs: no accelerator found")
    enable_compilation_cache()
    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5]
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for i in which:
        fns[i]()


if __name__ == "__main__":
    main()
