#!/usr/bin/env python3
"""Benchmark: 1080p frames/s on one accelerator for detect + IPPE pose.

Mirrors BASELINE.json config 3 (1080p stream, ARUCO_MIP_36H12, 8 markers
per frame, full detect+pose).  Usage: ``python bench.py [batch]``
(default 128).  Refuses to run without an accelerator, checks every
frame's markers against the scene's ground-truth corners, then prints
exactly one JSON line:
  {"metric": ..., "value": frames/s, "unit": "frames/s", "batch": N,
   "ms_per_batch_median": ..., "device": {"platform", "kind", "count"}}
"""

import json
import sys
import time

import numpy as np

HEIGHT, WIDTH = 1080, 1920
DICTIONARY = "ARUCO_MIP_36H12"
N_MARKERS = 8
CORNER_TOL_PX = 2.0


def build_step(dictionary):
    """The headline program: batched 1080p detect + pose, jitted."""
    import jax

    from aruco3_tpu import Detector

    det = Detector(dictionary=dictionary)
    return jax.jit(det.markers_pipeline(HEIGHT, WIDTH, with_pose=True))


def bench_scene(dictionary, seed: int = 0):
    """One 1080p frame with ``N_MARKERS`` markers on a 2x4 grid of tiles,
    plus sigma-2 grey noise.  Returns (frame (H, W) u8, truth), truth a
    list of (marker id, (4, 2) float64 corners in frame pixels)."""
    from aruco3_tpu.render import random_marker_scene

    rng = np.random.default_rng(seed)
    frame = np.full((HEIGHT, WIDTH), 255, dtype=np.uint8)
    truth = []
    for i in range(N_MARKERS):
        mid = int(rng.integers(0, len(dictionary)))
        # The renderer may place corners outside (or at the edge of) its
        # tile; such markers are clipped at paste time and the unclipped
        # truth would not match the visible corner, so only fully
        # interior placements are accepted.
        for _try in range(20):
            img, cor, _ = random_marker_scene(
                dictionary,
                mid,
                (480, 360),
                rng=rng,
                min_scale=0.45,
                max_scale=0.7,
                noise_sigma=0.0,
            )
            c = np.asarray(cor, dtype=np.float64)
            if (
                (c[:, 0] > 8).all()
                and (c[:, 0] < 472).all()
                and (c[:, 1] > 8).all()
                and (c[:, 1] < 352).all()
            ):
                break
        else:
            raise RuntimeError(f"no interior placement for marker {i}")
        y0 = (i // 4) * 520 + 40
        x0 = (i % 4) * 470 + 10
        frame[y0 : y0 + 360, x0 : x0 + 480] = np.minimum(
            frame[y0 : y0 + 360, x0 : x0 + 480], img
        )
        truth.append((mid, c + [x0, y0]))
    frame = np.clip(
        frame.astype(np.float64) + rng.normal(0, 2.0, frame.shape), 0, 255
    ).astype(np.uint8)
    return frame, truth


def corner_errors(valid, ids, corners, truth):
    """Per ground-truth marker, the smallest cyclic max-corner error (px)
    over the detections of its id in one frame; None when none has it."""
    out = []
    for mid, tc in truth:
        errs = [
            min(
                np.abs(np.roll(corners[k], r, axis=0) - tc).max()
                for r in range(4)
            )
            for k in np.nonzero(valid)[0]
            if int(ids[k]) == mid
        ]
        out.append(float(min(errs)) if errs else None)
    return out


def gate_failures(out, truth, tol: float = CORNER_TOL_PX):
    """Frames of a batch output in which some ground-truth marker was not
    found within ``tol`` px: [(frame, marker id, error or None)]."""
    valid = np.asarray(out["marker_valid"])
    ids = np.asarray(out["marker_id"])
    corners = np.asarray(out["marker_corners"], dtype=np.float64)
    bad = []
    for b in range(valid.shape[0]):
        errs = corner_errors(valid[b], ids[b], corners[b], truth)
        bad += [
            (b, mid, e)
            for (mid, _), e in zip(truth, errs)
            if e is None or e > tol
        ]
    return bad


def time_steps(step, frames, iters: int = 20):
    """Per-step seconds of ``iters`` steps after one warm-up, each step
    waited for with ``block_until_ready`` on its full outputs."""
    import jax

    jax.block_until_ready(step(frames))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(frames))
        times.append(time.perf_counter() - t0)
    return times


def device_info():
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }


def main(argv=None) -> None:
    import jax
    import jax.numpy as jnp

    from aruco3_tpu import ARDictionary
    from aruco3_tpu.runtime.cache import enable_compilation_cache

    device = device_info()
    if device["platform"] == "cpu":
        print(json.dumps({"error": "no accelerator", "device": device}))
        sys.exit(1)
    enable_compilation_cache()

    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else 128
    dictionary = ARDictionary.new_from_named_dict(DICTIONARY)
    step = build_step(dictionary)
    frame, truth = bench_scene(dictionary)
    frames = jnp.asarray(np.broadcast_to(frame, (batch, HEIGHT, WIDTH)))

    out = jax.block_until_ready(step(frames))
    bad = gate_failures(out, truth)
    if bad:
        print(
            json.dumps(
                {
                    "error": "1080p bench-scene corner gate FAILED",
                    "failures": [list(f) for f in bad[:16]],
                    "n_failures": len(bad),
                }
            )
        )
        sys.exit(1)

    times = time_steps(step, frames)
    med = float(np.median(times))
    print(
        json.dumps(
            {
                "metric": "1080p_detect_pose_fps",
                "value": batch / med,
                "unit": "frames/s",
                "batch": batch,
                "ms_per_batch_median": med * 1000.0,
                "steps": len(times),
                "markers_found_frame0": int(
                    np.asarray(out["marker_valid"][0]).sum()
                ),
                "markers_placed": N_MARKERS,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
