#!/usr/bin/env python3
"""Bring-up check: the detector's main path on one GPU, end to end.

Usage (from the repository root):

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the multi-card paths only

One card, in order (any failure exits non-zero):
  a. device: a GPU must be present; prints the card's name and power limit
  b. compile: the headline program (1080p ARUCO_MIP_36H12 detect + IPPE
     pose, bench.py) at batch 128, with ``memory_analysis()``; halves the
     batch only when the program does not fit the card, and says so
  c. run + check: the 8-marker bench scene in every frame of the batch
     must yield every ground-truth marker within 2 px; 2 frames are
     compared with the same stages run on the host CPU backend, and the
     numpy reference pipeline (``aruco3_tpu.oracle``) must find no marker
     id the detector misses
  d. time: median ms per batch over 20 steps (each waited for with
     ``block_until_ready``), frames/s, and the top device ops of one
     profiler trace
  e. public surfaces: ``Detector.detect`` + ``pose`` on a 640x480 frame,
     and ``StreamPipeline`` with four 1080p streams pushed from host memory

With ``--cards 4``: frame-batch data parallelism (``detect_sharded``) on a
4-card mesh at 1080p, compared with the same program on a 1-card mesh, and
row-band ``detect_spatial`` on a 4K dense grid, compared with one-card
``Detector.detect``.

The last line of standard output is the JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.  The trace, the device-op table and the
compiled headline program's HLO go to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HEADLINE_BATCH = 128
TIMED_STEPS = 20
TRACED_STEPS = 3
# GPU-vs-CPU tolerances (see compare_backends).
CORNER_TOL_PX = 0.5
PATCH_TOL_GREY = 2.0
POSE_REL_TOL = 1e-3


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    )
    return res.stdout.strip().splitlines()[0]


class Report:
    """Prints each result beside the card it was measured on."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------- phase b
def compile_headline(say, step, batch: int, h: int, w: int, limit: int):
    """Compile ``step`` at ``batch`` frames, halving the batch while the
    program needs more device memory than ``limit`` bytes."""
    import jax

    while True:
        spec = jax.ShapeDtypeStruct((batch, h, w), np.uint8)
        t0 = time.perf_counter()
        compiled = step.lower(spec).compile()
        secs = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        need = (
            ma.argument_size_in_bytes
            + ma.output_size_in_bytes
            + ma.temp_size_in_bytes
            + ma.generated_code_size_in_bytes
        )
        say(
            f"compile: batch {batch}, {secs:.1f} s; memory_analysis: "
            f"arguments {ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"code {ma.generated_code_size_in_bytes} B, total {need} B "
            f"of {limit} B usable"
        )
        if need <= limit:
            return compiled, batch
        if batch == 1:
            fail("the program does not fit the card at batch 1")
        say(
            f"batch {batch} needs {need} B > {limit} B usable: "
            f"retrying at batch {batch // 2}"
        )
        batch //= 2


# --------------------------------------------------------------- phase c
def stage_probe(det, h: int, w: int):
    """Jittable (B, H, W) u8 -> the pipeline's intermediate and final
    arrays: frontend masks, coarse plane, label planes, candidate quads,
    patches, decoded markers and both IPPE poses of every lane."""
    import jax
    import jax.numpy as jnp

    from aruco3_tpu import frontend, pose, segment

    params, _, _, ds = det.static_args(h, w)
    run = det.pipeline(h, w)
    scale = jnp.array([float(w), float(h)], dtype=jnp.float32)

    def masks(img):
        grey = frontend.rgb_to_luma_u8(img)
        white = frontend.adaptive_threshold(grey, det.config.threshold_window)
        black = segment.open_mask(~white, params.open_radius)
        coarse = segment.pool_black(black, ds)
        labels, labels2 = segment.label_planes(coarse, params)
        return {
            "black": black,
            "coarse": coarse,
            "labels": labels,
            "labels2": labels2,
        }

    def probe(frames):
        out = jax.vmap(masks)(frames)
        full = run(frames)
        for k in (
            "quads",
            "quad_valid",
            "patches",
            "marker_valid",
            "marker_id",
            "marker_dist",
            "marker_code",
            "marker_corners",
        ):
            out[k] = full[k]
        _, tr, _ = pose.solve_normalized_batch(
            full["marker_corners"] / scale, 40.0
        )
        out["pose_translations"] = tr
        return out

    return probe


def compare_backends(say, got: dict, ref: dict, label: str) -> None:
    """Hold ``got`` (GPU) to ``ref`` (CPU backend) on the keys both have.

    Masks, coarse plane, label planes, lane validity, ids, match
    distances and decoded code words must be bit-equal; quads and marker
    corners within CORNER_TOL_PX; patches within PATCH_TOL_GREY grey
    levels (the matmul warp takes bf16 products by design); pose
    translations within POSE_REL_TOL relative.  Per-lane fields are
    compared on the lanes where the lane is valid on both sides."""
    got = {k: np.asarray(v) for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    keys = sorted(set(got) & set(ref))
    exact = ("black", "coarse", "labels", "labels2", "quad_valid", "marker_valid")
    quad = got.get("quad_valid", got["marker_valid"])
    mark = got["marker_valid"]
    worst = {}
    for k in sorted(keys, key=lambda k: (k not in exact, k)):
        a, b = got[k], ref[k]
        if k in exact:
            if not np.array_equal(a, b):
                fail(f"{label}: {k} differs in {int((a != b).sum())} elements")
            continue
        lanes = mark if k.startswith(("marker_", "pose_")) else quad
        a, b = a[lanes], b[lanes]
        if k in ("marker_id", "marker_dist", "marker_code"):
            if not np.array_equal(a, b):
                fail(f"{label}: {k} differs on valid lanes")
        elif k in ("quads", "marker_corners"):
            worst[k] = float(np.abs(a - b).max(initial=0.0))
            if worst[k] > CORNER_TOL_PX:
                fail(f"{label}: {k} differ by {worst[k]} px")
        elif k == "patches":
            worst[k] = float(np.abs(a - b).max(initial=0.0))
            if worst[k] > PATCH_TOL_GREY:
                fail(f"{label}: patches differ by {worst[k]} grey levels")
        elif k == "pose_translations":
            rel = np.linalg.norm(a - b, axis=-1) / np.maximum(
                np.linalg.norm(b, axis=-1), 1e-12
            )
            worst[k] = float(rel.max(initial=0.0))
            if worst[k] > POSE_REL_TOL:
                fail(f"{label}: pose translations differ by {worst[k]} rel")
    say(
        f"{label}: bit-equal where required over {int(quad.sum())} candidate "
        f"and {int(mark.sum())} marker lanes; worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
    )


def check_scene(say, out, frame, truth, dictionary) -> None:
    """Ground-truth gate on every frame, found-vs-placed count, and
    containment of the numpy reference pipeline's markers."""
    import bench
    from aruco3_tpu import oracle

    bad = bench.gate_failures(out, truth)
    if bad:
        fail(f"corner gate: {len(bad)} misses, first {bad[:4]}")
    valid = np.asarray(out["marker_valid"])
    ids = np.asarray(out["marker_id"])
    corners = np.asarray(out["marker_corners"], dtype=np.float64)
    errs = [
        e
        for b in range(valid.shape[0])
        for e in bench.corner_errors(valid[b], ids[b], corners[b], truth)
    ]
    found = sorted(int(i) for i in ids[0][valid[0]])
    placed = sorted(mid for mid, _ in truth)
    say(
        f"ground truth: all {len(truth)} markers within "
        f"{bench.CORNER_TOL_PX} px in all {valid.shape[0]} frames (worst "
        f"{max(errs):.2f} px); frame 0 found {len(found)} markers, "
        f"placed {len(placed)}; extra ids {sorted(set(found) - set(placed))}"
    )
    om = oracle.OracleDetector(dictionary).detect(frame)
    missing = sorted({m.id for m in om} - set(found))
    if missing:
        fail(f"oracle ids {missing} not found by the detector")
    det_quads = [(int(ids[0][k]), corners[0][k]) for k in np.nonzero(valid[0])[0]]
    unmatched = [
        (m.id, m.corners)
        for m in om
        if not any(
            i == m.id and np.abs(c - np.asarray(m.corners)).max() <= 6.0
            for i, c in det_quads
        )
    ]
    say(
        f"oracle: {len(om)} markers, ids {sorted(m.id for m in om)} all "
        f"among the detector's; oracle markers with no detector marker of "
        f"that id within 6 px: {unmatched}"
    )


# --------------------------------------------------------------- phase d
def time_and_trace(say, compiled, frames, batch: int, out_dir: str) -> None:
    import jax

    import bench
    from aruco3_tpu.utils import profiling

    times = bench.time_steps(compiled, frames, TIMED_STEPS)
    med = float(np.median(times))
    say(
        f"time: batch {batch}, median {med * 1e3:.3f} ms per batch over "
        f"{TIMED_STEPS} steps (min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}), {batch / med:.1f} frames/s"
    )
    trace_dir = os.path.join(out_dir, "trace")
    with profiling.trace(trace_dir):
        for _ in range(TRACED_STEPS):
            jax.block_until_ready(compiled(frames))
    ops = profiling.device_op_times(trace_dir)
    if not ops:
        fail("the profiler trace holds no device op")
    total = sum(ops.values())
    say(
        f"trace: {len(ops)} distinct device ops, {total / TRACED_STEPS / 1e6:.3f} "
        f"ms of device op time per batch"
    )
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    with open(os.path.join(out_dir, "device_ops.json"), "w") as f:
        json.dump(
            [{"op": k, "ns_per_batch": v / TRACED_STEPS} for k, v in ranked],
            f,
            indent=1,
        )
    for name, ns in ranked[:5]:
        say(
            f"top op: {ns / TRACED_STEPS / 1e6:.3f} ms per batch "
            f"({100 * ns / total:.1f}%) {name}"
        )


# --------------------------------------------------------------- phase e
def public_surfaces(say, dictionary, frame, truth) -> None:
    import jax

    from aruco3_tpu import ARDictionary, Detector, pose
    from aruco3_tpu.render import random_marker_scene
    from aruco3_tpu.runtime.stream import StreamPipeline

    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img, _, _ = random_marker_scene(d, 7, (640, 480), rng=np.random.default_rng(3))
    res = Detector(dictionary=d).detect(img)
    hits = [m for m in res.markers if m.id == 7]
    if not hits:
        fail(f"Detector.detect: marker 7 not found ({res.stats})")
    best, alt = pose.solve_with_undistorted_points(hits[0].corners, 40.0, (640, 480))
    if not (np.isfinite(np.asarray(best.translation)).all() and best.error <= alt.error):
        fail("pose.solve_with_undistorted_points: bad pose")
    say(
        f"Detector.detect 640x480: ids {[m.id for m in res.markers]}; pose "
        f"translation {np.asarray(best.translation).round(4).tolist()}, "
        f"error {float(best.error):.3g}"
    )

    h, w = frame.shape
    det = Detector(dictionary=dictionary)
    n_streams, per_stream = 4, 3
    pipe = StreamPipeline(det, (h, w), n_streams=n_streams, batch=n_streams)
    jax.block_until_ready(det.detect_batch(np.stack([frame] * n_streams)))
    for _ in range(per_stream):
        for s in range(n_streams):
            pipe.push(s, frame)
    want = {mid for mid, _ in truth}
    lanes = 0
    pipe.start()
    try:
        deadline = time.time() + 300
        while time.time() < deadline and lanes < n_streams * per_stream:
            for item in pipe.drain():
                valid = np.asarray(item["outputs"]["marker_valid"])
                ids = np.asarray(item["outputs"]["marker_id"])
                for lane in range(item["n"]):
                    got = set(ids[lane][valid[lane]].tolist())
                    if not want <= got:
                        fail(f"StreamPipeline lane missed {sorted(want - got)}")
                    lanes += 1
            time.sleep(0.01)
    finally:
        pipe.stop()
    if lanes < n_streams * per_stream:
        fail(f"StreamPipeline returned {lanes} of {n_streams * per_stream} frames")
    say(
        f"StreamPipeline: {n_streams} streams of {w}x{h}, {lanes} frames in "
        f"{pipe.stats.batches} batches, every frame with all "
        f"{len(want)} markers; {pipe.stats.detect_seconds / pipe.stats.batches * 1e3:.1f} "
        f"ms per batch dispatch-to-done"
    )


def run_one_card(say, frame, truth, dictionary, batch: int, limit: int, out_dir: str):
    """Phases b-e on the first device; ``frame`` and ``truth`` come from
    ``bench.bench_scene`` (or a smaller scene of the same form)."""
    import jax
    import jax.numpy as jnp

    from aruco3_tpu import Detector

    h, w = frame.shape
    det = Detector(dictionary=dictionary)
    step = jax.jit(det.markers_pipeline(h, w, with_pose=True))
    compiled, batch = compile_headline(say, step, batch, h, w, limit)
    with open(os.path.join(out_dir, "headline.hlo.txt"), "w") as f:
        f.write(compiled.as_text())

    frames = jnp.asarray(np.broadcast_to(frame, (batch, h, w)))
    out = jax.block_until_ready(compiled(frames))
    check_scene(say, out, frame, truth, dictionary)

    probe = jax.jit(stage_probe(det, h, w))
    two = np.broadcast_to(frame, (2, h, w))
    t0 = time.perf_counter()
    ref = probe(jax.device_put(two, jax.devices("cpu")[0]))
    ref = jax.block_until_ready(ref)
    say(f"cpu backend: probe compiled and ran in {time.perf_counter() - t0:.1f} s")
    got = probe(jax.device_put(two, jax.devices()[0]))
    compare_backends(say, got, ref, "gpu stages vs cpu")
    head = {k: v[:2] for k, v in out.items() if k in ref}
    compare_backends(say, head, ref, "gpu headline program vs cpu")

    time_and_trace(say, compiled, frames, batch, out_dir)
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak device memory in use: {stats.get('peak_bytes_in_use')} B")
    public_surfaces(say, dictionary, frame, truth)


# ------------------------------------------------------------ --cards 4
def run_four_cards(say, frames, grid, grid_dictionary, dictionary) -> None:
    """Sharded frame batch vs a 1-card mesh, and row-band spatial detect
    vs one-card ``Detector.detect``."""
    import jax
    from jax.sharding import Mesh

    from aruco3_tpu import Detector, DetectorConfig
    from aruco3_tpu.parallel.sharding import build_sharded_detect, make_mesh, shard_frames
    from aruco3_tpu.parallel.spatial import detect_spatial

    n = 4
    b, h, w = frames.shape
    det = Detector(dictionary=dictionary)
    mesh4 = make_mesh(n)
    sharded = shard_frames(frames, mesh4)
    devices = {s.device for s in sharded.addressable_shards}
    if len(devices) != n:
        fail(f"frames sit on {len(devices)} devices, not {n}")
    out4 = jax.block_until_ready(build_sharded_detect(det, mesh4, h, w, with_pose=True)(sharded))
    out_devices = {s.device for s in out4["marker_valid"].addressable_shards}
    if len(out_devices) != n:
        fail(f"outputs sit on {len(out_devices)} devices, not {n}")
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("batch",))
    out1 = build_sharded_detect(det, mesh1, h, w, with_pose=True)(shard_frames(frames, mesh1))
    valid = np.asarray(out4["marker_valid"])
    if not valid.any():
        fail("sharded batch found no marker")
    for k in sorted(out4):
        a, c = np.asarray(out4[k]), np.asarray(out1[k])
        if k != "marker_valid":
            a, c = a[valid], c[valid]
        if not np.array_equal(a, c):
            fail(f"sharded {k} differs from the 1-card mesh")
    say(
        f"detect_sharded: {b} frames of {w}x{h} over {n} devices, bit-equal "
        f"to the 1-card mesh on {int(valid.sum())} marker lanes"
    )

    cfg = DetectorConfig(
        max_candidates=96,
        min_side_length_factor=0.02,
        min_corner_separation_factor=0.002,
    )
    gdet = Detector(cfg, grid_dictionary)
    single = gdet.detect(grid)
    out = jax.device_get(detect_spatial(gdet, grid, mesh=make_mesh(n, axis="rows")))
    sv = out["marker_valid"]
    spatial = sorted(int(i) for i in out["marker_id"][sv])
    ref_ids = sorted(m.id for m in single.markers)
    if spatial != ref_ids or not ref_ids:
        fail(f"detect_spatial ids {spatial} vs Detector.detect {ref_ids}")
    ref_c = {m.id: np.asarray(m.corners, float) for m in single.markers}
    worst = max(
        np.abs(c - ref_c[int(i)]).max()
        for i, c in zip(out["marker_id"][sv], out["marker_corners"][sv])
    )
    if worst > 1.0:
        fail(f"detect_spatial corners differ by {worst} px")
    gh, gw = grid.shape
    say(
        f"detect_spatial: {gw}x{gh} grid over {n} row bands, "
        f"{len(spatial)} markers, same ids as one-card Detector.detect, "
        f"corners within {worst:.2f} px (rounded integer corners)"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke"),
        help="directory for the trace, the device-op table and the HLO",
    )
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 1
    count = len(jax.devices())
    if count < args.cards:
        print(f"chip_smoke: {args.cards} cards asked, {count} found", file=sys.stderr)
        return 1
    say = Report(card_line())
    say(f"device: {dev.platform}, {dev.device_kind}, {count} device(s)")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench
    from aruco3_tpu import ARDictionary
    from aruco3_tpu.runtime.cache import enable_compilation_cache

    say(f"compilation cache: {enable_compilation_cache()}")
    os.makedirs(args.out, exist_ok=True)
    dictionary = ARDictionary.new_from_named_dict(bench.DICTIONARY)
    frame, truth = bench.bench_scene(dictionary)
    if args.cards == 4:
        from benches.bench_configs import grid_frame

        grid_dict = ARDictionary.new_from_named_dict("APRILTAG_36H11")
        grid, _ = grid_frame(grid_dict, 2160, 3840, cell=330, rng=np.random.default_rng(2))
        frames = np.broadcast_to(frame, (8,) + frame.shape)
        run_four_cards(say, frames, grid, grid_dict, dictionary)
    else:
        limit = dev.memory_stats()["bytes_limit"]
        run_one_card(say, frame, truth, dictionary, HEADLINE_BATCH, limit, args.out)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
