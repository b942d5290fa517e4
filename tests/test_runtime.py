"""Native streaming runtime tests: ring buffer, batch assembly, luma, and
an end-to-end multi-stream pipeline run (BASELINE config 5 shape)."""

import numpy as np
import pytest

from aruco3_tpu import ARDictionary, Detector, DetectorConfig, frontend
from aruco3_tpu.render import random_marker_scene
from aruco3_tpu.runtime import stream as rt


def test_native_lib_loaded():
    # Built from native/stream_buffer.cpp on first use when missing.
    assert rt.native_lib() is not None, "tools/build_native.sh failed"
    assert rt.FrameRing((2, 2))._native


def test_ring_push_pop_order():
    ring = rt.FrameRing((4, 6), capacity=4)
    frames = [np.full((4, 6), i, dtype=np.uint8) for i in range(3)]
    seqs = [ring.push(f) for f in frames]
    assert seqs == [0, 1, 2]
    assert len(ring) == 3
    for i in range(3):
        out, seq = ring.pop()
        assert seq == i
        assert (out == i).all()
    assert ring.pop() is None


def test_ring_drop_oldest():
    ring = rt.FrameRing((2, 2), capacity=2)
    for i in range(5):
        ring.push(np.full((2, 2), i, dtype=np.uint8))
    assert ring.dropped == 3
    out, seq = ring.pop()
    assert seq == 3 and (out == 3).all()
    out, seq = ring.pop()
    assert seq == 4 and (out == 4).all()


def test_batch_assemble_round_robin():
    rings = [rt.FrameRing((2, 2), capacity=8) for _ in range(3)]
    for s, ring in enumerate(rings):
        for i in range(2):
            ring.push(np.full((2, 2), 10 * s + i, dtype=np.uint8))
    frames, ids, seqs, n = rt.assemble_batch(rings, 8)
    assert n == 6
    # Round robin: first three lanes come from distinct streams.
    assert sorted(ids[:3].tolist()) == [0, 1, 2]
    # Padding lanes flagged and repeat the last real frame.
    assert (ids[6:] == -1).all()
    np.testing.assert_array_equal(frames[6], frames[5])


def test_rgb_to_luma_matches_device():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(16, 17, 3), dtype=np.uint8)
    host = rt.rgb_to_luma_host(rgb)
    import jax.numpy as jnp

    dev = np.asarray(frontend.rgb_to_luma_u8(jnp.asarray(rgb)))
    # Rounding of float32 vs float64 luma can differ by 1 LSB on exact .5s.
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


def test_stream_pipeline_overlaps_assembly_with_device():
    """The double-buffered loop must overlap host batch assembly with the
    in-flight device batch: with an artificially slow 'device' (50 ms) and
    slow assembly (30 ms), N pipelined batches must take ~max(50,30) each,
    well under the 80 ms serial sum (reference webcam loop is serial,
    examples/webcam_kamera.rs:28-77 — this is the batched replacement)."""
    import time

    dev_ms, asm_ms, batches = 0.05, 0.03, 8
    events = []

    class FakePipeline(rt.StreamPipeline):
        def __init__(self):
            super().__init__(
                detector=None, frame_shape=(2, 2), n_streams=1, batch=1
            )
            self._served = 0

        def _assemble(self):
            if self._served >= batches:
                return (
                    np.zeros((1, 2, 2), np.uint8),
                    np.full(1, -1, np.int64),
                    np.full(1, -1, np.int64),
                    0,
                )
            self._served += 1
            events.append(("assemble_start", time.perf_counter()))
            time.sleep(asm_ms)  # simulated host assembly cost
            events.append(("assemble_end", time.perf_counter()))
            return (
                np.zeros((1, 2, 2), np.uint8),
                np.zeros(1, np.int64),
                np.arange(1, dtype=np.int64) + self._served,
                1,
            )

        def _dispatch(self, frames):
            # Simulated async device: completion at a future deadline.
            return {"deadline": time.perf_counter() + dev_ms}

        def _sync(self, out):
            while time.perf_counter() < out["deadline"]:
                time.sleep(0.001)
            events.append(("complete", time.perf_counter()))

    pipe = FakePipeline()
    t0 = time.perf_counter()
    pipe.start()
    deadline = time.time() + 30
    while time.time() < deadline and pipe.stats.batches < batches:
        time.sleep(0.005)
    elapsed = time.perf_counter() - t0
    pipe.stop()
    assert pipe.stats.batches == batches
    serial = batches * (dev_ms + asm_ms)
    # Pipelined: ~first assembly + N * max(dev, asm); assert well under
    # the serial sum (leave slack for the 1-core CI box).
    assert elapsed < serial * 0.85, (elapsed, serial)
    # Structural overlap: assembly of batch N+1 begins before batch N's
    # completion is observed.
    starts = [t for k, t in events if k == "assemble_start"]
    completes = [t for k, t in events if k == "complete"]
    assert len(starts) >= batches and len(completes) >= 2
    overlapped = sum(
        1 for i in range(1, min(len(starts), len(completes)))
        if starts[i] < completes[i - 1]
    )
    assert overlapped >= (batches - 1) // 2, events


def test_stream_pipeline_end_to_end():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    det = Detector(DetectorConfig(max_candidates=16), d)
    pipe = rt.StreamPipeline(det, (240, 320), n_streams=4, batch=4)
    rng = np.random.default_rng(3)
    truth = {}
    for s in range(4):
        mid = int(rng.integers(0, len(d)))
        img, _, _ = random_marker_scene(d, mid, (320, 240), rng=rng)
        truth[s] = mid
        pipe.push(s, img)
    pipe.start()
    import time

    deadline = time.time() + 120
    got = {}
    while time.time() < deadline and len(got) < 4:
        for item in pipe.drain():
            out = item["outputs"]
            valid = np.asarray(out["marker_valid"])
            ids = np.asarray(out["marker_id"])
            for lane, s in enumerate(item["stream_ids"]):
                if s < 0:
                    continue
                det_ids = ids[lane][valid[lane]].tolist()
                got[int(s)] = det_ids
        time.sleep(0.05)
    pipe.stop()
    assert len(got) == 4
    hits = sum(1 for s, mid in truth.items() if mid in got.get(s, []))
    assert hits >= 3  # randomized scenes: most streams must decode
    assert pipe.stats.frames >= 4
