"""Multi-device tests on the virtual 8-device CPU mesh: sharded batch
detection must match single-frame results, and the graft entry points must
compile and run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aruco3_tpu import ARDictionary, Detector, DetectorConfig
from aruco3_tpu.parallel.sharding import (
    build_sharded_detect,
    detect_sharded,
    make_mesh,
    shard_frames,
)
from aruco3_tpu.render import random_marker_scene


@pytest.fixture(scope="module")
def small_detector():
    return Detector(
        DetectorConfig(max_candidates=16),
        ARDictionary.new_from_named_dict("ARUCO_DEFAULT"),
    )


def test_device_count():
    assert jax.device_count() == 8


def test_sharded_detect_matches_single(small_detector):
    d = small_detector.dictionary
    rng = np.random.default_rng(11)
    imgs, mids = [], []
    for _ in range(8):
        mid = int(rng.integers(0, len(d)))
        img, _, _ = random_marker_scene(d, mid, (320, 240), rng=rng)
        imgs.append(img)
        mids.append(mid)
    frames = jnp.asarray(np.stack(imgs))
    mesh = make_mesh(8)
    out = detect_sharded(small_detector, frames, mesh=mesh, with_pose=True)
    valid = np.asarray(out["marker_valid"])
    ids = np.asarray(out["marker_id"])
    # Poses come back for every lane with the right shapes.
    assert np.asarray(out["pose_rotations"]).shape[-3:] == (2, 3, 3)
    hits = 0
    for b in range(8):
        det = small_detector.detect(imgs[b])
        sharded_ids = sorted(ids[b][valid[b]].tolist())
        single_ids = sorted(m.id for m in det.markers)
        assert sharded_ids == single_ids
        if mids[b] in sharded_ids:
            hits += 1
    assert hits >= 6  # randomized scenes: most must detect


def test_sharded_batch_is_actually_sharded(small_detector):
    mesh = make_mesh(8)
    frames = jnp.asarray(
        np.random.default_rng(0).integers(
            0, 256, size=(8, 96, 128), dtype=np.uint8
        )
    )
    sharded = shard_frames(frames, mesh)
    # Each device holds a (1, 96, 128) shard.
    shard_shapes = {s.data.shape for s in sharded.addressable_shards}
    assert shard_shapes == {(1, 96, 128)}


def test_graft_entry_single():
    # Fresh interpreter, exactly as the driver compile-checks entry():
    # the full 1080p detect+pose program is the biggest compile in the
    # suite and the XLA CPU compiler can die on it late in a long
    # single-process run (see _pytest_stackfix.py) — while always
    # compiling fine with a process to itself.
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import jax.numpy as jnp\n"
        "import __graft_entry__ as ge\n"
        "fn, args = ge.entry()\n"
        "out = jax.jit(fn)(*[jnp.asarray(a) for a in args])\n"
        "jax.block_until_ready(out)\n"
        "assert out['marker_valid'].shape[0] == args[0].shape[0]\n"
        "print('ENTRY_OK')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=1200,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ENTRY_OK" in res.stdout


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_1080p_production_geometry():
    """Sharding must cover the geometry the bench actually runs: one
    8-device shard_map batch at 1080p / default config / the headline
    dictionary, asserted EQUAL to the identical program on a 1-device
    mesh (the small-frame sharding tests above never touch the 1080p
    shapes).  Subprocess-isolated: the 1080p detect
    program is the XLA CPU compiler's biggest input (see
    test_graft_entry_single)."""
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, jax.numpy as jnp\n"
        "from jax.sharding import Mesh\n"
        "from aruco3_tpu import ARDictionary, Detector, DetectorConfig\n"
        "from aruco3_tpu.parallel.sharding import (\n"
        "    build_sharded_detect, make_mesh, shard_frames)\n"
        "from aruco3_tpu.render import random_marker_scene\n"
        "d = ARDictionary.new_from_named_dict('ARUCO_MIP_36H12')\n"
        "det = Detector(DetectorConfig(), d)\n"
        "rng = np.random.default_rng(29)\n"
        "imgs = []\n"
        "for _ in range(8):\n"
        "    mid = int(rng.integers(0, len(d)))\n"
        "    img, _, _ = random_marker_scene(\n"
        "        d, mid, (1920, 1080), rng=rng, min_scale=0.2,\n"
        "        max_scale=0.4)\n"
        "    imgs.append(np.asarray(img))\n"
        "frames = jnp.asarray(np.stack(imgs))\n"
        "mesh8 = make_mesh(8)\n"
        "step8 = build_sharded_detect(det, mesh8, 1080, 1920,\n"
        "                             with_pose=True)\n"
        "out8 = step8(shard_frames(frames, mesh8))\n"
        "mesh1 = Mesh(np.array(jax.devices()[:1]), ('batch',))\n"
        "step1 = build_sharded_detect(det, mesh1, 1080, 1920,\n"
        "                             with_pose=True)\n"
        "out1 = step1(shard_frames(frames, mesh1))\n"
        "valid = np.asarray(out8['marker_valid'])\n"
        "assert valid.any(), 'no markers detected at 1080p'\n"
        "for k in sorted(out8):\n"
        "    a, b = np.asarray(out8[k]), np.asarray(out1[k])\n"
        "    if k.startswith('pose') or k == 'marker_corners':\n"
        "        a, b = a[valid], b[valid]\n"
        "    np.testing.assert_array_equal(a, b, err_msg=k)\n"
        "print('SHARD1080_OK', int(valid.sum()))\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=2400,
        env=env,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SHARD1080_OK" in res.stdout
