"""Preset registry + profiling utility smoke tests."""

import numpy as np
import pytest

from aruco3_tpu.models.presets import PRESETS, build_detector, get_preset
from aruco3_tpu.render import random_marker_scene
from aruco3_tpu.utils.profiling import StageTimer


def test_presets_build():
    for name in PRESETS:
        det = get_preset(name).build()
        assert det.dictionary is not None


def test_unknown_preset():
    with pytest.raises(KeyError):
        get_preset("nope")


def test_preset_detects():
    det = build_detector("reference-default")
    rng = np.random.default_rng(0)
    mid = int(rng.integers(0, len(det.dictionary)))
    img, _, _ = random_marker_scene(det.dictionary, mid, (320, 240), rng=rng)
    out = det.detect(img)
    assert any(m.id == mid for m in out.markers)


def test_stage_timer():
    import jax.numpy as jnp

    t = StageTimer()
    out = t.time_fn("add", lambda x: x + 1, jnp.ones((8, 8)), iters=2)
    np.testing.assert_array_equal(np.asarray(out), np.full((8, 8), 2.0))
    assert "add" in t.report()
