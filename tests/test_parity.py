"""Reference-parity suite: the detector must reproduce >=99% of the
reference pipeline's detections (BASELINE.json requirement).

The "reference" here is aruco3_tpu.oracle — a faithful numpy port of the
reference's detect pipeline (adaptive threshold -> Suzuki-Abe borders ->
RDP -> gates -> warp -> Otsu -> decode; see oracle.py's stage-by-stage
citations).  tests run a reduced seeded scene count for CI speed; the
full-size run (500+ scenes) is tools/parity_report.py, recorded in
BASELINE.md.  Set ARUCO3_PARITY_SCENES to override the count.
"""

import os

import numpy as np
import pytest

from aruco3_tpu import ARDictionary
from aruco3_tpu.oracle import (
    OracleDetector,
    adaptive_threshold_np,
    approximate_polygon_dp,
    convex_hull,
    find_contours_np,
)
from aruco3_tpu.parity import run_parity
from aruco3_tpu.render import render_marker


# ---------------------------------------------------------------- units
def test_adaptive_threshold_matches_jax():
    import jax.numpy as jnp

    from aruco3_tpu import frontend

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 80), dtype=np.uint8)
    a = adaptive_threshold_np(img, 7)
    b = np.asarray(frontend.adaptive_threshold(jnp.asarray(img), 7))
    np.testing.assert_array_equal(a, b)


def test_find_contours_rectangle():
    m = np.zeros((20, 30), dtype=bool)
    m[4:12, 5:20] = True
    cs = find_contours_np(m)
    assert len(cs) == 1  # one outer border, no holes
    c = cs[0]
    # Border pixels are exactly the rectangle's perimeter pixels.
    assert c[:, 0].min() == 5 and c[:, 0].max() == 19
    assert c[:, 1].min() == 4 and c[:, 1].max() == 11
    assert len(c) == 2 * (15 + 8) - 4


def test_find_contours_ring_has_hole_border():
    m = np.zeros((24, 24), dtype=bool)
    m[4:20, 4:20] = True
    m[8:16, 8:16] = False  # hole
    cs = find_contours_np(m)
    assert len(cs) == 2  # outer border + hole border
    sizes = sorted(len(c) for c in cs)
    assert sizes[0] < sizes[1]


def test_rdp_square():
    # A square contour must simplify to its 4 corners.
    pts = []
    for x in range(20):
        pts.append((x, 0))
    for y in range(20):
        pts.append((20, y))
    for x in range(20, 0, -1):
        pts.append((x, 20))
    for y in range(20, 0, -1):
        pts.append((0, y))
    out = approximate_polygon_dp(np.array(pts), len(pts) * 0.05)
    assert len(out) == 4


def test_convex_hull_drops_concave():
    pts = np.array([[0, 0], [10, 0], [10, 10], [5, 5]])
    assert len(convex_hull(pts)) == 3


def test_oracle_detects_rendered_marker():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    od = OracleDetector(d)
    corners = np.array([[60, 40], [200, 45], [195, 180], [55, 175]], float)
    img = render_marker(d, 33, (320, 240), corners, noise_sigma=1.5)
    ms = od.detect(img)
    assert any(m.id == 33 and m.hamming_distance == 0 for m in ms)


def test_oracle_detects_dark_background():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    od = OracleDetector(d)
    corners = np.array([[70, 50], [210, 55], [205, 190], [65, 185]], float)
    img = render_marker(
        d, 7, (320, 240), corners, background=0, quiet_zone_cells=2,
        noise_sigma=1.5,
    )
    assert any(m.id == 7 for m in od.detect(img))


# ------------------------------------------------------------- e2e parity
def test_recall_parity_vs_reference_pipeline():
    """>=99% of the oracle's detections must also be detector detections, over
    a seeded randomized scene mix (plain/dark/multi/nested).  144 scenes
    (~168 markers) so a single miss costs ~0.6%, not ~1.4%."""
    n = int(os.environ.get("ARUCO3_PARITY_SCENES", "144"))
    res = run_parity(n_scenes=n, image_size=(320, 240), seed=11)
    s = res.summary()
    assert res.oracle_found >= 0.7 * res.n_markers, s  # oracle sane
    assert res.parity >= 0.99, s
    # Corner agreement with ground truth: the detector at least as accurate as the
    # pixel-quantized reference pipeline on average.
    assert s["det_corner_mean_px"] < 2.0, s
    # No family may silently carry the misses: each >= 0.95 with the
    # small per-family counts (the 0.99 floor binds on the total).
    for kind, fam in s["per_family"].items():
        assert fam["parity"] >= 0.95, (kind, s)


def test_recall_parity_1080p_bench_regime():
    """Bench-regime parity gate: 1080p ARUCO_MIP_36H12 — the geometry
    the headline number is measured on (raw-src frontend, frame-packed
    coarse+fit).  The 320x240 gate above never touches that code path;
    a 1080p-only recall regression (e.g. from ccl_rounds / inner_depths
    changes) must fail CI, not wait for a manual parity_report run.
    20 seeded scenes (~25+ markers): at this count the 0.99 floor means
    zero misses, matching the measured 1.0 parity (BASELINE.md)."""
    n = int(os.environ.get("ARUCO3_PARITY_1080P_SCENES", "20"))
    res = run_parity(
        dictionary_name="ARUCO_MIP_36H12",
        n_scenes=n,
        image_size=(1920, 1080),
        seed=5,
    )
    s = res.summary()
    assert res.oracle_found >= 0.7 * res.n_markers, s  # oracle sane
    assert res.parity >= 0.99, s
