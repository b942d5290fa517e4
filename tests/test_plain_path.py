"""The detector's one path, stage by stage, against independent references:
numpy / scipy for the frontend, pyramid and labelling, rendered ground
truth for the quad fit and corner refinement, and the f32 gather warp
for the matmul warp.  Small shapes only; nothing here compiles the 1080p
pipeline."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from aruco3_tpu import frontend, oracle, rectify, segment
from aruco3_tpu.dictionaries import ARDictionary
from aruco3_tpu.render import render_marker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS = ndimage.generate_binary_structure(2, 1)  # 4-connectivity


# --------------------------------------------------------------- frontend
def _image(kind, shape, rng):
    """Test frames: uniform noise, smoothed blobs (real structure), a dark
    frame with bright speckle, a flat frame, or one rendered marker."""
    if kind == "noise":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    if kind == "blobs":
        f = ndimage.gaussian_filter(
            rng.normal(0, 1, size=shape), sigma=(0, 6, 6)
        )
        f = (f - f.min()) / (np.ptp(f) + 1e-9)
        return (f * 255).astype(np.uint8)
    if kind == "dark":
        img = rng.integers(0, 40, size=shape, dtype=np.uint8)
        img[rng.random(shape) < 0.02] = 250
        return img
    if kind == "flat":
        return np.full(shape, 131, dtype=np.uint8)
    assert kind == "marker"
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    corners = np.array([[60, 50], [260, 60], [250, 250], [55, 240]], float)
    img = render_marker(d, 7, (shape[2], shape[1]), corners, noise_sigma=2.0)
    return np.asarray(img)[None]


def _frontend_np(g, window, radius, ds):
    """Independent frontend: threshold (oracle), opening as a 5x5 erosion
    that treats outside as black then a 5x5 dilation that treats it as
    white, and count >= ds/2 pooling."""
    white = oracle.adaptive_threshold_np(g, window)
    fp = np.ones((2 * radius + 1,) * 2, bool)
    black = ndimage.binary_erosion(~white, fp, border_value=1)
    black = ndimage.binary_dilation(black, fp, border_value=0)
    h, w = black.shape
    hp, wp = -(-h // ds) * ds, -(-w // ds) * ds
    m = np.zeros((hp, wp), np.int64)
    m[:h, :w] = black
    counts = m.reshape(hp // ds, ds, wp // ds, ds).sum(axis=(1, 3))
    return black, counts * 2 >= max(ds, 2)


@pytest.mark.parametrize(
    "shape,ds,kind",
    [
        ((2, 123, 217), 3, "noise"),
        ((1, 480, 640), 4, "noise"),
        ((2, 96, 128), 2, "noise"),
        ((1, 123, 217), 3, "blobs"),
        ((1, 240, 320), 4, "blobs"),
        ((1, 270, 2400), 10, "blobs"),
        ((1, 123, 217), 3, "dark"),
        ((2, 200, 330), 10, "noise"),
        ((1, 270, 2400), 10, "noise"),
        ((2, 720, 1280), 10, "blobs"),
        ((1, 488, 640), 6, "noise"),
        ((1, 241, 330), 5, "blobs"),
        ((1, 300, 320), 4, "marker"),
        ((2, 200, 330), 10, "blobs"),
        ((1, 123, 217), 3, "flat"),
        ((1, 270, 2400), 10, "dark"),
    ],
)
def test_frontend_matches_numpy(shape, ds, kind, rng):
    g = _image(kind, shape, rng)

    @jax.jit
    def prep(frames):
        def one(x):
            black = segment.open_mask(~frontend.adaptive_threshold(x, 7), 2)
            return black, segment.pool_black(black, ds)

        return jax.vmap(one)(frames)

    black, coarse = prep(jnp.asarray(g))
    for b in range(g.shape[0]):
        bref, cref = _frontend_np(g[b], 7, 2, ds)
        np.testing.assert_array_equal(np.asarray(black[b]), bref)
        np.testing.assert_array_equal(np.asarray(coarse[b]), cref)


# ---------------------------------------------------------------- pyramid
@pytest.mark.parametrize("shape", [(240, 320), (721, 1283)])
def test_build_pyramid_box_means(shape, rng):
    g = rng.integers(0, 256, size=shape, dtype=np.uint8)
    levels = rectify.build_pyramid(jnp.asarray(g), 5)
    img = g.astype(np.float64)
    for lvl in levels:
        h, w = img.shape
        ph, pw = max(h + h % 2, 64), max(w + w % 2, 64)
        padded = np.zeros((ph, pw))
        padded[:h, :w] = img
        np.testing.assert_allclose(np.asarray(lvl), padded, atol=1e-4)
        img = padded.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))


# ------------------------------------------------------------- labelling
def _solid_scene(shape, rng, n_rect=6, n_ring=3):
    """Axis-aligned rectangles and rectangular rings, separated by white,
    plus one block touching the border."""
    m = np.zeros(shape, bool)
    hc, wc = shape
    m[0:5, wc // 2 : wc // 2 + 6] = True  # border-connected
    placed = 0
    while placed < n_rect + n_ring:
        h, w = rng.integers(4, max(5, hc // 5)), rng.integers(4, max(5, wc // 6))
        y, x = rng.integers(7, hc - h - 2), rng.integers(2, wc - w - 2)
        if m[y - 2 : y + h + 2, x - 2 : x + w + 2].any():
            continue
        m[y : y + h, x : x + w] = True
        if placed >= n_rect and h > 3 and w > 3:
            m[y + 1 : y + h - 1, x + 1 : x + w - 1] = False
        placed += 1
    return m


def _expected_labels(mask):
    """Each cell of a hole-filled 4-connected component holds the
    component's minimum linear index; white holds the grid size."""
    filled = ndimage.binary_fill_holes(mask, structure=np.ones((3, 3)))
    lab, n = ndimage.label(filled, structure=CROSS)
    out = np.full(mask.shape, mask.size, np.int64)
    flat = np.arange(mask.size).reshape(mask.shape)
    for i in range(1, n + 1):
        sel = lab == i
        out[sel] = flat[sel].min()
    return out, lab


@pytest.mark.parametrize("shape", [(108, 192), (60, 120), (64, 300)])
def test_label_planes_match_scipy(shape, rng):
    m = _solid_scene(shape, rng)
    labels, labels2 = jax.jit(
        lambda c: segment.label_planes(c, segment.QuadParams())
    )(jnp.asarray(m))
    want, lab = _expected_labels(m)
    np.testing.assert_array_equal(np.asarray(labels), want)
    # Inner pass: free-standing components keep their (hole-filled) root
    # on their own cells; the border-connected block has no inner label.
    labels2 = np.asarray(labels2)
    border = np.zeros(shape, bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    for i in range(1, lab.max() + 1):
        cells = (lab == i) & m
        if (cells & border).any():
            assert (labels2[cells] == m.size).all()
        else:
            assert (labels2[cells] == want[cells]).all()
    assert (labels2[~m] == m.size).all()


# ------------------------------------------------------------ quad fit
def _raster_quad(shape, quad):
    """Coarse cells whose centers lie inside the convex quad (x, y)."""
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    inside = np.ones(shape, bool)
    for a, b in zip(quad, np.roll(quad, -1, axis=0)):
        cross = (b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])
        inside &= cross >= 0
    return inside


def _fit(mask, ds, **kw):
    params = segment.QuadParams(coarse_factor=ds, **kw)

    @jax.jit
    def run(c):
        labels, labels2 = segment.label_planes(c, params)
        fit = segment.fit_quads(labels, ds, params)
        k2 = params.max_inner_candidates
        fit2 = segment.fit_quads(labels2, ds, params, k=k2) if k2 else None
        return fit, segment.merge_fits(labels, labels2, fit, fit2, params, ds)

    fit, cand = run(jnp.asarray(mask))
    return jax.tree_util.tree_map(np.asarray, fit), jax.tree_util.tree_map(
        np.asarray, cand
    )


def _cyclic_err(q, truth):
    return min(np.abs(np.roll(q, r, axis=0) - truth).max() for r in range(4))


QUAD = np.array([[20.0, 8.0], [42.0, 14.0], [36.0, 33.0], [14.0, 27.0]])


def test_fit_quads_rotated_quad_corners():
    ds = 4
    m = _raster_quad((40, 54), QUAD)
    fit, _ = _fit(m, ds)
    lanes = np.nonzero(fit["valid"])[0]
    assert len(lanes) == 1
    truth = QUAD * ds + (ds - 1) * 0.5  # cell centers in pixels
    assert _cyclic_err(fit["quads"][lanes[0]], truth) <= 1.5 * ds
    assert fit["sizes"][lanes[0]] == m.sum()


def test_fit_quads_speck_clutter_ahead_of_marker():
    """Sub-size specks earlier in raster order neither take a lane nor
    push the marker out of the ranking pool."""
    m = np.zeros((40, 54), bool)
    m[1:7:2, 1:53:2] = True  # 78 one-cell specks in the top rows
    m |= _raster_quad((40, 54), QUAD)
    fit, _ = _fit(m, 4, max_candidates=4)
    assert fit["valid"].sum() == 1
    assert fit["qualifying"] == 1  # specks fail admission
    lane = np.nonzero(fit["valid"])[0][0]
    assert fit["sizes"][lane] == _raster_quad((40, 54), QUAD).sum()


def test_fit_quads_counts_overflow():
    """More qualifying components than lanes: the K largest get lanes and
    the rest are counted as overflow."""
    m = np.zeros((40, 54), bool)
    for i in range(6):
        y, x = 3 + (i // 3) * 15, 3 + (i % 3) * 17
        s = 4 + i  # distinct sizes
        m[y : y + s, x : x + s] = True
    fit, cand = _fit(m, 4, max_candidates=4, max_inner_candidates=0)
    assert fit["qualifying"] == 6
    assert sorted(fit["sizes"][fit["valid"]]) == [36, 49, 64, 81]
    assert cand["overflow"] == 2


def test_merge_fits_drops_exact_twin_lanes():
    """A free-standing ring is fitted by both passes with the same (root,
    size); the merge keeps one outer lane for it."""
    m = _raster_quad((40, 54), QUAD)
    m &= ~ndimage.binary_erosion(m, iterations=3)
    fit, cand = _fit(m, 4)
    assert fit["valid"].sum() == 1
    assert cand["valid"].sum() == 1
    assert not cand["is_inner"][cand["valid"]].any()


def test_merge_fits_keeps_marker_inside_dark_region():
    """A ring inside a dark block is merged away by the outer pass (the
    block's hole fill swallows it) and comes back as an inner lane."""
    m = np.zeros((60, 80), bool)
    m[5:55, 5:75] = True  # dark block
    m[10:50, 12:68] = False  # quiet zone
    ring = _raster_quad((60, 80), QUAD + [10.0, 12.0])
    m |= ring & ~ndimage.binary_erosion(ring, iterations=3)
    _, cand = _fit(m, 4)
    inner = cand["valid"] & cand["is_inner"]
    assert inner.sum() == 1
    truth = (QUAD + [10.0, 12.0]) * 4 + 1.5
    assert _cyclic_err(cand["quads"][inner][0], truth) <= 6.0


# ------------------------------------------------------------ refinement
def _find(img, **kw):
    h, w = img.shape
    ds = segment.choose_coarse_factor(h, w)
    params = segment.QuadParams(coarse_factor=ds, **kw)

    @jax.jit
    def run(g):
        black = segment.open_mask(~frontend.adaptive_threshold(g, 7), 2)
        coarse = segment.pool_black(black, ds)
        return segment.find_quads_from_masks(
            black, coarse, params, 0.2 * min(h, w), 0.1 * min(h, w), ds, grey=g
        )

    found = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(img)))
    return found["quads"][found["valid"]]


def _render(d, size, corners, **kw):
    return np.asarray(render_marker(d, 3, size, np.asarray(corners, float), **kw))


CORNERS_A = [[100, 70], [300, 90], [290, 280], [90, 265]]
CORNERS_B = [[40, 40], [150, 35], [155, 150], [45, 145]]
CORNERS_C = [[330, 200], [440, 210], [430, 320], [325, 310]]


def test_refined_corners_match_truth():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img = _render(d, (400, 360), CORNERS_A, noise_sigma=2.0)
    quads = _find(img)
    assert len(quads) == 1
    assert _cyclic_err(quads[0], np.asarray(CORNERS_A, float)) <= 1.0


def test_refined_corners_odd_candidate_count():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    img = np.minimum(
        _render(d, (480, 360), CORNERS_B, noise_sigma=1.0),
        _render(d, (480, 360), CORNERS_C, noise_sigma=1.0),
    )
    quads = _find(img, max_candidates=5, max_inner_candidates=3)
    assert len(quads) == 2
    for truth in (CORNERS_B, CORNERS_C):
        truth = np.asarray(truth, float)
        assert min(_cyclic_err(q, truth) for q in quads) <= 1.0


def test_refined_corners_inner_lane_on_dark_background():
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    # The dark frame's outer pass merges everything into one blob, so
    # only the inner (hole-border) pass can fit the marker.
    img = _render(
        d, (400, 360), CORNERS_A, background=0, quiet_zone_cells=1,
        noise_sigma=1.0,
    )
    quads = _find(img)
    truth = np.asarray(CORNERS_A, float)
    assert min(_cyclic_err(q, truth) for q in quads) <= 1.0


# ------------------------------------------------------------------ warp
# Quads by pyramid level: bbox side + 4 <= 60 * 2^level.
WARP_QUADS = {
    "l0_square": [[40, 30], [80, 32], [78, 72], [38, 70]],
    "l0_rotated": [[60, 20], [90, 42], [68, 72], [38, 50]],
    "l0_perspective": [[30, 100], [75, 97], [78, 140], [27, 145]],
    "l1": [[120, 60], [215, 70], [205, 160], [110, 150]],
    "l2": [[60, 60], [270, 80], [260, 270], [50, 255]],
    "l3": [[30, 20], [480, 40], [470, 460], [20, 450]],
}


@pytest.mark.parametrize("name", sorted(WARP_QUADS))
def test_warp_mxu_matches_gather(name):
    """The matmul warp samples pyramid level l with bilinear weights; the
    reference is the f32 gather warp on that level's box-mean image with
    the homography carried into level coordinates.  Tolerance: 2 grey
    levels, from the bf16 window, weights and products.  Both warps must
    decode to the same bits."""
    d = ARDictionary.new_from_named_dict("ARUCO_DEFAULT")
    corners = np.asarray(WARP_QUADS[name], float)
    img = _render(d, (512, 512), corners, noise_sigma=2.0)
    quad = jnp.asarray(corners[None], jnp.float32)
    H, valid = rectify.homography_square_to_quad(quad, 49)
    pyramid = rectify.build_pyramid(jnp.asarray(img), 4)
    got = np.asarray(rectify.warp_patches_mxu(pyramid, H, quad, 49))

    side = (corners.max(0) - corners.min(0)).max() + 4.0
    level = int(np.clip(np.ceil(np.log2(max(side / 60.0, 1e-3))), 0, 3))
    assert level == int(name[1])
    s = 2.0**level
    to_level = np.array(
        [[1 / s, 0, 0.5 / s - 0.5], [0, 1 / s, 0.5 / s - 0.5], [0, 0, 1]],
        np.float32,
    )
    h_level = jnp.asarray(to_level) @ H[0]
    ref = np.asarray(rectify.warp_patches(pyramid[level], h_level[None], 49))
    assert np.asarray(valid)[0]
    assert np.abs(got - ref).max() <= 2.0
    bits_got, ok_got = rectify.decode_patches(jnp.asarray(got), 6)
    bits_ref, ok_ref = rectify.decode_patches(jnp.asarray(ref), 6)
    np.testing.assert_array_equal(np.asarray(bits_got), np.asarray(bits_ref))
    assert bool(ok_got[0]) and bool(ok_ref[0])


# ------------------------------------------------------ process-level
def _run(code, **env_overrides):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_overrides)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=300,
    )


CACHE_PROBE = (
    "import jax\n"
    "from aruco3_tpu.runtime.cache import enable_compilation_cache\n"
    "print(enable_compilation_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_cache_dir_from_environment(tmp_path):
    where = str(tmp_path / "xla")
    res = _run(CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=where)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == [where, where]


def test_cache_dir_fixed_inside_checkout():
    res = _run(CACHE_PROBE)
    assert res.returncode == 0, res.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert res.stdout.split() == [want, want]
    assert _run(CACHE_PROBE).stdout == res.stdout  # no per-process name


def test_chip_smoke_refuses_cpu_only():
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_marker_pose_is_a_pytree_without_flax():
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import jax, jax.numpy as jnp\n"
        "from aruco3_tpu import MarkerPose, pose\n"
        "best, alt = jax.jit(pose.solve_with_undistorted_points,\n"
        "                    static_argnums=(1, 2))(\n"
        "    jnp.array([[100., 80.], [220., 85.], [215., 200.], [95., 195.]]),\n"
        "    40.0, (320, 240))\n"
        "assert isinstance(best, MarkerPose)\n"
        "leaves = jax.tree_util.tree_leaves(best)\n"
        "assert [l.shape for l in leaves] == [(), (3, 3), (3,)]\n"
        "moved = jax.tree_util.tree_map(lambda x: x * 2, best)\n"
        "assert float(moved.error) == 2 * float(best.error)\n"
        "print('POSE_PYTREE_OK')\n"
    )
    res = _run(code, JAX_PLATFORMS="cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "POSE_PYTREE_OK" in res.stdout
