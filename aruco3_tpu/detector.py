"""Detector — the end-to-end ArUco/AprilTag pipeline as one XLA program.

Capability parity with reference src/aruco.rs:
  * ``DetectorConfig`` with the reference defaults (aruco.rs:32-43).
  * ``Detector { config, dictionary }`` and ``detect(image) -> Detection``
    (aruco.rs:46-122): grayscale -> adaptive threshold -> quad candidates ->
    clockwise corners -> near-duplicate suppression -> perspective patches ->
    Otsu binarize -> bit decode over 4 rotations -> dictionary match ->
    accept iff min distance < tau (or always when
    ``filter_high_bit_errors=False``), corners rotated so corner 0 is the
    marker's top-left (aruco.rs:96-111).
  * ``Detection`` exposes the debug intermediates the reference exposes:
    grey image, candidate quads, rectified patches, decoded markers
    (aruco.rs:15-21).

Design: the whole per-frame pipeline is one plain-JAX function over
fixed-capacity candidate buffers (no host round-trips between stages);
``detect_batch`` jits it vmapped over a frame batch, the unit that
``parallel.sharding`` distributes over a device mesh.  Host-facing ``detect``
is a thin adapter that feeds one frame through the same compiled program
and materialises reference-shaped Python objects.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from . import frontend, rectify, segment
from . import pose as pose_mod
from .dictionaries import ARDictionary

# Per-lane outputs that describe decoded markers (see detect_arrays).
MARKER_FIELDS = (
    "marker_valid",
    "marker_id",
    "marker_dist",
    "marker_corners",
    "marker_code",
)


@dataclass(frozen=True)
class DetectorConfig:
    """Detection tunables; defaults match reference aruco.rs:32-43.

    The reference's contour_simplification_epsilon controls RDP polygon
    simplification (aruco.rs:133), i.e. how far a contour may deviate from
    a 4-vertex polygon and still count as a quad.  The data-parallel
    fitter's analogue of that gate is the containment test (is the
    component well-covered by its fitted quad), so epsilon scales the
    containment slack: larger epsilon accepts blobbier components, exactly
    as a larger RDP epsilon would.  The pipeline's capacity/precision
    knobs live here too so a config fully determines the compiled program.
    """

    threshold_window: int = 7
    contour_simplification_epsilon: float = 0.05  # kept for API parity
    min_side_length_factor: float = 0.2
    min_corner_separation_factor: float = 0.1
    homography_sample_size: int = 49
    filter_high_bit_errors: bool = True
    # --- pipeline capacity/behaviour knobs (not in the reference) ---
    max_candidates: int = 32
    max_inner_candidates: int = 12  # hole-border pass lanes (0 disables)
    coarse_factor: int | None = None  # None = auto from image size
    ccl_rounds: int = 3  # see segment.QuadParams.ccl_rounds
    refine_corners: bool = True
    warp_impl: str = "mxu"  # "mxu" (pyramid+matmul) | "gather" (oracle)


@dataclass
class Marker:
    """Decoded marker (reference aruco.rs:7-13): ``id`` indexes the
    dictionary, ``code`` is the raw uncorrected read, corners are clockwise
    pixel coords starting at the marker's top-left."""

    id: int
    code: int
    corners: list[tuple[int, int]]
    hamming_distance: int


@dataclass
class Detection:
    """Host-side pipeline output incl. debug intermediates
    (reference aruco.rs:15-21).  ``stats`` carries the per-stage rejection
    counters the reference prints in debug builds (aruco.rs:125-127)."""

    grey: np.ndarray | None = None
    candidates: list = field(default_factory=list)
    homographies: list = field(default_factory=list)
    markers: list[Marker] = field(default_factory=list)
    stats: dict = field(default_factory=dict)


class Detector:
    """detect() orchestrator (reference aruco.rs:46-122)."""

    def __init__(
        self,
        config: DetectorConfig | None = None,
        dictionary: ARDictionary | None = None,
    ):
        self.config = config or DetectorConfig()
        self.dictionary = dictionary or ARDictionary.new_from_named_dict(
            "ARUCO_DEFAULT"
        )

    # ---------------------------------------------------------------- jit
    def static_args(self, height: int, width: int):
        """(params, min_edge, min_sep, ds): the jit-time constants of the
        pipeline for one image size."""
        cfg = self.config
        ds = cfg.coarse_factor or segment.choose_coarse_factor(height, width)
        # Map the reference's RDP epsilon onto the containment gate (see
        # DetectorConfig docstring): ratio 1.0 at the reference default.
        eps_scale = cfg.contour_simplification_epsilon / 0.05
        base = segment.QuadParams()
        params = segment.QuadParams(
            max_candidates=cfg.max_candidates,
            max_inner_candidates=cfg.max_inner_candidates,
            coarse_factor=ds,
            ccl_rounds=cfg.ccl_rounds,
            refine=cfg.refine_corners,
            containment_slack=base.containment_slack * eps_scale,
            min_containment=min(
                0.999, base.min_containment / max(eps_scale, 1e-6)
            ),
        )
        min_edge = min(width, height) * cfg.min_side_length_factor
        min_sep = min(width, height) * cfg.min_corner_separation_factor
        return params, min_edge, min_sep, ds

    def pipeline(self, height: int, width: int):
        """The unjitted batched frame pipeline for a static image size:
        (B, H, W[, C]) uint8 -> ``detect_batch_arrays`` outputs."""
        statics = self.static_args(height, width)

        def run(images: jnp.ndarray):
            return detect_batch_arrays(
                images, self.dictionary, self.config, *statics
            )

        return run

    def markers_pipeline(
        self,
        height: int,
        width: int,
        with_pose: bool = False,
        marker_size_mm: float = 40.0,
    ):
        """The unjitted batched pipeline reduced to per-lane marker fields
        (``MARKER_FIELDS``), plus both IPPE poses of every lane when
        ``with_pose``: corners normalised per axis by the image size
        (reference pose.rs:59-62); lanes with ``marker_valid`` False carry
        meaningless poses."""
        run = self.pipeline(height, width)

        def markers(images: jnp.ndarray):
            out = run(images)
            res = {k: out[k] for k in MARKER_FIELDS}
            if with_pose:
                scale = jnp.array([width, height], dtype=jnp.float32)
                rot, tr, err = pose_mod.solve_normalized_batch(
                    out["marker_corners"] / scale, marker_size_mm
                )
                res["pose_rotations"] = rot
                res["pose_translations"] = tr
                res["pose_errors"] = err
            return res

        return markers

    # NOTE: lru_cache on a method keys on `self`, so the cache holds a
    # strong reference to up to 32 Detector instances (and their
    # compiled programs).  Harmless for the intended long-lived-detector
    # usage; in a service that churns Detector objects, reuse instances
    # or call Detector._compiled.cache_clear() when discarding them.
    @functools.lru_cache(maxsize=32)
    def _compiled(self, height: int, width: int):
        """The jitted pipeline for a static image size (any batch size and
        channel count; jit retraces per input shape)."""
        return jax.jit(self.pipeline(height, width))

    # --------------------------------------------------------------- host
    def detect(self, image) -> Detection:
        """Single host image -> reference-shaped ``Detection``.

        Accepts (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 arrays
        (anything np.asarray-able, e.g. PIL images).
        """
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        fn = self._compiled(arr.shape[0], arr.shape[1])
        out = jax.device_get(fn(jnp.asarray(arr)[None]))
        return self._to_host(jax.tree_util.tree_map(lambda x: x[0], out))

    def detect_batch(self, images: jnp.ndarray):
        """(B, H, W[, C]) uint8 frames -> batched device-side results.

        Stays on device (no host sync); fields carry a leading batch axis.
        """
        return self._compiled(images.shape[1], images.shape[2])(images)

    def _to_host(self, out) -> Detection:
        quads = np.asarray(out["quads"])
        quad_valid = np.asarray(out["quad_valid"])
        patches = np.asarray(out["patches"])
        det = Detection(
            grey=np.asarray(out["grey"]),
            stats={k: int(v) for k, v in out.get("stats", {}).items()},
        )
        marker_valid = np.asarray(out["marker_valid"])
        ids = np.asarray(out["marker_id"])
        dists = np.asarray(out["marker_dist"])
        code_pairs = np.asarray(out["marker_code"])
        corners = np.asarray(out["marker_corners"])
        for k in range(quads.shape[0]):
            if not quad_valid[k]:
                continue
            det.candidates.append(
                [(float(x), float(y)) for x, y in quads[k]]
            )
            det.homographies.append(
                np.clip(np.round(patches[k]), 0, 255).astype(np.uint8)
            )
            if marker_valid[k]:
                code = int(code_pairs[k, 0]) | (int(code_pairs[k, 1]) << 32)
                det.markers.append(
                    Marker(
                        id=int(ids[k]),
                        code=code,
                        corners=[
                            (int(round(float(x))), int(round(float(y))))
                            for x, y in corners[k]
                        ],
                        hamming_distance=int(dists[k]),
                    )
                )
        return det


# --------------------------------------------------------------------------
# The jitted frame pipeline (pure function of arrays + static config)
# --------------------------------------------------------------------------
def detect_batch_arrays(
    images: jnp.ndarray,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
    params: segment.QuadParams,
    min_edge: float,
    min_sep: float,
    ds: int,
):
    """Batched detect pipeline: (B, H, W[, C]) u8 -> batched outputs.

    ``detect_arrays`` vmapped over the frame axis: every output field
    gains a leading batch axis.
    """
    return jax.vmap(
        lambda im: detect_arrays(
            im, dictionary, cfg, params, min_edge, min_sep, ds
        )
    )(images)


def detect_arrays(
    image: jnp.ndarray,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
    params: segment.QuadParams,
    min_edge: float,
    min_sep: float,
    ds: int,
):
    """Full detect pipeline for one frame; all shapes static.

    Returns a dict of device arrays with fixed candidate capacity K:
      grey (H, W) u8; quads (K, 4, 2) f32;
      quad_valid (K,) bool; patches (K, S, S) f32; marker_valid (K,) bool;
      marker_id / marker_dist / marker_rot (K,) i32; marker_code (K, 2) u32;
      marker_corners (K, 4, 2) f32 (rotated so corner 0 = marker top-left).
    """
    grey = frontend.rgb_to_luma_u8(image)
    white = frontend.adaptive_threshold(grey, cfg.threshold_window)
    black = segment.open_mask(~white, params.open_radius)
    coarse = segment.pool_black(black, ds)
    out = _detect_tail(
        grey, black, coarse, dictionary, cfg, params, min_edge, min_sep, ds
    )
    out["grey"] = grey
    return out


def _detect_tail(
    grey: jnp.ndarray,
    black: jnp.ndarray,
    coarse: jnp.ndarray,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
    params: segment.QuadParams,
    min_edge: float,
    min_sep: float,
    ds: int,
):
    found = segment.find_quads_from_masks(
        black, coarse, params, min_edge, min_sep, ds, grey=grey
    )
    return _decode_tail(
        grey,
        found["quads"],
        found["valid"],
        found["stats"],
        dictionary,
        cfg,
        ds,
    )


def _num_levels(h: int, w: int) -> int:
    import math

    return max(1, int(math.ceil(math.log2(max(h, w) / 60.0))) + 1)


def _decode_tail(
    grey: jnp.ndarray,
    quads: jnp.ndarray,
    quad_valid: jnp.ndarray,
    stats: dict,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
    ds: int,
):
    s = cfg.homography_sample_size
    H, h_valid = rectify.homography_square_to_quad(quads, s)
    if cfg.warp_impl == "gather":
        patches = rectify.warp_patches(grey, H, s)
    else:
        levels = _num_levels(grey.shape[0], grey.shape[1])
        pyramid = rectify.build_pyramid(grey, levels)
        patches = rectify.warp_patches_mxu(pyramid, H, quads, s)
    return _match_tail(
        quads, quad_valid, h_valid, patches, stats, dictionary, cfg
    )


def _match_tail(
    quads: jnp.ndarray,
    quad_valid: jnp.ndarray,
    h_valid: jnp.ndarray,
    patches: jnp.ndarray,
    stats: dict,
    dictionary: ARDictionary,
    cfg: DetectorConfig,
):
    bits, border_valid = rectify.decode_patches(
        patches, dictionary.get_mark_size()
    )

    # Dictionary match across 4 rotations in one matmul.
    ids_r, dists_r = dictionary.find_nearest_bits(bits)  # (K, 4) each
    rot = jnp.argmin(dists_r, axis=-1).astype(jnp.int32)  # first-min wins

    # Rotation selection as a static 4-term select chain.
    def take(a):
        return sum(
            jnp.where(rot == r, a[:, r], 0) for r in range(4)
        )

    best_id = take(ids_r)
    best_dist = take(dists_r)
    code_pairs_r = rectify.bits_to_u32_pairs(bits)  # (K, 4, 2)
    best_code = sum(
        jnp.where(
            (rot == r)[:, None],
            code_pairs_r[:, r],
            jnp.zeros_like(code_pairs_r[:, r]),
        )
        for r in range(4)
    )

    accept = quad_valid & h_valid & border_valid
    tau_ok = best_dist < dictionary.tau
    if cfg.filter_high_bit_errors:
        accept = accept & tau_ok

    count = lambda m: jnp.sum(m.astype(jnp.int32))  # noqa: E731
    stats = dict(stats)
    stats["reject_homography"] = count(quad_valid & ~h_valid)
    stats["reject_border"] = count(quad_valid & h_valid & ~border_valid)
    stats["reject_tau"] = count(
        quad_valid & h_valid & border_valid & ~tau_ok
    )
    stats["markers"] = count(accept)

    # corners.rotate_left(min_rotation) (reference aruco.rs:97-103) as
    # a 4-way select over static rolls (gather-free).
    corners_rot = sum(
        jnp.where(
            (rot == r)[:, None, None],
            jnp.roll(quads, -r, axis=1),
            0.0,
        )
        for r in range(4)
    )

    return {
        "quads": quads,
        "quad_valid": quad_valid,
        "patches": patches,
        "marker_valid": accept,
        "marker_id": best_id,
        "marker_dist": best_dist,
        "marker_rot": rot,
        "marker_code": best_code,
        "marker_corners": corners_rot,
        "stats": stats,
    }
