"""Image frontend: grayscale conversion and adaptive mean thresholding.

Semantics parity (vs reference src/aruco.rs:58-64 and its imageproc/image
dependencies):
  * ``rgb_to_luma`` uses the image-crate Rec.709 luma weights
    (0.212671, 0.715160, 0.072169) applied to the nonlinear 8-bit values.
  * ``adaptive_threshold(grey, window)`` compares each pixel against the
    mean of the (2*window+1)^2 box centred on it, with the box clamped at
    image borders (variable area).  Output is a boolean "white" mask
    (True == foreground == 255 in the reference).  The comparison is done
    in exact integer arithmetic as ``pixel * area > sum`` so there is no
    floating-point mean rounding anywhere.

Design: the box sums are two separable clamped cumsum-difference passes in
int32 (row pass bounds values at 255*(2r+1); column pass at 255*(2r+1)*H —
exact in int32 for any realistic frame), so the whole threshold stage is a
handful of fused dense XLA ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# image-crate luma weights (nonlinear Rec.709), see image-rs color::SRGB_LUMA.
LUMA_WEIGHTS = (0.212671, 0.715160, 0.072169)


def rgb_to_luma_u8(image: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W, C) uint8 (C in {1, 3, 4}) -> (..., H, W) uint8 grayscale.

    Mirrors ``DynamicImage::into_luma8`` (reference aruco.rs:60): weighted
    Rec.709 luma of the raw 8-bit channels, rounded to nearest.
    Alpha, if present, is ignored.
    """
    if image.ndim >= 3 and image.shape[-1] in (3, 4):
        r = image[..., 0].astype(jnp.float32)
        g = image[..., 1].astype(jnp.float32)
        b = image[..., 2].astype(jnp.float32)
        w = LUMA_WEIGHTS
        luma = w[0] * r + w[1] * g + w[2] * b
        return jnp.round(luma).astype(jnp.uint8)
    if image.ndim >= 3 and image.shape[-1] == 1:
        return image[..., 0]
    return image


def _clamped_window_sum_1d(
    cum: jnp.ndarray, length: int, radius: int, axis: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed sums along ``axis`` from an exclusive cumsum of length+1,
    with the window clamped to [0, length).  Returns (sums, counts).

    Expressed as edge-clamped pad + two static slices (no take/gather).
    """
    # cum has length+1 entries along `axis` (exclusive prefix sums).
    # Window sum at i = cum[min(i + r, L-1) + 1] - cum[max(i - r, 0)].
    hi_all = jax.lax.slice_in_dim(cum, 1, length + 1, axis=axis)
    lo_all = jax.lax.slice_in_dim(cum, 0, length, axis=axis)
    # Edge-clamp by padding with the boundary values.
    pad_hi = [(0, 0)] * cum.ndim
    pad_hi[axis] = (0, radius)
    pad_lo = [(0, 0)] * cum.ndim
    pad_lo[axis] = (radius, 0)
    hi = jnp.pad(hi_all, pad_hi, mode="edge")
    lo = jnp.pad(lo_all, pad_lo, mode="edge")
    hi = jax.lax.slice_in_dim(hi, radius, radius + length, axis=axis)
    lo = jax.lax.slice_in_dim(lo, 0, length, axis=axis)
    sums = hi - lo
    idx = np.arange(length)
    counts = (
        np.minimum(idx + radius, length - 1) + 1 - np.maximum(idx - radius, 0)
    ).astype(np.int32)
    return sums, counts


def box_sum_and_area(grey: jnp.ndarray, radius: int):
    """Clamped box sums + box areas over (H, W) uint8.

    Returns (sums int32, areas int32 (H, W)).  Exact integer arithmetic.
    """
    h, w = grey.shape[-2], grey.shape[-1]
    g = grey.astype(jnp.int32)

    # Row pass: exclusive cumsum along W, then clamped window difference.
    cum_w = jnp.cumsum(g, axis=-1)
    cum_w = jnp.pad(cum_w, [(0, 0)] * (g.ndim - 1) + [(1, 0)])
    row_sums, col_counts = _clamped_window_sum_1d(cum_w, w, radius, axis=-1)

    # Column pass over the row sums.
    cum_h = jnp.cumsum(row_sums, axis=-2)
    cum_h = jnp.pad(cum_h, [(0, 0)] * (g.ndim - 2) + [(1, 0), (0, 0)])
    sums, row_counts = _clamped_window_sum_1d(cum_h, h, radius, axis=-2)

    areas = row_counts[:, None] * col_counts[None, :]
    return sums, jnp.asarray(areas)


def adaptive_threshold(grey: jnp.ndarray, window: int) -> jnp.ndarray:
    """Boolean white mask: pixel >= clamped-box mean (exact integer compare).

    ``window`` is the box *radius*, matching imageproc's ``block_radius``
    argument as used by the reference (aruco.rs:61, default 7 -> 15x15 box).
    Ties (pixel exactly equal to the box mean, i.e. flat regions) classify
    as foreground/white: flat background stays white, which the hole-fill
    stage of the quad extractor relies on, and only genuinely
    below-local-mean pixels count as marker ink.
    """
    sums, areas = box_sum_and_area(grey, window)
    return grey.astype(jnp.int32) * areas >= sums


def threshold_u8(grey: jnp.ndarray, window: int) -> jnp.ndarray:
    """uint8 0/255 view of ``adaptive_threshold`` (reference-style image)."""
    return jnp.where(
        adaptive_threshold(grey, window),
        jnp.uint8(255),
        jnp.uint8(0),
    )
