"""Spatial sharding: one huge frame split row-wise across the mesh.

This is the detection analogue of context/sequence parallelism (SURVEY §5):
the full-resolution frontend (the only stage whose cost scales with pixel
count) runs sharded, each device processing a horizontal band of the frame:

  1. halo exchange: each device sends its boundary rows to its neighbours
     via ``jax.lax.ppermute`` (the threshold box + opening need
     window + 2*open_radius rows of context),
  2. per-shard exact adaptive threshold + opening + pooling (global border
     semantics preserved through global row indexing),
  3. the tiny coarse mask and the black mask are ``all_gather``-ed and the
     fixed-capacity candidate tail runs replicated (its cost is
     independent of resolution).

Useful for 8K+ frames or very small meshes; for ordinary workloads,
frame-batch data parallelism (parallel.sharding) is the right axis and
needs no communication at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import segment
from ..detector import Detector, _detect_tail


def _threshold_open_tile(
    grey_ext: jnp.ndarray,
    row0,
    h: int,
    w: int,
    window: int,
    open_radius: int,
    halo: int,
):
    """Exact adaptive threshold + opening for the central rows of a tile.

    grey_ext: (Hs + 2*halo, W) with neighbour halos (zeros outside the
    image).  row0: global row index of the first *central* row.  Returns
    the opened black mask for the central Hs rows, bit-identical to the
    full-frame path.
    """
    g = grey_ext.astype(jnp.int32)
    n_ext = grey_ext.shape[0]

    # Box sums over the zero-padded extended tile (cols zero-padded too).
    gp = jnp.pad(g, ((0, 0), (window, window)))
    cum_w = jnp.pad(jnp.cumsum(gp, axis=1), ((0, 0), (1, 0)))
    row_sums = (
        cum_w[:, 2 * window + 1 :] - cum_w[:, : -(2 * window) - 1]
    )  # (n_ext, W)
    cum_h = jnp.pad(jnp.cumsum(row_sums, axis=0), ((1, 0), (0, 0)))
    hp = jnp.pad(cum_h, ((window, window), (0, 0)), mode="edge")
    sums = hp[2 * window + 1 :] - hp[: -(2 * window) - 1]  # (n_ext, W)
    # NOTE: edge-padding the row cumsum treats rows beyond the tile as
    # empty; since the halo is >= window + 2*open_radius, the rows the
    # opening consumes are exact.

    # Clamped counts from *global* coordinates.
    rows_abs = row0 - halo + jnp.arange(n_ext)[:, None]
    cols_abs = jnp.arange(w)[None, :]
    crow = (
        jnp.clip(rows_abs + window, 0, h - 1)
        - jnp.clip(rows_abs - window, 0, h - 1)
        + 1
    )
    ccol = (
        jnp.clip(cols_abs + window, 0, w - 1)
        - jnp.clip(cols_abs - window, 0, w - 1)
        + 1
    )
    inside = (rows_abs >= 0) & (rows_abs < h)

    white = g * (crow * ccol) >= sums
    black = (~white) | (~inside)

    # Opening with the full-frame boundary semantics: erosion sees black
    # (True) outside the image; the eroded mask is cleared outside before
    # dilation (cf. segment.open_mask's pad values).
    for _ in range(open_radius):
        black = segment._erode3(black)
    black = black & inside
    for _ in range(open_radius):
        black = segment._dilate3(black)
    black = black & inside
    return black[halo : n_ext - halo]


def build_spatial_detect(
    detector: Detector,
    mesh: Mesh,
    height: int,
    width: int,
    axis: str = "rows",
):
    """Compile a single-frame, spatially-sharded detect step.

    Returns a jitted fn: (H, W) uint8 -> single-frame outputs (replicated).
    H must divide by mesh_size * coarse_factor (pad the frame otherwise).
    """
    cfg = detector.config
    dictionary = detector.dictionary
    params, min_edge, min_sep, ds = detector.static_args(height, width)
    n_dev = mesh.shape[axis]
    halo = cfg.threshold_window + 2 * params.open_radius
    assert height % (n_dev * ds) == 0, (
        f"H={height} must divide by devices*coarse ({n_dev}*{ds})"
    )
    hs = height // n_dev

    def local_fn(grey_shard):
        # grey_shard: (1?, Hs, W) -> shard_map gives (Hs, W) with P(axis).
        grey_shard = grey_shard.reshape(hs, width)
        idx = jax.lax.axis_index(axis)

        # Halo exchange via ppermute: unpaired edges receive zeros, which
        # is exactly the outside-image padding the threshold expects.
        down = [(i, i + 1) for i in range(n_dev - 1)]  # my bottom -> next
        up = [(i + 1, i) for i in range(n_dev - 1)]  # my top -> prev
        from_above = jax.lax.ppermute(grey_shard[-halo:], axis, down)
        from_below = jax.lax.ppermute(grey_shard[:halo], axis, up)
        grey_ext = jnp.concatenate(
            [from_above, grey_shard, from_below], axis=0
        )

        row0 = idx * hs
        black_shard = _threshold_open_tile(
            grey_ext,
            row0,
            height,
            width,
            cfg.threshold_window,
            params.open_radius,
            halo,
        )
        coarse_shard = segment.pool_black(black_shard, ds)

        # Gather the (small) masks and the grey frame; the candidate tail
        # is resolution-independent and runs replicated on every device.
        black = jax.lax.all_gather(
            black_shard, axis, tiled=True
        )  # (H, W)
        coarse = jax.lax.all_gather(coarse_shard, axis, tiled=True)
        grey = jax.lax.all_gather(grey_shard, axis, tiled=True)

        out = _detect_tail(
            grey,
            black,
            coarse,
            dictionary,
            cfg,
            params,
            min_edge,
            min_sep,
            ds,
        )
        out["grey"] = grey
        return out

    step = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=P(axis, None),
            out_specs=P(),  # replicated outputs
            check_vma=False,
        )
    )
    return step


def detect_spatial(
    detector: Detector, frame, mesh: Mesh | None = None, axis: str = "rows"
):
    """One-shot: shard a single frame's rows over the mesh and detect."""
    from .sharding import make_mesh

    mesh = mesh or make_mesh(axis=axis)
    frame = jnp.asarray(frame)
    h, w = frame.shape
    n_dev = mesh.shape[axis]
    ds = detector.config.coarse_factor or segment.choose_coarse_factor(h, w)
    pad = (-h) % (n_dev * ds)
    if pad:
        # Pad with white (background) rows; markers never extend there.
        frame = jnp.pad(frame, ((0, pad), (0, 0)), constant_values=255)
        h = h + pad
    step = build_spatial_detect(detector, mesh, h, w, axis=axis)
    sharded = jax.device_put(frame, NamedSharding(mesh, P(axis, None)))
    return step(sharded)
