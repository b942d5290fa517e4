"""Data-parallel quad-candidate extraction (replaces contour tracing).

The reference walks Suzuki-Abe borders sequentially and RDP-simplifies each
contour to a quad (reference src/aruco.rs:64-166).  Border following is
inherently serial and hostile to SIMD/vector units, so this module uses a
coarse-to-fine, fixed-shape, fully data-parallel design instead:

  1. Downsample the black mask to a coarse grid (majority pool, factor
     chosen so the grid stays small; markers obey a minimum side length so
     no detection is lost to pooling).
  2. Label 8-connected black components by iterated neighbour-min label
     propagation with pointer jumping (log-depth convergence) — pure
     gather/min ops, no data-dependent control flow.
  3. Keep the top-K components by pixel count (fixed capacity K, masked
     lanes) and fit a quad to each via four masked argmax reductions:
     farthest-from-centroid -> farthest-from-A -> extreme points on both
     sides of the diagonal.  For convex boundaries these are convex-hull
     vertices, i.e. the quad corners.
  4. Refine each corner at full resolution: inside a window around the
     coarse corner, take the black pixel (of the same component) extremal
     along the centroid->corner direction.
  5. Geometry filters with reference semantics: clockwise corner order
     (aruco.rs:168-185), the min-edge-length gate *including the
     squared-vs-linear comparison quirk* (aruco.rs:149-156 compares squared
     edge length against the linear threshold — reproduced for recall
     parity), near-duplicate suppression by mean corner distance keeping
     the larger perimeter (aruco.rs:187-232), plus a containment test that
     stands in for the reference's "simplifies to exactly 4 convex
     vertices" check (rejects disks/blobs whose hull-quad misses pixels).

Everything is static-shape and jit/vmap-friendly; invalid lanes carry a
False validity bit instead of changing shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class QuadParams:
    """Static quad-extraction hyper-parameters (jit-time constants)."""

    max_candidates: int = 32
    coarse_factor: int = 8  # downsample factor for the CCL grid
    ccl_rounds: int = 3  # label scan rounds (solid blobs converge in 2-3;
    #   markers label on HOLE-FILLED planes in both passes, so 3 carries a
    #   round of margin.  Measured on the CPU: ccl_rounds=2 keeps 320x240
    #   parity at 1.0 but drops the 150-scene 1080p ARUCO_MIP_36H12
    #   parity 0.9883 -> 0.9766 (fragmented components at production
    #   coarse factors need the third round); keep 3.)
    fill_rounds: int = 5  # border-reachability flood rounds for hole fill
    min_component_px: int = 3  # in coarse pixels
    containment_slack: float = 1.5  # in coarse cells
    min_containment: float = 0.80
    open_radius: int = 2  # denoise opening radius before pooling
    refine_window: int = 0  # 0 = auto from coarse factor
    refine: bool = True
    # Inner (hole-border) pass: lanes reserved for black components that
    # are not border-connected — markers on dark backgrounds and nested
    # markers (reference Suzuki-Abe traces hole borders too, aruco.rs:64).
    # 0 disables the pass.
    max_inner_candidates: int = 12
    bg_rounds: int = 6  # border-connected-black flood rounds
    # Inner-pass depth peeling (see label_planes): nesting levels after
    # background removal, and the flood budgets of its sub-steps.  All
    # its floods cross at most a marker-band width (seeds are dense), so
    # small counts converge regardless of marker size or rotation.
    # 3 levels: at production coarse factors a large dark patch's
    # interior speckle is erased by the opening+pooling, so the patch
    # fragments into an outer-edge band and a hole-edge band — a marker
    # inside it then sits at nesting depth 2 (measured: every nested-
    # scene miss at 1080p before this was the ring lost beyond depth 1;
    # the hole-edge band got its lane instead).  Depths beyond the
    # scene's nesting are skipped at runtime (exhausted-peel cond).
    inner_depths: int = 3
    inner_flood_rounds: int = 3  # level extraction / known-white growth
    inner_fill_rounds: int = 4  # outside-reach (enclosure) flood
    # Label rounds for the (hole-filled, solid) inner component planes.
    inner_ccl_rounds: int = 3


# Pre-merge inner-duplicate gate, in coarse-cell units (see
# candidates_from_labels).  Module-level so diagnostics can disable it
# (set < 0) without editing the merge.
INNER_DUP_CHEBYSHEV_DS = 2.0

# Minimal offset sets for the pool-admission size test (fit_quads):
# counting same-label cells at
# these offsets from a component ROOT (its raster-minimum cell) gives
# >= t-1 hits iff the 4-connected component has >= t cells.  Proof for
# t=3: the root's first in-component neighbour n1 is (0,1) or (1,0)
# (left/up cells have smaller linear indices).  A third cell adjacent
# to {root, n1} exists (BFS), and its candidates are (0,2),(1,0),(1,1)
# when n1=(0,1), or (1,-1),(1,1),(2,0),(0,1) when n1=(1,0) — all in the
# set.  Conversely same-label cells are component members, so an
# undersized component can never reach the count (wrapped roll hits
# are still same-component cells).  This replaces the previous
# 13-offset Chebyshev window — the admitted set is identical.
ADMIT_OFFSETS = {
    2: ((0, 1), (1, 0)),
    3: ((0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0)),
}


def choose_coarse_factor(h: int, w: int, target: int = 192) -> int:
    """Pick a pooling factor so the coarse grid's long side is ~target."""
    return max(1, int(np.ceil(max(h, w) / target)))


# --------------------------------------------------------------------------
# Coarse mask + connected-component labelling
# --------------------------------------------------------------------------
def _erode3(m: jnp.ndarray) -> jnp.ndarray:
    p = jnp.pad(m, 1, constant_values=True)
    out = m
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = out & p[dy : dy + m.shape[0], dx : dx + m.shape[1]]
    return out


def _dilate3(m: jnp.ndarray) -> jnp.ndarray:
    p = jnp.pad(m, 1, constant_values=False)
    out = m
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = out | p[dy : dy + m.shape[0], dx : dx + m.shape[1]]
    return out


def open_mask(mask: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """Morphological opening with a (2r+1)^2 structuring element.

    Kills salt-and-pepper noise from the adaptive threshold (a (2r+1)-square
    of solid black is needed to survive) while keeping the >=(2r+1)px-wide
    black bands markers produce.  Pure shifted and/or ops — fuses into the
    threshold stage.
    """
    out = mask
    for _ in range(radius):
        out = _erode3(out)
    for _ in range(radius):
        out = _dilate3(out)
    return out


def open3(mask: jnp.ndarray) -> jnp.ndarray:
    """3x3 opening (kept for tests/back-compat)."""
    return open_mask(mask, radius=1)


def pool_black(black: jnp.ndarray, ds: int) -> jnp.ndarray:
    """Pool a *denoised* (H, W) bool mask by ds (pad with False).

    A coarse cell is black when it holds at least ds/2 black pixels — i.e.
    any >=3px band crossing the cell registers, but residual specks don't.
    (Majority pooling would erase the thin bands the adaptive threshold
    leaves along thick marker borders.)
    """
    h, w = black.shape
    hp = -(-h // ds) * ds
    wp = -(-w // ds) * ds
    m = jnp.pad(black, ((0, hp - h), (0, wp - w))).astype(jnp.int32)
    pooled = m.reshape(hp // ds, ds, wp // ds, ds).sum(axis=(1, 3))
    return pooled * 2 >= max(ds, 2)


def _segmented_min_scan(l, mask, sentinel, axis):
    """Bidirectional segmented running-min along ``axis`` by doubling.

    Each in-mask element receives the min over its contiguous in-mask run
    (both directions).  Out-of-mask elements act as segment boundaries and
    come back as the sentinel.  Shift-by-powers-of-two with blocked-flag
    bookkeeping — pure vector min/or/select ops, no gathers.
    """
    n = l.shape[axis]
    shape = [1] * l.ndim
    shape[axis] = -1
    idx_ax = jnp.arange(n).reshape(shape)

    lf = lb = jnp.where(mask, l, sentinel)
    bf = bb = ~mask
    shift = 1
    while shift < n:
        sl = jnp.roll(lf, shift, axis=axis)
        sb = jnp.roll(bf, shift, axis=axis)
        wrap = idx_ax < shift
        sl = jnp.where(wrap, sentinel, sl)
        sb = sb | wrap
        lf = jnp.where(bf, lf, jnp.minimum(lf, sl))
        bf = bf | sb

        sl = jnp.roll(lb, -shift, axis=axis)
        sb = jnp.roll(bb, -shift, axis=axis)
        wrap = idx_ax >= n - shift
        sl = jnp.where(wrap, sentinel, sl)
        sb = sb | wrap
        lb = jnp.where(bb, lb, jnp.minimum(lb, sl))
        bb = bb | sb
        shift *= 2
    return jnp.where(mask, jnp.minimum(lf, lb), sentinel)


def flood(
    medium: jnp.ndarray, seed: jnp.ndarray, rounds: int, diag: bool = True
) -> jnp.ndarray:
    """Cells of ``medium`` connected to ``seed & medium`` through it.

    ``diag`` selects 8-connectivity (white/foreground, the reference's
    imageproc convention for 255-pixels) vs 4-connectivity (black/hole
    regions — the Suzuki-Abe dual; 8-connected black lets sparse noise
    fields percolate into one component, which the reference's hole
    borders do not).

    Reachability is a boolean flood: transported along whole in-medium
    runs per round via segmented scans, with a neighbour-OR step for
    corridors.  Large solid regions converge in 2-3 rounds regardless of
    shape orientation.
    """
    hc, wc = medium.shape
    reach = medium & seed
    if diag:
        offs = [(dy, dx) for dy in (0, 1, 2) for dx in (0, 1, 2)
                if not (dy == 1 and dx == 1)]
    else:
        offs = [(0, 1), (2, 1), (1, 0), (1, 2)]

    # Encode reach as int (0 reached / 1 not) so the min-scan machinery
    # doubles as an or-flood: min over a run == "any reached in run".
    def body(_, reach):
        r = reach
        pads = jnp.pad(r, 1, constant_values=False)
        for dy, dx in offs:
            r = r | pads[dy : dy + hc, dx : dx + wc]
        r = r & medium
        # run transport along rows and columns
        v = jnp.where(r, 0, 1)
        v = _segmented_min_scan(v, medium, jnp.int32(2), axis=1)
        r = medium & (v == 0)
        v = jnp.where(r, 0, 1)
        v = _segmented_min_scan(v, medium, jnp.int32(2), axis=0)
        return medium & (v == 0)

    return jax.lax.fori_loop(0, rounds, body, reach)


def flood_from_border(
    medium: jnp.ndarray, rounds: int, diag: bool = True
) -> jnp.ndarray:
    """Cells of ``medium`` connected to the image border through it."""
    border = jnp.zeros_like(medium)
    border = border.at[0, :].set(True)
    border = border.at[-1, :].set(True)
    border = border.at[:, 0].set(True)
    border = border.at[:, -1].set(True)
    return flood(medium, border, rounds, diag=diag)


def fill_holes(black: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """Fill regions enclosed by black: white cells unreachable from the
    image border through white become black.

    This is the step that makes marker components *solid*: a marker is a
    black ring whose interior (the code cells) is enclosed, so after
    filling each marker is one solid quad blob.  Solid convex regions then
    converge under row/column label scans in 2-3 rounds regardless of
    rotation — whereas a thin rotated ring would need O(perimeter) rounds
    of label propagation.
    """
    white = ~black
    reach = flood_from_border(white, rounds)
    return black | (white & ~reach)


def label_components(black: jnp.ndarray, rounds: int) -> jnp.ndarray:
    """CCL by segmented min-scans + 4-neighbour min sweeps.

    Black components are 4-connected — the Suzuki-Abe dual of the
    reference's 8-connected white foreground (imageproc find_contours):
    diagonal-only black contacts do not merge components, so sparse noise
    fields cannot percolate into the structures they touch.

    black: (Hc, Wc) bool — expected to be *hole-filled* (solid blobs, see
    ``fill_holes``).  Returns (Hc, Wc) int32 labels: each black pixel holds
    the linear index of its component representative (the component's
    minimum linear index); white pixels hold the sentinel P = Hc*Wc.

    Each round transports labels across whole rows/columns with segmented
    min-scans plus one 4-neighbour min, in a fixed number of rounds (no
    pointer jumping).  Solid convex blobs converge in 2-3 rounds
    independent of size or rotation.
    """
    hc, wc = black.shape
    p = hc * wc
    sentinel = jnp.int32(p)
    idx = jnp.arange(p, dtype=jnp.int32).reshape(hc, wc)
    lbl = jnp.where(black, idx, sentinel)

    def neighbor_min(l):
        pads = jnp.pad(l, 1, constant_values=p)
        m = l
        for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
            m = jnp.minimum(m, pads[dy : dy + hc, dx : dx + wc])
        return jnp.where(black, m, sentinel)

    def body(_, l):
        l = neighbor_min(l)
        l = _segmented_min_scan(l, black, sentinel, axis=1)
        l = _segmented_min_scan(l, black, sentinel, axis=0)
        return l

    return jax.lax.fori_loop(0, rounds, body, lbl)


# --------------------------------------------------------------------------
# Component selection + quad fitting
# --------------------------------------------------------------------------
def _masked_argmax(score: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    return jnp.argmax(jnp.where(mask, score, -jnp.inf), axis=-1)


def fit_quads(
    labels: jnp.ndarray,
    ds: int,
    params: QuadParams,
    k: int | None = None,
):
    """Top-K components -> fitted quads in full-res pixel coords.

    labels: (Hc, Wc) int32 from ``label_components``.
    Returns dict with:
      quads:      (K, 4, 2) float32 (x, y) corners (A, B, C, D cyclic)
      valid:      (K,) bool
      roots:      (K,) int32 component representative (coarse linear index)
      centroids:  (K, 2) float32 full-res (x, y)
      sizes:      (K,) int32 coarse pixel counts
      qualifying: () int32 — total component count (including any beyond
                  the K lanes: overflow accounting)

    Lane assignment is scatter- and sort-free in the expensive dimension:
    a component's
    representative cell is its own label ("root"); roots are ranked in
    raster order by a cumsum into KR >= K internal lanes, their sizes are
    counted with one (KR, P) masked reduction, and the final K lanes are
    the top-K *by size* of those KR scalars (a tiny KR-length top_k, not a
    P-length sort) — so small clutter components ahead of a marker in
    raster order cannot exhaust the marker's lane (the reference candidate
    list is unbounded, aruco.rs:124-166).  Components beyond the KR
    ranking pool are not size-prioritized but still counted in
    ``qualifying`` for overflow accounting.
    """
    hc, wc = labels.shape
    p = hc * wc
    k = params.max_candidates if k is None else k
    # Size-ranking pool: scale with the grid — a noisy 1080p-scale dark
    # field legitimately yields several hundred >=min-size components
    # and the markers' raster rank can exceed a fixed small pool
    # (measured 652 qualifying in one dark scene; the reference list is
    # unbounded, aruco.rs:124-166).
    kr = max(k, min(p, max(4 * k, 64, min(p // 16, 1024))))
    flat = labels.reshape(-1)
    idx = jnp.arange(p, dtype=jnp.int32)

    is_root = flat == idx  # white cells carry the sentinel p, never a root
    # Pool admission: exclude components that can never pass the
    # min-size gate.  At 1080p-scale grids a noisy dark field yields
    # 1000+ one/two-cell speck components which exhaust the KR
    # raster-ranked pool before the markers are reached (the reference
    # candidate list is unbounded, aruco.rs:124-166; measured 8/50
    # dark+nested misses at 1080p from exactly this).  Exact local
    # test over the MINIMAL offset set (ADMIT_OFFSETS): cnt >= t there
    # iff the component has >= t cells.  Wrap-around roll hits can only
    # be the same component (labels are root indices), so they never
    # admit an undersized one.
    t = min(int(params.min_component_px), 3)
    if t > 1:
        cnt = jnp.zeros((hc, wc), jnp.int32)
        for dy, dx in ADMIT_OFFSETS[t]:
            sh = jnp.roll(jnp.roll(labels, -dy, 0), -dx, 1)
            cnt = cnt + (sh == labels).astype(jnp.int32)
        is_root = is_root & (cnt.reshape(-1) >= t - 1)
    rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    lane_r = jnp.where(is_root & (rank < kr), rank, kr)
    onehot_r = lane_r[None, :] == jnp.arange(kr, dtype=jnp.int32)[:, None]
    roots_r = jnp.sum(jnp.where(onehot_r, idx[None, :], 0), axis=-1)  # (KR,)
    n_roots = jnp.sum(is_root.astype(jnp.int32))
    used_r = jnp.arange(kr) < n_roots
    qualifying = n_roots

    # Sizes over the ranking pool, then keep the K largest components.
    member_r = (flat[None, :] == roots_r[:, None]) & used_r[:, None]
    sizes_r = jnp.sum(member_r.astype(jnp.int32), axis=-1)  # (KR,)
    sizes, sel = jax.lax.top_k(jnp.where(used_r, sizes_r, -1), k)
    roots = jnp.take(roots_r, sel)
    lane_used = sizes >= 0

    # (K, P) membership masks for the selected components.
    member = (flat[None, :] == roots[:, None]) & lane_used[:, None]
    sizes = jnp.maximum(sizes, 0)
    valid = sizes >= params.min_component_px

    # Full-res coordinates of coarse cell centers.
    ii = jnp.arange(p, dtype=jnp.int32)
    cy = (ii // wc).astype(jnp.float32) * ds + (ds - 1) * 0.5
    cx = (ii % wc).astype(jnp.float32) * ds + (ds - 1) * 0.5

    szf = jnp.maximum(sizes.astype(jnp.float32), 1.0)
    cenx = jnp.sum(jnp.where(member, cx[None, :], 0.0), axis=-1) / szf
    ceny = jnp.sum(jnp.where(member, cy[None, :], 0.0), axis=-1) / szf

    # Corner A: farthest from centroid.
    d2c = (cx[None, :] - cenx[:, None]) ** 2 + (cy[None, :] - ceny[:, None]) ** 2
    ia = _masked_argmax(d2c, member)
    ax, ay = cx[ia], cy[ia]

    # Corner C: farthest from A.
    d2a = (cx[None, :] - ax[:, None]) ** 2 + (cy[None, :] - ay[:, None]) ** 2
    ic = _masked_argmax(d2a, member)
    qcx, qcy = cx[ic], cy[ic]

    # Corners B, D: extremes on either side of diagonal A-C.
    dx = qcx - ax
    dy = qcy - ay
    cross = (cx[None, :] - ax[:, None]) * dy[:, None] - (
        cy[None, :] - ay[:, None]
    ) * dx[:, None]
    ib = _masked_argmax(cross, member)
    idd = _masked_argmax(-cross, member)
    bx, by = cx[ib], cy[ib]
    ddx, ddy = cx[idd], cy[idd]

    quads = jnp.stack(
        [
            jnp.stack([ax, ay], axis=-1),
            jnp.stack([bx, by], axis=-1),
            jnp.stack([qcx, qcy], axis=-1),
            jnp.stack([ddx, ddy], axis=-1),
        ],
        axis=-2,
    )  # (K, 4, 2)

    # Containment: fraction of component pixels inside the fitted quad.
    px = cx[None, :]
    py = cy[None, :]
    slack = params.containment_slack * ds
    # Signed edge distances with consistent polygon orientation.
    e_from = quads  # (K, 4, 2)
    e_to = jnp.roll(quads, -1, axis=-2)
    ex = e_to[..., 0] - e_from[..., 0]  # (K, 4)
    ey = e_to[..., 1] - e_from[..., 1]
    elen = jnp.sqrt(ex * ex + ey * ey) + 1e-6
    # area sign (y-down): positive for one orientation
    area2 = jnp.sum(
        e_from[..., 0] * e_to[..., 1] - e_to[..., 0] * e_from[..., 1],
        axis=-1,
    )
    sgn = jnp.where(area2 >= 0, 1.0, -1.0)
    # Signed distance of pixel to edge line: z = ex*dy - ey*dx (positive on
    # the interior side for shoelace-positive orientation), in the EXPANDED
    # per-edge form py*a - px*b + c0 with the shoelace sign folded into the
    # scalar coefficients.  Accumulate the inside mask edge by edge rather
    # than materializing a (K, 4, P) tensor.
    av = sgn[:, None] * ex  # (K, 4)
    bv = sgn[:, None] * ey
    c0 = bv * e_from[..., 0] - av * e_from[..., 1]
    # The per-edge constant folds into the compare's SCALAR side (one
    # plane op per edge fewer).
    rhs = -slack * elen - c0  # (K, 4)
    inside = None
    for e in range(4):
        cmp = (
            py * av[:, e, None] - px * bv[:, e, None]
            >= rhs[:, e, None]
        )
        inside = cmp if inside is None else inside & cmp
    frac = jnp.sum(jnp.where(member & inside, 1.0, 0.0), axis=-1) / szf
    valid = valid & (frac >= params.min_containment)

    return {
        "quads": quads,
        "valid": valid,
        "roots": roots,
        "centroids": jnp.stack([cenx, ceny], axis=-1),
        "sizes": sizes,
        "qualifying": qualifying,
    }


# --------------------------------------------------------------------------
# Full-resolution corner refinement
# --------------------------------------------------------------------------
def refine_corners(
    black: jnp.ndarray,
    quads: jnp.ndarray,
    centroids: jnp.ndarray,
    ds: int,
    window: int,
    grey: jnp.ndarray | None = None,
    inner_coarse: jnp.ndarray | None = None,
    is_inner: jnp.ndarray | None = None,
):
    """Snap each coarse corner to the extreme full-res marker-ink pixel.

    For corner q with component centroid c, the refined corner is the ink
    pixel p within Chebyshev distance ds+2 of q maximising dot(p, q - c).
    The clamp radius equals one pooling quantum — the true corner cannot be
    farther from the coarse corner than that, so anything beyond is another
    structure.  Falls back to the coarse corner when the window holds no
    valid pixel.  Gather-free: dynamic_slice windows + vector reductions.

    "Ink" definition: the opened black mask erodes true corners by the
    opening radius (~2 px inward bias), so when ``grey`` is given, a pixel
    counts as ink if it is darker than its window's mean (a local re-
    threshold) AND lies within 2 px of the opened component — recovering
    the eroded corner tip while still rejecting detached noise.

    Inner-pass lanes (markers inside dark regions): ``inner_coarse`` is the
    coarse footprint of inner components and ``is_inner`` flags the lanes
    that came from the inner pass.  Their ink is additionally restricted to
    that footprint so a corner cannot snap onto the surrounding dark
    background across the quiet zone.
    """
    h, w = black.shape
    wn = window
    clamp_r = ds + 2

    dirs = quads - centroids[:, None, :]  # (K, 4, 2)
    dirs = dirs / (jnp.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-6)

    # Window top-left per (k, corner), clipped so slices stay in bounds.
    tlx = jnp.clip(
        jnp.round(quads[..., 0]).astype(jnp.int32) - wn // 2, 0, max(w - wn, 0)
    )
    tly = jnp.clip(
        jnp.round(quads[..., 1]).astype(jnp.int32) - wn // 2, 0, max(h - wn, 0)
    )

    oy, ox = jnp.meshgrid(
        jnp.arange(wn, dtype=jnp.int32),
        jnp.arange(wn, dtype=jnp.int32),
        indexing="ij",
    )

    # Dilate the opened mask once globally (fused dense passes) and pack it
    # with the grey plane into one int32 image so each corner needs a
    # single dynamic_slice (slices dominate this stage's cost).  Bit 8 =
    # near any opened black; bit 9 = near black within the inner footprint.
    if grey is not None:
        black_near = _dilate3(_dilate3(black))
        packed = grey.astype(jnp.int32) | (
            black_near.astype(jnp.int32) << 8
        )
    else:
        black_near = black
        packed = black.astype(jnp.int32) << 8
    if inner_coarse is not None:
        up = jnp.repeat(jnp.repeat(inner_coarse, ds, axis=0), ds, axis=1)
        up = up[:h, :w]
        packed = packed | ((black_near & up).astype(jnp.int32) << 9)
        bits = jnp.where(is_inner, jnp.int32(9), jnp.int32(8))
    else:
        bits = jnp.full((quads.shape[0],), 8, dtype=jnp.int32)
    bits = jnp.broadcast_to(bits[:, None], quads.shape[:2])  # (K, 4)

    def one(tlx_, tly_, dir_, corner_, bit_):
        win = jax.lax.dynamic_slice(packed, (tly_, tlx_), (wn, wn))
        near = ((win >> bit_) & 1) == 1
        if grey is not None:
            g = (win & 255).astype(jnp.float32)
            dark = g < jnp.mean(g)
            ink = dark & near
        else:
            ink = near
        xx = (tlx_ + ox).astype(jnp.float32)
        yy = (tly_ + oy).astype(jnp.float32)
        near_corner = (jnp.abs(xx - corner_[0]) <= clamp_r) & (
            jnp.abs(yy - corner_[1]) <= clamp_r
        )
        ok = ink & near_corner
        score = xx * dir_[0] + yy * dir_[1]
        score = jnp.where(ok, score, -jnp.inf)
        best = jnp.argmax(score.reshape(-1))
        has = jnp.any(ok)
        bx = (tlx_ + best % wn).astype(jnp.float32)
        by = (tly_ + best // wn).astype(jnp.float32)
        return bx, by, has

    one_v = jax.vmap(
        jax.vmap(one, in_axes=(0, 0, 0, 0, 0)), in_axes=(0, 0, 0, 0, 0)
    )
    bx, by, has = one_v(tlx, tly, dirs, quads, bits)
    refined = jnp.stack([bx, by], axis=-1)
    return jnp.where(has[..., None], refined, quads)


# --------------------------------------------------------------------------
# Geometry filters (reference semantics)
# --------------------------------------------------------------------------
def enforce_clockwise(quads: jnp.ndarray) -> jnp.ndarray:
    """Swap corners 1 and 3 when the quad is counter-clockwise in y-down
    screen space (reference aruco.rs:168-185)."""
    d1 = quads[..., 1, :] - quads[..., 0, :]
    d2 = quads[..., 2, :] - quads[..., 0, :]
    cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    swapped = quads[..., jnp.array([0, 3, 2, 1]), :]
    return jnp.where((cross < 0)[..., None, None], swapped, quads)


def min_edge_gate(quads: jnp.ndarray, min_edge_length: float) -> jnp.ndarray:
    """Reference quirk reproduced: the *squared* minimum edge length is
    compared against the *linear* threshold (aruco.rs:149-156)."""
    nxt = jnp.roll(quads, -1, axis=-2)
    d = nxt - quads
    edge_sq = jnp.sum(d * d, axis=-1)  # (K, 4)
    return jnp.min(edge_sq, axis=-1) >= min_edge_length


def perimeter(quads: jnp.ndarray) -> jnp.ndarray:
    """Quad perimeter (reference aruco.rs:328-338)."""
    nxt = jnp.roll(quads, -1, axis=-2)
    return jnp.sum(
        jnp.linalg.norm(nxt - quads, axis=-1), axis=-1
    )


def discard_too_near(
    quads: jnp.ndarray, valid: jnp.ndarray, min_distance: float
) -> jnp.ndarray:
    """Suppress near-duplicate quads, keeping the larger perimeter.

    Semantics of reference aruco.rs:187-232 — two quads are duplicates
    when the mean corner distance is below min_distance — except the
    distance is the minimum over cyclic corner shifts: the reference
    compares index-aligned corners only and TODOs the rotated case
    (aruco.rs:189-190), but here the outer (filled) and inner (hole
    border) passes can fit the same marker with different corner
    orderings, and those duplicates must collapse.  The parallel rule
    drops a quad iff some *larger* (or equal-but-earlier) valid
    near-duplicate exists, which resolves chains in one pass instead of
    the reference's order-dependent scan.
    """
    mean_d = None
    for r in range(4):
        rolled = jnp.roll(quads, r, axis=-2)
        diff = rolled[:, None, :, :] - quads[None, :, :, :]  # (K, K, 4, 2)
        d = jnp.mean(jnp.linalg.norm(diff, axis=-1), axis=-1)  # (K, K)
        mean_d = d if mean_d is None else jnp.minimum(mean_d, d)
    peri = perimeter(quads)
    k = quads.shape[0]
    ii = jnp.arange(k)
    near = (mean_d < min_distance) & valid[:, None] & valid[None, :]
    near = near & (ii[:, None] != ii[None, :])
    bigger = (peri[:, None] > peri[None, :]) | (
        (peri[:, None] == peri[None, :]) & (ii[:, None] < ii[None, :])
    )
    killed = jnp.any(near & bigger, axis=0)  # axis 0: does a bigger i kill j?
    return valid & ~killed


# --------------------------------------------------------------------------
# End-to-end quad extraction
# --------------------------------------------------------------------------
def extract_candidates(coarse: jnp.ndarray, params: QuadParams, ds: int):
    """Coarse mask -> merged fixed-capacity candidates (pre-refinement).

    Two nesting levels are extracted, mirroring the reference's Suzuki-Abe
    outer+hole border following (aruco.rs:64):
      * outer pass: black components after removing border-connected black
        (the background when the scene itself is dark), hole-filled so CCL
        converges in O(1) rounds;
      * inner pass: black components *inside the filled holes* of outer
        components — a marker ring enclosed by a dark region (dark
        background halo, nested markers on a dark plate).
    Candidates merge into the K output lanes with outer-pass priority;
    every component that finds no lane is counted into ``overflow`` (the
    reference's candidate list is unbounded, aruco.rs:124-166 — capacity
    loss must be observable).
    """
    labels, labels2 = label_planes(coarse, params)
    return candidates_from_labels(labels, labels2, params, ds)


def label_planes(coarse: jnp.ndarray, params: QuadParams):
    """Outer + inner label planes for one coarse mask."""
    # Outer pass: plain hole fill + CCL over ALL black.  Border-connected
    # black stays in (markers clipped at the image edge keep their — open,
    # unfilled — ring and are still fitted, like the reference's clipped
    # contours); on a dark scene this pass yields one useless
    # merged blob and the inner pass below recovers the markers.
    filled1 = fill_holes(coarse, params.fill_rounds)
    labels = label_components(filled1, params.ccl_rounds)

    if params.max_inner_candidates > 0:
        # Inner pass: non-border-connected black components — the direct
        # analogue of the reference's per-component hole borders.  This
        # recovers marker rings the outer pass merged away (dark
        # backgrounds — flat or noisy — and nested markers).
        #
        # DEPTH PEELING: labelling an UNFILLED rotated ring by label
        # propagation needs O(perimeter) rounds (labels crawl the ring's
        # staircase — measured: a 90-cell 30deg ring is still 10
        # fragments after 12 rounds).  Instead, peel nesting levels:
        # grow the known-outside white inward one level at a time,
        # extract the components adjacent to it (a flood that only
        # crosses the ring BAND, converging in ~2 rounds at any size or
        # angle), and label each level on its hole-FILLED plane (solid
        # blobs converge in O(1)).  The filled blob's minimum linear
        # index is its topmost-leftmost cell, which lies ON the ring, so
        # restricting labels back to ring cells preserves the
        # fit_quads root convention (label == own index).
        hc, wc = coarse.shape
        sent = jnp.int32(hc * wc)
        white = ~coarse
        bg = flood_from_border(coarse, params.bg_rounds, diag=False)
        m2 = coarse & ~bg
        # Known-outside white: border-reachable white plus white adjacent
        # to the removed background (dark-background scenes).
        border = jnp.zeros_like(white)
        border = border.at[0, :].set(True)
        border = border.at[-1, :].set(True)
        border = border.at[:, 0].set(True)
        border = border.at[:, -1].set(True)
        seed0 = (border | _dilate3(bg)) & white
        known = flood(white, seed0, params.fill_rounds)
        # fori_loop over depths (the XLA CPU compiler chokes on the
        # unrolled program late in long test runs).  The final
        # iteration's known-grow is
        # dead (known is not read afterwards), so looping it
        # unconditionally preserves semantics exactly.
        def peel(_, carry):
            # Runtime-skip exhausted depths (deeper levels exist only for
            # nested markers): an empty `remaining` makes the body an
            # exact no-op, so the skip never changes the labels.
            return jax.lax.cond(
                jnp.any(carry[1]), _peel_body, lambda c: c, carry
            )

        def _peel_body(carry):
            labels2, remaining, known = carry
            level = flood(
                remaining,
                remaining & _dilate3(known),
                params.inner_flood_rounds,
                diag=False,
            )
            # Enclosure fill: cells unreachable from the known outside
            # through non-level cells = the level components + their
            # interiors (solid).
            notlev = ~level
            reach_o = flood(
                notlev, known & notlev, params.inner_fill_rounds
            )
            lab = label_components(~reach_o, params.inner_ccl_rounds)
            labels2 = jnp.where(level, lab, labels2)
            remaining = remaining & ~level
            known = flood(
                white,
                known | (_dilate3(level) & white),
                params.inner_flood_rounds,
            )
            return labels2, remaining, known

        # DEPTH 0 normally needs no enclosure fill + CCL of its own: a
        # level-0 component's hole-filled plane is its pass-1 filled
        # blob, and segmented label propagation depends only on the
        # component's own cell set (mask runs never span two
        # components), so depth-0 labels equal the pass-1 labels
        # restricted to the level cells — including the root convention
        # (the filled blob's raster-min cell).  The ONE exception: a
        # component inside a filled hole of a *border-connected* blob
        # (a closed black band touching the border, thin enough to
        # survive the opening) merges with that blob in pass 1, so its
        # pass-1 root lies on the bg band — outside the level cells —
        # and the component would never rank as a root.  Gate the reuse
        # per blob: a level cell may reuse its pass-1 label only if it
        # is filled-blob-connected (4-conn flood, same connectivity as
        # the pass-1 CCL) to a properly-rooted root (a level-0 cell
        # that is its own pass-1 root); unreached level cells stay in
        # ``remaining`` and the next peel depth labels them exactly
        # (they are already adjacent to known white, so depth 1's
        # enclosure fill — which floods THROUGH bg cells — recovers
        # their own root).  Under-convergence of the ok-flood can only
        # defer, never mislabel.  Pocket-merged level-0 twins (two
        # components sealing a white pocket) reuse one shared root,
        # exactly what the previous per-depth enclosure fill produced.
        level0 = flood(
            m2, m2 & _dilate3(known), params.inner_flood_rounds,
            diag=False,
        )
        hcwc_idx = jnp.arange(labels.size, dtype=jnp.int32).reshape(
            labels.shape
        )
        # ccl_rounds suffices: flooding a filled blob from its root
        # converges like the CCL on the same plane, and
        # under-convergence only defers (exact).
        roots_ok = level0 & (labels == hcwc_idx)
        ok = level0 & flood(
            filled1, roots_ok, params.ccl_rounds, diag=False
        )
        labels2 = jnp.where(ok, labels, sent)
        remaining = m2 & ~ok
        known = flood(
            white,
            known | (_dilate3(level0) & white),
            params.inner_flood_rounds,
        )
        labels2, _, _ = jax.lax.fori_loop(
            1,
            params.inner_depths,
            peel,
            (labels2, remaining, known),
        )
    else:
        labels2 = jnp.full_like(labels, labels.size)
    return labels, labels2


def candidates_from_labels(
    labels: jnp.ndarray, labels2: jnp.ndarray, params: QuadParams, ds: int
):
    """Fit + merge the outer/inner label planes into K candidate lanes."""
    k1 = params.max_candidates
    k2 = params.max_inner_candidates
    fit = fit_quads(labels, ds, params, k=k1)
    fit2 = (
        fit_quads(labels2, ds, params, k=k2) if k2 > 0 else None
    )
    return merge_fits(labels, labels2, fit, fit2, params, ds)


def merge_fits(
    labels: jnp.ndarray,
    labels2: jnp.ndarray,
    fit: dict,
    fit2: dict | None,
    params: QuadParams,
    ds: int,
):
    """Merge the outer/inner fits into K candidate lanes (size priority,
    outer winning ties, same-marker inner duplicates suppressed)."""
    k1 = params.max_candidates
    k2 = params.max_inner_candidates

    overflow = jnp.maximum(fit["qualifying"] - k1, 0)

    if k2 > 0:
        overflow = overflow + jnp.maximum(fit2["qualifying"] - k2, 0)

        # Every free-standing marker ring is also a non-border-connected
        # component, so pass 2 re-fits what pass 1 already holds.  Kill
        # those duplicates BEFORE the merge so the freed lanes go to real
        # candidates.  Same-component fits agree within the
        # pooling quantum (cyclic-min Chebyshev corner distance <= 2*ds),
        # while a genuinely nested marker that could survive the min-edge
        # gate (side >= 0.05*min(h,w) for its INNER marker, so >= 3x that
        # for the outer) sits far beyond it at the auto coarse factor
        # (2*ds ~ 0.01*min(h,w)).  The post-refine near-duplicate gate in
        # finalize_quads still runs for everything that survives.
        best = jnp.full((k2, k1), jnp.inf)
        for s in range(4):
            q2s = jnp.roll(fit2["quads"], s, axis=1)
            dist = jnp.abs(
                q2s[:, None] - fit["quads"][None]
            ).max(axis=(2, 3))
            best = jnp.minimum(best, dist)
        dup = (best <= INNER_DUP_CHEBYSHEV_DS * ds) & fit["valid"][None, :]
        # Exact-twin rule: a free-standing marker's hole-filled ring is
        # the SAME cell set in both passes, so its inner re-fit shares
        # the outer lane's (root, size) — root is the raster-min member
        # and both planes index the same cropped linear space.  Equal
        # sets fit identical quads, so the Chebyshev rule above would
        # kill these anyway; the (root, size) test also catches twins
        # whose quads were never compared.
        twin = (
            (fit2["roots"][:, None] == fit["roots"][None, :])
            & (fit2["sizes"][:, None] == fit["sizes"][None, :])
            & fit["valid"][None, :]
        )
        fit2["valid"] = fit2["valid"] & ~jnp.any(dup | twin, axis=1)

        # Merge to K lanes by SIZE priority across both passes, outer
        # winning exact ties.  Strict outer-pass priority starved dark
        # scenes: a noisy dark field yields 30+ tiny valid outer noise
        # components which consumed every lane while the inner pass held
        # the (only) correct marker fit — measured 3/67 dark-family
        # parity misses at 320x240 from exactly this.  Size priority is
        # safe now that same-marker inner duplicates die before the
        # merge: surviving inner lanes are genuine hole-border
        # candidates, and any real marker dwarfs noise specks.
        cat = lambda a, b: jnp.concatenate([a, b], axis=0)  # noqa: E731
        quads_c = cat(fit["quads"], fit2["quads"])
        valid_c = cat(fit["valid"], fit2["valid"])
        sizes_c = cat(fit["sizes"], fit2["sizes"])
        cents_c = cat(fit["centroids"], fit2["centroids"])
        prio = jnp.concatenate(
            [
                jnp.ones((k1,), dtype=jnp.int32),
                jnp.zeros((k2,), dtype=jnp.int32),
            ]
        )
        key = jnp.where(valid_c, sizes_c * 2 + prio + 1, 0)
        _, sel = jax.lax.top_k(key, k1)
        quads = jnp.take(quads_c, sel, axis=0)
        valid = jnp.take(valid_c, sel, axis=0)
        sizes = jnp.take(sizes_c, sel, axis=0)
        centroids = jnp.take(cents_c, sel, axis=0)
        is_inner = sel >= k1
        filled2 = labels2 < labels2.size  # sentinel == grid size
        inner_coarse = _dilate3(filled2)
        n_valid = jnp.sum(valid_c.astype(jnp.int32))
        overflow = overflow + jnp.maximum(
            n_valid - jnp.sum(valid.astype(jnp.int32)), 0
        )
    else:
        quads, valid = fit["quads"], fit["valid"]
        sizes, centroids = fit["sizes"], fit["centroids"]
        is_inner = jnp.zeros(quads.shape[0], dtype=bool)
        inner_coarse = jnp.zeros(labels.shape, dtype=bool)

    return {
        "quads": quads,
        "valid": valid,
        "sizes": sizes,
        "centroids": centroids,
        "is_inner": is_inner,
        "inner_coarse": inner_coarse,
        "labels": labels,
        "overflow": overflow,
    }


def refine_window_size(params: QuadParams, ds: int) -> int:
    return params.refine_window or min(64, max(12, 2 * ds + 8))


def finalize_quads(
    quads: jnp.ndarray,
    valid: jnp.ndarray,
    sizes: jnp.ndarray,
    overflow: jnp.ndarray,
    params: QuadParams,
    min_edge_length: float,
    min_corner_separation: float,
):
    """Post-refinement geometry gates + the per-stage rejection counters
    the reference prints in debug builds (aruco.rs:125-127,163-164), as
    device scalars so they survive jit without host round-trips."""
    quads = enforce_clockwise(quads)
    v_size = sizes >= params.min_component_px
    v_contain = valid  # size gate & containment combined in fit_quads
    edge_ok = min_edge_gate(quads, min_edge_length)
    valid = valid & edge_ok
    v_before_near = valid
    valid = discard_too_near(quads, valid, min_corner_separation)

    count = lambda m: jnp.sum(m.astype(jnp.int32))  # noqa: E731
    stats = {
        "components": count(v_size),
        "components_overflow": overflow,
        "reject_containment": count(v_size & ~v_contain),
        "reject_edge_length": count(v_contain & ~edge_ok),
        "reject_too_near": count(v_before_near & ~valid),
        "candidates": count(valid),
    }
    return quads, valid, stats


def find_quads_from_masks(
    black: jnp.ndarray,
    coarse: jnp.ndarray,
    params: QuadParams,
    min_edge_length: float,
    min_corner_separation: float,
    ds: int,
    grey: jnp.ndarray | None = None,
):
    """(black full-res, coarse pooled) masks -> fixed-capacity quads.

    The masks come from the frontend (open_mask + pool_black).
    """
    cand = extract_candidates(coarse, params, ds)
    quads = cand["quads"]

    if params.refine and ds > 1:
        window = refine_window_size(params, ds)
        quads = refine_corners(
            black,
            quads,
            cand["centroids"],
            ds,
            window,
            grey=grey,
            inner_coarse=cand["inner_coarse"],
            is_inner=cand["is_inner"],
        )

    quads, valid, stats = finalize_quads(
        quads,
        cand["valid"],
        cand["sizes"],
        cand["overflow"],
        params,
        min_edge_length,
        min_corner_separation,
    )
    return {
        "quads": quads,
        "valid": valid,
        "labels": cand["labels"],
        "coarse_factor": ds,
        "sizes": cand["sizes"],
        "stats": stats,
    }


def find_quads(
    white: jnp.ndarray,
    params: QuadParams,
    min_edge_length: float,
    min_corner_separation: float,
    coarse_factor: int | None = None,
):
    """Thresholded white mask -> fixed-capacity candidate quads.

    white: (H, W) bool adaptive-threshold output (True = foreground).
    Returns dict: quads (K, 4, 2) float32 clockwise corners, valid (K,) bool.
    """
    h, w = white.shape
    ds = coarse_factor or choose_coarse_factor(h, w)
    black = open_mask(~white, params.open_radius)
    coarse = pool_black(black, ds)
    return find_quads_from_masks(
        black, coarse, params, min_edge_length, min_corner_separation, ds
    )
