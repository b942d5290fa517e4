"""Perspective rectification and code-bit decoding, batched over candidates.

Capability parity (vs reference src/aruco.rs):
  * ``extract_homographies``: 4-point projection + bilinear warp of each
    candidate quad into an SxS gray patch (aruco.rs:234-261; S=49 default).
    Warp convention matches imageproc ``warp_into``: output pixel (x, y)
    samples the source at H_patch->image (x, y), out-of-bounds reads the
    black default.
  * ``homography_to_code_permutations``: per-patch Otsu binarization
    (aruco.rs:264-265), Triangle-filter resize to mark_size (aruco.rs:273),
    bit = value > 127 (aruco.rs:283), all-black border gate
    (aruco.rs:288-292), and the MSB-first inner-grid read with 3 extra 90°
    CCW rotations (aruco.rs:296-326).

Design: every candidate is a lane in a fixed-capacity batch.  The warp
samples a per-candidate pyramid window with separable bilinear weight
matmuls; Otsu histograms are a one-hot outer product; the Triangle resize
is two small matmuls (L @ patch @ L^T); rotations are static jnp.rot90
views.
Invalid lanes (masked candidates, failed border gates) are carried as
validity masks — no dynamic shapes anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------
# Homography from control points (patch square -> image quad)
# --------------------------------------------------------------------------
def homography_square_to_quad(
    quads: jnp.ndarray, patch_size: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """DLT homographies mapping the patch square to each image quad.

    quads: (..., 4, 2) float (x, y) image corners, clockwise from top-left.
    The square control points are (0,0), (s,0), (s,s), (0,s) with
    s = patch_size, matching reference aruco.rs:244-247.

    Returns (H (..., 3, 3), valid (...,)) — invalid when the DLT system is
    singular (degenerate quad), mirroring the reference's projection-failure
    fallback (aruco.rs:250-256).
    """
    q = jnp.asarray(quads, dtype=jnp.float32)
    batch = q.shape[:-2]
    s = float(patch_size)

    # Closed form for unit-square -> quad (then compose the 1/s scale):
    # the projective-interpolation construction (same approach as the
    # reference's fully expanded homography, pose.rs:95-123) — ~20 flops
    # per quad instead of a batched 8x8 LU solve.
    u0, u1, u2, u3 = (q[..., i, 0] for i in range(4))
    v0, v1, v2, v3 = (q[..., i, 1] for i in range(4))
    d1u = u1 - u2
    d1v = v1 - v2
    d2u = u3 - u2
    d2v = v3 - v2
    su = u0 - u1 + u2 - u3
    sv = v0 - v1 + v2 - v3
    den = d1u * d2v - d2u * d1v
    valid = jnp.abs(den) > 1e-12
    den_safe = jnp.where(valid, den, 1.0)
    g = (su * d2v - sv * d2u) / den_safe  # a31 (unit square)
    hh = (d1u * sv - d1v * su) / den_safe  # a32
    a11 = u1 - u0 + g * u1
    a12 = u3 - u0 + hh * u3
    a13 = u0
    a21 = v1 - v0 + g * v1
    a22 = v3 - v0 + hh * v3
    a23 = v0
    inv_s = jnp.float32(1.0 / s)
    H = jnp.stack(
        [
            jnp.stack([a11 * inv_s, a12 * inv_s, a13], axis=-1),
            jnp.stack([a21 * inv_s, a22 * inv_s, a23], axis=-1),
            jnp.stack([g * inv_s, hh * inv_s, jnp.ones_like(g)], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3)
    finite = jnp.isfinite(H).all((-2, -1))
    valid = valid & finite
    H = jnp.where(
        valid[..., None, None], H, jnp.eye(3, dtype=jnp.float32)
    )
    return H, valid


# --------------------------------------------------------------------------
# Bilinear patch warp — matmul path (pyramid + window slice + weight matmul)
# --------------------------------------------------------------------------
_WARP_WIN = 64  # window side; markers bigger than ~60px/level go up a level


def build_pyramid(grey: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """2x2 box-mean image pyramid, float32, every level padded to >=64.

    Level l pixel (i, j) covers image pixels [i*2^l, (i+1)*2^l); its center
    sits at image coord (i + 0.5) * 2^l - 0.5.
    """
    out = []
    img = grey.astype(jnp.float32)
    for _ in range(levels):
        h, w = img.shape
        # Pad to even BEFORE clamping to the window: max(odd<64, 64)+1
        # would yield an odd padded size and break the 2x2 reshape below.
        ph = max(h + (h % 2), _WARP_WIN)
        pw = max(w + (w % 2), _WARP_WIN)
        padded = jnp.pad(img, ((0, ph - h), (0, pw - w)))
        out.append(padded)
        img = (
            padded.reshape(ph // 2, 2, pw // 2, 2).sum(axis=(1, 3)) * 0.25
        )
    return out


def _warp_setup(
    pyramid: list[jnp.ndarray],
    H: jnp.ndarray,
    quads: jnp.ndarray,
    patch_size: int,
):
    """Select per-candidate pyramid windows + window-space sample coords.

    Returns (windows (K, win, win) f32, ux (K, S2), uy (K, S2),
    bad (K, S2) bool).
    """
    levels = len(pyramid)
    s = patch_size
    k = H.shape[0]
    win = _WARP_WIN

    # Patch-grid sample coords in image space.
    ys, xs = jnp.meshgrid(
        jnp.arange(s, dtype=jnp.float32),
        jnp.arange(s, dtype=jnp.float32),
        indexing="ij",
    )
    pix = jnp.stack(
        [xs, ys, jnp.ones_like(xs)], axis=-1
    ).reshape(-1, 3)  # (S2, 3)
    src = jnp.einsum("kij,pj->kpi", H, pix, precision=_HIGHEST)
    wdiv = src[..., 2]
    wsafe = jnp.where(jnp.abs(wdiv) < 1e-12, 1.0, wdiv)
    sx = src[..., 0] / wsafe  # (K, S2) image-space x
    sy = src[..., 1] / wsafe
    bad = jnp.abs(wdiv) < 1e-12

    # Level selection from the quad bbox (margin for refinement jitter).
    bmin = jnp.min(quads, axis=-2)  # (K, 2)
    bmax = jnp.max(quads, axis=-2)
    side = jnp.max(bmax - bmin, axis=-1) + 4.0  # (K,)
    lvl = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(side / (win - 4.0), 1e-3))),
        0,
        levels - 1,
    ).astype(jnp.int32)
    center = (bmin + bmax) * 0.5  # (K, 2) image coords

    # Pack all levels into ONE row-concatenated buffer so each candidate
    # needs a single dynamic_slice instead of K*L window slices (the pack
    # itself is one ~1.33x-frame-size copy).  Right-padding with
    # zeros matches the out-of-image black default.
    w0 = pyramid[0].shape[1]
    padded = [
        img
        if img.shape[1] == w0
        else jnp.pad(img, ((0, 0), (0, w0 - img.shape[1])))
        for img in pyramid
    ]
    packed = jnp.concatenate(padded, axis=0)
    offsets = np.cumsum([0] + [img.shape[0] for img in pyramid]).tolist()

    # Per-level top-left / sample coords are cheap (K,)/(K, S2) arithmetic;
    # only the WINDOW slice (the expensive part) happens once, post-select.
    all_tlx, all_tly, all_ux, all_uy = [], [], [], []
    for level in range(levels):
        hl, wl = pyramid[level].shape
        scale = float(2**level)
        cl = (center + 0.5) / scale - 0.5  # (K, 2) level coords
        tlx = jnp.clip(
            jnp.round(cl[:, 0]).astype(jnp.int32) - win // 2, 0, wl - win
        )
        tly = jnp.clip(
            jnp.round(cl[:, 1]).astype(jnp.int32) - win // 2, 0, hl - win
        )
        all_ux.append(
            (sx + 0.5) / scale - 0.5 - tlx[:, None].astype(jnp.float32)
        )
        all_uy.append(
            (sy + 0.5) / scale - 0.5 - tly[:, None].astype(jnp.float32)
        )
        all_tlx.append(tlx)
        all_tly.append(tly + offsets[level])

    def sel(stack, zero):
        return sum(
            jnp.where(
                (lvl == level)[:, None] if stack[0].ndim == 2 else lvl == level,
                stack[level],
                zero,
            )
            for level in range(levels)
        )

    tlx = sel(all_tlx, 0)
    tly = sel(all_tly, 0)
    ux = sel(all_ux, 0.0)  # (K, S2)
    uy = sel(all_uy, 0.0)
    windows = jax.vmap(
        lambda ty, tx: jax.lax.dynamic_slice(packed, (ty, tx), (win, win))
    )(tly, tlx)  # (K, win, win)
    return windows, ux, uy, bad


def warp_patches_mxu(
    pyramid: list[jnp.ndarray],
    H: jnp.ndarray,
    quads: jnp.ndarray,
    patch_size: int,
) -> jnp.ndarray:
    """Perspective warp as one small matmul per candidate.

    Per candidate: pick the pyramid level where the quad's bbox fits a
    64x64 window, dynamic-slice that window, and evaluate all S*S bilinear
    samples as T = Wx @ window^T followed by a row-wise weighted sum with
    Wy — the bilinear weights live in two dense (S^2, 64) separable weight
    matrices, so the warp needs no per-sample gather.

    Samples outside the image resolve to 0 (the reference's black default,
    aruco.rs:253): out-of-window coordinates produce all-zero weight rows.
    For quads smaller than the window the warp samples pyramid level 0,
    i.e. it is exactly the reference's bilinear interpolation; larger quads
    sample a box-filtered level, which anti-aliases where the reference
    aliases (documented deviation).
    """
    s = patch_size
    k = H.shape[0]
    win = _WARP_WIN
    jcols = jnp.arange(win, dtype=jnp.float32)
    windows, ux, uy, bad = _warp_setup(pyramid, H, quads, patch_size)

    # Separable bilinear weights: (K, S2, win) each.  bf16 halves the memory
    # traffic of the weight tensors (the matmul itself is tiny); weight
    # quantization error <= 2^-8 on [0,1] is far below the Otsu margin.
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(ux[..., None] - jcols)).astype(
        jnp.bfloat16
    )
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(uy[..., None] - jcols)).astype(
        jnp.bfloat16
    )

    # T[k, s, y] = sum_x wx[k, s, x] * windows[k, y, x].  Keep T in bf16:
    # it is the single largest intermediate (K, S^2, 64) and the weighted
    # row-sum accumulates in f32 anyway.
    t = jnp.einsum(
        "ksx,kyx->ksy",
        wx,
        windows.astype(jnp.bfloat16),
        preferred_element_type=jnp.bfloat16,
    )
    vals = jnp.einsum(
        "ksy,ksy->ks", wy, t, preferred_element_type=jnp.float32
    )  # (K, S2)

    # Out-of-image samples land in the zero padding of the pyramid levels
    # (black, the reference default); degenerate homographies are masked.
    vals = jnp.where(bad, 0.0, vals)
    return vals.reshape(k, s, s)


# --------------------------------------------------------------------------
# Bilinear patch warp — gather path (portable oracle)
# --------------------------------------------------------------------------
def warp_patches(
    grey: jnp.ndarray, H: jnp.ndarray, patch_size: int
) -> jnp.ndarray:
    """Sample SxS patches from ``grey`` through per-candidate homographies.

    grey: (Him, Wim) uint8; H: (K, 3, 3) mapping patch coords -> image coords.
    Returns (K, S, S) float32 in [0, 255]; out-of-bounds samples are 0
    (the reference's black default, aruco.rs:253).
    """
    him, wim = grey.shape
    s = patch_size
    ys, xs = jnp.meshgrid(
        jnp.arange(s, dtype=jnp.float32),
        jnp.arange(s, dtype=jnp.float32),
        indexing="ij",
    )
    ones = jnp.ones_like(xs)
    pix = jnp.stack([xs, ys, ones], axis=-1).reshape(-1, 3)  # (S*S, 3)

    src = jnp.einsum(
        "kij,pj->kpi", H, pix, precision=_HIGHEST
    )  # (K, S*S, 3)
    w = src[..., 2]
    wsafe = jnp.where(jnp.abs(w) < 1e-12, 1.0, w)
    sxp = src[..., 0] / wsafe
    syp = src[..., 1] / wsafe

    inb = (
        (sxp >= 0.0)
        & (sxp <= wim - 1.0)
        & (syp >= 0.0)
        & (syp <= him - 1.0)
        & (jnp.abs(w) >= 1e-12)
    )
    x0 = jnp.clip(jnp.floor(sxp), 0, wim - 1)
    y0 = jnp.clip(jnp.floor(syp), 0, him - 1)
    fx = sxp - x0
    fy = syp - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, wim - 1)
    y1i = jnp.minimum(y0i + 1, him - 1)

    g = grey.astype(jnp.float32)
    flat = g.reshape(-1)
    gather = lambda yy, xx: flat[(yy * wim + xx).reshape(-1)].reshape(  # noqa: E731
        yy.shape
    )
    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x1i)
    v10 = gather(y1i, x0i)
    v11 = gather(y1i, x1i)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    vals = top * (1.0 - fy) + bot * fy
    vals = jnp.where(inb, vals, 0.0)
    return vals.reshape(H.shape[0], s, s)


# --------------------------------------------------------------------------
# Otsu threshold per patch
# --------------------------------------------------------------------------
def otsu_level(patches: jnp.ndarray) -> jnp.ndarray:
    """Per-patch Otsu threshold level (K,), from (K, S, S) values in [0,255].

    Standard between-class-variance maximisation over 256 bins (imageproc
    ``otsu_level`` semantics, used at reference aruco.rs:264); ties resolve
    to the lowest level.
    """
    k = patches.shape[0]
    vals = jnp.clip(jnp.round(patches), 0, 255).astype(jnp.int32)
    vals = vals.reshape(k, -1)
    n = vals.shape[1]
    # Histogram via a hi/lo-nibble outer product: hist[h, l] = #pixels
    # with value h*16+l = <hi one-hot, lo one-hot> contracted over pixels,
    # instead of a (K, S^2, 256) compare-reduce.  Exact: one-hot entries
    # are 0/1 (exact in bf16) and the f32 accumulator sums <= S^2 ones.
    nib = jnp.arange(16, dtype=jnp.int32)
    hi = ((vals[:, :, None] >> 4) == nib).astype(jnp.bfloat16)  # (K, N, 16)
    lo = ((vals[:, :, None] & 15) == nib).astype(jnp.bfloat16)
    hist = jnp.einsum(
        "knh,knl->khl", hi, lo, preferred_element_type=jnp.float32
    ).reshape(k, 256)

    # W (class-0 counts) and M (class-0 value sums) are exact integers
    # in f32 (cumsums of integers < 2^24 do not depend on summation
    # order), and the unnormalized between-class score
    #   f(t) = (MT*W - M*n)^2 / (W*(n - W))  ==  n^2 * sigma_b^2(t)
    # shares its argmax with imageproc's sigma_b^2.  The score itself is
    # rounded f32, not exact, but it is one expression of exact integer
    # inputs, so flat-histogram near-ties (noise windows) resolve the
    # same on every backend; a normalized-float form flips levels on
    # noise plateaus from ~1e-7 relative rounding.
    binsf = jnp.arange(256, dtype=jnp.float32)
    nf = jnp.float32(n)
    w_ = jnp.cumsum(hist, axis=-1)  # class 0 = values <= t
    m_ = jnp.cumsum(hist * binsf, axis=-1)
    mt = m_[:, -1:]
    den = w_ * (nf - w_)
    num = mt * w_ - m_ * nf
    sigma = jnp.where(den > 0.0, (num * num) / den, -1.0)
    return jnp.argmax(sigma, axis=-1).astype(jnp.int32)


# --------------------------------------------------------------------------
# Triangle-filter resize as a matmul
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _triangle_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) row-stochastic Triangle (bilinear) resampling matrix with
    image-crate semantics: centers at (i+0.5), support scaled by the
    downscale ratio, weights normalised per output pixel.

    Crate pin (image 0.25, src/imageops/sample.rs: Triangle filter kernel
    w(t) = max(0, 1-|t|) with support 1.0, evaluated at t = (i+0.5 -
    center)/scale where scale = max(src/dst, 1), weights normalised over
    the clamped support window).  Checkable via
    tests/golden/triangle_resize.json + rust_validation (raw values to
    the crate's u8 rounding; the pipeline's binarized-input bit reads
    exactly)."""
    ratio = src / dst
    scale = max(ratio, 1.0)
    support = 1.0 * scale
    L = np.zeros((dst, src), dtype=np.float32)
    for o in range(dst):
        center = (o + 0.5) * ratio
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        lo = max(lo, 0)
        hi = min(hi, src - 1)
        for i in range(lo, hi + 1):
            t = abs((i + 0.5 - center) / scale)
            w = max(0.0, 1.0 - t)
            L[o, i] = w
        srow = L[o].sum()
        if srow > 0:
            L[o] /= srow
    return L


def resize_triangle(patches: jnp.ndarray, dst: int) -> jnp.ndarray:
    """(K, S, S) -> (K, dst, dst) separable Triangle resize via two matmuls
    (matmul path), matching image::imageops::resize FilterType::Triangle as
    used at reference aruco.rs:273."""
    src = patches.shape[-1]
    L = jnp.asarray(_triangle_resize_matrix(src, dst))
    out = jnp.einsum(
        "oi,kij->koj", L, patches, precision=_HIGHEST
    )
    out = jnp.einsum(
        "koj,pj->kop", out, L, precision=_HIGHEST
    )
    return out


# --------------------------------------------------------------------------
# Bit extraction
# --------------------------------------------------------------------------
def decode_patches(
    patches: jnp.ndarray, mark_size: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Patches -> 4-rotation LSB-indexed bit vectors + border validity.

    patches: (K, S, S) float32 grays in [0, 255].
    Returns:
      bits:  (K, 4, num_bits) int32 in {0, 1}; rotation r is the marker
             grid rotated r*90 degrees CCW (reference aruco.rs:296-326),
             bit i = LSB i of the decoded u64 (MSB-first grid read).
      valid: (K,) bool — False when any border cell is white
             (reference aruco.rs:288-292).
    """
    levels = otsu_level(patches)  # (K,)
    binar = jnp.where(
        patches > levels[:, None, None].astype(jnp.float32), 255.0, 0.0
    )
    reduced = resize_triangle(binar, mark_size)  # (K, m, m)
    grid = reduced > 127.0  # True == white cell (reference aruco.rs:283)
    return _grid_tail(grid, mark_size)


def _grid_tail(
    grid: jnp.ndarray, mark_size: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(K, m, m) bool white-cell grid -> (bits, border valid)."""
    k = grid.shape[0]
    border = jnp.concatenate(
        [
            grid[:, 0, :],
            grid[:, -1, :],
            grid[:, :, 0],
            grid[:, :, -1],
        ],
        axis=-1,
    )
    valid = ~jnp.any(border, axis=-1)

    inner = grid[:, 1:-1, 1:-1]  # (K, m-2, m-2)
    rots = jnp.stack(
        [jnp.rot90(inner, r, axes=(1, 2)) for r in range(4)], axis=1
    )  # (K, 4, m-2, m-2)
    nb = (mark_size - 2) * (mark_size - 2)
    flat = rots.reshape(k, 4, nb)
    # MSB-first read: grid cell p lands at code bit (nb-1-p); our bit
    # vectors are LSB-indexed, so reverse the flattened grid.
    bits = flat[:, :, ::-1].astype(jnp.int32)
    return bits, valid


def bits_to_u32_pairs(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., num_bits) {0,1} -> (..., 2) uint32 (lo, hi) code words."""
    nb = bits.shape[-1]
    idx = np.arange(nb)
    lo_w = jnp.asarray(
        np.where(idx < 32, 1 << (idx % 32), 0).astype(np.uint32)
    )
    hi_w = jnp.asarray(
        np.where(idx >= 32, 1 << (idx % 32), 0).astype(np.uint32)
    )
    b = bits.astype(jnp.uint32)
    lo = jnp.sum(b * lo_w, axis=-1, dtype=jnp.uint32)
    hi = jnp.sum(b * hi_w, axis=-1, dtype=jnp.uint32)
    return jnp.stack([lo, hi], axis=-1)
