"""IPPE (Infinitesimal Plane-based Pose Estimation) — batched.

Recovers the two physically plausible 6-DoF poses of a square fiducial from
its four image corners.  Capability parity with reference src/pose.rs:

  * ``MarkerPose`` {error, rotation, translation} with OpenCV chirality
    (right-handed, +Z forward, +Y down, +X right) and the transform /
    inverse-transform helpers (pose.rs:8-50),
  * ``solve_with_intrinsics`` (pose.rs:52-55),
  * ``solve_with_undistorted_points`` — per-axis normalization by image
    dims, aspect ratio knowingly ignored (pose.rs:59-62),
  * ``solve_with_normalized_points`` — poses ordered by reprojection error
    (pose.rs:64-81).

Design differences from the reference (not a translation):
  * Everything is expressed as batched ``jnp`` linear algebra over an
    arbitrary leading marker axis; the scalar API is a thin wrapper over the
    batch path.
  * The square->image homography is solved as a batched 8x8 DLT system
    (``jnp.linalg.solve``) instead of a hand-expanded cofactor polynomial
    (pose.rs:96-123); results agree to the golden C++ IPPE vectors.
  * The translation least-squares uses an explicit 3x3 normal-equation solve
    rather than unrolled cofactors (pose.rs:269-335).

Golden-value parity is pinned by tests/test_pose.py, which carries the C++
IPPE-derived expected rotations/translations from pose.rs:457-598.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .camera import CameraIntrinsics

_DEGENERATE_EPS = 1e-6  # find_rotation_to_z stability guard (pose.rs:245)
_Z_CLAMP = 1e-5  # reprojection z clamp (pose.rs:342-343)

# All geometry matmuls are tiny (3x3 / 8x8); an accelerator's default
# matmul precision (bf16 or TF32 inputs) is far too coarse for pose
# recovery.  Every dot in this module goes through _mm with full float32
# precision.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(
        a, b, precision=_HIGHEST, preferred_element_type=jnp.float32
    )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["error", "rotation", "translation"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class MarkerPose:
    """Rigid transform placing a canonical marker into the camera frame.

    OpenCV chirality: right-handed, +Z forward, +Y down, +X right
    (reference pose.rs:5-6).  Works as a JAX pytree, so it can carry either
    a single pose (rotation (3,3)) or a batch (rotation (..., 3, 3)).
    """

    error: jnp.ndarray
    rotation: jnp.ndarray
    translation: jnp.ndarray

    @staticmethod
    def default() -> "MarkerPose":
        """Identity pose with sentinel error 1e31 (reference pose.rs:42-50)."""
        return MarkerPose(
            error=jnp.asarray(1e31, dtype=jnp.float32),
            rotation=jnp.eye(3, dtype=jnp.float32),
            translation=jnp.zeros(3, dtype=jnp.float32),
        )

    # point helpers (reference pose.rs:14-39) ------------------------------
    def apply_transform_to_points(self, points):
        """R @ p + t for a list/array of 3-D points."""
        pts = jnp.asarray(points, dtype=self.rotation.dtype)
        return _mm(pts, jnp.swapaxes(self.rotation, -1, -2)) + self.translation[
            ..., None, :
        ]

    def apply_transform_to_vectors(self, vectors):
        return self.apply_transform_to_points(vectors)

    def apply_inverse_transform_to_points(self, points):
        """R^T @ (p - t)."""
        pts = jnp.asarray(points, dtype=self.rotation.dtype)
        return _mm(pts - self.translation[..., None, :], self.rotation)

    def apply_inverse_transform_to_vectors(self, vectors):
        return self.apply_inverse_transform_to_points(vectors)


def make_marker_square(marker_size_mm) -> jnp.ndarray:
    """Canonical object points: (4, 3), clockwise from top-left at z=0,
    +Y up / +X right (reference pose.rs:83-93)."""
    hw = 0.5 * jnp.asarray(marker_size_mm, dtype=jnp.float32)
    zeros = jnp.zeros_like(hw)
    return jnp.stack(
        [
            jnp.stack([-hw, hw, zeros], axis=-1),
            jnp.stack([hw, hw, zeros], axis=-1),
            jnp.stack([hw, -hw, zeros], axis=-1),
            jnp.stack([-hw, -hw, zeros], axis=-1),
        ],
        axis=-2,
    )


def compute_homography_from_marker_square(
    marker_size_mm, target_points: jnp.ndarray
) -> jnp.ndarray:
    """Homography mapping the canonical square to 4 image points.

    target_points: (..., 4, 2) normalized image points.
    Returns (..., 3, 3) with H[2,2] = 1.

    Closed form (cf. the expanded closed form at reference pose.rs:96-123):
    the unit-square projective-interpolation homography composed with the
    canonical-square -> unit-square affine map, normalized to H[2,2] = 1.
    ~20 flops per candidate instead of a batched 8x8 LU solve.
    """
    tp = jnp.asarray(target_points, dtype=jnp.float32)
    hw = 0.5 * jnp.asarray(marker_size_mm, dtype=jnp.float32)
    batch = tp.shape[:-2]
    hw = jnp.broadcast_to(hw, batch)

    # Unit-square (0,0),(1,0),(1,1),(0,1) -> target points, Heckbert form.
    u0, u1, u2, u3 = (tp[..., i, 0] for i in range(4))
    v0, v1, v2, v3 = (tp[..., i, 1] for i in range(4))
    d1u, d1v = u1 - u2, v1 - v2
    d2u, d2v = u3 - u2, v3 - v2
    su = u0 - u1 + u2 - u3
    sv = v0 - v1 + v2 - v3
    den = d1u * d2v - d2u * d1v
    den = jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
    g = (su * d2v - sv * d2u) / den
    hh = (d1u * sv - d1v * su) / den
    a11 = u1 - u0 + g * u1
    a12 = u3 - u0 + hh * u3
    a21 = v1 - v0 + g * v1
    a22 = v3 - v0 + hh * v3

    # Compose with canonical->unit: x_u = (x_c + hw)/(2hw),
    # y_u = (hw - y_c)/(2hw)  (canonical square is clockwise from top-left
    # with +Y up, pose.rs:83-93), then renormalize H[2,2] to 1.
    inv2 = 1.0 / (2.0 * hw)
    h00 = a11 * inv2
    h01 = -a12 * inv2
    h02 = 0.5 * (a11 + a12) + u0
    h10 = a21 * inv2
    h11 = -a22 * inv2
    h12 = 0.5 * (a21 + a22) + v0
    h20 = g * inv2
    h21 = -hh * inv2
    h22 = 0.5 * (g + hh) + 1.0
    s = 1.0 / h22
    H = jnp.stack(
        [
            jnp.stack([h00 * s, h01 * s, h02 * s], axis=-1),
            jnp.stack([h10 * s, h11 * s, h12 * s], axis=-1),
            jnp.stack([h20 * s, h21 * s, jnp.ones_like(h22)], axis=-1),
        ],
        axis=-2,
    )
    return H


def find_rotation_to_z(vec: jnp.ndarray) -> jnp.ndarray:
    """Rotation aligning ``vec`` with +Z; batched over leading axes
    (reference pose.rs:237-267, incl. the |1+az| < 1e-6 degenerate branch)."""
    v = jnp.asarray(vec, dtype=jnp.float32)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    ax, ay, az = v[..., 0], v[..., 1], v[..., 2]

    degenerate = jnp.abs(1.0 + az) < _DEGENERATE_EPS
    d = 1.0 / jnp.where(degenerate, 1.0, 1.0 + az)
    ax2, ay2, axay = ax * ax, ay * ay, ax * ay

    r = jnp.stack(
        [
            -ax2 * d + 1.0,
            -axay * d,
            -ax,
            -axay * d,
            -ay2 * d + 1.0,
            -ay,
            ax,
            ay,
            1.0 - (ax2 + ay2) * d,
        ],
        axis=-1,
    ).reshape(v.shape[:-1] + (3, 3))

    flip = jnp.broadcast_to(
        jnp.diag(jnp.array([1.0, 1.0, -1.0], dtype=v.dtype)), r.shape
    )
    return jnp.where(degenerate[..., None, None], flip, r)


def compute_rotations(jacobian: jnp.ndarray, translation2: jnp.ndarray):
    """The two IPPE rotation candidates (reference pose.rs:158-235).

    jacobian: (..., 2, 2) — dH at the marker origin.
    translation2: (..., 2) — (tx, ty) of the origin projection.
    Returns (R1, R2): each (..., 3, 3).
    """
    tx, ty = translation2[..., 0], translation2[..., 1]
    t3 = jnp.stack([tx, ty, jnp.ones_like(tx)], axis=-1)
    rv = jnp.swapaxes(find_rotation_to_z(t3), -1, -2)

    # B = rv[:2, :2] - t2 (outer) rv[2, :2]
    b = rv[..., :2, :2] - translation2[..., :, None] * rv[..., 2:3, :2]
    det = b[..., 0, 0] * b[..., 1, 1] - b[..., 0, 1] * b[..., 1, 0]
    inv_det = 1.0 / det
    binv = (
        jnp.stack(
            [b[..., 1, 1], -b[..., 0, 1], -b[..., 1, 0], b[..., 0, 0]],
            axis=-1,
        ).reshape(b.shape)
        * inv_det[..., None, None]
    )
    a = _mm(binv, jacobian)  # (..., 2, 2)

    # Largest singular value of A (closed form for 2x2).
    ata00 = a[..., 0, 0] ** 2 + a[..., 0, 1] ** 2
    ata01 = a[..., 0, 0] * a[..., 1, 0] + a[..., 0, 1] * a[..., 1, 1]
    ata11 = a[..., 1, 0] ** 2 + a[..., 1, 1] ** 2
    gamma = jnp.sqrt(
        0.5
        * (
            ata00
            + ata11
            + jnp.sqrt((ata00 - ata11) ** 2 + 4.0 * ata01**2)
        )
    )

    rt = a / gamma[..., None, None]  # R-tilde, the upper-left 2x2 block
    rt00, rt01 = rt[..., 0, 0], rt[..., 0, 1]
    rt10, rt11 = rt[..., 1, 0], rt[..., 1, 1]

    b0 = jnp.sqrt(jnp.maximum(1.0 - rt00**2 - rt10**2, 0.0))
    b1 = jnp.sqrt(jnp.maximum(1.0 - rt01**2 - rt11**2, 0.0))
    sp = -rt00 * rt01 - rt10 * rt11
    b1 = jnp.where(sp < 0.0, -b1, b1)

    def assemble(b0, b1):
        # Columns: [rt00, rt10, b0], [rt01, rt11, b1], cross(col0, col1).
        c0 = jnp.stack([rt00, rt10, b0], axis=-1)
        c1 = jnp.stack([rt01, rt11, b1], axis=-1)
        c2 = jnp.cross(c0, c1)
        m = jnp.stack([c0, c1, c2], axis=-1)  # (..., 3, 3) columns
        return _mm(rv, m)

    return assemble(b0, b1), assemble(-b0, -b1)


def compute_translation(
    object_points: jnp.ndarray,
    normalized_image_points: jnp.ndarray,
    rot: jnp.ndarray,
) -> jnp.ndarray:
    """Least-squares translation given a rotation candidate
    (reference pose.rs:269-335, via an explicit 3x3 normal-equation solve).

    object_points: (..., 4, 3); image points (..., 4, 2); rot (..., 3, 3).
    """
    rp = _mm(object_points, jnp.swapaxes(rot, -1, -2))  # (..., 4, 3) = R @ p
    u = normalized_image_points[..., 0]
    v = normalized_image_points[..., 1]
    a2 = -u
    b2 = -v

    npts = object_points.shape[-2]
    batch = rp.shape[:-2]
    n = jnp.full(batch, float(npts), dtype=rp.dtype)
    zero = jnp.zeros(batch, dtype=rp.dtype)
    sa = jnp.sum(a2, axis=-1)
    sb = jnp.sum(b2, axis=-1)
    sab = jnp.sum(a2 * a2 + b2 * b2, axis=-1)
    ata = jnp.stack(
        [n, zero, sa, zero, n, sb, sa, sb, sab], axis=-1
    ).reshape(batch + (3, 3))

    rx, ry, rz = rp[..., 0], rp[..., 1], rp[..., 2]
    bx = -a2 * rz - rx
    by = -b2 * rz - ry
    atb = jnp.stack(
        [
            jnp.sum(bx, axis=-1),
            jnp.sum(by, axis=-1),
            jnp.sum(a2 * bx + b2 * by, axis=-1),
        ],
        axis=-1,
    )
    return jnp.linalg.solve(ata, atb[..., None])[..., 0]


def compute_reprojection_error(
    rotation: jnp.ndarray,
    translation: jnp.ndarray,
    object_points: jnp.ndarray,
    normalized_image_points: jnp.ndarray,
) -> jnp.ndarray:
    """Sum of per-point reprojection distances, z clamped at 1e-5
    (reference pose.rs:337-348)."""
    proj = _mm(object_points, jnp.swapaxes(rotation, -1, -2)) + translation[
        ..., None, :
    ]
    z = jnp.maximum(proj[..., 2], _Z_CLAMP)
    dx = proj[..., 0] / z - normalized_image_points[..., 0]
    dy = proj[..., 1] / z - normalized_image_points[..., 1]
    return jnp.sum(jnp.sqrt(dx * dx + dy * dy), axis=-1)


def solve_canonical_form(
    object_points: jnp.ndarray,
    normalized_image_points: jnp.ndarray,
    homography: jnp.ndarray,
):
    """IPPE core: homography -> two candidate poses (reference pose.rs:125-156).

    Returns (rotations (..., 2, 3, 3), translations (..., 2, 3),
    errors (..., 2)) — unsorted (candidate order as constructed).

    Structure-of-arrays formulation: every quantity is a (batch,)-shaped
    component vector, so the whole solve is elementwise math over the
    candidate lanes, with no (batch, 3, 3) matmuls or batched solves.  The
    math is identical to compute_rotations / compute_translation /
    compute_reprojection_error, which remain as the reference-shaped API.
    """
    h = homography
    j00 = h[..., 0, 0] - h[..., 2, 0] * h[..., 0, 2]
    j01 = h[..., 0, 1] - h[..., 2, 1] * h[..., 0, 2]
    j10 = h[..., 1, 0] - h[..., 2, 0] * h[..., 1, 2]
    j11 = h[..., 1, 1] - h[..., 2, 1] * h[..., 1, 2]
    tx = h[..., 0, 2]
    ty = h[..., 1, 2]

    # find_rotation_to_z((tx, ty, 1)) transposed, inline (pose.rs:237-267).
    inv_norm = jax.lax.rsqrt(tx * tx + ty * ty + 1.0)
    ax = tx * inv_norm
    ay = ty * inv_norm
    az = inv_norm  # z component of the normalized vector is 1/norm > 0
    degenerate = jnp.abs(1.0 + az) < _DEGENERATE_EPS
    d = 1.0 / jnp.where(degenerate, 1.0, 1.0 + az)
    ax2, ay2, axay = ax * ax, ay * ay, ax * ay

    def sel(val, flip_val):
        return jnp.where(degenerate, flip_val, val)

    one = jnp.ones_like(ax)
    zero = jnp.zeros_like(ax)
    # rv = R^T where R aligns t3 with +Z (degenerate: diag(1, 1, -1)).
    rv00 = sel(-ax2 * d + 1.0, one)
    rv01 = sel(-axay * d, zero)
    rv02 = sel(ax, zero)
    rv10 = sel(-axay * d, zero)
    rv11 = sel(-ay2 * d + 1.0, one)
    rv12 = sel(ay, zero)
    rv20 = sel(-ax, zero)
    rv21 = sel(-ay, zero)
    rv22 = sel(1.0 - (ax2 + ay2) * d, -one)

    # B = rv[:2,:2] - t2 (outer) rv[2,:2]; A = B^-1 @ J (pose.rs:169-184).
    b00 = rv00 - tx * rv20
    b01 = rv01 - tx * rv21
    b10 = rv10 - ty * rv20
    b11 = rv11 - ty * rv21
    idet = 1.0 / (b00 * b11 - b01 * b10)
    a00 = (b11 * j00 - b01 * j10) * idet
    a01 = (b11 * j01 - b01 * j11) * idet
    a10 = (b00 * j10 - b10 * j00) * idet
    a11 = (b00 * j11 - b10 * j01) * idet

    # Largest singular value of A, closed form (pose.rs:186-190).
    ata00 = a00 * a00 + a01 * a01
    ata01 = a00 * a10 + a01 * a11
    ata11 = a10 * a10 + a11 * a11
    gamma = jnp.sqrt(
        0.5
        * (ata00 + ata11 + jnp.sqrt((ata00 - ata11) ** 2 + 4.0 * ata01**2))
    )
    inv_g = 1.0 / gamma
    rt00, rt01 = a00 * inv_g, a01 * inv_g
    rt10, rt11 = a10 * inv_g, a11 * inv_g

    b0 = jnp.sqrt(jnp.maximum(1.0 - rt00 * rt00 - rt10 * rt10, 0.0))
    b1 = jnp.sqrt(jnp.maximum(1.0 - rt01 * rt01 - rt11 * rt11, 0.0))
    sp = -rt00 * rt01 - rt10 * rt11
    b1 = jnp.where(sp < 0.0, -b1, b1)

    # Object-point / image-point components (4 correspondences).
    ox = [object_points[..., k, 0] for k in range(4)]
    oy = [object_points[..., k, 1] for k in range(4)]
    oz = [object_points[..., k, 2] for k in range(4)]
    u = [normalized_image_points[..., k, 0] for k in range(4)]
    v = [normalized_image_points[..., k, 1] for k in range(4)]
    # A^T A entries shared by both candidates (pose.rs:269-335): a2=-u,
    # b2=-v.
    sa = -(u[0] + u[1] + u[2] + u[3])
    sb = -(v[0] + v[1] + v[2] + v[3])
    sab = sum(u[k] * u[k] + v[k] * v[k] for k in range(4))

    def candidate(sign):
        # Columns c0=(rt00, rt10, s*b0), c1=(rt01, rt11, s*b1), c2=c0xc1;
        # R = rv @ [c0 c1 c2] (pose.rs:203-234), unrolled.
        c0x, c0y, c0z = rt00, rt10, sign * b0
        c1x, c1y, c1z = rt01, rt11, sign * b1
        c2x = c0y * c1z - c0z * c1y
        c2y = c0z * c1x - c0x * c1z
        c2z = c0x * c1y - c0y * c1x

        def row(r0, r1, r2):
            return (
                r0 * c0x + r1 * c0y + r2 * c0z,
                r0 * c1x + r1 * c1y + r2 * c1z,
                r0 * c2x + r1 * c2y + r2 * c2z,
            )

        R00, R01, R02 = row(rv00, rv01, rv02)
        R10, R11, R12 = row(rv10, rv11, rv12)
        R20, R21, R22 = row(rv20, rv21, rv22)

        # Least-squares translation via the closed-form 3x3 normal
        # equations (A^T A as in compute_translation; the matrix is
        # [[4,0,sa],[0,4,sb],[sa,sb,sab]], solved by elimination).
        r0 = zero
        r1 = zero
        r2 = zero
        rpx, rpy, rpz = [], [], []
        for k in range(4):
            px = R00 * ox[k] + R01 * oy[k] + R02 * oz[k]
            py = R10 * ox[k] + R11 * oy[k] + R12 * oz[k]
            pz = R20 * ox[k] + R21 * oy[k] + R22 * oz[k]
            rpx.append(px)
            rpy.append(py)
            rpz.append(pz)
            bxk = u[k] * pz - px
            byk = v[k] * pz - py
            r0 = r0 + bxk
            r1 = r1 + byk
            r2 = r2 - u[k] * bxk - v[k] * byk
        denz = 4.0 * sab - sa * sa - sb * sb
        tz = (4.0 * r2 - sa * r0 - sb * r1) / denz
        tx_ = (r0 - sa * tz) * 0.25
        ty_ = (r1 - sb * tz) * 0.25

        # Reprojection error with the z clamp (pose.rs:337-348).
        err = zero
        for k in range(4):
            z = jnp.maximum(rpz[k] + tz, _Z_CLAMP)
            dx = (rpx[k] + tx_) / z - u[k]
            dy = (rpy[k] + ty_) / z - v[k]
            err = err + jnp.sqrt(dx * dx + dy * dy)

        rot = jnp.stack(
            [
                jnp.stack([R00, R01, R02], axis=-1),
                jnp.stack([R10, R11, R12], axis=-1),
                jnp.stack([R20, R21, R22], axis=-1),
            ],
            axis=-2,
        )
        tr = jnp.stack([tx_, ty_, tz], axis=-1)
        return rot, tr, err

    r1_, t1_, e1_ = candidate(one)
    r2_, t2_, e2_ = candidate(-one)
    rotations = jnp.stack([r1_, r2_], axis=-3)
    translations = jnp.stack([t1_, t2_], axis=-2)
    errors = jnp.stack([e1_, e2_], axis=-1)
    return rotations, translations, errors


def solve_normalized_batch(
    normalized_image_points: jnp.ndarray, marker_size_mm
):
    """Batched IPPE solve, best pose first.

    normalized_image_points: (..., 4, 2); marker_size_mm scalar or (...)
    Returns (rotations (..., 2, 3, 3), translations (..., 2, 3),
    errors (..., 2)) sorted so index 0 is the lower-error pose
    (reference pose.rs:76-80).
    """
    pts = jnp.asarray(normalized_image_points, dtype=jnp.float32)
    obj = make_marker_square(marker_size_mm)
    obj = jnp.broadcast_to(obj, pts.shape[:-2] + (4, 3))
    homography = compute_homography_from_marker_square(marker_size_mm, pts)
    rotations, translations, errors = solve_canonical_form(
        obj, pts, homography
    )
    swap = errors[..., 1] < errors[..., 0]
    order = jnp.where(
        swap[..., None],
        jnp.array([1, 0]),
        jnp.array([0, 1]),
    )
    rotations = jnp.take_along_axis(
        rotations, order[..., :, None, None], axis=-3
    )
    translations = jnp.take_along_axis(
        translations, order[..., :, None], axis=-2
    )
    errors = jnp.take_along_axis(errors, order, axis=-1)
    return rotations, translations, errors


# --------------------------------------------------------------------------
# Reference-parity scalar API
# --------------------------------------------------------------------------
def _pair_from_batch(rotations, translations, errors):
    p = lambda i: MarkerPose(  # noqa: E731
        error=errors[i], rotation=rotations[i], translation=translations[i]
    )
    return p(0), p(1)


def solve_with_normalized_points(normalized_image_points, marker_size_mm):
    """(best, alt) poses from 4 normalized image points
    (reference pose.rs:64-81)."""
    pts = jnp.asarray(normalized_image_points, dtype=jnp.float32).reshape(
        4, 2
    )
    rot, tr, err = solve_normalized_batch(pts, marker_size_mm)
    return _pair_from_batch(rot, tr, err)


def solve_with_undistorted_points(
    image_points, marker_size_mm, image_size
):
    """Normalizes pixel coords per-axis by image dims then solves
    (reference pose.rs:59-62 — aspect ratio knowingly ignored)."""
    pts = jnp.asarray(image_points, dtype=jnp.float32).reshape(4, 2)
    w, h = image_size
    pts = pts / jnp.array([float(w), float(h)], dtype=jnp.float32)
    return solve_with_normalized_points(pts, marker_size_mm)


def solve_with_intrinsics(
    image_points, marker_size_mm, camera_intrinsics: CameraIntrinsics
):
    """Unprojects pixel corners through the camera then solves
    (reference pose.rs:52-55)."""
    pts = jnp.asarray(image_points, dtype=jnp.float32).reshape(4, 2)
    x, y = camera_intrinsics.unproject(pts[..., 0], pts[..., 1])
    return solve_with_normalized_points(
        jnp.stack([x, y], axis=-1), marker_size_mm
    )


def estimate_pose(image_points, marker_size_mm, image_size):
    """Convenience alias used by the reference README (README.md:34 names an
    ``estimate_pose`` that the Rust code never defines); provided here so the
    documented surface actually exists."""
    return solve_with_undistorted_points(
        image_points, marker_size_mm, image_size
    )
