"""Multi-device execution: frame-batch data parallelism over a device mesh.

The reference is single-threaded per frame (SURVEY §2: its only implicit
parallelism is per-frame independence), so the natural scaling axis is the
frame batch: shard (B, H, W[, C]) over a flat 'batch' mesh axis with
``shard_map`` so every device runs the identical detect(+pose) program on
its local shard, with no cross-device communication on the hot path
(detections are per-frame).  Row-band spatial sharding, which does need
halo exchanges, lives in ``parallel.spatial``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..detector import Detector


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_frames(frames: jnp.ndarray, mesh: Mesh, axis: str = "batch"):
    """Place (B, ...) frames with the batch dim sharded over the mesh."""
    spec = P(axis, *([None] * (frames.ndim - 1)))
    return jax.device_put(frames, NamedSharding(mesh, spec))


def build_sharded_detect(
    detector: Detector,
    mesh: Mesh,
    height: int,
    width: int,
    channels: int = 1,
    with_pose: bool = False,
    marker_size_mm: float = 40.0,
    axis: str = "batch",
):
    """Compile a detect(+pose) step over a sharded frame batch.

    Returns a jitted fn: (B, H, W[, C]) uint8 -> dict of batched outputs,
    each sharded over the mesh batch axis.  B must divide by the mesh size.
    """
    local_batch_fn = detector.markers_pipeline(
        height, width, with_pose=with_pose, marker_size_mm=marker_size_mm
    )
    in_spec = P(axis, *([None] * (2 if channels == 1 else 3)))

    # shard_map: each device runs the identical local pipeline on its
    # frame shard; detection needs no cross-device collectives.
    step = jax.jit(
        jax.shard_map(
            local_batch_fn,
            mesh=mesh,
            in_specs=in_spec,
            out_specs=P(axis),
            check_vma=False,
        )
    )
    return step


def detect_sharded(
    detector: Detector,
    frames,
    mesh: Mesh | None = None,
    with_pose: bool = False,
    marker_size_mm: float = 40.0,
):
    """One-shot convenience wrapper: shard, run, return device results."""
    mesh = mesh or make_mesh()
    frames = jnp.asarray(frames)
    h, w = frames.shape[1], frames.shape[2]
    channels = 1 if frames.ndim == 3 else frames.shape[-1]
    step = build_sharded_detect(
        detector,
        mesh,
        h,
        w,
        channels,
        with_pose=with_pose,
        marker_size_mm=marker_size_mm,
    )
    return step(shard_frames(frames, mesh))
