"""aruco3_tpu — batched ArUco/AprilTag fiducial detection + IPPE pose in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of the
JosephCatrambone/aruco3 Rust crate: 15 named marker dictionaries, a batched
detect pipeline (grayscale -> adaptive threshold -> data-parallel quad
extraction -> perspective rectification -> bit decode -> Hamming dictionary
match), IPPE two-pose estimation, a pinhole camera model and marker
rendering — all compiled to one XLA program per frame batch and shardable
over a device mesh.
"""

from .camera import CameraExtrinsics, CameraIntrinsics, CameraModel
from .detector import Detection, Detector, DetectorConfig, Marker
from .dictionaries import ARDictionary, get_dictionary_names
from .pose import MarkerPose
from .utils.bits import hamming_distance
from . import pose

__all__ = [
    "ARDictionary",
    "CameraExtrinsics",
    "CameraIntrinsics",
    "CameraModel",
    "Detection",
    "Detector",
    "DetectorConfig",
    "Marker",
    "MarkerPose",
    "get_dictionary_names",
    "hamming_distance",
    "pose",
]

__version__ = "0.1.0"
