"""Recall/corner parity harness: detector vs the reference-pipeline
oracle (oracle.py) over randomized scenes.

BASELINE.json requires >=99% detection-recall parity vs the reference on a
randomized e2e suite.  This module generates seeded scene families
(rotation/scale/perspective/noise sweeps, dark backgrounds, nested and
multi-marker layouts), runs both detectors, and reports:

  * oracle_recall / det_recall: fraction of planted markers found;
  * parity: fraction of oracle-found (scene, id) pairs the detector
    also finds — THE headline number (>=0.99 required);
  * corner error stats of each detector vs ground truth.

Used by tests/test_parity.py (CI assertion) and tools/parity_report.py
(full-size run recorded in BASELINE.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .detector import Detector, DetectorConfig
from .dictionaries import ARDictionary
from .oracle import OracleDetector
from .render import render_marker


def _corner_err(found, truth) -> float:
    found = np.asarray(found, dtype=np.float64)
    best = np.inf
    for r in range(4):
        err = np.linalg.norm(
            np.roll(found, r, axis=0) - truth, axis=-1
        ).mean()
        best = min(best, err)
    return best


def _rot_quad(rng, side, cx, cy, max_persp):
    ang = rng.uniform(0, 2 * np.pi)
    base = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    rot = np.array(
        [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    )
    quad = base @ rot.T * side
    quad += rng.uniform(-max_persp, max_persp, size=(4, 2)) * side
    quad += np.array([cx, cy])
    return quad


def generate_scene(
    dictionary: ARDictionary,
    rng: np.random.Generator,
    image_size: tuple[int, int],
    kind: str,
):
    """One randomized scene -> (image u8, [(marker_id, truth_corners)])."""
    w, h = image_size
    noise = rng.uniform(0.5, 3.0)
    if kind == "plain":
        side = rng.uniform(0.28, 0.6) * min(w, h)
        cx = rng.uniform(side * 0.75, w - side * 0.75)
        cy = rng.uniform(side * 0.75, h - side * 0.75)
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.10)
        img = render_marker(
            dictionary, mid, image_size, quad, noise_sigma=noise, rng=rng
        )
        return img, [(mid, quad)]
    if kind == "dark":
        side = rng.uniform(0.35, 0.6) * min(w, h)
        cx = rng.uniform(side * 0.8, w - side * 0.8)
        cy = rng.uniform(side * 0.8, h - side * 0.8)
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.08)
        img = render_marker(
            dictionary, mid, image_size, quad, background=0,
            quiet_zone_cells=2, noise_sigma=noise, rng=rng,
        )
        return img, [(mid, quad)]
    if kind == "multi":
        img = np.full((h, w), 255, np.uint8)
        truths = []
        side = rng.uniform(0.26, 0.34) * min(w, h)
        for gx in (0.27, 0.73):
            mid = int(rng.integers(0, len(dictionary)))
            cx = gx * w + rng.uniform(-0.03, 0.03) * w
            cy = rng.uniform(0.4, 0.6) * h
            quad = _rot_quad(rng, side, cx, cy, 0.06)
            sub = render_marker(
                dictionary, mid, image_size, quad, noise_sigma=0.0
            )
            img = np.minimum(img, sub)
            truths.append((mid, quad))
        img = np.clip(
            img.astype(np.float64) + rng.normal(0, noise, img.shape), 0, 255
        ).astype(np.uint8)
        return img, truths
    if kind == "nested":
        side = rng.uniform(0.3, 0.42) * min(w, h)
        cx = rng.uniform(0.4, 0.6) * w
        cy = rng.uniform(0.4, 0.6) * h
        mid = int(rng.integers(0, len(dictionary)))
        quad = _rot_quad(rng, side, cx, cy, 0.05)
        mimg = render_marker(
            dictionary, mid, image_size, quad, background=0,
            quiet_zone_cells=2, noise_sigma=0.0,
        )
        scene = np.full((h, w), 255, np.uint8)
        pad = side * 0.55
        y0 = max(0, int(cy - pad - side * 0.5))
        y1 = min(h, int(cy + pad + side * 0.5))
        x0 = max(0, int(cx - pad - side * 0.5))
        x1 = min(w, int(cx + pad + side * 0.5))
        scene[y0:y1, x0:x1] = mimg[y0:y1, x0:x1]
        scene = np.clip(
            scene.astype(np.float64) + rng.normal(0, noise, scene.shape),
            0,
            255,
        ).astype(np.uint8)
        return scene, [(mid, quad)]
    raise ValueError(f"unknown scene kind {kind!r}")


SCENE_KINDS = ("plain", "plain", "plain", "dark", "multi", "nested")


@dataclass
class ParityResult:
    n_scenes: int = 0
    n_markers: int = 0
    oracle_found: int = 0
    det_found: int = 0
    both_found: int = 0
    det_errs: list = field(default_factory=list)
    oracle_errs: list = field(default_factory=list)
    # per scene-family counts: kind -> [n_markers, oracle, detector, both]
    families: dict = field(default_factory=dict)

    @property
    def parity(self) -> float:
        return self.both_found / max(self.oracle_found, 1)

    @property
    def oracle_recall(self) -> float:
        return self.oracle_found / max(self.n_markers, 1)

    @property
    def det_recall(self) -> float:
        return self.det_found / max(self.n_markers, 1)

    def summary(self) -> dict:
        te = np.array(self.det_errs) if self.det_errs else np.zeros(1)
        oe = np.array(self.oracle_errs) if self.oracle_errs else np.zeros(1)
        per_family = {
            kind: {
                "n_markers": int(n),
                "oracle_found": int(o),
                "det_found": int(t),
                "parity": round(b / max(o, 1), 4),
            }
            for kind, (n, o, t, b) in sorted(self.families.items())
        }
        return {
            "n_scenes": self.n_scenes,
            "n_markers": self.n_markers,
            "oracle_recall": round(self.oracle_recall, 4),
            "det_recall": round(self.det_recall, 4),
            "parity": round(self.parity, 4),
            "det_corner_mean_px": round(float(te.mean()), 3),
            "det_corner_p99_px": round(float(np.percentile(te, 99)), 3),
            "oracle_corner_mean_px": round(float(oe.mean()), 3),
            "per_family": per_family,
        }


def run_parity(
    dictionary_name: str = "ARUCO_DEFAULT",
    n_scenes: int = 120,
    image_size: tuple[int, int] = (320, 240),
    seed: int = 0,
    match_px: float = 6.0,
    detector_config: DetectorConfig | None = None,
) -> ParityResult:
    """A/B the detector against the reference oracle."""
    d = ARDictionary.new_from_named_dict(dictionary_name)
    det = Detector(detector_config or DetectorConfig(), d)
    od = OracleDetector(d)
    rng = np.random.default_rng(seed)
    res = ParityResult()

    for k in range(n_scenes):
        kind = SCENE_KINDS[k % len(SCENE_KINDS)]
        img, truths = generate_scene(d, rng, image_size, kind)
        found = det.detect(img).markers
        orc = od.detect(img)
        res.n_scenes += 1
        fam = res.families.setdefault(kind, np.zeros(4, np.int64))
        for mid, truth in truths:
            res.n_markers += 1
            fam[0] += 1
            t = [
                m
                for m in found
                if m.id == mid and _corner_err(m.corners, truth) < match_px
            ]
            o = [
                m
                for m in orc
                if m.id == mid and _corner_err(m.corners, truth) < match_px
            ]
            if t:
                res.det_found += 1
                fam[2] += 1
                res.det_errs.append(_corner_err(t[0].corners, truth))
            if o:
                res.oracle_found += 1
                fam[1] += 1
                res.oracle_errs.append(_corner_err(o[0].corners, truth))
            if t and o:
                res.both_found += 1
                fam[3] += 1
    return res
