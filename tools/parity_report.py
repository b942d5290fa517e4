#!/usr/bin/env python
"""Full-size reference-parity measurement (recorded in BASELINE.md).

Runs the randomized scene mix (plain/dark/multi/nested) through both the
detector and the reference-pipeline oracle and prints recall/parity/
corner statistics, per scene family.  Runs on the CPU (the oracle is
host-side anyway, and the detector runs the same one path everywhere).

Usage:
  python tools/parity_report.py [n_scenes] [width height] [dict]
      one configuration (back-compat; defaults 500 scenes, 320x240,
      ARUCO_DEFAULT)
  python tools/parity_report.py --suite [n_scenes_per_config]
      the BASELINE.md matrix: ARUCO_DEFAULT@320x240 +
      ARUCO_MIP_36H12@1920x1080 (the headline-bench regime) +
      APRILTAG_36H11@1920x1080
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

from aruco3_tpu.parity import run_parity  # noqa: E402


def one(name, n, size, seed=1234):
    t0 = time.time()
    res = run_parity(
        dictionary_name=name, n_scenes=n, image_size=size, seed=seed
    )
    s = res.summary()
    s["dictionary"] = name
    s["image_size"] = list(size)
    s["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(s), flush=True)
    return s


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--suite":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 400
        # The oracle is host-side numpy, ~linear in pixels: 1080p scenes
        # cost ~25x a 320x240 scene, so the full-HD configs run a 0.375
        # fraction of n (>=1000 markers total at the default n=400).
        n_hd = max(60, (3 * n) // 8)
        configs = [
            ("ARUCO_DEFAULT", n, (320, 240)),
            ("ARUCO_MIP_36H12", n_hd, (1920, 1080)),
            ("APRILTAG_36H11", n_hd, (1920, 1080)),
        ]
        results = [one(name, nn, size) for name, nn, size in configs]
        total_markers = sum(r["n_markers"] for r in results)
        total_oracle = sum(
            round(r["oracle_recall"] * r["n_markers"]) for r in results
        )
        total_both = sum(
            round(r["parity"] * r["oracle_recall"] * r["n_markers"])
            for r in results
        )
        print(
            json.dumps(
                {
                    "suite_markers": total_markers,
                    "suite_parity": round(
                        total_both / max(total_oracle, 1), 4
                    ),
                }
            )
        )
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    size = (
        (int(sys.argv[2]), int(sys.argv[3]))
        if len(sys.argv) > 3
        else (320, 240)
    )
    name = sys.argv[4] if len(sys.argv) > 4 else "ARUCO_DEFAULT"
    one(name, n, size)


if __name__ == "__main__":
    main()
