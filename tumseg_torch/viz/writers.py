"""Prediction artifact writers: per-point label .txt and colored .obj dumps,
matching the reference's outputs (localfunctions.py:424-459)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def write_labels_txt(path: str, pred_label: np.ndarray) -> None:
    """One integer label per line (localfunctions.py:424-428)."""
    with open(path, "w") as f:
        f.write("\n".join(str(int(i)) for i in pred_label))
        f.write("\n")


def write_obj_pointcloud(path: str, xyz: np.ndarray,
                         labels: Optional[np.ndarray] = None,
                         label2color: Optional[Dict] = None) -> None:
    """Wavefront-style 'v x y z [r g b]' vertex dump with class colors
    (localfunctions.py:432-459)."""
    with open(path, "w") as f:
        if labels is not None and label2color is not None:
            for i in range(xyz.shape[0]):
                c = label2color[int(labels[i])]
                f.write("v %f %f %f %d %d %d\n"
                        % (xyz[i, 0], xyz[i, 1], xyz[i, 2], c[0], c[1], c[2]))
        else:
            for i in range(xyz.shape[0]):
                f.write("v %f %f %f\n" % (xyz[i, 0], xyz[i, 1], xyz[i, 2]))


def read_labels_txt(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line) for line in f if line.strip()], dtype=np.int64)
