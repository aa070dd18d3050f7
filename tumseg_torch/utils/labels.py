"""TUM-Facade class taxonomies, merge rules, and color tables.

Parity source: the reference's localfunctions.py:37-100 (tables),
the reference's sem_seg_training.py:46-55,159-169 (18->8 merge + remap).
"""

from __future__ import annotations

import numpy as np

# 18-class raw TUM-Facade taxonomy (LAS classification codes used directly).
CLASSES_18 = [
    "total", "wall", "window", "door", "balcony", "molding", "deco", "column",
    "arch", "drainpipe", "stairs", "ground surface", "terrain", "roof",
    "blinds", "outer ceiling surface", "interior", "other",
]
NUM_CLASSES_18 = 18

# Merged 8-class taxonomy.
CLASSES_8 = ["wall", "window", "door", "molding", "other", "terrain", "column", "arch"]
NUM_CLASSES_8 = 8

# After the in-place merges below, the surviving raw codes are remapped 0..7.
NEW_CLASS_MAPPING = {1: 0, 2: 1, 3: 2, 6: 3, 13: 4, 11: 5, 7: 6, 8: 7}

CLASS2LABEL_18 = {c: i for i, c in enumerate(CLASSES_18)}
CLASS2LABEL_8 = {c: i for i, c in enumerate(CLASSES_8)}

CLASS2COLOR_18 = {
    "total": [255, 255, 255],
    "wall": [255, 240, 180],
    "window": [100, 149, 237],
    "door": [255, 97, 3],
    "balcony": [0, 128, 128],
    "molding": [138, 43, 226],
    "deco": [0, 238, 238],
    "column": [255, 0, 0],
    "arch": [61, 89, 171],
    "drainpipe": [255, 165, 0],
    "stairs": [188, 143, 143],
    "ground surface": [124, 252, 0],
    "terrain": [189, 252, 201],
    "roof": [139, 26, 26],
    "blinds": [84, 139, 84],
    "outer ceiling surface": [184, 134, 11],
    "interior": [255, 255, 0],
    "other": [105, 105, 105],
}
LABEL2COLOR_18 = {CLASSES_18.index(c): CLASS2COLOR_18[c] for c in CLASSES_18}

CLASS2COLOR_8 = {
    "wall": [255, 240, 180],
    "window": [100, 149, 237],
    "door": [255, 97, 3],
    "molding": [138, 43, 226],
    "other": [105, 105, 105],
    "terrain": [189, 252, 201],
    "column": [255, 0, 0],
    "arch": [61, 89, 171],
}
LABEL2COLOR_8 = {CLASSES_8.index(c): CLASS2COLOR_8[c] for c in CLASSES_8}


def merge_to_8_classes(labels: np.ndarray) -> np.ndarray:
    """Merge raw 18-class TUM-Facade codes into the 8-class taxonomy and remap
    them to contiguous 0..7 labels.

    Mirrors the reference's sem_seg_training.py:159-169 exactly:
      - molding(5) + deco(6)                          -> 6  -> "molding"(3)
      - wall(1) + drainpipe(9) + outer ceiling(15)
        + stairs(10)                                  -> 1  -> "wall"(0)
      - terrain(12) + ground surface(11)              -> 11 -> "terrain"(5)
      - roof(13) + interior(16) + other(17)           -> 13 -> "other"(4)
      - blinds(14)                                    -> 2  -> "window"(1)
    Codes 2 (window), 3 (door), 7 (column), 8 (arch) pass through the remap.
    """
    labels = np.asarray(labels).copy()
    labels[(labels == 5) | (labels == 6)] = 6
    labels[(labels == 1) | (labels == 9) | (labels == 15) | (labels == 10)] = 1
    labels[(labels == 12) | (labels == 11)] = 11
    labels[(labels == 13) | (labels == 16) | (labels == 17)] = 13
    labels[labels == 14] = 2
    # Vectorized remap (reference uses np.vectorize over the dict).
    lut = np.full(max(NEW_CLASS_MAPPING) + 1, -1, dtype=np.int64)
    for src, dst in NEW_CLASS_MAPPING.items():
        lut[src] = dst
    out_of_range = (labels < 0) | (labels >= lut.size)
    if out_of_range.any():
        raise ValueError(
            "unmappable LAS classification codes for the 8-class merge: "
            f"{np.unique(labels[out_of_range]).tolist()}")
    mapped = lut[labels]
    # Codes with no 8-class destination (0 'total', 4 'balcony') would map to
    # -1 and silently corrupt weight[target] / confusion tallies downstream;
    # the reference fails loudly here (np.vectorize(dict.get) -> None crash),
    # so we do too, with a better message.
    bad = mapped < 0
    if bad.any():
        raise ValueError(
            "LAS classification codes without an 8-class mapping: "
            f"{np.unique(labels[bad]).tolist()} (0 'total' and 4 'balcony' "
            "are not part of the merged taxonomy)")
    return mapped


def class_tables(class8: bool):
    """Return (class names, NUM_CLASSES, label->color) for the chosen taxonomy."""
    if class8:
        return CLASSES_8, NUM_CLASSES_8, LABEL2COLOR_8
    return CLASSES_18, NUM_CLASSES_18, LABEL2COLOR_18


def seg_label_to_cat(class8: bool) -> dict:
    classes = CLASSES_8 if class8 else CLASSES_18
    return {i: c for i, c in enumerate(classes)}


def compute_class_weights(las_dataset) -> np.ndarray:
    """Inverse-frequency class weights num_points / (n_classes * count),
    iterating (data, labels) pairs (reference localfunctions.py:142-156)."""
    from collections import Counter

    class_counts = Counter()
    for _, labels in las_dataset:
        class_counts.update(np.asarray(labels).tolist())
    num_points = sum(class_counts.values())
    weights = {label: num_points / (len(class_counts) * count)
               for label, count in class_counts.items()}
    return np.array([weights[label] for label in sorted(weights)],
                    dtype=np.float32)


def label_weights(histogram: np.ndarray) -> np.ndarray:
    """Inverse-cube-root balanced class weights: (max(w)/w)^(1/3) of the
    normalized label histogram (reference sem_seg_training.py:264-278)."""
    w = histogram.astype(np.float32)
    w = w / np.sum(w)
    with np.errstate(divide="ignore"):
        out = np.power(np.amax(w) / w, 1.0 / 3.0)
    return out
