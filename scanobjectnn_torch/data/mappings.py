"""Cross-domain class mappings and class names (a copy of
``scanobjectnn_tpu/data/mappings.py``, which the port does not import).

Behavioral reference: the reference's mapping2.py:1-38 and
training_data/shape_names_ext.txt (15 ScanObjectNN classes, label order
confirmed by training_data/README.md:9-12) / shape_names_modelnet.txt
(ModelNet40).

Used by the cross-domain evaluators:
  * real-trained-on-synthetic: ModelNet40 prediction → ScanObjectNN label
    (`MODELNET_TO_OBJECTDATASET`, many-to-one).
  * synthetic-trained-on-real: a ScanObjectNN prediction is correct if the
    ModelNet ground truth is in `OBJECTDATASET_TO_MODELNET[pred]` (one-to-many).
  * `OBJECTDATASET_TO_COMBINED` renumbers the 11 mappable ScanObjectNN classes
    densely for confusion matrices.
"""

from __future__ import annotations

import numpy as np

# ScanObjectNN's 15 classes, index == label id.
SCANOBJECTNN_CLASSES = (
    "bag", "bin", "box", "cabinet", "chair", "desk", "display", "door",
    "shelf", "table", "bed", "pillow", "sink", "sofa", "toilet",
)

# Chair part ids for part segmentation, index == part label
# (training_data/part_labels/chair_parts.txt; the reference's
# evaluate_partseg.py:58 reads it from a wrong path — quirk not replicated).
CHAIR_PART_NAMES = ("background", "head", "back", "arm", "base", "seat")

MODELNET40_CLASSES = (
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
)

# ModelNet40 label -> ScanObjectNN label (ref mapping2.py:1-14).
MODELNET_TO_OBJECTDATASET: dict[int, int] = {
    2: 10,   # bed
    4: 8,    # bookshelf -> shelf
    8: 4,    # chair
    12: 5,   # desk
    13: 7,   # door
    14: 3,   # dresser -> cabinet
    22: 6,   # monitor -> display
    3: 4,    # bench -> chair
    29: 12,  # sink
    30: 13,  # sofa
    32: 4,   # stool -> chair
    33: 9,   # table
    35: 14,  # toilet
    38: 3,   # wardrobe -> cabinet
}

# ScanObjectNN label -> list of acceptable ModelNet40 labels (ref mapping2.py:16-26).
OBJECTDATASET_TO_MODELNET: dict[int, list[int]] = {
    10: [2],
    8: [4],
    4: [8, 32, 3],
    5: [12],
    7: [13],
    3: [14, 38],
    6: [22],
    12: [29],
    13: [30],
    9: [33],
    14: [35],
}

# Dense renumbering of the 11 mappable ScanObjectNN classes (ref mapping2.py:28-38).
OBJECTDATASET_TO_COMBINED: dict[int, int] = {
    3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7, 12: 8, 13: 9, 14: 10,
}

NUM_CLASSES = len(SCANOBJECTNN_CLASSES)
NUM_CLASSES_MODELNET = len(MODELNET40_CLASSES)
NUM_CLASSES_COMBINED = len(OBJECTDATASET_TO_COMBINED)


def mapping_table(mapping: dict[int, int], size: int, fill: int = -1) -> np.ndarray:
    """Dense int lookup table for a label mapping (for vectorized remaps)."""
    table = np.full((size,), fill, dtype=np.int32)
    for k, v in mapping.items():
        table[k] = v
    return table


def modelnet_pred_to_scanobjectnn(preds: np.ndarray) -> np.ndarray:
    """Map ModelNet40 predictions to ScanObjectNN labels; unmappable → -1."""
    return mapping_table(MODELNET_TO_OBJECTDATASET, NUM_CLASSES_MODELNET)[preds]


def is_correct_on_modelnet(pred_scanobjectnn: np.ndarray, gt_modelnet: np.ndarray) -> np.ndarray:
    """One-to-many correctness test for synthetic-trained-on-real eval
    (ref pointnet2/evaluate_synthetic_trained_on_real.py:204-225)."""
    pred = np.asarray(pred_scanobjectnn)
    gt = np.asarray(gt_modelnet)
    ok = np.zeros(pred.shape, dtype=bool)
    for scan_label, modelnet_labels in OBJECTDATASET_TO_MODELNET.items():
        hit = pred == scan_label
        for m in modelnet_labels:
            ok |= hit & (gt == m)
    return ok
