"""Evaluation: the cross-domain protocols and the confusion matrix
(counterpart of ``scanobjectnn_tpu/train/evaluate.py``).

Behavioural references:
  * pointnet2/evaluate_scenennobjects.py:152-231: the voting eval
    (``Trainer.evaluate``), its per-class table and pred_label.txt;
  * pointnet2/evaluate_real_trained_on_synthetic.py:156-209: a
    ModelNet40-trained model on ScanObjectNN, only the 11 mappable classes,
    ModelNet predictions mapped to ScanObjectNN labels;
  * pointnet2/evaluate_synthetic_trained_on_real.py:159-225: a
    ScanObjectNN-trained model on ModelNet40, a prediction right iff the
    ground truth is in ``OBJECTDATASET_TO_MODELNET[pred]``;
  * pointnet2/draw_cmat.py:26-30: the row-normalised confusion matrix.

The cross-domain functions evaluate through ``_eval_no_shuffle``, JAX's
``Trainer.evaluate_auto(..., shuffle=False)``: dense clouds through
``evaluate_device``, ragged ones (an object array of ``[n_i, 3]`` clouds,
which ``np.asarray`` keeps, so the class filters index it like a
rectangular array) through ``evaluate``; with ``shuffle=False`` the two
give the same results.
``dump_error_cases`` and ``dump_seg_masks`` write the ``--visu`` dumps (PNG
renders through ``viz.render`` and PLY files through ``io.save_ply``), the
JAX package's file names and bytes.
"""

from __future__ import annotations

import os

import numpy as np

from scanobjectnn_torch.data import io as data_io
from scanobjectnn_torch.data import mappings

__all__ = [
    "confusion_matrix",
    "dump_error_cases",
    "dump_seg_masks",
    "evaluate_real_trained_on_synthetic",
    "evaluate_synthetic_trained_on_real",
    "filter_to_mappable_classes",
    "format_per_class_table",
    "write_pred_labels",
]


def format_per_class_table(per_class: np.ndarray, class_names) -> str:
    lines = []
    for name, acc in zip(class_names, per_class):
        acc_s = "  nan" if np.isnan(acc) else f"{acc:0.3f}"
        lines.append(f"{name:>10s}:\t{acc_s}")
    return "\n".join(lines)


def write_pred_labels(path: str, predictions, labels, class_names) -> None:
    """pred_label.txt: '<pred_name>, <gt_name>' per sample
    (evaluate_scenennobjects.py:209)."""
    with open(path, "w") as f:
        for p, l in zip(predictions, labels):
            f.write(f"{class_names[int(p)]}, {class_names[int(l)]}\n")


def filter_to_mappable_classes(data, labels, *extra):
    """Keep only samples whose ScanObjectNN label maps to ModelNet40 (the 11
    mappable classes, evaluate_real_trained_on_synthetic.py:156-170)."""
    keep = np.isin(np.asarray(labels), list(mappings.OBJECTDATASET_TO_COMBINED))
    out = [np.asarray(data)[keep], np.asarray(labels)[keep]]
    out += [np.asarray(e)[keep] for e in extra]
    return tuple(out)


def _eval_no_shuffle(trainer, state, data, labels, num_votes: int) -> dict:
    """The cross-domain protocols' voting evaluation without shuffling
    (``Trainer.evaluate_auto``)."""
    return trainer.evaluate_auto(state, data, labels, num_votes=num_votes, shuffle=False)


def evaluate_real_trained_on_synthetic(trainer, state, data, labels, num_votes: int = 1) -> dict:
    """A ModelNet40-trained (40-way) model evaluated on ScanObjectNN.

    Predictions over the 40 ModelNet classes are mapped to ScanObjectNN
    labels (many-to-one); unmappable predictions count as wrong."""
    data, labels = filter_to_mappable_classes(data, labels)
    results = _eval_no_shuffle(trainer, state, data, labels, num_votes)
    preds_scan = mappings.modelnet_pred_to_scanobjectnn(results["predictions"])
    gts = results["labels"]
    correct = preds_scan == gts
    results["accuracy"] = float(correct.mean()) if len(correct) else 0.0
    results["mapped_predictions"] = preds_scan
    per_class = {}
    for c in sorted(mappings.OBJECTDATASET_TO_COMBINED):
        sel = gts == c
        if sel.any():
            per_class[c] = float(correct[sel].mean())
    results["per_class_accuracy_mapped"] = per_class
    results["avg_class_accuracy"] = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return results


def evaluate_synthetic_trained_on_real(trainer, state, modelnet_data, modelnet_labels, num_votes: int = 1) -> dict:
    """A ScanObjectNN-trained (15-way) model evaluated on ModelNet40 data.

    Only ModelNet samples with a ScanObjectNN counterpart are kept; a
    prediction is right iff the ModelNet label is one of those accepted for
    the predicted ScanObjectNN class (one-to-many)."""
    keep = np.isin(np.asarray(modelnet_labels), list(mappings.MODELNET_TO_OBJECTDATASET))
    data = np.asarray(modelnet_data)[keep]
    gt_modelnet = np.asarray(modelnet_labels)[keep]
    # Dummy ScanObjectNN labels: only the predictions are read.
    results = _eval_no_shuffle(trainer, state, data, np.zeros(len(data), np.int64), num_votes)
    preds = results["predictions"]
    correct = mappings.is_correct_on_modelnet(preds, gt_modelnet)
    out = {
        "total_seen": len(preds),
        "accuracy": float(correct.mean()) if len(correct) else 0.0,
        "predictions": preds,
        "labels_modelnet": gt_modelnet[: len(preds)],
    }
    per_class = {}
    for m40 in sorted(mappings.MODELNET_TO_OBJECTDATASET):
        sel = out["labels_modelnet"] == m40
        if sel.any():
            per_class[m40] = float(correct[sel].mean())
    out["per_class_accuracy_modelnet"] = per_class
    out["avg_class_accuracy"] = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return out


def confusion_matrix(labels, predictions, num_classes: int, normalize: bool = True) -> np.ndarray:
    """Row-normalised confusion matrix (draw_cmat.py row-normalises
    sklearn's before plotting); rows without samples are 0."""
    cm = np.zeros((num_classes, num_classes), np.float64)
    for l, p in zip(np.asarray(labels), np.asarray(predictions)):
        cm[int(l), int(p)] += 1
    if normalize:
        with np.errstate(divide="ignore", invalid="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
        cm = np.nan_to_num(cm)
    return cm


def dump_error_cases(dump_dir: str, points, predictions, labels, class_names, max_dumps: int = 50) -> int:
    """A three-view depth PNG and a PLY for each misclassified cloud, at
    most ``max_dumps`` (evaluate_scenennobjects.py:211-222 writes JPEG);
    returns how many were written."""
    from scanobjectnn_torch.viz.render import point_cloud_three_views, save_image

    os.makedirs(dump_dir, exist_ok=True)
    error_cnt = 0
    for i, (p, l) in enumerate(zip(predictions, labels)):
        if p == l or error_cnt >= max_dumps:
            continue
        stem = f"{error_cnt}_label_{class_names[int(l)]}_pred_{class_names[int(p)]}"
        save_image(os.path.join(dump_dir, stem + ".png"), point_cloud_three_views(points[i]))
        data_io.save_ply(points[i], os.path.join(dump_dir, stem + ".ply"))
        error_cnt += 1
    return error_cnt


_MASK_COLORS = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])  # background red, foreground blue


def dump_seg_masks(dump_dir: str, points, gt_masks, pred_masks, max_dumps: int = 20) -> int:
    """The ground-truth and predicted binary masks of the first
    ``max_dumps`` clouds as coloured PLY files (evaluate_seg_scenennobjects.py:
    104-137 writes .bin/.obj with the same colours); returns the clouds
    written."""
    os.makedirs(dump_dir, exist_ok=True)
    n = min(len(points), max_dumps)
    for i in range(n):
        for tag, mask in (("gt", gt_masks[i]), ("pred", pred_masks[i])):
            colors = _MASK_COLORS[np.asarray(mask).astype(int).clip(0, 1)]
            data_io.save_ply(points[i], os.path.join(dump_dir, f"{i}_{tag}_mask.ply"), colors=colors)
    return n
