"""Confusion-matrix plotting (counterpart of
``scanobjectnn_tpu/viz/cmat.py``; ref: pointnet2/draw_cmat.py:26-30 and the
plot block of evaluate_seg_scenennobjects.py:345-375).  ``matplotlib`` is
imported when called; where it is missing the matrix is written as a text
table to ``output_path + ".txt"``, the JAX module's bytes."""

from __future__ import annotations

import numpy as np

from scanobjectnn_torch.data.mappings import SCANOBJECTNN_CLASSES


def plot_confusion_matrix(
    cm: np.ndarray,
    output_path: str,
    num_classes: int = 15,
    class_names=None,
    cmap_name: str = "Blues",
) -> None:
    """``cm`` [C, C] as a heatmap with its values, or the text table."""
    names = list(class_names or SCANOBJECTNN_CLASSES[:num_classes])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        with open(output_path + ".txt", "w") as f:
            f.write("\t" + "\t".join(names) + "\n")
            for name, row in zip(names, cm):
                f.write(name + "\t" + "\t".join(f"{v:.2f}" for v in row) + "\n")
        return

    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.get_cmap(cmap_name))
    fig.colorbar(im, ax=ax, fraction=0.046)
    ticks = np.arange(len(names))
    ax.set_xticks(ticks)
    ax.set_yticks(ticks)
    ax.set_xticklabels(names, rotation=90)
    ax.set_yticklabels(names)
    thresh = cm.max() / 2.0 if cm.size else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            if cm[i, j] >= 0.005:
                ax.text(
                    j, i, f"{cm[i, j]:.2f}",
                    ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black",
                    fontsize=6,
                )
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    fig.tight_layout()
    fig.savefig(output_path)
    plt.close(fig)
