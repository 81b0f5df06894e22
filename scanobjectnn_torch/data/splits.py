"""Split files and metadata of the ScanObjectNN benchmark (counterpart of
``scanobjectnn_tpu/data/splits.py``).

Behavioural reference: training_data/ (README.md:9-12).  ``main_split.txt``
and ``split1..4.txt`` hold tab-separated ``<file.bin>\\t<label>[\\t t]``
lines, a trailing ``t`` marking a test object; ``object_labels.txt`` is the
object registry ``<scene> <obj_id> <class_name> <size>``;
``shape_names_ext.txt`` lists the 15 class names in label order;
``part_labels/*_meta.xml`` holds the part colormaps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = [
    "SplitEntry",
    "default_training_data_dir",
    "load_class_names",
    "load_object_labels",
    "load_part_colormap",
    "load_split",
    "split_train_test",
]


@dataclass(frozen=True)
class SplitEntry:
    filename: str
    label: int
    is_test: bool


def load_split(path: str) -> list[SplitEntry]:
    """A split file's entries, blank lines skipped (a ``t`` in the third
    field marks a test object)."""
    entries: list[SplitEntry] = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            entries.append(SplitEntry(filename=parts[0], label=int(parts[1]),
                                      is_test=len(parts) > 2 and parts[2].strip() == "t"))
    return entries


def split_train_test(entries: list[SplitEntry]) -> tuple[list[SplitEntry], list[SplitEntry]]:
    """(training entries, test entries), each in file order."""
    return [e for e in entries if not e.is_test], [e for e in entries if e.is_test]


def load_class_names(path: str) -> list[str]:
    """A shape-names file: one class a line, the index its label; blank lines
    skipped."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_object_labels(path: str) -> list[dict]:
    """object_labels.txt's rows (scene, object id, class name, point count);
    lines of fewer than four fields skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            rows.append({"scene": parts[0], "object_id": parts[1], "class_name": parts[2],
                         "num_points": int(parts[3])})
    return rows


def default_training_data_dir() -> str | None:
    """The training_data/ directory ``$SCANOBJECTNN_TRAINING_DATA`` names, if
    it is one."""
    env = os.environ.get("SCANOBJECTNN_TRAINING_DATA")
    if env and os.path.isdir(env):
        return env
    return None


def load_part_colormap(path: str) -> list[dict]:
    """A part_labels/*_meta.xml colormap: each part's id, text and RGB color."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    return [{"id": int(node.get("id")), "text": node.get("text"),
             "color": tuple(int(v) for v in node.get("color").split())} for node in root.findall("class")]
