"""Per-model training recipes (counterpart of
``scanobjectnn_tpu/models/recipes.py``).

PointCNN's settings modules carry a training schedule beside the
architecture (PointCNN/pointcnn_cls/modelnet_x3_l4.py:25-46,
pointcnn_seg/object_dataset_x3.py:27-42): a staircase LR decay over global
steps with a floor, L2 weight decay, Adam epsilon 1e-2, and in-graph
augmentation ranges (PointCNN/train.py:125-172).  A model class that ships
one carries it as ``recipe`` (``PointCNNSetting.recipe()``); the ``Trainer``
honours it unless ``TrainerConfig.use_model_recipe`` is False.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["TrainRecipe"]


@dataclass(frozen=True)
class TrainRecipe:
    """What the ``Trainer`` takes from a recipe: LR(step) = max(base ·
    rate^floor(step / decay_steps), min), tf.train.exponential_decay on the
    global step (PointCNN/train.py:160-162); Adam's epsilon and L2 weight
    decay; and the ranges of pointfly.augment's per-cloud transform and
    jitter."""

    learning_rate_base: float
    decay_steps: int
    decay_rate: float
    learning_rate_min: float
    weight_decay: float
    adam_epsilon: float
    jitter: float
    rotation_range: tuple
    scaling_range: tuple
