"""Batch augmentations (counterpart of ``scanobjectnn_tpu/augment``)."""
