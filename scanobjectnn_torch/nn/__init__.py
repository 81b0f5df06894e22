"""Layers and PointNet++ modules (counterpart of ``scanobjectnn_tpu/nn``)."""
