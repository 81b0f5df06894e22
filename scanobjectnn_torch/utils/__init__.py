"""Logging and profiling helpers (counterpart of ``scanobjectnn_tpu/utils``)."""
