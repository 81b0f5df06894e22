"""Training: schedules and the trainer (counterpart of ``scanobjectnn_tpu/train``)."""
