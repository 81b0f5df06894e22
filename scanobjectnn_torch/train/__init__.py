"""Training: schedules, the trainer, the evaluation protocols and the command
line (counterpart of ``scanobjectnn_tpu/train``)."""
