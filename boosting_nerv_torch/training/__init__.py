"""Training of the port: schedules, the Adan optimizer, checkpoints and the
regression trainer (counterparts of boosting_nerv_tpu/training/)."""
