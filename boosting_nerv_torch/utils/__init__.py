"""Run logging of the port (counterpart of boosting_nerv_tpu/utils/)."""
