"""Serving runtime of the port (counterpart of boosting_nerv_tpu/runtime)."""
