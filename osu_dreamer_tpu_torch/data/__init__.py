"""Training data streams (counterpart of osu_dreamer_tpu/data/)."""
