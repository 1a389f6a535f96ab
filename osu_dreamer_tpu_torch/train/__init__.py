"""Training infrastructure (counterpart of osu_dreamer_tpu/train/)."""
