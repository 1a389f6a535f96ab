"""inference stage."""
