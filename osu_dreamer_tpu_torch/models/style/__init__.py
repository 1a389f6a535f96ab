"""style stage."""
