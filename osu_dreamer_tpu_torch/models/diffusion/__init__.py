"""diffusion stage."""
