"""latent stage."""
