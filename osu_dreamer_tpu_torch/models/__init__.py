"""The three stages of the model and the composed inference pipeline."""
