"""Audio constants and the resonator spectrogram."""
