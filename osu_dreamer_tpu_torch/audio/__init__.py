"""Audio constants, decoding and the resonator spectrogram."""
