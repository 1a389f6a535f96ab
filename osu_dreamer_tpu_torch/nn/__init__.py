"""Neural network building blocks (channel-last)."""
