"""The hot ops: each a hand-written CUDA kernel beside its plain PyTorch version."""
