"""Operators of the port that run a hand-written CUDA kernel on the card
and a plain PyTorch version on the CPU."""
