"""Tensor ops and the hand-written kernels of the serving path."""
