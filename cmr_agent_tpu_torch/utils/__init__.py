"""Timing and tracing helpers of the port."""
