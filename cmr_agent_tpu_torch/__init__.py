"""PyTorch + CUDA port of cmr_agent_tpu for NVIDIA Hopper (H100).

The serving path of the JAX package (KITTI geo forward + the deterministic
10-step refinement episode) with its four TPU kernels rewritten by hand in
CUDA C++ (``csrc/``). The JAX package stays the reference; this package
imports nothing of it. Entry points: :mod:`cmr_agent_tpu_torch.serve` and the
evaluation CLIs of :mod:`cmr_agent_tpu_torch.cli`.
"""
