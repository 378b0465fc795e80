"""Skyrise reproduction on PyTorch and CUDA (one NVIDIA H100).

The port of the ``repro`` package: the SQL front end and planner, the
serverless coordinator and fragment workers are host copies; the
execution layer runs on torch tensors, and the fused scan-aggregate
kernels are hand-written CUDA for Hopper. It imports neither ``jax`` nor
``repro``. Entry point: :func:`repro_torch.api.connect`.
"""
