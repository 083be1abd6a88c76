"""PyTorch/CUDA port of the JAX package, beside it.

The layout mirrors the JAX package module for module (``hw``, ``core``,
``plan``, ``check``, ``models``, ``configs``, ``kernels``, ``obs``,
``serve``, ``deploy``, ``launch``, ``cli``), trimmed to the ported paths:
the Table-I edge nets (plan for an NVIDIA H100, verify the plan, quantize
with scales calibrated by a float forward through ``fused_dense``, and
serve int8 requests through ``fused_mlp_q8`` and ``gemm_int8``), the
``python -m repro_torch check`` command (whose kernel self-check runs
``tiled_gemm``), and the ``recurrentgemma-2b`` and ``rwkv6-7b`` language
models (forward and continuous-batching serving through
``flash_attention``, ``linear_scan`` and ``rwkv6_scan``), all hand-written
CUDA kernels.

This package imports ``torch`` and never ``jax`` or the JAX package.  Every
entry point takes a ``device``: ``None`` means the GPU and raises when there
is none; ``device="cpu"`` runs each kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
