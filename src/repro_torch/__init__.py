"""PyTorch/CUDA port of the edge serving path, beside the JAX package.

The layout mirrors the JAX package module for module (``hw``, ``core``,
``plan``, ``models``, ``kernels``, ``obs``, ``serve``, ``deploy``), trimmed to
what the Table-I edge nets need: plan for an NVIDIA H100, quantize, and serve
int8 requests through two hand-written CUDA kernels (``fused_mlp_q8`` for a
whole fusion group, ``gemm_int8`` for single layers and the degraded rung).

This package imports ``torch`` and never ``jax`` or the JAX package.  Every
entry point takes a ``device``: ``None`` means the GPU and raises when there
is none; ``device="cpu"`` runs each kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
