"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``fused_mlp`` (``csrc/fused_mlp_q8.cu``), ``gemm_int8``
(``csrc/gemm_int8.cu``), ``flash_attention`` (``csrc/flash_attention.cu``),
``rglru`` (``csrc/linear_scan.cu``), ``rwkv6`` (``csrc/rwkv6_scan.cu``; its
backward ``csrc/rwkv6_scan_bwd.cu``),
``tiled_gemm`` (``csrc/tiled_gemm.cu``) and ``fused_dense``
(``csrc/fused_dense.cu``; the last two share ``csrc/gemm_tile.cuh``).
``ops`` dispatches on the tensor's device; ``build`` compiles the sources at
first use."""
