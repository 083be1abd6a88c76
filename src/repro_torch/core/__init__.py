"""Cost models behind the planner: DR7' fusion (``boundary``) and the
``gemm_int8`` tile search (``tiling``)."""
