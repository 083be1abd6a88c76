"""Model definitions of the port: the Table-I edge nets (``edge``) and the
Griffin and RWKV-6 language models (``griffin``, ``rwkv``, behind
``api``)."""
