"""Model definitions of the port: the Table-I edge nets (``edge``) and the
dense transformer, Griffin and RWKV-6 language models (``transformer``,
``griffin``, ``rwkv``, behind ``api``)."""
