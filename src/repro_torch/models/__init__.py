"""Model definitions of the port: the Table-I edge nets (``edge``) and the
Griffin language model (``griffin``, behind ``api``)."""
