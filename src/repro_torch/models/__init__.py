"""Model definitions of the port (the Table-I edge nets)."""
