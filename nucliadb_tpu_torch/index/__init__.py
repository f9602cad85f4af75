"""Index implementations of the port (vector only, so far)."""
