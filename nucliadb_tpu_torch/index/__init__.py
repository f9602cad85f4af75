"""Index implementations of the port: vector, text engine, paragraph and text."""
