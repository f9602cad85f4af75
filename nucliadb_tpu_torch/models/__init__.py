"""Data models: the port's copy of the internal index message."""
