"""Measurement tools of the port, run on a machine with an NVIDIA card."""
