"""CPU tests of the benchmark (run with ``python -m pytest benchmark/tests``);
the card's tests carry the ``cuda`` marker."""
