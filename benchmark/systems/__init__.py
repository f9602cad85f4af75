"""How the benchmark builds and drives each system under test, found by the
``system`` key of a configuration file."""
