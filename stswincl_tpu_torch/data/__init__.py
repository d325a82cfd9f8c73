"""Dataset constants of the port (the loaders are not ported yet)."""
