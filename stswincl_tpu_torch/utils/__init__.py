"""Logging of the port (`logging`)."""
