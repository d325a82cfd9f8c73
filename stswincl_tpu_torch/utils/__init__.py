"""Utilities of the port: logging (`logging`) and profiling
(`profiling`)."""
