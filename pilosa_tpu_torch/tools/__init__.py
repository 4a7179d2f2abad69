"""Measurement scripts for the port, run from the repository root."""
