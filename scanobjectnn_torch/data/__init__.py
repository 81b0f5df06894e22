"""Datasets for the port (numpy only)."""
