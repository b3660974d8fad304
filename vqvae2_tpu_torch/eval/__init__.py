"""Retrieval metrics and validation."""
