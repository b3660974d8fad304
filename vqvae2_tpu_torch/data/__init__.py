"""Datasets and the code store."""
