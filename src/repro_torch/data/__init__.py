"""Deterministic synthetic data (numpy), as the reference makes it."""
