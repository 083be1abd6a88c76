"""Deterministic synthetic data for the port's training path."""
