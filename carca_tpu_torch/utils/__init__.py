"""Masking and initializer helpers."""
