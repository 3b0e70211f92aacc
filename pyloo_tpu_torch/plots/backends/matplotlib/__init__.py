"""Matplotlib plot backend."""
