"""Geometry helpers used by the serving path."""
