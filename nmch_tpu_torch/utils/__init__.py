"""Timing helpers."""
