"""Timing and tracing on the card."""
