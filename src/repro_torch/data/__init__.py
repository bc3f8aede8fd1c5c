"""Synthetic graph and token streams (port of `repro/data`)."""
