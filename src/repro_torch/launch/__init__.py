"""Entry points; port of `repro/launch/` (so far the training launcher,
`launch/train.py`, for the wharf family)."""
