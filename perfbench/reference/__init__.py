"""Plain references that judge what a run produced."""
