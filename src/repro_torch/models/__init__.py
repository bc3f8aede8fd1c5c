"""Models over the maintained walks; port of `repro/models/` (so far the
SGNS embeddings of the downstream loop)."""
