"""Models over the maintained walks and beside them; port of
`repro/models/`: the SGNS embeddings of the downstream loop, the
transformer LM family and DLRM (the GNN family is not ported yet)."""
