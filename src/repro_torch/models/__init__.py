"""Models over the maintained walks and beside them; port of
`repro/models/`: the SGNS embeddings of the downstream loop, the
transformer LM family, the GNN family with its neighbor sampler, and
DLRM."""
