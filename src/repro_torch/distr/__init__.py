"""The sharded walk engine on `torch.distributed` (port of `repro/distr/`):
one process a shard, rank = shard index. `sharded.py` is the port's
distributed path; `engine.py` keeps the reference's GSPMD engine as what it
computes on one device's state."""
