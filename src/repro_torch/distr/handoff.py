"""Cross-shard walk-continuation handoff (port of `repro/distr/handoff.py`).

A rewalk lane whose next vertex another shard owns continues there. Every
rewalk step, every shard routes each active lane to the owner of its next
vertex (`shard_of_vertex`), compacts the lanes into fixed-size slabs, one
row a destination (`core.corpus.compact_lanes_by_shard`), exchanges the
slabs with ONE `all_to_all` (a lane staying local rides its own shard's
row), and scatters the received (lane id, vertex) pairs back into the full
[capacity] lane vector. The wire cost a step is n_shards * slab * 8 bytes
a shard. A destination given more than `slab` lanes sets the sticky
overflow flag.
"""
from __future__ import annotations

import torch

from repro_torch._u64 import u32_bits, u32_value
from repro_torch.core.corpus import compact_lanes_by_shard
from repro_torch.distr import collectives


def shard_of_vertex(v, vps: int) -> torch.Tensor:
    """Vertex-range owner: shard k owns [k*vps, (k+1)*vps)."""
    return v.to(torch.int64) // vps


def exchange_frontier(dest, nxt, n_shards: int, slab: int, group=None):
    """Route the active lanes to their owner shards; return the lanes
    received here.

    dest: int64 [capacity] destination shard a lane (`n_shards`: the lane
    does not continue); nxt: int64 [capacity] its next vertex. Returns
    (cur int64 [capacity], mine bool [capacity], overflow bool []):
    `mine[i]` iff lane i continues on this shard, at vertex `cur[i]`;
    lanes received nowhere have cur 0. (lane id, vertex) go as one int32
    [n_shards, slab, 2] tensor (u32 bits), the sentinel lane id
    `capacity` on unused rows."""
    capacity = dest.shape[0]
    send_lane, overflow = compact_lanes_by_shard(dest, n_shards, slab)
    gid = send_lane.reshape(-1)
    payload = nxt[gid.clamp(0, capacity - 1)]
    packed = torch.stack([gid, payload], dim=-1)
    packed = u32_bits(torch.where((gid < capacity)[:, None], packed, capacity))
    recv = collectives.all_to_all(packed, group)
    rgid = u32_value(recv[:, 0])     # sentinel = capacity: the scratch row
    cur = torch.zeros((capacity + 1,), dtype=torch.int64, device=dest.device)
    cur[rgid] = u32_value(recv[:, 1])
    mine = torch.zeros((capacity + 1,), dtype=torch.bool, device=dest.device)
    mine[rgid] = True
    return cur[:capacity], mine[:capacity], overflow
