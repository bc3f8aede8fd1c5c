"""The one traffic generator: a deployment's graph and its update stream,
drawn from `--seed` on the device in a few large calls.

A configuration file names the graph (`graph.kind`, its mean degree and the
vertex count); a traffic file names the stream: R-MAT quadrant weights, the
inserts and deletes of a batch, and how batches arrive. The same
seed gives the same inputs on the same kind of device. Each part of the
inputs has a generator of its own, seeded from (seed, part), so that adding
a part never moves the others.

R-MAT (Chakrabarti et al.) picks one of four quadrants per bit of the vertex
id with weights (a, b, c, d); the paper's update batches use a = 0.5,
b = c = 0.1, d = 0.3, and its er-k graphs the uniform quadrants, which is a
uniform pair of vertices. Deleting an absent edge is a graph no-op, but its
endpoints still count as touched (Wharf's MAV).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

I64 = torch.int64


def sub_seed(seed: int, part: str) -> int:
    """A 63-bit seed for one part of the inputs, from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}/{part}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, part: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, part))
    return gen


def log2_exact(n: int) -> int:
    k = int(n).bit_length() - 1
    if n <= 0 or 1 << k != n:
        raise ValueError(f"vertex count {n} is not a power of two")
    return k


def rmat(gen: torch.Generator, n_edges: int, log2_n: int, weights,
         device) -> tuple[torch.Tensor, torch.Tensor]:
    """n_edges R-MAT (src, dst) pairs over 2^log2_n vertices, int64."""
    a, b, c, d = (float(w) for w in weights)
    total = a + b + c + d
    cuts = torch.tensor([a / total, (a + b) / total, (a + b + c) / total],
                        dtype=torch.float64, device=device)
    src = torch.zeros(n_edges, dtype=I64, device=device)
    dst = torch.zeros(n_edges, dtype=I64, device=device)
    for _ in range(log2_n):
        u = torch.rand(n_edges, generator=gen, dtype=torch.float64,
                       device=device)
        q = (u[:, None] >= cuts[None]).sum(dim=1)
        src = (src << 1) | (q >= 2).to(I64)
        dst = (dst << 1) | (q % 2).to(I64)
    return src, dst


def graph_edges(cfg: dict, seed: int, device):
    """The configuration's initial graph as undirected (src, dst) pairs."""
    g = cfg["graph"]
    n = cfg["n_vertices"]
    m = n * g["mean_degree"] // 2
    gen = generator(seed, "graph", device)
    if g["kind"] == "er":
        # the er-k graphs are R-MAT with uniform quadrants: a uniform pair
        src = torch.randint(0, n, (m,), generator=gen, device=device)
        dst = torch.randint(0, n, (m,), generator=gen, device=device)
        return src, dst
    if g["kind"] == "rmat":
        return rmat(gen, m, log2_exact(n), g["rmat"], device)
    raise ValueError(f"unknown graph kind {g['kind']!r}")


@dataclass
class Stream:
    """[n_batches, inserts] and [n_batches, deletes] int64 edge batches and
    one walk key (two u32 words, int64) a batch."""

    ins_src: torch.Tensor
    ins_dst: torch.Tensor
    del_src: torch.Tensor
    del_dst: torch.Tensor
    keys: torch.Tensor

    @property
    def n_batches(self) -> int:
        return self.ins_src.shape[0]

    def batch(self, i: int):
        """Batch i as [1, width] slices (the entry takes a stream)."""
        return (self.keys[i], self.ins_src[i:i + 1], self.ins_dst[i:i + 1],
                self.del_src[i:i + 1], self.del_dst[i:i + 1])

    @property
    def edges_per_batch(self) -> int:
        return self.ins_src.shape[1] + self.del_src.shape[1]


def update_stream(cfg: dict, traffic: dict, seed: int, n_batches: int,
                  device) -> Stream:
    """`n_batches` batches of the traffic's R-MAT inserts and deletes over
    the configuration's vertices, drawn in one call per part and bit."""
    log2_n = log2_exact(cfg["n_vertices"])
    n_ins, n_del = traffic["inserts"], traffic["deletes"]
    w = traffic["rmat"]
    s, d = rmat(generator(seed, "inserts", device), n_batches * n_ins, log2_n,
                w, device)
    ins = s.reshape(n_batches, n_ins), d.reshape(n_batches, n_ins)
    s, d = rmat(generator(seed, "deletes", device), n_batches * n_del, log2_n,
                w, device)
    dele = s.reshape(n_batches, n_del), d.reshape(n_batches, n_del)
    keys = torch.randint(0, 1 << 32, (n_batches, 2), dtype=I64,
                         generator=generator(seed, "walk-keys", device),
                         device=device)
    return Stream(*ins, *dele, keys)


def corpus_key(seed: int, device) -> torch.Tensor:
    """The key the walk corpus is drawn with (two u32 words, int64)."""
    return torch.randint(0, 1 << 32, (2,), dtype=I64,
                         generator=generator(seed, "corpus-key", device),
                         device=device)


def max_batches(cfg: dict, traffic: dict) -> int:
    """The most batches a run may send: the graph's edge capacity holds the
    initial graph and every insert of that many batches in both directions,
    counted as if none were a duplicate, so no insert is ever cut off."""
    n = cfg["n_vertices"]
    initial = 2 * (n * cfg["graph"]["mean_degree"] // 2)
    room = cfg["edge_capacity"] - initial
    per_batch = 2 * traffic["inserts"]
    return room // per_batch if per_batch else 1 << 20
