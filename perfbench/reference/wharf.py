"""The plain reference of Wharf's streaming walks, in plain PyTorch.

It works out again, from the inputs the harness generated, what the system
under test derives, and judges the system's outputs against that:

* Graph: the undirected edge set after each batch (deletes, then inserts;
  a duplicate insert or an absent delete changes nothing), as sorted
  directed codes `src << 32 | dst`.
* MAV: a walk is affected by a batch if it visits an endpoint of one of the
  batch's edges, and its first affected position p_min is its first visit.
* Walks: every walk starts at its own vertex (walk w at w // n_w) and every
  step is an edge of the current graph (an isolated vertex stays put).
  A batch re-samples an affected walk from p_min on and keeps positions
  0..p_min; an unaffected walk stays as it was.
* Store: a merged store holds every corpus slot (w, p) exactly once, as the
  triplet (vertex at p, Szudzik pair of (w * l + p, vertex at p + 1)), the
  last one pointing to itself, each live at its slot's epoch.
* Re-walk: an affected walk with at least STALE_STEPS positions after
  p_min is re-sampled there; on a graph of mean degree 100 a re-walk
  repeats all of those positions with a chance of about 100^-4, so a walk
  whose positions after p_min all stay as they were was not re-walked.
* Law (order 1): DeepWalk steps to a neighbour drawn uniformly; the rank of
  the next vertex in its current vertex's sorted neighbour list, over the
  degree, falls in each tenth of [0, 1) as often as the ranks in it.
* Law (order 2): node2vec(p, q) steps from cur with previous vertex prev to
  a neighbor x with weight 1/p if x == prev, 1 if x is a neighbor of prev,
  1/q otherwise; exact where deg(cur) and deg(prev) are at most dmax, else
  the K-trial rejection sampler (first accepted proposal, else the last).

It reads the system's outputs only to judge them and imports nothing of the
system. Codes come as the system stores them: u64 values held in int64 as
`value XOR 2^63`.
"""
from __future__ import annotations

import math

import torch

I64 = torch.int64
I32 = torch.int32
FLIP = -(1 << 63)          # XOR with this maps a biased int64 to its u64 bits
LOW32 = (1 << 32) - 1
BLOCK = 1 << 24            # elements a block of the larger passes
STALE_STEPS = 4            # re-sampled positions a stale walk must keep


# ------------------------------------------------------------------ codes


def unbias(code: torch.Tensor) -> torch.Tensor:
    return code ^ FLIP


def isqrt(z: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(z)) of int64 z in [0, 2^62), exact."""
    s = torch.sqrt(z.to(torch.float64)).to(I64)
    for _ in range(2):
        s = torch.where(s * s > z, s - 1, s)
        s = torch.where((s + 1) * (s + 1) <= z, s + 1, s)
    return s


def unpair(z: torch.Tensor):
    """Szudzik's pairing inverted: z -> (x, y) with pair(x, y) = z, where
    pair(x, y) = y * y + x if x < y else x * x + x + y."""
    s = isqrt(z)
    r = z - s * s
    low = r < s
    return torch.where(low, r, s), torch.where(low, s, r - s)


# ------------------------------------------------------------------ graph


def directed(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Both directions of each undirected pair as codes src << 32 | dst."""
    src, dst = src.to(I64), dst.to(I64)
    return torch.cat([(src << 32) | dst, (dst << 32) | src])


class Graph:
    """A sorted set of directed edge codes and its CSR view."""

    def __init__(self, codes: torch.Tensor, n_vertices: int):
        self.codes = codes
        self.n = n_vertices
        src = codes >> 32
        bounds = torch.arange(n_vertices + 1, dtype=I64, device=codes.device)
        self.offsets = torch.searchsorted(src, bounds)
        self.deg = self.offsets[1:] - self.offsets[:-1]

    @staticmethod
    def from_pairs(src, dst, n_vertices: int) -> "Graph":
        return Graph(torch.unique(directed(src, dst)), n_vertices)

    def apply(self, ins_src, ins_dst, del_src, del_dst) -> "Graph":
        codes = self.codes
        if del_src.numel():
            gone = torch.unique(directed(del_src, del_dst))
            codes = codes[~torch.isin(codes, gone)]
        if ins_src.numel():
            codes = torch.unique(torch.cat([codes, directed(ins_src, ins_dst)]))
        return Graph(codes, self.n)

    def has_edge(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q = (u.to(I64) << 32) | v.to(I64)
        out = torch.empty(q.shape, dtype=torch.bool, device=q.device)
        flat, res = q.reshape(-1), out.reshape(-1)
        for s in range(0, flat.numel(), BLOCK):
            part = flat[s:s + BLOCK]
            pos = torch.searchsorted(self.codes, part).clamp(
                max=self.codes.numel() - 1)
            res[s:s + BLOCK] = self.codes[pos] == part
        return out


def graph_diff(ref: Graph, port_codes: torch.Tensor,
               port_offsets: torch.Tensor) -> int:
    """Edges in one graph and not the other, plus vertices whose CSR
    segment bounds differ. `port_codes` are the system's live codes."""
    mine = unbias(port_codes)
    both = torch.sort(torch.cat([ref.codes, mine])).values
    if both.numel() == 0:
        return 0
    same_next = torch.zeros_like(both, dtype=torch.bool)
    same_next[:-1] = both[1:] == both[:-1]
    same_prev = torch.zeros_like(same_next)
    same_prev[1:] = same_next[:-1]
    lonely = int((~same_next & ~same_prev).sum())
    dup_mine = int((mine[1:] == mine[:-1]).sum()) if mine.numel() > 1 else 0
    bounds = port_offsets.to(I64)
    seg = int((bounds != ref.offsets).sum()) if bounds.shape == ref.offsets.shape \
        else ref.n + 1
    return lonely + dup_mine + seg


# ------------------------------------------------------------------ walks


def touched(n_vertices: int, device, *ids) -> torch.Tensor:
    t = torch.zeros(n_vertices, dtype=torch.bool, device=device)
    for x in ids:
        if x.numel():
            t[x.reshape(-1).to(I64)] = True
    return t


def first_touch(walks: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Each walk's first position on a vertex marked in `hit`, or its length
    when it has none."""
    n_walks, length = walks.shape
    out = torch.full((n_walks,), length, dtype=I64, device=walks.device)
    rows = max(1, BLOCK // length)
    for s in range(0, n_walks, rows):
        h = hit[walks[s:s + rows].to(I64)]
        first = torch.argmax(h.to(torch.int8), dim=1)
        out[s:s + rows] = torch.where(h.any(dim=1), first, length)
    return out


def invalid_steps(walks: torch.Tensor, g: Graph, n_per_vertex: int) -> int:
    """Walks that start elsewhere than their own vertex, plus steps that are
    no edge of `g` (a step from an isolated vertex must stay put)."""
    n_walks, length = walks.shape
    bad = 0
    rows = max(1, BLOCK // length)
    for s in range(0, n_walks, rows):
        w = walks[s:s + rows].to(I64)
        own = torch.arange(s, s + w.shape[0], device=w.device) // n_per_vertex
        bad += int((w[:, 0] != own).sum())
        u, v = w[:, :-1], w[:, 1:]
        ok = g.has_edge(u, v) | ((g.deg[u] == 0) & (v == u))
        bad += int((~ok).sum())
    return bad


def prefix_diff(before: torch.Tensor, after: torch.Tensor,
                p_min: torch.Tensor) -> int:
    """Walks whose positions 0..p_min changed (all positions of a walk that
    the batch left unaffected, p_min = l)."""
    n_walks, length = before.shape
    bad = 0
    rows = max(1, BLOCK // length)
    pos = torch.arange(length, device=before.device)
    for s in range(0, n_walks, rows):
        keep = pos[None] <= p_min[s:s + rows, None]
        changed = (before[s:s + rows] != after[s:s + rows]) & keep
        bad += int(changed.any(dim=1).sum())
    return bad


def stale_walks(before: torch.Tensor, after: torch.Tensor,
                p_min: torch.Tensor, steps: int = STALE_STEPS) -> int:
    """Walks that the batch affected with at least `steps` positions after
    p_min, every one of which is as it was before the batch."""
    n_walks, length = before.shape
    bad = 0
    rows = max(1, BLOCK // length)
    pos = torch.arange(length, device=before.device)
    for s in range(0, n_walks, rows):
        pm = p_min[s:s + rows]
        tail = pos[None] > pm[:, None]
        same = ((before[s:s + rows] == after[s:s + rows]) | ~tail).all(dim=1)
        bad += int((same & (pm <= length - 1 - steps)).sum())
    return bad


def store_diff(owner: torch.Tensor, code: torch.Tensor, epoch: torch.Tensor,
               slot_epoch: torch.Tensor, walks: torch.Tensor) -> int:
    """Slots not held exactly once by the store's rows, plus rows whose
    vertex, next vertex or epoch disagree with `walks`."""
    n_walks, length = walks.shape
    n_slots = n_walks * length
    flat = walks.reshape(-1).to(I64)
    count = torch.zeros(n_slots + 1, dtype=I32, device=walks.device)
    bad = 0
    for s in range(0, code.numel(), BLOCK):
        f, nxt = unpair(unbias(code[s:s + BLOCK]))
        inside = (f >= 0) & (f < n_slots)
        fc = torch.where(inside, f, n_slots)
        count.index_add_(0, fc, torch.ones_like(fc, dtype=I32))
        fi = fc.clamp(max=n_slots - 1)
        last = (fi % length) == length - 1
        want_next = torch.where(last, flat[fi], flat[(fi + 1).clamp(max=n_slots - 1)])
        ok = (inside & (owner[s:s + BLOCK].to(I64) == flat[fi])
              & (nxt == want_next) & (epoch[s:s + BLOCK] == slot_epoch[fi]))
        bad += int((~ok).sum())
    return bad + int((count[:n_slots] != 1).sum()) + int(count[n_slots])


# ------------------------------------------------------------------ law


def rank_law_z(g: Graph, walks: torch.Tensor, w: torch.Tensor,
               pos: torch.Tensor) -> float:
    """DeepWalk's step law over the steps pos -> pos + 1 of walks w: the
    largest |z| over the ten deciles of rank / deg, where rank is the next
    vertex's place in the current vertex's sorted neighbour list. Each
    step's decile k has the probability (ceil((k+1) d / 10) - ceil(k d / 10))
    / d under the uniform law. Steps from an isolated vertex, and steps that
    are no edge (counted by `invalid_steps`), are left out."""
    walks = walks.to(I64)
    cur, nxt = walks[w, pos], walks[w, pos + 1]
    code = (cur << 32) | nxt
    at = torch.searchsorted(g.codes, code).clamp(max=g.codes.numel() - 1)
    keep = (g.deg[cur] > 0) & (g.codes[at] == code)
    cur, at = cur[keep], at[keep]
    if cur.numel() == 0:
        return math.inf
    d = g.deg[cur]
    rank = at - g.offsets[cur]
    k = torch.arange(11, device=cur.device)
    lo = (k[None] * d[:, None] + 9) // 10                 # ceil(k d / 10)
    pr = (lo[:, 1:] - lo[:, :-1]).to(torch.float64) / d[:, None].to(torch.float64)
    obs = torch.bincount((10 * rank) // d, minlength=10).to(torch.float64)
    exp = pr.sum(dim=0)
    var = (pr * (1 - pr)).sum(dim=0)
    gap = (obs - exp).abs()
    z = torch.where(var > 0, gap / var.sqrt(),
                    torch.where(gap > 0.5, math.inf, 0.0))
    return float(z.max())


def node2vec_classes(g: Graph, prev, cur, nxt):
    """The class of each step (0: back to prev, 1: to a neighbor of prev,
    2: elsewhere) and the class counts among cur's neighbors: n0 (prev is
    a neighbor), n1 (neighbors of prev other than prev), n2 (the rest)."""
    cls = torch.where(nxt == prev, 0,
                      torch.where(g.has_edge(prev, nxt), 1, 2))
    d = g.deg[cur]
    n0 = g.has_edge(cur, prev).to(I64)
    n1 = torch.zeros_like(d)
    width = int(d.max()) if d.numel() else 0
    rows = max(1, BLOCK // max(width, 1))
    col = torch.arange(width, device=cur.device)
    for s in range(0, cur.numel(), rows):
        c, p, dd = cur[s:s + rows], prev[s:s + rows], d[s:s + rows]
        idx = (g.offsets[c][:, None] + col[None]).clamp(max=g.codes.numel() - 1)
        x = g.codes[idx] & LOW32
        live = col[None] < dd[:, None]
        member = live & (x != p[:, None]) & g.has_edge(p[:, None].expand_as(x), x)
        n1[s:s + rows] = member.sum(dim=1)
    return cls, n0, n1, d - n0 - n1


def node2vec_probs(g: Graph, prev, cur, n0, n1, n2, p: float, q: float,
                   dmax: int, n_trials: int) -> torch.Tensor:
    """[B, 3] class probabilities of each step under the sampler that the
    configuration states for it."""
    f64 = torch.float64
    d = (n0 + n1 + n2).to(f64)
    m = torch.stack([n0.to(f64) / p, n1.to(f64), n2.to(f64) / q], dim=1)
    exact = m / m.sum(dim=1, keepdim=True)
    a_max = max(1.0 / p, 1.0, 1.0 / q)
    accept = m.sum(dim=1) / (a_max * d)                 # one trial accepts
    miss = (1.0 - accept) ** (n_trials - 1)            # the first K-1 miss
    geo = (1.0 - miss) / accept
    counts = torch.stack([n0, n1, n2], dim=1).to(f64)
    rejection = (m / (a_max * d[:, None])) * geo[:, None] \
        + miss[:, None] * counts / d[:, None]
    hub = (g.deg[cur] > dmax) | (g.deg[prev] > dmax)
    return torch.where(hub[:, None], rejection, exact)


def law_z(g: Graph, walks: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
          model: dict) -> float:
    """The largest |z| over the three classes of the steps pos -> pos + 1 of
    walks w: observed count against the sum of the probabilities that the
    law gives each step, over the root of the sum of their variances.
    Steps that start their walk or sit on an isolated vertex are left out."""
    walks = walks.to(I64)
    prev, cur, nxt = walks[w, pos - 1], walks[w, pos], walks[w, pos + 1]
    keep = (pos >= 1) & (prev != cur) & (g.deg[cur] > 0)
    prev, cur, nxt = prev[keep], cur[keep], nxt[keep]
    if prev.numel() == 0:
        return math.inf
    cls, n0, n1, n2 = node2vec_classes(g, prev, cur, nxt)
    pr = node2vec_probs(g, prev, cur, n0, n1, n2, model["p"], model["q"],
                        model["dmax"], model["n_trials"])
    obs = torch.stack([(cls == k).sum() for k in range(3)]).to(torch.float64)
    exp = pr.sum(dim=0)
    var = (pr * (1 - pr)).sum(dim=0)
    gap = (obs - exp).abs()
    z = torch.where(var > 0, gap / var.sqrt(),
                    torch.where(gap > 0.5, math.inf, 0.0))
    return float(z.max())


def law_sample(p_min: torch.Tensor, length: int, n: int,
               gen: torch.Generator):
    """`n` re-sampled steps of a batch, drawn with `gen` whatever the steps
    turned out to be: a walk among those the batch affected (p_min <= l - 2),
    then a position in [max(p_min, 1), l - 2]. -> (walk, position)."""
    dev = p_min.device
    cand = torch.nonzero(p_min <= length - 2).reshape(-1)
    if cand.numel() == 0:
        return cand, cand
    w = cand[torch.randint(0, cand.numel(), (n,), generator=gen, device=dev)]
    lo = p_min[w].clamp(min=1)
    span = (length - 1 - lo).clamp(min=1)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    pos = (lo + (u * span).to(I64)).clamp(max=length - 2)
    return w, pos


def prefix_sample(p_min: torch.Tensor, length: int, n: int,
                  gen: torch.Generator):
    """Up to `n` first re-sampled steps (pos = p_min, 1 <= p_min <= l - 2):
    the step whose previous vertex the system read back through its
    stored prefix."""
    dev = p_min.device
    cand = torch.nonzero((p_min >= 1) & (p_min <= length - 2)).reshape(-1)
    if cand.numel() > n:
        cand = cand[torch.randperm(cand.numel(), generator=gen,
                                   device=dev)[:n]]
    return cand, p_min[cand]


# ------------------------------------------------------------------ judge


def judge(pairs, batches, n_window: int, port: dict, cfg: dict,
          gen: torch.Generator) -> dict:
    """Every number that decides `correct`, from the generated inputs and
    the system's outputs.

    pairs: the initial graph's (src, dst). batches: (ins_src, ins_dst,
    del_src, del_dst) of the warm-up batch, the `n_window` batches of the
    window and the check batch after it, in order. port: what the system
    produced: its graph after the check batch (`graph_codes`, live codes,
    and `graph_offsets`); its walks read back after the window
    (`walks_end`), after the check batch (`walks_check`) and after the
    merge that followed (`walks_merged`); the merged store's rows
    (`owner`, `code`, `epoch`, `slot_epoch`); the affected counts it
    returned for the window's last batch (`affected_last`) and the check
    batch (`affected_check`), and the check batch's affected walks and
    positions (`check_walks`, `check_p_min`)."""
    n = cfg["n_vertices"]
    n_w = cfg["n_walks_per_vertex"]
    model = cfg["model"]
    dev = port["walks_end"].device
    g = Graph.from_pairs(*pairs, n)
    for b in batches[:n_window + 1]:
        g = g.apply(*b)
    g_end = g
    g_check = g.apply(*batches[n_window + 1])

    w_end, w_check = port["walks_end"], port["walks_check"]
    out = {}
    out["graph_diff"] = graph_diff(g_check, port["graph_codes"],
                                   port["graph_offsets"])
    out["walk_invalid"] = (invalid_steps(w_end, g_end, n_w)
                           + invalid_steps(w_check, g_check, n_w)
                           + invalid_steps(port["walks_merged"], g_check, n_w))

    last = batches[n_window]
    hit_last = touched(n, dev, *last)
    ref_last = int((first_touch(w_end, hit_last) < w_end.shape[1]).sum())
    hit = touched(n, dev, *batches[n_window + 1])
    p_min = first_touch(w_end, hit)
    length = w_end.shape[1]
    mine = torch.full_like(p_min, length)
    mine[port["check_walks"].to(I64)] = port["check_p_min"].to(I64)
    out["mav_diff"] = (abs(ref_last - int(port["affected_last"]))
                       + abs(int((p_min < length).sum())
                             - int(port["affected_check"]))
                       + int((mine != p_min).sum()))
    out["prefix_diff"] = prefix_diff(w_end, w_check, p_min)
    out["stale_walks"] = stale_walks(w_end, w_check, p_min)
    out["store_diff"] = (store_diff(port["owner"], port["code"], port["epoch"],
                                    port["slot_epoch"], w_check)
                         + int((port["walks_merged"] != w_check).any(dim=1).sum()))
    n_law = cfg["check"]["law_samples"]
    w, pos = law_sample(p_min, length, n_law, gen)
    if model["order"] == 1:
        out["rank_law_z"] = rank_law_z(g_check, w_check, w, pos)
    else:
        out["law_z"] = law_z(g_check, w_check, w, pos, model)
        w, pos = prefix_sample(p_min, length, n_law, gen)
        out["prefix_law_z"] = law_z(g_check, w_check, w, pos, model)
    return out
