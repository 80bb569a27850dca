"""The benchmark's read generator: a circular genome and CLR-like reads,
made on the device from the run's seed with one torch.Generator, then
copied to the host once.

The model is the repository simulator's (gamma(3) lengths, uniform start
and strand on a circular genome, per-base errors split into insertions,
deletions and substitutions), rewritten as bulk tensor operations so that
set-up makes hundreds of Mbp in seconds.  The program under test receives
only the reads; the genome and each read's span stay here as the ground
truth that the reference's recall check reads.

A configuration file's "genome" and "reads" groups give the parameters:

  genome: {"bp", "repeat_copies", "repeat_bp"}
  reads:  {"coverage", "mean_bp", "min_bp", "max_bp", "error",
           "ins_share", "del_share", "max_total_bp"}

max_total_bp (optional) stops the reads at that many bases: a cell that
holds only some blocks of a deployment makes only their reads, which are
a uniform sample of all of them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# bases of read spans processed at once (bounds the generator's memory)
CHUNK_BP = 1 << 25


@dataclass
class Reads:
    """Reads as the host holds them, with their ground truth."""
    bases: np.ndarray      # uint8 codes 0..3, all reads concatenated
    offsets: np.ndarray    # int64 [n + 1]
    start: np.ndarray      # int64 genome start of each read's span
    span: np.ndarray       # int64 span length on the genome
    strand: np.ndarray     # int8, 1 = reverse complement
    genome_bp: int
    # genome start of each planted repeat copy, and the copies' length
    repeat_starts: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    repeat_bp: int = 0

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def read(self, i: int) -> np.ndarray:
        return self.bases[self.offsets[i]:self.offsets[i + 1]]


def seed_words(seed: int, tag: int) -> list[int]:
    """A run's seed (any whole number) and a tag as the words of a numpy
    seed sequence: each use of the seed draws its own stream."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, tag]


def _uniform(gen, n, device):
    """n draws in (0, 1]: log() of them is finite."""
    return 1.0 - torch.rand(n, generator=gen, device=device,
                            dtype=torch.float64)


def make_genome(gen, spec: dict, device) -> torch.Tensor:
    """Random genome with `repeat_copies` exact copies of one random unit
    of `repeat_bp`, one copy at a random place in each of as many equal
    zones (so copies never overlap)."""
    return genome_with_repeats(gen, spec, device)[0]


def genome_with_repeats(gen, spec: dict, device
                        ) -> tuple[torch.Tensor, np.ndarray]:
    """make_genome's genome and the start of each planted copy."""
    G = int(spec["bp"])
    g = torch.randint(0, 4, (G,), generator=gen, device=device,
                      dtype=torch.uint8)
    n = int(spec.get("repeat_copies", 0))
    if n:
        R = int(spec["repeat_bp"])
        zone = G // n
        if zone <= R:
            raise ValueError("repeat copies do not fit the genome")
        unit = torch.randint(0, 4, (R,), generator=gen, device=device,
                             dtype=torch.uint8)
        at = torch.randint(0, zone - R, (n,), generator=gen,
                           device=device).cpu().tolist()
        for z, a in enumerate(at):
            g[z * zone + a:z * zone + a + R] = unit
        return g, np.array([z * zone + a for z, a in enumerate(at)],
                           np.int64)
    return g, np.zeros(0, np.int64)


def read_spans(gen, G: int, spec: dict, device):
    """(span lengths, starts, strands) of the reads, as the simulator
    draws them: lengths gamma(3, mean / 3) truncated to whole bases and
    clipped to [min_bp, max_bp], until their sum reaches coverage x G
    (or max_total_bp)."""
    mean = float(spec["mean_bp"])
    target = int(G * float(spec["coverage"]))
    if spec.get("max_total_bp"):
        target = min(target, int(spec["max_total_bp"]))
    lo = int(spec["min_bp"])
    hi = min(int(spec.get("max_bp") or G), G)
    nmax = int(target / mean * 1.25) + 256
    u = _uniform(gen, (nmax, 3), device)
    L = (-(mean / 3.0) * torch.log(u).sum(1)).floor().clamp(lo, hi)
    L = L.to(torch.int64)
    csum = torch.cumsum(L, 0)
    n = int(torch.searchsorted(csum, torch.tensor([target], device=device),
                               right=False)[0]) + 1
    if n > nmax:
        raise RuntimeError("read-length draws fell short of the target")
    L = L[:n]
    starts = torch.randint(0, G, (n,), generator=gen, device=device)
    strand = torch.randint(0, 2, (n,), generator=gen, device=device)
    return L, starts, strand


def _mutate(src: torch.Tensor, lens: torch.Tensor, gen, spec: dict):
    """CLR errors on concatenated spans (the simulator's mutate, over all
    reads at once): each base is kept, substituted, deleted, or gets one
    random base inserted before it.  Returns (bases, per-read lengths)."""
    dev = src.device
    n = src.numel()
    err = float(spec["error"])
    p_ins = err * float(spec["ins_share"])
    p_del = err * float(spec["del_share"])
    p_sub = err - p_ins - p_del
    r = torch.rand(n, generator=gen, device=dev, dtype=torch.float32)
    sub = r < p_sub
    dele = (r >= p_sub) & (r < p_sub + p_del)
    ins = (r >= p_sub + p_del) & (r < err)
    shift = torch.randint(1, 4, (n,), generator=gen, device=dev,
                          dtype=torch.uint8)
    ins_char = torch.randint(0, 4, (n,), generator=gen, device=dev,
                             dtype=torch.uint8)
    base = torch.where(sub, (src + shift) % 4, src)
    out_len = torch.ones(n, dtype=torch.int64, device=dev)
    out_len[dele] = 0
    out_len[ins] = 2
    pos = torch.cumsum(out_len, 0) - out_len
    out = torch.empty(int(out_len.sum()), dtype=torch.uint8, device=dev)
    keep = ~dele
    out[(pos + ins.to(torch.int64))[keep]] = base[keep]
    out[pos[ins]] = ins_char[ins]
    rid = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                  lens)
    per_read = torch.zeros(lens.numel(), dtype=torch.int64, device=dev)
    per_read.index_add_(0, rid, out_len)
    return out, per_read


def make_reads(cfg: dict, seed: int, device) -> Reads:
    """The configuration's genome and reads from `seed`, made on `device`
    and returned on the host.  Reads shorter than reads.min_bp after
    their errors are dropped, as the simulator drops them."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    rspec = cfg["reads"]
    genome, copies = genome_with_repeats(gen, cfg["genome"], device)
    G = genome.numel()
    L, starts, strand = read_spans(gen, G, rspec, device)
    cuts = [0]
    acc = torch.cumsum(L, 0).cpu().numpy()
    while cuts[-1] < len(acc):
        base = acc[cuts[-1] - 1] if cuts[-1] else 0
        nxt = int(np.searchsorted(acc, base + CHUNK_BP, side="right"))
        cuts.append(max(nxt, cuts[-1] + 1))
    parts, lens_out = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        Lc, sc, rc = L[lo:hi], starts[lo:hi], strand[lo:hi]
        tot = int(Lc.sum())
        first = torch.cumsum(Lc, 0) - Lc
        rid = torch.repeat_interleave(torch.arange(hi - lo, device=device),
                                      Lc)
        k = torch.arange(tot, device=device) - first[rid]
        rev = rc[rid] == 1
        k = torch.where(rev, Lc[rid] - 1 - k, k)
        src = genome[(sc[rid] + k) % G]
        src = torch.where(rev, 3 - src, src)
        out, per_read = _mutate(src, Lc, gen, rspec)
        parts.append(out.cpu())
        lens_out.append(per_read.cpu())
        del src, out, k, rid, rev
    bases = torch.cat(parts).numpy()
    lens = torch.cat(lens_out).numpy()
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    spans = L.cpu().numpy()
    st = starts.cpu().numpy()
    sd = strand.cpu().numpy().astype(np.int8)
    keep = lens >= int(rspec["min_bp"])
    if not keep.all():
        idx = np.nonzero(keep)[0]
        pieces = [bases[offs[i]:offs[i + 1]] for i in idx]
        bases = np.concatenate(pieces)
        lens = lens[idx]
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        spans, st, sd = spans[idx], st[idx], sd[idx]
    del genome, L, starts, strand
    return Reads(bases, offs, st.astype(np.int64), spans.astype(np.int64),
                 sd, G, copies,
                 int(cfg["genome"]["repeat_bp"]) if len(copies) else 0)


def dbsplit_blocks(lengths: np.ndarray, block_mb: float,
                   cutoff: int) -> list[tuple[int, int]]:
    """DBsplit -s's blocks as read index ranges [lo, hi): a read whose
    addition would pass block_mb x 10^6 bases of reads at or above the
    cutoff starts the next block."""
    limit = int(float(block_mb) * 1_000_000)
    out, lo, acc = [], 0, 0
    for i, n in enumerate(lengths.tolist()):
        if n < cutoff:
            continue
        if acc + n > limit and acc > 0:
            out.append((lo, i))
            lo, acc = i, 0
        acc += n
    out.append((lo, len(lengths)))
    return out


def true_overlap(reads: Reads, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Bases of genome shared by the spans of reads i and j (arrays of
    equal shape), on the circle."""
    G = reads.genome_bp
    si, ei = reads.start[i], reads.start[i] + reads.span[i]
    sj, ej = reads.start[j], reads.start[j] + reads.span[j]
    best = np.zeros(np.broadcast(i, j).shape, np.int64)
    for d in (-G, 0, G):
        ov = np.minimum(ei, ej + d) - np.maximum(si, sj + d)
        best = np.maximum(best, ov)
    return best
