"""Phase configurations: the fields of damar_tpu.core.config's
OverlapConfig that the port reads, with the same defaults (daligner
-k14 -w6 -h35 -e.70 -l1000 -s100), and its MaskConfig, ScrubConfig,
TourConfig and PipelineConfig as they are.  The reference's use_pallas
switch
and launch widths (seed_batch, seed_batch_dev) have no counterpart: each
dp_kernel has one implementation here, the CUDA kernels on the card and
their plain versions on the CPU."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class OverlapConfig:
    """daligner-equivalent parameters."""
    kmer: int = 14              # -k  seed k-mer size
    band_shift: int = 6         # -w  diagonal bucket width = 2^w
    hit_min: int = 35           # -h  min covered bases in a diagonal band
    max_kmer_count: int = 0     # -t  suppress k-mers occurring > t (0 = auto)
    err: float = 0.70           # -e  min correlation (1 - pair error rate)
    min_len: int = 1000         # -l  min overlap length to report
    tspace: int = 100           # -s  trace-point spacing
    identity: bool = False      # -I  report self-overlaps of a read
    bias: bool = False          # -b  biased-composition seeding: band
                                #     coverage weighted by composition
    # --- kernel shape parameters (not in the reference) ---
    band_width: int = 128       # wide-DP band lanes (the wide trace tier)
    xdrop: int = 60             # X-drop termination threshold (diff units)
    max_read_len: int = 65536   # static bound on read length in kernels
    diff_cost: int = 5          # score = antidiag - diff_cost * diffs
    dp_kernel: str = "bp"       # "bp" (bit-parallel, default) | "wide"
                                # (a lane per diagonal: one wide
                                # extension phase per orientation, the
                                # wide trace as the main trace)
    bp_chunk: int = 128         # bp extension rows between recenters
                                # (a multiple of 16)
    ext_phase1_rows: int = 128  # two-phase extension: run every unit
                                # this deep first, then re-run only the
                                # still-active survivors at full depth
                                # (identical outputs; 0 = single-phase)

    @property
    def bucket_width(self) -> int:
        return 1 << self.band_shift


@dataclass(frozen=True)
class MaskConfig:
    """datander/TANmask/REPmask/LArepeat-equivalent parameters."""
    tan_min_len: int = 500       # min tandem interval length to mask
    rep_cov: int = 10            # REPmask -c: coverage threshold
    rep_low: float = 1.5         # LArepeat -l: low multiple of expected cov
    rep_high: float = 2.0        # LArepeat -h: high multiple
    dust_window: int = 64        # DBdust window
    dust_thresh: float = 2.0     # DBdust score threshold


@dataclass(frozen=True)
class ScrubConfig:
    """LAstitch/LAq/LAfix/LAgap/LAfilter-equivalent parameters."""
    stitch_fuzz: int = 100       # LAstitch -f: max unaligned gap to stitch
    q_good: int = 25             # segment diff count considered good
    q_bad: int = 35              # segment diff count considered bad
    min_cov_patch: int = 1       # min alternatives to patch a segment
    gap_min_cov: int = 2         # LAgap: coverage below -> break candidate
    min_trim_len: int = 1000     # drop reads shorter than this after trim
    anchor_min: int = 300        # LAfilter chain rule: min bases of an
                                 # alignment outside repeat intervals
    filter_min_len: int = 1000   # LAfilter: min overlap length kept
    filter_max_diff: float = 0.35  # max error rate of kept overlaps
    filter_fuzz: int = 40        # dovetail end slop
    filter_best_n: int = 0       # LAfilter best-n-per-end: keep at most
                                 # n dovetails per read end (0 = off)


@dataclass(frozen=True)
class TourConfig:
    """OGbuild/OGtour parameters."""
    min_dovetail: int = 1000     # min dovetail overlap for a graph edge
    bubble_max: int = 8          # max path length when popping bubbles
    spur_len: int = 3            # max spur length to clip
    polish_rounds: int = 3       # staggered consensus rounds
    corrector_rounds: int = 2    # read-correction passes (pass 2 votes
                                 # with pass-1-corrected covers)
    finish_raw_rounds: int = 4   # raw-read recruitment finishing rounds
                                 # (0 = off)


@dataclass(frozen=True)
class PipelineConfig:
    overlap: OverlapConfig = field(default_factory=OverlapConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
    scrub: ScrubConfig = field(default_factory=ScrubConfig)
    tour: TourConfig = field(default_factory=TourConfig)
    block_mb: int = 200          # DBsplit -s
    min_read_len: int = 500      # DBsplit -x
