"""Port vs reference for the .qvs codec (formats/qv_huff.py, formats/qv.py)
and create_db from FASTQ (formats/dazzdb.py): encode_qvs bytes equal to
damar_tpu's on fuzz streams made from a seed (empty sets and streams,
single-symbol streams, delQV runs past the 255 run cap, absent streams),
decode round-trips, the legacy DQV1 container read back, and a DB made
from a FASTQ (and from a FASTA and a FASTQ together) byte-equal, .qvs
included.  Tolerance: exact (bytes and integers)."""
import filecmp
import gzip
import zlib

import numpy as np
import pytest

from damar_tpu.formats import dazzdb as ref_db
from damar_tpu.formats import qv as ref_qv
from damar_tpu.formats import qv_huff as ref_huff
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta
from damar_tpu_torch.formats import dazzdb, qv, qv_huff
from damar_tpu_torch.formats.fasta import iter_fasta, iter_fastq

STREAMS = qv_huff.STREAMS


def fuzz_streams(case: str, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    if case == "empty":
        return []
    if case == "empty-streams":
        return [{n: np.zeros(0, np.uint8) for n in STREAMS}, {}]
    if case == "single-symbol":     # a read's streams share its length
        return [{n: np.full(m, 7, np.uint8) for n in STREAMS}
                for m in rng.integers(1, 50, 3)]
    if case == "long-runs":
        out = []
        for _ in range(4):
            v = np.full(int(rng.integers(300, 900)), 12, np.uint8)
            v[rng.random(len(v)) < 0.01] = rng.integers(0, 40)
            out.append({"del_qv": v, "ins_qv": rng.integers(
                0, 41, len(v)).astype(np.uint8)})
        return out
    # mixed: reads of random lengths, skewed symbols, some streams absent
    out = []
    for _ in range(int(rng.integers(5, 30))):
        n = int(rng.integers(0, 400))
        st = {}
        for name in STREAMS:
            if rng.random() < 0.2:
                continue
            p = rng.dirichlet(np.full(int(rng.integers(1, 60)), 0.3))
            st[name] = rng.choice(len(p), n, p=p).astype(np.uint8)
        out.append(st)
    return out


CASES = [("empty", 0), ("empty-streams", 0), ("single-symbol", 1),
         ("long-runs", 2)] + [("mixed", s) for s in range(3, 9)]


@pytest.mark.parametrize("case,seed", CASES)
def test_encode_bytes_and_round_trip(case, seed):
    st = fuzz_streams(case, seed)
    got = qv_huff.encode_qvs(st)
    assert got == ref_huff.encode_qvs(st)
    back = qv_huff.decode_qvs(got)
    want = ref_huff.decode_qvs(got)
    assert len(back) == len(want) == len(st)
    for b, w, s in zip(back, want, st):
        assert b.keys() == w.keys()
        for k in b:
            assert np.array_equal(b[k], w[k])
        for k, v in s.items():
            if len(v) or k != "del_qv":
                assert np.array_equal(b[k], v)


@pytest.mark.parametrize("seed", [11, 12])
def test_code_lengths_and_canonical_codes(seed):
    rng = np.random.default_rng(seed)
    freq = np.zeros(256, np.int64)
    sym = rng.choice(256, int(rng.integers(2, 200)), replace=False)
    freq[sym] = rng.zipf(1.3, len(sym)).clip(1, 1 << 30)
    lengths = qv_huff._code_lengths(freq)
    assert np.array_equal(lengths, ref_huff._code_lengths(freq))
    assert lengths.max() <= qv_huff.MAX_CODE_LEN
    assert np.array_equal(qv_huff._canonical_codes(lengths),
                          ref_huff._canonical_codes(lengths))


def test_legacy_dqv1_read_back(tmp_path):
    rng = np.random.default_rng(21)
    reads = [{n: rng.integers(0, 40, int(rng.integers(1, 90))).astype(
        np.uint8) for n in STREAMS if rng.random() < 0.7} for _ in range(6)]
    parts = [np.int32(qv.MAGIC).tobytes(), np.int32(len(reads)).tobytes()]
    for st in reads:
        parts.append(np.int32(max((len(v) for v in st.values()),
                                  default=0)).tobytes())
        for n in STREAMS:
            blob = zlib.compress(st[n].tobytes()) if n in st else b""
            parts.append(np.int32(len(blob)).tobytes() + blob)
    db = str(tmp_path / "L.db")
    with open(qv.qvs_path(db), "wb") as f:
        f.write(b"".join(parts))
    got, want = qv.read_qvs(db), ref_qv.read_qvs(db)
    assert len(got) == len(want) == len(reads)
    for g, w, s in zip(got, want, reads):
        assert g.keys() == w.keys() == s.keys()
        for k in s:
            assert np.array_equal(g[k], s[k]) and np.array_equal(w[k], s[k])


def test_write_read_qvs(tmp_path):
    st = fuzz_streams("mixed", 30)
    qv.write_qvs(str(tmp_path / "P.db"), st)
    ref_qv.write_qvs(str(tmp_path / "R.db"), st)
    assert filecmp.cmp(qv.qvs_path(str(tmp_path / "P.db")),
                       ref_qv.qvs_path(str(tmp_path / "R.db")), shallow=False)
    for g, w in zip(qv.read_qvs(str(tmp_path / "P.db")),
                    ref_qv.read_qvs(str(tmp_path / "P.db"))):
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[k], w[k]) for k in g)


def write_fastq(path: str, seed: int, gz: bool = False) -> None:
    """Simulated reads with phred+33 qualities made from `seed`."""
    rng = np.random.default_rng(seed)
    sim = sample_reads(make_genome(20_000, seed=seed), coverage=4,
                       mean_len=1500, err=0.12, seed=seed + 1)
    lines = []
    for i, r in enumerate(sim.reads):
        q = np.clip(rng.normal(20, 8, len(r)), 2, 41).astype(np.uint8)
        q[rng.random(len(r)) < 0.3] = 11
        lines += [f"@fq/{i}/0_{len(r)} q", "".join("acgt"[c] for c in r),
                  "+", (q + 33).tobytes().decode()]
    text = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


DB_FILES = ["{r}.db", ".{r}.idx", ".{r}.bps", ".{r}.qvs"]


@pytest.mark.parametrize("inputs", [("reads.fastq",),
                                    ("reads.fasta", "more.fq.gz")])
def test_create_db_from_fastq(tmp_path, inputs):
    write_fastq(str(tmp_path / "reads.fastq"), 41)
    write_fastq(str(tmp_path / "more.fq.gz"), 43, gz=True)
    write_sim_fasta(str(tmp_path / "reads.fasta"), sample_reads(
        make_genome(15_000, seed=44), coverage=3, mean_len=1500, err=0.1,
        seed=45))
    paths = [str(tmp_path / p) for p in inputs]
    db = dazzdb.create_db(str(tmp_path / "P.db"), paths)
    ref = ref_db.create_db(str(tmp_path / "R.db"), paths)
    assert db.ureads == ref.ureads > 0
    for f in DB_FILES:
        assert filecmp.cmp(str(tmp_path / f.format(r="P")),
                           str(tmp_path / f.format(r="R")), shallow=False)
    got = qv.read_qvs(str(tmp_path / "P.db"))
    assert len(got) == db.ureads
    want = []
    for p in paths:
        if p.endswith(".fasta"):
            want += [None] * sum(1 for _ in iter_fasta(p))
        else:
            want += [q for _, _, q in iter_fastq(p)]
    assert len(want) == len(got)
    for st, q in zip(got, want):
        assert np.array_equal(st["ins_qv"], np.zeros(0, np.uint8)
                              if q is None else q)
