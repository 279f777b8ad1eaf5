"""The torch port's own host layer against the JAX package's, module for
module, on the same inputs (the golden and simulated BAMs of
``tests/data`` or arrays made from a numpy seed).

Every comparison is of integers, bytes or text: no tolerance.  The two
packages each build their own native library from their own copy of
``sniper_native.cpp``; the native calls are compared between those two
builds.
"""

import dataclasses
import importlib
import io

import numpy as np
import pytest

JAX_PKG = "somatic_sniper_tpu"
PORT_PKG = "somatic_sniper_tpu_torch"


def both(module: str):
    """(the JAX package's module, the port's copy of it)."""
    return (importlib.import_module(f"{JAX_PKG}.{module}"),
            importlib.import_module(f"{PORT_PKG}.{module}"))


def assert_same(a, b, what="value"):
    """Deep equality across the two packages' types: arrays by bytes and
    dtype, tuples, dataclasses and slotted objects field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    elif hasattr(a, "_fields"):
        assert a._fields == b._fields, what
        for name in a._fields:
            if name != "owner":  # the native handle of a pileup
                assert_same(getattr(a, name), getattr(b, name),
                            f"{what}.{name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif hasattr(type(a), "__slots__") and not isinstance(a, (str, bytes)):
        for name in type(a).__slots__:
            assert_same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    else:
        assert a == b, what


def golden(data_dir):
    return (str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
            str(data_dir / "small.fa"))


def sim1(data_dir):
    d = data_dir / "e2e" / "sim1"
    return str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa")


def test_constants_equal():
    ja, po = both("constants")
    names = [n for n in dir(ja) if n.isupper()]
    assert len(names) > 10 and names == [n for n in dir(po) if n.isupper()]
    for n in names:
        assert_same(getattr(ja, n), getattr(po, n), n)
    assert ja.log_phred(0.25) == po.log_phred(0.25)


@pytest.mark.parametrize("kwargs", [
    {}, {"use_joint_priors": True, "somatic_mutation_rate": 0.001},
    {"theta": 0.8, "n_hap": 3, "het_rate": 0.002},
], ids=["default", "joint", "model"])
def test_build_tables_byte_equal(kwargs):
    ja, po = both("models.tables")
    assert_same(ja.build_tables(ja.ModelParams(**kwargs)),
                po.build_tables(po.ModelParams(**kwargs)), "tables")


def test_allele_util_equal():
    ja, po = both("models.allele_util")
    a = np.arange(16)[:, None].repeat(16, 1)
    b = a.T
    for fn in ("genotype_intersection", "genotype_is_proper_subset",
               "genotype_set_difference"):
        assert_same(getattr(ja, fn)(a, b), getattr(po, fn)(a, b), fn)
    assert_same(ja.count_alleles(a), po.count_alleles(a), "count_alleles")
    for ref in (1, 2, 4, 8):
        for fn in ("should_filter_as_loh", "should_filter_as_gor"):
            assert_same(getattr(ja, fn)(ref, a, b), getattr(po, fn)(ref, a, b),
                        fn)


@pytest.mark.parametrize("pair", [golden, sim1])
@pytest.mark.parametrize("which", [0, 1], ids=["tumor", "normal"])
def test_read_bam_and_header(data_dir, which, pair):
    ja, po = both("io.bam")
    bam = pair(data_dir)[which]
    hj, hp = ja.read_bam_header(bam), po.read_bam_header(bam)
    assert_same(hj, hp, "header")
    assert hj.parse_rg() == hp.parse_rg()
    (h2j, rj), (h2p, rp) = ja.read_bam(bam), po.read_bam(bam)
    assert_same(h2j, h2p, "header")
    assert rj.n == rp.n >= 40
    assert_same(rj, rp, "reads")
    bj, bp = both("io.bgzf")
    assert bj.decompress_file(bam) == bp.decompress_file(bam)


def test_bai_index_and_chunks(data_dir, tmp_path):
    ja, po = both("io.bai")
    bam = sim1(data_dir)[0]
    ij, ip = ja.build_index(bam), po.build_index(bam)
    ij.write(tmp_path / "j.bai")
    ip.write(tmp_path / "p.bai")
    raw = (tmp_path / "j.bai").read_bytes()
    assert raw == (tmp_path / "p.bai").read_bytes() and len(raw) > 32
    lj, lp = ja.load_index(tmp_path / "j.bai"), po.load_index(tmp_path / "p.bai")
    n_ref = len(lj.refs)
    assert n_ref == len(lp.refs) > 0
    rng = np.random.default_rng(5)
    some = False
    for tid in range(n_ref):
        for beg in rng.integers(0, 3000, 6).tolist():
            cj = ja.region_chunks(lj, tid, beg, beg + 500)
            assert cj == po.region_chunks(lp, tid, beg, beg + 500)
            some = some or bool(cj)
    assert some
    for beg, end in [(0, 1), (100, 20000), (1 << 14, 1 << 20)]:
        assert ja.reg2bin(beg, end) == po.reg2bin(beg, end)
        assert ja.reg2bins(beg, end) == po.reg2bins(beg, end)


def test_fasta_fetch_equal(data_dir):
    ja, po = both("io.fasta")
    fa = golden(data_dir)[2]
    hdr = both("io.bam")[0].read_bam_header(golden(data_dir)[0])
    fj, fp = ja.FastaFile(fa), po.FastaFile(fa)
    for name in hdr.ref_names + ["no_such_contig"]:
        assert fj.fetch(name) == fp.fetch(name)


def _native_pair(data_dir):
    """Each package's native pileups of the sim1 pair, with its
    reference blob: [(package modules, pu_t, pu_n, ref_blob, ref_off,
    tabs, header), ...] for the JAX package, then the port."""
    out = []
    for pkg in (JAX_PKG, PORT_PKG):
        m = {name: importlib.import_module(f"{pkg}.{name}") for name in (
            "io.native_api", "io.bam", "io.fasta", "io.bai",
            "models.tables", "models.somatic", "pileup.prefilter",
            "pileup.columnize", "output.dqstats", "output.fast_emit")}
        if not m["io.native_api"].available():
            pytest.skip("needs the native host library (g++ and zlib)")
        t, n, fa = sim1(data_dir)
        header, pu_t = m["io.native_api"].load_and_columnize(t)
        _, pu_n = m["io.native_api"].load_and_columnize(n)
        fasta = m["io.fasta"].FastaFile(fa)
        blob, off = m["pileup.prefilter"].build_ref16(
            [fasta.fetch(name) or b"" for name in header.ref_names])
        tabs = m["models.tables"].build_tables(m["models.tables"].ModelParams())
        out.append((m, pu_t, pu_n, blob, off, tabs, header))
    return out


def test_two_native_builds_are_two_libraries():
    ja, po = both("io.native")
    if ja.get_lib() is None or po.get_lib() is None:
        pytest.skip("needs the native host library (g++ and zlib)")
    assert ja._LIB != po._LIB and po._LIB.parent.name == "native"
    assert PORT_PKG in str(po._LIB) and po._SRC.parent == po._LIB.parent
    assert ja._SRC.read_bytes() == po._SRC.read_bytes()


def test_native_load_and_region_load_equal(data_dir):
    (mj, tj, nj, *_), (mp, tp, n_p, *_rest) = _native_pair(data_dir)
    assert_same(tj, tp, "tumor pileup")
    assert_same(nj, n_p, "normal pileup")
    assert len(tj.ukeys) > 100
    bam = sim1(data_dir)[0]
    got = []
    for m in (mj, mp):
        idx = m["io.bai"].build_index(bam)
        header = m["io.bam"].read_bam_header(bam)
        tid = int(np.argmax(header.ref_lengths))
        end = min(int(header.ref_lengths[tid]), 1500)
        chunks = np.asarray(m["io.bai"].region_chunks(idx, tid, 200, end),
                            np.int64).reshape(-1, 2)
        got.append(m["io.native_api"].load_region_and_columnize(
            bam, chunks, tid, 200, end))
    assert_same(got[0], got[1], "region pileup")
    assert len(got[0].ukeys) > 0


def test_native_plan_fill_score_and_emit_equal(data_dir):
    results = []
    for m, pu_t, pu_n, blob, off, tabs, header in _native_pair(data_dir):
        api = m["io.native_api"]
        gmin, margin = m["pileup.prefilter"].prefilter_tables(tabs)
        plan = api.paired_plan(
            pu_t, pu_n, blob, off, m["pileup.columnize"].DEPTH_BUCKETS,
            fk=tabs.fk, gmin=gmin, margin=margin, coef=tabs.coef,
            lhet=tabs.lhet, q_r_int=tabs.q_r_int, cns_mode="proof")
        B, D = len(plan.keys), 48
        keep = np.nonzero(np.maximum(plan.d_t, plan.d_n) <= D)[0]
        stacked = np.zeros((2, len(keep), D), np.uint32)
        meta = np.zeros((3, len(keep)), np.int32)
        api.slab_fill_pair(
            pu_t, pu_n, np.ascontiguousarray(plan.ti[keep]),
            np.ascontiguousarray(plan.ni[keep]),
            np.ascontiguousarray(plan.ref16[keep]), plan.d_t[keep],
            plan.d_n[keep], D, 60, stacked[0], stacked[1], meta[0], meta[1],
            meta[2])
        p = tabs.params
        rows = api.exact_pair_rows(
            pu_t, pu_n, plan.ti, plan.ni, plan.ref16, tabs,
            p.use_joint_priors, p.min_somatic_qual, p.include_loh,
            p.include_gor)
        names = m["models.somatic"].COMPACT_FIELDS
        idx = rows[:, 0].astype(np.int64)
        keys = plan.keys[idx]
        rb4 = plan.ref16[idx].astype(np.int64)
        wanted = (rb4 | rows[:, 1 + names.index("tumor_eff_gt")]
                  | rows[:, 1 + names.index("normal_eff_gt")])
        dq_t = m["output.dqstats"].get_dqstats_rows(
            pu_t, plan.ti[idx], rb4, wanted)
        dq_n = m["output.dqstats"].get_dqstats_rows(
            pu_n, plan.ni[idx], rb4, wanted)
        tids = (keys >> 40).astype(np.int64)
        poss = (keys & ((1 << 40) - 1)).astype(np.int64)
        chars = np.full(len(keys), ord("A"), np.int64)
        fields = np.ascontiguousarray(rows[:, 1:13].astype(np.int64))
        lines = {}
        for fmt in ("classic", "vcf", "bed"):
            lines[fmt] = api.emit_lines(fmt, header.ref_names, tids, poss,
                                        chars, rb4, fields, dq_t, dq_n)
            f = {name: rows[:, 1 + j].tolist()
                 for j, name in enumerate(names)}
            lines[fmt + "_py"] = m["output.fast_emit"].LINE_BUILDERS[fmt](
                [header.ref_names[t] for t in tids.tolist()], poss.tolist(),
                chars.tolist(), rb4.tolist(), f, dq_t.tolist(),
                dq_n.tolist())
        assert lines["vcf"] == lines["vcf_py"] and len(lines["vcf"]) > 5
        assert B > 50 and len(keep) > 50
        results.append((plan, stacked, meta, rows, dq_t, dq_n, lines, names))
    assert_same(results[0], results[1], "plan, slab, rows, dqstats, lines")


def test_python_columnize_prefilter_dqstats_equal(data_dir):
    got = []
    for pkg in (JAX_PKG, PORT_PKG):
        bam = importlib.import_module(f"{pkg}.io.bam")
        col = importlib.import_module(f"{pkg}.pileup.columnize")
        pre = importlib.import_module(f"{pkg}.pileup.prefilter")
        dq = importlib.import_module(f"{pkg}.output.dqstats")
        tables = importlib.import_module(f"{pkg}.models.tables")
        fasta = importlib.import_module(f"{pkg}.io.fasta")
        t, _, fa = sim1(data_dir)
        header, reads = bam.read_bam(t)
        pu = col.columnize(reads, 0x704, 0)
        tabs = tables.build_tables(tables.ModelParams())
        gmin, margin = pre.prefilter_tables(tabs)
        ff = fasta.FastaFile(fa)
        blob, off = pre.build_ref16(
            [ff.fetch(n) or b"" for n in header.ref_names])
        flags = pre.pure_flags_np(pu, blob, off, tabs.fk, gmin, margin)
        n = len(pu.ukeys)
        ci = np.arange(0, n, 3, dtype=np.int64)
        rb4 = (1 << (ci % 4)).astype(np.int64)
        rows = dq.get_dqstats_rows(pu, ci, rb4, np.full(len(ci), 15, np.int64))
        pad = col._pad_columns(pu, ci[:64], 64)
        got.append((pu, flags, rows, pad, col.DEPTH_BUCKETS,
                    [col.bucket_for(d) for d in (1, 8, 9, 40, 300, 9000)]))
    assert_same(got[0], got[1], "columnize, flags, dqstats, pad")
    assert len(got[0][0].ukeys) > 100 and got[0][1].any()


def _records(pkg: str):
    rec = importlib.import_module(f"{pkg}.output.records")
    dq = importlib.import_module(f"{pkg}.output.dqstats")
    rng = np.random.default_rng(9)
    out = []
    for i in range(12):
        rows = rng.integers(0, 60, (2, 18)).astype(np.int64)
        st = dq.rows_to_dqstats(rows)
        samples = [rec.SampleData(
            genotype=int(rng.integers(1, 16)),
            joint_genotype=int(rng.integers(1, 16)),
            joint_consensus_quality=int(rng.integers(0, 255)),
            consensus_quality=int(rng.integers(0, 255)),
            variant_allele_quality=int(rng.integers(0, 255)),
            somatic_score=int(rng.integers(0, 255)),
            variant_status=int(rng.integers(0, 5)), dqstats=st[j])
            for j in range(2)]
        out.append(rec.SniperRecord(
            seq_name=f"chr{i % 3}", pos=100 * i + 7,
            ref_base=ord("ACGTacgtNn"[i % 10]), ref_base4=1 << (i % 4),
            tumor=samples[0], normal=samples[1]))
    return out, rec.HeaderData(refseq="ref.fa", normal_sample_id="N1",
                               tumor_sample_id="T1")


@pytest.mark.parametrize("fmt", ["classic", "vcf", "bed"])
def test_formatters_on_fixed_records(fmt):
    texts = []
    for pkg in (JAX_PKG, PORT_PKG):
        fm = importlib.import_module(f"{pkg}.output.formatters")
        records, hdata = _records(pkg)
        header_fn, record_fn = fm.get_formatter(fmt)
        fh = io.StringIO()
        header_fn(fh, hdata)
        body = io.StringIO()
        for r in records:
            record_fn(body, r)
        assert len(body.getvalue().splitlines()) == len(records)
        lines = [ln for ln in fh.getvalue().splitlines()
                 if not ln.startswith("##fileDate")]
        texts.append((lines, body.getvalue()))
    assert texts[0] == texts[1]
    with pytest.raises(ValueError):
        both("output.formatters")[1].get_formatter("nope")


def test_simulate_pair_fast_byte_identical(tmp_path):
    ja, po = both("utils.simulate")
    kw = dict(n_contigs=2, contig_len=3000, mean_depth=12.0, seed=21)
    ja.simulate_pair_fast(tmp_path / "j", ja.SimConfig(**kw))
    po.simulate_pair_fast(tmp_path / "p", po.SimConfig(**kw))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert {"tumor.bam", "normal.bam", "ref.fa"} <= set(names)
    for name in names:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "p" / name).read_bytes()), name


def test_contract_diff_and_hist_equal(data_dir):
    ja, po = both("utils.contract")
    gold = [ln for ln in (data_dir / "e2e" / "sim1" / "expected.vcf")
            .read_text().splitlines() if not ln.startswith("##fileDate")]
    body = [i for i, ln in enumerate(gold) if not ln.startswith("#")]
    assert len(body) > 10
    assert ja.diff_records(gold, gold, "vcf") == po.diff_records(
        gold, gold, "vcf") == []

    def bump(line, sample, field, by):
        cols = line.split("\t")
        vals = cols[sample].split(":")
        k = cols[8].split(":").index(field)
        vals[k] = str(int(vals[k]) + by)
        cols[sample] = ":".join(vals)
        return "\t".join(cols)

    fast = list(gold)
    fast[body[0]] = bump(fast[body[0]], 10, "GQ", 1)
    fast[body[3]] = bump(fast[body[3]], 9, "VAQ", -1)
    tol = ja.diff_records(fast, gold, "vcf")
    assert tol == po.diff_records(fast, gold, "vcf") and len(tol) == 2
    assert ja.hist(tol) == po.hist(tol) == {"GQ+1": 1, "VAQ-1": 1}
    # a difference of two, a changed call and a dropped record break the
    # contract in both
    bad = list(gold)
    bad[body[1]] = bump(bad[body[1]], 10, "GQ", 2)
    for mod in (ja, po):
        with pytest.raises(AssertionError):
            mod.diff_records(bad, gold, "vcf")
        with pytest.raises(AssertionError):
            mod.diff_records(gold[:-1], gold, "vcf")


def test_stats_counters_equal():
    ja, po = both("utils.stats")
    sj, sp = ja.RunStats(), po.RunStats()
    for s in (sj, sp):
        s.add("device_columns", 5)
        s.add("device_columns", 7)
        s.add("slabs_dispatched", 1)
    assert sj.snapshot() == sp.snapshot()
    assert sj.summary() == sp.summary()
    assert po.STATS is not ja.STATS
    assert ja.enabled() == po.enabled()


ARGVS = [
    ["-f", "r.fa", "t.bam", "n.bam", "out"],
    ["-F", "vcf", "-q", "1", "-Q", "20", "-L", "-G", "-p", "-J", "-s",
     "0.001", "-T", "0.8", "-N", "3", "-r", "0.002", "-n", "NN", "-t", "TT",
     "--precision", "fast", "--shards", "4", "--shard-index", "1",
     "--window-size", "1000", "--stats", "--manifest", "m.json", "-f", "r.fa",
     "t.bam", "n.bam", "out"],
    ["-v"],
    ["--jobs", "2", "--merge", "collective", "-f", "r.fa", "a", "b", "c"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["plain", "all", "version",
                                             "jobs"])
def test_build_parser_accepts_the_same_argv(argv):
    ja, po = both("cli.main")
    want = vars(ja.build_parser().parse_args(argv))
    got = vars(po.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(po.build_parser().parse_args(
        ["--device", "cpu", *argv]))["device"] == "cpu"


def test_build_parser_rejects_the_same_argv(capsys):
    ja, po = both("cli.main")
    for argv in (["-F", "nope"], ["--precision", "half"], ["-q", "x"]):
        for mod in (ja, po):
            with pytest.raises(SystemExit):
                mod.build_parser().parse_args(argv)
    capsys.readouterr()


def test_usage_text_identical_apart_from_the_program_name():
    ja, po = both("cli.main")
    kw = dict(mapq=3, min_somatic_qual=22, somatic_mutation_rate=0.002,
              theta=0.8, n_hap=3, het_rate=0.01)
    assert ja.usage_text(progname="prog", **kw) == po.usage_text(
        progname="prog", **kw)
    assert po.usage_text() == ja.usage_text().replace(
        "bam-somaticsniper-tpu", po.PROG)
    assert isinstance(po._commit_id(), str) and po._commit_id()
