"""The port's copies of the six post-processing scripts against their
sources in the JAX package: each ``main`` (and the module functions the
callers use) on the same inputs, the caller outputs under ``tests/data``,
must write the same bytes.  No tolerance anywhere.
"""

import contextlib
import importlib
import io
import tomllib
from pathlib import Path

import pytest
from tests.test_scripts import _fake_indel_file, _fake_readcount

REPO = Path(__file__).resolve().parents[1]
NAMES = ("fpfilter", "highconfidence", "merge_shards",
         "prepare_for_readcount", "readcount", "snpfilter")
KINDS = ("classic", "vcf", "big_classic")


def both(name: str):
    """(the JAX package's script module, the port's copy)."""
    return (importlib.import_module(f"somatic_sniper_tpu.scripts.{name}"),
            importlib.import_module(f"somatic_sniper_tpu_torch.scripts.{name}"))


@pytest.fixture(scope="module")
def outputs(data_dir):
    d = data_dir / "e2e" / "sim1"
    return {"classic": d / "expected.classic", "vcf": d / "expected.vcf",
            "big_classic": data_dir / "e2e" / "sim3_params"
            / "expected.N4.classic"}


def run_both(name, tmp_path, argv_of, files):
    """Run both mains with ``argv_of(prefix)``; every file ``prefix +
    suffix`` for the suffixes in ``files`` must be byte-equal, and so
    must what each printed."""
    printed = []
    for tag, mod in zip(("j", "p"), both(name)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv_of(str(tmp_path / tag)))
        assert not rc
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    for suffix in files:
        a = (tmp_path / f"j{suffix}").read_bytes()
        assert a == (tmp_path / f"p{suffix}").read_bytes(), suffix
        assert a or suffix.endswith(".lq")


@pytest.mark.parametrize("kind", KINDS)
def test_prepare_for_readcount(outputs, tmp_path, kind):
    run_both("prepare_for_readcount", tmp_path,
             lambda pre: ["--snp-file", str(outputs[kind]), "--out-file",
                          pre + ".pos"], [".pos"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("extra", [[], ["--min-mapping-quality", "0",
                                        "--min-read-depth", "1"]],
                         ids=["defaults", "loose"])
def test_snpfilter(outputs, tmp_path, kind, extra):
    run_both("snpfilter", tmp_path,
             lambda pre: ["--snp-file", str(outputs[kind]), "--out-file",
                          pre + ".out", "--lq-output", pre + ".lq", *extra],
             [".out", ".lq"])


@pytest.mark.parametrize("kind", KINDS)
def test_snpfilter_indel_branch(outputs, tmp_path, kind):
    indels = tmp_path / "indels.pileup"
    _fake_indel_file(outputs[kind], kind, indels)
    run_both("snpfilter", tmp_path,
             lambda pre: ["--snp-file", str(outputs[kind]), "--indel-file",
                          str(indels), "--min-mapping-quality", "0",
                          "--min-read-depth", "1", "--min-indel-score", "20",
                          "--indel-win-size", "3", "--out-file", pre + ".out",
                          "--lq-output", pre + ".lq"], [".out", ".lq"])


@pytest.mark.parametrize("kind", KINDS)
def test_highconfidence(outputs, tmp_path, kind):
    run_both("highconfidence", tmp_path,
             lambda pre: ["--snp-file", str(outputs[kind]), "--out-file",
                          pre + ".hc", "--lq-output", pre + ".lq",
                          "--min-mapping-quality", "40",
                          "--min-somatic-score", "20"], [".hc", ".lq"])


@pytest.mark.parametrize("kind", KINDS)
def test_fpfilter(outputs, tmp_path, kind):
    rc = tmp_path / "rc.txt"
    _fake_readcount(outputs[kind], "vcf" if "vcf" in kind else "classic", rc)
    run_both("fpfilter", tmp_path,
             lambda pre: ["--snp-file", str(outputs[kind]),
                          "--readcount-file", str(rc), "--output-basename",
                          pre], [".fp_pass", ".fp_fail"])


def test_readcount_on_sim1(data_dir, tmp_path):
    """The built-in bam-readcount: the port's reads the BAM and the FASTA
    through its own copies of ``io.bam`` and ``io.fasta``."""
    d = data_dir / "e2e" / "sim1"
    sites = tmp_path / "sites.pos"
    both("prepare_for_readcount")[1].main(
        ["--snp-file", str(d / "expected.vcf"), "--out-file", str(sites)])
    run_both("readcount", tmp_path,
             lambda pre: ["-f", str(d / "ref.fa"), "-l", str(sites), "-b",
                          "15", str(d / "tumor.bam"), pre + ".rc"], [".rc"])
    assert len((tmp_path / "p.rc").read_text().splitlines()) > 10


@pytest.mark.parametrize("fmt", ["vcf", "classic", "bed"])
def test_merge_shards(data_dir, tmp_path, fmt):
    """``merge`` and ``main`` over a caller output cut in three, each
    part under the header of its format."""
    src = data_dir / "e2e" / "sim1" / f"expected.{fmt}"
    lines = src.read_text().splitlines(keepends=True)
    ja, po = both("merge_shards")
    head = [ln for i, ln in enumerate(lines) if ja._is_header(ln, i == 0)]
    body = lines[len(head):]
    assert len(body) > 10
    cuts = [0, len(body) // 3, 2 * len(body) // 3, len(body)]
    shards = []
    for i in range(3):
        sh = tmp_path / f"shard{i}"
        sh.write_text("".join(head + body[cuts[i]:cuts[i + 1]]))
        shards.append(str(sh))
    ja.merge(str(tmp_path / "j.merged"), shards)
    po.merge(str(tmp_path / "p.merged"), shards)
    assert po.main([str(tmp_path / "p.main"), *shards]) in (0, None)
    want = (tmp_path / "j.merged").read_bytes()
    assert want == src.read_bytes()
    assert (tmp_path / "p.merged").read_bytes() == want
    assert (tmp_path / "p.main").read_bytes() == want


def test_module_functions_equal():
    ja, po = both("snpfilter")
    assert ja.IUB_AS_STRING == po.IUB_AS_STRING
    for t in "ACGTMKYRWSN":
        for n in "ACGTMKYRWSN":
            assert ja.is_loh(t, n) == po.is_loh(t, n)
    for name in NAMES:
        j, p = both(name)
        pub = [n for n in dir(j) if not n.startswith("__")]
        assert pub == [n for n in dir(p) if not n.startswith("__")], name


def test_console_scripts_name_the_ports_scripts():
    """``sniper-torch-*`` beside the six ``sniper-tpu-*`` entries."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    for name in NAMES:
        dashed = name.replace("_", "-")
        assert scripts[f"sniper-tpu-{dashed}"] == \
            f"somatic_sniper_tpu.scripts.{name}:main"
        assert scripts[f"sniper-torch-{dashed}"] == \
            f"somatic_sniper_tpu_torch.scripts.{name}:main"
        assert callable(both(name)[1].main)
