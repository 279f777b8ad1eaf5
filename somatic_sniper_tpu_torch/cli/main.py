"""bam-somaticsniper-torch: the reference's CLI on the torch port.

Same flag surface as ``bam-somaticsniper-tpu`` plus ``--device
{cuda,cpu}``.  ``usage_text``, ``build_parser`` and ``_commit_id`` are
the port's own copies of those in somatic_sniper_tpu/cli/main.py (the
port imports nothing of the JAX package); ``main`` and ``_run`` port
:299-565 there: whole-file and windowed runs, ``--manifest`` resume and
``--shards/--shard-index``, in exact and fast precision.  Not copied:
``_maybe_init_distributed`` (it imports JAX) and ``_run_jobs``; the
flags they serve exit 1 here.  Without the native host library the
whole-file fast path decodes in pure Python and scores u16 batches;
exact precision and the windowed driver exit 1 there.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import __version__
from ..io.bam import read_bam_header
from ..models.tables import ModelParams
from ..output.formatters import FORMATTERS, get_formatter
from ..output.records import HeaderData
from ..runner import NOT_PORTED, NativeUnavailable
from ..utils import stats as run_stats

PROG = "bam-somaticsniper-torch"
# references longer than this default to the windowed driver
WINDOWED_MIN_REF_LEN = 1_500_000


def usage_text(progname: str = PROG,
               mapq: int = 0, min_somatic_qual: int = 15,
               somatic_mutation_rate: float = 0.01, theta: float = 0.85,
               n_hap: int = 2, het_rate: float = 0.001) -> str:
    """The reference's usage() text, byte-for-byte modulo the program
    name (reference main.c:27-62, incl. the double space in the -Q line
    and the registry-order format list of output_format.c:10-17)."""
    lines = [
        "",
        "",
        f"{progname} [options] -f <ref.fasta> <tumor.bam> <normal.bam>"
        " <snp_output_file>",
        "",
        "Required Option: ",
        "        -f FILE   REQUIRED reference sequence in the FASTA"
        " format",
        "",
        "Options: ",
        "        -v        Display version information",
        "",
        f"        -q INT    filtering reads with mapping quality less"
        f" than INT [{mapq}]",
        f"        -Q INT    filtering somatic snv output with somatic"
        f" quality less than  INT [{min_somatic_qual}]",
        "        -L FLAG   do not report LOH variants as determined by"
        " genotypes",
        "        -G FLAG   do not report Gain of Reference variants as"
        " determined by genotypes",
        "        -p FLAG   disable priors in the somatic calculation."
        " Increases sensitivity for solid tumors",
        "        -J FLAG   Use prior probabilities accounting for the"
        " somatic mutation rate",
        f"        -s FLOAT  prior probability of a somatic mutation"
        f" (implies -J) [{somatic_mutation_rate:f}]",
        f"        -T FLOAT  theta in maq consensus calling model"
        f" (for -c/-g) [{theta:f}]",
        f"        -N INT    number of haplotypes in the sample"
        f" (for -c/-g) [{n_hap}]",
        f"        -r FLOAT  prior of a difference between two haplotypes"
        f" (for -c/-g) [{het_rate:f}]",
        "        -n STRING normal sample id (for VCF header) [NORMAL]",
        "        -t STRING tumor sample id (for VCF header) [TUMOR]",
        "        -F STRING select output format [classic]",
        "           Available formats:",
    ] + [f"             {name}" for name in ("classic", "vcf", "bed")] + [
        "",
    ]
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description=(
            "somatic SNV caller with SomaticSniper's statistics, "
            "PyTorch/CUDA port"
        ),
        add_help=True,
    )
    p.add_argument("-f", dest="ref", metavar="FILE", required=False,
                   help="REQUIRED reference sequence in the FASTA format")
    p.add_argument("-v", dest="version", action="store_true",
                   help="Display version information")
    p.add_argument("-q", dest="mapq", type=int, default=0, metavar="INT",
                   help="filtering reads with mapping quality less than INT")
    p.add_argument("-Q", dest="min_somatic_qual", type=int, default=15,
                   metavar="INT",
                   help="filtering somatic snv output with somatic quality "
                        "less than INT")
    p.add_argument("-L", dest="no_loh", action="store_true",
                   help="do not report LOH variants as determined by "
                        "genotypes")
    p.add_argument("-G", dest="no_gor", action="store_true",
                   help="do not report Gain of Reference variants as "
                        "determined by genotypes")
    p.add_argument("-p", dest="no_priors", action="store_true",
                   help="disable priors in the somatic calculation. "
                        "Increases sensitivity for solid tumors")
    p.add_argument("-J", dest="joint", action="store_true",
                   help="Use prior probabilities accounting for the somatic "
                        "mutation rate")
    p.add_argument("-s", dest="somatic_rate", type=float, default=None,
                   metavar="FLOAT",
                   help="prior probability of a somatic mutation "
                        "(implies -J) [0.010000]")
    p.add_argument("-T", dest="theta", type=float, default=0.85,
                   metavar="FLOAT",
                   help="theta in maq consensus calling model [0.850000]")
    p.add_argument("-N", dest="n_hap", type=int, default=2, metavar="INT",
                   help="number of haplotypes in the sample [2]")
    p.add_argument("-r", dest="het_rate", type=float, default=0.001,
                   metavar="FLOAT",
                   help="prior of a difference between two haplotypes "
                        "[0.001000]")
    p.add_argument("-n", dest="normal_id", default="NORMAL", metavar="STRING",
                   help="normal sample id (for VCF header) [NORMAL]")
    p.add_argument("-t", dest="tumor_id", default="TUMOR", metavar="STRING",
                   help="tumor sample id (for VCF header) [TUMOR]")
    p.add_argument("-I", dest="_dead_I", default=None, metavar="STRING",
                   help=argparse.SUPPRESS)  # parity: reference getopt
    # consumes "I:" but has no handler for it (reference main.c:80)
    p.add_argument("-F", dest="format", default="classic", metavar="STRING",
                   choices=sorted(FORMATTERS),
                   help="select output format [classic] "
                        f"(available: {', '.join(sorted(FORMATTERS))})")
    p.add_argument("--precision", default="exact",
                   choices=("exact", "fast"),
                   help="model arithmetic: 'exact' replicates the reference "
                        "bit-for-bit; 'fast' is the f32 device path")
    p.add_argument("--shards", type=int, default=1,
                   help="total number of genome shards")
    p.add_argument("--shard-index", type=int, default=None,
                   help="process only this shard (deterministic interval "
                        "partition); omit to process all shards locally")
    p.add_argument("--jobs", type=int, default=1, metavar="INT",
                   help="run INT shard worker processes on this host and "
                        "merge their outputs (built-in equivalent of the "
                        "manual --shards/--shard-index + merge_shards "
                        "workflow; the reference scaled only by running "
                        "one process per chromosome externally)")
    p.add_argument("--merge", default="files",
                   choices=("files", "collective"),
                   help="multi-process record merge: 'files' writes one "
                        "output per process for scripts.merge_shards; "
                        "'collective' all-gathers shard bytes (no shared "
                        "filesystem needed) and process 0 writes the "
                        "merged output [files]")
    p.add_argument("--window-size", type=int, default=250_000,
                   help="genome window length for the region-sharded "
                        "streaming driver [250000]")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage wall-clock/volume counters to "
                        "stderr at exit (also SNIPER_STATS=1); set "
                        "SNIPER_PROFILE=<dir> for a torch.profiler trace")
    p.add_argument("--manifest", default=None, metavar="FILE",
                   help="per-window completion manifest; enables the "
                        "streaming driver and crash-resumable runs "
                        "(re-running with the same manifest skips "
                        "completed windows)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device that scores fast-precision slabs; cuda "
                        "fails when no GPU is present [cuda]")
    p.add_argument("tumor_bam", nargs="?")
    p.add_argument("normal_bam", nargs="?")
    p.add_argument("output", nargs="?")
    return p


def _commit_id() -> str:
    """Source commit for version_info (reference main.c:20-25 prints the
    git-stamped commit via build-common/cmake/VersionHelper.cmake:1-8).

    Resolution: a build-time-stamped ``somatic_sniper_tpu_torch._commit``
    module if present (sdist/wheel installs), else a live ``git
    rev-parse`` of the package's checkout (editable/dev installs),
    else "unknown"."""
    try:
        from .. import _commit  # type: ignore

        return _commit.COMMIT
    except Exception:
        pass
    try:
        import subprocess

        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            ["git", "-C", here, "rev-parse", "--short=8", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip()
    except Exception:
        pass
    return "unknown"


def _not_ported(what: str) -> int:
    print(f"{PROG}: {what} is {NOT_PORTED}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"Somatic Sniper version ({__version__}) "
              f"(commit {_commit_id()}) (torch)")
        return 0
    if os.environ.get("SNIPER_COORDINATOR"):
        return _not_ported("multi-host init (SNIPER_COORDINATOR)")
    if args.jobs > 1:
        return _not_ported("--jobs")
    if args.merge == "collective":
        return _not_ported("--merge collective")
    if not (args.tumor_bam and args.normal_bam and args.output):
        sys.stderr.write(usage_text(
            progname=PROG, mapq=args.mapq,
            min_somatic_qual=args.min_somatic_qual,
            somatic_mutation_rate=(args.somatic_rate
                                   if args.somatic_rate is not None
                                   else 0.01),
            theta=args.theta, n_hap=args.n_hap, het_rate=args.het_rate,
        ))
        return 1
    if not args.ref:
        print("You MUST specify a reference sequence. It isn't optional.",
              file=sys.stderr)
        return 1
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    if args.tumor_bam == "-":
        # tumor BAM from stdin (reference main.c:128): spool to a temp
        # file so the region/seek paths work on it too
        import tempfile

        tmp = tempfile.NamedTemporaryFile(suffix=".bam", delete=False)
        with tmp:
            while True:
                chunk = sys.stdin.buffer.read(1 << 20)
                if not chunk:
                    break
                tmp.write(chunk)
        args.tumor_bam = tmp.name

    params = ModelParams(
        theta=args.theta,
        n_hap=args.n_hap,
        het_rate=args.het_rate,
        use_priors=not args.no_priors,
        use_joint_priors=args.joint or args.somatic_rate is not None,
        somatic_mutation_rate=(args.somatic_rate
                               if args.somatic_rate is not None else 0.01),
        min_somatic_qual=args.min_somatic_qual,
        include_loh=not args.no_loh,
        include_gor=not args.no_gor,
        mapq_threshold=args.mapq,
    )
    if params.use_joint_priors:
        print("Using priors accounting for somatic mutation rate. Prior "
              "probability of a somatic mutation is "
              f"{params.somatic_mutation_rate:f}", file=sys.stderr)
    print("Preparing to snipe some somatics", file=sys.stderr)
    if params.use_priors:
        print("Using prior probabilities", file=sys.stderr)
    print(f"Normal bam is {args.normal_bam}", file=sys.stderr)
    print(f"Tumor bam is {args.tumor_bam}", file=sys.stderr)
    # @RG parse parity (reference main.c:132,135): warnings only
    try:
        read_bam_header(args.tumor_bam).parse_rg()
        read_bam_header(args.normal_bam).parse_rg()
    except (OSError, ValueError):
        pass  # unreadable inputs produce their real error downstream

    header_fn, _ = get_formatter(args.format)
    hdata = HeaderData(refseq=args.ref, normal_sample_id=args.normal_id,
                       tumor_sample_id=args.tumor_id)
    try:
        return _run(args, params, header_fn, hdata, device)
    except (OSError, ValueError, NativeUnavailable) as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1


def _use_windowed(args) -> bool:
    if args.shards > 1 or args.shard_index is not None or args.manifest:
        return True
    if args.tumor_bam == "-":
        return False
    try:
        return (sum(read_bam_header(args.tumor_bam).ref_lengths)
                > WINDOWED_MIN_REF_LEN)
    except (OSError, ValueError):
        return False


def _run(args, params, header_fn, hdata, device) -> int:
    if not _use_windowed(args):
        from ..runner import call_pair

        with run_stats.maybe_profile(), open(args.output, "w") as fh:
            header_fn(fh, hdata)
            for line in call_pair(
                args.tumor_bam, args.normal_bam, args.ref, args.format,
                params=params, precision=args.precision, device=device,
            ):
                fh.write(line)
    else:
        from ..parallel.sharded import Manifest, call_pair_windows

        manifest = Manifest(args.manifest) if args.manifest else None
        resume_at = manifest.resume_offset() if manifest else None
        skip = set(manifest.done) if manifest else None
        mode = ("r+" if resume_at is not None and os.path.exists(args.output)
                else "w")
        with open(args.output, mode) as fh:
            if mode == "r+":
                fh.seek(resume_at)
                fh.truncate()
            else:
                header_fn(fh, hdata)
            for wi, _win, lines in call_pair_windows(
                args.tumor_bam, args.normal_bam, args.ref, args.format,
                params=params, precision=args.precision,
                window_size=args.window_size, shards=args.shards,
                shard_index=args.shard_index, skip_windows=skip,
                device=device,
            ):
                fh.writelines(lines)
                fh.flush()
                if manifest:
                    manifest.mark(wi, fh.tell())
    if args.stats or run_stats.enabled():
        print(run_stats.STATS.summary(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
