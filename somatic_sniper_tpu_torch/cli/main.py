"""bam-somaticsniper-torch: the reference's CLI on the torch port.

Same flag surface as ``bam-somaticsniper-tpu`` (the parser, usage text
and version string come from somatic_sniper_tpu.cli.main, whose module
level is jax-free) plus ``--device {cuda,cpu}``.  Port of
somatic_sniper_tpu/cli/main.py:299-565: whole-file and windowed runs,
``--manifest`` resume and ``--shards/--shard-index``, in exact and fast
precision.
"""

from __future__ import annotations

import os
import sys

from somatic_sniper_tpu.cli.main import _commit_id, build_parser, usage_text
from somatic_sniper_tpu.io.bam import read_bam_header
from somatic_sniper_tpu.models.tables import ModelParams
from somatic_sniper_tpu.output.formatters import get_formatter
from somatic_sniper_tpu.output.records import HeaderData
from somatic_sniper_tpu.utils import stats as run_stats

from .. import __version__
from ..runner import NOT_PORTED

PROG = "bam-somaticsniper-torch"
# references longer than this default to the windowed driver
WINDOWED_MIN_REF_LEN = 1_500_000


def _parser():
    p = build_parser()
    p.prog = PROG
    p.description = ("somatic SNV caller with SomaticSniper's statistics, "
                     "PyTorch/CUDA port")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device that scores fast-precision slabs; cuda "
                        "fails when no GPU is present [cuda]")
    return p


def _not_ported(what: str) -> int:
    print(f"{PROG}: {what} is {NOT_PORTED}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
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
    except (OSError, ValueError) as e:
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

        with open(args.output, "w") as fh:
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
