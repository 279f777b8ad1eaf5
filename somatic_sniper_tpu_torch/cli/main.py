"""bam-somaticsniper-torch: the reference's CLI on the torch port.

Same flag surface as ``bam-somaticsniper-tpu`` plus ``--device
{cuda,cpu}``.  ``usage_text``, ``build_parser`` and ``_commit_id`` are
the port's own copies of those in somatic_sniper_tpu/cli/main.py (the
port imports nothing of the JAX package); the rest ports :193-565
there: whole-file and windowed runs, ``--manifest`` resume,
``--shards/--shard-index``, ``--jobs`` (shard worker processes and a
merge), and multi-process runs joined by ``SNIPER_COORDINATOR`` with
``--merge collective`` (on ``torch.distributed``), in exact and fast
precision.  Without the native host library the whole-file path decodes
in pure Python and scores batches on the device (u16 batches in fast
precision, full-u32 batches through the f64 glfgen in exact); the
windowed path needs the library's region loads, as in the JAX
package.

The device rule: ``--device`` names the device (``cuda`` by default),
and it is resolved where a path first needs one: at once in fast
precision, and in exact precision only when a run or a window cannot be
scored by the native host layer (no native library, no reference).  A
CUDA device that is named and absent ends the run with exit 1 and
``device.py``'s message; nothing carries on on the CPU unless ``--device
cpu`` was given.  So the default exact run needs no card, and neither it,
nor ``-v``, a usage error or the ``--jobs`` parent imports torch (the
parent builds both libraries and learns of a missing card from its
workers' exit codes and messages).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import __version__
from ..device import DeviceUnavailable, resolve_device
from ..io.bam import read_bam_header
from ..models.tables import ModelParams
from ..output.formatters import FORMATTERS, get_formatter
from ..output.records import HeaderData
from ..runner import NativeUnavailable
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
                        "merge their outputs with "
                        "somatic_sniper_tpu_torch.scripts.merge_shards "
                        "(built-in equivalent of the manual "
                        "--shards/--shard-index + merge workflow; the "
                        "reference scaled only by running one process per "
                        "chromosome externally)")
    p.add_argument("--merge", default="files",
                   choices=("files", "collective"),
                   help="multi-process record merge: 'files' writes one "
                        "output per process for scripts.merge_shards; "
                        "'collective' all-gathers shard bytes over "
                        "torch.distributed (no shared filesystem needed) "
                        "and process 0 writes the merged output [files]")
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
                   help="device that scores slabs and batches; cuda "
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


# set by --jobs for its workers: the epoch second they were spawned at,
# so that each reports its start-up (spawn to first window) in its stats
SPAWNED_AT_ENV = "SNIPER_JOBS_SPAWNED_AT"


def _maybe_init_distributed(args) -> None:
    """Multi-process initialization (opt-in via env, so single-process
    runs never touch torch.distributed):

        SNIPER_COORDINATOR=host:port SNIPER_NUM_PROCESSES=N \\
        SNIPER_PROCESS_ID=I python -m somatic_sniper_tpu_torch.cli.main ...

    Each process then defaults to genome shard I of N (overridable with
    --shards/--shard-index) and scores its span on its one device, as
    its --device and CUDA_VISIBLE_DEVICES say; per-process outputs
    concatenate via scripts.merge_shards, or through --merge collective.
    The group is gloo's (parallel/collective.py says why).  Its timeout,
    for the rendezvous here and for every collective after it, is
    SNIPER_MERGE_TIMEOUT_MS but at least two minutes (processes start
    seconds apart); the merge barrier applies the variable as it is."""
    coord = os.environ.get("SNIPER_COORDINATOR")
    if not coord:
        return
    from datetime import timedelta

    import torch.distributed as dist

    from ..parallel.collective import merge_timeout_ms

    num = int(os.environ["SNIPER_NUM_PROCESSES"])
    pid = int(os.environ["SNIPER_PROCESS_ID"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", rank=pid, world_size=num,
        timeout=timedelta(milliseconds=max(merge_timeout_ms(), 120_000)))
    if args.shards == 1 and args.shard_index is None:
        args.shards = num
        args.shard_index = pid
    args._dist = (num, pid)


def _run_jobs(args) -> int:
    """--jobs N: spawn N shard worker processes (contiguous genome
    partition, same numbering as --shards/--shard-index) and merge
    their outputs; the merged bytes equal a single-process run.

    Worker thread budget: each worker's region-load pool is clamped
    (SNIPER_LOAD_POOL=1) when N workers x 2 load threads would
    oversubscribe the host's cores.  Both libraries are built before
    the workers start, so that N workers do not each run the
    compilers.  With ``--stats`` the parent adds a summary of its own
    (``jobs.build``, ``jobs.workers``, the ``jobs_workers`` count, and its
    ``worker_startup.imports`` when its own spawn time was given)."""
    import subprocess
    import tempfile

    from ..io import native
    from ..scripts.merge_shards import merge

    ncpu = os.cpu_count() or 1
    if args.jobs > ncpu:
        # more workers than cores can't help: per-worker work is CPU
        # bound; degrade instead of thrashing
        print(f"--jobs {args.jobs} clamped to {ncpu} (host cores)",
              file=sys.stderr)
        args.jobs = ncpu
    if args.jobs <= 1:
        args.jobs = 1
    with run_stats.STATS.timer("jobs.build"):
        native.get_lib()
        if args.device == "cuda" and args.precision == "fast":
            # exact workers score in the native layer and launch no
            # kernel.  ops.build imports no torch: nvcc, then ctypes at
            # first use
            from ..ops import build

            try:
                build.build()
            except RuntimeError as e:  # no nvcc, or a compile error
                print(f"{PROG}: {e}", file=sys.stderr)
                return 1

    base = [
        sys.executable, "-m", "somatic_sniper_tpu_torch.cli.main",
        "-f", args.ref, "-F", args.format,
        "-q", str(args.mapq), "-Q", str(args.min_somatic_qual),
        "-T", str(args.theta), "-N", str(args.n_hap),
        "-r", str(args.het_rate),
        "-n", args.normal_id, "-t", args.tumor_id,
        "--precision", args.precision,
        "--window-size", str(args.window_size),
        "--device", args.device,
    ]
    for flag, on in (("-L", args.no_loh), ("-G", args.no_gor),
                     ("-p", args.no_priors), ("-J", args.joint)):
        if on:
            base.append(flag)
    if args.somatic_rate is not None:
        base += ["-s", str(args.somatic_rate)]
    tmpdir = tempfile.mkdtemp(prefix="sniper_jobs_")
    outs = [os.path.join(tmpdir, f"shard{i}.out")
            for i in range(args.jobs)]
    wenv = dict(os.environ)
    if "SNIPER_LOAD_POOL" not in wenv and 2 * args.jobs > ncpu:
        wenv["SNIPER_LOAD_POOL"] = "1"
    wenv[SPAWNED_AT_ENV] = repr(time.time())
    procs = [
        subprocess.Popen(
            base + ["--shards", str(args.jobs), "--shard-index", str(i),
                    args.tumor_bam, args.normal_bam, outs[i]],
            env=wenv,
        )
        for i in range(args.jobs)
    ]
    rc = 0
    with run_stats.STATS.timer("jobs.workers"):
        for p in procs:
            rc = rc or p.wait()
    if args.stats or run_stats.enabled():
        run_stats.STATS.add("jobs_workers", args.jobs)
        sys.stderr.write(run_stats.STATS.summary() + "\n")
        sys.stderr.flush()
    try:
        if rc:
            print(f"--jobs worker failed (exit {rc})", file=sys.stderr)
            return rc
        merge(args.output, outs)
        return 0
    finally:
        for o in outs:
            try:
                os.unlink(o)
            except OSError:
                pass
        try:
            os.rmdir(tmpdir)
        except OSError:
            pass


def main(argv=None) -> int:
    _record_startup("worker_startup.imports")
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"Somatic Sniper version ({__version__}) "
              f"(commit {_commit_id()}) (torch)")
        return 0
    try:
        _maybe_init_distributed(args)
    except Exception as e:
        print(f"{PROG}: distributed init failed "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return 3
    try:
        return _main(args)
    finally:
        if getattr(args, "_dist", None) is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _main(args) -> int:
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
    if args.jobs > 1:
        if args.shard_index is not None or args.manifest:
            print("--jobs cannot combine with --shard-index/--manifest",
                  file=sys.stderr)
            return 1
        return _run_jobs(args)
    dist = getattr(args, "_dist", None)
    if dist is not None and args.merge == "collective":
        num, pid = dist
        # Hard failure paths use os._exit: after a peer death the
        # process group's teardown can block on the dead peer, turning a
        # clean fail-fast into a hang.  The branch logic lives in
        # _run_collective (returns the code + hard flag) so the failure
        # semantics are unit-testable in-process; output and manifest
        # are flushed before every hard exit.
        try:
            rc, hard = _run_collective(args, params, header_fn, hdata,
                                       args.device, num, pid)
        except DeviceUnavailable as e:
            print(f"{PROG}: {e}", file=sys.stderr)
            sys.stderr.flush()
            rc, hard = 1, True
        if hard:
            os._exit(rc)
        return rc
    try:
        return _run(args, params, header_fn, hdata, args.device)
    except (OSError, ValueError, NativeUnavailable, DeviceUnavailable) as e:
        # fail fast with a message, like the reference's exit paths
        # (truncated/corrupt/unsorted inputs, malformed .fai, ...); a
        # named CUDA device that is absent ends here too, and only here
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1


def _run_collective(args, params, header_fn, hdata, device,
                    num: int, pid: int) -> tuple[int, bool]:
    """One collective-merge worker's run: score the shard, rendezvous,
    all-gather the merge.  Returns ``(exit_code, hard)``: ``hard``
    means the caller must ``os._exit`` (a peer may be dead and the
    process group's teardown would hang; see _main).  Every failure
    leaves the shard output + manifest on disk so a re-run with the
    same manifests resumes.  A missing device is not handled here: it
    passes through to _main."""
    real_out = args.output
    args.output = f"{real_out}.shard{pid}"
    try:
        rc = _run(args, params, header_fn, hdata, device)
    except DeviceUnavailable:
        raise
    except (OSError, ValueError, NativeUnavailable) as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        sys.stderr.flush()
        return 1, True
    except Exception as e:
        print(
            f"{PROG}: distributed run failed "
            f"({type(e).__name__}: {e}); shard output kept at "
            f"{args.output} — re-run with the same manifests to "
            "resume",
            file=sys.stderr,
        )
        sys.stderr.flush()
        return 3, True
    if rc == 0:
        from ..parallel import collective

        try:
            # rendezvous with a timeout BEFORE the all-gather: a dead
            # peer must fail the survivors fast, not hang them in the
            # collective; shard output + manifest stay on disk for a
            # resumed re-run
            collective.merge_barrier()
        except Exception as e:
            print(
                f"{PROG}: merge barrier failed "
                f"(a worker died or stalled): {e}; shard output "
                f"kept at {args.output} — re-run with the same "
                "manifests to resume",
                file=sys.stderr,
            )
            sys.stderr.flush()
            return 3, True
        try:
            collective.collective_merge(real_out, args.output, pid, num)
        except Exception as e:
            print(
                f"{PROG}: collective merge failed "
                f"({type(e).__name__}: {e}); shard outputs kept",
                file=sys.stderr,
            )
            sys.stderr.flush()
            return 3, True
    return rc, False


def _record_startup(stage: str = "worker_startup") -> None:
    """A --jobs worker's start-up as a stage of its summary: the time
    since its spawn (the parent stamps it into the environment), read
    when ``main`` is entered (``worker_startup.imports``: the
    interpreter and the imports) and at the first window
    (``worker_startup``: also the indexes, the reference blob, the
    device's context and tables, and the first slabs' round trip)."""
    if SPAWNED_AT_ENV in os.environ:
        run_stats.STATS.record(
            stage, time.time() - float(os.environ[SPAWNED_AT_ENV]))


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
    """``device`` is the device's name (or a ``torch.device``).  Fast
    precision needs it for certain and resolves it before the output is
    opened; exact precision hands the name on, and the drivers resolve it
    only if a run or a window needs it."""
    if args.precision == "fast":
        device = resolve_device(device)
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
        with run_stats.maybe_profile(), open(args.output, mode) as fh:
            if mode == "r+":
                fh.seek(resume_at)
                fh.truncate()
            else:
                header_fn(fh, hdata)
            # fault-injection hook for the distributed failure tests: die
            # hard (no cleanup, like a real crash) after N windows
            fault_after = os.environ.get("SNIPER_FAULT_EXIT_AFTER_WINDOW")
            n_done = 0
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
                if n_done == 0:
                    _record_startup()
                n_done += 1
                if fault_after and n_done >= int(fault_after):
                    os._exit(17)
            if n_done == 0:  # a shard with no window to score
                _record_startup()
    if args.stats or run_stats.enabled():
        # a run that never loaded the kernels' module launched none
        kernels = sys.modules.get(
            "somatic_sniper_tpu_torch.ops.glfgen_kernels")
        for kernel, n in (kernels.LAUNCHES.items() if kernels else ()):
            if n:
                run_stats.STATS.add(f"launches_{kernel}", n)
        # one write, so that the summaries of --jobs workers, which share
        # the parent's stderr, do not interleave
        sys.stderr.write(run_stats.STATS.summary() + "\n")
        sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
