"""The control of the comparison that decides ``correct``, at a cell's size.

    python3 benchmark/control.py --config wgs30 --seeds 11 12 13

For each seed: makes the configuration's pair, scores the whole genome
with the plain reference twice, in the tool's arithmetic and in
bfloat16 (the precision below the float32 that ``--precision fast``
states), split over worker processes, and compares the bfloat16 records,
put in the program's place, with the others exactly as ``run.py``
compares the program's (``check.compare``, the same sample).
Prints one JSON line a seed.  The control must come out as not correct;
the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _part(task):
    pair_dir, flags, regions = task
    sys.path.insert(0, str(HERE))
    from reference import caller, model

    prm = model.params_from_flags(flags)
    reads = caller.read_pair(Path(pair_dir) / "tumor.bam",
                             Path(pair_dir) / "normal.bam",
                             Path(pair_dir) / "ref.fa")
    ex = caller.call(None, None, None, prm, regions=regions, reads=reads)
    bf = caller.call(None, None, None, prm, regions=regions, reads=reads,
                     precision="bf16")
    return ex.lines, ex.near, bf.lines, ex.columns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=8)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))

    import check
    import pairgen
    import run as harness
    from reference import caller, model

    cfg = json.loads((HERE / "configs" / f"{a.config}.json").read_text())
    d = cfg["data"]
    lengths = [d["contig_len"]] * d["n_contigs"]
    names = {f"ctg{i + 1}": i for i in range(d["n_contigs"])}
    chk = cfg["check"]
    prm = model.params_from_flags(cfg["flags"])
    work = harness.work_dir(HERE.parent) / "control"
    ctx = mp.get_context("spawn")
    for seed in a.seeds:
        t = time.perf_counter()
        pair = pairgen.generate(work, d, seed)
        spans = harness.genome_windows(lengths, 250_000)
        parts = [spans[i::a.workers] for i in range(a.workers)]
        with ctx.Pool(a.workers) as pool:
            got = pool.map(_part, [(str(work), cfg["flags"], sorted(p))
                                   for p in parts if p])
        ex, bf = caller.Result(), caller.Result()
        for lines, near, blines, cols in got:
            ex.lines.update(lines)
            ex.near.update(near)
            bf.lines.update(blines)
            ex.columns += cols
        _, in_sample = harness.check_sample(spans, chk, seed, pair.somatic)
        lines = [bf.lines[k] for k in sorted(bf.lines)]
        res = check.compare(lines, ex, in_sample, names, prm.min_qual,
                            chk["phred_tolerance"])
        limits = chk["limits"]
        res["correct"] = all(res.get(k, 0) <= v for k, v in limits.items())
        print(json.dumps({"config": a.config, "seed": seed, "control": res,
                          "exact_records": len(ex.lines),
                          "columns": ex.columns,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
