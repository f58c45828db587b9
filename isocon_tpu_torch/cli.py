"""Command-line entry point of the port: the ``pipeline``,
``get_candidates`` and ``stat_filter`` subcommands of the reference's
``IsoCon`` script (``IsoCon:183-250``), same flags and defaults, plus
``--device {cuda,cpu}``.

The engine runs on CUDA unless ``--device cpu`` is given; without a card it
raises instead of falling back.

Usage: python -m isocon_tpu_torch.cli pipeline -fl_reads READS.fa
       -outfolder OUT [--ccs CCS.bam] [--device cuda|cpu]
       python -m isocon_tpu_torch.cli get_candidates -fl_reads READS.fa
       -outfolder OUT
       python -m isocon_tpu_torch.cli stat_filter -fl_reads READS.fa
       -candidates CANDIDATES.fa -outfolder OUT
"""
from __future__ import annotations

import argparse
import contextlib
import os
import re
import shutil
import sys
from time import time

from torch.profiler import record_function

from .io import read_fasta, read_fastx
from .io.output import devlog, logger, print_candidates
from .ops._build import LAUNCHES
from .ops.engine import PairEngine
from .parallel import Sharder, distributed, make_mesh
from .params import Params
from .pipeline.candidates import find_candidate_transcripts
from .pipeline.stat_filter import stat_filter_candidates

KEEP_FILES = {
    "logfile.txt",
    "candidates_converged.fa",
    "final_candidates.fa",
    "not_converged.fa",
    "cluster_info.tsv",
}


def clean_dir(params) -> None:
    """``IsoCon:52-65``."""
    for name in os.listdir(params.outfolder):
        if name in KEEP_FILES:
            continue
        path = os.path.join(params.outfolder, name)
        if os.path.isfile(path):
            os.unlink(path)
        elif os.path.isdir(path):
            shutil.rmtree(path)


def initialize_logger(params) -> None:
    params.logfile = open(os.path.join(params.outfolder, "logfile.txt"), "w")
    for key, value in vars(params).items():
        if key in ("logfile", "develop_logfile"):
            continue
        logger("{0}:\t\t\t {1}".format(key, value), params.logfile,
               timestamp=False)
    logger("Starting.", params.logfile)


def make_engine(params) -> PairEngine:
    """The pair engine (``isocon_tpu/cli.py::make_engine``).  First it joins
    a multi-process group when ``ISOCON_COORDINATOR`` /
    ``ISOCON_NUM_PROCESSES`` / ``ISOCON_PROCESS_ID`` are set; then
    ``--devices N`` (N > 1) shards every kernel batch over the first N
    devices of ``--device`` (N logical shards of the CPU), and ``-1`` or
    a multi-process run over every process's devices (all visible cards;
    one CPU shard).  ``--devices 1`` alone builds no sharder."""
    multiprocess = distributed.initialize_from_env()
    ndev = params.devices
    if params.device_mesh is None and (ndev > 1 or ndev == -1
                                       or multiprocess):
        if ndev == -1 or multiprocess:
            params.device_mesh = distributed.make_global_mesh(
                make_mesh(None, params.device))
        else:
            params.device_mesh = make_mesh(ndev, params.device)
    if params.device_mesh is None:
        return PairEngine(device=params.device)
    return PairEngine(device=params.device,
                      sharder=Sharder(params.device_mesh))


@contextlib.contextmanager
def maybe_profile(params):
    """Under --profile, record a torch.profiler trace of the run into
    <outfolder>/torch_trace.json (viewable in chrome://tracing)."""
    if not params.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if params.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(params.outfolder, "torch_trace.json")
    prof.export_chrome_trace(path)
    logger("torch profiler trace written to {0}".format(path), params.logfile)


def run_pipeline(params):
    """Phase 1 then phase 2 on one engine.  Returns (engine, a copy of the
    engine's counters as they stood at the end of phase 1, with the kernel
    launch counts at that moment under ``"launches"``)."""
    total_start = time()
    initialize_logger(params)
    params.read_file = params.fl_reads
    engine = make_engine(params)

    with maybe_profile(params):
        t0 = time()
        # the two spans mark the phases in a --profile trace; the spans
        # inside them (isocon_phase1.*, isocon_phase2.*, isocon_engine.*)
        # are the pipeline's steps and the engine's calls
        with record_function("isocon_phase1"):
            candidate_file, read_partition, to_realign = (
                find_candidate_transcripts(params.read_file, params, engine))
        logger(
            "TIME ELAPSED FOR FINDING CANDIDATES WITH nearest_neighborS:{0}".format(
                time() - t0
            ),
            params.logfile,
        )
        logger(engine.stats_line(), params.logfile)
        devlog(params, "phase1 " + engine.stats_line())
        phase1_counters = dict(engine.counters, launches=dict(LAUNCHES))
        t1 = time()
        with record_function("isocon_phase2"):
            stat_filter_candidates(
                params.read_file, candidate_file, read_partition, to_realign,
                params, engine,
            )
        logger(
            "TIME ELAPSED FOR STATISTICAL TEST OF CANDIDATES:{0}".format(
                time() - t1),
            params.logfile,
        )
        logger(engine.stats_line(), params.logfile)
        devlog(params, "phase2 " + engine.stats_line())
    if params.cleanup:
        clean_dir(params)
    logger("TOTAL TIME ELAPSED FOR IsoCon:{0}".format(time() - total_start),
           params.logfile)
    return engine, phase1_counters


def run_get_candidates(params):
    total_start = time()
    initialize_logger(params)
    params.read_file = params.fl_reads
    engine = make_engine(params)
    with maybe_profile(params), record_function("isocon_phase1"):
        find_candidate_transcripts(params.read_file, params, engine)
    logger(engine.stats_line(), params.logfile)
    devlog(params, "phase1 " + engine.stats_line())
    logger(
        "TOTAL TIME ELAPSED FOR nearest_neighbor APPROACH:{0}".format(
            time() - total_start
        ),
        params.logfile,
    )
    if params.cleanup:
        clean_dir(params)
    return engine


def run_stat_filter(params):
    """``IsoCon:85-130``: user-supplied candidates are pre-filtered on the
    ``support_(\\d+)`` tag, everything is realigned from scratch."""
    total_start = time()
    initialize_logger(params)
    engine = make_engine(params)
    all_candidates = {acc: seq for acc, seq in read_fasta(params.candidates)}
    pre_path = os.path.join(params.outfolder, "preprocessed_candidates.fa")
    with open(pre_path, "w") as fh:
        for acc, seq in all_candidates.items():
            m = re.search(r"support_(\d+)", acc)
            if m and int(m.group(1)) < params.min_candidate_support:
                continue
            fh.write(">{0}\n{1}\n".format(acc, seq))
    params.candidates = pre_path

    if os.stat(params.candidates).st_size == 0:
        out = os.path.join(params.outfolder, "final_candidates.fa")
        print_candidates(out, {}, {}, {}, {}, final=True,
                         reads_to_consensus_tsv=os.path.join(
                             params.outfolder, "cluster_info.tsv"))
        print("Candidate file is empty!")
        sys.exit(0)

    if params.is_fastq:
        to_realign = {acc: seq for acc, seq, _q in read_fastx(params.fl_reads)}
    else:
        to_realign = {acc: seq for acc, seq in read_fasta(params.fl_reads)}
    read_partition = {acc: {} for acc, _ in read_fasta(params.candidates)}
    # phase 2 interns each read + candidate once per realignment round
    engine.reserve_pool_rows(2 * len(set(to_realign.values())))
    with maybe_profile(params), record_function("isocon_phase2"):
        stat_filter_candidates(
            params.fl_reads, params.candidates, read_partition, to_realign,
            params, engine,
        )
    logger(engine.stats_line(), params.logfile)
    devlog(params, "stat_filter " + engine.stats_line())
    if params.cleanup:
        clean_dir(params)
    logger("TOTAL TIME ELAPSED FOR STAT_FILTER:{0}".format(time() - total_start),
           params.logfile)
    return engine


def _add_common(p, with_stats: bool) -> None:
    p.add_argument("-fl_reads", required=True, type=str)
    p.add_argument("-outfolder", required=True, type=str)
    p.add_argument("--nr_cores", type=int, default=16)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--neighbor_search_depth", type=int, default=2 ** 32)
    p.add_argument("--min_exon_diff", type=int, default=20)
    p.add_argument("--min_candidate_support", type=int, default=2)
    p.add_argument("--ignore_ends_len", type=int, default=15)
    p.add_argument("--cleanup", action="store_true")
    p.add_argument("--batch_pairs", type=int, default=128,
                   help="accepted for CLI parity; the engine sizes its "
                        "own batches")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the kernels over the first N devices of "
                        "--device (N logical shards of the CPU); -1: all")
    p.add_argument("--nontargeted", action="store_true",
                   help="approximate sketch-retrieval candidate search "
                        "(hashed k-mer profiles, top-20 sketch neighbours "
                        "rescored exactly) for reads of many genes")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace of the run into "
                        "<outfolder>/torch_trace.json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the DP kernels run (default cuda; cpu runs "
                        "their plain PyTorch versions)")
    if with_stats:
        p.add_argument("--ccs", type=str)
        p.add_argument("--p_value_threshold", type=float, default=0.01)
        p.add_argument("--min_test_ratio", type=int, default=5)
        p.add_argument("--max_phred_q_trusted", type=int, default=43)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "isocon_tpu_torch",
        description="PyTorch/CUDA consensus/isoform reconstruction from long "
        "noisy amplicon reads.",
    )
    sub = parser.add_subparsers(dest="which")

    pipe = sub.add_parser("pipeline")
    _add_common(pipe, with_stats=True)
    pipe.add_argument("--prefilter_candidates", action="store_true")

    getc = sub.add_parser("get_candidates")
    _add_common(getc, with_stats=False)
    getc.add_argument("--prefilter_candidates", action="store_true")

    statf = sub.add_parser("stat_filter")
    statf.add_argument("-candidates", required=True, type=str)
    _add_common(statf, with_stats=True)
    return parser


def parse(argv=None):
    """(the subcommand's run function, its ``Params``) from the command
    line, with the output folder made."""
    parser = build_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if not args.which:
        parser.print_help()
        sys.exit(1)

    try:
        open(args.fl_reads, "r").close()
    except IOError:
        sys.exit("couldn't find read file: " + args.fl_reads)

    if args.fl_reads[-1] == "q":
        is_fastq = True
    elif args.fl_reads[-1] == "a":
        is_fastq = False
    else:
        sys.exit(
            args.fl_reads + " must end in 'a' (fasta/fa) or 'q' (fastq/fq)."
        )

    fields = {k: v for k, v in vars(args).items() if k != "which"}
    params = Params(**fields, is_fastq=is_fastq)
    params.ensure_outfolder()
    run = {"pipeline": run_pipeline, "get_candidates": run_get_candidates,
           "stat_filter": run_stat_filter}[args.which]
    return run, params


def main(argv=None):
    run, params = parse(argv)
    return run(params)


if __name__ == "__main__":
    main()
