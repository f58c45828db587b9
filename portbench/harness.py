"""One run of one cell: set-up, the measured window of whole jobs, the
``correct`` comparison and the metrics.

The window is a closed loop: job k draws its family and reads from
(seed, k) (``generator.make_job``) and writes them as FASTA; then the
job runs the traffic's subcommand on them through the port's CLI
(``cli.parse`` and the runner it returns, as a user's command line
would), and ends when its outputs are written and the card has finished;
then its outputs are read for the check and removed, and the next job
is made.  The window's clock runs only while a job runs: it is the sum
of the jobs' wall times, and making a job's reads, reading its outputs
and removing them, the benchmark's own work, stay outside it.  Jobs
start until the clock has passed ``seconds``; the one in flight
finishes.  Set-up is the process's start to the first job: imports, the
CUDA context, the kernels (built into the program's ``_build`` on a
checkout's first run, loaded after), and a warm-up job of the cell's own
size on job -1 of the seed, which no window uses: on one H100 a smaller
one left the first timed job 0.4-0.8 s slower than the rest (host memory
and device pools first grown there).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import check
from .generator import make_job, write_fasta
from .recorder import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "isocon_tpu")


@dataclass
class Job:
    reads: int
    seconds: float
    phase_s: Dict[int, float]
    counters_phase1: Optional[dict]
    counters_end: dict
    launches_phase1: Optional[dict]
    launches_end: dict


@dataclass
class Run:
    """What a metric's ``read(run)`` may read."""
    cell: object
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    jobs: List[Job] = field(default_factory=list)
    warmup_launches: dict = field(default_factory=dict)
    recorder: Optional[Recorder] = None
    events: Optional[list] = None       # the traced window's events
    trace_spans: list = field(default_factory=list)  # its jobs' (us, us)
    busy_s: Optional[float] = None
    peak_bytes: int = 0
    clock_mhz: Optional[float] = None
    power_limit: Optional[str] = None

    @property
    def trace_s(self) -> float:
        """Seconds of the traced window: the sum of its jobs' spans."""
        return sum(hi - lo for lo, hi in self.trace_spans) / 1e6


def forbidden_modules(modules) -> List[str]:
    """Names in ``modules`` whose top-level name (before the first dot)
    is one of FORBIDDEN, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def nvidia_smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _phase_seconds(logfile: str) -> Dict[int, float]:
    out = {}
    with open(logfile) as fh:
        for line in fh:
            text = line.rstrip("\n").split("\t")[-1]
            if text.startswith("TIME ELAPSED FOR FINDING CANDIDATES"):
                out[1] = float(text.rsplit(":", 1)[1])
            elif text.startswith("TIME ELAPSED FOR STATISTICAL TEST"):
                out[2] = float(text.rsplit(":", 1)[1])
    return out


class Jobs:
    """Runs the cell's jobs through the port's CLI."""

    def __init__(self, cell, seed: int, device: str, workdir: str):
        from isocon_tpu_torch import cli
        from isocon_tpu_torch.ops import _build

        self.cli, self.build = cli, _build
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir = workdir

    def make(self, k: int):
        """(isoforms, reads, FASTA path) of job k, written to disk."""
        isoforms, reads = make_job(self.cell.config, self.seed, k)
        jobdir = os.path.join(self.workdir, "job%d" % k)
        os.makedirs(jobdir)
        fasta = os.path.join(jobdir, "reads.fa")
        write_fasta(fasta, reads)
        return isoforms, reads, fasta

    def run(self, k: int, reads: List[str], fasta: str):
        """Job k on its FASTA, timed from the command line's parse to its
        outputs written and the card finished; returns (Job, its output
        folder), or raises ``JobFailed`` with the seconds it ran."""
        import torch
        from torch.profiler import record_function

        out = os.path.join(os.path.dirname(fasta), "out")
        argv = ([self.cell.traffic["subcommand"], "-fl_reads", fasta,
                 "-outfolder", out, "--device", self.device]
                + list(self.cell.traffic.get("args", [])))
        self.build.reset_launches()
        params = None
        t0 = time.perf_counter()
        try:
            with record_function("portbench.job"):
                runner, params = self.cli.parse(argv)
                result = runner(params)
                if self.device == "cuda":
                    torch.cuda.synchronize()
        except Exception as exc:
            raise JobFailed(time.perf_counter() - t0) from exc
        finally:
            if params is not None and params.logfile is not None:
                params.logfile.close()
        seconds = time.perf_counter() - t0
        if isinstance(result, tuple):
            engine, phase1 = result
            phase1 = dict(phase1)
            launches1 = phase1.pop("launches", None)
        else:
            engine, phase1, launches1 = result, None, None
        job = Job(len(reads), seconds,
                  _phase_seconds(os.path.join(out, "logfile.txt")),
                  phase1, dict(engine.counters), launches1,
                  dict(self.build.LAUNCHES))
        return job, out

    def outputs(self, out: str, reads: List[str], isoforms: List[str]):
        return check.job_outputs(os.path.join(out, "final_candidates.fa"),
                                 os.path.join(out, "cluster_info.tsv"),
                                 reads, isoforms)

    def remove(self, k: int) -> None:
        shutil.rmtree(os.path.join(self.workdir, "job%d" % k),
                      ignore_errors=True)


class JobFailed(Exception):
    """A job that raised, with the seconds it ran (its cause chained)."""

    def __init__(self, seconds: float):
        super().__init__("job failed after %.3f s" % seconds)
        self.seconds = seconds


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", log=None) -> dict:
    """One run; returns the result line's object (see ``run.py``)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device == "cuda"
    run = Run(cell=cell, seed=seed)
    from isocon_tpu_torch.ops import _build
    from isocon_tpu_torch.ops.engine import PairEngine

    log("set-up: %.2f s to the imports" % (time.time() - t_start))
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        log("set-up: %.2f s to the CUDA context" % (time.time() - t_start))
        build_s = _build.build_all()
        log("kernels: %.2f s building (0: already built)" % build_s)
        run.power_limit = nvidia_smi("name,power.limit")
        clock = nvidia_smi("clocks.max.sm")
        run.clock_mhz = float(clock.split()[0]) if clock else None
    workdir = tempfile.mkdtemp(prefix="portbench_")
    recorder = Recorder(seed, cell.checks.get("sample", {}), keep_all=trace)
    run.recorder = recorder
    outputs: List[Dict[str, int]] = []
    attempted = failed = 0
    prof = None
    try:
        jobs = Jobs(cell, seed, device, workdir)
        with recorder.install(PairEngine):
            recorder.active = False
            t_warm = time.time()
            isoforms, reads, fasta = jobs.make(-1)
            warm, _out = jobs.run(-1, reads, fasta)
            jobs.remove(-1)
            log("set-up: %.2f s to the warm-up job, which took %.2f s"
                % (t_warm - t_start, time.time() - t_warm))
            run.warmup_launches = warm.launches_end
            recorder.active = True
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            run.setup_s = time.time() - t_start
            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if cuda:
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            k = 0
            while run.window_s < seconds or k == 0:
                isoforms, reads, fasta = jobs.make(k)
                attempted += 1
                try:
                    job, out = jobs.run(k, reads, fasta)
                except JobFailed as exc:
                    failed += 1
                    run.window_s += exc.seconds
                    traceback.print_exception(exc.__cause__)
                else:
                    run.window_s += job.seconds
                    run.jobs.append(job)
                    outputs.append(jobs.outputs(out, reads, isoforms))
                jobs.remove(k)
                k += 1
        if cuda:
            torch.cuda.synchronize()
            run.peak_bytes = int(torch.cuda.max_memory_allocated())
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            prof = None
            from . import trace as tr
            run.events = tr.load_events(path)
            os.unlink(path)
            run.trace_spans = tr.spans_of(run.events, "portbench.job")
            run.busy_s = tr.busy_seconds(
                tr.within(tr.device_events(run.events), run.trace_spans))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules(sys.modules)
    if found:
        raise SystemExit("portbench: the process holds %s after the window"
                         % ", ".join(found))
    missing = sorted({k for j in run.jobs for k, v in j.launches_end.items()
                      if v and not run.warmup_launches.get(k)})
    if missing:
        log("warm-up did not launch %s, which the window launched"
            % ", ".join(missing))

    for k, j in enumerate(run.jobs):
        c = j.counters_end
        log("job %d: %d reads in %.3f s, phases %s; %d ED pairs, %d "
            "alignments (%d overflows), %d HW survivors; launches %s"
            % (k, j.reads, j.seconds, j.phase_s, c["ed_pairs"],
               c["align_pairs"], c["align_overflows"], c["hw_survivors"],
               {n: v for n, v in j.launches_end.items() if v}))
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check.numbers(recorder.samples, outputs, failed, device)
    correct, rows = check.verdict(nums, cell.checks["limits"])
    log("reference check: %.2f s" % (time.perf_counter() - t_check))
    log("sampled: %s of %s offered" % (
        {k: len(v.items) for k, v in recorder.samples.items()},
        {k: v.offered for k, v in recorder.samples.items()}))
    from .spec import metric_values
    metrics = metric_values(cell.per_layer if trace else cell.end_to_end, run)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": run.peak_bytes},
        "card": {"nvidia_smi": run.power_limit, "sm_clock_mhz": run.clock_mhz},
    }
    if trace and run.events is not None:
        from . import trace as tr
        inside = tr.within(run.events, run.trace_spans)
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.trace_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in tr.device_ops(inside)],
            "idle_gaps": [list(x) for x in
                          tr.idle_gaps(run.events, run.trace_spans)],
        }
        result["copies"] = tr.summarise(inside)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    for name, v, lim in rows:
        log("check %s: %s (limit %s)" % (name, v, lim))
    return result
