"""Run configuration.

Mirrors the flag surface of the reference CLI (``IsoCon:183-250``) and its
mutable ``Parameters`` bag (``isocon_parameters.py:2-19``), as a dataclass
with explicit defaults.  Runtime-derived fields (logfile handles, folders)
are attached by the CLI.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Params:
    # required
    fl_reads: str = ""
    outfolder: str = ""
    candidates: str = ""          # stat_filter subcommand only

    # shared knobs (defaults match IsoCon:197-248)
    nr_cores: int = 16            # kept for CLI parity; device batching replaces it
    verbose: bool = False
    neighbor_search_depth: int = 2 ** 32
    min_exon_diff: int = 20
    min_candidate_support: int = 2
    p_value_threshold: float = 0.01
    min_test_ratio: int = 5
    max_phred_q_trusted: int = 43
    ignore_ends_len: int = 15
    cleanup: bool = False
    prefilter_candidates: bool = False   # declared but inert in the reference too
    ccs: Optional[str] = None            # BAM/SAM with CCS predictions
    nontargeted: bool = False            # --nontargeted: graph/sketch.py NN graph
    profile: bool = False                # capture a torch.profiler trace

    # derived at runtime
    is_fastq: bool = False
    read_file: str = ""
    logfile: Optional[object] = None
    develop_logfile: Optional[object] = None
    tempfolder: str = ""
    plotfolder: str = ""

    # engine knobs (no reference analog)
    devices: int = 1              # shard the engine over N devices (-1: all)
    batch_pairs: int = 128        # accepted for CLI parity; the engine sizes its own batches
    k0: int = 63                  # initial band radius for k-escalation NN search
    device: str = "cuda"          # torch device of the engine ("cuda" or "cpu")
    device_mesh: Optional[object] = None  # device list of a sharded run

    def ensure_outfolder(self) -> None:
        if self.outfolder and not os.path.exists(self.outfolder):
            os.makedirs(self.outfolder)
        if self.verbose:
            # developer log + plots dir under --verbose (IsoCon:280-284)
            self.plotfolder = os.path.join(self.outfolder, "plots")
            if not os.path.exists(self.plotfolder):
                os.makedirs(self.plotfolder)
            self.develop_logfile = open(
                os.path.join(self.outfolder, "develop_logfile.txt"), "w"
            )
        self.tempfolder = os.path.join(self.outfolder, "alignments")
        if not os.path.exists(self.tempfolder):
            os.makedirs(self.tempfolder)
