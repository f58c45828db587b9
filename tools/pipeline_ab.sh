#!/bin/bash
# Wall time of the port's 10k-read `pipeline` from two source trees on one
# CUDA card, in turns (A, B, B, A), so that two versions are compared on
# the same card and host.  Each tree builds its own kernels at first use,
# so the first run of each tree includes its build.
#
# Usage: bash tools/pipeline_ab.sh TREE_A TREE_B
#   e.g. d=isocon_tpu_torch/_build/parent; mkdir -p $d &&
#        git archive HEAD~1 isocon_tpu_torch | tar -x -C $d &&
#        bash tools/pipeline_ab.sh $d .
# Prints the card's name and power limit, then one line per run: the tree,
# the pipeline's seconds and the engine's ED, alignment and host-traceback
# seconds.  A run that fails prints the end of its output and stops the
# script with exit code 1.
set -euo pipefail
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
run() {
  if ! (cd "$1" && PYTHONHASHSEED=0 python3 -c "
import os, shutil, sys, time
sys.path.insert(0, os.getcwd())
from isocon_tpu_torch import cli
from isocon_tpu_torch.workload import write_reads
work = '$work'
write_reads(work + '/reads.fa', 10000)
shutil.rmtree(work + '/out', ignore_errors=True)
t = time.perf_counter()
e, _p = cli.main(['pipeline', '-fl_reads', work + '/reads.fa',
                  '-outfolder', work + '/out', '--device', 'cuda'])
c = e.counters
print('AB', '$1', 'pipeline_s', time.perf_counter() - t, 'ed_s',
      c['ed_seconds'], 'align_s', c['align_seconds'], 'traceback_s',
      c['hw_traceback_seconds'], flush=True)
") > "$work/run.log" 2>&1 || ! grep "^AB " "$work/run.log"; then
    echo "pipeline_ab: the run from $1 failed:" >&2
    tail -n 40 "$work/run.log" >&2
    exit 1
  fi
}
run "$1"; run "$2"; run "$2"; run "$1"
