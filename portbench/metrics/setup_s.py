"""setup_s: the process's start (before the hash-seed re-execution) to
the first timed job (host clock): imports, the CUDA context, the kernels
(built on a checkout's first run), the warm-up job."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
