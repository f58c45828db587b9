"""peak_device_mib: ``torch.cuda.max_memory_allocated`` over the window
(reset before its first job), in MiB."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
