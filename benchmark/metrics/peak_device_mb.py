"""peak_device_mb: ``torch.cuda.max_memory_reserved`` from the driver's
construction to the end of the window (graph pools included), in MB."""


def read(run):
    if not run.peak_reserved_bytes:
        return None
    return run.peak_reserved_bytes / 1e6
