"""device_peak_gib.<run|genome>: torch.cuda.max_memory_allocated() over the
window, after reset_peak_memory_stats(), in GiB."""


def read(data):
    return data.peak_window_bytes / 2**30 if data.peak_window_bytes else None
