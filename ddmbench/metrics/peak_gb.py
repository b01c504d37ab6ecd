"""``torch.cuda.max_memory_allocated()`` when the window closes, in GB
(1e9 bytes).  Never reset, so set-up counts too and memory moved into
set-up shows; read before the reference runs."""
UNIT = "GB"


def read(win):
    if not win.peak_bytes:
        win.note("peak_gb: no device memory was read (not a CUDA run)")
        return None
    return win.peak_bytes / 1e9
