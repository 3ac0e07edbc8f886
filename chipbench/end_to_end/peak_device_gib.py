"""torch.cuda.max_memory_allocated() over set-up and window (reset when
the process starts), in GiB."""


def read(w):
    return w.peak_bytes / 2**30
