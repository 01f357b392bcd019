"""Peak device memory (GiB): ``torch.cuda.max_memory_allocated()`` over
set-up and window, on the fullest card."""


def read(rec):
    if rec.peak_bytes <= 0:
        return None
    return rec.peak_bytes / 2 ** 30
