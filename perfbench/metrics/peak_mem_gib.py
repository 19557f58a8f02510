"""The device memory the program held at its peak over set-up and window
(the caching allocator's peak of allocated bytes), in GiB."""


def read(rec):
    if rec.card is None:
        return None
    return rec.peak_bytes / 2**30
