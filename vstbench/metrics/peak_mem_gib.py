"""The device memory peak of the window, in GiB: ``max_memory_allocated``
after a reset at the window's start. Shared by every mix
(``peak_mem_gib.<mix>``)."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
