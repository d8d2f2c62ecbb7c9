"""Host milliseconds from issuing a call to the entry point's return, before
the wait for its outputs (steering and alignment filters, the wrappers'
checks, the launches), over every call of the window: their sum over their
count."""


def read(ctx: dict):
    ms = ctx["host_entry_ms"]
    return sum(ms) / len(ms)
