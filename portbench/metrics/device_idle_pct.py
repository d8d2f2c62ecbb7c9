"""The share of the traced stretch (the device's activity alone, its
host-clock length) in which no operation ran on the device."""


def read(ctx: dict):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy() / tr.wall_s)
