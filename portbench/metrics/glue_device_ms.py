"""Device milliseconds a call of the operations that are not the
configuration's own kernels (the torch front end: notch, alignment, the
fixed beam and blocking matrix, STFT powers, the AEC's preparation), as the
union of their intervals in the traced stretch."""

from portbench.metrics._kernels import matcher


def read(ctx: dict):
    tr = ctx["trace"]
    ours = [matcher(k) for k in ctx["cell"].config["kernels"]]
    busy = tr.busy(lambda name: not any(m(name) for m in ours))
    return busy / tr.calls * 1e3 if busy > 0 else None
