"""WPE's recursion's share of its roofline: ``roofline/wpe.py``'s least time
of the span stretch's calls over the device time in the shadow of
``ds.wpe_srp.wpe`` there (``wpe_device_ms``'s)."""

from portbench.harness import spans
from portbench.metrics._kernels import work
from portbench.metrics.wpe_device_ms import WPE
from portbench.roofline.peaks import bound_s


def read(ctx: dict):
    tr = spans.stretch(ctx)
    busy = tr.shadow_busy([WPE]) if tr is not None else 0.0
    if busy <= 0:
        return None
    return 100.0 * sum(bound_s(*work(ctx, "wpe", b)) for b in tr.batches) / busy
