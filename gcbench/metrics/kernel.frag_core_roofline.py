"""Share (%) of the byte bound of the fresh frag_core launches of the
traced stretch in the device time of frag_core_kernel."""

from gcbench.readers import frag_roofline


def read(ctx):
    return frag_roofline(ctx, "fresh", "frag_core_kernel")
