"""GB/s of the device-to-host copies in compress jobs: the bytes of the
program's "copy.d2h" spans (ops/backend.download) over the device
seconds of the trace's Memcpy DtoH events inside them, over the
window."""

from kmerbench.progtrace import d2h_gbps


def read(ctx):
    return d2h_gbps(ctx, "compress")
