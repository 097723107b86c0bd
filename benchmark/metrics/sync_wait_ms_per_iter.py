"""Host milliseconds a wavefront iteration spent blocked in the loop's
device-to-host reads (its ``wavefront/sync`` spans: the stop test and the
done lanes' ``nonzero``) over the window's waves, over the registry's
``Integrator/Wavefront iterations``."""

from benchmark import stages


def read(run):
    return stages.ms_per_iter(lambda record, chain: record.name == "wavefront/sync")
