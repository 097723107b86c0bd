"""Host milliseconds a wavefront iteration spent inside the material
dispatch over the window's waves: the durations (not self times) of the
``material/*`` spans under ``render/wave`` that lie in no other
``material/*`` span, over the registry's ``Integrator/Wavefront
iterations``."""

from benchmark import stages


def _top_material(record, chain):
    return record.name.startswith("material/") and not any(
        name.startswith("material/") for name in chain[1:])


def read(run):
    return stages.ms_per_iter(_top_material)
