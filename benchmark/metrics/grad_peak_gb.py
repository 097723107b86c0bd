"""Peak device memory allocated over the window's steps, in GB
(``torch.cuda.max_memory_allocated``, reset after set-up)."""


def read(run):
    peak = run.data.get("peak_bytes")
    if not peak or run.traffic["kind"] != "grad_steps":
        return None
    return peak / 1e9
