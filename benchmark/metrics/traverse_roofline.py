"""The port's traversal (``ops.traverse.traverse_raw``) on the yardstick's
frozen merged batch: the least time the card could take for the work
the frozen plain traversal needs on that batch, over the time the port
takes (CUDA events, 20 launches), in percent."""

import sys


def read(run):
    if run.port is None or run.device.type != "cuda":
        return None
    from benchmark import yardstick
    from shimmer_tpu_torch.ops.traverse import traverse_raw

    ref_scene, cam, film = run.reference()
    batch = yardstick.merged_batch(ref_scene, cam, film, run.seed)
    work = yardstick.plain_work(ref_scene, batch)
    tris = run.port[0].triangles
    o, d, t_max, want = batch
    ms = yardstick.cuda_ms(lambda: traverse_raw(tris, o, d, t_max, any_hit=want))
    print(f"traverse_roofline: {ms!r} ms a launch of {work['rays']} rays; bound "
          f"{work['bound_ms']!r} ms by {work['bound_by']} ({work})", file=sys.stderr)
    return 100.0 * work["bound_ms"] / ms
