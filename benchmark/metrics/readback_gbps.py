"""GB/s of the PDF, lmap and levid readback: the bytes the program's
copies move a call (its ``readback.bytes`` counter over its
``fitter.calls``, `frankenz_tpu_torch.utils.metrics.metrics`, every call
of the process; each call of a cell reads back a chunk of one size) over
the device seconds of `Memcpy DtoH` a call (`readback_ms`).  None
untraced, or where the program keeps no such counters."""


def read(ctx):
    dtoh_s = ctx.per_call("dtoh_s")
    if not dtoh_s:
        return None
    from frankenz_tpu_torch.utils.metrics import metrics

    calls = metrics.counters.get("fitter.calls")
    moved = metrics.counters.get("readback.bytes")
    if not calls or moved is None:
        return None
    return moved / calls / dtoh_s / 1e9
