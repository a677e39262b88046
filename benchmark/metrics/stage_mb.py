"""Megabytes (1e6 bytes) that the fitter's stage copies onto the cards a
call: the program's ``stage.bytes`` counter over its ``fitter.calls``
(`frankenz_tpu_torch.utils.metrics.metrics`, every call of the process;
each call of a cell stages a chunk of one size).  The catalog chunk goes
from the host to every card; the models and G to each card that does
not hold them already.  None where the program keeps no such counter."""


def read(ctx):
    from frankenz_tpu_torch.utils.metrics import metrics

    calls = metrics.counters.get("fitter.calls")
    moved = metrics.counters.get("stage.bytes")
    if not calls or moved is None:
        return None
    return moved / calls / 1e6
