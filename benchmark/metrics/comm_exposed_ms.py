"""Device ms a step in which an NCCL kernel runs and no other kernel
does, on the traced rank: the exchange between cards that the compute
does not hide."""


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx, variant):
    if ctx.trace is None or ctx.variant != variant:
        return None
    nccl = [(k.start_us, k.end_us) for k in ctx.trace.kernels
            if "nccl" in k.name.lower()]
    if not nccl:
        return None
    other = _union((k.start_us, k.end_us) for k in ctx.trace.kernels
                   if "nccl" not in k.name.lower())
    exposed = 0.0
    for s, e in _union(nccl):
        covered = sum(max(0.0, min(e, oe) - max(s, os_))
                      for os_, oe in other)
        exposed += (e - s) - covered
    return exposed / 1e3 / ctx.trace.units
