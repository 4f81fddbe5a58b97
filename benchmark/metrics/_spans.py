"""The program's own spans in a traced window: ``ptq.*`` ranges that the
port opens with ``torch.profiler.record_function`` while a profiler
records (``ptq4vit_tpu_torch/utils/tracing.span``), read from the trace's
host events.  A name's spans are merged into their union and clipped to
the window; the device's idle seconds inside them come from the union of
its kernel, copy and memset intervals (``Trace.busy_s``).  A program
that opens no such span gives an empty union, and the readers then
report nothing."""


def union(tr, *names):
    """The union of the spans named ``names``, clipped to the window:
    sorted, disjoint (start, end) pairs in the trace's microseconds."""
    lo, hi = tr.window
    out = []
    for ts, te in sorted((max(ts, lo), min(te, hi))
                         for ts, te, name in tr.host if name in names):
        if te <= ts:
            continue
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], te)
        else:
            out.append([ts, te])
    return [(ts, te) for ts, te in out]


def length_s(spans):
    """Seconds the spans cover."""
    return sum(te - ts for ts, te in spans) / 1e6


def idle_s(tr, spans):
    """Seconds inside the spans in which no device interval runs."""
    return sum((te - ts) / 1e6 - tr.busy_s(ts, te) for ts, te in spans)


def starting_in(tr, spans, names):
    """Host events named ``names`` that start inside the spans."""
    n, i = 0, 0
    for ts, _, name in tr.host:              # sorted by start
        while i < len(spans) and spans[i][1] < ts:
            i += 1
        if i == len(spans):
            break
        if name in names and spans[i][0] <= ts:
            n += 1
    return n
