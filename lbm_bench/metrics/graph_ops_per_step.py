"""graph_ops_per_step: the device operations (kernels, copies, memsets) a
replayed coarse step runs: the program's `graph.ops` counter (each captured
graph's nodes that run on the card, added at each of its replays) over
`graph.steps` (the coarse steps those replays ran;
`open_ludwig_torch.spans`), over the run; None where the program has no
such counter or replayed no graph."""


def read(rec):
    try:
        from open_ludwig_torch import spans
    except ImportError:
        return None
    steps = spans.COUNTS.get("graph.steps")
    ops = spans.COUNTS.get("graph.ops")
    if not steps or ops is None:
        return None
    return ops / steps
