"""sample_syncs: the blocking copies to the host that one force sample
makes: the program's `sync.forces` counter over the calls of its `forces`
span (`open_ludwig_torch.spans`), over the run (set-up, window and check
evaluate forces alike); None where the program has no such counter or
evaluated no forces."""


def read(rec):
    try:
        from open_ludwig_torch import spans
    except ImportError:
        return None
    calls = spans.SPANS.get("forces", [0, 0])[0]
    syncs = spans.COUNTS.get("sync.forces")
    if not calls or syncs is None:
        return None
    return syncs / calls
