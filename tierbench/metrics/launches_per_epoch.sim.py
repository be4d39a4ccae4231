"""``launches_per_epoch.sim``: device activities (kernels, copies and sets)
in the traced passes per simulated epoch (the epoch loop's launch count,
counted as ``repro_torch.trace_study`` counts it)."""


def read(trace):
    epochs = trace["shapes"].get("epochs")
    if not epochs or not trace["device"]:
        return None
    lo, hi = trace["window"]
    n = sum(1 for _, s, e in trace["device"] if lo <= s < hi)
    return n / epochs
