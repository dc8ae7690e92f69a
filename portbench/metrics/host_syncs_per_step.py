"""Host-device synchronisations per window step, counted by torch's sync
debug mode (their sites go to standard error)."""


def read(trace):
    return trace.syncs / trace.steps if trace.syncs is not None else None
