"""Model step: synchronised wall ms of one ``decode_step`` over the
probe's slots at the probe's context, called directly."""


def read(run):
    probe = run.out.get("probe")
    return probe["wall_ms"] if probe else None
