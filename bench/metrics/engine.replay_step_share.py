"""Serving engine: the share of the window's decode steps that replayed
prompts, in %: ``EngineReport.replay_steps`` over ``replay_steps`` plus
``iterations`` (the main loop's steps), summed over the window's waves.
The engine counts them itself; a program whose reports carry no
``replay_steps`` gives nothing."""


def read(run):
    reports = [w["report"] for w in run.out["window"]["waves"]]
    replay = [getattr(r, "replay_steps", None) for r in reports]
    if not reports or None in replay:
        return None
    steps = sum(replay) + sum(r.iterations for r in reports)
    return 100.0 * sum(replay) / steps if steps else None
