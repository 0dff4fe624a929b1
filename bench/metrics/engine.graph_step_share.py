"""Model step: the share of the window's decode steps that the engine
served by replaying its captured CUDA graph, in %:
``EngineReport.graph_steps`` over ``replay_steps`` plus ``iterations``
(every decode step of either kind), summed over the window's waves.  The
engine counts them itself; a program whose reports carry no
``graph_steps`` gives nothing."""


def read(run):
    reports = [w["report"] for w in run.out["window"]["waves"]]
    graph = [getattr(r, "graph_steps", None) for r in reports]
    replay = [getattr(r, "replay_steps", None) for r in reports]
    if not reports or None in graph or None in replay:
        return None
    steps = sum(replay) + sum(r.iterations for r in reports)
    return 100.0 * sum(graph) / steps if steps else None
