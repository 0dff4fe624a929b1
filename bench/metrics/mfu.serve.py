"""Model step: the useful FLOPs of every token the window ran through the
model (each prompt token and each served token but the last, the top-k
experts only, causal attention over its own context), over the window's
seconds times the chip's peak in the configuration's dtype."""


def read(run):
    if run.peaks is None:
        return None
    win = run.out["window"]
    lengths = []
    for w in win["waves"]:
        done = {r.rid: r for r in w["report"].results}
        lengths += [(len(q["prompt"]), len(done[q["rid"]].tokens))
                    for q in w["requests"] if q["rid"] in done]
    useful = run.flops.serve_flops(run.conf, lengths)
    peak = run.flops.flops_peak(run.peaks, run.conf["torch_dtype"])
    return 100.0 * useful / (win["seconds"] * peak)
